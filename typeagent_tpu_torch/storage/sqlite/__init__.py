"""SQLite storage backend (embeddings in a store on the settings' device,
BLOB write-through).

The port of ``typeagent_tpu/storage/sqlite/``. The tables, their column
text and the embedding BLOBs are the JAX package's byte for byte, so a
database written by either package opens in the other.
"""

from .collections import SqliteMessageCollection, SqliteSemanticRefCollection
from .indexes import (
    SqlitePropertyIndex,
    SqliteTermToSemanticRefIndex,
    SqliteTimestampToTextRangeIndex,
)
from .messageindex import SqliteMessageTextIndex
from .provider import SqliteStorageProvider
from .reltermsindex import (
    SqliteRelatedTermsAliases,
    SqliteRelatedTermsFuzzy,
    SqliteRelatedTermsIndex,
)

__all__ = [
    "SqliteMessageCollection",
    "SqliteMessageTextIndex",
    "SqlitePropertyIndex",
    "SqliteRelatedTermsAliases",
    "SqliteRelatedTermsFuzzy",
    "SqliteRelatedTermsIndex",
    "SqliteSemanticRefCollection",
    "SqliteStorageProvider",
    "SqliteTermToSemanticRefIndex",
    "SqliteTimestampToTextRangeIndex",
]
