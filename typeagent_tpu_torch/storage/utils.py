"""Storage provider factory (parity: reference storage/utils.py:14-45).

The port of ``typeagent_tpu/storage/utils.py``: the memory branch. SQLite
storage is not ported yet (ROADMAP.md Queue 1 item 12), so a ``dbname``
raises. :func:`prepare_term` is the SQLite indexes' term normalization
(``typeagent_tpu/storage/sqlite/indexes.py``), kept here for the device
query engine until those indexes are ported.
"""

from __future__ import annotations

import re
import unicodedata

from ..knowpro.convsettings import MessageTextIndexSettings, RelatedTermIndexSettings
from ..knowpro.interfaces import ConversationMetadata, IMessage, IStorageProvider


async def create_storage_provider[TMessage: IMessage](
    message_text_settings: MessageTextIndexSettings,
    related_terms_settings: RelatedTermIndexSettings,
    dbname: str | None = None,
    message_type: type[TMessage] | None = None,
    metadata: ConversationMetadata | None = None,
) -> IStorageProvider[TMessage]:
    """Memory provider when dbname is None; SQLite is not ported yet."""
    if dbname is not None:
        raise NotImplementedError(
            f"dbname={dbname!r}: SQLite storage is not ported yet "
            "(ROADMAP.md Queue 1 item 12); pass dbname=None for memory storage"
        )
    from .memory import MemoryStorageProvider

    return MemoryStorageProvider(
        message_text_settings, related_terms_settings, metadata=metadata
    )


def prepare_term(term: str) -> str:
    """strip + NFC unicode normalize + whitespace collapse + lowercase."""
    term = unicodedata.normalize("NFC", term.strip())
    return re.sub(r"\s+", " ", term).lower()
