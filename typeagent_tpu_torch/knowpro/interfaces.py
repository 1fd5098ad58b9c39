"""Core data model + protocols: messages, semantic refs, indexes, storage, search.

The port of ``typeagent_tpu/knowpro/interfaces.py``: the same dataclasses,
on the standard library's ``dataclass`` (``fields.py``) instead of
pydantic's, with the same camelCase keys. One module covering the
reference's interfaces layer
(`knowpro/interfaces_core.py`, `interfaces_indexes.py`, `interfaces_storage.py`,
`interfaces_search.py`, `interfaces_serialization.py`). Field names and
camelCase aliases match the reference's persisted formats.

Ordering semantics that the query engine depends on:
  * ``TextLocation`` orders by (message_ordinal, chunk_ordinal).
  * ``TextRange`` end is exclusive; a missing end means the single point
    [start, start.chunk+1) (`interfaces_core.py:253-297`).
  * ``DateRange`` is half-open [start, end); end None = unbounded
    (`interfaces_core.py:361-383`).
"""

from __future__ import annotations

from collections.abc import AsyncIterable, Iterable, Sequence
from types import TracebackType
from datetime import datetime as Datetime
from typing import (
    Any,
    ClassVar,
    Literal,
    NamedTuple,
    NotRequired,
    Protocol,
    Self,
    TypedDict,
    runtime_checkable,
)

import numpy as np

from ..models.result import Result
from . import kplib
from .fields import dataclass, deserialize_object, serialize_object

STATUS_INGESTED = "ingested"

# Ordinal aliases
type MessageOrdinal = int
type SemanticRefOrdinal = int
type ThreadOrdinal = int

type KnowledgeType = Literal["entity", "action", "topic", "tag"]


# ---------------------------------------------------------------------------
# Knowledge sources & extraction
# ---------------------------------------------------------------------------


class IKnowledgeSource(Protocol):
    """Any object that can self-report knowledge (no LLM)."""

    def get_knowledge(self) -> kplib.KnowledgeResponse: ...


class IKnowledgeExtractor(Protocol):
    """LLM-backed knowledge extraction."""

    async def extract(self, message: str) -> Result[kplib.KnowledgeResponse]: ...


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass
class DeletionInfo:
    timestamp: str
    reason: str | None = None


@dataclass
class IndexingStartPoints:
    """Collection sizes captured before adding new items."""

    message_count: int
    semref_count: int


@dataclass
class AddMessagesResult:
    """Result of an add_messages_with_indexing operation."""

    messages_added: int = 0
    chunks_added: int = 0
    semrefs_added: int = 0
    messages_skipped: int = 0


class IMessageMetadata(Protocol):
    source: str | list[str] | None = None  # senders
    dest: str | list[str] | None = None  # recipients


class IMessage[TMetadata: IMessageMetadata](IKnowledgeSource, Protocol):
    """A conversation message: one or more text chunks plus metadata."""

    text_chunks: list[str]
    tags: list[str]
    timestamp: str | None = None
    deletion_info: DeletionInfo | None = None
    metadata: TMetadata | None = None
    # External source identifier for ingestion restartability (email id, path#i).
    source_id: str | None = None


# ---------------------------------------------------------------------------
# Scored ordinals
# ---------------------------------------------------------------------------


class ScoredSemanticRefOrdinalData(TypedDict):
    semanticRefOrdinal: int
    score: float


@dataclass
class ScoredSemanticRefOrdinal:
    semantic_ref_ordinal: SemanticRefOrdinal
    score: float

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.semantic_ref_ordinal}, {self.score})"

    @classmethod
    def fast(cls, ordinal: int, score: float) -> "ScoredSemanticRefOrdinal":
        """Construction without ``__init__`` for bulk result
        materialization (the JAX package's pydantic ``__init__`` validates;
        the name is kept so both packages' callers read the same)."""
        obj = object.__new__(cls)
        obj.semantic_ref_ordinal = ordinal
        obj.score = score
        return obj

    def serialize(self) -> ScoredSemanticRefOrdinalData:
        return serialize_object(self, exclude_none=False)

    @staticmethod
    def deserialize(data: ScoredSemanticRefOrdinalData) -> "ScoredSemanticRefOrdinal":
        return deserialize_object(ScoredSemanticRefOrdinal, data)


@dataclass
class ScoredMessageOrdinal:
    message_ordinal: MessageOrdinal
    score: float


# ---------------------------------------------------------------------------
# Text locations and ranges
# ---------------------------------------------------------------------------


class TextLocationData(TypedDict):
    messageOrdinal: int
    chunkOrdinal: int


@dataclass(order=True)
class TextLocation:
    message_ordinal: MessageOrdinal
    # In a TextRange end, this is 1 + the ordinal of the last chunk included.
    chunk_ordinal: int = 0

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.message_ordinal}, {self.chunk_ordinal})"

    def serialize(self) -> TextLocationData:
        return serialize_object(self, exclude_none=False)

    @staticmethod
    def deserialize(data: TextLocationData) -> "TextLocation":
        return deserialize_object(TextLocation, data)


class TextRangeData(TypedDict):
    start: TextLocationData
    end: NotRequired[TextLocationData | None]


@dataclass
class TextRange:
    """A text range; end is exclusive, None means the single-point range."""

    start: TextLocation
    end: TextLocation | None = None

    def __repr__(self) -> str:
        if self.end is None:
            return f"{self.__class__.__name__}({self.start})"
        return f"{self.__class__.__name__}({self.start}, {self.end})"

    def _key(self) -> tuple[int, int]:
        """Effective exclusive end as a sortable tuple."""
        if self.end is not None:
            return (self.end.message_ordinal, self.end.chunk_ordinal)
        return (self.start.message_ordinal, self.start.chunk_ordinal + 1)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TextRange):
            return NotImplemented
        return self.start == other.start and self._key() == other._key()

    def __lt__(self, other: Self) -> bool:
        if self.start != other.start:
            return self.start < other.start
        return self._key() < other._key()

    def __gt__(self, other: Self) -> bool:
        return other.__lt__(self)

    def __ge__(self, other: Self) -> bool:
        return not self.__lt__(other)

    def __le__(self, other: Self) -> bool:
        return not other.__lt__(self)

    def __contains__(self, other: Self) -> bool:
        return self.start <= other.start and other._key() <= self._key()

    def serialize(self) -> TextRangeData:
        return serialize_object(self, exclude_none=True)

    @staticmethod
    def deserialize(data: TextRangeData) -> "TextRange":
        return deserialize_object(TextRange, data)


# ---------------------------------------------------------------------------
# Knowledge wrappers & semantic refs
# ---------------------------------------------------------------------------


@dataclass
class Topic:
    knowledge_type: ClassVar[Literal["topic"]] = "topic"
    text: str


@dataclass
class Tag:
    knowledge_type: ClassVar[Literal["tag"]] = "tag"
    text: str


type Knowledge = kplib.ConcreteEntity | kplib.Action | Topic | Tag


class SemanticRefData(TypedDict):
    semanticRefOrdinal: int
    range: TextRangeData
    knowledgeType: KnowledgeType
    knowledge: dict


@dataclass
class SemanticRef:
    semantic_ref_ordinal: SemanticRefOrdinal
    range: TextRange
    knowledge: Knowledge

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}({self.semantic_ref_ordinal}, {self.range}, "
            f"{self.knowledge.knowledge_type!r}, {self.knowledge})"
        )

    def serialize(self) -> SemanticRefData:
        return SemanticRefData(
            semanticRefOrdinal=self.semantic_ref_ordinal,
            range=self.range.serialize(),
            knowledgeType=self.knowledge.knowledge_type,
            knowledge=serialize_object(self.knowledge),
        )

    @staticmethod
    def deserialize(data: SemanticRefData) -> "SemanticRef":
        from .serialization import deserialize_knowledge

        return SemanticRef(
            semantic_ref_ordinal=data["semanticRefOrdinal"],
            range=TextRange.deserialize(data["range"]),
            knowledge=deserialize_knowledge(data["knowledgeType"], data["knowledge"]),
        )


@dataclass
class DateRange:
    """Half-open [start, end); end None = unbounded (timestamp indexes treat a
    missing end as a point query)."""

    start: Datetime
    end: Datetime | None = None

    def __repr__(self) -> str:
        if self.end is None:
            return f"{self.__class__.__name__}({self.start!r})"
        return f"{self.__class__.__name__}({self.start!r}, {self.end!r})"

    def __contains__(self, dt: Datetime) -> bool:
        if self.end is None:
            return self.start <= dt
        return self.start <= dt < self.end


class TermData(TypedDict):
    text: str
    weight: NotRequired[float | None]


@dataclass(unsafe_hash=True)
class Term:
    """A search term; hashable so it can key dicts/sets."""

    text: str
    weight: float | None = None

    def __repr__(self) -> str:
        if self.weight is None:
            return f"{self.__class__.__name__}({self.text!r})"
        return f"{self.__class__.__name__}({self.text!r}, {self.weight:.4g})"

    def serialize(self) -> TermData:
        return serialize_object(self, exclude_none=True)


# ---------------------------------------------------------------------------
# Index protocols — the six indexes
# ---------------------------------------------------------------------------


class ITermToSemanticRefIndex(Protocol):
    """Index 1: exact (case-insensitive) term -> scored semref posting list."""

    async def size(self) -> int: ...
    async def get_terms(self) -> list[str]: ...
    async def add_term(
        self,
        term: str,
        semantic_ref_ordinal: SemanticRefOrdinal | ScoredSemanticRefOrdinal,
    ) -> str: ...
    async def add_terms_batch(
        self,
        terms: Sequence[tuple[str, SemanticRefOrdinal | ScoredSemanticRefOrdinal]],
    ) -> None: ...
    async def remove_term(
        self, term: str, semantic_ref_ordinal: SemanticRefOrdinal
    ) -> None: ...
    async def lookup_term(self, term: str) -> list[ScoredSemanticRefOrdinal] | None: ...
    async def clear(self) -> None: ...
    async def serialize(self) -> Any: ...
    async def deserialize(self, data: Any) -> None: ...


@runtime_checkable
class IPropertyToSemanticRefIndex(Protocol):
    """Index 2: structured (name, value) property -> semref posting list."""

    async def size(self) -> int: ...
    async def get_values(self) -> list[str]: ...
    async def add_property(
        self,
        property_name: str,
        value: str,
        semantic_ref_ordinal: SemanticRefOrdinal | ScoredSemanticRefOrdinal,
    ) -> None: ...
    async def add_properties_batch(
        self,
        properties: Sequence[
            tuple[str, str, SemanticRefOrdinal | ScoredSemanticRefOrdinal]
        ],
    ) -> None: ...
    async def lookup_property(
        self, property_name: str, value: str
    ) -> list[ScoredSemanticRefOrdinal] | None: ...
    async def clear(self) -> None: ...
    async def remove_property(self, prop_name: str, semref_id: int) -> None: ...
    async def remove_all_for_semref(self, semref_id: int) -> None: ...


@dataclass
class TimestampedTextRange:
    timestamp: str
    range: TextRange


class ITimestampToTextRangeIndex(Protocol):
    """Index 3: time range -> message text ranges.

    Contract: ISO-8601 timestamps compare lexicographically; lookup_range
    returns start <= t < end (end exclusive); end None = point query.
    """

    async def size(self) -> int: ...
    async def add_timestamp(
        self, message_ordinal: MessageOrdinal, timestamp: str
    ) -> bool: ...
    async def add_timestamps(
        self, message_timestamps: list[tuple[MessageOrdinal, str]]
    ) -> None: ...
    async def lookup_range(self, date_range: DateRange) -> list[TimestampedTextRange]: ...


class ITermToRelatedTerms(Protocol):
    """Index 5a: alias table (term -> related terms)."""

    async def lookup_term(self, text: str) -> list[Term] | None: ...
    async def size(self) -> int: ...
    async def is_empty(self) -> bool: ...
    async def clear(self) -> None: ...
    async def add_related_term(
        self, text: str, related_terms: Term | list[Term]
    ) -> None: ...
    async def remove_term(self, text: str) -> None: ...
    async def serialize(self) -> TermToRelatedTermsData: ...
    async def deserialize(self, data: TermToRelatedTermsData | None) -> None: ...


class ITermToRelatedTermsFuzzy(Protocol):
    """Index 5b: embedding-based fuzzy term expansion."""

    async def size(self) -> int: ...
    async def add_terms(self, texts: list[str]) -> None: ...
    async def add_terms_with_embeddings(
        self, texts: list[str], embeddings: np.ndarray
    ) -> None: ...
    async def lookup_term(
        self,
        text: str,
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[Term]: ...
    async def lookup_terms(
        self,
        texts: list[str],
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[list[Term]]: ...


class ITermToRelatedTermsIndex(Protocol):
    """Index 5: aliases + fuzzy expansion behind one surface."""

    @property
    def aliases(self) -> ITermToRelatedTerms: ...
    @property
    def fuzzy_index(self) -> ITermToRelatedTermsFuzzy | None: ...
    async def serialize(self) -> TermsToRelatedTermsIndexData: ...
    async def deserialize(self, data: TermsToRelatedTermsIndexData) -> None: ...


class ThreadData(TypedDict):
    description: str
    ranges: list[TextRangeData]


@dataclass
class Thread:
    """A conversation thread: description + associated text ranges."""

    description: str
    ranges: Sequence[TextRange]

    def serialize(self) -> ThreadData:
        return serialize_object(self, exclude_none=False)

    @staticmethod
    def deserialize(data: ThreadData) -> "Thread":
        return deserialize_object(Thread, data)


@dataclass
class ScoredThreadOrdinal:
    thread_ordinal: ThreadOrdinal
    score: float


class IConversationThreads(Protocol):
    """Index 6: fuzzy thread scoping by description."""

    threads: list[Thread]

    async def add_thread(self, thread: Thread) -> None: ...
    async def lookup_thread(
        self,
        thread_description: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredThreadOrdinal] | None: ...
    def serialize(self) -> ConversationThreadData[ThreadDataItem]: ...
    def deserialize(self, data: ConversationThreadData[ThreadDataItem]) -> None: ...


@runtime_checkable
class IMessageTextIndex[TMessage: IMessage](Protocol):
    """Index 4: fuzzy text -> message chunks via embeddings."""

    async def add_messages(self, messages: Iterable[TMessage]) -> None: ...
    async def add_messages_starting_at(
        self, start_message_ordinal: int, messages: list[TMessage]
    ) -> None: ...
    async def add_messages_starting_at_with_embeddings(
        self,
        start_message_ordinal: int,
        messages: list[TMessage],
        chunk_embeddings: list[np.ndarray],
    ) -> None: ...
    async def lookup_messages(
        self,
        message_text: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]: ...
    async def lookup_messages_in_subset(
        self,
        message_text: str,
        ordinals_to_search: list[MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]: ...
    async def size(self) -> int: ...
    async def is_empty(self) -> bool: ...
    async def indexed_message_count(self) -> int:
        """Number of MESSAGES indexed (``size()`` counts chunk rows)."""
        ...

    async def serialize(self) -> MessageTextIndexData: ...
    async def deserialize(self, data: MessageTextIndexData) -> None: ...


class IConversationSecondaryIndexes[TMessage: IMessage](Protocol):
    property_to_semantic_ref_index: IPropertyToSemanticRefIndex | None
    timestamp_index: ITimestampToTextRangeIndex | None
    term_to_related_terms_index: ITermToRelatedTermsIndex | None
    threads: IConversationThreads | None = None
    message_index: IMessageTextIndex[TMessage] | None = None


# ---------------------------------------------------------------------------
# Collections & storage provider
# ---------------------------------------------------------------------------


@dataclass
class ConversationMetadata:
    """Provider-agnostic conversation metadata (None = missing/default)."""

    name_tag: str | None = None
    schema_version: int | None = None
    created_at: Datetime | None = None
    updated_at: Datetime | None = None
    embedding_model: str | None = None
    tags: list[str] | None = None
    extra: dict[str, str] | None = None


class SemanticRefMetadata(NamedTuple):
    """Lightweight semref metadata for filtering without full deserialization."""

    ordinal: SemanticRefOrdinal
    range: TextRange
    knowledge_type: KnowledgeType


@dataclass
class ChunkFailure:
    """One failed knowledge-extraction attempt for one chunk."""

    message_ordinal: int
    chunk_ordinal: int
    error_class: str
    error_message: str
    failed_at: Datetime


class IReadonlyCollection[T, TOrdinal](AsyncIterable[T], Protocol):
    async def size(self) -> int: ...
    async def get_item(self, arg: TOrdinal) -> T: ...
    async def get_slice(self, start: int, stop: int) -> list[T]: ...
    async def get_multiple(self, arg: list[TOrdinal]) -> list[T]: ...


class ICollection[T, TOrdinal](IReadonlyCollection[T, TOrdinal], Protocol):
    """An APPEND-ONLY collection."""

    @property
    def is_persistent(self) -> bool: ...
    async def append(self, item: T) -> None: ...
    async def extend(self, items: Iterable[T]) -> None:
        for item in items:
            await self.append(item)


class IMessageCollection[TMessage: IMessage](
    ICollection[TMessage, MessageOrdinal], Protocol
):
    async def extend(
        self,
        items: Iterable[TMessage],
        chunk_embeddings: list[np.ndarray] | None = None,
        index_messages: bool = True,
    ) -> None: ...


class ISemanticRefCollection(ICollection[SemanticRef, SemanticRefOrdinal], Protocol):
    async def get_metadata_multiple(
        self, ordinals: list[SemanticRefOrdinal]
    ) -> list[SemanticRefMetadata]: ...


class IStorageProvider[TMessage: IMessage](Protocol):
    """2 collections + all 6 indexes, plus metadata/transactions/tracking."""

    @property
    def messages(self) -> IMessageCollection[TMessage]: ...
    @property
    def semantic_refs(self) -> ISemanticRefCollection: ...
    @property
    def semantic_ref_index(self) -> ITermToSemanticRefIndex: ...
    @property
    def property_index(self) -> IPropertyToSemanticRefIndex: ...
    @property
    def timestamp_index(self) -> ITimestampToTextRangeIndex: ...
    @property
    def message_text_index(self) -> IMessageTextIndex[TMessage]: ...
    @property
    def related_terms_index(self) -> ITermToRelatedTermsIndex: ...
    @property
    def conversation_threads(self) -> IConversationThreads: ...

    async def get_conversation_metadata(self) -> ConversationMetadata: ...
    async def set_conversation_metadata(self, **kwds: str | list[str] | None) -> None: ...
    async def update_conversation_timestamps(
        self,
        created_at: Datetime | None = None,
        updated_at: Datetime | None = None,
    ) -> None: ...

    async def is_source_ingested(self, source_id: str) -> bool: ...
    async def are_sources_ingested(self, source_ids: list[str]) -> set[str]: ...
    async def get_source_status(self, source_id: str) -> str | None: ...
    async def mark_source_ingested(
        self, source_id: str, status: str = STATUS_INGESTED
    ) -> None: ...
    async def mark_sources_ingested_batch(
        self, source_ids: list[str], status: str = STATUS_INGESTED
    ) -> None: ...

    async def record_chunk_failure(
        self,
        message_ordinal: int,
        chunk_ordinal: int,
        error_class: str,
        error_message: str,
    ) -> None: ...
    async def clear_chunk_failure(
        self, message_ordinal: int, chunk_ordinal: int
    ) -> None: ...
    async def get_chunk_failures(self) -> list[ChunkFailure]: ...

    async def __aenter__(self) -> Self: ...
    async def __aexit__(
        self,
        exc_type: type[BaseException] | None,
        exc_val: BaseException | None,
        exc_tb: TracebackType | None,
    ) -> None: ...
    async def close(self) -> None: ...


class IConversation[
    TMessage: IMessage,
    TTermToSemanticRefIndex: ITermToSemanticRefIndex,
](Protocol):
    name_tag: str
    tags: list[str]
    messages: IMessageCollection[TMessage]
    semantic_refs: ISemanticRefCollection
    semantic_ref_index: TTermToSemanticRefIndex
    secondary_indexes: IConversationSecondaryIndexes[TMessage] | None


# ---------------------------------------------------------------------------
# Search expression types
# ---------------------------------------------------------------------------


@dataclass
class SearchTerm:
    """A term being searched for.

    related_terms semantics: empty list = no related matches; None = the
    query processor may resolve related terms from secondary indexes.
    """

    term: Term
    related_terms: list[Term] | None = None


type KnowledgePropertyName = Literal[
    "name", "type", "verb", "subject", "object", "indirectObject", "tag", "topic"
]


@dataclass
class PropertySearchTerm:
    """Match a named property value: well-known name or free SearchTerm name.

    E.g. name("Bach"), type("book"), or hue(red) as (SearchTerm('hue'),
    SearchTerm('red')) — which should also match facets color(red).
    """

    property_name: KnowledgePropertyName | SearchTerm
    property_value: SearchTerm


@dataclass
class SearchTermGroup:
    """A boolean group of search terms."""

    boolean_op: Literal["and", "or", "or_max"]
    terms: list["SearchTermGroupTypes"] = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.terms is None:
            self.terms = []


type SearchTermGroupTypes = SearchTerm | PropertySearchTerm | SearchTermGroup


@dataclass
class WhenFilter:
    """Extra constraints on when a matching SemanticRef counts as a match."""

    knowledge_type: KnowledgeType | None = None
    date_range: DateRange | None = None
    thread_description: str | None = None
    tags: list[str] | None = None
    # Scope: term group whose matching ranges define the scope, plus any
    # caller-computed ranges.
    scope_defining_terms: SearchTermGroup | None = None
    text_ranges_in_scope: list[TextRange] | None = None


@dataclass
class SearchSelectExpr:
    """Select expression: term group + optional when filter."""

    search_term_group: SearchTermGroup
    when: WhenFilter | None = None


@dataclass
class SemanticRefSearchResult:
    term_matches: set[str]
    semantic_ref_matches: list[ScoredSemanticRefOrdinal]


# ---------------------------------------------------------------------------
# Serialization TypedDicts (file-format parity with the reference)
# ---------------------------------------------------------------------------


class ThreadDataItem(TypedDict):
    thread: ThreadData
    embedding: list[float] | None


class ConversationThreadData[TThreadDataItem: ThreadDataItem](TypedDict):
    threads: list[TThreadDataItem] | None


class TermsToRelatedTermsDataItem(TypedDict):
    termText: str
    relatedTerms: list[TermData]


class TermToRelatedTermsData(TypedDict):
    relatedTerms: NotRequired[list[TermsToRelatedTermsDataItem] | None]


class TextEmbeddingIndexData(TypedDict):
    textItems: list[str]
    embeddings: np.ndarray | None


class TermsToRelatedTermsIndexData(TypedDict):
    aliasData: NotRequired[TermToRelatedTermsData]
    textEmbeddingData: NotRequired[TextEmbeddingIndexData]


class TermToSemanticRefIndexItemData(TypedDict):
    term: str
    semanticRefOrdinals: list[ScoredSemanticRefOrdinalData]


class TermToSemanticRefIndexData(TypedDict):
    items: list[TermToSemanticRefIndexItemData]


class ConversationData[TMessageData](TypedDict):
    nameTag: str
    messages: list[TMessageData]
    tags: list[str]
    semanticRefs: list[SemanticRefData] | None
    semanticIndexData: NotRequired[TermToSemanticRefIndexData | None]


class TextToTextLocationIndexData(TypedDict):
    textLocations: list[TextLocationData]
    embeddings: np.ndarray | None


class MessageTextIndexData(TypedDict):
    indexData: NotRequired[TextToTextLocationIndexData | None]


class ConversationDataWithIndexes[TMessageData](ConversationData[TMessageData]):
    relatedTermsIndexData: NotRequired[TermsToRelatedTermsIndexData | None]
    threadData: NotRequired[ConversationThreadData[ThreadDataItem] | None]
    messageIndexData: NotRequired[MessageTextIndexData | None]
