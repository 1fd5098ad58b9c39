"""Pipelined streaming ingestion: producer -> dispatcher -> reassembler.

(Parity: reference knowpro/add_messages.py. Invariants preserved:

  * Per-chunk work = LLM knowledge extraction + chunk embedding +
    related-term embeddings, run concurrently per chunk with workers bounded
    by a semaphore.
  * The reassembler commits only consecutive, complete, non-failed messages
    — message N incomplete/failed means N+1.. stay buffered. Target chunks
    per commit = ``batch_size``, with pre-flush when a message would
    overshoot.
  * Failure policy: halt-on-first-failure via a shared ``halt_before``
    watermark (partial work after the failure is dropped / rolled back with
    the storage transaction), or ``skip_failed_messages=True`` to skip and
    continue.
  * Graceful shutdown via ``shutdown_event``; zero-chunk messages flow
    straight to the reassembler as immediately-complete pending.)

The port of ``typeagent_tpu/knowpro/add_messages.py`` (plain Python, the
same code): each committed batch's message embeddings go into the message
index's store on the settings' device, as ``add_messages_with_indexing``
puts them there.
"""

from __future__ import annotations

import asyncio
from collections.abc import AsyncIterable, Awaitable, Callable
from dataclasses import dataclass, field
from itertools import chain
from typing import TYPE_CHECKING

import numpy as np

from ..models.embeddings import IEmbeddingModel
from ..models.result import Failure, Result, Success
from . import kplib
from .interfaces import (
    AddMessagesResult,
    IKnowledgeExtractor,
    IMessage,
    MessageOrdinal,
    TextLocation,
)
from .semrefindex import collect_action_terms, collect_entity_terms

__all__ = ["add_messages_streaming"]

if TYPE_CHECKING:
    from .conversation_base import ConversationBase

type ChunkOrdinal = int

_EMPTY_KNOWLEDGE = kplib.KnowledgeResponse(
    entities=[], actions=[], inverse_actions=[], topics=[]
)

# Sentinel watermark: effectively "no stop".
_NO_STOP = 10**100


class NoOpKnowledgeExtractor:
    """Used when auto_extract_knowledge is off: extraction yields nothing."""

    async def extract(self, message: str) -> Result[kplib.KnowledgeResponse]:
        return Success(_EMPTY_KNOWLEDGE)


@dataclass
class StopWatermark:
    """Shared stop watermark: ordinals >= halt_before are out of scope.

    ``exception`` holds the error from the lowest-ordinal failing message so
    the orchestrator can re-raise after the pipeline drains.
    """

    halt_before: int = _NO_STOP
    exception: Exception | None = None


@dataclass
class FeedState:
    next_message_id: MessageOrdinal
    produced_messages: int = 0
    produced_chunks: int = 0
    exception: Exception | None = None


@dataclass
class ChunkTask[TMessage: IMessage]:
    chunk_id: TextLocation
    chunk_count: int
    chunk_text: str
    message: TMessage


@dataclass
class ChunkOutcome[TMessage: IMessage]:
    """One chunk's extraction + embedding outcome."""

    chunk_id: TextLocation
    chunk_count: int
    message: TMessage
    extracted_knowledge: kplib.KnowledgeResponse | None = None
    chunk_embedding: np.ndarray | None = None
    related_terms: list[str] | None = None
    related_term_embeddings: list[np.ndarray] | None = None
    error: Exception | None = None


def _fuzzy_terms_of(
    knowledge: kplib.KnowledgeResponse,
) -> list[str]:
    """Lowercased, order-preserving dedupe of all knowledge-derived terms."""
    seen: set[str] = set()
    related_terms: list[str] = []

    def _add(term: str) -> None:
        canonical = term.strip().lower()
        if canonical and canonical not in seen:
            seen.add(canonical)
            related_terms.append(canonical)

    for entity in knowledge.entities:
        for term in collect_entity_terms(entity):
            _add(term)
    for action in chain(knowledge.actions, knowledge.inverse_actions):
        for term in collect_action_terms(action):
            _add(term)
    for topic in knowledge.topics:
        _add(topic)
    return related_terms


# "Public": imported by tests.
async def process_chunk[TMessage: IMessage](
    chunk_id: TextLocation,
    chunk_text: str,
    chunk_count: int,
    message: TMessage,
    knowledge_extractor: IKnowledgeExtractor,
    embedding_model: IEmbeddingModel,
) -> ChunkOutcome[TMessage]:
    """Extraction + related-term embeddings and chunk embedding run
    concurrently; the first failure is captured on the result."""
    result = ChunkOutcome(
        chunk_id=chunk_id, chunk_count=chunk_count, message=message
    )
    sem = asyncio.Semaphore(1)  # serialize embedding requests per chunk

    async def _extract_and_embed_related() -> None:
        knowledge_result = await knowledge_extractor.extract(chunk_text)
        if isinstance(knowledge_result, Failure):
            raise RuntimeError(
                f"Knowledge extraction failed: {knowledge_result.message}"
            )
        result.extracted_knowledge = knowledge_result.value
        result.related_terms = _fuzzy_terms_of(
            result.extracted_knowledge
        )
        if result.related_terms:
            async with sem:
                rel = await embedding_model.get_embeddings(result.related_terms)
            result.related_term_embeddings = list(rel)
        else:
            result.related_term_embeddings = []

    async def _embed_chunk() -> None:
        async with sem:
            result.chunk_embedding = await embedding_model.get_embedding_nocache(
                chunk_text
            )

    try:
        async with asyncio.TaskGroup() as tg:
            tg.create_task(_extract_and_embed_related())
            tg.create_task(_embed_chunk())
    except Exception as error:
        while isinstance(error, ExceptionGroup) and len(error.exceptions) == 1:
            error = error.exceptions[0]
        result.error = error

    return result


async def _feed_stage[TMessage: IMessage](
    messages: AsyncIterable[TMessage],
    task_queue: asyncio.Queue,
    watermark: StopWatermark,
    feed_state: FeedState,
    outcome_queue: asyncio.Queue,
    shutdown_event: asyncio.Event | None,
) -> None:
    """Enqueue chunk work items; always sends the dispatcher sentinel."""
    try:
        async for message in messages:
            message_id = feed_state.next_message_id
            if message_id >= watermark.halt_before:
                break
            if shutdown_event is not None and shutdown_event.is_set():
                break

            chunk_count = len(message.text_chunks)
            if chunk_count == 0:
                # Nothing to process: emit a zero-chunk result directly.
                zero = ChunkOutcome[TMessage](
                    chunk_id=TextLocation(message_id, 0),
                    chunk_count=0,
                    message=message,
                )
                await outcome_queue.put(zero)
            else:
                for chunk_ordinal, chunk_text in enumerate(message.text_chunks):
                    if message_id >= watermark.halt_before:
                        break
                    work = ChunkTask[TMessage](
                        chunk_id=TextLocation(message_id, chunk_ordinal),
                        chunk_count=chunk_count,
                        chunk_text=chunk_text,
                        message=message,
                    )
                    await task_queue.put(work)
                    feed_state.produced_chunks += 1

            feed_state.produced_messages += 1
            feed_state.next_message_id += 1
    except Exception as exc:
        feed_state.exception = exc
    finally:
        await task_queue.put(None)


async def _fanout_stage[TMessage: IMessage](
    task_queue: asyncio.Queue,
    outcome_queue: asyncio.Queue,
    watermark: StopWatermark,
    knowledge_extractor: IKnowledgeExtractor,
    embedding_model: IEmbeddingModel,
    concurrency: int,
    skip_failed_messages: bool,
) -> None:
    """Fan chunk work items out to at most ``concurrency`` worker tasks.

    Chunks at/past the stop watermark become error results so the reassembler
    accounts for them deterministically. When not skipping failures, the
    first failing chunk lowers the watermark to its message.
    """
    sem = asyncio.Semaphore(concurrency)

    async def _process_one(task: ChunkTask[TMessage]) -> None:
        try:
            stop_at = watermark.halt_before
            if task.chunk_id.message_ordinal >= stop_at:
                result: ChunkOutcome[TMessage] = ChunkOutcome(
                    chunk_id=task.chunk_id,
                    chunk_count=task.chunk_count,
                    message=task.message,
                    error=RuntimeError(
                        "Chunk skipped because halt_before is "
                        f"{stop_at} and message_id is "
                        f"{task.chunk_id.message_ordinal}"
                    ),
                )
            else:
                result = await process_chunk(
                    chunk_id=task.chunk_id,
                    chunk_text=task.chunk_text,
                    chunk_count=task.chunk_count,
                    message=task.message,
                    knowledge_extractor=knowledge_extractor,
                    embedding_model=embedding_model,
                )
                if result.error is not None and not skip_failed_messages:
                    # Halt-on-first-failure: lower the watermark to this
                    # message so later chunks turn into deterministic skips.
                    failed_at = task.chunk_id.message_ordinal
                    if failed_at < watermark.halt_before:
                        watermark.halt_before = failed_at
                    if watermark.exception is None:
                        watermark.exception = result.error
        finally:
            sem.release()
        await outcome_queue.put(result)

    async with asyncio.TaskGroup() as tg:
        while True:
            item = await task_queue.get()
            if item is None:
                break
            await sem.acquire()
            tg.create_task(_process_one(item))

    await outcome_queue.put(None)


@dataclass
class PendingMessage[TMessage: IMessage]:
    """Chunk accumulation for one message awaiting completeness."""

    message_id: MessageOrdinal
    chunk_count: int
    message: TMessage
    chunks: dict[ChunkOrdinal, ChunkOutcome[TMessage]] = field(
        default_factory=dict
    )
    has_error: bool = False

    def is_complete(self) -> bool:
        return len(self.chunks) == self.chunk_count


@dataclass
class CommitStats:
    next_commit_ordinal: MessageOrdinal
    messages_committed: int = 0
    chunks_committed: int = 0
    chunk_failures: int = 0
    messages_skipped: int = 0
    buffered_messages: int = 0


async def _commit_stage[TMessage: IMessage](
    outcome_queue: asyncio.Queue,
    watermark: StopWatermark,
    next_commit_ordinal: MessageOrdinal,
    chunk_commit_target: int,
    commit_batch: Callable[
        [list[TMessage], list[ChunkOutcome[TMessage]]], Awaitable[None]
    ],
    skip_failed_messages: bool,
    on_message_skipped: Callable[["PendingMessage[TMessage]"], Awaitable[None]]
    | None = None,
) -> CommitStats:
    """Commit order invariant: only consecutive complete non-failed messages
    commit. Validation errors (bad ordinals, duplicates, mismatched counts)
    lower the watermark and raise."""
    state = CommitStats(next_commit_ordinal=next_commit_ordinal)
    pending: dict[MessageOrdinal, PendingMessage[TMessage]] = {}

    queued_msgs: list[TMessage] = []
    queued_outcomes: list[ChunkOutcome[TMessage]] = []
    queued_chunk_n = 0

    async def _maybe_flush(force: bool = False) -> None:
        nonlocal queued_chunk_n, queued_msgs, queued_outcomes
        if not queued_msgs:
            return
        if not force and queued_chunk_n < chunk_commit_target:
            return
        pending_messages = queued_msgs
        pending_results = queued_outcomes
        msg_count = len(pending_messages)
        chunk_count = queued_chunk_n
        # Clear before awaiting so a post-commit exception can't double-commit
        # during the final drain.
        queued_msgs = []
        queued_outcomes = []
        queued_chunk_n = 0
        await commit_batch(pending_messages, pending_results)
        state.messages_committed += msg_count
        state.chunks_committed += chunk_count

    async def _advance_commit_frontier(force: bool = False) -> None:
        nonlocal queued_chunk_n
        while True:
            entry = pending.get(state.next_commit_ordinal)
            if entry is None or not entry.is_complete():
                await _maybe_flush(force)
                return
            if entry.has_error:
                if skip_failed_messages:
                    error_msg = next(
                        (
                            str(c.error)
                            for c in entry.chunks.values()
                            if c.error is not None
                        ),
                        "Unknown error",
                    )
                    print(
                        f"Skipping message {state.next_commit_ordinal} "
                        f"due to chunk processing error: {error_msg}"
                    )
                    if on_message_skipped is not None:
                        await on_message_skipped(entry)
                    del pending[state.next_commit_ordinal]
                    state.next_commit_ordinal += 1
                    state.messages_skipped += 1
                    continue
                await _maybe_flush(force)
                return

            # Pre-flush so one message doesn't overshoot the chunk target.
            if (
                queued_msgs
                and queued_chunk_n + entry.chunk_count > chunk_commit_target
            ):
                await _maybe_flush(force=True)

            ordered = [entry.chunks[i] for i in sorted(entry.chunks)]
            queued_msgs.append(entry.message)
            queued_outcomes.extend(ordered)
            queued_chunk_n += len(ordered)

            del pending[state.next_commit_ordinal]
            state.next_commit_ordinal += 1
            await _maybe_flush(force)

    try:
        while True:
            item = await outcome_queue.get()
            if item is None:
                break

            chunk_ordinal = item.chunk_id.chunk_ordinal
            message_id = item.chunk_id.message_ordinal

            shape_error: str | None = None
            entry = pending.get(message_id)
            if item.chunk_count == 0:
                if entry is None:
                    entry = PendingMessage[TMessage](
                        message_id=message_id, chunk_count=0, message=item.message
                    )
                    pending[message_id] = entry
            elif chunk_ordinal < 0 or chunk_ordinal >= item.chunk_count:
                shape_error = (
                    f"Invalid chunk ordinal: message_id={message_id}, "
                    f"chunk_ordinal={chunk_ordinal}, chunk_count={item.chunk_count}"
                )
            elif entry is None:
                entry = PendingMessage[TMessage](
                    message_id=message_id,
                    chunk_count=item.chunk_count,
                    message=item.message,
                )
                pending[message_id] = entry
            elif entry.chunk_count != item.chunk_count:
                shape_error = (
                    f"Mismatched chunk count for message: message_id={message_id}, "
                    f"expected={entry.chunk_count}, got={item.chunk_count}"
                )
            elif chunk_ordinal in entry.chunks:
                shape_error = (
                    f"Duplicate chunk: message_id={message_id}, "
                    f"chunk_ordinal={chunk_ordinal}, chunk_count={item.chunk_count}"
                )

            if shape_error is not None:
                watermark.halt_before = min(
                    watermark.halt_before, message_id
                )
                raise RuntimeError(shape_error)

            assert entry is not None
            if item.chunk_count > 0:
                entry.chunks[chunk_ordinal] = item

            if item.error is not None:
                entry.has_error = True
                state.chunk_failures += 1
                if not skip_failed_messages:
                    watermark.halt_before = min(
                        watermark.halt_before, message_id
                    )

            await _advance_commit_frontier()
    finally:
        # Commit whatever consecutive complete prefix exists before raising.
        await _advance_commit_frontier(force=True)

    state.buffered_messages = len(pending)
    return state


async def add_messages_streaming[TMessage: IMessage](
    conv: "ConversationBase[TMessage]",
    messages: AsyncIterable[TMessage],
    *,
    batch_size: int = 100,
    on_batch_committed: Callable[[AddMessagesResult], None] | None = None,
    skip_failed_messages: bool = False,
    shutdown_event: asyncio.Event | None = None,
) -> AddMessagesResult:
    """Pipelined ingest preserving commit order; see module docstring."""
    from . import convknowledge

    settings = conv.settings
    sem_ref_settings = settings.semantic_ref_index_settings
    storage = await settings.get_storage_provider()
    if sem_ref_settings.auto_extract_knowledge:
        knowledge_extractor: IKnowledgeExtractor = (
            sem_ref_settings.knowledge_extractor or convknowledge.KnowledgeExtractor()
        )
    else:
        knowledge_extractor = NoOpKnowledgeExtractor()
    embedding_model = settings.embedding_model

    initial_message_id: MessageOrdinal = await conv.messages.size()
    total = AddMessagesResult()

    def _accumulate(result: AddMessagesResult) -> None:
        total.messages_added += result.messages_added
        total.semrefs_added += result.semrefs_added
        total.chunks_added += result.chunks_added
        if on_batch_committed:
            on_batch_committed(result)

    async def _commit_batch(
        messages_batch: list[TMessage],
        chunk_results: list[ChunkOutcome[TMessage]],
    ) -> None:
        result = await conv._commit_chunk_batch(
            storage, messages_batch, chunk_results
        )
        _accumulate(result)

    async def _record_skipped_failures(entry) -> None:
        """Persist failed chunks to the ChunkFailures table so a re-extract
        tool can retry them (keyed by pipeline ordinal; the skipped message
        itself is not stored — its source id is embedded in the record)."""
        source_id = getattr(entry.message, "source_id", None)
        prefix = f"[source_id={source_id}] " if source_id else ""
        try:
            async with storage:
                for chunk_ord, chunk in entry.chunks.items():
                    if chunk.error is not None:
                        await storage.record_chunk_failure(
                            entry.message_id,
                            chunk_ord,
                            type(chunk.error).__name__,
                            (prefix + str(chunk.error))[:500],
                        )
        except Exception:
            pass  # failure bookkeeping must never break the ingest

    task_queue: asyncio.Queue = asyncio.Queue(
        maxsize=sem_ref_settings.concurrency * 2
    )
    outcome_queue: asyncio.Queue = asyncio.Queue(
        maxsize=sem_ref_settings.concurrency * 2
    )
    watermark = StopWatermark()
    feed_state = FeedState(next_message_id=initial_message_id)

    errors_seen: list[Exception] = []
    commit_stage_task: asyncio.Task[CommitStats] | None = None
    try:
        async with asyncio.TaskGroup() as tg:
            tg.create_task(
                _feed_stage(
                    messages,
                    task_queue,
                    watermark,
                    feed_state,
                    outcome_queue,
                    shutdown_event=shutdown_event,
                )
            )
            tg.create_task(
                _fanout_stage(
                    task_queue,
                    outcome_queue,
                    watermark,
                    knowledge_extractor,
                    embedding_model,
                    concurrency=sem_ref_settings.concurrency,
                    skip_failed_messages=skip_failed_messages,
                )
            )
            commit_stage_task = tg.create_task(
                _commit_stage(
                    outcome_queue,
                    watermark,
                    next_commit_ordinal=initial_message_id,
                    chunk_commit_target=batch_size,
                    commit_batch=_commit_batch,
                    skip_failed_messages=skip_failed_messages,
                    on_message_skipped=_record_skipped_failures,
                )
            )
    except ExceptionGroup as eg:
        errors_seen.extend(eg.exceptions)
    except Exception as exc:
        errors_seen.append(exc)

    if feed_state.exception is not None:
        errors_seen.append(feed_state.exception)
    if watermark.exception is not None and not skip_failed_messages:
        errors_seen.append(watermark.exception)

    if errors_seen:
        distinct: list[Exception] = []
        for exc in errors_seen:
            if exc not in distinct:
                distinct.append(exc)
        if len(distinct) == 1:
            raise distinct[0]
        raise ExceptionGroup("add_messages_streaming failed", distinct)

    if skip_failed_messages and commit_stage_task is not None:
        try:
            total.messages_skipped = commit_stage_task.result().messages_skipped
        except Exception:
            pass

    return total
