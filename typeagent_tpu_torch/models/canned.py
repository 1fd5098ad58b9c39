"""Recorded/crafted LLM replay: hermetic chat model for 4-stage golden evals.

The reference's ``make eval`` exercises answer generation against recorded
LLM output (reference ``Makefile:38-42``, ``tools/query.py:1275-1347``).
This module provides the equivalent without network: a chat model that

  * **replays recorded stage-1 translations** — the reference's
    ``Episode_53_Search_results.json`` ships each query's real LLM
    ``searchQueryExpr``; since our ``SearchQuery`` schema validates by the
    same camelCase aliases, the recorded JSON is returned verbatim; and
  * **crafts deterministic stage-4/combine completions** from the prompt
    itself — entities/topics are extracted from the ``[ANSWER CONTEXT]``
    block and composed into an answer, so ``generate_answers`` →
    ``combine_answers`` run their REAL machinery (chunking, merge, blend)
    over stable text with no network.

Everything is a pure function of the prompt, so golden files pin the full
pipeline: stage 1 (recorded translate) → stage 2/3 (real compile+search) →
stage 4 (real answer plumbing over crafted completions).

The port of ``typeagent_tpu/models/canned.py`` (plain Python, the same code).
"""

from __future__ import annotations

import json
import re

from .result import Failure, Result, Success
from .structured import PromptSection

# Prompt fingerprints (the literal strings our translators emit; see
# knowpro/searchlang.py:create_search_query_translator,
# knowpro/answers.py:create_question_prompt/combine_answers).
_STAGE1_MARK = '"SearchQuery"'
_COMBINE_MARK = "*** Original Question ***"
_ANSWER_MARK = "[ANSWER CONTEXT]"

_REQUEST_RE = re.compile(r'"""\n(.*?)\n"""', re.DOTALL)
_NAME_RE = re.compile(r"'name': '([^']+)'")
# Topics pprint as {'knowledge_type': 'topic', 'text': ...}; pprint may wrap
# between the keys at width 200, hence \s* instead of a literal space.
_TOPIC_RE = re.compile(r"'knowledge_type': 'topic',\s*'text': '([^']+)'")


def _request_text(prompt: str) -> str:
    m = _REQUEST_RE.search(prompt)
    return m.group(1) if m else prompt


class CannedChatModel:
    """Hermetic chat model: recorded stage-1 JSON + crafted stage-4 answers.

    ``stage1``: mapping of question text -> the recorded camelCase
    ``searchQueryExpr`` JSON object for it (matched by containment, since
    the live translate request may wrap the question in time-range
    preamble). ``max_items`` bounds how many extracted entities/topics a
    crafted answer lists (keeps goldens readable).
    """

    model_name = "canned-replay"

    def __init__(self, stage1: dict[str, dict] | None = None, max_items: int = 10):
        self.stage1 = stage1 or {}
        self.max_items = max_items
        self.calls = {"stage1": 0, "answer": 0, "combine": 0}

    async def complete(self, sections: list[PromptSection]) -> Result[str]:
        prompt = sections[-1]["content"] if sections else ""
        if _STAGE1_MARK in prompt:
            return self._stage1(prompt)
        if _COMBINE_MARK in prompt:
            return self._combine(prompt)
        if _ANSWER_MARK in prompt:
            return self._answer(prompt)
        return Failure("CannedChatModel: unrecognized prompt shape")

    # -- stage 1: recorded translation replay --------------------------------

    def _stage1(self, prompt: str) -> Result[str]:
        self.calls["stage1"] += 1
        request = _request_text(prompt)
        for question, recorded in self.stage1.items():
            if question in request:
                return Success(json.dumps(recorded))
        return Failure(
            f"CannedChatModel: no recorded translation matches {request[:120]!r}"
        )

    # -- stage 4: crafted answer from the context block ----------------------

    def _answer(self, prompt: str) -> Result[str]:
        self.calls["answer"] += 1
        context = prompt[prompt.index(_ANSWER_MARK):]
        # Entity/topic mentions in the pformat'd context dict. Order of
        # first appearance, deduped: stable because the context itself is
        # golden-pinned upstream.
        entities = list(dict.fromkeys(_NAME_RE.findall(context)))
        topics = list(dict.fromkeys(_TOPIC_RE.findall(context)))
        if not entities and not topics:
            return Success(
                json.dumps(
                    {
                        "type": "NoAnswer",
                        "whyNoAnswer": "No relevant entities or topics in context.",
                    }
                )
            )
        parts = []
        if entities:
            parts.append(", ".join(entities[: self.max_items]))
        if topics:
            parts.append("topics: " + "; ".join(topics[: self.max_items]))
        return Success(
            json.dumps({"type": "Answered", "answer": ". ".join(parts) + "."})
        )

    # -- combine: blend partial answers (dedup, keep order) ------------------

    def _combine(self, prompt: str) -> Result[str]:
        self.calls["combine"] += 1
        body = prompt[prompt.index(_COMBINE_MARK):]
        partials = [
            chunk.strip()
            for chunk in body.split("===")[1:]
            if chunk.strip()
        ]
        seen: dict[str, None] = {}
        for p in partials:
            for piece in p.split(". "):
                piece = piece.strip().rstrip(".")
                if piece:
                    seen.setdefault(piece)
        blended = ". ".join(seen) + "."
        return Success(json.dumps({"type": "Answered", "answer": blended}))
