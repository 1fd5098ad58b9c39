"""Structured LLM translation: natural language -> validated typed object.

Standalone equivalent of typechat's ``TypeChatJsonTranslator`` (used by the
reference for knowledge extraction, query translation, and answers). The
translator renders the target type's JSON schema into the prompt, requests
strict JSON, extracts/parses the response, validates it, and makes one
repair attempt feeding the validation error back to the model.

The port of ``typeagent_tpu/models/structured.py`` without pydantic: the
schema text is :func:`knowpro.fields.json_schema` of the target type (the
same JSON, key for key, as pydantic's ``TypeAdapter(T).json_schema()``),
and a response is parsed with ``json`` and validated with
:func:`knowpro.fields.deserialize_object`, which accepts and refuses what
pydantic's ``validate_json`` does. Error text differs from pydantic's.
"""

from __future__ import annotations

import json
from typing import Generic, Protocol, TypedDict, TypeVar

from ..knowpro.fields import deserialize_object, json_schema
from .result import Failure, Result, Success

T = TypeVar("T")


class PromptSection(TypedDict):
    """A single chat prompt section ({"role", "content"})."""

    role: str
    content: str


class IChatModel(Protocol):
    """Anything that can complete a chat prompt: HTTP adapters, the MCP
    sampling bridge, deterministic fakes, the canned replay model."""

    async def complete(self, prompt: list[PromptSection]) -> Result[str]: ...


def extract_json(text: str) -> str | None:
    """Pull the first top-level JSON object/array out of a model response."""
    for open_ch, close_ch in (("{", "}"), ("[", "]")):
        start = text.find(open_ch)
        end = text.rfind(close_ch)
        if start >= 0 and end > start:
            return text[start : end + 1]
    return None


class TypedTranslator(Generic[T]):
    """Translate user requests into instances of a camelCase dataclass type."""

    def __init__(
        self,
        model: IChatModel,
        schema: type[T],
        *,
        type_name: str | None = None,
        instructions: str | None = None,
    ):
        self.model = model
        self.schema = schema
        self.type_name = type_name or getattr(schema, "__name__", "Response")
        self.instructions = instructions
        self._schema_text = json.dumps(json_schema(schema), indent=2)

    def make_request_prompt(self, request: str) -> str:
        intro = (
            self.instructions
            or f"You are a service that translates user requests into JSON objects "
            f'of type "{self.type_name}".'
        )
        return (
            f"{intro}\n"
            f'The JSON must satisfy this JSON Schema for type "{self.type_name}":\n'
            f"```\n{self._schema_text}\n```\n"
            f"The following is the user request:\n"
            f'"""\n{request}\n"""\n'
            f"Respond ONLY with the JSON object, no prose, no code fences."
        )

    def _validate(self, text: str) -> Result[T]:
        json_text = extract_json(text)
        if json_text is None:
            return Failure(f"Response contained no JSON: {text[:200]!r}")
        try:
            return Success(deserialize_object(self.schema, json.loads(json_text)))
        except ValueError as exc:  # a ValidationError too
            return Failure(f"JSON validation failed: {exc}")

    async def translate(
        self,
        request: str,
        *,
        prompt_preamble: str | list[PromptSection] | None = None,
    ) -> Result[T]:
        sections: list[PromptSection] = []
        if isinstance(prompt_preamble, str):
            sections.append({"role": "user", "content": prompt_preamble})
        elif prompt_preamble:
            sections.extend(prompt_preamble)
        sections.append({"role": "user", "content": self.make_request_prompt(request)})

        result = await self.model.complete(sections)
        if isinstance(result, Failure):
            return result
        validated = self._validate(result.value)
        if isinstance(validated, Success):
            return validated

        # One repair attempt: feed the error back (typechat-style).
        repair_sections = sections + [
            {"role": "assistant", "content": result.value},
            {
                "role": "user",
                "content": (
                    f"The JSON was invalid: {validated.message}\n"
                    f"Respond with corrected JSON only."
                ),
            },
        ]
        result = await self.model.complete(repair_sections)
        if isinstance(result, Failure):
            return result
        return self._validate(result.value)
