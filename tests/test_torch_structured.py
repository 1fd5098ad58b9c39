"""The port's typed translator against the JAX package's pydantic one.

``typeagent_tpu_torch/models/structured.py`` renders its prompt's JSON
schema with ``knowpro.fields.json_schema`` and validates a response with
``json`` + ``fields.deserialize_object``. Here, for the three schema types
the query path and ingest translate into (``SearchQuery``,
``AnswerResponse``, ``kplib.KnowledgeResponse``) and for every camelCase
dataclass of the port:

* the rendered schema equals pydantic's ``TypeAdapter(T).json_schema()``
  as parsed JSON, and as the prompt's ``json.dumps(..., indent=2)`` text;
* seed-made responses, valid ones and ones broken at a random place, give
  ``Success`` in the port exactly where pydantic's ``validate_json`` gives
  it, and the same object (serialized) when they do;
* the repair round trip asks the model the same prompts and ends the same
  (error text may differ, so the repair prompt is compared up to it).
"""

import asyncio
import copy
import json

import numpy as np
import pytest
from pydantic import TypeAdapter

import typeagent_tpu.knowpro.fields as jax_fields
from typeagent_tpu.knowpro import answer_response_schema as jax_answer
from typeagent_tpu.knowpro import interfaces as jax_interfaces
from typeagent_tpu.knowpro import kplib as jax_kplib
from typeagent_tpu.knowpro import search_query_schema as jax_query
from typeagent_tpu.models import adapters as jax_adapters
from typeagent_tpu.models import structured as jax_structured
from typeagent_tpu.models.result import Success as JaxSuccess
from typeagent_tpu_torch.knowpro import answer_response_schema as port_answer
from typeagent_tpu_torch.knowpro import date_time_schema as port_dates
from typeagent_tpu_torch.knowpro import fields
from typeagent_tpu_torch.knowpro import interfaces as port_interfaces
from typeagent_tpu_torch.knowpro import kplib as port_kplib
from typeagent_tpu_torch.knowpro import search_query_schema as port_query
from typeagent_tpu_torch.knowpro import serialization as port_serialization
from typeagent_tpu_torch.models import adapters as port_adapters
from typeagent_tpu_torch.models import structured as port_structured
from typeagent_tpu_torch.models.result import Success

SCHEMAS = {
    "SearchQuery": (jax_query.SearchQuery, port_query.SearchQuery),
    "AnswerResponse": (jax_answer.AnswerResponse, port_answer.AnswerResponse),
    "KnowledgeResponse": (jax_kplib.KnowledgeResponse, port_kplib.KnowledgeResponse),
}
JAX_MODULES = {
    port_kplib: jax_kplib, port_interfaces: jax_interfaces, port_query: jax_query,
    port_answer: jax_answer,
}
ALL_CLASSES = [
    (mod, name)
    for mod in JAX_MODULES
    for name, obj in sorted(vars(mod).items())
    if isinstance(obj, type) and fields.is_camel_dataclass(obj) and obj.__module__ == mod.__name__
]


def _jax_class(mod, name):
    return getattr(JAX_MODULES[mod], name)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schema_equals_pydantic(name):
    jax_cls, port_cls = SCHEMAS[name]
    ref = TypeAdapter(jax_cls).json_schema()
    got = fields.json_schema(port_cls)
    assert got == ref
    assert json.dumps(got, indent=2) == json.dumps(ref, indent=2)


@pytest.mark.parametrize(
    "mod,name", ALL_CLASSES, ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n in ALL_CLASSES]
)
def test_every_dataclass_schema_equals_pydantic(mod, name):
    """Recursive classes, ``type`` aliases, datetimes, sets and dicts too."""
    ref = TypeAdapter(_jax_class(mod, name)).json_schema()
    assert fields.json_schema(getattr(mod, name)) == ref


def test_date_time_schema_equals_pydantic():
    from typeagent_tpu.knowpro import date_time_schema as jax_dates

    for name in ("DateVal", "TimeVal", "DateTime", "DateTimeRange"):
        assert fields.json_schema(getattr(port_dates, name)) == TypeAdapter(
            getattr(jax_dates, name)
        ).json_schema()


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_request_prompt_is_the_same_text(name):
    jax_cls, port_cls = SCHEMAS[name]
    jax_t = jax_structured.TypedTranslator(jax_adapters.FakeChatModel(), jax_cls)
    port_t = port_structured.TypedTranslator(port_adapters.FakeChatModel(), port_cls)
    request = "What did Bach write in 1720?"
    assert port_t.make_request_prompt(request) == jax_t.make_request_prompt(request)


# ---------------------------------------------------------------------------
# Seed-made responses
# ---------------------------------------------------------------------------

WORDS = ["Bach", "fugue", "organ", "Leipzig", "we", "*", "book", "color", "red", "none"]


def _word(rng):
    return str(rng.choice(WORDS))


def _entity_term(rng):
    out = {"name": _word(rng), "isNamePronoun": bool(rng.integers(2))}
    if rng.integers(2):
        out["type"] = [_word(rng) for _ in range(rng.integers(0, 3))]
    if rng.integers(2):
        out["facets"] = [
            {"facetName": _word(rng), "facetValue": _word(rng)} for _ in range(rng.integers(0, 3))
        ]
    return out


def _date_time(rng):
    out = {"date": {"day": int(rng.integers(1, 29)), "month": int(rng.integers(1, 13)),
                    "year": int(rng.integers(1990, 2030))}}
    if rng.integers(2):
        out["time"] = {"hour": int(rng.integers(24)), "minute": int(rng.integers(60)),
                       "seconds": int(rng.integers(60))}
    return out


def _search_query(rng):
    exprs = []
    for _ in range(rng.integers(1, 3)):
        filters = []
        for _ in range(rng.integers(1, 3)):
            f = {}
            if rng.integers(2):
                actors = "*" if rng.integers(3) == 0 else [_entity_term(rng)]
                action = {"actorEntities": actors, "isInformational": bool(rng.integers(2))}
                if rng.integers(2):
                    action["actionVerbs"] = {
                        "words": [_word(rng)],
                        "tense": str(rng.choice(["Past", "Present", "Future"])),
                    }
                if rng.integers(2):
                    action["targetEntities"] = [_entity_term(rng)]
                f["actionSearchTerm"] = action
            if rng.integers(2):
                f["entitySearchTerms"] = [_entity_term(rng) for _ in range(rng.integers(1, 3))]
            if rng.integers(2):
                f["searchTerms"] = [_word(rng) for _ in range(rng.integers(0, 3))]
            if rng.integers(3) == 0:
                f["timeRange"] = {"startDate": _date_time(rng)}
                if rng.integers(2):
                    f["timeRange"]["stopDate"] = _date_time(rng)
            filters.append(f)
        exprs.append({"rewrittenQuery": f"find {_word(rng)}", "filters": filters})
    return {"searchExpressions": exprs}


def _answer(rng):
    out = {"type": str(rng.choice(["Answered", "NoAnswer"]))}
    if rng.integers(2):
        out["answer"] = f"{_word(rng)} wrote it"
    if rng.integers(2):
        out["whyNoAnswer"] = "nothing relevant"
    return out


def _value(rng):
    kind = rng.integers(5)
    if kind == 0:
        return _word(rng)
    if kind == 1:
        return float(rng.integers(0, 100)) / 4
    if kind == 2:
        return bool(rng.integers(2))
    if kind == 3:
        return {"amount": float(rng.integers(1, 9)), "units": "kg"}
    return {"amount": "many", "units": "cups"}


def _action(rng):
    out = {"verbs": [_word(rng)], "verbTense": str(rng.choice(["past", "present", "future"]))}
    for key in ("subjectEntityName", "objectEntityName", "indirectObjectEntityName"):
        if rng.integers(2):
            out[key] = _word(rng)
    if rng.integers(2):
        out["params"] = [_word(rng) if rng.integers(2) else {"name": _word(rng), "value": _value(rng)}]
    if rng.integers(3) == 0:
        out["subjectEntityFacet"] = {"name": _word(rng), "value": _value(rng)}
    return out


def _knowledge(rng):
    entities = []
    for _ in range(rng.integers(0, 3)):
        e = {"name": _word(rng), "type": [_word(rng)]}
        if rng.integers(2):
            e["facets"] = [{"name": _word(rng), "value": _value(rng)}]
        entities.append(e)
    return {
        "entities": entities,
        "actions": [_action(rng) for _ in range(rng.integers(0, 2))],
        "inverseActions": [_action(rng) for _ in range(rng.integers(0, 2))],
        "topics": [_word(rng) for _ in range(rng.integers(0, 3))],
    }


MAKERS = {"SearchQuery": _search_query, "AnswerResponse": _answer, "KnowledgeResponse": _knowledge}
REPLACEMENTS = [
    None, 0, 1, 3, 3.0, 3.5, -2, "3", "x", "", "*", "none", "true", "false", "yes", "Past",
    "past", "Answered", True, False, [], ["x"], [1], {}, {"name": "x"}, {"amount": 2, "units": "kg"},
]


def _paths(value, path=()):
    yield path
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _paths(v, path + (k,))
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from _paths(v, path + (i,))


def _mutate(rng, obj):
    """``obj`` broken (or not) at one random place."""
    obj = copy.deepcopy(obj)
    paths = [p for p in _paths(obj) if p]
    if not paths:
        return obj
    path = paths[rng.integers(len(paths))]
    parent = obj
    for key in path[:-1]:
        parent = parent[key]
    key = path[-1]
    op = rng.integers(4)
    if op == 0 and isinstance(parent, dict):
        del parent[key]
    elif op == 1 and isinstance(parent, dict):
        parent[f"extra{rng.integers(9)}"] = REPLACEMENTS[rng.integers(len(REPLACEMENTS))]
    elif op == 2 and isinstance(parent[key], list) and parent[key]:
        parent[key] = parent[key][0]
    else:
        parent[key] = copy.deepcopy(REPLACEMENTS[rng.integers(len(REPLACEMENTS))])
    return obj


def _texts(rng, name, n):
    """Responses as a model writes them: JSON, some in prose, some broken."""
    make = MAKERS[name]
    out = []
    for i in range(n):
        obj = make(rng)
        if i % 4:
            obj = _mutate(rng, obj)
        text = json.dumps(obj)
        if i % 7 == 3:
            text = f"Here is the JSON:\n{text}\nDone."
        if i % 11 == 5:
            text = text[:-1]  # cut short
        if i % 13 == 6:
            text = "no json at all"
        out.append(text)
    return out


def _outcome(translator, dump, text):
    result = translator._validate(text)
    ok = type(result).__name__ == "Success"
    return ok, (dump(result.value) if ok else None)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_validation_accepts_and_refuses_as_pydantic(name, seed):
    jax_cls, port_cls = SCHEMAS[name]
    jax_t = jax_structured.TypedTranslator(jax_adapters.FakeChatModel(), jax_cls)
    port_t = port_structured.TypedTranslator(port_adapters.FakeChatModel(), port_cls)
    rng = np.random.default_rng(1000 * seed + len(name))
    accepted = 0
    for text in _texts(rng, name, 60):
        want = _outcome(jax_t, jax_fields.serialize_object, text)
        got = _outcome(port_t, fields.serialize_object, text)
        assert got == want, text
        accepted += want[0]
    assert 0 < accepted < 60  # both kinds were tried


def _run(coro):
    return asyncio.run(coro)


@pytest.mark.parametrize(
    "responses",
    [
        ['{"type": "Answered", "answer": "yes"}'],
        ['{"type": "Maybe"}', '{"type": "Answered", "answer": "fixed"}'],
        ["not json", '{"type": "NoAnswer", "whyNoAnswer": "none"}'],
        ['{"type": "Maybe"}', '{"answer": "still no type"}'],
        ['{"type": "Maybe"}'],
    ],
    ids=["first", "repaired", "repaired-from-prose", "repair-fails", "model-runs-dry"],
)
def test_repair_round_trip_as_jax(responses):
    jax_model = jax_adapters.FakeChatModel(list(responses))
    port_model = port_adapters.FakeChatModel(list(responses))
    jax_t = jax_structured.TypedTranslator(jax_model, jax_answer.AnswerResponse)
    port_t = port_structured.TypedTranslator(port_model, port_answer.AnswerResponse)
    want = _run(jax_t.translate("Did Bach write fugues?", prompt_preamble="Context."))
    got = _run(port_t.translate("Did Bach write fugues?", prompt_preamble="Context."))
    assert isinstance(got, Success) == isinstance(want, JaxSuccess)
    if isinstance(got, Success):
        assert fields.serialize_object(got.value) == jax_fields.serialize_object(want.value)
    assert len(port_model.prompts) == len(jax_model.prompts)
    for port_prompt, jax_prompt in zip(port_model.prompts, jax_model.prompts):
        assert len(port_prompt) == len(jax_prompt)
        for p, j in zip(port_prompt, jax_prompt):
            assert p["role"] == j["role"]
            if p["content"].startswith("The JSON was invalid: "):  # error text may differ
                assert j["content"].startswith("The JSON was invalid: ")
                assert p["content"].endswith("\nRespond with corrected JSON only.")
            else:
                assert p["content"] == j["content"]


def test_translator_imports_no_pydantic():
    import ast
    import pathlib

    path = pathlib.Path(port_structured.__file__)
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert "pydantic" not in roots


def test_serialize_refuses_what_is_not_a_dataclass():
    """The JAX package's TypeError, in the port's own words (the mirrored
    serialization suite asserts pydantic's text; see test_torch_query_suites)."""
    with pytest.raises(TypeError, match="camelCase dataclass"):
        port_serialization.serialize_object({"plain": "dict"})
    with pytest.raises(TypeError, match="Pydantic dataclass"):
        from typeagent_tpu.knowpro import serialization as jax_serialization

        jax_serialization.serialize_object({"plain": "dict"})
