"""Parity: the port's data model (``typeagent_tpu_torch/knowpro``: stdlib
dataclasses with a type-hint walker, ``fields.py``) against the JAX
package's pydantic dataclasses.

For every dataclass of ``kplib``, ``interfaces`` and ``universal_message``:
the same camelCase input deserializes in both packages to objects whose
``serialize_object`` outputs are equal (with and without None fields, and
through ``serialization.serialize_object``, which keeps None); each
package reads the other's output back to the same data; the ``listeners``
alias is read; unknown keys are ignored; lax inputs coerce the same way;
and the same bad inputs raise in both (a ``ValueError`` from
``fields.deserialize_object``, a ``DeserializationError`` from
``serialization.deserialize_object``).
"""

import dataclasses
from datetime import datetime, timezone

import pytest

from typeagent_tpu.knowpro import fields as jfields
from typeagent_tpu.knowpro import interfaces as jinterfaces
from typeagent_tpu.knowpro import kplib as jkplib
from typeagent_tpu.knowpro import serialization as jser
from typeagent_tpu.knowpro import universal_message as jum

from typeagent_tpu_torch.knowpro import fields, interfaces, kplib, serialization
from typeagent_tpu_torch.knowpro import universal_message as um

LOC = {"messageOrdinal": 3, "chunkOrdinal": 1}
RANGE = {"start": {"messageOrdinal": 1}, "end": {"messageOrdinal": 4, "chunkOrdinal": 2}}
ENTITY = {"name": "Bach", "type": ["person", "composer"],
          "facets": [{"name": "born", "value": 1685.0}, {"name": "weight", "value": {"amount": 70, "units": "kg"}},
                     {"name": "kids", "value": {"amount": "many", "units": "children"}},
                     {"name": "famous", "value": True}, {"name": "city", "value": "Leipzig"}]}
ACTION = {"verbs": ["compose", "write"], "verbTense": "past", "subjectEntityName": "Bach",
          "objectEntityName": "fugue", "params": ["quickly", {"name": "key", "value": "C minor"}],
          "subjectEntityFacet": {"name": "hobby", "value": "organ"}}
TERM_GROUP = {"booleanOp": "or", "terms": [
    {"term": {"text": "bach", "weight": 0.5}, "relatedTerms": [{"text": "js bach"}]},
    {"propertyName": "name", "propertyValue": {"term": {"text": "bach"}}},
    {"propertyName": {"term": {"text": "hue"}}, "propertyValue": {"term": {"text": "red"}}},
    {"booleanOp": "and", "terms": [{"term": {"text": "x"}}]},
]}

# Inputs per class: each deserializes in both packages.
SAMPLES = {
    "Quantity": [{"amount": 2.5, "units": "kg"}, {"amount": 3, "units": "m"}],
    "Quantifier": [{"amount": "few", "units": "people"}],
    "Facet": ENTITY["facets"],
    "ConcreteEntity": [ENTITY, {"name": "frog", "type": ["animal"]}, {"name": "x", "type": [], "facets": None}],
    "ActionParam": [{"name": "p", "value": 2.0}, {"name": "p", "value": "v"}],
    "Action": [ACTION, {"verbs": ["say"], "verbTense": "present"}],
    "KnowledgeResponse": [{"entities": [ENTITY], "actions": [ACTION], "inverseActions": [], "topics": ["music"]}],
    "DeletionInfo": [{"timestamp": "2024-01-01T00:00:00Z"}, {"timestamp": "t", "reason": "spam"}],
    "IndexingStartPoints": [{"messageCount": 4, "semrefCount": 9}],
    "AddMessagesResult": [{}, {"messagesAdded": 2, "chunksAdded": 3, "semrefsAdded": 7, "messagesSkipped": 1}],
    "ScoredSemanticRefOrdinal": [{"semanticRefOrdinal": 5, "score": 0.75}],
    "ScoredMessageOrdinal": [{"messageOrdinal": 5, "score": 0.25}],
    "TextLocation": [LOC, {"messageOrdinal": 0}],
    "TextRange": [RANGE, {"start": LOC}, {"start": LOC, "end": None}],
    "Topic": [{"text": "music"}],
    "Tag": [{"text": "urgent"}],
    "SemanticRef": [{"semanticRefOrdinal": 2, "range": RANGE, "knowledge": ENTITY},
                    {"semanticRefOrdinal": 3, "range": {"start": LOC}, "knowledge": {"text": "music"}}],
    "DateRange": [{"start": "2024-01-01T00:00:00Z", "end": "2024-02-01T12:30:00+00:00"}, {"start": "2024-03-01"}],
    "Term": [{"text": "bach"}, {"text": "bach", "weight": 0.5}],
    "TimestampedTextRange": [{"timestamp": "2024-01-01T00:00:00", "range": RANGE}],
    "Thread": [{"description": "about music", "ranges": [RANGE, {"start": LOC}]}],
    "ScoredThreadOrdinal": [{"threadOrdinal": 1, "score": 0.5}],
    "ConversationMetadata": [{}, {"nameTag": "chat", "schemaVersion": 1, "createdAt": "2024-01-01T00:00:00Z",
                                  "updatedAt": "2024-01-02T00:00:00+02:00", "embeddingModel": "test",
                                  "tags": ["a"], "extra": {"k": "v"}}],
    "ChunkFailure": [{"messageOrdinal": 1, "chunkOrdinal": 0, "errorClass": "ValueError",
                      "errorMessage": "bad", "failedAt": "2024-01-01T00:00:00Z"}],
    "SearchTerm": [{"term": {"text": "bach"}}, TERM_GROUP["terms"][0]],
    "PropertySearchTerm": TERM_GROUP["terms"][1:3],
    "SearchTermGroup": [TERM_GROUP, {"booleanOp": "or_max"}],
    "WhenFilter": [{}, {"knowledgeType": "entity", "dateRange": {"start": "2024-01-01T00:00:00Z"},
                        "threadDescription": "music", "tags": ["a"], "scopeDefiningTerms": TERM_GROUP,
                        "textRangesInScope": [RANGE]}],
    "SearchSelectExpr": [{"searchTermGroup": TERM_GROUP, "when": {"knowledgeType": "topic"}}],
    "SemanticRefSearchResult": [{"termMatches": ["a", "b"],
                                 "semanticRefMatches": [{"semanticRefOrdinal": 1, "score": 1.0}]}],
    "ConversationMessageMeta": [{"speaker": "Ann", "listeners": ["Bob", "Cy"]}, {"speaker": None},
                                {"recipients": ["Dee"]}],
    "ConversationMessage": [
        {"textChunks": ["hi", "there"], "metadata": {"speaker": "Ann", "listeners": ["Bob"]},
         "tags": ["t"], "timestamp": "2024-01-01T00:00:00Z", "sourceId": "m1"},
        {"textChunks": ["hi"], "metadata": {}},
    ],
}


def _module_classes(mod):
    return {
        name: obj for name, obj in vars(mod).items()
        if isinstance(obj, type) and dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__
    }


def _pairs():
    out = {}
    for jmod, pmod in ((jkplib, kplib), (jinterfaces, interfaces), (jum, um)):
        jcls, pcls = _module_classes(jmod), _module_classes(pmod)
        assert set(jcls) == set(pcls), (jmod.__name__, set(jcls) ^ set(pcls))
        out.update({name: (jcls[name], pcls[name]) for name in jcls})
    return out


PAIRS = _pairs()
CASES = [(name, i) for name in sorted(SAMPLES) for i in range(len(SAMPLES[name]))]


def test_every_dataclass_has_samples():
    assert set(PAIRS) == set(SAMPLES)
    assert len(PAIRS) == 32  # 7 in kplib, 23 in interfaces, 2 in universal_message


@pytest.mark.parametrize("name,i", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_same_data_both_ways(name, i):
    jcls, pcls = PAIRS[name]
    data = SAMPLES[name][i]
    jobj = jfields.deserialize_object(jcls, data)
    pobj = fields.deserialize_object(pcls, data)
    for exclude_none in (True, False):
        want = jfields.serialize_object(jobj, exclude_none=exclude_none)
        assert fields.serialize_object(pobj, exclude_none=exclude_none) == want
    assert serialization.serialize_object(pobj) == jser.serialize_object(jobj)
    # Each package reads the other's output back to the same data.
    port_out = fields.serialize_object(pobj)
    jax_out = jfields.serialize_object(jobj)
    assert jfields.serialize_object(jfields.deserialize_object(jcls, port_out)) == jax_out
    assert fields.serialize_object(fields.deserialize_object(pcls, jax_out)) == port_out
    assert serialization.serialize_object(serialization.deserialize_object(pcls, jser.serialize_object(jobj))) \
        == jser.serialize_object(jobj)


def test_listeners_alias_and_unknown_keys():
    for data in ({"speaker": "Ann", "listeners": ["Bob"]}, {"speaker": "Ann", "recipients": ["Bob"], "zz": 1},
                 {"speaker": "Ann", "listeners": ["Cy"], "recipients": ["Bob"]}):
        pmeta = fields.deserialize_object(um.ConversationMessageMeta, data)
        jmeta = jfields.deserialize_object(jum.ConversationMessageMeta, data)
        assert pmeta.recipients == jmeta.recipients == ["Bob"]
        assert fields.serialize_object(pmeta) == {"speaker": "Ann", "listeners": ["Bob"]}
    msg = {"textChunks": ["a"], "metadata": {"speaker": "S", "listeners": ["L"]}, "unknown": {"x": 1},
           "deletionInfo": {"timestamp": "t"}}
    pm = um.ConversationMessage.deserialize(msg)
    jm = jum.ConversationMessage.deserialize(msg)
    assert pm.serialize() == jm.serialize()
    assert pm.get_knowledge().entities == [kplib.ConcreteEntity(name="S", type=["person"]),
                                           kplib.ConcreteEntity(name="L", type=["person"])]
    assert fields.serialize_object(pm.get_knowledge()) == jfields.serialize_object(jm.get_knowledge())


# Inputs both packages accept by coercion, with the same result.
LAX = [
    ("TextLocation", {"messageOrdinal": "3", "chunk_ordinal": 2.0}),
    ("TextLocation", {"message_ordinal": True}),
    ("Quantity", {"amount": "3.5", "units": "kg"}),
    ("Quantity", {"amount": True, "units": "kg"}),
    ("ScoredSemanticRefOrdinal", {"semanticRefOrdinal": 1, "score": 1}),
    ("Facet", {"name": "a", "value": 1}),
    ("Facet", {"name": "a", "value": "1"}),
    ("Facet", {"name": "a", "value": {"amount": "3", "units": "u"}}),
    ("ConcreteEntity", {"name": "a", "type": ("x", "y")}),
    ("Thread", {"description": "d", "ranges": ({"start": {"messageOrdinal": 0}},)}),
    ("ConversationMetadata", {"createdAt": 0, "updatedAt": 1_700_000_000.5}),
    ("ConversationMetadata", {"createdAt": "2024-01-01T00:00:00Z", "schemaVersion": "2"}),
    ("SemanticRefSearchResult", {"termMatches": ("a",), "semanticRefMatches": []}),
]


@pytest.mark.parametrize("name,data", LAX, ids=[f"{n}-{i}" for i, (n, _) in enumerate(LAX)])
def test_lax_inputs_coerce_the_same(name, data):
    jcls, pcls = PAIRS[name]
    got = fields.serialize_object(fields.deserialize_object(pcls, data), exclude_none=False)
    want = jfields.serialize_object(jfields.deserialize_object(jcls, data), exclude_none=False)
    assert got == want


BAD = [
    ("TextLocation", {}),
    ("TextLocation", {"messageOrdinal": 3.5}),
    ("TextLocation", {"messageOrdinal": "three"}),
    ("TextLocation", [3, 1]),
    ("Quantity", {"amount": "x", "units": "kg"}),
    ("Quantity", {"amount": 3, "units": 5}),
    ("Facet", {"name": "a", "value": None}),
    ("Facet", {"name": "a", "value": [1]}),
    ("ConcreteEntity", {"name": "a", "type": "x"}),
    ("ConcreteEntity", {"type": ["x"]}),
    ("Action", {"verbs": ["a"], "verbTense": "PAST"}),
    ("Action", {"verbs": ["a"]}),
    ("SemanticRef", {"semanticRefOrdinal": 1, "range": RANGE, "knowledge": {"bogus": 1}}),
    ("SearchTermGroup", {"booleanOp": "xor"}),
    ("ConversationMessage", {"metadata": {}}),
    ("ConversationMessage", {"textChunks": "abc", "metadata": {}}),
    ("ConversationMessageMeta", {"listeners": "Bob"}),
    ("DateRange", {"start": "not a date"}),
    ("ChunkFailure", {"messageOrdinal": 1}),
]


@pytest.mark.parametrize("name,data", BAD, ids=[f"{n}-{i}" for i, (n, _) in enumerate(BAD)])
def test_bad_inputs_raise_in_both(name, data):
    jcls, pcls = PAIRS[name]
    with pytest.raises(ValueError):
        jfields.deserialize_object(jcls, data)
    with pytest.raises(ValueError):
        fields.deserialize_object(pcls, data)
    with pytest.raises(jser.DeserializationError):
        jser.deserialize_object(jcls, data)
    with pytest.raises(serialization.DeserializationError):
        serialization.deserialize_object(pcls, data)


@pytest.mark.parametrize("kind,data", [
    ("entity", ENTITY), ("action", ACTION), ("topic", {"text": "t"}), ("tag", {"text": "g"}),
])
def test_deserialize_knowledge(kind, data):
    p = serialization.deserialize_knowledge(kind, data)
    j = jser.deserialize_knowledge(kind, data)
    assert p.knowledge_type == j.knowledge_type == kind
    assert serialization.serialize_object(p) == jser.serialize_object(j)


def test_generic_and_union_types():
    data = [LOC, {"messageOrdinal": 9}]
    got = serialization.deserialize_object(list[interfaces.TextLocation], data)
    want = jser.deserialize_object(list[jinterfaces.TextLocation], data)
    assert [fields.serialize_object(x) for x in got] == [jfields.serialize_object(x) for x in want]
    got = serialization.deserialize_object(interfaces.TextLocation | interfaces.Term, {"text": "a"})
    assert got == interfaces.Term("a")
    with pytest.raises(serialization.DeserializationError):
        serialization.deserialize_object(list[interfaces.TextLocation], {"x": 1})


def test_serialize_object_refuses_other_types():
    for fn in (serialization.serialize_object, fields.serialize_object):
        with pytest.raises(TypeError):
            fn({"a": 1})
    assert serialization.serialize_object(None) is None


def test_ordering_hashing_and_ranges():
    """The dataclass options the query layer relies on: TextLocation
    orders, Term hashes, TextRange compares by its effective end."""
    a, b = interfaces.TextLocation(1, 0), interfaces.TextLocation(1, 2)
    assert a < b and sorted([b, a]) == [a, b]
    assert len({interfaces.Term("x"), interfaces.Term("x"), interfaces.Term("x", 0.5)}) == 2
    r = interfaces.TextRange(interfaces.TextLocation(2))
    assert r == interfaces.TextRange(interfaces.TextLocation(2), interfaces.TextLocation(2, 1))
    assert r in interfaces.TextRange(interfaces.TextLocation(0), interfaces.TextLocation(5))
    when = datetime(2024, 1, 1, tzinfo=timezone.utc)
    assert when in interfaces.DateRange(when) and when not in interfaces.DateRange(when, when)
    fast = interfaces.ScoredSemanticRefOrdinal.fast(4, 0.5)
    assert fast == interfaces.ScoredSemanticRefOrdinal(4, 0.5)
    assert fast.serialize() == jinterfaces.ScoredSemanticRefOrdinal.fast(4, 0.5).serialize()


def test_construction_validates_as_pydantic():
    """Constructing a dataclass in code coerces and checks as the JAX
    package's pydantic ``__init__`` does; lists are copied."""
    assert kplib.Facet("pages", 350).value == jkplib.Facet("pages", 350).value == 350.0
    assert isinstance(kplib.Facet("pages", 350).value, float)
    assert interfaces.TextLocation("3") == interfaces.TextLocation(3)
    types = ["person"]
    for mod in (kplib, jkplib):
        entity = mod.ConcreteEntity("x", types)
        assert entity.type == types and entity.type is not types
    for loc in (interfaces.TextLocation, jinterfaces.TextLocation):
        with pytest.raises(ValueError):
            loc("three")
    assert interfaces.SearchTermGroup("and").terms == []
    e = kplib.ConcreteEntity("x", ["t"], [kplib.Facet("n", 2)])
    je = jkplib.ConcreteEntity("x", ["t"], [jkplib.Facet("n", 2)])
    assert fields.serialize_object(e) == jfields.serialize_object(je)
