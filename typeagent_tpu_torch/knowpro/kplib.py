"""Knowledge data model — doubles as the LLM extraction schema.

JSON-parity with the reference's kplib (`knowpro/knowledge_schema.py`): the
field names and camelCase aliases must match so serialized conversations and
extraction prompts interoperate. Docstrings/Doc annotations feed the
extraction prompt's JSON schema.
"""
#
# NOTE ON SIMILARITY TO THE REFERENCE: this module is a wire/prompt CONTRACT,
# not logic (reference knowpro/knowledge_schema.py). The field names are the
# camelCase JSON format shared with the reference's serialized conversations
# (verified against its real Episode-53 fixture), and the Doc() strings are
# the literal text the extraction LLM sees — changing either would change
# behavior, so they intentionally match the reference schema word for word.
#

from __future__ import annotations

from typing import Annotated, ClassVar, Literal

from typing_extensions import Doc

from .fields import dataclass


@dataclass
class Quantity:
    """'amount' must be a number; do not infer amounts."""

    amount: float
    units: str

    def __str__(self) -> str:
        return f"{self.amount:g} {self.units}"


@dataclass
class Quantifier:
    """'amount' is a descriptive string, not a number; e.g. 'many', 'few', 'several', 'a lot of', 'some', 'dozens'."""

    amount: str
    units: str

    def __str__(self) -> str:
        return f"{self.amount} {self.units}"


type Value = str | float | bool | Quantity | Quantifier


@dataclass
class Facet:
    name: str
    value: Annotated[Value, Doc("Very concise values.")]

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.name!r}, {self.value!r})"


@dataclass
class ConcreteEntity:
    """Specific, tangible people, places, institutions or things only."""

    knowledge_type: ClassVar[Literal["entity"]] = "entity"

    name: Annotated[
        str,
        Doc("The name of the entity or thing, e.g. 'Bach', 'frog', 'piano'."),
    ]
    type: Annotated[
        list[str],
        Doc(
            "The types of the entity, e.g. 'person', 'artist', 'animal', "
            "'object', 'instrument', 'school', 'room', 'food'. An entity can "
            "have multiple types; types should be single words."
        ),
    ]
    facets: Annotated[
        list[Facet] | None,
        Doc(
            "Specific, inherent, defining, or non-immediate facets of the "
            "entity, e.g. 'blue', 'old', 'famous', 'sister', 'weight: 4 kg'. "
            "Trivial actions or state changes are not facets. Facets are "
            "concise 'properties'."
        ),
    ] = None

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.name!r}, {self.type}, {self.facets})"


@dataclass
class ActionParam:
    name: str
    value: Value


type VerbTense = Literal["past", "present", "future"]


@dataclass
class Action:
    knowledge_type: ClassVar[Literal["action"]] = "action"

    verbs: Annotated[list[str], Doc("Each verb is typically a word.")]
    verb_tense: Annotated[VerbTense, Doc("The tense of the verb")]
    subject_entity_name: Annotated[
        str | Literal["none"], Doc("The name of the subject entity")
    ] = "none"
    object_entity_name: Annotated[
        str | Literal["none"], Doc("The name of the object entity")
    ] = "none"
    indirect_object_entity_name: Annotated[
        str | Literal["none"], Doc("The name of the indirect object entity")
    ] = "none"
    params: list[str | ActionParam] | None = None
    subject_entity_facet: Annotated[
        Facet | None,
        Doc(
            "If the action implies an additional facet of the subject entity "
            "(hobbies, activities, interests, personality), provide it here."
        ),
    ] = None


@dataclass
class KnowledgeResponse:
    """Detailed and comprehensive knowledge response."""

    entities: list[ConcreteEntity]
    actions: Annotated[
        list[Action],
        Doc(
            "The 'subjectEntityName' and 'objectEntityName' must correspond "
            "to the 'name' of an entity listed in the 'entities' array."
        ),
    ]
    inverse_actions: Annotated[
        list[Action],
        Doc(
            "Actions that can also be expressed in reverse, e.g. "
            "(A gives to B) -> (B receives from A). If applicable, return the "
            "reverse form of the action, fully filled out."
        ),
    ]
    topics: Annotated[list[str], Doc("Detailed, descriptive topics and keywords.")]
