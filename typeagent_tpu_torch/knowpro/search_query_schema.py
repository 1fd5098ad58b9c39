"""LLM translation target for natural-language search queries.

(Parity: reference knowpro/search_query_schema.py — the Doc annotations feed
the translation prompt's JSON schema, camelCase aliases match.)

The port of ``typeagent_tpu/knowpro/search_query_schema.py``, on the port's
``fields.dataclass``; ``fields.json_schema`` renders the same schema.
"""
#
# NOTE ON SIMILARITY TO THE REFERENCE: this module is a wire/prompt CONTRACT,
# not logic. The field names are the camelCase JSON format shared with the
# reference's serialized data, and the Doc() strings are the literal text the
# LLM sees — changing either would change behavior, so they intentionally
# match the reference schema's semantics word for word.
#

from __future__ import annotations

from typing import Annotated, Literal

from typing_extensions import Doc

from .date_time_schema import DateTimeRange
from .fields import dataclass


@dataclass
class FacetTerm:
    facet_name: Annotated[
        str,
        Doc(
            "The name of the facet, such as 'color', 'profession', "
            "'patent number'; '*' means match any facet name."
        ),
    ]
    facet_value: Annotated[
        str,
        Doc(
            "The value of the facet, such as 'red', 'writer'; "
            "'*' means match any facet value."
        ),
    ]


@dataclass
class EntityTerm:
    """
    Use to find information about specific, tangible people, places,
    institutions or things only. This includes entities with particular
    facets. Abstract concepts or topics are not entityTerms; use strings for
    them. Any terms will match fuzzily.
    """

    name: Annotated[
        str,
        Doc(
            "The name of the entity or thing such as 'Bach', 'Great Gatsby', "
            "'frog' or 'piano' or 'we', 'I'; '*' means match any entity name."
        ),
    ]
    is_name_pronoun: bool
    type: Annotated[
        list[str] | None,
        Doc(
            "The specific types of the entity such as 'book', 'movie', 'song', "
            "'speaker', 'person', 'artist', 'animal', 'instrument', 'school', "
            "'room', 'museum', 'food' etc.\n"
            "Generic types like 'object', 'thing' etc. are NOT allowed.\n"
            "An entity can have multiple types; entity types should be single words."
        ),
    ] = None
    facets: Annotated[
        list[FacetTerm] | None,
        Doc(
            "Facet terms search for properties or attributes of the entity.\n"
            "E.g.: color(blue), profession(writer), author(*), aunt(Agatha), "
            "weight(4kg), phoneNumber(...), etc."
        ),
    ] = None


@dataclass
class VerbsTerm:
    words: Annotated[list[str], Doc("Individual words in single or compound verb.")]
    tense: Literal["Past", "Present", "Future"] = "Present"


@dataclass
class ActionTerm:
    actor_entities: Annotated[
        list[EntityTerm] | Literal["*"],
        Doc(
            "The origin of the action or information, typically the entity "
            "performing the action."
        ),
    ]
    is_informational: Annotated[
        bool,
        Doc(
            "Is the intent of the phrase translated to this ActionTerm to "
            "actually get information about specific entities?\n"
            "True: asking for specific information about an entity, such as "
            "'What is Mia's phone number?' or 'Where did Jane study?'\n"
            "False: involves actions and interactions between entities, such "
            "as 'What phone number did Mia mention in her note to Jane?'"
        ),
    ]
    action_verbs: Annotated[
        VerbsTerm | None, Doc("Action verbs describing the interaction.")
    ] = None
    target_entities: Annotated[
        list[EntityTerm] | None,
        Doc(
            "The recipient or target of the action or information.\n"
            "Action verbs can imply relevant facet names on the targetEntity. "
            "E.g. write -> writer, sing -> singer etc."
        ),
    ] = None
    additional_entities: Annotated[
        list[EntityTerm] | None,
        Doc(
            "Additional entities participating in the action.\n"
            "E.g. in 'Jane ate the spaghetti with the fork', 'the fork' is an "
            "additional entity. In 'Did Jane speak about Bach with Nina', "
            "'Bach' is the additional entity."
        ),
    ] = None


@dataclass
class SearchFilter:
    """
    Specifies the search terms for a search expression.
    Make sure at least one field below is present and not None nor empty.
    entity_search_terms cannot contain entities already in action_search_terms.
    """

    action_search_term: ActionTerm | None = None
    entity_search_terms: list[EntityTerm] | None = None
    search_terms: Annotated[
        list[str] | None,
        Doc(
            "Concepts, topics or other terms that don't fit ActionTerms or "
            "EntityTerms.\n"
            "- Do not use noisy searchTerms like 'topic', 'topics', 'subject', "
            "'discussion' etc. even if they are mentioned in the user request.\n"
            "- Phrases like 'email address' or 'first name' are a single term.\n"
            "- Use empty searchTerms array when user asks for summaries."
        ),
    ] = None
    time_range: Annotated[
        DateTimeRange | None,
        Doc(
            "Use only if request explicitly asks for time range, particular "
            "year, month etc. in this time range."
        ),
    ] = None


@dataclass
class SearchExpr:
    rewritten_query: Annotated[str, Doc("The rewritten search query")]
    filters: Annotated[list[SearchFilter], Doc("List of search filters")]


@dataclass
class SearchQuery:
    search_expressions: Annotated[
        list[SearchExpr],
        Doc(
            "One expression for each search required by user request. Each "
            "SearchExpr runs independently, so make them standalone by "
            "resolving references like 'it', 'that', 'them' etc."
        ),
    ]
