"""Shared predicates (parity: reference knowpro/common.py).

Kept deliberately tiny: the wildcard convention ('*' matches anything) shows
up in search terms, facet names, and facet values, so the predicate lives
here where query.py, searchlang.py, and the device executor can all import
it without cycles.
"""

from .interfaces import SearchTerm

WILDCARD = "*"


def is_search_term_wildcard(search_term: SearchTerm) -> bool:
    """A '*' search term matches any value."""
    return search_term.term.text == WILDCARD
