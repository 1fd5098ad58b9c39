"""Date/time range schema for LLM query translation (parity: reference
knowpro/date_time_schema.py).

The port of ``typeagent_tpu/knowpro/date_time_schema.py``, on the port's
``fields.dataclass``."""
#
# NOTE ON SIMILARITY TO THE REFERENCE: this module is a wire/prompt CONTRACT,
# not logic. The field names are the camelCase JSON format shared with the
# reference's serialized data, and the Doc() strings are the literal text the
# LLM sees — changing either would change behavior, so they intentionally
# match the reference schema's semantics word for word.
#

from __future__ import annotations

from typing import Annotated

from typing_extensions import Doc

from .fields import dataclass


@dataclass
class DateVal:
    # Calendar date as separate numeric fields (the LLM fills these from
    # phrases like "last March" against the conversation's time range).
    day: int
    month: int
    year: int


@dataclass
class TimeVal:
    hour: Annotated[int, Doc("In 24 hour form")]
    minute: int
    seconds: int


@dataclass
class DateTime:
    date: DateVal
    time: TimeVal | None = None


@dataclass
class DateTimeRange:
    # stop_date is optional: a missing stop means a point query; a bare date
    # (no time) rolls to the next midnight at compile time (searchlang.py).
    start_date: DateTime
    stop_date: DateTime | None = None
