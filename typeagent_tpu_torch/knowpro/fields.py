"""Dataclasses with camelCase (de)serialization, on the standard library.

The port of ``typeagent_tpu/knowpro/fields.py``, which builds pydantic
dataclasses with a camelCase alias generator. The port may not import
pydantic, so :func:`dataclass` is the standard library's, and the two
functions below walk each class's fields and type hints:

* :func:`serialize_object` writes camelCase keys (or a field's
  ``serialization_alias``) and, by default, drops fields that are None, as
  pydantic's ``exclude_none=True`` does; datetimes stay datetimes.
* :func:`deserialize_object` reads a field under its validation aliases,
  its camelCase key or its name, in that order; ignores unknown keys;
  coerces as pydantic's lax mode does (``"3"`` and ``3.0`` to an int, an int
  to a float, ISO strings and Unix seconds to a datetime, a tuple to a
  list); tries a union's members strictly in order, then laxly in order; and
  raises :class:`ValidationError`, a ``ValueError`` as pydantic's is, on
  input that fits no field.

:func:`json_schema` renders the JSON schema pydantic's
``TypeAdapter(cls).json_schema()`` gives for such a class (the typed
translator's prompt shows it to the model).

Construction validates as a pydantic dataclass does: after the generated
``__init__``, each field's value goes through the same lax validation
(``Facet("pages", 350)`` holds ``350.0``; lists are copied), except a value
that is the field's own default, which pydantic does not validate either.
"""

from __future__ import annotations

import collections
import collections.abc
import dataclasses
import functools
import inspect
import types
import typing
from datetime import datetime, timezone
from typing import Any, Literal, TypeVar, Union, dataclass_transform

T = TypeVar("T")

type _Validator = typing.Callable[[Any, bool], Any]

_MARK = "__camel_dataclass__"
_SER_ALIAS = "serialization_alias"
_VAL_ALIASES = "validation_alias"
_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


class ValidationError(ValueError):
    """Input that does not fit the type it was read as."""


def to_camel(name: str) -> str:
    """``semantic_ref_ordinal`` -> ``semanticRefOrdinal``."""
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def field(
    *,
    serialization_alias: str | None = None,
    validation_alias: tuple[str, ...] | None = None,
    **kwargs: Any,
) -> Any:
    """``dataclasses.field`` with the key a field is written under and the
    keys it is read from, in order (e.g. ``("recipients", "listeners")``)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    if serialization_alias is not None:
        metadata[_SER_ALIAS] = serialization_alias
    if validation_alias is not None:
        metadata[_VAL_ALIASES] = tuple(validation_alias)
    return dataclasses.field(metadata=metadata, **kwargs)


@dataclass_transform(field_specifiers=(dataclasses.field, field))
def dataclass(cls: type | None = None, /, **kwargs: Any) -> Any:
    """A standard dataclass that (de)serializes with camelCase keys."""

    def wrap(c: type) -> type:
        own_doc = c.__dict__.get("__doc__")  # before dataclass() fills it in
        c = dataclasses.dataclass(c, **kwargs)
        setattr(c, _MARK, True)
        c.__camel_doc__ = own_doc
        generated = c.__init__

        @functools.wraps(generated)
        def __init__(self: Any, *args: Any, **kw: Any) -> None:
            generated(self, *args, **kw)
            state = self.__dict__
            for name, default, check in _init_plan(c):
                value = state[name]
                if value is not default:
                    state[name] = check(value, False)

        c.__init__ = __init__
        c.__camel_init__ = generated  # construction from validated values
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def is_camel_dataclass(obj: Any) -> bool:
    """True for a class made by :func:`dataclass` or an instance of one."""
    return getattr(obj, _MARK, False) is True


@dataclasses.dataclass(frozen=True, slots=True)
class _Spec:
    name: str
    key: str  # written under
    keys: tuple[str, ...]  # read from, in order
    required: bool


@functools.cache
def _own_hints(owner: type) -> dict[str, Any]:
    """The evaluated annotations ``owner`` declares itself (its bases may
    be protocols whose annotations name type parameters)."""
    shell = type(owner.__name__, (), {
        "__annotations__": dict(owner.__dict__.get("__annotations__", {})),
        "__module__": owner.__module__,
    })
    return typing.get_type_hints(shell, localns=dict(vars(owner)))


@functools.cache
def _specs(cls: type) -> tuple[tuple[_Spec, Any], ...]:
    out = []
    for f in dataclasses.fields(cls):
        owner = next(c for c in cls.__mro__ if f.name in c.__dict__.get("__annotations__", {}))
        camel = to_camel(f.name)
        keys = f.metadata.get(_VAL_ALIASES) or tuple(dict.fromkeys((camel, f.name)))
        required = f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
        spec = _Spec(f.name, f.metadata.get(_SER_ALIAS, camel), keys, required)
        out.append((spec, _own_hints(owner)[f.name]))
    return tuple(out)


_NO_DEFAULT = object()


@functools.cache
def _init_plan(cls: type) -> tuple[tuple[str, Any, _Validator], ...]:
    """(field, default or a sentinel, validator) for construction."""
    return tuple(
        (spec.name, _field_default(cls, spec.name), _validator(tp)) for spec, tp in _specs(cls)
    )


def _field_default(cls: type, name: str) -> Any:
    default = cls.__dataclass_fields__[name].default
    return _NO_DEFAULT if default is dataclasses.MISSING else default


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


def serialize_object(obj: Any, *, exclude_none: bool = True) -> Any:
    """A dataclass of this module -> plain camelCase data."""
    if not is_camel_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"Object must be a camelCase dataclass, got {type(obj)}")
    return _dump(obj, exclude_none)


def _dump(value: Any, exclude_none: bool) -> Any:
    if is_camel_dataclass(value):
        out = {}
        for spec, _ in _specs(type(value)):
            item = getattr(value, spec.name)
            if item is None and exclude_none:
                continue
            out[spec.key] = _dump(item, exclude_none)
        return out
    if isinstance(value, list):
        return [_dump(v, exclude_none) for v in value]
    if isinstance(value, tuple):
        return tuple(_dump(v, exclude_none) for v in value)
    if isinstance(value, dict):
        return {k: _dump(v, exclude_none) for k, v in value.items()}
    return value


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def deserialize_object(cls: type[T], data: Any) -> T:
    """Validate plain camelCase data into ``cls`` (a dataclass of this
    module, or a list, set, dict, union or literal of such types)."""
    return _validator(cls)(data, False)


def _fail(tp: Any, value: Any) -> typing.NoReturn:
    raise ValidationError(f"{value!r:.80} is not a valid {getattr(tp, '__name__', tp)}")


@functools.cache
def _validator(tp: Any) -> _Validator:
    if isinstance(tp, typing.TypeAliasType):
        return _validator(tp.__value__)
    origin = typing.get_origin(tp)
    if origin is typing.Annotated:
        return _validator(typing.get_args(tp)[0])
    if tp is type(None):
        return _none
    if tp in _SCALARS:
        return _SCALARS[tp]
    if origin is Literal:
        return _literal(typing.get_args(tp))
    if origin in (Union, types.UnionType):
        return _union(typing.get_args(tp))
    if origin in (list, set, collections.abc.Sequence):
        return _sequence(origin, _validator(typing.get_args(tp)[0]))
    if origin is dict:
        key, value = typing.get_args(tp)
        return _mapping(_validator(key), _validator(value))
    if isinstance(tp, type) and is_camel_dataclass(tp):
        return _dataclass(tp)
    raise TypeError(f"cannot validate values of type {tp!r}")


def _none(v: Any, strict: bool) -> None:
    if v is not None:
        _fail(None, v)


def _str(v: Any, strict: bool) -> str:
    if not isinstance(v, str):
        _fail(str, v)
    return v


def _int(v: Any, strict: bool) -> int:
    if type(v) is int:
        return v
    if not strict:
        if isinstance(v, int):  # bool
            return int(v)
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, str):
            try:
                return int(v.strip())
            except ValueError:
                pass
    _fail(int, v)


def _float(v: Any, strict: bool) -> float:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if not strict:
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                pass
    _fail(float, v)


def _bool(v: Any, strict: bool) -> bool:
    if isinstance(v, bool):
        return v
    if not strict:
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str):
            word = v.strip().lower()
            if word in _TRUE:
                return True
            if word in _FALSE:
                return False
    _fail(bool, v)


def _datetime(v: Any, strict: bool) -> datetime:
    if isinstance(v, datetime):
        return v
    if not strict:
        if isinstance(v, str):
            try:
                return datetime.fromisoformat(v.strip())
            except ValueError:
                pass
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            seconds = v / 1000 if abs(v) > 2e10 else v  # milliseconds past 2e10
            return datetime.fromtimestamp(seconds, timezone.utc)
    _fail(datetime, v)


_SCALARS: dict[Any, _Validator] = {
    str: _str, int: _int, float: _float, bool: _bool, datetime: _datetime,
}


def _literal(values: tuple) -> _Validator:
    def validate(v: Any, strict: bool) -> Any:
        for allowed in values:
            if v == allowed and type(v) is type(allowed):
                return allowed
        raise ValidationError(f"{v!r:.80} is not one of {values!r}")

    return validate


def _union(members: tuple) -> _Validator:
    checks = [_validator(m) for m in members]
    # A value whose type is a member's own class goes to that member first.
    by_type = {}
    for m, check in zip(members, checks):
        if isinstance(m, type):
            by_type.setdefault(m, check)

    def validate(v: Any, strict: bool) -> Any:
        check = by_type.get(type(v))
        if check is not None:
            return check(v, True)
        for check in checks:
            try:
                return check(v, True)
            except ValidationError:
                pass
        if not strict:
            for check in checks:
                try:
                    return check(v, False)
                except ValidationError:
                    pass
        raise ValidationError(f"{v!r:.80} fits no member of {members!r}")

    return validate


def _sequence(kind: Any, item: _Validator) -> _Validator:
    lax_inputs = (list, tuple, set, frozenset, collections.deque)

    def validate(v: Any, strict: bool) -> Any:
        if kind is collections.abc.Sequence:
            if isinstance(v, (list, tuple)):
                return type(v)(item(x, strict) for x in v)
        elif isinstance(v, list) or (not strict and isinstance(v, lax_inputs)):
            out = [item(x, strict) for x in v]
            return out if kind is list else kind(out)
        _fail(kind, v)

    return validate


def _mapping(key: _Validator, value: _Validator) -> _Validator:
    def validate(v: Any, strict: bool) -> dict:
        if not isinstance(v, dict):
            _fail(dict, v)
        return {key(k, strict): value(x, strict) for k, x in v.items()}

    return validate


def _dataclass(cls: type) -> _Validator:
    # Field validators are built at the first call, so that recursive
    # types (a group whose terms may be groups) build in finite steps.
    plan: list[tuple[str, tuple[str, ...], bool, _Validator]] = []
    init = cls.__dict__["__camel_init__"]

    def validate(v: Any, strict: bool) -> Any:
        if isinstance(v, cls):
            return v
        if not isinstance(v, dict):
            _fail(cls, v)
        if not plan:
            plan.extend((s.name, s.keys, s.required, _validator(tp)) for s, tp in _specs(cls))
        kwargs = {}
        for name, keys, required, check in plan:
            for key in keys:
                if key in v:
                    kwargs[name] = check(v[key], strict)
                    break
            else:
                if required:
                    raise ValidationError(f"{cls.__name__}.{name}: field required")
        obj = cls.__new__(cls)
        init(obj, **kwargs)
        return obj

    return validate


# ---------------------------------------------------------------------------
# JSON schema
# ---------------------------------------------------------------------------

_JSON_TYPES: dict[Any, dict[str, Any]] = {
    str: {"type": "string"},
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
    type(None): {"type": "null"},
    datetime: {"format": "date-time", "type": "string"},
}
_LITERAL_TYPES = {str: "string", int: "integer", float: "number", bool: "boolean", type(None): "null"}


def json_schema(tp: Any) -> dict[str, Any]:
    """The validation-mode JSON schema of ``tp``, as pydantic renders it.

    Dataclasses and ``type`` aliases below the top level go to ``$defs``
    under their names and are referenced by ``$ref``; a field's ``title``
    is its camelCase key through ``str.title``, left off where the field's
    type is one referenced definition (alone or with None); a class's own
    docstring is its ``description``; a recursive class is itself a
    reference; keys are sorted except inside ``properties``, as pydantic
    sorts them.
    """
    defs: dict[str, Any] = {}
    top = _class_schema(tp, defs) if _is_class(tp) else _type_schema(tp, defs)
    if _is_class(tp) and tp.__name__ in defs:  # recursive: the top is a reference too
        defs[tp.__name__] = top
        top = {"$ref": f"#/$defs/{tp.__name__}"}
    if defs:
        top["$defs"] = defs
    return _sorted_schema(top)


def _is_class(tp: Any) -> bool:
    return isinstance(tp, type) and is_camel_dataclass(tp)


def _strip(tp: Any) -> Any:
    while typing.get_origin(tp) is typing.Annotated:
        tp = typing.get_args(tp)[0]
    return tp


def _class_schema(cls: type, defs: dict[str, Any]) -> dict[str, Any]:
    properties: dict[str, Any] = {}
    required = []
    for spec, tp in _specs(cls):
        key = to_camel(spec.name)
        schema = _type_schema(tp, defs)
        default = _field_default(cls, spec.name)
        if default is not _NO_DEFAULT:
            schema["default"] = _dump(default, False)
        if _titled(tp):
            schema["title"] = key.title().replace("_", " ")
        properties[key] = schema
        if spec.required:
            required.append(key)
    out: dict[str, Any] = {"properties": properties}
    if required:
        out["required"] = required
    out["title"] = cls.__name__
    out["type"] = "object"
    doc = cls.__dict__.get("__camel_doc__")
    if doc is not None:
        out["description"] = inspect.cleandoc(doc)
    return out


def _titled(tp: Any) -> bool:
    """pydantic titles a field unless its type is one reference."""
    tp = _strip(tp)
    if typing.get_origin(tp) in (Union, types.UnionType):
        members = [m for m in typing.get_args(tp) if m is not type(None)]
        if len(members) != 1:
            return True
        tp = _strip(members[0])
    return not (_is_class(tp) or isinstance(tp, typing.TypeAliasType))


def _ref(name: str, build: typing.Callable[[], dict[str, Any]], defs: dict[str, Any]) -> dict[str, Any]:
    if name not in defs:
        defs[name] = {}  # a recursive type refers to itself while it is built
        defs[name] = build()
    return {"$ref": f"#/$defs/{name}"}


def _type_schema(tp: Any, defs: dict[str, Any]) -> dict[str, Any]:
    tp = _strip(tp)
    origin = typing.get_origin(tp)
    if isinstance(tp, typing.TypeAliasType):
        return _ref(tp.__name__, lambda: _type_schema(tp.__value__, defs), defs)
    if _is_class(tp):
        return _ref(tp.__name__, lambda: _class_schema(tp, defs), defs)
    if tp in _JSON_TYPES:
        return dict(_JSON_TYPES[tp])
    if tp is Any:
        return {}
    if origin is Literal:
        values = list(typing.get_args(tp))
        out: dict[str, Any] = {"const": values[0]} if len(values) == 1 else {"enum": values}
        kinds = {type(v) for v in values}
        if len(kinds) == 1 and next(iter(kinds)) in _LITERAL_TYPES:
            out["type"] = _LITERAL_TYPES[next(iter(kinds))]
        return out
    if origin in (Union, types.UnionType):
        members: list[dict[str, Any]] = []
        for m in typing.get_args(tp):
            schema = _type_schema(m, defs)
            for item in schema["anyOf"] if list(schema) == ["anyOf"] else [schema]:
                if item not in members:
                    members.append(item)
        return members[0] if len(members) == 1 else {"anyOf": members}
    if origin in (list, collections.abc.Sequence, set):
        out = {"items": _type_schema(typing.get_args(tp)[0], defs), "type": "array"}
        if origin is set:
            out["uniqueItems"] = True
        return out
    if origin is dict:
        value = _type_schema(typing.get_args(tp)[1], defs)
        return {"additionalProperties": value or True, "type": "object"}
    raise TypeError(f"no JSON schema for type {tp!r}")


def _sorted_schema(value: Any, parent: str | None = None) -> Any:
    if isinstance(value, dict):
        keys = value if parent in ("properties", "default") else sorted(value)
        return {k: _sorted_schema(value[k], k) for k in keys}
    if isinstance(value, list):
        return [_sorted_schema(v, parent) for v in value]
    return value
