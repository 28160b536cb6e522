"""Chat templates: a Jinja interpreter for the subset that chat templates
use, rendering what ``transformers``' ``apply_chat_template`` renders.

The JAX package renders a tokenizer's ``chat_template`` through
``transformers`` (``render_jinja_template``, which compiles it with
``jinja2``), and the machine with the card has neither. This module
renders the same strings under the same environment:
``ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)``
with the ``loopcontrols`` extension and the ``{% generation %}`` block,
the ``tojson`` filter as ``json.dumps(ensure_ascii=False, ...)``, and the
globals ``raise_exception`` and ``strftime_now`` beside Jinja's
``range``, ``dict`` and ``namespace``.

- Layout: ``{{ }}``, ``{% %}`` and ``{# #}`` with ``-`` and ``+``
  whitespace control, ``trim_blocks`` (the newline after a block or
  comment tag goes) and ``lstrip_blocks`` (spaces and tabs between a line
  start and a block or comment tag go); newlines normalized to ``\\n``
  and one trailing newline dropped, as Jinja's lexer does.
- Statements: ``for`` (tuple targets, an ``if`` filter, ``else``, the
  ``loop`` object), ``break``, ``continue``, ``if``/``elif``/``else``,
  ``set`` (names, tuples, ``ns.attr`` of a ``namespace``, and the block
  form), ``generation``. Names follow Jinja's frames: a loop body (each
  iteration), a loop's ``else`` and filter, a ``set`` block and a
  ``generation`` body are frames of their own, ``if`` is not; a name a
  frame stores is that frame's from its entry (taken from the frame
  around it, from the context when an ``if`` may skip the store, else
  undefined until set), as Jinja's compiler analyzes it.
- Expressions: Jinja's grammar and precedence (``if``/``else``, ``or``,
  ``and``, ``not``, comparisons with ``in`` and ``not in``, ``+ -``,
  ``~``, ``* / // %``, ``**``, unary signs, filters and tests, then
  attribute, subscript, slice and call), with Python's operators beneath.
- Values: Jinja's ``Undefined`` (renders ``''``, is falsy, iterates
  empty, equals only another Undefined; an attribute, item, call or
  arithmetic of it raises), the sandbox's attribute and item lookup (an
  attribute falls back to the item and back; a missing one is Undefined;
  one that starts with ``_`` or mutates a list, dict or set is refused
  when used), ``str.format`` through the sandbox's formatter.
- Filters and tests: :data:`FILTERS` and :data:`TESTS`, each as Jinja
  3.1 defines it.

A construct outside the subset (a ``macro``, ``call``, ``filter``,
``with``, ``include`` or other tag, an unknown filter or test, ``*args``
in a call, the globals ``lipsum``, ``cycler`` and ``joiner``) raises
:class:`UnsupportedConstruct` when the template compiles, naming it and
its line, so that a serving unit refuses the checkpoint at load instead
of rendering another prompt than the reference would. Errors while
rendering (``raise_exception``, an undefined value used, a refused
attribute) raise :class:`TemplateError`.
"""

from __future__ import annotations

import json
import re
import types
from _string import formatter_field_name_split
from collections import abc
from datetime import datetime
from functools import lru_cache
from numbers import Number
from string import Formatter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class TemplateError(Exception):
    """A template failed while it rendered (``raise_exception`` included)."""


class TemplateSyntaxError(TemplateError):
    """A template that does not compile; ``lineno`` is its line."""

    def __init__(self, message: str, lineno: int):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


class UnsupportedConstruct(TemplateSyntaxError):
    """A construct Jinja has and this interpreter does not."""

    def __init__(self, construct: str, lineno: int):
        super().__init__(f"{construct} is not supported by this port's chat "
                         f"template interpreter", lineno)
        self.construct = construct


class TemplateRuntimeError(TemplateError):
    pass


class UndefinedError(TemplateRuntimeError):
    pass


class SecurityError(TemplateError):
    pass


# -- values ----------------------------------------------------------------


class Undefined:
    """Jinja's default undefined value."""

    __slots__ = ("_hint", "_exc")

    def __init__(self, hint: str = "value is undefined",
                 exc: type = UndefinedError):
        self._hint = hint
        self._exc = exc

    def _fail(self, *args, **kwargs):
        raise self._exc(self._hint)

    def __getattr__(self, name):
        if name[:2] == "__":
            raise AttributeError(name)
        self._fail()

    __add__ = __radd__ = __sub__ = __rsub__ = _fail
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _fail
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail
    __int__ = __float__ = __complex__ = __pow__ = __rpow__ = _fail

    def __eq__(self, other):
        return type(self) is type(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return id(type(self))

    def __str__(self):
        return ""

    def __len__(self):
        return 0

    def __iter__(self):
        yield from ()

    def __bool__(self):
        return False

    def __repr__(self):
        return "Undefined"


class Namespace:
    """``namespace(...)``: the one object a template may assign attributes
    of (``{% set ns.attr = value %}``)."""

    __slots__ = ("_attrs",)

    def __init__(self, *args, **kwargs):
        self._attrs = dict(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return self._attrs[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, name, value):
        self._attrs[name] = value

    def __repr__(self):
        return f"<Namespace {self._attrs!r}>"


class _Loop:
    """The ``loop`` object of a ``for`` body."""

    depth, depth0 = 1, 0

    def __init__(self, items: list):
        self._items = items
        self.length = len(items)
        self.index0 = 0
        self._last_changed = object()

    @property
    def index(self):
        return self.index0 + 1

    @property
    def revindex(self):
        return self.length - self.index0

    @property
    def revindex0(self):
        return self.length - self.index

    @property
    def first(self):
        return self.index0 == 0

    @property
    def last(self):
        return self.index0 == self.length - 1

    @property
    def previtem(self):
        if self.index0 == 0:
            return Undefined("there is no previous item")
        return self._items[self.index0 - 1]

    @property
    def nextitem(self):
        if self.index0 + 1 >= self.length:
            return Undefined("there is no next item")
        return self._items[self.index0 + 1]

    def cycle(self, *args):
        if not args:
            raise TypeError("no items for cycling given")
        return args[self.index0 % len(args)]

    def changed(self, *value):
        if self._last_changed != value:
            self._last_changed = value
            return True
        return False

    def __repr__(self):
        return f"<LoopContext {self.index}/{self.length}>"


# -- the sandbox -------------------------------------------------------------

_MUTATING = (
    (abc.MutableSet, frozenset(["add", "clear", "difference_update",
                                "discard", "pop", "remove",
                                "symmetric_difference_update", "update"])),
    (abc.MutableMapping, frozenset(["clear", "pop", "popitem", "setdefault",
                                    "update"])),
    (abc.MutableSequence, frozenset(["append", "clear", "pop", "reverse",
                                     "insert", "sort", "extend", "remove"])),
)
_GEN_UNSAFE = frozenset(["gi_frame", "gi_code", "gi_yieldfrom"])


def _safe_attribute(obj, attr: str) -> bool:
    if attr.startswith("_"):
        return False
    if isinstance(obj, type) and attr == "mro":
        return False
    if isinstance(obj, (types.CodeType, types.TracebackType,
                        types.FrameType)):
        return False
    if isinstance(obj, types.GeneratorType) and attr in _GEN_UNSAFE:
        return False
    return not any(isinstance(obj, t) and attr in names
                   for t, names in _MUTATING)


def _unsafe(obj, attr) -> Undefined:
    return Undefined(f"access to attribute {attr!r} of "
                     f"{type(obj).__name__!r} object is unsafe.",
                     SecurityError)


def _missing(obj, name) -> Undefined:
    if isinstance(name, str):
        return Undefined(f"'{type(obj).__name__} object' has no attribute "
                         f"{name!r}")
    return Undefined(f"'{type(obj).__name__} object' has no element "
                     f"{name!r}")


class _SandboxedFormatter(Formatter):
    def get_field(self, field_name, args, kwargs):
        first, rest = formatter_field_name_split(field_name)
        obj = self.get_value(first, args, kwargs)
        for is_attr, i in rest:
            obj = getattr_(obj, i) if is_attr else getitem_(obj, i)
        return obj, first


def _wrap_format(value):
    """``str.format`` and ``str.format_map`` go through the sandbox's
    formatter, as Jinja's sandbox wraps them when they are looked up."""
    if not isinstance(value, (types.MethodType, types.BuiltinMethodType)) \
            or value.__name__ not in ("format", "format_map") \
            or not isinstance(value.__self__, str):
        return None
    s, is_map = value.__self__, value.__name__ == "format_map"

    def wrapper(*args, **kwargs):
        if is_map:
            if kwargs:
                raise TypeError("format_map() takes no keyword arguments")
            if len(args) != 1:
                raise TypeError(f"format_map() takes exactly one argument "
                                f"({len(args)} given)")
            kwargs, args = args[0], ()
        return _SandboxedFormatter().vformat(s, args, kwargs)

    return wrapper


def getattr_(obj, attr: str):
    """``obj.attr`` in the sandbox: the attribute, else the item."""
    try:
        value = getattr(obj, attr)
    except AttributeError:
        try:
            return obj[attr]
        except (TypeError, LookupError):
            pass
    else:
        fmt = _wrap_format(value)
        if fmt is not None:
            return fmt
        return value if _safe_attribute(obj, attr) else _unsafe(obj, attr)
    return _missing(obj, attr)


def getitem_(obj, arg):
    """``obj[arg]`` in the sandbox: the item, else (a string key) the
    attribute."""
    try:
        return obj[arg]
    except (TypeError, LookupError):
        if isinstance(arg, str):
            try:
                value = getattr(obj, arg)
            except AttributeError:
                pass
            else:
                fmt = _wrap_format(value)
                if fmt is not None:
                    return fmt
                return value if _safe_attribute(obj, arg) \
                    else _unsafe(obj, arg)
    return _missing(obj, arg)


def _call(fn, args, kwargs):
    if getattr(fn, "unsafe_callable", False) or getattr(fn, "alters_data",
                                                        False):
        raise SecurityError(f"{fn!r} is not safely callable")
    try:
        return fn(*args, **kwargs)
    except StopIteration:
        return Undefined("value was undefined because a callable raised a "
                         "StopIteration exception")


def _soft_str(v) -> str:
    return v if isinstance(v, str) else str(v)


# -- filters and tests (Jinja 3.1's definitions) -----------------------------


def _attr_parts(attribute) -> list:
    if attribute is None:
        return []
    if isinstance(attribute, str):
        return [int(x) if x.isdigit() else x for x in attribute.split(".")]
    return [attribute]


def _attrgetter(attribute, default=None) -> Callable:
    parts = _attr_parts(attribute)

    def get(item):
        for part in parts:
            item = getitem_(item, part)
            if default is not None and isinstance(item, Undefined):
                item = default
        return item

    return get


def _call_test(name, value, args, kwargs):
    if name not in TESTS:
        raise TemplateRuntimeError(f"No test named {name!r}.")
    return TESTS[name](value, *args, **kwargs)


def _call_filter(name, value, args, kwargs):
    if name not in FILTERS:
        raise TemplateRuntimeError(f"No filter named {name!r}.")
    return FILTERS[name](value, *args, **kwargs)


def _select_or_reject(value, args, kwargs, keep: bool, attr: bool):
    if attr:
        if not args:
            raise TemplateError("Missing parameter for attribute name")
        trans = _attrgetter(args[0])
        off = 1
    else:
        def trans(x):
            return x
        off = 0
    if len(args) > off:
        name, rest = args[off], args[off + 1:]

        def func(item):
            return _call_test(name, item, rest, kwargs)
    else:
        func = bool
    if value:
        for item in value:
            if bool(func(trans(item))) == keep:
                yield item


def _f_map(value, *args, **kwargs):
    if not args and "attribute" in kwargs:
        attribute = kwargs.pop("attribute")
        default = kwargs.pop("default", None)
        if kwargs:
            raise TemplateError(f"Unexpected keyword argument "
                                f"{next(iter(kwargs))!r}")
        func = _attrgetter(attribute, default)
    else:
        try:
            name, args = args[0], args[1:]
        except LookupError:
            raise TemplateError("map requires a filter argument") from None

        def func(item):
            return _call_filter(name, item, args, kwargs)
    if value:
        for item in value:
            yield func(item)


def _f_first(seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined("No first item, sequence was empty.")


def _f_last(seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined("No last item, sequence was empty.")


def _f_int(value, default=0, base=10):
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def _f_default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _f_items(value):
    if isinstance(value, Undefined):
        return
    if not isinstance(value, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    yield from value.items()


def _f_indent(s, width=4, first=False, blank=False):
    indention = width if isinstance(width, str) else " " * width
    s += "\n"
    if blank:
        rv = ("\n" + indention).join(s.splitlines())
    else:
        lines = s.splitlines()
        rv = lines.pop(0)
        if lines:
            rv += "\n" + "\n".join(indention + line if line else line
                                   for line in lines)
    if first:
        rv = indention + rv
    return rv


def _f_join(value, d="", attribute=None):
    if attribute is not None:
        value = map(_attrgetter(attribute), value)
    return str(d).join(map(str, value))


def _f_tojson(x, ensure_ascii=False, indent=None, separators=None,
              sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _f_replace(s, old, new, count=None):
    return str(s).replace(str(old), str(new), -1 if count is None else count)


_WORD_BEGIN = re.compile(r"([-\s({\[<]+)")


def _f_title(s):
    return "".join(item[0].upper() + item[1:].lower()
                   for item in _WORD_BEGIN.split(_soft_str(s)) if item)


FILTERS: Dict[str, Callable] = {
    "trim": lambda v, chars=None: _soft_str(v).strip(chars),
    "tojson": _f_tojson,
    "length": len,
    "count": len,
    "upper": lambda v: _soft_str(v).upper(),
    "lower": lambda v: _soft_str(v).lower(),
    "title": _f_title,
    "capitalize": lambda v: _soft_str(v).capitalize(),
    "replace": _f_replace,
    "join": _f_join,
    "first": _f_first,
    "last": _f_last,
    "selectattr": lambda v, *a, **k: _select_or_reject(v, a, k, True, True),
    "rejectattr": lambda v, *a, **k: _select_or_reject(v, a, k, False, True),
    "select": lambda v, *a, **k: _select_or_reject(v, a, k, True, False),
    "reject": lambda v, *a, **k: _select_or_reject(v, a, k, False, False),
    "map": _f_map,
    "list": list,
    "string": _soft_str,
    "int": _f_int,
    "default": _f_default,
    "d": _f_default,
    "items": _f_items,
    "indent": _f_indent,
}


def _t_sequence(value) -> bool:
    try:
        len(value)
        value.__getitem__
    except Exception:
        return False
    return True


def _t_iterable(value) -> bool:
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS: Dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "integer": lambda v: isinstance(v, int) and v is not True
    and v is not False,
    "float": lambda v: isinstance(v, float),
    "number": lambda v: isinstance(v, Number),
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "sequence": _t_sequence,
    "iterable": _t_iterable,
    "lower": lambda v: str(v).islower(),
    "upper": lambda v: str(v).isupper(),
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
    "divisibleby": lambda v, n: v % n == 0,
    "sameas": lambda v, other: v is other,
    "in": lambda v, seq: v in seq,
    "==": lambda a, b: a == b, "eq": lambda a, b: a == b,
    "equalto": lambda a, b: a == b,
    "!=": lambda a, b: a != b, "ne": lambda a, b: a != b,
    ">": lambda a, b: a > b, "gt": lambda a, b: a > b,
    "greaterthan": lambda a, b: a > b,
    ">=": lambda a, b: a >= b, "ge": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "lt": lambda a, b: a < b,
    "lessthan": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, "le": lambda a, b: a <= b,
}

#: filters whose arguments name a test (from the first, or past the
#: attribute) or a filter (map's first): checked when the template compiles
_NAMED_ARGS = {"select": (0, TESTS), "reject": (0, TESTS),
               "selectattr": (1, TESTS), "rejectattr": (1, TESTS),
               "map": (0, FILTERS)}


def raise_exception(message):
    raise TemplateError(message)


def strftime_now(fmt):
    return datetime.now().strftime(fmt)


def _safe_range(*args):
    rng = range(*args)
    if len(rng) > 100000:
        raise OverflowError("Range too big. The sandbox blocks ranges larger "
                            "than MAX_RANGE (100000).")
    return rng


GLOBALS: Dict[str, Any] = {
    "range": _safe_range, "dict": dict, "namespace": Namespace,
    "raise_exception": raise_exception, "strftime_now": strftime_now,
}
#: Jinja's other default globals, refused by name
_UNSUPPORTED_GLOBALS = ("lipsum", "cycler", "joiner")


# -- the lexer ---------------------------------------------------------------

_NEWLINE = re.compile(r"\r\n|\r|\n")
_ROOT = re.compile(r"(.*?)(?:(?P<raw>\{%[-+]?\s*raw\s*(?:-%\}\s*|%\}))|"
                   r"(?P<tag>\{#|\{%|\{\{)(?P<sign>[-+]?))", re.S)
_COMMENT_END = re.compile(r"(.*?)(\+#\}|-#\}\s*|#\}\n?)", re.S)
_TAG_END = {"block": re.compile(r"\+%\}|-%\}\s*|%\}\n?"),
            "variable": re.compile(r"-\}\}\s*|\}\}")}
_WS = re.compile(r"\s+")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|"
                    r"\.(\d+_)*\d+)", re.I)
_INT = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|"
                  r"0(_?0)*)", re.I)
_NAME = re.compile(r"[^\W\d]\w*")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'|"
                     r"\"([^\"\\]*(?:\\.[^\"\\]*)*)\")", re.S)
_OP = re.compile(r"//|\*\*|==|!=|>=|<=|[-+/*%~\[\](){}><=.:|,;]")
_OPEN = {"(": ")", "[": "]", "{": "}"}

Token = Tuple[str, Any, int]   # (kind, value, line)


def tokenize(source: str) -> List[Token]:
    """Jinja's token stream for ``source`` under ``trim_blocks`` and
    ``lstrip_blocks``: ``data``, ``block_begin``/``block_end``,
    ``variable_begin``/``variable_end`` and, between them, ``name``,
    ``string``, ``integer``, ``float`` and ``op`` tokens."""
    lines = _NEWLINE.split(source)
    if lines[-1] == "":
        del lines[-1]
    source = "\n".join(lines)
    toks: List[Token] = []
    pos, line, n = 0, 1, len(source)
    line_starting = True
    while pos < n:
        m = _ROOT.match(source, pos)
        if m is None:
            toks.append(("data", source[pos:], line))
            break
        text = m.group(1)
        if m.group("raw"):
            raise UnsupportedConstruct("the {% raw %} tag",
                                       line + text.count("\n"))
        tag, sign = m.group("tag"), m.group("sign")
        data = text
        if sign == "-":
            data = text.rstrip()
        elif sign != "+" and tag != "{{":
            start = text.rfind("\n") + 1
            if (start > 0 or line_starting) and _WS.fullmatch(text, start):
                data = text[:start]
        if data:
            toks.append(("data", data, line))
        line += text.count("\n")
        pos = m.end()
        if tag == "{#":
            c = _COMMENT_END.match(source, pos)
            if c is None:
                raise TemplateSyntaxError("missing end of comment tag", line)
            line += c.group().count("\n")
            pos = c.end()
            line_starting = c.group().endswith("\n")
            continue
        kind = "block" if tag == "{%" else "variable"
        toks.append((kind + "_begin", tag, line))
        end, stack = _TAG_END[kind], []
        while True:
            if pos >= n:
                raise TemplateSyntaxError(
                    f"unexpected end of template, expected the end of the "
                    f"{kind} tag", line)
            e = None if stack else end.match(source, pos)
            if e is not None:
                toks.append((kind + "_end", e.group(), line))
                line += e.group().count("\n")
                pos = e.end()
                line_starting = e.group().endswith("\n")
                break
            for rx, kind_ in ((_WS, None), (_FLOAT, "float"),
                              (_INT, "integer"), (_NAME, "name"),
                              (_STRING, "string"), (_OP, "op")):
                t = rx.match(source, pos)
                if t is not None:
                    break
            else:
                raise TemplateSyntaxError(
                    f"unexpected char {source[pos]!r} at {pos}", line)
            value = t.group()
            if kind_ == "float":
                toks.append(("float", float(value.replace("_", "")), line))
            elif kind_ == "integer":
                toks.append(("integer", int(value.replace("_", ""), 0),
                             line))
            elif kind_ == "string":
                try:
                    s = value[1:-1].encode("ascii", "backslashreplace")\
                        .decode("unicode-escape")
                except Exception as ex:
                    raise TemplateSyntaxError(str(ex), line) from None
                toks.append(("string", s, line))
            elif kind_ is not None:
                if kind_ == "op":
                    if value in _OPEN:
                        stack.append(_OPEN[value])
                    elif value in (")", "]", "}"):
                        if not stack or stack.pop() != value:
                            raise TemplateSyntaxError(f"unexpected {value!r}",
                                                      line)
                toks.append((kind_, value, line))
            line += value.count("\n")
            pos = t.end()
    return toks


# -- the parser, compiling to closures ---------------------------------------


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


_MISSING = object()


class _Syms:
    """One frame's names, as Jinja's ``idtracking.Symbols`` keeps them:
    how each name this frame holds is set on entering it (``loads``:
    "param", "resolve" from the context, "alias" of an enclosing frame's
    value, "undefined") and which names it stores."""

    def __init__(self, parent: Optional["_Syms"] = None):
        self.parent = parent
        self.loads: Dict[str, str] = {}
        self.stores = set()

    def find(self, name: str) -> Optional[int]:
        """How many frames up ``name`` is held, or None."""
        syms, depth = self, 0
        while syms is not None:
            if name in syms.loads:
                return depth
            syms, depth = syms.parent, depth + 1
        return None

    def _outer(self, name: str) -> bool:
        return self.parent is not None and self.parent.find(name) is not None

    def load(self, name: str) -> None:
        if self.find(name) is None:
            self.loads[name] = "resolve"

    def store(self, name: str) -> None:
        self.stores.add(name)
        if name not in self.loads:
            self.loads[name] = "alias" if self._outer(name) else "undefined"

    def param(self, name: str) -> None:
        self.stores.add(name)
        self.loads[name] = "param"

    def copy(self) -> "_Syms":
        c = _Syms(self.parent)
        c.loads, c.stores = dict(self.loads), set(self.stores)
        return c

    def branch_update(self, branches: Sequence["_Syms"]) -> None:
        """After an ``if``: a name a branch stores is taken from outside on
        entering the frame, since the branch may not run."""
        new = set().union(*(b.stores for b in branches)) - self.stores
        for b in branches:
            self.loads.update(b.loads)
            self.stores.update(b.stores)
        for name in new:
            self.loads[name] = "alias" if self._outer(name) else "resolve"


class _Frame:
    """A frame of the template as parsed: its parameters, the loads and
    stores of its statements in Jinja's visiting order (an ``if`` as its
    branches), its nested frames and its name references, analyzed once
    the whole template is parsed (a nested frame sees every name of the
    frames around it, as Jinja's compiler analyzes it)."""

    def __init__(self, parent: Optional["_Frame"], params=()):
        self.parent = parent
        self.params = tuple(params)
        self.events: list = []
        self.cur = self.events
        self.children: List["_Frame"] = []
        self.refs: List["_Ref"] = []
        #: (name, kind, depth of an alias's frame), set by analyze
        self.plan: List[Tuple[str, str, int]] = []
        if parent is not None:
            parent.children.append(self)

    def analyze(self, parent_syms: Optional[_Syms] = None) -> None:
        syms = _Syms(parent_syms)
        for name in self.params:
            syms.param(name)
        self._apply(syms, self.events)
        self.plan = [(name, kind, (parent_syms.find(name) + 1
                                   if kind == "alias" else 0))
                     for name, kind in syms.loads.items()]
        for ref in self.refs:
            ref.depth = syms.find(ref.name)
        for child in self.children:
            child.analyze(syms)

    @classmethod
    def _apply(cls, syms: _Syms, events) -> None:
        for ev in events:
            if ev[0] == "load":
                syms.load(ev[1])
            elif ev[0] == "store":
                syms.store(ev[1])
            else:   # an if: each branch on a copy
                copies = []
                for branch in ev[1]:
                    copies.append(syms.copy())
                    cls._apply(copies[-1], branch)
                syms.branch_update(copies)


class _Ref:
    """A name read in a frame, resolved by analysis to the frame that
    holds it (``depth`` frames up)."""

    __slots__ = ("name", "depth")

    def __init__(self, name: str):
        self.name = name
        self.depth = 0

    def __call__(self, scope: "_Scope"):
        for _ in range(self.depth):
            scope = scope.parent
        v = scope.vars.get(self.name, _MISSING)
        if v is _MISSING:
            return Undefined(f"{self.name!r} is undefined")
        return v


class _Scope:
    """A frame at run time: its names' values, the frame around it and
    the render's context (its variables over the globals)."""

    __slots__ = ("vars", "parent", "ctx")

    def __init__(self, parent: Optional["_Scope"], frame: _Frame,
                 ctx: Optional[dict] = None):
        self.parent = parent
        self.ctx = ctx if parent is None else parent.ctx
        self.vars = {}
        for name, kind, depth in frame.plan:
            if kind == "resolve":
                v = self.ctx.get(name, _MISSING)
            elif kind == "alias":
                outer = self
                for _ in range(depth):
                    outer = outer.parent
                v = outer.vars.get(name, _MISSING)
            else:
                v = _MISSING
            self.vars[name] = v


Expr = Callable[[_Scope], Any]
Stmt = Callable[[_Scope, List[str]], None]

_BINOPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
}
_COMPARE = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}
_STATEMENTS = frozenset(["for", "if", "set", "break", "continue",
                         "generation"])


def _render(body: Sequence[Stmt], scope: _Scope, out: List[str]) -> None:
    for stmt in body:
        stmt(scope, out)


class _Parser:
    def __init__(self, toks: List[Token]):
        last = toks[-1][2] if toks else 1
        self.toks = toks + [("eof", None, last)]
        self.i = 0
        self.loops = 0
        #: the frame being parsed (the template's own at the root)
        self.frame = _Frame(None)

    def record(self, kind: str, name: str) -> None:
        self.frame.cur.append((kind, name))

    def child(self, params=()) -> _Frame:
        """Open a nested frame; the caller restores ``self.frame``."""
        self.frame = _Frame(self.frame, params)
        return self.frame

    # -- the stream ---------------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def look(self) -> Token:
        return self.toks[min(self.i + 1, len(self.toks) - 1)]

    def next(self) -> Token:
        tok = self.toks[self.i]
        if tok[0] != "eof":
            self.i += 1
        return tok

    def at(self, kind: str, value=None, tok: Optional[Token] = None) -> bool:
        tok = tok or self.cur
        return tok[0] == kind and (value is None or tok[1] == value)

    def skip(self, kind: str, value=None) -> bool:
        if self.at(kind, value):
            self.next()
            return True
        return False

    def expect(self, kind: str, value=None) -> Token:
        if not self.at(kind, value):
            want = value if value is not None else kind
            got = self.cur[1] if self.cur[0] != "eof" else "end of template"
            raise TemplateSyntaxError(f"expected {want!r}, got {got!r}",
                                      self.cur[2])
        return self.next()

    def fail(self, message: str, line: Optional[int] = None):
        raise TemplateSyntaxError(message, line or self.cur[2])

    # -- the template -------------------------------------------------------

    def parse(self) -> List[Stmt]:
        body = self.subparse(None)
        if not self.at("eof"):
            self.fail(f"unexpected tag {self.cur[1]!r}")
        return body

    def subparse(self, end: Optional[Tuple[str, ...]]) -> List[Stmt]:
        body: List[Stmt] = []
        while not self.at("eof"):
            kind, value, line = self.cur
            if kind == "data":
                self.next()
                body.append(lambda s, out, v=value: out.append(v))
            elif kind == "variable_begin":
                self.next()
                expr = self.parse_tuple()
                self.expect("variable_end")
                body.append(lambda s, out, e=expr: out.append(_soft_str(e(s))))
            elif kind == "block_begin":
                self.next()
                if end is not None and self.cur[0] == "name" \
                        and self.cur[1] in end:
                    return body
                body.append(self.parse_statement())
                self.expect("block_end")
            else:
                self.fail(f"unexpected {value!r}")
        if end is not None:
            self.fail(f"unexpected end of template; expected "
                      f"{' or '.join(repr(e) for e in end)}")
        return body

    def statements(self, end: Tuple[str, ...], drop: bool = False
                   ) -> List[Stmt]:
        self.skip("op", ":")
        self.expect("block_end")
        body = self.subparse(end)
        if drop:
            self.next()
        return body

    def parse_statement(self) -> Stmt:
        kind, name, line = self.cur
        if kind != "name":
            self.fail("tag name expected")
        if name not in _STATEMENTS:
            if name.startswith("end") or name in ("elif", "else"):
                self.fail(f"encountered unknown tag {name!r}")
            raise UnsupportedConstruct(f"the {{% {name} %}} tag", line)
        return getattr(self, "parse_" + name)()

    def parse_for(self) -> Stmt:
        line = self.expect("name", "for")[2]
        target, names, nsrefs = self.parse_target(("in",))
        if nsrefs:
            self.fail("expected a name in a for-loop target", line)
        if "loop" in names:
            self.fail("can't assign to special loop variable in for-loop "
                      "target", line)
        self.expect("name", "in")
        iterable = self.parse_tuple(with_condexpr=False,
                                    end=("recursive",))
        outer = self.frame
        test = test_frame = else_frame = None
        if self.skip("name", "if"):
            test_frame = self.child(names)
            test = self.parse_expression()
            self.frame = outer
        if self.at("name", "recursive"):
            raise UnsupportedConstruct("a recursive for loop", line)
        body_frame = self.child(names + ("loop",))
        self.loops += 1
        body = self.statements(("endfor", "else"))
        self.loops -= 1
        self.frame = outer
        else_: List[Stmt] = []
        if self.next()[1] == "else":
            else_frame = self.child()
            else_ = self.statements(("endfor",), drop=True)
            self.frame = outer

        def run(scope, out):
            items = iterable(scope)
            if test is not None:
                inner = _Scope(scope, test_frame)
                kept = []
                for item in items:
                    target(inner, item)
                    if test(inner):
                        kept.append(item)
                items = kept
            else:
                items = list(items)
            loop = _Loop(items)
            # Jinja's else runs unless an iteration ran its body to the
            # end (a break or continue on the last one leaves it to run)
            completed = False
            for i, item in enumerate(items):
                loop.index0 = i
                inner = _Scope(scope, body_frame)
                inner.vars["loop"] = loop
                target(inner, item)
                try:
                    _render(body, inner, out)
                except _Continue:
                    continue
                except _Break:
                    break
                completed = True
            if else_frame is not None and not completed:
                _render(else_, _Scope(scope, else_frame), out)

        return run

    def parse_if(self) -> Stmt:
        """``if``/``elif``/``else``; its names are analyzed as Jinja's
        ``visit_If`` does: the test in this frame, then the body, the elifs
        (each a test and a one-branch ``if``) and the else as branches."""
        self.expect("name", "if")
        frame = self.frame
        saved = frame.cur
        branches, events = [], [[], [], []]
        test = self.parse_tuple(with_condexpr=False)
        frame.cur = events[0]
        body = self.statements(("elif", "else", "endif"))
        branches.append((test, body))
        while True:
            tok = self.next()
            if tok[1] == "elif":
                frame.cur = events[1]
                test = self.parse_tuple(with_condexpr=False)
                elif_body: list = []
                frame.cur = elif_body
                body = self.statements(("elif", "else", "endif"))
                events[1].append(("if", [elif_body, [], []]))
                branches.append((test, body))
                continue
            if tok[1] == "else":
                frame.cur = events[2]
                branches.append((lambda s: True,
                                 self.statements(("endif",), drop=True)))
            break
        frame.cur = saved
        saved.append(("if", events))

        def run(scope, out):
            for test, body in branches:
                if test(scope):
                    _render(body, scope, out)
                    return

        return run

    def parse_set(self) -> Stmt:
        line = self.next()[2]
        target, names, nsrefs = self.parse_target(None, namespace=True)
        if self.skip("op", "="):
            expr = self.parse_tuple()
            self._stores(names, nsrefs)
            return lambda scope, out: target(scope, expr(scope))
        if self.at("op", "|"):
            raise UnsupportedConstruct("a filtered {% set %} block", line)
        outer = self.frame
        frame = self.child()
        body = self.statements(("endset",), drop=True)
        self.frame = outer
        self._stores(names, nsrefs)

        def run(scope, out):
            buf: List[str] = []
            _render(body, _Scope(scope, frame), buf)
            target(scope, "".join(buf))

        return run

    def _stores(self, names, nsrefs) -> None:
        """Record an assignment's target: its names stored, a namespace's
        name read."""
        for name in names:
            self.record("store", name)
        for ref in nsrefs:
            self.record("load", ref.name)
            self.frame.refs.append(ref)

    def parse_break(self) -> Stmt:
        line = self.next()[2]
        if not self.loops:
            self.fail("'break' outside a loop", line)

        def run(scope, out):
            raise _Break()

        return run

    def parse_continue(self) -> Stmt:
        line = self.next()[2]
        if not self.loops:
            self.fail("'continue' outside a loop", line)

        def run(scope, out):
            raise _Continue()

        return run

    def parse_generation(self) -> Stmt:
        """``{% generation %}``: its body renders as the caller of a call
        block, a frame of its own."""
        self.next()
        outer = self.frame
        frame = self.child()
        loops, self.loops = self.loops, 0
        body = self.statements(("endgeneration",), drop=True)
        self.loops = loops
        self.frame = outer

        def run(scope, out):
            buf: List[str] = []
            _render(body, _Scope(scope, frame), buf)
            out.append("".join(buf))

        return run

    def parse_target(self, end: Optional[Tuple[str, ...]],
                     namespace: bool = False):
        """An assignment target: a name, ``ns.attr``, or a tuple of
        targets. Returns ``assign(scope, value)``, the names it stores and
        the namespace references it reads (unrecorded: the caller records
        them where Jinja's analysis visits the target)."""
        parts, is_tuple = [], False
        names: List[str] = []
        nsrefs: List[_Ref] = []
        while True:
            if parts:
                self.expect("op", ",")
            if self.at("variable_end") or self.at("block_end") \
                    or self.at("op", ")") or (
                    end and self.cur[0] == "name" and self.cur[1] in end):
                break
            parts.append(self.parse_target_primary(namespace, names, nsrefs))
            if self.at("op", ","):
                is_tuple = True
            else:
                break
        if not parts:
            self.fail("expected an assignment target")
        if not is_tuple:
            return parts[0], tuple(names), nsrefs

        def assign(scope, value):
            values = list(value)
            if len(values) != len(parts):
                raise ValueError(f"cannot unpack {len(values)} values into "
                                 f"{len(parts)} targets")
            for part, v in zip(parts, values):
                part(scope, v)

        return assign, tuple(names), nsrefs

    def parse_target_primary(self, namespace: bool, names: List[str],
                             nsrefs: List[_Ref]):
        kind, value, line = self.cur
        if kind == "op" and value == "(":
            self.next()
            inner, more, refs = self.parse_target(None, namespace)
            names.extend(more)
            nsrefs.extend(refs)
            self.expect("op", ")")
            return inner
        name = self.expect("name")[1]
        if name in ("true", "false", "True", "False", "none", "None"):
            self.fail(f"can't assign to {name!r}", line)
        if namespace and self.at("op", "."):
            self.next()
            attr = self.expect("name")[1]
            ref = _Ref(name)
            nsrefs.append(ref)

            def assign_attr(scope, v):
                ns = ref(scope)
                if not isinstance(ns, Namespace):
                    raise TemplateRuntimeError("cannot assign attribute on "
                                               "non-namespace object")
                ns[attr] = v

            return assign_attr
        names.append(name)

        def assign(scope, v):
            scope.vars[name] = v

        return assign

    # -- expressions --------------------------------------------------------

    def parse_tuple(self, with_condexpr: bool = True,
                    end: Optional[Tuple[str, ...]] = None,
                    explicit: bool = False) -> Expr:
        items, is_tuple = [], False
        while True:
            if items:
                self.expect("op", ",")
            if self.at("variable_end") or self.at("block_end") \
                    or self.at("op", ")") or (
                    end and self.cur[0] == "name" and self.cur[1] in end):
                break
            items.append(self.parse_expression(with_condexpr))
            if self.at("op", ","):
                is_tuple = True
            else:
                break
        if not is_tuple:
            if items:
                return items[0]
            if not explicit:
                self.fail(f"expected an expression, got {self.cur[1]!r}")
        return lambda s: tuple(f(s) for f in items)

    def parse_expression(self, with_condexpr: bool = True) -> Expr:
        return self.parse_condexpr() if with_condexpr else self.parse_or()

    def parse_condexpr(self) -> Expr:
        expr1 = self.parse_or()
        while self.skip("name", "if"):
            line = self.cur[2]
            cond = self.parse_or()
            other = self.parse_condexpr() if self.skip("name", "else") \
                else None

            def condexpr(s, a=expr1, c=cond, b=other, line=line):
                if c(s):
                    return a(s)
                if b is None:
                    return Undefined(f"the inline if-expression on line "
                                     f"{line} evaluated to false and no "
                                     f"else section was defined.")
                return b(s)

            expr1 = condexpr
        return expr1

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.skip("name", "or"):
            right = self.parse_and()
            left = (lambda s, a=left, b=right: a(s) or b(s))
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.skip("name", "and"):
            right = self.parse_not()
            left = (lambda s, a=left, b=right: a(s) and b(s))
        return left

    def parse_not(self) -> Expr:
        if self.skip("name", "not"):
            inner = self.parse_not()
            return lambda s: not inner(s)
        return self.parse_compare()

    def parse_compare(self) -> Expr:
        expr = self.parse_math1()
        ops = []
        while True:
            kind, value, _ = self.cur
            if kind == "op" and value in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                ops.append((_COMPARE[value], self.parse_math1()))
            elif self.skip("name", "in"):
                ops.append((_COMPARE["in"], self.parse_math1()))
            elif self.at("name", "not") and self.at("name", "in", self.look()):
                self.next()
                self.next()
                ops.append((_COMPARE["notin"], self.parse_math1()))
            else:
                break
        if not ops:
            return expr

        def compare(s):
            left = expr(s)
            result = True
            for op, right in ops:
                r = right(s)
                result = op(left, r)
                if not result:
                    return result
                left = r
            return result

        return compare

    def _binary(self, ops: Tuple[str, ...], sub: Callable[[], Expr]) -> Expr:
        left = sub()
        while self.cur[0] == "op" and self.cur[1] in ops:
            op = _BINOPS[self.next()[1]]
            right = sub()
            left = (lambda s, a=left, b=right, op=op: op(a(s), b(s)))
        return left

    def parse_math1(self) -> Expr:
        return self._binary(("+", "-"), self.parse_concat)

    def parse_concat(self) -> Expr:
        parts = [self.parse_math2()]
        while self.skip("op", "~"):
            parts.append(self.parse_math2())
        if len(parts) == 1:
            return parts[0]
        return lambda s: "".join(str(p(s)) for p in parts)

    def parse_math2(self) -> Expr:
        return self._binary(("*", "/", "//", "%"), self.parse_pow)

    def parse_pow(self) -> Expr:
        return self._binary(("**",), self.parse_unary)

    def parse_unary(self, with_filter: bool = True) -> Expr:
        if self.skip("op", "-"):
            inner = self.parse_unary(False)
            node = lambda s: -inner(s)   # noqa: E731
        elif self.skip("op", "+"):
            inner = self.parse_unary(False)
            node = lambda s: +inner(s)   # noqa: E731
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filter_expr(node)
        return node

    def parse_primary(self) -> Expr:
        kind, value, line = self.cur
        if kind == "name":
            self.next()
            if value in ("true", "True"):
                return lambda s: True
            if value in ("false", "False"):
                return lambda s: False
            if value in ("none", "None"):
                return lambda s: None
            if value in _UNSUPPORTED_GLOBALS:
                raise UnsupportedConstruct(f"the global {value!r}", line)
            ref = _Ref(value)
            self.record("load", value)
            self.frame.refs.append(ref)
            return ref
        if kind == "string":
            buf = [self.next()[1]]
            while self.at("string"):
                buf.append(self.next()[1])
            text = "".join(buf)
            return lambda s: text
        if kind in ("integer", "float"):
            self.next()
            return lambda s: value
        if kind == "op" and value == "(":
            self.next()
            node = self.parse_tuple(explicit=True)
            self.expect("op", ")")
            return node
        if kind == "op" and value == "[":
            self.next()
            items = []
            while not self.at("op", "]"):
                if items:
                    self.expect("op", ",")
                if self.at("op", "]"):
                    break
                items.append(self.parse_expression())
            self.expect("op", "]")
            return lambda s: [f(s) for f in items]
        if kind == "op" and value == "{":
            self.next()
            pairs = []
            while not self.at("op", "}"):
                if pairs:
                    self.expect("op", ",")
                if self.at("op", "}"):
                    break
                key = self.parse_expression()
                self.expect("op", ":")
                pairs.append((key, self.parse_expression()))
            self.expect("op", "}")
            return lambda s: {k(s): v(s) for k, v in pairs}
        self.fail(f"unexpected {value!r}" if kind != "eof"
                  else "unexpected end of template")

    def parse_postfix(self, node: Expr) -> Expr:
        while True:
            if self.at("op", ".") or self.at("op", "["):
                node = self.parse_subscript(node)
            elif self.at("op", "("):
                node = self.parse_call(node)
            else:
                return node

    def parse_filter_expr(self, node: Expr) -> Expr:
        while True:
            if self.at("op", "|"):
                node = self.parse_filter(node)
            elif self.at("name", "is"):
                node = self.parse_test(node)
            elif self.at("op", "("):
                node = self.parse_call(node)
            else:
                return node

    def parse_subscript(self, node: Expr) -> Expr:
        tok = self.next()
        if tok[1] == ".":
            kind, attr, line = self.next()
            if kind == "name":
                return lambda s: getattr_(node(s), attr)
            if kind != "integer":
                self.fail("expected name or number", line)
            return lambda s: getitem_(node(s), attr)
        args = []
        while not self.at("op", "]"):
            if args:
                self.expect("op", ",")
            args.append(self.parse_subscribed())
        self.expect("op", "]")
        if len(args) == 1:
            arg = args[0]
        else:
            arg = (lambda s: tuple(a(s) for a in args))
        return lambda s: getitem_(node(s), arg(s))

    def parse_subscribed(self) -> Expr:
        parts: List[Optional[Expr]] = []
        if self.at("op", ":"):
            self.next()
            parts.append(None)
        else:
            node = self.parse_expression()
            if not self.at("op", ":"):
                return node
            self.next()
            parts.append(node)
        if self.at("op", ":"):
            parts.append(None)
        elif not (self.at("op", "]") or self.at("op", ",")):
            parts.append(self.parse_expression())
        else:
            parts.append(None)
        if self.at("op", ":"):
            self.next()
            if not (self.at("op", "]") or self.at("op", ",")):
                parts.append(self.parse_expression())
            else:
                parts.append(None)
        else:
            parts.append(None)
        return lambda s: slice(*(None if p is None else p(s) for p in parts))

    def parse_call_args(self) -> Tuple[List[Expr], Dict[str, Expr]]:
        line = self.expect("op", "(")[2]
        args: List[Expr] = []
        kwargs: Dict[str, Expr] = {}
        while not self.at("op", ")"):
            if args or kwargs:
                self.expect("op", ",")
                if self.at("op", ")"):
                    break
            if self.at("op", "*") or self.at("op", "**"):
                raise UnsupportedConstruct("*args and **kwargs in a call",
                                           line)
            if self.at("name") and self.at("op", "=", self.look()):
                key = self.next()[1]
                self.next()
                kwargs[key] = self.parse_expression()
            else:
                if kwargs:
                    self.fail("invalid syntax for function call expression",
                              line)
                args.append(self.parse_expression())
        self.expect("op", ")")
        return args, kwargs

    def parse_call(self, node: Expr) -> Expr:
        args, kwargs = self.parse_call_args()
        return lambda s: _call(node(s), [a(s) for a in args],
                               {k: v(s) for k, v in kwargs.items()})

    def _dotted_name(self) -> str:
        name = self.expect("name")[1]
        while self.at("op", "."):
            self.next()
            name += "." + self.expect("name")[1]
        return name

    def parse_filter(self, node: Expr) -> Expr:
        while self.skip("op", "|"):
            line = self.cur[2]
            name = self._dotted_name()
            if name not in FILTERS:
                raise UnsupportedConstruct(f"the filter {name!r}", line)
            args, kwargs = (self.parse_call_args() if self.at("op", "(")
                            else ([], {}))
            self._check_named_args(name, args, line)
            fn = FILTERS[name]
            node = (lambda s, v=node, fn=fn, a=args, k=kwargs: fn(
                v(s), *[x(s) for x in a], **{n: x(s) for n, x in k.items()}))
        return node

    def _check_named_args(self, name: str, args: List[Expr], line: int):
        """A test named by select/reject/selectattr/rejectattr, or a filter
        named by map, must be one this module has: checked here, on the
        constant argument, so that no render meets an unknown one."""
        if name not in _NAMED_ARGS:
            return
        at, table = _NAMED_ARGS[name]
        if len(args) <= at:
            return
        try:
            named = args[at](None)
        except Exception:
            named = None
        if not isinstance(named, str):
            raise UnsupportedConstruct(f"a computed name in the filter "
                                       f"{name!r}", line)
        if named not in table:
            what = "test" if table is TESTS else "filter"
            raise UnsupportedConstruct(f"the {what} {named!r}", line)

    def parse_test(self, node: Expr) -> Expr:
        line = self.next()[2]
        negated = self.skip("name", "not")
        name = self._dotted_name()
        if name not in TESTS:
            raise UnsupportedConstruct(f"the test {name!r}", line)
        kwargs: Dict[str, Expr] = {}
        if self.at("op", "("):
            args, kwargs = self.parse_call_args()
        elif (self.cur[0] in ("name", "string", "integer", "float")
              or (self.cur[0] == "op" and self.cur[1] in "([{")) \
                and not (self.cur[0] == "name"
                         and self.cur[1] in ("else", "or", "and")):
            if self.at("name", "is"):
                self.fail("you cannot chain multiple tests with is")
            args = [self.parse_postfix(self.parse_primary())]
        else:
            args = []
        fn = TESTS[name]

        def test(s):
            return fn(node(s), *[a(s) for a in args],
                      **{k: v(s) for k, v in kwargs.items()})

        if negated:
            return lambda s: not test(s)
        return test


# -- templates ---------------------------------------------------------------


class ChatTemplate:
    """One compiled template; :meth:`render` takes the context's names."""

    def __init__(self, source: str):
        self.source = source
        parser = _Parser(tokenize(source))
        self._body = parser.parse()
        self._frame = parser.frame
        self._frame.analyze()

    def render(self, **context) -> str:
        scope = _Scope(None, self._frame, {**GLOBALS, **context})
        out: List[str] = []
        try:
            _render(self._body, scope, out)
        except (_Break, _Continue):   # pragma: no cover - refused at compile
            raise TemplateError("loop control outside a loop") from None
        return "".join(out)


@lru_cache(maxsize=32)
def compile_template(source: str) -> ChatTemplate:
    """The compiled template of ``source``, once per string (as
    ``transformers`` caches ``_compile_jinja_template``)."""
    return ChatTemplate(source)


def render_chat(source: str, messages, add_generation_prompt: bool,
                special_tokens: Optional[Dict[str, Any]] = None) -> str:
    """``apply_chat_template(messages, tokenize=False,
    add_generation_prompt=...)``: the template's context is the messages,
    ``tools`` and ``documents`` None, ``add_generation_prompt`` and the
    tokenizer's special tokens map."""
    return compile_template(source).render(**{
        **(special_tokens or {}), "messages": messages, "tools": None,
        "documents": None, "add_generation_prompt": add_generation_prompt})
