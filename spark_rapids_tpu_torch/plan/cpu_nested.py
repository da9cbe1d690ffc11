"""The CPU engine's nested expressions, JSON functions and BINARY casts
(counterpart of the matching parts of spark_rapids_tpu/plan/cpu.py).

A nested value on the host is its Arrow array (with the row validity
beside it, as every value): the nested functions read its offsets and
children with numpy, vectorised (an element or a map lookup is a gather
at the entry positions, array_contains a count of the matches a row). GetJsonObject walks
the document that Python's ``json`` parses (numbers kept as their text,
as the device copies them; ``-0`` comes out ``0``), JsonToStructsText re-serialises it compactly,
and BINARY casts to and from STRING keep the bytes (a BINARY value that is
not UTF-8 becomes U+FFFD where it breaks, since a host string must be
text; the device keeps the bytes).
"""

from __future__ import annotations

import json
from typing import Callable, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import expr as E

Pair = Tuple[np.ndarray, np.ndarray]


def nested_values(arr: pa.Array) -> Pair:
    """(values, valid) of a nested Arrow column: the Arrow array itself
    (the engine's nested functions read its offsets and children
    vectorised) and its validity."""
    valid = (np.ones(len(arr), np.bool_) if arr.null_count == 0
             else np.asarray(arr.is_valid(), dtype=np.bool_))
    return arr, valid


def objects(values: list) -> np.ndarray:
    """An object array of Python values (lists stay elements, not rows)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def host_objects(vals):
    """A nested value as an object array of Python values (a dict a
    struct row, a list an array row, ``(key, value)`` pairs a map row), for
    the engine's generic operations (aggregates' picks, group keys)."""
    return objects(vals.to_pylist()) if isinstance(vals, pa.Array) else vals


def nested_to_arrow(vals, valid: np.ndarray,
                    dt: T.DataType) -> pa.Array:
    if not isinstance(vals, pa.Array):
        return pa.array([v if ok else None for v, ok in zip(vals, valid)],
                        type=dt.arrow_type())
    if valid.all() or np.array_equal(
            np.asarray(vals.is_valid(), dtype=np.bool_), valid):
        return vals
    return pc.if_else(pa.array(valid), vals, pa.nulls(len(vals), vals.type))


def _ranges(arr: pa.Array, valid: np.ndarray):
    """(start, length) of each row's entries in ``arr.values`` (a null
    row's length 0)."""
    offs = np.asarray(arr.offsets, dtype=np.int64)
    return offs[:-1], np.where(valid, offs[1:] - offs[:-1], 0)


def _entries(start: np.ndarray, lens: np.ndarray):
    """(row, position in the entry child) of every entry of the rows."""
    total = int(lens.sum())
    rows = np.repeat(np.arange(len(lens)), lens)
    excl = np.cumsum(lens) - lens
    return rows, np.arange(total) + (start - excl)[rows]


def _child(arr: pa.Array, k: int) -> pa.Array:
    """An array's elements (``k`` None) or a map's keys (0) or values."""
    return arr.values if k is None else arr.values.field(k)


def _zeroed(vals, valid: np.ndarray, dt: T.DataType):
    """Values with the null rows' slots zero (an empty string or bytes)."""
    if isinstance(vals, pa.Array) or valid.all():
        return vals
    empty = {T.STRING: "", T.BINARY: b""}.get(dt, 0)
    return np.where(valid, vals, np.asarray(empty, dtype=vals.dtype))


def eval_nested(expr: E.Expression, ev: Callable, n: int) -> Pair:
    from spark_rapids_tpu_torch.plan.cpu import column_values, \
        values_to_arrow

    def arrow(e):
        vals, valid = ev(e)
        return nested_to_arrow(vals, valid, e.dtype), valid

    if isinstance(expr, E.GetStructField):
        d, m = arrow(expr.child)
        f = d.field(expr.child.dtype.field_index(expr.field))
        vals, fv = column_values(f, expr.dtype)
        valid = fv & m
        return _zeroed(vals, valid, expr.dtype), valid
    if isinstance(expr, E.CreateNamedStruct):
        kids = [values_to_arrow(*ev(c), c.dtype) for c in expr.children]
        return (pa.StructArray.from_arrays(kids, fields=list(
            expr.dtype.arrow_type())), np.ones(n, np.bool_))
    if isinstance(expr, (E.MapKeys, E.MapValues)):
        d, m = arrow(expr.child)
        out = pa.ListArray.from_arrays(
            d.offsets, d.values.field(0 if isinstance(expr, E.MapKeys)
                                      else 1),
            type=expr.dtype.arrow_type(), mask=pa.array(~m))
        return out, m.copy()
    if isinstance(expr, E.Size):
        d, m = arrow(expr.child)
        lens = _ranges(d, m)[1].astype(np.int32)
        if expr.legacy_null:
            return np.where(m, lens, -1).astype(np.int32), np.ones(n,
                                                                   np.bool_)
        return lens, m.copy()
    (d, m), (p, pm) = arrow(expr.left), ev(expr.right)
    ok_row = m & pm
    start, lens = _ranges(d, ok_row)
    if isinstance(expr, E.ElementAt) and isinstance(expr.left.dtype,
                                                    T.ArrayType):
        # 1-based; a negative index counts from the end
        i = np.asarray(p, np.int64)
        full = np.asarray(d.offsets, np.int64)
        ln = full[1:] - full[:-1]
        pos = np.where(i > 0, i - 1, ln + i)
        ok = ok_row & (pos >= 0) & (pos < ln) & (i != 0)
        vals, _ = column_values(_child(d, None), expr.dtype)
        if len(vals) == 0:
            return column_values(pa.nulls(n, expr.dtype.arrow_type()),
                                 expr.dtype)
        src = np.clip(start + pos, 0, len(vals) - 1)
        return _zeroed(vals[src], ok, expr.dtype), ok
    is_map = isinstance(expr.left.dtype, T.MapType)
    keys, _ = column_values(_child(d, 0 if is_map else None),
                            expr.left.dtype.key if is_map
                            else expr.left.dtype.element)
    rows, at = _entries(start, lens)
    eq = keys[at] == np.asarray(p)[rows]
    if isinstance(expr, E.ArrayContains):
        hit = np.bincount(rows[eq], minlength=n) > 0
        return hit & ok_row, ok_row
    first = np.full(n, len(at), np.int64)
    np.minimum.at(first, rows[eq], np.flatnonzero(eq))
    found = first < len(at)
    vals, vvalid = column_values(_child(d, 1), expr.dtype)
    src = at[np.minimum(first, max(len(at) - 1, 0))] if len(at) else \
        np.zeros(n, np.int64)
    if len(vals) == 0:
        return column_values(pa.nulls(n, expr.dtype.arrow_type()),
                             expr.dtype)
    valid = found & vvalid[src]
    return _zeroed(vals[src], valid, expr.dtype), valid


class _Raw(str):
    """A JSON number with a fraction or an exponent, kept as the text it
    was written as (an integer is read as a Python int, whose text is the
    written one but for ``-0``)."""


def _json_text(v) -> str:
    """Compact JSON text of a parsed value (numbers as written)."""
    if isinstance(v, _Raw):
        return str(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if v is None:
        return "null"
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ",".join(_json_text(x) for x in v) + "]"
    return "{" + ",".join(f"{json.dumps(k)}:{_json_text(x)}"
                          for k, x in v.items()) + "}"


def _steps(path: str):
    """The steps of a path of ``$``, ``.name``, ``['name']`` and
    ``[index]`` (a negative index counts from the end): ("key", name) or
    ("index", i); None where the path selects nothing (a wildcard, say)."""
    if not path.startswith("$"):
        return None
    i, steps = 1, []
    while i < len(path):
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            steps.append(("key", path[i + 1: j]))
            i = j
        elif path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            tok = path[i + 1: j]
            if tok[:1] in ("'", '"'):
                steps.append(("key", tok[1:-1]))
            else:
                try:
                    steps.append(("index", int(tok)))
                except ValueError:
                    return None
            i = j + 1
        else:
            return None
    return steps


def _walk(obj, steps):
    """(value, found) at ``steps`` of a parsed document."""
    cur = obj
    for kind, arg in steps:
        if kind == "key":
            if not isinstance(cur, dict) or arg not in cur:
                return None, False
        elif not isinstance(cur, list) or not -len(cur) <= arg < len(cur):
            return None, False
        cur = cur[arg]
    return cur, True


# the documents last parsed and their parses: the paths of one projection
# read one column (the engine's cache gives them one array), parsed once
_LAST_PARSED: tuple = (None, None)
_BAD = object()


def _parsed(docs: np.ndarray) -> list:
    global _LAST_PARSED
    held, got = _LAST_PARSED
    if held is docs:
        return got
    got = []
    for x in docs:
        try:
            got.append(json.loads(x, parse_float=_Raw,
                                  parse_constant=_Raw))
        except (ValueError, TypeError):
            got.append(_BAD)
    _LAST_PARSED = (docs, got)
    return got


def get_json_object(docs: np.ndarray, valid: np.ndarray, path: str) -> Pair:
    steps = _steps(path)
    if steps is None:
        return np.full(len(docs), "", dtype=object), np.zeros_like(valid)
    out, ok = [], valid.copy()
    for i, obj in enumerate(_parsed(docs)):
        v, found = (None, False) if obj is _BAD else _walk(obj, steps)
        if not found or v is None or not valid[i]:
            out.append("")
            ok[i] = False
        elif isinstance(v, str) and not isinstance(v, _Raw):
            out.append(v)
        elif isinstance(v, int) and not isinstance(v, bool):
            out.append(str(v))
        else:
            out.append(_json_text(v))
    return np.array(out, dtype=object), ok


def json_to_text(docs: np.ndarray, valid: np.ndarray) -> Pair:
    out, ok = [], valid.copy()
    for i, x in enumerate(docs):
        try:
            out.append(json.dumps(json.loads(x), separators=(",", ":")))
        except (ValueError, TypeError):
            out.append("")
            ok[i] = False
    return np.array(out, dtype=object), ok


def cast_binary(vals: np.ndarray, valid: np.ndarray,
                dst: T.DataType) -> Pair:
    """BINARY -> STRING (the bytes read as UTF-8) or STRING -> BINARY."""
    if dst == T.BINARY:
        return np.array([s.encode("utf-8") for s in vals], dtype=object), \
            valid
    return np.array([b.decode("utf-8", "replace") for b in vals],
                    dtype=object), valid
