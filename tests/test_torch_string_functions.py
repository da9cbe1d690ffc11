"""The string family in the port, held against the JAX package on the CPU:
every one of the 41 classes over a dictionary column and a plain column
(seeded rows with nulls, empty strings and non-ASCII text) on the port's
device path against the reference's device path, and on the port's CPU
engine against the reference's CPU engine; the two engines of the port
against each other on ASCII rows; placement as the reference's, with the
reasons ``explain`` names.

Tolerance: exact. Strings are compared as their UTF-8 bytes (the
device's Reverse of a multi-byte character and its Chr of 128-255 are not
valid UTF-8, as the reference's). Where the engines differ on non-ASCII
text (``NON_ASCII_DIFFERENT``) the device is held to the reference's
device and the CPU engine to the reference's CPU engine, and ROADMAP.md
lists each class.
"""

import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.columnar.batch import dictionary_encode_table
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs.segscan import (exclusive_states,
                                                  segmented_compose)
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

WORDS = ["hello world", "", "aXbXcXXd", "  pad me  ", "abcabcabc",
         "Hello World foo", "4142", "QUJDRA==", "a,b", "xxx", "x",
         "Mixed CASE words here", "a  b", "0", "ff0A", "QUJD\nRA==",
         "héllo wörld", "日本語テキスト", "ñ"]
NON_ASCII = {"héllo wörld", "日本語テキスト", "ñ"}


def table(seed: int = 16) -> pa.Table:
    """``d``: a few words repeated (a dictionary column), ``p``: the
    words made distinct (a plain column), ``q``: a second plain column
    for the two-column classes, ``n``: integers for Chr/Hex/Bin/space,
    ``x``: doubles for format_number; each with nulls."""
    rng = np.random.default_rng(seed)
    n = 120
    pick = rng.integers(0, len(WORDS), n)
    null = rng.random(n) < 0.1
    d = [None if null[i] else WORDS[pick[i]] for i in range(n)]
    p = [None if null[(i + 7) % n] else WORDS[pick[(i * 5) % n]] + str(i)
         for i in range(n)]
    q = [None if null[(i + 3) % n] else WORDS[pick[(i * 3) % n]][:4]
         for i in range(n)]
    nums = rng.integers(-300, 3000, n)
    x = rng.normal(0, 1e5, n).round(3)
    t = pa.table({"d": pa.array(d, pa.string()), "p": pa.array(p),
                  "q": pa.array(q), "n": pa.array(nums, pa.int64(),
                                                  mask=null[::-1]),
                  "x": pa.array(x, pa.float64())})
    enc = dictionary_encode_table(t)
    assert pa.types.is_dictionary(enc.column("d").type)
    assert not pa.types.is_dictionary(enc.column("p").type)
    return t


def device_exprs(M, s: str):
    """(name, expression) of every device class of the family over
    column ``s`` (one projection, so that the reference compiles once)."""
    c = M.col(s)
    return [
        ("len", M.Length(c)), ("oct", M.OctetLength(c)),
        ("bits", M.BitLength(c)), ("up", M.Upper(c)), ("lo", M.Lower(c)),
        ("ic", M.InitCap(c)), ("rev", M.StringReverse(c)),
        ("sw", M.StartsWith(c, M.lit("he"))),
        ("ew", M.EndsWith(c, M.lit("d"))),
        ("ct", M.Contains(c, M.lit("X"))),
        ("cat", M.Concat(c, M.lit("-"), M.col("q"))),
        ("cws", M.ConcatWs(c, M.col("q"), M.lit("z"), sep="//")),
        ("tr", M.StringTrim(c)), ("trl", M.StringTrimLeft(c, "a ")),
        ("trr", M.StringTrimRight(c, "d ")),
        ("rep", M.StringReplace(c, "X", "YY")),
        ("rep2", M.StringReplace(c, "XX", "")),
        ("rep3", M.StringReplace(c, "abc", "Z")),
        ("instr", M.StringInstr(c, "X")),
        ("loc", M.StringLocate(c, "X", 3)),
        ("loc0", M.StringLocate(c, "b", 0)),
        ("lpad", M.StringLPad(c, 8, "*-")), ("rpad", M.StringRPad(c, 4, "")),
        ("rpad2", M.StringRPad(c, 12, "=")),
        ("rpt", M.StringRepeat(c, 2)),
        ("tl", M.StringTranslate(c, "lXaq", "L!")),
        ("si", M.SubstringIndex(c, "X", 2)),
        ("si2", M.SubstringIndex(c, "X", -1)),
        ("si3", M.SubstringIndex(c, "abc", -2)),
        ("si4", M.SubstringIndex(c, " ", 1)),
        ("b64", M.Base64(c)), ("ub64", M.UnBase64(c)),
        ("hex", M.Hex(c)), ("unhex", M.Unhex(c)),
        ("hexn", M.Hex(M.col("n"))),
        ("fis", M.FindInSet(c, "a,hello world,4142,x")),
        ("ov", M.Overlay(c, M.lit("__"), 2, 3)),
        ("asc", M.Ascii(c)), ("chr", M.Chr(M.col("n"))),
        ("left", M.StringLeft(c, 3)), ("right", M.StringRight(c, 3)),
    ]


# the CPU engine's classes (the reference's device_supported = False)
def cpu_exprs(M, s: str):
    c = M.col(s)
    return [
        ("bin", M.Bin(M.col("n"))), ("md5", M.Md5(c)), ("sha1", M.Sha1(c)),
        ("sha2", M.Sha2(c, 384)), ("crc", M.Crc32(c)),
        ("fmt", M.FormatNumber(M.col("x"), 2)),
        ("space", M.StringSpace(M.Pmod(M.col("n"), M.lit(7)))
         if hasattr(M, "Pmod") else M.StringSpace(M.col("n"))),
        ("lev", M.Levenshtein(c, M.col("q"))),
        ("ov_default", M.Overlay(c, M.col("q"), 3)),
    ]


# classes whose engines differ on non-ASCII rows (ROADMAP.md lists them)
NON_ASCII_DIFFERENT = ("len", "up", "lo", "ic", "rev", "lpad", "rpad",
                       "rpad2", "tl", "ov", "left", "right", "chr")
# malformed base64 (ROADMAP.md): the device drops the bytes outside the
# alphabet and then needs whole groups, the CPU engine is Python's decoder,
# which stops at the first padding; each is its reference's engine's
CANONICAL_B64 = re.compile(
    r"([A-Za-z0-9+/]{4})*([A-Za-z0-9+/]{2}==|[A-Za-z0-9+/]{3}=)?")


def _rows(tbl: pa.Table):
    """Rows with strings as their UTF-8 bytes."""
    cols = {n: (c.cast(pa.binary()) if pa.types.is_string(c.type) else c)
            for n, c in zip(tbl.column_names, tbl.columns)}
    return pa.table(cols).to_pylist()


_JAX = {}


def _cpu_nodes(text: str):
    return [ln for ln in text.splitlines() if ln.lstrip().startswith("!")]


def _jax(build, s: str, device: bool):
    key = (build.__name__, s, device)
    if key not in _JAX:
        conf = None if device else JConf({"spark.rapids.tpu.sql.enabled":
                                          "false"})
        df = jax_from_arrow(table(), conf)
        df.shuffle_partitions = 1
        _JAX[key] = _rows(df.select(*[e.alias(n) for n, e in build(JE, s)])
                          .to_arrow())
    return _JAX[key]


def _port(build, s: str, device: bool, exprs=None):
    conf = None if device else RapidsConf({"spark.rapids.gpu.sql.enabled":
                                           "false"})
    df = port_from_arrow(table(), conf, device="cpu")
    return df.select(*[e.alias(n) for n, e in (exprs or build(PE, s))])


@pytest.mark.parametrize("s", ["d", "p"])
def test_device_classes_match_the_reference_device(s):
    q = _port(device_exprs, s, True)
    assert _cpu_nodes(q.explain()) == []
    got, exp = _rows(q.to_arrow()), _jax(device_exprs, s, True)
    for name, _ in device_exprs(PE, s):
        assert [r[name] for r in got] == [r[name] for r in exp], name


@pytest.mark.parametrize("s", ["d", "p"])
def test_cpu_engine_matches_the_reference_cpu_engine(s):
    got = _rows(_port(device_exprs, s, False).to_arrow())
    exp = _jax(device_exprs, s, False)
    vals = table().column(s).to_pylist()
    for name, _ in device_exprs(PE, s):
        if name == "unhex":  # the reference's bytes.fromhex skips spaces
            spaced = [v is not None and " " in v for v in vals]
            assert all(r["unhex"] is None for r, sp in zip(got, spaced)
                       if sp)
            assert [r[name] for r, sp in zip(got, spaced) if not sp] == [
                r[name] for r, sp in zip(exp, spaced) if not sp]
            continue
        assert [r[name] for r in got] == [r[name] for r in exp], name


def test_cpu_only_classes_match_the_reference_cpu_engine():
    exprs = cpu_exprs(PE, "d")
    q = _port(None, "d", True, exprs)
    text = q.explain()
    for cls in ("Bin", "Md5", "Sha1", "Sha2", "Crc32", "FormatNumber",
                "StringSpace", "Levenshtein", "Overlay"):
        assert f"expression {cls} not on device" in text, cls
    got = _rows(q.to_arrow())
    exp = _jax(cpu_exprs, "d", False)
    for name, _ in exprs:
        if name == "space":  # the reference's space of a negative count
            continue
        assert [r[name] for r in got] == [r[name] for r in exp], name
    assert [r["space"] for r in got] == [
        None if r["n"] is None else b" " * max(r["n"] % 7, 0)
        for r in table().to_pylist()]


@pytest.mark.parametrize("s", ["d", "p"])
def test_the_two_engines_agree_on_ascii_rows(s):
    dev = _rows(_port(device_exprs, s, True).to_arrow())
    cpu = _rows(_port(device_exprs, s, False).to_arrow())
    ascii_rows = [i for i, v in enumerate(table().column(s).to_pylist())
                  if v is None or v.isascii()]
    assert len(ascii_rows) < len(dev)
    for name, _ in device_exprs(PE, s):
        rows = range(len(dev)) if name not in NON_ASCII_DIFFERENT \
            else ascii_rows
        if name == "chr":  # Chr of 128-255: one byte against two
            rows = [i for i in range(len(dev))
                    if dev[i]["chr"] is None or dev[i]["chr"] < b"\x80"]
        if name == "ub64":
            vals = table().column(s).to_pylist()
            rows = [i for i in ascii_rows if vals[i] is None
                    or CANONICAL_B64.fullmatch(vals[i])]
        assert [dev[i][name] for i in rows] == [cpu[i][name]
                                                for i in rows], name


def test_the_reference_device_reverse_is_not_utf8():
    """Kept for equivalence (ROADMAP.md): the device reverses bytes, so a
    multi-byte character comes out reversed, as on the reference's
    device."""
    t = pa.table({"s": ["ñ", "ab"]})
    got = _rows(port_from_arrow(t, device="cpu").select(
        PE.StringReverse(PE.col("s")).alias("r")).to_arrow())
    assert [r["r"] for r in got] == [b"\xb1\xc3", b"ba"]


def test_find_in_set_of_an_empty_item_on_both_engines():
    """An empty item matches the empty string (the reference's device
    path fails on an empty literal)."""
    t = pa.table({"s": ["", "a", "b", None, "c,"]})
    outs = []
    for conf in (None, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                   "false"})):
        outs.append(port_from_arrow(t, conf, device="cpu").select(
            PE.FindInSet(PE.col("s"), "a,,b").alias("i")).collect())
    assert outs[0] == outs[1] == [{"i": 2}, {"i": 1}, {"i": 3}, {"i": None},
                                  {"i": 0}]


def test_empty_inputs_on_both_engines():
    """An empty batch, empty strings only and an all-null column."""
    for vals in ([], ["", ""], [None, None]):
        t = pa.table({"d": pa.array(vals, pa.string()),
                      "p": pa.array(vals, pa.string()),
                      "q": pa.array(vals, pa.string()),
                      "n": pa.array([None] * len(vals), pa.int64()),
                      "x": pa.array([None] * len(vals), pa.float64())})
        outs = []
        for conf in (None, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                       "false"})):
            df = port_from_arrow(t, conf, device="cpu")
            outs.append(_rows(df.select(*[e.alias(n) for n, e in
                                          device_exprs(PE, "p")])
                              .to_arrow()))
        assert outs[0] == outs[1]
        assert len(outs[0]) == len(vals)


def _plain(vals):
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow

    return batch_from_arrow(pa.table({"s": pa.array(vals, pa.string())}),
                            device="cpu").columns[0]


def test_the_compose_scan_equals_a_walk_of_each_row():
    """A random DFA's per-byte transitions composed by the scan give the
    state a byte-by-byte walk of each row gives."""
    rng = np.random.default_rng(3)
    vals = ["".join(rng.choice(list("abc"), rng.integers(0, 40)))
            for _ in range(200)]
    col = _plain(vals)
    delta = rng.integers(0, 5, (5, 256)).astype(np.uint8)
    fns = torch.from_numpy(delta[:, col.data.numpy()].T.copy())
    resets = torch.zeros(col.data.numel(), dtype=torch.bool)
    lens = col.lengths()
    resets[col.offsets[:-1][lens > 0].long()] = True
    h = segmented_compose(fns, resets, int(lens.max()))
    ins = exclusive_states(h, resets, 2).numpy()
    pos = 0
    for v in vals:
        state = 2
        for ch in v.encode():
            assert ins[pos] == state
            state = delta[state, ch]
            pos += 1
        if v:
            assert h[pos - 1, 2] == state


def test_replace_is_greedy_left_to_right():
    col = _plain(["aaaa", "aaa", "abaaba", "", "aaaaab"])
    out = S.replace(col, b"aa", b"X")
    got = [bytes(out.data[out.offsets[i]:out.offsets[i + 1]].tolist())
           for i in range(5)]
    assert got == [b"XX", b"Xa", b"abXba", b"", b"XXab"]
