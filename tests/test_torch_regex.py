"""RLIKE, RegexpExtract and RegexpReplace in the port, held against the JAX
package and Python's ``re`` on the CPU, and the placement of the 44 string
and regex classes against the reference's planner.

- RLIKE with a pattern of the device's subset runs on the device: equal to
  the reference's device path on every row (bytes, non-ASCII included;
  ``AGAINST_DEVICE``'s patterns) and to ``re.search`` on ASCII rows (every
  pattern), over a dictionary and a plain column, on both of the port's
  engines.
- A pattern outside the subset (a back-reference, lookaround, a word
  boundary, an interior anchor, a DFA over the state cap) runs on the CPU
  engine on both sides, ``explain`` naming the reference's reason.
- RegexpExtract and RegexpReplace run on the CPU engine only; the
  reference's CPU engine does not evaluate them (NotImplementedError), so
  the port is held to ``re`` with Java's ``$n`` references.

Tolerance: exact.
"""

import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import regex as RX
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan import overrides as PO

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SUPPORTED = ["abc", "a.c", "^ab", "b$", "^x$", "[a-z]+@[a-z]+\\.com",
             "(ab|cd){2}", "x?y*z+", "\\d{3}-\\d{2}", "[^aeiou ]{4}",
             "colou?r", "(?:foo|bar)baz", "^$", "\\s\\S", "a{2,}",
             "[A-Z][a-z]+ [A-Z]", "é", "\\.org$|^www"]
UNSUPPORTED = {"(a)\\1": "unknown escape \\1",
               "(?=a)b": "group construct (?=",
               "(?<!a)b": "group construct (?<",
               "\\bword": "\\b boundary matcher",
               "a^b": "interior anchor",
               "(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)":
                   "DFA exceeds 96 states"}
TEXT = ["abc", "xabcx", "ab", "a-c", "bob", "x", "", "joe@mail.com",
        "abcd cdab", "xyzz", "123-45", "strength", "color colour", "foobaz",
        "barbaz", "tab\there", "Hello World", "café", "www.site.org",
        "a\nb", "aa", "word play", "babbbbbbb", "abaaaaaaab"]


def table(seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = 96
    pick = rng.integers(0, len(TEXT), n)
    null = rng.random(n) < 0.1
    d = [None if null[i] else TEXT[pick[i]] for i in range(n)]
    p = [None if null[(i + 5) % n] else TEXT[pick[(i * 7) % n]] + "~" + str(i)
         for i in range(n)]
    return pa.table({"d": pa.array(d, pa.string()), "p": pa.array(p)})


def _rlikes(M, s, patterns):
    return [M.RLike(M.col(s), p).alias(f"r{i}")
            for i, p in enumerate(patterns)]


CPU = {"spark.rapids.gpu.sql.enabled": "false"}


def _port(exprs, conf=None, t=None):
    return port_from_arrow(t if t is not None else table(),
                           RapidsConf(conf) if conf else None,
                           device="cpu").select(*exprs)


def _cpu_nodes(text: str):
    return [ln for ln in text.splitlines() if ln.lstrip().startswith("!")]


# held against the reference's device path in one projection over both
# columns (its compile is the test's cost)
AGAINST_DEVICE = ("^ab", "[a-z]+@[a-z]+\\.com", "(ab|cd){2}", "é")


def test_rlike_matches_the_reference_device():
    exprs = [PE.RLike(PE.col(s), p).alias(f"{s}{i}") for s in "dp"
             for i, p in enumerate(AGAINST_DEVICE)]
    q = _port(exprs)
    assert _cpu_nodes(q.explain()) == []
    jdf = jax_from_arrow(table())
    jdf.shuffle_partitions = 1
    assert q.collect() == jdf.select(*[
        JE.RLike(JE.col(s), p).alias(f"{s}{i}") for s in "dp"
        for i, p in enumerate(AGAINST_DEVICE)]).collect()


@pytest.mark.parametrize("s", ["d", "p"])
def test_rlike_matches_re_on_both_engines(s):
    exprs = _rlikes(PE, s, SUPPORTED)
    q = _port(exprs)
    assert _cpu_nodes(q.explain()) == []
    got = q.collect()
    assert _port(exprs, CPU).collect() == got
    vals = table().column(s).to_pylist()
    for i, p in enumerate(SUPPORTED):
        prog = re.compile(p)
        exp = [None if v is None else prog.search(v) is not None
               for v in vals]
        ascii_rows = [k for k, v in enumerate(vals) if v is None
                      or v.isascii()]
        assert [got[k][f"r{i}"] for k in ascii_rows] == [
            exp[k] for k in ascii_rows], p


@pytest.mark.parametrize("pattern", list(UNSUPPORTED))
def test_an_unsupported_pattern_runs_on_the_cpu_engine(pattern):
    reason = f"regex not on device: {UNSUPPORTED[pattern]}"
    q = _port([PE.RLike(PE.col("d"), pattern).alias("r")])
    nodes = _cpu_nodes(q.explain())
    assert len(nodes) == 1 and reason in nodes[0], nodes
    jtext = jax_from_arrow(table()).select(
        JE.RLike(JE.col("d"), pattern).alias("r")).explain()
    assert reason in jtext
    prog = re.compile(pattern)
    assert q.collect() == [{"r": None if v is None
                            else prog.search(v) is not None}
                           for v in table().column("d").to_pylist()]


def test_the_state_cap_is_a_conf_key():
    key = "spark.rapids.gpu.sql.regex.maxDfaStates"
    q = _port([PE.RLike(PE.col("d"), "[a-z]+@[a-z]+\\.com").alias("r")],
              {key: "8"})
    assert "regex not on device: DFA exceeds 8 states" in q.explain()
    assert q.collect() == _port([PE.RLike(
        PE.col("d"), "[a-z]+@[a-z]+\\.com").alias("r")]).collect()
    with pytest.raises(RX.RegexUnsupported):
        RX.compile_rlike("(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)")
    assert RX.compile_rlike("(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)",
                            1024).delta.shape[0] > 96


def _java_sub(pattern, repl, v):
    return re.sub(pattern, repl.replace("$1", "\\g<1>")
                  .replace("$2", "\\g<2>"), v)


@pytest.mark.parametrize("s", ["d", "p"])
def test_regexp_extract_and_replace_on_the_cpu_engine(s):
    cases = [("([a-z]+)@([a-z]+)", 2), ("(\\d+)", 1), ("(a)(x)?", 2),
             ("b+", 0)]
    reps = [("([a-z]+)@", "<$1>"), ("b", "B"), ("(\\w)(\\w)", "$2$1"),
            ("x*", "-")]
    exprs = ([PE.RegexpExtract(PE.col(s), p, g).alias(f"e{i}")
              for i, (p, g) in enumerate(cases)]
             + [PE.RegexpReplace(PE.col(s), p, r).alias(f"s{i}")
                for i, (p, r) in enumerate(reps)])
    q = _port(exprs)
    nodes = _cpu_nodes(q.explain())
    assert "expression RegexpExtract not on device" in nodes[0]
    assert "expression RegexpReplace not on device" in nodes[0]
    got = q.collect()
    vals = table().column(s).to_pylist()
    for i, (p, g) in enumerate(cases):
        exp = []
        for v in vals:
            m = None if v is None else re.search(p, v)
            exp.append(None if v is None else (m.group(g) or "") if m
                       else "")
        assert [r[f"e{i}"] for r in got] == exp, p
    for i, (p, r) in enumerate(reps):
        assert [g[f"s{i}"] for g in got] == [
            None if v is None else _java_sub(p, r, v) for v in vals], p
    with pytest.raises(NotImplementedError, match="RegexpExtract"):
        jax_from_arrow(table(), JConf({"spark.rapids.tpu.sql.enabled":
                                       "false"})).select(
            JE.RegexpExtract(JE.col(s), "(a)", 1).alias("e")).collect()


def _instances(M, T):
    """One instance of each of the 44 string and regex classes (two for
    Overlay and RLike: with and without a FOR length, a supported and a
    rejected pattern) over columns s (string) and n (bigint)."""
    s, n = M.col("s"), M.col("n")
    return {
        "Bin": M.Bin(n), "OctetLength": M.OctetLength(s),
        "BitLength": M.BitLength(s), "StringLeft": M.StringLeft(s, 2),
        "StringRight": M.StringRight(s, 2), "Length": M.Length(s),
        "Upper": M.Upper(s), "Lower": M.Lower(s),
        "StartsWith": M.StartsWith(s, M.lit("a")),
        "EndsWith": M.EndsWith(s, M.lit("a")),
        "Contains": M.Contains(s, M.lit("a")),
        "Concat": M.Concat(s, s), "ConcatWs": M.ConcatWs(s, s, sep=","),
        "StringTrim": M.StringTrim(s), "StringTrimLeft": M.StringTrimLeft(s),
        "StringTrimRight": M.StringTrimRight(s),
        "StringReplace": M.StringReplace(s, "a", "b"),
        "StringInstr": M.StringInstr(s, "a"),
        "StringLocate": M.StringLocate(s, "a", 1),
        "StringLPad": M.StringLPad(s, 5, "x"),
        "StringRPad": M.StringRPad(s, 5, "x"),
        "StringRepeat": M.StringRepeat(s, 2),
        "StringReverse": M.StringReverse(s),
        "StringTranslate": M.StringTranslate(s, "a", "b"),
        "InitCap": M.InitCap(s), "SubstringIndex": M.SubstringIndex(s, ",", 1),
        "Md5": M.Md5(s), "Sha1": M.Sha1(s), "Sha2": M.Sha2(s, 256),
        "Crc32": M.Crc32(s), "Base64": M.Base64(s), "UnBase64": M.UnBase64(s),
        "Hex": M.Hex(s), "Unhex": M.Unhex(s),
        "FormatNumber": M.FormatNumber(M.Cast(n, T.DOUBLE), 2),
        "StringSpace": M.StringSpace(n),
        "Levenshtein": M.Levenshtein(s, s),
        "FindInSet": M.FindInSet(s, "a,b"),
        "Overlay": M.Overlay(s, s, 2, 1), "Overlay_default": M.Overlay(s, s, 2),
        "Ascii": M.Ascii(s), "Chr": M.Chr(n),
        "RLike": M.RLike(s, "a+b"), "RLike_rejected": M.RLike(s, "(a)\\1"),
        "RegexpExtract": M.RegexpExtract(s, "(a)", 1),
        "RegexpReplace": M.RegexpReplace(s, "a", "b"),
    }


def test_placement_matches_the_reference():
    """Each class placed where the reference's planner places it, with its
    reason; the port's class set is the 44 of the reference."""
    names = {c.__name__ for c in PE.STRING_FUNCTIONS + PE.REGEX_FUNCTIONS}
    assert len(names) == 44 and all(hasattr(JE, n) for n in names)
    jschema = JT.Schema([JT.Field("s", JT.STRING), JT.Field("n", JT.LONG)])
    pschema = PT.Schema([PT.Field("s", PT.STRING), PT.Field("n", PT.LONG)])
    jexprs, pexprs = _instances(JE, JT), _instances(PE, PT)
    assert {k.split("_")[0] for k in pexprs} == names
    off = []
    for name in pexprs:
        want = JO.check_expr(jexprs[name], jschema)
        got = PO.check_expr(pexprs[name], pschema, RapidsConf())
        assert got == want, name
        if got:
            off.append(name)
            q = port_from_arrow(pa.table({"s": ["a"], "n": [1]}),
                                device="cpu").select(pexprs[name].alias("x"))
            assert want[0] in _cpu_nodes(q.explain())[0], name
    assert sorted(off) == sorted(
        ["Bin", "Md5", "Sha1", "Sha2", "Crc32", "FormatNumber",
         "StringSpace", "Levenshtein", "Overlay_default", "RLike_rejected",
         "RegexpExtract", "RegexpReplace"])
