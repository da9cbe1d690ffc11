"""The port's Substring, LIKE, projected string literals and equality of two
string columns (spark_rapids_tpu_torch.exprs.eval / exprs.regex on the
device path with CPU tensors, and plan.cpu on the CPU engine), held against
the JAX package's planner on the same seeded tables (one partition):

- Substring at pos 1, 0, -2 and past the end, with length 0, past the end
  and huge (10**9), over a dictionary column, a plain column, empty
  strings and nulls;
- grouping, joining and sorting on ``Substring(d, 2, 3)`` and
  ``Substring(d, -2, 2)`` over a dictionary column whose entries collide
  after the cut (the device re-encodes the cut entries: one code per
  distinct value, in byte order);
- LIKE with ``%``, ``_``, escapes, an empty pattern and a pattern equal to
  a whole value, over dictionary and plain columns;
- equality of two string columns across two dictionaries, a dictionary
  against plain strings, two plain columns and two Substrings.

Results must equal the JAX package's exactly (strings, booleans, counts
and nulls), rows in order where the query orders them.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import regex as PRX
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU_ONLY = {"spark.rapids.gpu.sql.enabled": "false"}
ENGINES = ["device", "cpu_engine"]
# entries that collide after a cut: "abcxx"/"zbcyy"/"qbcxx" share
# substring(2, 3) = "bcx"/"bcy"/"bcx", "abcxx"/"abdxx"/"qbcxx" share the
# last two bytes "xx"
WORDS = ["abcxx", "zbcyy", "abdxx", "qbcxx", "xxbcq", "", "a", "ab",
         "a%b", "x_y", "abcxx_", "bcxx"]


def _table(n=400, seed=7):
    rng = np.random.default_rng(seed)
    words = np.array(WORDS, dtype=object)

    def nulls():
        return rng.random(n) < 0.1
    d = words[rng.integers(0, len(words), n)].tolist()
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "d": pa.array(d, pa.string(), mask=nulls()),
        # the same words in another order of first appearance: another
        # dictionary
        "d2": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                       pa.string(), mask=nulls()),
        # many distinct values: stays a plain string column
        "p": pa.array([w + str(int(x)) if rng.random() < 0.7 else w
                       for w, x in zip(d, rng.integers(0, 10**6, n))],
                      pa.string(), mask=nulls()),
        "p2": pa.array([w + str(int(x)) for w, x in
                        zip(words[rng.integers(0, len(words), n)],
                            rng.integers(0, 3, n))], pa.string()),
    })


def _jax(t):
    df = jax_from_arrow(t)
    df.shuffle_partitions = 1
    return df


def _port(t, engine, batch_rows=128):
    conf = PC.RapidsConf(CPU_ONLY if engine == "cpu_engine" else {})
    return port_from_arrow(t, conf, batch_rows=batch_rows, device="cpu")


def _on_device(df):
    assert "!" not in df.explain(), df.explain()
    return df


def test_the_table_has_dictionary_and_plain_columns():
    enc = PB.dictionary_encode_table(_table())
    b = PB.batch_from_arrow(enc, "cpu")
    names = enc.column_names
    assert b.columns[names.index("d")].is_dict
    assert b.columns[names.index("d2")].is_dict
    assert (b.columns[names.index("d")].dictionary
            is not b.columns[names.index("d2")].dictionary)
    assert not b.columns[names.index("p")].is_dict


SUBSTRINGS = [(1, 3), (0, 3), (-2, 2), (2, 3), (10, 2), (1, 0), (3, 100),
              (2, 10**9), (-10, 3), (-1, 5), (4, -1)]


def _substring_query(M, df):
    out = [M.col("i")]
    for c in ("d", "p"):
        for pos, ln in SUBSTRINGS:
            out.append(M.Alias(M.Substring(M.col(c), pos, ln),
                               f"{c}_{pos}_{ln}"))
    return df.select(*out)


@pytest.mark.parametrize("engine", ENGINES)
def test_substring_matches_jax(engine):
    t = _table()
    exp = _substring_query(JE, _jax(t)).collect()
    df = _substring_query(PE, _port(t, engine))
    if engine == "device":
        _on_device(df)
    got = df.collect()
    assert got == exp
    # the edges spelled out
    row = next(r for r, w in zip(got, t.column("d").to_pylist())
               if w == "abcxx")
    assert (row["d_1_3"], row["d_0_3"], row["d_-2_2"], row["d_10_2"],
            row["d_1_0"], row["d_3_100"], row["d_2_1000000000"],
            row["d_-10_3"]) == ("abc", "abc", "xx", "", "", "cxx", "bcxx",
                                "")
    assert any(r["d_1_3"] is None for r in got)
    assert any(r["d_1_3"] == "" for r in got)


def test_substring_of_a_dictionary_is_re_encoded():
    """The cut entries of a dictionary column form a new dictionary: one
    entry per distinct value, sorted bytewise, each row's code pointing at
    its value."""
    from spark_rapids_tpu_torch.exprs import eval as PEV

    enc = PB.dictionary_encode_table(_table())
    b = PB.batch_from_arrow(enc, "cpu")
    schema = PT.Schema.from_arrow(enc.schema)
    for pos, ln in ((2, 3), (-2, 2), (1, 1)):
        e = PE.resolve(PE.Substring(PE.col("d"), pos, ln), schema)
        c = PEV.eval_expr(e, PEV.EvalContext(b))
        assert c.is_dict
        entries = PB.batch_to_arrow(
            PB.ColumnarBatch([c.dictionary], c.dictionary.num_rows),
            PT.Schema([PT.Field("e", PT.STRING)])).column(0)
        vals = entries.to_pylist()
        assert vals == sorted(set(vals), key=lambda v: v.encode())
        src = enc.column("d").to_pylist()
        for code, ok, w in zip(c.data.tolist(), c.validity.tolist(), src):
            if ok:
                start = pos - 1 if pos > 0 else max(len(w) + pos, 0)
                end = max((pos - 1 if pos > 0 else len(w) + pos) + ln, 0)
                assert vals[code] == w[start:end]
    # the dictionary's entries collide after the cut: fewer entries
    d = b.columns[enc.column_names.index("d")].dictionary
    cut = PEV.substring_bytes(d, 2, 3)
    uniq, codes = PK.dictionary_unique(cut)
    assert uniq.num_rows < d.num_rows
    assert codes.numel() == d.num_rows


def _grouped(M, df, pos, ln):
    return (df.with_column("sub", M.Substring(M.col("d"), pos, ln))
            .group_by("sub").agg(M.Alias(M.Count(), "n"),
                                 M.Alias(M.Sum(M.col("i")), "si")))


def _joined(M, left, right, pos, ln):
    lk = left.with_column("lsub", M.Substring(M.col("d"), pos, ln)).select(
        M.col("i"), M.col("lsub"))
    rk = right.select(M.Alias(M.Substring(M.col("d2"), pos, ln), "rsub"),
                      M.Alias(M.col("i"), "ri"))
    return lk.join(rk, left_on="lsub", right_on="rsub").agg(
        M.Alias(M.Count(), "pairs"), M.Alias(M.Sum(M.col("ri")), "sri"))


def _sorted(M, df, pos, ln):
    Ord = JOrd if M is JE else POrd
    s = df.select(M.Alias(M.Substring(M.col("d"), pos, ln), "sub"),
                  M.col("i"))
    return s.sort(Ord(M.col("sub"), ascending=False), Ord(M.col("i")),
                  limit=60)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cut", [(2, 3), (-2, 2)])
def test_group_join_sort_on_a_cut_dictionary_match_jax(cut, engine):
    t = _table()
    pos, ln = cut
    for build in (_grouped, _sorted):
        exp = build(JE, _jax(t), pos, ln).collect()
        df = build(PE, _port(t, engine), pos, ln)
        if engine == "device":
            _on_device(df)
        got = df.collect()
        if build is _sorted:
            assert got == exp
        else:
            assert rows_match(got, exp) and len(got) == len(exp)
            # one group per distinct cut value (collisions merged)
            subs = [r["sub"] for r in got]
            assert len(subs) == len(set(subs))
    exp = _joined(JE, _jax(t), _jax(t), pos, ln).collect()
    df = _joined(PE, _port(t, engine), _port(t, engine, 96), pos, ln)
    if engine == "device":
        _on_device(df)
    assert df.collect() == exp and exp[0]["pairs"] > 0


LIKES = ["ab%", "%b%", "_b%", "a_c%", "%", "", "abcxx", "a\\%b", "%\\_%",
         "x_y", "%xx", "a%x_", "__", "%c%x%"]


def _like_query(M, df):
    out = [M.col("i")]
    for c in ("d", "p"):
        for k, pat in enumerate(LIKES):
            out.append(M.Alias(M.Like(M.col(c), pat), f"{c}_like{k}"))
    return df.select(*out)


@pytest.mark.parametrize("engine", ENGINES)
def test_like_matches_jax(engine):
    t = _table()
    exp = _like_query(JE, _jax(t)).collect()
    df = _like_query(PE, _port(t, engine))
    if engine == "device":
        _on_device(df)
    got = df.collect()
    assert got == exp
    words = t.column("d").to_pylist()
    i = LIKES.index
    for r, w in zip(got, words):
        if w is None:
            assert r[f"d_like{i('%')}"] is None
            continue
        assert r[f"d_like{i('%')}"] is True
        assert r[f"d_like{i('')}"] == (w == "")
        assert r[f"d_like{i('abcxx')}"] == (w == "abcxx")
        assert r[f"d_like{i('a' + chr(92) + '%b')}"] == (w == "a%b")
        assert r[f"d_like{i('%' + chr(92) + '_%')}"] == ("_" in w)


def test_like_dfa_and_its_errors():
    dfa = PRX.like_to_dfa("a%b_")
    col = PB.batch_from_arrow(pa.table({"s": pa.array(
        ["ab", "abc", "axxbz", "", "b", "a\nbz"])}), "cpu").columns[0]
    assert PRX.match_strings(dfa, col).tolist() == [False, True, True,
                                                    False, False, True]
    with pytest.raises(ValueError, match="escape"):
        PRX.like_to_dfa("abc\\")


def _equality_query(M, df):
    eq = M.EqualTo
    return df.select(
        M.col("i"),
        M.Alias(eq(M.col("d"), M.col("d2")), "dict_dict"),
        M.Alias(eq(M.col("d"), M.col("p")), "dict_plain"),
        M.Alias(eq(M.col("p2"), M.col("p")), "plain_plain"),
        M.Alias(eq(M.col("d"), M.col("d")), "same_dict"),
        M.Alias(M.Not(eq(M.Substring(M.col("d"), 1, 2),
                         M.Substring(M.col("p"), 1, 2))), "cut_neq"),
        M.Alias(eq(M.col("d"), M.lit("abcxx")), "dict_lit"),
        M.Alias(M.lit("store channel"), "channel"))


@pytest.mark.parametrize("engine", ENGINES)
def test_string_column_equality_matches_jax(engine):
    t = _table()
    exp = _equality_query(JE, _jax(t)).collect()
    df = _equality_query(PE, _port(t, engine))
    if engine == "device":
        _on_device(df)
    got = df.collect()
    assert got == exp
    assert any(r["dict_dict"] for r in got) and any(
        r["dict_dict"] is False for r in got)
    assert any(r["dict_plain"] for r in got)
    assert all(r["same_dict"] in (True, None) for r in got)
    assert all(r["channel"] == "store channel" for r in got)


@pytest.mark.parametrize("engine", ENGINES)
def test_string_literal_projection_and_filter_match_jax(engine):
    """A projected literal is a one-entry dictionary column on the device:
    it groups, sorts and compares with a column of the table."""
    t = _table()

    def q(M, df):
        lit = df.select(M.Alias(M.lit("abcxx"), "tag"), M.col("d"),
                        M.col("i"))
        return (lit.filter(M.EqualTo(M.col("tag"), M.col("d")))
                .group_by("tag").agg(M.Alias(M.Count(), "n")).sort("tag"))
    exp = q(JE, _jax(t)).collect()
    df = q(PE, _port(t, engine))
    if engine == "device":
        _on_device(df)
    got = df.collect()
    assert got == exp and got[0]["n"] > 0
