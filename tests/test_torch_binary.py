"""BINARY through the port's operators, held against the JAX package on
the CPU: BINARY group, join and sort keys and the aggregates over BINARY
(count, min/max, first/last as over strings) on the port's device path
against the reference's device path and on its CPU engine against the
reference's CPU engine; casts between BINARY and STRING both ways; the
shuffle's wire bytes equal to the reference's kudo bytes, and a 4-split
exchange on a BINARY key equal to one partition; a nested column refused
by the wire format, where the reference's fails.

Tolerance: exact.
"""

import hashlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.sort import SortOrder as PSortOrder
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.shuffle import serializer as PS

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

KEYS = [hashlib.blake2b(bytes([i]), digest_size=1 + i % 5).digest()
        for i in range(24)] + [b""]


def tables(seed: int = 3, n: int = 300):
    """``t``: a BINARY key with nulls (digests of 1-5 bytes, one empty),
    an integer and the key's hex as a string; ``u``: 20 of the keys."""
    rng = np.random.default_rng(seed)
    b = [None if rng.random() < .1 else KEYS[rng.integers(0, len(KEYS))]
         for _ in range(n)]
    t = pa.table({"b": pa.array(b, pa.binary()),
                  "v": pa.array(rng.integers(0, 100, n), pa.int64()),
                  "h": pa.array([None if x is None else x.hex() for x in b])})
    u = pa.table({"b2": pa.array(KEYS[:20], pa.binary()),
                  "w": pa.array(np.arange(20), pa.int64())})
    return t, u


def grouped(M, S, d, _u):
    c = M.col
    return d.group_by("b").agg(
        M.Count(c("v")).alias("n"), M.Sum(c("v")).alias("sv"),
        M.Count(c("b")).alias("nb"), M.Min(c("b")).alias("mn"),
        M.Max(c("b")).alias("mx"), M.First(c("b")).alias("f"),
        M.Last(c("b")).alias("l")).sort(S(c("b")))


def joined(M, S, d, u):
    return d.join(u, left_on="b", right_on="b2").select(
        M.col("b"), M.col("v"), M.col("w"))


def ordered(M, S, d, _u):
    return d.sort(S(M.col("b")), S(M.col("v")), limit=50)


def global_aggs(M, S, d, _u):
    c = M.col
    return d.group_by().agg(M.Min(c("b")).alias("mn"),
                            M.Max(c("b")).alias("mx"),
                            M.Count(c("b")).alias("n"))


QUERIES = {"group": grouped, "join": joined, "order": ordered,
           "global": global_aggs}


def _rows(df, key):
    rows = df.to_arrow().to_pylist()
    return rows if key == "order" else sorted(rows, key=repr)


def _cpu_nodes(df):
    return [ln for ln in df.explain().splitlines()
            if ln.lstrip().startswith("!")]


@pytest.mark.parametrize("device", [True, False], ids=["device", "cpu"])
def test_binary_keys_and_aggregates_match_the_reference(device):
    t, u = tables()
    pconf = None if device else RapidsConf({"spark.rapids.gpu.sql.enabled":
                                            "false"})
    jconf = JConf({"spark.rapids.tpu.sql.enabled": device})
    for key, q in QUERIES.items():
        pd_ = q(PE, PSortOrder, port_from_arrow(t, pconf, device="cpu"),
                port_from_arrow(u, pconf, device="cpu"))
        if device:
            assert _cpu_nodes(pd_) == [], key
        jd = jax_from_arrow(t, jconf)
        jd.shuffle_partitions = 1
        exp = _rows(q(JE, JSortOrder, jd, jax_from_arrow(u, jconf)), key)
        assert _rows(pd_, key) == exp, key


def casts(M, T, d):
    c = M.col
    return d.select(M.Cast(c("h"), T.BINARY).alias("hb"),
                    M.Cast(M.Cast(c("h"), T.BINARY), T.STRING).alias("back"),
                    M.EqualTo(c("b"), M.lit(KEYS[3], T.BINARY)).alias("eq"),
                    M.Cast(c("b"), T.STRING).alias("bs"))


def test_casts_between_binary_and_string_on_both_engines():
    t, _ = tables()
    hexes, keys = t.column("h").to_pylist(), t.column("b").to_pylist()
    for device in (True, False):
        conf = None if device else RapidsConf(
            {"spark.rapids.gpu.sql.enabled": "false"})
        df = casts(PE, PT, port_from_arrow(t, conf, device="cpu"))
        if device:
            assert _cpu_nodes(df) == []
        out = df.to_arrow()
        rows = out.drop(["bs"]).to_pylist()
        assert [r["hb"] for r in rows] == [
            None if h is None else h.encode() for h in hexes]
        assert [r["back"] for r in rows] == hexes
        assert [r["eq"] for r in rows] == [
            None if x is None else x == KEYS[3] for x in keys]
        # the keys are not UTF-8: the device keeps their bytes, the CPU
        # engine's host text has U+FFFD where they break
        bs = out.column("bs").cast(pa.binary()).to_pylist()
        assert bs == [None if x is None else x if device else
                      x.decode("utf-8", "replace").encode() for x in keys]


def test_the_reference_faults_on_binary_casts_and_literals():
    """The reference's CPU engine casts BINARY to STRING through int()
    and its device has no BINARY literal (ROADMAP.md queue 3)."""
    t, _ = tables()
    cpu = jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled": False}))
    with pytest.raises(ValueError):
        cpu.select(JE.Cast(JE.col("b"), JT.STRING).alias("s")).to_arrow()
    dev = jax_from_arrow(t, JConf({}))
    with pytest.raises(NotImplementedError, match="binary"):
        dev.select(JE.EqualTo(JE.col("b"), JE.lit(KEYS[3], JT.BINARY))
                   .alias("e")).to_arrow()


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_wire_bytes_equal_the_reference_kudo_bytes(codec):
    t, _ = tables()
    for part in (t, t.slice(7, 40), t.slice(0, 0)):
        got = PS.serialize_table(part, codec)
        assert got == JS.serialize_table(part, codec)
        back, _ = PS.deserialize_table(got, PT.Schema.from_arrow(t.schema))
        assert back.equals(part)


def test_four_split_exchange_on_a_binary_key_equals_one_partition():
    t, u = tables()
    conf = RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})
    four = port_from_arrow(t, conf, device="cpu", batch_rows=80,
                           partitions=4)
    four.shuffle_partitions = 4
    q = grouped(PE, PSortOrder, four, None)
    plan = q.physical_plan()
    assert "HashPartitioner(4)" in plan.explain()
    one = grouped(PE, PSortOrder, port_from_arrow(t, device="cpu"), None)
    assert q.to_arrow().to_pylist() == one.to_arrow().to_pylist()


def test_a_nested_column_is_refused_by_the_wire_format():
    t = pa.table({"a": pa.array([[1, 2], None], pa.list_(pa.int32())),
                  "s": pa.array([{"x": 1}, None], pa.struct([("x",
                                                              pa.int32())]))})
    for name in ("a", "s"):
        with pytest.raises(NotImplementedError, match="nested type"):
            PS.serialize_table(t.select([name]))
        with pytest.raises(Exception):  # the reference's: Arrow or KeyError
            JS.serialize_table(t.select([name]))
