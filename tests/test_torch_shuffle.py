"""The port's shuffle (spark_rapids_tpu_torch.shuffle) against the JAX
package's on the same inputs, on the CPU:

- the wire format: serialized blocks byte-equal to the reference's for
  every column type of the port (boolean, int, bigint, double, date,
  DECIMAL64, DECIMAL128, string; with and without nulls) under every
  codec, and the round trip and the host merge;
- the integrity trailer: sealed bytes equal, a flipped byte detected;
- partition ids: Hash (int, bigint, date, double with NaN and -0.0,
  DECIMAL64, dictionary and plain strings, nulls; 1, 4 and 7 partitions),
  RoundRobin, Single and Range (bounds from one sample) bit-equal;
- the reference's shuffled aggregation (files and CACHE_ONLY) and
  range-partitioned global sort, mirrored row for row;
- the manager: map outputs read back in map order whatever the writer
  threads, a corrupt block raising, cleanup removing the files.
"""

import decimal
import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.shuffle import integrity as JI
from spark_rapids_tpu.shuffle import partition as JP
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exec.sort import SortExec, SortOrder
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.shuffle import integrity as PI
from spark_rapids_tpu_torch.shuffle import partition as PP
from spark_rapids_tpu_torch.shuffle import serializer as PS
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
CODECS = ["none", "zlib", "lz4", "zstd"]


def _table(n: int, seed: int, nulls: bool) -> pa.Table:
    """One column of each port type, ``nulls`` about 15% null."""
    rng = np.random.default_rng(seed)

    def mask():
        return (rng.random(n) < 0.15) if nulls else None

    words = ["", "a", "bb", "hello", "naïve", "x" * 40]
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=mask()),
        "l": pa.array(rng.integers(-2**62, 2**62, n), mask=mask()),
        "f": pa.array(rng.normal(0, 1e6, n), mask=mask()),
        "d": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                      mask=mask()).cast(pa.date32()),
        "m": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-10**15, 10**15, n)],
                      pa.decimal128(17, 2), mask=mask()),
        "w": pa.array([D(int(v) * 10**12 + 7).scaleb(-2) for v in
                       rng.integers(-10**12, 10**12, n)],
                      pa.decimal128(27, 2), mask=mask()),
        "s": pa.array([words[int(k)] + str(int(k) * 3) for k in
                       rng.integers(0, len(words), n)], mask=mask()),
    })


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_serialized_blocks_equal_the_reference(codec, nulls):
    t = _table(700, 3, nulls)
    for part in (t, t.slice(123, 300), t.slice(0, 0)):
        assert PS.serialize_table(part, codec) == JS.serialize_table(
            part, codec)


@pytest.mark.parametrize("codec", CODECS)
def test_round_trip_and_merge(codec):
    t = _table(500, 4, True)
    schema = PT.Schema.from_arrow(t.schema)
    blob = PS.serialize_table(t.slice(10, 200), codec)
    back, end = PS.deserialize_table(blob, schema)
    assert end == len(blob) and back.equals(t.slice(10, 200))
    # the reference reads the port's bytes and the port the reference's
    jback, _ = JS.deserialize_table(blob, JT.Schema.from_arrow(t.schema))
    assert jback.equals(back)
    # one block of two frames and a second block merge in order
    blocks = [PS.serialize_table(t.slice(0, 10), codec)
              + PS.serialize_table(t.slice(10, 300), codec),
              PS.serialize_table(t.slice(310), codec)]
    merged = PS.merge_tables(blocks, schema)
    assert merged.to_pylist() == (t.slice(0, 310).to_pylist()
                                  + t.slice(310).to_pylist())
    assert PS.merge_tables([], schema) is None


def test_integrity_seal_matches_and_detects_a_flipped_byte():
    blob = PS.serialize_table(_table(50, 5, True), "none")
    sealed = PI.seal(blob)
    assert sealed == JI.seal(blob)
    assert PI.unseal(sealed) == blob
    for pos in (0, len(blob) // 2, len(sealed) - 1):
        bad = bytearray(sealed)
        bad[pos] ^= 0x10
        with pytest.raises(PI.BlockCorruption):
            PI.unseal(bytes(bad))
        with pytest.raises(JI.BlockCorruption):
            JI.unseal(bytes(bad))
    with pytest.raises(PI.BlockCorruption):
        PI.unseal(b"abc")


def _key_table(n: int = 600, seed: int = 11) -> pa.Table:
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.1
    dbl = rng.normal(0, 100, n)
    dbl[rng.random(n) < 0.1] = np.nan
    dbl[rng.random(n) < 0.1] = -0.0
    dbl[rng.random(n) < 0.1] = 0.0
    words = [f"w{i}" for i in range(20)]
    return pa.table({
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32), mask=mask),
        "l": pa.array(rng.integers(-2**62, 2**62, n)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      mask=mask).cast(pa.date32()),
        "f": pa.array(dbl, mask=mask),
        "m": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-10**9, 10**9, n)],
                      pa.decimal128(12, 2), mask=mask),
        "s": pa.array([words[int(k)] for k in rng.integers(0, 20, n)],
                      mask=mask),
    })


def _ids(jpart, ppart, table, dict_encode=False):
    """(reference ids, port ids) of one partitioner pair over a table."""
    t = JB.dictionary_encode_table(table) if dict_encode else table
    jb = JB.batch_from_arrow(t)
    exp = np.asarray(jpart.partition_ids(jb))[: table.num_rows]
    t = PB.dictionary_encode_table(table) if dict_encode else table
    got = ppart.partition_ids(PB.batch_from_arrow(t, "cpu")).numpy()
    return exp.astype(np.int64), got


@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("cols", [[0], [1], [2], [3], [4], [5], [0, 5],
                                  [3, 1, 2]])
def test_hash_partition_ids_equal_the_reference(cols, n):
    t = _key_table()
    exp, got = _ids(JP.HashPartitioner(cols, n),
                    PP.HashPartitioner(cols, n), t)
    assert np.array_equal(exp, got)
    assert got.min() >= 0 and got.max() < n
    if 5 in cols:
        # a dictionary key lands where its plain value does
        exp_d, got_d = _ids(JP.HashPartitioner(cols, n),
                            PP.HashPartitioner(cols, n), t, True)
        assert PB.batch_from_arrow(PB.dictionary_encode_table(t),
                                   "cpu").columns[5].is_dict
        assert np.array_equal(got_d, got) and np.array_equal(exp_d, got)


@pytest.mark.parametrize("n,start", [(1, 0), (4, 0), (7, 3)])
def test_round_robin_and_single_ids_equal_the_reference(n, start):
    t = _key_table(333)
    exp, got = _ids(JP.RoundRobinPartitioner(n, start),
                    PP.RoundRobinPartitioner(n, start), t)
    assert np.array_equal(exp, got)
    exp, got = _ids(JP.SinglePartitioner(), PP.SinglePartitioner(), t)
    assert np.array_equal(exp, got) and not got.any()


@pytest.mark.parametrize("col", [0, 1, 2])
@pytest.mark.parametrize("ascending,nulls_first",
                         [(True, None), (False, None), (True, False),
                          (False, True)])
def test_range_partition_ids_equal_the_reference(col, ascending,
                                                 nulls_first):
    t = _key_table()
    sample = np.random.default_rng(2).integers(-60, 60, 200).astype(
        np.float64) * (10**15 if col == 1 else 1) + (9000 if col == 2 else 0)
    jp = JP.RangePartitioner.from_sample(sample, 5, col, ascending,
                                         nulls_first)
    pp = PP.RangePartitioner.from_sample(sample, 5, col, ascending,
                                         nulls_first)
    assert np.array_equal(np.asarray(jp.bounds, np.float64), pp.bounds)
    exp, got = _ids(jp, pp, t)
    assert np.array_equal(exp, got)
    assert len(set(got.tolist())) > 1


def test_range_partitioner_orders_doubles_nan_last():
    t = _key_table()
    pp = PP.RangePartitioner.from_sample(np.linspace(-150, 150, 50), 4, 3)
    b = PB.batch_from_arrow(t, "cpu")
    ids = pp.partition_ids(b).numpy()
    v = np.asarray(t.column("f").to_numpy(zero_copy_only=False))
    valid = ~np.asarray(t.column("f").is_null())
    assert (ids[valid & np.isnan(v)] == 3).all()
    assert (ids[~valid] == 0).all()
    ok = valid & ~np.isnan(v)
    order = np.argsort(v[ok], kind="stable")
    assert (np.diff(ids[ok][order]) >= 0).all()  # monotone in the key
    # -0.0 and 0.0 land together
    zero = ok & (v == 0)
    assert len(set(ids[zero].tolist())) == 1


def _source(t: pa.Table, cuts):
    """A two-or-more-partition device source over slices of ``t``."""
    schema = PT.Schema.from_arrow(t.schema)
    parts = [[PB.batch_from_arrow(t.slice(a, b - a), "cpu")]
             for a, b in zip(cuts[:-1], cuts[1:])]
    return BatchSourceExec(parts, schema)


def _collect(node):
    out = []
    for p in range(node.num_partitions()):
        for b in node.execute(p):
            out.extend(PB.batch_to_arrow(b, node.output_schema).to_pylist())
    return out


@pytest.mark.parametrize("cache_only", [False, True])
def test_shuffled_aggregation(tmp_path, cache_only):
    """The reference's tests/test_shuffle.py::test_shuffled_aggregation:
    partial -> hash shuffle -> final equals the single-node result."""
    rng = np.random.default_rng(8)
    n = 5000
    keys = rng.integers(0, 97, n)
    vals = rng.integers(-1000, 1000, n)
    t = pa.table({"k": pa.array(keys, pa.int64()),
                  "v": pa.array(vals, pa.int64())})
    src = _source(t, [0, 2500, 5000])
    partial = HashAggregateExec([PE.col("k")],
                                [PE.Sum(PE.col("v")).alias("s"),
                                 PE.Count(PE.col("v")).alias("c")],
                                src, mode="partial")
    mgr = ShuffleManager(local_dir=str(tmp_path), cache_only=cache_only,
                         codec="zlib")
    shuffled = ShuffleExchangeExec(PP.HashPartitioner([0], 5), partial,
                                   manager=mgr)
    final = HashAggregateExec.final_from_partial(partial, shuffled)
    got = {}
    for r in _collect(final):
        assert r["k"] not in got
        got[r["k"]] = (r["s"], r["c"])
    expected = {}
    for k, v in zip(keys, vals):
        s, c = expected.get(int(k), (0, 0))
        expected[int(k)] = (s + int(v), c + 1)
    assert got == expected
    assert final.num_partitions() == 5
    assert bool(os.listdir(tmp_path)) != cache_only
    assert shuffled.metrics["shuffleBytesWritten"].value == mgr.bytes_written
    assert mgr.bytes_read == mgr.bytes_written > 0


def test_range_partitioned_global_sort(tmp_path):
    """The reference's tests/test_shuffle.py::
    test_range_partitioned_global_sort."""
    rng = np.random.default_rng(9)
    vals = rng.integers(-10000, 10000, 3000)
    t = pa.table({"x": pa.array(vals, pa.int64())})
    src = _source(t, [0, 1500, 3000])
    sample = rng.choice(vals, 200)
    part = PP.RangePartitioner.from_sample(sample, 4, key_col=0)
    mgr = ShuffleManager(local_dir=str(tmp_path))
    node = SortExec([SortOrder(PE.col("x"))],
                    ShuffleExchangeExec(part, src, manager=mgr))
    assert [r["x"] for r in _collect(node)] == sorted(vals.tolist())


def test_writer_threads_give_identical_rows_in_map_order(tmp_path):
    t = _table(4000, 12, True)
    cuts = [0, 700, 1500, 1500, 2600, 4000]  # one empty map partition
    rows = {}
    for threads in (1, 4):
        writers = set()

        class _Recording(ShuffleManager):
            def write_map_output(self, *args):
                writers.add(threading.get_ident())
                super().write_map_output(*args)

        mgr = _Recording(local_dir=str(tmp_path / str(threads)),
                         writer_threads=threads)
        ex = ShuffleExchangeExec(PP.HashPartitioner([1, 7], 3),
                                 _source(t, cuts), manager=mgr,
                                 target_batch_rows=500)
        rows[threads] = [[r for b in ex.execute(p) for r in
                          PB.batch_to_arrow(b, ex.output_schema).to_pylist()]
                         for p in range(3)]
        # the four non-empty maps were written on at most `threads` threads,
        # none of them the calling thread
        assert 1 <= len(writers) <= threads
        assert threading.get_ident() not in writers
        assert all(b.num_rows <= 500 for p in range(3)
                   for b in ex.execute(p))
        ex.cleanup()
        assert os.listdir(tmp_path / str(threads)) == []
    assert rows[1] == rows[4]
    # each reduce partition holds its rows in map order, each map's rows
    # in their source order
    ids = PP.HashPartitioner([1, 7], 3).partition_ids(
        PB.batch_from_arrow(t, "cpu")).numpy()
    src = t.to_pylist()
    for p in range(3):
        assert rows[1][p] == [r for r, i in zip(src, ids) if i == p]


def test_a_corrupt_block_raises_on_read(tmp_path):
    t = _table(300, 13, False)
    mgr = ShuffleManager(local_dir=str(tmp_path))
    ex = ShuffleExchangeExec(PP.HashPartitioner([1], 2),
                             _source(t, [0, 150, 300]), manager=mgr)
    list(ex.execute(0))
    path = sorted(tmp_path.iterdir())[0]
    data = bytearray(path.read_bytes())
    data[len(data) // 3] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(PI.BlockCorruption):
        for p in range(2):
            list(ex.execute(p))


def test_exchange_uploads_strings_with_a_dictionary_per_chunk(tmp_path):
    t = pa.table({"k": pa.array(np.arange(1200) % 7, pa.int64()),
                  "s": pa.array([f"v{i % 5}" for i in range(1200)])})
    mgr = ShuffleManager(local_dir=str(tmp_path), cache_only=True)
    ex = ShuffleExchangeExec(PP.HashPartitioner([1], 2),
                             _source(t, [0, 600, 1200]), manager=mgr,
                             target_batch_rows=256)
    batches = [b for p in range(2) for b in ex.execute(p)]
    assert len(batches) > 2
    assert all(b.columns[1].is_dict for b in batches)
    assert len({id(b.columns[1].dictionary) for b in batches}) == len(batches)
    assert sorted(r["s"] for b in batches for r in PB.batch_to_arrow(
        b, ex.output_schema).to_pylist()) == sorted(t.column("s").to_pylist())
