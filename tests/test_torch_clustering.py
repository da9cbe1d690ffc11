"""Clustering, runtime filters, Expand, the dataframe cache and the ML
handoff of the port against the JAX package on the same inputs (seeded
numpy data, small sizes, on the CPU).

- Z-order and Hilbert: the index and the permutation over ints, floats,
  strings and nulls equal the reference's where the rows fill its
  power-of-two bucket; at another row count the reference's padding rows
  take ranks among the nulls and its scale comes from the bucket, so the
  two differ, and a test holds both answers (ROADMAP queue 3).
- The bloom filter's bits and masks equal the reference's.
- Expand over a ROLLUP's 3 projections gives the reference's rows.
- The Parquet-encoded cache reads back its source's rows, twice, and a
  rename-equal plan is served the cached relation.
- The ML handoff: device batches and a feature matrix, nulls as NaN; a
  decimal gives its value (the reference: its unscaled integer).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.columnar.batch as JB
import spark_rapids_tpu.exec.bloom as JBL
import spark_rapids_tpu.exec.zorder as JZ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import bloom as PBL
from spark_rapids_tpu_torch.exec import zorder as PZ
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def _mixed(n: int, seed: int) -> pa.Table:
    """ints, floats (NaN among them), short strings and nulls in each."""
    rng = np.random.default_rng(seed)

    def nulls(vals):
        return [None if rng.random() < 0.1 else v for v in vals]

    floats = rng.normal(size=n).round(3)
    floats[rng.random(n) < 0.05] = np.nan
    return pa.table({
        "i": pa.array(nulls(rng.integers(-50, 50, n).tolist()), pa.int64()),
        "f": pa.array(nulls(floats.tolist()), pa.float64()),
        "s": pa.array(nulls([f"k{x}" for x in rng.integers(0, 40, n)]),
                      pa.string()),
        "j": pa.array(rng.permutation(n), pa.int32())})


def _jax_u64(a, n):
    return np.asarray(a)[:n].astype(np.uint64).view(np.int64)


def _port(t):
    return PB.batch_from_arrow(t, "cpu")


def _jax(t, bucket=16):
    return JB.batch_from_arrow(t, bucket)


# -- Z-order ---------------------------------------------------------------

@pytest.mark.parametrize("cols", [(0, 1), (2, 3), (0, 1, 2), (3,), (1,),
                                  (0, 1, 2, 3)])
def test_interleave_bits_equal_the_reference_at_a_full_bucket(cols):
    n = 1024
    t = _mixed(n, 1)
    got = PZ.interleave_bits(_port(t), cols).numpy()
    exp = _jax_u64(JZ.interleave_bits(_jax(t), cols), n)
    assert np.array_equal(got, exp)
    order = PZ.zorder_sort_indices(_port(t), cols).numpy()
    jorder = np.asarray(JZ.zorder_sort_indices(_jax(t), cols))[:n]
    assert np.array_equal(order, jorder)


@pytest.mark.parametrize("cols", [(0, 1), (2, 3), (1, 2)])
def test_hilbert_equals_the_reference_at_a_full_bucket(cols):
    n = 1024
    t = _mixed(n, 2)
    got = PZ.hilbert_index(_port(t), cols).numpy()
    exp = _jax_u64(JZ.hilbert_index(_jax(t), cols), n)
    assert np.array_equal(got, exp)
    order = PZ.zorder_sort_indices(_port(t), cols, "hilbert").numpy()
    jorder = np.asarray(JZ.zorder_sort_indices(_jax(t), cols,
                                               "hilbert"))[:n]
    assert np.array_equal(order, jorder)


def _ranks(keys_np, n_pad):
    """Stable ranks with nulls first and ``n_pad`` padding rows ranked
    between the live nulls and the values (the reference's layout)."""
    vals, valid = keys_np
    n = len(vals)
    null_idx = [i for i in range(n) if not valid[i]]
    live = sorted((i for i in range(n) if valid[i]),
                  key=lambda i: (vals[i], i))
    ranks = np.empty(n, np.int64)
    for r, i in enumerate(null_idx):
        ranks[i] = r
    for r, i in enumerate(live):
        ranks[i] = len(null_idx) + n_pad + r
    return ranks


def _z2(rx, ry, rows_for_shift):
    shift = 32 - max((rows_for_shift - 1).bit_length(), 1)
    x, y = rx << shift, ry << shift
    out = np.zeros(len(rx), np.uint64)
    for b in range(32):
        for ci, c in enumerate((x, y)):
            bit = ((c >> (31 - b)) & 1).astype(np.uint64)
            out |= bit << np.uint64(63 - (2 * b + ci))
    return out.view(np.int64)


def test_zorder_below_a_full_bucket_differs_from_the_reference():
    """Reference fault: 1,000 rows in a 1,024-row bucket. The reference
    ranks its 24 padding rows among the nulls and scales by the bucket;
    the port ranks its live rows and scales by their count. Both answers
    are held to their formulas, and they differ."""
    n = 1000
    rng = np.random.default_rng(3)
    x = [None if rng.random() < 0.1 else int(v)
         for v in rng.integers(0, 300, n)]
    y = [int(v) for v in rng.permutation(n)]
    t = pa.table({"x": pa.array(x, pa.int64()), "y": pa.array(y, pa.int64())})
    kx = ([0 if v is None else v for v in x], [v is not None for v in x])
    ky = (y, [True] * n)
    got = PZ.interleave_bits(_port(t), (0, 1)).numpy()
    exp = _jax_u64(JZ.interleave_bits(_jax(t), (0, 1)), n)
    assert np.array_equal(got, _z2(_ranks(kx, 0), _ranks(ky, 0), n))
    assert np.array_equal(exp, _z2(_ranks(kx, 24), _ranks(ky, 24), 1024))
    assert not np.array_equal(got, exp)


def test_zorder_clusters():
    """tests/test_integrations.py::test_zorder_clusters on the port."""
    rng = np.random.default_rng(1234)
    n = 256
    t = pa.table({"x": pa.array(rng.permutation(n), pa.int64()),
                  "y": pa.array(rng.permutation(n), pa.int64())})
    b = _port(t)
    z = PZ.interleave_bits(b, (0, 1)).numpy()
    h = PZ.hilbert_index(b, (0, 1)).numpy()
    assert len(set(z.tolist())) > n // 2
    assert len(set(h.tolist())) > n // 2
    order = PZ.zorder_sort_indices(b, (0, 1)).numpy()
    xs, ys = t.column("x").to_numpy()[order], t.column("y").to_numpy()[order]
    jumps = np.abs(np.diff(xs)) + np.abs(np.diff(ys))
    rand = np.random.default_rng(0).permutation(n)
    rj = (np.abs(np.diff(t.column("x").to_numpy()[rand]))
          + np.abs(np.diff(t.column("y").to_numpy()[rand])))
    assert jumps.mean() < rj.mean() * 0.6
    jorder = np.asarray(JZ.zorder_sort_indices(_jax(t), (0, 1)))[:n]
    assert np.array_equal(order, jorder)


@pytest.mark.parametrize("dtype", [pa.int64(), pa.float64()])
def test_zorder_single_column_sorts_by_value(dtype):
    """tests/test_integrations.py:201 and :247 on the port."""
    rng = np.random.default_rng(1234)
    vals = rng.permutation(64)
    t = pa.table({"x": pa.array(vals.astype(dtype.to_pandas_dtype()),
                                dtype)})
    order = PZ.zorder_sort_indices(_port(t), (0,)).numpy()
    assert vals[order].tolist() == sorted(vals.tolist())
    jorder = np.asarray(JZ.zorder_sort_indices(_jax(t), (0,)))[:64]
    assert np.array_equal(order, jorder)


# -- bloom filter ----------------------------------------------------------

def test_bloom_filter_bits_and_masks_equal_the_reference():
    """tests/test_integrations.py::test_bloom_filter on the port, the bits
    and masks equal to the reference's."""
    rng = np.random.default_rng(1234)
    build_keys = rng.choice(10**6, 2000, replace=False)
    bt = pa.table({"k": pa.array(build_keys, pa.int64())})
    m, k = PBL.optimal_params(2000, fpp=0.03)
    assert (m, k) == JBL.optimal_params(2000, fpp=0.03)
    bits = PBL.build_bloom_filter(_port(bt), (0,), m, k)
    jbits = np.asarray(JBL.build_bloom_filter(_jax(bt), (0,), m, k))
    assert np.array_equal(bits.numpy(), jbits)
    hit_t = pa.table({"k": pa.array(build_keys[:500], pa.int64())})
    build_set = set(build_keys.tolist())
    miss_keys = np.array([x for x in rng.choice(10**7, 3000)
                          if x not in build_set][:2000])
    miss_t = pa.table({"k": pa.array(miss_keys, pa.int64())})
    hit = PBL.might_contain(_port(hit_t), (0,), bits, m, k).numpy()
    assert hit.all()
    miss = PBL.might_contain(_port(miss_t), (0,), bits, m, k).numpy()
    assert miss.mean() < 0.1
    jmiss = np.asarray(JBL.might_contain(_jax(miss_t), (0,), jbits, m,
                                         k))[:len(miss_keys)]
    assert np.array_equal(miss, jmiss)


def test_bloom_filter_over_two_columns_with_strings_and_nulls():
    t = _mixed(3000, 4)
    bt = t.slice(0, 1000)
    m, k = PBL.optimal_params(1000, fpp=0.01)
    bits = PBL.build_bloom_filter(_port(bt), (2, 0), m, k)
    jbits = np.asarray(JBL.build_bloom_filter(_jax(bt), (2, 0), m, k))
    assert np.array_equal(bits.numpy(), jbits)
    got = PBL.might_contain(_port(t), (2, 0), bits, m, k).numpy()
    exp = np.asarray(JBL.might_contain(_jax(t), (2, 0), jbits, m, k))[:3000]
    assert np.array_equal(got, exp)
    assert got[:1000].all()


def test_default_bits_reads_the_active_conf():
    from spark_rapids_tpu_torch.config import conf as C

    assert PBL.default_bits() == 1 << 23
    C.set_active(RapidsConf({"spark.rapids.gpu.sql.join.bloomFilter.bits":
                             4096}))
    try:
        assert PBL.default_bits() == 4096
    finally:
        C.set_active(None)


# -- Expand ----------------------------------------------------------------

def _rollup(E, T, cat, cls, val):
    null_s = E.lit(None, T.STRING)
    return [[E.col(cat), E.col(cls), E.col(val), E.Alias(E.lit(0), "g")],
            [E.col(cat), E.Alias(null_s, cls), E.col(val),
             E.Alias(E.lit(1), "g")],
            [E.Alias(null_s, cat), E.Alias(null_s, cls), E.col(val),
             E.Alias(E.lit(3), "g")]]


def test_expand_rollup_rows_equal_the_reference():
    from spark_rapids_tpu.exec import BatchSourceExec as JSource
    from spark_rapids_tpu.exec.expand import ExpandExec as JExpand
    from spark_rapids_tpu_torch.exec.expand import ExpandExec

    rng = np.random.default_rng(5)
    n = 700
    t = pa.table({
        "cat": pa.array([None if rng.random() < 0.05 else f"c{x}"
                         for x in rng.integers(0, 4, n)]),
        "cls": pa.array([f"l{x}" for x in rng.integers(0, 9, n)]),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    enc = PB.dictionary_encode_table(t)
    cache = {}
    src = BatchSourceExec([[PB.batch_from_arrow(enc.slice(i, 256), "cpu",
                                                dict_cache=cache)
                            for i in range(0, n, 256)]],
                          PT.Schema.from_arrow(t.schema))
    node = ExpandExec(_rollup(PE, PT, "cat", "cls", "v"), src)
    got = pa.concat_tables(PB.batch_to_arrow(b, node.output_schema)
                           for b in node.execute_all())
    jsrc = JSource([[JB.batch_from_arrow(t.slice(i, 256), 16)
                     for i in range(0, n, 256)]],
                   JT.Schema.from_arrow(t.schema))
    jnode = JExpand(_rollup(JE, JT, "cat", "cls", "v"), jsrc)
    exp = pa.concat_tables(JB.batch_to_arrow(b, jnode.output_schema)
                           for b in jnode.execute_all())
    assert got.num_rows == 3 * n
    assert got.column_names == exp.column_names
    assert got.to_pylist() == exp.to_pylist()


# -- the dataframe cache ---------------------------------------------------

def test_pcbs_cache():
    """tests/test_integrations.py::test_pcbs_cache on the port."""
    from spark_rapids_tpu_torch.plan.cache import CachedRelation

    rng = np.random.default_rng(1234)
    t = pa.table({"k": pa.array(range(500), pa.int64()),
                  "v": pa.array(rng.integers(0, 1000, 500), pa.int64()),
                  "d": pa.array([None if i % 7 == 0 else i * 3
                                 for i in range(500)],
                                pa.decimal128(9, 2)),
                  "s": pa.array([f"r{i % 13}" for i in range(500)])})
    schema = PT.Schema.from_arrow(t.schema)
    src = BatchSourceExec([[PB.batch_from_arrow(t.slice(i, 128), "cpu")
                            for i in range(0, 500, 128)]], schema)
    cached = CachedRelation.cache(src, device="cpu")
    assert 0 < cached.cached_bytes() < t.nbytes
    for _ in range(2):  # re-readable
        rows = [r for b in cached.execute_all()
                for r in PB.batch_to_arrow(b, schema).to_pylist()]
        assert rows == t.to_pylist()
    assert cached.metrics["decodeTimeNs"].value > 0
    assert CachedRelation.cache(src, device="cpu") is cached


def test_cached_relation_fingerprint_memo():
    """tests/test_reuse.py::test_cached_relation_fingerprint_memo on the
    port: a rename-equal plan hits, a literal change misses."""
    from spark_rapids_tpu_torch.plan.cache import CachedRelation

    t = pa.table({"v": pa.array(range(100), pa.int64())})
    conf = RapidsConf({"spark.rapids.gpu.sql.exchange.reuse.enabled":
                       "true"})

    def plan(name, v=1):
        return from_arrow(t, conf, device="cpu").select(
            PE.Alias(PE.Add(PE.col("v"), PE.lit(v)), name)).physical_plan()

    r1 = CachedRelation.cache(plan("x"), device="cpu")
    r2 = CachedRelation.cache(plan("y"), device="cpu")
    r3 = CachedRelation.cache(plan("x", v=2), device="cpu")
    assert r2 is r1
    assert r3 is not r1
    got = [r["x"] for b in r3.execute_all()
           for r in PB.batch_to_arrow(b, r3.output_schema).to_pylist()]
    assert got == list(range(2, 102))


# -- the ML handoff --------------------------------------------------------

def test_device_batches_handoff():
    """tests/test_aux.py::test_device_batches_handoff on the port."""
    from spark_rapids_tpu_torch.plan.ml import device_batches

    t = pa.table({"a": pa.array(np.arange(100, dtype=np.float64)),
                  "b": pa.array(np.arange(100), pa.int64())})
    df = from_arrow(t, device="cpu").filter(PE.col("b") < PE.lit(50))
    batches = list(device_batches(df))
    assert batches and all(isinstance(b.columns[0].data, torch.Tensor)
                           for b in batches)
    assert sum(b.num_rows for b in batches) == 50


def test_feature_matrix_stack():
    """tests/test_aux.py::test_feature_matrix_stack on both packages."""
    from spark_rapids_tpu.plan import from_arrow as jfrom_arrow
    from spark_rapids_tpu.plan.ml import feature_matrix as jfeature_matrix
    from spark_rapids_tpu_torch.plan.ml import feature_matrix

    t = pa.table({
        "f1": pa.array([1.0, 2.0, None, 4.0], pa.float64()),
        "f2": pa.array([10.0, 20.0, 30.0, 40.0], pa.float64()),
        "n": pa.array([3, None, 5, 6], pa.int32()),
        "y": pa.array([0.0, 1.0, 0.0, 1.0], pa.float64()),
    })
    x, y = feature_matrix(from_arrow(t, device="cpu"), label_col="y")
    assert x.shape == (4, 3) and y.shape == (4,)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    jx, jy = jfeature_matrix(jfrom_arrow(t), label_col="y")
    assert np.array_equal(x.numpy(), np.asarray(jx), equal_nan=True)
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert torch.isnan(x[2, 0]) and x[3, 1] == 40.0 and torch.isnan(x[1, 2])


def test_feature_matrix_of_a_decimal_is_its_value():
    """Reference fault: the reference stacks a decimal's unscaled
    integer (12.34 as 1234.0); the port its value, as Arrow reads it."""
    from spark_rapids_tpu.plan import from_arrow as jfrom_arrow
    from spark_rapids_tpu.plan.ml import feature_matrix as jfeature_matrix
    from spark_rapids_tpu_torch.plan.ml import feature_matrix

    import decimal
    t = pa.table({"d": pa.array([decimal.Decimal("12.34"), None,
                                 decimal.Decimal("-0.07")],
                                pa.decimal128(7, 2))})
    x, _ = feature_matrix(from_arrow(t, device="cpu"))
    exp = np.array([[12.34], [np.nan], [-0.07]], np.float32)
    assert np.array_equal(x.numpy(), exp, equal_nan=True)
    jx, _ = jfeature_matrix(jfrom_arrow(t))
    assert np.array_equal(np.asarray(jx), np.array([[1234.0], [np.nan],
                                                   [-7.0]], np.float32),
                          equal_nan=True)
