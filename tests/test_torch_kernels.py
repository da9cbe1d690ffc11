"""The port's main-path kernels (spark_rapids_tpu_torch.exec.kernels) held
against the JAX package's on the same seeded inputs: hashes, the hash-table
build and probe bit for bit, sort/filter/group indices exactly, float sums
within rel 1e-6 (another summation order), and the segmented scan exactly
for integers and min/max, within ``segscan_add_tolerance`` for float add."""

import functools

import jax
import jax.numpy as jnp
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import kernels as JK
from spark_rapids_tpu_torch import interop
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec import kernels as PK


def _np(x):
    a = np.asarray(jax.device_get(x))
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _batches(table):
    """(JAX batch without padding, port CPU batch) of one arrow table."""
    table = JB.dictionary_encode_table(table)
    return (JB.batch_from_arrow(table, capacity=table.num_rows),
            PB.batch_from_arrow(table, "cpu"))


def _table(kind, n, rng):
    nulls = rng.random(n) < 0.15
    if kind == "long":
        a = pa.array(rng.integers(-10**12, 10**12, n), pa.int64())
    elif kind == "int":
        a = pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                     pa.int32())
    elif kind == "date":
        a = pa.array(rng.integers(-3000, 20000, n).astype(np.int32),
                     pa.int32()).cast(pa.date32())
    elif kind == "double":
        v = rng.normal(0, 1e3, n)
        v[rng.random(n) < 0.1] = np.nan
        v[rng.random(n) < 0.1] = -0.0
        v[rng.random(n) < 0.1] = 0.0
        v[rng.random(n) < 0.05] = 1e300
        a = pa.array(v, pa.float64())
    elif kind == "decimal":
        a = pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                      rng.integers(-10**9, 10**9, n)], pa.decimal128(11, 2))
    elif kind == "dict_string":
        words = np.array(["FRANCE", "ALGERIA", "", "ASIA", "BUILDING", "zz"])
        a = pa.array(words[rng.integers(0, len(words), n)], pa.string())
    elif kind == "plain_string":
        a = pa.array([f"key-{int(x)}-{'x' * int(x % 7)}"
                      for x in rng.integers(0, 10**6, n)], pa.string())
    else:
        raise KeyError(kind)
    return pa.array(a.to_pylist(), a.type, mask=nulls)


KEY_CASES = {
    "long": ["long"], "int": ["int"], "date": ["date"],
    "double": ["double"], "dict_string": ["dict_string"],
    "plain_string": ["plain_string"], "decimal": ["decimal"],
    "multi": ["long", "dict_string", "double", "date", "decimal"],
}


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_hash_keys_bit_equal(case, variant):
    rng = np.random.default_rng(11)
    kinds = KEY_CASES[case]
    n = 300
    t = pa.table({f"c{i}": _table(k, n, rng) for i, k in enumerate(kinds)})
    jb, pb = _batches(t)
    cols = list(range(len(kinds)))
    exp = _np(JK.hash_keys(jb, cols, variant=variant))
    got = PK.hash_keys(pb, cols, variant=variant).numpy()
    np.testing.assert_array_equal(got, exp)


def test_interop_batch_from_numpy_hashes_like_jax():
    """The JAX package's own batch state (padded, as numpy) fed through
    interop.batch_from_numpy hashes bit-equal in the port."""
    rng = np.random.default_rng(12)
    kinds = ["long", "dict_string", "plain_string", "double", "date"]
    t = JB.dictionary_encode_table(pa.table(
        {f"c{i}": _table(k, 200, rng) for i, k in enumerate(kinds)}))
    jb = JB.batch_from_arrow(t)
    n = t.num_rows
    cols = []
    for c in jb.columns:
        d = {"data": _np(c.data), "validity": _np(c.validity)[:n]}
        if c.is_dict:
            d["data"] = d["data"][:n]
            d["dict_data"] = _np(c.dictionary.data)
            d["dict_offsets"] = _np(c.dictionary.offsets)[: c.dict_size + 1]
        elif c.offsets is not None:
            d["offsets"] = _np(c.offsets)[: n + 1]
        else:
            d["data"] = d["data"][:n]
        cols.append(d)
    pb = interop.batch_from_numpy(cols, PT.Schema.from_arrow(t.schema),
                                  "cpu")
    assert pb.num_rows == n
    keys = list(range(len(kinds)))
    for variant in (0, 1):
        np.testing.assert_array_equal(
            PK.hash_keys(pb, keys, variant).numpy(),
            _np(JK.hash_keys(jb, keys, variant))[:n])


def _hash_inputs(kind, rng):
    if kind == "duplicate_heavy":
        n, distinct, cap = 400, 30, 1024
    elif kind == "near_full":
        n, distinct, cap = 60, 60, 64
    else:
        n, distinct, cap = 257, 200, 512
    ids = rng.integers(0, distinct, n)
    base1 = rng.integers(0, 2**63, distinct, dtype=np.uint64) * np.uint64(2)
    base2 = rng.integers(0, 2**63, distinct, dtype=np.uint64) * np.uint64(3)
    h1, h2 = base1[ids], base2[ids]
    valid = rng.random(n) > 0.1
    return h1, h2, valid, cap


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["duplicate_heavy", "near_full", "mixed"])
def test_build_hash_table_identical(kind, seed):
    rng = np.random.default_rng(5)
    h1, h2, valid, cap = _hash_inputs(kind, rng)
    jt, jover = JK.build_hash_table(jnp.asarray(h1), jnp.asarray(h2),
                                    jnp.asarray(valid), cap, seed,
                                    JK.HASHTBL_MAX_PROBES)
    pt, pover = PK.build_hash_table(
        torch.from_numpy(h1.view(np.int64)), torch.from_numpy(h2.view(np.int64)),
        torch.from_numpy(valid), cap, seed, PK.HASHTBL_MAX_PROBES)
    assert pover == bool(jax.device_get(jover))
    for field in PK.HashTable._fields:
        np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                      _np(getattr(jt, field)), err_msg=field)


def _jax_table(keys):
    jb = JB.batch_from_arrow(pa.table({"k": pa.array(keys, pa.int64())}), 16)
    tbl, cap, seed = JK.build_batch_hash_table(jb, (0,))
    fields = {f: _np(getattr(tbl, f)) for f in JK.HashTable._fields}
    return tbl, fields, cap, seed


@pytest.mark.parametrize("distinct", [25, 400])
def test_probe_on_jax_table_matches_jax_and_pallas(distinct):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, distinct, 500)
    tbl, fields, cap, seed = _jax_table(keys)
    probe = pa.table({"k": pa.array(rng.integers(-5, distinct + 50, 300),
                                    pa.int64())})
    jb, pb = _batches(probe)
    jh1, jh2 = JK.hash_keys(jb, [0]), JK.hash_keys(jb, [0], variant=1)
    js, jhit = JK.probe_hash_table(tbl, jh1, jh2, cap, seed,
                                   JK.HASHTBL_MAX_PROBES)
    ps_, phit_ = JK.probe_hash_table_pallas(tbl, jh1, jh2, cap, seed,
                                            JK.HASHTBL_MAX_PROBES,
                                            interpret=True)
    ptbl = interop.hash_table_from_numpy(fields, "cpu")
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    slot, hit = PK.probe_hash_table(ptbl, h1, h2, cap, seed,
                                    PK.HASHTBL_MAX_PROBES)
    for exp_s, exp_h in ((_np(js), _np(jhit)), (_np(ps_), _np(phit_))):
        np.testing.assert_array_equal(slot.numpy(), exp_s)
        np.testing.assert_array_equal(hit.numpy(), exp_h)
    # the port's own build agrees with the JAX build field for field
    bb = PB.batch_from_arrow(pa.table({"k": pa.array(keys, pa.int64())}),
                             "cpu")
    bh1, bh2 = PK.hash_keys(bb, [0]), PK.hash_keys(bb, [0], variant=1)
    own, over = PK.build_hash_table(bh1, bh2, torch.ones(500, dtype=torch.bool),
                                    cap, seed, PK.HASHTBL_MAX_PROBES)
    assert not over
    for f in PK.HashTable._fields:
        exp = fields[f][:500] if f in ("row_slot", "order",
                                       "sorted_slots") else fields[f]
        np.testing.assert_array_equal(getattr(own, f).numpy(), exp,
                                      err_msg=f)
    # candidate ranges over the same table and slots
    jlo, jcnt = JK.hashtbl_candidate_ranges(tbl, js, jhit)
    lo, cnt = PK.hashtbl_candidate_ranges(ptbl, slot, hit)
    np.testing.assert_array_equal(lo.numpy(), _np(jlo))
    np.testing.assert_array_equal(cnt.numpy(), _np(jcnt))


def test_build_rehashes_then_gives_up(monkeypatch):
    """An overflowing build retries with the next seed at twice the
    capacity; when every seed overflows the builder returns None and the
    join raises instead of dropping rows."""
    real = PK.build_hash_table
    calls = []

    def always_overflow(h1, h2, valid, capacity, seed, max_probes):
        calls.append((capacity, seed))
        return real(h1, h2, valid, capacity, seed, max_probes)[0], True

    bb = PB.batch_from_arrow(pa.table({"k": pa.array(np.arange(40),
                                                     pa.int64())}), "cpu")
    monkeypatch.setattr(PK, "build_hash_table", always_overflow)
    assert PK.build_batch_hash_table(bb, (0,)) is None
    assert calls == [(128, 0), (256, 1), (512, 2), (1024, 3)]
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exprs import expr as PE

    schema = PT.Schema([PT.Field("k", PT.LONG)])
    node = HashJoinExec([PE.col("k")], [PE.col("k")], "inner",
                        BatchSourceExec([[bb]], schema),
                        BatchSourceExec([[bb]], schema))
    with pytest.raises(RuntimeError, match="overflowed"):
        list(node.execute(0))


def test_kernel_wrapper_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 50, 200)
    _, fields, cap, seed = _jax_table(keys)
    ptbl = interop.hash_table_from_numpy(fields, "cpu")
    pb = PB.batch_from_arrow(pa.table({"k": pa.array(np.arange(80),
                                                     pa.int64())}), "cpu")
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    before = dict(PK.KERNEL_LAUNCHES)
    ks, kh = PK.probe_hash_table_kernel(ptbl, h1, h2, cap, seed, 16)
    ps, ph = PK.probe_hash_table(ptbl, h1, h2, cap, seed, 16)
    assert torch.equal(ks, ps) and torch.equal(kh, ph)
    assert int(kh.sum()) == len(set(keys.tolist()))
    assert PK.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("bad", ["h1_dtype", "used_dtype", "shape",
                                 "capacity", "noncontig"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(2)
    _, fields, cap, seed = _jax_table(rng.integers(0, 50, 200))
    tbl = interop.hash_table_from_numpy(fields, "cpu")
    h1 = torch.arange(10, dtype=torch.int64)
    h2 = torch.arange(10, dtype=torch.int64)
    if bad == "h1_dtype":
        h1 = h1.int()
    elif bad == "used_dtype":
        tbl = tbl._replace(slot_used=tbl.slot_used.to(torch.uint8))
    elif bad == "shape":
        h2 = h2[:5]
    elif bad == "capacity":
        cap = cap - 1
    elif bad == "noncontig":
        h1 = torch.arange(20, dtype=torch.int64)[::2]
    with pytest.raises((TypeError, ValueError)):
        PK.probe_hash_table_kernel(tbl, h1, h2, cap, seed, 16)


def test_filter_indices_matches():
    rng = np.random.default_rng(4)
    keep = rng.random(777) < 0.3
    idx, n = JK.filter_indices(jnp.asarray(keep), jnp.ones(777, jnp.bool_))
    got = PK.filter_indices(torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), _np(idx)[: int(n)])


SORT_CASES = [
    [("long", True, None)],
    [("long", False, None)],
    [("double", True, None)],
    [("double", False, True)],
    [("dict_string", True, None), ("int", False, None)],
    [("date", True, False), ("double", False, None), ("long", True, None)],
    [("decimal", False, None), ("dict_string", True, False)],
]


@pytest.mark.parametrize("case", range(len(SORT_CASES)))
def test_sort_indices_matches(case):
    rng = np.random.default_rng(13 + case)
    specs = SORT_CASES[case]
    n = 400
    # few distinct values so ties and later keys matter
    t = pa.table({f"c{i}": pa.array(_table(kind, n, rng).to_pylist()[:40] * 10)
                  for i, (kind, _, _) in enumerate(specs)})
    jb, pb = _batches(t)
    jspec = [JK.SortSpec(i, asc, nf) for i, (_, asc, nf) in enumerate(specs)]
    pspec = [PK.SortSpec(i, asc, nf) for i, (_, asc, nf) in enumerate(specs)]
    exp = _np(JK.sort_indices(jb, jspec))
    np.testing.assert_array_equal(PK.sort_indices(pb, pspec).numpy(), exp)


@pytest.mark.parametrize("kinds", [["long"], ["dict_string", "date"],
                                   ["double"], ["int", "long"]])
def test_group_rows_and_segment_agg_match(kinds):
    rng = np.random.default_rng(21)
    n = 500
    t = pa.table({**{f"k{i}": pa.array(_table(k, n, rng).to_pylist()[:30] * 17
                                       )[:n] for i, k in enumerate(kinds)},
                  "v": pa.array(rng.normal(0, 100, n), pa.float64()),
                  "w": pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                                mask=rng.random(n) < 0.2)})
    jb, pb = _batches(t)
    keys = list(range(len(kinds)))
    jg = JK.group_rows(jb, keys)
    pg = PK.group_rows(pb, keys)
    ng = int(jax.device_get(jg.num_groups))
    assert pg.num_groups == ng
    np.testing.assert_array_equal(pg.perm.numpy(), _np(jg.perm))
    np.testing.assert_array_equal(pg.segment_ids.numpy(), _np(jg.segment_ids))
    np.testing.assert_array_equal(pg.group_starts.numpy(),
                                  _np(jg.group_starts)[:ng])
    ends = JK.segment_ends(jg.group_starts, jg.num_groups, n)
    for ci, op in ((len(kinds), "sum"), (len(kinds) + 1, "sum"),
                   (len(kinds) + 1, "count"), (len(kinds), "count_all"),
                   (len(kinds) + 1, "min"), (len(kinds), "max")):
        jc, pc = jb.columns[ci], pb.columns[ci]
        jd, jv = JK.segment_agg(jc.data[jg.perm], jc.validity[jg.perm],
                                jnp.ones(n, jnp.bool_), jg.segment_ids, n,
                                op, ends=ends, starts=jg.group_starts)
        pd_, pv = PK.segment_agg(pc.data[pg.perm], pc.validity[pg.perm],
                                 pg.segment_ids, pg.group_starts, op)
        jd, jv = _np(jd)[:ng], _np(jv)[:ng]
        np.testing.assert_array_equal(pv.numpy(), jv)
        if pd_.is_floating_point():
            np.testing.assert_allclose(pd_.numpy()[jv], jd[jv], rtol=1e-6)
        else:
            np.testing.assert_array_equal(pd_.numpy()[jv], jd[jv])


def test_concat_device_keeps_shared_dictionary_and_strings():
    rng = np.random.default_rng(8)
    t = JB.dictionary_encode_table(pa.table({
        "d": _table("dict_string", 100, rng),
        "s": _table("plain_string", 100, rng),
        "x": _table("double", 100, rng)}))
    cache = {}
    parts = [PB.batch_from_arrow(t.slice(i, 30), "cpu", dict_cache=cache)
             for i in range(0, 100, 30)]
    cat = PK.concat_device(parts)
    assert cat.columns[0].dictionary is parts[0].columns[0].dictionary
    schema = PT.Schema.from_arrow(t.schema)
    out = PB.batch_to_arrow(cat, schema)
    plain = pa.table(t.to_pydict())
    for name in ("d", "s"):
        assert out.column(name).to_pylist() == plain.column(name).to_pylist()
    np.testing.assert_array_equal(
        out.column("x").to_numpy(zero_copy_only=False),
        plain.column("x").to_numpy(zero_copy_only=False))


def test_keys_equal_matches_on_decimal_and_mixed_keys():
    rng = np.random.default_rng(17)
    n = 300
    kinds = ["decimal", "long", "double"]
    t = pa.table({f"c{i}": pa.array(_table(k, n, rng).to_pylist()[:25] * 12)
                  for i, k in enumerate(kinds)})
    jb, pb = _batches(t)
    a = rng.integers(0, n, 500)
    b = rng.integers(0, n, 500)
    cols = list(range(len(kinds)))
    exp = _np(JK.keys_equal(jb, jnp.asarray(a, jnp.int32), cols, jb,
                            jnp.asarray(b, jnp.int32), cols))
    got = PK.keys_equal(pb, torch.from_numpy(a), cols, pb,
                        torch.from_numpy(b), cols).numpy()
    np.testing.assert_array_equal(got, exp)
    assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# segmented scan: the port's plain version against the reference's XLA
# formulation and its Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

# Every case runs through the reference at one padded shape (rows past the
# case are heads, so they cannot reach into it): one compile per op.
_SCAN_ROWS = 1 << 17
_SCAN_LENGTHS = [0, 1, 1023, 1024, 1025, 100_003]
_SCAN_MODES = ["random", "all_heads", "one_head"]
_SCAN_DTYPES = {"int32": np.int32, "int64": np.int64, "float32": np.float32,
                "float64": np.float64}


@functools.lru_cache(maxsize=None)
def _jax_scan(op, pallas):
    if pallas:
        return jax.jit(functools.partial(JK.segmented_scan_pallas,
                                         op_name=op, interpret=True))
    return jax.jit(functools.partial(JK.segmented_scan_xla, op_name=op))


def _scan_case(dtype, op, n, mode, rng):
    """Seeded (values, is_start) of one case: integers over their whole
    range (so add wraps), floats with NaNs for min/max."""
    dt = _SCAN_DTYPES[dtype]
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, endpoint=True).astype(dt)
    else:
        v = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(dt)
        if op != "add":
            v[rng.random(n) < 0.01] = np.nan
    if mode == "random":
        f = rng.random(n) < 0.01
        if n:
            f[0] = bool(rng.random() < 0.5)  # both first-row conventions
    elif mode == "all_heads":
        f = np.ones(n, np.bool_)
    else:
        f = np.zeros(n, np.bool_)
        if n:
            f[n // 2] = True
    return v, f


def _reference_scan(v, f, op, pallas):
    pad = _SCAN_ROWS - len(v)
    vp = np.concatenate([v, np.zeros(pad, v.dtype)])
    fp = np.concatenate([f, np.ones(pad, np.bool_)])
    out = _jax_scan(op, pallas)(jnp.asarray(vp), jnp.asarray(fp))
    return np.asarray(jax.device_get(out))[: len(v)]


def assert_scan_close(got, exp, v, f, op):
    """Integers and min/max exactly (NaN equals NaN); float add within
    ``segscan_add_tolerance`` of the running sum of |values|."""
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if np.issubdtype(got.dtype, np.floating) and op == "add":
        absrun = PK.segmented_scan(torch.from_numpy(np.abs(v)).double(),
                                   torch.from_numpy(f), "add")
        tol = PK.segscan_add_tolerance(absrun, len(v),
                                       torch.from_numpy(v).dtype).numpy()
        err = np.abs(got.astype(np.float64) - exp.astype(np.float64))
        assert (err <= tol).all(), float((err - tol).max())
    else:
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", sorted(_SCAN_DTYPES))
def test_segmented_scan_plain_matches_xla(dtype, op):
    rng = np.random.default_rng(31)
    for n in _SCAN_LENGTHS:
        for mode in _SCAN_MODES:
            v, f = _scan_case(dtype, op, n, mode, rng)
            got = PK.segmented_scan(torch.from_numpy(v), torch.from_numpy(f),
                                    op).numpy()
            assert_scan_close(got, _reference_scan(v, f, op, False), v, f,
                              op)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_segmented_scan_plain_matches_pallas_interpret(dtype, op):
    rng = np.random.default_rng(37)
    for n in _SCAN_LENGTHS:
        for mode in _SCAN_MODES:
            v, f = _scan_case(dtype, op, n, mode, rng)
            got = PK.segmented_scan(torch.from_numpy(v), torch.from_numpy(f),
                                    op).numpy()
            assert_scan_close(got, _reference_scan(v, f, op, True), v, f, op)


def test_segmented_scan_is_not_a_prefix_difference():
    # a small segment after a large prefix keeps its exact float sum
    v = torch.tensor([1e17, -1e17 + 2.0**12, 1.0, 2.0], dtype=torch.float64)
    f = torch.tensor([True, False, True, False])
    out = PK.segmented_scan(v, f, "add")
    assert out[2].item() == 1.0 and out[3].item() == 3.0


def test_segscan_wrapper_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(5)
    v, f = _scan_case("int32", "max", 5000, "random", rng)
    before = dict(PK.KERNEL_LAUNCHES)
    got = PK.segmented_scan_kernel(torch.from_numpy(v), torch.from_numpy(f),
                                   "max")
    exp = PK.segmented_scan(torch.from_numpy(v), torch.from_numpy(f), "max")
    assert torch.equal(got, exp)
    assert PK.KERNEL_LAUNCHES == before
    empty = PK.segmented_scan_kernel(torch.zeros(0, dtype=torch.int64),
                                     torch.zeros(0, dtype=torch.bool), "add")
    assert empty.shape == (0,) and empty.dtype == torch.int64


@pytest.mark.parametrize("bad", ["flag_dtype", "shape", "op", "two_d",
                                 "device"])
def test_segscan_wrapper_rejects_what_the_kernel_does_not_take(bad):
    v = torch.arange(10, dtype=torch.int32)
    f = torch.zeros(10, dtype=torch.bool)
    op = "add"
    if bad == "flag_dtype":
        f = f.to(torch.uint8)
    elif bad == "shape":
        f = f[:5]
    elif bad == "op":
        op = "mul"
    elif bad == "two_d":
        v, f = v.reshape(2, 5), f.reshape(2, 5)
    elif bad == "device":
        v = v.to("meta")
    with pytest.raises((TypeError, ValueError)):
        PK.segmented_scan_kernel(v, f, op)
