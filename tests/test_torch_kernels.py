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

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


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
    for field in JK.HashTable._fields:
        np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                      _np(getattr(jt, field)), err_msg=field)
    np.testing.assert_array_equal(pt.slot_tag.numpy(),
                                  _tags(_np(jt.slot_used), _np(jt.slot_h2)))


def _tags(used, h2):
    """The port's slot tags from a table's fields, in numpy."""
    return np.where(used, 0x80 | (h2 & 0x7F), 0).astype(np.uint8)


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
    for f in JK.HashTable._fields:
        exp = fields[f][:500] if f in ("row_slot", "order",
                                       "sorted_slots") else fields[f]
        np.testing.assert_array_equal(getattr(own, f).numpy(), exp,
                                      err_msg=f)
    np.testing.assert_array_equal(own.slot_tag.numpy(),
                                  _tags(fields["slot_used"], fields["slot_h2"]))
    # candidate ranges over the same table and slots
    jlo, jcnt = JK.hashtbl_candidate_ranges(tbl, js, jhit)
    lo, cnt = PK.hashtbl_candidate_ranges(ptbl, slot, hit)
    np.testing.assert_array_equal(lo.numpy(), _np(jlo))
    np.testing.assert_array_equal(cnt.numpy(), _np(jcnt))


def test_build_rehashes_then_gives_up(monkeypatch):
    """An overflowing build retries with the next seed at twice the
    capacity; when every seed overflows the builder returns None and the
    join takes the sorted-hash path instead of dropping rows (the
    reference's fallback), recorded in its metrics."""
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
    out = list(node.execute(0))
    assert sorted(v for b in out for v in b.columns[0].data.tolist()) == \
        list(range(40))
    assert node.join_path == "sorted"
    assert node.metrics["sortedHashFallbacks"].value == 1
    assert node.metrics["sortedHashJoins"].value == 1
    assert node.metrics["hashTableJoins"].value == 0


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


def test_hash_table_layout_is_records_and_tags():
    """Every table the port makes (its build, and a reference table brought
    over by interop) keeps each slot's (h1, h2) as one row of a contiguous
    (capacity, 2) record tensor, with the reference's values, and a tag
    byte a slot: 0 exactly where the slot is unused."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 300)
    _, fields, cap, seed = _jax_table(keys)
    ptbl = interop.hash_table_from_numpy(fields, "cpu")
    bb = PB.batch_from_arrow(pa.table({"k": pa.array(keys, pa.int64())}),
                             "cpu")
    own, over = PK.build_hash_table(PK.hash_keys(bb, [0]),
                                    PK.hash_keys(bb, [0], variant=1),
                                    torch.ones(300, dtype=torch.bool), cap,
                                    seed, PK.HASHTBL_MAX_PROBES)
    assert not over
    for tbl in (ptbl, own):
        assert tbl.slot_keys.shape == (cap, 2)
        assert tbl.slot_keys.is_contiguous()
        np.testing.assert_array_equal(
            tbl.slot_keys.numpy(),
            np.stack([fields["slot_h1"], fields["slot_h2"]], 1))
        for f in ("slot_h1", "slot_h2", "slot_used"):
            np.testing.assert_array_equal(getattr(tbl, f).numpy(), fields[f],
                                          err_msg=f)
        tag = tbl.slot_tag.numpy()
        np.testing.assert_array_equal(tag, _tags(fields["slot_used"],
                                                 fields["slot_h2"]))
        np.testing.assert_array_equal(tag != 0, fields["slot_used"])


@pytest.mark.parametrize("bad", ["h1_dtype", "used_dtype", "shape",
                                 "capacity", "noncontig", "column_major_keys",
                                 "tag_dtype"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(2)
    _, fields, cap, seed = _jax_table(rng.integers(0, 50, 200))
    tbl = interop.hash_table_from_numpy(fields, "cpu")
    h1 = torch.arange(10, dtype=torch.int64)
    h2 = torch.arange(10, dtype=torch.int64)
    if bad == "h1_dtype":
        h1 = h1.int()
    elif bad == "used_dtype":  # a slot's used state lives in its tag
        tbl = tbl._replace(slot_tag=tbl.slot_tag.int())
    elif bad == "shape":
        h2 = h2[:5]
    elif bad == "capacity":
        cap = cap - 1
    elif bad == "noncontig":
        h1 = torch.arange(20, dtype=torch.int64)[::2]
    elif bad == "column_major_keys":  # h1 words apart from h2 words
        tbl = tbl._replace(slot_keys=tbl.slot_keys.t().contiguous().t())
    elif bad == "tag_dtype":
        tbl = tbl._replace(slot_tag=tbl.slot_tag.bool())
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


def assert_scan_close(got, exp, v, f, op, grouping="reference"):
    """Integers and min/max exactly (NaN equals NaN); float add within
    ``segscan_add_tolerance`` of the running sum of |values|, for the
    grouping that ``got`` or ``exp`` was summed in besides the plain
    version's."""
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if np.issubdtype(got.dtype, np.floating) and op == "add":
        absrun = PK.segmented_scan(torch.from_numpy(np.abs(v)).double(),
                                   torch.from_numpy(f), "add")
        tol = PK.segscan_add_tolerance(absrun, len(v),
                                       torch.from_numpy(v).dtype,
                                       grouping).numpy()
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


def test_segscan_add_tolerance_follows_the_kernel_grouping():
    """The stated depth is ceil(log2 n) plus, for the kernel, its in-tile
    depth + ceil(n / tile), both read off the tile geometry the kernel
    runs (kThreads, kItems and kRun in csrc/segscan.cu: r rows a run, R
    runs a thread, W warps; r - 1 + 5 + R - 1 + log2 W adds to the tile
    aggregate, then R + 2 folds into a row), and for the reference the
    larger of its two groupings' depths; any other grouping is refused."""
    import math
    import os
    import re

    src = open(os.path.join(os.path.dirname(PK.__file__), "..", "csrc",
                            "segscan.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    tile, thr, items, r = (const(c) for c in ("kTile", "kThreads",
                                               "kItems", "kRun"))
    assert thr * items == tile == PK._SEGSCAN_TILE_ROWS == 4096
    runs, warps = items // r, thr // 32
    in_tile = (r - 1 + 5 + runs - 1 + int(math.log2(warps))) + (runs + 2)
    assert in_tile == PK._SEGSCAN_TILE_DEPTH == 20
    eps = torch.finfo(torch.float32).eps
    one = torch.ones(1, dtype=torch.float64)
    for n, kernel, reference in ((1, 1 + 20 + 1, 1 + 17),
                                 (4096, 12 + 20 + 1, 12 + 27),
                                 (4097, 13 + 20 + 2, 13 + 27),
                                 (100_003, 17 + 20 + 25, 17 + 35),
                                 (3_000_001, 22 + 20 + 733, 22 + 45)):
        for grouping, depth in (("kernel", kernel),
                                ("reference", reference)):
            got = PK.segscan_add_tolerance(one, n, torch.float32,
                                           grouping).item()
            assert got == pytest.approx(depth * eps, rel=1e-12), (n,
                                                                  grouping)
    assert PK.segscan_add_tolerance(one, 10, torch.float32).item() == \
        PK.segscan_add_tolerance(one, 10, torch.float32, "kernel").item()
    with pytest.raises(ValueError):
        PK.segscan_add_tolerance(one, 10, torch.float32, "tiles")


def _hs_scan(v, f, fn):
    """Inclusive shuffle (Hillis-Steele) scan of (value, flag) pairs along
    the last axis, as __shfl_up_sync steps give it."""
    v, f = v.copy(), f.copy()
    d = 1
    while d < v.shape[-1]:
        ov, of = v[..., :-d].copy(), f[..., :-d].copy()
        v[..., d:] = np.where(f[..., d:], v[..., d:], fn(ov, v[..., d:]))
        f[..., d:] = f[..., d:] | of
        d *= 2
    return v, f


def _shift1(a):
    """Each lane's value from the lane before it (lane 0 keeps its own)."""
    return np.concatenate([a[..., :1], a[..., :-1]], -1)


def _fold(have, pre, f, v, fn):
    """pre . (f, v) where ``have``; v where not (csrc/segscan.cu's fold)."""
    return np.where(have & ~f, fn(pre, v), v)


def _kernel_grouping_scan(v, f, op):
    """The CUDA kernel's grouping of the scan, emulated in numpy in the
    values' own type: 4096-row tiles of 8 warps, each lane holding 4 runs
    of 4 rows (run j of a warp's lanes covers 128 contiguous rows; rows
    past the end are heads); a sequential scan in each run, a shuffle scan
    of the run's thread totals over the lanes, the warp's runs chained,
    a shuffle scan of the warp totals, and tile carries chained one tile
    at a time (the longest chain the look-back can take)."""
    fn = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    n = len(v)
    tiles = max(-(-n // 4096), 1)
    vp = np.zeros(tiles * 4096, v.dtype)
    fp = np.ones(tiles * 4096, np.bool_)
    vp[:n], fp[:n] = v, f
    # (tile, warp, run, lane, row)
    x = vp.reshape(tiles, 8, 4, 32, 4).copy()
    h = fp.reshape(tiles, 8, 4, 32, 4)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(1, 4):
            x[..., k] = np.where(h[..., k], x[..., k],
                                 fn(x[..., k - 1], x[..., k]))
        lv, lf = _hs_scan(x[..., 3], h.any(-1), fn)   # over the lanes
        run_v, run_f = lv[..., 31], lf[..., 31]       # (tile, warp, run)
        wt_v, wt_f = run_v[..., 0].copy(), run_f[..., 0].copy()
        for j in range(1, 4):
            wt_v = np.where(run_f[..., j], run_v[..., j],
                            fn(wt_v, run_v[..., j]))
            wt_f = wt_f | run_f[..., j]
        tv, tf = _hs_scan(wt_v, wt_f, fn)             # over the warps
        agg_v, agg_f = tv[:, 7], tf[:, 7]
        incl = np.empty(tiles, v.dtype)
        for t in range(tiles):
            incl[t] = (agg_v[t] if t == 0 or agg_f[t]
                       else fn(incl[t - 1], agg_v[t]))
        # prefixes: tile, warp, the warp's runs before, the run's lanes
        pre = np.zeros((tiles, 8), v.dtype)
        have = np.zeros((tiles, 8), np.bool_)
        pre[1:], have[1:] = incl[:-1, None], True
        wmask = np.arange(8)[None, :] > 0
        pre = np.where(wmask, _fold(have, pre, _shift1(tf), _shift1(tv), fn),
                       pre)
        have = have | wmask
        lmask = np.arange(32) > 0
        lane_v, lane_f = _shift1(lv), _shift1(lf)
        before = np.cumsum(h, -1) == 0
        for j in range(4):
            p = np.where(lmask, _fold(have[..., None], pre[..., None],
                                      lane_f[:, :, j], lane_v[:, :, j], fn),
                         pre[..., None])
            hj = have[..., None] | lmask
            xj = x[:, :, j]
            x[:, :, j] = np.where(before[:, :, j] & hj[..., None],
                                  fn(p[..., None], xj), xj)
            pre = _fold(have, pre, run_f[..., j], run_v[..., j], fn)
            have = np.ones_like(have)
    return x.reshape(-1)[:n]


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", sorted(_SCAN_DTYPES))
def test_kernel_grouping_matches_plain_scan(dtype, op):
    """The kernel's tile/warp/look-back grouping (emulated) gives the plain
    scan's rows: exactly for integers and min/max, within
    ``segscan_add_tolerance`` for float add, across tile edges, several
    tiles, and one segment carried over 74 tiles."""
    rng = np.random.default_rng(29)
    cases = [(n, m) for n in (1, 4095, 4096, 4097, 3 * 4096 + 7)
             for m in _SCAN_MODES] + [(300_001, "span")]
    for n, mode in cases:
        if mode == "span":
            v, _ = _scan_case(dtype, op, n, "random", rng)
            f = np.zeros(n, np.bool_)
        else:
            v, f = _scan_case(dtype, op, n, mode, rng)
        got = _kernel_grouping_scan(v, f, op)
        exp = PK.segmented_scan(torch.from_numpy(v), torch.from_numpy(f),
                                op).numpy()
        assert_scan_close(got, exp, v, f, op, grouping="kernel")
