"""Tests of the port that need a CUDA card (marker ``cuda``); they skip
where there is none: the probe and segmented-scan kernels against their
plain versions on the card (ragged row counts, tile edges, misaligned
views and records, many tiles, the scan's scratch left zeroed), TPC-H
Q3 and TPC-DS q3/q7/q42/q44/q52/q67/q96 on the card against the same
queries on the CPU (the headline queries also against the CPU engine),
plain-string sort keys and the string hash's device-resident power table;
the six join types (inner, left, right, full, left_semi, left_anti)
through the probe kernel against the same joins on the CPU, and the
joins slice's q9/q28/q40/q43/q87/q88/q93/q97 on the card against the CPU
and the CPU engine; the sorted-hash join path (all six types, its
candidate ranges) and the breadth slice's 33 queries on the card against
the CPU, the CPU engine and the sorted-hash path; Substring, LIKE and
string-column equality, residual join conditions (all six types, both
join paths) and the union slice's 25 queries on the card against the
CPU (the queries also against the CPU engine, and the six that join with
a condition against the sorted-hash path); the 128-bit arithmetic, a
DECIMAL128 window sum through the segmented-scan kernel, decimal Divide,
Abs and UnaryMinus, and the decimal slice's 21 queries and
q1/q30/q65/q81 on the card against the CPU, the CPU engine and the
sorted-hash path; the window slice's surface (ntile, percent_rank,
cume_dist, lead/lag, first/last, bounded ROWS and RANGE frames, the
min/max scans, plain-string partition keys) and its five queries
q47/q57/q70/q86/q89 the same way; partitioned execution: partition ids
on the card against the CPU, the shuffle exchange uploading to the card
in map order with one and four writer threads, and TPC-H and TPC-DS
queries with 4 source splits on the card against one partition on the
CPU; adaptive reads and reuse: a skew-split shuffled join through the
probe kernel, prefetch boundaries and the exchange's read-ahead
delivering card batches in map order (on a side stream too), and a
reused exchange replayed on the card, each against the CPU; the scalar
types: ingest and Arrow out of TINYINT, SMALLINT, FLOAT and TIMESTAMP,
a typed spill round trip, int8/int16 scans launching the kernel, a
BYTE/SHORT bounded ROWS Min/Max window and the typed sales' T4 through
the planner; the aggregate family: every device aggregate on the card
(one split and 4) against the CPU engine, the variance windows over all
four frames with every scan call held against the plain version, and the
statistics pass's S3 under a capped pool, its spilled partials read back
equal; the scalar families: every device class over seeded edge values on
the card against the CPU, the string casts over a 2^20-row dictionary
column and a plain one, and the scalar sales pass's N3 on one split and
on four against the CPU engine; the string family: every device class
over 2^18 rows (a dictionary and a plain column) on the card against the
CPU byte for byte, the composition scan with uint8 and int32 states, and
the string sales pass's G1 (the probe) and G5 (the scan) against the CPU
engine; the nested sales pass's kernels; the Parquet scan of each reader
type on the card against its CPU run, ``write_columnar`` of card batches
read back equal, and q3 over Parquet files with every probe call held
against the plain version and a row group pruned dynamically; the bloom
filter, Z-order, Hilbert and Expand on the card against the CPU, a Delta
DELETE and UPDATE with their predicates on the card, a plan memo hit
whose rows equal the first run's, and an idle memoised tree holding no
device memory.
This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec import kernels as PK

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keys(a):
    return PB.batch_from_arrow(pa.table({"k": pa.array(a, pa.int64())}),
                               "cuda")


@pytest.mark.parametrize("distinct,probes", [(5000, 100000), (50, 1000),
                                             (200000, 7)])
def test_probe_kernel_matches_plain_version_on_card(distinct, probes):
    _card()
    rng = np.random.default_rng(9)
    bb = _keys(rng.integers(0, distinct, 4 * distinct))
    tbl, cap, seed = PK.build_batch_hash_table(bb, (0,))
    pb = _keys(rng.integers(0, 2 * distinct, probes))
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    before = PK.KERNEL_LAUNCHES["hashtbl_probe"]
    ks, kh = PK.probe_hash_table_kernel(tbl, h1, h2, cap, seed, 16)
    torch.cuda.synchronize()
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] == before + 1
    ps, ph = PK.probe_hash_table(tbl, h1, h2, cap, seed, 16)
    assert torch.equal(ks, ps) and torch.equal(kh, ph)


@pytest.mark.parametrize("probes", [0, 1, 2, 3, 5, 6, 7, 4097, 4098, 4099,
                                    1_000_003])
def test_probe_kernel_ragged_row_counts_on_card(probes):
    """The kernel runs one row a thread in 256-thread blocks: row counts
    of every residue mod 4, none at all (no launch), counts just past a
    block edge, and one of many blocks."""
    _card()
    rng = np.random.default_rng(11)
    bb = _keys(rng.integers(0, 3000, 9000))
    tbl, cap, seed = PK.build_batch_hash_table(bb, (0,))
    pb = _keys(rng.integers(0, 6000, probes))
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    before = PK.KERNEL_LAUNCHES["hashtbl_probe"]
    ks, kh = PK.probe_hash_table_kernel(tbl, h1, h2, cap, seed, 16)
    torch.cuda.synchronize()
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] == before + (probes > 0)
    assert ks.shape == kh.shape == (probes,)
    assert ks.dtype == torch.int32 and kh.dtype == torch.bool
    ps, ph = PK.probe_hash_table(tbl, h1, h2, cap, seed, 16)
    assert torch.equal(ks, ps) and torch.equal(kh, ph)


def test_probe_kernel_near_full_table_stops_at_the_bound_on_card():
    """60,000 keys in 2^16 slots: clusters run probes into the 16-slot
    bound, where both versions give -1 without reaching an empty slot."""
    _card()
    rng = np.random.default_rng(13)
    build = rng.choice(1 << 40, 60_000, replace=False)
    bb = _keys(build)
    h1b, h2b = PK.hash_keys(bb, [0]), PK.hash_keys(bb, [0], variant=1)
    valid = torch.ones(len(build), dtype=torch.bool, device="cuda")
    tbl, overflow = PK.build_hash_table(h1b, h2b, valid, 1 << 16, 0, 16)
    assert overflow  # some keys found no slot within the bound
    pb = _keys(np.concatenate([build, rng.integers(1 << 41, 1 << 42,
                                                   50_001)]))
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    ks, kh = PK.probe_hash_table_kernel(tbl, h1, h2, 1 << 16, 0, 16)
    ps, ph = PK.probe_hash_table(tbl, h1, h2, 1 << 16, 0, 16)
    assert torch.equal(ks, ps) and torch.equal(kh, ph)
    assert not bool(kh[: len(build)].all())  # the unplaced keys miss


def test_probe_kernel_takes_records_not_16_byte_aligned_on_card():
    """A record array 8 bytes off a 16-byte boundary (a contiguous view at
    an odd storage offset) takes the kernel's two 8-byte loads; the result
    is the same."""
    _card()
    rng = np.random.default_rng(15)
    bb = _keys(rng.integers(0, 3000, 9000))
    tbl, cap, seed = PK.build_batch_hash_table(bb, (0,))
    flat = torch.empty(2 * cap + 1, dtype=torch.int64, device="cuda")
    keys = flat[1:].view(cap, 2)
    keys.copy_(tbl.slot_keys)
    assert keys.is_contiguous() and keys.data_ptr() % 16 == 8
    odd = tbl._replace(slot_keys=keys)
    pb = _keys(rng.integers(0, 6000, 100_001))
    h1, h2 = PK.hash_keys(pb, [0]), PK.hash_keys(pb, [0], variant=1)
    ks, kh = PK.probe_hash_table_kernel(odd, h1, h2, cap, seed, 16)
    torch.cuda.synchronize()
    ps, ph = PK.probe_hash_table(tbl, h1, h2, cap, seed, 16)
    assert torch.equal(ks, ps) and torch.equal(kh, ph)


def test_probe_kernel_rejects_mixed_devices():
    _card()
    bb = _keys(np.arange(100))
    tbl, cap, seed = PK.build_batch_hash_table(bb, (0,))
    h = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError):
        PK.probe_hash_table_kernel(tbl, h, h, cap, seed, 16)


def test_tpch_q3_on_card_matches_cpu():
    _card()
    from spark_rapids_tpu_torch.bench import tpch

    t = tpch.tables_for(0.05, seed=3)
    got = tpch.DF_QUERIES["q3"](tpch.df_tables(t, device="cuda"))
    exp = tpch.DF_QUERIES["q3"](tpch.df_tables(t, device="cpu"))
    g, e = got.to_arrow().to_pylist(), exp.to_arrow().to_pylist()
    assert tpch.rows_match(g, e)
    assert [r["l_orderkey"] for r in g] == [r["l_orderkey"] for r in e]


SCAN_DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64]


def _scan_input(dtype, op, n, mode, rng):
    if dtype.is_floating_point:
        v = rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
        if op != "add":
            v[rng.random(n) < 0.01] = np.nan
        vals = torch.from_numpy(v).to(dtype)
    else:
        info = torch.iinfo(dtype)
        vals = torch.from_numpy(rng.integers(info.min, info.max, n,
                                             endpoint=True)).to(dtype)
    f = {"random": rng.random(n) < 0.01, "all_heads": np.ones(n, np.bool_),
         "span": np.zeros(n, np.bool_)}[mode]
    return vals.cuda(), torch.from_numpy(f).cuda()


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", SCAN_DTYPES, ids=str)
def test_segscan_kernel_matches_plain_version_on_card(dtype, op):
    """Integers and min/max exactly (NaN equals NaN); float add within
    ``segscan_add_tolerance``. Lengths around the 1024-row tile, the
    main path's geometry-scan size, and one segment over 2M rows."""
    _card()
    rng = np.random.default_rng(7)
    cases = [(n, m) for n in (1, 1023, 1024, 1025, 518_011)
             for m in ("random", "all_heads")] + [(2_000_001, "span")]
    for n, mode in cases:
        v, f = _scan_input(dtype, op, n, mode, rng)
        before = PK.KERNEL_LAUNCHES["segscan"]
        k = PK.segmented_scan_kernel(v, f, op)
        torch.cuda.synchronize()
        assert PK.KERNEL_LAUNCHES["segscan"] == before + 1
        p = PK.segmented_scan(v, f, op)
        if dtype.is_floating_point and op == "add":
            absrun = PK.segmented_scan(v.abs().double(), f, "add")
            tol = PK.segscan_add_tolerance(absrun, n, dtype)
            assert bool(((k.double() - p.double()).abs() <= tol).all()), \
                (n, mode)
        else:
            same = k == p
            if dtype.is_floating_point:
                same = same | (torch.isnan(k) & torch.isnan(p))
            assert bool(same.all()), (n, mode)


def _assert_scan_matches(k, p, v, f, dtype, op, what):
    if dtype.is_floating_point and op == "add":
        absrun = PK.segmented_scan(v.abs().double(), f, "add")
        tol = PK.segscan_add_tolerance(absrun, v.numel(), dtype)
        assert bool(((k.double() - p.double()).abs() <= tol).all()), what
    else:
        same = k == p
        if dtype.is_floating_point:
            same = same | (torch.isnan(k) & torch.isnan(p))
        assert bool(same.all()), what


TILE = 4096  # rows a tile of csrc/segscan.cu


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", SCAN_DTYPES, ids=str)
def test_segscan_kernel_tile_edges_on_card(dtype, op):
    """Lengths at the kernel's 4096-row tile edges (tile - 1, tile,
    tile + 1, 127 tiles + 1), with random heads, all heads and none."""
    _card()
    rng = np.random.default_rng(17)
    for n in (TILE - 1, TILE, TILE + 1, 127 * TILE + 1):
        for mode in ("random", "all_heads", "span"):
            v, f = _scan_input(dtype, op, n, mode, rng)
            k = PK.segmented_scan_kernel(v, f, op)
            torch.cuda.synchronize()
            _assert_scan_matches(k, PK.segmented_scan(v, f, op), v, f, dtype,
                                 op, (n, mode))


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", SCAN_DTYPES, ids=str)
def test_segscan_kernel_misaligned_views_on_card(dtype, op):
    """Views at storage offsets 1-3 of values and flags take the kernel's
    scalar loads; the result is the same."""
    _card()
    rng = np.random.default_rng(19)
    n = 3 * TILE + 7
    for vo, fo in ((1, 1), (2, 2), (3, 3), (0, 3), (3, 0)):
        v, f = _scan_input(dtype, op, n + 3, "random", rng)
        v, f = v[vo:vo + n], f[fo:fo + n]
        assert v.is_contiguous() and f.is_contiguous()
        k = PK.segmented_scan_kernel(v, f, op)
        torch.cuda.synchronize()
        _assert_scan_matches(k, PK.segmented_scan(v, f, op), v, f, dtype, op,
                             (vo, fo))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64], ids=str)
def test_segscan_kernel_many_tiles_on_card(dtype):
    """4096 tiles with 16 heads: the look-back carries across many tiles;
    ten repeated calls give the same output."""
    _card()
    rng = np.random.default_rng(23)
    n = 4096 * TILE
    f = torch.zeros(n, dtype=torch.bool, device="cuda")
    f[torch.from_numpy(rng.choice(n, 16, replace=False)).cuda()] = True
    for op in ("max", "add"):
        v, _ = _scan_input(dtype, op, n, "span", rng)
        k = PK.segmented_scan_kernel(v, f, op)
        torch.cuda.synchronize()
        _assert_scan_matches(k, PK.segmented_scan(v, f, op), v, f, dtype, op,
                             op)
        if op == "max":  # NaN rows are NaN in every call
            for _ in range(10):
                again = PK.segmented_scan_kernel(v, f, op)
                assert bool(((again == k) | (torch.isnan(again)
                                             & torch.isnan(k))).all())


def test_segscan_kernel_leaves_its_scratch_zero_on_card():
    """The scan's scratch arrives zeroed and each launch leaves it zeroed,
    across dtypes whose descriptors are laid out differently and sizes
    that grow the buffer; every result stays right."""
    _card()
    rng = np.random.default_rng(29)
    for dtype, n in ((torch.float64, 300_001), (torch.int32, 5_000_001),
                     (torch.int64, 70_000), (torch.float32, 3 * TILE)):
        for op in ("add", "max"):
            v, f = _scan_input(dtype, op, n, "random", rng)
            k = PK.segmented_scan_kernel(v, f, op)
            torch.cuda.synchronize()
            _assert_scan_matches(k, PK.segmented_scan(v, f, op), v, f, dtype,
                                 op, (dtype, n, op))
            for buf in PK._segscan_scratch.values():
                assert not bool(buf.any()), (dtype, n, op)


def test_segscan_kernel_empty_input_launches_nothing():
    _card()
    before = PK.KERNEL_LAUNCHES["segscan"]
    out = PK.segmented_scan_kernel(torch.zeros(0, device="cuda"),
                                   torch.zeros(0, dtype=torch.bool,
                                               device="cuda"), "max")
    assert out.shape == (0,) and PK.KERNEL_LAUNCHES["segscan"] == before


def test_segscan_kernel_rejects_what_it_does_not_take():
    _card()
    f = torch.zeros(8, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        PK.segmented_scan_kernel(torch.zeros(8, dtype=torch.float16,
                                             device="cuda"), f, "add")
    with pytest.raises(ValueError):
        PK.segmented_scan_kernel(torch.zeros(16, device="cuda")[::2], f,
                                 "add")
    with pytest.raises(ValueError):
        PK.segmented_scan_kernel(torch.zeros(8, device="cuda"), f.cpu(),
                                 "add")


@pytest.mark.parametrize("q", ["q44", "q67"])
def test_tpcds_window_query_on_card_matches_cpu(q):
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    t = S.tables_for(0.05, seed=3)
    before = PK.KERNEL_LAUNCHES["segscan"]
    got = Q.QUERIES[q](Q.df_tables(t, device="cuda")).to_arrow().to_pylist()
    assert PK.KERNEL_LAUNCHES["segscan"] > before
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.check_rows(q, got, exp) == (True, "")
    assert Q.check_rows(q, got, Q.PANDAS[q](t)) == (True, "")


@pytest.mark.parametrize("q", ["q3", "q7", "q42", "q52", "q96"])
def test_tpcds_headline_query_on_card_matches_cpu(q):
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = S.tables_for(0.25, seed=3)
    df = Q.QUERIES[q](Q.df_tables(t, batch_rows=1 << 22, device="cuda"))
    assert "!" not in df.explain()
    got = df.to_arrow().to_pylist()
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.check_rows(q, got, exp) == (True, "")
    assert Q.check_rows(q, got, Q.PANDAS[q](t)) == (True, "")
    on_cpu = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda"))
    assert Q.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True, "")


def test_plain_string_sort_keys_on_card_match_cpu():
    _card()
    rng = np.random.default_rng(23)
    vals = ["".join(chr(c) for c in rng.integers(97, 100, rng.integers(0, 41)))
            for _ in range(5000)] + ["ab", "ab\x00", "", "a"]
    t = pa.table({"s": pa.array(vals, pa.string(),
                                mask=rng.random(len(vals)) < 0.05)})
    for asc in (True, False):
        pc, pg = PB.batch_from_arrow(t, "cpu"), PB.batch_from_arrow(t, "cuda")
        specs = [PK.SortSpec(0, asc)]
        got = PK.sort_indices(pg, specs)
        exp = PK.sort_indices(pc, specs)
        assert torch.equal(got.cpu(), exp)


def test_string_hash_power_table_stays_on_card():
    _card()
    t = pa.table({"s": pa.array([f"row{i}" * (i % 7) for i in range(3000)],
                                pa.string())})
    col = PB.batch_from_arrow(t, "cuda").columns[0]
    got = PK._string_hash(col, 0)
    table = PK._POW_TABLES[(0, col.device)]
    assert table.device.type == "cuda"
    PK._string_hash(col, 0)
    assert PK._POW_TABLES[(0, col.device)] is table
    exp = PK._string_hash(PB.batch_from_arrow(t, "cpu").columns[0], 0)
    assert torch.equal(got.cpu(), exp)


JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti"]


def _join_sides(device, string_keys):
    """Probe (three batches) and build sides with null and repeated keys,
    on ``device``."""
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec

    rng = np.random.default_rng(17)
    n, m = 30_000, 4_000

    def keys(k, count, domain):
        v = rng.integers(0, domain, count)
        mask = rng.random(count) < 0.05
        if string_keys:
            return pa.array([f"key-{int(x)}" for x in v], pa.string(),
                            mask=mask)
        return pa.array(v, pa.int64(), mask=mask)
    left = pa.table({"k": keys("k", n, 3000),
                     "k2": pa.array(rng.integers(0, 3, n), pa.int64()),
                     "v": pa.array(rng.normal(size=n))})
    right = pa.table({"rk": keys("rk", m, 4000),
                      "rk2": pa.array(rng.integers(0, 3, m), pa.int64()),
                      "w": pa.array(rng.integers(0, 99, m), pa.int64())})

    def source(t, rows):
        t = PB.dictionary_encode_table(t)
        cache = {}
        return BatchSourceExec([[PB.batch_from_arrow(
            t.slice(i, rows), device, dict_cache=cache)
            for i in range(0, t.num_rows, rows)]],
            PT.Schema.from_arrow(t.schema), device)
    return source(left, 10_000), source(right, m)


@pytest.mark.parametrize("string_keys", [False, True])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_type_through_probe_kernel_matches_cpu_on_card(how,
                                                             string_keys):
    _card()
    from spark_rapids_tpu_torch.bench.tpch import rows_match
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exprs import expr as PE

    def run(device):
        left, right = _join_sides(device, string_keys)
        node = HashJoinExec([PE.col("k"), PE.col("k2")],
                            [PE.col("rk"), PE.col("rk2")], how, left, right)
        return pa.concat_tables([PB.batch_to_arrow(b, node.output_schema)
                                 for b in node.execute(0)]).to_pylist()
    before = PK.KERNEL_LAUNCHES["hashtbl_probe"]
    got = run("cuda")
    torch.cuda.synchronize()
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] == before + 3  # one a batch
    exp = run("cpu")
    assert len(got) == len(exp) and rows_match(got, exp)


@pytest.mark.parametrize("q", ["q9", "q28", "q40", "q43", "q87", "q88",
                               "q93", "q97"])
def test_tpcds_join_query_on_card_matches_cpu(q):
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = S.tables_for(0.1, seed=3, names=Q.TABLES[q])
    df = Q.QUERIES[q](Q.df_tables(t, batch_rows=1 << 22, device="cuda"))
    assert "!" not in df.explain()
    before = PK.KERNEL_LAUNCHES["hashtbl_probe"]
    got = df.to_arrow().to_pylist()
    assert (PK.KERNEL_LAUNCHES["hashtbl_probe"] > before) == (q != "q9")
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.check_rows(q, got, exp) == (True, "")
    assert Q.check_rows(q, got, Q.PANDAS[q](t)) == (True, "")
    on_cpu = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda"))
    assert Q.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True, "")


@pytest.mark.parametrize("string_keys", [False, True])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_type_on_sorted_hash_path_matches_cpu_on_card(how,
                                                            string_keys):
    """The sorted-hash path (hash table off) on the card: no probe launch,
    and the rows of the same join on the CPU, on either path."""
    _card()
    from spark_rapids_tpu_torch.bench.tpch import rows_match
    from spark_rapids_tpu_torch.config import conf as PC
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exprs import expr as PE

    def run(device, hash_table):
        PC.set_active(PC.RapidsConf({
            "spark.rapids.gpu.sql.join.hashTable.enabled": hash_table}))
        try:
            left, right = _join_sides(device, string_keys)
            node = HashJoinExec([PE.col("k"), PE.col("k2")],
                                [PE.col("rk"), PE.col("rk2")], how, left,
                                right)
        finally:
            PC.set_active(None)
        rows = pa.concat_tables([PB.batch_to_arrow(b, node.output_schema)
                                 for b in node.execute(0)]).to_pylist()
        return rows, node.join_path
    before = PK.KERNEL_LAUNCHES["hashtbl_probe"]
    got, path = run("cuda", False)
    torch.cuda.synchronize()
    assert path == "sorted"
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] == before
    for hash_table in (False, True):
        exp, _ = run("cpu", hash_table)
        assert len(got) == len(exp) and rows_match(got, exp)


def test_sorted_hash_candidates_on_card_match_cpu():
    """prepare_join_side and join_candidate_counts on the card give the
    CPU's sorted hashes, build rows and candidate ranges, hashes on both
    sides of 2^63 included (the search runs on the top-bit-flipped
    bits)."""
    _card()
    rng = np.random.default_rng(23)
    build = rng.integers(0, 20_000, 50_000)
    probe = rng.integers(0, 40_000, 200_000)
    out = {}
    for dev in ("cuda", "cpu"):
        bb = PB.batch_from_arrow(pa.table({"k": pa.array(build, pa.int64())}),
                                 dev)
        pb = PB.batch_from_arrow(pa.table({"k": pa.array(probe, pa.int64())}),
                                 dev)
        jh = PK.prepare_join_side(bb, [0])
        lo, cnt = PK.join_candidate_counts(pb, [0], jh)
        out[dev] = [t.cpu() for t in (jh.sorted_hash, jh.order, lo, cnt)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    h = PK.hash_keys(PB.batch_from_arrow(pa.table(
        {"k": pa.array(build, pa.int64())}), "cpu"), [0])
    assert bool((h < 0).any()) and bool((h >= 0).any())
    assert int(out["cpu"][3].sum()) > 0


@pytest.mark.parametrize("q", ["q1", "q13", "q14", "q16", "q17", "q25", "q26",
                               "q27", "q29", "q30", "q32", "q34", "q37",
                               "q38", "q39", "q41", "q48", "q50", "q55",
                               "q62", "q64", "q65", "q69", "q73", "q78",
                               "q79", "q81", "q82", "q84", "q85", "q92",
                               "q94", "q99"])
def test_tpcds_breadth_query_on_card_matches_cpu(q):
    """The breadth slice's queries on the card against the same query on
    the CPU, on the CPU engine and with the hash table off (the sorted-hash
    path on the card)."""
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t = S.tables_for(0.1, seed=3, names=Q.TABLES[q])
    df = Q.QUERIES[q](Q.df_tables(t, batch_rows=1 << 22, device="cuda"))
    got = df.to_arrow().to_pylist()
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.informative(got)  # every result of seed 3 at SF 0.1 has values
    assert Q.check_rows(q, got, exp) == (True, "")
    on_cpu = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda"))
    assert Q.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True, "")
    off = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
        batch_rows=1 << 22, device="cuda")).physical_plan()
    assert Q.check_rows(q, execute_to_arrow(off).to_pylist(), got) == (True,
                                                                     "")
    assert "ht" not in join_paths(off)


def _string_table(n=5000, seed=11):
    rng = np.random.default_rng(seed)
    words = np.array(["abcxx", "zbcyy", "abdxx", "", "a", "a%b", "x_y",
                      "qbcxx"], dtype=object)
    d = words[rng.integers(0, len(words), n)].tolist()
    return pa.table({
        "d": pa.array(d, pa.string(), mask=rng.random(n) < 0.1),
        "d2": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                       pa.string()),
        "p": pa.array([w + str(int(x)) for w, x in
                       zip(d, rng.integers(0, 10**6, n))], pa.string()),
    })


def test_string_functions_on_card_match_cpu():
    """Substring (dictionary and plain), LIKE and string-column equality
    on the card against the same projection on the CPU, and a group-by on
    a cut dictionary column."""
    _card()
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow

    t = _string_table()

    def q(device):
        df = from_arrow(t, batch_rows=2048, device=device)
        cols = []
        for c in ("d", "p"):
            for pos, ln in ((1, 3), (0, 2), (-2, 2), (9, 2), (2, 10**9)):
                cols.append(E.Alias(E.Substring(E.col(c), pos, ln),
                                    f"{c}{pos}_{ln}"))
            for k, pat in enumerate(("ab%", "%x_", "", "a\\%b", "%")):
                cols.append(E.Alias(E.Like(E.col(c), pat), f"{c}like{k}"))
        cols += [E.Alias(E.EqualTo(E.col("d"), E.col("d2")), "dd"),
                 E.Alias(E.EqualTo(E.col("d"), E.col("p")), "dp"),
                 E.Alias(E.lit("chan"), "chan")]
        proj = df.select(*cols).collect()
        grouped = (df.with_column("s", E.Substring(E.col("d"), 2, 3))
                   .group_by("s").agg(E.Alias(E.Count(), "n")).sort("s")
                   .collect())
        return proj, grouped
    assert q("cuda") == q("cpu")


@pytest.mark.parametrize("hashtable", ["true", "false"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_condition_on_card_matches_cpu(how, hashtable):
    _card()
    from spark_rapids_tpu_torch.bench.tpch import rows_match
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow

    rng = np.random.default_rng(17)
    n, m = 20000, 3000
    left = pa.table({"k": pa.array(rng.integers(0, 500, n), pa.int64()),
                     "s": pa.array([f"w{int(x)}" for x in
                                    rng.integers(0, 30, n)]),
                     "v": pa.array(rng.integers(0, 9, n), pa.int64())})
    right = pa.table({"rk": pa.array(rng.integers(0, 600, m), pa.int64()),
                      "rs": pa.array([f"w{int(x)}" for x in
                                      rng.integers(0, 30, m)]),
                      "w": pa.array(rng.integers(0, 9, m), pa.int64())})
    cond = E.And(E.Not(E.EqualTo(E.col("s"), E.col("rs"))),
                 E.LessThan(E.col("v"), E.col("w")))

    def q(device):
        conf = RapidsConf({"spark.rapids.gpu.sql.join.hashTable.enabled":
                           hashtable})
        return from_arrow(left, conf, batch_rows=8192, device=device).join(
            from_arrow(right, conf, device=device), left_on="k",
            right_on="rk", how=how, condition=cond).collect()
    got, exp = q("cuda"), q("cpu")
    assert len(got) == len(exp) and rows_match(got, exp)


@pytest.mark.parametrize("q", ["q5", "q6", "q8", "q10", "q15", "q18", "q19",
                               "q22", "q23", "q24", "q33", "q35", "q45",
                               "q46", "q56", "q60", "q66", "q68", "q71",
                               "q72", "q76", "q77", "q80", "q91", "q95"])
def test_tpcds_union_query_on_card_matches_cpu(q):
    """The union slice's queries on the card against the same query on the
    CPU and on the CPU engine, and the six that join with a condition
    also with the hash table off (the sorted-hash path on the card)."""
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t = S.tables_for(0.1, seed=3, names=Q.TABLES[q])
    if q == "q76":
        t = Q.with_null_promotions(t)
    got = Q.QUERIES[q](Q.df_tables(t, batch_rows=1 << 22, device="cuda")
                       ).to_arrow().to_pylist()
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.check_rows(q, got, exp) == (True, "")
    on_cpu = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda"))
    assert Q.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True, "")
    if q in Q.CONDITION_JOINS:
        off = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
            {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
            batch_rows=1 << 22, device="cuda")).physical_plan()
        assert Q.check_rows(q, execute_to_arrow(off).to_pylist(),
                            got) == (True, "")
        assert "ht" not in join_paths(off)


def _wide_values(n, seed):
    """Seeded signed 128-bit values of every magnitude, as (hi, lo)."""
    from spark_rapids_tpu_torch.exec import int128 as I128

    rng = np.random.default_rng(seed)
    vals = []
    for bits in rng.integers(1, 127, n).tolist():
        v = int(rng.integers(0, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))
        v >>= 126 - bits
        vals.append(-v if rng.random() < 0.5 else v)
    vals[:6] = [0, 1, -1, (1 << 127) - 1, -(1 << 127), 10**38 - 1]
    return I128.from_py_ints(vals)


@pytest.mark.parametrize("fn", ["mul_128_exact", "decimal_divide_128",
                                "decimal_avg_128", "rescale10_checked",
                                "mul_64x64"])
def test_int128_on_card_matches_cpu(fn):
    """The 128-bit arithmetic's torch operations on the card give the
    CPU's bits (shifts, wraparound and floor division included)."""
    _card()
    from spark_rapids_tpu_torch.exec import int128 as I128

    ah, al = _wide_values(20000, 1)
    bh, bl = _wide_values(20000, 2)
    cnt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 31, 20000))

    def run(dev):
        a = (ah.to(dev), al.to(dev))
        b = (bh.to(dev), bl.to(dev))
        if fn == "mul_128_exact":
            return I128.mul_128_exact(*a, *b, 38)
        if fn == "decimal_divide_128":
            return (I128.decimal_divide_128(*a, *b, 20, 38)
                    + I128.decimal_divide_128(*a, *b, 50, 38))
        if fn == "decimal_avg_128":
            return I128.decimal_avg_128(*a, cnt.to(dev), 4, 21)
        if fn == "rescale10_checked":
            return I128.rescale10_checked(*a, 18, 38)
        return I128.mul_64x64(a[1], b[1])
    for g, c in zip(run("cuda"), run("cpu")):
        assert torch.equal(g.cpu(), c)


def test_wide_window_sum_on_card_matches_cpu():
    """A DECIMAL128 window Sum and Average (three add-scans through the
    segmented-scan kernel, joined with carries) on the card against the
    same window on the CPU."""
    _card()
    import decimal

    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.exprs import window as W
    from spark_rapids_tpu_torch.plan import from_arrow

    rng = np.random.default_rng(21)
    n = 300_000
    u = rng.integers(-10**17 + 1, 10**17, n)
    t = pa.table({"g": pa.array(rng.integers(0, 40, n), pa.int64()),
                  "o": pa.array(rng.integers(0, 1000, n), pa.int64()),
                  "m": pa.array([decimal.Decimal(f"{int(x)}E-2") for x in u],
                                pa.decimal128(17, 2))})

    def q(device):
        spec = W.window_spec(partition_by=["g"], order_by=["o"],
                             frame=W.WindowFrame("rows", None, 0))
        full = W.window_spec(partition_by=["g"])
        df = from_arrow(t, batch_rows=1 << 17, device=device)
        return df.with_window(
            W.over(E.Sum(E.col("m")), spec).alias("run"),
        ).with_window(W.over(E.Average(E.col("m")), full).alias("avg")
                      ).sort("g", "o", "run").collect()
    before = PK.KERNEL_LAUNCHES["segscan"]
    got = q("cuda")
    assert PK.KERNEL_LAUNCHES["segscan"] > before
    assert got == q("cpu")


def test_decimal_divide_on_card_matches_cpu():
    """Divide, Abs and UnaryMinus over decimal(17,2) columns (a
    decimal(38,20) quotient, zero divisors) and a double divide by zero on
    the card against the CPU and the CPU engine."""
    _card()
    import decimal

    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow

    rng = np.random.default_rng(5)
    n = 100_000
    a = rng.integers(-10**17 + 1, 10**17, n)
    b = rng.integers(-10**6, 10**6, n)
    b[::97] = 0
    t = pa.table({"a": pa.array([decimal.Decimal(f"{int(x)}E-2") for x in a],
                                pa.decimal128(17, 2)),
                  "b": pa.array([decimal.Decimal(f"{int(x)}E-2") for x in b],
                                pa.decimal128(17, 2)),
                  "x": pa.array(rng.normal(0, 1, n)),
                  "y": pa.array(np.where(b == 0, 0.0, 1.5))})

    def q(device, conf=None):
        return from_arrow(t, RapidsConf(conf or {}), batch_rows=1 << 16,
                          device=device).select(
            E.Divide(E.col("a"), E.col("b")).alias("q"),
            E.Abs(E.Divide(E.col("b"), E.col("a"))).alias("r"),
            E.UnaryMinus(E.col("a")).alias("m"),
            E.Divide(E.col("x"), E.col("y")).alias("f")).collect()
    got = q("cuda")
    assert got == q("cpu")
    assert got == q("cuda", {"spark.rapids.gpu.sql.enabled": "false"})
    assert sum(r["q"] is None for r in got) == sum(b == 0)


@pytest.mark.parametrize("q", ["q2", "q4", "q11", "q12", "q20", "q21",
                               "q31", "q54", "q58", "q59", "q61", "q74",
                               "q75", "q83", "q90", "q98", "q36", "q49",
                               "q51", "q53", "q63", "q1", "q30", "q65",
                               "q81"])
def test_tpcds_decimal_query_on_card_matches_cpu(q):
    """The decimal slice's queries (and q1/q30/q65/q81, whose decimal(21,6)
    averages now run on the device) on the card."""
    _slice_query_on_card(q)


def _slice_query_on_card(q):
    """A slice's query on the card, wholly on the device, against the same
    query on the CPU, on the CPU engine and with the hash table off (the
    sorted-hash path on the card); returns the card's rows."""
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t = S.tables_for(0.1, seed=3, names=Q.TABLES[q])
    df = Q.QUERIES[q](Q.df_tables(t, batch_rows=1 << 22, device="cuda"))
    assert "!" not in df.explain()
    got = df.to_arrow().to_pylist()
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu")).to_arrow().to_pylist()
    assert Q.check_rows(q, got, exp) == (True, "")
    on_cpu = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda"))
    assert Q.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True, "")
    off = Q.QUERIES[q](Q.df_tables(t, RapidsConf(
        {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
        batch_rows=1 << 22, device="cuda")).physical_plan()
    assert Q.check_rows(q, execute_to_arrow(off).to_pylist(), got) == (True,
                                                                     "")
    assert "ht" not in join_paths(off)
    return got


def test_window_rest_on_card_matches_cpu():
    """The window slice's surface on the card (ntile, percent_rank,
    cume_dist, lead/lag with defaults over doubles, decimals, DECIMAL128
    and both string kinds, first/last, bounded ROWS Sum/Min/Max through
    the prefix/suffix min/max scans, bounded RANGE Sum and Max, a
    DECIMAL128 Sum over a bounded frame, a plain-string partition key)
    against the same window on the CPU and on the CPU engine; the
    segmented-scan kernel runs its min and max ops."""
    _card()
    import decimal

    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.exprs import window as W
    from spark_rapids_tpu_torch.plan import from_arrow

    rng = np.random.default_rng(31)
    n = 200_000
    v = rng.normal(0, 10, n)
    v[rng.random(n) < 0.02] = np.nan
    t = pa.table({
        "g": pa.array(rng.integers(0, 500, n), pa.int64()),
        "o": pa.array(rng.integers(0, 400, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.01),
        "v": pa.array(v, pa.float64(), mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "m": pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                       rng.integers(-10**6, 10**6, n)], pa.decimal128(7, 2)),
        "w": pa.array([decimal.Decimal(int(x) * 10**5).scaleb(-2) for x in
                       rng.integers(-10**14, 10**14, n)],
                      pa.decimal128(24, 2)),
        # more distinct values than half the rows: a plain string column
        "s": pa.array([f"store name {k} " + "x" * (k % 13)
                       for k in rng.integers(0, 150_000, n)])})
    seen = []
    real = PK.segmented_scan_kernel

    def spy(values, is_start, op_name="add"):
        seen.append(op_name)
        return real(values, is_start, op_name)

    def q(device, conf=None, part="g"):
        spec = W.window_spec(partition_by=[part], order_by=["o"])
        rows = W.window_spec([part], ["o"], W.WindowFrame("rows", -3, 3))
        rng_ = W.window_spec([part], ["o"], W.WindowFrame("range", -5, 5))
        df = from_arrow(t, RapidsConf(conf or {}), batch_rows=1 << 16,
                        device=device)
        ws = [W.over(f, sp).alias(a) for a, f, sp in (
            ("nt", W.NTile(4), spec), ("pr", W.PercentRank(), spec),
            ("cd", W.CumeDist(), spec),
            ("ld", W.Lead(E.col("v"), 1, E.lit(0.0)), spec),
            ("lg", W.Lag(E.col("m"), 2), spec),
            ("lw", W.Lag(E.col("w"), 1), spec),
            ("ls", W.Lead(E.col("s"), 1, E.lit("none")), spec),
            ("f", E.First(E.col("v")), rows), ("l", E.Last(E.col("i")), rows),
            ("sv", E.Sum(E.col("v")), rows), ("mn", E.Min(E.col("v")), rows),
            ("mx", E.Max(E.col("i")), rows), ("sm", E.Sum(E.col("m")), rows),
            ("sw", E.Sum(E.col("w")), rows),
            ("rs", E.Sum(E.col("i")), rng_), ("rx", E.Max(E.col("m")), rng_))]
        return df.with_window(*ws).collect()

    PK.segmented_scan_kernel = spy
    try:
        got = q("cuda")
        got_s = q("cuda", part="s")
    finally:
        PK.segmented_scan_kernel = real
    assert {"add", "min", "max"} <= set(seen)
    for g, c in ((got, q("cpu")), (got_s, q("cpu", part="s")),
                 (got, q("cuda", {"spark.rapids.gpu.sql.enabled":
                                  "false"}))):
        assert len(g) == len(c) == n
        for a, b in zip(g, c):
            for k, x in a.items():
                y = b[k]
                if isinstance(x, float) and isinstance(y, float):
                    assert (x == y or (x != x and y != y)
                            or abs(x - y) <= 1e-9 * max(1.0, abs(y))), k
                else:
                    assert x == y, k


@pytest.mark.parametrize("q", ["q47", "q57", "q70", "q86", "q89"])
def test_tpcds_window_rest_query_on_card_matches_cpu(q):
    """The window slice's queries on the card, each with values."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    assert Q.informative(_slice_query_on_card(q))


# ---------------------------------------------------------------------------
# partitioned execution: partitioners, the exchange and partitioned plans
# ---------------------------------------------------------------------------


def _partition_table(n=20000, seed=21):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.1
    words = [f"w{i}" for i in range(40)]
    return pa.table({
        "k": pa.array(rng.integers(-1000, 1000, n), pa.int64(), mask=mask),
        "f": pa.array(rng.normal(0, 50, n)),
        "s": pa.array([words[int(i)] for i in rng.integers(0, 40, n)],
                      mask=mask),
    })


@pytest.mark.parametrize("part", ["hash_int", "hash_string", "hash_pair",
                                  "range", "round_robin"])
def test_partition_ids_on_card_match_cpu(part):
    _card()
    from spark_rapids_tpu_torch.shuffle import partition as PP

    t = PB.dictionary_encode_table(_partition_table())
    p = {"hash_int": PP.HashPartitioner([0], 7),
         "hash_string": PP.HashPartitioner([2], 4),
         "hash_pair": PP.HashPartitioner([2, 0], 5),
         "range": PP.RangePartitioner.from_sample(
             np.linspace(-100, 100, 64), 4, 1),
         "round_robin": PP.RoundRobinPartitioner(3, 1)}[part]
    got = p.partition_ids(PB.batch_from_arrow(t, "cuda"))
    assert got.is_cuda
    exp = p.partition_ids(PB.batch_from_arrow(t, "cpu"))
    assert torch.equal(got.cpu(), exp)


@pytest.mark.parametrize("threads", [1, 4])
def test_exchange_on_card_uploads_to_the_card_and_keeps_map_order(
        threads, tmp_path):
    _card()
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.shuffle import partition as PP
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

    t = _partition_table()
    sch = PT.Schema.from_arrow(t.schema)

    def rows(device):
        src = BatchSourceExec([[PB.batch_from_arrow(
            t.slice(i * 5000, 5000), device)] for i in range(4)], sch)
        ex = ShuffleExchangeExec(
            PP.HashPartitioner([2], 3), src,
            manager=ShuffleManager(local_dir=str(tmp_path / device),
                                   writer_threads=threads),
            target_batch_rows=4096)
        out = []
        for p in range(3):
            for b in ex.execute(p):
                assert b.columns[0].device.type == device
                out.append(PB.batch_to_arrow(b, sch).to_pylist())
        return out

    assert rows("cuda") == rows("cpu")


@pytest.mark.parametrize("q", ["q3", "q38", "q47", "q67", "q77", "q93"])
def test_tpcds_partitioned_query_on_card_matches_one_partition(q):
    """TPC-DS queries with 4 source splits and 4 shuffle partitions on the
    card against the same query in one partition on the CPU."""
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = S.tables_for(0.1, seed=3, names=Q.TABLES.get(q, S.BASE_TABLES))
    df = Q.QUERIES[q](Q.df_tables(
        t, RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"}),
        batch_rows=1 << 14, device="cuda", partitions=4))
    assert "!" not in df.explain()
    got = df.to_arrow().to_pylist()
    exp = Q.QUERIES[q](Q.df_tables(t, device="cpu", shuffle_partitions=1)
                       ).to_arrow().to_pylist()
    assert Q.informative(got)
    assert Q.check_rows(q, got, exp) == (True, "")


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_tpch_partitioned_query_on_card_matches_one_partition(q):
    _card()
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = tpch.tables_for(0.1, seed=7)
    got = tpch.DF_QUERIES[q](tpch.df_tables(
        t, RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"}),
        batch_rows=1 << 16, device="cuda", partitions=4)).collect()
    exp = tpch.DF_QUERIES[q](tpch.df_tables(
        t, device="cpu", shuffle_partitions=1)).collect()
    assert len(got) == len(exp) > 0 and tpch.rows_match(got, exp)


def _skewed(n=40000, seed=21):
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.6, 4, rng.integers(0, 4000, n))
    facts = pa.table({"k": pa.array(k, pa.int64()),
                      "v": pa.array(rng.integers(-9, 9, n), pa.int64()),
                      "x": pa.array(rng.normal(0, 1, n))})
    dims = pa.table({"k": pa.array(np.arange(0, 6000, 2), pa.int64()),
                     "w": pa.array(rng.integers(0, 9, 3000), pa.int64())})
    return facts, dims


_SKEW_CONF = {"spark.rapids.gpu.fastpath.enabled": "false",
              "spark.rapids.gpu.sql.join.broadcastRowThreshold": 0,
              "spark.rapids.gpu.sql.adaptive.advisoryPartitionSizeBytes":
                  1 << 16,
              "spark.rapids.gpu.sql.adaptive.skewJoin."
              "skewedPartitionThresholdBytes": 1 << 16}


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v) for _, v in
                                            sorted(r.items())))


@pytest.mark.parametrize("how", ["inner", "left", "left_semi"])
def test_skew_split_join_on_card_matches_cpu(how):
    _card()
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan import from_arrow
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.shuffle import aqe as PA

    facts, dims = _skewed()

    def run(device, extra=None):
        conf = RapidsConf(dict(_SKEW_CONF, **(extra or {})))
        df = from_arrow(facts, conf, batch_rows=10000, device=device,
                        partitions=4).join(
            from_arrow(dims, conf, device=device), on="k", how=how)
        plan = df.physical_plan()
        return plan, execute_to_arrow(plan).to_pylist()

    PK.reset_kernel_launches()
    plan, got = run("cuda")
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] > 0
    readers = [n for n in _walk_plan(plan)
               if isinstance(n, PA.SkewAwareShuffleReadExec)]
    assert len(readers) == 2
    lspecs, rspecs = readers[0].specs(), readers[1].specs()
    assert len(lspecs) == len(rspecs)
    assert any(isinstance(s, PA.PartialReducerPartitionSpec)
               for s in lspecs)
    _, exp = run("cpu")
    _, off = run("cuda", {"spark.rapids.gpu.sql.adaptive.enabled": "false"})
    assert got and _sorted_rows(got) == _sorted_rows(exp) == \
        _sorted_rows(off)


def _walk_plan(node):
    yield node
    for c in node.children:
        yield from _walk_plan(c)


@pytest.mark.parametrize("side_stream", [False, True])
def test_read_ahead_on_card_delivers_card_batches_in_map_order(
        side_stream, tmp_path):
    _card()
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.exec.pipeline import PrefetchExec
    from spark_rapids_tpu_torch.shuffle import partition as PP
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

    t = _partition_table()
    sch = PT.Schema.from_arrow(t.schema)

    def rows(device):
        src = BatchSourceExec([[PB.batch_from_arrow(
            t.slice(i * 5000, 5000), device)] for i in range(4)], sch)
        ex = ShuffleExchangeExec(
            PP.HashPartitioner([2], 3), src,
            manager=ShuffleManager(local_dir=str(tmp_path / device)),
            target_batch_rows=2048)
        assert ex.read_ahead
        node = PrefetchExec(ex, depth=2)
        out = []
        for p in range(3):
            for b in node.execute(p):
                assert b.columns[0].device.type == device
                # a kernel on the consumer's stream reads the batch
                out.append(PB.batch_to_arrow(b, sch).to_pylist())
            if p < 2:
                assert ex._ahead.pending() == {p + 1}
        ex.cleanup()
        return out

    exp = rows("cpu")
    if side_stream:
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            got = rows("cuda")
        stream.synchronize()
    else:
        got = rows("cuda")
    assert got == exp


def test_reused_exchange_replayed_on_card_matches_cpu():
    """A global aggregate read twice: its single-partition exchange is
    read once, through the shared entry, and replayed on the card."""
    _card()
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.plan import from_arrow
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    facts, _ = _skewed(20000, 22)

    def run(device):
        conf = RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})
        d = from_arrow(facts, conf, batch_rows=5000, device=device,
                       partitions=4)
        cte = d.agg(PE.Sum(PE.col("v")).alias("sv"), PE.Count().alias("n"))
        q = cte.select(PE.Alias(PE.col("sv"), "a")).union(
            cte.select(PE.Alias(PE.col("n"), "a")))
        plan = q.physical_plan()
        reused = [n for n in _walk_plan(plan)
                  if isinstance(n, R.ReusedExchangeExec)]
        assert len(reused) == 1 and reused[0].entry is not None
        kept, = [n for n in _walk_plan(plan)
                 if isinstance(n, ShuffleExchangeExec)]
        rows = execute_to_arrow(plan).to_pylist()
        # four map outputs, one block each, read once for both consumers
        assert kept.metrics["shuffleBlocksRead"].value == 4
        return rows, reused[0]

    R.reset_counters()
    got, alias = run("cuda")
    assert R.counters()["reuse_bytes_saved_total"] > 0
    assert alias.metrics["numOutputBatches"].value == 1
    exp, _ = run("cpu")
    assert got == exp and len(got) == 2


# ---------------------------------------------------------------------------
# the memory runtime on the card
# ---------------------------------------------------------------------------


def test_spill_round_trip_of_a_card_batch_through_host_and_disk(tmp_path):
    """A card batch (plain and dictionary strings, DECIMAL128 limbs,
    nulls) spilled to pinned host memory and on to disk comes back on
    the card bit-equal, its dictionary the same object."""
    _card()
    import decimal

    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import spill as MS

    n = 5000
    rng = np.random.default_rng(3)
    t = PB.dictionary_encode_table(pa.table({
        "a": pa.array([None if i % 7 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-10**12, 10**12, n))],
                      pa.int64()),
        "s": pa.array(["x" * int(k) for k in rng.integers(0, 30, n)]),
        "e": pa.array([["n", "s", None, "e"][i % 4] for i in range(n)]),
        "w": pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                       rng.integers(-10**17, 10**17, n)],
                      pa.decimal128(30, 2)),
    }), ["e"])
    b = PB.batch_from_arrow(t, "cuda")
    for codec in ("none", "zlib"):
        pool = MP.HbmPool(1 << 30)
        fw = MS.SpillFramework(pool, host_limit_bytes=1,
                               spill_dir=str(tmp_path), chunk_bytes=1 << 16,
                               codec=codec)
        h = MS.SpillableBatch(b, fw)
        assert fw.spill_device_bytes(1) == h.nbytes
        assert h.state == "DISK" and pool.used == 0
        with h as got:
            assert got.columns[0].data.is_cuda
            for ca, cb in zip(b.columns, got.columns):
                assert torch.equal(ca.data, cb.data)
                assert torch.equal(ca.validity, cb.validity)
                if ca.offsets is not None:
                    assert torch.equal(ca.offsets, cb.offsets)
                assert ca.dictionary is cb.dictionary
        h.close()
        assert pool.used == 0 and not list(tmp_path.iterdir())


def test_capped_hash_join_on_card_matches_uncapped():
    """A shuffled hash join on the card under the least pool that holds
    every handle and every build set it pins (the most its uncapped run
    pinned at once), with a handle of another operator live beside it:
    that older handle spills to the host to make room, no registration
    splits, and the rows equal the uncapped join's and the CPU's."""
    _card()
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import retry as MR
    from spark_rapids_tpu_torch.mem import spill as MS

    tables = tpch.tables_for(0.05, seed=3)
    conf = RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false",
                       "spark.rapids.gpu.sql.join.broadcastRowThreshold": 0})

    def run(device, pool):
        MP.set_pool(pool)
        d = tpch.df_tables(tables, conf, batch_rows=8192, device=device,
                           partitions=4)
        return tpch.DF_QUERIES["q3"](d).to_arrow().to_pylist()

    try:
        exp = run("cpu", MP.HbmPool(1 << 34))
        got = run("cuda", MP.HbmPool(1 << 34))
        c = MS.get_framework().counters()
        need = max(c["max_handle_bytes"], c["max_pinned_bytes"])
        other = PB.batch_from_arrow(tables["orders"].slice(0, 20_000), "cuda")
        pool = MP.HbmPool(need + MS.batch_nbytes(other) // 2)
        MP.set_pool(pool)
        fw = MS.SpillFramework(pool, host_limit_bytes=1 << 30)
        held = MS.SpillableBatch(other, fw)
        MR.STATS.reset()
        capped = run("cuda", pool)
        c = fw.counters()
        state = held.state
        with held as back:
            assert torch.equal(back.columns[0].data, other.columns[0].data)
        held.close()
    finally:
        MP.set_pool(None)
    assert tpch.rows_match(got, exp) and tpch.rows_match(capped, exp)
    assert state == "HOST" and c["spilled_to_host"] > 0
    assert MR.STATS.snapshot()["splits"] == 0
    assert pool.used == 0


@pytest.mark.parametrize("kind", ["running", "bounded", "running_global"])
def test_streaming_window_on_card_matches_streaming_off(kind):
    """A running or bounded window over many card batches, sorted out of
    core (runs pre-merged), against the same window over one batch and
    on the CPU. Partitioned by g, each partition leaves the sort whole in
    one batch (the sort's boundary takes every row of a first key at
    once); ``running_global`` has no partition, so its one partition
    spans every streamed batch and the carry continues across each
    edge."""
    _card()
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.exprs import window as PW
    from spark_rapids_tpu_torch.plan import from_arrow

    n = 200_000
    rng = np.random.default_rng(9)
    t = pa.table({
        "g": pa.array([None if i % 101 == 0 else int(x) for i, x in
                       enumerate(rng.integers(0, 7, n))], pa.int64()),
        "o": pa.array(rng.integers(0, n // 3, n), pa.int64()),
        "v": pa.array([None if i % 13 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-100, 100, n))], pa.int64())})
    sp = PW.WindowSpec((PE.col("g"),) if kind != "running_global" else (),
                       (SortOrder(PE.col("o")),))
    if kind != "bounded":
        fr = PW.WindowSpec(sp.partition_by, sp.order_by,
                           PW.WindowFrame("rows", PW.UNBOUNDED, 0))
        exprs = [PW.WindowExpression(PW.RowNumber(), sp).alias("rn"),
                 PW.WindowExpression(PW.Rank(), sp).alias("rk"),
                 PW.WindowExpression(PW.DenseRank(), sp).alias("dr"),
                 PW.WindowExpression(PE.Sum(PE.col("v")), fr).alias("s"),
                 PW.WindowExpression(PE.Min(PE.col("v")), fr).alias("m")]
    else:
        fr = PW.WindowSpec(sp.partition_by, sp.order_by,
                           PW.WindowFrame("rows", -4, 2))
        exprs = [PW.WindowExpression(PW.Lead(PE.col("v"), 3), sp).alias("l"),
                 PW.WindowExpression(PW.Lag(PE.col("v"), 2), sp).alias("g2"),
                 PW.WindowExpression(PE.Sum(PE.col("v")), fr).alias("s")]

    def run(device, streaming, batch_rows):
        conf = RapidsConf({
            "spark.rapids.gpu.sql.window.streaming.enabled": streaming,
            "spark.rapids.gpu.sql.sort.outOfCore.targetRows": 8192})
        df = from_arrow(t, conf, batch_rows=batch_rows, device=device)
        plan = df.with_window(*exprs).physical_plan()
        from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

        return execute_to_arrow(plan).to_pylist(), plan

    on, plan = run("cuda", True, 4096)
    win = plan
    while type(win).__name__ != "WindowExec":
        win = win.children[0]
    assert win._mode is not None
    if kind == "running_global":
        assert win.metrics["streamedBatches"].value > 1
    assert on == run("cuda", False, 1 << 20)[0]
    assert on == run("cpu", True, 4096)[0]


@pytest.mark.parametrize("kind", ["running", "bounded"])
def test_streaming_window_carries_across_card_batch_edges(kind):
    """Presorted card batches cut so that partitions, peer runs and null
    keys continue across their edges (one-row batches inside peer runs):
    the streaming window equals the single-batch window on the card."""
    _card()
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exec.window import WindowExec
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.exprs import window as PW

    n = 20_000
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, n)
    o = rng.integers(0, n // 5, n)
    o_null = rng.random(n) < 0.03
    order = np.lexsort((o, ~o_null, g, g != 3))
    g, o, o_null = g[order], o[order], o_null[order]
    t = pa.table({
        "g": pa.array([None if x == 3 else int(x) for x in g], pa.int64()),
        "o": pa.array([None if on else int(x) for x, on in zip(o, o_null)],
                      pa.int64()),
        "v": pa.array([None if i % 11 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-100, 100, n))], pa.int64())})
    cuts, i, j = [], 0, 0
    sizes = (1, 1, 700, 3, 2048, 1, 511, 96)
    while i < n:
        cuts.append(t.slice(i, sizes[j % len(sizes)]))
        i, j = i + sizes[j % len(sizes)], j + 1
    sp = PW.WindowSpec((PE.col("g"),), (SortOrder(PE.col("o")),))
    if kind == "running":
        fr = PW.WindowSpec(sp.partition_by, sp.order_by,
                           PW.WindowFrame("rows", PW.UNBOUNDED, 0))
        exprs = [PW.WindowExpression(PW.RowNumber(), sp).alias("rn"),
                 PW.WindowExpression(PW.Rank(), sp).alias("rk"),
                 PW.WindowExpression(PW.DenseRank(), sp).alias("dr"),
                 PW.WindowExpression(PE.Sum(PE.col("v")), fr).alias("s"),
                 PW.WindowExpression(PE.Count(PE.col("v")), fr).alias("c"),
                 PW.WindowExpression(PE.Max(PE.col("v")), fr).alias("m")]
    else:
        fr = PW.WindowSpec(sp.partition_by, sp.order_by,
                           PW.WindowFrame("rows", -3, 2))
        exprs = [PW.WindowExpression(PW.Lead(PE.col("v"), 3), sp).alias("l"),
                 PW.WindowExpression(PW.Lag(PE.col("v"), 2), sp).alias("g2"),
                 PW.WindowExpression(PE.Sum(PE.col("v")), fr).alias("s")]
    schema = PT.Schema.from_arrow(t.schema)

    def run(slices, streaming):
        node = WindowExec(exprs, BatchSourceExec(
            [[PB.batch_from_arrow(x, "cuda") for x in slices]], schema),
            streaming=streaming)
        return [r for b in node.execute(0)
                for r in PB.batch_to_arrow(b, node.output_schema)
                .to_pylist()]

    assert run(cuts, True) == run([t], False)


def _typed_table(n=4000, seed=21):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 100, n).astype(np.float32)
    f[:4] = [np.nan, -0.0, np.inf, 0.0]
    return pa.table({
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                      mask=rng.random(n) < 0.1),
        "h": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "t": pa.array(rng.integers(-4 * 10**15, 4 * 10**15, n), pa.int64(),
                      mask=rng.random(n) < 0.1).cast(
            pa.timestamp("us", tz="UTC")),
        "tm": pa.array(rng.integers(-10**12, 10**12, n), pa.int64()).cast(
            pa.timestamp("ms"))})


def _same_storage(a: pa.Table, b: pa.Table):
    for name in a.column_names:
        x, y = a[name].combine_chunks(), b[name].combine_chunks()
        assert x.type == y.type, name
        assert x.is_valid().equals(y.is_valid()), name
        if pa.types.is_floating(x.type):
            vx = np.asarray(x.fill_null(0)).view(np.int32)
            vy = np.asarray(y.fill_null(0)).view(np.int32)
        else:
            vx = np.asarray(x.cast(pa.int64()).fill_null(0))
            vy = np.asarray(y.cast(pa.int64()).fill_null(0))
        assert np.array_equal(vx, vy), name


def test_typed_ingest_and_arrow_out_on_card():
    """int8, int16, float32 and timestamps (us and ms) onto the card and
    back: each column's own dtype on the card, nulls zeroed, the same
    types and values out (the ms column as microseconds)."""
    _card()
    from spark_rapids_tpu_torch import types as PT

    t = _typed_table()
    b = PB.batch_from_arrow(t, "cuda")
    assert [c.data.dtype for c in b.columns] == [
        torch.int8, torch.int16, torch.float32, torch.int64, torch.int64]
    assert all(c.data.is_cuda for c in b.columns)
    for c in b.columns:
        assert not bool(c.data[~c.validity].bool().any())
    out = PB.batch_to_arrow(b, PT.Schema.from_arrow(t.schema))
    exp = t.set_column(4, "tm", t["tm"].cast(pa.timestamp("us", tz="UTC")))
    _same_storage(out, exp)


def test_typed_spill_round_trip_on_card(tmp_path):
    """A typed card batch spilled to host and disk comes back bit-equal,
    its handle holding each type's element size."""
    _card()
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import spill as MS

    t = _typed_table(5000, 22)
    b = PB.batch_from_arrow(t, "cuda")
    pool = MP.HbmPool(1 << 30)
    fw = MS.SpillFramework(pool, host_limit_bytes=1,
                           spill_dir=str(tmp_path), chunk_bytes=1 << 16)
    h = MS.SpillableBatch(b, fw)
    assert h.nbytes == 5000 * (1 + 2 + 4 + 8 + 8 + 5)
    assert fw.spill_device_bytes(1) == h.nbytes and h.state == "DISK"
    with h as got:
        for ca, cb in zip(b.columns, got.columns):
            assert cb.data.is_cuda and cb.data.dtype == ca.data.dtype
            assert torch.equal(ca.data.view(torch.uint8) if
                               ca.data.dtype == torch.float32 else ca.data,
                               cb.data.view(torch.uint8) if
                               cb.data.dtype == torch.float32 else cb.data)
            assert torch.equal(ca.validity, cb.validity)
    h.close()
    assert pool.used == 0


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_narrow_int_scan_launches_the_kernel(dtype, op):
    """An int8 or int16 scan on the card launches the kernel (widened to
    int32 and narrowed back) and equals the plain version, the add
    wrapping as the narrow type does."""
    _card()
    rng = np.random.default_rng(5)
    n = 3 * 4096 + 17
    info = torch.iinfo(dtype)
    v = torch.from_numpy(rng.integers(info.min, info.max + 1, n)).to(
        dtype).cuda()
    f = torch.from_numpy(rng.random(n) < 0.01).cuda()
    before = PK.KERNEL_LAUNCHES["segscan"]
    k = PK.segmented_scan_kernel(v, f, op)
    torch.cuda.synchronize()
    assert PK.KERNEL_LAUNCHES["segscan"] == before + 1
    assert k.dtype == dtype
    assert torch.equal(k.cpu(), PK.segmented_scan(v.cpu(), f.cpu(), op))


@pytest.mark.parametrize("col", ["b", "h"])
def test_narrow_bounded_rows_minmax_on_card_launches_the_kernel(col):
    """A BYTE/SHORT bounded ROWS Min/Max window on the card: its
    prefix/suffix scans launch the kernel, rows equal the CPU."""
    _card()
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.exprs import window as PW
    from spark_rapids_tpu_torch.plan import from_arrow

    rng = np.random.default_rng(6)
    t = _typed_table(20000, 23).append_column(
        "g", pa.array(rng.integers(0, 7, 20000)))
    t = t.append_column("o", pa.array(np.arange(20000)))
    sp = PW.WindowSpec((PE.col("g"),), (SortOrder(PE.col("o")),),
                       PW.WindowFrame("rows", -10, 3))
    exprs = [PW.WindowExpression(PE.Min(PE.col(col)), sp).alias("mn"),
             PW.WindowExpression(PE.Max(PE.col(col)), sp).alias("mx")]

    def run(device):
        return from_arrow(t, device=device).with_window(*exprs).sort(
            SortOrder(PE.col("o"))).select("o", "mn", "mx").to_arrow()

    before = PK.KERNEL_LAUNCHES["segscan"]
    got = run("cuda")
    assert PK.KERNEL_LAUNCHES["segscan"] > before
    assert got.equals(run("cpu"))


def test_typed_t4_through_the_planner_on_card():
    """T4 (a one-hour RANGE window over a TIMESTAMP order key, a FLOAT
    Sum and Count, ROWS 10 PRECEDING Min/Max of the int8 quantity) on the
    card through the planner: the scans launch, rows equal the CPU and
    the CPU engine."""
    _card()
    from spark_rapids_tpu_torch.bench import typed_sales as TS
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = TS.tables_for(0.05)
    before = PK.KERNEL_LAUNCHES["segscan"]
    df = TS.t4(TS.df_tables(t, device="cuda"))
    assert "!" not in df.explain()
    got = df.to_arrow().to_pylist()
    assert PK.KERNEL_LAUNCHES["segscan"] > before
    for conf in (None, {"spark.rapids.gpu.sql.enabled": "false"}):
        exp = TS.t4(TS.df_tables(t, RapidsConf(conf) if conf else None,
                                 device="cpu")).to_arrow().to_pylist()
        assert TS.check_rows("T4", got, exp) == (True, "")


# ---------------------------------------------------------------------------
# the aggregate family
# ---------------------------------------------------------------------------


def _family_table(n=20000, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.normal(1e6, 3.0, n)
    return pa.table({
        "k": pa.array(rng.integers(0, 37, n), pa.int64()),
        "x": pa.array([None if i % 11 == 0 else float(v)
                       for i, v in enumerate(x)], pa.float64()),
        "y": pa.array([None if i % 13 == 0 else float(v)
                       for i, v in enumerate(2 * x + rng.normal(0, 1, n))],
                      pa.float64()),
        "o": pa.array(rng.integers(0, 500, n), pa.int64()),
        "b": pa.array([None if i % 17 == 0 else bool(v) for i, v in
                       enumerate(rng.integers(0, 2, n))], pa.bool_()),
        "s": pa.array([f"{'p' * 18}{v:04d}" for v in
                       rng.integers(0, 3000, n)], pa.string()),
    })


def _family_aggs():
    from spark_rapids_tpu_torch.exprs import expr as PE

    c = PE.col
    plain = PE.Substring(c("s"), 1, 30)
    return [
        PE.VarianceSamp(c("x")).alias("var_samp"),
        PE.VariancePop(c("x")).alias("var_pop"),
        PE.StddevSamp(c("x")).alias("stddev_samp"),
        PE.StddevPop(c("o")).alias("stddev_pop"),
        PE.Skewness(c("x")).alias("skew"), PE.Kurtosis(c("x")).alias("kurt"),
        PE.Corr(c("x"), c("y")).alias("corr"),
        PE.CovarSamp(c("x"), c("y")).alias("covar_samp"),
        PE.CovarPop(c("x"), c("o")).alias("covar_pop"),
        PE.MinBy(c("x"), c("o")).alias("min_by"),
        PE.MaxBy(c("y"), c("o")).alias("max_by"),
        PE.BoolAnd(c("b")).alias("bool_and"),
        PE.BoolOr(c("b")).alias("bool_or"),
        PE.CountIf(c("b")).alias("count_if"),
        PE.AnyValue(c("o")).alias("any_o"),
        PE.First(c("x")).alias("first_x"), PE.Last(c("s")).alias("last_s"),
        PE.Min(c("s")).alias("min_s"), PE.Max(plain).alias("max_plain"),
        PE.First(plain).alias("first_plain")]


@pytest.mark.parametrize("splits", [1, 4])
def test_aggregate_family_on_card_matches_the_cpu_engine(splits):
    """Every device aggregate of the family on the card (one split, and 4
    splits through the partial/final exchange) against the CPU engine
    and the CPU device path: doubles within relative 1e-9 (the central
    moments about a 1e6 offset keep their digits), the rest exactly."""
    _card()
    from spark_rapids_tpu_torch.bench.tpch import rows_match
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan import from_arrow

    t = _family_table()

    def run(device, conf):
        df = from_arrow(t, RapidsConf(conf), batch_rows=-(-20000 // splits),
                        device=device, partitions=splits)
        q = df.group_by("k").agg(*_family_aggs()).sort("k")
        return q, q.to_arrow().to_pylist()

    fast = {"spark.rapids.gpu.fastpath.enabled": "false"} if splits > 1 \
        else {}
    q, got = run("cuda", fast)
    assert "!" not in q.explain()
    assert len(got) == 37 and all(v is not None for v in got[0].values())
    for device, conf in (("cpu", fast),
                         ("cuda", {"spark.rapids.gpu.sql.enabled": "false"})):
        assert rows_match(got, run(device, conf)[1], rel=1e-9)


def test_variance_windows_on_card_hold_every_scan_against_plain():
    """The variance family over UNBOUNDED, running, bounded ROWS and
    bounded RANGE frames on the card: every segmented-scan call held
    against the plain version on the same inputs, the rows against the
    CPU engine."""
    _card()
    from spark_rapids_tpu_torch.bench.tpch import rows_match
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.exprs import window as PW
    from spark_rapids_tpu_torch.plan import from_arrow

    t = _family_table().append_column("rid", pa.array(np.arange(20000)))
    exprs = []
    for tag, fr in (("unb", PW.WindowFrame("rows", None, None)),
                    ("run", PW.WindowFrame("range", None, 0)),
                    ("rows", PW.WindowFrame("rows", -30, 0)),
                    ("range", PW.WindowFrame("range", -7, 0))):
        order = (SortOrder(PE.col("o")),) + (
            (SortOrder(PE.col("rid")),) if tag == "rows" else ())
        sp = PW.WindowSpec((PE.col("k"),), order, fr)
        exprs += [PW.WindowExpression(PE.VarianceSamp(PE.col("x")),
                                      sp).alias(f"vs_{tag}"),
                  PW.WindowExpression(PE.StddevPop(PE.col("o")),
                                      sp).alias(f"sp_{tag}")]
    calls = []
    real = PK.segmented_scan_kernel

    def checked(values, is_start, op_name="add"):
        k = real(values, is_start, op_name)
        p = PK.segmented_scan(values, is_start, op_name)
        if values.is_floating_point() and op_name == "add":
            run = PK.segmented_scan(values.abs(), is_start, "add")
            tol = PK.segscan_add_tolerance(run, values.numel(), values.dtype)
            assert bool(((k - p).abs() <= tol).all())
        else:
            assert torch.equal(k, p)
        calls.append(op_name)
        return k

    def run(device, conf=None):
        df = from_arrow(t, RapidsConf(conf or {}), device=device)
        out = df
        for i in range(0, len(exprs), 2):
            out = out.with_window(*exprs[i:i + 2])
        return out.sort(SortOrder(PE.col("rid"))).to_arrow().to_pylist()

    before = PK.KERNEL_LAUNCHES["segscan"]
    PK.segmented_scan_kernel = checked
    try:
        got = run("cuda")
    finally:
        PK.segmented_scan_kernel = real
    assert PK.KERNEL_LAUNCHES["segscan"] - before == len(calls) > 0
    assert rows_match(got, run("cpu", {"spark.rapids.gpu.sql.enabled":
                                       "false"}))


def test_capped_s3_on_card_spills_partials_and_reads_them_back(tmp_path):
    """The statistics pass's S3 on the card in 8,192-row batches under the
    least pool its uncapped run's largest handle and pinned set fit: its
    partials spill to host and disk and come back, and the rows equal the
    uncapped run's and the CPU engine's."""
    _card()
    from spark_rapids_tpu_torch.bench import stat_sales as SS
    from spark_rapids_tpu_torch.config import conf as C
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import spill as MS

    t = SS.tables_for(0.05)

    def fresh(conf):
        pool = MP.HbmPool(MP.pool_limit(conf))
        MP.set_pool(pool)
        MS.SpillFramework(pool, host_limit_bytes=C.HOST_SPILL_LIMIT.get(conf),
                          spill_dir=str(tmp_path))
        return pool

    def run(settings, device="cuda"):
        return SS.s3(SS.df_tables(t, RapidsConf(settings), batch_rows=8192,
                                  device=device)).to_arrow().to_pylist()

    try:
        fresh(RapidsConf())
        base = run({})
        c0 = MS.get_framework().counters()
        cap = max(c0["max_handle_bytes"], c0["max_pinned_bytes"])
        settings = {"spark.rapids.gpu.memory.pool.maxBytes": cap,
                    "spark.rapids.gpu.memory.host.spillStorageSize":
                        cap // 16,
                    "spark.rapids.gpu.sql.agg.repartition.targetBytes":
                        cap // 16}
        pool = fresh(RapidsConf(settings))
        got = run(settings)
        c = MS.get_framework().counters()
        assert pool.used == 0
    finally:
        MP.set_pool(None)
        C.set_active(None)
    assert c["spilled_to_host"] > 0 and c["spilled_to_disk"] > 0
    assert c["unspilled"] > 0
    assert SS.check_rows("S3", got, base) == (True, "")
    cpu = run({"spark.rapids.gpu.sql.enabled": "false"}, "cpu")
    assert SS.check_rows("S3", got, cpu) == (True, "")


# ---------------------------------------------------------------------------
# the scalar function families and the string casts
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = ("sqrt", "cbrt", "exp", "log", "sin", "cos", "tan", "cot",
                   "sec", "csc", "asin", "acos", "atan", "sinh", "cosh",
                   "tanh", "asinh", "acosh", "atanh", "degrees", "radians",
                   "hypot", "pow")


def _scalar_edge_table(n=4096):
    """Seeded edge values: each integral type's ends, zero divisors, NaN,
    the infinities, signed zeros, .5 ties, shift counts past the width,
    decimals of both widths, nulls in every column."""
    import decimal

    rng = np.random.default_rng(15)

    def pick(edges, rand):
        vals = np.where(rng.random(n) < 0.3, rng.choice(edges, n), rand)
        return vals

    def nulls(arr, typ):
        return pa.array(arr, typ, mask=rng.random(n) < 0.05)

    i64 = np.array([-2 ** 63, 2 ** 63 - 1, 0, 1, -1, 2 ** 53 + 1, 25, -15],
                   np.int64)
    i32 = np.array([-2 ** 31, 2 ** 31 - 1, 0, 1, -1, 7, -7], np.int32)
    f64 = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, -2.5, 0.125,
                    1.005, 1e300], np.float64)
    return pa.table({
        "i": nulls(pick(i32, rng.integers(-10 ** 6, 10 ** 6, n)).astype(
            np.int32), pa.int32()),
        "j": nulls(pick(np.array([0, -1, 1, 3], np.int32),
                        rng.integers(-50, 50, n)).astype(np.int32),
                   pa.int32()),
        "l": nulls(pick(i64, rng.integers(-2 ** 62, 2 ** 62, n)), pa.int64()),
        "m": nulls(pick(np.array([0, -1, 1, 10], np.int64),
                        rng.integers(-10 ** 9, 10 ** 9, n)), pa.int64()),
        "d": nulls(pick(f64, rng.standard_normal(n) * 100), pa.float64()),
        "e": nulls(pick(np.array([0.0, np.nan, -2.0, 0.5]),
                        rng.standard_normal(n) * 10), pa.float64()),
        "f": nulls(pick(f64[:-1], rng.standard_normal(n)).astype(
            np.float32), pa.float32()),
        "sh": nulls(pick(np.array([-1, 0, 31, 32, 63, 64, 65], np.int32),
                         rng.integers(0, 64, n)).astype(np.int32),
                    pa.int32()),
        "p": pa.array([None if k % 17 == 3 else decimal.Decimal(int(x))
                       .scaleb(-2) for k, x in enumerate(
                           rng.integers(-10 ** 6, 10 ** 6, n))],
                      pa.decimal128(9, 2)),
        "w": pa.array([None if k % 13 == 5 else decimal.Decimal(int(x))
                       .scaleb(-3) for k, x in enumerate(
                           rng.integers(-10 ** 17, 10 ** 17, n))],
                      pa.decimal128(24, 3)),
        "s": nulls(np.array([f"s{x}" for x in rng.integers(0, 50, n)],
                            dtype=object), pa.string()),
    })


def _scalar_exprs():
    from spark_rapids_tpu_torch.exprs import expr as E

    c, lit = E.col, E.lit
    out = [E.IntegralDivide(c("l"), c("m")).alias("div"),
           E.Remainder(c("i"), c("j")).alias("rem"),
           E.Pmod(c("l"), c("m")).alias("pmod"),
           E.Pmod(c("d"), c("e")).alias("pmod_d"),
           E.EqualNullSafe(c("i"), c("j")).alias("ens"),
           E.NullIf(c("s"), lit("s7")).alias("nullif"),
           E.Nvl2(c("i"), c("d"), c("e")).alias("nvl2"),
           E.Greatest(c("p"), c("w")).alias("greatest"),
           E.Least(c("d"), c("e")).alias("least"),
           E.Floor(c("d")).alias("floor"), E.Ceil(c("f")).alias("ceil"),
           E.Rint(c("d")).alias("rint"),
           E.Factorial(c("j")).alias("factorial"),
           E.Signum(c("d")).alias("signum"),
           E.BitwiseXor(c("i"), c("l")).alias("xor"),
           E.BitwiseNot(c("i")).alias("bnot"),
           E.BitCount(c("l")).alias("bitcount"),
           E.BitGet(c("i"), c("sh")).alias("bitget"),
           E.Murmur3Hash(c("l"), c("s"), c("d"), c("p")).alias("hash"),
           E.XxHash64(c("w"), c("f")).alias("xxhash"),
           E.Rand(5).alias("rand")]
    for s in (-2, 0, 2, 5):
        out += [E.Round(c("d"), s).alias(f"round{s}"),
                E.BRound(c("f"), s).alias(f"bround{s}"),
                E.Round(c("l"), -abs(s) - 1).alias(f"round_l{s}")]
    for cls in ("ShiftLeft", "ShiftRight", "ShiftRightUnsigned"):
        out += [getattr(E, cls)(c(x), c("sh")).alias(f"{cls}_{x}")
                for x in ("i", "l")]
    for name in ("Sqrt", "Cbrt", "Exp", "Log", "Log1p", "Sin", "Cos", "Tan",
                 "Cot", "Sec", "Csc", "Asin", "Acos", "Atan", "Sinh",
                 "Cosh", "Tanh", "Asinh", "Acosh", "Atanh", "ToDegrees",
                 "ToRadians"):
        out.append(getattr(E, name)(c("d")).alias(name.lower()))
    out += [E.Sqrt(c("p")).alias("sqrt_p"),
            E.Hypot(c("d"), c("e")).alias("hypot"),
            E.Pow(c("d"), c("e")).alias("pow")]
    return out


def _close(a, b, name):
    import math

    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if name.startswith(_TRANSCENDENTAL) and a != b:
            return (abs(a - b) <= 1e-15 if abs(b) < 1e-3
                    else abs(a - b) <= 1e-12 * abs(b))
    return a == b


def test_scalar_families_on_card_match_the_cpu():
    """Every device class of the scalar families (Rand through the device
    evaluator directly) on the card against the same projection on the
    CPU: exact, the transcendental functions within relative 1e-12."""
    _card()
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import eval as EV
    from spark_rapids_tpu_torch.exprs import expr as E

    t = _scalar_edge_table()
    bound = EV.bind_projection(_scalar_exprs(), T.Schema.from_arrow(t.schema))
    schema = EV.output_schema(bound)
    out = {}
    for device in ("cuda", "cpu"):
        b = PB.batch_from_arrow(PB.dictionary_encode_table(t), device)
        out[device] = PB.batch_to_arrow(EV.project_batch(b, bound),
                                        schema).to_pylist()
    assert len(out["cuda"]) == t.num_rows
    for g, c in zip(out["cuda"], out["cpu"]):
        for k in c:
            assert _close(g[k], c[k], k), (k, g[k], c[k])
    assert E.SCALAR_FUNCTIONS  # the families' classes, all in the list


@pytest.mark.parametrize("layout", ["dict", "plain"])
def test_string_casts_on_card_match_the_cpu(layout):
    """Casts from strings (integers with fractions and signs, doubles in
    every form, dates, timestamps, booleans and junk: a 2^20-row column
    over a 4,000-entry dictionary, and 2^16 plain rows, the CPU's side
    being the slow one) and back to strings, on the card against the CPU:
    exact, doubles within 1 ulp."""
    _card()
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import eval as EV
    from spark_rapids_tpu_torch.exprs import expr as E

    n = 1 << 20 if layout == "dict" else 1 << 16
    rng = np.random.default_rng(20)
    pool_n = 4000 if layout == "dict" else n
    ints = rng.integers(-2 ** 62, 2 ** 62, pool_n)
    floats = rng.standard_normal(pool_n) * 10.0 ** rng.integers(-20, 20,
                                                               pool_n)
    days = rng.integers(-300000, 2900000, pool_n)
    forms = [lambda k: str(ints[k]), lambda k: f" {ints[k] % 1000}.5 ",
             lambda k: repr(float(floats[k])), lambda k: f"{floats[k]:.3e}",
             lambda k: str(np.datetime64(int(days[k]), "D")),
             lambda k: f"{np.datetime64(int(days[k]), 'D')} "
                       f"{k % 24}:{k % 60:02d}:{k % 60:02d}.{k % 999}",
             lambda k: ["true", "N", "yes", "0"][k % 4],
             lambda k: ["", "x1", "1e", "+", "inf", "-NaN"][k % 6]]
    pool = [forms[k % len(forms)](k) for k in range(pool_n)]
    vals = ([pool[k] for k in rng.integers(0, pool_n, n)]
            if layout == "dict" else pool)
    t = pa.table({"s": pa.array(vals, pa.string())})
    enc = PB.dictionary_encode_table(t)
    assert pa.types.is_dictionary(enc.column("s").type) == (layout == "dict")
    exprs = [E.Cast(E.col("s"), getattr(T, x)).alias(x.lower()) for x in (
        "LONG", "INT", "SHORT", "BYTE", "BOOLEAN", "DATE", "TIMESTAMP",
        "DOUBLE", "FLOAT")]
    exprs += [E.Cast(E.Cast(E.col("s"), T.LONG), T.STRING).alias("ls"),
              E.Cast(E.Cast(E.col("s"), T.DATE), T.STRING).alias("ds"),
              E.Cast(E.Cast(E.col("s"), T.TIMESTAMP), T.STRING).alias("ts"),
              E.Cast(E.Cast(E.Cast(E.col("s"), T.LONG),
                            T.DecimalType(30, 4)), T.STRING).alias("ws")]
    bound = EV.bind_projection(exprs, T.Schema.from_arrow(t.schema))
    schema = EV.output_schema(bound)
    got = {}
    for device in ("cuda", "cpu"):
        b = PB.batch_from_arrow(enc, device)
        got[device] = PB.batch_to_arrow(EV.project_batch(b, bound), schema)
    for name in got["cpu"].column_names:
        a, c = got["cuda"].column(name), got["cpu"].column(name)
        if pa.types.is_timestamp(a.type):
            # as microseconds: Python datetimes with a zone are slow to
            # make where pyarrow has no pytz
            a, c = a.cast(pa.int64()), c.cast(pa.int64())
        a, c = a.to_pylist(), c.to_pylist()
        if name in ("double", "float"):
            x = np.array([np.nan if v is None else v for v in a])
            y = np.array([np.nan if v is None else v for v in c])
            assert np.array_equal(np.isnan(x), np.isnan(y))
            typ = np.float32 if name == "float" else np.float64
            ok = ~np.isnan(y) & np.isfinite(y)
            ulp = np.spacing(np.abs(y[ok]).astype(typ)).astype(np.float64)
            assert (np.abs(x[ok] - y[ok]) <= ulp).all(), name
        else:
            assert a == c, name
    assert got["cuda"].column("date").null_count < n


@pytest.mark.parametrize("splits", [1, 4])
def test_scalar_sales_n3_on_card_matches_the_cpu_engine(splits):
    """N3 of the scalar sales pass (hash buckets, rounding, greatest/least,
    the null functions, a left join through the probe kernel) on the card,
    on one split and on four, against the CPU engine."""
    _card()
    from spark_rapids_tpu_torch.bench import scalar_sales as SS
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = SS.tables_for(0.1)
    rows = t["store_sales"].num_rows
    conf = {"spark.rapids.gpu.fastpath.enabled": "false"} if splits > 1 \
        else {}
    PK.reset_kernel_launches()
    d = SS.df_tables(t, RapidsConf(conf), device="cuda", partitions=splits,
                     batch_rows=-(-rows // splits))
    df = SS.n3(d)
    assert "!" not in df.explain()
    got = df.to_arrow().to_pylist()
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] > 0
    cpu = SS.df_tables(t, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                      "false"}), device="cuda")
    assert SS.check_rows("N3", got, SS.n3(cpu).to_arrow().to_pylist()) == (
        True, "")


def _string_family_table(n: int, seed: int = 21) -> pa.Table:
    """n rows of seeded words (ASCII and not, empty, null), a plain
    column and a dictionary one, and integers."""
    rng = np.random.default_rng(seed)
    words = ["hello world", "", "aXbXcXXd", "  pad  ", "abcabcabc", "4142",
             "QUJDRA==", "a,b", "héllo", "日本", "x"]
    pick = rng.integers(0, len(words), n)
    null = rng.random(n) < 0.05
    d = [None if null[i] else words[pick[i]] for i in range(n)]
    p = [None if null[i] else words[pick[i]] + str(i) for i in range(n)]
    return pa.table({"d": pa.array(d, pa.string()), "p": pa.array(p),
                     "n": pa.array(rng.integers(-500, 5000, n), pa.int64())})


def _string_family_exprs(E, s):
    c = E.col(s)
    return [E.Length(c), E.OctetLength(c), E.Upper(c), E.Lower(c),
            E.InitCap(c), E.StringReverse(c), E.StartsWith(c, E.lit("he")),
            E.EndsWith(c, E.lit("d")), E.Contains(c, E.lit("X")),
            E.Concat(c, E.lit("-"), E.col("d")),
            E.ConcatWs(c, E.col("d"), sep="|"), E.StringTrim(c),
            E.StringReplace(c, "X", "YY"), E.StringReplace(c, "abc", "Z"),
            E.StringInstr(c, "X"), E.StringLocate(c, "X", 3),
            E.StringLPad(c, 8, "*-"), E.StringRPad(c, 12, "="),
            E.StringRepeat(c, 2), E.StringTranslate(c, "lXa", "L!"),
            E.SubstringIndex(c, "X", 2), E.SubstringIndex(c, "abc", -2),
            E.Base64(c), E.UnBase64(c), E.Hex(c), E.Unhex(c),
            E.Hex(E.col("n")), E.FindInSet(c, "x,4142,a"),
            E.Overlay(c, E.lit("__"), 2, 3), E.Ascii(c), E.Chr(E.col("n")),
            E.StringLeft(c, 3), E.StringRight(c, 3),
            E.RLike(c, "X+d$|^[a-z]+ w")]


@pytest.mark.parametrize("s", ["d", "p"])
def test_string_family_on_card_matches_the_cpu(s):
    """Every device class of the string family over 2^18 rows on the card
    against the same projection on the CPU, byte for byte."""
    _card()
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import eval as EV
    from spark_rapids_tpu_torch.exprs import expr as E

    t = _string_family_table(1 << 18)
    exprs = [e.alias(f"c{i}") for i, e in
             enumerate(_string_family_exprs(E, s))]
    bound = EV.bind_projection(exprs, T.Schema.from_arrow(t.schema))
    schema = EV.output_schema(bound)
    out = {}
    for device in ("cuda", "cpu"):
        b = PB.batch_from_arrow(PB.dictionary_encode_table(t), device)
        res = PB.batch_to_arrow(EV.project_batch(b, bound), schema)
        out[device] = [c.cast(pa.binary()) if pa.types.is_string(c.type)
                       else c for c in res.columns]
    for i, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        assert g.equals(c), (i, bound[i])


def test_compose_scan_on_card_matches_the_cpu():
    """The segmented compose scan of a random automaton on the card
    against the CPU: 7 uint8 states over 2^22 bytes, 260 int32 states over
    2^16."""
    _card()
    from spark_rapids_tpu_torch.exprs.segscan import (exclusive_states,
                                                      segmented_compose)

    rng = np.random.default_rng(22)
    for states, dtype, n in ((7, torch.uint8, 1 << 22),
                             (260, torch.int32, 1 << 16)):
        fns = torch.from_numpy(rng.integers(0, states, (n, states)).astype(
            np.int64)).to(dtype)
        resets = torch.from_numpy(rng.random(n) < 1 / 40)
        resets[0] = True
        got = segmented_compose(fns.cuda(), resets.cuda(), 512)
        exp = segmented_compose(fns, resets, 512)
        assert torch.equal(got.cpu(), exp)
        assert torch.equal(exclusive_states(got, resets.cuda(), 3).cpu(),
                           exclusive_states(exp, resets, 3))


def test_string_sales_g1_and_g5_on_card_match_the_cpu_engine():
    """G1 (the dictionary path through the probe kernel) and G5 (windows
    over a projected string partition through the scan kernel) of the
    string sales pass at SF 0.1 on the card against the CPU engine."""
    _card()
    from spark_rapids_tpu_torch.bench import string_sales as G
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = G.tables_for(0.1)
    d = G.df_tables(t, device="cuda")
    cpu = G.df_tables(t, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                     "false"}), device="cuda")
    for q, kernel in (("G1", "hashtbl_probe"), ("G5", "segscan")):
        PK.reset_kernel_launches()
        got = G.QUERIES[q](d).to_arrow().to_pylist()
        assert PK.KERNEL_LAUNCHES[kernel] > 0, q
        exp = G.QUERIES[q](cpu).to_arrow().to_pylist()
        assert G.check_rows(q, got, exp) == (True, ""), q


def _checked_kernels(monkeypatch):
    """Wrap both kernel wrappers so that every call on the card is held
    against its plain version on the same inputs; the calls checked."""
    calls = {"probe": 0, "scan": 0}
    real_probe, real_scan = PK.probe_hash_table_kernel, \
        PK.segmented_scan_kernel

    def probe(tbl, h1, h2, capacity, seed, max_probes):
        ks, kh = real_probe(tbl, h1, h2, capacity, seed, max_probes)
        ps, ph = PK.probe_hash_table(tbl, h1, h2, capacity, seed,
                                     max_probes)
        assert torch.equal(ks, ps) and torch.equal(kh, ph)
        calls["probe"] += 1
        return ks, kh

    def scan(values, is_start, op_name="add"):
        k = real_scan(values, is_start, op_name)
        p = PK.segmented_scan(values, is_start, op_name)
        if values.is_floating_point():
            torch.testing.assert_close(k, p, rtol=1e-9, atol=1e-6)
        else:
            assert torch.equal(k, p)
        calls["scan"] += 1
        return k

    monkeypatch.setattr(PK, "probe_hash_table_kernel", probe)
    monkeypatch.setattr(PK, "segmented_scan_kernel", scan)
    return calls


def test_nested_sales_h1_h4j_h6_kernels_on_card(monkeypatch):
    """The nested sales pass at SF 0.1 on the card: H1's probe over the
    exploded items, H4J's probe on BINARY keys and H6's scans, every call
    held against the plain version, the rows against pyarrow (H1) and the
    CPU engine."""
    _card()
    from spark_rapids_tpu_torch.bench import nested_sales as NS
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t = NS.tables_for(0.1)
    calls = _checked_kernels(monkeypatch)
    PK.reset_kernel_launches()
    assert NS.h1_rows(t, "cuda") == NS.arrow_h1(t)
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] > 0 and calls["probe"] > 0
    d = NS.df_tables(t, device="cuda")
    cpu = NS.df_tables(t, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                      "false"}), device="cuda")
    for q, kernel in (("H4J", "hashtbl_probe"), ("H6", "segscan"),
                      ("H3", None), ("H2", None), ("H4G", None)):
        PK.reset_kernel_launches()
        got = NS.QUERIES[q](d).to_arrow().to_pylist()
        if kernel:
            assert PK.KERNEL_LAUNCHES[kernel] > 0, q
        exp = NS.QUERIES[q](cpu).to_arrow().to_pylist()
        assert NS.check_rows(q, got, exp) == (True, ""), q
    assert calls["scan"] > 0


def _parquet_files(tmp_path, seed=21):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(3):
        n = 3000 + i * 100
        t = pa.table({
            "a": pa.array(rng.integers(0, 50, n), pa.int64()),
            "s": pa.array([f"s{j % 7}" if j % 11 else None
                           for j in range(n)]),
            "d": pa.array(rng.normal(size=n))})
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(t, p, row_group_size=700)
        paths.append(p)
    return paths


@pytest.mark.parametrize("reader_type",
                         ["PERFILE", "MULTITHREADED", "COALESCING"])
def test_parquet_scan_on_card_matches_its_cpu_run(tmp_path, reader_type):
    """Each reader type uploads its chunks to the card (the staging
    worker on the consumer's stream), rows equal to the same scan on the
    CPU; pruning counts equal."""
    _card()
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
    from spark_rapids_tpu_torch.exprs import expr as PE

    paths = _parquet_files(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        node = ParquetScanExec(paths, reader_type=reader_type,
                               predicate=PE.col("a") >= 0, n_partitions=2,
                               target_batch_rows=1000, device=dev)
        rows = []
        for p in range(node.num_partitions()):
            for b in node.execute(p):
                if dev == "cuda":
                    assert b.columns[0].data.is_cuda
                rows.extend(PB.batch_to_arrow(
                    b, node.output_schema).to_pylist())
        out[dev] = (rows, {k: node.metrics[k].value for k in (
            "numRowGroups", "numPrunedRowGroups")})
    assert out["cuda"] == out["cpu"]
    assert len(out["cuda"][0]) == 9300


def test_write_columnar_of_card_batches_reads_back_equal(tmp_path):
    _card()
    import glob

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.io import write_columnar

    rng = np.random.default_rng(3)
    n = 50_000
    t = pa.table({"k": pa.array([f"g{int(x)}" for x in
                                 rng.integers(0, 4, n)]),
                  "v": pa.array(rng.integers(0, 100, n), pa.int64()),
                  "x": pa.array(rng.normal(size=n))})
    enc = PB.dictionary_encode_table(t)
    cache = {}
    batches = [PB.batch_from_arrow(enc.slice(i, 8192), "cuda",
                                   dict_cache=cache)
               for i in range(0, n, 8192)]
    schema = PT.Schema.from_arrow(t.schema)
    st = write_columnar(iter(batches), schema, str(tmp_path / "plain"))
    assert st.num_rows == n and st.num_files == 1
    files = glob.glob(str(tmp_path / "plain" / "*.parquet"))
    back = pq.read_table(files[0])
    assert back.equals(t)
    st = write_columnar(iter(batches), schema, str(tmp_path / "part"),
                        partition_by=["k"])
    assert st.num_partitions == 4 and st.num_rows == n


def test_parquet_q3_probe_calls_equal_plain_on_card(tmp_path, monkeypatch):
    """q3 over Parquet files written from card batches (SF 0.1, store_sales
    clustered by date in 16,384-row row groups): rows equal the CPU
    engine's, every probe call equal to the plain version, a row group
    pruned dynamically."""
    _card()
    from spark_rapids_tpu_torch.bench import parquet_sales as PSales
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    paths, _ = PSales.write_tables(S.tables_for(0.1), str(tmp_path), "cuda",
                                   batch_rows=16384, rows_per_file=65536)
    calls = _checked_kernels(monkeypatch)
    PK.reset_kernel_launches()
    plan = Q.QUERIES["q3"](PSales.df_tables(paths, device="cuda")) \
        .physical_plan()
    got = execute_to_arrow(plan).to_pylist()
    assert PK.KERNEL_LAUNCHES["hashtbl_probe"] > 0
    assert calls["probe"] >= PK.KERNEL_LAUNCHES["hashtbl_probe"]
    stack, dyn = [plan], 0
    while stack:
        n = stack.pop()
        stack.extend(n.children)
        if isinstance(n, ParquetScanExec):
            dyn += n.metrics["numDynPrunedRowGroups"].value
    assert dyn >= 1
    cpu = PSales.df_tables(paths, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    exp = Q.QUERIES["q3"](cpu).to_arrow().to_pylist()
    assert Q.check_rows("q3", got, exp) == (True, "")


# -- the lakehouse slice: clustering, runtime filters, Expand, Delta and the
# plan memo on the card ----------------------------------------------------

def _lake_table(n=300_001, seed=21):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array([None if x % 17 == 0 else int(x)
                       for x in rng.integers(0, 5000, n)], pa.int64()),
        "b": pa.array(rng.normal(size=n)),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 300, n)]),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())})


def test_bloom_zorder_and_hilbert_on_card_equal_the_cpu():
    _card()
    from spark_rapids_tpu_torch.exec import bloom, zorder

    t = _lake_table()
    gb, cb = PB.batch_from_arrow(t, "cuda"), PB.batch_from_arrow(t, "cpu")
    bits = bloom.build_bloom_filter(gb, (0, 2), 1 << 20, 3)
    cbits = bloom.build_bloom_filter(cb, (0, 2), 1 << 20, 3)
    assert bits.is_cuda and torch.equal(bits.cpu(), cbits)
    mask = bloom.might_contain(gb, (0, 2), bits, 1 << 20, 3)
    assert torch.equal(mask.cpu(), bloom.might_contain(cb, (0, 2), cbits,
                                                       1 << 20, 3))
    assert bool(mask.all())
    for cols in ((0, 1), (1, 2, 3)):
        z = zorder.interleave_bits(gb, cols)
        assert z.is_cuda and torch.equal(z.cpu(),
                                         zorder.interleave_bits(cb, cols))
    for curve in ("z", "hilbert"):
        o = zorder.zorder_sort_indices(gb, (0, 2), curve)
        assert torch.equal(o.cpu(),
                           zorder.zorder_sort_indices(cb, (0, 2), curve))
    h = zorder.hilbert_index(gb, (1, 3))
    assert torch.equal(h.cpu(), zorder.hilbert_index(cb, (1, 3)))


def test_expand_rollup_on_card_equals_the_cpu():
    _card()
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.exec.expand import ExpandExec
    from spark_rapids_tpu_torch.exprs import expr as E

    t = _lake_table(100_000)
    enc = PB.dictionary_encode_table(t)
    none = E.lit(None, PT.STRING)
    projections = [[E.col("s"), E.col("v"), E.Alias(E.lit(0), "g")],
                   [E.Alias(none, "s"), E.col("v"), E.Alias(E.lit(1), "g")],
                   [E.Alias(none, "s"), E.col("a"), E.Alias(E.lit(3), "g")]]
    out = {}
    for dev in ("cuda", "cpu"):
        src = BatchSourceExec([[PB.batch_from_arrow(enc, dev, dict_cache={})]],
                              PT.Schema.from_arrow(t.schema))
        node = ExpandExec(projections, src)
        out[dev] = pa.concat_tables(PB.batch_to_arrow(b, node.output_schema)
                                    for b in node.execute_all())
    assert out["cuda"].num_rows == 3 * t.num_rows
    assert out["cuda"].equals(out["cpu"])


def test_delta_delete_mask_on_card(tmp_path):
    """A Delta DELETE whose predicate is evaluated on the card: the same
    deletion vectors, snapshot and rows as the run on the CPU."""
    _card()
    from spark_rapids_tpu_torch.delta import DeltaTable
    from spark_rapids_tpu_torch.delta.log import read_dv
    from spark_rapids_tpu_torch.exprs import expr as E

    t = _lake_table(50_000)
    cond = E.And(E.LessThan(E.col("a"), E.lit(100)),
                 E.Like(E.col("s"), "s1%"))
    state = {}
    for dev in ("cuda", "cpu"):
        dt = DeltaTable.create(str(tmp_path / dev), t.slice(0, 25_000),
                               device=dev)
        dt.append(t.slice(25_000))
        assert dt.device.type == dev
        dt.delete(cond)
        snap = dt.log.snapshot()
        dvs = sorted(read_dv(dt.path, f.deletion_vector).tolist()
                     for f in snap.files if f.deletion_vector)
        dt.update(E.GreaterThan(E.col("v"), E.lit(990)),
                  {"b": E.lit(0.0)})
        after = dt.log.snapshot()
        state[dev] = (snap.num_records, dvs, after.version,
                      after.num_records,
                      sorted(dt.to_arrow().to_pylist(), key=repr))
    assert state["cuda"] == state["cpu"]
    assert state["cuda"][1] and state["cuda"][0] < t.num_rows


def test_plan_memo_hit_on_card():
    """A repeat of a query on the card is served the memoised tree, and
    its rows equal the first run's."""
    _card()
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.plan import from_arrow, plan_cache

    tables = S.tables_for(0.1)
    d = {n: from_arrow(t, device="cuda") for n, t in tables.items()}
    c0 = plan_cache.counters()
    first = Q.QUERIES["q3"](d).to_arrow()
    plan = Q.QUERIES["q3"](d).physical_plan()
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    second = execute_to_arrow(plan)
    c1 = plan_cache.counters()
    assert c1["plan_cache_miss_total"] - c0["plan_cache_miss_total"] == 1
    assert c1["plan_cache_hit_total"] - c0["plan_cache_hit_total"] == 1
    assert second.equals(first)
    assert Q.QUERIES["q3"](d).physical_plan() is plan


def test_an_idle_memoised_tree_holds_no_device_memory_on_card():
    """While a broadcast join's tree sits idle in the plan memo, the
    card's allocated memory is back at its level before the run: the
    tree dropped its broadcast build and its hash table when the run
    ended."""
    _card()
    import gc

    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow, plan_cache
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    rng = np.random.default_rng(31)
    n, m = 1 << 20, 1 << 14
    facts = pa.table({"k": pa.array(rng.integers(0, m, n), pa.int64()),
                      "v": pa.array(rng.integers(-500, 500, n), pa.int64())})
    dims = pa.table({"k": pa.array(np.arange(m), pa.int64()),
                     "w": pa.array(rng.integers(0, 64, m), pa.int64())})
    conf = RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})

    def query():
        left = from_arrow(facts, conf=conf, batch_rows=1 << 18,
                          device="cuda", partitions=4)
        return (left.join(from_arrow(dims, conf=conf, device="cuda"),
                          on="k")
                .group_by("w").agg(E.Alias(E.Sum(E.col("v")), "s")))

    warm = query().to_arrow().sort_by("w")  # the first run's one-off state
    plan_cache.clear()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    plan = query().physical_plan()
    assert any(isinstance(x, BroadcastHashJoinExec)
               for x in _walk_plan(plan))
    assert execute_to_arrow(plan).sort_by("w").equals(warm)
    del plan
    gc.collect()
    torch.cuda.synchronize()
    assert plan_cache.counters()["plan_cache_size"] == 1
    assert torch.cuda.memory_allocated() == base
