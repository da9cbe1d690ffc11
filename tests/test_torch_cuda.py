"""Tests of the port that need a CUDA card (marker ``cuda``); they skip
where there is none: the probe and segmented-scan kernels against their
plain versions on the card, and TPC-H Q3 and TPC-DS q44/q67 on the card
against the same queries on the CPU. This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

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
        PK.segmented_scan_kernel(torch.zeros(8, dtype=torch.int16,
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
