"""Tests of the port that need a CUDA card (marker ``cuda``); they skip
where there is none. This file imports no JAX, so it also runs on a
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
