"""The nested sales pass (``bench/nested_sales.py``) at SF 0.01 on the
CPU: H1 (posexplode, the hash join exec and the aggregate composed as
exec nodes) against pyarrow's list kernels; H2-H6 on the port's device
path against its CPU engine, H3 also against Python's ``json``; the
placement of H3R's rejected path and of H5's CPU-engine classes; H7: H2,
H4G and H4J with 4 splits and 4 shuffle partitions against one
partition.

Tolerance: ``check_rows``'s (doubles within relative 1e-6, everything
else exact, ORDER BY order).
"""

import pytest
import torch

from spark_rapids_tpu_torch.bench import nested_sales as NS
from spark_rapids_tpu_torch.config.conf import RapidsConf

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

_T = {}


def tables():
    if "t" not in _T:
        _T["t"] = NS.tables_for(0.01)
    return _T["t"]


def test_tickets_hold_every_basket():
    t = tables()
    tk = t["tickets"]
    assert tk.num_rows == len(set(t["lines"].column("ss_ticket_number")
                                  .to_pylist()))
    assert sum(len(x) for x in tk.column("items").to_pylist()) == \
        t["lines"].num_rows
    heads = tk.column("head").to_pylist()
    assert 0 < sum(h["customer_sk"] is None for h in heads) < len(heads)
    assert len(set(tk.column("basket_id").to_pylist())) == tk.num_rows


def test_h1_matches_pyarrow_list_kernels():
    got = NS.h1_rows(tables(), "cpu")
    assert got == NS.arrow_h1(tables())
    assert sum(r["n"] for r in got) == tables()["lines"].num_rows


def _off(df):
    return [ln.strip() for ln in df.explain().splitlines()
            if ln.lstrip().startswith("!")]


PLACED = {
    "H3R": ["json path '$.lines[*].item' not on device"],
    "H5": ["expression CollectList not on device",
           "expression CollectSet not on device",
           "expression MapValues not on device",
           "expression JsonToStructsText not on device"],
}


@pytest.mark.parametrize("q", sorted(NS.QUERIES))
def test_query_on_both_engines(q):
    t = tables()
    dev = NS.df_tables(t, device="cpu")
    cpu = NS.df_tables(t, RapidsConf({"spark.rapids.gpu.sql.enabled":
                                      "false"}), device="cpu")
    df = NS.QUERIES[q](dev)
    off = _off(df)
    if q in PLACED:
        assert all(any(r in ln for ln in off) for r in PLACED[q]), off
    else:
        assert off == []
    got = df.to_arrow().to_pylist()
    exp = NS.QUERIES[q](cpu).to_arrow().to_pylist()
    assert NS.check_rows(q, got, exp) == (True, "")
    if q in ("H3", "H3R"):
        assert NS.check_rows(q, got, NS.json_h3(t, q == "H3R")) == (True,
                                                                    "")


@pytest.mark.parametrize("q", NS.PARTITIONED)
def test_four_splits_equal_one_partition(q):
    t = tables()
    one = NS.df_tables(t, device="cpu")
    four = NS.df_tables(t, RapidsConf(NS.H7_CONF), device="cpu",
        partitions=4, shuffle_partitions=4,
        batch_rows=-(-t["tickets"].num_rows // 4))
    df = NS.QUERIES[q](four)
    assert "HashPartitioner(4)" in df.physical_plan().explain()
    assert NS.check_rows(q, df.to_arrow().to_pylist(),
                         NS.QUERIES[q](one).to_arrow().to_pylist()) == (
        True, "")
