"""Compare ``chip_smoke.py --out`` records: per cell, the sums of the
queries' warm walls (medians), first-run walls and planning times, then
each record's whole run and plan-memo counts.

    python -m spark_rapids_tpu_torch.bench.smoke_compare A.json B.json
"""

from __future__ import annotations

import argparse
import json

CELLS = ("tpcds_headline", "tpcds_joins", "tpcds_breadth", "tpcds_union",
         "tpcds_decimal", "partitioned")


def cell_sums(record: dict) -> dict:
    out = {}
    for cell in CELLS:
        queries = record.get(cell) or {}
        sums = {"warm_s": 0.0, "first_s": 0.0, "plan_s": 0.0}
        for q in queries.values():
            if not isinstance(q, dict):
                continue
            for k in sums:
                if isinstance(q.get(k), (int, float)):
                    sums[k] += q[k]
        out[cell] = sums
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("records", nargs="+")
    args = ap.parse_args(argv)
    recs = [json.load(open(p)) for p in args.records]
    sums = [cell_sums(r) for r in recs]
    for cell in CELLS:
        for k in ("warm_s", "first_s", "plan_s"):
            vals = " ".join(f"{s[cell][k]:.3f}" for s in sums)
            print(f"{cell:16s} {k:8s} {vals}")
    for path, r in zip(args.records, recs):
        print(f"{path}: total_s {r.get('total_s')}, "
              f"plan_memo {r.get('plan_memo')}")


if __name__ == "__main__":
    main()
