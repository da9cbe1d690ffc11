"""Peak device memory of the partitioned queries on the card.

    python -m spark_rapids_tpu_torch.bench.peak_memory [--sf 2.0]
        [--sf-ds 1.0] [--out PATH.json]

Runs the queries of ``chip_smoke.py``'s partitioned phase as it runs
them, every setting at its default: TPC-H Q1/Q3/Q5/Q6 (tables from seed
0 in batches of 2^20 rows) and its twelve TPC-DS queries (``DS_QUERIES``,
batches of 2^19 rows), with 4 source splits and 4 shuffle partitions.
Each runs once to upload its tables, then once with the card's peak
counter reset. Prints per query the bytes allocated before the counted
run (the uploaded tables), the peak during it above that, and the
batches and bytes the plan's broadcast builds (``ReplayExec``) hold
after it. The counted run's plan is built with the plan memo off: a
memoised tree drops its builds when its run ends. Run it from the root of the tree to measure (``python -m``
imports the package of the working directory).

Needs a CUDA card: it fails rather than measure the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

TPCH_QUERIES = ("q1", "q3", "q5", "q6")
DS_QUERIES = ("q3", "q7", "q42", "q52", "q96", "q67", "q47", "q93", "q97",
              "q38", "q16", "q77")


def measure(frame, queries) -> dict:
    """``queries``: name -> query over ``frame``."""
    import torch

    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.dpp import ReplayExec
    from spark_rapids_tpu_torch.exec.reuse import batch_nbytes
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import Overrides

    out = {}
    for q, query in queries.items():
        query(frame).to_arrow()  # uploads the tables it reads
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        df = query(frame)
        conf = RapidsConf(dict(df.conf._values if df.conf is not None
                               else {},
                               **{"spark.rapids.gpu.plan.cache.enabled":
                                  False}))
        plan = Overrides(conf, df.shuffle_partitions).apply(df.plan)
        rows = execute_to_arrow(plan).num_rows
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        stack, held, builds, batches = [plan], 0, 0, 0
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            done = n.materialized() if isinstance(n, ReplayExec) else None
            if done is not None:
                builds += 1
                batches += sum(len(p) for p in done)
                held += sum(batch_nbytes(b) for p in done for b in p)
        out[q] = {"rows": rows, "allocated_before_bytes": base,
                  "peak_above_bytes": peak - base, "replay_builds": builds,
                  "replay_batches": batches, "replay_held_bytes": held}
        print(f"{q}: {rows} rows; allocated before {base} B, peak above "
              f"{peak - base} B; {builds} broadcast builds hold {batches} "
              f"batches, {held} B", flush=True)
        del plan
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=2.0,
                    help="TPC-H scale factor")
    ap.add_argument("--sf-ds", type=float, default=1.0,
                    help="TPC-DS scale factor")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("peak_memory: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S
    from spark_rapids_tpu_torch.bench import tpch

    h = tpch.df_tables(tpch.tables_for(args.sf, seed=0), batch_rows=1 << 20,
                       device="cuda", partitions=4)
    res = {"device": torch.cuda.get_device_name(0), "sf": args.sf,
           "sf_ds": args.sf_ds,
           "tpch": measure(h, {q: tpch.DF_QUERIES[q] for q in TPCH_QUERIES})}
    del h
    ds = Q.df_tables(S.tables_for(args.sf_ds, seed=0, names=S.ALL_TABLES),
                     batch_rows=1 << 19, device="cuda", partitions=4)
    res["tpcds"] = measure(ds, {q: Q.QUERIES[q] for q in DS_QUERIES})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
