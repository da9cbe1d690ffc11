"""Planning cost on the host: for TPC-DS queries over in-memory tables,
the plan memo's key (``plan_cache.build_key``), a full planning with the
memo off (``Overrides.apply``) and a memo hit, each the median of
``--reps`` host-clock timings in milliseconds.

    python -m spark_rapids_tpu_torch.bench.plan_cost [--sf 0.01]
        [--device cpu] [--queries q3,q64,q75] [--reps 5]

Planning runs on the host whatever the device; ``--device`` only places
the tables (``cuda`` uploads them once, at the first planning).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

DEFAULT_QUERIES = ("q3", "q7", "q2", "q4", "q11", "q14", "q23", "q24",
                   "q47", "q64", "q75", "q78", "q95")


def plan_costs(frames, queries, reps: int = 5) -> dict:
    """{query: {"key_ms", "plan_ms", "hit_ms"}} over ``frames``
    (``tpcds_queries.df_tables``)."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan import plan_cache
    from spark_rapids_tpu_torch.plan.dataframe import finish_run
    from spark_rapids_tpu_torch.plan.overrides import Overrides

    on = RapidsConf()
    off = RapidsConf({"spark.rapids.gpu.plan.cache.enabled": False})

    def ms(fn):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    out = {}
    for q in queries:
        plan = Q.QUERIES[q](frames).plan

        def hit():
            finish_run(Overrides(on, 4).apply(plan), True)
        hit()  # the miss that stores it
        out[q] = {"key_ms": ms(lambda: plan_cache.build_key(plan, on, 4,
                                                            [])),
                  "plan_ms": ms(lambda: finish_run(
                      Overrides(off, 4).apply(plan), True)),
                  "hit_ms": ms(hit)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--queries", default=",".join(DEFAULT_QUERIES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    torch.set_num_threads(1)
    tables = S.tables_for(args.sf, names=S.ALL_TABLES)
    frames = Q.df_tables(tables, device=args.device)
    res = plan_costs(frames, args.queries.split(","), args.reps)
    for q, r in res.items():
        print(f"{q}: key {r['key_ms']:.2f} ms, planning {r['plan_ms']:.2f} "
              f"ms, hit {r['hit_ms']:.2f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
