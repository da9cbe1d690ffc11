"""Where the time of the port's main-path queries goes on the card.

    python -m spark_rapids_tpu_torch.bench.profile_tpch [--suite tpch]
        [--sf 2.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch --suite tpcds
        [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch --suite tpcds_joins
        [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch --suite tpcds_breadth
        [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch --suite tpcds_union
        [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch --suite tpcds_decimal
        [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch \
        --suite tpcds_window_rest [--sf 1.0] [--out PATH.json]
    python -m spark_rapids_tpu_torch.bench.profile_tpch \
        --suite streaming_windows [--sf 1.0] [--out PATH.json]

``--suite tpch`` profiles TPC-H Q1/Q3/Q5/Q6 (default SF 2), ``--suite
tpcds`` the TPC-DS half of ``bench.py``'s headline, q3/q7/q42/q52/q96, in
batches of 2^22 rows as ``bench.py`` runs them, and the window queries
q44/q67 in batches of 2^20 rows (default SF 1, decimal(7,2) money
columns), ``--suite tpcds_joins`` the joins slice's q9/q28/q40/q43/q87/
q88/q93/q97 in batches of 2^22 rows (default SF 1), ``--suite
tpcds_breadth`` the breadth slice's 33 queries (``tpcds_queries.BREADTH``)
the same way, each with the nodes its plan places on the CPU engine
(``cpu_nodes``, from ``explain``), and ``--suite tpcds_union`` the union
slice's 25 queries (``tpcds_queries.UNION_SLICE``) the same way (q23 and
q24 collect their threshold inside each run), and ``--suite
tpcds_decimal`` the decimal slice's 21 queries
(``tpcds_queries.DECIMAL_SLICE``: Divide and DECIMAL128 on the device)
and q1/q30/q65/q81 (their decimal(21,6) averages now on the device) the
same way, and ``--suite tpcds_window_rest`` the window slice's five
(``tpcds_queries.WINDOW_SLICE``: window averages partitioned by plain
strings, ranks over sums) the same way, and ``--suite
streaming_windows`` the three window groups of ``chip_smoke.py``'s phase 15
(``tpcds_queries.streaming_windows``) over store_sales in batches of
2^17 rows, each streaming (an out-of-core sort under a streaming window)
and with ``spark.rapids.gpu.sql.window.streaming.enabled`` false (the
partition coalesced into one batch). For each query (after
one warm-up run): the warm wall time (host clock around a run that ends in
a synchronise, median of 3), then one run under ``torch.profiler`` giving
the device time summed over kernels and copies, the host-to-device copy
time within it, the device's busy and idle share of that run's wall time,
the number of kernel launches and of copies, the host syncs (the
``cudaStreamSynchronize`` calls the host made: each read of a device value
waits for one), and the operations that took the most device time and the
most host time. The hand-written kernels' launches come from the port's
own counters. ``--hash-table off`` runs every join on the sorted-hash
path. ``string_hash_power_table_bytes`` is what the device cache of
the string hash's power tables holds after the query (it only grows).

Needs a CUDA card: it fails rather than measure the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def device_events(prof):
    """(name, microseconds) of every event that ran on the card: kernels
    and copies, one stream after another."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            out.append((e.name, float(e.time_range.end - e.time_range.start)))
    return out


def profile_query(run, reps: int = 3) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.exec import kernels as K

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    before = dict(K.KERNEL_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    hand_launches = {k: K.KERNEL_LAUNCHES[k] - before[k]
                     for k in K.KERNEL_LAUNCHES}
    kernel_us, h2d_us, launches, copies = 0.0, 0.0, 0, 0
    by_name: dict = {}
    for name, us in device_events(prof):
        kernel_us += us
        low = name.lower()
        if "memcpy" in low or "memset" in low:
            copies += 1
            if "htod" in low:
                h2d_us += us
        else:
            launches += 1
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    ops = sorted(((us, k, c) for k, (us, c) in by_name.items()),
                 reverse=True)
    averages = prof.key_averages()
    host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                   for e in averages), reverse=True)
    syncs = sum(e.count for e in averages
                if e.key == "cudaStreamSynchronize")
    busy = kernel_us / 1e6 / prof_wall if prof_wall > 0 else 0.0
    return {"warm_wall_s": statistics.median(walls), "walls_s": walls,
            "profiled_wall_s": prof_wall, "device_s": kernel_us / 1e6,
            "host_to_device_copy_s": h2d_us / 1e6,
            "device_busy_share": busy, "device_idle_share": 1.0 - busy,
            "device_kernels": launches, "device_copies_and_sets": copies,
            "host_syncs": syncs,
            "hand_kernel_launches": hand_launches,
            "top_device_ops": [{"op": k, "device_ms": us / 1e3, "calls": c}
                               for us, k, c in ops[:12]],
            "top_host_ops": [{"op": k, "host_self_ms": us / 1e3, "calls": c}
                             for us, k, c in host[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("tpch", "tpcds", "tpcds_joins",
                                        "tpcds_breadth", "tpcds_union",
                                        "tpcds_decimal",
                                        "tpcds_window_rest",
                                        "streaming_windows"),
                    default="tpch")
    ap.add_argument("--sf", type=float, default=None,
                    help="scale factor (default 2 for tpch, 1 for tpcds)")
    ap.add_argument("--hash-table", choices=("on", "off"), default="on",
                    help="off: spark.rapids.gpu.sql.join.hashTable.enabled="
                         "false, every join on the sorted-hash path")
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_tpch: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.exec import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.suite == "streaming_windows":
        return profile_streaming_windows(1.0 if args.sf is None else args.sf,
                                         smi, args.out)
    if args.suite == "tpch":
        from spark_rapids_tpu_torch.bench import tpch as suite

        sf = 2.0 if args.sf is None else args.sf
        tables = suite.tables_for(sf, seed=0)
        queries = suite.DF_QUERIES
        fact = "lineitem"
        order, batched = list(queries), ()
    else:
        from spark_rapids_tpu_torch.bench import tpcds_queries as suite
        from spark_rapids_tpu_torch.bench import tpcds_schema

        sf = 1.0 if args.sf is None else args.sf
        if args.suite == "tpcds":
            names = tpcds_schema.BASE_TABLES
            order, batched = list(suite.HEADLINE) + ["q44", "q67"], \
                suite.HEADLINE
        else:
            group = {"tpcds_joins": suite.JOINS,
                     "tpcds_breadth": suite.BREADTH,
                     "tpcds_union": suite.UNION_SLICE,
                     "tpcds_decimal": suite.DECIMAL_SLICE
                     + suite.WIDE_AVERAGES,
                     "tpcds_window_rest": suite.WINDOW_SLICE}[args.suite]
            names = suite.tables_of(group)
            order, batched = list(group), group
        tables = tpcds_schema.tables_for(sf, seed=0, names=names)
        queries = suite.QUERIES
        fact = "store_sales"
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    conf = (RapidsConf({"spark.rapids.gpu.sql.join.hashTable.enabled":
                        "false"}) if args.hash_table == "off" else None)
    d = suite.df_tables(tables, conf, batch_rows=1 << 20, device="cuda")
    # bench.py runs the TPC-DS headline in batches of 2^22 rows, and the
    # joins queries run the same way
    head = (suite.df_tables(tables, conf, batch_rows=1 << 22, device="cuda")
            if batched else d)
    out = {"device": smi, "torch": torch.__version__, "suite": args.suite,
           "hash_table": args.hash_table,
           "sf": sf, f"{fact}_rows": tables[fact].num_rows, "queries": {}}
    for q in order:
        dq = head if q in batched else d
        res = profile_query(lambda q=q, dq=dq: queries[q](dq).to_arrow())
        res["string_hash_power_table_bytes"] = sum(
            t.numel() * t.element_size() for t in K._POW_TABLES.values())
        if args.suite != "tpch":
            res["cpu_nodes"] = [ln.strip() for ln in queries[q](dq).explain(
                "NOT_ON_GPU").splitlines() if ln.lstrip().startswith("!")]
        out["queries"][q] = res
        _print_query(q, res)
    return report(out, smi, args.out)


def report(out: dict, smi: str, path: str) -> int:
    print(smi, flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _print_query(q: str, res: dict) -> None:
    print(json.dumps({"query": q, **{k: v for k, v in res.items()
                                     if not k.startswith("top_")}}),
          flush=True)
    for op in res["top_device_ops"][:6]:
        print(f"  {q} device {op['device_ms']:9.3f} ms "
              f"{op['calls']:6d}x {op['op'][:90]}", flush=True)
    for op in res["top_host_ops"][:6]:
        print(f"  {q} host {op['host_self_ms']:9.3f} ms "
              f"{op['calls']:6d}x {op['op'][:90]}", flush=True)


def profile_streaming_windows(sf: float, smi: str, path: str) -> int:
    """``--suite streaming_windows`` (see the module docstring)."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan import from_arrow

    ss = tpcds_schema.tables_for(sf, seed=0,
                                 names=["store_sales"])["store_sales"]
    frames = {"": from_arrow(ss, batch_rows=1 << 17, device="cuda"),
              "_off": from_arrow(ss, RapidsConf(
                  {"spark.rapids.gpu.sql.window.streaming.enabled":
                   "false"}), batch_rows=1 << 17, device="cuda")}
    out = {"device": smi, "torch": torch.__version__,
           "suite": "streaming_windows", "sf": sf,
           "store_sales_rows": ss.num_rows, "queries": {}}
    for name, exprs in Q.streaming_windows().items():
        ws = [w for _a, w in exprs]
        for suffix, df in frames.items():
            q = name + suffix
            res = profile_query(lambda df=df: df.with_window(*ws).to_arrow())
            out["queries"][q] = res
            _print_query(q, res)
    return report(out, smi, path)


if __name__ == "__main__":
    sys.exit(main())
