"""Where the time of TPC-H Q1/Q3/Q5/Q6 goes on the card, for the port.

    python -m spark_rapids_tpu_torch.bench.profile_tpch [--sf 2.0]
        [--out PATH.json]

For each query (after one warm-up run): the warm wall time (host clock
around a run that ends in a synchronise, median of 3), then one run under
``torch.profiler`` giving the device time summed over kernels, the device's
busy and idle share of that run's wall time, the number of kernel launches
and of copies, and the operations that took the most device time and the
most host time. The probe kernel's launches come from the port's own counter.

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
    before = K.KERNEL_LAUNCHES["hashtbl_probe"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    probe_launches = K.KERNEL_LAUNCHES["hashtbl_probe"] - before
    kernel_us, launches, copies = 0.0, 0, 0
    by_name: dict = {}
    for name, us in device_events(prof):
        kernel_us += us
        if "memcpy" in name.lower() or "memset" in name.lower():
            copies += 1
        else:
            launches += 1
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    ops = sorted(((us, k, c) for k, (us, c) in by_name.items()),
                 reverse=True)
    host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                   for e in prof.key_averages()), reverse=True)
    busy = kernel_us / 1e6 / prof_wall if prof_wall > 0 else 0.0
    return {"warm_wall_s": statistics.median(walls), "walls_s": walls,
            "profiled_wall_s": prof_wall, "device_s": kernel_us / 1e6,
            "device_busy_share": busy, "device_idle_share": 1.0 - busy,
            "device_kernels": launches, "device_copies_and_sets": copies,
            "probe_kernel_launches": probe_launches,
            "top_device_ops": [{"op": k, "device_ms": us / 1e3, "calls": c}
                               for us, k, c in ops[:12]],
            "top_host_ops": [{"op": k, "host_self_ms": us / 1e3, "calls": c}
                             for us, k, c in host[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=2.0)
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_tpch: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.bench import tpch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    tables = tpch.tables_for(args.sf, seed=0)
    d = tpch.df_tables(tables, batch_rows=1 << 20, device="cuda")
    out = {"device": smi, "torch": torch.__version__, "sf": args.sf,
           "lineitem_rows": tables["lineitem"].num_rows, "queries": {}}
    for q in ("q1", "q3", "q5", "q6"):
        res = profile_query(lambda q=q: tpch.DF_QUERIES[q](d).to_arrow())
        out["queries"][q] = res
        print(json.dumps({"query": q, **{k: v for k, v in res.items()
                                         if not k.startswith("top_")}}),
              flush=True)
        for op in res["top_device_ops"][:6]:
            print(f"  {q} device {op['device_ms']:9.3f} ms "
                  f"{op['calls']:6d}x {op['op'][:90]}", flush=True)
        for op in res["top_host_ops"][:6]:
            print(f"  {q} host {op['host_self_ms']:9.3f} ms "
                  f"{op['calls']:6d}x {op['op'][:90]}", flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
