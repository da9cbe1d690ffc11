#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one card.

    python3 chip_smoke.py [--sf 2.0] [--out PATH.json]

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: every CUDA kernel source under spark_rapids_tpu_torch/csrc, one
   nvcc process each, started together;
3. kernels: each kernel's wrapper against its plain torch version on the
   card at three seeded shapes (Q3's lineitem-join shape, a
   duplicate-heavy build, near-full clusters that reach the probe bound);
   results must be exactly equal. Times are CUDA-event medians of 20 runs
   after warm-up, each queued behind a spin on the card so that the
   kernel's time is device time (``call_ms`` is the wrapper's call with
   its host launch cost, timed without the spin). The bound is the bytes
   the probe must move over 3.35 TB/s: 16 B of hashes in and 4 B of slot
   out per probe row, the used byte of every table slot, and the two 8 B
   hash words of the used slots only (the kernel reads a slot's words
   only when its used byte is set);
4. main path: TPC-H Q1/Q3/Q5/Q6 at SF ``--sf`` (12M lineitem rows at SF2)
   through ``from_arrow(...)...to_arrow()`` on ``cuda``, once with every
   kernel launch count set to 0 just before and read just after, each
   result held against the pandas reference (rel 1e-6, exact keys, counts
   and ORDER BY order); then the warm wall time of each query (median of
   3); then each kernel against its plain version, as in phase 3, on the
   largest input the main path gave it. The kernels line reports that
   input's times and bound.

The last lines are the kernels JSON line, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PROBE_SOURCE = "spark_rapids_tpu_torch/csrc/hashtbl_probe.cu"
PROBE_REPLACES = "spark_rapids_tpu/exec/kernels.py:1769"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds. With ``queued``
    the events and ``fn``'s launches wait behind a spin of about 2 ms on
    the card, so the interval holds device work only and not the host's
    time to make the launches (unless ``fn`` itself synchronises)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe_bound_ms(n: int, capacity: int, table_keys: int) -> float:
    """Least time of one probe call: 20 B per probe row, 1 B per slot and
    16 B per used slot, each read or written once, at the memory rate."""
    return (20 * n + capacity + 16 * table_keys) / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------


def synthetic_probe_inputs(name: str, seed: int, device):
    """(tbl, h1, h2, capacity, seed) for one seeded probe shape, the table
    built by the port's own build from int64 keys."""
    import numpy as np
    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import kernels as K

    rng = np.random.default_rng(seed)
    if name == "q3_lineitem":
        # ~292k unique order keys (every 4th integer, as tpch's orders) and
        # 1M probes of which about 1 in 41 hits
        build_keys = rng.choice(np.arange(1, 4 * 3_000_000, 4), 292_000,
                                replace=False)
        hits = rng.choice(build_keys, 24_000)
        miss = rng.integers(0, 1 << 40, 1_000_000 - 24_000) * 4 + 2
        probe_keys = rng.permutation(np.concatenate([hits, miss]))
    elif name == "duplicate_heavy":
        build_keys = rng.integers(0, 5_000, 500_000)
        probe_keys = rng.integers(0, 10_000, 1_000_000)
    elif name == "near_full":
        build_keys = rng.choice(1 << 40, 60_000, replace=False)
        probe_keys = np.concatenate([rng.choice(build_keys, 500_000),
                                     rng.integers(1 << 41, 1 << 42,
                                                  500_000)])
    else:
        raise KeyError(name)
    bb = batch_from_arrow(pa.table({"k": pa.array(build_keys, pa.int64())}),
                          device)
    pb = batch_from_arrow(pa.table({"k": pa.array(probe_keys, pa.int64())}),
                          device)
    h1 = K.hash_keys(bb, [0])
    h2 = K.hash_keys(bb, [0], variant=1)
    valid = torch.ones(bb.num_rows, dtype=torch.bool, device=device)
    if name == "near_full":
        # 60k keys into 2^16 slots: the build leaves some rows unplaced, and
        # the clusters it does leave run probes into the 16-slot bound
        capacity, seed_ = 1 << 16, 0
        tbl, _ = K.build_hash_table(h1, h2, valid, capacity, seed_,
                                    K.HASHTBL_MAX_PROBES)
    else:
        tbl, capacity, seed_ = K.build_batch_hash_table(bb, (0,))
    return (tbl, K.hash_keys(pb, [0]), K.hash_keys(pb, [0], variant=1),
            capacity, seed_)


def check_probe(label: str, tbl, h1, h2, capacity: int, seed: int) -> dict:
    """Kernel against the plain version on one input: exact slots, times."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    mp = K.HASHTBL_MAX_PROBES
    saved = dict(K.KERNEL_LAUNCHES)
    ks, kh = K.probe_hash_table_kernel(tbl, h1, h2, capacity, seed, mp)
    torch.cuda.synchronize()
    ps, ph = K.probe_hash_table(tbl, h1, h2, capacity, seed, mp)
    exact = bool(torch.equal(ks, ps)) and bool(torch.equal(kh, ph))
    err = int((ks.long() - ps.long()).abs().max()) if ks.numel() else 0
    kernel_ms = cuda_ms(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp))
    call_ms = cuda_ms(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp), queued=False)
    plain_ms = cuda_ms(lambda: K.probe_hash_table(
        tbl, h1, h2, capacity, seed, mp))
    K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    n = h1.numel()
    table_keys = int(tbl.slot_used.sum())
    res = {"shape": label, "probe_rows": n, "capacity": capacity,
           "seed": seed, "table_keys": table_keys,
           "hit_rate": float(kh.float().mean()) if n else 0.0,
           "exact": exact, "max_abs_err": err, "kernel_ms": kernel_ms,
           "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": probe_bound_ms(n, capacity, table_keys)}
    log(f"probe {label}: " + json.dumps(res))
    if not exact:
        raise AssertionError(f"probe kernel differs from its plain version "
                             f"on {label} (max abs err {err})")
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def _py(v):
    import numpy as np

    return v.item() if isinstance(v, np.generic) else v


def reference_rows(cpu, q: str):
    """The pandas reference of one query as (rows, ORDER BY key list)."""
    if q == "q6":
        return [{"revenue": cpu["q6"]()}], None
    df = cpu[q]()
    df = df.reset_index() if q == "q1" else df.reset_index(drop=True)
    rows = [{k: _py(v) for k, v in r.items()}
            for r in df.to_dict("records")]
    keys = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("l_orderkey",),
            "q5": ("n_name",)}[q]
    return rows, [tuple(r[k] for k in keys) for r in rows]


def run_main_path(sf: float, tables_seed: int = 0) -> dict:
    import torch

    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.exec import kernels as K

    t0 = time.perf_counter()
    tables = tpch.tables_for(sf, seed=tables_seed)
    log(f"generated TPC-H SF{sf}: lineitem {tables['lineitem'].num_rows} "
        f"rows in {time.perf_counter() - t0:.1f}s")
    d = tpch.df_tables(tables, batch_rows=1 << 20, device="cuda")
    cpu = tpch.cpu_tpch(*[tables[k] for k in (
        "lineitem", "orders", "customer", "supplier", "nation", "region")])
    queries = ["q1", "q3", "q5", "q6"]

    # record the largest probe call the main path makes
    largest = {}
    real_probe = K.probe_hash_table_kernel

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("n", -1):
            largest.update(n=h1.numel(), args=(tbl, h1, h2, capacity, seed))
        return real_probe(tbl, h1, h2, capacity, seed, max_probes)

    K.probe_hash_table_kernel = recording_probe
    results = {}
    K.reset_kernel_launches()
    try:
        for q in queries:
            before = dict(K.KERNEL_LAUNCHES)
            t1 = time.perf_counter()
            out = tpch.DF_QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = {k: K.KERNEL_LAUNCHES[k] - before[k]
                        for k in K.KERNEL_LAUNCHES}
            got = out.to_pylist()
            exp, exp_order = reference_rows(cpu, q)
            if not tpch.rows_match(got, exp):
                raise AssertionError(f"{q} differs from the pandas "
                                     f"reference:\n{got[:5]}\n{exp[:5]}")
            if exp_order is not None:
                keys = {"q1": ("l_returnflag", "l_linestatus"),
                        "q3": ("l_orderkey",), "q5": ("n_name",)}[q]
                got_order = [tuple(r[k] for k in keys) for r in got]
                if got_order != exp_order:
                    raise AssertionError(f"{q} ORDER BY order differs: "
                                         f"{got_order} vs {exp_order}")
            results[q] = {"rows": len(got), "first_s": first_s,
                          "launches": launches}
            log(f"{q}: {len(got)} rows match the pandas reference; "
                f"launches {launches}; first run {first_s:.3f}s")
    finally:
        K.probe_hash_table_kernel = real_probe
    main_launches = dict(K.KERNEL_LAUNCHES)
    for q in ("q3", "q5"):
        if results[q]["launches"]["hashtbl_probe"] <= 0:
            raise AssertionError(f"{q} launched no probe kernel")
    for name, count in main_launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    # warm wall time per query (launches here are not the main path's)
    for q in queries:
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            tpch.DF_QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        results[q]["warm_s"] = statistics.median(walls)
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of 3)")
    K.KERNEL_LAUNCHES.update(main_launches)
    return {"queries": results, "launches": main_launches,
            "largest_probe": largest.get("args"),
            "lineitem_rows": tables["lineitem"].num_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=2.0)
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec import kernels as K

    t_all = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = native.build_all()
    for src in native.SOURCES:
        native.load(src)
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} "
        f"in {build_s:.1f}s")

    shapes = []
    for i, name in enumerate(("q3_lineitem", "duplicate_heavy",
                              "near_full")):
        shapes.append(check_probe(name, *synthetic_probe_inputs(
            name, 100 + i, "cuda")))

    main_res = run_main_path(args.sf)

    tbl, h1, h2, capacity, seed = main_res.pop("largest_probe")
    real = check_probe("main_path_largest", tbl, h1, h2, capacity, seed)
    shapes.append(real)
    torch.cuda.synchronize()

    kernels_line = {"kernels": [{
        "name": "hashtbl_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES,
        "replaces_fn": "probe_hash_table_pallas",
        "launches": main_res["launches"]["hashtbl_probe"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": real["kernel_ms"], "kernel_ms": real["kernel_ms"],
        "call_ms": real["call_ms"],
        "plain_ms": real["plain_ms"], "bound_ms": real["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "exact": all(s["exact"] for s in shapes)}]}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "sf": args.sf, "lineitem_rows": main_res["lineitem_rows"],
              "queries": main_res["queries"], "probe_shapes": shapes,
              "kernels": kernels_line["kernels"],
              "total_s": time.perf_counter() - t_all}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
