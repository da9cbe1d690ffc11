"""The headline queries over two Parquet layouts of the same files.

    python -m spark_rapids_tpu_torch.bench.parquet_layouts [--sf-ds 1.0]
        [--out PATH.json]

The port's writer stores decimals of precision up to 18 as INT32/INT64,
as Spark writes them; the reference's writer stores them as fixed-length
byte arrays (pyarrow's default). This writes ``bench/parquet_sales.py``'s
files once with the port's writer from the card's batches, copies each
file row group by row group into the byte-array layout (the same rows,
row groups and files), and runs q3/q7/q42/q52/q96 from both on the card,
every setting at its default. Per query and layout: one first run, its
rows held equal across the layouts and its scans' ``scanTimeNs`` and
``uploadTimeNs`` (host, summed over the decode and staging threads),
then warm walls, the median of 3 taken in rounds that alternate the
layouts. Prints one JSON object. Run it from the root of the tree
(``python -m`` imports the package of the working directory).

Needs a CUDA card: it fails rather than measure the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

QUERIES = ("q3", "q7", "q42", "q52", "q96")


def byte_array_copy(paths: dict, out_dir: str) -> dict:
    """Each file rewritten row group by row group with pyarrow's default
    decimal layout (fixed-length byte arrays)."""
    import pyarrow.parquet as pq

    out = {}
    for name, ps in paths.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        out[name] = []
        for p in ps:
            src = pq.ParquetFile(p)
            dst = os.path.join(d, os.path.basename(p))
            with pq.ParquetWriter(dst, src.schema_arrow,
                                  compression="snappy") as w:
                for i in range(src.metadata.num_row_groups):
                    w.write_table(src.read_row_group(i))
            out[name].append(dst)
    return out


def _scan_times(plan) -> dict:
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec

    out = {"scanTimeNs": 0, "uploadTimeNs": 0}
    todo = [plan]
    while todo:
        n = todo.pop()
        todo.extend(n.children)
        if isinstance(n, ParquetScanExec):
            for k in out:
                out[k] += n.metrics[k].value
    return out


def _wall(run) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure(frames: dict) -> dict:
    """``frames``: layout -> the ``read_parquet`` frames of its files."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    res = {}
    for q in QUERIES:
        r, rows = {}, {}
        for layout, f in frames.items():
            plan = Q.QUERIES[q](f).physical_plan()
            rows[layout] = execute_to_arrow(plan).to_pylist()
            r[layout] = _scan_times(plan)
        first = next(iter(rows.values()))
        for layout, got in rows.items():
            ok, why = Q.check_rows(q, got, first)
            if not ok:
                raise AssertionError(f"{q} from {layout} differs ({why})")
        walls = {layout: [] for layout in frames}
        for _ in range(3):
            for layout, f in frames.items():
                walls[layout].append(_wall(
                    lambda f=f: Q.QUERIES[q](f).to_arrow()))
        for layout in frames:
            r[layout]["warm_s"] = statistics.median(walls[layout])
        res[q] = r
        print(f"{q}: " + "; ".join(
            f"{layout} warm {r[layout]['warm_s']:.4f}s, scan "
            f"{r[layout]['scanTimeNs'] / 1e6:.1f} ms, upload "
            f"{r[layout]['uploadTimeNs'] / 1e6:.1f} ms"
            for layout in frames), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf-ds", type=float, default=1.0,
                    help="TPC-DS scale factor")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("parquet_layouts: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.bench import parquet_sales as PS
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    tables = S.tables_for(args.sf_ds, seed=0, names=S.BASE_TABLES)
    with tempfile.TemporaryDirectory(prefix="parquet_layouts_") as d:
        paths, _ = PS.write_tables(tables, os.path.join(d, "integer"),
                                   device="cuda")
        del tables
        byte_paths = byte_array_copy(paths, os.path.join(d, "byte_array"))
        sizes = {layout: sum(os.path.getsize(p) for ps in lp.values()
                             for p in ps)
                 for layout, lp in (("integer", paths),
                                    ("byte_array", byte_paths))}
        frames = {"integer": PS.df_tables(paths, device="cuda"),
                  "byte_array": PS.df_tables(byte_paths, device="cuda")}
        res = {"device": torch.cuda.get_device_name(0), "sf_ds": args.sf_ds,
               "bytes": sizes, "queries": measure(frames)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
