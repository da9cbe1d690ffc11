"""Device handoff to ML code (counterpart of spark_rapids_tpu/plan/ml.py;
the reference plugin's ColumnarRdd, which hands XGBoost GPU-resident
tables without a round trip through the host).

``device_batches`` yields a query's output batches where the plan left
them; ``feature_matrix`` stacks numeric columns into one dense
``(rows, features)`` tensor on the plan's device, nulls as NaN (XGBoost's
missing value), ready for torch models.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.plan.dataframe import DataFrame


def device_batches(df: DataFrame) -> Iterator[ColumnarBatch]:
    """Run the plan and yield its batches on the device. A plan whose
    root is on the CPU engine uploads each of its tables once, to the
    plan's device. The run ends as ``execute_to_arrow``'s does (its
    shuffles released, a memoised tree given back) when the caller has
    taken every batch or closes the generator."""
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.plan.cpu import CpuExec
    from spark_rapids_tpu_torch.plan.dataframe import finish_run

    node = df.physical_plan()
    ok = False
    try:
        for p in range(node.num_partitions()):
            if isinstance(node, CpuExec):
                for t in node.execute_host(p):
                    yield batch_from_arrow(t, node.plan_device())
            else:
                yield from node.execute(p)
        ok = True
    finally:
        finish_run(node, ok)


def feature_matrix(df: DataFrame,
                   feature_cols: Optional[Sequence[str]] = None,
                   label_col: Optional[str] = None,
                   dtype: torch.dtype = torch.float32,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Numeric columns as a dense ``(rows, features)`` tensor on the
    plan's device (``cuda`` unless the frame was made for another), nulls
    as NaN, and the label column as a ``(rows,)`` tensor when named; every
    column but the label when ``feature_cols`` is None. A decimal gives its
    value; the reference gives its unscaled integer."""
    names = [f.name for f in df.schema]
    feature_cols = list(feature_cols) if feature_cols is not None else [
        n for n in names if n != label_col]
    fidx = [names.index(c) for c in feature_cols]
    lidx = names.index(label_col) if label_col is not None else None

    types = [f.dtype for f in df.schema]
    for i in fidx + ([lidx] if lidx is not None else []):
        if not types[i].fixed_width or T.is_wide_decimal(types[i]) or \
                T.is_nested(types[i]):
            raise TypeError(f"feature_matrix: column {names[i]} is "
                            f"{types[i]}, not a number")

    def values(col, dt) -> torch.Tensor:
        v = col.data
        if isinstance(dt, T.DecimalType):
            # the decimal's value (the reference hands its unscaled
            # integer), divided by a tensor: a CUDA division by a host
            # scalar multiplies by its reciprocal, an ulp off
            v = v.double() / torch.tensor(10.0 ** dt.scale,
                                          dtype=torch.float64,
                                          device=v.device)
        return torch.where(col.validity, v.to(dtype),
                           torch.full((), float("nan"), dtype=dtype,
                                      device=v.device))

    xs: List[torch.Tensor] = []
    ys: List[torch.Tensor] = []
    for b in device_batches(df):
        xs.append(torch.stack([values(b.columns[i], types[i])
                               for i in fidx], dim=1))
        if lidx is not None:
            ys.append(values(b.columns[lidx], types[lidx]))
    if not xs:
        dev = df.physical_plan().plan_device()
        return (torch.zeros((0, len(fidx)), dtype=dtype, device=dev),
                torch.zeros((0,), dtype=dtype, device=dev)
                if lidx is not None else None)
    x = torch.cat(xs, dim=0)
    y = torch.cat(ys, dim=0) if ys else None
    return x, y
