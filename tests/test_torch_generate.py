"""GenerateExec (explode, posexplode and their outer variants) and
SampleExec in the port, held against the JAX package's exec nodes on the
CPU, over the same seeded batches.

Tolerance: exact (rows compared as Python values, in output order:
each batch's expansion, then, with ``outer``, its null or empty arrays'
rows). The sample cannot equal the reference's rows (``torch.Generator``
against ``jax.random``): it is held to the reference's own properties,
the same rows for a seed and a kept share near the fraction.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_arrow as jax_upload
from spark_rapids_tpu.columnar.batch import batch_to_arrow as jax_download
from spark_rapids_tpu.exec import BatchSourceExec as JaxSource
from spark_rapids_tpu.exec import GenerateExec as JaxGenerate
from spark_rapids_tpu.exprs.expr import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, batch_to_arrow)
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exec.generate import GenerateExec
from spark_rapids_tpu_torch.exec.misc import SampleExec
from spark_rapids_tpu_torch.exprs.expr import col

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

BATCH_ROWS = 40


def table(seed: int = 5, n: int = 120) -> pa.Table:
    """An id, an array with null rows and empty arrays, a string and a
    second array column that repeats with its row."""
    rng = np.random.default_rng(seed)
    a = [None if i % 11 == 0 else rng.integers(0, 50, rng.integers(0, 5))
         .tolist() for i in range(n)]
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "a": pa.array(a, pa.list_(pa.int32())),
        "s": pa.array([None if i % 7 == 0 else f"r{i}" for i in range(n)]),
        "b": pa.array([[i, i + 1] for i in range(n)], pa.list_(pa.int64()))})


def port_rows(node):
    out = []
    for b in node.execute_all():
        out.extend(batch_to_arrow(b, node.output_schema).to_pylist())
    return out


def port_source(t):
    return BatchSourceExec([[batch_from_arrow(t.slice(i, BATCH_ROWS), "cpu")
                             for i in range(0, t.num_rows, BATCH_ROWS)]],
                           PT.Schema.from_arrow(t.schema), "cpu")


def jax_rows(t, outer, position):
    src = JaxSource([[jax_upload(t.slice(i, BATCH_ROWS), 16)
                      for i in range(0, t.num_rows, BATCH_ROWS)]],
                    JT.Schema.from_arrow(t.schema))
    node = JaxGenerate(jcol("a"), src, outer=outer, position=position)
    out = []
    for b in node.execute_all():
        out.extend(jax_download(b, node.output_schema).to_pylist())
    return out


@pytest.mark.parametrize("outer", [False, True], ids=["inner", "outer"])
@pytest.mark.parametrize("position", [False, True],
                         ids=["explode", "posexplode"])
def test_generate_matches_the_reference(outer, position):
    t = table()
    node = GenerateExec(col("a"), port_source(t), outer=outer,
                        position=position)
    names = ["id", "s", "b"] + (["pos"] if position else []) + ["col"]
    assert node.output_schema.names() == names
    assert port_rows(node) == jax_rows(t, outer, position)


def test_generate_needs_an_array_column_reference():
    t = table()
    with pytest.raises(NotImplementedError, match="array"):
        GenerateExec(col("s"), port_source(t))


def _ids(node):
    return [r["x"] for r in port_rows(node)]


def test_sample_is_deterministic_for_a_seed_and_near_its_fraction():
    n = 4000
    t = pa.table({"x": pa.array(np.arange(n), pa.int64())})

    def src():
        return BatchSourceExec([[batch_from_arrow(t.slice(i, 512), "cpu")
                                 for i in range(0, n, 512)]],
                               PT.Schema.from_arrow(t.schema), "cpu")

    a = _ids(SampleExec(0.3, 42, src()))
    assert a == _ids(SampleExec(0.3, 42, src()))
    assert a != _ids(SampleExec(0.3, 7, src()))
    assert a == sorted(set(a))  # a subset, in order
    assert 0.25 < len(a) / n < 0.35
    assert _ids(SampleExec(0.0, 1, src())) == []
    assert len(_ids(SampleExec(1.0, 1, src()))) == n
    with pytest.raises(ValueError):
        SampleExec(1.5, 1, src())
