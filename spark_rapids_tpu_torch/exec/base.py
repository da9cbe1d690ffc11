"""Physical operator base (counterpart of spark_rapids_tpu/exec/base.py).

An operator produces an iterator of device ``ColumnarBatch`` per partition:
``execute`` wraps the subclass's ``do_execute`` with the operator's output
metrics. An operator has its first child's partitions unless it says
otherwise; a ``BatchSourceExec`` has one per source split.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class Metric:
    """Accumulating metric; ``add`` is locked against concurrent adders."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, v) -> None:
        with self._lock:
            self.value += v

    def __repr__(self):
        return f"{self.name}={self.value}"


class MetricsTimer:
    """Context manager adding elapsed host nanoseconds to a metric. Device
    work is asynchronous, so this times the host side of an operator."""

    def __init__(self, metric: Optional[Metric]):
        self.metric = metric

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.metric is not None:
            self.metric.add(time.perf_counter_ns() - self._t0)
        return False


class DeviceExec:
    """Base physical operator: subclasses define ``output_schema`` and
    ``do_execute(partition)``."""

    def __init__(self, *children: "DeviceExec"):
        self.children: List[DeviceExec] = list(children)
        self.metrics: Dict[str, Metric] = {}
        for name in ("numOutputRows", "numOutputBatches", "opTime"):
            self._register_metric(name)

    @property
    def output_schema(self) -> T.Schema:
        raise NotImplementedError

    def num_partitions(self) -> int:
        if self.children:
            return self.children[0].num_partitions()
        return 1

    def execute(self, partition: int = 0) -> Iterator[ColumnarBatch]:
        it = self.do_execute(partition)
        op_time = self.metrics["opTime"]
        while True:
            t0 = time.perf_counter_ns()
            try:
                batch = next(it)
            except StopIteration:
                op_time.add(time.perf_counter_ns() - t0)
                return
            op_time.add(time.perf_counter_ns() - t0)
            self.metrics["numOutputBatches"].add(1)
            self.metrics["numOutputRows"].add(batch.num_rows)
            yield batch

    def execute_all(self) -> Iterator[ColumnarBatch]:
        for p in range(self.num_partitions()):
            yield from self.execute(p)

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def plan_device(self) -> torch.device:
        """The device this plan's batches live on: its first source's."""
        return self.children[0].plan_device()

    def _register_metric(self, name: str) -> Metric:
        m = Metric(name)
        self.metrics[name] = m
        return m

    def timer(self, name: str) -> MetricsTimer:
        return MetricsTimer(self.metrics.get(name))

    def node_description(self) -> str:
        return type(self).__name__

    def explain(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{'+- ' if indent else ''}{self.node_description()}"]
        for c in self.children:
            lines.append(c.explain(indent + 1))
        return "\n".join(lines)


class UnaryExec(DeviceExec):
    def __init__(self, child: DeviceExec):
        super().__init__(child)

    @property
    def child(self) -> DeviceExec:
        return self.children[0]

    @property
    def output_schema(self) -> T.Schema:
        return self.child.output_schema


class BinaryExec(DeviceExec):
    def __init__(self, left: DeviceExec, right: DeviceExec):
        super().__init__(left, right)

    @property
    def left(self) -> DeviceExec:
        return self.children[0]

    @property
    def right(self) -> DeviceExec:
        return self.children[1]


class BatchSourceExec(DeviceExec):
    """Leaf producing pre-built device batches. ``device`` defaults to that
    of the first batch with columns."""

    def __init__(self, batches_per_partition: Sequence[Sequence[ColumnarBatch]],
                 schema: T.Schema, device=None):
        super().__init__()
        self._parts = [list(bs) for bs in batches_per_partition]
        self._schema = schema
        if device is None:
            device = next((b.columns[0].device for bs in self._parts
                           for b in bs if b.columns), None)
        self.device = None if device is None else torch.device(device)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self._parts)

    def plan_device(self) -> torch.device:
        if self.device is None:
            raise ValueError("the plan's source has no device: pass device= "
                             "to BatchSourceExec")
        return self.device

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        yield from self._parts[partition]
