"""Typed configuration registry (counterpart of spark_rapids_tpu/config/conf.py).

Keys live under ``spark.rapids.gpu.``; each entry the port reads carries the
reference's default.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

_REGISTRY: "Dict[str, ConfEntry]" = {}
_REG_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[Any], Any]

    def get(self, conf: "RapidsConf"):
        return conf.get(self.key)


def _to_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("true", "1", "yes")


def conf(key: str, *, default, doc: str) -> ConfEntry:
    """Declare a config entry; its type is inferred from the default."""
    if isinstance(default, bool):
        conv: Callable[[Any], Any] = _to_bool
    elif isinstance(default, int):
        conv = int
    elif isinstance(default, float):
        conv = float
    else:
        conv = str
    entry = ConfEntry(key, default, doc, conv)
    with _REG_LOCK:
        if key in _REGISTRY:
            raise ValueError(f"duplicate conf key {key}")
        _REGISTRY[key] = entry
    return entry


JOIN_MAX_OUTPUT_ROWS = conf(
    "spark.rapids.gpu.sql.join.maxCandidateRowsPerBatch", default=1 << 27,
    doc="Hard cap on candidate join pairs produced by one probe batch; a "
        "join that explodes past it raises instead of exhausting memory.")

JOIN_CHUNK_TARGET_ROWS = conf(
    "spark.rapids.gpu.sql.join.gatherChunkTargetRows", default=1 << 22,
    doc="Candidate-pair budget per output chunk of the hash-table join: a "
        "probe batch with more candidates is emitted as several bounded "
        "batches.")


class RapidsConf:
    """Immutable bag of settings; unknown keys are rejected."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        for k, v in (settings or {}).items():
            entry = _REGISTRY.get(k)
            if entry is None:
                raise KeyError(f"unknown conf key {k}")
            self._values[k] = entry.conv(v)

    def get(self, key: str):
        if key in self._values:
            return self._values[key]
        return _REGISTRY[key].default

    def __getitem__(self, entry: ConfEntry):
        return self.get(entry.key)


_active_lock = threading.Lock()
_active: RapidsConf = RapidsConf()


def set_active(conf_obj: Optional[RapidsConf]) -> None:
    global _active
    with _active_lock:
        _active = conf_obj if conf_obj is not None else RapidsConf()


def get_active() -> RapidsConf:
    with _active_lock:
        return _active
