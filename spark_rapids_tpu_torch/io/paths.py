"""Scan-path replacement rules (Alluxio integration analog).

The port's copy of spark_rapids_tpu/io/paths.py.

Reference: AlluxioUtils.scala + spark.rapids.alluxio.pathsToReplace — the
reference rewrites s3:// paths to alluxio:// mount points so scans hit the
cache cluster. Standalone, the same mechanism is a config-driven prefix
rewrite applied to every scan path before the reader opens it; useful for
pointing table locations at a local cache tier (see io/filecache.py) or a
mirror without touching the query.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.config.conf import PATHS_TO_REPLACE  # noqa: F401


def parse_rules(spec: str) -> List[Tuple[str, str]]:
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "->" not in part:
            raise ValueError(
                f"bad path replacement rule {part!r}: expected 'src->dst'")
        src, dst = part.split("->", 1)
        rules.append((src.strip(), dst.strip()))
    return rules


def replace_paths(paths: Sequence[str],
                  conf: "C.RapidsConf") -> List[str]:
    """First-matching-prefix rewrite of each path (AlluxioUtils semantics:
    one rule applies per path, longest configured first wins as written)."""
    rules = parse_rules(conf[PATHS_TO_REPLACE])
    if not rules:
        return list(paths)
    # longest src first so a more specific prefix cannot be shadowed by a
    # shorter one listed earlier
    rules = sorted(rules, key=lambda r: len(r[0]), reverse=True)
    out = []
    for p in paths:
        for src, dst in rules:
            if p.startswith(src):
                p = dst + p[len(src):]
                break
        out.append(p)
    return out
