"""Window expressions: specs, frames, ranking/offset/aggregate functions
(host-only; counterpart of spark_rapids_tpu/exprs/window.py).

exec/window.py computes every window column over partition-sorted rows
from one shared segment/peer geometry, built with segmented scans: every
function here, and Sum/Count/Average/Min/Max/First/Last (exprs/expr.py)
over UNBOUNDED, running and bounded ROWS and RANGE frames
(``exec.window.check_window`` names what it refuses).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import expr as E

UNBOUNDED = None  #: frame bound sentinel
CURRENT_ROW = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """ROWS or RANGE frame. ``start``/``end`` are row offsets relative to the
    current row (negative = preceding), or UNBOUNDED (None)."""

    kind: str = "rows"  # "rows" | "range"
    start: Optional[int] = UNBOUNDED
    end: Optional[int] = CURRENT_ROW

    def __post_init__(self):
        assert self.kind in ("rows", "range")

    @property
    def is_unbounded_both(self) -> bool:
        return self.start is UNBOUNDED and self.end is UNBOUNDED

    @property
    def is_running(self) -> bool:
        """UNBOUNDED PRECEDING .. CURRENT ROW."""
        return self.start is UNBOUNDED and self.end == 0

    @property
    def is_bounded_rows(self) -> bool:
        """ROWS a..b with both offsets given."""
        return (self.kind == "rows" and self.start is not UNBOUNDED
                and self.end is not UNBOUNDED)

    @property
    def is_bounded_range(self) -> bool:
        """A RANGE frame whose rows depend on the order key's values (all
        but UNBOUNDED..UNBOUNDED, UNBOUNDED..CURRENT ROW and CURRENT
        ROW..UNBOUNDED FOLLOWING, which follow the peer runs)."""
        return (self.kind == "range" and not self.is_unbounded_both
                and not self.is_running
                and not (self.start == 0 and self.end is UNBOUNDED))

    def __repr__(self):
        def b(x, side):
            if x is UNBOUNDED:
                return f"UNBOUNDED {side}"
            if x == 0:
                return "CURRENT ROW"
            return f"{abs(x)} {'PRECEDING' if x < 0 else 'FOLLOWING'}"

        return f"{self.kind.upper()} BETWEEN {b(self.start, 'PRECEDING')} " \
               f"AND {b(self.end, 'FOLLOWING')}"


#: Spark's default frame with ORDER BY: RANGE UNBOUNDED PRECEDING..CURRENT ROW
DEFAULT_ORDERED_FRAME = WindowFrame("range", UNBOUNDED, CURRENT_ROW)
FULL_FRAME = WindowFrame("rows", UNBOUNDED, UNBOUNDED)


@dataclasses.dataclass(frozen=True, eq=False)
class WindowSpec:
    partition_by: Tuple[E.Expression, ...] = ()
    order_by: Tuple[SortOrder, ...] = ()
    frame: Optional[WindowFrame] = None  # None -> Spark default rule

    def resolved_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        return DEFAULT_ORDERED_FRAME if self.order_by else FULL_FRAME

    def __repr__(self):
        parts = []
        if self.partition_by:
            parts.append(f"partition by {list(self.partition_by)}")
        if self.order_by:
            parts.append(f"order by {list(self.order_by)}")
        parts.append(repr(self.resolved_frame()))
        return "(" + ", ".join(parts) + ")"


def window_spec(partition_by: Sequence[E.Expression] = (),
                order_by: Sequence = (),
                frame: Optional[WindowFrame] = None) -> WindowSpec:
    pb = tuple(E.col(p) if isinstance(p, str) else p for p in partition_by)
    ob = []
    for o in order_by:
        if isinstance(o, str):
            ob.append(SortOrder(E.col(o)))
        elif isinstance(o, SortOrder):
            ob.append(o)
        else:
            ob.append(SortOrder(o))
    return WindowSpec(pb, tuple(ob), frame)


class WindowFunction(E.Expression):
    """Marker base for functions only valid inside WindowExpression."""


class RowNumber(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


class Rank(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


class DenseRank(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.n = n

    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


class PercentRank(WindowFunction):
    """percent_rank() = (rank - 1) / (partition rows - 1), 0.0 for a
    single-row partition (Spark PercentRank)."""

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False


class CumeDist(WindowFunction):
    """cume_dist() = rows <= current (peers included) / partition rows."""

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False


class Lead(WindowFunction):
    def __init__(self, child: E.Expression, offset: int = 1,
                 default: Optional[E.Expression] = None):
        self.child = child
        self.offset = offset
        self.default = default
        self.children = (child,) if default is None else (child, default)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class Lag(Lead):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class WindowExpression(E.Expression):
    function: E.Expression  # WindowFunction or AggregateExpression
    spec: WindowSpec

    @property
    def children(self):  # type: ignore[override]
        return (self.function,)

    @property
    def dtype(self):
        return self.function.dtype

    @property
    def nullable(self):
        return getattr(self.function, "nullable", True)

    def __repr__(self):
        return f"{self.function!r} OVER {self.spec!r}"


def over(function: E.Expression, spec: WindowSpec) -> WindowExpression:
    return WindowExpression(function, spec)
