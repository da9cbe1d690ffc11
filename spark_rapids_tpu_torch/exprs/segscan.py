"""Segmented composition scan of per-byte state transitions (counterpart of
spark_rapids_tpu/exprs/segscan.py), as torch operations.

A sequential per-row walk over a string's bytes (greedy non-overlapping
replace, substring_index's occurrence count) is written as one function
``f_i: state -> state`` a byte, a row of an ``(nbytes, S)`` table, and the
functions are composed left to right within each row. The reference
composes them with ``jax.lax.associative_scan``; torch has none, so this is
a doubling (Hillis-Steele) scan: step ``d`` composes every position with
the composition ending ``d`` bytes before it, unless a row starts in
between. A row's prefix is whole once ``d`` reaches the longest row, so
the scan takes ``ceil(log2(longest row))`` steps, not ``log2(nbytes)``:
the caller passes the longest row (its one host read).

Why doubling and not a loop over byte positions (the port's LIKE
``match_strings``): the loop takes one step per byte of the longest row,
each over every row; doubling takes log2 of that, each over every byte,
and its launches do not grow with long rows.

Memory: states are uint8 where ``S <= 256`` (int32 otherwise); a step
holds the table twice and gathers one state column at a time through one
``(nbytes,)`` int64 index, so no ``(nbytes, S)`` int64 copy is made.
"""

from __future__ import annotations

import torch


def segmented_compose(fns: torch.Tensor, resets: torch.Tensor,
                      longest: int) -> torch.Tensor:
    """Inclusive segmented composition: ``h[i, s]`` is the state after the
    current segment's transitions up to and including position ``i``,
    from state ``s``. ``fns[i, s]`` is position ``i``'s transition,
    ``resets[i]`` marks a segment's first position and ``longest`` is the
    longest segment."""
    h = fns
    seg_start = resets
    n, states = fns.shape
    d = 1
    while d < max(longest, 1) and d < n:
        # h[i] = h[i] o h[i - d] where no segment starts in (i - d, i]
        prev = h[:-d]
        cur = h[d:]
        keep = seg_start[d:]
        composed = torch.empty_like(cur)
        for s in range(states):
            composed[:, s] = cur.gather(1, prev[:, s:s + 1].long())[:, 0]
        nxt = h.clone()
        nxt[d:] = torch.where(keep[:, None], cur, composed)
        h = nxt
        started = seg_start.clone()
        started[d:] = seg_start[d:] | seg_start[:-d]
        seg_start = started
        d *= 2
    return h


def exclusive_states(h: torch.Tensor, resets: torch.Tensor,
                     start_state: int) -> torch.Tensor:
    """The state (int32) before each position's byte: ``start_state`` at
    a segment's first position, else the previous position's composition
    applied to ``start_state``."""
    out = torch.full((h.shape[0],), start_state, dtype=torch.int32,
                     device=h.device)
    if h.shape[0] > 1:
        out[1:] = h[:-1, start_state].int()
    return torch.where(resets, torch.full_like(out, start_state), out)
