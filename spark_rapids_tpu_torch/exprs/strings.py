"""Byte kernels of the device's string values (counterpart of
spark_rapids_tpu/exprs/strings.py), over the port's plain string columns
(``columnar/column.py``: uint8 bytes, int32 offsets, validity; a
dictionary column's entries are one).

Every kernel is written over the flat byte buffer, as the reference's:
per-row output lengths, their offsets (``make_offsets``), the row of each
output byte (``row_ids``) and one gather or scatter of the output bytes.
The output's byte count is the kernel's one host read (``_build`` reads
it); the compose scan's depth needs the longest row, a second one, in
``replace`` and ``substring_index``. An output column holds exactly its
bytes, and a null row is empty.

Sequential per-row semantics (greedy non-overlapping replace,
substring_index's occurrence count) run the countdown automaton of
``_greedy_takes`` through ``segscan.segmented_compose``.

Byte semantics, as the reference's device: case mapping (Upper, Lower,
InitCap) is ASCII, Reverse, Translate, the pads and Instr/Locate work on
bytes, Chr writes one byte (a code of 128-255 is not valid UTF-8 alone),
Ascii reads the first byte and Length counts UTF-8 characters. On ASCII
text these are Spark's answers; the CPU engine (``plan/cpu_strings.py``)
works on characters.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exprs.segscan import (exclusive_states,
                                                  segmented_compose)

_BIG = 1 << 40


def make_offsets(lens: torch.Tensor) -> torch.Tensor:
    """int32 offsets (n + 1,) of rows with byte lengths ``lens``."""
    out = torch.zeros(lens.numel() + 1, dtype=torch.int32,
                      device=lens.device)
    if lens.numel():
        out[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    return out


def row_ids(offsets: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The row (int64) of each of the first ``nbytes`` bytes of a column
    with ``offsets``."""
    n = offsets.numel() - 1
    lens = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   lens, output_size=nbytes)


def emit(mat: torch.Tensor, lens: torch.Tensor, start: torch.Tensor,
         validity: torch.Tensor) -> DeviceColumn:
    """A plain string column whose row i is ``mat[i, start[i]:start[i] +
    lens[i]]`` (empty where the row is null)."""
    start = start.long()
    return _build(lens, validity,
                  lambda rows, rel: mat[rows, start[rows] + rel])


def _build(lens: torch.Tensor, validity: torch.Tensor,
           fill: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           dt: T.DataType = T.STRING) -> DeviceColumn:
    """A plain column with rows of ``lens`` bytes (null rows empty): output
    byte (row, rel) is ``fill(rows, rel)``. One host read: the byte
    count."""
    lens = torch.where(validity, lens.int(), torch.zeros_like(lens.int()))
    offsets = make_offsets(lens)
    total = int(offsets[-1]) if lens.numel() else 0
    rows = row_ids(offsets, total)
    rel = torch.arange(total, device=lens.device) - offsets[:-1].long()[rows]
    data = fill(rows, rel) if total else torch.zeros(
        0, dtype=torch.uint8, device=lens.device)
    return DeviceColumn(dt, data.to(torch.uint8).contiguous(), validity,
                        offsets)


def _take(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` with the index clamped into the buffer (zeros from an
    empty one)."""
    if data.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.uint8, device=idx.device)
    return data[idx.clamp(0, data.numel() - 1)]


def _positions(c: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, position in the row) of each byte of a plain column."""
    nbytes = c.data.numel()
    rows = row_ids(c.offsets, nbytes)
    rel = torch.arange(nbytes, device=c.device) - c.offsets[:-1].long()[rows]
    return rows, rel


def _starts(c: DeviceColumn) -> torch.Tensor:
    return c.offsets[:-1].long()


def _lens(c: DeviceColumn) -> torch.Tensor:
    return c.lengths().long()


def _segment_min(vals: torch.Tensor, rows: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Per row, the least of its bytes' ``vals`` (``_BIG`` where none)."""
    out = torch.full((n,), _BIG, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, rows, vals, "amin")


def _segment_max(vals: torch.Tensor, rows: torch.Tensor, n: int
                 ) -> torch.Tensor:
    out = torch.full((n,), -1, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, rows, vals, "amax")


def _segment_sum(vals: torch.Tensor, rows: torch.Tensor, n: int
                 ) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int64, device=vals.device)
    return out.index_add_(0, rows, vals.long())


def _exclusive_cumsum(flags: torch.Tensor) -> torch.Tensor:
    """(nbytes + 1,) int64: the flags before each position."""
    out = torch.zeros(flags.numel() + 1, dtype=torch.int64,
                      device=flags.device)
    out[1:] = torch.cumsum(flags.long(), 0)
    return out


# --------------------------------------------------------------------------
# lengths, case, search
# --------------------------------------------------------------------------


def char_lengths(c: DeviceColumn) -> torch.Tensor:
    """UTF-8 characters a row (int32): its bytes that are not 10xxxxxx."""
    lead = _exclusive_cumsum((c.data & 0xC0) != 0x80)
    off = c.offsets.long()
    return (lead[off[1:]] - lead[off[:-1]]).int()


def change_case(c: DeviceColumn, upper: bool) -> DeviceColumn:
    """ASCII upper or lower case; other bytes stay."""
    d = c.data
    if upper:
        hit = (d >= ord("a")) & (d <= ord("z"))
        out = torch.where(hit, d - 32, d)
    else:
        hit = (d >= ord("A")) & (d <= ord("Z"))
        out = torch.where(hit, d + 32, d)
    return DeviceColumn(c.dtype, out.to(torch.uint8), c.validity, c.offsets)


def _match_starts(c: DeviceColumn, needle: bytes) -> torch.Tensor:
    """bool per byte: an occurrence of ``needle`` starts here within its
    row."""
    rows, rel = _positions(c)
    pos = torch.arange(c.data.numel(), device=c.device)
    ok = rel <= _lens(c)[rows] - len(needle)
    for j, ch in enumerate(needle):
        ok = ok & (_take(c.data, pos + j) == ch)
    return ok


def search(c: DeviceColumn, needle: bytes, kind: str) -> torch.Tensor:
    """startswith / endswith / contains of a literal (bool per row; an
    empty needle is in every row)."""
    n, m = c.num_rows, len(needle)
    lens = _lens(c)
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=c.device)
    if kind in ("starts", "ends"):
        base = _starts(c) + (0 if kind == "starts" else lens - m)
        ok = lens >= m
        for j, ch in enumerate(needle):
            ok = ok & (_take(c.data, base + j) == ch)
        return ok
    rows, _ = _positions(c)
    hit = _segment_sum(_match_starts(c, needle), rows, n)
    return hit > 0


def first_match_pos(c: DeviceColumn, needle: bytes,
                    from_pos: int = 1) -> torch.Tensor:
    """1-based byte position (int32) of the first occurrence at or after
    ``from_pos``, 0 if none; an empty needle gives ``max(from_pos, 1)``
    (the reference's instr and locate)."""
    n = c.num_rows
    if len(needle) == 0:
        return torch.full((n,), max(from_pos, 1), dtype=torch.int32,
                          device=c.device)
    rows, rel = _positions(c)
    ok = _match_starts(c, needle) & (rel >= from_pos - 1)
    first = _segment_min(torch.where(ok, rel, torch.full_like(rel, _BIG)),
                         rows, n)
    return torch.where(first >= _BIG, torch.zeros_like(first),
                       first + 1).int()


# --------------------------------------------------------------------------
# concat / concat_ws
# --------------------------------------------------------------------------


def concat(cols: Sequence[DeviceColumn]) -> DeviceColumn:
    """Spark ``concat``: null if any input is null."""
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    lens = [_lens(c) for c in cols]
    ends = torch.stack(lens).cumsum(0)  # (k, n): end of each part

    def fill(rows, rel):
        out = torch.zeros(rel.shape, dtype=torch.uint8, device=rel.device)
        before = torch.zeros_like(rel)
        for k, c in enumerate(cols):
            end = ends[k][rows]
            part = (rel >= before) & (rel < end)
            out = torch.where(part, _take(c.data, _starts(c)[rows] + rel
                                          - before), out)
            before = end
        return out
    return _build(ends[-1], valid, fill)


def concat_ws(sep: bytes, cols: Sequence[DeviceColumn],
              validity: torch.Tensor) -> DeviceColumn:
    """Spark ``concat_ws``: the non-null inputs joined by ``sep`` (rows
    where ``validity`` is false come out null)."""
    m = len(sep)
    sep_t = torch.tensor(list(sep) or [0], dtype=torch.uint8,
                         device=validity.device)
    n = validity.numel()
    has_any = torch.zeros(n, dtype=torch.bool, device=validity.device)
    seps, parts = [], []
    for c in cols:
        s_len = torch.where(c.validity & has_any, m, 0)
        seps.append(s_len)
        parts.append(torch.where(c.validity, _lens(c), 0))
        has_any = has_any | c.validity
    widths = torch.stack([x for pair in zip(seps, parts) for x in pair])
    ends = widths.cumsum(0)

    def fill(rows, rel):
        out = torch.zeros(rel.shape, dtype=torch.uint8, device=rel.device)
        before = torch.zeros_like(rel)
        for k, c in enumerate(cols):
            sep_end = ends[2 * k][rows]
            end = ends[2 * k + 1][rows]
            in_sep = (rel >= before) & (rel < sep_end)
            out = torch.where(in_sep, sep_t[(rel - before).clamp(
                0, max(m - 1, 0))], out)
            in_part = (rel >= sep_end) & (rel < end)
            out = torch.where(in_part, _take(c.data, _starts(c)[rows] + rel
                                             - sep_end), out)
            before = end
        return out
    return _build(ends[-1], validity, fill)


# --------------------------------------------------------------------------
# trim, slices
# --------------------------------------------------------------------------


def slice_rows(c: DeviceColumn, start: torch.Tensor,
               length: torch.Tensor) -> DeviceColumn:
    """Each row's bytes [start, start + length) (already within the
    row)."""
    base = _starts(c) + start.long()
    return _build(length, c.validity,
                  lambda rows, rel: _take(c.data, base[rows] + rel))


def trim(c: DeviceColumn, chars: bytes, left: bool, right: bool
         ) -> DeviceColumn:
    """Strip the bytes of ``chars`` from a row's left and/or right end."""
    lut = torch.zeros(256, dtype=torch.bool, device=c.device)
    for b in chars:
        lut[b] = True
    n = c.num_rows
    lens = _lens(c)
    rows, rel = _positions(c)
    keep = ~lut[c.data.long()]
    first = _segment_min(torch.where(keep, rel, torch.full_like(rel, _BIG)),
                         rows, n)
    last = _segment_max(torch.where(keep, rel, torch.full_like(rel, -1)),
                        rows, n)
    start = torch.where(first >= _BIG, lens, first) if left else \
        torch.zeros_like(lens)
    end = last + 1 if right else lens
    return slice_rows(c, start, (end - start).clamp(min=0))


# --------------------------------------------------------------------------
# replace and substring_index (the compose scan)
# --------------------------------------------------------------------------


def _row_resets(c: DeviceColumn) -> torch.Tensor:
    resets = torch.zeros(c.data.numel(), dtype=torch.bool, device=c.device)
    starts = _starts(c)[_lens(c) > 0]
    resets[starts] = True
    return resets


def _greedy_takes(c: DeviceColumn, match: torch.Tensor, m: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-to-right non-overlapping choice of the matches (length ``m``)
    in each row: ``(take, covered)``, where a chosen match starts and which
    bytes lie in one. A countdown automaton (state 0 free, else the bytes
    left of the current match) composed by the segmented scan."""
    if m <= 1:
        return match, match
    dtype = torch.uint8 if m <= 256 else torch.int32
    busy = (torch.arange(m, device=c.device) - 1).clamp(min=0).to(dtype)
    fns = busy.expand(match.numel(), m).clone()
    fns[:, 0] = torch.where(match, m - 1, 0).to(dtype)
    resets = _row_resets(c)
    longest = int(_lens(c).max()) if c.num_rows else 0
    c_in = exclusive_states(segmented_compose(fns, resets, longest),
                            resets, 0)
    take = match & (c_in == 0)
    return take, take | (c_in > 0)


def replace(c: DeviceColumn, search: bytes, repl: bytes) -> DeviceColumn:
    """Spark ``replace(str, search, replace)``: every non-overlapping
    occurrence, left to right, replaced (an empty search changes
    nothing)."""
    m, r = len(search), len(repl)
    if m == 0 or c.data.numel() == 0:
        return c
    take, covered = _greedy_takes(c, _match_starts(c, search), m)
    rows, _ = _positions(c)
    cum_t = _exclusive_cumsum(take)
    cum_s = _exclusive_cumsum(~covered)
    off = c.offsets.long()
    n_takes = cum_t[off[1:]] - cum_t[off[:-1]]
    n_surv = cum_s[off[1:]] - cum_s[off[:-1]]
    lens = torch.where(c.validity, n_surv + n_takes * r, 0)
    offsets = make_offsets(lens)
    total = int(offsets[-1])
    pos = (offsets[:-1].long()[rows] + (cum_s[:-1] - cum_s[off[:-1]][rows])
           + (cum_t[:-1] - cum_t[off[:-1]][rows]) * r)
    out = torch.zeros(total, dtype=torch.uint8, device=c.device)
    out[pos[~covered]] = c.data[~covered]
    at = pos[take]
    for j, b in enumerate(repl):
        out[at + j] = b
    return DeviceColumn(T.STRING, out, c.validity, offsets)


def substring_index(c: DeviceColumn, delim: bytes, count: int
                    ) -> DeviceColumn:
    """Spark ``substring_index``: the part before the ``count``-th
    delimiter (count > 0) or after the ``-count``-th from the end (count <
    0); the whole row when it has fewer; empty for count 0 or an empty
    delimiter. Occurrences are the greedy non-overlapping ones."""
    n = c.num_rows
    lens = _lens(c)
    if count == 0 or len(delim) == 0:
        return slice_rows(c, torch.zeros_like(lens), torch.zeros_like(lens))
    if c.data.numel() == 0:
        return c
    m = len(delim)
    take, _ = _greedy_takes(c, _match_starts(c, delim), m)
    rows, rel = _positions(c)
    cum = _exclusive_cumsum(take)
    off = c.offsets.long()
    total = cum[off[1:]] - cum[off[:-1]]
    rank = cum[1:] - cum[off[:-1]][rows]  # 1-based at a taken position
    want = count if count > 0 else (total + count + 1)[rows]
    cut = _segment_min(torch.where(take & (rank == want), rel,
                                   torch.full_like(rel, _BIG)), rows, n)
    found = cut < _BIG
    if count > 0:
        return slice_rows(c, torch.zeros_like(lens),
                          torch.where(found, cut, lens))
    start = torch.where(found, cut + m, 0)
    return slice_rows(c, start, lens - start)


# --------------------------------------------------------------------------
# pad / repeat / reverse / translate / initcap
# --------------------------------------------------------------------------


def pad(c: DeviceColumn, target: int, pad_bytes: bytes, left: bool
        ) -> DeviceColumn:
    """lpad / rpad to ``target`` bytes (a longer row is cut to it; an
    empty pad only cuts)."""
    target = max(target, 0)
    lens = _lens(c)
    kept = lens.clamp(max=target)
    out_len = torch.full_like(lens, target) if pad_bytes else kept
    n_pad = out_len - kept
    plen = len(pad_bytes)
    p = torch.tensor(list(pad_bytes) or [0], dtype=torch.uint8,
                     device=c.device)
    base = _starts(c)

    def fill(rows, rel):
        if left:
            in_pad = rel < n_pad[rows]
            src = base[rows] + rel - n_pad[rows]
            pad_rel = rel
        else:
            in_pad = rel >= kept[rows]
            src = base[rows] + rel
            pad_rel = rel - kept[rows]
        d_pad = p[pad_rel.clamp(min=0) % max(plen, 1)]
        return torch.where(in_pad, d_pad, _take(c.data, src))
    return _build(out_len, c.validity, fill)


def repeat(c: DeviceColumn, times: int) -> DeviceColumn:
    times = max(times, 0)
    lens = _lens(c)
    base = _starts(c)
    return _build(lens * times, c.validity, lambda rows, rel: _take(
        c.data, base[rows] + rel % lens[rows].clamp(min=1)))


def reverse(c: DeviceColumn) -> DeviceColumn:
    """Byte-order reverse (a multi-byte character comes out reversed, as
    in the reference)."""
    rows, rel = _positions(c)
    src = _starts(c)[rows] + _lens(c)[rows] - 1 - rel
    return DeviceColumn(T.STRING, _take(c.data, src), c.validity, c.offsets)


def translate(c: DeviceColumn, frm: bytes, to: bytes) -> DeviceColumn:
    """Per-byte remap: the first occurrence of a byte in ``frm`` maps to
    the byte at its index in ``to``, and is deleted where ``to`` is
    shorter."""
    lut = np.arange(256, dtype=np.int16)
    seen = set()
    for i, b in enumerate(frm):
        if b not in seen:
            seen.add(b)
            lut[b] = to[i] if i < len(to) else -1
    mapped = torch.from_numpy(lut).to(c.device)[c.data.long()]
    keep = mapped >= 0
    rows, _ = _positions(c)
    cum = _exclusive_cumsum(keep)
    off = c.offsets.long()
    offsets = make_offsets(cum[off[1:]] - cum[off[:-1]])
    out = torch.zeros(int(offsets[-1]), dtype=torch.uint8, device=c.device)
    pos = offsets[:-1].long()[rows] + cum[:-1] - cum[off[:-1]][rows]
    out[pos[keep]] = mapped[keep].to(torch.uint8)
    return DeviceColumn(T.STRING, out, c.validity, offsets)


def initcap(c: DeviceColumn) -> DeviceColumn:
    """ASCII: a byte after a space (or a row's first byte) upper case,
    every other letter lower case."""
    d = c.data
    _, rel = _positions(c)
    prev = torch.roll(d, 1)
    word_start = (rel == 0) | (prev == ord(" "))
    lower = torch.where((d >= ord("A")) & (d <= ord("Z")), d + 32, d)
    upper = torch.where((d >= ord("a")) & (d <= ord("z")), d - 32, d)
    out = torch.where(word_start, upper, lower).to(torch.uint8)
    return DeviceColumn(T.STRING, out, c.validity, c.offsets)


# --------------------------------------------------------------------------
# ascii / chr
# --------------------------------------------------------------------------


def ascii_code(c: DeviceColumn) -> torch.Tensor:
    """The first byte (int32), 0 for an empty row."""
    first = _take(c.data, _starts(c)).int()
    return torch.where(_lens(c) > 0, first, 0)


def chr_of(codes: torch.Tensor, validity: torch.Tensor) -> DeviceColumn:
    """One byte ``code % 256`` a row; empty for a negative code."""
    n = codes.long()
    byte = torch.remainder(n, 256).to(torch.uint8)
    lens = (n >= 0).int()
    return _build(lens, validity, lambda rows, rel: byte[rows])


# --------------------------------------------------------------------------
# byte codecs: hex and base64
# --------------------------------------------------------------------------


def _hex_char(nib: torch.Tensor) -> torch.Tensor:
    return torch.where(nib < 10, nib + 48, nib + 55)


def hex_encode(c: DeviceColumn) -> DeviceColumn:
    """Each byte as two upper-case hex digits."""
    base = _starts(c)

    def fill(rows, rel):
        src = _take(c.data, base[rows] + rel // 2).long()
        nib = torch.where(rel % 2 == 0, src >> 4, src & 15)
        return _hex_char(nib)
    return _build(_lens(c) * 2, c.validity, fill)


def hex_of_long(x: torch.Tensor, validity: torch.Tensor) -> DeviceColumn:
    """Spark ``hex`` of a BIGINT: its two's complement in upper-case hex
    without leading zeros ("0" for 0). Nibbles come from the int64 bits
    by an arithmetic shift and a mask."""
    x = x.long()
    nibs = torch.stack([(x >> (4 * k)) & 15 for k in range(15, -1, -1)],
                       dim=1)  # (n, 16), most significant first
    nz = nibs != 0
    first = torch.where(nz.any(1), nz.int().argmax(1), 15)
    lens = 16 - first
    return _build(lens, validity, lambda rows, rel: _hex_char(
        nibs[rows, first[rows] + rel]))


def _hex_val(ch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, ok) of hex digit bytes."""
    c = ch.long()
    dig = (c >= 48) & (c <= 57)
    low = (c >= 97) & (c <= 102)
    up = (c >= 65) & (c <= 70)
    v = torch.where(dig, c - 48, torch.where(low, c - 87,
                                             torch.where(up, c - 55, 0)))
    return v, dig | low | up


def unhex(c: DeviceColumn) -> DeviceColumn:
    """Hex digits to bytes (BINARY): an odd count reads a leading 0; a row
    with a byte that is not a hex digit is null."""
    n = c.num_rows
    rows, _ = _positions(c)
    _, ok = _hex_val(c.data)
    bad = _segment_sum(~ok, rows, n) > 0
    lens = _lens(c)
    odd = lens % 2
    base = _starts(c)

    def fill(rows, rel):
        k = 2 * rel - odd[rows]
        hi, _ = _hex_val(_take(c.data, base[rows] + k))
        lo, _ = _hex_val(_take(c.data, base[rows] + k + 1))
        return torch.where(k >= 0, hi, 0) * 16 + lo
    return _build((lens + 1) // 2, c.validity & ~bad, fill, T.BINARY)


_B64 = (b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
        b"0123456789+/")


def base64_encode(c: DeviceColumn) -> DeviceColumn:
    """3 bytes to 4 characters, ``=`` padded (Spark ``base64``)."""
    tbl = torch.tensor(list(_B64), dtype=torch.uint8, device=c.device)
    lens = _lens(c)
    base = _starts(c)

    def fill(rows, rel):
        q, sub = rel // 4, rel % 4
        at = base[rows] + 3 * q
        ln = lens[rows]

        def byte(k):
            ok = 3 * q + k < ln
            return torch.where(ok, _take(c.data, at + k).long(), 0), ok
        b0, _ = byte(0)
        b1, ok1 = byte(1)
        b2, ok2 = byte(2)
        idx = torch.where(sub == 0, b0 >> 2, torch.where(
            sub == 1, ((b0 & 3) << 4) | (b1 >> 4), torch.where(
                sub == 2, ((b1 & 15) << 2) | (b2 >> 6), b2 & 63)))
        pad_here = ((sub == 2) & ~ok1) | ((sub == 3) & ~ok2)
        return torch.where(pad_here, 61, tbl[idx].long())
    return _build(4 * ((lens + 2) // 3), c.validity, fill)


def _b64_val(ch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = ch.long()
    up = (c >= 65) & (c <= 90)
    low = (c >= 97) & (c <= 122)
    dig = (c >= 48) & (c <= 57)
    v = torch.where(up, c - 65, torch.where(low, c - 71, torch.where(
        dig, c + 4, torch.where(c == 43, 62, torch.where(c == 47, 63, 0)))))
    return v, up | low | dig | (c == 43) | (c == 47)


def unbase64(c: DeviceColumn) -> DeviceColumn:
    """4 characters to 3 bytes (BINARY). Bytes outside the alphabet and
    ``=`` are dropped first (the lenient decoder Spark exposes); a row
    whose remaining length is not a multiple of 4, or with ``=`` before
    its last two places, is null."""
    n = c.num_rows
    _, okc = _b64_val(c.data)
    keep = okc | (c.data == 61)
    rows, _ = _positions(c)
    cum = _exclusive_cumsum(keep)
    off = c.offsets.long()
    k_off = make_offsets(cum[off[1:]] - cum[off[:-1]])
    kept = torch.zeros(int(k_off[-1]), dtype=torch.uint8, device=c.device)
    pos = k_off[:-1].long()[rows] + cum[:-1] - cum[off[:-1]][rows]
    kept[pos[keep]] = c.data[keep]
    s = DeviceColumn(T.STRING, kept, c.validity, k_off)
    lens = _lens(s)
    base = _starts(s)
    last1 = _take(s.data, base + lens - 1) == 61
    last2 = _take(s.data, base + lens - 2) == 61
    pads = ((lens > 0) & last1).long() + ((lens > 1) & last1 & last2).long()
    k_rows, k_rel = _positions(s)
    _, ok = _b64_val(s.data)
    char_ok = ok | ((s.data == 61) & (k_rel >= lens[k_rows] - 2))
    bad = _segment_sum(~char_ok, k_rows, n) > 0
    valid = c.validity & ~bad & (lens % 4 == 0)

    def fill(rows, rel):
        g, sub = rel // 3, rel % 3
        at = base[rows] + 4 * g
        v0, v1, v2, v3 = (_b64_val(_take(s.data, at + k))[0]
                          for k in range(4))
        return torch.where(sub == 0, (v0 << 2) | (v1 >> 4), torch.where(
            sub == 1, ((v1 & 15) << 4) | (v2 >> 2), ((v2 & 3) << 6) | v3))
    return _build((lens // 4 * 3 - pads).clamp(min=0), valid, fill,
                  T.BINARY)
