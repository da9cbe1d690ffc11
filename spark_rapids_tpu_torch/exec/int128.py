"""128-bit integer arithmetic over (hi, lo) int64 limb pairs (counterpart of
spark_rapids_tpu/exec/int128.py).

The device arithmetic of DECIMAL128 (precision 19-38): an unscaled value
v = hi * 2^64 + (lo read unsigned), two's complement. Every function is
exact mod 2^128 and bit-equal to the reference on every input. A device
column holds the pair as one ``(n, 2)`` int64 tensor ``[lo, hi]`` (Arrow's
own 16-byte little-endian decimal128 layout); ``split`` and ``pack`` turn
it into the pair these functions take and back.

torch has no uint64 shifts, adds or compares, so the reference's uint64
steps run on int64 bit patterns: wraparound ``+``/``*``, a masked logical
right shift (``_lsr``) and the sign-flip unsigned compare (``_ult``:
``x ^ 2^63`` keeps unsigned order under a signed compare). torch's ``//``
is floor division; it is only given non-negative operands here, where it
is the reference's truncating division.

The 16-bit-limb engine at the end (``mul_128_exact``,
``udivmod_256_by_128``, ``decimal_divide_128``) holds limbs on a trailing
axis of shape (..., L); every step is an elementwise int64 op or a gather
along that axis, and the Knuth-D loop is a fixed 9 x 8 unroll.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

_SIGN = -(1 << 63)        # the int64 with only bit 63 set
_MASK32 = 0xFFFFFFFF
_B16 = 1 << 16


def _s64(v: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def split(data: torch.Tensor) -> Pair:
    """(hi, lo) of an ``(n, 2)`` ``[lo, hi]`` column tensor."""
    return data[:, 1], data[:, 0]


def pack(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The ``(n, 2)`` ``[lo, hi]`` column tensor of a (hi, lo) pair."""
    return torch.stack([l, h], dim=1)


def from_i64(x: torch.Tensor) -> Pair:
    """Sign-extend an int64 into (hi, lo)."""
    x = x.long()
    return torch.where(x < 0, -1, 0).to(torch.int64), x


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned < on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def add(ah, al, bh, bl) -> Pair:
    lo = al + bl  # wraps
    carry = _ult(lo, al)
    return ah + bh + carry.long(), lo


def neg(h, l) -> Pair:
    lo = -l  # two's complement: ~l + 1 wraps correctly
    return -h - (l != 0).long(), lo


def sub(ah, al, bh, bl) -> Pair:
    nh, nl = neg(bh, bl)
    return add(ah, al, nh, nl)


def is_neg(h, l) -> torch.Tensor:
    return h < 0


def abs_(h, l) -> Pair:
    nh, nl = neg(h, l)
    m = is_neg(h, l)
    return torch.where(m, nh, h), torch.where(m, nl, l)


def cmp_lt(ah, al, bh, bl) -> torch.Tensor:
    return (ah < bh) | ((ah == bh) & _ult(al, bl))


def cmp_eq(ah, al, bh, bl) -> torch.Tensor:
    return (ah == bh) & (al == bl)


def mul_64x64(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Full signed 64x64 -> 128 product via 32-bit half words."""
    a, b = a.long(), b.long()
    a0, a1 = a & _MASK32, _lsr(a, 32)
    b0, b1 = b & _MASK32, _lsr(b, 32)
    p00 = a0 * b0  # each below 2^64: the bits of the unsigned product
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lsr(p00, 32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((mid & _MASK32) << 32)
    hi = p11 + _lsr(p01, 32) + _lsr(p10, 32) + _lsr(mid, 32)
    # unsigned -> signed correction: subtract b<<64 if a<0, a<<64 if b<0
    zero = torch.zeros_like(a)
    hi = hi - torch.where(a < 0, b, zero) - torch.where(b < 0, a, zero)
    return hi, lo


def mul_small(h, l, m: int) -> Pair:
    """(hi, lo) * m for a small positive Python int m (< 2^31)."""
    ph, pl = mul_64x64(l, torch.full_like(l, m))
    # l is the UNSIGNED low word here: add back the m * 2^64 that
    # mul_64x64's sign correction took off where l < 0
    ph = ph + torch.where(l < 0, m, 0).to(torch.int64)
    return ph + h * m, pl


def rescale10(h, l, k: int) -> Pair:
    """(hi, lo) * 10^k, k >= 0, exact mod 2^128."""
    while k > 0:
        step = min(k, 9)  # 10^9 < 2^31
        h, l = mul_small(h, l, 10 ** step)
        k -= step
    return h, l


def rescale10_checked(h, l, k: int, precision: int):
    """(hi, lo) * 10^k with Spark's overflow check made BEFORE the
    multiply: a product that wraps mod 2^128 could look in range, so rows
    whose magnitude is at least 10^(precision-k) are flagged (the caller
    nulls them) and multiplied as zero. Returns (hi, lo, overflow)."""
    if k <= 0:
        return h, l, overflow_mask(h, l, precision)
    if precision - k >= 1:
        ovf = overflow_mask(h, l, precision - k)
    else:
        ovf = ~cmp_eq(h, l, torch.zeros_like(h), torch.zeros_like(l))
    zero = torch.zeros_like(h)
    rh, rl = rescale10(torch.where(ovf, zero, h), torch.where(ovf, zero, l),
                       k)
    return rh, rl, ovf


def _udivmod_small(h, l, d: Union[torch.Tensor, int]):
    """Unsigned (hi, lo) // d and the remainder, for a divisor
    0 < d < 2^31: schoolbook long division over four 32-bit digits. Every
    partial value stays below 2^63, so int64 floor division is exact."""
    digits = [_lsr(h, 32), h & _MASK32, _lsr(l, 32), l & _MASK32]
    if not torch.is_tensor(d):
        d = torch.full_like(h, d)
    d = d.long()
    r = torch.zeros_like(d)
    qd = []
    for dig in digits:
        cur = (r << 32) | dig
        q = cur // d
        r = cur - q * d
        qd.append(q)
    return (qd[0] << 32) | qd[1], (qd[2] << 32) | qd[3], r


def div_small_half_up(h, l, d: torch.Tensor) -> Pair:
    """Signed (hi, lo) / d with ROUND_HALF_UP (away from zero); d > 0."""
    ah, al = abs_(h, l)
    qh, ql, r = _udivmod_small(ah, al, d)
    qh, ql = add(qh, ql, torch.zeros_like(qh), (2 * r >= d).long())
    nqh, nql = neg(qh, ql)
    m = is_neg(h, l)
    return torch.where(m, nqh, qh), torch.where(m, nql, ql)


def pow10_128(k: int) -> Tuple[int, int]:
    """(hi, lo) Python ints of 10^k (two's complement limbs)."""
    v = 10 ** k
    return _s64(v >> 64), _s64(v)


def overflow_mask(h, l, precision: int) -> torch.Tensor:
    """True where |value| >= 10^precision (Spark non-ANSI -> NULL)."""
    if precision >= 39:
        return torch.zeros_like(h, dtype=torch.bool)
    bh, bl = pow10_128(precision)
    ah, al = abs_(h, l)
    # abs of -2^127 stays negative; treat as overflow
    ge = ~cmp_lt(ah, al, torch.full_like(h, bh), torch.full_like(l, bl))
    return ge | (ah < 0)


def to_py_ints(h, l):
    """Host-side exact values: hi * 2^64 + lo read unsigned."""
    return [(hi << 64) + (lo & ((1 << 64) - 1))
            for hi, lo in zip(h.tolist(), l.tolist())]


def from_py_ints(vals, device="cpu") -> Pair:
    """Host-side split of Python ints into (hi, lo) int64 limb tensors."""
    hi = [_s64(v >> 64) for v in vals]
    lo = [_s64(v) for v in vals]
    return (torch.tensor(hi, dtype=torch.int64, device=device),
            torch.tensor(lo, dtype=torch.int64, device=device))


def sortable_keys(h, l) -> Pair:
    """Order-preserving (primary, secondary) int64 keys for a lexsort."""
    return h, l ^ _SIGN


def lo_halves(l: torch.Tensor) -> Pair:
    """The low word's two 32-bit halves (low, high), each non-negative: a
    sum of fewer than 2^31 of them stays below 2^63."""
    return l & _MASK32, _lsr(l, 32)


def from_part_sums(s0: torch.Tensor, s1: torch.Tensor,
                   sh: torch.Tensor) -> Pair:
    """(hi, lo) of a sum of 128-bit values from its parts' sums: ``s0`` and
    ``s1`` the sums of the low words' 32-bit halves (``lo_halves``), ``sh``
    of the high words (mod 2^64, as its place value allows). Exact mod
    2^128."""
    th, tl = add(_lsr(s1, 32), s1 << 32, torch.zeros_like(s0), s0)
    return th + sh, tl


# ---------------------------------------------------------------------------
# 16-bit-limb engine: exact 128 x 128 multiply and 256 / 128 divide
# ---------------------------------------------------------------------------


def _limbs8(h, l) -> torch.Tensor:
    """Unsigned (hi, lo) -> (..., 8) int64 limbs, little-endian 16-bit."""
    parts = []
    for word in (l, h):
        parts.append(word & 0xFFFF)
        for k in range(1, 4):
            parts.append(_lsr(word, 16 * k) & 0xFFFF)
    return torch.stack(parts, dim=-1)


def _from_limbs8(limbs: torch.Tensor) -> Pair:
    """(..., >= 8) limbs -> unsigned (hi, lo); limbs above 8 ignored."""
    lo = limbs[..., 0].clone()
    hi = limbs[..., 4].clone()
    for k in range(1, 4):
        lo = lo | (limbs[..., k] << (16 * k))
        hi = hi | (limbs[..., 4 + k] << (16 * k))
    return hi, lo


def _mul_limbs(a: torch.Tensor, b: torch.Tensor, out_n: int) -> torch.Tensor:
    """Schoolbook product of limb arrays (each limb < 2^16) -> out_n limbs.
    Column sums stay below 2^36 (at most 16 terms below 2^32), so the
    carries fit int64."""
    na, nb = a.shape[-1], b.shape[-1]
    out = []
    carry = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for k in range(out_n):
        v = carry
        for i in range(max(0, k - nb + 1), min(na, k + 1)):
            v = v + a[..., i] * b[..., k - i]
        out.append(v & (_B16 - 1))
        carry = v >> 16
    return torch.stack(out, dim=-1)


def mul_128_exact(ah, al, bh, bl, precision: int):
    """Signed 128 x 128 multiply with Spark's overflow-to-NULL: returns
    (hi, lo, overflow), overflow where |a * b| needs more than 128 bits or
    reaches 10^precision."""
    sa, sb = is_neg(ah, al), is_neg(bh, bl)
    aah, aal = abs_(ah, al)
    abh, abl = abs_(bh, bl)
    prod = _mul_limbs(_limbs8(aah, aal), _limbs8(abh, abl), 16)
    high_any = (prod[..., 8:] != 0).any(dim=-1)
    h, l = _from_limbs8(prod)
    nh, nl = neg(h, l)
    neg_out = sa != sb
    oh, ol = torch.where(neg_out, nh, h), torch.where(neg_out, nl, l)
    ovf = high_any | overflow_mask(oh, ol, precision) | is_neg(h, l)
    return oh, ol, ovf


def _clz16_limbs(v: torch.Tensor) -> torch.Tensor:
    """Per row, the left shift in bits that brings the top nonzero limb to
    position L-1 with its high bit set (0 when v == 0)."""
    L = v.shape[-1]
    idx = torch.full(v.shape[:-1], -1, dtype=torch.int64, device=v.device)
    for k in range(L):
        idx = torch.where(v[..., k] != 0, k, idx)
    top = torch.gather(v, -1, idx.clamp(0, L - 1)[..., None])[..., 0]
    tb = torch.zeros_like(idx)
    cur = top
    for b in (8, 4, 2, 1):
        fits = cur < (1 << (16 - b))
        tb = tb + torch.where(fits, b, 0)
        cur = torch.where(fits, cur << b, cur)
    return torch.where(idx < 0, 0, (L - 1 - idx) * 16 + tb)


def _shl_limbs(v: torch.Tensor, s: torch.Tensor, out_n: int) -> torch.Tensor:
    """Left-shift a limb array (n, L) by per-row s bits into out_n limbs."""
    L = v.shape[-1]
    sl, sb = s // 16, s % 16
    k = torch.arange(out_n, device=v.device)
    src = k[None, :] - sl[:, None]
    padded = torch.cat([v, torch.zeros(v.shape[:-1] + (max(out_n - L, 1),),
                                       dtype=torch.int64, device=v.device)],
                       dim=-1)
    top = padded.shape[-1] - 1
    base = torch.where((src >= 0) & (src < L),
                       torch.gather(padded, -1, src.clamp(0, top)), 0)
    below = torch.where((src >= 1) & (src - 1 < L),
                        torch.gather(padded, -1, (src - 1).clamp(0, top)), 0)
    sbx = sb[:, None]
    return ((base << sbx) | (below >> (16 - sbx))) & (_B16 - 1)


def _shr_limbs(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Right-shift a limb array (n, L) by per-row s bits."""
    L = v.shape[-1]
    sl, sb = s // 16, s % 16
    src = torch.arange(L, device=v.device)[None, :] + sl[:, None]
    base = torch.where(src < L, torch.gather(v, -1, src.clamp(0, L - 1)), 0)
    above = torch.where(src + 1 < L,
                        torch.gather(v, -1, (src + 1).clamp(0, L - 1)), 0)
    sbx = sb[:, None]
    return ((base >> sbx) | (above << (16 - sbx))) & (_B16 - 1)


def udivmod_256_by_128(u: torch.Tensor, v: torch.Tensor):
    """Knuth's algorithm D over rows: u (n, 16) limbs / v (n, 8) limbs ->
    (q (n, 9) limbs, r (n, 8) limbs). v must be nonzero (the caller masks
    division by zero). A fixed 9 x 8 unroll."""
    s = _clz16_limbs(v)
    vn = _shl_limbs(v, s, 8)
    un = list(_shl_limbs(u, s, 17).unbind(-1))
    B = _B16
    v_top = vn[..., 7].clamp(min=1)
    v_next = vn[..., 6]
    q_limbs = []
    for j in reversed(range(9)):  # 16 - 8 + 1 quotient positions
        top2 = un[j + 8] * B + un[j + 7]
        qhat = torch.clamp(top2 // v_top, max=B - 1)
        rhat = top2 - qhat * v_top
        for _ in range(2):  # at most two corrections (Knuth's Theorem B)
            over = (qhat * v_next > rhat * B + un[j + 6]) & (rhat < B)
            qhat = torch.where(over, qhat - 1, qhat)
            rhat = torch.where(over, rhat + v_top, rhat)
        # multiply-subtract qhat * vn from un[j .. j+8]
        borrow = torch.zeros_like(qhat)
        new_u = []
        for i in range(8):
            t = un[j + i] - qhat * vn[..., i] - borrow
            lim = t & (B - 1)
            new_u.append(lim)
            borrow = (lim - t) >> 16
        t = un[j + 8] - borrow
        neg_row = t < 0
        new_u.append(t & (B - 1))
        # add back one v where the estimate overshot
        qhat = torch.where(neg_row, qhat - 1, qhat)
        carry = torch.zeros_like(qhat)
        for i in range(8):
            t2 = new_u[i] + torch.where(neg_row, vn[..., i], 0) + carry
            un[j + i] = t2 & (B - 1)
            carry = t2 >> 16
        un[j + 8] = (new_u[8] + carry) & (B - 1)
        q_limbs.append(qhat)
    q = torch.stack(q_limbs[::-1], dim=-1)
    r = _shr_limbs(torch.stack(un[:8], dim=-1), s)  # denormalise
    return q, r


def _pow10_limbs(k: int, like: torch.Tensor) -> torch.Tensor:
    ph, pl = pow10_128(k)
    return _limbs8(torch.full_like(like, ph), torch.full_like(like, pl))


def decimal_divide_128(ah, al, bh, bl, shift_k: int, precision: int):
    """q = ROUND_HALF_UP(a * 10^shift_k / b) over signed 128-bit operands
    (Spark's decimal divide): returns (hi, lo, overflow_or_div0), shift_k
    in [0, 76]."""
    assert 0 <= shift_k <= 76, shift_k
    sa, sb = is_neg(ah, al), is_neg(bh, bl)
    aah, aal = abs_(ah, al)
    abh, abl = abs_(bh, bl)
    u = _mul_limbs(_limbs8(aah, aal), _pow10_limbs(min(shift_k, 38), ah), 16)
    big_ovf = torch.zeros_like(ah, dtype=torch.bool)
    if shift_k > 38:
        # a second stage into 24 limbs; spill past 256 bits means
        # |q| > 2^129 > 10^38: overflow whatever b is
        u24 = _mul_limbs(u, _pow10_limbs(shift_k - 38, ah), 24)
        big_ovf = (u24[..., 16:] != 0).any(dim=-1)
        u = u24[..., :16]
    v = _limbs8(abh, abl)
    div0 = ~(v != 0).any(dim=-1)
    v_safe = v.clone()
    v_safe[..., 0] = torch.where(div0, 1, v[..., 0])
    q, r = udivmod_256_by_128(u, v_safe)
    # HALF_UP: 2r >= |b|, compared limbwise (2r as 9 limbs, v as 8)
    two_r = _mul_limbs(r, torch.full(r.shape[:-1] + (1,), 2,
                                     dtype=torch.int64, device=r.device), 9)
    ge = torch.zeros_like(div0)
    decided = torch.zeros_like(div0)
    for k in reversed(range(9)):
        tv = two_r[..., k]
        vv = v[..., k] if k < 8 else torch.zeros_like(tv)
        gt = ~decided & (tv > vv)
        lt = ~decided & (tv < vv)
        ge = ge | gt
        decided = decided | gt | lt
    ge = ge | ~decided  # equal: round up (HALF_UP)
    qh, ql = _from_limbs8(q)
    qh, ql = add(qh, ql, torch.zeros_like(qh), ge.long())
    q_high = q[..., 8] != 0
    # the UNSIGNED magnitude bound before the sign is applied: quotients in
    # [10^precision, 2^128) would otherwise wrap the signed pair and slip
    # past overflow_mask
    bph, bpl = pow10_128(min(precision, 38))
    bph_t, bpl_t = torch.full_like(qh, bph), torch.full_like(ql, bpl)
    mag_lt = _ult(qh, bph_t) | ((qh == bph_t) & _ult(ql, bpl_t))
    nh, nl = neg(qh, ql)
    neg_out = sa != sb
    oh, ol = torch.where(neg_out, nh, qh), torch.where(neg_out, nl, ql)
    return oh, ol, q_high | ~mag_lt | div0 | big_ovf


def decimal_avg_128(sh, sl, cnt, d: int, out_precision: int):
    """avg = HALF_UP(sum / cnt) rescaled by 10^d into the result scale
    (the aggregate's and the window's decimal average): divide FIRST, so
    the rescale of the small remainder cannot wrap 2^127. Returns (hi,
    lo, overflow)."""
    den = torch.clamp(cnt.long(), min=1)
    ah, al = abs_(sh, sl)
    q1h, q1l, r = _udivmod_small(ah, al, den)
    pre_ovf = overflow_mask(q1h, q1l, max(out_precision - d, 1))
    S = 10 ** d
    frac = r * S
    f_q = frac // den
    f_r = frac - f_q * den
    f_q = f_q + (2 * f_r >= den).long()
    qh, ql = mul_small(q1h, q1l, S)
    qh, ql = add(qh, ql, torch.zeros_like(f_q), f_q)
    nh, nl = neg(qh, ql)
    neg_in = is_neg(sh, sl)
    oh, ol = torch.where(neg_in, nh, qh), torch.where(neg_in, nl, ql)
    return oh, ol, pre_ovf | overflow_mask(oh, ol, out_precision)
