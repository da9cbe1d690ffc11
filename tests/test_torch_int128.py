"""The port's 128-bit arithmetic (spark_rapids_tpu_torch.exec.int128) held
bit for bit against the JAX package's (spark_rapids_tpu.exec.int128) on
the same seeded numpy operands and on the edges: +-(2^127 - 1), -2^127,
+-(10^38 - 1), 10^18 boundaries, 2^63 and 2^64 neighbours, zero divisors,
operands of mixed sign, HALF_UP ties of both signs, and divide rescales
``shift_k`` of 0, 38 and 39-76."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.exec import int128 as JI
from spark_rapids_tpu_torch.exec import int128 as PI

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

_EDGES = [0, 1, -1, 2, -2, 5, -5, 10, -10, (1 << 63) - 1, -(1 << 63),
          1 << 63, -(1 << 63) - 1, (1 << 64) - 1, 1 << 64, -(1 << 64),
          (1 << 127) - 1, -(1 << 127) + 1, -(1 << 127), 10 ** 18,
          -10 ** 18, 10 ** 18 - 1, 10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 38,
          10 ** 19, 12345678901234567890123, -98765432109876543210,
          (1 << 96) + 7, -(1 << 100) - 3, 15, -15, 25, -25]


def _wrap(v: int) -> int:
    """v as a signed 128-bit value (two's complement wrap)."""
    v &= (1 << 128) - 1
    return v - (1 << 128) if v >= (1 << 127) else v


def _values(n: int, seed: int):
    """``n`` seeded 128-bit values of every magnitude, then the edges."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 128, n)
    mags = [int(rng.integers(0, 1 << 62)) << 66 | int(rng.integers(0, 1 << 62))
            << 4 | int(rng.integers(0, 16)) for _ in range(n)]
    vals = [_wrap((m >> (128 - int(b))) * (1 if rng.random() < 0.5 else -1))
            for m, b in zip(mags, bits)]
    return vals + [_wrap(e) for e in _EDGES]


def _pairs(n: int, seed: int):
    """(a, b) operand lists: random x random, and every edge x every
    edge."""
    a, b = _values(n, seed), _values(n, seed + 1)
    ea = [_wrap(e) for e in _EDGES]
    return (a + [x for x in ea for _ in ea], b + [y for _ in ea for y in ea])


def _both(vals):
    """(port (hi, lo) tensors, reference (hi, lo) arrays) of ``vals``."""
    ph, pl = PI.from_py_ints(vals)
    jh, jl = JI.from_py_ints(vals)
    return (ph, pl), (jnp.asarray(jh), jnp.asarray(jl))


def _same(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def _small_divisors(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(1, (1 << 31) - 1, n + len(_EDGES))
    d[:8] = [1, 2, 3, 10, 7, (1 << 31) - 2, 1000000000, 4]
    return d


UNARY = {
    "neg": lambda M, h, l: M.neg(h, l),
    "abs_": lambda M, h, l: M.abs_(h, l),
    "is_neg": lambda M, h, l: (M.is_neg(h, l),),
    "sortable_keys": lambda M, h, l: M.sortable_keys(h, l),
    "rescale10_k3": lambda M, h, l: M.rescale10(h, l, 3),
    "rescale10_k20": lambda M, h, l: M.rescale10(h, l, 20),
    "rescale10_checked_k4_p38": lambda M, h, l: M.rescale10_checked(
        h, l, 4, 38),
    "rescale10_checked_k2_p21": lambda M, h, l: M.rescale10_checked(
        h, l, 2, 21),
    "rescale10_checked_k0_p20": lambda M, h, l: M.rescale10_checked(
        h, l, 0, 20),
    "rescale10_checked_k38_p38": lambda M, h, l: M.rescale10_checked(
        h, l, 38, 38),
    "mul_small_7": lambda M, h, l: M.mul_small(h, l, 7),
    "mul_small_1e9": lambda M, h, l: M.mul_small(h, l, 10 ** 9),
    "overflow_mask_p38": lambda M, h, l: (M.overflow_mask(h, l, 38),),
    "overflow_mask_p18": lambda M, h, l: (M.overflow_mask(h, l, 18),),
    "overflow_mask_p39": lambda M, h, l: (M.overflow_mask(h, l, 39),),
}


@pytest.mark.parametrize("fn", sorted(UNARY))
def test_unary_matches_jax(fn):
    (ph, pl), (jh, jl) = _both(_values(400, 3))
    _same(UNARY[fn](PI, ph, pl), UNARY[fn](JI, jh, jl))


BINARY = {
    "add": lambda M, a, b: M.add(*a, *b),
    "sub": lambda M, a, b: M.sub(*a, *b),
    "cmp_lt": lambda M, a, b: (M.cmp_lt(*a, *b),),
    "cmp_eq": lambda M, a, b: (M.cmp_eq(*a, *b),),
    "mul_128_exact_p38": lambda M, a, b: M.mul_128_exact(*a, *b, 38),
    "mul_128_exact_p27": lambda M, a, b: M.mul_128_exact(*a, *b, 27),
    "mul_64x64_lo_words": lambda M, a, b: M.mul_64x64(a[1], b[1]),
}


@pytest.mark.parametrize("fn", sorted(BINARY))
def test_binary_matches_jax(fn):
    a, b = _pairs(300, 7)
    pa_, ja = _both(a)
    pb_, jb = _both(b)
    _same(BINARY[fn](PI, pa_, pb_), BINARY[fn](JI, ja, jb))


@pytest.mark.parametrize("fn", ["udivmod_small", "div_small_half_up"])
def test_small_division_matches_jax(fn):
    vals = _values(400, 11)
    (ph, pl), (jh, jl) = _both(vals)
    d = _small_divisors(400, 12)
    if fn == "udivmod_small":
        # unsigned operands, as its callers pass (magnitudes)
        (ph, pl), (jh, jl) = PI.abs_(ph, pl), JI.abs_(jh, jl)
        got = PI._udivmod_small(ph, pl, torch.from_numpy(d))
        exp = JI._udivmod_small(jh, jl, jnp.asarray(d))
    else:
        got = PI.div_small_half_up(ph, pl, torch.from_numpy(d))
        exp = JI.div_small_half_up(jh, jl, jnp.asarray(d))
    _same(got, exp)


def test_half_up_ties_of_both_signs():
    """Exact .5 quotients round away from zero on both signs."""
    vals = [15, -15, 25, -25, 5, -5, 14, -14, 16, -16]
    (ph, pl), (jh, jl) = _both(vals)
    d = np.full(len(vals), 10, np.int64)
    got = PI.div_small_half_up(ph, pl, torch.from_numpy(d))
    _same(got, JI.div_small_half_up(jh, jl, jnp.asarray(d)))
    assert PI.to_py_ints(*got) == [2, -2, 3, -3, 1, -1, 1, -1, 2, -2]


@pytest.mark.parametrize("shift_k,precision", [
    (0, 38), (6, 38), (20, 37), (38, 38), (39, 38), (50, 38), (76, 38),
    (16, 38), (10, 17), (20, 21)])
def test_decimal_divide_128_matches_jax(shift_k, precision):
    a, b = _pairs(250, 21 + shift_k)
    # zero divisors and small divisors whose quotient ties at .5
    a += [0, 7, -7, 1, -1, 5, -5, 15, -15]
    b += [0, 0, 0, 2, 2, 10, 10, 10, -10]
    pa_, ja = _both(a)
    pb_, jb = _both(b)
    got = PI.decimal_divide_128(*pa_, *pb_, shift_k, precision)
    exp = JI.decimal_divide_128(*ja, *jb, shift_k, precision)
    _same(got, exp)
    ovf = got[2].numpy()
    assert ovf[-9:-6].all()  # division by zero
    if shift_k == 0:  # HALF_UP away from zero on both signs
        q = PI.to_py_ints(got[0][-6:], got[1][-6:])
        assert q == [1, -1, 1, -1, 2, 2]


@pytest.mark.parametrize("d,precision", [(4, 21), (4, 38), (6, 38), (0, 27),
                                         (4, 18)])
def test_decimal_avg_128_matches_jax(d, precision):
    vals = _values(400, 31 + d)
    (ph, pl), (jh, jl) = _both(vals)
    cnt = _small_divisors(400, 32)
    cnt[:3] = [0, 1, 2]  # a count of 0 reads as 1
    got = PI.decimal_avg_128(ph, pl, torch.from_numpy(cnt), d, precision)
    exp = JI.decimal_avg_128(jh, jl, jnp.asarray(cnt), d, precision)
    _same(got, exp)


def test_limb_round_trips_and_python_ints():
    vals = _values(200, 41)
    h, l = PI.from_py_ints(vals)
    assert PI.to_py_ints(h, l) == vals
    assert PI.to_py_ints(*PI._from_limbs8(PI._limbs8(h, l))) == vals
    data = PI.pack(h, l)
    assert data.shape == (len(vals), 2)
    h2, l2 = PI.split(data)
    assert PI.to_py_ints(h2, l2) == vals
    x = torch.tensor([-(1 << 63), -1, 0, 5, (1 << 63) - 1])
    assert PI.to_py_ints(*PI.from_i64(x)) == x.tolist()
    _same(PI.from_i64(x), JI.from_i64(jnp.asarray(x.numpy())))
    assert PI.pow10_128(38) == JI.pow10_128(38)
    assert PI.pow10_128(19) == JI.pow10_128(19)
