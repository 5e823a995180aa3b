"""Arithmetic identities that kernel B's bf16 kernel relies on, checked on
the CPU in exact rational arithmetic.

The kernel's softmax divides every entry of a score row by the row's sum
as ``q = e * r; q' = fma(fma(-q, d, e), r, q)`` with ``r`` the correctly
rounded fp32 reciprocal of ``d`` (``__frcp_rn``): one reciprocal per row
in place of an IEEE division per entry. Markstein's theorem says ``q'`` is
the correctly rounded fp32 quotient ``e / d``, the one the plain twin's
``e / e.sum()`` gives; this test holds it on entries in [0, 1] (down to
e^-80) over sums in [1, 64], the range of a 64-entry softmax row.
"""

from fractions import Fraction

import numpy as np

F32 = np.float32


def _rn32(x: Fraction) -> np.float32:
    """The correctly rounded fp32 value of an exact rational (ties to
    even): the float64 rounding may be one fp32 step off, so the nearest
    of its neighbours wins."""
    c = F32(float(x))
    best = None
    for cand in (np.nextafter(c, F32(-np.inf)), c,
                 np.nextafter(c, F32(np.inf))):
        err = abs(Fraction(float(cand)) - x)
        even = int(np.array(cand).view(np.uint32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, cand)
    return best[1]


def _fma32(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_reciprocal_division_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 2000
    es = np.concatenate([rng.random(n // 2),
                         np.exp(-80 * rng.random(n // 2))]).astype(F32)
    ds = (1 + 63 * rng.random(n)).astype(F32)
    for e, d in zip(es, ds):
        r = _rn32(1 / Fraction(float(d)))
        q = F32(e * r)
        got = _fma32(_fma32(-q, d, e), r, q)
        assert got == _rn32(Fraction(float(e)) / Fraction(float(d))), (e, d)
