"""Double-float ("df64") arithmetic: ~double precision from f32 pairs.

The dual-Newton f64 phase only needs high precision in a handful of
places (residuals, dual values, the exact Hessian action for iterative
refinement) — everything else can run in f32. This module provides those places with classic error-free-transform
double-float arithmetic (Dekker 1971; Hida-Li-Bailey QD): every value is
an unevaluated sum hi + lo of two f32s, giving ~2^-48 ≈ 3.6e-15 relative
accuracy, and every operation is a short sequence of ordinary f32 ops
that XLA fuses like any other elementwise code.

Correctness requirements (validated by tests/test_df64.py on every
backend):
  * f32 ops are IEEE round-to-nearest,
  * the compiler must not reassociate floating-point expressions
    (XLA preserves value semantics; `--xla_allow_excess_precision` only
    widens intermediate precision, which is harmless here).

Used by the dual-Newton "polish" phase (tdunes_multistage.py) replacing
the reference's f64 BLASFEO ops (treeQP computes everything in f64;
dual_Newton_tree.c:446-637 gradient/dual-value evaluation is the part
that genuinely needs it).

A Df value is a NamedTuple (hi, lo) of equal-shape f32 arrays and is a
pytree, so Df values pass through jit/scan/vmap transparently.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Df", "from_f64", "to_f64", "from_f32", "zeros_like",
    "add", "sub", "neg", "add_f32", "mul", "mul_f32", "df_sum",
    "dot", "where", "clip", "less", "scale_pow2",
]

# 2^12 + 1 (Veltkamp split for f32)
_SPLITTER = np.float32(4097.0)


class Df(NamedTuple):
    """Unevaluated sum ``hi + lo``, |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return self.hi.shape

    def __getitem__(self, idx):  # slicing conveniences (not tuple indexing)
        return Df(self.hi[idx], self.lo[idx])


# -- error-free transforms ---------------------------------------------------


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """s + e == a + b exactly, requires |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """a == hi + lo with hi, lo representable in 12 bits of mantissa."""
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker two-product, no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- conversions -------------------------------------------------------------


def from_f64(a) -> Df:
    """Split an f64 array into a df64 pair (exact for |a| < 3e38)."""
    hi = a.astype(jnp.float32)
    lo = (a - hi.astype(a.dtype)).astype(jnp.float32)
    return Df(hi, lo)


def from_f32(a) -> Df:
    a = jnp.asarray(a, jnp.float32)
    return Df(a, jnp.zeros_like(a))


def to_f64(x: Df):
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def zeros_like(x: Df) -> Df:
    return Df(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))


# -- arithmetic --------------------------------------------------------------


def add(x: Df, y: Df) -> Df:
    """Accurate (ieee-style) double-float addition: two-sums both words so
    the result stays ~1 df-ulp even under massive cancellation (QD's
    ddouble::ieee_add)."""
    s1, s2 = _two_sum(x.hi, y.hi)
    t1, t2 = _two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = _quick_two_sum(s1, s2)
    return Df(s1, s2)


def add_f32(x: Df, b) -> Df:
    s, e = _two_sum(x.hi, b)
    e = e + x.lo
    s, e = _quick_two_sum(s, e)
    return Df(s, e)


def neg(x: Df) -> Df:
    return Df(-x.hi, -x.lo)


def sub(x: Df, y: Df) -> Df:
    return add(x, neg(y))


def mul(x: Df, y: Df) -> Df:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = _quick_two_sum(p, e)
    return Df(p, e)


def mul_f32(x: Df, b) -> Df:
    p, e = _two_prod(x.hi, b)
    e = e + x.lo * b
    p, e = _quick_two_sum(p, e)
    return Df(p, e)


def scale_pow2(x: Df, s) -> Df:
    """Exact scaling by a power of two (or any exactly-representable f32
    whose products don't round — use only for powers of two)."""
    return Df(x.hi * s, x.lo * s)


def where(c, x: Df, y: Df) -> Df:
    return Df(jnp.where(c, x.hi, y.hi), jnp.where(c, x.lo, y.lo))


def less(x: Df, y: Df):
    """Full two-word comparison x < y (hi-word-only compares are off by up
    to one f32 ulp at the boundary — enough to leave a ~1e-7 bound
    violation in a clipped stage solution)."""
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def clip(x: Df, lo: Df, hi: Df) -> Df:
    y = where(less(x, lo), lo, x)
    return where(less(hi, y), hi, y)


# -- reductions --------------------------------------------------------------


def df_sum(x: Df, axis: int) -> Df:
    """Sum over one axis via a binary two-sum tree (error ~ log2(n) ulps)."""
    n = x.hi.shape[axis]
    hi = jnp.moveaxis(x.hi, axis, -1)
    lo = jnp.moveaxis(x.lo, axis, -1)
    while n > 1:
        m = n // 2
        if n % 2:  # fold the odd tail into lane 0's lo (exact two_sum later)
            a = Df(hi[..., : 2 * m : 2], lo[..., : 2 * m : 2])
            b = Df(hi[..., 1 : 2 * m : 2], lo[..., 1 : 2 * m : 2])
            s = add(a, b)
            s0 = add(s[..., :1], Df(hi[..., -1:], lo[..., -1:]))
            hi = jnp.concatenate([s0.hi, s.hi[..., 1:]], axis=-1)
            lo = jnp.concatenate([s0.lo, s.lo[..., 1:]], axis=-1)
        else:
            a = Df(hi[..., ::2], lo[..., ::2])
            b = Df(hi[..., 1::2], lo[..., 1::2])
            s = add(a, b)
            hi, lo = s.hi, s.lo
        n = m
    return Df(hi[..., 0], lo[..., 0])


def dot(a: Df, b: Df, axis: int = -1) -> Df:
    """Elementwise df64 product followed by a two-sum tree reduction: a
    ~1-ulp-per-level accurate replacement for an f64 contraction."""
    return df_sum(mul(a, b), axis=axis)
