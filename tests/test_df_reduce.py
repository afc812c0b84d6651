"""The df64 reduction that serves the ms_df64 phase (``_sum_terms``: a
binary two-sum tree over the zero-padded flat terms) against the f64
reference; covers pow2 / ragged / tiny sizes and cancellation-heavy data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu.ops import df64 as df
from treeqp_tpu.ops.df64 import Df
from treeqp_tpu.solvers.ms_df64 import _sum_terms


def _mk(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    # cancellation-heavy: large paired +/- values plus a small signal
    a = rng.standard_normal(n) * scale
    a[: n // 2 * 2 : 2] *= 1e4
    a[1: n // 2 * 2 : 2] = -a[: n // 2 * 2 : 2][: n // 2] + rng.standard_normal(n // 2) * 1e-6
    x = jnp.asarray(a)  # f64 on CPU (x64 enabled in conftest)
    return df.from_f64(x), a


def _reduce(x):
    return _sum_terms([x])


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 1025, 50000])
def test_matches_f64_and_tree(n):
    xdf, a = _mk(n, seed=n)
    got = jax.jit(_reduce)(xdf)
    assert got.hi.shape == ()
    ref64 = np.sum(np.asarray(df.to_f64(xdf)))  # exact split, f64 sum
    got64 = float(got.hi) + float(got.lo)
    scale = max(np.sum(np.abs(a)), 1.0)
    assert abs(got64 - ref64) <= 1e-11 * scale
    # same accuracy class as the unpadded binary tree
    tree = df.df_sum(Df(xdf.hi[None], xdf.lo[None]), axis=1)
    tree64 = float(tree.hi[0]) + float(tree.lo[0])
    assert abs(got64 - tree64) <= 1e-11 * scale


def test_zero_padding_is_exact():
    xdf, _ = _mk(130, seed=3)
    got = _reduce(xdf)
    # appending explicit zeros must not change the result bit-for-bit
    pad = Df(jnp.concatenate([xdf.hi, jnp.zeros((126,), jnp.float32)]),
             jnp.concatenate([xdf.lo, jnp.zeros((126,), jnp.float32)]))
    got2 = _reduce(pad)
    assert float(got.hi) == float(got2.hi)
    assert float(got.lo) == float(got2.lo)


def test_oversize_chunked_fallback():
    # several term arrays of mixed shapes, over 2^18 elements in all, with
    # values spread over six decades: the reduction stays exact (two-sum of
    # zero padding is error-free)
    rng = np.random.default_rng(7)
    n = (1 << 18) + 1234
    v = rng.standard_normal(n) * 10.0**rng.integers(-3, 3, size=n)
    x = df.from_f64(jnp.asarray(v, jnp.float64))
    k = n // 3
    terms = [Df(x.hi[:k].reshape(-1, 2), x.lo[:k].reshape(-1, 2)),
             Df(x.hi[k:], x.lo[k:])]
    got = _sum_terms(terms)
    ref = float(np.sum(np.asarray(v, np.float64)))
    assert abs(float(got.hi) + float(got.lo) - ref) <= 1e-9 * max(1.0, abs(ref))
