"""df64 (double-float) arithmetic: error-free transforms must deliver
~2^-48 relative accuracy after jit compilation on the test backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu.ops import df64 as df


def _rand(key, shape, scale_pow=12):
    """Values spanning ~2^±scale_pow around 1 with dirty mantissas."""
    k1, k2 = jax.random.split(key)
    mant = jax.random.uniform(k1, shape, jnp.float64, 1.0, 2.0)
    ex = jax.random.randint(k2, shape, -scale_pow, scale_pow + 1)
    sign = jnp.where(jax.random.bernoulli(k1, 0.5, shape), 1.0, -1.0)
    return sign * mant * (2.0 ** ex.astype(jnp.float64))


def test_roundtrip_48bit():
    """from_f64 keeps ~48 mantissa bits (hi 24 + lo 24)."""
    a = _rand(jax.random.PRNGKey(0), (257,))
    got = np.asarray(df.to_f64(df.from_f64(a)))
    rel = np.abs(got - np.asarray(a)) / np.abs(np.asarray(a))
    assert rel.max() < 2.0**-47


@pytest.mark.parametrize("op,dfop", [
    (lambda a, b: a + b, df.add),
    (lambda a, b: a - b, df.sub),
    (lambda a, b: a * b, df.mul),
])
def test_binary_ops(op, dfop):
    key = jax.random.PRNGKey(1)
    a = _rand(key, (1024,))
    b = _rand(jax.random.PRNGKey(2), (1024,))
    got = np.asarray(df.to_f64(jax.jit(
        lambda a, b: dfop(df.from_f64(a), df.from_f64(b)))(a, b)))
    want = np.asarray(op(a, b))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 1e-13, rel.max()


def test_cancellation():
    """x + y with y ~ -x: the classic f32 killer. The df64 add itself is
    error-free; the only loss is the 48-bit input rounding, so the result
    must match the f64 sum of the rounded inputs to ~1 ulp."""
    a = _rand(jax.random.PRNGKey(3), (512,))
    b = -a * (1.0 + np.float64(2.0) ** -30)
    xa, xb = df.from_f64(a), df.from_f64(b)
    got = np.asarray(df.to_f64(jax.jit(df.add)(xa, xb)))
    want = np.asarray(df.to_f64(xa) + df.to_f64(xb))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 1e-12, rel.max()
    # and the result still beats plain f32 by ~9 digits
    f32res = (a.astype(jnp.float32) + b.astype(jnp.float32)).astype(jnp.float64)
    assert np.median(np.abs(np.asarray(f32res) - want)) > \
        1e6 * np.median(np.abs(got - want))


def test_dot_matches_f64():
    key = jax.random.PRNGKey(4)
    a = _rand(key, (64, 8), scale_pow=8)
    b = _rand(jax.random.PRNGKey(5), (64, 8), scale_pow=8)
    got = np.asarray(df.to_f64(jax.jit(
        lambda a, b: df.dot(df.from_f64(a), df.from_f64(b), axis=-1))(a, b)))
    want = np.einsum("ni,ni->n", np.asarray(a), np.asarray(b))
    scale = np.einsum("ni,ni->n", np.abs(a), np.abs(b))
    assert (np.abs(got - want) / scale).max() < 1e-13


@pytest.mark.slow
def test_df_sum_odd_sizes():
    for n in (1, 2, 3, 7, 20, 33, 256):
        a = _rand(jax.random.PRNGKey(n), (5, n), scale_pow=6)
        got = np.asarray(df.to_f64(jax.jit(
            lambda a: df.df_sum(df.from_f64(a), axis=1))(a)))
        want = np.asarray(a).sum(axis=1)
        scale = np.abs(np.asarray(a)).sum(axis=1) + 1e-300
        assert (np.abs(got - want) / scale).max() < 1e-13, n


def test_clip_where():
    a = _rand(jax.random.PRNGKey(8), (300,), scale_pow=4)
    lo, hi = -1.5, 2.5
    got = np.asarray(df.to_f64(jax.jit(lambda a: df.clip(
        df.from_f64(a),
        df.from_f32(jnp.full(a.shape, lo, jnp.float32)),
        df.from_f32(jnp.full(a.shape, hi, jnp.float32))))(a)))
    want = np.clip(np.asarray(a), lo, hi)
    assert np.abs(got - want).max() < 1e-13


def test_mul_f32_add_f32():
    a = _rand(jax.random.PRNGKey(9), (256,), scale_pow=6)
    s = jnp.float32(1.7)
    got = np.asarray(df.to_f64(jax.jit(
        lambda a: df.add_f32(df.mul_f32(df.from_f64(a), s), jnp.float32(0.3)))(a)))
    want = np.asarray(a) * np.float64(np.float32(1.7)) + np.float64(np.float32(0.3))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 1e-13


@pytest.mark.slow
def test_df64_newton_step_matches_f64_loop():
    """Per-iteration trajectory equivalence of the df64 phase (SURVEY 7
    hard-part 6 / SAVE_DATA analog): ONE Newton step of the df64 loop
    from a common warm point must match the emulated-f64 loop's step to
    the df64 arithmetic accuracy — not just the final answers."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.solvers.tdunes import TdunesOpts
    from treeqp_tpu.solvers import tdunes_multistage as tm
    from treeqp_tpu.solvers.ms_df64 import ms_newton_loop_df

    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=10)
    ms = tm.split_multistage(qp)
    base = TdunesOpts(stage_solver="clipping", tol=1e-9, max_iter=40,
                      factor_dtype="float32", refine_steps=2,
                      refine_safeguard=False,
                      reg_type="always", reg_value=1e-6)
    # a warm point: a few plain iterations in
    cro, cho, _ = tm.tdunes_ms_solve(
        ms, None, None,
        TdunesOpts(stage_solver="clipping", tol=1e-2, max_iter=10))
    lam_cr0, lam_ch0 = cro["lam"], cho["lam"]

    one = TdunesOpts(**{**base.__dict__, "max_iter": 1})
    # emulated-f64 step
    r64 = tm._ms_newton_loop(ms, lam_cr0, lam_ch0, one, 0)
    lam_cr64, lam_ch64 = r64[0], r64[1]
    # df64 step
    rdf = ms_newton_loop_df(ms, lam_cr0, lam_ch0, one, 0)
    lam_crdf, lam_chdf = rdf[0], rdf[1]
    scale = max(float(jnp.max(jnp.abs(lam_cr64))),
                float(jnp.max(jnp.abs(lam_ch64))), 1.0)
    assert float(jnp.max(jnp.abs(lam_cr64 - lam_crdf))) / scale < 1e-9
    assert float(jnp.max(jnp.abs(lam_ch64 - lam_chdf))) / scale < 1e-9
