"""Pallas (Triton route) kernels for the banded chain sweeps of the
multistage solver.

The reference's hot loop is BLASFEO's per-node panel-major Cholesky/trsm
(dual_Newton_tree.c:668-735, dual_Newton_scenarios.c:590-689). In the
multistage solver it is S independent chains of L tiny (nx x nx, nx <= 16)
factorizations. XLA runs each ``lax.scan`` step of such a sweep as several
small launches, so the sweep is bound by launch latency, not by FLOPs. These
kernels run each whole sweep as ONE launch:

* scenarios are the minor axis (``[L, n, n, S]`` kernel layout), so each
  thread owns one scenario and every load is coalesced along S;
* the grid runs over independent scenario tiles of ``_TS`` lanes; the L loop
  is a ``fori_loop`` inside the program, carrying the Schur complement (or the
  RHS accumulator) in registers — nothing carries between programs;
* the n x n algebra is unrolled over per-lane scalars, in the input dtype
  (f64 natively, f32 with ``factor_dtype="float32"``);
* regularization follows ``tdunes._reg_cholesky`` exactly: none, always-LM,
  or the on-the-fly LM cascade (shift x1, x1e3, x1e6 where the plain
  factorization has a non-finite entry or a pivot <= reg_tol).

The factors stay in the kernel layout between calls: ``chain_factor``
returns them as an opaque handle that only ``chain_solve_bwd`` and
``chain_forward`` read. On the CPU the kernels run in the Pallas
interpreter (tests); on a GPU they compile through Triton.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["chain_factor", "chain_solve_bwd", "chain_forward"]

_TS = 32  # scenarios per program: one warp, one scenario per thread
_PARAMS = plgpu.CompilerParams(num_warps=1, num_stages=1)


def _call(kernel, *, grid, in_specs, out_specs, out_shape):
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, backend="triton", compiler_params=_PARAMS,
        interpret=jax.default_backend() == "cpu")


def _spec(*lead):
    """Block of all leading dims x one scenario tile."""
    nl = len(lead)
    return pl.BlockSpec((*lead, _TS), lambda i: (0,) * nl + (i,))


def _pad_s(x, S_pad):
    pad = S_pad - x.shape[-1]
    if pad == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _s_pad(S):
    return -(-S // _TS) * _TS


# --- unrolled per-lane algebra (lists of [_TS] vectors; lower triangles
# are indexed M[a][b] with b <= a)


def _chol(M, n):
    """Unregularized lower Cholesky. A non-positive pivot yields NaN, which
    the on-the-fly cascade detects like a failed LAPACK factorization."""
    Lf = [[None] * n for _ in range(n)]
    for k in range(n):
        d = M[k][k]
        for m in range(k):
            d = d - Lf[k][m] * Lf[k][m]
        dk = jnp.sqrt(d)
        Lf[k][k] = dk
        for i in range(k + 1, n):
            a = M[i][k]
            for m in range(k):
                a = a - Lf[i][m] * Lf[k][m]
            Lf[i][k] = a / dk
    return Lf


def _shift(M, n, s):
    return [[M[a][b] + s if a == b else M[a][b] for b in range(a + 1)]
            for a in range(n)]


def _bad(Lf, n, reg_tol):
    big = jnp.finfo(Lf[0][0].dtype).max
    bad = None
    for a in range(n):
        for b in range(a + 1):
            v = Lf[a][b]
            # |v| <= max is false for NaN and +-inf
            e = ~(jnp.abs(v) <= big)
            if a == b:
                e = e | (v <= reg_tol)
            bad = e if bad is None else bad | e
    return bad


def _reg_chol(M, n, reg):
    """Lower Cholesky with ``tdunes._reg_cholesky``'s regularization."""
    reg_type, reg_value, reg_tol = reg
    if reg_type == "none":
        return _chol(M, n)
    if reg_type == "always":
        return _chol(_shift(M, n, reg_value), n)
    Lf = _chol(M, n)
    for scale in (1.0, 1e3, 1e6):
        bad = _bad(Lf, n, reg_tol)
        Lr = _chol(_shift(M, n, scale * reg_value), n)
        Lf = [[jnp.where(bad, Lr[a][b], Lf[a][b]) for b in range(a + 1)]
              for a in range(n)]
    return Lf


def _load_lower(ref, j, n):
    return [[ref[j, a, b, :] for b in range(a + 1)] for a in range(n)]


@partial(jax.jit, static_argnames=("reg",))
def chain_factor(Wc, Utc, reg=("on_the_fly", 1e-6, 1e-6)):
    """Fused banded backward factorization, j = L-1 .. 0.

    Wc, Utc: [S, L, n, n] (equilibrated dual-Hessian chain blocks);
    ``reg`` = (reg_type, reg_value, reg_tol) as in TdunesOpts. Returns
    (Ls, CUs, schur0): the factors in kernel layout [L, n, n, S_pad] and the
    Schur complement flowing into the crown, [S, n, n]."""
    S, L, n, _ = Wc.shape
    S_pad = _s_pad(S)
    dt = Wc.dtype
    Wt = _pad_s(jnp.transpose(Wc, (1, 2, 3, 0)), S_pad)
    # identity on padded lanes keeps their factorization finite
    eye = jnp.eye(n, dtype=dt)[:, :, None]
    Wt = Wt + jnp.where(jnp.arange(S_pad) >= S, eye, 0.0)[None]
    Ut = _pad_s(jnp.transpose(Utc, (1, 2, 3, 0)), S_pad)

    def kernel(W_ref, Ut_ref, L_ref, CU_ref, schur_ref):
        zero = jnp.zeros((_TS,), dt)

        def step(i, schur):
            j = L - 1 - i
            W = _load_lower(W_ref, j, n)
            k = 0
            M = []
            for a in range(n):
                row = []
                for b in range(a + 1):
                    row.append(W[a][b] - schur[k])
                    k += 1
                M.append(row)
            Lf = _reg_chol(M, n, reg)
            # X L' = Ut (trsm_rltn), column by column
            CU = [[None] * n for _ in range(n)]
            for c in range(n):
                for a in range(n):
                    acc = Ut_ref[j, a, c, :]
                    for m in range(c):
                        acc = acc - CU[a][m] * Lf[c][m]
                    CU[a][c] = acc / Lf[c][c]
            for a in range(n):
                for b in range(n):
                    L_ref[j, a, b, :] = Lf[a][b] if b <= a else zero
                    CU_ref[j, a, b, :] = CU[a][b]
            new = []
            for a in range(n):
                for b in range(a + 1):
                    s = CU[a][0] * CU[b][0]
                    for m in range(1, n):
                        s = s + CU[a][m] * CU[b][m]
                    new.append(s)
            return tuple(new)

        schur = jax.lax.fori_loop(jnp.int32(0), jnp.int32(L), step,
                                  (zero,) * (n * (n + 1) // 2))
        k = 0
        for a in range(n):
            for b in range(a + 1):
                schur_ref[a, b, :] = schur[k]
                schur_ref[b, a, :] = schur[k]
                k += 1

    Ls, CUs, schur0 = _call(
        kernel, grid=(S_pad // _TS,),
        in_specs=[_spec(L, n, n), _spec(L, n, n)],
        out_specs=(_spec(L, n, n), _spec(L, n, n), _spec(n, n)),
        out_shape=(jax.ShapeDtypeStruct((L, n, n, S_pad), dt),
                   jax.ShapeDtypeStruct((L, n, n, S_pad), dt),
                   jax.ShapeDtypeStruct((n, n, S_pad), dt)),
    )(Wt, Ut)
    return Ls, CUs, jnp.transpose(schur0[..., :S], (2, 0, 1))


@jax.jit
def chain_solve_bwd(Lt, CUt, res):
    """Fused RHS backward sweep: y_j = L_j^-1 (r_j - CU_{j+1} y_{j+1}).

    Lt/CUt are chain_factor's kernel-layout factors; res [S, L, n]. Returns
    (ys in kernel layout [L, n, S_pad], for chain_forward; radd0 [S, n])."""
    L, n, _, S_pad = Lt.shape
    S = res.shape[0]
    dt = Lt.dtype
    rt = _pad_s(jnp.transpose(res.astype(dt), (1, 2, 0)), S_pad)

    def kernel(L_ref, CU_ref, r_ref, y_ref, radd_ref):
        def step(i, radd):
            j = L - 1 - i
            Lf = _load_lower(L_ref, j, n)
            y = []
            for a in range(n):
                acc = r_ref[j, a, :] - radd[a]
                for m in range(a):
                    acc = acc - Lf[a][m] * y[m]
                y.append(acc / Lf[a][a])
            new = []
            for a in range(n):
                y_ref[j, a, :] = y[a]
                s = CU_ref[j, a, 0, :] * y[0]
                for m in range(1, n):
                    s = s + CU_ref[j, a, m, :] * y[m]
                new.append(s)
            return tuple(new)

        radd = jax.lax.fori_loop(jnp.int32(0), jnp.int32(L), step,
                                 (jnp.zeros((_TS,), dt),) * n)
        for a in range(n):
            radd_ref[a, :] = radd[a]

    ys, radd0 = _call(
        kernel, grid=(S_pad // _TS,),
        in_specs=[_spec(L, n, n), _spec(L, n, n), _spec(L, n)],
        out_specs=(_spec(L, n), _spec(n)),
        out_shape=(jax.ShapeDtypeStruct((L, n, S_pad), dt),
                   jax.ShapeDtypeStruct((n, S_pad), dt)),
    )(Lt, CUt, rt)
    return ys, jnp.transpose(radd0[:, :S], (1, 0))


@jax.jit
def chain_forward(Lt, CUt, ys, droot):
    """Fused forward substitution: dl_j = L_j^-T (y_j - CU_j' dl_{j-1}).

    Lt/CUt: kernel-layout factors; ys: chain_solve_bwd's kernel-layout
    output; droot [S, n], the crown's dlam at each chain root. Returns
    dls [S, L, n]."""
    L, n, _, S_pad = Lt.shape
    S = droot.shape[0]
    dt = Lt.dtype
    dr = _pad_s(jnp.transpose(droot.astype(dt), (1, 0)), S_pad)

    def kernel(L_ref, CU_ref, y_ref, dr_ref, dl_ref):
        def step(j, dp):
            Lf = _load_lower(L_ref, j, n)
            d = []
            for b in range(n):
                acc = y_ref[j, b, :]
                for a in range(n):
                    acc = acc - CU_ref[j, a, b, :] * dp[a]
                d.append(acc)
            dl = [None] * n
            for a in range(n - 1, -1, -1):
                acc = d[a]
                for m in range(a + 1, n):
                    acc = acc - Lf[m][a] * dl[m]
                dl[a] = acc / Lf[a][a]
            for a in range(n):
                dl_ref[j, a, :] = dl[a]
            return tuple(dl)

        jax.lax.fori_loop(jnp.int32(0), jnp.int32(L), step,
                          tuple(dr_ref[a, :] for a in range(n)))

    dls = _call(
        kernel, grid=(S_pad // _TS,),
        in_specs=[_spec(L, n, n), _spec(L, n, n), _spec(L, n), _spec(n)],
        out_specs=_spec(L, n),
        out_shape=jax.ShapeDtypeStruct((L, n, S_pad), dt),
    )(Lt, CUt, ys, dr)
    return jnp.transpose(dls[..., :S], (2, 0, 1))
