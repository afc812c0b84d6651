"""Triton chain-sweep kernels (Pallas interpreter on the CPU) against the
XLA scans of the multistage solver, which are the plain reference.

Tolerances (max error relative to the largest reference entry):
* f64: 1e-10 — the kernels and the scans run the same algorithm in
  another summation order; the blocks are equilibrated, so their rounding
  differences stay within a few hundred ulps;
* f32: 1e-4 — the same argument at f32's 6e-8 unit roundoff, with the
  1e-6 LM shift of the regularized lanes amplifying rounding by ~1e2.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from treeqp_tpu.ops import chain_kernels as ck
from treeqp_tpu.solvers import tdunes_multistage as tm
from treeqp_tpu.solvers.tdunes import TdunesOpts

L, NX, NU = 16, 6, 4
TOL = {"float64": 1e-10, "float32": 1e-4}
REGS = ("none", "always", "on_the_fly")


def _blocks(S, dtype, singular, seed=0):
    """Equilibrated dual-Hessian chain blocks of the solver's form:
    W = A diag(qt_p) A' + B diag(rt_p) B' + diag(qt), Ut = -qt_p * A'.
    ``singular`` zeroes the last state of every third scenario at one chain
    step (a zero row and column of W, and no coupling to its neighbours),
    which the regularization must repair."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (S, L, NX, NX)) / np.sqrt(NX) + np.eye(NX)
    B = rng.uniform(-1, 1, (S, L, NX, NU))
    qt = rng.uniform(0.5, 2.0, (S, L, NX))
    rt = rng.uniform(0.5, 2.0, (S, L, NU))
    qtp = np.concatenate([rng.uniform(0.5, 2.0, (S, 1, NX)), qt[:, :-1]], 1)
    rtp = np.concatenate([rng.uniform(0.5, 2.0, (S, 1, NU)), rt[:, :-1]], 1)
    W = (np.einsum("slin,sln,sljn->slij", A, qtp, A)
         + np.einsum("slin,sln,sljn->slij", B, rtp, B)
         + qt[..., None] * np.eye(NX))
    Ut = -(qtp[..., :, None] * A.swapaxes(2, 3))
    if singular:
        lanes = np.arange(0, S, 3)
        W[lanes, 5, -1, :] = 0.0
        W[lanes, 5, :, -1] = 0.0
        Ut[lanes, 5, :, -1] = 0.0
        Ut[lanes, 6, -1, :] = 0.0
    d = np.sqrt(np.maximum(np.diagonal(W, axis1=2, axis2=3), 1e-12))
    sc = 1.0 / np.where(np.diagonal(W, axis1=2, axis2=3) > 0, d, 1.0)
    scp = np.concatenate([np.ones((S, 1, NX)), sc[:, :-1]], 1)
    W = W * sc[..., :, None] * sc[..., None, :]
    Ut = Ut * scp[..., :, None] * sc[..., None, :]
    res = rng.standard_normal((S, L, NX))
    droot = rng.standard_normal((S, NX))
    return tuple(jnp.asarray(v, dtype) for v in (W, Ut, res, droot))


def _to_nodes(v, S):
    """Kernel layout [L, ..., S_pad] -> [S, L, ...]."""
    v = np.asarray(v)[..., :S]
    return np.moveaxis(v, -1, 0)


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)
    assert err <= TOL[dtype], err


def _case(S, dtype, reg):
    opts = TdunesOpts(reg_type=reg, reg_value=1e-6, reg_tol=1e-6)
    W, Ut, res, droot = _blocks(S, dtype, singular=reg != "none")
    Ls, CUs, schur0 = tm._chain_factor(W, Ut, opts)
    return opts, (W, Ut, res, droot), (Ls, CUs, schur0)


def _kernel_layout(x, S):
    return ck._pad_s(jnp.moveaxis(x, 0, -1), ck._s_pad(S))


CASES = [(s, dt, reg) for s in (5, 256) for dt in ("float64", "float32")
         for reg in REGS]
IDS = [f"S{s}-{dt}-{reg}" for s, dt, reg in CASES]


@pytest.mark.parametrize("S,dtype,reg", CASES, ids=IDS)
def test_chain_factor_matches_scan(S, dtype, reg):
    opts, (W, Ut, _, _), (Ls, CUs, schur0) = _case(S, dtype, reg)
    kLs, kCUs, kschur = ck.chain_factor(
        W, Ut, reg=(opts.reg_type, opts.reg_value, opts.reg_tol))
    assert kLs.shape == (L, NX, NX, ck._s_pad(S)) and kLs.dtype == W.dtype
    _close(_to_nodes(kLs, S), Ls, dtype)
    _close(_to_nodes(kCUs, S), CUs, dtype)
    _close(kschur, schur0, dtype)


@pytest.mark.parametrize("S,dtype,reg", CASES, ids=IDS)
def test_chain_solve_bwd_matches_scan(S, dtype, reg):
    opts, (_, _, res, _), (Ls, CUs, _) = _case(S, dtype, reg)
    ys, radd0 = tm._chain_solve_bwd(Ls, CUs, res)
    kys, kradd = ck.chain_solve_bwd(_kernel_layout(Ls, S),
                                    _kernel_layout(CUs, S), res)
    _close(_to_nodes(kys, S), ys, dtype)
    _close(kradd, radd0, dtype)


@pytest.mark.parametrize("S,dtype,reg", CASES, ids=IDS)
def test_chain_forward_matches_scan(S, dtype, reg):
    opts, (_, _, res, droot), (Ls, CUs, _) = _case(S, dtype, reg)
    ys, _ = tm._chain_solve_bwd(Ls, CUs, res)
    dls = tm._chain_forward(Ls, CUs, ys, droot)
    kdls = ck.chain_forward(_kernel_layout(Ls, S), _kernel_layout(CUs, S),
                            _kernel_layout(ys, S), droot)
    _close(kdls, dls, dtype)


def test_bench_singular_lanes_reach_each_shift():
    """The on-card check's inputs (benchmarks/chain_kernel_bench.py), on a
    small quadcopter tree in the interpreter: the on-the-fly cascade
    repairs its singular lanes at each of its three shifts, the kernel
    takes the same shifts as the scan, and the outputs agree."""
    from benchmarks.chain_kernel_bench import chain_inputs, compare
    from benchmarks.models import quadcopter

    ms = tm.split_multistage(quadcopter(md=3, Nr=2, Nh=10).qp)
    r = compare(chain_inputs(ms, jnp.float64, "on_the_fly"), "on_the_fly")
    assert r["ok"], r
    levels = r["shift_levels"]
    assert levels["1"] > 0 and levels["1e3"] > 0 and levels["1e6"] > 0, r
    r = compare(chain_inputs(ms, jnp.float64, "always"), "always")
    assert r["ok"] and r["shift_levels"]["0"] == 0, r


@pytest.mark.gpu
@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("shape", ["S256_L16", "S1024_L15"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chain_sweeps_on_card(gpu, shape, dtype, reg):
    """Compiled through Triton at the quadcopter trees' real widths, the
    kernels match the XLA scans within the tolerances above, singular
    lanes included, and take the same regularization shifts."""
    import jax

    from benchmarks.chain_kernel_bench import SHAPES, chain_inputs, compare
    from benchmarks.models import quadcopter

    ms = jax.device_put(tm.split_multistage(quadcopter(**SHAPES[shape]).qp),
                        gpu)
    r = compare(chain_inputs(ms, jnp.dtype(dtype), reg), reg)
    assert r["ok"], r
