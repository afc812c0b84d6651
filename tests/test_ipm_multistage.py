"""Multistage (crown+chains) IPM vs the generic tree IPM.

The multistage IPM is a pure re-layout of ipm_solve (same Mehrotra
algorithm, same residuals) — it must reproduce the generic solver's
iterates exactly, at f64, on the clipping-class instances it supports.
Reference semantics being matched: treeqp_hpmpc_solve / treeqp_hpipm_solve
(hpmpc_tree.c:316-455, hpipm_tree.c:307-562).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.models import spring_mass_chain, crane
from treeqp_tpu.core.kkt import max_kkt_residual
from treeqp_tpu.solvers.ipm import IpmOpts, ipm_solve
from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
from treeqp_tpu.solvers.tdunes_multistage import split_multistage, merge_output


@pytest.fixture(scope="module")
def problem():
    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=10)
    return qp, split_multistage(qp)


def test_matches_generic_ipm(problem):
    qp, ms = problem
    opts = IpmOpts(tol=1e-10, max_iter=40)
    ref = ipm_solve(qp, opts)
    cro, cho, info = ipm_ms_solve(ms, opts)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert int(info["iter"]) == int(ref.info["iter"])
    assert float(max_kkt_residual(qp, out)) < 1e-9
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-10
    assert float(jnp.max(jnp.abs(out.lam - ref.lam))) < 1e-10
    assert float(jnp.max(jnp.abs(out.mu_x - ref.mu_x))) < 1e-10


def test_crane_instance():
    m = crane(md=2, Nr=2, Nh=10)
    ms = split_multistage(m.qp)
    cro, cho, info = ipm_ms_solve(ms, IpmOpts(tol=1e-10, max_iter=40))
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(m.qp, out)) < 1e-9


def test_mixed_precision(problem):
    qp, ms = problem
    cro, cho, info = ipm_ms_solve(
        ms, IpmOpts(tol=1e-10, max_iter=40, factor_dtype="float32"))
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-9


def test_warm_start_cuts_iterations(problem):
    qp, ms = problem
    opts = IpmOpts(tol=1e-10, max_iter=40)
    cro, cho, _ = ipm_ms_solve(ms, opts)
    ms2 = dataclasses.replace(
        ms, b=ms.b + 1e-4,
        crown=dataclasses.replace(ms.crown, b=ms.crown.b + 1e-4))
    cold = ipm_ms_solve(ms2, opts)
    warm = ipm_ms_solve(ms2, opts, ws=(cro, cho))
    assert int(warm[2]["status"]) == 0
    qp2 = dataclasses.replace(qp, b=qp.b + 1e-4)
    out_w = merge_output(ms2, *warm)
    assert float(max_kkt_residual(qp2, out_w)) < 1e-8
    assert int(warm[2]["iter"]) < int(cold[2]["iter"])


@pytest.mark.slow
def test_ipm_ms_sharded_matches_unsharded():
    """The multistage IPM under a scenario-sharded mesh (GSPMD inserts the
    chain<->crown collectives) must match the unsharded solve — the same
    single-vs-sharded CI-matrix check the dual-Newton solver has."""
    from treeqp_tpu.parallel.sharding import scenario_mesh, shard_multistage
    from benchmarks.models import spring_mass_chain

    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    ms = split_multistage(qp)
    assert ms.meta.S == 8
    mesh = scenario_mesh()
    mss = shard_multistage(ms, mesh)
    opts = IpmOpts(tol=1e-10, max_iter=40)
    out_s = ipm_ms_solve(mss, opts)
    out = ipm_ms_solve(ms, opts)
    assert int(out_s[2]["iter"]) == int(out[2]["iter"])
    full_s = merge_output(mss, *out_s)
    full = merge_output(ms, *out)
    assert float(max_kkt_residual(qp, full_s)) < 1e-9
    assert float(jnp.max(jnp.abs(full_s.x - full.x))) < 1e-11


@pytest.mark.slow
def test_closed_loop_ipm_ms():
    """The multistage IPM in the closed-loop harness: warm-started steps
    must converge in fewer iterations than the cold first step, with zero
    KKT violations (treeqp_main.m:171-177 accuracy bar)."""
    from benchmarks.closed_loop import closed_loop_mpc
    from benchmarks.models import crane

    log = closed_loop_mpc(crane(md=2, Nr=2, Nh=8), "ipm_ms", nsim=5)
    assert log.kkt_violations == 0
    assert all(s == 0 for s in log.status.tolist())
    assert log.iters[1:].max() < log.iters[0]


# ---------------------------------------------------------------------------
# general C/D rows on the multistage path (VERDICT r2 #3)


def _with_general_rows(qp):
    from benchmarks.models import with_general_rows
    return with_general_rows(qp, cmax=0.3)


@pytest.fixture(scope="module")
def general_problem():
    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=10)
    qp_g = _with_general_rows(qp)
    return qp_g, split_multistage(qp_g)


@pytest.mark.slow
def test_general_rows_match_generic_ipm(general_problem):
    """ipm_ms with C/D rows == generic ipm_solve on the same instance
    (dense barrier blocks, dense chain Riccati)."""
    qp, ms = general_problem
    assert ms.C is not None  # the split carried the rows
    opts = IpmOpts(tol=1e-9, max_iter=40)
    cro, cho, info = ipm_ms_solve(ms, opts)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    kkt = float(max_kkt_residual(qp, out))
    assert kkt < 1e-8
    ref = ipm_solve(qp, opts)
    assert int(ref.info["status"]) == 0
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-7
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-7
    assert float(jnp.max(jnp.abs(out.mu_d - ref.mu_d))) < 1e-5
    # the rows actually bind somewhere (otherwise this tests nothing)
    assert float(jnp.max(jnp.abs(out.mu_d))) > 1e-6


@pytest.mark.slow
def test_general_rows_mixed_precision(general_problem):
    """The f32-phase + refinement speed path on the general-row instance
    still meets the KKT bar (dense chain Riccati in f32)."""
    qp, ms = general_problem
    opts = IpmOpts(tol=1e-9, max_iter=40, factor_dtype="float32",
                   refine_steps=1)
    cro, cho, info = ipm_ms_solve(ms, opts)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8


def test_general_rows_warm_start(general_problem):
    """Warm starting from a previous solution (incl. general-row duals)
    cuts iterations."""
    qp, ms = general_problem
    opts = IpmOpts(tol=1e-9, max_iter=40)
    cro, cho, info = ipm_ms_solve(ms, opts)
    cro2, cho2, info2 = ipm_ms_solve(ms, opts, ws=(cro, cho))
    assert int(info2["status"]) == 0
    assert int(info2["iter"]) < int(info["iter"])
