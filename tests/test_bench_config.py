"""Coverage for the mixed-precision solver configuration on CPU.

These opts (factor_dtype=float32, refine_steps=1, unsafeguarded,
reg_type=always, two-phase f32/f64) exercise code paths the plain f64
tests never touch; with the chain sweeps routed through the Triton
kernels as on a GPU (Pallas interpreter on the CPU), the whole pipeline
is testable here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.models import spring_mass_chain
from treeqp_tpu.core.kkt import max_kkt_residual
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from treeqp_tpu.solvers.tdunes_multistage import (
    split_multistage, tdunes_ms_solve, merge_output)

BENCH_OPTS = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=120,
                        factor_dtype="float32", refine_steps=1,
                        refine_safeguard=False,
                        reg_type="always", reg_value=1e-6,
                        f32_phase_tol=1e-4)
REF_OPTS = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=120)


@pytest.fixture(scope="module")
def problem():
    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    return qp, split_multistage(qp)


@pytest.mark.slow
def test_bench_opts_match_f64_xla(problem, monkeypatch):
    """The mixed-precision pipeline (Triton sweeps + f32 phase +
    refinement) agrees with the plain f64 path with the XLA scans."""
    qp, ms = problem
    ref = tdunes_ms_solve(ms, None, None, REF_OPTS)
    out_ref = merge_output(ms, *ref)
    from treeqp_tpu.solvers import tdunes_multistage as tm
    jax.clear_caches()
    monkeypatch.setattr(tm, "_triton_sweeps", lambda meta, shard=None: True)
    cro, cho, info = tdunes_ms_solve(ms, None, None, BENCH_OPTS)
    out = merge_output(ms, cro, cho, info)
    jax.clear_caches()
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    assert float(jnp.max(jnp.abs(out.x - out_ref.x))) < 1e-6
    assert float(jnp.max(jnp.abs(out.u - out_ref.u))) < 1e-6


@pytest.mark.slow
def test_df64_phase_matches_f64(problem):
    """The df64 (two-f32 double-float) final phase reproduces the native
    f64 phase: same Newton semantics, solution to ~1e-9, KKT <= 1e-8
    (solvers/ms_df64.py)."""
    import dataclasses
    qp, ms = problem
    opts = dataclasses.replace(BENCH_OPTS, df64_phase=True)
    cro, cho, info = tdunes_ms_solve(ms, None, None, opts)
    out = merge_output(ms, cro, cho, info)
    ref = tdunes_ms_solve(ms, None, None, REF_OPTS)
    out_ref = merge_output(ms, *ref)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    assert float(jnp.max(jnp.abs(out.x - out_ref.x))) < 1e-8
    assert float(jnp.max(jnp.abs(out.u - out_ref.u))) < 1e-8
    assert float(jnp.max(jnp.abs(out.lam - out_ref.lam))) < 1e-7


@pytest.mark.slow
def test_two_phase_equals_single_phase_solution(problem):
    """f32_phase_tol only changes the iteration schedule, not the answer."""
    qp, ms = problem
    import dataclasses
    one = dataclasses.replace(BENCH_OPTS, f32_phase_tol=0.0)
    cro1, cho1, info1 = tdunes_ms_solve(ms, None, None, one)
    cro2, cho2, info2 = tdunes_ms_solve(ms, None, None, BENCH_OPTS)
    o1 = merge_output(ms, cro1, cho1, info1)
    o2 = merge_output(ms, cro2, cho2, info2)
    assert int(info1["status"]) == 0 and int(info2["status"]) == 0
    assert float(max_kkt_residual(qp, o2)) < 1e-8
    assert float(jnp.max(jnp.abs(o1.x - o2.x))) < 1e-6


def test_generic_tdunes_f32_refinement(problem):
    """Plain tdunes_solve honours refine_steps on the f32 path (round-1
    ADVICE: it used to silently skip refinement outside the multistage
    solver)."""
    qp, _ = problem
    import dataclasses
    for safeguard in (True, False):
        opts = TdunesOpts(tol=1e-8, max_iter=100, factor_dtype="float32",
                          refine_steps=1, refine_safeguard=safeguard,
                          reg_type="always", reg_value=1e-6)
        out = tdunes_solve(qp, opts=opts)
        assert int(out.info["status"]) == 0
        assert float(max_kkt_residual(qp, out)) < 1e-8
    # refinement should not be slower to converge than no refinement
    out_nr = tdunes_solve(qp, opts=TdunesOpts(
        tol=1e-8, max_iter=100, factor_dtype="float32", refine_steps=0,
        reg_type="always", reg_value=1e-6))
    assert int(out.info["iter"]) <= int(out_nr.info["iter"])


@pytest.mark.slow
def test_batched_ls_matches_sequential(problem):
    """ls_batch changes scheduling, not Armijo decisions."""
    qp, ms = problem
    import dataclasses
    seq = dataclasses.replace(REF_OPTS, ls_batch=0)
    bat = dataclasses.replace(REF_OPTS, ls_batch=4)
    _, _, i1 = tdunes_ms_solve(ms, None, None, seq)
    _, _, i2 = tdunes_ms_solve(ms, None, None, bat)
    assert int(i1["iter"]) == int(i2["iter"])


def test_factor_reuse_matches_refactorization(problem):
    """reuse_factorization skips refactorizing on unchanged active sets
    (checkLastActiveSet / idxFactorStart, dual_Newton_tree.c:501-512);
    with clipping the reused factors are bitwise the ones a refactorization
    would build, so iterations and solutions match exactly."""
    import dataclasses
    qp, ms = problem
    on = dataclasses.replace(REF_OPTS, reuse_factorization=True)
    off = dataclasses.replace(REF_OPTS, reuse_factorization=False)
    cro1, cho1, i1 = tdunes_ms_solve(ms, None, None, on)
    cro2, cho2, i2 = tdunes_ms_solve(ms, None, None, off)
    assert int(i1["iter"]) == int(i2["iter"])
    o1 = merge_output(ms, cro1, cho1, i1)
    o2 = merge_output(ms, cro2, cho2, i2)
    assert float(jnp.max(jnp.abs(o1.x - o2.x))) == 0.0
    assert float(jnp.max(jnp.abs(o1.lam - o2.lam))) == 0.0
