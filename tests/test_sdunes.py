"""sdunes (scenario decomposition) tests.

The Newton direction is validated against a dense assembly of M = J P J'
during development; here we test end-to-end behavior: exact convergence on
quadratic duals (no active inequality kinks -> 1-2 Newton steps), agreement
with tdunes, and the dual dimension formula of the reference
(treeqp_sdunes_calculate_dual_dimension, dual_Newton_scenarios.c:99-108).

Note the method's known cold-start weakness on strongly active-set-changing
instances (singular piecewise dual Hessians); the reference ships dual warm
starts for its spring_mass example for the same reason (spring_mass.c:76-83).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu import max_kkt_residual
from treeqp_tpu.solvers.sdunes import (
    SdunesOpts, sdunes_solve, scenario_data, scenario_output)
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from benchmarks.models import spring_mass_chain

TD = TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=100)


def _loose_bounds(qp, keep_x0=True):
    xmin = np.full_like(np.asarray(qp.xmin), -1e12)
    xmax = -xmin.copy()
    if keep_x0:
        xmin[0] = np.asarray(qp.xmin)[0]
        xmax[0] = np.asarray(qp.xmax)[0]
    return qp.replace(xmin=jnp.asarray(xmin), xmax=jnp.asarray(xmax),
                      umin=jnp.full_like(qp.umin, -1e12),
                      umax=jnp.full_like(qp.umax, 1e12))


def test_quadratic_dual_converges_in_two_iters():
    qp, _ = spring_mass_chain(nm=2, md=2, Nr=2, Nh=6)
    qp = _loose_bounds(qp)
    sqp = scenario_data(qp)
    sol, lam, mu, info = sdunes_solve(sqp, None, None, SdunesOpts(tol=1e-9, max_iter=30))
    assert int(info["status"]) == 0
    assert int(info["iter"]) <= 2
    out = scenario_output(sqp, sol, lam, mu, info)
    assert float(max_kkt_residual(qp, out)) < 1e-12
    ref = tdunes_solve(qp, None, TD)
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-10
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-10


def test_constrained_chain_agrees_with_tdunes():
    # solved TIGHT (1e-8): at tol=1e-6 the solution-agreement bar is
    # path-dependent (a stop just under the tolerance leaves u at
    # ~err/cond, which the pre-round-5 path masked by overshooting)
    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    sqp = scenario_data(qp)
    sol, lam, mu, info = sdunes_solve(sqp, None, None,
                                      SdunesOpts(tol=1e-8, max_iter=250))
    out = scenario_output(sqp, sol, lam, mu, info)
    assert float(info["error"]) < 1e-8
    ref = tdunes_solve(qp, None, TD)
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-7
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-7


def test_warm_start_resumes():
    qp, _ = spring_mass_chain(nm=2, md=2, Nr=2, Nh=6)
    qp = _loose_bounds(qp)
    sqp = scenario_data(qp)
    opts = SdunesOpts(tol=1e-9, max_iter=30)
    sol, lam, mu, info = sdunes_solve(sqp, None, None, opts)
    _, _, _, info2 = sdunes_solve(sqp, lam, mu, opts)
    assert int(info2["iter"]) <= 1


def test_dual_dimension_formula():
    """Sum of pairwise common-node couplings equals the reference's closed
    form (Nr*Ns - (Ns-1)/(md-1))*nu."""
    for md, Nr in [(2, 2), (3, 2), (2, 3)]:
        qp, _ = spring_mass_chain(nm=1, md=md, Nr=Nr, Nh=Nr + 2)
        sqp = scenario_data(qp)
        Ns = md**Nr
        assert sum(sqp.meta.common) == Nr * Ns - (Ns - 1) // (md - 1)


def test_spring_mass_reference_instance():
    """sdunes on the EXACT reference sdunes example configuration
    (spring_mass_dual_newton_scenarios.c: untightened bounds), cold and
    warm-started from the reference's own txt files (VERDICT #5 parity)."""
    from benchmarks.models import spring_mass_qp
    from treeqp_tpu.utils.ref_data import read_txt_vector
    from treeqp_tpu.solvers.sdunes import (
        scenario_data, sdunes_solve, SdunesOpts, scenario_output,
        _coupling_masks)
    from treeqp_tpu.core.kkt import max_kkt_residual
    qp, _ = spring_mass_qp(xmax1=None)
    sqp = scenario_data(qp)
    meta = sqp.meta
    # cold
    sol, lam, mu, info = sdunes_solve(sqp, opts=SdunesOpts(tol=1e-8, max_iter=100))
    out = scenario_output(sqp, sol, lam, mu, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    # warm from reference txt (lambda0_scen / mu0_scen)
    base = "/root/reference/examples/spring_mass_utils"
    lam_flat = read_txt_vector(f"{base}/lambda0_scen.txt")
    mu_flat = read_txt_vector(f"{base}/mu0_scen.txt")
    nx = sqp.b.shape[-1]
    nu = sqp.r.shape[-1]
    mu0 = jnp.asarray(mu_flat.reshape(meta.Ns, meta.Nh, nx))
    cm = np.asarray(_coupling_masks(meta, jnp.float64))
    lam0 = np.zeros((max(meta.Ns - 1, 1), meta.Nr, nu))
    idx = 0
    for s in range(meta.Ns - 1):
        m = int(cm[s].sum()) * nu
        lam0[s].flat[:m] = lam_flat[idx: idx + m]
        idx += m
    assert idx == len(lam_flat)
    sol, lam, mu, info = sdunes_solve(sqp, jnp.asarray(lam0), mu0,
                                      opts=SdunesOpts(tol=1e-8, max_iter=100))
    out = scenario_output(sqp, sol, lam, mu, info)
    assert int(info["status"]) == 0
    assert int(info["iter"]) <= 5
    assert float(max_kkt_residual(qp, out)) < 1e-8


def test_spring_mass_tightened_via_bootstrap():
    """The tightened spring_mass.c instance (xmax1=0.2, active state
    constraints) hits the dual-Newton cold-start plateau; an IPM-mapped
    warm start (scenario_duals_from_tree) converges in O(1) iterations."""
    from benchmarks.models import spring_mass_qp
    from treeqp_tpu.solvers.sdunes import (
        scenario_data, sdunes_solve, SdunesOpts, scenario_output,
        scenario_duals_from_tree)
    from treeqp_tpu.solvers.ipm import ipm_solve, IpmOpts
    from treeqp_tpu.core.kkt import max_kkt_residual
    qp, _ = spring_mass_qp()  # tightened (spring_mass.c:124)
    sqp = scenario_data(qp)
    ref = ipm_solve(qp, IpmOpts(tol=1e-10, max_iter=40))
    lam0, mu0 = scenario_duals_from_tree(sqp, ref.lam)
    sol, lam, mu, info = sdunes_solve(sqp, lam0, mu0,
                                      opts=SdunesOpts(tol=1e-8, max_iter=50))
    out = scenario_output(sqp, sol, lam, mu, info)
    assert int(info["status"]) == 0
    assert int(info["iter"]) <= 10
    assert float(max_kkt_residual(qp, out)) < 1e-8


@pytest.mark.slow
def test_exact_dual_recovery_branchy_tree():
    """With the full tree solution, scenario_duals_from_tree recovers the
    copy duals exactly (per-scenario adjoint recursion for mu, telescoped
    u-stationarity for lam): on an Nr=3 branchy tree — where the equal
    lam/cnt split is inconsistent at branching stages and sdunes used to
    run to max_iter — the bootstrapped solve terminates immediately."""
    from benchmarks.models import linear_chain
    from treeqp_tpu.solvers.sdunes import (
        scenario_data, sdunes_solve, SdunesOpts, scenario_output,
        scenario_duals_from_tree)
    from treeqp_tpu.solvers.ipm import ipm_solve, IpmOpts
    from treeqp_tpu.core.kkt import max_kkt_residual
    model = linear_chain(md=3, Nr=3, Nh=12, nm=2, nu_count=1)
    qp = model.qp
    boot = ipm_solve(qp, IpmOpts(tol=1e-10, max_iter=40))
    sqp = scenario_data(qp)
    lam0, mu0 = scenario_duals_from_tree(sqp, boot.lam, boot)
    sol, lam, mu, info = sdunes_solve(sqp, lam0, mu0,
                                      opts=SdunesOpts(tol=1e-8, max_iter=50))
    out = scenario_output(sqp, sol, lam, mu, info)
    assert int(info["status"]) == 0
    assert int(info["iter"]) <= 2
    assert float(max_kkt_residual(qp, out)) < 1e-8


# ---------------------------------------------------------------------------
# mixed-precision path (VERDICT r2 #5): two-phase f32 -> refined-f64
# schedule, cyclic-reduction Jay, scenario sharding


SPEED_OPTS = None  # initialized lazily to keep module import light


def _speed_opts():
    from treeqp_tpu.solvers.sdunes import SdunesOpts
    return SdunesOpts(tol=1e-8, max_iter=100, factor_dtype="float32",
                      refine_steps=1, f32_phase_tol=1e-4,
                      reg_type="always",
                      reg_value=1e-6)


@pytest.mark.slow
def test_sdunes_speed_path_matches_plain():
    """Two-phase + CR Jay == plain f64 sdunes on a
    constrained instance (same trajectories, KKT bar met)."""
    from treeqp_tpu.solvers.sdunes import (
        scenario_data, sdunes_solve, SdunesOpts, scenario_output)
    from treeqp_tpu.core.kkt import max_kkt_residual
    from benchmarks.models import spring_mass_chain

    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    sqp = scenario_data(qp)
    sol, lam, mu, info = sdunes_solve(sqp, None, None, _speed_opts())
    assert int(info["status"]) == 0
    out = scenario_output(sqp, sol, lam, mu, info)
    assert float(max_kkt_residual(qp, out)) < 1e-8
    ref_opts = SdunesOpts(tol=1e-10, max_iter=100)
    sol_r, lam_r, mu_r, info_r = sdunes_solve(sqp, None, None, ref_opts)
    out_r = scenario_output(sqp, sol_r, lam_r, mu_r, info_r)
    assert float(jnp.max(jnp.abs(out.x - out_r.x))) < 1e-6
    assert float(jnp.max(jnp.abs(out.u - out_r.u))) < 1e-6


@pytest.mark.slow
def test_sdunes_sharded_matches_unsharded():
    """sdunes under a scenario-sharded mesh (GSPMD inserts the boundary
    exchanges + reductions) must match the unsharded solve — the same
    CI-matrix check the tdunes_ms/ipm_ms solvers have."""
    from treeqp_tpu.solvers.sdunes import (
        scenario_data, sdunes_solve, scenario_output)
    from treeqp_tpu.parallel.sharding import scenario_mesh, shard_scenarios
    from treeqp_tpu.core.kkt import max_kkt_residual
    from benchmarks.models import spring_mass_chain

    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    sqp = scenario_data(qp)
    assert sqp.meta.Ns == 8
    opts = _speed_opts()
    mesh = scenario_mesh()
    sqps = shard_scenarios(sqp, mesh)
    sol_s, lam_s, mu_s, info_s = sdunes_solve(sqps, None, None, opts)
    sol, lam, mu, info = sdunes_solve(sqp, None, None, opts)
    assert int(info_s["status"]) == 0
    assert int(info_s["iter"]) == int(info["iter"])
    out_s = scenario_output(sqps, sol_s, lam_s, mu_s, info_s)
    out = scenario_output(sqp, sol, lam, mu, info)
    assert float(max_kkt_residual(qp, out_s)) < 1e-8
    assert float(jnp.max(jnp.abs(out_s.x - out.x))) < 1e-9


@pytest.mark.slow
def test_sdunes_df64_phase_matches_f64():
    """The df64 final phase (solvers/sd_df64.py, VERDICT r3 #3) must
    reproduce the emulated-f64 phase's solution at the same certified
    KKT quality — the sdunes mirror of the tdunes_ms precision
    schedule."""
    from treeqp_tpu.core.kkt import max_kkt_residual
    from benchmarks.models import spring_mass_chain

    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    sqp = scenario_data(qp)
    base = dict(tol=1e-8, max_iter=120, factor_dtype="float32",
                refine_steps=1, f32_phase_tol=1e-3, reg_type="always",
                reg_value=1e-6)
    sol, lam, mu, info = sdunes_solve(sqp, None, None, SdunesOpts(**base))
    out = scenario_output(sqp, sol, lam, mu, info)
    sol2, lam2, mu2, info2 = sdunes_solve(
        sqp, None, None, SdunesOpts(**base, df64_phase=True))
    out2 = scenario_output(sqp, sol2, lam2, mu2, info2)
    assert int(info2["status"]) == 0
    assert float(max_kkt_residual(qp, out2)) < 1e-8
    assert float(jnp.max(jnp.abs(out.x - out2.x))) < 1e-7
