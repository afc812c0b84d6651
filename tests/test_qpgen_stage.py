"""General (C/D-row) stage QPs inside dual Newton + per-node solver mixing
(reference qpOASES plugin, dual_Newton_tree_qpoases.c; per-node vtable,
dual_Newton_tree.c:124-162)."""

import numpy as np
import jax.numpy as jnp
import pytest

from benchmarks.models import spring_mass_chain
from treeqp_tpu.core.kkt import max_kkt_residual
from treeqp_tpu.solvers.tdunes import (
    tdunes_solve, TdunesOpts, clipping_applicable_nodes, _qpgen_batch,
    _batched_inverse_spd)
from treeqp_tpu.solvers.ipm import ipm_solve, IpmOpts
from treeqp_tpu.utils.tree import TreeStructure


@pytest.fixture(scope="module")
def constrained_qp():
    """Spring-mass tree with general C/D rows on every third node."""
    qp0, _ = spring_mass_chain(nm=2, md=2, Nr=2, Nh=5)
    topo0 = qp0.topo
    nc = tuple(1 if (i % 3 == 0 and i > 0) else 0 for i in range(topo0.Nn))
    topo = TreeStructure.from_parent(topo0.parent, topo0.nx, topo0.nu, nc)
    C = np.zeros((topo.Nn, topo.ncm, topo.nxm))
    D = np.zeros((topo.Nn, topo.ncm, topo.num))
    dmin = np.full((topo.Nn, topo.ncm), -1e12)
    dmax = np.full((topo.Nn, topo.ncm), 1e12)
    for i in range(topo.Nn):
        if nc[i]:
            C[i, 0, :2] = [1.0, 1.0]
            D[i, 0, :topo.nu[i]] = 0.3
            dmin[i, 0], dmax[i, 0] = -0.4, 0.4
    return qp0.replace(C=jnp.asarray(C), D=jnp.asarray(D),
                       dmin=jnp.asarray(dmin), dmax=jnp.asarray(dmax),
                       topo=topo)


def test_qpgen_batch_standalone():
    """The batched general stage-QP solver against brute force."""
    from scipy.optimize import minimize
    rng = np.random.default_rng(1)
    N, nz, ng = 5, 4, 6
    Hr = rng.standard_normal((N, nz, nz))
    H = jnp.asarray(Hr @ Hr.transpose(0, 2, 1) / nz + 2 * np.eye(nz))
    G = jnp.asarray(rng.standard_normal((N, ng, nz)))
    lo = jnp.asarray(-0.5 * np.ones((N, ng)))
    hi = jnp.asarray(0.5 * np.ones((N, ng)))
    ones = jnp.ones((N, ng))
    hmod = jnp.asarray(rng.standard_normal((N, nz)) * 2)
    Hinv = _batched_inverse_spd(H)
    rho_row = jnp.ones((N, ng))
    L_admm = jnp.linalg.cholesky(
        H + (G * rho_row[:, :, None]).swapaxes(1, 2) @ G)
    opts = TdunesOpts(qpgen_iters=100)
    z, P, mu, res, _ = _qpgen_batch(hmod, H, Hinv, G, lo, hi, ones, ones,
                                 rho_row, L_admm, opts)
    assert float(res) < 1e-8
    for n in range(N):
        Hn, Gn, hn = np.asarray(H[n]), np.asarray(G[n]), np.asarray(hmod[n])
        cons = [dict(type="ineq", fun=lambda zz, j=j: 0.5 - Gn[j] @ zz)
                for j in range(ng)]
        cons += [dict(type="ineq", fun=lambda zz, j=j: Gn[j] @ zz + 0.5)
                 for j in range(ng)]
        r = minimize(lambda zz: 0.5 * zz @ Hn @ zz - hn @ zz,
                     np.zeros(nz), constraints=cons, tol=1e-12)
        assert np.max(np.abs(r.x - np.asarray(z[n]))) < 1e-5


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["qpgen", "mixed"])
def test_general_constraints_match_ipm(constrained_qp, solver):
    """tdunes with general stage QPs matches the IPM to 1e-8 on a tree
    with mixed clipping/general nodes (VERDICT done-criterion)."""
    qp = constrained_qp
    ref = ipm_solve(qp, IpmOpts(tol=1e-11, max_iter=50))
    assert int(ref.info["status"]) == 0
    out = tdunes_solve(qp, opts=TdunesOpts(stage_solver=solver, tol=1e-9,
                                           max_iter=100))
    assert int(out.info["status"]) == 0
    assert float(out.info["qpgen_res"]) < 1e-8
    assert float(max_kkt_residual(qp, out)) < 1e-8
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-8
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-8


def test_node_solver_autoderive(constrained_qp):
    ns = clipping_applicable_nodes(constrained_qp)
    nc = constrained_qp.topo.nc
    assert all((v == 0) == (nc[i] > 0) for i, v in enumerate(ns))


def test_mixed_constraint_multipliers_exported(constrained_qp):
    """mu_d must be populated (complementarity checked by the oracle)."""
    out = tdunes_solve(constrained_qp,
                       opts=TdunesOpts(stage_solver="mixed", tol=1e-9,
                                       max_iter=100))
    assert float(jnp.max(jnp.abs(out.mu_d))) > 1e-8  # some row is active


@pytest.mark.slow
def test_qpgen_hotstart_same_solution():
    """Working-set hotstart (dual_Newton_tree_qpoases.c:312-356): a solve
    hotstarted from another instance's final working sets returns the
    same solution and status as the cold solve, in no more iterations."""
    from treeqp_tpu.core.json_io import load_tree_qp_file
    qp, extras = load_tree_qp_file(
        "/root/reference/examples/random_qp_utils/data03.json")
    opts = TdunesOpts(stage_solver="qpgen", tol=1e-9, max_iter=60)
    cold = tdunes_solve(qp, None, opts)
    assert int(cold.info["status"]) == 0
    ws = cold.info["qpgen_ws"]
    # perturbed instance (MPC-step-like data change)
    qp2 = qp.replace(q=qp.q * 1.02, r=qp.r * 1.02)
    cold2 = tdunes_solve(qp2, None, opts)
    warm2 = tdunes_solve(qp2, None, opts, stage_ws=ws)
    assert int(warm2.info["status"]) == 0
    assert float(jnp.max(jnp.abs(warm2.x - cold2.x))) < 1e-8
    assert float(jnp.max(jnp.abs(warm2.u - cold2.u))) < 1e-8
    # iteration-count parity: hotstart must not degrade the Newton path
    assert int(warm2.info["iter"]) <= int(cold2.info["iter"])
    from treeqp_tpu.core.kkt import max_kkt_residual
    assert float(max_kkt_residual(qp2, warm2)) < 1e-8


def test_qpgen_hotstart_skips_admm():
    """With the correct working set provided, the hotstarted path must
    reproduce the cold _qpgen_batch answer exactly (same polish) — the
    lax.cond ADMM fallback does not fire."""
    rng = np.random.default_rng(7)
    N, nz, ng = 5, 4, 6
    A = rng.standard_normal((N, nz, nz))
    H = jnp.asarray(A @ A.transpose(0, 2, 1) + 3 * np.eye(nz))
    Hinv = jnp.linalg.inv(H)
    G = jnp.asarray(rng.standard_normal((N, ng, nz)))
    lo = jnp.asarray(-0.3 * np.abs(rng.standard_normal((N, ng))) - 0.05)
    hi = jnp.asarray(0.3 * np.abs(rng.standard_normal((N, ng))) + 0.05)
    hmod = jnp.asarray(rng.standard_normal((N, nz)))
    ones = jnp.ones((N, ng))
    rho_row = jnp.ones((N, ng))
    L_admm = jnp.linalg.cholesky(
        H + (G * rho_row[:, :, None]).swapaxes(1, 2) @ G)
    opts = TdunesOpts(qpgen_iters=100)
    z0, P0, mu0, res0, ws = _qpgen_batch(hmod, H, Hinv, G, lo, hi, ones,
                                         ones, rho_row, L_admm, opts)
    assert float(res0) < 1e-8
    z1, P1, mu1, res1, _ = _qpgen_batch(hmod, H, Hinv, G, lo, hi, ones,
                                        ones, rho_row, L_admm, opts, ws=ws)
    assert float(jnp.max(jnp.abs(z1 - z0))) < 1e-12
    assert float(jnp.max(jnp.abs(mu1 - mu0))) < 1e-10
    assert float(res1) < 1e-8


@pytest.mark.slow
def test_qpgen_f32_factor_parity(constrained_qp):
    """qpgen_factor_dtype=float32 (f32 working-set factors + iterative
    refinement / Newton-Schulz elimination-matrix refinement) must reproduce the f64-factor path:
    same Newton iteration count, same solution to f64 quality."""
    qp = constrained_qp
    o64 = TdunesOpts(stage_solver="qpgen", tol=1e-9, max_iter=100)
    o32 = TdunesOpts(stage_solver="qpgen", tol=1e-9, max_iter=100,
                     qpgen_factor_dtype="float32")
    ref = tdunes_solve(qp, opts=o64)
    out = tdunes_solve(qp, opts=o32)
    assert int(out.info["status"]) == 0
    assert int(out.info["iter"]) == int(ref.info["iter"])
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-10
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-10
    assert float(out.info["qpgen_res"]) < 1e-8
    assert float(max_kkt_residual(qp, out)) < 1e-8
