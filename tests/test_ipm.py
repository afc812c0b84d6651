"""Tree IPM tests (HPIPM capability class).

Strategy mirrors the reference: unconstrained golden datasets (random_qp.c
with -DUSE_HPIPM), cross-solver agreement with tdunes on spring_mass
(spring_mass.c:309-440), and bounds-as-general-constraints equivalence
(spring_mass.c TEST_GENERAL_CONSTRAINTS, :105-196)."""

import dataclasses
import glob

import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu import TreeQPIn, TreeStructure, load_tree_qp_file, max_kkt_residual
from treeqp_tpu.core.qp_data import TREEQP_INF
from treeqp_tpu.solvers.ipm import IpmOpts, ipm_solve
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from benchmarks.models import spring_mass_qp

DATASETS = sorted(glob.glob("/root/reference/examples/random_qp_utils/data0[0-5].json"))
OPTS = IpmOpts(tol=1e-10, max_iter=40)


@pytest.mark.parametrize("path", DATASETS)
def test_golden_datasets(path):
    qp, extras = load_tree_qp_file(path)
    out = ipm_solve(qp, OPTS)
    assert int(out.info["status"]) == 0
    assert int(out.info["iter"]) <= 2
    assert float(max_kkt_residual(qp, out)) < 1e-12
    err = np.max(np.abs(np.asarray(out.x) - extras["xopt"]))
    assert err < 1e-12


def test_spring_mass_agrees_with_tdunes():
    """Cross-solver agreement, the reference's spring_mass.c check."""
    qp, _ = spring_mass_qp()
    out = ipm_solve(qp, OPTS)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-9
    ref = tdunes_solve(qp, None, TdunesOpts(stage_solver="clipping",
                                            tol=1e-10, max_iter=100))
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-8
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-8


def test_general_constraints_equivalent_to_bounds():
    """Encode the u-bound of spring_mass as a general constraint D u in
    [umin, umax]; solution must match the bound formulation
    (spring_mass.c TEST_GENERAL_CONSTRAINTS with NC=1)."""
    qp, _ = spring_mass_qp()
    topo = qp.topo
    # new topology with nc=1 on non-leaf nodes
    nc = tuple(1 if topo.nkids[i] > 0 else 0 for i in range(topo.Nn))
    topo2 = TreeStructure.from_parent(topo.parent, topo.nx, topo.nu, nc)
    qp2 = TreeQPIn.zeros(topo2)
    # copy all data; move u bounds into D rows
    umin, umax = qp.umin, qp.umax
    D = jnp.zeros((topo.Nn, topo2.ncm, topo2.num)).at[:, 0, 0].set(1.0)
    cmask = jnp.asarray(topo2.c_mask)
    qp2 = qp2.replace(
        Q=qp.Q, R=qp.R, S=qp.S, q=qp.q, r=qp.r, A=qp.A, B=qp.B, b=qp.b,
        xmin=qp.xmin, xmax=qp.xmax,
        umin=jnp.full_like(qp.umin, -TREEQP_INF),
        umax=jnp.full_like(qp.umax, TREEQP_INF),
        D=D * cmask[:, :, None],
        dmin=jnp.where(cmask > 0, umin[:, :1], -TREEQP_INF),
        dmax=jnp.where(cmask > 0, umax[:, :1], TREEQP_INF),
    )
    out2 = ipm_solve(qp2, OPTS)
    assert int(out2.info["status"]) == 0
    assert float(max_kkt_residual(qp2, out2)) < 1e-9
    out1 = ipm_solve(qp, OPTS)
    assert float(jnp.max(jnp.abs(out2.x - out1.x))) < 1e-7
    assert float(jnp.max(jnp.abs(out2.u - out1.u))) < 1e-7
    # the general-constraint multiplier equals the bound multiplier
    assert float(jnp.max(jnp.abs(out2.mu_d[:, 0] - out1.mu_u[:, 0]))) < 1e-6


def test_dense_weights_with_bounds():
    """IPM covers what tdunes+clipping cannot: dense Q with active bounds.
    Validated purely by the KKT oracle (complete optimality certificate)."""
    rng = np.random.default_rng(0)
    topo = TreeStructure.multistage(md=2, Nr=2, Nh=4, nx=3, nu=2)
    nodes = []
    for i in range(topo.Nn):
        nx, nu = topo.nx[i], topo.nu[i]
        M = rng.standard_normal((nx, nx))
        nd = dict(Q=M @ M.T + 2 * np.eye(nx), q=rng.standard_normal(nx),
                  xmin=-0.4 * np.ones(nx), xmax=0.4 * np.ones(nx))
        if nu:
            N = rng.standard_normal((nu, nu))
            nd.update(R=N @ N.T + 2 * np.eye(nu), r=rng.standard_normal(nu),
                      S=0.1 * rng.standard_normal((nu, nx)),
                      umin=-0.3 * np.ones(nu), umax=0.3 * np.ones(nu))
        nodes.append(nd)
    edges = {c: dict(A=0.5 * rng.standard_normal((3, 3)),
                     B=0.5 * rng.standard_normal((3, topo.nu[topo.parent[c]])),
                     b=0.1 * rng.standard_normal(3)) for c in range(1, topo.Nn)}
    qp = TreeQPIn.from_node_edge_lists(topo, nodes, edges)
    out = ipm_solve(qp, OPTS)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-9
    # some bound must be active, otherwise the test is vacuous
    x = np.asarray(out.x)
    assert np.any(np.abs(np.abs(x[np.asarray(topo.x_mask) > 0]) - 0.4) < 1e-9) or \
        np.any(np.abs(np.abs(np.asarray(out.u)[np.asarray(topo.u_mask) > 0]) - 0.3) < 1e-9)


def test_ipm_warm_start_cuts_iterations():
    """Warm-starting from a neighbouring solution must cut the iteration
    count at least 2x (VERDICT: warm_start, hpmpc_tree.h:56)."""
    import jax.numpy as jnp
    from benchmarks.models import spring_mass_chain
    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    opts = IpmOpts(tol=1e-10, max_iter=40)
    out0 = ipm_solve(qp, opts)
    assert int(out0.info["status"]) == 0
    # perturb the problem slightly (an MPC-step-sized change)
    qp2 = dataclasses.replace(qp, b=qp.b + 1e-3)
    cold = ipm_solve(qp2, opts)
    warm = ipm_solve(qp2, opts, ws=out0)
    assert int(warm.info["status"]) == 0
    assert float(max_kkt_residual(qp2, warm)) < 1e-8
    assert int(warm.info["iter"]) * 2 <= int(cold.info["iter"])


@pytest.mark.slow
def test_ipm_mixed_precision_matches_f64():
    """The mixed-precision path — f32 tree-Riccati factorization/solves with a
    full-precision finish (IpmOpts.factor_dtype) — must reproduce the f64
    path's solution, and iterative refinement must recover its iteration
    count (VERDICT round 1: mixed precision for the IPM; the engine being
    matched is hpipm_tree.c:489 / mode=SPEED)."""
    import jax.numpy as jnp
    from benchmarks.models import crane

    qp = crane(md=2, Nr=2, Nh=10).qp  # active bounds + crane dynamics
    o64 = ipm_solve(qp, IpmOpts())
    o32 = ipm_solve(qp, IpmOpts(factor_dtype="float32"))
    o32r = ipm_solve(qp, IpmOpts(factor_dtype="float32", refine_steps=1))
    assert int(o64.info["status"]) == 0
    assert int(o32.info["status"]) == 0
    assert int(o32r.info["status"]) == 0
    assert float(max_kkt_residual(qp, o32)) < 1e-9
    assert float(max_kkt_residual(qp, o32r)) < 1e-9
    assert float(jnp.max(jnp.abs(o32.x - o64.x))) < 1e-9
    # refinement restores f64-quality directions: same iteration count
    assert int(o32r.info["iter"]) == int(o64.info["iter"])
