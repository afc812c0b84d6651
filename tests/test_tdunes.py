"""tdunes solver tests, mirroring the reference unit-test strategy
(examples/random_qp.c:240-254: KKT < 1e-12, deviation from stored optimum
< 1e-12, unconstrained convergence in <= 1 Newton iteration)."""

import glob

import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu import TreeQPIn, load_tree_qp_file, max_kkt_residual
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from benchmarks.models import spring_mass_qp

DATASETS = sorted(glob.glob("/root/reference/examples/random_qp_utils/data0[0-5].json"))
DENSE_OPTS = TdunesOpts(stage_solver="dense", tol=1e-10, max_iter=10, reg_type="none")


@pytest.mark.parametrize("path", DATASETS)
def test_golden_datasets_dense(path):
    qp, extras = load_tree_qp_file(path)
    out = tdunes_solve(qp, None, DENSE_OPTS)
    assert int(out.info["status"]) == 0
    # unconstrained QPs must converge in <= 1 dual Newton iteration
    assert int(out.info["iter"]) <= 1
    kkt = float(max_kkt_residual(qp, out))
    err = max(np.max(np.abs(np.asarray(out.x) - extras["xopt"])),
              np.max(np.abs(np.asarray(out.u) - extras["uopt"])))
    assert kkt < 1e-12
    assert err < 1e-12


def test_spring_mass_clipping():
    qp, _ = spring_mass_qp()
    opts = TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=100)
    out = tdunes_solve(qp, None, opts)
    assert int(out.info["status"]) == 0
    kkt = float(max_kkt_residual(qp, out))
    assert kkt < 1e-10
    # input bound active at the beginning of the horizon (spring_mass setup)
    u = np.asarray(out.u)
    assert np.max(np.abs(u)) <= 1.0 + 1e-10
    assert np.any(np.abs(np.abs(u[qp.topo.nkids > 0, 0]) - 1.0) < 1e-8)


def test_spring_mass_warm_start():
    """Dual warm starting = the checkpoint/resume analog (SURVEY.md 5.4)."""
    qp, _ = spring_mass_qp()
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=100)
    out = tdunes_solve(qp, None, opts)
    out2 = tdunes_solve(qp, out.lam, opts)
    assert int(out2.info["iter"]) <= 2
    assert float(max_kkt_residual(qp, out2)) < 1e-8


def test_eliminate_x0_matches():
    """x0 elimination (tree_qp_common.c:404-525) must not change the solution."""
    qp, x0 = spring_mass_qp()
    opts = TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=100)
    out_full = tdunes_solve(qp, None, opts)
    qp_e = qp.eliminate_x0()
    out_e = tdunes_solve(qp_e, None, opts)
    assert float(max_kkt_residual(qp_e, out_e)) < 1e-10
    x_f, x_e = np.asarray(out_full.x), np.asarray(out_e.x)
    u_f, u_e = np.asarray(out_full.u), np.asarray(out_e.u)
    assert np.max(np.abs(x_f[1:] - x_e[1:])) < 1e-8
    assert np.max(np.abs(u_f - u_e)) < 1e-8


def test_eliminated_x0_reembedding():
    """set_x0 on an eliminated problem matches eliminating from scratch
    (reference qp_internal_t pattern, tree_qp_common.c:2154-2237)."""
    from benchmarks.models import spring_mass_chain
    qp, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=6)
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=100)
    elim = qp.eliminate_x0(keep_originals=True)
    rng = np.random.default_rng(0)
    for step in range(3):
        x_new = 0.1 * rng.standard_normal(qp.topo.nx[0])
        # path A: re-embed into the eliminated problem
        elim = elim.set_x0(x_new)
        out_a = tdunes_solve(elim.qp, opts=opts)
        # path B: set x0 on the full problem, eliminate from scratch
        qp_b = qp.set_x0(x_new).eliminate_x0()
        out_b = tdunes_solve(qp_b, opts=opts)
        assert int(out_a.info["status"]) == 0
        assert float(jnp.max(jnp.abs(out_a.x - out_b.x))) < 1e-9
        assert float(jnp.max(jnp.abs(out_a.u - out_b.u))) < 1e-9
        from treeqp_tpu.core.kkt import max_kkt_residual
        assert float(max_kkt_residual(elim.qp, out_a)) < 1e-8


# ---------------------------------------------------------------------------
# generic-tree speed path (VERDICT r2 #1): the two-phase f32 -> refined-f64
# schedule on asymmetric / pruned / general trees


GENERIC_SPEED_OPTS = TdunesOpts(
    stage_solver="clipping", tol=1e-8, max_iter=120,
    factor_dtype="float32", refine_steps=1, refine_safeguard=False,
    reg_type="always", reg_value=1e-6,
    f32_phase_tol=1e-4)


@pytest.mark.slow
def test_generic_two_phase_asymmetric_tree():
    """Two-phase schedule on the thesis-example-class ASYMMETRIC
    tree matches the plain f64 XLA path (the reference's speed substrate
    is shape-agnostic, dual_Newton_tree.c:668-775)."""
    from treeqp_tpu.utils.tree import TreeStructure
    from treeqp_tpu.core.qp_data import TreeQPIn as QPIn

    # asymmetric tree: root with 3 kids, one kid chains 3 deep, one 1 deep
    parent = [-1, 0, 0, 0, 1, 4, 2, 5]
    nx, nu = [3] * 8, [2] * 8
    topo = TreeStructure.from_parent(parent, nx, nu, [0] * 8)
    rng = np.random.default_rng(3)
    Nn = topo.Nn
    Qd = 1.0 + rng.random((Nn, 3))
    Rd = 1.0 + rng.random((Nn, 2))
    qp = QPIn.zeros(topo).replace(
        Q=jnp.asarray(np.einsum("ni,ij->nij", Qd, np.eye(3))),
        R=jnp.asarray(np.einsum("ni,ij->nij", Rd, np.eye(2))),
        q=jnp.asarray(rng.standard_normal((Nn, 3))),
        r=jnp.asarray(rng.standard_normal((Nn, 2))),
        A=jnp.asarray(rng.standard_normal((Nn, 3, 3)) * 0.4),
        B=jnp.asarray(rng.standard_normal((Nn, 3, 2)) * 0.4),
        b=jnp.asarray(rng.standard_normal((Nn, 3)) * 0.1),
        xmin=jnp.full((Nn, 3), -0.8), xmax=jnp.full((Nn, 3), 0.8),
        umin=jnp.full((Nn, 2), -0.6), umax=jnp.full((Nn, 2), 0.6),
    )
    # edge row 0 must stay zero (edge data indexed by child)
    qp = qp.replace(A=qp.A.at[0].set(0.0), B=qp.B.at[0].set(0.0),
                    b=qp.b.at[0].set(0.0))
    out = tdunes_solve(qp, None, GENERIC_SPEED_OPTS)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    ref = tdunes_solve(qp, None, TdunesOpts(stage_solver="clipping",
                                            tol=1e-10, max_iter=120))
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-6
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-6


@pytest.mark.slow
def test_generic_two_phase_pruned_tree():
    """Two-phase schedule on a PRUNED (fault-tolerance-class)
    scenario tree: prune a multistage tree to 5 scenarios (asymmetric
    result), solve with the speed opts, compare against plain f64."""
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.utils.pruning import prune_scenario_tree

    qp_full, _ = spring_mass_chain(nm=1, md=3, Nr=2, Nh=7)
    rng = np.random.default_rng(0)
    leaf_probs = rng.dirichlet(np.ones(9))
    qp, _ = prune_scenario_tree(qp_full, leaf_probs=leaf_probs, nscenmax=5)
    assert qp.topo.multistage_params is None  # genuinely asymmetric now
    out = tdunes_solve(qp, None, GENERIC_SPEED_OPTS)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    ref = tdunes_solve(qp, None, TdunesOpts(stage_solver="clipping",
                                            tol=1e-10, max_iter=120))
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-6


def test_generic_two_phase_general_constraints():
    """Two-phase with qpgen stage QPs (general C/D rows) on a golden
    dataset with general constraints still meets the KKT bar."""
    import dataclasses

    qp, extras = load_tree_qp_file(
        "/root/reference/examples/random_qp_utils/data03.json")
    opts = dataclasses.replace(GENERIC_SPEED_OPTS, stage_solver="qpgen",
                               tol=1e-8)
    out = tdunes_solve(qp, None, opts)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    err = max(np.max(np.abs(np.asarray(out.x) - extras["xopt"])),
              np.max(np.abs(np.asarray(out.u) - extras["uopt"])))
    assert err < 1e-7
