"""Parity of the scatter-free sliced tree Cholesky (round 5) against the
scan-based path: same factors, same Newton directions, on generic trees.

The sliced path replaces the `.at[idx].add` scatters of the level sweep
with static slices + one-hot slot matmuls; the
math is identical (dual_Newton_tree.c:668-775)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from benchmarks.models import spring_mass_chain, with_general_rows
from treeqp_tpu.solvers.tdunes import (
    TdunesOpts, tdunes_solve, _get_prep, _sliced_sched,
    _tree_chol_factor, _tree_chol_solve,
    _tree_chol_factor_sliced, _tree_chol_solve_sliced)
from treeqp_tpu.core.kkt import max_kkt_residual


def _rand_blocks(prep, seed=0):
    rng = np.random.default_rng(seed)
    G, nxm, NpG = prep.G, prep.nxm, prep.NpG
    A = rng.standard_normal((NpG, G, G))
    W = A @ A.transpose(0, 2, 1) + 3.0 * np.eye(G)
    Ut = 0.3 * rng.standard_normal((NpG, nxm, G))
    rg = rng.standard_normal((NpG, G))
    return jnp.asarray(W), jnp.asarray(Ut), jnp.asarray(rg)


@pytest.mark.parametrize("dims", [(3, 2, 10), (2, 3, 6)])
def test_sliced_factor_solve_parity(dims, monkeypatch):
    # the random W here has no chain blockdiag structure, so the
    # dispatching _tree_chol_factor (which may pick the multistage-split
    # path under TREEQP_SLICED_CHOL=1) must be pinned to the scan path
    # as the reference; the sliced path is called explicitly.
    monkeypatch.setenv("TREEQP_SLICED_CHOL", "0")
    md, Nr, Nh = dims
    qp, _ = spring_mass_chain(nm=3, md=md, Nr=Nr, Nh=Nh)
    prep = _get_prep(qp.topo)
    sched = _sliced_sched(prep)
    assert sched is not None, "multistage trees must be level-contiguous"
    W, Ut, rg = _rand_blocks(prep)
    opts = TdunesOpts(reg_type="always", reg_value=1e-9)
    f_ref = _tree_chol_factor(W, Ut, opts, prep)
    dl_ref = _tree_chol_solve(f_ref, rg, opts, prep)
    f_sl = _tree_chol_factor_sliced(W, Ut, opts, prep, sched)
    dl_sl = _tree_chol_solve_sliced(f_sl, rg, opts, prep, sched)
    NpG = prep.NpG  # the scan path carries a scratch block at index NpG
    np.testing.assert_allclose(np.asarray(f_sl["CholW"]),
                               np.asarray(f_ref["CholW"][:NpG]), atol=1e-11)
    np.testing.assert_allclose(np.asarray(dl_sl), np.asarray(dl_ref),
                               atol=1e-9)


def test_split_factor_solve_parity():
    """The multistage-split path (chain levels through the banded chain
    machinery + sliced crown, round 5) against the scan path, on REAL
    dual-Hessian blocks (the chain blocks carry the blockdiag structure
    the split exploits) with slot-masked RHS (the solver's rg is always
    masked by kvalid)."""
    from treeqp_tpu.solvers import tdunes as td
    from benchmarks.models import with_general_rows

    qp0, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    qp = with_general_rows(qp0, cmax=0.6)
    prep = td._get_prep(qp.topo)
    split = td._split_sched(prep)
    assert split is not None and len(split[0]) >= 3
    opts = TdunesOpts(stage_solver="qpgen", reg_type="always",
                      reg_value=1e-6)
    data = td._stage_data(qp, opts)
    rng = np.random.default_rng(0)
    lam = jnp.asarray(0.1 * rng.standard_normal(
        (qp.topo.Nn, qp.topo.nxm))) * td._masks(qp)[2]
    sol = td._stage_solve(qp, lam, data, opts, prep)
    W, Ut = td._build_dual_hessian(qp, sol, data, opts, prep)
    kv = np.repeat(np.asarray(prep.kvalid), prep.nxm, axis=1)
    rg = jnp.asarray(rng.standard_normal((prep.NpG, prep.G)) * kv)
    f_ref = td._tree_chol_factor(W, Ut, opts, prep)
    dl_ref = td._tree_chol_solve(f_ref, rg, opts, prep)
    f_sp = td._tree_chol_factor_split(W, Ut, opts, prep, split)
    dl_sp = td._tree_chol_solve_split(f_sp, rg, opts, prep, split)
    np.testing.assert_allclose(np.asarray(dl_sp), np.asarray(dl_ref),
                               atol=1e-9)


def test_split_solver_end_to_end(monkeypatch):
    """Full qpgen solve with the split factorization forced on a
    multistage-shaped tree."""
    monkeypatch.setenv("TREEQP_SLICED_CHOL", "1")
    from benchmarks.models import with_general_rows
    qp0, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    qp = with_general_rows(qp0, cmax=0.6)
    opts = TdunesOpts(stage_solver="qpgen", tol=2.5e-9, max_iter=150,
                      factor_dtype="float32", refine_steps=1,
                      refine_safeguard=False, qpgen_factor_dtype="float32",
                      reg_type="always", reg_value=1e-6,
                      f32_phase_tol=1e-4, f32_patience=3)
    out = tdunes_solve(qp, None, opts)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8


def test_sliced_solver_end_to_end(monkeypatch):
    monkeypatch.setenv("TREEQP_SLICED_CHOL", "1")
    qp0, _ = spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    qp = with_general_rows(qp0, cmax=0.6)
    opts = TdunesOpts(stage_solver="qpgen", tol=2.5e-9, max_iter=150,
                      factor_dtype="float32", refine_steps=1,
                      refine_safeguard=False, qpgen_factor_dtype="float32",
                      reg_type="always", reg_value=1e-6,
                      f32_phase_tol=1e-4, f32_patience=3)
    out = tdunes_solve(qp, None, opts)
    assert int(out.info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
