"""Explicit-SPMD (shard_map) multistage solve: parity with the
single-device solver on a virtual 8-device mesh (parallel/shard_solver.py;
the psum-only communication structure is audited in test_hlo_audit.py)."""

import jax
import jax.numpy as jnp
import pytest

from benchmarks.models import spring_mass_chain
from treeqp_tpu.core.kkt import max_kkt_residual
from treeqp_tpu.solvers.tdunes import TdunesOpts
from treeqp_tpu.solvers.tdunes_multistage import (
    split_multistage, tdunes_ms_solve, merge_output)
from treeqp_tpu.parallel.sharding import scenario_mesh
from treeqp_tpu.parallel.shard_solver import tdunes_ms_solve_shmap


def test_shmap_matches_single_device():
    qp, _ = spring_mass_chain(nm=4, md=2, Nr=3, Nh=8)
    ms = split_multistage(qp)
    mesh = scenario_mesh(jax.devices()[:8])
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=30)
    cro, cho, info = jax.jit(
        lambda m: tdunes_ms_solve_shmap(m, None, None, opts, mesh))(ms)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    cro0, cho0, info0 = tdunes_ms_solve(ms, None, None, opts)
    out0 = merge_output(ms, cro0, cho0, info0)
    assert int(info["iter"]) == int(info0["iter"])
    assert float(jnp.max(jnp.abs(out.x - out0.x))) < 1e-9


def test_ipm_shmap_matches_single_device():
    """Explicit-SPMD multistage IPM (round 5): parity with the
    single-device ipm_ms_solve on the virtual 8-device mesh."""
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
    from treeqp_tpu.parallel.shard_solver import ipm_ms_solve_shmap

    qp, _ = spring_mass_chain(nm=4, md=2, Nr=3, Nh=8)
    ms = split_multistage(qp)
    mesh = scenario_mesh(jax.devices()[:8])
    opts = IpmOpts(tol=1e-10, max_iter=40)
    cro, cho, info = jax.jit(
        lambda m: ipm_ms_solve_shmap(m, opts, mesh))(ms)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
    cro0, cho0, info0 = ipm_ms_solve(ms, opts)
    out0 = merge_output(ms, cro0, cho0, info0)
    assert int(info["iter"]) == int(info0["iter"])
    assert float(jnp.max(jnp.abs(out.x - out0.x))) < 1e-9


def test_ipm_shmap_general_rows():
    """Sharded IPM with general C/D rows (dense barrier chains)."""
    from benchmarks.models import with_general_rows
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.parallel.shard_solver import ipm_ms_solve_shmap

    qp0, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=6)
    qp = with_general_rows(qp0, cmax=0.6)
    ms = split_multistage(qp)
    mesh = scenario_mesh(jax.devices()[:8])
    opts = IpmOpts(tol=1e-9, max_iter=50)
    cro, cho, info = jax.jit(
        lambda m: ipm_ms_solve_shmap(m, opts, mesh))(ms)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-7


@pytest.mark.slow
def test_sdunes_shmap_matches_single_device():
    """Explicit-SPMD sdunes (round 5): parity with the single-device
    solver on the virtual 8-device mesh (warm-started from IPM duals,
    the engine's documented usage — examples/spring_mass.py)."""
    from treeqp_tpu.solvers.sdunes import (
        SdunesOpts, scenario_data, sdunes_solve, scenario_duals_from_tree)
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
    from treeqp_tpu.parallel.shard_solver import sdunes_solve_shmap

    qp, _ = spring_mass_chain(nm=3, md=2, Nr=3, Nh=8)
    sqp = scenario_data(qp)
    ms = split_multistage(qp)
    cro, cho, info_i = ipm_ms_solve(ms, IpmOpts(tol=1e-10, max_iter=40))
    out_i = merge_output(ms, cro, cho, info_i)
    lam0, mu0 = scenario_duals_from_tree(sqp, out_i.lam, out_i)

    opts = SdunesOpts(tol=1e-8, max_iter=30)
    sol0, lam_0, mu_0, info0 = sdunes_solve(sqp, lam0, mu0, opts)
    mesh = scenario_mesh(jax.devices()[:8])
    sol, lam, mu, info = jax.jit(
        lambda a, b, c: sdunes_solve_shmap(a, b, c, opts, mesh))(
            sqp, lam0, mu0)
    assert int(info["status"]) == 0
    assert int(info["iter"]) == int(info0["iter"])
    assert float(jnp.max(jnp.abs(sol["x"] - sol0["x"]))) < 1e-9
    assert float(jnp.max(jnp.abs(mu - mu_0))) < 1e-8


def test_shmap_two_phase_speed_opts():
    """The f32->f64 two-phase schedule under shard_map (xla backend;
    kernel paths are per-device-global and bypassed)."""
    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    ms = split_multistage(qp)
    mesh = scenario_mesh(jax.devices()[:8])
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=60,
                      factor_dtype="float32", refine_steps=1,
                      refine_safeguard=False,
                      reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4)
    cro, cho, info = jax.jit(
        lambda m: tdunes_ms_solve_shmap(m, None, None, opts, mesh))(ms)
    out = merge_output(ms, cro, cho, info)
    assert int(info["status"]) == 0
    assert float(max_kkt_residual(qp, out)) < 1e-8
