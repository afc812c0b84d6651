"""Scenario-sharded multistage solver tests: equivalence with the generic
tree solver and correctness under a multi-device mesh (the translation of
the reference CI matrix — same numerics single-device vs sharded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treeqp_tpu import max_kkt_residual
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from treeqp_tpu.solvers.tdunes_multistage import (
    split_multistage, tdunes_ms_solve, merge_output)
from treeqp_tpu.parallel.sharding import scenario_mesh, shard_multistage
from benchmarks.models import spring_mass_qp, spring_mass_chain

OPTS = TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=100)


def test_multistage_matches_generic_spring_mass():
    qp, _ = spring_mass_qp()
    ms = split_multistage(qp)
    cro, cho, info = tdunes_ms_solve(ms, None, None, OPTS)
    out = merge_output(ms, cro, cho, info)
    ref = tdunes_solve(qp, None, OPTS)
    # same algorithm, different summation order -> allow 1-2 iteration drift
    assert abs(int(info["iter"]) - int(ref.info["iter"])) <= 2
    assert float(max_kkt_residual(qp, out)) < 1e-10
    assert float(jnp.max(jnp.abs(out.x - ref.x))) < 1e-10
    assert float(jnp.max(jnp.abs(out.u - ref.u))) < 1e-10
    assert float(jnp.max(jnp.abs(out.lam - ref.lam))) < 1e-9


@pytest.mark.slow
def test_sharded_matches_unsharded():
    qp, _ = spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    ms = split_multistage(qp)
    assert ms.meta.S == 8
    mesh = scenario_mesh()
    mss = shard_multistage(ms, mesh)
    cro_s, cho_s, info_s = tdunes_ms_solve(mss, None, None, OPTS)
    cro, cho, info = tdunes_ms_solve(ms, None, None, OPTS)
    assert int(info_s["iter"]) == int(info["iter"])
    out_s = merge_output(mss, cro_s, cho_s, info_s)
    out = merge_output(ms, cro, cho, info)
    assert float(max_kkt_residual(qp, out_s)) < 1e-10
    assert float(jnp.max(jnp.abs(out_s.x - out.x))) < 1e-12


def test_multistage_detection():
    qp, _ = spring_mass_chain(nm=1, md=3, Nr=2, Nh=5)
    assert qp.topo.multistage_params == (3, 2, 5)
    qp2, _ = spring_mass_qp()
    assert qp2.topo.multistage_params == (3, 2, 10)
