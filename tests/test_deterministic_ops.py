"""The solvers sum in a fixed order: no scatter-add that XLA must run on
atomics (``hlo_audit.atomic_scatter_adds``) in their lowered programs.

On a GPU an atomic scatter-add makes a solve differ from run to run in the
last bit. The scenario-sharded solvers compute the replicated crown on
every device and branch on it, so devices whose copies differ take other
branches and deadlock in a collective. Lowering is platform-independent
at this level, so the check runs on the CPU.
"""

import pytest

import jax

from treeqp_tpu.parallel.hlo_audit import atomic_scatter_adds


def _tiny():
    from benchmarks.models import quadcopter
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    qp = quadcopter(md=2, Nr=2, Nh=6).qp
    return qp, split_multistage(qp)


def _tdunes_ms(**kw):
    from treeqp_tpu.solvers.tdunes import TdunesOpts
    from treeqp_tpu.solvers.tdunes_multistage import tdunes_ms_solve

    qp, ms = _tiny()
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=20,
                      reg_type="on_the_fly", **kw)
    return tdunes_ms_solve.lower(ms, None, None, opts)


def _mesh():
    from treeqp_tpu.parallel.sharding import scenario_mesh
    return scenario_mesh(jax.devices()[:2])


LEGS = {
    # bench.py's option set (the headline path)
    "tdunes_ms": lambda: _tdunes_ms(),
    # f32 factors with refinement, f32 coarse phase and the df64 phase
    "tdunes_ms_mixed": lambda: _tdunes_ms(
        factor_dtype="float32", refine_steps=1, refine_safeguard=True,
        f32_phase_tol=1e-4, df64_phase=True),
    "tdunes_generic": lambda: _generic_tdunes(),
    "ipm_generic": lambda: _generic_ipm(),
    "ipm_ms": lambda: _ipm_ms(),
    "sdunes": lambda: _sdunes(),
    "tdunes_ms_shmap": lambda: _shmap("tdunes"),
    "ipm_ms_shmap": lambda: _shmap("ipm"),
}


def _generic_tdunes():
    from treeqp_tpu.solvers.tdunes import TdunesOpts, _tdunes_solve_jit

    qp, _ = _tiny()
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=20,
                      factor_dtype="float32", refine_steps=1)
    return _tdunes_solve_jit.lower(qp, None, opts, None)


def _generic_ipm():
    from treeqp_tpu.solvers.ipm import IpmOpts, _ipm_solve_jit

    qp, _ = _tiny()
    return _ipm_solve_jit.lower(qp, IpmOpts(tol=1e-8, max_iter=30), None)


def _ipm_ms():
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve

    _, ms = _tiny()
    return ipm_ms_solve.lower(ms, IpmOpts(tol=1e-8, max_iter=30))


def _sdunes():
    from treeqp_tpu.solvers.sdunes import SdunesOpts, scenario_data, sdunes_solve

    qp, _ = _tiny()
    return sdunes_solve.lower(scenario_data(qp), None, None,
                              SdunesOpts(tol=1e-8, max_iter=50))


def _shmap(which):
    from treeqp_tpu.parallel.shard_solver import (
        ipm_ms_solve_shmap, tdunes_ms_solve_shmap)
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.solvers.tdunes import TdunesOpts

    _, ms = _tiny()
    mesh = _mesh()
    if which == "tdunes":
        opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=20)
        return jax.jit(lambda m: tdunes_ms_solve_shmap(
            m, None, None, opts, mesh)).lower(ms)
    return jax.jit(lambda m: ipm_ms_solve_shmap(
        m, IpmOpts(tol=1e-8, max_iter=30), mesh)).lower(ms)


@pytest.mark.parametrize("leg", list(LEGS))
def test_no_atomic_scatter_adds(leg):
    found = atomic_scatter_adds(LEGS[leg]().as_text())
    assert not found, "\n".join(found[:5])


def test_audit_flags_segment_sum():
    """The audit itself: segment_sum over a parent array is flagged, the
    fixed-order kid_sum is not, and both agree numerically."""
    import jax.numpy as jnp
    import numpy as np

    from treeqp_tpu.utils.tree import kid_sum

    qp, _ = _tiny()
    topo = qp.topo
    v = jnp.asarray(np.random.default_rng(0).standard_normal((topo.Nn, 3)))
    par = topo.parent_np

    def seg(v):
        return jax.ops.segment_sum(v[1:], par[1:], num_segments=topo.Nn)

    assert atomic_scatter_adds(jax.jit(seg).lower(v).as_text())
    fixed = jax.jit(lambda v: kid_sum(v, topo))
    assert not atomic_scatter_adds(fixed.lower(v).as_text())
    np.testing.assert_allclose(fixed(v), seg(v), rtol=1e-15, atol=1e-15)
