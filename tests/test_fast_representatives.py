"""Fast representatives of the slow-marked test families (round 5,
verdict task 9): the default gate must touch sharding byte budgets and
the chain kernels daily, not only in CI's full matrix.

* one HLO collective audit at a 2-device mesh on a tiny tree
  (the test_hlo_audit.py family);
* one multistage solve through the Triton chain sweeps in interpret mode
  at tiny shapes (the test_chain_kernels family).
"""

import numpy as np
import jax
import jax.numpy as jnp

from treeqp_tpu.parallel.hlo_audit import audit_compiled


def test_audit_representative_2dev():
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.solvers.tdunes import TdunesOpts
    from treeqp_tpu.solvers.tdunes_multistage import (
        split_multistage, tdunes_ms_solve)
    from treeqp_tpu.parallel.sharding import scenario_mesh, shard_multistage

    qp, _ = spring_mass_chain(nm=1, md=2, Nr=1, Nh=3)
    ms = split_multistage(qp)
    mesh = scenario_mesh(jax.devices()[:2])
    ms = shard_multistage(ms, mesh)
    opts = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=10)
    fn = jax.jit(lambda m: tdunes_ms_solve(m, None, None, opts))
    a = audit_compiled(fn.lower(ms).compile(), "tdunes_ms_solve",
                       scan_weight=ms.meta.L)
    # collectives present; no chain-interior movement
    assert a["census"].get("all-reduce", 0) > 0
    chain_bytes = ms.meta.S * ms.meta.L * ms.meta.nx * ms.meta.nx * 8
    big_gather = max((o.bytes_global for o in a["ops"]
                      if o.kind != "all-reduce"), default=0)
    assert big_gather < max(chain_bytes, 1), big_gather


def test_chain_kernel_solve_representative(monkeypatch):
    """A tiny multistage solve with the Triton chain sweeps (Pallas
    interpreter on CPU) agrees with the plain XLA scans — the kernel-path
    daily-gate case (kernel-level cases: test_chain_kernels.py)."""
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.core.kkt import max_kkt_residual
    from treeqp_tpu.solvers import tdunes_multistage as tm
    from treeqp_tpu.solvers.tdunes import TdunesOpts
    from treeqp_tpu.solvers.tdunes_multistage import (
        split_multistage, tdunes_ms_solve, merge_output)

    qp, _ = spring_mass_chain(nm=2, md=2, Nr=2, Nh=6)
    ms = split_multistage(qp)
    opts = TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=60)
    outs = {}
    for triton in (False, True):
        # the sweep path is chosen while the solve is traced
        jax.clear_caches()
        monkeypatch.setattr(tm, "_triton_sweeps",
                            lambda meta, shard=None, t=triton: t)
        cro, cho, info = tdunes_ms_solve(ms, None, None, opts)
        assert int(info["status"]) == 0
        outs[triton] = (merge_output(ms, cro, cho, info), int(info["iter"]))
    jax.clear_caches()
    (o_x, it_x), (o_p, it_p) = outs[False], outs[True]
    assert it_p == it_x
    assert float(max_kkt_residual(qp, o_p)) < 1e-10
    np.testing.assert_allclose(np.asarray(o_p.x), np.asarray(o_x.x),
                               atol=1e-10)
