"""Mesh sharding for the scenario-decomposed solvers.

The scaling design (SURVEY.md 5.8, replacing the reference's single-process
OpenMP backend): scenarios/chains are sharded over a 1-D device mesh axis
``"scen"`` with ``jax.sharding``; the crown (non-anticipativity coupling)
stays replicated. XLA/GSPMD inserts the all-gathers for the chain-root duals
and Schur complements and the psum/pmax for termination norms.

Every device computes the replicated crown itself and the solvers' loops
branch on it, so the crown code sums in a fixed order (no atomic
scatter-adds, ``tests/test_deterministic_ops.py``): the devices' copies
agree bitwise and take the same branches.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from treeqp_tpu.solvers.tdunes_multistage import MultistageQP

__all__ = ["scenario_mesh", "shard_multistage"]


def scenario_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name "scen"."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=("scen",))


def shard_multistage(ms: MultistageQP, mesh: Mesh) -> MultistageQP:
    """Place chain arrays sharded over "scen" (dim 0) and the crown replicated.

    The scenario count S must be divisible by the mesh size. The result's
    ``meta.chain_shards`` records the split, so the solver runs its chain
    sweeps as scans, which GSPMD partitions.
    """
    n = mesh.devices.size
    assert ms.meta.S % n == 0, f"S={ms.meta.S} not divisible by {n} devices"
    ms = dataclasses.replace(
        ms, meta=dataclasses.replace(ms.meta, chain_shards=n))
    chain_sh = NamedSharding(mesh, P("scen"))
    repl = NamedSharding(mesh, P())

    def place(path, x):
        name = path[0].name if path else ""
        if name == "crown":
            return jax.device_put(x, repl)
        return jax.device_put(x, chain_sh)

    return jax.tree_util.tree_map_with_path(place, ms)


def shard_scenarios(sqp, mesh: Mesh):
    """Place ScenarioQP arrays sharded over "scen" (dim 0 = scenarios).

    sdunes' per-scenario work (stage solves, banded factorizations/sweeps)
    then fans out across devices; GSPMD inserts the adjacent-scenario
    boundary exchanges (non-anticipativity residuals, Jay couplings) and
    the termination-norm reductions — the distributed translation of the
    reference's `omp parallel for` over scenarios
    (dual_Newton_scenarios.c:332-345).
    """
    n = mesh.devices.size
    assert sqp.meta.Ns % n == 0, \
        f"Ns={sqp.meta.Ns} not divisible by {n} devices"
    sh = NamedSharding(mesh, P("scen"))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), sqp)
