"""Scaling ANALYSIS for the scenario-sharded multistage solver
(VERDICT r2 #9 / BASELINE.md scaling row).

Two parts; neither is a hardware measurement:

1. **Model** the sharded per-iteration execution exactly: per-device
   load balance (chain nodes per device vs the replicated crown) and the
   collective BYTES each Newton iteration moves over the mesh axis,
   counted from the actual array shapes GSPMD communicates (f64):
     * chain -> crown root contributions cqr [S, nz]   (all-gather)
     * chain Schur complements schur0 [S, nx, nx]       (all-gather)
     * chain-root duals dlam[rid] (crown replicated -> no gather back)
     * termination norm / dual value / Armijo dot       (scalar psums)
   Next to them stand the byte counts audited from the compiled HLO
   (tests/test_hlo_audit.py). Turning bytes into time needs a measured
   per-iteration time and link bandwidth on the cards; neither is
   measured yet.

2. **Measure** the virtual-device sweep (benchmarks/scaling.py) and
   label it for what it is: N virtual devices multiplexing ONE shared
   CPU core — wall-clock "efficiency" there is shared-core-confounded
   and validates only that the collectives compile and execute.

Run: python -m benchmarks.scaling_analysis [--skip-virtual]
Writes benchmarks/results/scaling.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# quadcopter-class headline workload (bench.py)
MD, NR, NH, NM = 4, 4, 20, 4


def model(n_devices: int, S: int):
    """Per-iteration communication/load model for S scenarios on D devices."""
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    qp, _ = spring_mass_chain(nm=NM, md=MD, Nr=NR, Nh=NH)
    ms = split_multistage(qp)
    meta = ms.meta
    nx, nz, L = meta.nx, meta.nx + meta.nu, meta.L
    assert meta.S == S

    f64 = 8
    # collective bytes per Newton iteration over the scenario axis
    ag_cqr = S * nz * f64                 # chain root contributions
    ag_schur = S * nx * nx * f64          # chain Schur into the crown
    psums = 6 * 8                         # termination/dual/dot scalars
    # load balance: chains split evenly (identical shapes); the crown is
    # replicated (Amdahl term — every device redoes the crown work)
    return dict(
        devices=n_devices, scenarios=S,
        chain_nodes_per_device=S * L // n_devices,
        crown_nodes=meta.crown_topo.Nn,
        collective_bytes_per_iter=int(ag_cqr + ag_schur + psums))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-virtual", action="store_true")
    ap.add_argument("--out", default="benchmarks/results/scaling.jsonl")
    args = ap.parse_args(argv)

    rows = [{"kind": "model", **model(d, MD**NR)} for d in (1, 2, 4, 8)]
    # HLO audit (tests/test_hlo_audit.py, treeqp_tpu/parallel/
    # hlo_audit.py): the GSPMD auto-partitioned jit path as COMPILED moves
    # ~6.37 MB/iter on the headline tree — far above this model's minimal
    # count (chain-shaped gathers around layout transposes, full-width
    # reduction workspaces, crown-shaped contribution all-reduces). The
    # model
    # row above is the MINIMAL boundary traffic the algorithm needs (and
    # what an explicit shard_map port of the iteration pays); the audited
    # row is what jit+GSPMD produces today. Weak-scaling predictions from
    # the model apply to the shard_map design point, not the audited jit
    # path.
    audited = 6_367_656
    rows.append({"kind": "hlo-audit", "devices": 8, "scenarios": MD**NR,
                 "collective_bytes_per_iter": audited,
                 "note": "GSPMD-auto jit path, compiled at 256 scenarios "
                         "on an 8-device mesh; see tests/test_hlo_audit.py"})
    # the explicit-SPMD shard_map path (parallel/shard_solver.py): the
    # solver inserts the boundary collectives itself (all-gathered chain
    # root contributions [S, nz] / Schur complements [S, nx, nx] + scalar
    # psums) — audited at ~0.42 MB/iter static (includes the f64 phase,
    # refinement gathers and the rarely-taken sequential line-search
    # branch), 15x below GSPMD-auto.
    audited_shmap = 420_996
    rows.append({"kind": "hlo-audit-shard-map", "devices": 8,
                 "scenarios": MD**NR,
                 "collective_bytes_per_iter": audited_shmap,
                 "note": "explicit-SPMD shard_map path "
                         "(parallel/shard_solver.py), compiled at 256 "
                         "scenarios on an 8-device mesh; "
                         "tests/test_hlo_audit.py::"
                         "test_shard_map_path_reaches_model_bytes"})

    if not args.skip_virtual:
        # virtual-device measurement (labeled: shared-core-confounded)
        import jax
        if jax.default_backend() == "cpu" and len(jax.devices()) >= 8:
            from benchmarks.scaling import scaling_sweep
            for r in scaling_sweep(devices=(1, 2, 4, 8)):
                r = dict(r)
                r["kind"] = "virtual-cpu-measured"
                r["note"] = ("N virtual devices multiplex ONE shared CPU "
                             "core: wall-clock efficiency is shared-core-"
                             "confounded; this validates collective "
                             "structure + load balance, NOT hardware "
                             "scaling")
                rows.append(r)
        else:
            rows.append({"kind": "virtual-cpu-measured", "skipped":
                         "run with XLA_FLAGS=--xla_force_host_platform_"
                         "device_count=8 JAX_PLATFORMS=cpu"})

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
