"""1024-scenario bench point on the GPU.

md=4, Nr=5, Nh=20 -> 1024 scenarios, 16725 nodes (spring-mass chain,
nx=8): a 1365-node crown and chains of L=15. Options come from bench.py's
GPU option set.

Cold-chain protocol as bench.py at a reduced CHAIN_R; the KKT oracle
certifies the base and one perturbed instance first. Run
``python -m benchmarks.scen1024_bench`` on a GPU machine (it fails without
one); prints one JSON line.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

CHAIN_R = int(os.environ.get("TREEQP_1024_CHAIN", "24"))
NREP = 3
TOL = 1e-8


def _build():
    import bench
    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    qp, _ = spring_mass_chain(nm=4, md=4, Nr=5, Nh=20)
    ms = split_multistage(qp)
    opts = dataclasses.replace(bench.bench_opts(), max_iter=150)
    return qp, ms, opts


def main():
    import bench
    from treeqp_tpu.solvers.tdunes_multistage import tdunes_ms_solve
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dev = require_gpu()
    print(f"card (name, power limit): {card_info()}", file=sys.stderr)
    qp, ms, opts = _build()
    qp, ms = jax.device_put((qp, ms), dev)
    check = bench.certify(qp, ms, opts)
    assert check["status"] == 0 and check["kkt"] < TOL, check
    assert check["status_perturbed"] == 0 \
        and check["kkt_perturbed"] < TOL, check

    meta = ms.meta
    lam0c = jnp.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), ms.q.dtype)
    lam0h = jnp.zeros_like(ms.q)

    @jax.jit
    def run_chain(seed):
        def body(carry, k):
            ms_k = bench.perturb_ms(ms, bench.perturb_factor(k, seed))
            cro, cho, inf = tdunes_ms_solve(ms_k, lam0c, lam0h, opts)
            return 0.0, (inf["iter"], inf["error"], inf["status"])
        _, (iters, errs, stats) = jax.lax.scan(
            body, 0.0, jnp.arange(CHAIN_R, dtype=ms.q.dtype))
        return iters, errs, stats

    out = jax.block_until_ready(run_chain(np.float64(0)))
    times = []
    for k in range(NREP):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run_chain(np.float64(k + 1)))
        times.append(time.perf_counter() - t0)
    iters, errs, stats = (np.asarray(v) for v in out)
    t = min(times)
    assert np.all(stats == 0), stats
    assert np.all(errs < TOL), errs.max()
    print(json.dumps(dict(
        metric="tdunes_ms_1024scen", scenarios=1024, nodes=qp.topo.Nn,
        crown_nodes=int(ms.meta.crown_topo.Nn), device=dev.device_kind,
        protocol="chain", valid=True,
        ms_per_solve=round(t / CHAIN_R * 1e3, 2),
        iters_per_solve=round(float(iters.mean()), 2),
        iters_per_sec=round(float(iters.sum()) / t, 1),
        max_err=float(errs.max()),
        certified_kkt=check["kkt"],
        certified_kkt_pert=check["kkt_perturbed"],
        chain=CHAIN_R, nrep=NREP)))


if __name__ == "__main__":
    main()
