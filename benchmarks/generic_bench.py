"""Generic-tree benchmark on the GPU.

Measures dual-Newton per-iteration cost for tree shapes the multistage
crown+chains solver cannot take — asymmetric (thesis-class) and pruned
(fault-tolerance-class) trees — against the multistage path on a
comparable-size tree. Options come from bench.py's GPU option set.

Protocol: CHAIN_R cold solves of per-solve-perturbed instances inside one
jit (the bench.py chain discipline), per-solve status/error asserted.
Reported: ms per Newton iteration and ns per node per iteration (the
size-normalized comparison).

Run ``python -m benchmarks.generic_bench`` on a GPU machine (it fails
without one); ``TREEQP_GENERIC_MODE=<mode>`` runs one mode. Prints one
JSON line per mode.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHAIN_R = int(os.environ.get("TREEQP_GENERIC_CHAIN", "48"))
NREP = 3
TOL = 1e-8

MODES = ("ms", "pruned", "asym")


def build(mode):
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.models import spring_mass_chain
    from treeqp_tpu.core.qp_data import TreeQPIn
    from treeqp_tpu.utils.pruning import prune_scenario_tree
    from treeqp_tpu.utils.tree import TreeStructure

    if mode == "ms":
        # multistage reference point: 27-scenario spring-mass tree
        qp, _ = spring_mass_chain(nm=2, md=3, Nr=3, Nh=12)
        return qp
    if mode == "pruned":
        # fault-tolerance-class pruned tree: same family, pruned to 12
        # scenarios -> genuinely asymmetric topology
        qp_full, _ = spring_mass_chain(nm=2, md=3, Nr=3, Nh=12)
        rng = np.random.default_rng(0)
        qp, _ = prune_scenario_tree(
            qp_full, leaf_probs=rng.dirichlet(np.ones(27)), nscenmax=12)
        assert qp.topo.multistage_params is None
        return qp
    # thesis-example-class asymmetric tree, scaled to non-trivial dims
    rng = np.random.default_rng(3)
    # root branches 3 ways; kids chain to different depths (2/5/9)
    parent = [-1, 0, 0, 0]
    tips = [1, 2, 3]
    for d, depth in zip((1, 2, 3), (2, 5, 9)):
        for _ in range(depth):
            parent.append(tips[d - 1])
            tips[d - 1] = len(parent) - 1
    Nn = len(parent)
    nx, nu = 8, 3
    topo = TreeStructure.from_parent(parent, [nx] * Nn, [nu] * Nn, [0] * Nn)
    Qd = 1.0 + rng.random((Nn, nx))
    Rd = 1.0 + rng.random((Nn, nu))
    qp = TreeQPIn.zeros(topo).replace(
        Q=jnp.asarray(np.einsum("ni,ij->nij", Qd, np.eye(nx))),
        R=jnp.asarray(np.einsum("ni,ij->nij", Rd, np.eye(nu))),
        q=jnp.asarray(rng.standard_normal((Nn, nx))),
        r=jnp.asarray(rng.standard_normal((Nn, nu))),
        A=jnp.asarray(rng.standard_normal((Nn, nx, nx)) * 0.3),
        B=jnp.asarray(rng.standard_normal((Nn, nx, nu)) * 0.3),
        b=jnp.asarray(rng.standard_normal((Nn, nx)) * 0.1),
        xmin=jnp.full((Nn, nx), -0.9), xmax=jnp.full((Nn, nx), 0.9),
        umin=jnp.full((Nn, nu), -0.7), umax=jnp.full((Nn, nu), 0.7),
    )
    return qp.replace(A=qp.A.at[0].set(0.0), B=qp.B.at[0].set(0.0),
                      b=qp.b.at[0].set(0.0))


def mode_main(mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_opts

    qp = build(mode)
    dev = jax.devices()[0]
    qp = jax.device_put(qp, dev)
    opts = bench_opts()

    if mode == "ms":
        from treeqp_tpu.solvers.tdunes_multistage import (
            split_multistage, tdunes_ms_solve)

        ms = split_multistage(qp)

        @jax.jit
        def run_chain(seed):
            def body(carry, k):
                fac = 1.0 + 0.02 * jnp.sin(seed + 1.7 * (k + 1.0))
                cr2 = ms.crown.replace(xmin=ms.crown.xmin.at[0].multiply(fac),
                                       xmax=ms.crown.xmax.at[0].multiply(fac))
                ms_k = dataclasses.replace(ms, crown=cr2)
                _, _, inf = tdunes_ms_solve(ms_k, None, None, opts)
                return carry, (inf["iter"], inf["error"], inf["status"])
            _, ys = jax.lax.scan(body, 0.0,
                                 jnp.arange(CHAIN_R, dtype=qp.dtype))
            return ys
    else:
        from treeqp_tpu.solvers.tdunes import tdunes_solve

        @jax.jit
        def run_chain(seed):
            def body(carry, k):
                fac = 1.0 + 0.02 * jnp.sin(seed + 1.7 * (k + 1.0))
                qp_k = qp.replace(xmin=qp.xmin.at[0].multiply(fac),
                                  xmax=qp.xmax.at[0].multiply(fac))
                out = tdunes_solve(qp_k, None, opts)
                return carry, (out.info["iter"], out.info["error"],
                               out.info["status"])
            _, ys = jax.lax.scan(body, 0.0,
                                 jnp.arange(CHAIN_R, dtype=qp.dtype))
            return ys

    out = jax.block_until_ready(run_chain(np.float64(0)))
    times = []
    for k in range(NREP):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run_chain(np.float64(k + 1)))
        times.append(time.perf_counter() - t0)
    iters, errs, stats = (np.asarray(v) for v in out)
    assert np.all(stats == 0), stats
    assert np.all(errs < TOL), errs.max()
    t = min(times)
    tot = int(iters.sum())
    Nn = qp.topo.Nn
    print(json.dumps({
        "mode": mode, "nodes": Nn, "device": dev.device_kind,
        "chained_solves": CHAIN_R, "total_iters": tot,
        "iters_per_solve_mean": round(float(iters.mean()), 2),
        "ms_per_iter": round(1e3 * t / tot, 4),
        "ns_per_node_iter": round(1e9 * t / tot / Nn, 1),
        "iters_per_sec": round(tot / t, 1),
        "max_error": float(errs.max()),
    }))


def main():
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    require_gpu()
    print(f"card (name, power limit): {card_info()}", file=sys.stderr)
    mode = os.environ.get("TREEQP_GENERIC_MODE")
    for m in ((mode,) if mode else MODES):
        mode_main(m)


if __name__ == "__main__":
    main()
