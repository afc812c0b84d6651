"""GPU bench line for the tree IPM (HPIPM capability class).

Measures interior-point solves/s on the 256-scenario spring-mass tree
(4437 nodes) for the f64 path and the mixed-precision path
(IpmOpts.factor_dtype="float32" two-phase schedule, optional refinement).

Protocol follows bench.py: solves are chained inside ONE jit (per-rep
inputs varied via a scalar seed argument), min wall time over NREP. Run on
a GPU machine (it fails without one):

    python -m benchmarks.ipm_bench                        # all modes
    TREEQP_IPM_MODE=ms_f32 python -m benchmarks.ipm_bench # one mode
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MD, NR, NH, NM = 4, 4, 20, 4
CHAIN_R = int(os.environ.get("TREEQP_IPM_CHAIN", "3"))
NREP = int(os.environ.get("TREEQP_IPM_NREP", "3"))

MODES = {
    "f64": dict(),
    # crown+chains layout (solvers/ipm_multistage.py)
    "ms_f64": dict(_ms=True),
    "ms_f32": dict(_ms=True, factor_dtype="float32"),
    # f32 factors throughout + exact-KKT refinement
    "ms_f32r": dict(_ms=True, factor_dtype="float32", f32_until=1e-8,
                    refine_steps=1),
    # general C/D rows (VERDICT r2 #3): dense barrier blocks -> dense
    # batched chain Riccati; measured against the box (clipping-class)
    # path's per-iteration time
    "ms_general_f64": dict(_ms=True, _general=True),
    "ms_general_f32r": dict(_ms=True, _general=True,
                            factor_dtype="float32", refine_steps=1),
}


def run_mode(mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from treeqp_tpu.solvers.ipm import IpmOpts, ipm_solve

    cfg = dict(MODES[mode])
    use_ms = cfg.pop("_ms", False)
    use_general = cfg.pop("_general", False)

    from benchmarks.models import spring_mass_chain, with_general_rows
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    qp, _ = spring_mass_chain(nm=NM, md=MD, Nr=NR, Nh=NH)
    if use_general:
        qp = with_general_rows(qp, cmax=0.3)
    if use_ms:
        ms = split_multistage(qp)
    dev = jax.devices()[0]
    qp = jax.device_put(qp, dev)
    opts = IpmOpts(tol=1e-8, max_iter=40, **cfg)
    if use_ms:
        from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
        ms = jax.device_put(ms, dev)

        @jax.jit
        def run_chain(seed):
            def body(carry, k):
                eps = 1e-9 * (k + 1) + seed * 1e-12
                ms2 = dataclasses.replace(
                    ms, b=ms.b + eps,
                    crown=dataclasses.replace(ms.crown, b=ms.crown.b + eps))
                _, _, info = ipm_ms_solve(ms2, opts)
                return carry + info["iter"], (info["res4"], info["status"])
            tot, (res4, status) = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), jnp.arange(CHAIN_R))
            return tot, res4, status
    else:
        @jax.jit
        def run_chain(seed):
            def body(carry, k):
                eps = 1e-9 * (k + 1) + seed * 1e-12
                qp2 = dataclasses.replace(qp, b=qp.b + eps)
                out = ipm_solve(qp2, opts)
                return carry + out.info["iter"], (out.info["res4"],
                                                  out.info["status"])
            tot, (res4, status) = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), jnp.arange(CHAIN_R))
            return tot, res4, status

    tot, res4, status = jax.block_until_ready(run_chain(np.float64(0)))
    times = []
    for k in range(NREP):
        t0 = time.perf_counter()
        tot, res4, status = jax.block_until_ready(run_chain(np.float64(k + 1)))
        times.append(time.perf_counter() - t0)
    t = min(times) / CHAIN_R
    print(json.dumps({
        "mode": mode, "device": dev.device_kind,
        "solve_ms": round(t * 1e3, 2),
        "ipm_iters_per_solve": int(tot) / CHAIN_R,
        "iters_per_sec": round(int(tot) / (min(times)), 1),
        "max_res4": float(jnp.max(res4)),
        "statuses": [int(s) for s in np.asarray(status).ravel()],
    }), flush=True)


def main():
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    require_gpu()
    print(f"card (name, power limit): {card_info()}", file=sys.stderr)
    mode = os.environ.get("TREEQP_IPM_MODE")
    for m in ((mode,) if mode else MODES):
        run_mode(m)


if __name__ == "__main__":
    main()
