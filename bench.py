"""Headline benchmark: dual-Newton solves of the 256-scenario quadcopter
tree QP on one GPU, each solved to 1e-8 and certified by the KKT oracle.

Run ``python bench.py`` on a machine with a GPU; without one it fails (no
CPU fallback). It prints the card's name and power limit on stderr and ONE
JSON line on stdout.

Protocol: the reference's min wall time over NREP repeats
(Makefile.rule:78-79 / treeqp_main.m:29). Each timed call runs CHAIN_R
solves inside one jit, each on a DIFFERENT instance: the pinned initial
state x0 is scaled by a factor derived from the solve index and a per-rep
seed (the closed-loop MPC variation, treeqp_main.m:266-268), so no
factorization or solve is loop-invariant and XLA cannot hoist any
per-solve work. Two modes of the same compiled executable (scalar `warm`
argument):

* cold (headline): every solve starts from the exact-zero dual point —
  the start of the certified solve;
* warm: each solve starts from the previous solve's final multipliers —
  the MPC deployment pattern (treeqp_solve.m:6-8).

Every chained solve must report status OPTIMAL with stationarity error
< tol; the KKT oracle certifies the base instance and one perturbed
instance before timing.

``vs_baseline`` compares against a measured single-core treeQP+BLASFEO
iteration rate on the same tree (the reference repo publishes no numbers
and its BLAS submodules are not vendored here): a plain-C replica of the
reference per-iteration kernel sequence (benchmarks/c_baseline/) times a
BLASFEO-headroom factor.
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Measured single-core treeQP+BLASFEO dual-Newton iteration rates on the
# 256-scenario trees, by the plain-C kernel-sequence replica
# (benchmarks/c_baseline/, best of 6 runs, on a CPU core) times a
# reference-favorable 2.1x BLASFEO-headroom factor.
#   quadcopter (nx=6, nu=4): 264.1 it/s replica (make run_quad) -> 554.6
#   spring-mass proxy (nx=8, nu=1): 189.2 it/s replica -> 400.0
_BASELINES = {"quadcopter": 554.6, "spring_mass": 400.0}

# workload: the quadcopter (nx=6, nu=4 — BASELINE.md north star); the
# spring-mass proxy stays selectable (TREEQP_BENCH_WORKLOAD=spring_mass)
WORKLOAD = os.environ.get("TREEQP_BENCH_WORKLOAD", "quadcopter")
BASELINE_ITERS_PER_SEC = _BASELINES[WORKLOAD]

# 256-scenario robust-MPC tree (BASELINE.md north star)
MD, NR, NH, NM = 4, 4, 20, 4  # md^Nr = 256 scenarios, Nh = 20
NREP = 5
# solves chained inside one jit per timed call
CHAIN_R = int(os.environ.get("TREEQP_BENCH_CHAIN", "192"))
TOL = 1e-8
# per-solve multiplicative perturbation amplitude of the pinned x0
PERT = 0.02


def build_problem():
    """(qp, ms): the full-tree QP and its crown+chains split."""
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    if WORKLOAD == "quadcopter":
        from benchmarks.models import quadcopter
        qp = quadcopter(md=MD, Nr=NR, Nh=NH).qp
    else:
        from benchmarks.models import spring_mass_chain
        qp, _ = spring_mass_chain(nm=NM, md=MD, Nr=NR, Nh=NH)
    return qp, split_multistage(qp)


def perturb_factor(k, seed):
    """Per-solve data scale: 1 + PERT*sin(seed + 1.7(k+1)). Depends on the
    chain index AND the per-rep seed, so no chained instance repeats."""
    import jax.numpy as jnp

    return 1.0 + PERT * jnp.sin(seed + 1.7 * (k + 1.0))


def perturb_ms(ms, fac):
    """Scale the pinned root state x0 (root bound rows) by `fac` — the
    closed-loop MPC variation: every chained solve sees a different
    initial condition (treeqp_main.m:266-268 embeds the new x0 as
    equality bounds each step)."""
    cr = ms.crown
    cr2 = cr.replace(xmin=cr.xmin.at[0].multiply(fac),
                     xmax=cr.xmax.at[0].multiply(fac))
    return dataclasses.replace(ms, crown=cr2)


def perturb_qp(qp, fac):
    """The identical perturbation on the full-tree QP (oracle side)."""
    return qp.replace(xmin=qp.xmin.at[0].multiply(fac),
                      xmax=qp.xmax.at[0].multiply(fac))


def bench_opts():
    """The option set: native f64 throughout (factorization included) and
    the reference's on-the-fly Levenberg-Marquardt regularization. On a
    GPU the solver runs its chain sweeps as the Triton kernels
    (ops/chain_kernels.py; benchmarks/chain_kernel_bench.py compares them
    with the XLA scans)."""
    from treeqp_tpu.solvers.tdunes import TdunesOpts

    return TdunesOpts(stage_solver="clipping", tol=TOL, max_iter=120,
                      reg_type="on_the_fly", reg_value=1e-6)


def certify(qp, ms, opts, seed=1.0):
    """Cold solve + KKT oracle on the base instance AND on one perturbed
    instance (chain index 0), as one jit program. Returns a dict."""
    import jax
    import numpy as np

    from treeqp_tpu.core.kkt import max_kkt_residual
    from treeqp_tpu.solvers.tdunes_multistage import (
        merge_output, tdunes_ms_solve)

    @jax.jit
    def check(ms, qp, seed):
        cro, cho, info = tdunes_ms_solve(ms, None, None, opts)
        kkt0 = max_kkt_residual(qp, merge_output(ms, cro, cho, info))
        fac = perturb_factor(0.0, seed)
        ms_p, qp_p = perturb_ms(ms, fac), perturb_qp(qp, fac)
        cro_p, cho_p, info_p = tdunes_ms_solve(ms_p, None, None, opts)
        kkt_p = max_kkt_residual(qp_p, merge_output(ms_p, cro_p, cho_p,
                                                    info_p))
        return (kkt0, info["iter"], info["status"],
                kkt_p, info_p["iter"], info_p["status"])

    vals = jax.block_until_ready(check(ms, qp, np.float64(seed)))
    kkt, it, st, kkt_p, it_p, st_p = (v.item() for v in vals)
    return {"kkt": kkt, "newton_iters": it, "status": st,
            "kkt_perturbed": kkt_p, "newton_iters_perturbed": it_p,
            "status_perturbed": st_p}


def make_run_chain(ms, opts, chain_r):
    """jit(warm, seed) -> per-solve (iters, errors, statuses) of chain_r
    solves of per-solve-perturbed instances. warm = 0.0: every solve from
    the exact-zero dual start (cold); warm = 1.0: each solve warm-started
    from the previous solve's final multipliers (MPC pattern)."""
    import jax
    import jax.numpy as jnp

    from treeqp_tpu.solvers.tdunes_multistage import tdunes_ms_solve

    meta = ms.meta
    lam0c = jnp.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), ms.q.dtype)
    lam0h = jnp.zeros_like(ms.q)

    @jax.jit
    def run_chain(warm, seed):
        def body(carry, k):
            lc_prev, lh_prev = carry
            ms_k = perturb_ms(ms, perturb_factor(k, seed))
            cro, cho, inf = tdunes_ms_solve(ms_k, lc_prev * warm,
                                            lh_prev * warm, opts)
            return (cro["lam"], cho["lam"]), \
                (inf["iter"], inf["error"], inf["status"])
        _, (iters, errs, stats) = jax.lax.scan(
            body, (lam0c, lam0h), jnp.arange(chain_r, dtype=ms.q.dtype))
        return iters, errs, stats

    return run_chain


def main():
    import jax
    import numpy as np

    from treeqp_tpu.solvers.tdunes_multistage import _triton_sweeps
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(ROOT)
    dev = require_gpu()
    card = card_info()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"card (name, power limit): {card}", file=sys.stderr)

    qp, ms = build_problem()
    qp, ms = jax.device_put((qp, ms), dev)
    opts = bench_opts()
    t0 = time.perf_counter()
    check = certify(qp, ms, opts)
    certify_s = time.perf_counter() - t0
    assert check["status"] == 0 and check["kkt"] < TOL, check
    assert check["status_perturbed"] == 0 and check["kkt_perturbed"] < TOL, \
        check

    run_chain = make_run_chain(ms, opts, CHAIN_R)

    def timed_mode(warm):
        t0 = time.perf_counter()
        jax.block_until_ready(run_chain(np.float64(warm), np.float64(0)))
        compile_s = time.perf_counter() - t0
        times = []
        for k in range(1, NREP + 1):
            t0 = time.perf_counter()
            out = jax.block_until_ready(
                run_chain(np.float64(warm), np.float64(k)))
            times.append(time.perf_counter() - t0)
        iters, errs, stats = (np.asarray(v) for v in out)
        # certify the TIMED computation, not just an out-of-chain proxy
        assert np.all(stats == 0), f"non-optimal chained solves: {stats}"
        assert np.all(errs < TOL), f"chained solve above tol: {errs.max()}"
        t = min(times)
        return dict(time_s=t, times_s=times, first_call_s=compile_s,
                    iters=iters, errs=errs,
                    solves_per_sec=CHAIN_R / t,
                    iters_per_sec=float(iters.sum()) / t)

    cold = timed_mode(0.0)
    warm = timed_mode(1.0)

    def summary(m):
        return {
            "iters_per_sec": m["iters_per_sec"],
            "solves_per_sec": m["solves_per_sec"],
            "solve_time_s": m["time_s"] / CHAIN_R,
            "chain_times_s": m["times_s"],
            "first_call_s": m["first_call_s"],
            "iters_per_solve_min": int(m["iters"].min()),
            "iters_per_solve_max": int(m["iters"].max()),
            "iters_per_solve_mean": float(m["iters"].mean()),
            "max_error": float(m["errs"].max()),
        }

    iters_per_sec = cold["iters_per_sec"]
    result = {
        "metric": f"tdunes_iters_per_sec_{WORKLOAD}_256scen",
        "value": iters_per_sec,
        "unit": "iter/s",
        "vs_baseline": iters_per_sec / BASELINE_ITERS_PER_SEC,
        "detail": {
            "workload": WORKLOAD,
            "baseline_iters_per_sec": BASELINE_ITERS_PER_SEC,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "scenarios": MD**NR,
            "nodes": qp.topo.Nn,
            "nx": int(qp.topo.nx[0]),
            "nu": int(qp.topo.nu[0]),
            "horizon": NH,
            "chain_sweeps": "triton" if _triton_sweeps(ms.meta) else "scan",
            "certify_s_incl_compile": certify_s,
            "certified": check,
            "chained_solves": CHAIN_R,
            "nrep": NREP,
            "tol": TOL,
            "cold": summary(cold),
            "warm": summary(warm),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
