"""sdunes benchmark on the GPU.

Measures sdunes on the 256-scenario quadcopter-class workload (the
headline tree) against the multistage dual Newton (tdunes_ms) on the same
instance. Three measurements:

* ``sdunes_boot`` — convergence: a chain of per-solve-perturbed instances,
  each bootstrapped in-jit by a coarse ipm_ms solve mapped to scenario
  duals (scenario_duals_from_tree) — the in-jit form of the
  reference's warm-start-file usage (spring_mass.c:69-83; sdunes
  cold-starts hit the known piecewise-singular plateau on ~15% of
  perturbed instances, reference and ours alike). Asserts every solve
  OPTIMAL at 1e-8 and certifies the base instance with the KKT oracle.
* ``sdunes_f32`` / ``tdunes_ms_f32`` — coarse-phase per-iteration cost:
  both solvers run their all-f32 loop (data cast to f32) to a 1e-3
  stationarity tolerance on cold chains; ms/iter = ms_per_solve /
  iters_per_solve. Identical definition for both solvers. (A tol=0
  fixed-iteration slope is NOT usable here: past convergence the descent
  check degenerates and the measurement times the gradient-fallback
  line search instead of the Newton iteration.)
* ``tdunes_ms`` — the headline solver's convergent chain on the same
  instances (cold start; it needs no bootstrap).

Options come from bench.py's GPU option set (native f64). Run
``python -m benchmarks.sdunes_bench`` on a GPU machine (it fails without
one); ``TREEQP_SDUNES_MODE=<mode>`` runs one mode. Prints one JSON line
per mode.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MD, NR, NH, NM = 4, 4, 20, 4  # 256 scenarios, nx = 8 (bench.py workload)
CHAIN_R = int(os.environ.get("TREEQP_SDUNES_CHAIN", "48"))
NREP = 3
TOL = 1e-8

MODES = ("sdunes_boot", "sdunes_boot_df64", "sdunes_f32", "tdunes_ms",
         "tdunes_ms_f32")


def build():
    from benchmarks.models import spring_mass_chain
    qp, _ = spring_mass_chain(nm=NM, md=MD, Nr=NR, Nh=NH)
    return qp


def _sdunes_opts(**kw):
    from treeqp_tpu.solvers.sdunes import SdunesOpts
    base = dict(tol=TOL, max_iter=150, reg_type="always", reg_value=1e-6)
    base.update(kw)
    return SdunesOpts(**base)


def _tdunes_opts(**kw):
    import dataclasses

    from bench import bench_opts
    return dataclasses.replace(bench_opts(), **kw)


def _timed_chain(solve):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def timed(seed):
        def body(carry, k):
            fac = 1.0 + 0.02 * jnp.sin(seed + 1.7 * (k + 1.0))
            return carry, solve(fac)
        _, outs = jax.lax.scan(body, 0.0,
                               jnp.arange(CHAIN_R, dtype=jnp.float64))
        return outs

    return timed


def run_mode(mode):
    import dataclasses as dc

    import jax
    import numpy as np

    qp = build()
    dev = jax.devices()[0]
    nodes = qp.topo.Nn
    extra = {}

    if mode.startswith("sdunes"):
        from treeqp_tpu.solvers.sdunes import (
            scenario_data, sdunes_solve, scenario_duals_from_tree,
            scenario_output)
        sqp = jax.device_put(scenario_data(qp), dev)

        def perturb_sqp(fac):
            return dc.replace(sqp, xmin=sqp.xmin.at[:, 0].multiply(fac),
                              xmax=sqp.xmax.at[:, 0].multiply(fac))

        if mode.startswith("sdunes_boot"):
            import jax.numpy as jnp
            from treeqp_tpu.solvers.tdunes_multistage import (
                split_multistage, merge_output, tdunes_ms_solve)
            from treeqp_tpu.core.kkt import max_kkt_residual
            ms = jax.device_put(split_multistage(qp), dev)
            # _df64 variant: final phase in two-f32 double-float
            # arithmetic (solvers/sd_df64.py) instead of native f64
            opts = _sdunes_opts(df64_phase=mode.endswith("df64"))
            # coarse tdunes_ms bootstrap (cheaper than the IPM at loose
            # tolerance: the barrier schedule cannot shortcut, the dual
            # Newton can) mapped EXACTLY onto scenario duals
            bopts = _tdunes_opts(tol=1e-4)

            def boot_solve(fac):
                s2 = perturb_sqp(fac)
                cr2 = ms.crown
                ms2 = dc.replace(ms, crown=cr2.replace(
                    xmin=cr2.xmin.at[0].multiply(fac),
                    xmax=cr2.xmax.at[0].multiply(fac)))
                cro, cho, iinf = tdunes_ms_solve(ms2, None, None, bopts)
                boot = merge_output(ms2, cro, cho, iinf)
                lam0, mu0 = scenario_duals_from_tree(s2, None, boot)
                sol, lam, mu, info = sdunes_solve(s2, lam0, mu0, opts)
                return (info["iter"], info["error"], info["status"],
                        iinf["iter"], sol, lam, mu, s2)

            def solve(fac):
                it, err, st, bit, *_ = boot_solve(fac)
                return it, err, st, bit

            # certification: base instance through the full KKT oracle,
            # inside the same compiled program
            @jax.jit
            def timed(seed):
                def body(carry, k):
                    fac = 1.0 + 0.02 * jnp.sin(seed + 1.7 * (k + 1.0))
                    return carry, solve(fac)
                _, outs = jax.lax.scan(
                    body, 0.0, jnp.arange(CHAIN_R, dtype=jnp.float64))
                it, err, st, bit, sol, lam, mu, s2 = boot_solve(
                    jnp.float64(1.0))
                out = scenario_output(s2, sol, lam, mu,
                                      dict(iter=it, status=st, error=err))
                kkt = max_kkt_residual(qp, out)
                return outs, (kkt, st)

            out0, (kkt, st) = jax.block_until_ready(timed(np.float64(0)))
            assert int(st) == 0 and float(kkt) < TOL, (float(kkt), int(st))
            extra["certified_kkt"] = float(kkt)

            def run(seed):
                outs, _ = timed(seed)
                return outs
            timed_fn = run
        else:  # coarse-phase per-iteration cost: all-f32 loop to 1e-3
            import jax.numpy as jnp
            sqp32 = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float32)
                if hasattr(x, "dtype") and jnp.issubdtype(x.dtype,
                                                          jnp.floating)
                else x, sqp)
            opts = _sdunes_opts(tol=1e-3, max_iter=80)

            def solve(fac):
                s2 = dc.replace(sqp32,
                                xmin=sqp32.xmin.at[:, 0].multiply(fac),
                                xmax=sqp32.xmax.at[:, 0].multiply(fac))
                sol, lam, mu, info = sdunes_solve(s2, None, None, opts)
                return (info["iter"], info["error"], info["status"],
                        info["iter"] * 0)

            timed_fn = _timed_chain(solve)
    else:
        from treeqp_tpu.solvers.tdunes_multistage import (
            split_multistage, tdunes_ms_solve)
        ms = jax.device_put(split_multistage(qp), dev)
        if mode == "tdunes_ms":
            opts = _tdunes_opts()
            ms_used = ms
        else:
            import jax.numpy as jnp
            ms_used = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float32)
                if hasattr(x, "dtype") and jnp.issubdtype(x.dtype,
                                                          jnp.floating)
                else x, ms)
            opts = _tdunes_opts(tol=1e-3, max_iter=80)

        def solve(fac):
            cr = ms_used.crown
            ms2 = dc.replace(ms_used, crown=cr.replace(
                xmin=cr.xmin.at[0].multiply(fac),
                xmax=cr.xmax.at[0].multiply(fac)))
            cro, cho, info = tdunes_ms_solve(ms2, None, None, opts)
            return (info["iter"], info["error"], info["status"],
                    info["iter"] * 0)

        timed_fn = _timed_chain(solve)

    out = jax.block_until_ready(timed_fn(np.float64(0)))
    times = []
    for k in range(NREP):
        t0 = time.perf_counter()
        out = jax.block_until_ready(timed_fn(np.float64(k + 1)))
        times.append(time.perf_counter() - t0)
    iters, errs, stats, boot_iters = (np.asarray(v) for v in out)
    if mode in ("sdunes_boot", "tdunes_ms"):
        assert np.all(stats == 0), f"{mode}: bad statuses {stats}"
        assert np.all(errs < TOL), f"{mode}: errors above tol {errs.max()}"
    t = min(times)
    rec = {
        "mode": mode, "device": dev.device_kind, "nodes": int(nodes),
        "scenarios": MD**NR, "chained_solves": CHAIN_R,
        "total_iters": int(iters.sum()),
        "iters_per_solve_mean": round(float(iters.mean()), 2),
        "ms_per_solve": round(1e3 * t / CHAIN_R, 3),
        "iters_per_sec": round(float(iters.sum()) / t, 1),
        "max_error": float(errs.max()), **extra}
    if mode == "sdunes_boot":
        rec["boot_ipm_iters_mean"] = round(float(boot_iters.mean()), 2)
    print(json.dumps(rec), flush=True)
    return rec


def main():
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    require_gpu()
    print(f"card (name, power limit): {card_info()}", file=sys.stderr)
    mode = os.environ.get("TREEQP_SDUNES_MODE")
    rows = {m: run_mode(m) for m in ((mode,) if mode else MODES)}
    # coarse-phase per-iteration cost comparison
    a, b = rows.get("sdunes_f32"), rows.get("tdunes_ms_f32")
    if a and b:
        ca = a["ms_per_solve"] / max(a["iters_per_solve_mean"], 1e-9)
        cb = b["ms_per_solve"] / max(b["iters_per_solve_mean"], 1e-9)
        print(json.dumps({"summary": "f32_phase_ms_per_iter",
                          "sdunes": round(ca, 4), "tdunes_ms": round(cb, 4),
                          "ratio": round(ca / cb, 2)}), flush=True)


if __name__ == "__main__":
    main()
