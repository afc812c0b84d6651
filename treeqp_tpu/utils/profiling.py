"""Per-operation profiling (reference PROFILE=3, profiling.h:38-68).

The reference tic/tocs inside the solve loop (stage QPs / dual build /
Newton direction / line search, dual_Newton_tree.c:1168-1227). Under jit
the whole solve is one fused program, so per-op host timers are
meaningless; instead ``profile_tdunes_ops`` times each phase as its own
jitted program on representative iterates — the per-op split at the same
granularity, measured honestly on the target backend.

PROFILE level map:
  1 — total time: utils.timing.min_time_over
  2 — per-iteration stats: TdunesOpts(record_history=True)
  3 — per-op split: profile_tdunes_ops below
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from treeqp_tpu.solvers import tdunes as td

__all__ = ["profile_tdunes_ops", "profile_ms_phases"]


def _time(f, *a, nrep=5):
    fj = jax.jit(f)
    jax.block_until_ready(fj(*a))
    ts = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        jax.block_until_ready(fj(*a))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def profile_tdunes_ops(qp, opts=None, lam=None, nrep=5) -> dict:
    """Per-op times (seconds) for one dual-Newton iteration's phases:
    stage_qps / dual_build / newton_direction / line_search_eval.

    Mirrors treeqp_profiling_t's PROFILE=3 quantities
    (profiling.h:56-66)."""
    opts = opts or td.TdunesOpts()
    prep = td._get_prep(qp.topo)
    dt = qp.dtype
    if lam is None:
        lam = jnp.zeros((qp.topo.Nn, qp.topo.nxm), dt)
    data = td._stage_data(qp, opts)

    out = {}
    out["stage_qps"] = _time(
        lambda l: td._stage_solve(qp, l, data, opts, prep)["x"], lam, nrep=nrep)

    sol = td._stage_solve(qp, lam, data, opts, prep)

    def dual_build(l):
        s = td._stage_solve(qp, l, data, opts, prep)
        res = td._dual_residual(qp, s, prep)
        W, Ut = td._build_dual_hessian(qp, s, data, opts, prep)
        return W, res

    t_build_tot = _time(lambda l: dual_build(l)[0], lam, nrep=nrep)
    out["dual_build"] = max(t_build_tot - out["stage_qps"], 0.0)

    res = td._dual_residual(qp, sol, prep)
    W, Ut = td._build_dual_hessian(qp, sol, data, opts, prep)
    rg = td._nodes_to_group(res, prep)
    out["newton_direction"] = _time(
        lambda W, Ut, rg: td._newton_direction(W, Ut, rg, opts, prep),
        W, Ut, rg, nrep=nrep)

    dlam_g = td._newton_direction(W, Ut, rg, opts, prep)
    dlam = td._group_to_nodes(dlam_g, prep, dt)

    def ls_eval(l, d):
        lt = l + 0.5 * d
        s = td._stage_solve(qp, lt, data, opts, prep)
        return td._dual_value(qp, lt, s, data, opts)

    out["line_search_eval"] = _time(ls_eval, lam, dlam, nrep=nrep)
    out["iteration_estimate"] = (out["stage_qps"] + out["dual_build"]
                                 + out["newton_direction"]
                                 + 2 * out["line_search_eval"])
    return out


def profile_ms_phases(ms, opts=None, nrep=3) -> dict:
    """PROFILE=3 phase split for the two-phase multistage dual Newton:
    wall time of the coarse f32 phase, the high-precision (df64 or f64)
    phase, plus the per-call cost of one factorization and one
    line-search evaluation — the treeqp_profiling_t per-op quantities
    (profiling.h:56-66) at the granularity the jit model admits (each
    phase is one fused program; sub-phase ops are timed as their own
    jitted programs on representative iterates)."""
    import dataclasses

    from treeqp_tpu.solvers import tdunes_multistage as tm
    from treeqp_tpu.solvers.tdunes import TdunesOpts

    opts = opts or TdunesOpts()
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt = ms.q.dtype
    lam0_cr = jnp.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), dt)
    lam0_ch = jnp.zeros_like(ms.q)
    it0 = jnp.zeros((), jnp.int32)
    out = {}

    use_coarse = (opts.f32_phase_tol > 0 and dt == jnp.float64
                  and opts.factor_dtype == "float32")
    lamA_cr, lamA_ch = lam0_cr, lam0_ch
    if use_coarse:
        ms32 = tm._cast_ms(ms, jnp.float32)
        optsA = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol),
            ls_batch=opts.ls_batch if opts.ls_batch > 0 else 4)

        def coarse(lc, lh):
            r = tm._ms_newton_loop(ms32, lc, lh, optsA, it0, patience=3)
            return r[0], r[1], r[2]

        out["f32_phase"] = _time(coarse, lam0_cr.astype(jnp.float32),
                                 lam0_ch.astype(jnp.float32), nrep=nrep)
        lamA_cr32, lamA_ch32, itA = jax.jit(coarse)(
            lam0_cr.astype(jnp.float32), lam0_ch.astype(jnp.float32))
        out["f32_phase_iters"] = int(itA)
        lamA_cr, lamA_ch = lamA_cr32.astype(dt), lamA_ch32.astype(dt)

    if opts.df64_phase and dt == jnp.float64 and opts.factor_dtype == "float32":
        from treeqp_tpu.solvers.ms_df64 import ms_newton_loop_df

        def hi_phase(lc, lh):
            r = ms_newton_loop_df(ms, lc, lh, opts, it0)
            return r[0], r[1], r[2]

        key = "df64_phase"
    else:
        def hi_phase(lc, lh):
            r = tm._ms_newton_loop(ms, lc, lh, opts, it0)
            return r[0], r[1], r[2]

        key = "f64_phase"
    out[key] = _time(hi_phase, lamA_cr, lamA_ch, nrep=nrep)
    _, _, it_hi = jax.jit(hi_phase)(lamA_cr, lamA_ch)
    out[key + "_iters"] = int(it_hi)

    # per-op: one factorization (dual Hessian build + chain/crown
    # Cholesky) and one line-search dual-value evaluation, at the
    # warm-started iterate
    crown_data = td._stage_data(ms.crown, opts)

    def factor(lc, lh):
        cr, ch = tm._ms_stage_solve(ms, crown_data, lc, lh, opts, prep_cr)
        fdt = jnp.float32 if opts.factor_dtype == "float32" else None
        W, Ut = td._build_dual_hessian(ms.crown, cr, crown_data, opts,
                                       prep_cr, dtype=fdt)
        Wc, Utc = tm._chain_blocks(ms, ch, cr["qtilde"], cr["rtilde"],
                                   dtype=fdt)
        Ls, CUs, schur0 = tm._chain_factor(Wc, Utc, opts,
                                           tm._triton_sweeps(ms.meta))
        return Ls, schur0, W

    out["factorization"] = _time(factor, lamA_cr, lamA_ch, nrep=nrep)

    def ls_eval(lc, lh):
        cr, ch = tm._ms_stage_solve(ms, crown_data, lc, lh, opts, prep_cr)
        return tm._ms_dual_value(ms, crown_data, lc, lh, cr, ch, opts)

    out["line_search_eval"] = _time(ls_eval, lamA_cr, lamA_ch, nrep=nrep)
    return out
