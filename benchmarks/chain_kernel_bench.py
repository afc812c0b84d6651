"""Triton chain sweeps against the XLA scans, on the GPU.

Two parts, both on the quadcopter trees at their real widths (nx = 6):

* parity and sweep time: the factor + backward + forward sweeps of the
  multistage solver on the chain blocks of the first Newton iteration,
  S=256/L=16 (md=4, Nr=4, Nh=20) and S=1024/L=15 (md=4, Nr=5, Nh=20), in
  f64 and f32, Triton kernels vs XLA scans, for each ``reg_type``. The
  regularized cases get singular lanes, so that the regularization runs:
  zero pivots for "always"; for "on_the_fly", pivots of 0, -1e-5 and -1e-2
  that the cascade repairs at its first, second and third shift;
* end to end: one cold 256-scenario solve with bench.py's options, with
  the kernels (the solver's choice on a GPU) and with the scans.

Run ``python -m benchmarks.chain_kernel_bench`` on a GPU machine; its
last stdout line is one JSON object. Without a GPU it fails. Times are
medians over alternating runs (scan, kernel, kernel, scan, ...) in one
process.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# max error relative to the largest reference entry (see
# tests/test_chain_kernels.py for the reasons)
TOL = {"float64": 1e-10, "float32": 1e-4}
SHAPES = {"S256_L16": dict(md=4, Nr=4, Nh=20),
          "S1024_L15": dict(md=4, Nr=5, Nh=20)}
REGS = ("none", "always", "on_the_fly")
REG_VALUE = REG_TOL = 1e-6
# chain step whose last state is made singular in every third scenario,
# and the pivots given to the three lane groups of the on-the-fly case
SING_STEP = 5
SING_PIVOTS = {"always": (0.0,), "on_the_fly": (0.0, -1e-5, -1e-2)}


def chain_inputs(ms, dtype, reg="none"):
    """Equilibrated chain blocks (Wc, Utc) of the first Newton iteration
    (zero duals) of ``ms``, with a seeded random residual and root
    direction (at zero duals the true ones vanish on these trees). For a
    regularized ``reg`` the last state of every third scenario at chain
    step SING_STEP is decoupled and given the pivots SING_PIVOTS[reg], in
    turn (a fully clipped coordinate makes such a zero pivot)."""
    from treeqp_tpu.solvers import tdunes as td
    from treeqp_tpu.solvers import tdunes_multistage as tm

    opts = td.TdunesOpts(stage_solver="clipping")
    prep = td._get_prep(ms.meta.crown_topo)
    lam_cr = jnp.zeros((ms.meta.crown_topo.Nn, ms.meta.crown_topo.nxm),
                       ms.q.dtype)
    lam_ch = jnp.zeros_like(ms.q)
    cr, ch = tm._ms_stage_solve(ms, td._stage_data(ms.crown, opts), lam_cr,
                                lam_ch, opts, prep)
    Wc, Utc = tm._chain_blocks(ms, ch, cr["qtilde"], cr["rtilde"])
    s_root = jnp.ones(Wc.shape[:1] + Wc.shape[-1:], Wc.dtype)
    Wc, Utc, _ = tm._equilibrate_chain(Wc, Utc, s_root)
    if reg in SING_PIVOTS:
        pivots = SING_PIVOTS[reg]
        lanes = np.arange(0, Wc.shape[0], 3)
        piv = np.asarray(pivots)[np.arange(lanes.size) % len(pivots)]
        j = SING_STEP
        Wc = Wc.at[lanes, j, -1, :].set(0.0).at[lanes, j, :, -1].set(0.0)
        Wc = Wc.at[lanes, j, -1, -1].set(piv)
        Utc = Utc.at[lanes, j, :, -1].set(0.0).at[lanes, j + 1, -1, :].set(0.0)
    rng = np.random.default_rng(0)
    res = jnp.asarray(rng.standard_normal(Wc.shape[:3]))
    droot = jnp.asarray(rng.standard_normal(Wc.shape[:1] + Wc.shape[3:]))
    return tuple(v.astype(dtype) for v in (Wc, Utc, res, droot))


def sweeps(triton, reg="on_the_fly"):
    """jit(W, Ut, res, droot) -> (Ls, CUs, schur0, ys, radd0, dls) in the
    [S, L, ...] layout, through the solver's sweep functions."""
    from treeqp_tpu.solvers import tdunes_multistage as tm
    from treeqp_tpu.solvers.tdunes import TdunesOpts

    opts = TdunesOpts(reg_type=reg, reg_value=REG_VALUE, reg_tol=REG_TOL)

    @jax.jit
    def run(W, Ut, res, droot):
        Ls, CUs, schur0 = tm._chain_factor(W, Ut, opts, triton)
        ys, radd0 = tm._chain_solve_bwd(Ls, CUs, res, triton)
        dls = tm._chain_forward(Ls, CUs, ys, droot, triton)
        if triton:  # kernel layout -> [S, L, ...]
            S = W.shape[0]
            nodes = lambda v: jnp.moveaxis(v[..., :S], -1, 0)
            Ls, CUs, ys = nodes(Ls), nodes(CUs), nodes(ys)
        return Ls, CUs, schur0, ys, radd0, dls

    return run


def shift_levels(W, Ls, CUs):
    """Lane-steps by the LM shift their factor carries, as multiples of
    REG_VALUE: {"0": n, "1": n, "1e3": n, "1e6": n}. The shift is read off
    diag(L L' - M) with M = W_j - CU_{j+1} CU_{j+1}' (f64 only: f32
    rounding is of the order of the smallest shift)."""
    W, Ls, CUs = (np.asarray(v, np.float64) for v in (W, Ls, CUs))
    schur = np.einsum("slik,sljk->slij", CUs, CUs)
    schur = np.concatenate([schur[:, 1:], np.zeros_like(schur[:, :1])], 1)
    LLt = np.einsum("slik,sljk->slij", Ls, Ls)
    shift = np.mean(np.diagonal(LLt - (W - schur), axis1=2, axis2=3), -1)
    level = np.where(shift < 0.5 * REG_VALUE, -1,
                     np.rint(np.log10(np.maximum(shift, REG_VALUE)
                                      / REG_VALUE) / 3))
    return {name: int(np.sum(level == k))
            for k, name in ((-1, "0"), (0, "1"), (1, "1e3"), (2, "1e6"))}


def compare(inputs, reg="on_the_fly"):
    """Max relative error of every kernel output against the XLA scans,
    whether each is within its tolerance, and (f64) the lane-steps at each
    shift level, which must be the same in both."""
    dt = str(inputs[0].dtype)
    ref = sweeps(False, reg)(*inputs)
    got = sweeps(True, reg)(*inputs)
    names = ("Ls", "CUs", "schur0", "ys", "radd0", "dls")
    errs = {}
    for name, r, g in zip(names, ref, got):
        r, g = np.asarray(r, np.float64), np.asarray(g, np.float64)
        assert r.shape == g.shape, (name, r.shape, g.shape)
        errs[name] = float(np.max(np.abs(g - r)) / max(np.max(np.abs(r)),
                                                        1e-300))
    worst = max(errs.values())
    ok = bool(np.isfinite(worst) and worst <= TOL[dt])
    out = {"dtype": dt, "reg_type": reg, "max_rel_err": worst,
           "tol": TOL[dt], "per_output": errs}
    if dt == "float64":
        out["shift_levels"] = shift_levels(inputs[0], ref[0], ref[1])
        out["shift_levels_kernel"] = shift_levels(inputs[0], got[0], got[1])
        ok = ok and out["shift_levels"] == out["shift_levels_kernel"]
    out["ok"] = ok
    return out


@contextlib.contextmanager
def scan_sweeps():
    """Trace solves with the XLA scans in place of the solver's choice."""
    from treeqp_tpu.solvers import tdunes_multistage as tm

    choose = tm._triton_sweeps
    tm._triton_sweeps = lambda meta, shard=None: False
    try:
        yield
    finally:
        tm._triton_sweeps = choose


def _median_times(fns, args, reps):
    """Alternate the functions (a, b, b, a, ...) and return the median
    seconds of each."""
    times = {k: [] for k in fns}
    order = list(fns)
    for i in range(reps):
        seq = order if i % 2 == 0 else order[::-1]
        for k in seq:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[k](*args))
            times[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in times.items()}, times


def main():
    from bench import bench_opts, build_problem
    from benchmarks.models import quadcopter
    from treeqp_tpu.core.kkt import max_kkt_residual
    from treeqp_tpu.solvers.tdunes_multistage import (
        merge_output, split_multistage, tdunes_ms_solve)
    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache(ROOT)
    dev = require_gpu()
    card = card_info()
    print(f"card (name, power limit): {card}", flush=True)
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "card": card,
           "sweeps": {}, "end_to_end": {}}

    for tag, shape in SHAPES.items():
        ms = jax.device_put(split_multistage(quadcopter(**shape).qp), dev)
        for dtype in (jnp.float64, jnp.float32):
            inputs = chain_inputs(ms, dtype)
            row = compare(inputs)
            fns = {"xla": sweeps(False), "triton": sweeps(True)}
            med, _ = _median_times(fns, inputs, reps=20)
            row["sweep_median_s"] = med
            out["sweeps"][f"{tag}_{row['dtype']}"] = row
            print(tag, json.dumps(row), flush=True)

    qp, ms = build_problem()
    qp, ms = jax.device_put((qp, ms), dev)
    opts = bench_opts()
    fns, e2e = {}, {}
    for path in ("xla", "triton"):
        # the sweep path is fixed when the solve is traced: compile each
        # ahead of time, and drop the traces between the two
        jax.clear_caches()
        t0 = time.perf_counter()
        with scan_sweeps() if path == "xla" else contextlib.nullcontext():
            solve = jax.jit(lambda m: tdunes_ms_solve(m, None, None, opts)
                            ).lower(ms).compile()
        cro, cho, info = jax.block_until_ready(solve(ms))
        first = time.perf_counter() - t0
        kkt = float(max_kkt_residual(qp, merge_output(ms, cro, cho, info)))
        e2e[path] = {"first_call_s": first, "iters": int(info["iter"]),
                     "status": int(info["status"]), "kkt": kkt}
        fns[path] = solve
    med, raw = _median_times(fns, (ms,), reps=10)
    for path in fns:
        e2e[path]["cold_solve_median_s"] = med[path]
        e2e[path]["cold_solve_times_s"] = raw[path]
    out["end_to_end"] = e2e
    out["ok"] = (all(r["ok"] for r in out["sweeps"].values())
                 and all(r["status"] == 0 and r["kkt"] <= 1e-8
                         for r in e2e.values()))
    print(json.dumps(out))
    if not out["ok"]:
        raise SystemExit("chain kernel check failed")


if __name__ == "__main__":
    main()
