"""Smoke check of the tree-QP solvers on the GPU.

    python chip_smoke.py           # one card: phases a-d
    python chip_smoke.py --four    # four cards: the sharded path only

Run from the repository root. Phases, all in this one process (a second
JAX process could not reserve the card):

a. device: the first JAX device must be a GPU (no CPU fallback); prints
   its kind, the device count and ``nvidia-smi``'s name and power limit;
b. main path: the 256-scenario quadcopter tree (bench.build_problem,
   4437 nodes) solved cold by tdunes_ms_solve with bench.py's options,
   five times, bitwise equal each time; the KKT oracle certifies the base
   and one perturbed instance (<= 1e-8, OPTIMAL), then a warm chain of 8
   perturbed solves must be all OPTIMAL;
c. serve path: three JSON requests of that tree through
   ``interfaces.cli.serve`` (stdin/stdout swapped in this process), each
   with a new x0, the second and third warm-started from the previous
   response; each OPTIMAL with KKT <= 1e-8;
d. kernels: each hand-written kernel compiled at the real widths and
   compared once with its plain reference (max error beside tolerance),
   for each regularization, with singular lanes that the regularization
   repairs (the lane-steps at each shift level are printed).

``--four`` runs the six scenario-sharded legs of
``__graft_entry__.sharded_legs`` over four cards on the same tree and
compares each with the one-card solve (solution max-diff and KKT).

A failed phase raises, so the exit code is non-zero and no result line is
printed. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

KKT_TOL = 1e-8
WARM_CHAIN = 8
# solution max-diff of a sharded leg against the one-card solve: the same
# algorithm with other reduction orders, converged to KKT <= 1e-8
LEG_DIFF_TOL = 1e-6


def log(msg):
    print(msg, flush=True)


def phase_device(n_cards):
    import jax

    from treeqp_tpu.utils.platform import (
        card_info, enable_compile_cache, require_gpu)

    cache = enable_compile_cache(ROOT)
    dev = require_gpu()
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX found {len(devs)}")
    log(f"[a] device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)} compile_cache={cache}")
    log(card_info())
    return dev


def _check(cond, what):
    if not cond:
        raise SystemExit(f"check failed: {what}")


def phase_main(dev):
    import jax
    import numpy as np

    import bench
    from treeqp_tpu.solvers.tdunes_multistage import (
        _triton_sweeps, tdunes_ms_solve)

    t0 = time.perf_counter()
    qp, ms = bench.build_problem()
    qp, ms = jax.device_put((qp, ms), dev)
    log(f"[b] tree: {qp.topo.Nn} nodes, {ms.meta.S} scenarios, "
        f"nx={ms.meta.nx} nu={ms.meta.nu}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    opts = bench.bench_opts()

    t0 = time.perf_counter()
    solve = tdunes_ms_solve.lower(ms, None, None, opts).compile()
    log(f"[b] solve step compiled in {time.perf_counter() - t0:.1f}s; "
        f"memory_analysis: {solve.memory_analysis()}")
    times, outs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(solve(ms, None, None))
        times.append(time.perf_counter() - t0)
        outs.append([np.asarray(v) for v in jax.tree.leaves(out)])
    info = out[2]
    # the sharded path relies on this: every device computes the crown and
    # branches on it, so its copies must agree bitwise
    same = all(all(np.array_equal(a, b)
                   for a, b in zip(outs[0], o)) for o in outs[1:])
    log(f"[b] cold solve: iter={int(info['iter'])} "
        f"status={int(info['status'])} chain_sweeps="
        f"{'triton' if _triton_sweeps(ms.meta) else 'scan'} "
        f"bitwise_repeatable={same} times_s={times}")
    _check(same, "five cold solves are not bitwise equal")

    t0 = time.perf_counter()
    check = bench.certify(qp, ms, opts)
    log(f"[b] certified in {time.perf_counter() - t0:.1f}s (incl. compile):"
        f" {json.dumps(check)}")
    _check(check["status"] == 0 and check["kkt"] <= KKT_TOL,
           f"base instance {check}")
    _check(check["status_perturbed"] == 0
           and check["kkt_perturbed"] <= KKT_TOL,
           f"perturbed instance {check}")

    run_chain = bench.make_run_chain(ms, opts, WARM_CHAIN)
    t0 = time.perf_counter()
    jax.block_until_ready(run_chain(np.float64(1.0), np.float64(0.0)))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    iters, errs, stats = (np.asarray(v) for v in jax.block_until_ready(
        run_chain(np.float64(1.0), np.float64(1.0))))
    log(f"[b] warm chain of {WARM_CHAIN}: first call {first:.1f}s, "
        f"timed {time.perf_counter() - t0:.4f}s, iters={iters.tolist()} "
        f"max_err={errs.max():.2e}")
    _check(np.all(stats == 0) and np.all(errs < bench.TOL),
           f"warm chain statuses {stats.tolist()} errors {errs.tolist()}")
    return qp


class _Pipe:
    """stdin/stdout stand-in for cli.serve: yields request lines built
    from the previous response, and collects the responses."""

    def __init__(self, make_request, n):
        self.make_request, self.n = make_request, n
        self.lines = []

    def __iter__(self):
        for i in range(self.n):
            prev = json.loads(self.lines[-1]) if i else None
            yield json.dumps(self.make_request(i, prev)) + "\n"
        yield json.dumps({"cmd": "quit"}) + "\n"

    def write(self, s):
        self.lines.extend(s.splitlines())

    def flush(self):
        pass


def phase_serve(qp):
    import numpy as np

    from treeqp_tpu.core.json_io import tree_qp_to_json
    from treeqp_tpu.interfaces import cli

    nx0 = int(qp.topo.nx[0])
    x0 = np.asarray(qp.xmin[0])[:nx0]
    qp_json = tree_qp_to_json(qp, options=dict(
        solver="tdunes", clipping=True, maxit=120,
        stationarityTolerance=1e-8))
    scales = (1.0, 1.02, 0.97)

    def make_request(i, prev):
        init = {"x0": (x0 * scales[i]).tolist()}
        if prev is not None:
            init["lam0_tree"] = prev["init"]["lam0_tree"]
        return {"qp": qp_json, "init": init}

    pipe = _Pipe(make_request, len(scales))
    stdin, stdout = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = pipe, pipe
    t0 = time.perf_counter()
    try:
        rc = cli.serve([])
    finally:
        sys.stdin, sys.stdout = stdin, stdout
    _check(rc == 0, f"serve returned {rc}")
    _check(json.loads(pipe.lines[0]) == {"ready": True}, "serve handshake")
    resps = [json.loads(line) for line in pipe.lines[1:]]
    _check(len(resps) == len(scales), f"{len(resps)} responses")
    for i, r in enumerate(resps):
        _check("error" not in r, f"request {i}: {r.get('error')}")
        info = r["info"]
        log(f"[c] request {i} ({'warm' if i else 'cold'}): "
            f"solver={info['solver']} iter={info['num_iter']} "
            f"status={info['status']} kkt={info['kkt_tol']:.2e} "
            f"solver_time={info['solver_time']:.4f}s "
            f"interface_time={info['interface_time']:.2f}s")
        _check(info["status"] == 0 and info["kkt_tol"] <= KKT_TOL,
               f"request {i}: {info}")
    log(f"[c] serve: {time.perf_counter() - t0:.1f}s for "
        f"{len(scales)} requests (incl. compile)")


def phase_kernels(dev):
    import jax
    import jax.numpy as jnp

    from benchmarks.chain_kernel_bench import (
        REGS, SHAPES, chain_inputs, compare)
    from benchmarks.models import quadcopter
    from treeqp_tpu.solvers.tdunes_multistage import split_multistage

    t0 = time.perf_counter()
    for tag, shape in SHAPES.items():
        ms = jax.device_put(split_multistage(quadcopter(**shape).qp), dev)
        for reg in REGS:
            for dtype in (jnp.float64, jnp.float32):
                r = compare(chain_inputs(ms, dtype, reg), reg)
                levels = (f" shift_levels={r['shift_levels']}"
                          if "shift_levels" in r else "")
                log(f"[d] chain sweeps {tag} {r['dtype']} {reg}: max_rel_err="
                    f"{r['max_rel_err']:.3e} tol={r['tol']:.0e}{levels}")
                _check(r["ok"], f"chain sweeps {tag} {r['dtype']} {reg}: {r}")
    log(f"[d] kernels checked in {time.perf_counter() - t0:.1f}s "
        f"(incl. compile)")


def phase_four():
    import jax
    import numpy as np

    import bench
    from __graft_entry__ import sharded_legs
    from benchmarks.models import quadcopter, spring_mass_chain
    from treeqp_tpu.core.kkt import max_kkt_residual
    from treeqp_tpu.parallel.sharding import scenario_mesh
    from treeqp_tpu.solvers.ipm import IpmOpts
    from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
    from treeqp_tpu.solvers.sdunes import (
        SdunesOpts, scenario_data, scenario_output, sdunes_solve)
    from treeqp_tpu.solvers.tdunes_multistage import (
        merge_output, split_multistage, tdunes_ms_solve)

    devs = jax.devices()[:4]
    qp = quadcopter(md=bench.MD, Nr=bench.NR, Nh=bench.NH).qp
    ms = split_multistage(qp)
    # the one-card reference and the shard_map leg run the Triton chain
    # sweeps; the GSPMD leg runs the XLA scans (tdunes_multistage.
    # _triton_sweeps)
    opts_td = bench.bench_opts()
    opts_ipm = IpmOpts(tol=1e-10, max_iter=60)
    opts_sd = SdunesOpts(tol=1e-8, max_iter=200)

    # one-card references on the first card
    one = jax.device_put((qp, ms), devs[0])
    out_td = merge_output(one[1], *tdunes_ms_solve(one[1], None, None,
                                                   opts_td))
    out_ipm = merge_output(one[1], *ipm_ms_solve(one[1], opts_ipm))

    def sd_one(q):
        sqp = jax.device_put(scenario_data(q), devs[0])
        sol, lam, mu, info = sdunes_solve(sqp, None, None, opts_sd)
        out = scenario_output(sqp, sol, lam, mu, info)
        return out, int(info["status"]), float(max_kkt_residual(q, out))

    shape = f"md={bench.MD} Nr={bench.NR} Nh={bench.NH}"
    qp_sd = qp
    out_sd, st, kkt = sd_one(qp)
    sd_tree = f"quadcopter {shape}"
    if st != 0 or kkt > KKT_TOL:
        log(f"[four] sdunes does not converge on the quadcopter tree on one "
            f"card (status={st} kkt={kkt:.2e}); the sdunes legs use the "
            f"spring-mass chain tree of the same shape")
        qp_sd, _ = spring_mass_chain(nm=4, md=bench.MD, Nr=bench.NR,
                                     Nh=bench.NH)
        out_sd, st, kkt = sd_one(qp_sd)
        sd_tree = f"spring_mass_chain nm=4 {shape}"
        _check(st == 0 and kkt <= KKT_TOL,
               f"one-card sdunes on {sd_tree}: status={st} kkt={kkt}")
    log(f"[four] tdunes_ms/ipm_ms legs on quadcopter {shape} "
        f"({qp.topo.Nn} nodes); sdunes legs on {sd_tree}")

    one_card = {"tdunes_ms": (qp, out_td), "ipm_ms": (qp, out_ipm),
                "sdunes": (qp_sd, out_sd)}
    for name, (q, ref) in one_card.items():
        kref = float(max_kkt_residual(q, ref))
        log(f"[four] one-card {name}: kkt={kref:.2e}")
        _check(kref <= KKT_TOL, f"one-card reference of {name}: {kref}")

    t0 = time.perf_counter()
    legs = sharded_legs(qp, ms, qp_sd, scenario_mesh(devs), opts_td,
                        opts_ipm, opts_sd)
    log(f"[four] six sharded legs over {len(devs)} cards in "
        f"{time.perf_counter() - t0:.1f}s (incl. compile)")
    for name, (out, status, it) in legs.items():
        q, ref = one_card[name.removesuffix("_shmap")]
        kkt = float(max_kkt_residual(q, out))
        diff = max(float(np.max(np.abs(np.asarray(getattr(out, f))
                                       - np.asarray(getattr(ref, f)))))
                   for f in ("x", "u"))
        log(f"[four] {name}: iter={it} status={status} kkt={kkt:.2e} "
            f"max|x,u - one-card|={diff:.2e}")
        _check(status == 0 and kkt <= KKT_TOL and diff <= LEG_DIFF_TOL,
               f"sharded leg {name}")


def main(argv):
    four = "--four" in argv
    dev = phase_device(4 if four else 1)
    if four:
        phase_four()
    else:
        qp = phase_main(dev)
        phase_serve(qp)
        phase_kernels(dev)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
