"""Closed-loop robust-MPC benchmark harness.

Python re-design of the reference MATLAB driver (benchmark/treeqp_main.m):
per MPC step embed the measured state as equality bounds on the root
(treeqp_main.m:266-268), solve the tree QP warm-started with the previous
multipliers (utils/treeqp_solve.m:6-17), apply the first control to the
nonlinear plant (RK4, :249-262), and log cpu time / iterations / status /
KKT residual per step (:130-141), pausing-equivalent on KKT violations
(:171-177 -> here recorded as failures).

Includes the Dolan-More performance-profile utility (benchmark/utils/perf.m)
for comparing solvers across an experiment grid
(treeqp_performance_plot.m:24-42).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from treeqp_tpu.core.kkt import max_kkt_residual
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve
from treeqp_tpu.solvers.ipm import IpmOpts, ipm_solve
from treeqp_tpu.solvers.sdunes import (
    SdunesOpts, scenario_data, sdunes_solve, scenario_output,
    scenario_duals_from_tree)


@dataclasses.dataclass
class ClosedLoopLog:
    """Per-step logs (treeqp_main.m:130-141)."""

    cpu_time: np.ndarray
    iters: np.ndarray
    status: np.ndarray
    kkt: np.ndarray
    x: np.ndarray  # [nsim+1, nx] closed-loop state trajectory
    u: np.ndarray  # [nsim, nu] applied controls
    kkt_tol: float = 1e-6  # accuracy bar used for kkt_violations

    @property
    def kkt_violations(self):
        return int(np.sum(self.kkt > self.kkt_tol))


def closed_loop_mpc(model, solver: str = "tdunes", nsim: int = 30,
                    opts=None, warm_start: bool = True,
                    kkt_tol: float = 1e-6,
                    ipm_bootstrap: bool = True) -> ClosedLoopLog:
    """Run ``nsim`` MPC steps of the given benchmark model.

    ``ipm_bootstrap``: when tdunes has no dual warm start yet (first MPC
    step), obtain one from a single IPM solve — dual Newton's global phase
    is weak on cold starts with strongly anisotropic weights (quadcopter),
    while warm-started it converges in O(1) iterations. This mirrors the
    reference's reliance on warm starts (treeqp_solve.m:6-17,
    spring_mass.c:69-83) with a self-contained initializer.
    """
    qp = model.qp
    topo = qp.topo
    nx, nu = topo.nx[0], topo.nu[0]
    x = np.asarray(model.x0, dtype=np.float64)

    if solver == "tdunes":
        opts = opts or TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=100)
    elif solver in ("ipm", "hpmpc", "hpipm"):
        solver = "ipm"
        opts = opts or IpmOpts(tol=1e-8, max_iter=30)
    elif solver == "ipm_ms":
        # crown+chains IPM (the scenario-batched layout) — exercised on
        # the same closed loop for parity with the generic path
        opts = opts or IpmOpts(tol=1e-8, max_iter=30)
    elif solver == "sdunes":
        opts = opts or SdunesOpts(tol=1e-8, max_iter=100)
    else:
        raise ValueError(solver)

    lam = None
    prev_out = None  # IPM warm start (hpmpc_tree.h:56 analog)
    ms_ws = None  # multistage-IPM (crown, chain) warm start
    sd_duals = None  # sdunes (lam, mu) persistence across steps
    logs = dict(cpu_time=[], iters=[], status=[], kkt=[])
    xs, us = [x.copy()], []

    for k in range(nsim):
        qp = qp.set_x0(x)
        t0 = time.perf_counter()
        if solver == "tdunes":
            if lam is None and ipm_bootstrap:
                lam = ipm_solve(qp, IpmOpts(tol=1e-8, max_iter=30)).lam
            out = jax.block_until_ready(tdunes_solve(qp, lam, opts))
        elif solver == "sdunes":
            sqp = scenario_data(qp)
            if sd_duals is None and ipm_bootstrap:
                # tighter tol than tdunes' bootstrap: the recovered duals
                # start sdunes at ~the boot residual, and the Nr>=3 plateau
                # means sdunes cannot polish 1e-7 -> 1e-8 itself
                boot = ipm_solve(qp, IpmOpts(tol=1e-10, max_iter=40))
                sd_duals = scenario_duals_from_tree(sqp, boot.lam, boot)
            sd_lam0, sd_mu0 = sd_duals if sd_duals is not None else (None, None)
            sol, sd_lam, sd_mu, info = sdunes_solve(sqp, sd_lam0, sd_mu0, opts)
            sol, sd_lam, sd_mu, info = jax.block_until_ready(
                (sol, sd_lam, sd_mu, info))
            if int(info["status"]) != 0 and ipm_bootstrap:
                # a large active-set change can drop the warm start onto the
                # dual-Newton plateau mid-loop; recover by re-bootstrapping
                # from the IPM (the fall-back pattern of the reference
                # harness, fault_tolerance.c:569-574)
                boot = ipm_solve(qp, IpmOpts(tol=1e-10, max_iter=40))
                sd_lam0, sd_mu0 = scenario_duals_from_tree(sqp, boot.lam, boot)
                sol, sd_lam, sd_mu, info = jax.block_until_ready(
                    sdunes_solve(sqp, sd_lam0, sd_mu0, opts))
            out = scenario_output(sqp, sol, sd_lam, sd_mu, info)
            if warm_start:
                sd_duals = (sd_lam, sd_mu)
        elif solver == "ipm_ms":
            from treeqp_tpu.solvers.ipm_multistage import ipm_ms_solve
            from treeqp_tpu.solvers.tdunes_multistage import (
                split_multistage, merge_output)
            msq = split_multistage(qp)
            ws = ms_ws if warm_start else None
            cro, cho, minfo = jax.block_until_ready(
                ipm_ms_solve(msq, opts, ws=ws))
            out = merge_output(msq, cro, cho, minfo)
            ms_ws = (cro, cho)
        else:
            ws = prev_out if warm_start else None
            out = jax.block_until_ready(ipm_solve(qp, opts, ws=ws))
        dt_solve = time.perf_counter() - t0
        kkt = float(max_kkt_residual(qp, out))

        u0 = np.asarray(out.u[0, :nu])
        x = np.asarray(model.simulate(x, u0), dtype=np.float64)[:nx]

        if warm_start and solver == "tdunes":
            lam = out.lam  # multiplier persistence across steps (treeqp_solve.m:6-8)
        prev_out = out

        logs["cpu_time"].append(dt_solve)
        logs["iters"].append(int(out.info["iter"]))
        logs["status"].append(int(out.info["status"]))
        logs["kkt"].append(kkt)
        xs.append(x.copy())
        us.append(u0)

    return ClosedLoopLog(
        cpu_time=np.asarray(logs["cpu_time"]), iters=np.asarray(logs["iters"]),
        status=np.asarray(logs["status"]), kkt=np.asarray(logs["kkt"]),
        x=np.stack(xs), u=np.stack(us), kkt_tol=kkt_tol)


def performance_profile(times: np.ndarray, taus: Optional[np.ndarray] = None):
    """Dolan-More performance profiles (benchmark/utils/perf.m:1-16).

    ``times`` [n_problems, n_solvers] (np.inf for failures). Returns
    (taus, rho [n_taus, n_solvers]) where rho_s(tau) = fraction of problems
    solver s solved within tau x the best time.
    """
    times = np.asarray(times, dtype=np.float64)
    best = np.min(times, axis=1, keepdims=True)
    ratios = times / best
    if taus is None:
        finite = ratios[np.isfinite(ratios)]
        rmax = float(finite.max()) if finite.size else 2.0
        taus = np.linspace(1.0, max(rmax, 1.0 + 1e-9), 64)
    rho = np.stack([np.mean(ratios <= t, axis=0) for t in taus])
    return taus, rho
