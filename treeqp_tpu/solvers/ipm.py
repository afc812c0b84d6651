"""Tree-structured primal-dual interior-point method (HPIPM capability class).

From-scratch JAX replacement for the reference's external HPMPC/HPIPM
engines (``treeqp/src/hpmpc_tree.c`` / ``hpipm_tree.c`` marshal into
``d_tree_ip2_res_mpc_hard_libstr`` / ``d_solve_tree_ocp_qp_ipm``):

* Mehrotra predictor-corrector on the full tree QP with box + general
  constraints (two-sided, HPIPM-style signed fold mu = lam_ub - lam_lb on
  export, cf. hpmpc_tree.c:405-433).
* Every IPM iteration solves its KKT systems with a **tree Riccati
  recursion**: a backward sweep over tree depths factorizing all nodes of a
  depth as one batched Cholesky/gemm call (the level-synchronous translation
  of HPMPC's per-node sweep), then two rhs solves (affine + centering-
  corrector) reusing the same factors.
* Termination on the four residual max-norms res_g / res_b / res_d / res_m
  (HPIPM convention, hpipm_tree.c:102-105).
* Infinite bounds (TREEQP_INF) are masked out exactly like the reference's
  finite-bound index sets idxb (hpmpc_tree.c:81-127): their slacks/duals are
  pinned at (1, 0) and contribute nothing.

Layout: per-node constraint rows t = [x; u; C x + D u] (padded
ng = nxm + num + ncm rows); all sweeps are scans over padded per-depth node
batches with a scratch row, as in the tdunes tree Cholesky.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut, TREEQP_INF
from treeqp_tpu.utils.tree import TreeStructure, add_by_slot, kid_sum

__all__ = ["IpmOpts", "ipm_solve"]

IPM_OPTIMAL = 0
IPM_MAX_ITER = 1
IPM_MIN_STEP = 2

_INF_THRESH = 0.5 * TREEQP_INF


@dataclasses.dataclass(frozen=True)
class IpmOpts:
    """Options (cf. treeqp_hpmpc_opts_t hpmpc_tree.h:50-59 /
    treeqp_hpipm_opts_t hpipm_tree.c:82-106).

    Documented deviations from the reference defaults: ``max_iter=30``
    (reference: 20, hpmpc_tree.c:68) and ``mu0=1e2`` (reference: 2.0,
    hpmpc_tree.c:69) — this from-scratch IPM cold-starts from z=0 rather
    than HPMPC's internal initialization, and the larger barrier/budget is
    reliably convergent across the whole benchmark set at the 1e-10
    4-residual tolerance (tighter than the reference's mu_tol=1e-12 on mu
    only)."""

    max_iter: int = 30
    tol: float = 1e-10  # applied to all four residuals (res_g/b/d/m)
    mu0: float = 1e2  # initial slack/dual magnitude
    alpha_min: float = 1e-8  # minimum step -> TREEQP_IP_MIN_STEP (types.h:67)
    tau_frac: float = 0.995  # fraction-to-boundary
    # fraction-to-boundary for instances WITH general C/D rows: the
    # aggressive 0.995 drives slacks so close to the boundary that the
    # dense late-barrier KKT systems exceed what the Riccati recursion +
    # refinement can solve (res_g floor ~2e-8 on the 256-scenario tree);
    # the centered 0.95 converges to ~5e-10 in the same iteration count. Box-only instances keep tau_frac.
    tau_frac_general: float = 0.95
    reg_eps: float = 0.0  # static regularization added to Muu diagonals
    # warm start (reference warm_start flag, hpmpc_tree.h:56 /
    # hpipm_tree.c:88): slack/dual floor when initializing from a previous
    # solution — keeps the start strictly interior
    ws_eps: float = 1e-3
    # --- mixed-precision path (the engine-speed analog of the tdunes
    # factor_dtype machinery; HPIPM mode=SPEED counterpart). With
    # factor_dtype="float32" the tree-Riccati factorization + solves run in
    # f32 while residuals/steps stay in the data dtype; IPM residuals are
    # recomputed exactly every iteration, so an f32-accurate direction only
    # perturbs the path (inexact Newton), not the answer. Once
    # max(res4) < f32_until (or the barrier is small enough that f32
    # directions stall), iterations switch to full-precision factorization
    # to close the last digits.
    factor_dtype: str = "same"  # same | float32
    f32_until: float = 1e-5  # residual switch point of the f32 phase
    # optional iterative refinement of each Riccati solve against the
    # exact data-dtype KKT operator (per-solve cost: one KKT apply + one
    # re-solve per step). Lowers the attainable res_g floor when the
    # Riccati floor sits right at a tight tolerance.
    refine_steps: int = 0
    # stall exit: if max(res4) has not improved by >=10% for this many
    # consecutive iterations, stop and return the BEST iterate seen (0
    # disables). Without it, an unattainable tolerance drives the barrier
    # to its floor and the late-barrier systems (gamma ~ 1/mu) blow up the
    # stationarity residual.
    stall_patience: int = 4
    # PROFILE>=2 analog: per-iteration [res_g res_b res_d res_m alpha mu
    # sigma] into info["hist"] ([max_iter, 7], NaN-padded)
    record_history: bool = False
    # Explicit-SPMD mesh axis for running the MULTISTAGE IPM inside
    # jax.shard_map with chains sharded over this axis and the crown
    # replicated: cross-device traffic becomes the explicit all-gathers of
    # the chain-root Riccati contributions (W0/w0) + scalar reductions —
    # the minimal boundary bytes — instead of GSPMD's auto-partitioned
    # collectives (parallel/shard_solver.py; round-5). None = single-device.
    axis_name: str | None = None


class _IpmPrep:
    """Static per-topology schedule: padded per-depth node batches."""

    def __init__(self, topo: TreeStructure):
        self.topo = topo
        Nn = topo.Nn
        self.par = topo.parent_np.copy()
        self.par[0] = Nn  # root's parent -> scratch row
        # sibling slot of each node (and of the scratch row Nn)
        self.sibx = np.concatenate([topo.sib_index, [0]]).astype(np.int32)
        self.K = max(topo.Kmax, 1)
        st = topo.stage
        self.n_stages = topo.Nh + 1
        Smax = max(int(np.sum(st == s)) for s in range(self.n_stages))
        self.Smax = Smax
        # descending stage order for the backward sweep
        self.bwd_idx = np.full((self.n_stages, Smax), Nn, dtype=np.int32)
        self.bwd_valid = np.zeros((self.n_stages, Smax), dtype=bool)
        for r, s in enumerate(range(self.n_stages - 1, -1, -1)):
            nodes = np.nonzero(st == s)[0]
            self.bwd_idx[r, : len(nodes)] = nodes
            self.bwd_valid[r, : len(nodes)] = True
        self.fwd_idx = self.bwd_idx[::-1].copy()
        self.fwd_valid = self.bwd_valid[::-1].copy()


def _get_ipm_prep(topo: TreeStructure) -> _IpmPrep:
    if not hasattr(_get_ipm_prep, "_cache"):
        _get_ipm_prep._cache = {}
    if topo not in _get_ipm_prep._cache:
        _get_ipm_prep._cache[topo] = _IpmPrep(topo)
    return _get_ipm_prep._cache[topo]


def _constraint_data(qp: TreeQPIn):
    """Stack bounds + general constraints: t = G z in [lo, hi], with
    finite-side masks. G rows: [I 0; 0 I; C D] (ng = nxm + num + ncm)."""
    topo = qp.topo
    dt = qp.dtype
    Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
    xm = jnp.asarray(topo.x_mask, dt)
    um = jnp.asarray(topo.u_mask, dt)
    cm = jnp.asarray(topo.c_mask, dt)
    nz = nxm + num
    ng = nxm + num + ncm
    G = jnp.zeros((Nn, ng, nz), dt)
    eye_x = jnp.eye(nxm, dtype=dt)[None] * xm[:, :, None]
    eye_u = jnp.eye(num, dtype=dt)[None] * um[:, :, None]
    G = G.at[:, :nxm, :nxm].set(eye_x)
    G = G.at[:, nxm:nz, nxm:].set(eye_u)
    G = G.at[:, nz:, :nxm].set(qp.C * cm[:, :, None])
    G = G.at[:, nz:, nxm:].set(qp.D * cm[:, :, None])
    lo = jnp.concatenate([qp.xmin, qp.umin, qp.dmin], axis=1)
    hi = jnp.concatenate([qp.xmax, qp.umax, qp.dmax], axis=1)
    rmask = jnp.concatenate([xm, um, cm], axis=1)
    m_lo = (lo > -_INF_THRESH) & (rmask > 0)
    m_hi = (hi < _INF_THRESH) & (rmask > 0)
    return G, lo, hi, m_lo.astype(dt), m_hi.astype(dt)


def _stage_hessian(qp: TreeQPIn):
    """H = [[Q S'],[S R]] per node, identity on padded dims."""
    topo = qp.topo
    dt = qp.dtype
    nxm, num = topo.nxm, topo.num
    xm = jnp.asarray(topo.x_mask, dt)
    um = jnp.asarray(topo.u_mask, dt)
    H = jnp.zeros((topo.Nn, nxm + num, nxm + num), dt)
    H = H.at[:, :nxm, :nxm].set(qp.Q * xm[:, :, None] * xm[:, None, :])
    H = H.at[:, nxm:, nxm:].set(qp.R * um[:, :, None] * um[:, None, :])
    Sm = qp.S * um[:, :, None] * xm[:, None, :]
    H = H.at[:, nxm:, :nxm].set(Sm)
    H = H.at[:, :nxm, nxm:].set(Sm.swapaxes(1, 2))
    zmask = jnp.concatenate([xm, um], axis=1)
    return H + jnp.eye(nxm + num, dtype=dt)[None] * (1.0 - zmask)[:, :, None], zmask


def _tri_solve_mat(L, B, trans=False):
    return jax.lax.linalg.triangular_solve(L, B, left_side=True, lower=True,
                                           transpose_a=trans)


def _riccati_factor(qp: TreeQPIn, Hbar, prep: _IpmPrep, opts: IpmOpts,
                    fdt=None, Wsum0=None):
    """Backward depth sweep: per-node P, chol(Muu), K, Mxu.

    M_n = Hbar_n + sum_kids [A B]' P_c [A B];  u = K x + k elimination.
    Batched over all nodes of a depth per scan step. ``fdt`` (e.g.
    jnp.float32) runs the whole factorization in that dtype — the IPM
    mixed-precision speed path; _riccati_solve then casts rhs/solution at
    the boundary. ``Wsum0`` [Nn, nz, nz] seeds the child contributions —
    the boundary term when this tree is the crown of a larger multistage
    tree (ipm_multistage feeds the chains' value-function Hessians here).
    """
    topo = qp.topo
    if fdt is not None:
        Hbar = Hbar.astype(fdt)
    dt = Hbar.dtype
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    AB = jnp.concatenate([qp.A, qp.B], axis=2).astype(dt)  # [Nn, nxm, nz]

    P = jnp.zeros((Nn + 1, nxm, nxm), dt)
    Luu = jnp.zeros((Nn + 1, num, num), dt)
    K = jnp.zeros((Nn + 1, num, nxm), dt)
    Mxu = jnp.zeros((Nn + 1, nxm, num), dt)
    Wsum = jnp.zeros((Nn + 1, nz, nz), dt)
    if Wsum0 is not None:
        Wsum = Wsum.at[:Nn].set(Wsum0.astype(dt))
    Hx = jnp.concatenate([Hbar, jnp.eye(nz, dtype=dt)[None]], axis=0)
    ABx = jnp.concatenate([AB, jnp.zeros((1, nxm, nz), dt)], axis=0)
    parx = jnp.asarray(np.concatenate([prep.par, [Nn]]).astype(np.int32))
    sibx = jnp.asarray(prep.sibx)

    xs = (jnp.asarray(prep.bwd_idx), jnp.asarray(prep.bwd_valid))

    def step(carry, x):
        P, Luu, K, Mxu, Wsum = carry
        idx, valid = x
        safe = jnp.where(valid, idx, Nn)
        M = Hx[safe] + Wsum[safe]
        Mxx = M[:, :nxm, :nxm]
        Mxu_b = M[:, :nxm, nxm:]
        Muu = M[:, nxm:, nxm:] + opts.reg_eps * jnp.eye(num, dtype=dt)
        Lb = jnp.linalg.cholesky(Muu)
        # K = -Muu^-1 Mux
        Kb = -_tri_solve_mat(Lb, _tri_solve_mat(Lb, M[:, nxm:, :nxm]), trans=True)
        Pb = Mxx + Mxu_b @ Kb
        Pb = 0.5 * (Pb + Pb.swapaxes(1, 2))
        P = P.at[safe].set(Pb)
        Luu = Luu.at[safe].set(Lb)
        K = K.at[safe].set(Kb)
        Mxu = Mxu.at[safe].set(Mxu_b)
        # contribution to the parent: W_c = [A B]' P_c [A B] for the edge into c
        ABc = ABx[safe]
        Wc = ABc.swapaxes(1, 2) @ Pb @ ABc
        Wsum = add_by_slot(Wsum, parx[safe], sibx[safe], valid, Wc, prep.K)
        return (P, Luu, K, Mxu, Wsum), None

    (P, Luu, K, Mxu, _), _ = jax.lax.scan(
        step, (P, Luu, K, Mxu, Wsum), xs)
    return dict(P=P, Luu=Luu, K=K, Mxu=Mxu, AB=AB)


def _riccati_solve(qp: TreeQPIn, fact, rg, rb, prep: _IpmPrep, wsum0=None):
    """Two-sweep solve with stored factors.

    rg [Nn, nz]: stationarity rhs (gradient); rb [Nn, nxm]: dynamics residual
    as the affine term of the edge into each node. Returns (dz [Nn, nz],
    dlam [Nn, nxm]) solving the equality-constrained Newton system:
        Hbar dz + rg + edge-duals = 0,  dx_c = A dx_p + B du_p + rb_c.
    Runs in the factors' dtype (rhs cast in, solution cast back out).
    """
    topo = qp.topo
    out_dt = rg.dtype
    dt = fact["P"].dtype
    rg, rb = rg.astype(dt), rb.astype(dt)
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    P, Luu, K, Mxu, AB = fact["P"], fact["Luu"], fact["K"], fact["Mxu"], fact["AB"]
    ABx = jnp.concatenate([AB, jnp.zeros((1, nxm, nz), dt)], axis=0)
    rbx = jnp.concatenate([rb, jnp.zeros((1, nxm), dt)], axis=0)
    parx = jnp.asarray(np.concatenate([prep.par, [Nn]]).astype(np.int32))
    sibx = jnp.asarray(prep.sibx)

    p = jnp.zeros((Nn + 1, nxm), dt)
    k = jnp.zeros((Nn + 1, num), dt)
    wsum = jnp.zeros((Nn + 1, nz), dt)
    if wsum0 is not None:
        wsum = wsum.at[:Nn].set(wsum0.astype(dt))
    rgx = jnp.concatenate([rg, jnp.zeros((1, nz), dt)], axis=0)

    bxs = (jnp.asarray(prep.bwd_idx), jnp.asarray(prep.bwd_valid))

    def bwd(carry, x):
        p, k, wsum = carry
        idx, valid = x
        safe = jnp.where(valid, idx, Nn)
        m = rgx[safe] + wsum[safe]  # [b, nz]
        mu_part = m[:, nxm:]
        kb = -_tri_solve_mat(Luu[safe], _tri_solve_mat(Luu[safe], mu_part[..., None]),
                             trans=True)[..., 0]
        pb = m[:, :nxm] + jnp.einsum("bxu,bu->bx", Mxu[safe], kb)
        p = p.at[safe].set(pb)
        k = k.at[safe].set(kb)
        # contribution to parent: w_c = [A B]'(P_c rb_c + p_c)
        v = jnp.einsum("bxy,by->bx", P[safe], rbx[safe]) + pb
        wc = jnp.einsum("bxz,bx->bz", ABx[safe], v)
        wsum = add_by_slot(wsum, parx[safe], sibx[safe], valid, wc, prep.K)
        return (p, k, wsum), None

    (p, k, _), _ = jax.lax.scan(bwd, (p, k, wsum), bxs)

    # forward: root state from P_0 dx0 = -p_0 (free or eliminated root)
    L0 = jnp.linalg.cholesky(P[0])
    dx0 = -_tri_solve_mat(L0, _tri_solve_mat(L0, p[0][:, None]), trans=True)[:, 0]

    dx = jnp.zeros((Nn + 1, nxm), dt).at[0].set(dx0)
    du = jnp.zeros((Nn + 1, num), dt)
    dlam = jnp.zeros((Nn + 1, nxm), dt)

    fxs = (jnp.asarray(prep.fwd_idx), jnp.asarray(prep.fwd_valid))

    def fwd(carry, x):
        dx, du, dlam = carry
        idx, valid = x
        safe = jnp.where(valid, idx, Nn)
        # state of this node: root already set; others from parent
        is_root = (safe == 0)
        xp = dx[parx[safe]]
        up = du[parx[safe]]
        zp = jnp.concatenate([xp, up], axis=1)
        x_new = jnp.einsum("bxz,bz->bx", ABx[safe], zp) + rbx[safe]
        x_cur = jnp.where(is_root[:, None], dx[safe], x_new)
        u_cur = jnp.einsum("bux,bx->bu", K[safe], x_cur) + k[safe]
        lam_cur = jnp.einsum("bxy,by->bx", P[safe], x_cur) + p[safe]
        dx = dx.at[safe].set(x_cur)
        du = du.at[safe].set(u_cur)
        dlam = dlam.at[safe].set(lam_cur)
        return (dx, du, dlam), None

    (dx, du, dlam), _ = jax.lax.scan(fwd, (dx, du, dlam), fxs)
    dz = jnp.concatenate([dx[:Nn], du[:Nn]], axis=1)
    return dz.astype(out_dt), dlam[:Nn].astype(out_dt)


def _kkt_apply(qp: TreeQPIn, Hbar, dz, dlam, prep: _IpmPrep, nrxm, zmask):
    """Exact data-dtype action of the equality-constrained KKT operator
    solved by the Riccati recursion:
        L1(dz, dlam) = Hbar dz - E'dlam + sum_kids [A B]' dlam_kid
        L2(dz)       = dx - (A dx_p + B du_p)
    _riccati_solve returns (dz, dlam) with L1 = -rg, L2 = rb; used for
    iterative refinement of f32-factored solves."""
    topo = qp.topo
    Nn, nxm = topo.Nn, topo.nxm
    AB = jnp.concatenate([qp.A, qp.B], axis=2)
    par = prep.par.copy()
    par[0] = 0
    r1 = jnp.einsum("nij,nj->ni", Hbar, dz)
    r1 = r1.at[:, :nxm].add(-dlam * nrxm)
    contrib = jnp.einsum("nxz,nx->nz", AB, dlam * nrxm)
    r1 = (r1 + kid_sum(contrib, topo)) * zmask
    r2 = (dz[:, :nxm] - jnp.einsum("nxz,nz->nx", AB, dz[par])) * nrxm
    return r1, r2


def ipm_solve(qp: TreeQPIn, opts: IpmOpts = IpmOpts(), ws=None) -> TreeQPOut:
    """Solve the tree QP with a Mehrotra predictor-corrector IPM.

    Capability equivalent of ``treeqp_hpipm_solve`` (hpipm_tree.c:307-562),
    built on the batched tree Riccati above instead of an external engine.

    ``ws``: optional warm start from a previous solution (a TreeQPOut or
    any object with x/u/lam/mu_x/mu_u/mu_d) — the reference's
    ``warm_start`` flag (hpmpc_tree.h:56, hpipm_tree.c:88). Slacks start
    at the actual constraint distances and duals at the signed-fold
    multipliers, floored at ``opts.ws_eps`` to stay strictly interior;
    consecutive MPC steps then converge in a fraction of the cold-start
    iterations.
    """
    return _ipm_solve_jit(qp, opts, ws)


@partial(jax.jit, static_argnames=("opts",))
def _ipm_solve_jit(qp: TreeQPIn, opts: IpmOpts = IpmOpts(),
                   ws=None) -> TreeQPOut:
    topo = qp.topo
    prep = _get_ipm_prep(topo)
    dt = qp.dtype
    has_general = max(topo.nc) > 0  # static: general C/D rows present
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num

    H, zmask = _stage_hessian(qp)
    G, lo, hi, m_lo, m_hi = _constraint_data(qp)
    ng = G.shape[1]
    h = jnp.concatenate([qp.q, qp.r], axis=1) * zmask
    nrxm = jnp.asarray(topo.nonroot_x_mask, dt)
    par = prep.par.copy()
    par[0] = 0
    n_ineq = jnp.maximum(jnp.sum(m_lo) + jnp.sum(m_hi), 1.0)

    def residuals(z, lam, l_lo, l_hi, s_lo, s_hi):
        """HPIPM-style res_g / res_b / res_d / res_m."""
        t = jnp.einsum("ngz,nz->ng", G, z)
        # res_g: H z + h + G'(l_hi - l_lo) - E'lam_self + sum_kids [A B]'lam_c
        rg = (jnp.einsum("nij,nj->ni", H, z) * zmask + h
              + jnp.einsum("ngz,ng->nz", G, l_hi - l_lo))
        rg = rg.at[:, :nxm].add(-lam * nrxm)
        AB = jnp.concatenate([qp.A, qp.B], axis=2)
        contrib = jnp.einsum("nxz,nx->nz", AB, lam * nrxm)
        rg = rg + kid_sum(contrib, topo)
        rg = rg * zmask
        # res_b
        zp = z[par]
        rb = (jnp.einsum("nxz,nz->nx", AB, zp) + qp.b - z[:, :nxm]) * nrxm
        # res_d
        rd_lo = (s_lo - (t - lo)) * m_lo
        rd_hi = (s_hi - (hi - t)) * m_hi
        # res_m
        rm_lo = s_lo * l_lo * m_lo
        rm_hi = s_hi * l_hi * m_hi
        return rg, rb, rd_lo, rd_hi, rm_lo, rm_hi

    def kkt_rhs(rg, rb, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi):
        """Eliminate (ds, dl) -> condensed (rhs_g, Gamma) for the Riccati."""
        inv_slo = jnp.where(m_lo > 0, 1.0 / s_lo, 0.0)
        inv_shi = jnp.where(m_hi > 0, 1.0 / s_hi, 0.0)
        gamma = l_lo * inv_slo + l_hi * inv_shi  # [Nn, ng]
        # Substituting ds = +-G dz - rd and dl = (-rm - l ds)/s into the
        # stationarity rows gives (H + G'Gamma G) dz + dual-terms + rg_c = 0,
        # rg_c = rg + G'[(rm_lo - l_lo rd_lo)/s_lo - (rm_hi - l_hi rd_hi)/s_hi]
        qx = ((rm_lo - l_lo * rd_lo) * inv_slo
              - (rm_hi - l_hi * rd_hi) * inv_shi)
        rhs_g = rg + jnp.einsum("ngz,ng->nz", G, qx)
        return rhs_g, gamma

    def expand_step(dz, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi):
        dt_ = jnp.einsum("ngz,nz->ng", G, dz)
        ds_lo = (dt_ - rd_lo) * m_lo
        ds_hi = (-dt_ - rd_hi) * m_hi
        inv_slo = jnp.where(m_lo > 0, 1.0 / s_lo, 0.0)
        inv_shi = jnp.where(m_hi > 0, 1.0 / s_hi, 0.0)
        dl_lo = (-(rm_lo + l_lo * ds_lo) * inv_slo) * m_lo
        dl_hi = (-(rm_hi + l_hi * ds_hi) * inv_shi) * m_hi
        return ds_lo, ds_hi, dl_lo, dl_hi

    def max_step(v, dv, mask, frac=1.0):
        """Largest alpha in (0,1] with v + alpha frac*dv >= 0 on masked
        entries; 1.0 when no constraint blocks (so unconstrained problems
        take exact full Newton steps)."""
        ratio = jnp.where((dv < 0) & (mask > 0), -v / jnp.where(dv < 0, dv, -1.0),
                          jnp.inf)
        return jnp.minimum(1.0, frac * jnp.min(ratio))

    if ws is None:
        # --- cold start: slacks at least the distance to the bound at z=0
        # (wide but finite bounds then start near-inactive instead of
        # blowing up the complementarity residual), duals mu0/s
        z0 = jnp.zeros((Nn, nz), dt)
        lam0 = jnp.zeros((Nn, nxm), dt)
        s_init = jnp.sqrt(opts.mu0)
        s_lo0 = jnp.where(m_lo > 0, jnp.maximum(s_init, -lo), 1.0)
        s_hi0 = jnp.where(m_hi > 0, jnp.maximum(s_init, hi), 1.0)
        l_lo0 = jnp.where(m_lo > 0, opts.mu0 / s_lo0, 0.0)
        l_hi0 = jnp.where(m_hi > 0, opts.mu0 / s_hi0, 0.0)
    else:
        # --- warm start from a previous solution (hpmpc_tree.h:56)
        eps = jnp.asarray(opts.ws_eps, dt)
        z0 = jnp.concatenate([ws.x, ws.u], axis=1).astype(dt) * zmask
        lam0 = ws.lam.astype(dt) * nrxm
        t0 = jnp.einsum("ngz,nz->ng", G, z0)
        s_lo0 = jnp.where(m_lo > 0, jnp.maximum(t0 - lo, eps), 1.0)
        s_hi0 = jnp.where(m_hi > 0, jnp.maximum(hi - t0, eps), 1.0)
        mu_fold = jnp.concatenate(
            [ws.mu_x, ws.mu_u, ws.mu_d], axis=1).astype(dt)
        l_lo0 = jnp.where(m_lo > 0, jnp.maximum(-mu_fold, eps), 0.0)
        l_hi0 = jnp.where(m_hi > 0, jnp.maximum(mu_fold, eps), 0.0)

    def iteration(carry, fdt=None):
        (z, lam, l_lo, l_hi, s_lo, s_hi, it, status, res4, hist,
         bstate, best4, noimp) = carry
        rg, rb, rd_lo, rd_hi, rm_lo, rm_hi = residuals(z, lam, l_lo, l_hi, s_lo, s_hi)

        # --- factor with current barrier weights
        rhs_g_aff, gamma = kkt_rhs(rg, rb, rd_lo, rd_hi, rm_lo, rm_hi,
                                   s_lo, s_hi, l_lo, l_hi)
        Hbar = H + jnp.einsum("ngi,ng,ngj->nij", G, gamma, G)
        fact = _riccati_factor(qp, Hbar, prep, opts, fdt)

        def one_solve(rg_, rb_):
            return _riccati_solve(qp, fact, rg_, rb_, prep)

        def rsolve(rg_, rb_):
            dz_, dlam_ = one_solve(rg_, rb_)
            if opts.refine_steps <= 0:
                return dz_, dlam_
            # iterative refinement against the exact data-dtype KKT
            # operator (cf. tdunes _newton_direction)
            for _ in range(opts.refine_steps):
                r1, r2 = _kkt_apply(qp, Hbar, dz_, dlam_, prep, nrxm, zmask)
                e1 = -rg_ - r1
                e2 = rb_ - r2
                cz, clam = one_solve(-e1, e2)
                dz_, dlam_ = dz_ + cz, dlam_ + clam
            return dz_, dlam_

        # --- affine (predictor) step: dx_c = A dx_p + B du_p + rb_c
        dz_a, dlam_a = rsolve(rhs_g_aff, rb)
        ds_lo_a, ds_hi_a, dl_lo_a, dl_hi_a = expand_step(
            dz_a, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi)
        a_p = jnp.minimum(max_step(s_lo, ds_lo_a, m_lo), max_step(s_hi, ds_hi_a, m_hi))
        a_d = jnp.minimum(max_step(l_lo, dl_lo_a, m_lo), max_step(l_hi, dl_hi_a, m_hi))
        alpha_aff = jnp.minimum(a_p, a_d)
        mu = (jnp.sum(s_lo * l_lo * m_lo) + jnp.sum(s_hi * l_hi * m_hi)) / n_ineq
        mu_aff = (jnp.sum((s_lo + alpha_aff * ds_lo_a) * (l_lo + alpha_aff * dl_lo_a) * m_lo)
                  + jnp.sum((s_hi + alpha_aff * ds_hi_a) * (l_hi + alpha_aff * dl_hi_a) * m_hi)) / n_ineq
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-300)) ** 3, 0.0, 1.0)

        # --- corrector: comp target sigma*mu - ds_aff*dl_aff
        rm_lo_c = rm_lo + (ds_lo_a * dl_lo_a - sigma * mu) * m_lo
        rm_hi_c = rm_hi + (ds_hi_a * dl_hi_a - sigma * mu) * m_hi
        rhs_g_c, _ = kkt_rhs(rg, rb, rd_lo, rd_hi, rm_lo_c, rm_hi_c,
                             s_lo, s_hi, l_lo, l_hi)
        dz, dlam = rsolve(rhs_g_c, rb)
        ds_lo, ds_hi, dl_lo, dl_hi = expand_step(
            dz, rd_lo, rd_hi, rm_lo_c, rm_hi_c, s_lo, s_hi, l_lo, l_hi)

        tf = opts.tau_frac_general if has_general else opts.tau_frac
        a_p = jnp.minimum(max_step(s_lo, ds_lo, m_lo, tf), max_step(s_hi, ds_hi, m_hi, tf))
        a_d = jnp.minimum(max_step(l_lo, dl_lo, m_lo, tf), max_step(l_hi, dl_hi, m_hi, tf))
        alpha = jnp.minimum(a_p, a_d)

        # numerical-failure guard (cf. the dual-Newton NaN/non-descent
        # check, dual_Newton_tree.c:951-954): a NaN direction — e.g. a
        # failed Cholesky on a late-barrier Muu — must exit as MIN_STEP
        # with the last finite iterate, never report OPTIMAL (NaN
        # comparisons in `cond` are false and would exit the loop)
        ok = ~(jnp.isnan(alpha) | jnp.isnan(jnp.sum(dz)))
        alpha = jnp.where(ok, alpha, 0.0)
        # sanitize the direction too: alpha = 0 alone still poisons the
        # iterate (0 * NaN = NaN)
        dz = jnp.where(ok, dz, 0.0)
        dlam = jnp.where(ok, dlam, 0.0)
        ds_lo, ds_hi = jnp.where(ok, ds_lo, 0.0), jnp.where(ok, ds_hi, 0.0)
        dl_lo, dl_hi = jnp.where(ok, dl_lo, 0.0), jnp.where(ok, dl_hi, 0.0)
        z = z + alpha * dz
        lam = lam + alpha * dlam * nrxm
        s_lo = jnp.where(m_lo > 0, s_lo + alpha * ds_lo, 1.0)
        s_hi = jnp.where(m_hi > 0, s_hi + alpha * ds_hi, 1.0)
        l_lo = jnp.where(m_lo > 0, l_lo + alpha * dl_lo, 0.0)
        l_hi = jnp.where(m_hi > 0, l_hi + alpha * dl_hi, 0.0)

        status = jnp.where((alpha < opts.alpha_min) | ~ok,
                           IPM_MIN_STEP, status)
        rg2, rb2, rd_lo2, rd_hi2, rm_lo2, rm_hi2 = residuals(
            z, lam, l_lo, l_hi, s_lo, s_hi)
        res4 = jnp.stack([
            jnp.max(jnp.abs(rg2)), jnp.max(jnp.abs(rb2)),
            jnp.maximum(jnp.max(jnp.abs(rd_lo2)), jnp.max(jnp.abs(rd_hi2))),
            jnp.maximum(jnp.max(jnp.abs(rm_lo2)), jnp.max(jnp.abs(rm_hi2))),
        ])
        if opts.record_history:
            hist = hist.at[it].set(jnp.concatenate(
                [res4, jnp.stack([alpha, mu, sigma])]))
        # best-iterate tracking + stall detection. The stall counter only
        # arms in the late-barrier regime (mu < tol): the early Mehrotra
        # phase is legitimately non-monotone in max(res4) (the
        # complementarity residual spikes while the iterate centers).
        m4 = jnp.max(res4)
        better = m4 < jnp.max(best4)
        mu2 = (jnp.sum(s_lo * l_lo * m_lo) + jnp.sum(s_hi * l_hi * m_hi)) \
            / n_ineq
        noimp = jnp.where(m4 < 0.9 * jnp.max(best4), 0,
                          jnp.where(mu2 < opts.tol, noimp + 1, 0))
        sel = lambda a, b: jnp.where(better, a, b)
        bstate = jax.tree_util.tree_map(
            sel, (z, lam, l_lo, l_hi, s_lo, s_hi), bstate)
        best4 = jax.tree_util.tree_map(sel, res4, best4)
        return (z, lam, l_lo, l_hi, s_lo, s_hi, it + 1, status, res4, hist,
                bstate, best4, noimp)

    def cond(carry):
        _, _, _, _, _, _, it, status, res4, _, _, _, noimp = carry
        ok = (jnp.max(res4) >= opts.tol) & (status == IPM_OPTIMAL) \
            & (it < opts.max_iter)
        if opts.stall_patience > 0:
            ok = ok & (noimp < opts.stall_patience)
        return ok

    hist0 = jnp.full((opts.max_iter if opts.record_history else 1, 7),
                     jnp.nan, dt)
    state0 = (z0, lam0, l_lo0, l_hi0, s_lo0, s_hi0)
    init = state0 + (jnp.zeros((), jnp.int32),
                     jnp.full((), IPM_OPTIMAL, jnp.int32),
                     jnp.full((4,), jnp.inf, dt),
                     hist0, state0, jnp.full((4,), jnp.inf, dt),
                     jnp.zeros((), jnp.int32))
    if opts.factor_dtype == "float32" and dt == jnp.float64:
        # --- two-phase mixed precision: f32 Riccati while the residuals
        # are above f32_until (inexact Newton — the exactly-recomputed
        # residuals absorb the f32 direction error), then full-precision
        # factorization to the final tolerance.
        switch = max(opts.tol, opts.f32_until)

        def cond_a(carry):
            _, _, _, _, _, _, it, status, res4, _, _, _, noimp = carry
            ok = ((jnp.max(res4) >= switch) & (status == IPM_OPTIMAL)
                  & (it < opts.max_iter))
            if opts.stall_patience > 0:
                ok = ok & (noimp < opts.stall_patience)
            return ok

        carry = jax.lax.while_loop(
            cond_a, partial(iteration, fdt=jnp.float32), init)
        # a MIN_STEP / stall in the f32 phase is expected noise near its
        # residual floor, not a failure: hand over to the exact phase,
        # which re-detects a true minimum step / stall
        carry = carry[:7] + (jnp.full((), IPM_OPTIMAL, jnp.int32),) \
            + carry[8:12] + (jnp.zeros((), jnp.int32),)
        init = carry
    (z, lam, l_lo, l_hi, s_lo, s_hi, it, status, res4, hist,
     bstate, best4, _) = jax.lax.while_loop(cond, iteration, init)
    # export the BEST iterate seen (== the final one unless the loop ran
    # past its numerical floor and was stall-exited)
    use_best = jnp.max(best4) < jnp.max(res4)
    selb = lambda a, b: jnp.where(use_best, a, b)
    (z, lam, l_lo, l_hi, s_lo, s_hi) = jax.tree_util.tree_map(
        selb, bstate, (z, lam, l_lo, l_hi, s_lo, s_hi))
    res4 = jax.tree_util.tree_map(selb, best4, res4)
    # NaN-safe: ~(max < tol) so a NaN residual can never read as OPTIMAL
    status = jnp.where((status == IPM_OPTIMAL) & ~(jnp.max(res4) < opts.tol),
                       IPM_MAX_ITER, status)
    # a MIN_STEP whose best iterate still meets the tolerance is a success
    status = jnp.where((status == IPM_MIN_STEP) & (jnp.max(res4) < opts.tol),
                       IPM_OPTIMAL, status)

    # --- export with signed multiplier fold mu = l_hi - l_lo (hpmpc_tree.c:405-433)
    xm = jnp.asarray(topo.x_mask, dt)
    um = jnp.asarray(topo.u_mask, dt)
    mu_all = l_hi - l_lo
    return TreeQPOut(
        x=z[:, :nxm] * xm, u=z[:, nxm:] * um, lam=lam * nrxm,
        mu_x=mu_all[:, :nxm] * xm, mu_u=mu_all[:, nxm:nz] * um,
        mu_d=mu_all[:, nz:] * jnp.asarray(topo.c_mask, dt),
        info=(dict(iter=it, status=status, res4=res4, hist=hist)
              if opts.record_history else
              dict(iter=it, status=status, res4=res4)),
    )
