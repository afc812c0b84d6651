"""tdunes — dual Newton on the tree formulation (the flagship solver).

Batched array re-design of the reference ``treeqp/src/dual_Newton_tree.{h,c}``
with its stage-QP plugins (``dual_Newton_tree_clipping.c``,
``dual_Newton_tree_qpoases.c``). The algorithm: dualize all parent->child
dynamics constraints with multipliers lambda_c (one per non-root node); each
node becomes an independent small QP parametric in lambda; run a non-smooth
Newton method on the concave dual, whose block-sparse Hessian is factorized
by a tree-structured block Cholesky.

Architectural translation (not a port):

* The reference solves Nn stage QPs in an OpenMP loop
  (dual_Newton_tree.c:256-330); here one batched closed-form clip / matmul
  over all nodes.
* The dual Hessian assembly uses a unified formulation M = J P J' where J is
  the dynamics Jacobian and P_n the per-node sensitivity dz/d(gradient)
  (diagonal "calligraphic inverse" QinvCal/RinvCal for clipping,
  dual_Newton_tree_clipping.c:221-224; dense null-space elimination matrix
  P = Z (Z'HZ)^-1 Z' for general stage QPs,
  dual_Newton_tree_qpoases.c:153-214). W/Ut blocks become batched einsums
  over the slot-padded lambda-group layout.
* The level-synchronous tree Cholesky (dual_Newton_tree.c:668-775) becomes a
  static sweep over depths with batched potrf/trsm/syrk over all parent
  blocks of a depth, with scatter-adds for the parent Schur updates.
* The active-set change tracking (`checkLastActiveSet`) survives as a
  whole-tree scalar: per-node branchy skipping loses in batched form, but
  when the ENTIRE active set is unchanged a scalar lax.cond reuses the previous
  factorization bitwise (opts.reuse_factorization, multistage solver).
* The Armijo line search (dual_Newton_tree.c:922-1019) runs under
  lax.while_loop with batched dual-function evaluations.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut, TREEQP_INF
from treeqp_tpu.utils.tree import TreeStructure, kid_sum

__all__ = ["TdunesOpts", "tdunes_solve", "TDUNES_OPTIMAL", "TDUNES_MAX_ITER",
           "TDUNES_NOT_DESCENT"]

# status codes (cf. reference utils/types.h return_t)
TDUNES_OPTIMAL = 0
TDUNES_MAX_ITER = 1
TDUNES_NOT_DESCENT = 2


@dataclasses.dataclass(frozen=True)
class TdunesOpts:
    """Solver options (reference treeqp_tdunes_opts_t, dual_Newton_tree.h:67-87;
    defaults at dual_Newton_tree.c:92-120)."""

    max_iter: int = 100
    termination: str = "infnorm"  # infnorm | twonorm | sumsquared
    tol: float = 1e-8
    ls_max_iter: int = 50
    ls_gamma: float = 0.1
    ls_beta: float = 0.6
    # Batched Armijo: evaluate the first `ls_batch` candidates tau = beta^k
    # in ONE batched stage solve (SURVEY 7 hard-part 4 — the reference
    # re-solves all stage QPs per trial step sequentially,
    # dual_Newton_tree.c:958-992) and pick the first acceptable, falling
    # back to sequential backtracking beyond. Identical accept decisions to
    # the sequential search; 0 disables. Batching trades serialized
    # kernels for proportional flops.
    ls_batch: int = 0
    ls_restart_trigger: int = -1  # consecutive maxed-out line searches -> full step
    reg_type: str = "on_the_fly"  # none | always | on_the_fly
    reg_tol: float = 1e-6
    reg_value: float = 1e-6
    # Stage-QP solver (reference per-node vtable, dual_Newton_tree.c:124-162):
    #   clipping — closed-form for diag Q/R, S=0, nc=0
    #             (dual_Newton_tree_clipping.c)
    #   dense    — unconstrained general H via P = H^-1
    #   boxqp    — dense H + bounds, batched projected Newton
    #   qpgen    — fully general stage QPs incl. C/D rows (the qpOASES
    #             capability, dual_Newton_tree_qpoases.c): batched ADMM for
    #             active-set identification + one exact KKT polish + the
    #             null-space elimination matrix P = Z (Z'HZ)^-1 Z'
    #   mixed    — per-node dispatch clipping/qpgen (reference mixes
    #             clipping and qpOASES nodes in one tree); the node split
    #             comes from `node_solver` (auto-derived by tdunes_solve)
    stage_solver: str = "clipping"  # clipping | dense | boxqp | qpgen | mixed
    # inner projected-Newton iterations for the boxqp stage solver
    boxqp_iters: int = 8
    # qpgen: ADMM iterations for active-set identification (the final
    # answer comes from exact working-set solves; see _qpgen_batch)
    qpgen_iters: int = 100
    # qpgen working-set factorization dtype: "float32" factors the
    # working-set system and the elimination-matrix inverse in f32 and
    # restores data-dtype accuracy by iterative refinement (polish) /
    # Newton-Schulz steps (elimination matrix); refinement against the f64
    # residual keeps the KKT guard
    # at 1e-9 quality. "same" disables.
    qpgen_factor_dtype: str = "same"  # same | float32
    # static per-node solver choice for stage_solver="mixed":
    # tuple of 1 (clipping) / 0 (qpgen) per node; None = derive from data
    node_solver: tuple = None
    # Mixed-precision path: gradients / residuals / line search stay
    # in the data dtype (f64 for 1e-8+ KKT targets), while the dual-Hessian
    # factorization + triangular solves run in this dtype. "same" disables.
    # An inexact-Newton scheme: the direction is f32-accurate but the
    # descent check and Armijo acceptance use exact f64 dual values.
    factor_dtype: str = "same"  # same | float32
    # Iterative refinement of the Newton direction: re-solve the f32-factored
    # system against the f64 Newton-system residual (M applied via the
    # J P J' structure) this many extra times. 1-2 restores f64-quality
    # directions at f32 factorization cost.
    refine_steps: int = 0
    # Safeguarded refinement compares Newton-system residual norms and keeps
    # the better direction (2 extra Hessian applies); unsafeguarded applies
    # the correction unconditionally (1 apply) — fine for well-equilibrated
    # problems, the safeguard matters near-degenerate active sets.
    refine_safeguard: bool = True
    # Two-phase precision (multistage solver): > 0 runs a coarse phase with
    # EVERYTHING in f32 (stage solves, residuals, dual values) down to
    # this stationarity error (or
    # stall), then switches to the f64 phase with refinement for the final
    # tolerance. Same Newton iterations, same final accuracy. Requires f64
    # data + factor_dtype=float32; 0 disables.
    f32_phase_tol: float = 0.0
    # Coarse-phase stall patience: exit the f32 phase after this many
    # consecutive iterations without a >=10% residual improvement. The f32
    # Armijo noise floor (~sqrt(eps_f32)-scale stationarity) sits ABOVE
    # f32_phase_tol on large trees, so the coarse phase usually ends on
    # this stall exit; every patience iteration past the first detection
    # is wasted work the high-precision phase redoes anyway (measured:
    # patience 3 -> 1 cuts ~2 no-progress f32 iterations per cold solve
    # on the headline tree at identical final accuracy).
    f32_patience: int = 3
    # Run the multistage solver's high-precision phase in df64 (two-f32
    # double-float) arithmetic instead of native f64: same Newton
    # semantics (solvers/ms_df64.py) at f32 op cost. Requires f64 data +
    # factor_dtype=float32; accuracy ~1e-14 relative (ops/df64.py).
    df64_phase: bool = False
    # Skip the dual-Hessian build + factorization when the clipping active
    # set is unchanged from the previous Newton iteration (the reference's
    # checkLastActiveSet / idxFactorStart, dual_Newton_tree.c:501-512,
    # :681-699): with clipping, W depends only on the active-set PATTERN
    # (qtilde is Qinv-or-0 and A/B are constants), so an equal pattern
    # means bitwise-equal factors — a scalar lax.cond reuses them exactly.
    # Warm MPC solves settle their active set in 1-2 iterations; the
    # remaining iterations skip the dominant per-iteration cost.
    # Multistage solver only.
    reuse_factorization: bool = True
    # Explicit-SPMD mesh axis for running the MULTISTAGE solver inside
    # jax.shard_map with chains sharded over this axis and the crown
    # replicated: cross-device traffic becomes the explicit psums of the
    # chain-root contributions / Schur complements / reduction scalars —
    # the minimal boundary bytes of the communication model — instead of
    # GSPMD's auto-partitioned collectives (parallel/shard_solver.py;
    # tests/test_hlo_audit.py documents the gap). None = single-device /
    # GSPMD path. The df64 phase is per-device-global and is bypassed
    # under an axis.
    axis_name: str | None = None
    # PROFILE>=2 analog (reference profiling.h:38-68): record per-iteration
    # residual error and line-search iteration counts into
    # info["err_hist"] / info["ls_hist"] (length max_iter, NaN/-1 padded).
    record_history: bool = False
    # Static hint set by tdunes_solve on concrete data: the stage
    # Hessians are diagonal (S = 0), so dual values may use the
    # elementwise quadratic form instead of the dense einsum. Never set this by hand on non-diagonal instances.
    h_diag: bool = False


# ---------------------------------------------------------------------------
# static (numpy) prep derived from the topology


class _Prep:
    """Precomputed static index arrays for one topology."""

    def __init__(self, topo: TreeStructure):
        self.topo = topo
        self.Nn = topo.Nn
        self.nxm, self.num = topo.nxm, topo.num
        self.K = max(topo.Kmax, 1)
        self.G = self.K * topo.nxm
        self.NpG = topo.num_groups
        self.par = topo.parent_np.copy()
        self.par[0] = 0  # safe gather for root row (masked)
        self.gnodes = topo.group_nodes
        self.kidsP = topo.kids_padded  # [NpG, K]
        self.kvalid = topo.kids_valid  # [NpG, K]
        self.gdad = topo.group_dad
        self.gslot = topo.group_slot
        self.gstage = topo.group_stage
        self.stages = [s for s in topo.groups_by_stage]
        # per-node -> position of its lambda inside its group vector
        self.slot_of_node = topo.sib_index
        self.group_of_node = topo.group_of_node

        # --- padded per-depth schedule for the scan-based tree Cholesky.
        # Stages s = Nh-1 .. 1 (groups at stage 0 = the root block, handled
        # separately). Invalid lanes point at a scratch block NpG.
        occupied = [s for s in range(len(self.stages) - 1, 0, -1)
                    if len(self.stages[s]) > 0]
        self.n_sweep = len(occupied)
        Wmax = max((len(self.stages[s]) for s in occupied), default=0)
        nS = self.n_sweep
        self.bwd_idx = np.full((nS, Wmax), self.NpG, dtype=np.int32)
        self.bwd_dad = np.full((nS, Wmax), self.NpG, dtype=np.int32)
        self.bwd_slot = np.zeros((nS, Wmax), dtype=np.int32)
        self.bwd_valid = np.zeros((nS, Wmax), dtype=bool)
        for r, s in enumerate(occupied):
            g = self.stages[s]
            self.bwd_idx[r, : len(g)] = g
            self.bwd_dad[r, : len(g)] = self.gdad[g]
            self.bwd_slot[r, : len(g)] = self.gslot[g]
            self.bwd_valid[r, : len(g)] = True
        # forward order = reverse
        self.fwd_idx = self.bwd_idx[::-1].copy()
        self.fwd_dad = self.bwd_dad[::-1].copy()
        self.fwd_slot = self.bwd_slot[::-1].copy()
        self.fwd_valid = self.bwd_valid[::-1].copy()


def _get_prep(topo: TreeStructure) -> _Prep:
    if not hasattr(_get_prep, "_cache"):
        _get_prep._cache = {}
    if topo not in _get_prep._cache:
        _get_prep._cache[topo] = _Prep(topo)
    return _get_prep._cache[topo]


# ---------------------------------------------------------------------------
# solver


def _masks(qp: TreeQPIn):
    dt = qp.dtype
    t = qp.topo
    return (jnp.asarray(t.x_mask, dt), jnp.asarray(t.u_mask, dt),
            jnp.asarray(t.nonroot_x_mask, dt))


def _dense_H(qp: TreeQPIn):
    """Per-node dense Hessian [[Q S'],[S R]], identity on padded dims."""
    xm, um, _ = _masks(qp)
    nxm, num = qp.topo.nxm, qp.topo.num
    H = jnp.zeros((qp.topo.Nn, nxm + num, nxm + num), qp.dtype)
    H = H.at[:, :nxm, :nxm].set(qp.Q * xm[:, :, None] * xm[:, None, :])
    H = H.at[:, nxm:, nxm:].set(qp.R * um[:, :, None] * um[:, None, :])
    Sm = qp.S * um[:, :, None] * xm[:, None, :]
    H = H.at[:, nxm:, :nxm].set(Sm)
    H = H.at[:, :nxm, nxm:].set(Sm.swapaxes(1, 2))
    zmask = jnp.concatenate([xm, um], axis=1)
    return H + jnp.eye(nxm + num, dtype=qp.dtype)[None] * (1.0 - zmask)[:, :, None]


def _batched_inverse_spd(H):
    L = jnp.linalg.cholesky(H)
    eye = jnp.broadcast_to(jnp.eye(H.shape[-1], dtype=H.dtype), H.shape)
    Linv = jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return Linv.swapaxes(1, 2) @ Linv


def _stage_data(qp: TreeQPIn, opts: TdunesOpts):
    """Per-node solver data: diag weights + inverses (clipping,
    dual_Newton_tree_clipping.c:149-184), dense H factor/inverse P = H^-1
    (unconstrained general stage QPs), or the general-constraint machinery
    (qpgen/mixed: constraint stack G, H^-1, ADMM factor)."""
    xm, um, _ = _masks(qp)
    data = {}
    if opts.stage_solver in ("clipping", "mixed"):
        Qd = jnp.diagonal(qp.Q, axis1=1, axis2=2) * xm + (1.0 - xm)
        Rd = jnp.diagonal(qp.R, axis1=1, axis2=2) * um + (1.0 - um)
        data["Qd"], data["Rd"] = Qd, Rd
        data["Qinv"], data["Rinv"] = 1.0 / Qd, 1.0 / Rd
    if opts.stage_solver == "boxqp":
        H = _dense_H(qp)
        data["H"] = H
        data["Hd"] = jnp.diagonal(H, axis1=1, axis2=2)
        data["lo"] = jnp.concatenate([qp.xmin, qp.umin], axis=1)
        data["hi"] = jnp.concatenate([qp.xmax, qp.umax], axis=1)
    elif opts.stage_solver in ("qpgen", "mixed"):
        from treeqp_tpu.solvers.ipm import _constraint_data
        H = _dense_H(qp)
        G, lo, hi, m_lo, m_hi = _constraint_data(qp)
        data["H"] = H
        data["Hd"] = jnp.diagonal(H, axis1=1, axis2=2)
        data["Hinv"] = _batched_inverse_spd(H)
        data["G"], data["lo"], data["hi"] = G, lo, hi
        data["m_lo"], data["m_hi"] = m_lo, m_hi
        # per-row ADMM penalty: base = Hessian scale; equality rows
        # (lo == hi) get a 1e3 stiffer penalty (OSQP convention)
        rho_base = jnp.mean(jnp.diagonal(H, axis1=1, axis2=2),
                            axis=1)[:, None]
        eq = ((jnp.where(m_hi > 0, hi, TREEQP_INF)
               - jnp.where(m_lo > 0, lo, -TREEQP_INF)) <= 1e-14).astype(qp.dtype)
        rho_row = rho_base * (1.0 + 999.0 * eq)
        data["rho_row"] = rho_row
        GtRG = (G * rho_row[:, :, None]).swapaxes(1, 2) @ G
        # ADMM factor in the qpgen factor dtype: the identification phase
        # only seeds the working set (PDAS + exact polish recompute all
        # final quantities in the data dtype), so f32 sweeps are safe
        adt = (jnp.float32 if (opts.qpgen_factor_dtype == "float32"
                               and qp.dtype == jnp.dtype(jnp.float64))
               else qp.dtype)
        data["L_admm"] = jnp.linalg.cholesky((H + GtRG).astype(adt))
        # hmod-independent products hoisted out of _qpgen_batch: computed
        # once per solve instead of once per stage solve (incl. every
        # Armijo trial evaluation) — two batched matmuls each
        data["GH"] = G @ data["Hinv"]
        data["GHG"] = data["GH"] @ G.swapaxes(1, 2)
    elif opts.stage_solver not in ("clipping",):
        H = _dense_H(qp)
        data["H"] = H
        data["P"] = _batched_inverse_spd(H)
    return data


def _modified_gradient(qp: TreeQPIn, lam, prep: _Prep, extra_q=None, extra_r=None):
    """qmod/rmod with the minus sign built in (solve_stage_problems,
    dual_Newton_tree.c:264-292): qmod = -q + lam_self - sum_kids A_c' lam_c.

    ``extra_q/extra_r`` add externally-computed -A'lam contributions (used by
    the multistage solver to inject chain-edge terms into crown nodes)."""
    xm, um, nrxm = _masks(qp)
    # packed [A B]: one einsum + one segment-sum for both contributions
    nx = qp.A.shape[-1]
    AB = jnp.concatenate([qp.A, qp.B], axis=2)
    AtBtL = jnp.einsum("nji,nj->ni", AB, lam)
    if _use_sliced_nodes(prep):
        sum_AB = _kid_sum_sliced(AtBtL, prep, _node_sliced_sched(prep))
    else:
        sum_AB = kid_sum(AtBtL, prep.topo)
    sum_A, sum_B = sum_AB[..., :nx], sum_AB[..., nx:]
    if extra_q is not None:
        sum_A = sum_A + extra_q
    if extra_r is not None:
        sum_B = sum_B + extra_r
    qmod = (-qp.q + lam - sum_A) * xm
    rmod = (-qp.r - sum_B) * um
    return qmod, rmod


def _qpgen_batch(hmod, H, Hinv, G, lo, hi, m_lo, m_hi, rho_row, L_admm,
                 opts: TdunesOpts, ws=None, GH=None, GHG=None):
    """Batched general stage QPs:  min 1/2 z'Hz - hmod'z,  lo <= G z <= hi.

    The qpOASES capability (dual_Newton_tree_qpoases.c:153-214, :401-476).
    Three phases, all batched and jit-friendly:

    1. scaled ADMM (fixed iterations, factor precomputed; per-row penalty
       with stiff equality rows, OSQP-style) — globally convergent
       active-set identification;
    2. a few primal-dual active-set refinement steps with a per-node
       keep-best safeguard (plain PDAS can 2-cycle; the safeguard keeps
       the working set with the smallest KKT residual);
    3. one exact KKT polish on the selected set, plus the elimination
       matrix  P = H^-1 - H^-1 G_A' (G_A H^-1 G_A')^-1 G_A H^-1  — the
       dense analog of qpOASES' null-space form Z (Z'HZ)^-1 Z'.

    Equality rows (lo == hi, e.g. the root's embedded x0) stay permanently
    active. Returns (z, P, mu, res, (m_up, m_dn)): mu signed (positive =
    upper active), res = max over nodes of the violation/stationarity
    guard, and the final working-set masks.

    ``ws``: optional (m_up, m_dn) working-set HOTSTART (the qpOASES
    hotstart capability, dual_Newton_tree_qpoases.c:312-356): phases 2+3
    run directly from the given set, and the ADMM identification phase
    runs only — under a lax.cond — if the hotstarted set fails the KKT
    guard. Warm Newton/MPC iterations then skip the ~qpgen_iters ADMM
    sweeps entirely.
    """
    dt = hmod.dtype
    ng = G.shape[1]
    # f32 factorization + refinement of the working-set systems (the
    # qpgen_factor_dtype option)
    factor32 = (opts.qpgen_factor_dtype == "float32"
                and dt == jnp.dtype(jnp.float64))
    fdt = jnp.float32 if factor32 else dt
    n_refine = 3 if factor32 else 1
    mask = m_lo + m_hi - m_lo * m_hi  # any finite side
    lo_c = jnp.where(m_lo > 0, lo, -TREEQP_INF)
    hi_c = jnp.where(m_hi > 0, hi, TREEQP_INF)
    m_eq = ((hi_c - lo_c <= 1e-14) & (m_lo > 0) & (m_hi > 0)).astype(dt)
    eye = jnp.eye(ng, dtype=dt)[None]
    if GH is None:
        GH = G @ Hinv                       # [n, ng, nz]
    if GHG is None:
        GHG = GH @ G.swapaxes(1, 2)         # [n, ng, ng]
    w = jnp.einsum("ngz,nz->ng", GH, hmod)  # G H^-1 hmod
    c_pd = 1.0 / jnp.maximum(jnp.diagonal(GHG, axis1=1, axis2=2), 1e-12)
    # relative working-set regularization: an absolute shift would bias the
    # active-row residuals by ~reg/scale(GHG), showing up as bound
    # complementarity error scaled by the (large, probability-weighted)
    # multipliers
    regM = 1e-13 * jnp.maximum(
        jnp.mean(jnp.diagonal(GHG, axis1=1, axis2=2), axis=1), 1e-300
    )[:, None, None]

    # ---- phase 1: scaled ADMM
    def z_update(v):
        return jax.lax.linalg.triangular_solve(
            L_admm, jax.lax.linalg.triangular_solve(
                L_admm, v[..., None], left_side=True, lower=True),
            left_side=True, lower=True, transpose_a=True)[..., 0]


    # ---- exact working-set solve + per-node KKT guard
    def polish(m_up, m_dn):
        m_act = jnp.minimum(m_up + m_dn + m_eq, 1.0)
        d_act = (m_up * hi_c + m_dn * lo_c + m_eq * lo_c) * m_act
        Mfull = (m_act[:, :, None] * GHG * m_act[:, None, :]
                 + eye * (1.0 - m_act)[:, :, None] + regM * eye)
        # refinement target WITHOUT the shift: the factor of the
        # regularized system is only a preconditioner. Refining against
        # Mfull itself leaves active rows regM*mu off their bounds — a
        # complementarity gap that is invisible to the one-sided
        # violation guard and scales with the Hessian magnitude (for
        # probability-split tree weights: linearly with the node count;
        # measured 2.1e-7 at 1109 nodes before this fix).
        Mres = (m_act[:, :, None] * GHG * m_act[:, None, :]
                + eye * (1.0 - m_act)[:, :, None])
        rhs = m_act * (w - d_act)
        # Cholesky-based solve: Mfull is SPD by construction (masked GHG +
        # identity on inactive rows + reg).
        # Under qpgen_factor_dtype=float32 the factor + triangular solves
        # run in f32; the refinement passes against the data-dtype residual
        # restore f64-quality multipliers.
        Lm = jnp.linalg.cholesky(Mfull.astype(fdt))

        def spd_solve(b):
            y = jax.lax.linalg.triangular_solve(
                Lm, b.astype(fdt)[..., None], left_side=True, lower=True)
            return jax.lax.linalg.triangular_solve(
                Lm, y, left_side=True, lower=True,
                transpose_a=True)[..., 0].astype(dt)

        mu = spd_solve(rhs)
        # refinement passes (the reg + roundoff would otherwise leave
        # active rows ~1e-10 off their bounds; 3 passes under the f32
        # factor, 1 under the native factor)
        for _ in range(n_refine):
            mu = mu + spd_solve(rhs - jnp.einsum("nij,nj->ni", Mres, mu))
        mu = m_act * mu
        z = jnp.einsum("nij,nj->ni", Hinv,
                       hmod - jnp.einsum("ngz,ng->nz", G, mu))
        t = jnp.einsum("ngz,nz->ng", G, z)
        viol = jnp.maximum(jnp.maximum(t - hi_c, lo_c - t), 0.0) * mask
        # wrong-sign working-set multipliers are also KKT violations
        bad_mu = jnp.maximum(-mu * m_up, 0.0) + jnp.maximum(mu * m_dn, 0.0)
        # active rows must SIT on their bounds (two-sided): slack there is
        # a complementarity error the one-sided viol term cannot see
        slack = jnp.abs(t - d_act) * m_act * mask
        res_node = jnp.maximum(jnp.max(viol, axis=1),
                               jnp.maximum(jnp.max(bad_mu, axis=1),
                                           jnp.max(slack, axis=1)))
        # a non-finite factor (numerically semidefinite working set in the
        # factor dtype) must register as infinitely bad, not poison the
        # keep-best safeguard downstream (ADVICE r3)
        res_node = jnp.where(jnp.isfinite(res_node), res_node, jnp.inf)
        return z, mu, t, m_act, res_node

    def pdas_from(m_up, m_dn, n_sweeps):
        # exact working-set solve + PDAS refinement with keep-best safeguard
        z, mu, t, m_act, res_node = polish(m_up, m_dn)
        best = (z, mu, t, m_act, res_node, m_up, m_dn)
        for _ in range(n_sweeps):
            m_up = ((mu + c_pd * (t - hi_c) > 0) & (m_hi > 0)).astype(dt) \
                * (1.0 - m_eq)
            m_dn = ((mu + c_pd * (t - lo_c) < 0) & (m_lo > 0)).astype(dt) \
                * (1.0 - m_eq)
            z, mu, t, m_act, res_node = polish(m_up, m_dn)
            better = (res_node < best[4])[:, None]
            best = (jnp.where(better, z, best[0]),
                    jnp.where(better, mu, best[1]),
                    jnp.where(better, t, best[2]),
                    jnp.where(better, m_act, best[3]),
                    # where(), not minimum(): a NaN res_node (singular
                    # factor) must not poison the carried best
                    jnp.where(better[:, 0], res_node, best[4]),
                    jnp.where(better, m_up, best[5]),
                    jnp.where(better, m_dn, best[6]))
        return best

    def cold_start():
        # ---- phase 1: scaled ADMM active-set identification, in the ADMM
        # factor's dtype (f32 under qpgen_factor_dtype=float32 — the phase
        # only seeds the working set, PDAS/polish recompute exactly)
        adt = L_admm.dtype
        G_a, rho_a = G.astype(adt), rho_row.astype(adt)
        lo_a, hi_a, h_a = lo_c.astype(adt), hi_c.astype(adt), hmod.astype(adt)
        z0 = jnp.einsum("nij,nj->ni", Hinv, hmod).astype(adt)
        y0 = jnp.clip(jnp.einsum("ngz,nz->ng", G_a, z0), lo_a, hi_a)

        def admm_step(_, carry):
            z, y, lm = carry
            z = z_update(h_a + jnp.einsum("ngz,ng->nz", G_a,
                                          rho_a * (y - lm)))
            t = jnp.einsum("ngz,nz->ng", G_a, z) + lm
            y = jnp.clip(t, lo_a, hi_a)
            return (z, y, t - y)

        _, _, lm = jax.lax.fori_loop(0, opts.qpgen_iters, admm_step,
                                     (z0, y0, jnp.zeros_like(y0)))
        mu_admm = rho_row * lm.astype(dt)
        # activity threshold scaled to the identification dtype's noise
        # floor (f32 ADMM multipliers carry ~1e-7*scale noise; a fixed
        # 1e-9 would classify marginal constraints from noise — ADVICE
        # r3). PDAS + exact polish recover the exact set either way.
        tol_rel = 1e-9 if adt == jnp.float64 else 1e-5
        tol_act = tol_rel * jnp.maximum(
            1.0, jnp.max(jnp.abs(mu_admm), axis=1, keepdims=True))
        m_up = ((mu_admm > tol_act) & (m_hi > 0)).astype(dt) * (1.0 - m_eq)
        m_dn = ((mu_admm < -tol_act) & (m_lo > 0)).astype(dt) * (1.0 - m_eq)
        return pdas_from(m_up, m_dn, 3)

    if ws is None:
        best = cold_start()
    else:
        # working-set hotstart: PDAS from the previous set; full ADMM
        # identification only if the hotstarted set fails the KKT guard
        warm = pdas_from(ws[0] * (1.0 - m_eq), ws[1] * (1.0 - m_eq), 2)
        ok = jnp.max(warm[4]) < 1e-9
        best = jax.lax.cond(ok, lambda: warm, cold_start)

    z, mu, t, m_act, res_node = best[0], best[1], best[2], best[3], best[4]
    ws_out = (best[5], best[6])

    # ---- phase 3: elimination matrix on the selected set
    Mfull = (m_act[:, :, None] * GHG * m_act[:, None, :]
             + eye * (1.0 - m_act)[:, :, None] + regM * eye)
    if factor32:
        # f32 inverse + two Newton-Schulz steps X <- X + X(I - M X) in the
        # data dtype: each step squares the inverse residual (f32 gives
        # ~kappa*1e-7, two steps land below f64 roundoff for the
        # well-equilibrated working-set systems), and the matmul-shaped
        # refinement replaces a data-dtype Cholesky+trsm
        Minv = _batched_inverse_spd(Mfull.astype(jnp.float32)).astype(dt)
        eyeb = jnp.broadcast_to(eye, Mfull.shape)
        for _ in range(2):
            Minv = Minv + Minv @ (eyeb - Mfull @ Minv)
        Minv = 0.5 * (Minv + Minv.swapaxes(1, 2))
        # guard: Newton-Schulz diverges when kappa(Mfull) ~ 1/eps_f32
        # (near-dependent active rows) and a corrupted P is invisible to
        # the z/mu KKT guard (ADVICE r3). Check the inverse residual and
        # fall back to the data-dtype inverse when it exceeds threshold.
        ns_res = jnp.max(jnp.abs(eyeb - Mfull @ Minv))
        Minv = jax.lax.cond(
            jnp.isfinite(ns_res) & (ns_res < 1e-6),
            lambda: Minv, lambda: _batched_inverse_spd(Mfull))
    else:
        Minv = _batched_inverse_spd(Mfull)
    HG_act = Hinv @ G.swapaxes(1, 2) * m_act[:, None, :]   # [n, nz, ng]
    P = Hinv - HG_act @ Minv @ HG_act.swapaxes(1, 2)

    stat = (jnp.einsum("nij,nj->ni", H, z) - hmod
            + jnp.einsum("ngz,ng->nz", G, mu))
    res = jnp.maximum(jnp.max(res_node), jnp.max(jnp.abs(stat)))
    return z, P, mu, res, ws_out


def _stage_solve(qp: TreeQPIn, lam, data, opts: TdunesOpts, prep: _Prep,
                 extra_q=None, extra_r=None, inner_ws=None):
    """Batched stage-QP solve over all nodes.

    clipping (dual_Newton_tree_clipping.c:188-227): closed-form
    x = clip(Qinv qmod), with active-set-masked inverses qtilde/rtilde.
    dense (unconstrained): z = P hmod.
    ``inner_ws``: qpgen working-set hotstart (dual_Newton_tree_qpoases.c
    :312-356) — previous (m_up, m_dn) masks; the solution carries the new
    set in sol["qpgen_ws"].
    Returns the solution plus whatever the Hessian build needs.
    """
    xm, um, _ = _masks(qp)
    qmod, rmod = _modified_gradient(qp, lam, prep, extra_q, extra_r)
    sol = dict(qmod=qmod, rmod=rmod)
    if opts.stage_solver == "clipping":
        xUnc = data["Qinv"] * qmod
        uUnc = data["Rinv"] * rmod
        x = jnp.clip(xUnc, qp.xmin, qp.xmax) * xm
        u = jnp.clip(uUnc, qp.umin, qp.umax) * um
        x_active = (xUnc > qp.xmax) | (xUnc < qp.xmin)
        u_active = (uUnc > qp.umax) | (uUnc < qp.umin)
        sol.update(
            x=x, u=u, xUnc=xUnc, uUnc=uUnc,
            qtilde=jnp.where(x_active, 0.0, data["Qinv"]),
            rtilde=jnp.where(u_active, 0.0, data["Rinv"]),
        )
    elif opts.stage_solver == "boxqp":
        # general dense stage QPs with bounds (the qpOASES capability class,
        # dual_Newton_tree_qpoases.c) as batched projected Newton: iterate
        # free-set Newton solves with clipping; finitely convergent for
        # strictly convex box QPs. Returns the null-space elimination matrix
        # P = Z (Z'HZ)^-1 Z' (zero rows/cols on the active set), matching
        # QProblem_build_elimination_matrix (:153-214) semantics.
        nxm = prep.nxm
        H, lo, hi = data["H"], data["lo"], data["hi"]
        hmod = jnp.concatenate([qmod, rmod], axis=1)  # minus sign built in
        nz = hmod.shape[1]
        eyez = jnp.eye(nz, dtype=hmod.dtype)
        z = jnp.clip(hmod / data["Hd"], lo, hi)

        def pn_step(_, z):
            g = jnp.einsum("nij,nj->ni", H, z) - hmod
            at_lo = (z <= lo + 1e-12) & (g > 0)
            at_hi = (z >= hi - 1e-12) & (g < 0)
            free = ~(at_lo | at_hi)
            fm = free.astype(hmod.dtype)
            M = H * fm[:, :, None] * fm[:, None, :] + \
                eyez[None] * (1.0 - fm)[:, :, None]
            L = jnp.linalg.cholesky(M)
            d = jax.lax.linalg.triangular_solve(
                L, (-g * fm)[..., None], left_side=True, lower=True)
            d = jax.lax.linalg.triangular_solve(
                L, d, left_side=True, lower=True, transpose_a=True)[..., 0]
            return jnp.clip(z + d, lo, hi)

        z = jax.lax.fori_loop(0, opts.boxqp_iters, pn_step, z)
        # final active set, multipliers, elimination matrix
        g = jnp.einsum("nij,nj->ni", H, z) - hmod
        at_lo = (z <= lo + 1e-12) & (g > 0)
        at_hi = (z >= hi - 1e-12) & (g < 0)
        free = ~(at_lo | at_hi)
        fm = free.astype(hmod.dtype)
        # convergence guard: the projected-Newton loop runs a fixed
        # boxqp_iters; a hard active set can leave the free-set gradient
        # nonzero, silently degrading the stage solution and the
        # elimination matrix P. Expose the max free-gradient residual so
        # the caller can flag / the user can raise boxqp_iters.
        sol["boxqp_res"] = jnp.max(jnp.abs(g * fm))
        mu = -g * (1.0 - fm)  # hmod - Hz on the active set, signed
        M = H * fm[:, :, None] * fm[:, None, :] + \
            eyez[None] * (1.0 - fm)[:, :, None]
        L = jnp.linalg.cholesky(M)
        eyeb = jnp.broadcast_to(eyez, M.shape)
        Linv = jax.lax.linalg.triangular_solve(L, eyeb, left_side=True, lower=True)
        P = (Linv.swapaxes(1, 2) @ Linv) * fm[:, :, None] * fm[:, None, :]
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um, P=P,
                   mu=mu, free=fm)
    elif opts.stage_solver == "qpgen":
        nxm, nz = prep.nxm, prep.nxm + prep.num
        hmod = jnp.concatenate([qmod, rmod], axis=1)
        z, P, mu, res, ws_out = _qpgen_batch(
            hmod, data["H"], data["Hinv"], data["G"], data["lo"], data["hi"],
            data["m_lo"], data["m_hi"], data["rho_row"], data["L_admm"],
            opts, ws=inner_ws, GH=data["GH"], GHG=data["GHG"])
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um, P=P,
                   mu_x=mu[:, :nxm], mu_u=mu[:, nxm:nz], mu_d=mu[:, nz:],
                   qpgen_res=res, qpgen_ws=ws_out)
    elif opts.stage_solver == "mixed":
        # per-node solver dispatch (reference vtable dual_Newton_tree.c:
        # 124-162): clipping closed-form on applicable nodes, qpgen on the
        # rest; both feed the unified dense-P Hessian build.
        assert opts.node_solver is not None, \
            "stage_solver='mixed' needs opts.node_solver (use tdunes_solve)"
        nxm, nz = prep.nxm, prep.nxm + prep.num
        ns = np.asarray(opts.node_solver, dtype=np.int64)
        gen_idx = np.nonzero(ns == 0)[0].astype(np.int32)
        # clipping closed-form everywhere (general nodes overwritten below)
        xUnc = data["Qinv"] * qmod
        uUnc = data["Rinv"] * rmod
        x = jnp.clip(xUnc, qp.xmin, qp.xmax) * xm
        u = jnp.clip(uUnc, qp.umin, qp.umax) * um
        qtilde = jnp.where((xUnc > qp.xmax) | (xUnc < qp.xmin), 0.0,
                           data["Qinv"])
        rtilde = jnp.where((uUnc > qp.umax) | (uUnc < qp.umin), 0.0,
                           data["Rinv"])
        # diagonal elimination matrix for clipping nodes
        diagP = jnp.concatenate([qtilde * xm, rtilde * um], axis=1)
        P = jnp.eye(nz, dtype=qp.dtype)[None] * diagP[:, None, :]
        mu_x = data["Qd"] * (xUnc - x) * xm
        mu_u = data["Rd"] * (uUnc - u) * um
        mu_d = jnp.zeros((prep.Nn, data["G"].shape[1] - nz), qp.dtype)
        res = jnp.zeros((), qp.dtype)
        if len(gen_idx) > 0:
            hmod_g = jnp.concatenate([qmod[gen_idx], rmod[gen_idx]], axis=1)
            z_g, P_g, mu_g, res, ws_out = _qpgen_batch(
                hmod_g, data["H"][gen_idx], data["Hinv"][gen_idx],
                data["G"][gen_idx], data["lo"][gen_idx], data["hi"][gen_idx],
                data["m_lo"][gen_idx], data["m_hi"][gen_idx],
                data["rho_row"][gen_idx], data["L_admm"][gen_idx], opts,
                ws=inner_ws, GH=data["GH"][gen_idx], GHG=data["GHG"][gen_idx])
            sol["qpgen_ws"] = ws_out
            x = x.at[gen_idx].set(z_g[:, :nxm] * xm[gen_idx])
            u = u.at[gen_idx].set(z_g[:, nxm:] * um[gen_idx])
            P = P.at[gen_idx].set(P_g)
            mu_x = mu_x.at[gen_idx].set(mu_g[:, :nxm])
            mu_u = mu_u.at[gen_idx].set(mu_g[:, nxm:nz])
            mu_d = mu_d.at[gen_idx].set(mu_g[:, nz:])
        sol.update(x=x, u=u, P=P, mu_x=mu_x, mu_u=mu_u, mu_d=mu_d,
                   qpgen_res=res)
    else:
        nxm = prep.nxm
        hmod = jnp.concatenate([qmod, rmod], axis=1)
        z = jnp.einsum("nij,nj->ni", data["P"], hmod)
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um)
    return sol


def _dual_residual(qp: TreeQPIn, sol, prep: _Prep, AT=None, BT=None):
    """Dual gradient res_c = A_c x_p + B_c u_p + b_c - x_c (non-root)
    (build_dual_problem, dual_Newton_tree.c:519-539).

    ``AT``/``BT`` are pre-transposed A/B (swapaxes(1, 2)), so the
    contraction runs over the minor axis."""
    _, _, nrxm = _masks(qp)
    if AT is None:
        AT, BT = qp.A.swapaxes(1, 2), qp.B.swapaxes(1, 2)
    ABT = jnp.concatenate([AT, BT], axis=1)  # stacked [A'; B'], hoisted
    if _use_sliced_nodes(prep):
        zn = jnp.concatenate([sol["x"], sol["u"]], axis=1)
        zp = _par_gather_sliced(zn, prep, _node_sliced_sched(prep))
    else:
        zp = jnp.concatenate([sol["x"][prep.par], sol["u"][prep.par]], axis=1)
    res = (jnp.einsum("nji,nj->ni", ABT, zp) + qp.b - sol["x"]) * nrxm
    return res


def _residual_error(res, opts: TdunesOpts):
    if opts.termination == "infnorm":
        return jnp.max(jnp.abs(res))
    sq = jnp.sum(res * res)
    return jnp.sqrt(sq) if opts.termination == "twonorm" else sq


def _dual_value(qp: TreeQPIn, lam, sol, data, opts: TdunesOpts):
    """f(lambda) = -g(lambda), the quantity the reference minimizes
    (stage_qp_clipping_eval_dual_term, dual_Newton_tree_clipping.c:359-382):
    per node -1/2 x'Qx + qmod'x - 1/2 u'Ru + rmod'u, minus sum_c b_c'lam_c."""
    x, u = sol["x"], sol["u"]
    if opts.stage_solver == "clipping":
        # fused per-element terms -> ONE reduction per array family (the
        # naive 5-reduction form costs 5 kernel launches per dual value,
        # and dual values run 2-5x per Newton iteration via the LS)
        tx = x * (sol["qmod"] - 0.5 * data["Qd"] * x) - qp.b * lam
        tu = u * (sol["rmod"] - 0.5 * data["Rd"] * u)
        return jnp.sum(tx) + jnp.sum(tu)
    z = jnp.concatenate([x, u], axis=1)
    if opts.h_diag and "Hd" in data:
        # diagonal Hessians (all benchmark families): the elementwise
        # form replaces a batched dense matvec per LS trial
        quad = jnp.sum(z * data["Hd"] * z)
    else:
        quad = jnp.sum(z * jnp.einsum("nij,nj->ni", data["H"], z))
    lin = jnp.sum(sol["qmod"] * x) + jnp.sum(sol["rmod"] * u)
    cmod = jnp.sum(qp.b * lam)  # lam rows are masked to non-root support
    return -0.5 * quad + lin - cmod


def _build_dual_hessian(qp: TreeQPIn, sol, data, opts: TdunesOpts, prep: _Prep,
                        dtype=None):
    """Assemble the lambda-group blocks W [NpG,G,G] and parent couplings
    Ut [NpG,nxm,G] of M = J P J' (build_dual_problem,
    dual_Newton_tree.c:551-615 + clipping/qpoases vtable contributions).

    With ``dtype=float32`` the blocks are built directly in f32 — they feed
    only the (f32) factorization on the mixed-precision path; the exact
    Hessian action for refinement is applied separately in f64."""
    dt = dtype if dtype is not None else qp.dtype
    K, G, nxm, NpG = prep.K, prep.G, prep.nxm, prep.NpG
    kidsP, kvalid = prep.kidsP, prep.kvalid
    kv = jnp.asarray(kvalid, dt)
    Ak = qp.A.astype(dt)[kidsP] * kv[:, :, None, None]  # [NpG,K,nxm,nxm]
    Bk = qp.B.astype(dt)[kidsP] * kv[:, :, None, None]  # [NpG,K,nxm,num]
    # per-iteration gathers become static slices / sliced one-hot stacks
    # on BFS topologies when the sliced schedule is switched on (the A/B
    # gathers above are loop-INVARIANT and are hoisted by XLA;
    # sol-dependent gathers below are not). Under GSPMD-auto on CPU meshes
    # the dynamic-slice form degrades the partitioner's placement
    # (headline audit 5.8 -> 17 MB/iter), so it shares the switch of the
    # sliced Cholesky.
    sliced = _use_sliced_nodes(prep)
    sched_n = _node_sliced_sched(prep) if sliced else None
    g0s, g_contig = _gnodes_slice(prep)
    g_contig = g_contig and sliced

    def parent_rows(v):
        vv = v.astype(dt)
        return vv[g0s:g0s + NpG] if g_contig else vv[prep.gnodes]

    if opts.stage_solver == "clipping":
        qtp = parent_rows(sol["qtilde"])  # [NpG, nxm] parent's masked inverse
        rtp = parent_rows(sol["rtilde"])
        As = Ak * jnp.sqrt(qtp)[:, None, None, :]
        Bs = Bk * jnp.sqrt(rtp)[:, None, None, :]
        Af = As.reshape(NpG, G, nxm)
        Bf = Bs.reshape(NpG, G, prep.num)
        W = Af @ Af.swapaxes(1, 2) + Bf @ Bf.swapaxes(1, 2)
        # + E P_c E' on the diagonal (add_EPmE): child's own qtilde
        if sliced:
            qt_k = _kid_slot_stack_sl(sol["qtilde"].astype(dt), prep, sched_n)
            dvals = (qt_k.transpose(1, 0, 2).reshape(NpG, G)
                     + (1.0 - kv[:, :, None]
                        * jnp.ones((1, 1, nxm), dt)).reshape(NpG, G))
        else:
            dvals = jnp.where(kv[:, :, None] > 0,
                              sol["qtilde"].astype(dt)[kidsP],
                              jnp.ones((), dt)).reshape(NpG, G)
        W = W + jnp.zeros((NpG, G, G), dt).at[
            :, jnp.arange(G), jnp.arange(G)].set(dvals)
        # Ut (coupling of group g to its parent's lambda): -qtilde_p * A_k'
        Ut = -(qtp[:, :, None]) * Ak.transpose(0, 3, 1, 2).reshape(NpG, nxm, G)
    else:
        nzm = nxm + prep.num
        Pmat = (sol["P"] if "P" in sol else data["P"]).astype(dt)
        Pp = (Pmat[g0s:g0s + NpG] if g_contig else Pmat[prep.gnodes])
        Cf = jnp.concatenate([Ak, Bk], axis=-1).reshape(NpG, G, nzm)
        W = Cf @ Pp @ Cf.swapaxes(1, 2)
        Px = Pmat[:, :nxm, :nxm]  # E P E' per node
        eye = jnp.eye(nxm, dtype=dt)
        if sliced:
            Px_k = _kid_slot_stack_sl(Px.reshape(Px.shape[0], nxm * nxm),
                                      prep, sched_n)
            for k in range(K):
                blk = (Px_k[k].reshape(NpG, nxm, nxm)
                       + (1.0 - kv[:, k, None, None]) * eye[None])
                W = W.at[:, k * nxm:(k + 1) * nxm,
                         k * nxm:(k + 1) * nxm].add(blk)
        else:
            for k in range(K):
                blk = jnp.where(kv[:, k, None, None] > 0, Px[kidsP[:, k]],
                                eye[None])
                W = W.at[:, k * nxm:(k + 1) * nxm,
                         k * nxm:(k + 1) * nxm].add(blk)
        Ut = -(Pp[:, :nxm, :] @ Cf.swapaxes(1, 2))
    return W, Ut


def _reg_cholesky(W, opts: TdunesOpts):
    """Regularized Cholesky (treeqp_dpotrf_l_with_reg_opts,
    dual_Newton_common.c:35-123): NO / ALWAYS-LM / ON-THE-FLY-LM.

    The on-the-fly path escalates the Levenberg-Marquardt shift (x1, x1e3,
    x1e6) until the factorization succeeds — degenerate active sets can push
    Schur complements below -reg_value, which the reference's single retry
    would turn into NaNs that poison the whole Newton direction."""
    if opts.reg_type == "none":
        return jnp.linalg.cholesky(W)
    eye = jnp.eye(W.shape[-1], dtype=W.dtype)
    if opts.reg_type == "always":
        return jnp.linalg.cholesky(W + opts.reg_value * eye)

    def is_bad(L):
        diag = jnp.diagonal(L, axis1=-2, axis2=-1)
        return jnp.any(~jnp.isfinite(L), axis=(-2, -1)) | \
            jnp.any(diag <= opts.reg_tol, axis=-1)

    L = jnp.linalg.cholesky(W)
    for scale in (1.0, 1e3, 1e6):
        Lr = jnp.linalg.cholesky(W + scale * opts.reg_value * eye)
        L = jnp.where(is_bad(L)[..., None, None], Lr, L)
    return L


def _tri_solve(L, b, trans=False):
    """Solve L y = b (or L' y = b) for batched lower-triangular L; b [..., G]."""
    y = jax.lax.linalg.triangular_solve(
        L, b[..., None], left_side=True, lower=True, transpose_a=trans)
    return y[..., 0]


def _tree_chol_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """Tree-structured block Cholesky factorization, level-synchronous over
    depths (backward half of calculate_delta_lambda,
    dual_Newton_tree.c:668-735): for parent stages Nh-1..1, batched over the
    depth's groups: factor W, trsm the parent coupling, syrk-update the
    parent diagonal block. Returns stored factors for repeated solves.
    """
    if opts.factor_dtype == "float32":
        W, Ut = W.astype(jnp.float32), Ut.astype(jnp.float32)
    if _use_sliced_chol(prep):
        if opts.reg_type in ("always", "none"):
            split = _split_sched(prep)
            if split is not None:
                return _tree_chol_factor_split(W, Ut, opts, prep, split)
        return _tree_chol_factor_sliced(W, Ut, opts, prep,
                                        _sliced_sched(prep))
    dt = W.dtype
    nxm, G, NpG = prep.nxm, prep.G, prep.NpG
    ar = jnp.arange(nxm)

    # extended arrays with a scratch block at index NpG: invalid (padding)
    # lanes of a depth read/write only the scratch block, so garbage never
    # leaks into real blocks.
    Wx = jnp.concatenate([W, jnp.eye(G, dtype=dt)[None]], axis=0)
    Utx = jnp.concatenate([Ut, jnp.zeros((1, nxm, G), dt)], axis=0)
    CholW = jnp.zeros((NpG + 1, G, G), dt)
    CholUt = jnp.zeros((NpG + 1, nxm, G), dt)

    if prep.n_sweep > 0:
        bwd_xs = (jnp.asarray(prep.bwd_idx), jnp.asarray(prep.bwd_dad),
                  jnp.asarray(prep.bwd_slot), jnp.asarray(prep.bwd_valid))
        lanes = jnp.arange(prep.bwd_idx.shape[1], dtype=jnp.int32)

        def bwd(carry, xs):
            Wx, CholW, CholUt = carry
            idx, dad, slot, valid = xs
            Lb = _reg_cholesky(Wx[idx], opts)
            # CholUt solves X L' = Ut  (trsm_rltn)
            CUb = jax.lax.linalg.triangular_solve(
                Lb, Utx[idx], left_side=False, lower=True, transpose_a=True)
            Sb = CUb @ CUb.swapaxes(1, 2)  # [b, nxm, nxm]
            # siblings own distinct slots of their parent's block; padding
            # lanes point past the end (dropped): unique targets, so the
            # GPU scatter adds in no run-dependent order
            tgt = jnp.where(valid, dad, NpG + 1 + lanes)
            rows = slot[:, None] * nxm + ar[None, :]  # [b, nxm]
            Wx = Wx.at[tgt[:, None, None], rows[:, :, None],
                       rows[:, None, :]].add(-Sb, mode="drop",
                                             unique_indices=True)
            st = jnp.where(valid, idx, NpG)
            CholW = CholW.at[st].set(Lb)
            CholUt = CholUt.at[st].set(CUb)
            return (Wx, CholW, CholUt), None

        (Wx, CholW, CholUt), _ = jax.lax.scan(bwd, (Wx, CholW, CholUt), bwd_xs)

    L0 = _reg_cholesky(Wx[0], opts)
    CholW = CholW.at[0].set(L0)
    return dict(CholW=CholW, CholUt=CholUt)


def _tree_chol_solve(fact, rg, opts: TdunesOpts, prep: _Prep):
    """Solve M dlam = rg with stored tree Cholesky factors: backward RHS
    sweep, root solve, forward substitution (dual_Newton_tree.c:745-775)."""
    out_dt = rg.dtype
    if fact.get("kind") == "split":
        return _tree_chol_solve_split(fact, rg, opts, prep,
                                      _split_sched(prep))
    if fact.get("kind") == "sliced":
        return _tree_chol_solve_sliced(fact, rg, opts, prep,
                                       _sliced_sched(prep))
    CholW, CholUt = fact["CholW"], fact["CholUt"]
    rg = rg.astype(CholW.dtype)
    nxm, NpG, G = prep.nxm, prep.NpG, prep.G
    ar = jnp.arange(nxm)
    dt = rg.dtype
    rx = jnp.concatenate([rg, jnp.zeros((1, G), dt)], axis=0)
    ybar = jnp.zeros((NpG + 1, G), dt)

    if prep.n_sweep > 0:
        bwd_xs = (jnp.asarray(prep.bwd_idx), jnp.asarray(prep.bwd_dad),
                  jnp.asarray(prep.bwd_slot), jnp.asarray(prep.bwd_valid))
        lanes = jnp.arange(prep.bwd_idx.shape[1], dtype=jnp.int32)

        def bwd(carry, xs):
            rx, ybar = carry
            idx, dad, slot, valid = xs
            yb = _tri_solve(CholW[idx], rx[idx])
            rv = jnp.einsum("big,bg->bi", CholUt[idx], yb)
            tgt = jnp.where(valid, dad, NpG + 1 + lanes)  # as in the factor
            rows = slot[:, None] * nxm + ar[None, :]
            rx = rx.at[tgt[:, None], rows].add(-rv, mode="drop",
                                               unique_indices=True)
            ybar = ybar.at[jnp.where(valid, idx, NpG)].set(yb)
            return (rx, ybar), None

        (rx, ybar), _ = jax.lax.scan(bwd, (rx, ybar), bwd_xs)

    y0 = _tri_solve(CholW[0], rx[0])
    dl0 = _tri_solve(CholW[0], y0, trans=True)
    dlam_x = jnp.zeros((NpG + 1, G), dt).at[0].set(dl0)

    if prep.n_sweep > 0:
        fwd_xs = (jnp.asarray(prep.fwd_idx), jnp.asarray(prep.fwd_dad),
                  jnp.asarray(prep.fwd_slot), jnp.asarray(prep.fwd_valid))

        def fwd(dlam_x, xs):
            idx, dad, slot, valid = xs
            rows = slot[:, None] * nxm + ar[None, :]
            dp = dlam_x[dad[:, None], rows]  # parent's dlam slice [b, nxm]
            d = ybar[idx] - jnp.einsum("big,bi->bg", CholUt[idx], dp)
            dl = _tri_solve(CholW[idx], d, trans=True)
            return dlam_x.at[jnp.where(valid, idx, NpG)].set(dl), None

        dlam_x, _ = jax.lax.scan(fwd, dlam_x, fwd_xs)
    return dlam_x[:NpG].astype(out_dt)


def _split_sched(prep: _Prep):
    """Multistage split of the sliced level schedule (round 5): the deep
    levels of a scenario tree are CHAINS (every group has exactly one kid
    at slot 0, constant width S, identity scenario alignment level to
    level) — their blocks are [nxm, nxm] inside the uniform [G, G]
    layout, so factoring them through the generic per-level sweep wastes
    K^2x flops AND runs XLA batched Cholesky per level. This schedule
    routes them through the banded chain sweeps of the multistage solver
    (tdunes_multistage._chain_factor) and leaves only the small crown to
    the per-level sliced sweep.

    Returns (chain_levels, crown_levels) — both in the sliced-schedule
    format, chain deepest-first ending with the boundary level (whose
    dads are crown groups) — or None when the tree is not
    multistage-shaped. Match: the crown+chains decomposition of
    setup_multistage_tree trees (tree.c:247-280)."""
    cached = getattr(prep, "_split_sched_cache", "miss")
    if cached != "miss":
        return cached
    sched = _sliced_sched(prep)
    out = None
    if sched is not None and len(sched) >= 4:
        kvalid = np.asarray(prep.kvalid).astype(bool)
        S = sched[0][1]
        eyeS = np.eye(S, dtype=np.float32)
        chain = []
        i = 0
        while i < len(sched):
            c0, w, p0, wp, U = sched[i]
            kv = kvalid[c0:c0 + w]
            if w != S or not ((kv.sum(1) == 1).all() and kv[:, 0].all()):
                break
            if wp == S:
                if not (np.array_equal(U[0], eyeS) and not U[1:].any()):
                    break
                chain.append(sched[i])
                i += 1
            else:
                chain.append(sched[i])  # boundary level: dads in the crown
                i += 1
                break
        if (len(chain) >= 3 and chain[-1][3] < S and i < len(sched)):
            out = (chain, sched[i:])
    prep._split_sched_cache = out
    return out


def _tree_chol_factor_split(W, Ut, opts: TdunesOpts, prep: _Prep, split):
    """Chain part through the lane-batched banded factorization, crown
    part through the sliced per-level sweep (see _split_sched)."""
    from treeqp_tpu.solvers import tdunes_multistage as tm
    chain_levels, crown_levels = split
    S = chain_levels[0][1]
    nxm, G, K = prep.nxm, prep.G, prep.K
    dt = W.dtype
    # ms chain layout: j = 0 is the SHALLOWEST chain level (boundary)
    Wc = jnp.stack([W[c0:c0 + S, :nxm, :nxm]
                    for c0, w, p0, wp, U in reversed(chain_levels)], axis=1)
    Utc = jnp.stack([Ut[c0:c0 + S, :, :nxm]
                     for c0, w, p0, wp, U in reversed(chain_levels)], axis=1)
    if opts.reg_type == "always":
        # the chain backends apply no LM shift themselves; pre-add it
        Wc = Wc + opts.reg_value * jnp.eye(nxm, dtype=dt)
    nreg = dataclasses.replace(opts, reg_type="none")
    Ls, CUs, schur0 = tm._chain_factor(Wc, Utc, nreg)
    # boundary: the chain-root Schur flows into the crown groups at each
    # scenario's (slot, slot) block
    c0b, wb, p0b, wpb, Ub = chain_levels[-1]
    Um = jnp.asarray(Ub.reshape(K * wpb, S), dt)
    upds = (Um @ schur0.astype(dt).reshape(S, nxm * nxm)
            ).reshape(K, wpb, nxm, nxm)
    zero = jnp.zeros((wpb, nxm, nxm), dt)
    rows = [jnp.concatenate([upds[s] if t == s else zero
                             for t in range(K)], axis=2)
            for s in range(K)]
    W = W.at[p0b:p0b + wpb].add(-jnp.concatenate(rows, axis=1))
    crown_fact = _tree_chol_factor_sliced(W, Ut, opts, prep, crown_levels)
    return dict(kind="split", Ls=Ls, CUs=CUs,
                CholW=crown_fact["CholW"], CholUt=crown_fact["CholUt"])


def _tree_chol_solve_split(fact, rg, opts: TdunesOpts, prep: _Prep, split):
    """Solve with _tree_chol_factor_split factors: chain backward sweep
    (one launch), boundary injection, sliced crown solve, chain forward."""
    from treeqp_tpu.solvers import tdunes_multistage as tm
    chain_levels, crown_levels = split
    S = chain_levels[0][1]
    nxm, G, K = prep.nxm, prep.G, prep.K
    out_dt = rg.dtype
    fdt = fact["CholW"].dtype
    rd = rg.astype(fdt)
    rch = jnp.stack([rd[c0:c0 + S, :nxm]
                     for c0, w, p0, wp, U in reversed(chain_levels)], axis=1)
    ys, radd0 = tm._chain_solve_bwd(fact["Ls"], fact["CUs"], rch)
    c0b, wb, p0b, wpb, Ub = chain_levels[-1]
    Um = jnp.asarray(Ub.reshape(K * wpb, S), fdt)
    radd = (Um @ radd0.astype(fdt)).reshape(K, wpb, nxm)
    rd = rd.at[p0b:p0b + wpb].add(
        -radd.transpose(1, 0, 2).reshape(wpb, G))
    dl = _tree_chol_solve_sliced(
        dict(CholW=fact["CholW"], CholUt=fact["CholUt"]), rd, opts, prep,
        crown_levels)
    dl = dl.astype(fdt)
    # chain roots read their dad's dlam rows (slot placement via Ub)
    dpar = dl[p0b:p0b + wpb].reshape(wpb, K, nxm).transpose(1, 0, 2)
    Ut_s = jnp.asarray(Ub.transpose(0, 2, 1), fdt)          # [K, S, wp]
    droot = jnp.einsum("ksp,kpi->si", Ut_s, dpar)           # [S, nxm]
    dls = tm._chain_forward(fact["Ls"], fact["CUs"], ys, droot)
    for j, (c0, w, p0, wp, U) in enumerate(reversed(chain_levels)):
        dl = dl.at[c0:c0 + S, :nxm].set(dls[:, j])
    return dl.astype(out_dt)


def _use_sliced_chol(prep: _Prep) -> bool:
    """Scatter-free sliced tree Cholesky, off unless TREEQP_SLICED_CHOL=1
    (parity tests; whether it pays under plain XLA is not measured)."""
    import os
    return (os.environ.get("TREEQP_SLICED_CHOL") == "1"
            and _sliced_sched(prep) is not None)


def _sliced_sched(prep: _Prep):
    """Per-level static-slice schedule for the scatter-free tree Cholesky
    (round 5): each backward level becomes a static slice of the group
    arrays plus a small one-hot child->parent slot matrix, so the whole
    sweep is dynamic-slice updates + small matmuls — no `.at[idx].add`
    scatters. Applicable when every occupied stage's group ids form a
    contiguous range (BFS-ordered topologies: multistage trees and the
    reference's random trees). Returns a list of per-level tuples
    (c0, w, p0, wp, U[K, wp, w]) deepest-first, or None."""
    cached = getattr(prep, "_sliced_sched_cache", "miss")
    if cached != "miss":
        return cached
    K, nxm = prep.K, prep.nxm
    stages = prep.stages
    occupied = [s for s in range(len(stages) - 1, 0, -1) if len(stages[s]) > 0]
    sched = []
    ok = True
    for s in occupied:
        g = np.asarray(stages[s])
        gp = np.asarray(stages[s - 1]) if len(stages[s - 1]) else None
        if gp is None or np.any(np.diff(g) != 1) or np.any(np.diff(gp) != 1):
            ok = False
            break
        c0, w = int(g[0]), len(g)
        p0, wp = int(gp[0]), len(gp)
        dads = prep.gdad[g]
        if np.any((dads < p0) | (dads >= p0 + wp)):
            ok = False
            break
        U = np.zeros((K, wp, w), np.float32)
        U[prep.gslot[g], dads - p0, np.arange(w)] = 1.0
        sched.append((c0, w, p0, wp, U))
    if not ok or (len(stages[0]) != 1 or stages[0][0] != 0):
        sched = None
    prep._sliced_sched_cache = sched
    return sched


def _node_sliced_sched(prep: _Prep):
    """Per-level node<->group schedule (round 5): for each occupied group
    stage, (g0, wg, np0, n0, wn, V[K, wg, wn]) where groups g0..g0+wg sit
    on parent nodes np0..np0+wg and their kids are nodes n0..n0+wn;
    V[s][g-g0, n-n0] = 1 iff node n is kid slot s of group g. Per-slot V
    matrices have <= 1 nonzero per row AND per column, so f64 operands can
    ride exact hi/lo f32 matmuls. Requires
    level-contiguous group ids, parent-node ids and kid-node ids (BFS
    topologies). None if not applicable."""
    cached = getattr(prep, "_node_sliced_cache", "miss")
    if cached != "miss":
        return cached
    K = prep.K
    stages = prep.stages
    kidsP = np.asarray(prep.kidsP)
    kvalid = np.asarray(prep.kvalid).astype(bool)
    gnodes = np.asarray(prep.gnodes)
    sched = []
    ok = True
    for s in range(len(stages)):
        g = np.asarray(stages[s])
        if len(g) == 0:
            continue
        if np.any(np.diff(g) != 1):
            ok = False
            break
        g0, wg = int(g[0]), len(g)
        pn = gnodes[g]
        kids = kidsP[g][kvalid[g]]
        if (len(kids) == 0 or np.any(np.diff(pn) != 1)
                or kids.min() + len(kids) - 1 != kids.max()
                or len(np.unique(kids)) != len(kids)):
            ok = False
            break
        n0, wn = int(kids.min()), len(kids)
        V = np.zeros((K, wg, wn), np.float32)
        for gl in range(wg):
            for sl in range(K):
                if kvalid[g0 + gl, sl]:
                    V[sl, gl, kidsP[g0 + gl, sl] - n0] = 1.0
        sched.append((g0, wg, int(pn[0]), n0, wn, V))
    if not ok:
        sched = None
    prep._node_sliced_cache = sched
    return sched


def _hilo_mm(M32, v):
    """Exact one-summand matmul for f64 operands via hi/lo f32 split
    (each output element receives <= 1 summand through M32, a 0/1 matrix
    with <= 1 nonzero per row); plain matmul for f32."""
    M = jnp.asarray(M32)
    if v.dtype == jnp.float64:
        hi = v.astype(jnp.float32)
        lo = (v - hi.astype(jnp.float64)).astype(jnp.float32)
        return (M @ hi).astype(jnp.float64) + (M @ lo).astype(jnp.float64)
    return (M @ v.astype(M.dtype)).astype(v.dtype)


def _kid_sum_sliced(v, prep: _Prep, sched_n):
    """Segment-sum replacement: out[p] = sum_{kids c of p} v[c], zeros on
    leaves — static slices + per-slot one-hot matmuls (no scatters)."""
    out = jnp.zeros_like(v)
    for g0, wg, np0, n0, wn, V in sched_n:
        vb = v[n0:n0 + wn]
        acc = _hilo_mm(V[0], vb)
        for s in range(1, V.shape[0]):
            acc = acc + _hilo_mm(V[s], vb)
        out = out.at[np0:np0 + wg].set(acc)
    return out


def _par_gather_sliced(v, prep: _Prep, sched_n):
    """Parent-gather replacement: out[c] = v[par(c)] for non-root rows
    (root row zero — callers mask with nrxm)."""
    out = jnp.zeros_like(v)
    for g0, wg, np0, n0, wn, V in sched_n:
        vb = v[np0:np0 + wg]
        acc = _hilo_mm(V[0].T, vb)
        for s in range(1, V.shape[0]):
            acc = acc + _hilo_mm(V[s].T, vb)
        out = out.at[n0:n0 + wn].set(acc)
    return out


def _kid_slot_stack_sl(v_n, prep: _Prep, sched_n):
    """Per-slot grouped kid stacks [K, NpG, r] of node rows [Nn, r]
    (the `v[kidsP[:, k]]` gather family), sliced; invalid slots zero."""
    K = prep.K
    r = v_n.shape[1]
    out = jnp.zeros((K, prep.NpG, r), v_n.dtype)
    for g0, wg, np0, n0, wn, V in sched_n:
        vb = v_n[n0:n0 + wn]
        for s in range(K):
            out = out.at[s, g0:g0 + wg].set(_hilo_mm(V[s], vb))
    return out


def _gnodes_slice(prep: _Prep):
    """(start, True) when group->parent-node ids are one contiguous run
    (BFS topologies) so `v[prep.gnodes]` is a static slice."""
    cached = getattr(prep, "_gnodes_slice_cache", None)
    if cached is None:
        g = prep.gnodes
        ok = bool(len(g) and np.all(np.diff(g) == 1))
        cached = (int(g[0]) if ok else 0, ok)
        prep._gnodes_slice_cache = cached
    return cached


def _use_sliced_nodes(prep: _Prep) -> bool:
    """Sliced node<->group index ops, switched with the sliced Cholesky
    (TREEQP_SLICED_CHOL=1)."""
    import os
    return (os.environ.get("TREEQP_SLICED_CHOL") == "1"
            and _node_sliced_sched(prep) is not None)


def _nodes_to_group_sl(v_n, prep: _Prep, sched_n):
    """[Nn, nxm] node rows -> [NpG, G] grouped kid stacks, sliced."""
    nxm = prep.nxm
    out = jnp.zeros((prep.NpG, prep.G), v_n.dtype)
    for g0, wg, np0, n0, wn, V in sched_n:
        vb = v_n[n0:n0 + wn]
        blocks = [_hilo_mm(V[s], vb) for s in range(V.shape[0])]
        out = out.at[g0:g0 + wg].set(jnp.concatenate(blocks, axis=1))
    return out


def _group_to_nodes_sl(v_g, prep: _Prep, sched_n, dt):
    """[NpG, G] grouped -> [Nn, nxm] node rows (root row zero), sliced."""
    nxm = prep.nxm
    out = jnp.zeros((prep.group_of_node.shape[0], nxm), v_g.dtype)
    for g0, wg, np0, n0, wn, V in sched_n:
        vg = v_g[g0:g0 + wg]
        acc = _hilo_mm(V[0].T, vg[:, :nxm])
        for s in range(1, V.shape[0]):
            acc = acc + _hilo_mm(V[s].T, vg[:, s * nxm:(s + 1) * nxm])
        out = out.at[n0:n0 + wn].set(acc)
    return out.astype(dt)


def _tree_chol_factor_sliced(W, Ut, opts: TdunesOpts, prep: _Prep, sched):
    """Scatter-free level-synchronous tree Cholesky: per backward level a
    static slice is factored, the Schur complements are placed into the
    parent level's diagonal blocks via the static one-hot slot matrices
    (dual_Newton_tree.c:668-735 semantics)."""
    dt = W.dtype
    nxm, G, NpG, K = prep.nxm, prep.G, prep.NpG, prep.K
    CholW = jnp.zeros((NpG, G, G), dt)
    CholUt = jnp.zeros((NpG, nxm, G), dt)
    for c0, w, p0, wp, U in sched:
        Lb = _reg_cholesky(W[c0:c0 + w], opts)
        CUb = jax.lax.linalg.triangular_solve(
            Lb, Ut[c0:c0 + w], left_side=False, lower=True, transpose_a=True)
        Sb = CUb @ CUb.swapaxes(1, 2)                    # [w, nxm, nxm]
        Um = jnp.asarray(U.reshape(K * wp, w), dt)
        upds = (Um @ Sb.reshape(w, nxm * nxm)).reshape(K, wp, nxm, nxm)
        zero = jnp.zeros((wp, nxm, nxm), dt)
        rows = [jnp.concatenate([upds[s] if t == s else zero
                                 for t in range(K)], axis=2)
                for s in range(K)]
        W = W.at[p0:p0 + wp].add(-jnp.concatenate(rows, axis=1))
        CholW = CholW.at[c0:c0 + w].set(Lb)
        CholUt = CholUt.at[c0:c0 + w].set(CUb)
    L0 = _reg_cholesky(W[0:1], opts)
    CholW = CholW.at[0:1].set(L0)
    return dict(kind="sliced", CholW=CholW, CholUt=CholUt)


def _tree_chol_solve_sliced(fact, rg, opts: TdunesOpts, prep: _Prep, sched):
    """Solve with `_tree_chol_factor_sliced` factors: static-slice backward
    RHS sweep, root solve, forward substitution (dual_Newton_tree.c:745-775)."""
    CholW, CholUt = fact["CholW"], fact["CholUt"]
    out_dt = rg.dtype
    rd = rg.astype(CholW.dtype)
    nxm, G, NpG, K = prep.nxm, prep.G, prep.NpG, prep.K
    ys = jnp.zeros((NpG, G), rd.dtype)
    for c0, w, p0, wp, U in sched:
        yb = _tri_solve(CholW[c0:c0 + w], rd[c0:c0 + w])          # [w, G]
        rv = jnp.einsum("big,bg->bi", CholUt[c0:c0 + w], yb)      # [w, nxm]
        Um = jnp.asarray(U.reshape(K * wp, w), rd.dtype)
        radd = (Um @ rv).reshape(K, wp, nxm).transpose(1, 0, 2).reshape(wp, G)
        rd = rd.at[p0:p0 + wp].add(-radd)
        ys = ys.at[c0:c0 + w].set(yb)
    y0 = _tri_solve(CholW[0:1], rd[0:1])
    dl0 = _tri_solve(CholW[0:1], y0, trans=True)
    dlam = jnp.zeros((NpG, G), rd.dtype).at[0:1].set(dl0)
    for c0, w, p0, wp, U in reversed(sched):
        Ut_s = jnp.asarray(U.transpose(0, 2, 1), rd.dtype)        # [K, w, wp]
        dpar = dlam[p0:p0 + wp].reshape(wp, K, nxm).transpose(1, 0, 2)
        dp = jnp.einsum("kwp,kpi->wi", Ut_s, dpar)                # [w, nxm]
        d = ys[c0:c0 + w] - jnp.einsum("big,bi->bg", CholUt[c0:c0 + w], dp)
        dl = _tri_solve(CholW[c0:c0 + w], d, trans=True)
        dlam = dlam.at[c0:c0 + w].set(dl)
    return dlam.astype(out_dt)


def _newton_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """Equilibrate (M~ = S M S, S = 1/sqrt(diag M)) and factor; returns
    (scales, factors) for repeated `_newton_solve` calls."""
    sW = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(W, axis1=1, axis2=2), 1e-12))
    nxm = prep.nxm
    rows_all = prep.gslot[:, None] * nxm + np.arange(nxm)[None, :]
    sUt_rows = sW[np.maximum(prep.gdad, 0)[:, None], rows_all]
    Ws = W * sW[:, :, None] * sW[:, None, :]
    Uts = Ut * sUt_rows[:, :, None] * sW[:, None, :]
    fact = _tree_chol_factor(Ws, Uts, opts, prep)
    return sW, fact


def _newton_solve(sW, fact, rg, opts: TdunesOpts, prep: _Prep):
    return _tree_chol_solve(fact, rg * sW, opts, prep) * sW


def _apply_M_nodes(qp: TreeQPIn, sol, data, d_nodes, opts: TdunesOpts,
                   prep: _Prep, AT=None, BT=None):
    """Exact dual-Hessian action M d in the data dtype, via the J P J'
    structure: the linearized stage response to a dual perturbation d,
    pushed through the linearized dynamics residual. Used for iterative
    refinement of f32-factored Newton directions (cf. _ms_apply_M)."""
    xm, um, nrxm = _masks(qp)
    if AT is None:
        AT, BT = qp.A.swapaxes(1, 2), qp.B.swapaxes(1, 2)
    sliced = _use_sliced_nodes(prep)
    AtL = jnp.einsum("nji,nj->ni", qp.A, d_nodes)
    BtL = jnp.einsum("nji,nj->ni", qp.B, d_nodes)
    if sliced:
        sched_n = _node_sliced_sched(prep)
        AtBt = jnp.concatenate([AtL, BtL], axis=1)
        sums = _kid_sum_sliced(AtBt, prep, sched_n)
        sum_A, sum_B = sums[:, : prep.nxm], sums[:, prep.nxm:]
    else:
        sum_A = kid_sum(AtL, prep.topo)
        sum_B = kid_sum(BtL, prep.topo)
    ql = (d_nodes - sum_A) * xm
    rl = (-sum_B) * um
    if opts.stage_solver == "clipping":
        xl = sol["qtilde"] * ql
        ul = sol["rtilde"] * rl
    else:
        Pmat = sol["P"] if "P" in sol else data["P"]
        hl = jnp.concatenate([ql, rl], axis=1)
        zl = jnp.einsum("nij,nj->ni", Pmat, hl)
        xl, ul = zl[:, : prep.nxm] * xm, zl[:, prep.nxm:] * um
    if sliced:
        zl_p = _par_gather_sliced(jnp.concatenate([xl, ul], axis=1),
                                  prep, sched_n)
        xl_p, ul_p = zl_p[:, : prep.nxm], zl_p[:, prep.nxm:]
    else:
        xl_p, ul_p = xl[prep.par], ul[prep.par]
    res = (jnp.einsum("nji,nj->ni", AT, xl_p)
           + jnp.einsum("nji,nj->ni", BT, ul_p) - xl) * nrxm
    return -res


def _newton_direction(W, Ut, rg, opts: TdunesOpts, prep: _Prep,
                      qp=None, sol=None, data=None):
    """Factor + solve (calculate_delta_lambda equivalent) with Jacobi
    equilibration. With refine_steps > 0 on the f32-factorization path and
    (qp, sol, data) provided, applies safeguarded/plain iterative
    refinement against the exact data-dtype Hessian action."""
    sW, fact = _newton_factor(W, Ut, opts, prep)
    dlam_g = _newton_solve(sW, fact, rg, opts, prep)
    refine = (opts.refine_steps > 0 and opts.factor_dtype == "float32"
              and qp is not None)
    if not refine:
        return dlam_g
    dt = qp.dtype

    def M_g(dg):
        d_nodes = _group_to_nodes_mm(dg, prep, dt) * _masks(qp)[2]
        return _nodes_to_group_mm(
            _apply_M_nodes(qp, sol, data, d_nodes, opts, prep), prep)

    if not opts.refine_safeguard:
        for _ in range(opts.refine_steps):
            dlam_g = dlam_g + _newton_solve(sW, fact, rg - M_g(dlam_g), opts, prep)
        return dlam_g
    resid = rg - M_g(dlam_g)
    n_best = jnp.sum(resid * resid)
    for _ in range(opts.refine_steps):
        cand = dlam_g + _newton_solve(sW, fact, resid, opts, prep)
        resid2 = rg - M_g(cand)
        n_new = jnp.sum(resid2 * resid2)
        better = n_new < n_best
        dlam_g = jnp.where(better, cand, dlam_g)
        resid = jnp.where(better, resid2, resid)
        n_best = jnp.where(better, n_new, n_best)
    return dlam_g


def _group_to_nodes(v_g, prep: _Prep, dt):
    """Scatter a grouped vector [NpG, G] back to per-node rows [Nn, nxm]."""
    rows = prep.slot_of_node[:, None] * prep.nxm + np.arange(prep.nxm)[None, :]
    out = v_g[prep.group_of_node[:, None], rows]
    return out.at[0].set(0.0)


def _nodes_to_group(v_n, prep: _Prep):
    """Gather per-node rows into the grouped layout [NpG, G]."""
    kv = np.repeat(prep.kvalid, prep.nxm, axis=1)
    return v_n[prep.kidsP].reshape(prep.NpG, prep.G) * jnp.asarray(kv, v_n.dtype)


# one-hot matmul variants of the two layout converters: a static one-hot
# matmul is exact (each output element receives exactly one summand).
# Used on hot per-iteration paths; the gather versions stay for
# host/one-off use and very large trees.
_GN_MAT_LIMIT = 32_000_000  # max K*NpG*Nn elements for the static mats


def _gn_mats(prep: _Prep):
    """[K, NpG, Nn] one-hot slot matrices E[k, g, n] = 1 iff node n is
    kid k of lambda-group g. Cached on the prep object."""
    mats = getattr(prep, "_gn_mats_cache", None)
    if mats is not None:
        return mats
    K, NpG, Nn = prep.K, prep.NpG, prep.group_of_node.shape[0]
    mats = np.zeros((K, NpG, Nn), np.float32)
    for g in range(NpG):
        for k in range(K):
            if prep.kvalid[g, k]:
                mats[k, g, prep.kidsP[g, k]] = 1.0
    prep._gn_mats_cache = mats
    return mats


def _gn_mm_ok(prep: _Prep) -> bool:
    return (prep.K * prep.NpG * prep.group_of_node.shape[0]
            <= _GN_MAT_LIMIT)


def _group_to_nodes_mm(v_g, prep: _Prep, dt):
    if _use_sliced_nodes(prep):
        return _group_to_nodes_sl(v_g, prep, _node_sliced_sched(prep), dt)
    if not _gn_mm_ok(prep):
        return _group_to_nodes(v_g, prep, dt)
    mats = _gn_mats(prep)
    nxm = prep.nxm
    out = None
    for k in range(prep.K):
        Ek = jnp.asarray(mats[k], v_g.dtype)
        blk = Ek.T @ v_g[:, k * nxm:(k + 1) * nxm]
        out = blk if out is None else out + blk
    return out.astype(dt)


def _nodes_to_group_mm(v_n, prep: _Prep):
    if _use_sliced_nodes(prep):
        return _nodes_to_group_sl(v_n, prep, _node_sliced_sched(prep))
    if not _gn_mm_ok(prep):
        return _nodes_to_group(v_n, prep)
    mats = _gn_mats(prep)
    return jnp.concatenate(
        [jnp.asarray(mats[k], v_n.dtype) @ v_n for k in range(prep.K)],
        axis=1)


def _line_search(qp, lam, dlam_nodes, sol0, dlam_g, rg, data, opts, prep, restart,
                 inner_ws=None):
    """Armijo backtracking on f = -g (line_search, dual_Newton_tree.c:922-1019).

    Accept tau when f(lam + tau d) <= f(lam) + gamma tau grad'd, where
    grad'd = -sum res.dlam. Returns (new lam, ls iters, descent_ok, restart).
    """
    dt = lam.dtype
    dot = -jnp.sum(rg * dlam_g)
    descent_ok = dot < 1e-10  # NaN compares false -> not ok; documented
        # deviation: reference requires < 0 (dual_Newton_tree.c:951)
        # but near the residual floor g'd rounds to ~+-eps — the
        # 1e-10 slack avoids spurious NOT_DESCENT exits there

    f0 = _dual_value(qp, lam, sol0, data, opts)
    # noise-aware Armijo slack (see ms_df64/tdunes_multistage: the dual
    # value carries ~sqrt(Nterms)*eps relative summation noise; near
    # convergence the true decrease falls below it and exact comparisons
    # reject every step, stalling the solver just above tolerance)
    eps_rel = 2.0 ** -45 if dt == jnp.float64 else 2.0 ** -18
    eta = jnp.asarray(eps_rel, dt) * jnp.abs(f0)

    def accepts(f2, tau):
        return f2 <= f0 + opts.ls_gamma * tau * dot + eta

    def f_at(tau):
        lt = lam + tau * dlam_nodes
        return _dual_value(qp, lt, _stage_solve(qp, lt, data, opts, prep,
                                                inner_ws=inner_ws),
                           data, opts)

    def cond(c):
        tau, f, it, acc = c
        return (~acc) & (it < opts.ls_max_iter)

    def body(c):
        tau, f, it, acc = c
        tau2 = opts.ls_beta * tau
        f2 = f_at(tau2)
        return (tau2, f2, it + 1, accepts(f2, tau2))

    one = jnp.ones((), dt)
    T = min(opts.ls_batch, opts.ls_max_iter)
    if T > 0:
        # batched trial steps: same Armijo decisions, one kernel sequence
        taus = opts.ls_beta ** jnp.arange(T, dtype=dt)
        fs = jax.vmap(f_at)(taus)
        accs = accepts(fs, taus)
        any_acc = jnp.any(accs)
        idx = jnp.argmax(accs)  # first accepted
        init = (taus[-1], fs[-1], jnp.full((), T, jnp.int32), any_acc)
        tau_sq, _, it_sq, acc = jax.lax.while_loop(cond, body, init)
        tau = jnp.where(any_acc, taus[idx], tau_sq)
        ls_iter = jnp.where(any_acc, (idx + 1).astype(jnp.int32), it_sq)
    else:
        f1 = f_at(one)
        acc0 = accepts(f1, one)
        tau, f, ls_iter, acc = jax.lax.while_loop(
            cond, body, (one, f1, jnp.ones((), jnp.int32), acc0))

    # restart heuristic: after `ls_restart_trigger` consecutive maxed-out
    # line searches, take a full step (dual_Newton_tree.c:973-1000)
    maxed = ~acc
    restart = jnp.where(maxed, restart + 1, 0)
    full_step = (opts.ls_restart_trigger > 0) & (restart >= opts.ls_restart_trigger)
    tau = jnp.where(full_step, one, tau)
    restart = jnp.where(full_step, 0, restart)

    lam_new = lam + tau * dlam_nodes
    return lam_new, ls_iter, descent_ok, restart


def diag_weights_applicable(qp: TreeQPIn, atol: float = 0.0) -> bool:
    """Diagonal Q/R, zero S — the layout requirement of the crown+chains
    solvers (general constraints allowed; cf. clipping_applicable).
    Host-side check on concrete data."""
    Q = np.asarray(qp.Q)
    R = np.asarray(qp.R)
    S = np.asarray(qp.S)
    offq = Q - np.einsum("nii->ni", Q)[:, :, None] * np.eye(Q.shape[-1])
    offr = R - np.einsum("nii->ni", R)[:, :, None] * np.eye(R.shape[-1])
    return (np.max(np.abs(offq)) <= atol and np.max(np.abs(offr)) <= atol
            and np.max(np.abs(S)) <= atol)


def clipping_applicable(qp: TreeQPIn, atol: float = 0.0) -> bool:
    """Clipping requires diagonal Q/R, zero S, no general constraints
    (stage_qp_clipping_is_applicable, dual_Newton_tree_clipping.c:45-77).
    Host-side check on concrete data."""
    return diag_weights_applicable(qp, atol) and max(qp.topo.nc) == 0


def clipping_applicable_nodes(qp: TreeQPIn, atol: float = 0.0) -> tuple:
    """Per-node clipping applicability (diag Q/R, zero S, nc=0) — the
    static node split for ``stage_solver='mixed'``. Host-side."""
    Q = np.asarray(qp.Q)
    R = np.asarray(qp.R)
    S = np.asarray(qp.S)
    offq = np.abs(Q - np.einsum("nii->ni", Q)[:, :, None]
                  * np.eye(Q.shape[-1])).max(axis=(1, 2))
    offr = np.abs(R - np.einsum("nii->ni", R)[:, :, None]
                  * np.eye(R.shape[-1])).max(axis=(1, 2))
    offs = np.abs(S).max(axis=(1, 2))
    nc = np.asarray(qp.topo.nc)
    ok = (offq <= atol) & (offr <= atol) & (offs <= atol) & (nc == 0)
    return tuple(int(v) for v in ok)


def tdunes_solve(qp: TreeQPIn, lam0=None, opts: TdunesOpts = TdunesOpts(),
                 stage_ws=None) -> TreeQPOut:
    """Solve a tree QP with dual Newton on the tree formulation.

    Equivalent of ``treeqp_tdunes_solve`` (dual_Newton_tree.c:1104-1263).
    ``lam0`` is the dual warm start [Nn, nxm] per non-root node (the
    checkpoint/resume analog, cf. treeqp_tdunes_set_dual_initialization).
    ``stage_ws``: qpgen working-set masks from a previous solve
    (info["qpgen_ws"]) — the qpOASES cross-MPC-step hotstart
    (dual_Newton_tree_qpoases.c:335-342).
    """
    if (opts.stage_solver == "clipping"
            and not isinstance(qp.Q, jax.core.Tracer)
            and not clipping_applicable(qp)):
        raise ValueError(
            "clipping stage solver not applicable (needs diagonal Q/R, zero "
            "S, nc=0) — use stage_solver='qpgen'/'mixed'/'boxqp' or the IPM "
            "(cf. stage_qp_clipping_is_applicable)")
    if (opts.stage_solver == "mixed" and opts.node_solver is None
            and not isinstance(qp.Q, jax.core.Tracer)):
        opts = dataclasses.replace(
            opts, node_solver=clipping_applicable_nodes(qp))
    if (opts.stage_solver in ("qpgen", "mixed", "boxqp", "dense")
            and not opts.h_diag and not isinstance(qp.Q, jax.core.Tracer)
            and diag_weights_applicable(qp)):
        opts = dataclasses.replace(opts, h_diag=True)
    return _tdunes_solve_jit(qp, lam0, opts, stage_ws)


def _cast_qp(qp: TreeQPIn, dtype):
    """Cast all float leaves of a TreeQPIn (topology metadata is static)."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        qp)


def _td_newton_loop(qp: TreeQPIn, lam0, opts: TdunesOpts, it0, hist0,
                    patience: int = 0, ws0=None):
    """One dual-Newton while-loop at the dtype of ``qp``'s data — the
    generic-tree counterpart of tdunes_multistage._ms_newton_loop.

    ``patience > 0`` adds a stall exit (stop when the residual error has
    not improved by >= 10% for `patience` consecutive iterations) — used
    by the coarse f32 phase, whose Armijo decisions become noise-limited
    near the f32 residual floor. Returns (lam, it, err, status, ls_it,
    hist). ``ws0``: qpgen working-set hotstart masks carried ACROSS Newton
    iterations and into line-search trial evaluations (the qpOASES
    hotstart, dual_Newton_tree_qpoases.c:312-356)."""
    prep = _get_prep(qp.topo)
    dt = qp.dtype
    xm, um, nrxm = _masks(qp)
    data = _stage_data(qp, opts)
    use_ws = opts.stage_solver in ("qpgen", "mixed")
    if use_ws and ws0 is None:
        ng = data["G"].shape[1]
        if opts.stage_solver == "mixed":
            n_ws = int(np.sum(np.asarray(opts.node_solver) == 0))
        else:
            n_ws = prep.Nn
        ws0 = (jnp.zeros((n_ws, ng), dt), jnp.zeros((n_ws, ng), dt))
    elif not use_ws:
        ws0 = ()

    def newton_step(carry, sol, res):
        lam, it, err, status, restart, ls_it, ws = carry
        # with an f32 factorization the blocks are built DIRECTLY in f32:
        # they feed only the factorization (which would cast anyway).
        # Direction accuracy is restored by the exact-dtype refinement.
        build_dt = jnp.float32 if opts.factor_dtype == "float32" else None
        W, Ut = _build_dual_hessian(qp, sol, data, opts, prep, dtype=build_dt)
        rg = _nodes_to_group_mm(res, prep)
        dlam_g = _newton_direction(W, Ut, rg, opts, prep,
                                   qp=qp, sol=sol, data=data)
        dlam_nodes = _group_to_nodes_mm(dlam_g, prep, dt) * nrxm
        lam_new, ls_it, descent_ok, restart = _line_search(
            qp, lam, dlam_nodes, sol, dlam_g, rg, data, opts, prep, restart,
            inner_ws=ws if use_ws else None)
        status = jnp.where(descent_ok, status, TDUNES_NOT_DESCENT)
        lam_new = jnp.where(descent_ok, lam_new, lam)
        return lam_new, it + 1, err, status, restart, ls_it, ws

    def cond(carry):
        lam, it, err, status, restart, ls_it, ws, hist, best, noimp = carry
        ok = (err >= opts.tol) & (status == TDUNES_OPTIMAL) & (it < opts.max_iter)
        if patience > 0:
            ok = ok & (noimp < patience)
        return ok

    def body(carry):
        lam, it, err, status, restart, ls_it, ws, hist, best, noimp = carry
        # residual/termination first (build_dual_problem:519-546), then
        # Newton — one stage solve per iteration, shared via closure
        sol = _stage_solve(qp, lam, data, opts, prep,
                           inner_ws=ws if use_ws else None)
        ws = sol.get("qpgen_ws", ws)
        res = _dual_residual(qp, sol, prep)
        err = _residual_error(res, opts)
        converged = err < opts.tol
        improved = err < 0.9 * best
        best = jnp.minimum(best, err)
        noimp = jnp.where(improved, 0, noimp + 1)
        lam, it2, err, status, restart, ls_it, ws = jax.lax.cond(
            converged,
            lambda c: (c[0], c[1], err, c[3], c[4], c[5], c[6]),
            lambda c: newton_step((c[0], c[1], err, c[3], c[4], c[5], c[6]),
                                  sol, res),
            (lam, it, err, status, restart, ls_it, ws))
        if opts.record_history:
            hist = (hist[0].at[it].set(err), hist[1].at[it].set(ls_it))
        return lam, it2, err, status, restart, ls_it, ws, hist, best, noimp

    init = (lam0, jnp.asarray(it0, jnp.int32), jnp.full((), jnp.inf, dt),
            jnp.full((), TDUNES_OPTIMAL, jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), ws0, hist0,
            jnp.full((), jnp.inf, dt), jnp.zeros((), jnp.int32))
    lam, it, err, status, _, ls_it, ws, hist, _, _ = jax.lax.while_loop(
        cond, body, init)
    return lam, it, err, status, ls_it, hist, ws


@partial(jax.jit, static_argnames=("opts",))
def _tdunes_solve_jit(qp: TreeQPIn, lam0=None, opts: TdunesOpts = TdunesOpts(),
                      stage_ws=None) -> TreeQPOut:
    topo = qp.topo
    prep = _get_prep(topo)
    dt = qp.dtype
    xm, um, nrxm = _masks(qp)

    if lam0 is None:
        lam0 = jnp.zeros((topo.Nn, topo.nxm), dt)
    lam0 = lam0 * nrxm
    ws_in = stage_ws  # qpgen working-set persistence across MPC steps

    it0 = jnp.zeros((), jnp.int32)
    # --- two-phase precision on GENERIC trees (asymmetric / pruned /
    # general-constraint): a coarse phase with everything in f32 down to
    # f32_phase_tol or stall, then the data-dtype phase with f32-factored
    # iterative refinement to the final tolerance — the same schedule the
    # multistage solver runs, minus the df64 arithmetic (the refined-f64
    # phase needs only 1-3 iterations). Cf. dual_Newton_tree.c:668-775:
    # the reference's speed substrate is shape-agnostic; this makes ours.
    use_coarse = (opts.f32_phase_tol > 0 and dt == jnp.float64
                  and opts.factor_dtype == "float32")
    if use_coarse:
        qp32 = _cast_qp(qp, jnp.float32)
        optsA = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol),
            record_history=False)
        histA = (jnp.zeros((1,), jnp.float32), jnp.zeros((1,), jnp.int32))
        lamA, it0, _, _, _, _, wsA = _td_newton_loop(
            qp32, lam0.astype(jnp.float32), optsA, it0, histA,
            patience=opts.f32_patience)
        # f32-phase status is discarded: a not-descent there is expected
        # noise near the f32 residual floor, not a failure
        lam0 = lamA.astype(dt) * nrxm
        if wsA != ():
            # hand the coarse phase's working sets to the f64 phase
            ws_in = tuple(w.astype(dt) for w in wsA)

    hist0 = (jnp.full((opts.max_iter,), jnp.nan, dt),
             jnp.full((opts.max_iter,), -1, jnp.int32))
    lam, it, err, status, ls_it, hist, ws_f = _td_newton_loop(
        qp, lam0, opts, it0, hist0, ws0=ws_in)
    data = _stage_data(qp, opts)

    # final stage solve + multiplier recovery (export, dual_Newton_tree.c:1235-1247)
    sol = _stage_solve(qp, lam, data, opts, prep,
                       inner_ws=ws_f if ws_f != () else None)
    res = _dual_residual(qp, sol, prep)
    err = _residual_error(res, opts)
    status = jnp.where((status == TDUNES_OPTIMAL) & (err >= opts.tol),
                       TDUNES_MAX_ITER, status)

    mu_d = jnp.zeros((topo.Nn, topo.ncm), dt)
    if opts.stage_solver == "clipping":
        # mu = Q .* (xUnc - x) (stage_qp_clipping_export_mu)
        mu_x = data["Qd"] * (sol["xUnc"] - sol["x"]) * xm
        mu_u = data["Rd"] * (sol["uUnc"] - sol["u"]) * um
    elif opts.stage_solver == "boxqp":
        mu_x = sol["mu"][:, : topo.nxm] * xm
        mu_u = sol["mu"][:, topo.nxm:] * um
    elif opts.stage_solver in ("qpgen", "mixed"):
        mu_x = sol["mu_x"] * xm
        mu_u = sol["mu_u"] * um
        mu_d = sol["mu_d"][:, : topo.ncm] * jnp.asarray(topo.c_mask, dt)
    else:
        mu_x = jnp.zeros_like(sol["x"])
        mu_u = jnp.zeros_like(sol["u"])

    info = dict(iter=it, status=status, error=err, ls_iter=ls_it)
    if opts.stage_solver == "boxqp":
        # inner-solver convergence guard (see _stage_solve): nonzero means
        # boxqp_iters was too small for the final active set
        info["boxqp_res"] = sol["boxqp_res"]
    if opts.stage_solver in ("qpgen", "mixed"):
        # inner-solver guard: max primal violation / stationarity of the
        # polished general stage QPs at the final iterate
        info["qpgen_res"] = sol["qpgen_res"]
        # final working-set masks for cross-MPC-step hotstart (pass back
        # via tdunes_solve(..., stage_ws=...); treeqp_solve.m:6-17 analog)
        info["qpgen_ws"] = sol["qpgen_ws"]
    if opts.record_history:
        info["err_hist"], info["ls_hist"] = hist
    return TreeQPOut(
        x=sol["x"], u=sol["u"], lam=lam * nrxm,
        mu_x=mu_x, mu_u=mu_u,
        mu_d=mu_d,
        info=info,
    )
