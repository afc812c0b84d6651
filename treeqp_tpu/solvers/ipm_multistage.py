"""Multistage (crown + chains) tree IPM — the scenario-batched path of the
HPIPM-capability engine.

The generic tree IPM (solvers/ipm.py) factorizes per depth with a scan
over ALL tree stages; on a multistage robust-MPC tree (md^Nr scenarios x
length-L chains, the reference's setup_multistage_tree shape,
tree.c:247-280) that serializes Nh scan steps of scattered [Nn,...]
updates. This module reuses the crown+chains layout of the multistage
dual-Newton solver (tdunes_multistage.MultistageQP): the chain Riccati
sweeps are batched over all scenarios ([S, L, ...] arrays, scenarios on
the leading axis -> one XLA kernel per step instead of per node),
and only the small crown runs the generic per-depth recursion (seeded with
the chains' value-function Hessians through _riccati_factor's Wsum0).

Scope: multistage instances with diagonal Q/R and S=0 (the crown+chains
layout requirement). Box constraints keep the barrier matrix diagonal
(G = I), so the stage Hessians stay diagonal vectors end to end — the
fast path (spring_mass / linear_chain / quadcopter / crane). General C/D
rows are first-class (hpipm_tree.c:376-379): their barrier contribution
G'Gamma G densifies the stage Hessians, so those instances run the dense
batched chain Riccati (still one kernel per chain step over all S
scenarios — not the generic per-node scan) and the dense crown recursion.

Mixed precision mirrors IpmOpts.factor_dtype: f32 Riccati sweeps while
max res4 > f32_until, then a full-precision finish (residuals/steps are
always recomputed in the data dtype, so f32 directions only perturb the
path — inexact Newton).

Reference parity: treeqp_hpmpc_solve / treeqp_hpipm_solve semantics
(hpmpc_tree.c:316-455, hpipm_tree.c:307-562) — 4-residual termination,
fraction-to-boundary steps, signed multiplier fold on export.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.solvers.ipm import (
    IpmOpts, IPM_OPTIMAL, IPM_MAX_ITER, IPM_MIN_STEP, _INF_THRESH,
    _get_ipm_prep, _riccati_factor, _riccati_solve, _tri_solve_mat)  # noqa: F401 (re-exported surface)
from treeqp_tpu.solvers.tdunes_multistage import MultistageQP
from treeqp_tpu.utils.tree import kid_sum

__all__ = ["ipm_ms_solve"]


def _box_data(lo, hi, mask):
    """Finite-side masks for a stacked bound pair (cf. ipm._constraint_data
    with G = I)."""
    m_lo = ((lo > -_INF_THRESH) & (mask > 0)).astype(lo.dtype)
    m_hi = ((hi < _INF_THRESH) & (mask > 0)).astype(lo.dtype)
    return m_lo, m_hi


def _chain_riccati_factor(hbar, AB, opts: IpmOpts, fdt=None):
    """Batched backward Riccati along all chains at once.

    hbar [S, L, nz] diagonal stage Hessians (barrier included) OR
    [S, L, nz, nz] dense ones (general C/D rows densify the barrier
    matrix); AB [S, L, nx, nz] edge dynamics INTO chain node j. Scan
    j = L-1 .. 0:
        M_j = Hbar_j + W_{j+1},  W_j = AB_j' P_j AB_j
    Returns per-node (P, Luu, K, Mxu) stacked [S, L, ...] plus the crown
    boundary term W_0 [S, nz, nz] (the Schur flowing into each chain's
    crown parent). The tree-wide counterpart is ipm._riccati_factor.
    """
    if fdt is not None:
        hbar = hbar.astype(fdt)
    dt = hbar.dtype
    AB = AB.astype(dt)
    S, L, nx, nz = AB.shape
    num = nz - nx
    dense_h = hbar.ndim == 4

    def step(W, inp):
        hb, ABj = inp  # [S, nz] or [S, nz, nz], [S, nx, nz]
        M = W + (hb if dense_h
                 else jnp.eye(nz, dtype=dt)[None] * hb[:, None, :])
        Mxx = M[:, :nx, :nx]
        Mxu = M[:, :nx, nx:]
        Muu = M[:, nx:, nx:] + opts.reg_eps * jnp.eye(num, dtype=dt)
        Lb = jnp.linalg.cholesky(Muu)
        Kb = -_tri_solve_mat(Lb, _tri_solve_mat(Lb, M[:, nx:, :nx]),
                             trans=True)
        Pb = Mxx + Mxu @ Kb
        Pb = 0.5 * (Pb + Pb.swapaxes(1, 2))
        Wout = ABj.swapaxes(1, 2) @ (Pb @ ABj)
        return Wout, (Pb, Lb, Kb, Mxu)

    inps = (jnp.flip(hbar, 1).swapaxes(0, 1),
            jnp.flip(AB, 1).swapaxes(0, 1))
    W0, (P, Luu, K, Mxu) = jax.lax.scan(
        step, jnp.zeros((S, nz, nz), dt), inps)
    flip = lambda a: jnp.flip(a, 0).swapaxes(0, 1)  # -> [S, L, ...]
    return dict(P=flip(P), Luu=flip(Luu), K=flip(K), Mxu=flip(Mxu),
                AB=AB, W0=W0)


def _chain_riccati_bwd(fact, rg, rb):
    """Batched backward RHS sweep (cf. ipm._riccati_solve bwd half).

    rg [S, L, nz], rb [S, L, nx]. Returns per-node (p, k) and the crown
    boundary rhs w0 [S, nz]."""
    P, Luu, Mxu, AB = fact["P"], fact["Luu"], fact["Mxu"], fact["AB"]
    dt = P.dtype
    rg, rb = rg.astype(dt), rb.astype(dt)
    S, L, nx, nz = AB.shape

    def step(w, inp):
        rgj, rbj, Pj, Lj, Mxuj, ABj = inp
        m = rgj + w
        kb = -_tri_solve_mat(Lj, _tri_solve_mat(Lj, m[:, nx:, None]),
                             trans=True)[..., 0]
        pb = m[:, :nx] + jnp.einsum("bxu,bu->bx", Mxuj, kb)
        v = jnp.einsum("bxy,by->bx", Pj, rbj) + pb
        wout = jnp.einsum("bxz,bx->bz", ABj, v)
        return wout, (pb, kb)

    sw = lambda a: jnp.flip(a, 1).swapaxes(0, 1)
    inps = (sw(rg), sw(rb), sw(P), sw(Luu), sw(fact["Mxu"]), sw(AB))
    w0, (p, k) = jax.lax.scan(step, jnp.zeros((S, nz), dt), inps)
    flip = lambda a: jnp.flip(a, 0).swapaxes(0, 1)
    return flip(p), flip(k), w0


def _chain_riccati_fwd(fact, p, k, rb, z_root):
    """Batched forward substitution down the chains.

    z_root [S, nz]: the crown solution at each chain's parent node.
    Returns (dz [S, L, nz], dlam [S, L, nx])."""
    P, K, AB = fact["P"], fact["K"], fact["AB"]
    dt = P.dtype
    rb, z_root = rb.astype(dt), z_root.astype(dt)
    S, L, nx, nz = AB.shape

    def step(zp, inp):
        Pj, Kj, ABj, rbj, pj, kj = inp
        dx = jnp.einsum("bxz,bz->bx", ABj, zp) + rbj
        du = jnp.einsum("bux,bx->bu", Kj, dx) + kj
        dlam = jnp.einsum("bxy,by->bx", Pj, dx) + pj
        dz = jnp.concatenate([dx, du], axis=1)
        return dz, (dz, dlam)

    sw = lambda a: a.swapaxes(0, 1)
    _, (dz, dlam) = jax.lax.scan(
        step, z_root, (sw(P), sw(K), sw(AB), sw(rb), sw(p), sw(k)))
    return dz.swapaxes(0, 1), dlam.swapaxes(0, 1)


class _IpmShard:
    """Explicit-SPMD context for the multistage IPM under ``jax.shard_map``
    (chains sharded over the mesh axis, crown replicated) — the IPM
    counterpart of tdunes_multistage._Shard. Boundary traffic: compact
    all-gathers of the chain-root Riccati contributions W0 [S, nz, nz] /
    w0 [S, nz] per solve, plus scalar reductions. Reference analog:
    hpmpc_tree.c:395-398's capability class with the scenario fork-join of
    dual_Newton_scenarios.c:528-563."""

    def __init__(self, meta, axis: str, S_local: int):
        self.axis = axis
        rid = jnp.asarray(np.asarray(meta.root_ids))
        ax = jax.lax.axis_index(axis)
        self.start = ax * S_local
        self.rid_l = jax.lax.dynamic_slice(rid, (self.start,), (S_local,))
        self.S_local = S_local

    def slice_s(self, v):
        """Local scenario rows of a global [S, ...] constant."""
        return jax.lax.dynamic_slice_in_dim(v, self.start, self.S_local, 0)

    def psum(self, v):
        return jax.lax.psum(v, self.axis)

    def pmax(self, v):
        return jax.lax.pmax(v, self.axis)

    def pmin(self, v):
        return jax.lax.pmin(v, self.axis)

    def gather_s(self, v):
        return jax.lax.all_gather(v, self.axis, axis=0, tiled=True)

    def all_true(self, flag):
        return self.psum(1 - flag.astype(jnp.int32)) == 0


@partial(jax.jit, static_argnames=("opts",))
def ipm_ms_solve(ms: MultistageQP, opts: IpmOpts = IpmOpts(), ws=None):
    """Mehrotra predictor-corrector IPM in crown+chains layout.

    Returns (crown_out dict, chain_out dict, info) like tdunes_ms_solve;
    use tdunes_multistage.merge_output for a full-tree TreeQPOut.
    ``ws``: optional (crown_out, chain_out) warm start pair — or a full
    TreeQPOut-like on the crown topology is NOT accepted here (layout).

    General C/D rows (ms.C is not None) are handled first-class
    (hpipm_tree.c:376-379): their barrier fold G'Gamma G densifies the
    stage Hessians, so the chain Riccati runs its dense batched variant
    and the crown the dense recursion — still scenario-batched kernels,
    not the generic per-node scan.
    """
    meta = ms.meta
    qp = ms.crown
    topo = qp.topo
    prep = _get_ipm_prep(topo)
    dt = ms.q.dtype
    Nc, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    L = meta.L
    # local scenario count: inside shard_map the chain arrays are the
    # LOCAL shard, so shapes come from the data, not the (global) meta
    S = ms.q.shape[0]
    shard = (_IpmShard(meta, opts.axis_name, S)
             if opts.axis_name is not None else None)
    rid = np.asarray(meta.root_ids)
    rid_l = shard.rid_l if shard is not None else rid
    loc = (lambda v: shard.slice_s(v)) if shard is not None else (lambda v: v)

    xm = jnp.asarray(topo.x_mask, dt)
    um = jnp.asarray(topo.u_mask, dt)
    nrxm = jnp.asarray(topo.nonroot_x_mask, dt)
    zmask_cr = jnp.concatenate([xm, um], axis=1)
    # chain masks come from the full topology (identity-padded weights
    # cannot distinguish padding reliably); ids = [S, L] chain node grid
    # (same construction as tdunes_multistage.merge_output)
    ss = meta.full_topo.stage_start
    ids = np.stack([np.arange(int(ss[meta.Nr + 1 + j]),
                              int(ss[meta.Nr + 2 + j]))
                    for j in range(L)], axis=1)
    xmask_ch = loc(jnp.asarray(meta.full_topo.x_mask, dt)[ids])
    umask_ch = loc(jnp.asarray(meta.full_topo.u_mask, dt)[ids])
    zmask_ch = jnp.concatenate([xmask_ch, umask_ch], axis=2)

    # --- stacked diagonal Hessians / gradients / bounds ([.., nz])
    Hd_cr = jnp.concatenate(
        [jnp.diagonal(qp.Q, axis1=1, axis2=2) * xm + (1 - xm),
         jnp.diagonal(qp.R, axis1=1, axis2=2) * um + (1 - um)], axis=1)
    h_cr = jnp.concatenate([qp.q, qp.r], axis=1) * zmask_cr
    lo_cr = jnp.concatenate([qp.xmin, qp.umin], axis=1)
    hi_cr = jnp.concatenate([qp.xmax, qp.umax], axis=1)
    mlo_cr, mhi_cr = _box_data(lo_cr, hi_cr, zmask_cr)

    Hd_ch = jnp.concatenate([ms.Qd, ms.Rd], axis=2)
    h_ch = jnp.concatenate([ms.q, ms.r], axis=2) * zmask_ch
    lo_ch = jnp.concatenate([ms.xmin, ms.umin], axis=2)
    hi_ch = jnp.concatenate([ms.xmax, ms.umax], axis=2)
    mlo_ch, mhi_ch = _box_data(lo_ch, hi_ch, zmask_ch)

    AB_cr = jnp.concatenate([qp.A, qp.B], axis=2)          # [Nc, nxm, nz]
    AB_ch = jnp.concatenate([ms.A, ms.B], axis=3)          # [S, L, nxm, nz]
    par = prep.par.copy()
    par[0] = 0

    # --- general C/D rows (static: present iff split carried them)
    HG = ms.C is not None
    if HG:
        cm_cr = jnp.asarray(meta.full_topo.c_mask, dt)[:Nc]
        Gc_cr = jnp.concatenate([qp.C * cm_cr[:, :, None],
                                 qp.D * cm_cr[:, :, None]], axis=2)
        lo_crg, hi_crg = qp.dmin, qp.dmax
        mlo_crg, mhi_crg = _box_data(lo_crg, hi_crg, cm_cr)
        cm_ch = loc(jnp.asarray(meta.full_topo.c_mask, dt)[ids])
        Gc_ch = jnp.concatenate([ms.C * cm_ch[..., None],
                                 ms.D * cm_ch[..., None]], axis=3)
        lo_chg, hi_chg = ms.dmin, ms.dmax
        mlo_chg, mhi_chg = _box_data(lo_chg, hi_chg, cm_ch)

    # constraint-section registry: tag -> (lo, hi, m_lo, m_hi); per-section
    # slack/dual state lives in st["slo_<tag>"] etc. Box sections project
    # t = z; general sections t = [C D] z.
    SEC = dict(cr=(lo_cr, hi_cr, mlo_cr, mhi_cr),
               ch=(lo_ch, hi_ch, mlo_ch, mhi_ch))
    if HG:
        SEC["crg"] = (lo_crg, hi_crg, mlo_crg, mhi_crg)
        SEC["chg"] = (lo_chg, hi_chg, mlo_chg, mhi_chg)
    TAGS = tuple(SEC.keys())

    def tproj(tag, zc, zh):
        if tag == "cr":
            return zc
        if tag == "ch":
            return zh
        if tag == "crg":
            return jnp.einsum("ncz,nz->nc", Gc_cr, zc)
        return jnp.einsum("slcz,slz->slc", Gc_ch, zh)

    _CHAIN_TAGS = ("ch", "chg")

    def _sum_split(per_tag):
        """Sum a per-tag scalar: crown tags replicated, chain tags local
        (psummed over the mesh axis under shard_map)."""
        t_cr = sum(per_tag(tag) for tag in TAGS if tag not in _CHAIN_TAGS)
        t_ch = sum((per_tag(tag) for tag in TAGS if tag in _CHAIN_TAGS),
                   start=jnp.zeros((), dt))
        if shard is not None:
            t_ch = shard.psum(t_ch)
        return t_cr + t_ch

    def _ineq_of(tag):
        _, _, mlo, mhi = SEC[tag]
        return jnp.sum(mlo) + jnp.sum(mhi)

    n_ineq = jnp.maximum(_sum_split(_ineq_of), 1.0)

    def residuals(st):
        """res_g / res_b and per-section res_d / res_m."""
        z_cr, z_ch = st["z_cr"], st["z_ch"]
        lam_cr, lam_ch = st["lam_cr"], st["lam_ch"]
        # crown res_g
        rg_cr = Hd_cr * z_cr + h_cr \
            + (st["lhi_cr"] - st["llo_cr"]) * zmask_cr
        rg_ch = Hd_ch * z_ch + h_ch \
            + (st["lhi_ch"] - st["llo_ch"]) * zmask_ch
        if HG:
            rg_cr = rg_cr + jnp.einsum("ncz,nc->nz", Gc_cr,
                                       st["lhi_crg"] - st["llo_crg"])
            rg_ch = rg_ch + jnp.einsum("slcz,slc->slz", Gc_ch,
                                       st["lhi_chg"] - st["llo_chg"])
        rg_cr = rg_cr.at[:, :nxm].add(-lam_cr * nrxm)
        contrib = jnp.einsum("nxz,nx->nz", AB_cr, lam_cr * nrxm)
        rg_cr = rg_cr + kid_sum(contrib, topo)
        # chain-root lambdas pull on their crown parents
        c0 = jnp.einsum("sxz,sx->sz", AB_ch[:, 0], lam_ch[:, 0])
        if shard is not None:
            c0 = shard.gather_s(c0)  # compact boundary form [S, nz]
        rg_cr = rg_cr.at[rid].add(c0, unique_indices=True) * zmask_cr
        # chain res_g: -lam_j (x rows) + AB_{j+1}' lam_{j+1}
        rg_ch = rg_ch.at[:, :, :nxm].add(-lam_ch)
        up = jnp.einsum("slxz,slx->slz", AB_ch[:, 1:], lam_ch[:, 1:])
        rg_ch = (rg_ch.at[:, :-1].add(up)) * zmask_ch
        # res_b
        z_par = z_cr[par]
        rb_cr = (jnp.einsum("nxz,nz->nx", AB_cr, z_par) + qp.b
                 - z_cr[:, :nxm]) * nrxm
        z_rid = z_cr[rid_l] if shard is not None else z_cr[rid]
        zp = jnp.concatenate([z_rid[:, None], z_ch[:, :-1]], axis=1)
        rb_ch = jnp.einsum("slxz,slz->slx", AB_ch, zp) + ms.b \
            - z_ch[:, :, :nxm]
        # per-section res_d / res_m
        rd, rm = {}, {}
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            t = tproj(tag, z_cr, z_ch)
            s_lo, s_hi = st["slo_" + tag], st["shi_" + tag]
            l_lo, l_hi = st["llo_" + tag], st["lhi_" + tag]
            rd[tag] = ((s_lo - (t - lo)) * mlo, (s_hi - (hi - t)) * mhi)
            rm[tag] = (s_lo * l_lo * mlo, s_hi * l_hi * mhi)
        return rg_cr, rg_ch, rb_cr, rb_ch, rd, rm

    def res4_of(rg_cr, rg_ch, rb_cr, rb_ch, rd, rm):
        mx = lambda *a: jnp.max(jnp.stack([jnp.max(jnp.abs(v)) for v in a]))
        d_all = [v for tag in TAGS for v in rd[tag]]
        m_all = [v for tag in TAGS for v in rm[tag]]
        r4 = jnp.stack([
            mx(rg_cr, rg_ch), mx(rb_cr, rb_ch), mx(*d_all), mx(*m_all)])
        if shard is not None:
            r4 = shard.pmax(r4)  # crown terms replicated (max idempotent)
        return r4

    def kkt_rhs(rg, rd_pair, rm_pair, s_lo, s_hi, l_lo, l_hi, mlo, mhi):
        """Eliminate (ds, dl) per section (elementwise in the section's
        row space; general sections fold through G' outside)."""
        rd_lo, rd_hi = rd_pair
        rm_lo, rm_hi = rm_pair
        inv_slo = jnp.where(mlo > 0, 1.0 / s_lo, 0.0)
        inv_shi = jnp.where(mhi > 0, 1.0 / s_hi, 0.0)
        gamma = l_lo * inv_slo + l_hi * inv_shi
        qx = ((rm_lo - l_lo * rd_lo) * inv_slo
              - (rm_hi - l_hi * rd_hi) * inv_shi)
        return rg + qx, gamma

    def expand_step(dz, rd_pair, rm_pair, s_lo, s_hi, l_lo, l_hi, mlo, mhi):
        rd_lo, rd_hi = rd_pair
        rm_lo, rm_hi = rm_pair
        ds_lo = (dz - rd_lo) * mlo
        ds_hi = (-dz - rd_hi) * mhi
        inv_slo = jnp.where(mlo > 0, 1.0 / s_lo, 0.0)
        inv_shi = jnp.where(mhi > 0, 1.0 / s_hi, 0.0)
        dl_lo = (-(rm_lo + l_lo * ds_lo) * inv_slo) * mlo
        dl_hi = (-(rm_hi + l_hi * ds_hi) * inv_shi) * mhi
        return ds_lo, ds_hi, dl_lo, dl_hi

    def max_step(v, dv, mask, frac=1.0):
        ratio = jnp.where((dv < 0) & (mask > 0),
                          -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, frac * jnp.min(ratio))

    def kkt_apply(hbars, dzc, dzh, dlc, dlh):
        """Exact data-dtype action of the KKT operator the Riccati solves
        (cf. ipm._kkt_apply). ``hbars`` = (diag_cr, diag_ch, gam_crg,
        gam_chg): the general-row barrier term applies FACTORED,
        G'(Gamma (G dz)) — materializing the dense Hessians in the data
        dtype would cost more than the rest of the refinement combined."""
        hb_cr_d, hb_ch_d, g_crg, g_chg = hbars
        r1_cr = hb_cr_d * dzc
        if HG:
            t = jnp.einsum("ncz,nz->nc", Gc_cr, dzc)
            r1_cr = r1_cr + jnp.einsum("ncz,nc->nz", Gc_cr, g_crg * t)
        r1_cr = r1_cr.at[:, :nxm].add(-dlc * nrxm)
        contrib = jnp.einsum("nxz,nx->nz", AB_cr, dlc * nrxm)
        r1_cr = r1_cr + kid_sum(contrib, topo)
        c0 = jnp.einsum("sxz,sx->sz", AB_ch[:, 0], dlh[:, 0])
        if shard is not None:
            c0 = shard.gather_s(c0)
        r1_cr = r1_cr.at[rid].add(c0, unique_indices=True) * zmask_cr
        r1_ch = hb_ch_d * dzh
        if HG:
            th = jnp.einsum("slcz,slz->slc", Gc_ch, dzh)
            r1_ch = r1_ch + jnp.einsum("slcz,slc->slz", Gc_ch, g_chg * th)
        r1_ch = r1_ch.at[:, :, :nxm].add(-dlh)
        up = jnp.einsum("slxz,slx->slz", AB_ch[:, 1:], dlh[:, 1:])
        r1_ch = (r1_ch.at[:, :-1].add(up)) * zmask_ch
        dz_par = dzc[par]
        r2_cr = (dzc[:, :nxm]
                 - jnp.einsum("nxz,nz->nx", AB_cr, dz_par)) * nrxm
        dz_rid = dzc[rid_l] if shard is not None else dzc[rid]
        zp = jnp.concatenate([dz_rid[:, None], dzh[:, :-1]], axis=1)
        r2_ch = dzh[:, :, :nxm] - jnp.einsum("slxz,slz->slx", AB_ch, zp)
        return r1_cr, r1_ch, r2_cr, r2_ch

    def solve_kkt(fact_ch, fact_cr, rhs_cr, rhs_ch, rb_cr, rb_ch,
                  hbars=None):
        """Full-tree Riccati solve: chain bwd -> crown -> chain fwd.
        With ``hbars`` (data-dtype stage Hessians, diag or dense) and
        refine_steps > 0, iteratively refine against the exact KKT
        operator."""
        def one_solve(rhs_cr_, rhs_ch_, rb_cr_, rb_ch_):
            p_ch, k_ch, w0 = _chain_riccati_bwd(fact_ch, rhs_ch_, rb_ch_)
            if shard is not None:
                w0 = shard.gather_s(w0)  # [S, nz] boundary vector
            wsum0 = jnp.zeros((Nc, nz), w0.dtype).at[rid].set(w0)
            dz_cr, dlam_cr = _riccati_solve(qp, fact_cr, rhs_cr_, rb_cr_,
                                            prep, wsum0=wsum0)
            dz_ch, dlam_ch = _chain_riccati_fwd(
                fact_ch, p_ch, k_ch, rb_ch_, dz_cr[rid_l])
            out_dt = rhs_cr_.dtype
            return (dz_cr.astype(out_dt), dz_ch.astype(out_dt),
                    dlam_cr.astype(out_dt), dlam_ch.astype(out_dt))

        sol = one_solve(rhs_cr, rhs_ch, rb_cr, rb_ch)
        if opts.refine_steps <= 0 or hbars is None:
            return sol
        dzc, dzh, dlc, dlh = sol
        for _ in range(opts.refine_steps):
            r1c, r1h, r2c, r2h = kkt_apply(hbars,
                                           dzc, dzh, dlc, dlh)
            # K(corr) = (e1, e2), e1 = -rhs - L1(d), e2 = rb - L2(d);
            # one_solve(rg', rb') gives L1 = -rg', L2 = rb' -> rg' = -e1
            cc, ch_, lc, lh = one_solve(rhs_cr + r1c, rhs_ch + r1h,
                                        rb_cr - r2c, rb_ch - r2h)
            dzc, dzh = dzc + cc, dzh + ch_
            dlc, dlh = dlc + lc, dlh + lh
        return dzc, dzh, dlc, dlh

    # --- initial point (cf. ipm_solve cold/warm start)
    if ws is None:
        s_init = jnp.sqrt(jnp.asarray(opts.mu0, dt))
        st0 = dict(
            z_cr=jnp.zeros((Nc, nz), dt), z_ch=jnp.zeros((S, L, nz), dt),
            lam_cr=jnp.zeros((Nc, nxm), dt),
            lam_ch=jnp.zeros((S, L, nxm), dt))
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            s_lo = jnp.where(mlo > 0, jnp.maximum(s_init, -lo), 1.0)
            s_hi = jnp.where(mhi > 0, jnp.maximum(s_init, hi), 1.0)
            st0["slo_" + tag] = s_lo
            st0["shi_" + tag] = s_hi
            st0["llo_" + tag] = jnp.where(mlo > 0, opts.mu0 / s_lo, 0.0)
            st0["lhi_" + tag] = jnp.where(mhi > 0, opts.mu0 / s_hi, 0.0)
    else:
        crown_ws, chain_ws = ws
        eps = jnp.asarray(opts.ws_eps, dt)
        z_cr = jnp.concatenate([crown_ws["x"], crown_ws["u"]],
                               axis=1).astype(dt) * zmask_cr
        z_ch = jnp.concatenate([chain_ws["x"], chain_ws["u"]],
                               axis=2).astype(dt) * zmask_ch
        st0 = dict(z_cr=z_cr, z_ch=z_ch,
                   lam_cr=crown_ws["lam"].astype(dt) * nrxm,
                   lam_ch=chain_ws["lam"].astype(dt))
        mu_ws = dict(
            cr=jnp.concatenate([crown_ws["mu_x"], crown_ws["mu_u"]],
                               axis=1).astype(dt),
            ch=jnp.concatenate([chain_ws["mu_x"], chain_ws["mu_u"]],
                               axis=2).astype(dt))
        if HG:
            mu_ws["crg"] = (crown_ws["mu_d"].astype(dt)
                            if "mu_d" in crown_ws
                            else jnp.zeros_like(lo_crg))
            mu_ws["chg"] = (chain_ws["mu_d"].astype(dt)
                            if "mu_d" in chain_ws
                            else jnp.zeros_like(lo_chg))
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            t = tproj(tag, z_cr, z_ch)
            mu = mu_ws[tag]
            st0["slo_" + tag] = jnp.where(mlo > 0,
                                          jnp.maximum(t - lo, eps), 1.0)
            st0["shi_" + tag] = jnp.where(mhi > 0,
                                          jnp.maximum(hi - t, eps), 1.0)
            st0["llo_" + tag] = jnp.where(mlo > 0, jnp.maximum(-mu, eps), 0.0)
            st0["lhi_" + tag] = jnp.where(mhi > 0, jnp.maximum(mu, eps), 0.0)

    def iteration(carry, fdt=None):
        st, it, status, res4, bst, best4, noimp = carry
        rg_cr, rg_ch, rb_cr, rb_ch, rd, rm = residuals(st)

        def sec_args(tag):
            lo, hi, mlo, mhi = SEC[tag]
            return (st["slo_" + tag], st["shi_" + tag],
                    st["llo_" + tag], st["lhi_" + tag], mlo, mhi)

        def make_rhs(rm_use):
            rhs_cr, gam_cr = kkt_rhs(rg_cr, rd["cr"], rm_use["cr"],
                                     *sec_args("cr"))
            rhs_ch, gam_ch = kkt_rhs(rg_ch, rd["ch"], rm_use["ch"],
                                     *sec_args("ch"))
            gams = dict(cr=gam_cr, ch=gam_ch)
            if HG:
                qx_crg, gam_crg = kkt_rhs(jnp.zeros_like(lo_crg), rd["crg"],
                                          rm_use["crg"], *sec_args("crg"))
                qx_chg, gam_chg = kkt_rhs(jnp.zeros_like(lo_chg), rd["chg"],
                                          rm_use["chg"], *sec_args("chg"))
                rhs_cr = rhs_cr + jnp.einsum("ncz,nc->nz", Gc_cr, qx_crg)
                rhs_ch = rhs_ch + jnp.einsum("slcz,slc->slz", Gc_ch, qx_chg)
                gams["crg"], gams["chg"] = gam_crg, gam_chg
            return rhs_cr, rhs_ch, gams

        rhs_cr_a, rhs_ch_a, gams = make_rhs(rm)
        hbar_d_cr = Hd_cr + gams["cr"]
        hbar_d_ch = Hd_ch + gams["ch"]
        hbars_fact = (hbar_d_cr, hbar_d_ch, gams.get("crg"), gams.get("chg"))
        if HG:
            # general rows densify the barrier matrix Hbar = diag + G'Gamma G
            # — built straight in the FACTOR dtype (it feeds only the
            # factorization; refinement applies the factored form in f64)
            Gf_cr, Gf_ch = Gc_cr.astype(fdt), Gc_ch.astype(fdt)
            hbar_cr = jnp.eye(nz, dtype=fdt)[None] \
                * hbar_d_cr.astype(fdt)[:, None, :] \
                + jnp.einsum("nci,nc,ncj->nij", Gf_cr,
                             gams["crg"].astype(fdt), Gf_cr)
            hbar_ch = (jnp.eye(nz, dtype=fdt)[None, None]
                       * hbar_d_ch.astype(fdt)[..., None, :]
                       + jnp.einsum("slci,slc,slcj->slij", Gf_ch,
                                    gams["chg"].astype(fdt), Gf_ch))
        else:
            hbar_cr = hbar_d_cr
            hbar_ch = hbar_d_ch
        fact_ch = _chain_riccati_factor(hbar_ch, AB_ch, opts, fdt)
        W0ch = fact_ch["W0"]
        if shard is not None:
            # chain-root Riccati contributions: THE boundary tensor of the
            # scenario decomposition ([S, nz, nz] per factorization)
            W0ch = shard.gather_s(W0ch)
        Wsum0 = jnp.zeros((Nc, nz, nz), W0ch.dtype).at[rid].set(W0ch)
        Hbar_cr_dense = (hbar_cr if hbar_cr.ndim == 3 else
                         jnp.eye(nz, dtype=hbar_cr.dtype)[None]
                         * hbar_cr[:, None, :])
        fact_cr = _riccati_factor(qp, Hbar_cr_dense, prep, opts, fdt,
                                  Wsum0=Wsum0)

        def expand_all(dzc, dzh, rm_use):
            return {tag: expand_step(tproj(tag, dzc, dzh), rd[tag],
                                     rm_use[tag], *sec_args(tag))
                    for tag in TAGS}

        def alpha_of(exp, frac=1.0):
            a = None
            for tag in TAGS:
                _, _, mlo, mhi = SEC[tag]
                for v, dv, m in ((st["slo_" + tag], exp[tag][0], mlo),
                                 (st["shi_" + tag], exp[tag][1], mhi),
                                 (st["llo_" + tag], exp[tag][2], mlo),
                                 (st["lhi_" + tag], exp[tag][3], mhi)):
                    step = max_step(v, dv, m, frac)
                    a = step if a is None else jnp.minimum(a, step)
            if shard is not None:
                a = shard.pmin(a)  # crown terms replicated (min idempotent)
            return a

        def mu_of(stx):
            def term(tag):
                _, _, mlo, mhi = SEC[tag]
                return (jnp.sum(stx["slo_" + tag] * stx["llo_" + tag] * mlo)
                        + jnp.sum(stx["shi_" + tag] * stx["lhi_" + tag] * mhi))
            return _sum_split(term) / n_ineq

        def mu_shifted(exp, a):
            def term(tag):
                _, _, mlo, mhi = SEC[tag]
                return jnp.sum(
                    (st["slo_" + tag] + a * exp[tag][0])
                    * (st["llo_" + tag] + a * exp[tag][2]) * mlo) + jnp.sum(
                    (st["shi_" + tag] + a * exp[tag][1])
                    * (st["lhi_" + tag] + a * exp[tag][3]) * mhi)
            return _sum_split(term) / n_ineq

        # predictor
        dzc_a, dzh_a, dlc_a, dlh_a = solve_kkt(
            fact_ch, fact_cr, rhs_cr_a, rhs_ch_a, rb_cr, rb_ch,
            hbars=hbars_fact)
        exp_a = expand_all(dzc_a, dzh_a, rm)
        a_aff = alpha_of(exp_a)
        mu = mu_of(st)
        mu_aff = mu_shifted(exp_a, a_aff)
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-300)) ** 3, 0.0, 1.0)

        # corrector
        rm_c = {}
        for tag in TAGS:
            _, _, mlo, mhi = SEC[tag]
            rm_c[tag] = (
                rm[tag][0] + (exp_a[tag][0] * exp_a[tag][2] - sigma * mu) * mlo,
                rm[tag][1] + (exp_a[tag][1] * exp_a[tag][3] - sigma * mu) * mhi)
        rhs_cr_c, rhs_ch_c, _ = make_rhs(rm_c)
        dzc, dzh, dlc, dlh = solve_kkt(
            fact_ch, fact_cr, rhs_cr_c, rhs_ch_c, rb_cr, rb_ch,
            hbars=hbars_fact)
        exp = expand_all(dzc, dzh, rm_c)
        alpha = alpha_of(exp, opts.tau_frac_general if HG
                         else opts.tau_frac)

        ok = ~(jnp.isnan(alpha) | jnp.isnan(jnp.sum(dzc)) |
               jnp.isnan(jnp.sum(dzh)))
        if shard is not None:
            ok = shard.all_true(ok)  # predicates must agree across devices
        alpha = jnp.where(ok, alpha, 0.0)
        # sanitize the directions too: alpha = 0 alone still poisons the
        # iterate (0 * NaN = NaN) — cf. the same guard in ipm.py
        san = lambda v: jnp.where(ok, v, 0.0)
        dzc, dzh, dlc, dlh = san(dzc), san(dzh), san(dlc), san(dlh)
        exp = {tag: tuple(san(v) for v in exp[tag]) for tag in TAGS}
        st2 = dict(st)
        st2["z_cr"] = st["z_cr"] + alpha * dzc
        st2["z_ch"] = st["z_ch"] + alpha * dzh
        st2["lam_cr"] = st["lam_cr"] + alpha * dlc * nrxm
        st2["lam_ch"] = st["lam_ch"] + alpha * dlh
        for tag in TAGS:
            _, _, mlo, mhi = SEC[tag]
            st2["slo_" + tag] = jnp.where(
                mlo > 0, st["slo_" + tag] + alpha * exp[tag][0], 1.0)
            st2["shi_" + tag] = jnp.where(
                mhi > 0, st["shi_" + tag] + alpha * exp[tag][1], 1.0)
            st2["llo_" + tag] = jnp.where(
                mlo > 0, st["llo_" + tag] + alpha * exp[tag][2], 0.0)
            st2["lhi_" + tag] = jnp.where(
                mhi > 0, st["lhi_" + tag] + alpha * exp[tag][3], 0.0)

        status = jnp.where((alpha < opts.alpha_min) | ~ok,
                           IPM_MIN_STEP, status)
        out = residuals(st2)
        res4 = res4_of(*out)
        # best-iterate tracking + stall detection (cf. ipm.py: the
        # residual floor can sit at the tolerance; iterating
        # past it blows up the late-barrier systems). Armed only in the
        # late-barrier regime — the early Mehrotra phase is legitimately
        # non-monotone in max(res4).
        m4 = jnp.max(res4)
        better = m4 < jnp.max(best4)
        mu2 = mu_of(st2)
        noimp = jnp.where(m4 < 0.9 * jnp.max(best4), 0,
                          jnp.where(mu2 < opts.tol, noimp + 1, 0))
        sel = lambda a, b: jnp.where(better, a, b)
        bst = jax.tree_util.tree_map(sel, st2, bst)
        best4 = jax.tree_util.tree_map(sel, res4, best4)
        return st2, it + 1, status, res4, bst, best4, noimp

    def cond(carry):
        _, it, status, res4, _, _, noimp = carry
        ok = ((jnp.max(res4) >= opts.tol) & (status == IPM_OPTIMAL)
              & (it < opts.max_iter))
        if opts.stall_patience > 0:
            ok = ok & (noimp < opts.stall_patience)
        return ok

    init = (st0, jnp.zeros((), jnp.int32),
            jnp.full((), IPM_OPTIMAL, jnp.int32), jnp.full((4,), jnp.inf, dt),
            st0, jnp.full((4,), jnp.inf, dt), jnp.zeros((), jnp.int32))
    if opts.factor_dtype == "float32" and dt == jnp.float64:
        switch = max(opts.tol, opts.f32_until)

        def cond_a(carry):
            _, it, status, res4, _, _, noimp = carry
            ok = ((jnp.max(res4) >= switch) & (status == IPM_OPTIMAL)
                  & (it < opts.max_iter))
            if opts.stall_patience > 0:
                ok = ok & (noimp < opts.stall_patience)
            return ok

        st, it, status, res4, bst, best4, _ = jax.lax.while_loop(
            cond_a, partial(iteration, fdt=jnp.float32), init)
        init = (st, it, jnp.full((), IPM_OPTIMAL, jnp.int32), res4,
                bst, best4, jnp.zeros((), jnp.int32))
    st, it, status, res4, bst, best4, _ = jax.lax.while_loop(
        cond, iteration, init)
    use_best = jnp.max(best4) < jnp.max(res4)
    selb = lambda a, b: jnp.where(use_best, a, b)
    st = jax.tree_util.tree_map(selb, bst, st)
    res4 = jax.tree_util.tree_map(selb, best4, res4)
    status = jnp.where((status == IPM_OPTIMAL) & ~(jnp.max(res4) < opts.tol),
                       IPM_MAX_ITER, status)
    status = jnp.where((status == IPM_MIN_STEP) & (jnp.max(res4) < opts.tol),
                       IPM_OPTIMAL, status)

    # --- export (signed fold mu = l_hi - l_lo, hpmpc_tree.c:405-433)
    mu_cr = st["lhi_cr"] - st["llo_cr"]
    mu_ch = st["lhi_ch"] - st["llo_ch"]
    crown_out = dict(
        x=st["z_cr"][:, :nxm] * xm, u=st["z_cr"][:, nxm:] * um,
        lam=st["lam_cr"] * nrxm,
        mu_x=mu_cr[:, :nxm] * xm, mu_u=mu_cr[:, nxm:] * um)
    chain_out = dict(
        x=st["z_ch"][:, :, :nxm] * xmask_ch,
        u=st["z_ch"][:, :, nxm:] * umask_ch,
        lam=st["lam_ch"],
        mu_x=mu_ch[:, :, :nxm] * xmask_ch,
        mu_u=mu_ch[:, :, nxm:] * umask_ch)
    if HG:
        crown_out["mu_d"] = (st["lhi_crg"] - st["llo_crg"]) * cm_cr
        chain_out["mu_d"] = (st["lhi_chg"] - st["llo_chg"]) * cm_ch
    info = dict(iter=it, status=status, res4=res4)
    return crown_out, chain_out, info
