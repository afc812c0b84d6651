"""df64 (double-float) final phase of the multistage dual-Newton solve.

The two-phase schedule (tdunes_multistage.tdunes_ms_solve) runs coarse
f32 Newton iterations to ~1e-4/1e-5, then a short high-precision phase to
the final tolerance. This module runs that phase in two-f32
double-float arithmetic, for devices without fast native f64 (treeqp_tpu.ops.df64): every high-precision
quantity — stage solutions, dual gradients, dual values, the exact Hessian
action for iterative refinement, and the lambda iterate itself — is an
(hi, lo) f32 pair manipulated by short fusable f32 op sequences, while the
factorization/solve machinery stays the plain f32 path.

Accuracy: df64 carries ~48 mantissa bits (~3.6e-16 .. 1e-14 relative in
practice), comfortably below the 1e-8 KKT target and matching the native
f64 phase to ~1e-12 on the golden problems (tests/test_ms_df64.py).

Semantics mirror `_ms_newton_loop` (same Armijo acceptance, refinement,
restart and status logic — reference line_search dual_Newton_tree.c:
922-1019, solve loop :218-330); only the arithmetic changed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.ops import df64 as df
from treeqp_tpu.ops.df64 import Df
from treeqp_tpu.solvers import tdunes as td
from treeqp_tpu.solvers import tdunes_multistage as tm
from treeqp_tpu.solvers.tdunes import (
    TdunesOpts, TDUNES_OPTIMAL, TDUNES_NOT_DESCENT)

__all__ = ["ms_newton_loop_df"]

f32 = jnp.float32


def _mask(x: Df, m) -> Df:
    """Multiply by an exact 0/1 mask (error-free)."""
    return Df(x.hi * m, x.lo * m)


def _cat(xs, axis) -> Df:
    return Df(jnp.concatenate([x.hi for x in xs], axis),
              jnp.concatenate([x.lo for x in xs], axis))


def _contract(A: Df, x: Df, axis: int) -> Df:
    """sum_k A[..., k, :] * x[..., k, None] over `axis` (the contraction
    axis of A; x is broadcast along A's last axis). Elementwise df64
    products + a two-sum tree: the df64 replacement for an einsum."""
    return df.df_sum(df.mul(A, Df(jnp.expand_dims(x.hi, -1),
                                  jnp.expand_dims(x.lo, -1))), axis=axis)


def _contract_f32(A: Df, x, axis: int) -> Df:
    """Same, with a plain-f32 x (exact two-product lift)."""
    return df.df_sum(df.mul_f32(A, jnp.expand_dims(x, -1)), axis=axis)


def _sum_terms(terms) -> Df:
    """df64 sum over every element of every term array: a binary two-sum
    tree (df_sum) over the flattened terms, zero-padded to a power of two
    (~log2(n) df-ulp error). log2(n) vectorized levels, not a sequential
    accumulation chain, whose straight-line length would make compile
    time and execution superlinear."""
    x = Df(jnp.concatenate([t.hi.reshape(-1) for t in terms]),
           jnp.concatenate([t.lo.reshape(-1) for t in terms]))
    n = x.hi.size
    m = 1 << max(n - 1, 0).bit_length()  # pad to a power of two
    z = jnp.zeros((m - n,), f32)
    x = Df(jnp.concatenate([x.hi, z]), jnp.concatenate([x.lo, z]))
    s = df.df_sum(Df(x.hi[None], x.lo[None]), axis=1)
    return Df(s.hi.reshape(()), s.lo.reshape(()))


def _dfdot(a: Df, b) -> Df:
    """<a, b> with b plain f32, full df64 accumulation."""
    return _sum_terms([df.mul_f32(a, b)])


# ---------------------------------------------------------------------------
# problem data in df64 form (loop-invariant; XLA hoists it out of solver
# loops / closed-loop scans)


def make_dd(ms: tm.MultistageQP, opts: TdunesOpts, prep_cr):
    qp = ms.crown
    xm, um, nrxm = td._masks(qp)
    crown_data = td._stage_data(qp, opts)
    rid = np.asarray(ms.meta.root_ids)
    # parent node of each lambda-group (all members share one parent)
    pnode = np.asarray(prep_cr.par)[np.asarray(prep_cr.kidsP)[:, 0]]
    dd = dict(
        xm=xm.astype(f32), um=um.astype(f32), nrxm=nrxm.astype(f32),
        kv=jnp.asarray(prep_cr.kvalid, f32),
        # --- chain data [S, L, ...]; [A B] packed along the output axis and
        # [A'; B'] stacked along the contraction axis: every per-iteration
        # dynamics contraction is ONE df64 contract instead of two
        A=df.from_f64(ms.A), AT=df.from_f64(ms.A.swapaxes(2, 3)),
        B=df.from_f64(ms.B), BT=df.from_f64(ms.B.swapaxes(2, 3)),
        ABp=df.from_f64(jnp.concatenate([ms.A, ms.B], axis=3)),
        ABT=df.from_f64(jnp.concatenate(
            [ms.A.swapaxes(2, 3), ms.B.swapaxes(2, 3)], axis=2)),
        b=df.from_f64(ms.b), q=df.from_f64(ms.q), r=df.from_f64(ms.r),
        Qd=df.from_f64(ms.Qd), Rd=df.from_f64(ms.Rd),
        Qinv=df.from_f64(1.0 / ms.Qd), Rinv=df.from_f64(1.0 / ms.Rd),
        xmin=df.from_f64(ms.xmin), xmax=df.from_f64(ms.xmax),
        umin=df.from_f64(ms.umin), umax=df.from_f64(ms.umax),
        # --- crown data [Nn, ...]
        cA=df.from_f64(qp.A), cAT=df.from_f64(qp.A.swapaxes(1, 2)),
        cB=df.from_f64(qp.B), cBT=df.from_f64(qp.B.swapaxes(1, 2)),
        cABp=df.from_f64(jnp.concatenate([qp.A, qp.B], axis=2)),
        cABT=df.from_f64(jnp.concatenate(
            [qp.A.swapaxes(1, 2), qp.B.swapaxes(1, 2)], axis=1)),
        cb=df.from_f64(qp.b), cq=df.from_f64(qp.q), crr=df.from_f64(qp.r),
        cQd=df.from_f64(crown_data["Qd"]), cRd=df.from_f64(crown_data["Rd"]),
        cQinv=df.from_f64(crown_data["Qinv"]),
        cRinv=df.from_f64(crown_data["Rinv"]),
        cxmin=df.from_f64(qp.xmin), cxmax=df.from_f64(qp.xmax),
        cumin=df.from_f64(qp.umin), cumax=df.from_f64(qp.umax),
    )
    meta = dict(rid=rid, pnode=pnode)
    return dd, meta


# ---------------------------------------------------------------------------
# df64 versions of the per-iteration quantities


def _kid_sums(dd, meta, prep_cr, AtBtL: Df):
    """sum over each node's children of the packed [A'lam B'lam] rows (the
    segment_sum in _modified_gradient) via the padded kid-group gather +
    masked df tree sum; scattered back to parent-node rows (each parent
    owns exactly one kid group, so scatter-set is exact). Returns the
    packed [Nn, nxm+num] sum (callers split)."""
    kidsP = np.asarray(prep_cr.kidsP)
    kv = dd["kv"][:, :, None]
    Nn = prep_cr.Nn
    s_g = df.df_sum(_mask(AtBtL[kidsP], kv), axis=1)  # [NpG, nxm+num]
    pn = meta["pnode"]

    def scat(v):
        return jnp.zeros((Nn, v.shape[-1]), f32).at[pn].set(v)

    return Df(scat(s_g.hi), scat(s_g.lo))


def df_stage_solve(dd, meta, prep_cr, lam_cr: Df, lam_ch: Df):
    """Clipping stage solve + modified gradients for crown and chains
    (mirrors _ms_stage_solve with stage_solver='clipping')."""
    xm, um = dd["xm"], dd["um"]
    # --- chain part (cf. _chain_stage_solve); packed [A B] contraction
    ABup = _contract(dd["ABp"][:, 1:], lam_ch[:, 1:], axis=2)
    S, L, nx = lam_ch.hi.shape
    Aup, Bup = ABup[..., :nx], ABup[..., nx:]
    zq = Df(jnp.zeros((S, 1, nx), f32), jnp.zeros((S, 1, nx), f32))
    zr = Df(jnp.zeros((S, 1, Bup.hi.shape[-1]), f32),
            jnp.zeros((S, 1, Bup.hi.shape[-1]), f32))
    qmod = df.sub(df.add(df.neg(dd["q"]), lam_ch), _cat([Aup, zq], 1))
    rmod = df.sub(df.neg(dd["r"]), _cat([Bup, zr], 1))
    xUnc = df.mul(dd["Qinv"], qmod)
    uUnc = df.mul(dd["Rinv"], rmod)
    x = df.clip(xUnc, dd["xmin"], dd["xmax"])
    u = df.clip(uUnc, dd["umin"], dd["umax"])
    x_act = df.less(xUnc, dd["xmin"]) | df.less(dd["xmax"], xUnc)
    u_act = df.less(uUnc, dd["umin"]) | df.less(dd["umax"], uUnc)
    qt = df.where(x_act, df.from_f32(jnp.zeros_like(xUnc.hi)), dd["Qinv"])
    rt = df.where(u_act, df.from_f32(jnp.zeros_like(uUnc.hi)), dd["Rinv"])
    ch = dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc,
              qt=qt, rt=rt)

    # --- chain -> crown root contributions (cf. _chain_root_contrib),
    # packed [S, nxm+num]
    cqr = _contract(dd["ABp"][:, 0], lam_ch[:, 0], axis=1)
    rid = meta["rid"]
    Nn = prep_cr.Nn

    def rscat(v):
        return jnp.zeros((Nn, v.shape[-1]), f32).at[rid].set(v)

    extra = Df(rscat(cqr.hi), rscat(cqr.lo))

    # --- crown clipping solve (cf. _modified_gradient + _stage_solve)
    nxm_c = lam_cr.hi.shape[-1]
    AtBtL = _contract(dd["cABp"], lam_cr, axis=1)   # [Nn, nxm+num]
    sum_AB = df.add(_kid_sums(dd, meta, prep_cr, AtBtL), extra)
    sum_A, sum_B = sum_AB[..., :nxm_c], sum_AB[..., nxm_c:]
    cqmod = _mask(df.sub(df.add(df.neg(dd["cq"]), lam_cr), sum_A), xm)
    crmod = _mask(df.sub(df.neg(dd["crr"]), sum_B), um)
    cxUnc = df.mul(dd["cQinv"], cqmod)
    cuUnc = df.mul(dd["cRinv"], crmod)
    cx = _mask(df.clip(cxUnc, dd["cxmin"], dd["cxmax"]), xm)
    cu = _mask(df.clip(cuUnc, dd["cumin"], dd["cumax"]), um)
    cx_act = df.less(cxUnc, dd["cxmin"]) | df.less(dd["cxmax"], cxUnc)
    cu_act = df.less(cuUnc, dd["cumin"]) | df.less(dd["cumax"], cuUnc)
    cqt = df.where(cx_act, df.from_f32(jnp.zeros_like(cxUnc.hi)), dd["cQinv"])
    crt = df.where(cu_act, df.from_f32(jnp.zeros_like(cuUnc.hi)), dd["cRinv"])
    cr = dict(qmod=cqmod, rmod=crmod, x=cx, u=cu, xUnc=cxUnc, uUnc=cuUnc,
              qtilde=cqt, rtilde=crt)
    return cr, ch


def df_residuals(dd, meta, prep_cr, cr, ch):
    """Dual gradients (cf. _dual_residual + _chain_residual); stacked
    [A'; B'] against [x; u] — one df64 contraction per residual."""
    par = np.asarray(prep_cr.par)
    zp = _cat([Df(cr["x"].hi[par], cr["x"].lo[par]),
               Df(cr["u"].hi[par], cr["u"].lo[par])], 1)
    res_cr = _mask(
        df.sub(df.add(_contract(dd["cABT"], zp, axis=1), dd["cb"]),
               cr["x"]),
        dd["nrxm"])
    rid = meta["rid"]
    xpc = _cat([Df(cr["x"].hi[rid][:, None], cr["x"].lo[rid][:, None]),
                Df(ch["x"].hi[:, :-1], ch["x"].lo[:, :-1])], 1)
    upc = _cat([Df(cr["u"].hi[rid][:, None], cr["u"].lo[rid][:, None]),
                Df(ch["u"].hi[:, :-1], ch["u"].lo[:, :-1])], 1)
    zc = _cat([xpc, upc], 2)
    res_ch = df.sub(df.add(_contract(dd["ABT"], zc, axis=2), dd["b"]),
                    ch["x"])
    return res_cr, res_ch


def df_dual_value(dd, lam_cr: Df, lam_ch: Df, cr, ch) -> Df:
    """f(lambda) = -g(lambda) (cf. _ms_dual_value), df64 throughout: the
    Armijo comparisons resolve differences ~1e-10 of O(1e3) values. All
    per-element terms are signed up front so ONE fused reduction covers
    quad + lin + cmod."""
    half = jnp.float32(-0.5)
    terms = [
        df.mul_f32(df.mul(df.mul(cr["x"], dd["cQd"]), cr["x"]), half),
        df.mul_f32(df.mul(df.mul(cr["u"], dd["cRd"]), cr["u"]), half),
        df.mul_f32(df.mul(df.mul(ch["x"], dd["Qd"]), ch["x"]), half),
        df.mul_f32(df.mul(df.mul(ch["u"], dd["Rd"]), ch["u"]), half),
        df.mul(cr["qmod"], cr["x"]),
        df.mul(cr["rmod"], cr["u"]),
        df.mul(ch["qmod"], ch["x"]),
        df.mul(ch["rmod"], ch["u"]),
        df.neg(df.mul(dd["cb"], lam_cr)),
        df.neg(df.mul(dd["b"], lam_ch)),
    ]
    return _sum_terms(terms)


def df_apply_M(dd, meta, prep_cr, cr, ch, dcr, dch):
    """Exact dual-Hessian action M d (cf. _ms_apply_M) with df64 masked
    inverses: the refinement residual res - M d cancels ~6 digits, so M d
    must be accurate well below the f32 direction error."""
    xm, um, nrxm = dd["xm"], dd["um"], dd["nrxm"]
    nxm_c = dcr.shape[-1]
    AtBtL = _contract_f32(dd["cABp"], dcr, axis=1)
    sum_AB = _kid_sums(dd, meta, prep_cr, AtBtL)
    # chain root contributions of dch (packed [S, nxm+num])
    cqr = _contract_f32(dd["ABp"][:, 0], dch[:, 0], axis=1)
    rid = meta["rid"]
    Nn = prep_cr.Nn

    def rscat(v):
        return jnp.zeros((Nn, v.shape[-1]), f32).at[rid].set(v)

    sum_AB = df.add(sum_AB, Df(rscat(cqr.hi), rscat(cqr.lo)))
    sum_A = sum_AB[..., :nxm_c]
    sum_B = sum_AB[..., nxm_c:]
    xl = _mask(df.mul(cr["qtilde"],
                      df.sub(Df(dcr, jnp.zeros_like(dcr)), sum_A)), xm)
    ul = _mask(df.mul(cr["rtilde"], df.neg(sum_B)), um)
    # chain linear response (packed [A B])
    ABup = _contract_f32(dd["ABp"][:, 1:], dch[:, 1:], axis=2)
    S, L, nx = dch.shape
    Aup, Bup = ABup[..., :nx], ABup[..., nx:]
    zq = Df(jnp.zeros((S, 1, nx), f32), jnp.zeros((S, 1, nx), f32))
    zr = Df(jnp.zeros((S, 1, Bup.hi.shape[-1]), f32),
            jnp.zeros((S, 1, Bup.hi.shape[-1]), f32))
    qml = df.sub(Df(dch, jnp.zeros_like(dch)), _cat([Aup, zq], 1))
    rml = df.neg(_cat([Bup, zr], 1))
    xlc = df.mul(ch["qt"], qml)
    ulc = df.mul(ch["rt"], rml)
    # linearized residuals (stacked [A'; B'] against [x; u])
    par = np.asarray(prep_cr.par)
    zpr = _cat([Df(xl.hi[par], xl.lo[par]), Df(ul.hi[par], ul.lo[par])], 1)
    res_cr = _mask(df.sub(_contract(dd["cABT"], zpr, axis=1), xl), nrxm)
    xpc = _cat([Df(xl.hi[rid][:, None], xl.lo[rid][:, None]),
                Df(xlc.hi[:, :-1], xlc.lo[:, :-1])], 1)
    upc = _cat([Df(ul.hi[rid][:, None], ul.lo[rid][:, None]),
                Df(ulc.hi[:, :-1], ulc.lo[:, :-1])], 1)
    res_ch = df.sub(_contract(dd["ABT"], _cat([xpc, upc], 2), axis=2), xlc)
    return df.neg(res_cr), df.neg(res_ch)


# ---------------------------------------------------------------------------
# the Newton loop


def ms_newton_loop_df(ms: tm.MultistageQP, lam0_crown, lam0_chain,
                      opts: TdunesOpts, it0, handover=None):
    """df64 mirror of _ms_newton_loop (f64-data semantics, f32 speed).

    ``lam0_crown``/``lam0_chain`` may be f32 or f64; returns the same
    solution tuple as _ms_newton_loop (without its trailing handover).
    ``handover``: the coarse f32 phase's last (fact, sig) — when the
    active-set PATTERN at the phase boundary is unchanged (it almost
    always is: same lambda), the initial factorization is reused instead
    of recomputed (the factors are f32 either way; refinement absorbs the
    ulp-level differences between f32-data and df64-hi stage inverses).
    """
    meta_ms = ms.meta
    prep_cr = td._get_prep(meta_ms.crown_topo)
    dd, meta = make_dd(ms, opts, prep_cr)
    nrxm = dd["nrxm"]

    rid = meta["rid"]
    g_of = prep_cr.group_of_node[rid]
    slot = prep_cr.slot_of_node[rid]
    nxm = meta_ms.crown_topo.nxm
    rows = slot[:, None] * nxm + np.arange(nxm)[None, :]

    def to_df(v):
        if v.dtype == jnp.float64:
            return df.from_f64(v)
        return df.from_f32(v.astype(f32))

    lam_cr0 = _mask(to_df(lam0_crown), nrxm)
    lam_ch0 = to_df(lam0_chain)

    def compute_residuals(lam_cr, lam_ch):
        cr, ch = df_stage_solve(dd, meta, prep_cr, lam_cr, lam_ch)
        res_cr, res_ch = df_residuals(dd, meta, prep_cr, cr, ch)
        return cr, ch, res_cr, res_ch

    def residuals_of(cr, ch):
        return df_residuals(dd, meta, prep_cr, cr, ch)

    def error_of(res_cr, res_ch):
        if opts.termination == "infnorm":
            return jnp.maximum(jnp.max(jnp.abs(res_cr.hi)),
                               jnp.max(jnp.abs(res_ch.hi)))
        sq = jnp.sum(res_cr.hi ** 2) + jnp.sum(res_ch.hi ** 2)
        return jnp.sqrt(sq) if opts.termination == "twonorm" else sq

    def dual_value_of(lam_cr, lam_ch, cr, ch):
        return df_dual_value(dd, lam_cr, lam_ch, cr, ch)

    def apply_M_of(cr, ch, dcr, dch):
        return df_apply_M(dd, meta, prep_cr, cr, ch, dcr, dch)

    def factorize(cr, ch):
        # shared with the f64 loop
        return tm._ms_factorize(ms, cr["qtilde"].hi, cr["rtilde"].hi,
                                ch["qt"].hi, ch["rt"].hi, opts, prep_cr,
                                g_of, rows, nrxm, f32)

    def active_sig(cr, ch):
        # reuse key (see tdunes_multistage.factorize): hi words of the
        # masked inverses are Qinv-or-0 — equality == pattern equality
        return (cr["qtilde"].hi, cr["rtilde"].hi, ch["qt"].hi, ch["rt"].hi)

    def sig_equal(a, b):
        eq = [jnp.all(x == y) for x, y in zip(a, b)]
        out = eq[0]
        for e in eq[1:]:
            out = out & e
        return out

    def newton_step(carry, f0, cr, ch, res_cr, res_ch, fact_prev, sig_prev):
        # f0 = f(lam) is carried from the previous line search's accepted
        # evaluation (it IS the same quantity) — one full df64 dual-value
        # reduction per iteration saved
        lam_cr, lam_ch, it, err, status, restart, ls_it = carry

        sig = active_sig(cr, ch)
        if opts.reuse_factorization:
            fact = jax.lax.cond(sig_equal(sig, sig_prev),
                                lambda: fact_prev, lambda: factorize(cr, ch))
        else:
            fact = factorize(cr, ch)
        # f32 in / f32 out
        solve = tm._make_ms_solve(fact, meta_ms, prep_cr, opts, f32, nrxm,
                                  g_of, rows, rid)

        def refine_resid(dcr, dch):
            mcr, mch = apply_M_of(cr, ch, dcr, dch)
            return df.sub(res_cr, mcr), df.sub(res_ch, mch)

        dlam_cr, dlam_ch = solve(res_cr.hi, res_ch.hi)
        if opts.refine_steps > 0 and not opts.refine_safeguard:
            for _ in range(opts.refine_steps):
                rcr, rch = refine_resid(dlam_cr, dlam_ch)
                ccr, cch = solve(rcr.hi, rch.hi)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
        elif opts.refine_steps > 0:
            # safeguarded = iterate UNCONDITIONALLY, return the best
            # iterate by Newton-system residual norm. Refinement with f32
            # factors is non-monotone on ill-conditioned active sets: a
            # transiently-worse step is often the escape route (measured:
            # keep-best-and-retry stalls exactly where unconditional
            # refinement converges), while unconditional application
            # WITHOUT the final argmin can overshoot on the last step.
            def resnorm(dcr, dch):
                rcr, rch = refine_resid(dcr, dch)
                n = jnp.sum(rcr.hi ** 2) + jnp.sum(rch.hi ** 2)
                return n, rcr, rch
            n_best, rcr, rch = resnorm(dlam_cr, dlam_ch)
            best_cr, best_ch = dlam_cr, dlam_ch
            for _ in range(opts.refine_steps):
                ccr, cch = solve(rcr.hi, rch.hi)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
                n_new, rcr, rch = resnorm(dlam_cr, dlam_ch)
                better = n_new < n_best
                best_cr = jnp.where(better, dlam_cr, best_cr)
                best_ch = jnp.where(better, dlam_ch, best_ch)
                n_best = jnp.where(better, n_new, n_best)
            dlam_cr, dlam_ch = best_cr, best_ch

        # --- Armijo on f = -g (df64 values: the comparisons resolve
        # differences far below f32 ulps of f0)
        dot = df.neg(_sum_terms([df.mul_f32(res_cr, dlam_cr),
                                 df.mul_f32(res_ch, dlam_ch)]))
        dot_hi = dot.hi
        descent_ok = dot_hi < 1e-10  # NaN compares false -> not ok; documented
        # deviation: reference requires < 0 (dual_Newton_tree.c:951)
        # but near the residual floor g'd rounds to ~+-eps — the
        # 1e-10 slack avoids spurious NOT_DESCENT exits there

        def lam_at(tau):
            lc = df.add(lam_cr, df.mul_f32(Df(dlam_cr, jnp.zeros_like(dlam_cr)), tau))
            lh = df.add(lam_ch, df.mul_f32(Df(dlam_ch, jnp.zeros_like(dlam_ch)), tau))
            return lc, lh

        def f_at(tau):
            lc, lh = lam_at(tau)
            cr2, ch2 = df_stage_solve(dd, meta, prep_cr, lc, lh)
            return dual_value_of(lc, lh, cr2, ch2), cr2, ch2

        # noise-aware Armijo (Hager-Zhang-style approximate descent): the
        # df64 dual value carries ~sqrt(Nterms) * 2^-48 relative noise, so
        # near convergence the true decrease gamma*tau*dot (~err^2) drops
        # BELOW the measurement noise and an exact comparison rejects every
        # step — the solver then stalls just above tolerance (measured:
        # deterministic 1.07e-8 stall at |f0| ~ 1.5e4). The slack admits
        # steps whose decrease is indistinguishable from zero at the
        # arithmetic's resolution; far from convergence it is negligible
        # against dot.
        eta = jnp.float32(2.0 ** -38) * jnp.abs(f0.hi)

        def accepts(f2, tau):
            # f2 <= f0 + gamma*tau*dot + eta  (all df64)
            rhs = df.add(f0, df.mul_f32(dot, jnp.float32(opts.ls_gamma) * tau))
            rhs = df.add(rhs, Df(eta, jnp.zeros_like(eta)))
            return ~df.less(rhs, f2)

        def cond_ls(c):
            tau, fv, i, acc, _, _ = c
            return (~acc) & (i < opts.ls_max_iter)

        def body_ls(c):
            tau, fv, i, acc, _, _ = c
            tau2 = jnp.float32(opts.ls_beta) * tau
            f2, cr2, ch2 = f_at(tau2)
            return (tau2, f2, i + 1, accepts(f2, tau2), cr2, ch2)

        # every path carries the accepted tau's stage solution AND dual
        # value so the next iteration reuses them (its f0 is exactly this
        # f) instead of re-solving / re-reducing
        one = jnp.ones((), f32)
        f1, cr1, ch1 = f_at(one)
        acc1 = accepts(f1, one)
        T = min(opts.ls_batch, opts.ls_max_iter)
        if T > 0:
            def quick_path():
                return (one, f1, jnp.ones((), jnp.int32),
                        jnp.ones((), bool), cr1, ch1)

            def batch_path():
                taus = jnp.float32(opts.ls_beta) ** \
                    jnp.arange(1, T + 1, dtype=f32)
                fs, crs, chs = jax.vmap(f_at)(taus)
                accs = jax.vmap(accepts)(fs, taus)
                any_acc = jnp.any(accs)
                idx = jnp.argmax(accs)
                at = lambda tree, i: jax.tree_util.tree_map(
                    lambda a: a[i], tree)
                init = (taus[-1], at(fs, -1),
                        jnp.full((), T + 1, jnp.int32), any_acc,
                        at(crs, -1), at(chs, -1))
                tau_sq, f_sq, it_sq, acc, crq, chq = jax.lax.while_loop(
                    cond_ls, body_ls, init)
                tau = jnp.where(any_acc, taus[idx], tau_sq)
                ls_it = jnp.where(any_acc, (idx + 2).astype(jnp.int32), it_sq)
                sel = lambda a, b: jax.tree_util.tree_map(
                    lambda x, y: jnp.where(any_acc, x, y), a, b)
                return (tau, sel(at(fs, idx), f_sq), ls_it, acc,
                        sel(at(crs, idx), crq), sel(at(chs, idx), chq))

            tau, f_t, ls_it, acc, cr_t, ch_t = jax.lax.cond(
                acc1, quick_path, batch_path)
        else:
            tau, f_t, ls_it, acc, cr_t, ch_t = jax.lax.while_loop(
                cond_ls, body_ls, (one, f1, jnp.ones((), jnp.int32), acc1,
                                   cr1, ch1))
        maxed = ~acc
        restart = jnp.where(maxed, restart + 1, 0)
        full_step = (opts.ls_restart_trigger > 0) & \
            (restart >= opts.ls_restart_trigger)
        restart = jnp.where(full_step, 0, restart)
        sel_fs = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(full_step, x, y), a, b)
        tau = jnp.where(full_step, one, tau)
        f_t = sel_fs(f1, f_t)
        cr_t = sel_fs(cr1, cr_t)
        ch_t = sel_fs(ch1, ch_t)

        lc2, lh2 = lam_at(tau)
        keep = descent_ok
        lam_cr2 = df.where(keep, lc2, lam_cr)
        lam_ch2 = df.where(keep, lh2, lam_ch)
        selk = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(keep, x, y), a, b)
        f_t = selk(f_t, f0)
        cr_t = selk(cr_t, cr)
        ch_t = selk(ch_t, ch)
        status = jnp.where(keep, status, TDUNES_NOT_DESCENT)
        return (lam_cr2, lam_ch2, it + 1, err, status, restart, ls_it), \
            fact, sig, f_t, cr_t, ch_t

    def cond(carry):
        (_, _, it, err, status, _, _), _, _, _, _ = carry
        return (err >= opts.tol) & (status == TDUNES_OPTIMAL) & \
            (it < opts.max_iter)

    def body(carry):
        (lam_cr, lam_ch, it, err, status, restart, ls_it), \
            (cr, ch, res_cr, res_ch), f0, fact, sig = carry
        stepped, fact2, sig2, f2, cr2, ch2 = newton_step(
            (lam_cr, lam_ch, it, err, status, restart, ls_it),
            f0, cr, ch, res_cr, res_ch, fact, sig)
        lam_cr2, lam_ch2 = stepped[0], stepped[1]
        rc2, rh2 = residuals_of(cr2, ch2)
        err2 = error_of(rc2, rh2)
        state = (lam_cr2, lam_ch2, stepped[2], err2, stepped[4], stepped[5],
                 stepped[6])
        return state, (cr2, ch2, rc2, rh2), f2, fact2, sig2

    cr0, ch0, rc0, rh0 = compute_residuals(lam_cr0, lam_ch0)
    err0 = error_of(rc0, rh0)
    f0_init = dual_value_of(lam_cr0, lam_ch0, cr0, ch0)
    sig0 = active_sig(cr0, ch0)
    if handover is not None:
        fact_h, sig_h = handover
        fact0 = jax.lax.cond(tm._pattern_equal(sig0, sig_h),
                             lambda: fact_h, lambda: factorize(cr0, ch0))
    else:
        fact0 = factorize(cr0, ch0)
    init = ((lam_cr0, lam_ch0, jnp.asarray(it0, jnp.int32), err0,
             jnp.full((), TDUNES_OPTIMAL, jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            (cr0, ch0, rc0, rh0), f0_init, fact0, sig0)
    (lam_cr, lam_ch, it, err, status, _, ls_it), (cr, ch, _, _), _, _, _ = \
        jax.lax.while_loop(cond, body, init)

    cr64 = {k: df.to_f64(v) for k, v in cr.items()}
    ch64 = {k: df.to_f64(v) for k, v in ch.items()}
    return (df.to_f64(lam_cr), df.to_f64(lam_ch), it, status, ls_it,
            cr64, ch64, err.astype(jnp.float64))
