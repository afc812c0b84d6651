"""df64 (double-float) final phase of the sdunes dual-Newton solve.

It runs the data-dtype phase of sdunes (stage solves, residuals, dual
values and the refinement Hessian action) in two-f32 double-float
arithmetic instead of native f64. This module mirrors solvers/ms_df64.py for the scenario
decomposition: every high-precision quantity is an (hi, lo) f32 pair
manipulated with the error-free transforms of ops/df64, while the f32
machinery — banded per-scenario factorization (_sd_factor /
_sd_full_solve), coupling Schur pieces and the cyclic-reduction Jay solve
— is shared with the plain loop unchanged.

Semantics mirror sdunes._sd_newton_loop (same Armijo rule, refinement,
gradient-fallback globalization, status logic — reference
dual_Newton_scenarios.c:1850-2091, line search :1385-1449); only the
arithmetic of the exact-data-path quantities changed.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.ops import df64 as df
from treeqp_tpu.ops.df64 import Df
from treeqp_tpu.solvers import sdunes as sd
from treeqp_tpu.solvers.ms_df64 import (_cat, _contract, _contract_f32,
                                        _mask, _sum_terms)
from treeqp_tpu.solvers.tdunes import TDUNES_OPTIMAL, TDUNES_NOT_DESCENT

__all__ = ["sd_newton_loop_df"]

f32 = jnp.float32


def _zero_df(shape):
    z = jnp.zeros(shape, f32)
    return Df(z, z)


def make_dd(sqp: sd.ScenarioQP):
    """Loop-invariant df64 problem data (hoisted by XLA)."""
    return dict(
        A=df.from_f64(sqp.A), AT=df.from_f64(sqp.A.swapaxes(2, 3)),
        B=df.from_f64(sqp.B), BT=df.from_f64(sqp.B.swapaxes(2, 3)),
        b=df.from_f64(sqp.b), q=df.from_f64(sqp.q), r=df.from_f64(sqp.r),
        Qd=df.from_f64(sqp.Qd), Rd=df.from_f64(sqp.Rd),
        Qinv=df.from_f64(1.0 / sqp.Qd), Rinv=df.from_f64(1.0 / sqp.Rd),
        xmin=df.from_f64(sqp.xmin), xmax=df.from_f64(sqp.xmax),
        umin=df.from_f64(sqp.umin), umax=df.from_f64(sqp.umax))


def df_stage_solve(dd, meta, cmask32, mu: Df, lam: Df):
    """Clipping stage solves (mirror of sdunes._stage_solve)."""
    Ns, Nr = meta.Ns, meta.Nr
    Atmu = _contract(dd["A"], mu, axis=2)     # A_k' mu_{k+1}: sum over i
    Btmu = _contract(dd["B"], mu, axis=2)
    qmod = df.neg(dd["q"])
    qmod = _cat([qmod[:, :1],
                 df.add(qmod[:, 1:], mu)], 1)
    qmod = _cat([df.sub(qmod[:, :-1], Atmu), qmod[:, -1:]], 1)
    rmod = df.neg(dd["r"])
    rmod = _cat([df.sub(rmod[:, :-1], Btmu), rmod[:, -1:]], 1)
    if Ns > 1:
        lm = _mask(lam, cmask32[..., None])   # [Ns-1, Nr, nu]
        # rmod[:-1, :Nr] -= lm ; rmod[1:, :Nr] += lm
        top = _cat([df.sub(rmod[:-1, :Nr], lm), rmod[:-1, Nr:]], 1)
        rmod = _cat([top, rmod[-1:]], 0)
        bot = _cat([df.add(rmod[1:, :Nr], lm), rmod[1:, Nr:]], 1)
        rmod = _cat([rmod[:1], bot], 0)
    xUnc = df.mul(dd["Qinv"], qmod)
    uUnc = df.mul(dd["Rinv"], rmod)
    x = df.clip(xUnc, dd["xmin"], dd["xmax"])
    u = df.clip(uUnc, dd["umin"], dd["umax"])
    x_act = df.less(xUnc, dd["xmin"]) | df.less(dd["xmax"], xUnc)
    u_act = df.less(uUnc, dd["umin"]) | df.less(dd["umax"], uUnc)
    z = jnp.zeros_like(xUnc.hi)
    qt = df.where(x_act, Df(z, z), dd["Qinv"])
    zu = jnp.zeros_like(uUnc.hi)
    rt = df.where(u_act, Df(zu, zu), dd["Rinv"])
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc,
                qt=qt, rt=rt)


def df_residuals(dd, meta, cmask32, sol):
    x, u = sol["x"], sol["u"]
    r_mu = df.add(
        df.add(_contract(dd["AT"], x[:, :-1], axis=2),
               _contract(dd["BT"], u[:, :-1], axis=2)),
        df.sub(dd["b"], x[:, 1:]))
    Nr = meta.Nr
    if meta.Ns > 1:
        r_lam = _mask(df.sub(u[:-1, :Nr], u[1:, :Nr]), cmask32[..., None])
    else:
        r_lam = _zero_df((1, Nr, u.hi.shape[-1]))
    return r_mu, r_lam


def df_dual_value(dd, sol, mu: Df, lam: Df) -> Df:
    half = np.float32(-0.5)
    x, u = sol["x"], sol["u"]
    terms = [
        df.mul_f32(df.mul(df.mul(x, dd["Qd"]), x), half),
        df.mul_f32(df.mul(df.mul(u, dd["Rd"]), u), half),
        df.mul(sol["qmod"], x),
        df.mul(sol["rmod"], u),
        df.neg(df.mul(dd["b"], mu)),
    ]
    return _sum_terms(terms)


def df_apply_M(dd, meta, cmask32, dm32, sol, dmu, dlam_flat):
    """Exact df64 dual-Hessian action (mirror of sdunes._sd_apply_M;
    dmu/dlam_flat are plain f32 directions)."""
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nu = dd["r"].hi.shape[-1]
    nl = Nr * nu
    qt, rt = sol["qt"][:, :-1], sol["rt"][:, :-1]
    qt_c = sol["qt"][:, 1:]
    t0 = _contract_f32(dd["A"], dmu, axis=2)      # A_k' dmu_k
    t = _cat([t0[:, :1], df.sub(t0[:, 1:], df.from_f32(dmu[:, :-1]))], 1)
    r = _contract_f32(dd["B"], dmu, axis=2)       # B_k' dmu_k
    Amu = df.add(_contract(dd["AT"], df.mul(qt, t), axis=2),
                 _contract(dd["BT"], df.mul(rt, r), axis=2))
    u_ = df.sub(df.from_f32(dmu),
                _cat([t0[:, 1:], _zero_df(t0.hi[:, :1].shape)], 1))
    Amu = df.add(Amu, df.mul(qt_c, u_))
    rt_l = Df(sol["rt"].hi[:, :Nr].reshape(Ns, nl),
              sol["rt"].lo[:, :Nr].reshape(Ns, nl))
    if Ns > 1:
        dl = dlam_flat * dm32
        coef = jnp.zeros((Ns, nl), f32)
        coef = coef.at[:-1].add(dl)
        coef = coef.at[1:].add(-dl)
        cfk = coef.reshape(Ns, Nr, nu)
        add = _contract(Df(dd["BT"].hi[:, :Nr], dd["BT"].lo[:, :Nr]),
                        df.mul_f32(rt[:, :Nr], cfk), axis=2)
        Amu = _cat([df.add(Amu[:, :Nr], add), Amu[:, Nr:]], 1)
        kvv = df.mul(rt[:, :Nr], r[:, :Nr])
        kv = Df(kvv.hi.reshape(Ns, nl), kvv.lo.reshape(Ns, nl))
        Al = df.mul_f32(df.add(rt_l[:-1], rt_l[1:]), dl)
        if Ns > 2:
            Al = df.sub(Al, _cat([
                _zero_df((1, nl)),
                df.mul_f32(rt_l[1:-1], dl[:-1])], 0))
            Al = df.sub(Al, _cat([
                df.mul_f32(rt_l[1:-1], dl[1:]),
                _zero_df((1, nl))], 0))
        Al = _mask(df.add(Al, df.sub(kv[:-1], kv[1:])), dm32)
    else:
        Al = _zero_df(dlam_flat.shape)
    return Amu, Al


def sd_newton_loop_df(sqp: sd.ScenarioQP, lam0, mu0, opts: "sd.SdunesOpts",
                      it0):
    """df64 mirror of sdunes._sd_newton_loop (final phase only: warm
    start from the f32 coarse phase). Returns (lam, mu, it, err, status,
    ls_it) in f64."""
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    topts = opts._as_tdunes()
    dd = make_dd(sqp)
    cmask32 = sd._coupling_masks(meta, f32)
    dm32 = (cmask32[..., None].repeat(nu, axis=-1).reshape(Ns - 1, nl)
            if Ns > 1 else jnp.zeros((1, nl), f32))
    # the f32 factor path operates on a plain-f32 view of the data
    sqp32 = sd._cast_sqp(sqp, f32)

    def to_df(v):
        if v.dtype == jnp.float64:
            return df.from_f64(v)
        return df.from_f32(v.astype(f32))

    lam0 = to_df(lam0)
    mu0 = to_df(mu0)

    def error_of(r_mu, r_lam):
        if opts.termination == "infnorm":
            e = jnp.max(jnp.abs(r_mu.hi))
            if r_lam.hi.size:
                e = jnp.maximum(e, jnp.max(jnp.abs(r_lam.hi)))
            return e
        sq = jnp.sum(r_mu.hi**2) + (jnp.sum(r_lam.hi**2)
                                    if r_lam.hi.size else 0.0)
        return jnp.sqrt(sq) if opts.termination == "twonorm" else sq

    def coef_of(dlam_flat):
        coef = jnp.zeros((Ns, nl), f32)
        if Ns > 1:
            coef = coef.at[:-1].add(dlam_flat)
            coef = coef.at[1:].add(-dlam_flat)
        return coef

    def newton_step(carry, sol, r_mu, r_lam):
        lam, mu, it, err, status, ls_it = carry

        qt_b, rt_b = sol["qt"].hi, sol["rt"].hi
        D, Ssub = sd._banded_blocks(sqp32.A, sqp32.B, qt_b, rt_b)
        Uown = sd._coupling_columns(sqp32.B, rt_b, meta, f32)
        fact = sd._sd_factor(D, Ssub, topts)
        Z = sd._sd_full_solve(
            fact, jnp.concatenate([r_mu.hi[..., None], Uown], axis=-1),
            topts)
        z_mu, Zu = Z[..., 0], Z[..., 1:]
        Gram = jnp.einsum("skxl,skxm->slm", Uown, Zu)
        diag, off, _, _ = sd._jay_blocks(sqp32, {"rt": rt_b}, Gram, cmask32)

        rl_full = (_mask(Df(r_lam.hi.reshape(Ns - 1, nl),
                            r_lam.lo.reshape(Ns - 1, nl)), dm32)
                   if Ns > 1 else _zero_df((1, nl)))

        def schur_solve(e_l_hi, z_mu_):
            if Ns > 1:
                Kv_ = jnp.einsum("skxl,skx->sl", Uown, z_mu_)
                rl = (e_l_hi - (Kv_[:-1] - Kv_[1:])) * dm32
                dl = sd._jay_solve(diag, off, rl, opts) * dm32
            else:
                dl = jnp.zeros((1, nl), f32)
            dmu_ = z_mu_ - jnp.einsum("skxl,sl->skx", Zu, coef_of(dl))
            return dmu_, dl

        dmu, dlam_flat = schur_solve(rl_full.hi, z_mu)
        for _ in range(max(opts.refine_steps, 1)):
            # refinement against the exact df64 dual Hessian
            Amu, Al = df_apply_M(dd, meta, cmask32, dm32, sol, dmu,
                                 dlam_flat)
            e_mu = df.sub(r_mu, Amu)
            e_l = df.sub(rl_full, Al)
            z2 = sd._sd_full_solve(fact, e_mu.hi[..., None], topts)[..., 0]
            cmu, cl = schur_solve(e_l.hi, z2)
            dmu = dmu + cmu
            dlam_flat = dlam_flat + cl
        dlam = (dlam_flat * dm32).reshape(max(Ns - 1, 1), Nr, nu)

        # Armijo on f = -g (df64 values)
        dot = df.neg(_sum_terms([df.mul_f32(r_mu, dmu),
                                 df.mul_f32(r_lam, dlam)]))
        descent_ok = dot.hi < 1e-10
        f0 = df_dual_value(dd, sol, mu, lam)

        def lam_at(tau):
            mu_t = df.add(mu, df.mul_f32(df.from_f32(dmu), tau))
            lam_t = df.add(lam, df.mul_f32(df.from_f32(dlam), tau))
            return mu_t, lam_t

        def f_at(tau):
            mu_t, lam_t = lam_at(tau)
            sol_t = df_stage_solve(dd, meta, cmask32, mu_t, lam_t)
            return df_dual_value(dd, sol_t, mu_t, lam_t)

        eta = jnp.float32(2.0 ** -38) * jnp.abs(f0.hi)

        def accepts(f2, tau, dot_v):
            rhs = df.add(f0, df.mul_f32(dot_v, jnp.float32(opts.ls_gamma)
                                        * tau))
            rhs = df.add(rhs, Df(eta, jnp.zeros_like(eta)))
            return ~df.less(rhs, f2)

        one = jnp.ones((), f32)
        f1 = f_at(one)
        acc0 = accepts(f1, one, dot)

        def cond_ls(c):
            tau, fv, i, acc = c
            return (~acc) & (i < opts.ls_max_iter)

        def body_ls(c):
            tau, fv, i, acc = c
            tau2 = jnp.float32(opts.ls_beta) * tau
            f2 = f_at(tau2)
            return (tau2, f2, i + 1, accepts(f2, tau2, dot))

        tau, _, ls_it, acc = jax.lax.while_loop(
            cond_ls, body_ls, (one, f1, jnp.ones((), jnp.int32), acc0))

        mu_n, lam_n = lam_at(tau)
        lam2 = df.where(descent_ok, lam_n, lam)
        mu2 = df.where(descent_ok, mu_n, mu)

        if opts.grad_fallback:
            need_fb = (~descent_ok) | (~acc)
            L_est = jnp.max(jnp.abs(jnp.diagonal(D, axis1=2, axis2=3)))
            if Ns > 1:
                L_est = jnp.maximum(L_est, jnp.max(jnp.abs(
                    jnp.diagonal(diag, axis1=1, axis2=2))))
            t0 = 1.0 / jnp.maximum(L_est, 1e-12)
            dot_g = df.neg(_sum_terms([df.mul(r_mu, r_mu),
                                       df.mul(r_lam, r_lam)]))

            def f_at_g(tau_):
                mu_t = df.add(mu, df.mul_f32(r_mu, tau_))
                lam_t = df.add(lam, df.mul_f32(r_lam, tau_))
                sol_t = df_stage_solve(dd, meta, cmask32, mu_t, lam_t)
                return (df_dual_value(dd, sol_t, mu_t, lam_t),
                        mu_t, lam_t)

            def body_g(c):
                tau_, f_, i_, a_ = c
                tau2 = jnp.float32(opts.ls_beta) * tau_
                f2, _, _ = f_at_g(tau2)
                return (tau2, f2, i_ + 1, accepts(f2, tau2, dot_g))

            def cond_g(c):
                return (~c[3]) & (c[2] < opts.ls_max_iter)

            fg, _, _ = f_at_g(t0)
            accg0 = accepts(fg, t0, dot_g)
            tau_g, _, ls_g, _ = jax.lax.while_loop(
                cond_g, body_g, (t0, fg, jnp.ones((), jnp.int32), accg0))
            mu_fb, lam_fb = f_at_g(tau_g)[1:]
            lam2 = df.where(need_fb, lam_fb, lam2)
            mu2 = df.where(need_fb, mu_fb, mu2)
            ls_it = jnp.where(need_fb, ls_it + ls_g, ls_it)
        else:
            status = jnp.where(descent_ok, status, TDUNES_NOT_DESCENT)
        return lam2, mu2, it + 1, err, status, ls_it

    def cond(carry):
        _, _, it, err, status, _ = carry
        return (err >= opts.tol) & (status == TDUNES_OPTIMAL) & \
            (it < opts.max_iter)

    def body(carry):
        lam, mu, it, err, status, ls_it = carry
        sol = df_stage_solve(dd, meta, cmask32, mu, lam)
        r_mu, r_lam = df_residuals(dd, meta, cmask32, sol)
        err = error_of(r_mu, r_lam)
        out = jax.lax.cond(
            err < opts.tol,
            lambda c: (c[0], c[1], c[2], err, c[4], c[5]),
            lambda c: newton_step((c[0], c[1], c[2], err, c[4], c[5]),
                                  sol, r_mu, r_lam),
            (lam, mu, it, err, status, ls_it))
        return out

    init = (lam0, mu0, jnp.asarray(it0, jnp.int32),
            jnp.full((), jnp.inf, f32),
            jnp.full((), TDUNES_OPTIMAL, jnp.int32),
            jnp.zeros((), jnp.int32))
    lam, mu, it, err, status, ls_it = jax.lax.while_loop(cond, body, init)
    return (df.to_f64(lam), df.to_f64(mu), it,
            err.astype(jnp.float64), status, ls_it)
