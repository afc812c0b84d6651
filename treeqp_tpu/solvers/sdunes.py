"""sdunes — dual Newton on scenario decomposition.

Batched array re-design of ``treeqp/src/dual_Newton_scenarios.{h,c}``. The
multistage tree is decomposed into ``Ns = md**Nr`` full-horizon scenarios;
per-node costs are split across the scenarios traversing the node
(un-scaling at dual_Newton_scenarios.c:1884-1898); dynamics inside each
scenario are dualized with mu[s,k]; non-anticipativity of controls at shared
nodes is enforced pairwise between adjacent scenarios with multipliers
lambda[s,k] (u[s,k] == u[s+1,k] for k up to the common-prefix stage,
cf. ``treeqp_sdunes_calculate_dual_dimension`` :99-108 and the common-node
counts :262-292).

Same restrictions as the reference (guards at spring_mass.c:55-60): uniform
nx/nu, diagonal weights, bounds only, x0 fixed by equality bounds (or
root-eliminated) so scenario copies of x0 agree.

Architectural translation:

* per-scenario stage solves / residuals / banded factorizations are one
  batched op or one lax.scan over the horizon, vmapped over scenarios —
  replacing the ``omp parallel for`` over scenarios (:332-345, :610-613);
* the dual Hessian is eliminated in the same order as the reference
  (mu first — banded block-bidiagonal Cholesky per scenario — then the
  Schur complement "Jay" on lambda), but Jay's block-tridiagonal structure
  over adjacent scenario pairs is solved by BATCHED cyclic reduction
  (ops/tridiag.py) — ceil(log2 Ns) parallel levels replacing the
  "NOTE: Cannot be parallelized" sequential loop (:815-817);
* the mixed-precision path (SdunesOpts.factor_dtype/f32_phase_tol) runs
  the two-phase f32 -> refined-f64 schedule of the tdunes solvers, with the
  banded sweeps on the multistage chain factorization (scenarios as
  chains).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut
from treeqp_tpu.utils.tree import TreeStructure
from treeqp_tpu.solvers.tdunes import (
    TdunesOpts, TDUNES_OPTIMAL, TDUNES_MAX_ITER, TDUNES_NOT_DESCENT)

__all__ = ["SdunesOpts", "sdunes_solve", "scenario_data",
           "scenario_duals_from_tree"]


@dataclasses.dataclass(frozen=True)
class SdunesOpts:
    """Options (treeqp_sdunes_opts_t, dual_Newton_scenarios.h:49-66)."""

    max_iter: int = 100
    termination: str = "infnorm"
    tol: float = 1e-8
    ls_max_iter: int = 50
    ls_gamma: float = 0.1
    ls_beta: float = 0.6
    reg_type: str = "on_the_fly"
    reg_tol: float = 1e-6
    reg_value: float = 1e-6
    # Stall-triggered proximal escalation (round 5, the cold-start
    # globalization): the Jay system is exactly singular on the clipping
    # active-set boundary and the on-the-fly trigger misses the
    # near-singular band — the huge null-space steps strand the Armijo
    # search and the solver crawls on the gradient fallback (measured on
    # the reference spring_mass instance: err 0.29 after 100 cold
    # iterations; the reference ships warm-start files instead,
    # spring_mass.c:69-83). After `stall_boost_after` consecutive
    # iterations without a >=10% residual improvement, a STATIC LM shift
    # of `reg_value` is added to every factorization (sticky) — with it
    # the same instance converges cold in ~37 iterations, while easy
    # instances keep the exact-Newton 1-2-iteration convergence the
    # reference unit tests require. 0 disables.
    stall_boost_after: int = 4
    # Globalization for the dual-Newton cold-start plateau (the reference
    # has the same weakness and ships warm-start files instead,
    # spring_mass.c:69-83): when the Newton step's Armijo search fails or
    # the direction is not descent, fall back to a curvature-scaled
    # gradient-ascent step on the dual (guaranteed descent on f = -g).
    grad_fallback: bool = True
    # --- mixed-precision path (mirrors TdunesOpts; see tdunes.py docs) ---
    # factorization/solve dtype for the banded per-scenario systems and the
    # coupling ("Jay") system; "float32" + refine_steps>0 restores
    # f64-quality directions at f32 factorization cost.
    factor_dtype: str = "same"  # same | float32
    refine_steps: int = 0
    # coarse all-f32 phase down to this stationarity error (or stall),
    # then the data-dtype phase with refinement; 0 disables.
    f32_phase_tol: float = 0.0
    # run the final (data-dtype) phase in df64 two-f32 double-float
    # arithmetic instead of native f64 (solvers/sd_df64.py — the
    # sdunes mirror of the tdunes_ms df64 phase, VERDICT r3 #3).
    # Requires f64 data + factor_dtype="float32".
    df64_phase: bool = False
    # Explicit-SPMD mesh axis: run the solver body inside jax.shard_map
    # with the per-scenario arrays (mu, banded systems) sharded over this
    # axis and the small coupling quantities (lambda, the Jay system)
    # replicated. Cross-device traffic: all-gathers of the Jay boundary
    # blocks (Gram [Ns, nl, nl] per factorization, Kv/u-coupling rows per
    # solve) + scalar reductions — the reference's scenario fork-join
    # (dual_Newton_scenarios.c:332-345, :528-563). The df64 phase is
    # per-device-global and bypassed under an axis. None = single-dev.
    axis_name: str | None = None

    def _as_tdunes(self) -> TdunesOpts:
        return TdunesOpts(reg_type=self.reg_type, reg_tol=self.reg_tol,
                          reg_value=self.reg_value,
                          factor_dtype=self.factor_dtype)


@dataclasses.dataclass(frozen=True)
class _ScenMeta:
    Ns: int
    Nh: int
    Nr: int
    nx: int
    nu: int
    topo: TreeStructure
    path_ids: tuple  # flattened [Ns, Nh+1] node ids
    common: tuple  # common[s] = # stages where scenarios s, s+1 share nodes

    def __hash__(self):
        return hash((self.Ns, self.Nh, self.Nr, self.topo))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScenarioQP:
    """Scenario-decomposed QP data, all arrays stacked [Ns, Nh(+1), ...]."""

    Qd: object  # [Ns, Nh+1, nx] probability-split diagonal weights
    Rd: object  # [Ns, Nh+1, nu] (stage Nh row is identity padding)
    q: object
    r: object
    xmin: object
    xmax: object
    umin: object
    umax: object
    A: object  # [Ns, Nh, nx, nx] dynamics of edge into stage k+1
    B: object  # [Ns, Nh, nx, nu]
    b: object  # [Ns, Nh, nx]
    meta: object = dataclasses.field(metadata=dict(static=True))


def scenario_data(qp: TreeQPIn) -> ScenarioQP:
    """Decompose a multistage tree QP into scenarios.

    Mirrors the reference's extraction of per-scenario data with
    probability un-scaling: each node's (diagonal) weights are divided by
    the number of scenarios traversing it (dual_Newton_scenarios.c:1884-98).
    """
    topo = qp.topo
    params = topo.multistage_params
    assert params is not None, "sdunes requires a multistage scenario tree"
    md, Nr, Nh = params
    Ns = md**Nr
    nxm, num = topo.nxm, topo.num

    # leaves in node order = scenarios; path = leaf-to-root chain
    leaves = np.nonzero(topo.nkids == 0)[0]
    assert len(leaves) == Ns
    paths = np.zeros((Ns, Nh + 1), dtype=np.int32)
    for s, leaf in enumerate(leaves):
        n = leaf
        for k in range(Nh, -1, -1):
            paths[s, k] = n
            n = topo.parent[n]
    common = tuple(
        int(np.sum(paths[s, : Nr] == paths[s + 1, : Nr])) for s in range(Ns - 1))

    share = np.ones((Ns, Nh + 1))
    for k in range(Nh + 1):
        _, inv, counts = np.unique(paths[:, k], return_inverse=True,
                                   return_counts=True)
        share[:, k] = counts[inv]
    share = jnp.asarray(share)

    ids = paths
    xm = jnp.asarray(topo.x_mask, qp.dtype)[ids]
    um = jnp.asarray(topo.u_mask, qp.dtype)[ids]
    Qd = jnp.diagonal(qp.Q, axis1=1, axis2=2)[ids] / share[..., None] * xm + (1 - xm)
    Rd = jnp.diagonal(qp.R, axis1=1, axis2=2)[ids] / share[..., None] * um + (1 - um)
    meta = _ScenMeta(Ns=Ns, Nh=Nh, Nr=Nr, nx=topo.nx[leaves[0]],
                     nu=topo.nu[0], topo=topo,
                     path_ids=tuple(map(tuple, paths.tolist())),
                     common=common)
    eids = paths[:, 1:]  # edge data indexed by child node
    return ScenarioQP(
        Qd=Qd, Rd=Rd,
        q=qp.q[ids] / share[..., None] * xm,
        r=qp.r[ids] / share[..., None] * um,
        xmin=qp.xmin[ids], xmax=qp.xmax[ids],
        umin=qp.umin[ids], umax=qp.umax[ids],
        A=qp.A[eids], B=qp.B[eids], b=qp.b[eids],
        meta=meta)


class _SdShard:
    """Explicit-SPMD context for sdunes under ``jax.shard_map``: scenarios
    sharded over the mesh axis, the coupling multipliers lambda and the
    Jay system replicated (they are tiny: [Ns-1, Nr*nu] rows vs the
    [Ns, Nh, nx] scenario states)."""

    def __init__(self, axis: str, S_local: int):
        self.axis = axis
        self.S_local = S_local
        self.start = jax.lax.axis_index(axis) * S_local

    def slice_s(self, v):
        """Local scenario rows of a replicated [Ns, ...] array."""
        return jax.lax.dynamic_slice_in_dim(v, self.start, self.S_local, 0)

    def psum(self, v):
        return jax.lax.psum(v, self.axis)

    def pmax(self, v):
        return jax.lax.pmax(v, self.axis)

    def gather_s(self, v):
        return jax.lax.all_gather(v, self.axis, axis=0, tiled=True)


def _coupling_masks(meta: _ScenMeta, dt):
    """cmask [Ns-1, Nr]: 1 where lambda[s,k] exists (k < common prefix)."""
    cm = np.zeros((max(meta.Ns - 1, 1), meta.Nr), dtype=np.float64)
    for s in range(meta.Ns - 1):
        cm[s, : meta.common[s]] = 1.0
    return jnp.asarray(cm, dt)


def _stage_solve(sqp: ScenarioQP, mu, lam, cmask, shard=None):
    """Batched clipping stage solves for all [Ns, Nh+1] scenario stages.

    hmod_x[s,k] = -q + mu[s,k] - A[s,k]'mu[s,k+1]        (mu[s,0] := 0)
    hmod_u[s,k] = -r - B[s,k]'mu[s,k+1] - lam[s,k] + lam[s-1,k]
    (dual_Newton_scenarios.c:311-486 with our sign conventions)

    Under ``shard`` the scenario arrays are the LOCAL shard and ``lam``
    is replicated: the lambda pulls are assembled globally (tiny) and
    sliced to the local rows.
    """
    Ns, Nr = sqp.meta.Ns, sqp.meta.Nr
    num = sqp.r.shape[-1]
    Atmu = jnp.einsum("skji,skj->ski", sqp.A, mu)  # A_k' mu_{k+1} at stage k
    Btmu = jnp.einsum("skji,skj->ski", sqp.B, mu)
    qmod = -sqp.q
    qmod = qmod.at[:, 1:].add(mu)
    qmod = qmod.at[:, :-1].add(-Atmu)
    rmod = -sqp.r
    rmod = rmod.at[:, :-1].add(-Btmu)
    if Ns > 1:
        lm = lam * cmask[..., None]  # [Ns-1, Nr, nu] (replicated)
        if shard is not None:
            pulls = jnp.zeros((Ns, Nr, lm.shape[-1]), lm.dtype)
            pulls = pulls.at[:-1].add(-lm).at[1:].add(lm)
            rmod = rmod.at[:, :Nr].add(shard.slice_s(pulls))
        else:
            rmod = rmod.at[:-1, :Nr].add(-lm)
            rmod = rmod.at[1:, :Nr].add(lm)
    Qinv, Rinv = 1.0 / sqp.Qd, 1.0 / sqp.Rd
    xUnc, uUnc = Qinv * qmod, Rinv * rmod
    x = jnp.clip(xUnc, sqp.xmin, sqp.xmax)
    u = jnp.clip(uUnc, sqp.umin, sqp.umax)
    qt = jnp.where((xUnc > sqp.xmax) | (xUnc < sqp.xmin), 0.0, Qinv)
    rt = jnp.where((uUnc > sqp.umax) | (uUnc < sqp.umin), 0.0, Rinv)
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc, qt=qt, rt=rt)


def _residuals(sqp: ScenarioQP, sol, cmask, shard=None):
    """r_mu[s,k] = A x_k + B u_k + b - x_{k+1};  r_lam = u_s - u_{s+1}.

    Under ``shard``: r_mu is local; the u coupling rows are all-gathered
    (compact [Ns, Nr, nu] boundary form) so r_lam comes out replicated."""
    x, u = sol["x"], sol["u"]
    r_mu = (jnp.einsum("skij,skj->ski", sqp.A, x[:, :-1])
            + jnp.einsum("skij,skj->ski", sqp.B, u[:, :-1]) + sqp.b - x[:, 1:])
    Nr = sqp.meta.Nr
    if sqp.meta.Ns > 1:
        u_c = u[:, :Nr]
        if shard is not None:
            u_c = shard.gather_s(u_c)
        r_lam = (u_c[:-1] - u_c[1:]) * cmask[..., None]
    else:
        r_lam = jnp.zeros((1, Nr, u.shape[-1]), u.dtype)
    return r_mu, r_lam


def _dual_value(sqp: ScenarioQP, sol, mu, lam, cmask, shard=None):
    """f = -g: sum over scenario stages of -1/2 z'Hz + hmod'z, minus
    sum b'mu (the coupling constraints have zero constant term)."""
    x, u = sol["x"], sol["u"]
    quad = jnp.sum(x * sqp.Qd * x) + jnp.sum(u * sqp.Rd * u)
    lin = jnp.sum(sol["qmod"] * x) + jnp.sum(sol["rmod"] * u)
    f = -0.5 * quad + lin - jnp.sum(sqp.b * mu)
    if shard is not None:
        f = shard.psum(f)  # every term is scenario-local
    return f


def _banded_blocks(A, B, qt, rt):
    """mu-mu dual Hessian blocks per scenario (banded):
    D[s,k] = A_k qt_k A_k' + B_k rt_k B_k' + qt_{k+1}   (k = 0..Nh-1)
    Ssub[s,k] = M[mu_{k+2}, mu_{k+1}] = -A_{k+1} qt_{k+1}  (k = 0..Nh-2)

    Takes explicit arrays so the mixed-precision path can build the
    blocks straight in f32 (they feed only the f32 factorization; the
    exact refinement operator is the factored _sd_apply_M).
    """
    D = (jnp.einsum("skin,skn,skjn->skij", A, qt[:, :-1], A)
         + jnp.einsum("skin,skn,skjn->skij", B, rt[:, :-1], B))
    nx = D.shape[-1]
    D = D + jnp.eye(nx, dtype=D.dtype) * qt[:, 1:, None, :]
    Ssub = -(A[:, 1:] * qt[:, 1:-1, None, :])  # [Ns, Nh-1, nx, nx]
    return D, Ssub


def _coupling_columns(B, rt, meta, dt):
    """U[t] = M[mu(t,:), lambda-columns touching scenario t], for the Schur
    complement onto lambda. lambda(s,k) touches u[s,k] (+I) and u[s+1,k]
    (-I); mu(t,k+1) sees u[t,k] through B_k: column block = +-B_k rt[t,k].

    Returns Uown [Ns, Nh, nx, Nr*nu] (columns of lambda(t,:), sign +) —
    the contribution for lambda(t-1,:) is -Uown of scenario t reindexed.
    """
    Nh, Nr = meta.Nh, meta.Nr
    Ns = B.shape[0]  # LOCAL scenario count under shard_map
    nu = B.shape[-1]
    nx = B.shape[-2]
    # block at (mu stage k+1, lambda stage k) = B_k * rt_k  -> [Ns,Nr,nx,nu]
    Brt = B[:, :Nr] * rt[:, :Nr, None, :]
    U = jnp.zeros((Ns, Nh, Nr, nx, nu), dt)
    for k in range(Nr):  # mu stage k+1 is row k of [Nh]
        U = U.at[:, k, k].set(Brt[:, k])
    return U.swapaxes(2, 3).reshape(Ns, Nh, nx, Nr * nu)


def _jay_blocks(sqp, sol, Gram, cmask):
    """Jay = Mll - Mlm Mmm^-1 Mml, block-tridiagonal over scenario pairs.

    Mll: diag(s) = rt[s] + rt[s+1] on matching (k,k) nu-blocks;
         off(s,s+1) = -rt[s+1].
    Mlm Mmm^-1 Mml: scenario t contributes Gram_t = U_t' Mmm^-1 U_t to the
    pairs touching t (t-1 and t), with signs (+ for own pair t, - for
    pair t-1). (form_K / form_and_factorize_Jay,
    dual_Newton_scenarios.c:692-868, parallelized-by-construction here.)
    Returns (diag, off, rt_l, dm).
    """
    Ns, Nr = sqp.meta.Ns, sqp.meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    dt = Gram.dtype

    rt_l = sol["rt"][:, :Nr].reshape(Ns, nl)  # diag of rt at coupling stages
    dmask = cmask[..., None].repeat(nu, axis=-1).reshape(Ns - 1, nl) if Ns > 1 \
        else jnp.zeros((1, nl), dt)

    # Jay = Mll - Schur. Diagonal block of pair s:
    #   diag(rt_s + rt_{s+1}) - (Gram_s + Gram_{s+1})
    diag = (jnp.eye(nl, dtype=dt) * (rt_l[:-1] + rt_l[1:])[:, None, :]
            - Gram[:-1] - Gram[1:])
    # off-diagonal (pair s+1, pair s): both touch scenario s+1 with opposite
    # signs: Mll off = -diag(rt_{s+1}); Schur off = -Gram_{s+1}
    off = -(jnp.eye(nl, dtype=dt) * rt_l[1:-1, None, :]) + Gram[1:-1] \
        if Ns > 2 else jnp.zeros((max(Ns - 2, 0), nl, nl), dt)
    # mask invalid lambda rows/cols to identity (no coupling there)
    dm = dmask
    diag = diag * dm[:, :, None] * dm[:, None, :] + \
        jnp.eye(nl, dtype=dt) * (1.0 - dm)[:, None, :]
    if Ns > 2:
        off = off * dm[1:, :, None] * dm[:-1, None, :]
    return diag, off, rt_l, dm


def _jay_solve(diag, off, rhs, opts: SdunesOpts, extra_shift=None):
    """Solve the Jay system by Jacobi-equilibrated block cyclic reduction
    (ops/tridiag.py) at the factor dtype — ceil(log2 P) BATCHED levels
    replacing the reference's sequential factorization
    ("Cannot be parallelized", dual_Newton_scenarios.c:815-817).

    ``extra_shift``: traced scalar added unconditionally at the original
    scale (stall-triggered proximal escalation)."""
    from treeqp_tpu.ops.tridiag import tridiag_cr_solve
    out_dt = rhs.dtype
    fdt = jnp.float32 if opts.factor_dtype == "float32" else out_dt
    if extra_shift is not None:
        diag = diag + (extra_shift.astype(diag.dtype)
                       * jnp.eye(diag.shape[-1], dtype=diag.dtype))
    scJ = jax.lax.rsqrt(jnp.maximum(
        jnp.diagonal(diag, axis1=1, axis2=2), 1e-12))
    dg = (diag * scJ[:, :, None] * scJ[:, None, :]).astype(fdt)
    of = (off * scJ[1:, :, None] * scJ[:-1, None, :]).astype(fdt)
    r = (rhs * scJ).astype(fdt)
    # regularized Cholesky per block (dual_Newton_common.c:81-123): the
    # Jay system is exactly singular on the clipping active-set boundary.
    # The LM shift must act at the ORIGINAL scale (reg_value * scJ^2 after
    # equilibration): an equilibrated-scale shift amplifies the null-space
    # direction components by 1/diag relative to the reference semantics
    # and the resulting huge steps strand the line search.
    shift = (opts.reg_value * scJ * scJ).astype(fdt) \
        if opts.reg_type != "none" else None
    reg_tol = opts.reg_tol if opts.reg_type == "on_the_fly" else -1.0
    x = tridiag_cr_solve(dg, of, r, shift=shift, reg_tol=reg_tol)
    return x.astype(out_dt) * scJ


def _sd_factor(D, Ssub, topts: TdunesOpts, extra_shift=None):
    """Equilibrate the per-scenario banded mu-systems and factor them with
    the multistage chain machinery (scenario lanes): reversed stage order
    maps the FORWARD banded Cholesky onto the chains' backward one, with
    no crown coupling (Ut_0 = 0). Returns an opaque factor dict.

    ``extra_shift``: traced scalar added UNCONDITIONALLY to the diagonal
    (the stall-triggered proximal escalation, SdunesOpts.stall_boost_after)."""
    from treeqp_tpu.solvers import tdunes_multistage as tm
    dg = jnp.diagonal(D, axis1=2, axis2=3)  # [Ns, Nh, nx]
    if extra_shift is not None:
        D = D + (extra_shift.astype(D.dtype)
                 * jnp.eye(D.shape[-1], dtype=D.dtype))
        dg = dg + extra_shift.astype(D.dtype)
    if topts.reg_type != "none":
        # Zero-curvature rows (fully clipped coordinates) make the banded
        # blocks exactly singular; the LM shift must act at the ORIGINAL
        # scale (dual_Newton_common.c:81-123) — adding it after Jacobi
        # equilibration would amplify the null-space direction components
        # by 1/diag. Per-row conditional shift on the raw diagonal.
        shift = jnp.where(dg < topts.reg_tol, topts.reg_value, 0.0)
        # diagonal add as an eye broadcast
        D = D + shift[..., :, None] * jnp.eye(D.shape[-1], dtype=D.dtype)
        dg = dg + shift
    sc = jax.lax.rsqrt(jnp.maximum(dg, 1e-12))
    Ds = D * sc[..., :, None] * sc[..., None, :]
    # Ssub[s,k] = M[k+1, k]: rows scale with stage k+1, cols with stage k
    Ss = Ssub * sc[:, 1:, :, None] * sc[:, :-1, None, :]
    Wc = jnp.flip(Ds, 1)
    Ut = jnp.concatenate([jnp.zeros_like(Ss[:, :1]), jnp.flip(Ss, 1)], axis=1)
    Ls, CUs, _ = tm._chain_factor(Wc, Ut, topts)
    return dict(Ls=Ls, CUs=CUs, sc=sc)


def _sd_full_solve(fact, rhs, topts: TdunesOpts):
    """Multi-RHS FULL solve of the banded mu-systems: rhs [Ns, Nh, nx, m]
    (data dtype) -> Mmm^-1 rhs (data dtype): backward then forward scan
    over the stages, batched over scenarios."""
    out_dt = rhs.dtype
    sc = fact["sc"]
    Ls, CUs = fact["Ls"], fact["CUs"]
    r = (rhs * sc[..., None]).astype(Ls.dtype)
    rr = jnp.flip(r, 1)

    def bwd(acc, inp):
        Lj, CUj, rj = inp
        y = jax.lax.linalg.triangular_solve(
            Lj, rj - acc, left_side=True, lower=True)
        return CUj @ y, y
    _, ys = jax.lax.scan(
        bwd, jnp.zeros_like(rr[:, 0]),
        (jnp.flip(Ls, 1).swapaxes(0, 1), jnp.flip(CUs, 1).swapaxes(0, 1),
         jnp.flip(rr, 1).swapaxes(0, 1)))
    ys = jnp.flip(ys.swapaxes(0, 1), 1)

    def fwd(zprev, inp):
        Lj, CUj, yj = inp
        z = jax.lax.linalg.triangular_solve(
            Lj, yj - CUj.swapaxes(-1, -2) @ zprev, left_side=True,
            lower=True, transpose_a=True)
        return z, z
    _, z = jax.lax.scan(fwd, jnp.zeros_like(rr[:, 0]),
                        (Ls.swapaxes(0, 1), CUs.swapaxes(0, 1),
                         ys.swapaxes(0, 1)))
    z = z.swapaxes(0, 1)
    return jnp.flip(z, 1).astype(out_dt) * sc[..., None]


def _sd_apply_M(sqp, sol, cmask, dm, dmu, dlam_flat, AT=None, BT=None,
                shard=None):
    """Exact data-dtype action of the full dual Hessian on (dmu, dlam) —
    the iterative-refinement operator for f32-factored solves.

    FACTORED application (A (qt o (A' v)) matvecs on pre-transposed
    operands) instead of materialized D/Ssub/Uown blocks: the blocks feed
    only the f32 factorization, and materializing them in the data dtype
    would cost more than the rest of the Newton iteration.

    Mmm dmu (banded) + Mml dlam (coupling columns, own pair +, prev -);
    Mlm dmu (per-pair kv differences) + Mll dlam (tridiag of rt diagonals).
    """
    Ns, Nh, Nr = sqp.meta.Ns, sqp.meta.Nh, sqp.meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    qt, rt = sol["qt"][:, :-1], sol["rt"][:, :-1]   # stage k (edge parent)
    qt_c = sol["qt"][:, 1:]                          # stage k+1 (child x)
    if AT is None:
        AT, BT = sqp.A.swapaxes(2, 3), sqp.B.swapaxes(2, 3)
    # t0_k = A_k' dmu_k; t_k = t0_k - dmu_{k-1} (the -Ssub_{k-1} fold)
    t0 = jnp.einsum("skij,skj->ski", AT, dmu)
    t = t0.at[:, 1:].add(-dmu[:, :-1])
    r = jnp.einsum("skij,skj->ski", BT, dmu)        # B_k' dmu_k
    A = jnp.einsum("skij,skj->ski", sqp.A, qt * t) \
        + jnp.einsum("skij,skj->ski", sqp.B, rt * r)
    # + qt_{k+1} o (dmu_k - A_{k+1}' dmu_{k+1}) (diag + Ssub_k' fold)
    u = dmu.at[:, :-1].add(-t0[:, 1:])
    A = A + qt_c * u
    rt_c = sol["rt"][:, :Nr]
    if shard is not None and Ns > 1:
        rt_c = shard.gather_s(rt_c)  # [Ns, Nr, nu] coupling rows
    rt_l = rt_c.reshape(Ns, nl)
    if Ns > 1:
        dl = dlam_flat * dm
        coef = jnp.zeros((Ns, nl), dmu.dtype)
        coef = coef.at[:-1].add(dl)
        coef = coef.at[1:].add(-dl)
        # U coef: rows k < Nr get B_k (rt_k o coef[k-block])
        cfk = (shard.slice_s(coef) if shard is not None
               else coef).reshape(-1, Nr, nu)
        add = jnp.einsum("skij,skj->ski", sqp.B[:, :Nr],
                         rt[:, :Nr] * cfk)
        A = A.at[:, :Nr].add(add)
        # kv_t = rt o (B' dmu) rows k < Nr
        kv = (rt[:, :Nr] * r[:, :Nr]).reshape(r.shape[0], nl)
        if shard is not None:
            kv = shard.gather_s(kv)  # [Ns, nl] boundary rows
        Al = (rt_l[:-1] + rt_l[1:]) * dl
        if Ns > 2:
            Al = Al.at[1:].add(-rt_l[1:-1] * dl[:-1])
            Al = Al.at[:-1].add(-rt_l[1:-1] * dl[1:])
        Al = (Al + kv[:-1] - kv[1:]) * dm
    else:
        Al = jnp.zeros_like(dlam_flat)
    return A, Al


def _sd_newton_loop(sqp: ScenarioQP, lam0, mu0, opts: SdunesOpts, it0,
                    patience: int = 0, shard=None):
    """One sdunes dual-Newton while-loop at the dtype of ``sqp``'s data.

    The per-iteration linear algebra is restructured around ONE multi-RHS
    full solve of the banded per-scenario systems, Z = Mmm^-1 [r_mu, U]:
      Gram_t = U_t' Z_u,t  (the Jay Schur blocks),
      Kv_t   = U_t' z_mu,t (the Jay RHS fold),
      dmu    = z_mu - Z_u coef(dlam) (the back-substitution)
    — algebraically identical to the reference's half-solve sequence
    (form_K / form_RHS_non_anticipaticity / calculate_delta_mu,
    dual_Newton_scenarios.c:692-1205) with no extra banded sweeps. The
    Jay system solves by batched cyclic reduction (ops/tridiag.py).

    With ``opts.refine_steps > 0`` each direction is iteratively refined
    against the exact data-dtype dual Hessian (_sd_apply_M) — restoring
    f64 quality from f32-factored solves. ``patience > 0`` adds the
    coarse-phase stall exit (see tdunes._td_newton_loop).
    Returns (lam, mu, it, err, status, ls_it).
    """
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    dt = sqp.b.dtype
    topts = opts._as_tdunes()
    cmask = _coupling_masks(meta, dt)
    dm = (cmask[..., None].repeat(nu, axis=-1).reshape(Ns - 1, nl)
          if Ns > 1 else jnp.zeros((1, nl), dt))

    def error_of(r_mu, r_lam):
        # pure-chain trees (Ns == 1 or Nr == 0) have no non-anticipativity
        # multipliers: r_lam is a zero-size array and reducing it would
        # crash ('zero-size array to reduction'). Under shard, r_mu is
        # local (pmax) and r_lam replicated.
        if opts.termination == "infnorm":
            e = jnp.max(jnp.abs(r_mu))
            if shard is not None:
                e = shard.pmax(e)
            if r_lam.size:
                e = jnp.maximum(e, jnp.max(jnp.abs(r_lam)))
            return e
        sq = jnp.sum(r_mu**2)
        if shard is not None:
            sq = shard.psum(sq)
        sq = sq + (jnp.sum(r_lam**2) if r_lam.size else 0.0)
        return jnp.sqrt(sq) if opts.termination == "twonorm" else sq

    def coef_of(dlam_flat):
        coef = jnp.zeros((Ns, nl), dt)
        if Ns > 1:
            coef = coef.at[:-1].add(dlam_flat)
            coef = coef.at[1:].add(-dlam_flat)
        return shard.slice_s(coef) if shard is not None else coef

    # mixed-precision direction algebra: the dual-Hessian blocks, Jay
    # Schur pieces and back-substitutions feed only the f32 factorization
    # path — build them straight in the factor dtype (the tdunes_ms
    # pattern); the exact data-dtype Hessian action for refinement is the
    # FACTORED _sd_apply_M (matvecs, no materialized blocks)
    bdt = jnp.float32 if (opts.factor_dtype == "float32"
                          and dt != jnp.float32) else dt
    A_b, B_b = sqp.A.astype(bdt), sqp.B.astype(bdt)
    AT64, BT64 = sqp.A.swapaxes(2, 3), sqp.B.swapaxes(2, 3)

    def newton_step(carry, sol, r_mu, r_lam, boost):
        lam, mu, it, err, status, ls_it = carry

        qt_b, rt_b = sol["qt"].astype(bdt), sol["rt"].astype(bdt)
        D, Ssub = _banded_blocks(A_b, B_b, qt_b, rt_b)
        Uown = _coupling_columns(B_b, rt_b, meta, bdt)
        fact = _sd_factor(D, Ssub, topts, extra_shift=boost)
        # ONE multi-RHS full solve: [r_mu | U] -> [z_mu | Z_u]
        Z = _sd_full_solve(
            fact, jnp.concatenate([r_mu.astype(bdt)[..., None], Uown],
                                  axis=-1), topts)
        z_mu, Zu = Z[..., 0], Z[..., 1:]
        Gram = jnp.einsum("skxl,skxm->slm", Uown, Zu)
        if shard is not None:
            # Jay boundary blocks: THE boundary tensor of the scenario
            # decomposition ([Ns, nl, nl] per factorization)
            Gram = shard.gather_s(Gram)
            rt_jay = shard.gather_s(rt_b[:, :Nr])
        else:
            rt_jay = rt_b
        diag, off, rt_l, _ = _jay_blocks(sqp, {"rt": rt_jay}, Gram, cmask)

        rl_full = (r_lam.reshape(Ns - 1, nl) * dm if Ns > 1
                   else jnp.zeros((1, nl), dt))

        def schur_solve(e_l, z_mu_):
            """Direction from a mu-space solve z_mu_ = Mmm^-1 e_mu."""
            if Ns > 1:
                Kv_ = jnp.einsum("skxl,skx->sl", Uown, z_mu_.astype(bdt))
                if shard is not None:
                    Kv_ = shard.gather_s(Kv_)  # [Ns, nl] boundary rows
                rl = (e_l.astype(bdt) - (Kv_[:-1] - Kv_[1:])) * dm.astype(bdt)
                dl = _jay_solve(diag, off, rl, opts,
                                extra_shift=boost).astype(dt) * dm
            else:
                dl = jnp.zeros((1, nl), dt)
            dmu_ = z_mu_.astype(dt) - jnp.einsum(
                "skxl,sl->skx", Zu, coef_of(dl).astype(bdt)).astype(dt)
            return dmu_, dl

        dmu, dlam_flat = schur_solve(rl_full, z_mu)
        for _ in range(max(opts.refine_steps, 0)
                       if opts.factor_dtype == "float32" else 0):
            # refinement against the exact data-dtype dual Hessian
            Amu, Al = _sd_apply_M(sqp, sol, cmask, dm, dmu, dlam_flat,
                                  AT=AT64, BT=BT64, shard=shard)
            e_mu = r_mu - Amu
            e_l = rl_full - Al
            z2 = _sd_full_solve(fact, e_mu[..., None], topts)[..., 0]
            cmu, cl = schur_solve(e_l, z2)
            dmu = dmu + cmu
            dlam_flat = dlam_flat + cl
        dlam = dlam_flat.reshape(max(Ns - 1, 1), Nr, nu) * cmask[..., None]

        # Armijo line search on f = -g over (lambda, mu) jointly
        dot_mu = jnp.sum(r_mu * dmu)
        if shard is not None:
            dot_mu = shard.psum(dot_mu)  # r_lam part is replicated
        dot = -(dot_mu + jnp.sum(r_lam * dlam))
        descent_ok = dot < 1e-10  # see tdunes.py: documented < 0 deviation
        f0 = _dual_value(sqp, sol, mu, lam, cmask, shard=shard)

        def f_at(tau):
            mu_t = mu + tau * dmu
            lam_t = lam + tau * dlam
            sol_t = _stage_solve(sqp, mu_t, lam_t, cmask, shard=shard)
            return _dual_value(sqp, sol_t, mu_t, lam_t, cmask, shard=shard)

        # noise-aware Armijo slack (see tdunes._line_search)
        eps_rel = 2.0 ** -45 if dt == jnp.float64 else 2.0 ** -18
        eta = jnp.asarray(eps_rel, dt) * jnp.abs(f0)

        one = jnp.ones((), dt)
        f1 = f_at(one)
        acc0 = f1 <= f0 + opts.ls_gamma * one * dot + eta

        def cond_ls(c):
            tau, f, i, acc = c
            return (~acc) & (i < opts.ls_max_iter)

        def body_ls(c):
            tau, f, i, acc = c
            tau2 = opts.ls_beta * tau
            f2 = f_at(tau2)
            return (tau2, f2, i + 1,
                    f2 <= f0 + opts.ls_gamma * tau2 * dot + eta)

        tau, _, ls_it, acc = jax.lax.while_loop(
            cond_ls, body_ls, (one, f1, jnp.ones((), jnp.int32), acc0))

        lam2 = jnp.where(descent_ok, lam + tau * dlam, lam)
        mu2 = jnp.where(descent_ok, mu + tau * dmu, mu)

        if opts.grad_fallback:
            # --- globalization: if the Newton step failed (non-descent
            # direction or maxed-out Armijo — the piecewise-singular
            # cold-start plateau), take a curvature-scaled gradient step on
            # the dual: direction (r_lam, r_mu) is always ascent for g.
            need_fb = (~descent_ok) | (~acc)
            L_est = jnp.max(jnp.abs(jnp.diagonal(D, axis1=2, axis2=3))).astype(dt)
            if shard is not None:
                L_est = shard.pmax(L_est)  # D is local; diag is replicated
            if Ns > 1:
                L_est = jnp.maximum(
                    L_est, jnp.max(jnp.abs(jnp.diagonal(
                        diag, axis1=1, axis2=2))).astype(dt))
            t0 = 1.0 / jnp.maximum(L_est, 1e-12)
            g_mu = jnp.sum(r_mu * r_mu)
            if shard is not None:
                g_mu = shard.psum(g_mu)
            dot_g = -(g_mu + jnp.sum(r_lam * r_lam))

            def f_at_g(tau_):
                mu_t = mu + tau_ * r_mu
                lam_t = lam + tau_ * r_lam
                sol_t = _stage_solve(sqp, mu_t, lam_t, cmask, shard=shard)
                return _dual_value(sqp, sol_t, mu_t, lam_t, cmask, shard=shard)

            def body_g(c):
                tau_, f_, i_, a_ = c
                tau2 = opts.ls_beta * tau_
                f2 = f_at_g(tau2)
                return (tau2, f2, i_ + 1,
                        f2 <= f0 + opts.ls_gamma * tau2 * dot_g)

            def cond_g(c):
                return (~c[3]) & (c[2] < opts.ls_max_iter)

            fg = f_at_g(t0)
            accg0 = fg <= f0 + opts.ls_gamma * t0 * dot_g
            tau_g, _, ls_g, _ = jax.lax.while_loop(
                cond_g, body_g, (t0, fg, jnp.ones((), jnp.int32), accg0))
            lam2 = jnp.where(need_fb, lam + tau_g * r_lam, lam2)
            mu2 = jnp.where(need_fb, mu + tau_g * r_mu, mu2)
            ls_it = jnp.where(need_fb, ls_it + ls_g, ls_it)
        else:
            status = jnp.where(descent_ok, status, TDUNES_NOT_DESCENT)
        return lam2, mu2, it + 1, err, status, ls_it

    def cond(carry):
        _, _, it, err, status, _, best, noimp, _ = carry
        ok = (err >= opts.tol) & (status == TDUNES_OPTIMAL) & (it < opts.max_iter)
        if patience > 0:
            ok = ok & (noimp < patience)
        return ok

    def body(carry):
        lam, mu, it, err, status, ls_it, best, noimp, boost = carry
        sol = _stage_solve(sqp, mu, lam, cmask, shard=shard)
        r_mu, r_lam = _residuals(sqp, sol, cmask, shard=shard)
        err = error_of(r_mu, r_lam)
        improved = err < 0.9 * best
        best = jnp.minimum(best, err)
        noimp = jnp.where(improved, 0, noimp + 1)
        # stall-triggered proximal escalation with decay-on-progress:
        # re-arms while the residual stalls, decays away once Newton
        # makes progress so the quadratic tail is EXACT Newton (the
        # sticky variant left an O(shift) solution perturbation at loose
        # tolerances). See SdunesOpts.stall_boost_after.
        if opts.stall_boost_after > 0:
            # engage only on the O(1) cold-start plateau (err > 1e-2):
            # mid-range slow phases are ordinary damped-Newton behavior
            # and perturbing them costs final-iterate accuracy at loose
            # tolerances (test_constrained_chain_agrees_with_tdunes)
            boost = jnp.where((noimp >= opts.stall_boost_after)
                              & (err > 1e-2),
                              jnp.asarray(opts.reg_value, dt), 0.1 * boost)
        # shift scales with the residual (LM for nonlinear equations):
        # full strength on the O(1) cold-start plateau, vanishing near
        # convergence so the accepted tail is exact Newton
        shift_now = boost * jnp.minimum(err.astype(dt), 1.0)
        out = jax.lax.cond(
            err < opts.tol,
            lambda c: (c[0], c[1], c[2], err, c[4], c[5]),
            lambda c: newton_step((c[0], c[1], c[2], err, c[4], c[5]),
                                  sol, r_mu, r_lam, shift_now),
            (lam, mu, it, err, status, ls_it))
        return out + (best, noimp, boost)

    init = (lam0, mu0, jnp.asarray(it0, jnp.int32), jnp.full((), jnp.inf, dt),
            jnp.full((), TDUNES_OPTIMAL, jnp.int32), jnp.zeros((), jnp.int32),
            jnp.full((), jnp.inf, dt), jnp.zeros((), jnp.int32),
            jnp.zeros((), dt))
    lam, mu, it, err, status, ls_it, _, _, _ = jax.lax.while_loop(
        cond, body, init)
    return lam, mu, it, err, status, ls_it


def _cast_sqp(sqp: ScenarioQP, dtype):
    """Cast all float leaves of a ScenarioQP (meta is static)."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        sqp)


@partial(jax.jit, static_argnames=("opts",))
def sdunes_solve(sqp: ScenarioQP, lam0=None, mu0=None,
                 opts: SdunesOpts = SdunesOpts()):
    """Dual Newton on the scenario decomposition
    (treeqp_sdunes_solve, dual_Newton_scenarios.c:1850-2091).

    Returns (sol dict with [Ns, Nh+1] trajectories, lam, mu, info).

    With ``opts.f32_phase_tol > 0`` (f64 data, factor_dtype=float32) the
    solve runs the two-phase precision schedule of the tdunes solvers: a
    coarse all-f32 phase to f32_phase_tol or stall, then the f64 phase
    with f32-factored iterative refinement.
    """
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nx = sqp.b.shape[-1]
    nu = sqp.r.shape[-1]
    dt = sqp.b.dtype
    cmask = _coupling_masks(meta, dt)
    # explicit-SPMD context: scenario arrays are the LOCAL shard inside
    # shard_map; lambda / the Jay system stay replicated (round 5)
    S_loc = sqp.b.shape[0]
    shard = (_SdShard(opts.axis_name, S_loc)
             if opts.axis_name is not None else None)

    # the stall-triggered proximal escalation is a COLD-START
    # globalization: on warm-started solves (MPC steps, bootstrapped
    # runs) the early-iterate residual can sit on the O(1) plateau the
    # trigger watches for while the warm duals are already good — the
    # engaged shift then degrades the convergence tail (measured: one
    # 256-scenario closed-loop cell fell from KKT 8.8e-10 to 2.9e-6).
    # Host-side gate (BEFORE the zero-defaulting below): keep it only
    # when the caller provided NO duals.
    if (lam0 is not None or mu0 is not None) and opts.stall_boost_after:
        opts = dataclasses.replace(opts, stall_boost_after=0)

    if mu0 is None:
        mu0 = jnp.zeros((S_loc, Nh, nx), dt)
    if lam0 is None:
        lam0 = jnp.zeros((max(Ns - 1, 1), Nr, nu), dt)

    it0 = jnp.zeros((), jnp.int32)
    use_coarse = (opts.f32_phase_tol > 0 and dt == jnp.float64
                  and opts.factor_dtype == "float32")
    if use_coarse:
        sqp32 = _cast_sqp(sqp, jnp.float32)
        optsA = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol))
        lamA, muA, it0, _, _, _ = _sd_newton_loop(
            sqp32, lam0.astype(jnp.float32), mu0.astype(jnp.float32),
            optsA, it0, patience=3, shard=shard)
        # f32-phase status is discarded: a not-descent there is expected
        # noise near the f32 residual floor, not a failure
        lam0 = lamA.astype(dt)
        mu0 = muA.astype(dt)

    if (opts.df64_phase and dt == jnp.float64
            and opts.factor_dtype == "float32" and shard is None):
        # the df64 phase is per-device-global; bypassed under a mesh axis
        from treeqp_tpu.solvers.sd_df64 import sd_newton_loop_df
        lam, mu, it, err, status, ls_it = sd_newton_loop_df(
            sqp, lam0, mu0, opts, it0)
    else:
        lam, mu, it, err, status, ls_it = _sd_newton_loop(
            sqp, lam0, mu0, opts, it0, shard=shard)

    sol = _stage_solve(sqp, mu, lam, cmask, shard=shard)
    r_mu, r_lam = _residuals(sqp, sol, cmask, shard=shard)
    if opts.termination == "infnorm":
        err = jnp.max(jnp.abs(r_mu))
        if shard is not None:
            err = shard.pmax(err)
        if r_lam.size:
            err = jnp.maximum(err, jnp.max(jnp.abs(r_lam)))
    else:
        sq = jnp.sum(r_mu**2)
        if shard is not None:
            sq = shard.psum(sq)
        sq = sq + (jnp.sum(r_lam**2) if r_lam.size else 0.0)
        err = jnp.sqrt(sq) if opts.termination == "twonorm" else sq
    status = jnp.where((status == TDUNES_OPTIMAL) & (err >= opts.tol),
                       TDUNES_MAX_ITER, status)
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it)
    return sol, lam, mu, info


def scenario_duals_from_tree(sqp: ScenarioQP, lam_tree, out=None):
    """Map a tree solution to scenario duals (lam0, mu0).

    With only ``lam_tree`` (tree-edge dynamics multipliers), the scenario
    copies of a shared edge split its multiplier equally:
    mu[s, k] = lam_tree[path(s, k+1)] / #scenarios-through-edge. That is
    exact on the chain part (count 1) but inconsistent at branching
    stages — the md child edges of a crown node carry *different*
    multipliers, so no equal split satisfies each copy's stationarity,
    and the bootstrap residual stays O(1) for Nr >= 3.

    With the full tree solution ``out`` (TreeQPOut: x, u, mu_x, mu_u), the
    copy duals are recovered exactly instead:

    * mu by the per-scenario backward adjoint recursion on the copy's own
      x-stationarity (see _stage_solve conventions; kkt.py:11-12 signs):
          mu[s, k-1] = Qd x_k + q_k + mu_x_k/cnt + A_k' mu[s, k]
      (A term absent at k = Nh), which reproduces lam_tree on the chain
      part and distributes the crown children's contributions per copy.
    * lam (non-anticipativity) by telescoping the copy u-stationarity
      over each coupled scenario block (cmask):
          lam[s, k] = lam[s-1, k] + rmod0 - Rd u_k - mu_u_k/cnt
      with rmod0 the lam-free modified gradient; block sums reproduce the
      tree node's own u-stationarity, so block edges land back at ~0.

    Used to bootstrap sdunes from an IPM/tdunes solution on cold-start
    plateau instances (the reference instead ships warm-start txt files,
    spring_mass.c:69-83). Pure jnp on static path indices — works under
    jit (e.g. an in-jit ipm_ms -> sdunes bootstrap chain)."""
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nx = sqp.b.shape[-1]
    nu = sqp.r.shape[-1]
    dt = sqp.b.dtype
    paths = np.asarray(meta.path_ids).reshape(Ns, Nh + 1)
    cnt = np.zeros(meta.topo.Nn)
    np.add.at(cnt, paths.reshape(-1), 1.0)
    lam0 = jnp.zeros((max(Ns - 1, 1), Nr, nu), dt)
    if out is None:
        mu0 = jnp.asarray(lam_tree)[paths[:, 1:], :nx] \
            / jnp.asarray(cnt[paths[:, 1:]], dt)[..., None]
        return lam0, mu0.astype(dt)

    share = jnp.asarray(cnt[paths], dt)                  # [Ns, Nh+1]
    x_sc = out.x[paths][..., :nx]                        # [Ns, Nh+1, nx]
    mux_sc = out.mu_x[paths][..., :nx] / share[..., None]
    muu_sc = out.mu_u[paths][..., :nu] / share[..., None]
    u_sc = out.u[paths][..., :nu]
    # adjoint recursion mu[s, k-1] = Qd x_k + q_k + mux_k + A_k' mu[s, k]
    def adj(mu_next, inp):
        Qk, xk, qk, mk, Ak, has_A = inp
        g = Qk * xk + qk + mk
        g = g + has_A * jnp.einsum("sji,sj->si", Ak, mu_next)
        return g, g
    ks = np.arange(Nh, 0, -1)
    A_ext = jnp.concatenate([sqp.A, jnp.zeros_like(sqp.A[:, :1])], axis=1)
    has_A = jnp.asarray((ks < Nh).astype(np.float64), dt)
    _, mus = jax.lax.scan(
        adj, jnp.zeros((Ns, nx), dt),
        (sqp.Qd[:, ks].swapaxes(0, 1), x_sc[:, ks].swapaxes(0, 1),
         sqp.q[:, ks].swapaxes(0, 1), mux_sc[:, ks].swapaxes(0, 1),
         A_ext[:, jnp.minimum(ks, Nh - 1)].swapaxes(0, 1), has_A))
    mu0 = jnp.flip(mus.swapaxes(0, 1), 1)                # [Ns, Nh, nx]

    if Ns > 1:
        cmask = _coupling_masks(meta, dt)
        sol0 = _stage_solve(sqp, mu0, lam0, cmask)
        d = (sol0["rmod"][:, :Nr] - sqp.Rd[:, :Nr] * u_sc[:, :Nr]
             - muu_sc[:, :Nr])                           # [Ns, Nr, nu]

        def tele(prev, inp):
            ds, cs = inp
            cur = (prev + ds) * cs[:, None]  # restart at boundaries
            return cur, cur
        _, lam = jax.lax.scan(tele, jnp.zeros((Nr, nu), dt), (d[:-1], cmask))
        lam0 = lam
    return lam0, mu0


def scenario_output(sqp: ScenarioQP, sol, lam, mu, info) -> TreeQPOut:
    """Average scenario copies back onto the tree and recover multipliers
    (export at dual_Newton_scenarios.c:2028-2075): tree-edge lam = sum of
    the mu of scenarios traversing the edge; bound multipliers from
    mu = Q (xUnc - x) summed over copies."""
    meta = sqp.meta
    topo = meta.topo
    dt = sqp.b.dtype
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    paths = np.asarray(meta.path_ids, dtype=np.int32)  # [Ns, Nh+1]
    Ns, Nh1 = paths.shape
    flat = paths.reshape(-1)
    share = np.zeros(Nn)
    np.add.at(share, flat, 1.0)
    share_j = jnp.asarray(share, dt)

    def avg(v):  # [Ns, Nh+1, w] -> [Nn, w]
        acc = jax.ops.segment_sum(v.reshape(Ns * Nh1, -1), flat, num_segments=Nn)
        return acc / share_j[:, None]

    def tot(v):
        return jax.ops.segment_sum(v.reshape(Ns * Nh1, -1), flat, num_segments=Nn)

    x = avg(sol["x"])
    u = avg(sol["u"])
    mu_x = tot(sqp.Qd * (sol["xUnc"] - sol["x"]))
    mu_u = tot(sqp.Rd * (sol["uUnc"] - sol["u"]))
    # tree lam per edge into node: sum over scenarios traversing the edge
    eflat = paths[:, 1:].reshape(-1)
    lam_tree = jax.ops.segment_sum(mu.reshape(Ns * (Nh1 - 1), -1), eflat,
                                   num_segments=Nn)
    xmask = jnp.asarray(topo.x_mask, dt)
    umask = jnp.asarray(topo.u_mask, dt)
    return TreeQPOut(
        x=x * xmask, u=u * umask, lam=lam_tree * jnp.asarray(topo.nonroot_x_mask, dt),
        mu_x=mu_x * xmask, mu_u=mu_u * umask,
        mu_d=jnp.zeros((Nn, topo.ncm), dt), info=info)
