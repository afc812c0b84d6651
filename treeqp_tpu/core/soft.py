"""Soft constraints — the HPIPM engine capability class ``ns``.

The reference's HPIPM interface exposes (but never uses,
hpipm_tree.c:152-160) soft box constraints: selected bounds get slack
pairs (sl, su) >= 0 with quadratic+linear penalties,

    lb - sl <= v <= ub + su,
    cost += 1/2 sl' Zl sl + zl' sl + 1/2 su' Zu su + zu' su.

Instead of threading slack blocks through the IPM KKT system (HPIPM's
in-engine route), this module performs the EXACT reduction to a hard tree
QP — the batched choice, because it reuses the existing batched Riccati
unchanged and keeps static shapes:

* each softened coordinate's slack pair joins the node's CONTROL vector
  (slacks are stage-local decision variables with diagonal cost and
  [0, inf) bounds; the dynamics B gets zero columns),
* the softened bound rows move from box constraints to one-sided GENERAL
  rows  lb <= v + sl  and  v - su <= ub.

``soften_bounds`` builds the augmented ``TreeQPIn``; ``recover_soft`` maps
an augmented solution back to the original layout (plus slack values and
soft-bound multipliers). The reduction is exact: the augmented QP's KKT
conditions are the soft-constrained QP's KKT conditions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut, TREEQP_INF
from treeqp_tpu.utils.tree import TreeStructure

__all__ = ["soften_bounds", "recover_soft", "SoftMap"]


@dataclasses.dataclass(frozen=True)
class SoftMap:
    """Mapping from the augmented hard QP back to the soft-QP layout."""

    topo: TreeStructure          # original topology
    aug_topo: TreeStructure
    soft_x: tuple                # per node: tuple of softened x coordinates
    nu_orig: tuple


def soften_bounds(qp: TreeQPIn, soft_x, Zl, Zu, zl=0.0, zu=0.0):
    """Return ``(qp_aug, SoftMap)`` with the listed state bounds softened.

    ``soft_x``: per-node iterable of x-coordinate indices whose box bounds
    become soft (both sides; a one-sided infinite bound simply leaves its
    slack unused). ``Zl/Zu/zl/zu``: scalar penalty coefficients (HPIPM
    stores per-coordinate vectors; scalars cover the capability and the
    arrays below make per-coordinate values a one-line extension).
    """
    topo = qp.topo
    Nn = topo.Nn
    soft_x = tuple(tuple(int(i) for i in soft_x[n]) for n in range(Nn))
    ns = [len(s) for s in soft_x]
    nu2 = tuple(topo.nu[n] + 2 * ns[n] for n in range(Nn))
    nc2 = tuple(topo.nc[n] + 2 * ns[n] for n in range(Nn))
    topo2 = TreeStructure(parent=topo.parent, nx=topo.nx, nu=nu2, nc=nc2)

    num2, ncm2 = topo2.num, topo2.ncm
    nxm = topo.nxm

    def pad(a, shape):
        out = np.zeros(shape, dtype=np.float64)
        sl = tuple(slice(0, s) for s in np.asarray(a).shape)
        out[sl] = np.asarray(a)
        return out

    Q = np.asarray(qp.Q)
    R = np.zeros((Nn, num2, num2))
    S = np.zeros((Nn, num2, nxm))
    r = np.zeros((Nn, num2))
    umin = np.full((Nn, num2), -TREEQP_INF)
    umax = np.full((Nn, num2), TREEQP_INF)
    C = np.zeros((Nn, ncm2, nxm))
    D = np.zeros((Nn, ncm2, num2))
    dmin = np.full((Nn, ncm2), -TREEQP_INF)
    dmax = np.full((Nn, ncm2), TREEQP_INF)
    xmin = np.asarray(qp.xmin).copy()
    xmax = np.asarray(qp.xmax).copy()
    B = np.zeros((Nn, nxm, num2))
    b = np.asarray(qp.b)
    A = np.asarray(qp.A)

    R0, S0, r0 = np.asarray(qp.R), np.asarray(qp.S), np.asarray(qp.r)
    um0, uM0 = np.asarray(qp.umin), np.asarray(qp.umax)
    C0, D0 = np.asarray(qp.C), np.asarray(qp.D)
    dm0, dM0 = np.asarray(qp.dmin), np.asarray(qp.dmax)
    B0 = np.asarray(qp.B)

    for n in range(Nn):
        nu0, nc0 = topo.nu[n], topo.nc[n]
        k = ns[n]
        R[n, :nu0, :nu0] = R0[n, :nu0, :nu0]
        S[n, :nu0] = S0[n, :nu0]
        r[n, :nu0] = r0[n, :nu0]
        umin[n, :nu0] = um0[n, :nu0]
        umax[n, :nu0] = uM0[n, :nu0]
        C[n, :nc0] = C0[n, :nc0]
        D[n, :nc0, :nu0] = D0[n, :nc0, :nu0]
        dmin[n, :nc0] = dm0[n, :nc0]
        dmax[n, :nc0] = dM0[n, :nc0]
        if n > 0:
            # edge INTO node n: columns index the PARENT's controls, which
            # keep their leading positions (slacks are appended after them)
            nu_p = topo.nu[topo.parent[n]]
            B[n, :, :nu_p] = B0[n, :, :nu_p]
        for j, i in enumerate(soft_x[n]):
            isl = nu0 + 2 * j          # slack sl for coordinate i
            isu = nu0 + 2 * j + 1      # slack su
            R[n, isl, isl] = Zl
            R[n, isu, isu] = Zu
            r[n, isl] = zl
            r[n, isu] = zu
            umin[n, isl] = 0.0
            umin[n, isu] = 0.0
            # general rows: xmin_i <= x_i + sl  ;  x_i - su <= xmax_i
            rl = nc0 + 2 * j
            ru = nc0 + 2 * j + 1
            C[n, rl, i] = 1.0
            D[n, rl, isl] = 1.0
            dmin[n, rl] = xmin[n, i]
            C[n, ru, i] = 1.0
            D[n, ru, isu] = -1.0
            dmax[n, ru] = xmax[n, i]
            # the hard box row is released
            xmin[n, i] = -TREEQP_INF
            xmax[n, i] = TREEQP_INF

    dt = qp.dtype
    qp2 = TreeQPIn(
        Q=jnp.asarray(Q, dt), R=jnp.asarray(R, dt), S=jnp.asarray(S, dt),
        q=qp.q, r=jnp.asarray(r, dt),
        xmin=jnp.asarray(xmin, dt), xmax=jnp.asarray(xmax, dt),
        umin=jnp.asarray(umin, dt), umax=jnp.asarray(umax, dt),
        C=jnp.asarray(C, dt), D=jnp.asarray(D, dt),
        dmin=jnp.asarray(dmin, dt), dmax=jnp.asarray(dmax, dt),
        A=jnp.asarray(A, dt), B=jnp.asarray(B, dt), b=jnp.asarray(b, dt),
        topo=topo2)
    return qp2, SoftMap(topo=topo, aug_topo=topo2, soft_x=soft_x,
                        nu_orig=tuple(topo.nu))


def recover_soft(out: TreeQPOut, m: SoftMap):
    """Map an augmented-QP solution back to the original layout.

    Returns ``(out_orig, slacks)``: a TreeQPOut on the original topology
    (u truncated to the original controls; soft coordinates' mu_x taken
    from the general-row multipliers so complementarity reads as for the
    soft bound) and ``slacks[n] = [(sl, su), ...]`` per softened coord.
    """
    topo = m.topo
    Nn = topo.Nn
    num = topo.num
    x = np.asarray(out.x)
    u2 = np.asarray(out.u)
    mu_x = np.asarray(out.mu_x).copy()
    mu_u2 = np.asarray(out.mu_u)
    mu_d2 = np.asarray(out.mu_d)

    u = np.zeros((Nn, num))
    mu_u = np.zeros((Nn, num))
    slacks = []
    for n in range(Nn):
        nu0 = m.nu_orig[n]
        nc0 = topo.nc[n]
        u[n, :nu0] = u2[n, :nu0]
        mu_u[n, :nu0] = mu_u2[n, :nu0]
        ssl = []
        for j, i in enumerate(m.soft_x[n]):
            isl, isu = nu0 + 2 * j, nu0 + 2 * j + 1
            rl, ru = nc0 + 2 * j, nc0 + 2 * j + 1
            ssl.append((float(u2[n, isl]), float(u2[n, isu])))
            # signed fold of the two one-sided soft rows (lower row active
            # -> negative multiplier convention, as for hard boxes)
            mu_x[n, i] = mu_d2[n, rl] + mu_d2[n, ru]
        slacks.append(tuple(ssl))

    ncm = topo.ncm
    mu_d = np.zeros((Nn, ncm))
    for n in range(Nn):
        mu_d[n, : topo.nc[n]] = mu_d2[n, : topo.nc[n]]

    dt = out.x.dtype
    out2 = TreeQPOut(
        x=out.x, u=jnp.asarray(u, dt),
        lam=out.lam,
        mu_x=jnp.asarray(mu_x, dt), mu_u=jnp.asarray(mu_u, dt),
        mu_d=jnp.asarray(mu_d, dt), info=out.info)
    return out2, tuple(slacks)
