"""Tree QP data containers (the ``tree_qp_in`` / ``tree_qp_out`` equivalents).

Accelerator re-design of the reference QP data layer
(``treeqp/src/tree_qp_common.{h,c}``):

* Instead of per-node BLASFEO matrices carved out of an arena
  (tree_qp_common.c:60-306), all node/edge data live in stacked, zero-padded
  dense arrays ``[Nn, nxm, ...]`` registered as a JAX pytree — one XLA buffer
  per field, so every solver operation is a single batched kernel over all
  nodes (or all nodes at a depth).
* The tree topology and per-node dims are static pytree metadata
  (``TreeStructure``), which keys jit caches exactly like the reference's
  "create once, solve many" workspace discipline.

The QP solved (tree_qp_common.h:85-116)::

    min   sum_n 1/2 [x_n;u_n]' [Q_n S_n'; S_n R_n] [x_n;u_n] + [q_n;r_n]'[x_n;u_n]
    s.t.  x_n = A_n x_{p(n)} + B_n u_{p(n)} + b_n          (edge into node n, n>0)
          xmin_n <= x_n <= xmax_n,  umin_n <= u_n <= umax_n
          dmin_n <= C_n x_n + D_n u_n <= dmax_n

Note: the reference indexes edge data by ``n-1`` for the edge into node ``n``;
here edge arrays are indexed directly by the child node ``n`` with row 0 unused.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.utils.tree import TreeStructure

# Infinity convention of the reference (utils/types.h:37)
TREEQP_INF = 1e12

__all__ = ["TreeQPIn", "TreeQPOut", "EliminatedTreeQP", "TREEQP_INF"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeQPIn:
    """Tree QP problem data. Equivalent of ``tree_qp_in`` (tree_qp_common.h:85-116)."""

    # node data, padded to [Nn, nxm/num/ncm, ...]
    Q: Any
    R: Any
    S: Any  # [Nn, num, nxm]
    q: Any
    r: Any
    xmin: Any
    xmax: Any
    umin: Any
    umax: Any
    C: Any  # [Nn, ncm, nxm]
    D: Any  # [Nn, ncm, num]
    dmin: Any
    dmax: Any
    # edge data, indexed by CHILD node (row 0 zero): x_n = A_n x_p + B_n u_p + b_n
    A: Any  # [Nn, nxm, nxm]
    B: Any  # [Nn, nxm, num]
    b: Any  # [Nn, nxm]
    topo: TreeStructure = dataclasses.field(metadata=dict(static=True))

    # -------------------------------------------------------------- helpers

    def replace(self, **kw) -> "TreeQPIn":
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self):
        return self.Q.dtype

    def astype(self, dtype) -> "TreeQPIn":
        return jax.tree.map(lambda a: a.astype(dtype), self)

    # --------------------------------------------------------- constructors

    @classmethod
    def zeros(cls, topo: TreeStructure, dtype=jnp.float64) -> "TreeQPIn":
        Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
        z = lambda *s: jnp.zeros(s, dtype=dtype)
        inf = TREEQP_INF
        return cls(
            Q=z(Nn, nxm, nxm), R=z(Nn, num, num), S=z(Nn, num, nxm),
            q=z(Nn, nxm), r=z(Nn, num),
            xmin=jnp.full((Nn, nxm), -inf, dtype), xmax=jnp.full((Nn, nxm), inf, dtype),
            umin=jnp.full((Nn, num), -inf, dtype), umax=jnp.full((Nn, num), inf, dtype),
            C=z(Nn, ncm, nxm), D=z(Nn, ncm, num),
            dmin=jnp.full((Nn, ncm), -inf, dtype), dmax=jnp.full((Nn, ncm), inf, dtype),
            A=z(Nn, nxm, nxm), B=z(Nn, nxm, num), b=z(Nn, nxm),
            topo=topo,
        )

    @classmethod
    def from_node_edge_lists(cls, topo: TreeStructure, nodes: list, edges_by_child: dict,
                             dtype=jnp.float64) -> "TreeQPIn":
        """Build from per-node dicts of (unpadded) numpy arrays.

        ``nodes[i]`` may contain Q, R, S, q, r, xmin, xmax, umin, umax,
        C, D, dmin, dmax. ``edges_by_child[c]`` contains A, B, b of the edge
        into node c. Missing bounds default to +-TREEQP_INF; missing matrices
        to zero. Equivalent to the ~60 setters of tree_qp_common.c:874-2427.
        """
        Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
        nx, nu, nc = topo.nx, topo.nu, topo.nc

        def alloc(shape, fill=0.0):
            return np.full(shape, fill, dtype=np.float64)

        F = dict(
            Q=alloc((Nn, nxm, nxm)), R=alloc((Nn, num, num)), S=alloc((Nn, num, nxm)),
            q=alloc((Nn, nxm)), r=alloc((Nn, num)),
            xmin=alloc((Nn, nxm), -TREEQP_INF), xmax=alloc((Nn, nxm), TREEQP_INF),
            umin=alloc((Nn, num), -TREEQP_INF), umax=alloc((Nn, num), TREEQP_INF),
            C=alloc((Nn, ncm, nxm)), D=alloc((Nn, ncm, num)),
            dmin=alloc((Nn, ncm), -TREEQP_INF), dmax=alloc((Nn, ncm), TREEQP_INF),
            A=alloc((Nn, nxm, nxm)), B=alloc((Nn, nxm, num)), b=alloc((Nn, nxm)),
        )
        shapes = dict(
            Q=lambda i: (nx[i], nx[i]), R=lambda i: (nu[i], nu[i]), S=lambda i: (nu[i], nx[i]),
            q=lambda i: (nx[i],), r=lambda i: (nu[i],),
            xmin=lambda i: (nx[i],), xmax=lambda i: (nx[i],),
            umin=lambda i: (nu[i],), umax=lambda i: (nu[i],),
            C=lambda i: (nc[i], nx[i]), D=lambda i: (nc[i], nu[i]),
            dmin=lambda i: (nc[i],), dmax=lambda i: (nc[i],),
        )
        for i, nd in enumerate(nodes):
            for k, v in nd.items():
                if k not in F:
                    continue
                v = np.asarray(v, dtype=np.float64).reshape(shapes[k](i))
                sl = tuple(slice(0, s) for s in v.shape)
                F[k][(i,) + sl] = v
        for c, ed in edges_by_child.items():
            p = topo.parent[c]
            A = np.asarray(ed["A"], dtype=np.float64).reshape(nx[c], nx[p])
            B = np.asarray(ed["B"], dtype=np.float64).reshape(nx[c], nu[p])
            bb = np.asarray(ed["b"], dtype=np.float64).reshape(nx[c])
            F["A"][c, : nx[c], : nx[p]] = A
            F["B"][c, : nx[c], : nu[p]] = B
            F["b"][c, : nx[c]] = bb
        return cls(**{k: jnp.asarray(v, dtype=dtype) for k, v in F.items()}, topo=topo)

    @classmethod
    def lti_diag_weights(cls, topo: TreeStructure, A, B, b, dQ, dq, dP, dp, dR, dr,
                        xmin, xmax, umin, umax, x0=None, scale_by_stage=True,
                        dtype=jnp.float64) -> "TreeQPIn":
        """LTI scenario-tree fill, mirroring ``tree_qp_in_fill_lti_data_diag_weights``
        (tree_qp_common.c:1837-1950).

        ``A/B/b`` are stacked realizations ``[md, nx, nx]`` etc.; the edge into
        node c uses realization ``topo.realization[c]``. Non-leaf nodes get
        diag(dQ)/diag(dR) weights, leaves diag(dP). When ``scale_by_stage``,
        objectives are scaled by num_leaves/nodes_in_stage (probability
        weighting, tree_qp_common.c:1909-1928). ``x0`` is embedded as equality
        bounds at the root.
        """
        A = np.asarray(A, dtype=np.float64)
        B = np.asarray(B, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        nodes = []
        stage = topo.stage
        n_in_stage = np.bincount(stage, minlength=topo.Nh + 1)
        num_leaves = int(np.sum(topo.nkids == 0))
        for i in range(topo.Nn):
            leaf = topo.nkids[i] == 0
            sf = (num_leaves / n_in_stage[stage[i]]) if scale_by_stage else 1.0
            nd = dict(
                Q=np.diag(np.asarray(dP if leaf else dQ, dtype=np.float64)) * sf,
                q=np.asarray(dp if leaf else dq, dtype=np.float64) * sf,
                xmin=xmin, xmax=xmax,
            )
            if topo.nu[i] > 0:
                nd.update(R=np.diag(np.asarray(dR, dtype=np.float64)) * sf,
                          r=np.asarray(dr, dtype=np.float64) * sf,
                          umin=umin, umax=umax)
            if i == 0 and x0 is not None:
                nd.update(xmin=x0, xmax=x0)
            nodes.append(nd)
        edges = {}
        for c in range(1, topo.Nn):
            re = int(topo.realization[c])
            edges[c] = dict(A=A[re], B=B[re], b=b[re])
        return cls.from_node_edge_lists(topo, nodes, edges, dtype=dtype)

    # ----------------------------------------------------- LTV batch setters
    # Reference tree_qp_in_set_ltv_* (tree_qp_common.c:1953-2153): flat
    # concatenated per-edge / per-node arrays (variable dims), unpacked in
    # node order. Used for stage-varying (LTV) problem data.

    def set_ltv_dynamics(self, A_flat, B_flat, b_flat) -> "TreeQPIn":
        """``tree_qp_in_set_ltv_dynamics_colmajor``: A/B/b of every edge,
        flat-concatenated in child-node order 1..Nn-1 (column-major per
        matrix, matching the reference)."""
        topo = self.topo
        nx, nu = topo.nx, topo.nu
        A_flat = np.asarray(A_flat, dtype=np.float64).ravel()
        B_flat = np.asarray(B_flat, dtype=np.float64).ravel()
        b_flat = np.asarray(b_flat, dtype=np.float64).ravel()
        A = np.zeros((topo.Nn, topo.nxm, topo.nxm))
        B = np.zeros((topo.Nn, topo.nxm, topo.num))
        b = np.zeros((topo.Nn, topo.nxm))
        ia = ib = iv = 0
        for c in range(1, topo.Nn):
            p = topo.parent[c]
            m, nA, nB = nx[c], nx[p], nu[p]
            A[c, :m, :nA] = A_flat[ia: ia + m * nA].reshape(nA, m).T
            ia += m * nA
            B[c, :m, :nB] = B_flat[ib: ib + m * nB].reshape(nB, m).T
            ib += m * nB
            b[c, :m] = b_flat[iv: iv + m]
            iv += m
        dt = self.dtype
        return self.replace(A=jnp.asarray(A, dt), B=jnp.asarray(B, dt),
                            b=jnp.asarray(b, dt))

    def set_ltv_objective_diag(self, Qd_flat, Rd_flat, q_flat, r_flat) -> "TreeQPIn":
        """``tree_qp_in_set_ltv_objective_diag``: diagonal weights + linear
        terms of every node, flat-concatenated in node order (S zeroed)."""
        topo = self.topo
        Qd_flat = np.asarray(Qd_flat, dtype=np.float64).ravel()
        Rd_flat = np.asarray(Rd_flat, dtype=np.float64).ravel()
        q_flat = np.asarray(q_flat, dtype=np.float64).ravel()
        r_flat = np.asarray(r_flat, dtype=np.float64).ravel()
        Q = np.zeros((topo.Nn, topo.nxm, topo.nxm))
        R = np.zeros((topo.Nn, topo.num, topo.num))
        q = np.zeros((topo.Nn, topo.nxm))
        r = np.zeros((topo.Nn, topo.num))
        iq = ir = 0
        for i in range(topo.Nn):
            m, n = topo.nx[i], topo.nu[i]
            Q[i, :m, :m] = np.diag(Qd_flat[iq: iq + m])
            q[i, :m] = q_flat[iq: iq + m]
            iq += m
            R[i, :n, :n] = np.diag(Rd_flat[ir: ir + n])
            r[i, :n] = r_flat[ir: ir + n]
            ir += n
        dt = self.dtype
        return self.replace(Q=jnp.asarray(Q, dt), R=jnp.asarray(R, dt),
                            S=jnp.zeros_like(self.S),
                            q=jnp.asarray(q, dt), r=jnp.asarray(r, dt))

    def set_ltv_bounds(self, xmin_flat, xmax_flat, umin_flat, umax_flat) -> "TreeQPIn":
        """Batch bound setter in node order (flat-concatenated, variable
        dims), cf. tree_qp_in_set_node_bounds applied node by node."""
        topo = self.topo
        flats = [np.asarray(v, dtype=np.float64).ravel()
                 for v in (xmin_flat, xmax_flat, umin_flat, umax_flat)]
        xmin = np.full((topo.Nn, topo.nxm), -TREEQP_INF)
        xmax = np.full((topo.Nn, topo.nxm), TREEQP_INF)
        umin = np.full((topo.Nn, topo.num), -TREEQP_INF)
        umax = np.full((topo.Nn, topo.num), TREEQP_INF)
        ix = iu = 0
        for i in range(topo.Nn):
            m, n = topo.nx[i], topo.nu[i]
            xmin[i, :m] = flats[0][ix: ix + m]
            xmax[i, :m] = flats[1][ix: ix + m]
            ix += m
            umin[i, :n] = flats[2][iu: iu + n]
            umax[i, :n] = flats[3][iu: iu + n]
            iu += n
        dt = self.dtype
        return self.replace(
            xmin=jnp.asarray(xmin, dt), xmax=jnp.asarray(xmax, dt),
            umin=jnp.asarray(umin, dt), umax=jnp.asarray(umax, dt))

    # --------------------------------------------------------- MPC utilities

    def set_x0(self, x0) -> "TreeQPIn":
        """Embed the current state as equality bounds on the root
        (tree_qp_in_set_x0_* semantics, tree_qp_common.c:2154-2237)."""
        x0 = jnp.asarray(x0, dtype=self.dtype)
        nx0 = self.topo.nx[0]
        x0p = jnp.zeros((self.topo.nxm,), self.dtype).at[:nx0].set(x0[:nx0])
        mask = self.topo.x_mask[0]
        lo = x0p * mask - TREEQP_INF * (1 - mask)
        hi = x0p * mask + TREEQP_INF * (1 - mask)
        return self.replace(xmin=self.xmin.at[0].set(lo), xmax=self.xmax.at[0].set(hi))

    def eliminate_x0(self, keep_originals: bool = False):
        """Fold a fixed root state into the data, shrinking node 0 to nx=0.

        Mirrors ``tree_qp_in_eliminate_x0`` (tree_qp_common.c:404-525): with
        x0 fixed (xmin[0]==xmax[0]), fold A_c x0 into b_c for each child c of
        the root, S_0 x0 into r_0, and C_0 x0 into the root's d bounds.

        Returns a new TreeQPIn on a topology with nx[0] = 0. The returned
        problem shares padded array shapes with the original, so jit caches
        keyed on (shapes, topo) remain distinct per topology as in the
        reference (qp_internal_t, tree_qp_common.h:58-80).

        ``keep_originals=True`` instead returns an :class:`EliminatedTreeQP`
        holding the pre-elimination data so the eliminated problem can get a
        NEW x0 every MPC step via ``.set_x0`` without rebuilding — the
        reference's qp_internal_t pattern (tree_qp_common.c:2154-2237).
        """
        topo = self.topo
        x0 = self.xmin[0] * jnp.asarray(topo.x_mask[0], self.dtype)
        new_topo = TreeStructure.from_parent(
            topo.parent, (0,) + topo.nx[1:], topo.nu, topo.nc)
        kids0 = np.asarray(topo.kids[0], dtype=np.int32)
        A0 = self.A[kids0]
        b0 = self.b[kids0]
        S0, r0, C0 = self.S[0], self.r[0], self.C[0]
        dmin0, dmax0 = self.dmin[0], self.dmax[0]
        # b_c += A_c x0 for children of the root
        badd = jnp.einsum("kij,j->ki", A0, x0)
        b = self.b.at[kids0].add(badd)
        A = self.A.at[kids0].set(0.0)
        # r_0 += S_0 x0
        r = self.r.at[0].add(S0 @ x0)
        S = self.S.at[0].set(0.0)
        # d bounds at root: dmin_0 -= C_0 x0, dmax_0 -= C_0 x0
        cshift = C0 @ x0
        dmin = self.dmin.at[0].add(-cshift)
        dmax = self.dmax.at[0].add(-cshift)
        C = self.C.at[0].set(0.0)
        Q = self.Q.at[0].set(0.0)
        q = self.q.at[0].set(0.0)
        elim = self.replace(A=A, b=b, r=r, S=S, C=C, Q=Q, q=q,
                            dmin=dmin, dmax=dmax, topo=new_topo)
        if not keep_originals:
            return elim
        return EliminatedTreeQP(qp=elim, A0=A0, b0=b0, S0=S0, r0=r0, C0=C0,
                                dmin0=dmin0, dmax0=dmax0,
                                kids0=tuple(int(k) for k in kids0))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EliminatedTreeQP:
    """An x0-eliminated tree QP that can be re-embedded with a new x0 every
    MPC step (the reference's qp_internal_t pattern: originals are kept so
    ``tree_qp_in_set_x0_strvec`` works on the eliminated problem,
    tree_qp_common.h:58-80, tree_qp_common.c:2154-2237)."""

    qp: TreeQPIn   # the eliminated problem (nx[0] = 0 topology)
    A0: Any        # original A of the edges out of the root [K0, nxm, nxm]
    b0: Any        # original b of those edges [K0, nxm]
    S0: Any        # original root S [num, nxm]
    r0: Any        # original root r [num]
    C0: Any        # original root C [ncm, nxm]
    dmin0: Any
    dmax0: Any
    kids0: Any = dataclasses.field(metadata=dict(static=True))  # root kid ids

    def set_x0(self, x0) -> "EliminatedTreeQP":
        """Re-embed a new root state into the eliminated data (cheap,
        jit-friendly: only the folded fields are rewritten)."""
        qp = self.qp
        x0 = jnp.asarray(x0, qp.dtype)
        nxm = qp.topo.nxm
        x0p = jnp.zeros((nxm,), qp.dtype).at[: x0.shape[0]].set(x0)
        kids0 = np.asarray(self.kids0, dtype=np.int32)
        b = qp.b.at[kids0].set(self.b0 + jnp.einsum("kij,j->ki", self.A0, x0p))
        r = qp.r.at[0].set(self.r0 + self.S0 @ x0p)
        cshift = self.C0 @ x0p
        dmin = qp.dmin.at[0].set(self.dmin0 - cshift)
        dmax = qp.dmax.at[0].set(self.dmax0 - cshift)
        return dataclasses.replace(
            self, qp=qp.replace(b=b, r=r, dmin=dmin, dmax=dmax))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeQPOut:
    """Tree QP solution. Equivalent of ``tree_qp_out`` (tree_qp_common.h:119-131).

    ``lam`` is the multiplier of the dynamics constraint of the edge INTO each
    node (row 0 zero). ``mu_x/mu_u/mu_d`` are signed bound multipliers
    (positive = upper bound active), matching the reference convention in
    tree_qp_out_calculate_KKT_res (tree_qp_common.c:540-765).
    """

    x: Any  # [Nn, nxm]
    u: Any  # [Nn, num]
    lam: Any  # [Nn, nxm]
    mu_x: Any  # [Nn, nxm]
    mu_u: Any  # [Nn, num]
    mu_d: Any  # [Nn, ncm]
    info: Any  # dict: iter, status, obj ... (traced scalars)

    def replace(self, **kw) -> "TreeQPOut":
        return dataclasses.replace(self, **kw)

    @classmethod
    def zeros(cls, topo: TreeStructure, dtype=jnp.float64) -> "TreeQPOut":
        Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
        z = lambda *s: jnp.zeros(s, dtype=dtype)
        return cls(x=z(Nn, nxm), u=z(Nn, num), lam=z(Nn, nxm),
                   mu_x=z(Nn, nxm), mu_u=z(Nn, num), mu_d=z(Nn, ncm),
                   info=dict(iter=jnp.zeros((), jnp.int32),
                             status=jnp.zeros((), jnp.int32)))
