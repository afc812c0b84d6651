"""Scenario-sharded dual Newton for multistage robust-MPC trees.

The scenario-parallel scaling path (SURVEY.md 5.7/5.8). A multistage tree
(branch ``md`` ways for ``Nr`` stages, then chains to horizon ``Nh``,
reference ``setup_multistage_tree`` tree.c:247-280) splits into:

* the **crown** — stages 0..Nr, a small tree replicated on every device;
* ``S = md**Nr`` independent **chains** of length ``L = Nh - Nr``, stored as
  stacked ``[S, L, ...]`` arrays and sharded over the mesh axis ``"scen"``.

Every chain operation is batched over scenarios (one XLA kernel, local to
each device); the only cross-device communication is (a) the all-gather of
the chain-root duals / Schur complements into the replicated crown — the
exact analog of the reference's non-anticipativity coupling — and (b) the
psum/pmax reductions for the termination norm and the line-search dual value.
The sequential part is the length-L banded sweep per chain (lax.scan), the
direct counterpart of the reference's per-scenario banded Cholesky
(dual_Newton_scenarios.c:590-689) but factorized over the tree formulation.

The module is written shard-agnostically: running it under jit with chain
arrays sharded ``P("scen")`` and crown arrays replicated makes XLA/GSPMD
insert the collectives. ``make_sharded_solver`` wires that up for a mesh.

Restrictions (round 1): clipping stage QPs (diag Q/R, S=0, nc=0), uniform
dims along chains — the standard robust-MPC setting of the reference's
spring_mass/quadcopter/crane benchmarks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut
from treeqp_tpu.utils.tree import TreeStructure, kid_sum
from treeqp_tpu.solvers import tdunes as td
from treeqp_tpu.solvers.tdunes import (
    TdunesOpts, TDUNES_OPTIMAL, TDUNES_MAX_ITER, TDUNES_NOT_DESCENT)

__all__ = ["MultistageQP", "split_multistage", "tdunes_ms_solve", "merge_output",
           "chain_node_ids", "split_duals", "multistage_applicable"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultistageQP:
    """A multistage tree QP in crown + stacked-chain layout."""

    crown: TreeQPIn  # crown tree (stages 0..Nr); stage-Nr nodes keep real nu
    # chain arrays [S, L, ...]; j-th entry = chain node at stage Nr+1+j
    Qd: Any  # [S, L, nx] diagonal weights (identity-padded)
    Rd: Any  # [S, L, nu]
    q: Any
    r: Any
    xmin: Any
    xmax: Any
    umin: Any
    umax: Any
    A: Any  # [S, L, nx, nx] edge into chain node j (j=0: from crown node)
    B: Any  # [S, L, nx, nu]
    b: Any  # [S, L, nx]
    # general C/D constraint rows on chain nodes ([S, L, ncm, nx/nu]; None
    # when the tree has none). Consumed by the multistage IPM; the
    # multistage dual Newton requires clipping-class data (no C/D).
    C: Any = None
    D: Any = None
    dmin: Any = None
    dmax: Any = None
    meta: Any = dataclasses.field(default=None,
                                  metadata=dict(static=True))  # _MsMeta


@dataclasses.dataclass(frozen=True)
class _MsMeta:
    md: int
    Nr: int
    Nh: int
    S: int
    L: int
    nx: int
    nu: int
    crown_topo: TreeStructure
    full_topo: TreeStructure
    # crown node ids of the S chain roots (stage-Nr nodes), scenario order
    root_ids: tuple
    # devices that GSPMD splits the chain arrays over
    # (parallel.sharding.shard_multistage sets it)
    chain_shards: int = 1

    def __hash__(self):
        return hash((self.md, self.Nr, self.Nh, self.crown_topo, self.full_topo))


def chain_node_ids(meta) -> np.ndarray:
    """[S, L] grid of full-tree node ids of the chain nodes (scenario s,
    chain position j = stage Nr+1+j). Stage-contiguous BFS numbering keeps
    scenario order within each stage."""
    ss = meta.full_topo.stage_start
    return np.stack([np.arange(int(ss[meta.Nr + 1 + j]),
                               int(ss[meta.Nr + 2 + j]))
                     for j in range(meta.L)], axis=1).astype(np.int32)


def split_duals(ms: MultistageQP, lam_nodes):
    """Split a full-tree dual warm start [Nn, nxm] into the crown+chain
    layout (lam0_crown [Ncrown, nxm_cr], lam0_chain [S, L, nx]) — the
    multistage counterpart of treeqp_tdunes_set_dual_initialization."""
    meta = ms.meta
    ids = chain_node_ids(meta)
    lam_cr = jnp.asarray(lam_nodes)[: meta.crown_topo.Nn,
                                    : meta.crown_topo.nxm]
    lam_ch = jnp.asarray(lam_nodes)[ids][:, :, : ms.q.shape[-1]]
    return lam_cr, lam_ch


def multistage_applicable(qp: TreeQPIn) -> bool:
    """True when the crown+chains speed path applies: multistage scenario
    tree (setup_multistage_tree shape) with clipping-class data."""
    if qp.topo.multistage_params is None:
        return False
    from treeqp_tpu.solvers.tdunes import clipping_applicable
    return clipping_applicable(qp)


def split_multistage(qp: TreeQPIn) -> MultistageQP:
    """Split a multistage TreeQPIn into crown + stacked chains.

    Layout requirement: diagonal Q/R, zero S. General C/D rows are
    allowed and carried in stacked chain arrays — the multistage IPM
    handles them (dense barrier blocks); the multistage dual Newton
    (tdunes_ms_solve) additionally requires nc = 0 (clipping)."""
    topo = qp.topo
    if not isinstance(qp.Q, jax.core.Tracer) and not td.diag_weights_applicable(qp):
        raise ValueError("multistage solver requires diagonal Q/R and zero S "
                         "(general C/D rows are allowed for the IPM)")
    params = topo.multistage_params
    assert params is not None, "not a multistage scenario tree"
    md, Nr, Nh = params
    S = md**Nr if md > 1 else 1
    L = Nh - Nr
    ss = topo.stage_start
    root_ids = tuple(range(int(ss[Nr]), int(ss[Nr + 1])))
    assert len(root_ids) == S

    # chain node id grid [S, L]: stage-contiguous BFS numbering keeps
    # scenario order within each stage
    ids = np.stack([np.arange(ss[Nr + 1 + j], ss[Nr + 2 + j]) for j in range(L)],
                   axis=1).astype(np.int32)  # [S, L]
    # consistency: each chain node's parent is the previous chain node
    par = topo.parent_np
    assert np.array_equal(par[ids[:, 0]], np.asarray(root_ids))
    for j in range(1, L):
        assert np.array_equal(par[ids[:, j]], ids[:, j - 1])

    nx = topo.nx[root_ids[0]]
    nu = topo.nu[root_ids[0]]
    nxm, num = topo.nxm, topo.num

    crown_nodes = int(ss[Nr + 1])
    crown_topo = TreeStructure.from_parent(
        topo.parent[:crown_nodes], topo.nx[:crown_nodes],
        topo.nu[:crown_nodes], topo.nc[:crown_nodes])

    xm = jnp.asarray(topo.x_mask, qp.dtype)[ids]  # [S, L, nxm]
    um = jnp.asarray(topo.u_mask, qp.dtype)[ids]
    Qd = jnp.diagonal(qp.Q, axis1=1, axis2=2)[ids] * xm + (1 - xm)
    Rd = jnp.diagonal(qp.R, axis1=1, axis2=2)[ids] * um + (1 - um)

    crown = TreeQPIn(
        **{f: getattr(qp, f)[:crown_nodes] for f in
           ("Q", "R", "S", "q", "r", "xmin", "xmax", "umin", "umax",
            "C", "D", "dmin", "dmax", "A", "B", "b")},
        topo=crown_topo)

    meta = _MsMeta(md=md, Nr=Nr, Nh=Nh, S=S, L=L, nx=nx, nu=nu,
                   crown_topo=crown_topo, full_topo=topo, root_ids=root_ids)
    general = {}
    if max(topo.nc) > 0:  # ncm is padded to >= 1 even without C/D rows
        general = dict(C=qp.C[ids], D=qp.D[ids],
                       dmin=qp.dmin[ids], dmax=qp.dmax[ids])
    return MultistageQP(
        crown=crown, Qd=Qd, Rd=Rd,
        q=qp.q[ids], r=qp.r[ids],
        xmin=qp.xmin[ids], xmax=qp.xmax[ids],
        umin=qp.umin[ids], umax=qp.umax[ids],
        A=qp.A[ids], B=qp.B[ids], b=qp.b[ids],
        meta=meta, **general)


# ---------------------------------------------------------------------------
# chain operations (all batched over [S, L])


def _chain_stage_solve(ms: MultistageQP, lam_ch):
    """Clipping stage solve for all chain nodes.

    qmod[s,j] = -q + lam[s,j] - A[s,j+1]' lam[s,j+1]   (last j: no kid term)
    """
    # packed [A B] operand: ONE einsum for both contractions (the concat of
    # the loop-invariant dynamics is hoisted out of solver loops by XLA)
    nx = ms.A.shape[-1]
    AB = jnp.concatenate([ms.A, ms.B], axis=3)[:, 1:]
    ABup = jnp.einsum("sljn,slj->sln", AB, lam_ch[:, 1:])
    Aup, Bup = ABup[..., :nx], ABup[..., nx:]
    qmod = -ms.q + lam_ch
    qmod = qmod.at[:, :-1].add(-Aup)
    rmod = -ms.r
    rmod = rmod.at[:, :-1].add(-Bup)
    Qinv, Rinv = 1.0 / ms.Qd, 1.0 / ms.Rd
    xUnc = Qinv * qmod
    uUnc = Rinv * rmod
    x = jnp.clip(xUnc, ms.xmin, ms.xmax)
    u = jnp.clip(uUnc, ms.umin, ms.umax)
    qt = jnp.where((xUnc > ms.xmax) | (xUnc < ms.xmin), 0.0, Qinv)
    rt = jnp.where((uUnc > ms.umax) | (uUnc < ms.umin), 0.0, Rinv)
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc, qt=qt, rt=rt)


class _Shard:
    """Explicit-SPMD context for running the multistage solver body inside
    ``jax.shard_map`` with the chains sharded over a mesh axis and the
    crown replicated (SURVEY 5.8; parallel/shard_solver.py wraps it).

    Inside shard_map the chain arrays are the LOCAL shard; the crown data
    and every crown computation are replicated. All cross-device traffic
    is explicit here: the chain-root contributions / Schur complements
    sum into the replicated crown via ``psum`` — exactly the minimal
    boundary bytes the communication model counts
    (benchmarks/scaling_analysis.py) — instead of the chain-shaped
    gathers GSPMD's auto-partitioner inserts (tests/test_hlo_audit.py,
    round-4 finding). Reference analog: the OpenMP scenario fork-join of
    dual_Newton_scenarios.c:528-563 with shared-memory coupling."""

    def __init__(self, meta, axis: str, S_local: int, prep_cr):
        self.axis = axis
        rid = jnp.asarray(np.asarray(meta.root_ids))
        ax = jax.lax.axis_index(axis)
        start = ax * S_local
        self.rid_l = jax.lax.dynamic_slice(rid, (start,), (S_local,))
        nxm = meta.crown_topo.nxm
        self.g_of_l = jnp.asarray(np.asarray(prep_cr.group_of_node))[self.rid_l]
        slot_l = jnp.asarray(np.asarray(prep_cr.slot_of_node))[self.rid_l]
        self.rows_l = slot_l[:, None] * nxm + jnp.arange(nxm)[None, :]

    def psum(self, v):
        return jax.lax.psum(v, self.axis)

    def gather_s(self, v):
        """All-gather a per-scenario array along dim 0 (the compact
        boundary form: S*rows bytes instead of a crown-shaped dense
        psum — the byte count the communication model assumes)."""
        return jax.lax.all_gather(v, self.axis, axis=0, tiled=True)

    def all_true(self, flag):
        # globally-agreed boolean (predicates guarding collectives must
        # not diverge across devices)
        return self.psum(1 - flag.astype(jnp.int32)) == 0


def _rid_of(ms, shard: "_Shard | None"):
    if shard is not None:
        return shard.rid_l
    return np.asarray(ms.meta.root_ids)


def _chain_root_contrib(ms: MultistageQP, lam_ch, shard=None):
    """-A0'lam0 / -B0'lam0 terms to inject into the crown stage-Nr nodes'
    modified gradients, in crown [Ncrown, nxm/num] layout (all-gathered;
    psummed over the mesh axis under shard_map)."""
    nx = ms.A.shape[-1]
    AB0 = jnp.concatenate([ms.A, ms.B], axis=3)[:, 0]
    cqr = jnp.einsum("sjn,sj->sn", AB0, lam_ch[:, 0])
    cq, cr = cqr[..., :nx], cqr[..., nx:]  # [S, nxm] / [S, num]
    Ncrown = ms.meta.crown_topo.Nn
    rid = np.asarray(ms.meta.root_ids)
    if shard is not None:
        cq, cr = shard.gather_s(cq), shard.gather_s(cr)  # [S, *]
    extra_q = jnp.zeros((Ncrown, cq.shape[-1]), cq.dtype).at[rid].set(cq)
    extra_r = jnp.zeros((Ncrown, cr.shape[-1]), cr.dtype).at[rid].set(cr)
    return extra_q, extra_r


def _chain_residual(ms: MultistageQP, ch, x_crown, u_crown, AT=None, BT=None,
                    shard=None):
    """res[s,j] = A x_parent + B u_parent + b - x  over all chain edges.

    ``AT``/``BT`` are pre-transposed copies of ms.A/ms.B (swapaxes(2, 3)),
    passed once per solve so the contraction runs over the minor axis."""
    rid = _rid_of(ms, shard)
    if AT is None:
        AT, BT = ms.A.swapaxes(2, 3), ms.B.swapaxes(2, 3)
    xp = jnp.concatenate([x_crown[rid][:, None], ch["x"][:, :-1]], axis=1)
    up = jnp.concatenate([u_crown[rid][:, None], ch["u"][:, :-1]], axis=1)
    # stacked [A' ; B'] against [x; u]: one einsum, no separate add
    ABT = jnp.concatenate([AT, BT], axis=2)
    zp = jnp.concatenate([xp, up], axis=2)
    return jnp.einsum("sljn,slj->sln", ABT, zp) + ms.b - ch["x"]


def _chain_blocks(ms: MultistageQP, ch, qt_crown, rt_crown, dtype=None,
                  shard=None):
    """Dual-Hessian chain blocks Wc [S,L,nx,nx] / Utc [S,L,nx,nx].

    Wc[s,j]  = A_j qt_p A_j' + B_j rt_p B_j' + qt_j   (p = parent of node j)
    Utc[s,j] = -qt_p * A_j'   (coupling of lam[s,j] to the parent's lambda)

    With ``dtype=float32`` the blocks are built directly in f32 — they feed
    only the (f32) factorization; the exact Hessian action for refinement is
    applied separately in f64 (_ms_apply_M).
    """
    rid = _rid_of(ms, shard)
    A, B = ms.A, ms.B
    qt_p = jnp.concatenate([qt_crown[rid][:, None], ch["qt"][:, :-1]], axis=1)
    rt_p = jnp.concatenate([rt_crown[rid][:, None], ch["rt"][:, :-1]], axis=1)
    qt_c = ch["qt"]
    if dtype is not None:
        A, B = A.astype(dtype), B.astype(dtype)
        qt_p, rt_p, qt_c = (v.astype(dtype) for v in (qt_p, rt_p, qt_c))
    AB = jnp.concatenate([A, B], axis=3)
    zt_p = jnp.concatenate([qt_p, rt_p], axis=2)
    Wc = jnp.einsum("slin,sln,sljn->slij", AB, zt_p, AB)
    nxm = Wc.shape[-1]
    Wc = Wc + jnp.eye(nxm, dtype=Wc.dtype) * qt_c[:, :, None, :]
    Utc = -(qt_p[:, :, :, None] * A.swapaxes(2, 3))  # [S,L,nx(parent),nx(child)]
    return Wc, Utc


def _equilibrate_chain(Wc, Utc, s_root):
    """Jacobi equilibration of the chain blocks: unit diagonals, with the
    coupling rows scaled by the parent's scale (``s_root`` [S, nx] for the
    chain roots' crown parents). Returns (Wc, Utc, sc)."""
    sc = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.diagonal(Wc, axis1=2, axis2=3), 1e-12))
    scp = jnp.concatenate([s_root[:, None].astype(sc.dtype),
                           sc[:, :-1]], axis=1)
    Wc = Wc * sc[..., :, None] * sc[..., None, :]
    Utc = Utc * scp[..., :, None] * sc[..., None, :]
    return Wc, Utc, sc


def _triton_sweeps(meta, shard=None) -> bool:
    """Whether the chain sweeps run as the Triton kernels
    (ops/chain_kernels.py) rather than as the ``lax.scan`` reference: on a
    GPU, over whole chains on one device or over the local block inside
    shard_map (``shard``). Chains that GSPMD splits over devices
    (``meta.chain_shards > 1``) take the scans, which GSPMD partitions; the
    kernels have no partitioning rule."""
    return (jax.default_backend() == "gpu"
            and (shard is not None or meta.chain_shards == 1))


def _chain_factor(Wc, Utc, opts: TdunesOpts, triton: bool = False):
    """Banded backward factorization per chain, scan j = L-1 .. 0.

    Returns per-step factors (Lc, CU) and the Schur complement flowing into
    the crown. Mirrors the reference per-scenario reverse Cholesky
    (dual_Newton_scenarios.c:590-689) on the tree-formulation blocks.
    ``triton`` runs the sweep as one kernel; its factors are then in the
    kernel layout, which only the kernel sweeps below read.
    """
    out_dt = Wc.dtype
    if opts.factor_dtype == "float32":
        Wc, Utc = Wc.astype(jnp.float32), Utc.astype(jnp.float32)
    if triton:
        from treeqp_tpu.ops import chain_kernels as ck
        Ls, CUs, schur0 = ck.chain_factor(
            Wc, Utc, reg=(opts.reg_type, opts.reg_value, opts.reg_tol))
        return Ls, CUs, schur0.astype(out_dt)
    S, L, nx, _ = Wc.shape
    dt = Wc.dtype

    def step(schur, inp):
        Wj, Utj = inp
        Lb = td._reg_cholesky(Wj - schur, opts)
        CU = jax.lax.linalg.triangular_solve(
            Lb, Utj, left_side=False, lower=True, transpose_a=True)
        return CU @ CU.swapaxes(1, 2), (Lb, CU)

    inps = (jnp.flip(Wc, 1).swapaxes(0, 1), jnp.flip(Utc, 1).swapaxes(0, 1))
    schur0, (Ls, CUs) = jax.lax.scan(step, jnp.zeros((S, nx, nx), dt), inps)
    Ls = jnp.flip(Ls, 0).swapaxes(0, 1)   # [S, L, nx, nx]
    CUs = jnp.flip(CUs, 0).swapaxes(0, 1)
    return Ls, CUs, schur0.astype(out_dt)


def _chain_solve_bwd(Ls, CUs, res_ch, triton: bool = False):
    """RHS backward sweep with stored factors: y_j = L^-1(r_j - CU y_{j+1}-
    style accumulation); returns y and the RHS update into the crown."""
    out_dt = res_ch.dtype
    res_ch = res_ch.astype(Ls.dtype)
    if triton:
        from treeqp_tpu.ops import chain_kernels as ck
        ys, radd0 = ck.chain_solve_bwd(Ls, CUs, res_ch)
        return ys, radd0.astype(out_dt)
    S, L, nx, _ = Ls.shape

    def step(radd, inp):
        Lb, CU, rj = inp
        y = jax.lax.linalg.triangular_solve(
            Lb, (rj - radd)[..., None], left_side=True, lower=True)[..., 0]
        return jnp.einsum("sij,sj->si", CU, y), y

    inps = (jnp.flip(Ls, 1).swapaxes(0, 1), jnp.flip(CUs, 1).swapaxes(0, 1),
            jnp.flip(res_ch, 1).swapaxes(0, 1))
    radd0, ys = jax.lax.scan(step, jnp.zeros((S, nx), Ls.dtype), inps)
    ys = jnp.flip(ys, 0).swapaxes(0, 1)
    return ys, radd0.astype(out_dt)


def _chain_forward(Ls, CUs, ys, dlam_root, triton: bool = False):
    """Forward substitution down each chain, scan j = 0 .. L-1.

    dlam[s,j] = L^-T (y[s,j] - CU[s,j]' dlam_parent).
    ``dlam_root`` [S, nx] is the crown's dlam at the edge into each chain root.
    """
    out_dt = dlam_root.dtype
    if triton:
        from treeqp_tpu.ops import chain_kernels as ck
        dls = ck.chain_forward(Ls, CUs, ys, dlam_root.astype(Ls.dtype))
        return dls.astype(out_dt)

    def step(dp, inp):
        Lb, CU, y = inp
        d = y - jnp.einsum("sij,si->sj", CU, dp)
        dl = jax.lax.linalg.triangular_solve(
            Lb, d[..., None], left_side=True, lower=True, transpose_a=True)[..., 0]
        return dl, dl

    _, dls = jax.lax.scan(step, dlam_root.astype(Ls.dtype),
                          (Ls.swapaxes(0, 1), CUs.swapaxes(0, 1), ys.swapaxes(0, 1)))
    return dls.swapaxes(0, 1).astype(out_dt)  # [S, L, nx]


def _chain_dual_terms(ms: MultistageQP, ch, lam_ch):
    """Chain contribution to f = -g: per node -1/2 x'Qx + qmod'x (+u terms),
    minus sum over chain edges b'lam."""
    x, u = ch["x"], ch["u"]
    tx = x * (ch["qmod"] - 0.5 * ms.Qd * x) - ms.b * lam_ch
    tu = u * (ch["rmod"] - 0.5 * ms.Rd * u)
    return jnp.sum(tx) + jnp.sum(tu)


# ---------------------------------------------------------------------------
# full solve


def _ms_stage_solve(ms: MultistageQP, crown_data, lam_cr, lam_ch, opts,
                    prep_cr, shard=None):
    ch = _chain_stage_solve(ms, lam_ch)
    extra_q, extra_r = _chain_root_contrib(ms, lam_ch, shard)
    cr = td._stage_solve(ms.crown, lam_cr, crown_data, opts, prep_cr,
                         extra_q, extra_r)
    return cr, ch


def _ms_apply_M(ms: MultistageQP, cr, ch, dlam_cr, dlam_ch, prep_cr,
                trans=None, shard=None):
    """Apply the exact dual Hessian M = J P J' to a direction, in the data
    dtype. Used for iterative refinement of f32-factored Newton solves:
    M d = -(linearized dynamics residual of the linear stage response).

    ``trans`` optionally carries pre-transposed dynamics (ATc/BTc chain,
    ATr/BTr crown) to keep f64 einsums off the slow minor-dim contraction."""
    qp = ms.crown
    xm, um, nrxm = td._masks(qp)
    if trans is None:
        trans = dict(ATc=ms.A.swapaxes(2, 3), BTc=ms.B.swapaxes(2, 3),
                     ATr=qp.A.swapaxes(1, 2), BTr=qp.B.swapaxes(1, 2))
    # crown linear stage response (packed [A B] -> one einsum + one segsum)
    nxc = qp.A.shape[-1]
    ABr = jnp.concatenate([qp.A, qp.B], axis=2)
    AtBtL = jnp.einsum("nji,nj->ni", ABr, dlam_cr)
    sum_AB = kid_sum(AtBtL, prep_cr.topo)
    sum_A, sum_B = sum_AB[..., :nxc], sum_AB[..., nxc:]
    eq, er = _chain_root_contrib(ms, dlam_ch, shard)
    xl = cr["qtilde"] * (dlam_cr - sum_A - eq) * xm
    ul = cr["rtilde"] * (-sum_B - er) * um
    # chain linear stage response
    nx = ms.A.shape[-1]
    ABc = jnp.concatenate([ms.A, ms.B], axis=3)[:, 1:]
    ABup = jnp.einsum("sljn,slj->sln", ABc, dlam_ch[:, 1:])
    Aup, Bup = ABup[..., :nx], ABup[..., nx:]
    qml = dlam_ch.at[:, :-1].add(-Aup)
    rml = jnp.zeros_like(ch["rmod"]).at[:, :-1].add(-Bup)
    xlc = ch["qt"] * qml
    ulc = ch["rt"] * rml
    # linearized residuals (stacked transposes against [x; u])
    ABTr = jnp.concatenate([trans["ATr"], trans["BTr"]], axis=1)
    zpr = jnp.concatenate([xl[prep_cr.par], ul[prep_cr.par]], axis=1)
    res_cr = (jnp.einsum("nji,nj->ni", ABTr, zpr) - xl) * nrxm
    rid = _rid_of(ms, shard)
    xp = jnp.concatenate([xl[rid][:, None], xlc[:, :-1]], axis=1)
    up = jnp.concatenate([ul[rid][:, None], ulc[:, :-1]], axis=1)
    ABTc = jnp.concatenate([trans["ATc"], trans["BTc"]], axis=2)
    zpc = jnp.concatenate([xp, up], axis=2)
    res_ch = jnp.einsum("sljn,slj->sln", ABTc, zpc) - xlc
    return -res_cr, -res_ch


def _ms_dual_value(ms, crown_data, lam_cr, lam_ch, cr, ch, opts,
                   shard=None):
    f_cr = td._dual_value(ms.crown, lam_cr, cr, crown_data, opts)
    f_ch = _chain_dual_terms(ms, ch, lam_ch)
    if shard is not None:
        f_ch = shard.psum(f_ch)  # crown term replicated, chains sharded
    return f_cr + f_ch



_SLOT_MAT_CACHE = {}


def _slot_mats(g_of, rows, NpG, nxm):
    """Static per-slot scenario->group one-hot matrices [K, S, NpG]:
    mats[k][s, g] = 1 iff chain root s sits in group g at kid slot k.
    Cached per (g_of, rows) pattern."""
    g_of = np.asarray(g_of)
    rows = np.asarray(rows)
    key = (g_of.tobytes(), rows.tobytes(), NpG, nxm)
    hit = _SLOT_MAT_CACHE.get(key)
    if hit is not None:
        return hit
    while len(_SLOT_MAT_CACHE) >= 32:  # bound for long-lived --serve processes
        _SLOT_MAT_CACHE.pop(next(iter(_SLOT_MAT_CACHE)))
    slot = rows[:, 0] // nxm
    K = int(slot.max()) + 1 if slot.size else 1
    S = g_of.shape[0]
    mats = np.zeros((K, S, NpG), np.float32)
    mats[slot, np.arange(S), g_of] = 1.0
    _SLOT_MAT_CACHE[key] = mats
    return mats


def _schur_scatter(schur0, g_of, rows, prep, nxm, dtype):
    """Scatter the per-scenario [nxm, nxm] chain-root Schur blocks into
    the [NpG, G, G] crown-group layout (each block lands on its group's
    kid-slot diagonal block) as K static slot matmuls + static block
    writes, in place of a `.at[g_of, rows, rows].add` scatter."""
    NpG, G = prep.NpG, prep.G
    S = schur0.shape[0]
    mats = _slot_mats(g_of, rows, NpG, nxm)
    flat = schur0.reshape(S, nxm * nxm).astype(dtype)
    out = jnp.zeros((NpG, G, G), dtype)
    for k in range(mats.shape[0]):
        if not mats[k].any():
            continue
        Wk = jnp.einsum("sg,sa->ga", jnp.asarray(mats[k], dtype), flat)
        out = out.at[:, k * nxm:(k + 1) * nxm,
                     k * nxm:(k + 1) * nxm].set(Wk.reshape(NpG, nxm, nxm))
    return out


def _rhs_scatter(radd0, g_of, rows, prep, nxm, dtype):
    """Vector form of _schur_scatter: per-scenario [nxm] chain-root RHS
    contributions into the [NpG, G] group layout via the same static slot
    matmuls (replaces `rg.at[g_of, rows].add`)."""
    NpG, G = prep.NpG, prep.G
    mats = _slot_mats(g_of, rows, NpG, nxm)
    flat = radd0.astype(dtype)
    out = jnp.zeros((NpG, G), dtype)
    for k in range(mats.shape[0]):
        if not mats[k].any():
            continue
        vk = jnp.einsum("sg,sa->ga", jnp.asarray(mats[k], dtype), flat)
        out = out.at[:, k * nxm:(k + 1) * nxm].set(vk)
    return out


def _ms_factorize(ms, qtilde_cr, rtilde_cr, qt_ch, rt_ch, opts, prep_cr,
                  g_of, rows, nrxm_cr, s_node_dt, shard=None):
    """Shared factorize of the crown+chains dual Hessian (f64 and df64
    loops): blocks + Jacobi equilibration + chain/crown factorization."""
    meta = ms.meta
    fdt = jnp.float32 if opts.factor_dtype == "float32" else None
    prep = prep_cr
    nxm = meta.crown_topo.nxm
    ar = np.arange(nxm)
    rows_all = prep.gslot[:, None] * nxm + ar[None, :]
    dad_safe = np.maximum(prep.gdad, 0)

    W, Ut = td._build_dual_hessian(
        ms.crown, {"qtilde": qtilde_cr, "rtilde": rtilde_cr}, None,
        opts, prep, dtype=fdt)
    sW = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.diagonal(W, axis1=1, axis2=2), 1e-12))
    sUt_rows = sW[dad_safe[:, None], rows_all]
    W = W * sW[:, :, None] * sW[:, None, :]
    Ut = Ut * sUt_rows[:, :, None] * sW[:, None, :]
    # local-scenario view for the chain-side uses (scp); the crown-side
    # Schur scatter keeps the GLOBAL indices (post all-gather)
    if shard is not None:
        g_of_loc, rows_loc = shard.g_of_l, shard.rows_l
    else:
        g_of_loc, rows_loc = g_of, rows
    s_root = sW[g_of_loc[:, None], rows_loc]
    s_node = td._group_to_nodes_mm(sW, prep, s_node_dt) * nrxm_cr

    Wc, Utc = _chain_blocks(ms, {"qt": qt_ch, "rt": rt_ch},
                            qtilde_cr, rtilde_cr, dtype=fdt, shard=shard)
    Wc, Utc, sc = _equilibrate_chain(Wc, Utc, s_root)
    Ls, CUs, schur0 = _chain_factor(Wc, Utc, opts,
                                    _triton_sweeps(meta, shard))

    if shard is not None:
        schur0 = shard.gather_s(schur0)  # [S, nx, nx] boundary form
    W = W - _schur_scatter(schur0, g_of, rows, prep, nxm, W.dtype)
    crown_fact = td._tree_chol_factor(W, Ut, opts, prep)
    return dict(Ls=Ls, CUs=CUs, CholW=crown_fact["CholW"],
                CholUt=crown_fact["CholUt"], s_node=s_node, sc=sc)


def _make_ms_solve(fact, meta, prep_cr, opts, dt, nrxm_cr, g_of, rows, rid,
                   shard=None):
    """Build solve(rcr, rch) -> (dcr, dch) from stored factors: chain
    backward sweep, crown solve, chain forward sweep.

    Shared by the f32/f64 loop (_ms_newton_loop) and the df64 loop
    (ms_df64), whose factors and solves are f32."""
    Ls, CUs = fact["Ls"], fact["CUs"]
    s_node, sc = fact["s_node"], fact["sc"]
    crown_fact = dict(CholW=fact["CholW"], CholUt=fact["CholUt"])
    rid_loc = shard.rid_l if shard is not None else rid
    triton = _triton_sweeps(meta, shard)

    def solve(rcr, rch):
        rcr_s, rch_s = rcr * s_node, rch * sc
        ys, radd0 = _chain_solve_bwd(Ls, CUs, rch_s, triton)
        if shard is not None:
            radd0 = shard.gather_s(radd0)  # [S, nx] boundary form
        rg = td._nodes_to_group_mm(rcr_s, prep_cr)
        rg = rg - _rhs_scatter(radd0, g_of, rows, prep_cr,
                               meta.crown_topo.nxm, rg.dtype)
        dg = td._tree_chol_solve(crown_fact, rg, opts, prep_cr)
        dcr_s = td._group_to_nodes_mm(dg, prep_cr, dt) * nrxm_cr
        dch_s = _chain_forward(Ls, CUs, ys, dcr_s[rid_loc], triton)
        return dcr_s * s_node, dch_s * sc
    return solve


def _ms_newton_loop(ms: MultistageQP, lam0_crown, lam0_chain,
                    opts: TdunesOpts, it0, patience: int = 0):
    """The dual-Newton while-loop on one precision level.

    Runs in the dtype of ``ms``'s data. ``patience > 0`` adds a stall exit:
    stop when the residual error has not improved by >=10% for `patience`
    consecutive iterations — used by the coarse f32 phase, whose Armijo
    decisions become noise-limited near the f32 residual floor.
    Returns (lam_cr, lam_ch, it, status, ls_it).
    """
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt = ms.q.dtype
    crown_data = td._stage_data(ms.crown, opts)
    xm_cr, um_cr, nrxm_cr = td._masks(ms.crown)
    # explicit-SPMD context under shard_map (chains = local shard)
    shard = (_Shard(meta, opts.axis_name, ms.b.shape[0], prep_cr)
             if opts.axis_name else None)
    # pre-transposed dynamics, computed once and hoisted out of the loop
    trans = dict(ATc=ms.A.swapaxes(2, 3), BTc=ms.B.swapaxes(2, 3),
                 ATr=ms.crown.A.swapaxes(1, 2), BTr=ms.crown.B.swapaxes(1, 2))

    rid = np.asarray(meta.root_ids)
    # crown-group position of each chain root's lambda-edge: the Schur
    # complement of chain j=0 lands on the diagonal block of the crown group
    # holding lam(edge into root_ids[s])
    g_of = prep_cr.group_of_node[rid]            # crown group index per scenario
    slot = prep_cr.slot_of_node[rid]
    nxm = meta.crown_topo.nxm
    rows = slot[:, None] * nxm + np.arange(nxm)[None, :]  # [S, nxm]

    def stage_solve(lam_cr, lam_ch):
        return _ms_stage_solve(ms, crown_data, lam_cr, lam_ch, opts,
                               prep_cr, shard)

    def dual_value(lam_cr, lam_ch, cr, ch):
        return _ms_dual_value(ms, crown_data, lam_cr, lam_ch, cr, ch, opts,
                              shard)

    def residuals_of(cr, ch):
        res_cr = td._dual_residual(ms.crown, cr, prep_cr)
        res_ch = _chain_residual(ms, ch, cr["x"], cr["u"],
                                 AT=trans["ATc"], BT=trans["BTc"],
                                 shard=shard)
        return res_cr, res_ch

    def compute_residuals(lam_cr, lam_ch):
        cr, ch = stage_solve(lam_cr, lam_ch)
        return (cr, ch) + residuals_of(cr, ch)

    def error_of(res_cr, res_ch):
        if opts.termination == "infnorm":
            e_ch = jnp.max(jnp.abs(res_ch))
            if shard is not None:
                e_ch = jax.lax.pmax(e_ch, shard.axis)
            return jnp.maximum(jnp.max(jnp.abs(res_cr)), e_ch)
        sq_ch = jnp.sum(res_ch**2)
        if shard is not None:
            sq_ch = shard.psum(sq_ch)
        sq = jnp.sum(res_cr**2) + sq_ch
        return jnp.sqrt(sq) if opts.termination == "twonorm" else sq

    def factorize(cr, ch):
        return _ms_factorize(ms, cr["qtilde"], cr["rtilde"], ch["qt"],
                             ch["rt"], opts, prep_cr, g_of, rows, nrxm_cr,
                             dt, shard=shard)

    def active_sig(cr, ch):
        # With clipping, qtilde/rtilde are Qinv-or-0: exact array equality
        # is exactly active-set-pattern equality, and equal patterns give
        # bitwise-identical factorization inputs.
        return (cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"])

    def sig_equal(a, b):
        eq = [jnp.all(x == y) for x, y in zip(a, b)]
        out = eq[0]
        for e in eq[1:]:
            out = out & e
        if shard is not None:
            # globally-agreed predicate: the factorize under this cond
            # contains a psum (crown Schur), so the branch choice must
            # not diverge across devices
            out = shard.all_true(out)
        return out

    def make_solve(fact):
        return _make_ms_solve(fact, meta, prep_cr, opts, dt, nrxm_cr,
                              g_of, rows, rid, shard)

    def newton_step(carry, f0, cr, ch, res_cr, res_ch, fact_prev, sig_prev):
        # f0 = f(lam) carried from the previous line search's accepted
        # evaluation (same quantity) — saves one dual-value reduction/iter
        lam_cr, lam_ch, it, err, status, restart, ls_it = carry

        sig = active_sig(cr, ch)
        if opts.reuse_factorization:
            fact = jax.lax.cond(sig_equal(sig, sig_prev),
                                lambda: fact_prev, lambda: factorize(cr, ch))
        else:
            fact = factorize(cr, ch)
        solve = make_solve(fact)

        def newton_resnorm(dcr, dch):
            mcr, mch = _ms_apply_M(ms, cr, ch, dcr, dch, prep_cr, trans,
                                   shard)
            n_ch = jnp.sum((res_ch - mch) ** 2)
            if shard is not None:
                n_ch = shard.psum(n_ch)
            return (jnp.sum((res_cr - mcr) ** 2) + n_ch, mcr, mch)

        dlam_cr, dlam_ch = solve(res_cr, res_ch)
        if opts.refine_steps > 0 and not opts.refine_safeguard:
            for _ in range(opts.refine_steps):
                mcr, mch = _ms_apply_M(ms, cr, ch, dlam_cr, dlam_ch, prep_cr,
                                       trans, shard)
                ccr, cch = solve(res_cr - mcr, res_ch - mch)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
        elif opts.refine_steps > 0:
            # safeguarded = iterate UNCONDITIONALLY, return the best
            # iterate by Newton-system residual norm (see ms_df64 for the
            # rationale: refinement is non-monotone on ill-conditioned
            # active sets; keep-best-and-retry stalls)
            n_best, mcr, mch = newton_resnorm(dlam_cr, dlam_ch)
            best_cr, best_ch = dlam_cr, dlam_ch
            for _ in range(opts.refine_steps):
                ccr, cch = solve(res_cr - mcr, res_ch - mch)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
                n_new, mcr, mch = newton_resnorm(dlam_cr, dlam_ch)
                better = n_new < n_best
                best_cr = jnp.where(better, dlam_cr, best_cr)
                best_ch = jnp.where(better, dlam_ch, best_ch)
                n_best = jnp.where(better, n_new, n_best)
            dlam_cr, dlam_ch = best_cr, best_ch

        # --- Armijo line search on f = -g over (crown, chain) jointly
        dot_ch = jnp.sum(res_ch * dlam_ch)
        if shard is not None:
            dot_ch = shard.psum(dot_ch)
        dot = -(jnp.sum(res_cr * dlam_cr) + dot_ch)
        descent_ok = dot < 1e-10  # see tdunes.py: documented < 0 deviation

        def f_at(tau):
            lc = lam_cr + tau * dlam_cr
            lh = lam_ch + tau * dlam_ch
            cr2, ch2 = stage_solve(lc, lh)
            return dual_value(lc, lh, cr2, ch2), cr2, ch2

        # noise-aware Armijo slack (see ms_df64: the dual value carries
        # ~sqrt(Nterms)*eps relative noise; near convergence the true
        # decrease falls below it and exact comparisons stall the solver)
        eta = jnp.asarray(2.0 ** -45, dt) * jnp.abs(f0)

        def accepts(f2, tau):
            return f2 <= f0 + opts.ls_gamma * tau * dot + eta

        def cond_ls(c):
            tau, f, i, acc, _, _ = c
            return (~acc) & (i < opts.ls_max_iter)

        def body_ls(c):
            tau, f, i, acc, _, _ = c
            tau2 = opts.ls_beta * tau
            f2, cr2, ch2 = f_at(tau2)
            return (tau2, f2, i + 1, accepts(f2, tau2), cr2, ch2)

        one = jnp.ones((), dt)
        T = min(opts.ls_batch, opts.ls_max_iter)
        # every path returns the accepted tau's STAGE SOLUTION and dual
        # value too, so the next iteration reuses them (its f0 is exactly
        # this f) instead of re-solving / re-reducing
        f1, cr1, ch1 = f_at(one)
        acc1 = accepts(f1, one)
        if T > 0:
            # tau=1 fast path: near convergence the full Newton step is
            # accepted almost always, so pay ONE stage-solve eval and run
            # the batched backtracking only on rejection (the batch is
            # ~T stage solves; measured ~54us per eval on the bench tree)
            def quick_path():
                return (one, f1, jnp.ones((), jnp.int32), jnp.ones((), bool),
                        cr1, ch1)

            def batch_path():
                # batched trial steps (SURVEY 7 hard-part 4): all
                # tau = beta^k candidates (k >= 1) in one batched stage
                # solve, sequential fallback beyond
                taus = opts.ls_beta ** jnp.arange(1, T + 1, dtype=dt)
                fs, crs, chs = jax.vmap(f_at)(taus)
                accs = accepts(fs, taus)
                any_acc = jnp.any(accs)
                idx = jnp.argmax(accs)
                crb = jax.tree_util.tree_map(lambda a: a[idx], crs)
                chb = jax.tree_util.tree_map(lambda a: a[idx], chs)
                init = (taus[-1], fs[-1], jnp.full((), T + 1, jnp.int32),
                        any_acc,
                        jax.tree_util.tree_map(lambda a: a[-1], crs),
                        jax.tree_util.tree_map(lambda a: a[-1], chs))
                tau_sq, f_sq, it_sq, acc, crq, chq = jax.lax.while_loop(
                    cond_ls, body_ls, init)
                tau = jnp.where(any_acc, taus[idx], tau_sq)
                ls_it = jnp.where(any_acc, (idx + 2).astype(jnp.int32), it_sq)
                sel = lambda a, b: jnp.where(any_acc, a, b)
                f_t = sel(fs[idx], f_sq)
                cr_t = jax.tree_util.tree_map(sel, crb, crq)
                ch_t = jax.tree_util.tree_map(sel, chb, chq)
                return tau, f_t, ls_it, acc, cr_t, ch_t

            tau, f_t, ls_it, acc, cr_t, ch_t = jax.lax.cond(
                acc1, quick_path, batch_path)
        else:
            tau, f_t, ls_it, acc, cr_t, ch_t = jax.lax.while_loop(
                cond_ls, body_ls,
                (one, f1, jnp.ones((), jnp.int32), acc1, cr1, ch1))
        maxed = ~acc
        restart = jnp.where(maxed, restart + 1, 0)
        full_step = (opts.ls_restart_trigger > 0) & (restart >= opts.ls_restart_trigger)
        restart = jnp.where(full_step, 0, restart)
        # full-step restart: tau forced to 1; f_at(1)'s solution is cr1/ch1
        sel_fs = lambda a, b: jnp.where(full_step, a, b)
        tau = jnp.where(full_step, one, tau)
        f_t = sel_fs(f1, f_t)
        cr_t = jax.tree_util.tree_map(sel_fs, cr1, cr_t)
        ch_t = jax.tree_util.tree_map(sel_fs, ch1, ch_t)

        keep = descent_ok
        lam_cr2 = jnp.where(keep, lam_cr + tau * dlam_cr, lam_cr)
        lam_ch2 = jnp.where(keep, lam_ch + tau * dlam_ch, lam_ch)
        f_t = jnp.where(keep, f_t, f0)
        cr_t = jax.tree_util.tree_map(
            lambda a, b: jnp.where(keep, a, b), cr_t, cr)
        ch_t = jax.tree_util.tree_map(
            lambda a, b: jnp.where(keep, a, b), ch_t, ch)
        status = jnp.where(keep, status, TDUNES_NOT_DESCENT)
        return (lam_cr2, lam_ch2, it + 1, err, status, restart, ls_it), \
            fact, sig, f_t, cr_t, ch_t

    # step-then-evaluate structure: the carry always holds the stage
    # solution / residuals / error AT the carried lam, so the termination
    # check is free and the caller gets fresh final solutions without a
    # re-evaluation.
    def cond(carry):
        (_, _, it, err, status, _, _), _, _, (best, noimp), _, _ = carry
        ok = (err >= opts.tol) & (status == TDUNES_OPTIMAL) & (it < opts.max_iter)
        if patience > 0:
            ok = ok & (noimp < patience)
        return ok

    def body(carry):
        (lam_cr, lam_ch, it, err, status, restart, ls_it), \
            (cr, ch, res_cr, res_ch), f0, (best, noimp), fact, sig = carry
        stepped, fact2, sig2, f2, cr2, ch2 = newton_step(
            (lam_cr, lam_ch, it, err, status, restart, ls_it),
            f0, cr, ch, res_cr, res_ch, fact, sig)
        lam_cr2, lam_ch2 = stepped[0], stepped[1]
        # stage solution at the accepted step comes from the line search —
        # only the residuals remain to evaluate
        rc2, rh2 = residuals_of(cr2, ch2)
        err2 = error_of(rc2, rh2)
        improved = err2 < 0.9 * best
        best = jnp.minimum(best, err2)
        noimp = jnp.where(improved, 0, noimp + 1)
        state = (lam_cr2, lam_ch2, stepped[2], err2, stepped[4], stepped[5],
                 stepped[6])
        return state, (cr2, ch2, rc2, rh2), f2, (best, noimp), fact2, sig2

    cr0, ch0, rc0, rh0 = compute_residuals(lam0_crown, lam0_chain)
    err0 = error_of(rc0, rh0)
    f0_init = dual_value(lam0_crown, lam0_chain, cr0, ch0)
    # the initial factorization matches cr0/ch0's active set, so the first
    # newton_step's reuse-compare is a true hit and uses exactly fact0
    fact0 = factorize(cr0, ch0)
    sig0 = active_sig(cr0, ch0)
    init = ((lam0_crown, lam0_chain, jnp.asarray(it0, jnp.int32), err0,
             jnp.full((), TDUNES_OPTIMAL, jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            (cr0, ch0, rc0, rh0), f0_init,
            (err0, jnp.zeros((), jnp.int32)), fact0, sig0)
    (lam_cr, lam_ch, it, err, status, _, ls_it), (cr, ch, res_cr, res_ch), \
        _, _, fact_f, sig_f = jax.lax.while_loop(cond, body, init)
    return (lam_cr, lam_ch, it, status, ls_it, cr, ch, err,
            (fact_f, sig_f))


def _pattern_equal(sig_a, sig_b):
    """Active-set PATTERN equality across representations: the masked
    inverses are value-or-0, so (x != 0) is the active-set pattern even
    when the values were rounded through different paths (f32 stage data
    vs the hi word of df64 data)."""
    eqs = [jnp.all((a != 0) == (b != 0)) for a, b in zip(sig_a, sig_b)]
    out = eqs[0]
    for e in eqs[1:]:
        out = out & e
    return out


def _cast_ms(ms: MultistageQP, dtype):
    """Cast all float leaves of a MultistageQP (incl. the crown TreeQPIn)."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        ms)


@partial(jax.jit, static_argnames=("opts",))
def tdunes_ms_solve(ms: MultistageQP, lam0_crown=None, lam0_chain=None,
                    opts: TdunesOpts = TdunesOpts()):
    """Dual Newton solve in crown+chains layout.

    Returns (out_crown: TreeQPOut on the crown topology minus chain parts,
    chain solution dict, info). Use ``merge_output`` for a full-tree
    TreeQPOut. Shard chain arrays over a mesh axis to scale scenarios.

    With ``opts.f32_phase_tol > 0`` (and f64 data + factor_dtype=float32)
    the solve runs TWO phases: a coarse phase with everything — stage
    solves, residuals, dual values — in f32 down to f32_phase_tol or
    stall, then the f64 phase with
    iterative refinement to the final tolerance. Same Newton method, same
    final accuracy; the f64 phase typically needs only 1-3 iterations.
    """
    assert opts.stage_solver == "clipping", "multistage solver: clipping only"
    assert ms.C is None, \
        "multistage dual Newton requires nc = 0 (general C/D rows: use ipm_ms)"
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt = ms.q.dtype
    crown_data = td._stage_data(ms.crown, opts)
    xm_cr, um_cr, nrxm_cr = td._masks(ms.crown)

    if lam0_crown is None:
        lam0_crown = jnp.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), dt)
    if lam0_chain is None:
        lam0_chain = jnp.zeros_like(ms.q)
    lam0_crown = lam0_crown * nrxm_cr

    it0 = jnp.zeros((), jnp.int32)
    handover = None  # (fact, sig) of the coarse phase's last factorization
    use_coarse = (opts.f32_phase_tol > 0 and dt == jnp.float64
                  and opts.factor_dtype == "float32")
    if use_coarse:
        ms32 = _cast_ms(ms, jnp.float32)
        optsA = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol),
            ls_batch=opts.ls_batch if opts.ls_batch > 0 else 4)
        lamA_cr, lamA_ch, it0, _, _, _, _, _, handover = _ms_newton_loop(
            ms32, lam0_crown.astype(jnp.float32),
            lam0_chain.astype(jnp.float32), optsA, it0,
            patience=opts.f32_patience)
        # f32-phase status is discarded: a not-descent there is expected
        # noise near the f32 residual floor, not a failure
        lam0_crown = lamA_cr.astype(dt)
        lam0_chain = lamA_ch.astype(dt)

    if (opts.df64_phase and dt == jnp.float64
            and opts.factor_dtype == "float32" and opts.axis_name is None):
        from treeqp_tpu.solvers.ms_df64 import ms_newton_loop_df
        lam_cr, lam_ch, it, status, ls_it, cr, ch, err = ms_newton_loop_df(
            ms, lam0_crown, lam0_chain, opts, it0, handover=handover)
    else:
        lam_cr, lam_ch, it, status, ls_it, cr, ch, err, _ = _ms_newton_loop(
            ms, lam0_crown, lam0_chain, opts, it0)
    status = jnp.where((status == TDUNES_OPTIMAL) & (err >= opts.tol),
                       TDUNES_MAX_ITER, status)

    mu_x_cr = crown_data["Qd"] * (cr["xUnc"] - cr["x"]) * xm_cr
    mu_u_cr = crown_data["Rd"] * (cr["uUnc"] - cr["u"]) * um_cr
    crown_out = dict(x=cr["x"], u=cr["u"], lam=lam_cr * nrxm_cr,
                     mu_x=mu_x_cr, mu_u=mu_u_cr)
    chain_out = dict(x=ch["x"], u=ch["u"], lam=lam_ch,
                     mu_x=ms.Qd * (ch["xUnc"] - ch["x"]),
                     mu_u=ms.Rd * (ch["uUnc"] - ch["u"]))
    # iter_f32 = coarse-phase share of iter (phase-split diagnostics)
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it,
                iter_f32=it0)
    return crown_out, chain_out, info


def merge_output(ms: MultistageQP, crown_out, chain_out, info) -> TreeQPOut:
    """Assemble a full-tree TreeQPOut in the original node numbering."""
    meta = ms.meta
    topo = meta.full_topo
    dt = ms.q.dtype
    ids = chain_node_ids(meta)

    def assemble(crown_v, chain_v, width):
        out = jnp.zeros((topo.Nn, width), dt)
        out = out.at[: meta.crown_topo.Nn].set(crown_v)
        return out.at[ids].set(chain_v)

    xm = jnp.asarray(topo.x_mask, dt)
    um = jnp.asarray(topo.u_mask, dt)
    x = assemble(crown_out["x"], chain_out["x"], topo.nxm) * xm
    u = assemble(crown_out["u"], chain_out["u"], topo.num) * um
    lam = assemble(crown_out["lam"], chain_out["lam"], topo.nxm) * xm
    mu_x = assemble(crown_out["mu_x"], chain_out["mu_x"], topo.nxm) * xm
    mu_u = assemble(crown_out["mu_u"], chain_out["mu_u"], topo.num) * um
    mu_d = jnp.zeros((topo.Nn, topo.ncm), dt)
    if "mu_d" in crown_out and topo.ncm > 0:
        mu_d = assemble(crown_out["mu_d"], chain_out["mu_d"], topo.ncm) \
            * jnp.asarray(topo.c_mask, dt)
    return TreeQPOut(x=x, u=u, lam=lam, mu_x=mu_x, mu_u=mu_u,
                     mu_d=mu_d, info=info)
