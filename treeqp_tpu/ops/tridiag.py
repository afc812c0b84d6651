"""Batched block cyclic reduction for SPD block-tridiagonal systems.

The sdunes "Jay" system over adjacent-scenario couplings is block
tridiagonal with P = Ns-1 blocks; the reference factors it sequentially
("NOTE: Cannot be parallelized", dual_Newton_scenarios.c:815-817) and our
portable path is a lax.scan — P sequential steps of tiny ops, which on an
accelerator is launch-latency-bound (~P kernel launches per Newton
iteration at Ns = 256). Cyclic reduction (even-odd elimination) solves the same system
in ceil(log2 P) levels of BATCHED ops: each level Cholesky-factors all odd
blocks at once, folds them into their even neighbours, and recurses on the
halved system (SURVEY 5.8's prescription for the scenario-coupling solve).
All ops are jnp-batched — the same code runs on CPU/GPU and shards.

Convention: diag [P, b, b] (SPD blocks), off [P-1, b, b] with
off[i] = M[i+1, i], rhs [P, b].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _chol(D, shift, reg_tol):
    """Batched Cholesky with the on-the-fly Levenberg-Marquardt cascade of
    treeqp_dpotrf_l_with_reg_opts (dual_Newton_common.c:81-123), per block:
    factor, and re-factor WITH the per-row diagonal ``shift`` only the
    blocks whose smallest pivot is <= reg_tol (or NaN — exactly singular).
    reg_tol < 0 applies the shift unconditionally; shift None disables."""
    if shift is None:
        return jnp.linalg.cholesky(D)
    b = D.shape[-1]
    rows = jnp.arange(b)
    D1 = D.at[..., rows, rows].add(shift, unique_indices=True)
    if reg_tol < 0:
        return jnp.linalg.cholesky(D1)
    L0 = jnp.linalg.cholesky(D)
    piv = jnp.min(jnp.diagonal(L0, axis1=-2, axis2=-1), axis=-1)
    need = ~(piv > reg_tol)  # NaN-safe: NaN compares false
    L1 = jnp.linalg.cholesky(D1)
    return jnp.where(need[..., None, None], L1, L0)


def _cho_solve(L, B):
    """Solve (L L') X = B for batched [*, b, k] B."""
    y = jax.lax.linalg.triangular_solve(L, B, left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                           transpose_a=True)


def tridiag_cr_solve(diag, off, rhs, shift=None, reg_tol: float = -1.0):
    """Solve the SPD block-tridiagonal system by cyclic reduction.

    diag [P, b, b], off [P-1, b, b] (block (i+1, i)), rhs [P, b].
    Returns x [P, b]. Exact (direct) up to roundoff; ceil(log2 P) batched
    levels instead of P sequential steps. ``shift`` ([P, b] per-row
    Levenberg-Marquardt diagonal) and ``reg_tol`` select the per-block
    regularized Cholesky (see _chol): reg_tol >= 0 applies the shift on
    the fly only to blocks with pivots <= reg_tol.
    """
    P, b, _ = diag.shape
    dt = diag.dtype
    if P == 1:
        return _cho_solve(_chol(diag, shift, reg_tol), rhs[..., None])[..., 0]

    # pad off to length P (zero = no right neighbour)
    offp = jnp.concatenate([off, jnp.zeros((1, b, b), dt)], axis=0)

    D_odd = diag[1::2]                        # [no, b, b]
    no = D_odd.shape[0]
    Lo = _chol(D_odd, None if shift is None else shift[1::2], reg_tol)
    off_lo = offp[0:2 * no:2]                 # M[o, o-1] = off[o-1], o odd
    off_hi = offp[1:2 * no + 1:2]             # M[o+1, o] = off[o]
    Z1 = _cho_solve(Lo, off_lo)               # D_o^-1 M[o, o-1]
    Z2 = _cho_solve(Lo, jnp.swapaxes(off_hi, 1, 2))  # D_o^-1 M[o, o+1]
    zr = _cho_solve(Lo, rhs[1::2][..., None])[..., 0]

    ne = (P + 1) // 2
    D_ev = diag[0::2]
    r_ev = rhs[0::2]
    # left odd neighbour of even e=2j is odd j-1; right is odd j
    # (zero-padded at the ends)
    zpadM = jnp.zeros((1, b, b), dt)
    zpadv = jnp.zeros((1, b), dt)
    Z2_l = jnp.concatenate([zpadM, Z2], 0)[:ne]      # Z2_{j-1}
    zr_l = jnp.concatenate([zpadv, zr], 0)[:ne]
    Z1_r = jnp.concatenate([Z1, zpadM], 0)[:ne]      # Z1_j
    zr_r = jnp.concatenate([zr, zpadv], 0)[:ne]
    offl = jnp.concatenate([zpadM, offp], 0)[:ne * 2:2]   # off[e-1]
    offr = offp[0:2 * ne:2]                               # off[e]
    offr_t = jnp.swapaxes(offr, 1, 2)

    D_new = D_ev - offl @ Z2_l - offr_t @ Z1_r
    r_new = r_ev - (offl @ zr_l[..., None])[..., 0] \
        - (offr_t @ zr_r[..., None])[..., 0]
    # M'[j+1, j] = -off[e+1] Z1_j, e = 2j (off[e+1] = M[e+2, e+1])
    off_new = -offp[1:2 * (ne - 1):2] @ Z1[: ne - 1]

    x_ev = tridiag_cr_solve(D_new, off_new, r_new,
                            None if shift is None else shift[0::2], reg_tol)

    # back-substitute odd: x_o = zr_j - Z1_j x_{2j} - Z2_j x_{2j+2}
    x_r = jnp.concatenate([x_ev[1:], zpadv], 0)[:no]
    x_odd = zr - (Z1 @ x_ev[:no][..., None])[..., 0] \
        - (Z2 @ x_r[..., None])[..., 0]

    x = jnp.zeros((P, b), dt)
    x = x.at[0::2].set(x_ev[: (P + 1) // 2])
    x = x.at[1::2].set(x_odd)
    return x
