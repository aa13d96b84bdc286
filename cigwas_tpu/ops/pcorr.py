"""Batched partial-correlation CI tests — the level-l kernels of the skeleton.

The reference runs one CUDA thread per (node, combination) with hand-unrolled
SVD pseudo-inverses per level (`cuPC-S.cu:486-3020`). Here a level is a dense
batched computation: for a tile of nodes X, chunks of K candidate
conditioning sets S (position tuples into each node's neighbour list, shared
across nodes thanks to colex enumeration) and all neighbour slots Y at once:

    M2    = C[S, S]                  (K, l, l)   per node
    t     = M2^-1 C[X, S]            (K, l)
    H00   = 1 - C[X,S]·t
    H01   = C[X,Y] - C[Y,S]·t        (K, d)
    H11   = 1 - C[Y,S]·M2^-1·C[Y,S]  (K, d)
    rho   = H01 / sqrt(|H00 H11|)

which is the identical Schur-complement formulation of `cuPC-S.cu:664-699`.

Two design points:

* the Fisher z-transform is monotonic in |rho|, so the per-test
  ``|atanh(rho)| < Th`` of the reference becomes ``|rho| < tanh(Th)`` with
  the tanh evaluated once on the host — the inner sweep runs free of
  transcendentals,
* a whole batch of candidate-set chunks is processed per device dispatch
  with ``lax.scan`` (no per-chunk host round trips); the min-|rho|
  reduction over chunks replaces the reference's atomicCAS edge mutex with
  a deterministic reduction (removing its sepset tie-break
  nondeterminism).

Every float32 one-hot selection dot here is pinned to
``Precision.HIGHEST``: at default precision a GPU may run an f32 matmul in
TF32 (10-bit mantissa), which would round the selected correlations and
ESS values and move CI decisions. At HIGHEST a one-hot selection is exact.

Small conditioning matrices are inverted with closed forms for l <= 3 and
batched LU (`jnp.linalg.inv`) above; near-singular sets produce |rho| ~ 1,
i.e. "dependent", which errs toward keeping edges like the reference's
pseudo-inverse path.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# sentinel for invalid tests; |rho| <= 1 for any valid test
# numpy (not jnp) scalars: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks `init_distributed` (it must run
# before any backend initialization)
RHO_BIG = np.float32(2.0)
MARGIN_BIG = np.float32(3.0e38)


def _inv_small(M: jnp.ndarray, l: int) -> jnp.ndarray:
    """Batched inverse of (..., l, l) matrices; closed form for l <= 3."""
    if l == 1:
        return 1.0 / M
    if l == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        d = M[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack(
            [jnp.stack([d, -b], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
        )
        return inv / det[..., None, None]
    if l == 3:
        m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        c00 = m11 * m22 - m12 * m21
        c01 = m02 * m21 - m01 * m22
        c02 = m01 * m12 - m02 * m11
        c10 = m12 * m20 - m10 * m22
        c11 = m00 * m22 - m02 * m20
        c12 = m02 * m10 - m00 * m12
        c20 = m10 * m21 - m11 * m20
        c21 = m01 * m20 - m00 * m21
        c22 = m00 * m11 - m01 * m10
        det = m00 * c00 + m10 * c01 + m20 * c02
        adj = jnp.stack(
            [
                jnp.stack([c00, c01, c02], axis=-1),
                jnp.stack([c10, c11, c12], axis=-1),
                jnp.stack([c20, c21, c22], axis=-1),
            ],
            axis=-2,
        )
        return adj / det[..., None, None]
    return jnp.linalg.inv(M)


def _inv_unrolled(M: list, l: int) -> list:
    """Closed-form inverse of an unrolled list-of-lists matrix (l <= 3),
    entries being same-shaped arrays."""
    if l == 1:
        return [[1.0 / M[0][0]]]
    if l == 2:
        a, b = M[0]
        c, d = M[1]
        det = a * d - b * c
        return [[d / det, -b / det], [-c / det, a / det]]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = M
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m10 * c01 + m20 * c02
    return [
        [c00 / det, c01 / det, c02 / det],
        [c10 / det, c11 / det, c12 / det],
        [c20 / det, c21 / det, c22 / det],
    ]


def _combo_onehots(combos, d: int, l: int):
    """One-hot selection matrices for each combo position, l x (K, d)."""
    slot = jnp.arange(d)[None, :]
    return [(combos[:, i][:, None] == slot).astype(jnp.float32) for i in range(l)]


def _pcorr_rho_local(C_x, c_row, c0y, deg_x, combos_left, sel, combos, l: int):
    """Level-l |rho| for one node from its LOCAL neighbourhood panel.

    C_x: (d, d) correlations among the node's neighbours; c_row: (d,)
    correlations of x with its neighbours; c0y == c_row (kept separate for
    clarity); sel: l x (K, d) one-hot combo selectors.

    All conditioning-set accesses are one-hot matmuls / masked reductions,
    so the only gather in the whole level is the per-launch C_x slice.
    """
    K = sel[0].shape[0]
    d = C_x.shape[0]
    # rows_i[k, :] = C[S_ik, nbrs] ; C_x is symmetric so this also provides
    # M1Y_i = rows_i.T
    rows = [
        jnp.dot(sel[i], C_x, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        for i in range(l)
    ]  # l x (K, d)
    Cx = [jnp.sum(sel[i] * c_row[None, :], axis=1) for i in range(l)]  # l x (K,)
    if l <= 3:
        M2 = [
            [jnp.sum(rows[i] * sel[j], axis=1) for j in range(l)] for i in range(l)
        ]
        M2inv = _inv_unrolled(M2, l)
    else:
        M2d = jnp.stack(
            [
                jnp.stack([jnp.sum(rows[i] * sel[j], axis=1) for j in range(l)], -1)
                for i in range(l)
            ],
            -2,
        )  # (K, l, l); l >= 4 is rare
        M2inv_d = jnp.linalg.inv(M2d)
        M2inv = [[M2inv_d[:, i, j] for j in range(l)] for i in range(l)]
    t = [sum(M2inv[i][j] * Cx[j] for j in range(l)) for i in range(l)]  # l x (K,)
    H00 = 1.0 - sum(Cx[i] * t[i] for i in range(l))  # (K,)
    # M1Y_i as (d, K) = rows_i.T
    H01 = c0y[:, None] - sum(rows[i].T * t[i][None, :] for i in range(l))  # (d, K)
    H11 = 1.0 - sum(
        rows[i].T * M2inv[i][j][None, :] * rows[j].T
        for i in range(l)
        for j in range(l)
    )  # (d, K)
    rho = (jnp.abs(H01) * jax.lax.rsqrt(jnp.abs(H00[None, :] * H11))).T  # (K, d)

    k_ix = jnp.arange(K)
    slot_ix = jnp.arange(d)
    combo_ok = k_ix < combos_left  # (K,)
    slot_ok = slot_ix < deg_x  # (d,)
    y_in_S = jnp.zeros((K, d), dtype=bool)
    for i in range(l):
        y_in_S = y_in_S | (combos[:, i][:, None] == slot_ix[None, :])
    invalid = (~combo_ok[:, None]) | (~slot_ok[None, :]) | y_in_S
    rho = jnp.where(invalid | ~jnp.isfinite(rho), RHO_BIG, rho)
    return rho


@partial(jax.jit, static_argnames=("l",))
def level_scan_minrho(C, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
    """Many chunks of level-l CI tests in ONE dispatch.

    combos_seq: (nch, K, l) colex position tuples; left_seq: (nch, nt) valid
    rows per node per chunk.

    Returns (rho_min (nt, d), rank (nt, d)): per (node, neighbour-slot) the
    minimum |partial rho| over every scanned conditioning set and the
    LAUNCH-LOCAL rank (chunk_ix * K + argk, int32-safe) achieving it; the
    caller adds the launch's global offset with exact Python integers, so
    colex ranks beyond 2^31 cannot overflow on device.
    """
    # the only gathers of the level: per-node local panels, once per launch
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    c_row = C[node_ixs[:, None], nbrs]  # (nt, d)
    return level_scan_minrho_pre(C_x, c_row, deg, combos_seq, left_seq, l)


def level_scan_minrho_pre(C_x, c_row, deg, combos_seq, left_seq, l: int):
    """`level_scan_minrho` on PRE-GATHERED local panels (the row-sharded
    engine builds them with a ring pass over the panel shards)."""
    nt, d = c_row.shape
    nch, K, _ = combos_seq.shape

    def chunk_step(carry, inp):
        rho_min, rank, ci = carry
        combos, left = inp
        sel = _combo_onehots(combos, d, l)

        def per_node(C_x_n, c_row_n, deg_x, left_x):
            rho = _pcorr_rho_local(
                C_x_n, c_row_n, c_row_n, deg_x, left_x, sel, combos, l
            )
            return jnp.min(rho, axis=0), jnp.argmin(rho, axis=0)

        rho_c, argk = jax.vmap(per_node)(C_x, c_row, deg, left)
        better = rho_c < rho_min
        rho_min = jnp.where(better, rho_c, rho_min)
        rank = jnp.where(better, ci * K + argk.astype(jnp.int32), rank)
        return (rho_min, rank, ci + 1), None

    init = (
        jnp.full((nt, d), RHO_BIG, jnp.float32),
        jnp.zeros((nt, d), jnp.int32),
        jnp.int32(0),
    )
    (rho_min, rank, _), _ = jax.lax.scan(
        chunk_step, init, (combos_seq, left_seq)
    )
    return rho_min, rank


def _pair_sweep_chunk(Cb, qb, Ct, qt, deg_x, t_cap, y_excl, t0, ct: int):
    """One t-chunk of the pair sweep (the loop body of :func:`_pair_sweep`).
    Ct/qt are the caller's dynamic_slice chunk rows."""
    d = Cb.shape[0]
    Rt = jax.lax.rsqrt(jnp.abs(1.0 - Ct * Ct))  # (t, s)
    # first conditioning step: everything given B u {t}
    q2 = (qb[None, :] - qt[:, None] * Ct) * (
        jax.lax.rsqrt(jnp.abs(1.0 - qt * qt))[:, None] * Rt
    )  # (t, b) = pcorr(x, b | B u {t})
    CtT = Ct.T  # (y, t)
    RtT = Rt.T
    T2 = (Cb[:, None, :] - CtT[:, :, None] * Ct[None, :, :]) * (
        RtT[:, :, None] * Rt[None, :, :]
    )  # (y, t, s) = pcorr(y, s | B u {t})
    # second step: rho_{xy | B u {t, s}}
    rho = jnp.abs(q2.T[:, :, None] - q2[None, :, :] * T2) * (
        jax.lax.rsqrt(jnp.abs(1.0 - q2 * q2))[None, :, :]
        * jax.lax.rsqrt(jnp.abs(1.0 - T2 * T2))
    )  # (y, t, s)
    y_i3 = jax.lax.broadcasted_iota(jnp.int32, (d, ct, d), 0)
    t_i3 = jax.lax.broadcasted_iota(jnp.int32, (d, ct, d), 1) + t0
    s_i3 = jax.lax.broadcasted_iota(jnp.int32, (d, ct, d), 2)
    bad = (
        (s_i3 >= t_i3)  # s < t
        | (t_i3 >= t_cap)
        | (y_i3 >= deg_x)  # y live
        | (y_i3 == s_i3)
        | (y_i3 == t_i3)
        | (y_i3 == y_excl)
    )
    rho = jnp.where(bad | ~jnp.isfinite(rho), RHO_BIG, rho)
    # axis-wise reductions (never reshape the cube: XLA fuses a
    # producer into a plain reduce, but not through a reshape — the
    # reshape forces the (y, t, s) tensor to materialize in HBM).
    # Index extraction via masked-iota mins instead of argmin +
    # take_along_axis: bit-identical (min of a masked iota IS the
    # first-occurrence argmin, and the keepdims min is an exact element
    # of the reduced axis so the equality compare is exact). The iota
    # mins run in f32 — exact for indices << 2^24.
    rho_s = jnp.min(rho, axis=2, keepdims=True)  # (y, t, 1)
    s_f3 = s_i3.astype(jnp.float32)
    am_s = jnp.min(
        jnp.where(rho == rho_s, s_f3, jnp.float32(d)), axis=2
    )  # (y, t) smallest minimizing s
    rho_s = rho_s[:, :, 0]  # (y, t)
    rmin_k = jnp.min(rho_s, axis=1, keepdims=True)  # (y, 1)
    t_f2 = jax.lax.broadcasted_iota(jnp.int32, (d, ct), 1).astype(jnp.float32)
    am_t = jnp.min(
        jnp.where(rho_s == rmin_k, t_f2, jnp.float32(ct)), axis=1
    )  # smallest minimizing t (chunk-local)
    sl = jnp.min(
        jnp.where(t_f2 == am_t[:, None], am_s, jnp.float32(d)), axis=1
    )
    # positions stay f32 (exact for indices << 2^24); callers cast once
    return rmin_k[:, 0], am_t + t0, sl


def _pair_sweep(Cb, qb, deg_x, t_hi, y_excl, ct: int):
    """Min |rho_{xy|base u {s,t}}| over pairs s < t, per neighbour slot y.

    The level-(k+2) partial correlation given a base set B (|B| = k) is
    obtained from the level-k local panel by two steps of the classic
    recursion rho_{ab|B,c} = (rho_{ab|B} - rho_{ac|B} rho_{bc|B}) /
    sqrt((1-rho_{ac|B}^2)(1-rho_{bc|B}^2)) — algebraically the same Schur
    complement as `cuPC-S.cu:664-699`, but every test costs O(1) fused
    elementwise ops instead of a per-combination matrix inverse.

    Cb: (d, d) pcorr(a, b | B) among the node's neighbours; qb: (d,)
    pcorr(x, b | B); deg_x: live degree; pairs are restricted to
    s < t < min(deg_x, t_hi) and y != y_excl (the level-3 outer scan passes
    its base element). Chunked over t (the colex-major element) in blocks of
    ct so peak memory is (ct, d, d); within a chunk the argmin runs in
    (t, s)-major order and across chunks the merge is strictly `<` with t
    ascending — together this selects the LOWEST COLEX RANK among ties,
    matching the combinatorial path's chunk-scan tie-breaking.

    Loop bounds are STATIC: XLA pipelines and unrolls a static fori_loop
    but not a data-dependent while loop.

    Returns (rho_min (d,), t_pos (d,), s_pos (d,)) with positions into the
    neighbour list (int32).
    """
    d = Cb.shape[0]
    t_cap = jnp.minimum(deg_x, t_hi)

    def sliced_chunk(t0):
        Ct = jax.lax.dynamic_slice(Cb, (t0, 0), (ct, d))
        qt = jax.lax.dynamic_slice(qb, (t0,), (ct,))
        return _pair_sweep_chunk(Cb, qb, Ct, qt, deg_x, t_cap, y_excl,
                                 t0, ct)

    if ct == d:
        # single chunk: no loop at all
        r0, tp0, sp0 = sliced_chunk(0)
        return r0, tp0.astype(jnp.int32), sp0.astype(jnp.int32)

    def chunk(i, carry):
        rho0, tp0, sp0 = carry
        rmin, tl, sl = sliced_chunk(i * ct)
        # strict < with t ascending across chunks + first-occurrence argmin
        # within a chunk selects the lowest colex rank among ties
        better = rmin < rho0
        return (
            jnp.where(better, rmin, rho0),
            jnp.where(better, tl, tp0),
            jnp.where(better, sl, sp0),
        )

    init = (
        jnp.full((d,), RHO_BIG, jnp.float32),
        jnp.zeros((d,), jnp.float32),
        jnp.zeros((d,), jnp.float32),
    )
    rho, tp, sp = jax.lax.fori_loop(0, d // ct, chunk, init)
    return rho, tp.astype(jnp.int32), sp.astype(jnp.int32)


@jax.jit
def level1_local_sweep(C, node_ixs, nbrs, deg):
    """ALL level-1 CI tests of a node tile in one dispatch.

    For every node x and neighbour slot y, the minimum |rho_{xy|s}| over
    every single conditioning neighbour s of x — the same candidate set as
    `cal_Indepl1` (`cuPC-S.cu:486-582`) and as the dense v^3 sweep
    (`level1_dense_minrho`), but at sum(deg^2) cost instead of v^3: at the
    reference-default 11k block that is ~5 orders of magnitude fewer slots,
    bounded by the local-panel gather instead of the sweep. Lanes layout
    (nodes trailing), one recursion step. Ties break toward the smallest
    conditioning position = smallest variable index (neighbour lists are
    ascending), identical to the dense sweep's argmin.

    Returns (rho_min (nt, d), pos (nt, d) int32 positions into the
    neighbour list).
    """
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    c_row = C[node_ixs[:, None], nbrs]  # (nt, d)
    return level1_local_sweep_pre(C_x, c_row, deg)


@jax.jit
def level1_local_sweep_pre(C_x, c_row, deg):
    """`level1_local_sweep` on pre-gathered (nt, d, d) local panels.

    Bit-parity note: the arithmetic mirrors `_level1_dense_padded`'s
    pre-scaled form `|c_xy (R_xs R_ys) - P_xs P_ys|` op for op, so the two
    level-1 routes produce IDENTICAL rho values (the sharded engines run
    the dense route; plain-vs-engine byte-identity tests depend on this).
    """
    d = c_row.shape[1]
    Cb = jnp.transpose(C_x, (1, 2, 0))  # (s, y, nt): nodes on lanes
    qb = c_row.T  # (b, nt)
    Rc = jax.lax.rsqrt(jnp.abs(1.0 - Cb * Cb))  # R_ys as (s, y, nt)
    Pc = Cb * Rc
    Rq = jax.lax.rsqrt(jnp.abs(1.0 - qb * qb))  # R_xs as (s, nt)
    Pq = qb * Rq
    rho = jnp.abs(
        qb[None] * (Rq[:, None] * Rc) - Pq[:, None] * Pc
    )  # (s, y, nt) = |rho_{xy|s}|
    s_ix = jnp.arange(d)
    bad = (
        (s_ix[:, None, None] >= deg[None, None, :])  # s live
        | (s_ix[:, None, None] == s_ix[None, :, None])  # s == y
    )
    rho = jnp.where(bad | ~jnp.isfinite(rho), RHO_BIG, rho)
    rho_min = jnp.min(rho, axis=0)  # (y, nt)
    pos = jnp.argmin(rho, axis=0).astype(jnp.int32)
    return rho_min.T, pos.T


@partial(jax.jit, static_argnames=("ct",))
def level2_local_sweep(C, node_ixs, nbrs, deg, ct: int):
    """ALL level-2 CI tests of a node tile in one dispatch.

    For every node x of the tile and every neighbour slot y, the minimum
    |rho_{xy|s,t}| over all C(deg(x), 2) conditioning pairs from x's
    neighbour list, with the minimizing pair positions (colex tie-break —
    identical test set to `cal_Indepl2`, `cuPC-S.cu:584-716`). Dense
    local-panel recursion: ~O(1) elementwise ops per test, no per-combination
    gathers or inverses.

    Returns (rho_min (nt, d), pos (nt, d, 2) int32 ascending positions).
    """
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    c_row = C[node_ixs[:, None], nbrs]  # (nt, d)
    return level2_local_sweep_pre(C_x, c_row, deg, ct=ct)


@partial(jax.jit, static_argnames=("ct",))
def level2_local_sweep_pre(C_x, c_row, deg, ct: int):
    """`level2_local_sweep` on pre-gathered (nt, d, d) local panels."""
    d = c_row.shape[1]

    def per_node(Cb, qb, deg_x):
        rho, t_pos, s_pos = _pair_sweep(
            Cb, qb, deg_x, jnp.int32(d), jnp.int32(d), ct
        )
        return rho, jnp.stack([s_pos, t_pos], axis=-1)

    return jax.vmap(per_node)(C_x, c_row, deg)


@partial(jax.jit, static_argnames=("ct",))
def level3_local_sweep(C, node_ixs, nbrs, deg, ct: int):
    """ALL level-3 CI tests of a node tile in one dispatch.

    Outer scan over the largest conditioning element u (colex-major): each
    step conditions the local panel on u via the recursion and runs the
    level-2 pair sweep bounded to s < t < u. Strict-< merge with u ascending
    keeps the lowest colex rank among ties. Same tests as `cal_Indepl3`
    (`cuPC-S.cu:718-871`).

    Returns (rho_min (nt, d), pos (nt, d, 3) int32 ascending positions).
    """
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]
    c_row = C[node_ixs[:, None], nbrs]
    return level3_local_sweep_pre(C_x, c_row, deg, ct=ct)


@partial(jax.jit, static_argnames=("ct",))
def level3_local_sweep_pre(C_x, c_row, deg, ct: int):
    """`level3_local_sweep` on pre-gathered (nt, d, d) local panels."""
    d = c_row.shape[1]

    def per_node(Cb, qb, deg_x):
        def outer(u, carry):
            rho0, p3, p2, p1 = carry
            cu = jax.lax.dynamic_index_in_dim(Cb, u, 0, keepdims=False)  # (d,)
            qu = jax.lax.dynamic_index_in_dim(qb, u, 0, keepdims=False)
            Ru = jax.lax.rsqrt(jnp.abs(1.0 - cu * cu))
            T1 = (Cb - cu[:, None] * cu[None, :]) * (Ru[:, None] * Ru[None, :])
            q1 = (qb - qu * cu) * (jax.lax.rsqrt(jnp.abs(1.0 - qu * qu)) * Ru)
            rmin, tb, sb = _pair_sweep(T1, q1, deg_x, u, u, ct)
            # u >= deg_x is not a valid conditioning variable: its local
            # panel row holds junk from padded neighbour slots
            better = (rmin < rho0) & (u < deg_x)
            return (
                jnp.where(better, rmin, rho0),
                jnp.where(better, u, p3),
                jnp.where(better, tb, p2),
                jnp.where(better, sb, p1),
            )

        init = (
            jnp.full((d,), RHO_BIG, jnp.float32),
            jnp.zeros((d,), jnp.int32),
            jnp.zeros((d,), jnp.int32),
            jnp.zeros((d,), jnp.int32),
        )
        rho, p3, p2, p1 = jax.lax.fori_loop(2, d, outer, init)
        return rho, jnp.stack([p1, p2, p3], axis=-1)

    return jax.vmap(per_node)(C_x, c_row, deg)



def _hetcor_pair_margin(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg_x,
                        t_hi, y_excl, base, th, lvl: int, ct: int):
    """Min hetcor margin over pairs s < t (< min(t_hi, deg)), per slot y.

    margin = |rho_{xy | B u {s,t}}| - tanh(th / sqrt(mean_ess - lvl - 3)).
    Cb/qb: the level-|B| CONDITIONED local panel / cross row (the recursion
    of `_pair_sweep`); the ESS and time terms always use the RAW per-pair N
    and time indices (`hetcor-cuPC-S.cu:3055-3089`). Nbv/Nbc: NaN-masked
    pairwise-N values/counts among neighbours; nrv/nrc: same for (x, b).

    base = (sum0, cnt0, sum_y (d,), cnt_y (d,), sum_v (d,), cnt_v (d,),
    t_base): the base element's ESS contributions — (x, u) scalars, (y, u)
    per y row, (s, u)/(t, u) per variable slot — and its time index (-1.0
    for an empty base).

    Returns margin_min (d,) per y (no positions: hetcor keeps no sepsets).
    """
    d = Cb.shape[0]
    s_ix = jnp.arange(d)
    t_cap = jnp.minimum(deg_x, t_hi)
    sum0, cnt0, sum_y, cnt_y, sum_v, cnt_v, t_base = base
    lvl_f = jnp.float32(lvl)

    def chunk_fn(t0):
        Ct = jax.lax.dynamic_slice(Cb, (t0, 0), (ct, d))
        qt = jax.lax.dynamic_slice(qb, (t0,), (ct,))
        Rt = jax.lax.rsqrt(jnp.abs(1.0 - Ct * Ct))
        q2 = (qb[None, :] - qt[:, None] * Ct) * (
            jax.lax.rsqrt(jnp.abs(1.0 - qt * qt))[:, None] * Rt
        )
        CtT = Ct.T
        RtT = Rt.T
        T2 = (Cb[:, None, :] - CtT[:, :, None] * Ct[None, :, :]) * (
            RtT[:, :, None] * Rt[None, :, :]
        )
        rho = jnp.abs(q2.T[:, :, None] - q2[None, :, :] * T2) * (
            jax.lax.rsqrt(jnp.abs(1.0 - q2 * q2))[None, :, :]
            * jax.lax.rsqrt(jnp.abs(1.0 - T2 * T2))
        )  # (y, t, s)
        t_glob = t0 + jnp.arange(ct)
        bad = (
            (s_ix[None, None, :] >= t_glob[None, :, None])
            | (t_glob[None, :, None] >= t_cap)
            | (s_ix[:, None, None] >= deg_x)
            | (s_ix[:, None, None] == s_ix[None, None, :])
            | (s_ix[:, None, None] == t_glob[None, :, None])
            | (s_ix[:, None, None] == y_excl)
        )
        rho = jnp.where(bad | ~jnp.isfinite(rho), RHO_BIG, rho)

        # pairwise mean ESS over {x, y, s, t} u B: broadcast sums of the
        # RAW NaN-masked terms
        nrv_t = jax.lax.dynamic_slice(nrv, (t0,), (ct,))
        nrc_t = jax.lax.dynamic_slice(nrc, (t0,), (ct,))
        Nbv_t = jax.lax.dynamic_slice(Nbv, (t0, 0), (ct, d))  # (t, s)
        Nbc_t = jax.lax.dynamic_slice(Nbc, (t0, 0), (ct, d))
        NbvT_t = jax.lax.dynamic_slice(Nbv, (0, t0), (d, ct))  # (y, t)
        NbcT_t = jax.lax.dynamic_slice(Nbc, (0, t0), (d, ct))
        sv_t = jax.lax.dynamic_slice(sum_v, (t0,), (ct,))
        cv_t = jax.lax.dynamic_slice(cnt_v, (t0,), (ct,))
        tot = (
            nrv[:, None, None]            # (x, y)
            + nrv[None, None, :]          # (x, s)
            + nrv_t[None, :, None]        # (x, t)
            + Nbv[:, None, :]             # (y, s)
            + NbvT_t[:, :, None]          # (y, t)
            + Nbv_t[None, :, :]           # (s, t)
            + sum0
            + sum_y[:, None, None]        # (y, u)
            + sum_v[None, None, :]        # (s, u)
            + sv_t[None, :, None]         # (t, u)
        )
        cnt = (
            nrc[:, None, None]
            + nrc[None, None, :]
            + nrc_t[None, :, None]
            + Nbc[:, None, :]
            + NbcT_t[:, :, None]
            + Nbc_t[None, :, :]
            + cnt0
            + cnt_y[:, None, None]
            + cnt_v[None, None, :]
            + cv_t[None, :, None]
        )
        mean_ess = tot / cnt
        th_test = jnp.tanh(th / jnp.sqrt(mean_ess - lvl_f - 3.0))
        tn_t = jax.lax.dynamic_slice(tn, (t0,), (ct,))
        t_set = jnp.maximum(
            jnp.maximum(tn[None, None, :], tn_t[None, :, None]), t_base
        )
        t_pair = jnp.maximum(t_x, tn)[:, None, None]  # (y, 1, 1)
        time_bad = t_set > t_pair
        margin = jnp.where(
            time_bad | ~jnp.isfinite(th_test) | (rho >= RHO_BIG),
            MARGIN_BIG, rho - th_test,
        )
        return jnp.min(margin, axis=(1, 2))  # (y,)

    if ct == d:
        return chunk_fn(0)

    def chunk(i, m0):
        return jnp.minimum(m0, chunk_fn(i * ct))

    return jax.lax.fori_loop(
        0, d // ct, chunk, jnp.full((d,), MARGIN_BIG, jnp.float32)
    )


def _hetcor_local_gather(C, N, t_ix, node_ixs, nbrs):
    Cb = C[nbrs[:, :, None], nbrs[:, None, :]]
    qb = C[node_ixs[:, None], nbrs]
    Nb_raw = N[nbrs[:, :, None], nbrs[:, None, :]]
    nr_raw = N[node_ixs[:, None], nbrs]
    Nbv = jnp.nan_to_num(Nb_raw)
    Nbc = jnp.where(jnp.isnan(Nb_raw), 0.0, 1.0)
    nrv = jnp.nan_to_num(nr_raw)
    nrc = jnp.where(jnp.isnan(nr_raw), 0.0, 1.0)
    tn = t_ix[nbrs].astype(jnp.float32)
    t_x = t_ix[node_ixs].astype(jnp.float32)
    return Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x


@jax.jit
def hetcor1_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th):
    """ALL hetcor level-1 tests of a node tile in one dispatch.

    For every node x and neighbour slot y, the minimum hetcor margin
    |rho_{xy|s}| - tanh(th / sqrt(mean_ess({x,y,s}) - 4)) over single
    conditioning neighbours s under the time constraint — the same
    candidate set as `cal_Indepl1_ess` (`hetcor-cuPC-S.cu:343-460`) and as
    the dense sweep (:func:`hetcor1_dense_margin`), at sum(deg^2) cost
    instead of v^3. The arithmetic mirrors `_hetcor1_dense_padded` op for
    op (same products, same left-associated ESS sums, same tanh), so the
    two routes produce IDENTICAL margins; the per-slot tanh rides ~1e8
    slots here instead of ~1e12 at a 10k summary-stat panel.

    Returns margin_min (nt, d) per neighbour slot (no positions: hetcor
    keeps no sepsets).
    """
    Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x = _hetcor_local_gather(
        C, N, t_ix, node_ixs, nbrs
    )
    return _hetcor1_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th)


@jax.jit
def hetcor1_local_sweep_bits(C, N, t_ix, node_ixs, nbrs, deg, th):
    """`hetcor1_local_sweep` margins packed to removal hit-bits on device
    (margin < 0, uint8 lanes): the caller only consumes the SIGN, and bits
    cut the (nt, d) f32 margin fetch 32x."""
    m = hetcor1_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th)
    return jnp.packbits(m < 0, axis=1)


@partial(jax.jit, static_argnames=("ct",))
def hetcor2_local_sweep_bits(C, N, t_ix, node_ixs, nbrs, deg, th, ct: int):
    """`hetcor2_local_sweep` margins as removal hit-bits (see the level-1
    variant for the fetch rationale)."""
    m = hetcor2_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, ct)
    return jnp.packbits(m < 0, axis=1)


@partial(jax.jit, static_argnames=("ct",))
def hetcor3_local_sweep_bits(C, N, t_ix, node_ixs, nbrs, deg, th, ct: int):
    """`hetcor3_local_sweep` margins as removal hit-bits."""
    m = hetcor3_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, ct)
    return jnp.packbits(m < 0, axis=1)


def _hetcor1_local_core(Cb_, qb_, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th):
    d = qb_.shape[1]
    # lanes layout (s, y, nt) like level1_local_sweep_pre; the rho
    # expression uses the same pre-scaled grouping as the dense kernel
    Cb = jnp.transpose(Cb_, (1, 2, 0))  # (s, y, nt)
    qb = qb_.T  # (b, nt)
    Rc = jax.lax.rsqrt(jnp.abs(1.0 - Cb * Cb))
    Pc = Cb * Rc
    Rq = jax.lax.rsqrt(jnp.abs(1.0 - qb * qb))
    Pq = qb * Rq
    rho = jnp.abs(qb[None] * (Rq[:, None] * Rc) - Pq[:, None] * Pc)
    # ESS sums, left-associated (x,y) + (x,s) + (y,s) like the dense path
    nvT = (nrv * nrc).T  # (b, nt): masked N[x, b]
    ncT = nrc.T
    NbT = jnp.transpose(Nbv * Nbc, (2, 1, 0))  # [s, y, nt] = N[y_nbr, s_nbr]
    NbcT = jnp.transpose(Nbc, (2, 1, 0))
    total = nvT[None, :, :] + nvT[:, None, :] + NbT
    count = ncT[None, :, :] + ncT[:, None, :] + NbcT
    mean_ess = total / count
    th_test = jnp.tanh(th / jnp.sqrt(mean_ess - 4.0))
    tnT = tn.T  # (b, nt)
    t_pair = jnp.maximum(t_x[None, :], tnT)  # (y, nt)
    bad_time = tnT[:, None, :] > t_pair[None, :, :]
    s_ix = jnp.arange(d)
    bad = (
        (s_ix[:, None, None] >= deg[None, None, :])
        | (s_ix[:, None, None] == s_ix[None, :, None])
        | bad_time
    )
    margin = rho - th_test
    margin = jnp.where(bad | ~jnp.isfinite(margin), MARGIN_BIG, margin)
    return jnp.min(margin, axis=0).T  # (nt, d)


@partial(jax.jit, static_argnames=("ct",))
def hetcor2_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, ct: int):
    """ALL hetcor level-2 tests of a node tile in one dispatch: min margin
    over every conditioning pair, with per-test mean-ESS thresholds and
    time constraints (same tests as `level_scan_hetcor` at l=2)."""
    Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x = _hetcor_local_gather(
        C, N, t_ix, node_ixs, nbrs
    )
    return _hetcor2_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct)


def hetcor2_local_sweep_pre(Cb, qb, Nb_raw, nr_raw, tn, t_x, deg, th, ct: int):
    """`hetcor2_local_sweep` on PRE-GATHERED local panels (the row-sharded
    entry point: Cb/qb/Nb_raw/nr_raw come from the ring pass). NaN masking of
    the raw per-pair N happens here, identically to `_hetcor_local_gather`."""
    Nbv = jnp.nan_to_num(Nb_raw)
    Nbc = jnp.where(jnp.isnan(Nb_raw), 0.0, 1.0)
    nrv = jnp.nan_to_num(nr_raw)
    nrc = jnp.where(jnp.isnan(nr_raw), 0.0, 1.0)
    return _hetcor2_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct)


def _hetcor2_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct: int):
    d = Cb.shape[1]
    zero_d = jnp.zeros((d,), jnp.float32)

    def per_node(Cb_n, qb_n, Nbv_n, Nbc_n, nrv_n, nrc_n, tn_n, t_x_n, deg_n):
        base = (jnp.float32(0.0), jnp.float32(0.0), zero_d, zero_d,
                zero_d, zero_d, jnp.float32(-1.0))
        return _hetcor_pair_margin(
            Cb_n, qb_n, Nbv_n, Nbc_n, nrv_n, nrc_n, tn_n, t_x_n, deg_n,
            jnp.int32(d), jnp.int32(d), base, jnp.float32(th), 2, ct,
        )

    return jax.vmap(per_node)(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg)


@partial(jax.jit, static_argnames=("ct",))
def hetcor3_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, ct: int):
    """ALL hetcor level-3 tests of a node tile: outer scan over the largest
    conditioning element u, rho via the conditioned-panel recursion, ESS and
    time terms from the RAW per-pair N (same tests as `level_scan_hetcor`
    at l=3)."""
    Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x = _hetcor_local_gather(
        C, N, t_ix, node_ixs, nbrs
    )
    return _hetcor3_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct)


def hetcor3_local_sweep_pre(Cb, qb, Nb_raw, nr_raw, tn, t_x, deg, th, ct: int):
    """`hetcor3_local_sweep` on PRE-GATHERED local panels (row-sharded entry
    point); NaN masking identical to `_hetcor_local_gather`."""
    Nbv = jnp.nan_to_num(Nb_raw)
    Nbc = jnp.where(jnp.isnan(Nb_raw), 0.0, 1.0)
    nrv = jnp.nan_to_num(nr_raw)
    nrc = jnp.where(jnp.isnan(nr_raw), 0.0, 1.0)
    return _hetcor3_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct)


def _hetcor3_local_core(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, th, ct: int):
    d = Cb.shape[1]

    def per_node(Cb_n, qb_n, Nbv_n, Nbc_n, nrv_n, nrc_n, tn_n, t_x_n, deg_n):
        def outer(u, m0):
            cu = jax.lax.dynamic_index_in_dim(Cb_n, u, 0, keepdims=False)
            qu = jax.lax.dynamic_index_in_dim(qb_n, u, 0, keepdims=False)
            Ru = jax.lax.rsqrt(jnp.abs(1.0 - cu * cu))
            T1 = (Cb_n - cu[:, None] * cu[None, :]) * (Ru[:, None] * Ru[None, :])
            q1 = (qb_n - qu * cu) * (jax.lax.rsqrt(jnp.abs(1.0 - qu * qu)) * Ru)
            base = (
                jax.lax.dynamic_index_in_dim(nrv_n, u, 0, keepdims=False),
                jax.lax.dynamic_index_in_dim(nrc_n, u, 0, keepdims=False),
                jax.lax.dynamic_slice(Nbv_n, (0, u), (d, 1))[:, 0],
                jax.lax.dynamic_slice(Nbc_n, (0, u), (d, 1))[:, 0],
                jax.lax.dynamic_slice(Nbv_n, (0, u), (d, 1))[:, 0],
                jax.lax.dynamic_slice(Nbc_n, (0, u), (d, 1))[:, 0],
                jax.lax.dynamic_index_in_dim(tn_n, u, 0, keepdims=False),
            )
            m_u = _hetcor_pair_margin(
                T1, q1, Nbv_n, Nbc_n, nrv_n, nrc_n, tn_n, t_x_n, deg_n,
                u, u, base, jnp.float32(th), 3, ct,
            )
            return jnp.where(u < deg_n, jnp.minimum(m0, m_u), m0)

        return jax.lax.fori_loop(
            2, d, outer, jnp.full((d,), MARGIN_BIG, jnp.float32)
        )

    return jax.vmap(per_node)(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg)


@partial(jax.jit, static_argnames=("tile",))
def _level1_dense_padded(C, Gm, tile: int):
    """Tiled dense level-1 sweep over a padded (vp, vp) panel.

    Returns (rho_min, s_argmin) where rho_min[x, y] is the minimum
    |rho_{xy|s}| over conditioning variables s with Gm[x, s] true (and
    s != x, s != y), and s_argmin the minimizing s. Uses the pre-scaled
    form |rho| = |c_xy R_xs R_ys - P_xs P_ys| with R = rsqrt(|1 - C^2|),
    P = C R, so the inner sweep is 4 elementwise ops per test.
    """
    vp = C.shape[0]
    s_ix = jnp.arange(vp)
    R = jax.lax.rsqrt(jnp.abs(1.0 - C * C))
    P = C * R

    def tile_body(t, carry):
        rho_all, s_all = carry
        x0 = t * tile
        cxy = jax.lax.dynamic_slice(C, (x0, 0), (tile, vp))
        rx = jax.lax.dynamic_slice(R, (x0, 0), (tile, vp))
        px = jax.lax.dynamic_slice(P, (x0, 0), (tile, vp))
        gx = jax.lax.dynamic_slice(Gm, (x0, 0), (tile, vp))
        rho = jnp.abs(
            cxy[:, :, None] * (rx[:, None, :] * R[None, :, :])
            - px[:, None, :] * P[None, :, :]
        )
        x_ix = x0 + jnp.arange(tile)
        bad = (
            (s_ix[None, None, :] == x_ix[:, None, None])
            | (s_ix[None, None, :] == s_ix[None, :, None])
            | ~gx[:, None, :]
        )
        rho = jnp.where(bad | ~jnp.isfinite(rho), RHO_BIG, rho)
        rmin = jnp.min(rho, axis=2)
        smin = jnp.argmin(rho, axis=2).astype(jnp.int32)
        return (
            jax.lax.dynamic_update_slice(rho_all, rmin, (x0, 0)),
            jax.lax.dynamic_update_slice(s_all, smin, (x0, 0)),
        )

    init = (
        jnp.full((vp, vp), RHO_BIG, jnp.float32),
        jnp.zeros((vp, vp), jnp.int32),
    )
    return jax.lax.fori_loop(0, vp // tile, tile_body, init)


def level1_dense_minrho(C, G):
    """Level 1 of the skeleton as ONE dense masked dispatch.

    Exactly the tests of `cal_Indepl1` (`cuPC-S.cu:486-582`): for every
    retained edge (x, y), sweep all single conditioning variables s in
    adj(x) \\ {y} — non-neighbours are masked to the RHO_BIG sentinel, so
    the dense sweep over all v candidates matches the reference's
    neighbour-list enumeration while avoiding every per-node host round
    trip (the combinatorial path needs several launches per level).

    Returns (rho_min (v, v), s_argmin (v, v) int32).
    """
    C = jnp.asarray(C, dtype=jnp.float32)
    v = C.shape[0]
    pad = (-v) % 128
    Gm = jnp.asarray(G, dtype=bool)
    if pad:
        C = jnp.pad(C, ((0, pad), (0, pad)))
        Gm = jnp.pad(Gm, ((0, pad), (0, pad)))
    vp = v + pad
    # x-tile = 128: not yet derived on the H100 (ROADMAP 3.2)
    tile = 128
    rho_min, s_min = _level1_dense_padded(C, Gm, tile)
    return rho_min[:v, :v], s_min[:v, :v]


@partial(jax.jit, static_argnames=("tile",))
def _hetcor1_dense_padded(C, N, t, Gm, th, tile: int):
    """Tiled dense hetcor level-1 margin sweep over a padded (vp, vp) panel.

    margin[x, y] = min over s in adj(x)\\{x, y} with t_s <= max(t_x, t_y) of
    |rho_{xy|s}| - tanh(th / sqrt(mean_ess({x,y,s}) - 4)), where mean_ess
    averages the pairwise sample sizes N[x,y], N[x,s], N[y,s] ignoring NaNs
    (`hetcor-cuPC-S.cu:3068-3089`; l=1 margin semantics of
    :func:`level_scan_hetcor`). Invalid tests contribute MARGIN_BIG.
    """
    vp = C.shape[0]
    s_ix = jnp.arange(vp)
    R = jax.lax.rsqrt(jnp.abs(1.0 - C * C))
    P = C * R
    Nv = jnp.nan_to_num(N)
    Nok = (~jnp.isnan(N)).astype(jnp.float32)
    tf = t.astype(jnp.float32)

    def tile_body(i, margin_all):
        x0 = i * tile
        cxy = jax.lax.dynamic_slice(C, (x0, 0), (tile, vp))
        rx = jax.lax.dynamic_slice(R, (x0, 0), (tile, vp))
        px = jax.lax.dynamic_slice(P, (x0, 0), (tile, vp))
        gx = jax.lax.dynamic_slice(Gm, (x0, 0), (tile, vp))
        nxy = jax.lax.dynamic_slice(Nv, (x0, 0), (tile, vp))
        oxy = jax.lax.dynamic_slice(Nok, (x0, 0), (tile, vp))
        rho = jnp.abs(
            cxy[:, :, None] * (rx[:, None, :] * R[None, :, :])
            - px[:, None, :] * P[None, :, :]
        )
        total = (
            (nxy * oxy)[:, :, None]
            + (nxy * oxy)[:, None, :]
            + (Nv * Nok)[None, :, :]
        )
        count = oxy[:, :, None] + oxy[:, None, :] + Nok[None, :, :]
        mean_ess = total / count
        th_test = jnp.tanh(th / jnp.sqrt(mean_ess - 4.0))
        t_x = jax.lax.dynamic_slice(tf, (x0,), (tile,))
        t_pair = jnp.maximum(t_x[:, None], tf[None, :])  # (tile, vp)
        bad_time = tf[None, None, :] > t_pair[:, :, None]
        x_ix = x0 + jnp.arange(tile)
        bad = (
            (s_ix[None, None, :] == x_ix[:, None, None])
            | (s_ix[None, None, :] == s_ix[None, :, None])
            | ~gx[:, None, :]
            | bad_time
        )
        margin = rho - th_test
        margin = jnp.where(bad | ~jnp.isfinite(margin), MARGIN_BIG, margin)
        return jax.lax.dynamic_update_slice(
            margin_all, jnp.min(margin, axis=2), (x0, 0)
        )

    init = jnp.full((vp, vp), MARGIN_BIG, jnp.float32)
    return jax.lax.fori_loop(0, vp // tile, tile_body, init)


def hetcor1_dense_margin(C_dev, N_dev, t_dev, Gb, th: float):
    """Hetcor level 1 as one dense masked dispatch; returns margin min (v, v).

    Candidates are exactly adj(x)\\{y} under the time constraint — identical
    tests to the neighbour-list enumeration of `cal_Indepl1_ess`
    (`hetcor-cuPC-S.cu:343-460`), minus the per-node round trips. The caller
    removes edges where margin < 0 (one side suffices, like
    :func:`level_scan_hetcor`).
    """
    C = jnp.asarray(C_dev, dtype=jnp.float32)
    v = C.shape[0]
    pad = (-v) % 128
    Gm = jnp.asarray(Gb, dtype=bool)
    N = jnp.asarray(N_dev, dtype=jnp.float32)
    t = jnp.asarray(t_dev, dtype=jnp.int32)
    if pad:
        C = jnp.pad(C, ((0, pad), (0, pad)))
        Gm = jnp.pad(Gm, ((0, pad), (0, pad)))
        N = jnp.pad(N, ((0, pad), (0, pad)), constant_values=10.0)
        t = jnp.pad(t, (0, pad))
    out = _hetcor1_dense_padded(C, N, t, Gm, jnp.float32(th), 128)
    return np.asarray(out)[:v, :v]


@jax.jit
def _level1_side_packed(rho_min, Gm, rho_threshold):
    """int8-packed removal side mask: the (v, v) bool costs a ~127 MB
    fetch at the 11k block; packed bits are 8x smaller."""
    return jnp.packbits((rho_min < rho_threshold) & Gm, axis=1)


@partial(jax.jit, static_argnames=("n",))
def _unpack_bool_dev(packed, n: int):
    return jnp.unpackbits(packed, axis=1)[:, :n].astype(bool)


@jax.jit
def _level1_side(rho_min, Gm, rho_threshold):
    return ((rho_min < rho_threshold) & Gm).astype(jnp.int8)


@jax.jit
def _gather_flat(a, b, idx):
    return a.reshape(-1)[idx], b.reshape(-1)[idx]


@jax.jit
def hetcor_l0_packed(C, N, th):
    """Hetcor level-0 delete mask as packed bits: delete iff
    fisher_z(C) < th / sqrt(N - 3) with the RAW per-pair N
    (`cal_Indepl0_ess`, `hetcor-cuPC-S.cu:343-377`); NaN thresholds
    compare false and keep the edge, like the host compare."""
    z0 = jnp.abs(0.5 * jnp.log(jnp.abs((1 + C) / (1 - C))))
    return jnp.packbits(z0 < th / jnp.sqrt(N - 3.0), axis=1)


@jax.jit
def trunc_ref_ess(N):
    """ess_mode="reference" transform on device: truncate toward zero
    with NaN -> 0 (the reference's int conversion + dead isnan check)."""
    return jnp.trunc(jnp.nan_to_num(N, nan=0.0)).astype(jnp.float32)


@jax.jit
def level0_screen(C, th0):
    """Level-0 adjacency on device: delete iff fisher-z < th0.

    Reference `cal_Indepl0` (`cuPC-S.cu:458-484`); a NaN z compares false and
    keeps the edge, the diagonal is cleared.
    """
    v = C.shape[0]
    z0 = jnp.abs(0.5 * jnp.log(jnp.abs((1 + C) / (1 - C))))
    return (~(z0 < th0)) & ~jnp.eye(v, dtype=bool)


def level1_dense_dispatch(C_dev, G_dev, rho_threshold: float):
    """Dispatch the dense level-1 sweep on a DEVICE adjacency; no fetch.

    Returns opaque handles for :func:`level1_dense_collect`. Dispatching
    before any host fetch lets the caller overlap the (large) correlation
    panel transfer with the kernel.
    """
    Gb_dev = G_dev.astype(bool)
    rho_dev, s_dev = level1_dense_minrho(C_dev, Gb_dev)
    side_pk = _level1_side_packed(rho_dev, Gb_dev, jnp.float32(rho_threshold))
    return rho_dev, s_dev, side_pk, Gb_dev.shape[0]


def level1_dense_collect(handles):
    """Fetch a dispatched level-1 screen with minimal transfer.

    Fetches only the int8 removal mask, then gathers (|rho|, argmin s) for
    just the removed ordered pairs (padded to a power of two so the gather
    compiles once per size bucket, not per block).

    Returns (side (v, v) bool, xs, ys, s_sel, rho_sel) where side[x, y] is
    "x's sweep condemned (x, y)" and the parallel arrays give the minimizing
    conditioning variable and its |rho| for each such ordered pair.
    """
    rho_dev, s_dev, side_pk, n = handles
    side = np.unpackbits(np.asarray(side_pk), axis=1, count=n).astype(bool)
    xs, ys = np.nonzero(side)
    k = len(xs)
    if k == 0:
        return side, xs, ys, np.zeros(0, np.int32), np.zeros(0, np.float32)
    kp = 1 << (k - 1).bit_length()
    flat = np.zeros(kp, dtype=np.int64)
    flat[:k] = xs.astype(np.int64) * n + ys
    rho_sel, s_sel = _gather_flat(rho_dev, s_dev, jnp.asarray(flat))
    return side, xs, ys, np.asarray(s_sel)[:k], np.asarray(rho_sel)[:k]


def level1_dense_screen(C_dev, Gb, rho_threshold: float):
    """Full level-1 screen from a HOST adjacency (upload + dispatch + fetch).

    The adjacency rides the link as packed bits (16 MB instead of 127 MB
    at the 11k block) and is unpacked on device."""
    Gb = np.asarray(Gb).astype(bool)
    n = Gb.shape[0]
    gp = jnp.asarray(np.packbits(Gb, axis=1))
    return level1_dense_collect(
        level1_dense_dispatch(C_dev, _unpack_bool_dev(gp, n), rho_threshold)
    )


@partial(jax.jit, static_argnames=("l",))
def level_scan_hetcor(
    C, N, time_index, node_ixs, nbrs, deg, combos_seq, left_seq, th, l: int
):
    """Hetcor level-l chunks in one dispatch: per-test ESS thresholds + time
    constraints (`hetcor-cuPC-S.cu`), margin reduction.

    A test of (X, Y | S) uses threshold th / sqrt(mean_ess({X,Y} u S) - l - 3)
    where mean_ess averages the pairwise ESS over all variable pairs of the
    test ignoring NaNs (`hetcor-cuPC-S.cu:3068-3089`); S must not contain a
    variable with time index greater than max(t_X, t_Y)
    (`valid_time_conditioning`). Removal when min margin < 0 where margin =
    |rho| - tanh(th_test). Gather-free like :func:`level_scan_minrho`: local
    panels are sliced once per launch, NaNs tracked with a parallel mask so
    one-hot matmuls stay NaN-safe.
    """
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    c_row = C[node_ixs[:, None], nbrs]  # (nt, d)
    N_x_raw = N[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    n_row_raw = N[node_ixs[:, None], nbrs]  # (nt, d)
    t_nbrs = time_index[nbrs].astype(jnp.float32)  # (nt, d)
    t_x = time_index[node_ixs].astype(jnp.float32)  # (nt,)
    return level_scan_hetcor_pre(
        C_x, c_row, N_x_raw, n_row_raw, t_nbrs, t_x, deg, combos_seq,
        left_seq, th, l,
    )


def level_scan_hetcor_pre(
    C_x, c_row, N_x_raw, n_row_raw, t_nbrs, t_x, deg, combos_seq, left_seq,
    th, l: int
):
    """`level_scan_hetcor` on PRE-GATHERED local panels (row-sharded entry
    point: C_x/c_row/N_x_raw/n_row_raw come from the ring pass)."""
    nt, d = c_row.shape
    nch, K, _ = combos_seq.shape
    N_x = jnp.nan_to_num(N_x_raw)
    N_x_nan = jnp.isnan(N_x_raw).astype(jnp.float32)
    n_row = jnp.nan_to_num(n_row_raw)
    n_row_nan = jnp.isnan(n_row_raw).astype(jnp.float32)

    def chunk_step(margin_min, inp):
        combos, left = inp
        sel = _combo_onehots(combos, d, l)

        def per_node(C_x_n, c_row_n, N_x_n, N_nan_n, n_row_n, n_nan_n, t_nbrs_n, t_x_n, deg_x, left_x):
            rho = _pcorr_rho_local(
                C_x_n, c_row_n, c_row_n, deg_x, left_x, sel, combos, l
            )  # (K, d)
            # pairwise ESS sums over {x, y} u S with NaN masking
            rowsN = [
                jnp.dot(sel[i], N_x_n, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
                for i in range(l)
            ]  # l x (K, d)
            rowsNaN = [
                jnp.dot(sel[i], N_nan_n, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
                for i in range(l)
            ]
            s_SS = jnp.zeros((K,), jnp.float32)
            c_SS = jnp.zeros((K,), jnp.float32)
            for i in range(l):
                for j in range(i):
                    vij = jnp.sum(rowsN[i] * sel[j], axis=1)
                    nanij = jnp.sum(rowsNaN[i] * sel[j], axis=1) > 0.5
                    s_SS = s_SS + jnp.where(nanij, 0.0, vij)
                    c_SS = c_SS + jnp.where(nanij, 0.0, 1.0)
            s_xS = jnp.zeros((K,), jnp.float32)
            c_xS = jnp.zeros((K,), jnp.float32)
            for i in range(l):
                vi = jnp.sum(sel[i] * n_row_n[None, :], axis=1)
                nani = jnp.sum(sel[i] * n_nan_n[None, :], axis=1) > 0.5
                s_xS = s_xS + jnp.where(nani, 0.0, vi)
                c_xS = c_xS + jnp.where(nani, 0.0, 1.0)
            # N[S_i, y] over all neighbour slots y: rowsN_i is (K, d) already
            s_yS = jnp.zeros((K, d), jnp.float32)
            c_yS = jnp.zeros((K, d), jnp.float32)
            for i in range(l):
                nan_i = rowsNaN[i] > 0.5
                s_yS = s_yS + jnp.where(nan_i, 0.0, rowsN[i])
                c_yS = c_yS + jnp.where(nan_i, 0.0, 1.0)
            nan_xy = n_nan_n > 0.5  # (d,)
            s_xy = jnp.where(nan_xy, 0.0, n_row_n)[None, :]
            c_xy = jnp.where(nan_xy, 0.0, 1.0)[None, :]
            total = s_SS[:, None] + s_xS[:, None] + s_yS + s_xy
            count = c_SS[:, None] + c_xS[:, None] + c_yS + c_xy
            mean_ess = total / count
            th_test = jnp.tanh(th / jnp.sqrt(mean_ess - l - 3.0))
            # time-index constraint
            tS = [jnp.sum(sel[i] * t_nbrs_n[None, :], axis=1) for i in range(l)]
            tS_max = tS[0]
            for i in range(1, l):
                tS_max = jnp.maximum(tS_max, tS[i])  # (K,)
            t_pair = jnp.maximum(t_x_n, t_nbrs_n)  # (d,)
            time_bad = tS_max[:, None] > t_pair[None, :]
            margin = jnp.where(
                time_bad | ~jnp.isfinite(th_test), MARGIN_BIG, rho - th_test
            )
            margin = jnp.where(rho >= RHO_BIG, MARGIN_BIG, margin)
            return jnp.min(margin, axis=0)

        m_c = jax.vmap(per_node)(
            C_x, c_row, N_x, N_x_nan, n_row, n_row_nan, t_nbrs, t_x, deg, left
        )
        return jnp.minimum(margin_min, m_c), None

    init = jnp.full((nt, d), MARGIN_BIG, jnp.float32)
    margin_min, _ = jax.lax.scan(chunk_step, init, (combos_seq, left_seq))
    return margin_min
