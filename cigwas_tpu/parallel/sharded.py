"""Sharded production skeleton: the two-stage cusk engine on a device mesh.

This is the multi-chip path of the PRODUCTION engine (`skeleton()` /
`hetcor_skeleton` / `corr_panel_device`), not a demo: `pipelines.cusk` takes
a mesh and every device kernel of the level search runs SPMD over it.

Sharding layout (axis name given by the caller, conventionally ``marker``):

* correlation panel: the contingency/covariance matmuls are sharded over
  marker ROW slabs — each device computes (3·m/D, n) x (n, 3·m) counts on
  its slab — and the finished (v, v) panel is all-gathered to every device
  (`ShardedEngine`). Replication is the latency-optimal default: the level
  kernels read arbitrary (x, y, S) entries, and one card holds an
  11k-variable f32 panel in <0.5 GB of device memory (the reference's ~9.3 GB working
  set, `cuPC-S.cu:85-95`, is dominated by the n²·ML sepset array, which
  lives on the host here). For blocks beyond one chip's HBM,
  `RowShardedEngine` keeps the panel split in (vp/D, vp) stripes and feeds
  every level kernel through a ppermute ring (see the row-sharded section
  below).
* level 1: the dense min-|rho| sweep is sharded over x-row slabs.
* levels >= 2: the local-panel sweeps / combination scans shard node tiles
  over the mesh axis — each device covers the conditioning sets of its node
  shard; results are all-gathered.

Every reduction stays per-(node, neighbour); device placement changes which
chip computes a row, never the row's value — block outputs are byte-identical
to the single-device path (tests/test_sharded_skeleton.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cigwas_tpu.ops import pcorr as pcorr_ops
from cigwas_tpu.ops.corr import _kendall_from_counts
from cigwas_tpu.ops.decode import (
    contingency_counts,
    geno_onehot,
    geno_value_valid,
    unpack_bed_codes,
)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


# ---------------------------------------------------------------------------
# level >= 2: node-sharded combination scans
# ---------------------------------------------------------------------------


def make_level_scan_sharded(mesh: Mesh, axis: str):
    """Sharded `level_scan_minrho`: node tiles split over `axis`.

    Returns a callable with the same signature as
    :func:`cigwas_tpu.ops.pcorr.level_scan_minrho`; the node-tile length must
    be a multiple of the axis size (the caller pads tiles already).
    """

    def local(C, node_ixs, nbrs, deg, combos_seq, left_seq, l):
        return pcorr_ops.level_scan_minrho(
            C, node_ixs, nbrs, deg, combos_seq, left_seq, l
        )

    cache = {}

    def run(C, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
        fn = cache.get(l)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(local, l=l),
                    mesh,
                    in_specs=(
                        P(None, None),  # C replicated
                        P(axis),
                        P(axis, None),
                        P(axis),
                        P(None, None, None),  # combos replicated
                        P(None, axis),
                    ),
                    out_specs=(P(axis, None), P(axis, None)),
                )
            )
            cache[l] = fn
        return fn(C, node_ixs, nbrs, deg, combos_seq, left_seq)

    return run


def make_level_local_sharded(mesh: Mesh, axis: str, l: int):
    """Sharded dense local-panel sweep (levels 2/3): node tiles over `axis`.

    Same contract as :func:`cigwas_tpu.ops.pcorr.level2_local_sweep` /
    `level3_local_sweep`; node-tile length must be a multiple of the axis
    size (the caller pads tiles).
    """
    base = {
        2: pcorr_ops.level2_local_sweep,
        3: pcorr_ops.level3_local_sweep,
    }[l]

    cache = {}

    def run(C, node_ixs, nbrs, deg, ct: int):
        fn = cache.get(ct)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(base, ct=ct),
                    mesh,
                    in_specs=(
                        P(None, None),  # C replicated
                        P(axis),
                        P(axis, None),
                        P(axis),
                    ),
                    out_specs=(P(axis, None), P(axis, None, None)),
                )
            )
            cache[ct] = fn
        return fn(C, node_ixs, nbrs, deg)

    return run


def make_hetcor_local_sharded(mesh: Mesh, axis: str, l: int):
    """Sharded hetcor dense local sweep (levels 2/3): node tiles over
    `axis`; panel/N/time replicated. Same contract as
    `pcorr.hetcor2/3_local_sweep`."""
    base = {
        2: pcorr_ops.hetcor2_local_sweep,
        3: pcorr_ops.hetcor3_local_sweep,
    }[l]
    cache = {}

    def run(C, N, t_ix, node_ixs, nbrs, deg, th: float, ct: int):
        key = (ct, float(th))
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(base, th=float(th), ct=ct),
                    mesh,
                    in_specs=(
                        P(None, None), P(None, None), P(None),
                        P(axis), P(axis, None), P(axis),
                    ),
                    out_specs=P(axis, None),
                )
            )
            cache[key] = fn
        return fn(C, N, t_ix, node_ixs, nbrs, deg)

    return run


def make_level_scan_hetcor_sharded(mesh: Mesh, axis: str):
    """Sharded `level_scan_hetcor` (same layout; N/time replicated)."""

    def local(C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th, l):
        return pcorr_ops.level_scan_hetcor(
            C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th, l
        )

    cache = {}

    def run(C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th, l: int):
        fn = cache.get(l)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(local, l=l),
                    mesh,
                    in_specs=(
                        P(None, None),
                        P(None, None),
                        P(None),
                        P(axis),
                        P(axis, None),
                        P(axis),
                        P(None, None, None),
                        P(None, axis),
                        P(),
                    ),
                    out_specs=P(axis, None),
                )
            )
            cache[l] = fn
        return fn(C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th)

    return run


# ---------------------------------------------------------------------------
# level 1: x-row-sharded dense sweeps
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("tile",))
def _level1_rows(C, G_rows, x0, tile: int):
    """Dense level-1 sweep for a slab of x rows starting at global row x0.

    Same tests as `_level1_dense_padded` (`cal_Indepl1`, `cuPC-S.cu:486-582`)
    with the global row offset explicit so a shard can own any slab.
    """
    vp = C.shape[0]
    rows = G_rows.shape[0]
    s_ix = jnp.arange(vp)
    R = jax.lax.rsqrt(jnp.abs(1.0 - C * C))
    Pm = C * R

    def tile_body(t, carry):
        rho_all, s_all = carry
        r0 = t * tile
        gx = jax.lax.dynamic_slice(G_rows, (r0, 0), (tile, vp))
        cxy = jax.lax.dynamic_slice(C, (x0 + r0, 0), (tile, vp))
        rx = jax.lax.dynamic_slice(R, (x0 + r0, 0), (tile, vp))
        px = jax.lax.dynamic_slice(Pm, (x0 + r0, 0), (tile, vp))
        rho = jnp.abs(
            cxy[:, :, None] * (rx[:, None, :] * R[None, :, :])
            - px[:, None, :] * Pm[None, :, :]
        )
        x_ix = x0 + r0 + jnp.arange(tile)
        bad = (
            (s_ix[None, None, :] == x_ix[:, None, None])
            | (s_ix[None, None, :] == s_ix[None, :, None])
            | ~gx[:, None, :]
        )
        rho = jnp.where(bad | ~jnp.isfinite(rho), pcorr_ops.RHO_BIG, rho)
        return (
            jax.lax.dynamic_update_slice(rho_all, jnp.min(rho, axis=2), (r0, 0)),
            jax.lax.dynamic_update_slice(
                s_all, jnp.argmin(rho, axis=2).astype(jnp.int32), (r0, 0)
            ),
        )

    init = (
        jnp.full((rows, vp), pcorr_ops.RHO_BIG, jnp.float32),
        jnp.zeros((rows, vp), jnp.int32),
    )
    return jax.lax.fori_loop(0, rows // tile, tile_body, init)


def make_level1_sharded(mesh: Mesh, axis: str):
    """Sharded dense level-1 screen; same contract as `level1_dense_minrho`."""
    ndev = mesh_axis_size(mesh, axis)

    def run(C, Gm):
        C = jnp.asarray(C, dtype=jnp.float32)
        v = C.shape[0]
        Gm = jnp.asarray(Gm, dtype=bool)
        # rows per shard must be a multiple of the inner tile
        tile = 8
        pad = (-v) % (ndev * tile)
        if pad:
            C = jnp.pad(C, ((0, pad), (0, pad)))
            Gm = jnp.pad(Gm, ((0, pad), (0, pad)))
        vp = v + pad

        def local(C_full, G_rows):
            x0 = jax.lax.axis_index(axis) * (vp // ndev)
            return _level1_rows(C_full, G_rows, x0, tile)

        rho, s = jax.jit(
            _shard_map(
                local, mesh,
                in_specs=(P(None, None), P(axis, None)),
                out_specs=(P(axis, None), P(axis, None)),
            )
        )(C, Gm)
        return rho[:v, :v], s[:v, :v]

    return run


@partial(jax.jit, static_argnames=("tile",))
def _hetcor1_rows(C, N, t, G_rows, th, x0, tile: int):
    """Hetcor level-1 margin sweep for a slab of x rows at offset x0
    (`_hetcor1_dense_padded` with explicit slab offset)."""
    vp = C.shape[0]
    rows = G_rows.shape[0]
    s_ix = jnp.arange(vp)
    R = jax.lax.rsqrt(jnp.abs(1.0 - C * C))
    Pm = C * R
    Nv = jnp.nan_to_num(N)
    Nok = (~jnp.isnan(N)).astype(jnp.float32)
    tf = t.astype(jnp.float32)

    def tile_body(i, margin_all):
        r0 = i * tile
        gx = jax.lax.dynamic_slice(G_rows, (r0, 0), (tile, vp))
        cxy = jax.lax.dynamic_slice(C, (x0 + r0, 0), (tile, vp))
        rx = jax.lax.dynamic_slice(R, (x0 + r0, 0), (tile, vp))
        px = jax.lax.dynamic_slice(Pm, (x0 + r0, 0), (tile, vp))
        nxy = jax.lax.dynamic_slice(Nv, (x0 + r0, 0), (tile, vp))
        oxy = jax.lax.dynamic_slice(Nok, (x0 + r0, 0), (tile, vp))
        rho = jnp.abs(
            cxy[:, :, None] * (rx[:, None, :] * R[None, :, :])
            - px[:, None, :] * Pm[None, :, :]
        )
        total = (
            (nxy * oxy)[:, :, None]
            + (nxy * oxy)[:, None, :]
            + (Nv * Nok)[None, :, :]
        )
        count = oxy[:, :, None] + oxy[:, None, :] + Nok[None, :, :]
        mean_ess = total / count
        th_test = jnp.tanh(th / jnp.sqrt(mean_ess - 4.0))
        t_x = jax.lax.dynamic_slice(tf, (x0 + r0,), (tile,))
        t_pair = jnp.maximum(t_x[:, None], tf[None, :])
        bad_time = tf[None, None, :] > t_pair[:, :, None]
        x_ix = x0 + r0 + jnp.arange(tile)
        bad = (
            (s_ix[None, None, :] == x_ix[:, None, None])
            | (s_ix[None, None, :] == s_ix[None, :, None])
            | ~gx[:, None, :]
            | bad_time
        )
        margin = rho - th_test
        margin = jnp.where(bad | ~jnp.isfinite(margin), pcorr_ops.MARGIN_BIG, margin)
        return jax.lax.dynamic_update_slice(
            margin_all, jnp.min(margin, axis=2), (r0, 0)
        )

    init = jnp.full((rows, vp), pcorr_ops.MARGIN_BIG, jnp.float32)
    return jax.lax.fori_loop(0, rows // tile, tile_body, init)


def make_hetcor1_sharded(mesh: Mesh, axis: str):
    """Sharded hetcor level-1 margin sweep (`hetcor1_dense_margin`)."""
    ndev = mesh_axis_size(mesh, axis)

    def run(C_dev, N_dev, t_dev, Gb, th: float):
        C = jnp.asarray(C_dev, dtype=jnp.float32)
        v = C.shape[0]
        Gm = jnp.asarray(Gb, dtype=bool)
        N = jnp.asarray(N_dev, dtype=jnp.float32)
        t = jnp.asarray(t_dev, dtype=jnp.int32)
        tile = 8
        pad = (-v) % (ndev * tile)
        if pad:
            C = jnp.pad(C, ((0, pad), (0, pad)))
            Gm = jnp.pad(Gm, ((0, pad), (0, pad)))
            N = jnp.pad(N, ((0, pad), (0, pad)), constant_values=10.0)
            t = jnp.pad(t, (0, pad))
        vp = v + pad

        def local(C_full, N_full, t_full, G_rows):
            x0 = jax.lax.axis_index(axis) * (vp // ndev)
            return _hetcor1_rows(C_full, N_full, t_full, G_rows, jnp.float32(th),
                                 x0, tile)

        out = jax.jit(
            _shard_map(
                local, mesh,
                in_specs=(P(None, None), P(None, None), P(None), P(axis, None)),
                out_specs=P(axis, None),
            )
        )(C, N, t, Gm)
        return np.asarray(out)[:v, :v]

    return run


# ---------------------------------------------------------------------------
# correlation panel: marker-row-sharded contingency matmuls
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_chunks", "axis"))
def _panel_sharded_body(bed_rows, bed_full, phen0, phenv, mean, std,
                        n_chunks: int, axis: str):
    """Per-device slab of the fused correlation panel.

    bed_rows: (m/D, B) this shard's packed rows; bed_full: (m, B) replicated.
    Output: replicated (m + p, m + p) panel (rows all-gathered over `axis`).
    Matches `_panel_device` (`ops/corr.py`) exactly — the decode + matmul per
    sample chunk happen on the row slab, so FLOPs and HBM writes scale 1/D.
    """
    ms, B = bed_rows.shape
    m = bed_full.shape[0]
    p = phen0.shape[0]
    chunk_bytes = B // n_chunks
    chunk = 4 * chunk_bytes

    def step(carry, idx):
        counts, s_mp, s_p, n_val = carry
        rb = jax.lax.dynamic_slice(bed_rows, (0, idx * chunk_bytes), (ms, chunk_bytes))
        cb = jax.lax.dynamic_slice(bed_full, (0, idx * chunk_bytes), (m, chunk_bytes))
        codes = unpack_bed_codes(rb)
        oh = geno_onehot(codes).reshape(3 * ms, -1)
        oh_full = geno_onehot(unpack_bed_codes(cb)).reshape(3 * m, -1)
        counts = counts + contingency_counts(oh, oh_full)
        vals, valid = geno_value_valid(codes)
        ph0 = jax.lax.dynamic_slice(phen0, (0, idx * chunk), (p, chunk))
        s_mp = s_mp + jnp.dot(
            vals * valid, ph0.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        s_p = s_p + jnp.dot(
            valid, ph0.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        phv = jax.lax.dynamic_slice(phenv, (0, idx * chunk), (p, chunk))
        n_val = n_val + jnp.dot(
            valid, phv.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return (counts, s_mp, s_p, n_val), None

    init = (
        jnp.zeros((3 * ms, 3 * m), jnp.int32),
        jnp.zeros((ms, p), jnp.float32),
        jnp.zeros((ms, p), jnp.float32),
        jnp.zeros((ms, p), jnp.float32),
    )
    (counts, s_mp, s_p, n_val), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    C_mm_rows = _kendall_from_counts(counts.astype(jnp.float32), ms, m)
    shard = jax.lax.axis_index(axis)
    mean_rows = jax.lax.dynamic_slice(mean, (shard * ms,), (ms,))
    std_rows = jax.lax.dynamic_slice(std, (shard * ms,), (ms,))
    C_mp_rows = (s_mp - mean_rows[:, None] * s_p) / (n_val * std_rows[:, None])
    C_rows = jnp.concatenate([C_mm_rows, C_mp_rows], axis=1)  # (ms, m + p)

    # all-gather the marker rows; trait rows are computed replicated
    C_markers = jax.lax.all_gather(C_rows, axis, tiled=True)  # (m, m + p)
    s_pp = jnp.dot(phen0, phen0.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    n_pp = jnp.dot(phenv, phenv.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    C_pp = s_pp / n_pp
    C_traits = jnp.concatenate([C_markers[:, m:].T, C_pp], axis=1)  # (p, m+p)
    C = jnp.concatenate([C_markers, C_traits], axis=0)
    return jnp.where(jnp.eye(m + p, dtype=bool), jnp.float32(1.0), C)


def make_panel_sharded(mesh: Mesh, axis: str):
    """Sharded `corr_panel_device`: returns (C_dev replicated, v)."""
    from cigwas_tpu.constants import PANEL_ALIGN
    from cigwas_tpu.ops.corr import _pad_rows, _prep_bytes, _reorder_mask_panel
    from cigwas_tpu.ops.corr import DEFAULT_SAMPLE_CHUNK
    from cigwas_tpu.ops.decode import PAD_BYTE

    ndev = mesh_axis_size(mesh, axis)

    def run(bed_bytes, phen, marker_mean, marker_std, num_samples,
            sample_chunk: int = DEFAULT_SAMPLE_CHUNK):
        bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
        phen = np.asarray(phen, dtype=np.float32)
        m = bed_bytes.shape[0]
        p = phen.shape[0]
        v = m + p
        # pad markers so the panel hits the shape bucket, then extend so the
        # marker-row count divides the mesh axis (the panel grows slightly
        # past the bucket; extra rows are inert like the bucket pads)
        m_pad = m + ((-v) % PANEL_ALIGN)
        if m_pad % ndev:
            m_pad += ndev - m_pad % ndev
        if m_pad != m:
            bed_bytes = _pad_rows(bed_bytes, m_pad, PAD_BYTE)
            marker_mean = _pad_rows(
                np.asarray(marker_mean, dtype=np.float32), m_pad, 1.0
            )
            marker_std = _pad_rows(np.asarray(marker_std, dtype=np.float32), m_pad, 1.0)
        sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
        padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
        n_padded = padded.shape[1] * 4
        phen0 = np.zeros((p, n_padded), dtype=np.float32)
        phenv = np.zeros((p, n_padded), dtype=np.float32)
        phen0[:, : phen.shape[1]] = np.nan_to_num(phen)
        phenv[:, : phen.shape[1]] = np.isfinite(phen).astype(np.float32)

        fn = jax.jit(
            _shard_map(
                partial(_panel_sharded_body, n_chunks=n_chunks, axis=axis),
                mesh,
                in_specs=(P(axis, None), P(None, None), P(None, None),
                          P(None, None), P(None), P(None)),
                out_specs=P(None, None),
            )
        )
        C_raw = fn(
            jnp.asarray(padded),
            jnp.asarray(padded),
            jnp.asarray(phen0),
            jnp.asarray(phenv),
            jnp.asarray(np.asarray(marker_mean, dtype=np.float32)),
            jnp.asarray(np.asarray(marker_std, dtype=np.float32)),
        )
        if m_pad == m:
            return C_raw, v
        idx = np.concatenate(
            [np.arange(m), np.arange(m_pad, m_pad + p), np.arange(m, m_pad)]
        ).astype(np.int32)
        return _reorder_mask_panel(C_raw, jnp.asarray(idx), jnp.int32(v)), v

    return run


# ---------------------------------------------------------------------------
# row-sharded (non-replicated) panel: ring gather + level kernels
# ---------------------------------------------------------------------------
#
# The replicated engine bounds per-block size by one chip's HBM (the whole
# (vp, vp) panel lives on every device). The row-sharded mode keeps the
# panel split over the mesh — each device owns (vp/D, vp) rows — and every
# level kernel consumes it through ONE primitive: a ring pass that rotates
# the panel shards around the mesh while each device extracts the (nt, d, d)
# local neighbour panels of the nodes it owns. Peak panel bytes per device
# are 2 shards (own + in-flight) + the local panels: the analogue of the
# reference's stripe sweep under a device-memory cap
# (`corr_host.cu:208-420`).


def _ring_local_panels(C_loc, node_ixs, nbrs, axis: str, ndev: int):
    """(Cb (nt, d, d), qb (nt, d)) local panels from a row-sharded C.

    C_loc: (L, vp) this device's panel rows [me*L, (me+1)*L); node_ixs /
    nbrs: this device's node tile (GLOBAL variable indices). D ring steps;
    at step k the device holds shard (me + k) % D and copies the rows of it
    that its nodes reference. Selection is exact (where-masked), so the
    gathered panels are bitwise equal to a replicated gather.
    """
    L = C_loc.shape[0]
    me = jax.lax.axis_index(axis)
    nt, d = nbrs.shape
    Cb0 = jnp.zeros((nt, d, d), jnp.float32)
    qb0 = jnp.zeros((nt, d), jnp.float32)

    def step(k, carry):
        Cb, qb, shard = carry
        src = (me + k) % ndev
        r0 = src * L
        loc = nbrs - r0  # (nt, d)
        inside = (loc >= 0) & (loc < L)
        rows = shard[jnp.clip(loc, 0, L - 1)[:, :, None],
                     nbrs[:, None, :]]  # (nt, d, d)
        Cb = jnp.where(inside[:, :, None], rows, Cb)
        xloc = node_ixs - r0
        x_in = (xloc >= 0) & (xloc < L)
        xrows = shard[jnp.clip(xloc, 0, L - 1)[:, None], nbrs]  # (nt, d)
        qb = jnp.where(x_in[:, None], xrows, qb)
        shard = jax.lax.ppermute(
            shard, axis, [(i, (i - 1) % ndev) for i in range(ndev)]
        )
        return Cb, qb, shard

    Cb, qb, _ = jax.lax.fori_loop(0, ndev, step, (Cb0, qb0, C_loc))
    return Cb, qb


def make_level_local_rowsharded(mesh: Mesh, axis: str, l: int):
    """Row-sharded dense local-panel sweep (levels 2/3): the node tile AND
    the panel rows are sharded over `axis`; local panels come from the ring
    pass. Same contract as `level2/3_local_sweep`."""
    base = {
        2: pcorr_ops.level2_local_sweep_pre,
        3: pcorr_ops.level3_local_sweep_pre,
    }[l]
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def body(C_loc, node_ixs, nbrs, deg, ct: int):
        Cb, qb = _ring_local_panels(C_loc, node_ixs, nbrs, axis, ndev)
        return base(Cb, qb, deg, ct=ct)

    def run(C, node_ixs, nbrs, deg, ct: int):
        fn = cache.get(ct)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(body, ct=ct),
                    mesh,
                    in_specs=(P(axis, None), P(axis), P(axis, None), P(axis)),
                    out_specs=(P(axis, None), P(axis, None, None)),
                )
            )
            cache[ct] = fn
        return fn(C, node_ixs, nbrs, deg)

    return run


def make_level_scan_rowsharded(mesh: Mesh, axis: str):
    """Row-sharded `level_scan_minrho` (levels >= 4): ring-gathered local
    panels feed the combinatorial chunk scan."""
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def body(C_loc, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
        Cb, qb = _ring_local_panels(C_loc, node_ixs, nbrs, axis, ndev)
        return pcorr_ops.level_scan_minrho_pre(
            Cb, qb, deg, combos_seq, left_seq, l
        )

    def run(C, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
        fn = cache.get(l)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(body, l=l),
                    mesh,
                    in_specs=(
                        P(axis, None), P(axis), P(axis, None), P(axis),
                        P(None, None, None), P(None, axis),
                    ),
                    out_specs=(P(axis, None), P(axis, None)),
                )
            )
            cache[l] = fn
        return fn(C, node_ixs, nbrs, deg, combos_seq, left_seq)

    return run


def make_hetcor_local_rowsharded(mesh: Mesh, axis: str, l: int):
    """Row-sharded hetcor dense local sweep (levels 2/3): node tile, panel
    ROWS and ESS rows sharded over `axis`; local (nt, d, d) panels of BOTH
    the correlation panel and the per-pair N come from ring passes. Same
    contract as `pcorr.hetcor2/3_local_sweep` (time index replicated)."""
    base = {
        2: pcorr_ops.hetcor2_local_sweep_pre,
        3: pcorr_ops.hetcor3_local_sweep_pre,
    }[l]
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def body(C_loc, N_loc, t_ix, node_ixs, nbrs, deg, th: float, ct: int):
        Cb, qb = _ring_local_panels(C_loc, node_ixs, nbrs, axis, ndev)
        Nb, nr = _ring_local_panels(N_loc, node_ixs, nbrs, axis, ndev)
        tn = t_ix[nbrs].astype(jnp.float32)
        t_x = t_ix[node_ixs].astype(jnp.float32)
        return base(Cb, qb, Nb, nr, tn, t_x, deg, jnp.float32(th), ct)

    def run(C, N, t_ix, node_ixs, nbrs, deg, th: float, ct: int):
        key = (ct, float(th))
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(body, th=float(th), ct=ct),
                    mesh,
                    in_specs=(
                        P(axis, None), P(axis, None), P(None),
                        P(axis), P(axis, None), P(axis),
                    ),
                    out_specs=P(axis, None),
                )
            )
            cache[key] = fn
        return fn(C, N, t_ix, node_ixs, nbrs, deg)

    return run


def make_level_scan_hetcor_rowsharded(mesh: Mesh, axis: str):
    """Row-sharded `level_scan_hetcor` (levels >= 4): ring-gathered local
    correlation AND per-pair-N panels feed the combinatorial chunk scan."""
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def body(C_loc, N_loc, t_ix, node_ixs, nbrs, deg, combos_seq, left_seq,
             th, l: int):
        Cb, qb = _ring_local_panels(C_loc, node_ixs, nbrs, axis, ndev)
        Nb, nr = _ring_local_panels(N_loc, node_ixs, nbrs, axis, ndev)
        tn = t_ix[nbrs].astype(jnp.float32)
        t_x = t_ix[node_ixs].astype(jnp.float32)
        return pcorr_ops.level_scan_hetcor_pre(
            Cb, qb, Nb, nr, tn, t_x, deg, combos_seq, left_seq, th, l
        )

    def run(C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th, l: int):
        fn = cache.get(l)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(body, l=l),
                    mesh,
                    in_specs=(
                        P(axis, None), P(axis, None), P(None),
                        P(axis), P(axis, None), P(axis),
                        P(None, None, None), P(None, axis), P(),
                    ),
                    out_specs=P(axis, None),
                )
            )
            cache[l] = fn
        return fn(C, N, t, node_ixs, nbrs, deg, combos_seq, left_seq, th)

    return run


def _hetcor1_ring_body(C_loc, N_loc, t_full, G_loc, th, axis: str, ndev: int):
    """Row-sharded dense hetcor level-1 margin sweep: x rows local, y rows
    via the ring (`_dense1_ring_body` with `_hetcor1_dense_padded`'s ESS and
    time terms). The (y, s) pairwise-N factors ride the ring alongside the
    y-row R/P factors; time indices are replicated.
    """
    L, vp = C_loc.shape
    me = jax.lax.axis_index(axis)
    R_loc = jax.lax.rsqrt(jnp.abs(1.0 - C_loc * C_loc))
    P_loc = C_loc * R_loc
    Nv_loc = jnp.nan_to_num(N_loc)
    Nok_loc = (~jnp.isnan(N_loc)).astype(jnp.float32)
    NN_loc = Nv_loc * Nok_loc
    tf = t_full.astype(jnp.float32)
    s_ix = jnp.arange(vp)
    x_ix0 = me * L + jnp.arange(L)
    t_x = jnp.take(tf, x_ix0)

    def step(k, carry):
        margin_all, sR, sP, sNN, sNok = carry
        src = (me + k) % ndev
        y0 = src * L
        cxy = jax.lax.dynamic_slice(C_loc, (0, y0), (L, L))
        nnxy = jax.lax.dynamic_slice(NN_loc, (0, y0), (L, L))  # N[x,y] masked
        oxy = jax.lax.dynamic_slice(Nok_loc, (0, y0), (L, L))
        rho = jnp.abs(
            cxy[:, :, None] * (R_loc[:, None, :] * sR[None, :, :])
            - P_loc[:, None, :] * sP[None, :, :]
        )
        total = nnxy[:, :, None] + NN_loc[:, None, :] + sNN[None, :, :]
        count = oxy[:, :, None] + Nok_loc[:, None, :] + sNok[None, :, :]
        mean_ess = total / count
        th_test = jnp.tanh(th / jnp.sqrt(mean_ess - 4.0))
        t_y = jax.lax.dynamic_slice(tf, (y0,), (L,))
        t_pair = jnp.maximum(t_x[:, None], t_y[None, :])  # (L, L)
        bad_time = tf[None, None, :] > t_pair[:, :, None]
        y_ix = y0 + jnp.arange(L)
        bad = (
            (s_ix[None, None, :] == x_ix0[:, None, None])
            | (s_ix[None, None, :] == y_ix[None, :, None])
            | ~G_loc[:, None, :]
            | bad_time
        )
        margin = rho - th_test
        margin = jnp.where(bad | ~jnp.isfinite(margin), pcorr_ops.MARGIN_BIG,
                           margin)
        margin_all = jax.lax.dynamic_update_slice(
            margin_all, jnp.min(margin, axis=2), (0, y0)
        )
        perm = [(i, (i - 1) % ndev) for i in range(ndev)]
        return (
            margin_all,
            jax.lax.ppermute(sR, axis, perm),
            jax.lax.ppermute(sP, axis, perm),
            jax.lax.ppermute(sNN, axis, perm),
            jax.lax.ppermute(sNok, axis, perm),
        )

    init = (
        jnp.full((L, vp), pcorr_ops.MARGIN_BIG, jnp.float32),
        R_loc, P_loc, NN_loc, Nok_loc,
    )
    margin_all, _, _, _, _ = jax.lax.fori_loop(0, ndev, step, init)
    return margin_all


def make_hetcor1_rowsharded(mesh: Mesh, axis: str):
    """Row-sharded `hetcor1_dense_margin`; same host contract (returns the
    (v, v) margin as numpy)."""
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def run(C_dev, N_dev, t_dev, Gb, th: float):
        C = jnp.asarray(C_dev, dtype=jnp.float32)
        v = C.shape[0]
        N = jnp.asarray(N_dev, dtype=jnp.float32)
        t = jnp.asarray(t_dev, dtype=jnp.int32)
        Gm = jnp.asarray(np.asarray(Gb), dtype=bool)
        import math
        pad = (-v) % math.lcm(128, ndev)
        if pad:
            C = jnp.pad(C, ((0, pad), (0, pad)))
            Gm = jnp.pad(Gm, ((0, pad), (0, pad)))
            N = jnp.pad(N, ((0, pad), (0, pad)), constant_values=10.0)
            t = jnp.pad(t, (0, pad))
        key = (float(th),)
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(_hetcor1_ring_body, th=jnp.float32(th),
                            axis=axis, ndev=ndev),
                    mesh,
                    in_specs=(P(axis, None), P(axis, None), P(None),
                              P(axis, None)),
                    out_specs=P(axis, None),
                )
            )
            cache[key] = fn
        out = fn(C, N, t, Gm)
        return np.asarray(out)[:v, :v]

    return run


def _dense1_ring_body(C_loc, G_loc, axis: str, ndev: int):
    """Row-sharded dense level-1 sweep: x rows local, y rows via the ring.

    For each local x row and every (y, s): rho = |c_xy R_xs R_ys - P_xs
    P_ys| with the y-row R/P factors arriving shard by shard. Matches
    `pcorr._level1_dense_padded`'s tests and smallest-s tie-break.
    """
    L, vp = C_loc.shape
    me = jax.lax.axis_index(axis)
    R_loc = jax.lax.rsqrt(jnp.abs(1.0 - C_loc * C_loc))
    P_loc = C_loc * R_loc
    s_ix = jnp.arange(vp)
    x_ix0 = me * L + jnp.arange(L)

    def step(k, carry):
        rho_all, s_all, shard_R, shard_P = carry
        src = (me + k) % ndev
        y0 = src * L
        # (L x, L y, vp s) cube for this y shard
        cxy = jax.lax.dynamic_slice(C_loc, (0, y0), (L, L))  # C[x, y]
        rho = jnp.abs(
            cxy[:, :, None] * (R_loc[:, None, :] * shard_R[None, :, :])
            - P_loc[:, None, :] * shard_P[None, :, :]
        )
        y_ix = y0 + jnp.arange(L)
        bad = (
            (s_ix[None, None, :] == x_ix0[:, None, None])
            | (s_ix[None, None, :] == y_ix[None, :, None])
            | ~(G_loc[:, None, :] > 0)
        )
        rho = jnp.where(bad | ~jnp.isfinite(rho), pcorr_ops.RHO_BIG, rho)
        rmin = jnp.min(rho, axis=2)
        smin = jnp.argmin(rho, axis=2).astype(jnp.int32)
        rho_all = jax.lax.dynamic_update_slice(rho_all, rmin, (0, y0))
        s_all = jax.lax.dynamic_update_slice(s_all, smin, (0, y0))
        perm = [(i, (i - 1) % ndev) for i in range(ndev)]
        return (
            rho_all, s_all,
            jax.lax.ppermute(shard_R, axis, perm),
            jax.lax.ppermute(shard_P, axis, perm),
        )

    init = (
        jnp.full((L, vp), pcorr_ops.RHO_BIG, jnp.float32),
        jnp.zeros((L, vp), jnp.int32),
        R_loc,
        P_loc,
    )
    rho_all, s_all, _, _ = jax.lax.fori_loop(0, ndev, step, init)
    return rho_all, s_all


def make_level1_rowsharded(mesh: Mesh, axis: str):
    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def run(C, Gb):
        fn = cache.get("f")
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(_dense1_ring_body, axis=axis, ndev=ndev),
                    mesh,
                    in_specs=(P(axis, None), P(axis, None)),
                    out_specs=(P(axis, None), P(axis, None)),
                )
            )
            cache["f"] = fn
        return fn(C, jnp.asarray(np.asarray(Gb).astype(np.int8)))

    return run


def make_panel_rowsharded(mesh: Mesh, axis: str):
    """Row-sharded correlation panel: each device computes and KEEPS only
    its (vp/D, vp) row stripe (layout [markers, traits, pads] like
    `corr_panel_device`); returns (C row-sharded, v).

    The marker-phen and phen-phen blocks are computed ON DEVICE with the
    same per-chunk matmuls + epilogue as `_panel_device` /
    `_panel_sharded_body`, so every panel entry is bit-equal to the
    single-device path (the earlier host `marker_phen_corr` shortcut
    differed by ~1 ulp in the f32 epilogue and broke `.corr` byte-parity).
    """
    from cigwas_tpu.ops.corr import DEFAULT_SAMPLE_CHUNK, _pad_rows, _prep_bytes
    from cigwas_tpu.ops.decode import PAD_BYTE

    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def run(bed_bytes, phen, marker_mean, marker_std, num_samples,
            sample_chunk: int = DEFAULT_SAMPLE_CHUNK):
        bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
        phen = np.asarray(phen, dtype=np.float32)
        m = bed_bytes.shape[0]
        p = phen.shape[0]
        v = m + p
        vp = -(-v // (128 * ndev)) * (128 * ndev)
        m_pad = vp - p
        bed_pad = _pad_rows(bed_bytes, m_pad, PAD_BYTE)
        sample_chunk = min(
            sample_chunk, 4 * (((bed_pad.shape[1] + 31) // 32) * 32)
        )
        padded, n_chunks = _prep_bytes(bed_pad, num_samples, sample_chunk)
        n_padded = padded.shape[1] * 4
        phen0 = np.zeros((p, n_padded), dtype=np.float32)
        phenv = np.zeros((p, n_padded), dtype=np.float32)
        phen0[:, : phen.shape[1]] = np.nan_to_num(phen)
        phenv[:, : phen.shape[1]] = np.isfinite(phen).astype(np.float32)

        # panel row r (final layout) -> bed row: r for markers, r - p for
        # pads; trait rows get bed row 0 as a placeholder and are
        # overwritten from the device-computed trait block afterwards
        bed_row_of = np.concatenate(
            [np.arange(m), np.zeros(p, np.int64), np.arange(m, m_pad)]
        )
        row_bytes = padded[bed_row_of]  # (vp, B) host gather of byte rows
        mean_pad = _pad_rows(np.asarray(marker_mean, np.float32), m_pad, 1.0)
        std_pad = _pad_rows(np.asarray(marker_std, np.float32), m_pad, 1.0)
        mean_r = mean_pad[bed_row_of]
        std_r = std_pad[bed_row_of]
        is_trait = np.zeros(vp, bool)
        is_trait[m : m + p] = True
        trait_of = np.zeros(vp, np.int64)
        trait_of[m : m + p] = np.arange(p)

        # m and p are baked into the shard_map body: they MUST key the
        # cache (blocks of different marker counts can share padded.shape
        # after m_pad rounding — reusing the wrong body silently mislabels
        # the trait columns)
        key = (padded.shape, n_chunks, vp, m, p)
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(
                        _panel_rowsharded_body, n_chunks=n_chunks, m=m, p=p,
                        axis=axis, ndev=ndev,
                    ),
                    mesh,
                    in_specs=(
                        P(axis, None),  # this shard's byte rows
                        P(None, None),  # all byte rows (for columns)
                        P(None, None),  # phen values
                        P(None, None),  # phen valid mask
                        P(axis),        # per-row marker mean
                        P(axis),        # per-row marker std
                        P(axis),        # is_trait
                        P(axis),        # trait_of
                    ),
                    out_specs=P(axis, None),
                )
            )
            cache[key] = fn
        C = fn(
            jnp.asarray(row_bytes), jnp.asarray(padded),
            jnp.asarray(phen0), jnp.asarray(phenv),
            jnp.asarray(mean_r), jnp.asarray(std_r),
            jnp.asarray(is_trait), jnp.asarray(trait_of.astype(np.int32)),
        )
        return C, v

    return run


def _panel_rowsharded_body(row_bytes, bed_all, phen0, phenv, mean_r, std_r,
                           is_trait, trait_of, n_chunks: int, m: int, p: int,
                           axis: str, ndev: int):
    """One (vp/D, vp) stripe of the final-layout panel.

    Kendall rows vs ALL bed rows give the marker/pad columns; the
    marker-phen block is computed per shard row with `_panel_device`'s
    chunked matmuls + epilogue (bit-equal), all-gathered so trait ROWS can
    be assembled as [mp.T | pp | 0] on every shard.
    """
    from cigwas_tpu.ops.corr import _kendall_counts_block

    L, B = row_bytes.shape
    me = jax.lax.axis_index(axis)
    counts = _kendall_counts_block(row_bytes, bed_all, n_chunks)
    k_all = _kendall_from_counts(counts, L, bed_all.shape[0])  # (L, m_pad)

    # marker-phen sums per shard row (same chunk sequence + dot shapes rule
    # as `_panel_sharded_body`, so each row's sums are bit-equal to the
    # single-device scan)
    chunk_bytes = B // n_chunks
    chunk = 4 * chunk_bytes

    def mp_step(carry, idx):
        s_mp, s_p, n_val = carry
        rb = jax.lax.dynamic_slice(
            row_bytes, (0, idx * chunk_bytes), (L, chunk_bytes)
        )
        vals, valid = geno_value_valid(unpack_bed_codes(rb))
        ph0 = jax.lax.dynamic_slice(phen0, (0, idx * chunk), (p, chunk))
        phv = jax.lax.dynamic_slice(phenv, (0, idx * chunk), (p, chunk))
        s_mp = s_mp + jnp.dot(
            vals * valid, ph0.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        s_p = s_p + jnp.dot(
            valid, ph0.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        n_val = n_val + jnp.dot(
            valid, phv.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return (s_mp, s_p, n_val), None

    init = (
        jnp.zeros((L, p), jnp.float32),
        jnp.zeros((L, p), jnp.float32),
        jnp.zeros((L, p), jnp.float32),
    )
    (s_mp, s_p, n_val), _ = jax.lax.scan(mp_step, init, jnp.arange(n_chunks))
    mp_rows = (s_mp - mean_r[:, None] * s_p) / (n_val * std_r[:, None])
    mp_all = jax.lax.all_gather(mp_rows, axis, tiled=True)  # (vp, p)

    s_pp = jnp.dot(phen0, phen0.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    n_pp = jnp.dot(phenv, phenv.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    C_pp = s_pp / n_pp

    # final column layout: [markers 0:m | traits m:m+p | pads m+p:vp]
    stripe = jnp.concatenate(
        [k_all[:, :m], mp_rows, k_all[:, m:]], axis=1
    )  # (L, vp)
    vp = stripe.shape[1]
    g_row = me * L + jnp.arange(L)
    # trait ROWS: [mp.T markers | pp | zeros pads]
    trait_full = jnp.concatenate(
        [mp_all[:m].T, C_pp, jnp.zeros((p, vp - m - p), jnp.float32)], axis=1
    )  # (p, vp)
    trows = trait_full[jnp.clip(trait_of, 0, p - 1)]  # (L, vp)
    stripe = jnp.where(is_trait[:, None], trows, stripe)
    # diagonal 1, inert pads (zero off-diagonal beyond v = m + p)
    col = jnp.arange(vp)[None, :]
    v = m + p
    on_diag = col == g_row[:, None]
    pad_rc = (g_row[:, None] >= v) | (col >= v)
    stripe = jnp.where(on_diag, 1.0, jnp.where(pad_rc, 0.0, stripe))
    return stripe


# ---------------------------------------------------------------------------
# genome-wide banded correlations (the `block` stage) over the mesh
# ---------------------------------------------------------------------------


def _banded_body(bytes_loc, width: int, n_chunks: int, m_real: int,
                 axis: str, ndev: int):
    """Per-shard banded Kendall band (mloc, width) with a ring boundary pass.

    Each shard computes the band rows it owns; the conditioning columns past
    its last row come from the NEXT shard's leading `width` genotype rows,
    exchanged with one `ppermute` (SURVEY §2.4 row 5's ring analogue of the
    reference's streamed stripe pairs, `corr_host.cu:1199-1319`).
    """
    from cigwas_tpu.ops.corr import _kendall_counts_block

    mloc, B = bytes_loc.shape
    idx = jax.lax.axis_index(axis)
    head = jax.lax.slice(bytes_loc, (0, 0), (width, B))
    recv = jax.lax.ppermute(
        head, axis, [(i, (i - 1) % ndev) for i in range(ndev)]
    )
    cols = jnp.concatenate([bytes_loc, recv], axis=0)  # (mloc + width, B)
    counts = _kendall_counts_block(bytes_loc, cols, n_chunks)
    corr = _kendall_from_counts(counts, mloc, mloc + width)
    r_ix = jnp.arange(mloc)[:, None]
    j_ix = jnp.arange(width)[None, :]
    band = jnp.take_along_axis(corr, r_ix + 1 + j_ix, axis=1)
    gcol = idx * mloc + r_ix + 1 + j_ix
    return jnp.where((gcol >= m_real) | ~jnp.isfinite(band), 0.0, band)


def make_banded_corr_sharded(mesh: Mesh, axis: str):
    """Sharded `kendall_npn_corr_banded`: chromosome marker rows split over
    `axis` with neighbour boundary-row exchange.

    Byte-identity contract: per-shard compute shapes equal the single-device
    path's when its `row_tile` equals the shard length (the same
    equal-shapes rule as the local sweeps); counts are exact integers, so
    the band is deterministic either way up to the elementwise tau epilogue.
    """
    from cigwas_tpu.ops.corr import DEFAULT_SAMPLE_CHUNK, _pad_rows, _prep_bytes
    from cigwas_tpu.ops.decode import PAD_BYTE

    ndev = mesh_axis_size(mesh, axis)
    cache = {}

    def run(bed_bytes, num_samples: int, corr_width: int,
            sample_chunk: int = DEFAULT_SAMPLE_CHUNK) -> np.ndarray:
        bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
        m = bed_bytes.shape[0]
        m_pad = -(-m // ndev) * ndev
        mloc = m_pad // ndev
        if mloc < corr_width:
            raise ValueError(
                f"{ndev}-way sharding leaves {mloc} rows/shard < corr_width "
                f"{corr_width}; use fewer devices or the single-device path"
            )
        bed_pad = _pad_rows(bed_bytes, m_pad, PAD_BYTE)
        sample_chunk = min(
            sample_chunk, 4 * (((bed_pad.shape[1] + 31) // 32) * 32)
        )
        padded, n_chunks = _prep_bytes(bed_pad, num_samples, sample_chunk)
        key = (padded.shape, n_chunks, corr_width, m)
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(
                _shard_map(
                    partial(
                        _banded_body, width=corr_width, n_chunks=n_chunks,
                        m_real=m, axis=axis, ndev=ndev,
                    ),
                    mesh,
                    in_specs=(P(axis, None),),
                    out_specs=P(axis, None),
                )
            )
            cache[key] = fn
        band = np.asarray(fn(jnp.asarray(padded)))
        return band[:m]

    return run


# ---------------------------------------------------------------------------
# engine handle
# ---------------------------------------------------------------------------


def make_engine(mesh, panel_mode: str = "replicated", axis: str | None = None):
    """Engine for a mesh (or None): `ShardedEngine` for the replicated
    panel, `RowShardedEngine` for (vp/D, vp) row strips. The shared
    constructor behind `pipelines.cusk.CuskContext` and `pipelines.cuskss`."""
    if mesh is None:
        return None
    if panel_mode not in ("replicated", "rowsharded"):
        raise ValueError(f"unknown panel_mode: {panel_mode!r}")
    if axis is None:
        axis = "marker" if "marker" in mesh.axis_names else mesh.axis_names[0]
    cls = RowShardedEngine if panel_mode == "rowsharded" else ShardedEngine
    return cls(mesh, axis)


class ShardedEngine:
    """Bundle of mesh-sharded kernel variants consumed by `skeleton()` /
    `hetcor_skeleton` / `pipelines.cusk` when a mesh is supplied."""

    def __init__(self, mesh: Mesh, axis: str = "marker"):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh_axis_size(mesh, axis)
        self.level_scan_minrho = make_level_scan_sharded(mesh, axis)
        self.level2_local_sweep = make_level_local_sharded(mesh, axis, 2)
        self.level3_local_sweep = make_level_local_sharded(mesh, axis, 3)
        self.level_scan_hetcor = make_level_scan_hetcor_sharded(mesh, axis)
        self.hetcor2_local_sweep = make_hetcor_local_sharded(mesh, axis, 2)
        self.hetcor3_local_sweep = make_hetcor_local_sharded(mesh, axis, 3)
        self.level1_dense_minrho = make_level1_sharded(mesh, axis)
        self.hetcor1_dense_margin = make_hetcor1_sharded(mesh, axis)
        self.corr_panel_device = make_panel_sharded(mesh, axis)
        self.kendall_npn_corr_banded = make_banded_corr_sharded(mesh, axis)

    def for_stage2(self):
        """Engine to use for the second cusk stage (the reduced panel)."""
        return self

    def put_panel(self, x) -> jax.Array:
        """Place a host (v, v) panel (correlation or per-pair N) with this
        engine's panel sharding: replicated here, row strips in
        `RowShardedEngine`. `v` must divide the mesh axis in row-sharded
        mode (callers pad to PANEL_ALIGN already)."""
        return jax.device_put(
            x, NamedSharding(self.mesh, P(None, None))
        )

    @classmethod
    def flat(cls, devices=None, axis: str = "marker") -> "ShardedEngine":
        """1-D mesh over all (or the given) devices."""
        if devices is None:
            devices = jax.devices()
        return cls(Mesh(np.array(devices), (axis,)), axis)


class RowShardedEngine(ShardedEngine):
    """Non-replicated panel mode: the correlation panel stays ROW-SHARDED
    over the mesh — each device holds a (vp/D, vp) stripe — so a block
    whose panel exceeds one chip's HBM still runs. Level kernels consume
    the stripes through a ring pass (`_ring_local_panels` /
    `_dense1_ring_body`): D ppermute steps rotate the stripes while each
    device extracts what its node shard needs; no device ever materializes
    the full panel. The multi-chip analogue of the reference's stripe sweep
    under a device-memory cap (`corr_host.cu:208-420`).

    The second cusk stage runs single-device (`for_stage2` returns None):
    the reduced panel is tiny and re-sharding it would only change kernel
    shapes, which the byte-identity contract forbids.
    """

    def __init__(self, mesh: Mesh, axis: str = "marker"):
        super().__init__(mesh, axis)
        self.level_scan_minrho = make_level_scan_rowsharded(mesh, axis)
        self.level2_local_sweep = make_level_local_rowsharded(mesh, axis, 2)
        self.level3_local_sweep = make_level_local_rowsharded(mesh, axis, 3)
        self.level1_dense_minrho = make_level1_rowsharded(mesh, axis)
        self.corr_panel_device = make_panel_rowsharded(mesh, axis)
        self.level_scan_hetcor = make_level_scan_hetcor_rowsharded(mesh, axis)
        self.hetcor1_dense_margin = make_hetcor1_rowsharded(mesh, axis)
        self.hetcor2_local_sweep = make_hetcor_local_rowsharded(mesh, axis, 2)
        self.hetcor3_local_sweep = make_hetcor_local_rowsharded(mesh, axis, 3)

    def put_panel(self, x) -> jax.Array:
        return jax.device_put(
            x, NamedSharding(self.mesh, P(self.axis, None))
        )

    def for_stage2(self):
        return None
