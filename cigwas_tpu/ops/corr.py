"""Correlation panels as dense matmuls.

Replaces the reference's per-pair CUDA reduction kernels
(`corr_kernels.cu:92-1150`) with dense contingency/covariance matmuls:

* marker–marker Kendall tau-b ("npn"): the 3x3 genotype contingency table of
  every marker pair is obtained in one shot as a one-hot matmul
  ``X (3m, n) @ X.T`` — all 9 counts for all m^2 pairs in one int8 GEMM. The
  tau-b -> Pearson map sin(pi/2 * tau) matches `corr_kernels.cu:408-476`.
* marker–phenotype Pearson with NaN masking (`corr_kernels.cu:92-155`) and
  phenotype–phenotype Pearson (`corr_kernels.cu:241-282`) are masked matmuls.
* the banded variant (`corr_kernels.cu:850-1150`) computes row tiles of the
  dense panel and gathers the width-w diagonal band.

Sample and row axes are processed in fixed-size chunks via `lax.scan` /
Python-level tiling so that device memory never holds a decoded (m, n)
panel; counts accumulate exactly in int32 (one-hot int8 inputs).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cigwas_tpu.ops.decode import (
    PAD_BYTE,
    contingency_counts,
    geno_onehot,
    geno_value_valid,
    unpack_bed_codes,
)

# default number of samples processed per scan step (bytes chunk = this / 4)
DEFAULT_SAMPLE_CHUNK = 131072
# default number of marker rows per output tile in the tiled/banded paths
DEFAULT_ROW_TILE = 2048


def _pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    m = arr.shape[0]
    pad = (-m) % multiple
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)], axis=0
    )


def _device_put_chunked(arr: np.ndarray, max_bytes: int = 8 * 2**20):
    """Upload a host array in row chunks and concatenate on device.

    Kept from the earlier host link, where one large `device_put` stalled;
    unmeasured on the H100's PCIe link (ROADMAP 1.7). Values are
    bit-identical either way.
    """
    nbytes = arr.nbytes
    if nbytes <= max_bytes or arr.ndim < 2:
        return jnp.asarray(arr)
    rows_per = max(1, int(len(arr) * max_bytes / nbytes))
    parts = [
        jax.device_put(arr[i : i + rows_per])
        for i in range(0, len(arr), rows_per)
    ]
    return jnp.concatenate(parts, axis=0)


def _prep_bytes(bed_bytes: np.ndarray, num_samples: int, sample_chunk: int):
    """Pad the byte matrix so every sample chunk is full; returns (bytes, n_chunks).

    Tail codes inside the final byte and padding bytes are forced to the
    "missing" code so they contribute nothing (reference guards with
    ``i*4+j < num_individuals``).
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m, B = bed_bytes.shape
    # force tail codes in the last partial byte to missing
    rem = num_samples % 4
    if rem and B * 4 >= num_samples:
        last = bed_bytes[:, (num_samples - 1) // 4].astype(np.uint16)
        keep_mask = (1 << (2 * rem)) - 1
        pad_bits = PAD_BYTE & ~keep_mask
        bed_bytes = bed_bytes.copy()
        bed_bytes[:, (num_samples - 1) // 4] = ((last & keep_mask) | pad_bits).astype(np.uint8)
    chunk_bytes = sample_chunk // 4
    padB = (-B) % chunk_bytes
    if padB:
        bed_bytes = np.concatenate(
            [bed_bytes, np.full((m, padB), PAD_BYTE, dtype=np.uint8)], axis=1
        )
    return bed_bytes, bed_bytes.shape[1] // chunk_bytes


@partial(jax.jit, static_argnames=("mr", "mc"))
def _kendall_from_counts(counts: jnp.ndarray, mr: int, mc: int) -> jnp.ndarray:
    """(3mr, 3mc) channel-major contingency counts -> (mr, mc) npn corr.

    counts[a*mr + i, b*mc + j] counts individuals with genotype a for row
    marker i and b for column marker j (the channel-major one-hot layout of
    :func:`cigwas_tpu.ops.decode.geno_onehot` makes the nine per-(a, b)
    count matrices contiguous blocks — no dim-3 transpose).
    Concordant/discordant/tie aggregates follow `corr_kernels.cu:455-471`;
    the result is sin(pi/2 * tau_b).
    """
    s = [
        counts[(i // 3) * mr : (i // 3 + 1) * mr, (i % 3) * mc : (i % 3 + 1) * mc]
        for i in range(9)
    ]
    p = (
        s[0] * (s[4] + s[5] + s[7] + s[8])
        + s[1] * (s[5] + s[8])
        + s[3] * (s[7] + s[8])
        + s[4] * s[8]
    )
    q = (
        s[1] * (s[3] + s[6])
        + s[2] * (s[3] + s[4] + s[6] + s[7])
        + s[4] * s[6]
        + s[5] * (s[6] + s[7])
    )
    t = (
        s[0] * (s[1] + s[2])
        + s[1] * s[2]
        + s[3] * (s[4] + s[5])
        + s[4] * s[5]
        + s[6] * (s[7] + s[8])
        + s[7] * s[8]
    )
    u = (
        s[0] * (s[3] + s[6])
        + s[1] * (s[4] + s[7])
        + s[2] * (s[5] + s[8])
        + s[3] * s[6]
        + s[4] * s[7]
        + s[5] * s[8]
    )
    tau = (p - q) / jnp.sqrt((p + q + t) * (p + q + u))
    return jnp.sin(jnp.pi / 2 * tau)


@partial(jax.jit, static_argnames=("n_chunks",))
def _kendall_counts_block(rows_bytes, cols_bytes, n_chunks: int):
    """Accumulated 3x3 contingency counts between two packed byte panels.

    rows_bytes: (mr, B), cols_bytes: (mc, B) -> channel-major counts
    (3mr, 3mc) f32 (see `_kendall_from_counts` for the block layout).
    Scans over sample chunks; each step decodes on the fly and issues one
    (3*mr, nc) x (nc, 3*mc) int8 matmul (exact int32 accumulation).
    """
    mr, B = rows_bytes.shape
    mc = cols_bytes.shape[0]
    chunk_bytes = B // n_chunks

    def step(acc, idx):
        rb = jax.lax.dynamic_slice(rows_bytes, (0, idx * chunk_bytes), (mr, chunk_bytes))
        cb = jax.lax.dynamic_slice(cols_bytes, (0, idx * chunk_bytes), (mc, chunk_bytes))
        ra = geno_onehot(unpack_bed_codes(rb)).reshape(3 * mr, -1)
        ca = geno_onehot(unpack_bed_codes(cb)).reshape(3 * mc, -1)
        acc = acc + contingency_counts(ra, ca)
        return acc, None

    counts, _ = jax.lax.scan(
        step, jnp.zeros((3 * mr, 3 * mc), jnp.int32), jnp.arange(n_chunks)
    )
    return counts.astype(jnp.float32)


def kendall_npn_corr(
    bed_bytes,
    num_samples: int,
    row_tile: int | None = None,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
) -> np.ndarray:
    """Full (m, m) marker–marker npn correlation panel.

    Equivalent of `cu_corr_pearson_npn` / `cu_marker_corr_pearson_npn_batched`
    (`corr_host.cu:1094-1197, 612-898`) — tiling replaces the stripe sweep.
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    if row_tile is None:
        row_tile = m if m <= 4096 else DEFAULT_ROW_TILE
    padded = _pad_rows(padded, row_tile, PAD_BYTE)
    mp = padded.shape[0]
    cols = jnp.asarray(padded)
    out = np.empty((mp, m), dtype=np.float32)
    # bounded wave dispatch (see kendall_npn_corr_banded): each queued tile
    # keeps its (3*row_tile, 3*mp) counts alive on device
    wave = max(1, int(4e9 / (4 * 9 * row_tile * mp)))
    pending = []

    def drain():
        for _, corr_dev in pending:
            corr_dev.copy_to_host_async()
        for t0, corr_dev in pending:
            out[t0 : t0 + row_tile] = np.asarray(corr_dev)[:, :m]
        pending.clear()

    for t0 in range(0, mp, row_tile):
        counts = _kendall_counts_block(cols[t0 : t0 + row_tile], cols, n_chunks)
        pending.append((t0, _kendall_from_counts(counts, row_tile, mp)))
        if len(pending) >= wave:
            drain()
    drain()
    res = out[:m]
    np.fill_diagonal(res, 1.0)
    return res


def kendall_npn_corr_banded(
    bed_bytes,
    num_samples: int,
    corr_width: int,
    row_tile: int = DEFAULT_ROW_TILE,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
) -> np.ndarray:
    """Banded npn correlations: band[i, j] = corr(i, i+1+j), zero past the end.

    Equivalent of `cal_mcorrk_banded` / the sparse-scan kernels
    (`corr_host.cu:1199-1319`, `corr_kernels.cu:850-1003`), with the stream of
    single-row launches replaced by row-tile x (tile+width) panel matmuls.
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    band = np.zeros((m, corr_width), dtype=np.float32)
    row_tile = min(row_tile, m)
    gather_ix = np.arange(1, corr_width + 1)[None, :] + np.arange(row_tile)[:, None]
    # wave dispatch: tiles are queued before any result is fetched, so the
    # host waits on the device once per wave instead of once per tile; wave
    # size is bounded by the device bytes each queued
    # tile keeps alive (its genotype panels + counts)
    per_tile_bytes = (2 * row_tile + corr_width) * padded.shape[1] + 4 * (
        3 * row_tile
    ) * 3 * (row_tile + corr_width)
    wave = max(1, int(4e9 / per_tile_bytes))
    pending = []

    def drain():
        for _, _, corr_dev in pending:
            corr_dev.copy_to_host_async()
        for t0, rt, corr_dev in pending:
            corr = np.asarray(corr_dev)
            # local column index of corr(i, i+1+j) is i_local + 1 + j
            tile_band = np.take_along_axis(
                corr, np.minimum(gather_ix, corr.shape[1] - 1), axis=1
            )
            # zero out entries whose global column falls off the chromosome
            global_col = t0 + gather_ix
            tile_band[(global_col >= m) | ~np.isfinite(tile_band)] = 0.0
            band[t0 : t0 + rt] = tile_band[:rt]
        pending.clear()

    for t0 in range(0, m, row_tile):
        rt = min(row_tile, m - t0)
        cols_end = min(t0 + row_tile + corr_width, m)
        rows_b = _pad_rows(padded[t0 : t0 + rt], row_tile, PAD_BYTE)
        cols_b = _pad_rows(padded[t0:cols_end], row_tile + corr_width, PAD_BYTE)
        counts = _kendall_counts_block(jnp.asarray(rows_b), jnp.asarray(cols_b), n_chunks)
        pending.append(
            (t0, rt, _kendall_from_counts(counts, row_tile, row_tile + corr_width))
        )
        if len(pending) >= wave:
            drain()
    drain()
    return band


@partial(jax.jit, static_argnames=("n_chunks",))
def _marker_phen_sums(bed_bytes, phen0, phen_valid, n_chunks: int):
    """Accumulate (s_mv_phen, s_phen, n_valid) over sample chunks.

    bed_bytes: (m, B); phen0/phen_valid: (p, 4*B) NaN-zeroed values & masks.
    """
    m, B = bed_bytes.shape
    p = phen0.shape[0]
    chunk_bytes = B // n_chunks
    chunk = 4 * chunk_bytes

    def step(carry, idx):
        s_mp, s_p, n_val = carry
        rb = jax.lax.dynamic_slice(bed_bytes, (0, idx * chunk_bytes), (m, chunk_bytes))
        ph0 = jax.lax.dynamic_slice(phen0, (0, idx * chunk), (p, chunk))
        phv = jax.lax.dynamic_slice(phen_valid, (0, idx * chunk), (p, chunk))
        vals, valid = geno_value_valid(unpack_bed_codes(rb))
        mv = vals * valid
        s_mp = s_mp + jnp.dot(mv, ph0.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        s_p = s_p + jnp.dot(valid, ph0.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        n_val = n_val + jnp.dot(valid, phv.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        return (s_mp, s_p, n_val), None

    init = tuple(jnp.zeros((m, p), jnp.float32) for _ in range(3))
    (s_mp, s_p, n_val), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    return s_mp, s_p, n_val


def marker_phen_sums_dispatch(
    bed_bytes,
    phen: np.ndarray,
    num_samples: int,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
):
    """Dispatch the marker-phen sum kernels; returns device handles (no fetch).

    Pair with :func:`marker_phen_corr_from_sums` — splitting lets a caller
    overlap the device work with other host work (block pre-screens in the
    multi-block runner).
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    phen = np.asarray(phen, dtype=np.float32)
    sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    n_padded = padded.shape[1] * 4
    phen0 = np.zeros((phen.shape[0], n_padded), dtype=np.float32)
    phenv = np.zeros((phen.shape[0], n_padded), dtype=np.float32)
    phen0[:, : phen.shape[1]] = np.nan_to_num(phen)
    phenv[:, : phen.shape[1]] = np.isfinite(phen).astype(np.float32)
    return _marker_phen_sums(
        jnp.asarray(padded), jnp.asarray(phen0), jnp.asarray(phenv), n_chunks
    )


def marker_phen_corr_from_sums(
    handles, marker_mean: np.ndarray, marker_std: np.ndarray
) -> np.ndarray:
    """Finish a dispatched marker-phen correlation (fetch + host math)."""
    s_mp, s_p, n_val = map(np.asarray, handles)
    mean = np.asarray(marker_mean, dtype=np.float32)[:, None]
    std = np.asarray(marker_std, dtype=np.float32)[:, None]
    return (s_mp - mean * s_p) / (n_val * std)


@jax.jit
def _mp_corr_dev(s_mp, s_p, n_val, mean, std):
    """Device epilogue of the marker-phen correlation (same expression as
    `_panel_device` / `marker_phen_corr_from_sums`, so all three agree
    bitwise — the tiled-vs-fused panel parity tests depend on it)."""
    return (s_mp - mean[:, None] * s_p) / (n_val * std[:, None])


def marker_phen_corr(
    bed_bytes,
    phen: np.ndarray,
    marker_mean: np.ndarray,
    marker_std: np.ndarray,
    num_samples: int,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
) -> np.ndarray:
    """(m, p) Pearson correlations between markers and standardized phenotypes.

    r = (sum(g * y) - mean_g * sum(y)) / (n_valid * std_g), sums over samples
    where the genotype is non-missing and the phenotype is not NaN — exactly
    `bed_marker_phen_corr_pearson` (`corr_kernels.cu:92-155`).
    """
    handles = marker_phen_sums_dispatch(bed_bytes, phen, num_samples, sample_chunk)
    return marker_phen_corr_from_sums(handles, marker_mean, marker_std)


def phen_phen_corr(phen: np.ndarray) -> np.ndarray:
    """(p, p) Pearson panel of standardized phenotypes with pairwise NaN masking.

    r_ab = sum_valid(y_a * y_b) / n_valid_ab (`corr_kernels.cu:241-282`; the
    phenotypes are assumed standardized, so no mean/std correction).
    """
    phen = np.asarray(phen, dtype=np.float32)
    p0 = jnp.asarray(np.nan_to_num(phen))
    v = jnp.asarray(np.isfinite(phen).astype(np.float32))
    s = jnp.dot(p0, p0.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    n = jnp.dot(v, v.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    return np.asarray(s / n)


@partial(jax.jit, static_argnames=("n_chunks",))
def _panel_device(bed_bytes, phen0, phenv, mean, std, n_chunks: int):
    m, B = bed_bytes.shape
    p = phen0.shape[0]
    chunk_bytes = B // n_chunks
    chunk = 4 * chunk_bytes

    def step(carry, idx):
        counts, s_mp, s_p, n_val = carry
        rb = jax.lax.dynamic_slice(bed_bytes, (0, idx * chunk_bytes), (m, chunk_bytes))
        codes = unpack_bed_codes(rb)
        oh = geno_onehot(codes).reshape(3 * m, -1)
        counts = counts + contingency_counts(oh, oh)
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
        jnp.zeros((3 * m, 3 * m), jnp.int32),
        jnp.zeros((m, p), jnp.float32),
        jnp.zeros((m, p), jnp.float32),
        jnp.zeros((m, p), jnp.float32),
    )
    (counts, s_mp, s_p, n_val), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    C_mm = _kendall_from_counts(counts.astype(jnp.float32), m, m)
    C_mp = (s_mp - mean[:, None] * s_p) / (n_val * std[:, None])
    s_pp = jnp.dot(
        phen0, phen0.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    n_pp = jnp.dot(
        phenv, phenv.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    C_pp = s_pp / n_pp
    C = jnp.concatenate(
        [
            jnp.concatenate([C_mm, C_mp], axis=1),
            jnp.concatenate([C_mp.T, C_pp], axis=1),
        ],
        axis=0,
    )
    return jnp.where(jnp.eye(m + p, dtype=bool), jnp.float32(1.0), C)


@jax.jit
def _reorder_mask_panel(C, idx, v_valid):
    """Move inert pad-marker rows behind the traits and zero their corrs.

    idx permutes [markers, pad, traits] -> [markers, traits, pad]; rows and
    columns at positions >= v_valid are cleared off-diagonal (their raw
    values are NaN from all-missing pad genotypes, which would otherwise
    read as "dependent" in the level-0 screen).
    """
    C2 = C[idx][:, idx]
    r = jnp.arange(C.shape[0])
    pad_rc = (r[:, None] >= v_valid) | (r[None, :] >= v_valid)
    off_diag = r[:, None] != r[None, :]
    return jnp.where(pad_rc & off_diag, jnp.float32(0.0), C2)


def corr_panel_device(
    bed_bytes,
    phen: np.ndarray,
    marker_mean: np.ndarray,
    marker_std: np.ndarray,
    num_samples: int,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
):
    """Packed correlation panel, computed and LEFT on device; returns (C, v).

    Fuses `kendall_npn_corr` + `marker_phen_corr` + `phen_phen_corr` +
    `pack_square_corr` into one dispatch: the genotype panel is decoded once
    per sample chunk and feeds both the contingency matmul and the
    marker-phen sums, and the packed matrix never leaves the device (the
    skeleton consumes it in place via ``skeleton(..., C_dev=C, n_var=v)``;
    fetch with ``np.asarray(C)[:v, :v]`` when the host copy is needed).

    C is shape-bucketed to a PANEL_ALIGN multiple with layout
    [v real variables, inert padding], so distinct block sizes share XLA
    compilations. Single-tile path: use the tiled `kendall_npn_corr` for
    m > ~4096.
    """
    from cigwas_tpu.constants import PANEL_ALIGN

    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    phen = np.asarray(phen, dtype=np.float32)
    m = bed_bytes.shape[0]
    p = phen.shape[0]
    v = m + p
    # pad marker rows so the total panel lands on the shape bucket
    m_pad = m + ((-v) % PANEL_ALIGN)
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
    C_raw = _panel_device(
        jnp.asarray(padded),
        jnp.asarray(phen0),
        jnp.asarray(phenv),
        jnp.asarray(np.asarray(marker_mean, dtype=np.float32)),
        jnp.asarray(np.asarray(marker_std, dtype=np.float32)),
        n_chunks,
    )
    if m_pad == m:
        return C_raw, v
    idx = np.concatenate(
        [np.arange(m), np.arange(m_pad, m_pad + p), np.arange(m, m_pad)]
    ).astype(np.int32)
    return _reorder_mask_panel(C_raw, jnp.asarray(idx), jnp.int32(v)), v


# mm-block row tile of the large-panel builder (multiple of PANEL_ALIGN so
# the assembled panel stays shape-bucketed; bigger stripes amortize the int8
# matmul better). Not yet derived on the H100 (ROADMAP 3.2)
PANEL_ROW_TILE = 2048


@partial(jax.jit, donate_argnums=(0,), static_argnames=("n_chunks",))
def _panel_mm_tile_update(C, rows_bytes, cols_bytes, t0, n_chunks: int):
    """One (rt, m_pad) Kendall tile written into the device canvas at row t0."""
    rt = rows_bytes.shape[0]
    mc = cols_bytes.shape[0]
    counts = _kendall_counts_block(rows_bytes, cols_bytes, n_chunks)
    tile = _kendall_from_counts(counts, rt, mc)
    return jax.lax.dynamic_update_slice(C, tile, (t0, 0))


# decode-once gate: materialize the whole (3m, n) int8 one-hot in HBM
# when it fits this budget; beyond it the scan path re-decodes per stripe
DECODE_ONCE_MAX_BYTES = 2 << 30


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("n_chunks", "row_tile", "nfull"))
def _panel_mm_tiles_fused(C, cols_bytes, n_chunks: int, row_tile: int,
                          nfull: int):
    """ALL full Kendall row stripes in ONE dispatch (fori over tiles).

    One dispatch instead of one per stripe; the loop body is identical to
    `_panel_mm_tile_update`, so tile values are byte-identical.

    When the decoded one-hot panel fits DECODE_ONCE_MAX_BYTES, the
    column panel is decoded ONCE into device memory and stripes are pure
    int8 matmul row slices instead of re-decoding per stripe. Counts are
    int32-exact either way, so tile values are bit-identical across the
    two paths.
    """
    B = cols_bytes.shape[1]
    mc = cols_bytes.shape[0]

    if 3 * mc * (4 * B) <= DECODE_ONCE_MAX_BYTES and n_chunks == 1:
        from cigwas_tpu.ops.decode import contingency_counts

        X = geno_onehot(unpack_bed_codes(cols_bytes)).reshape(3 * mc, -1)

        def body_pre(i, C):
            t0 = i * row_tile
            # channel-major rows of the stripe: [a*mc + t0, +rt) per
            # channel a (matches _kendall_from_counts' block layout)
            rows = jnp.concatenate([
                jax.lax.dynamic_slice(
                    X, (a * mc + t0, 0), (row_tile, X.shape[1])
                )
                for a in range(3)
            ], axis=0)
            counts = contingency_counts(rows, X).astype(jnp.float32)
            tile = _kendall_from_counts(counts, row_tile, mc)
            return jax.lax.dynamic_update_slice(C, tile, (t0, 0))

        return jax.lax.fori_loop(0, nfull, body_pre, C)

    def body(i, C):
        t0 = i * row_tile
        rows = jax.lax.dynamic_slice(cols_bytes, (t0, 0), (row_tile, B))
        counts = _kendall_counts_block(rows, cols_bytes, n_chunks)
        tile = _kendall_from_counts(counts, row_tile, mc)
        return jax.lax.dynamic_update_slice(C, tile, (t0, 0))

    return jax.lax.fori_loop(0, nfull, body, C)


@partial(jax.jit, donate_argnums=(0,))
def _panel_assemble(C, mp_corr, pp_corr, idx, v_valid):
    """Write the marker-phen / phen-phen blocks, set the unit diagonal, and
    reorder to [markers, traits, pad] with inert pads."""
    m_pad, p = mp_corr.shape
    C = jax.lax.dynamic_update_slice(C, mp_corr, (0, m_pad))
    C = jax.lax.dynamic_update_slice(C, mp_corr.T, (m_pad, 0))
    C = jax.lax.dynamic_update_slice(C, pp_corr, (m_pad, m_pad))
    vp = C.shape[0]
    C = jnp.where(jnp.eye(vp, dtype=bool), jnp.float32(1.0), C)
    return _reorder_mask_panel(C, idx, v_valid)


@partial(jax.jit, donate_argnums=(0,), static_argnames=("m", "sharding"))
def _set_trait_blocks(C, mp_corr, pp_corr, m: int, sharding=None):
    C = jax.lax.dynamic_update_slice(C, mp_corr, (0, m))
    C = jax.lax.dynamic_update_slice(C, mp_corr.T, (m, 0))
    p = pp_corr.shape[0]
    pp = jnp.where(jnp.eye(p, dtype=bool), jnp.float32(1.0), pp_corr)
    C = jax.lax.dynamic_update_slice(C, pp, (m, m))
    return C if sharding is None else jax.lax.with_sharding_constraint(
        C, sharding)


def set_trait_blocks(C, mp_corr: np.ndarray, pp_corr: np.ndarray, m: int):
    """Overwrite the marker-trait and trait-trait blocks of a device panel
    in the [m markers, p traits, pad] layout with the given host values
    (NaN marker-trait correlations stay NaN), keeping C's sharding.

    Every panel route takes these two blocks from the same host arrays —
    the pre-screen's marker-phen correlations and `phen_phen_corr` — as
    `corr_panel_device_tiled` does. Computed on device they would depend
    on the route: a GPU's f32 GEMMs accumulate in a shape-dependent order
    and its epilogue may contract to FMAs, so row-slab (sharded) and
    whole-block panels would differ in the last bits.
    """
    return _set_trait_blocks(
        C, jnp.asarray(np.asarray(mp_corr, np.float32)),
        jnp.asarray(np.asarray(pp_corr, np.float32)), m,
        sharding=C.sharding if len(C.sharding.device_set) > 1 else None,
    )


def corr_panel_device_tiled(
    bed_bytes,
    phen: np.ndarray,
    marker_mean: np.ndarray,
    marker_std: np.ndarray,
    num_samples: int,
    mp_corr: np.ndarray | None = None,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
    row_tile: int = PANEL_ROW_TILE,
    stats: dict | None = None,
):
    """Large-block correlation panel, built and LEFT on device; returns (C, v).

    The scalable sibling of :func:`corr_panel_device`: the (m, m) Kendall
    block is computed in `row_tile`-row stripes into a preallocated device
    canvas — the form of the reference's stripe sweep under a memory cap
    (`corr_host.cu:208-420`) — so peak device memory is O(row_tile * m)
    instead of O((3m)^2), and the packed panel NEVER crosses the host link
    (no ~0.5 GB fetch-pack-reupload round trip).

    mp_corr: optional precomputed (m, p) marker-phen correlations (the cusk
    pre-screen already has them, `pipelines/cusk.py`); computed here when
    absent. Tile dispatches are queued without any intervening fetch.

    Layout/alignment contract matches `corr_panel_device`: logical variables
    [m markers, p traits] occupy indices < v, inert pads follow, and the
    panel size is the smallest `row_tile` multiple >= m + p.
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    phen = np.asarray(phen, dtype=np.float32)
    m = bed_bytes.shape[0]
    p = phen.shape[0]
    v = m + p
    vp = -(-v // row_tile) * row_tile
    m_pad = vp - p
    import time as _time

    def _mark(name, t0):
        if stats is not None:
            stats[name] = stats.get(name, 0.0) + (_time.perf_counter() - t0)
        return _time.perf_counter()

    t_m = _time.perf_counter()
    mp_dev = None
    if mp_corr is None:
        # keep the marker-phen block ON DEVICE: fetching it only to
        # re-upload for the assemble would sync the host on the device
        # (production passes the pre-screen's host mp_corr instead)
        handles = marker_phen_sums_dispatch(bed_bytes, phen, num_samples)
        mp_dev = _mp_corr_dev(
            handles[0], handles[1], handles[2],
            jnp.asarray(np.asarray(marker_mean, np.float32)),
            jnp.asarray(np.asarray(marker_std, np.float32)),
        )
    t_m = _mark("panel_mp_s", t_m)
    bed_pad = _pad_rows(bed_bytes, m_pad, PAD_BYTE)
    sample_chunk = min(sample_chunk, 4 * (((bed_pad.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_pad, num_samples, sample_chunk)
    t_m = _mark("panel_prep_s", t_m)
    # chunked upload (see _device_put_chunked; ROADMAP 1.7)
    cols = _device_put_chunked(padded)
    t_m = _mark("panel_upload_s", t_m)

    C = jnp.zeros((vp, vp), jnp.float32)
    nfull = m_pad // row_tile
    if nfull:
        C = _panel_mm_tiles_fused(C, cols, n_chunks, row_tile, nfull)
    t0 = nfull * row_tile
    while t0 < m_pad:
        # ragged tail stripe (m_pad is vp - p, not a row_tile multiple)
        rt = min(row_tile, m_pad - t0)
        C = _panel_mm_tile_update(
            C, jax.lax.slice(cols, (t0, 0), (t0 + rt, cols.shape[1])), cols,
            jnp.int32(t0), n_chunks,
        )
        t0 += rt
    t_m = _mark("panel_dispatch_s", t_m)
    if stats is not None:
        # attribution-only sentinel: fetching one element of the canvas
        # waits out every queued Kendall stripe, so this mark isolates the
        # DEVICE wall of the mm tiles, which would otherwise hide in the
        # first downstream fetch
        float(C[0, 0])
        t_m = _mark("panel_mm_wall_s", t_m)

    # NaN marker-phen corrs stay NaN: the level-0 screen keeps such edges,
    # matching the fused `_panel_device` / host `pack_square_corr` paths
    if mp_dev is not None:
        mp_pad_dev = jnp.pad(mp_dev, ((0, m_pad - m), (0, 0)))
    else:
        mp_pad = np.zeros((m_pad, p), dtype=np.float32)
        mp_pad[:m] = np.asarray(mp_corr, dtype=np.float32)
        mp_pad_dev = jnp.asarray(mp_pad)
    # this fetch SYNCS behind every queued tile dispatch: without the
    # stats sentinel above it absorbs the whole mm-tile device wall
    pp = phen_phen_corr(phen).astype(np.float32)
    t_m = _mark("panel_pp_sync_s", t_m)
    idx = np.concatenate(
        [np.arange(m), np.arange(m_pad, m_pad + p), np.arange(m, m_pad)]
    ).astype(np.int32)
    C = _panel_assemble(
        C, mp_pad_dev, jnp.asarray(pp), jnp.asarray(idx), jnp.int32(v)
    )
    t_m = _mark("panel_assemble_s", t_m)
    return C, v


def banded_row_abs_sums(band: np.ndarray) -> np.ndarray:
    """Forward-band |corr| row sums used by LD blocking (`corr_host.cu:112-128`)."""
    return np.abs(band).sum(axis=1).astype(np.float32)


@partial(jax.jit, static_argnames=("row_tile", "width", "n_chunks"))
def _banded_tile_abs_sums(rows_bytes, cols_bytes, t0, m, row_tile: int,
                          width: int, n_chunks: int):
    """One banded tile reduced to its (row_tile,) |corr| row sums ON
    DEVICE — the whole band never crosses the host link."""
    counts = _kendall_counts_block(rows_bytes, cols_bytes, n_chunks)
    corr = _kendall_from_counts(counts, row_tile, row_tile + width)
    gather_ix = (
        jnp.arange(1, width + 1)[None, :] + jnp.arange(row_tile)[:, None]
    )
    band = jnp.take_along_axis(
        corr, jnp.minimum(gather_ix, corr.shape[1] - 1), axis=1
    )
    band = jnp.where(
        ((t0 + gather_ix) >= m) | ~jnp.isfinite(band), 0.0, band
    )
    return jnp.abs(band).sum(axis=1)


def banded_row_abs_sums_streaming(
    bed_bytes,
    num_samples: int,
    corr_width: int,
    row_tile: int = DEFAULT_ROW_TILE,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
) -> np.ndarray:
    """`banded_row_abs_sums(kendall_npn_corr_banded(...))` with the band
    reduced on device: each tile fetches (row_tile,) f32 instead of the
    (row_tile, width) band (~33 MB/tile at the reference-default width).

    The f32 row sums reduce in XLA's order instead of numpy's pairwise
    order, so results can differ from the two-step host path by float
    ulps; `make_blocks` uses this route only at chromosome scale (the
    golden blocking fixtures pin the host path).
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    row_tile = min(row_tile, m)
    # upload the chromosome ONCE (pad rows to a tile multiple plus the
    # band width, so every tile slices the same device array — the
    # two-step path re-uploads each overlapping column panel); pad rows
    # decode to all-missing -> NaN corr -> masked to 0 below
    mp = -(-m // row_tile) * row_tile
    big = _pad_rows(padded, mp + corr_width, PAD_BYTE)[: mp + corr_width]
    cols_all = _device_put_chunked(big)
    B = int(cols_all.shape[1])
    sums = np.zeros(m, dtype=np.float32)
    pending = []

    def drain():
        for _, _, s_dev in pending:
            s_dev.copy_to_host_async()
        for t0, rt, s_dev in pending:
            sums[t0 : t0 + rt] = np.asarray(s_dev)[:rt]
        pending.clear()

    for t0 in range(0, m, row_tile):
        rt = min(row_tile, m - t0)
        rows_b = jax.lax.dynamic_slice(cols_all, (t0, 0), (row_tile, B))
        cols_b = jax.lax.dynamic_slice(
            cols_all, (t0, 0), (row_tile + corr_width, B)
        )
        pending.append((t0, rt, _banded_tile_abs_sums(
            rows_b, cols_b, jnp.int32(t0), jnp.int32(m), row_tile,
            corr_width, n_chunks,
        )))
        if len(pending) >= 8:
            drain()
    drain()
    return sums


def pack_square_corr(
    marker_corr: np.ndarray, marker_phen: np.ndarray, phen_corr: np.ndarray
) -> np.ndarray:
    """Assemble the dense (m+p, m+p) correlation matrix fed to the skeleton.

    Equivalent of the triangular->square packing in `cli.cpp:594-649`; the
    diagonal is 1.
    """
    m, p = marker_phen.shape
    n = m + p
    sq = np.ones((n, n), dtype=np.float32)
    sq[:m, :m] = marker_corr
    sq[:m, m:] = marker_phen
    sq[m:, :m] = marker_phen.T
    sq[m:, m:] = phen_corr
    np.fill_diagonal(sq, 1.0)
    return sq


def marker_corr_mat_antidiag_sums(corrs: np.ndarray) -> np.ndarray:
    """Antidiagonal sums of the strictly-upper triangular panel.

    Equivalent of `marker_corr_mat_antidiag_sums` (`corr_host.cu:130-166`):
    entry (row, col) contributes to antidiagonal row + col - 1; the result
    has 2m - 3 entries. Accepts a dense symmetric panel.
    """
    corrs = np.asarray(corrs, dtype=np.float64)
    m = corrs.shape[0]
    sums = np.zeros(max(2 * m - 3, 0), dtype=np.float64)
    iu = np.triu_indices(m, k=1)
    np.add.at(sums, iu[0] + iu[1] - 1, corrs[iu])
    return sums.astype(np.float32)


def marker_pearson_corr(
    bed_bytes,
    marker_mean: np.ndarray,
    marker_std: np.ndarray,
    num_samples: int,
    sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
) -> np.ndarray:
    """(m, m) pairwise-complete Pearson correlations between markers.

    Equivalent of `bed_marker_corr_pearson` (`corr_kernels.cu:344-407`):
    r = (sum(g_a g_b)/n_joint - mean_a mean_b) / (std_a std_b) with sums over
    individuals where both genotypes are non-missing.
    """
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = min(sample_chunk, 4 * (((bed_bytes.shape[1] + 31) // 32) * 32))
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    s_gg, n_joint = _marker_pearson_sums(jnp.asarray(padded), n_chunks)
    s_gg, n_joint = np.asarray(s_gg), np.asarray(n_joint)
    mean = np.asarray(marker_mean, dtype=np.float32)
    std = np.asarray(marker_std, dtype=np.float32)
    corr = (s_gg / n_joint - mean[:, None] * mean[None, :]) / (
        std[:, None] * std[None, :]
    )
    np.fill_diagonal(corr, 1.0)
    return corr.astype(np.float32)


@partial(jax.jit, static_argnames=("n_chunks",))
def _marker_pearson_sums(bed_bytes, n_chunks: int):
    m, B = bed_bytes.shape
    chunk_bytes = B // n_chunks

    def step(carry, idx):
        s_gg, n_joint = carry
        rb = jax.lax.dynamic_slice(bed_bytes, (0, idx * chunk_bytes), (m, chunk_bytes))
        vals, valid = geno_value_valid(unpack_bed_codes(rb))
        gv = vals * valid
        s_gg = s_gg + jnp.dot(
            gv, gv.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        n_joint = n_joint + jnp.dot(
            valid, valid.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return (s_gg, n_joint), None

    init = (jnp.zeros((m, m), jnp.float32), jnp.zeros((m, m), jnp.float32))
    (s_gg, n_joint), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    return s_gg, n_joint
