"""Level-wise PC-stable skeleton search (cuPC-S equivalents).

Deterministic batched re-design of `Skeleton` (`cuPC-S.cu:61-450`) and
`hetcor_skeleton` (`hetcor-cuPC-S.cu:75-341`):

* level 0 is an elementwise Fisher-z screen of the whole correlation panel,
* each level l >= 1 compacts neighbour lists on the host, enumerates
  candidate conditioning sets in colex order (rank-independent of the node
  degree, see :mod:`cigwas_tpu.utils.combinatorics`) and streams large
  batches of fixed-size chunks through the device scan kernels
  (:func:`cigwas_tpu.ops.pcorr.level_scan_minrho`) — one dispatch covers
  many chunks,
* edge deletion is the reduction ``min |rho| over all candidate sets <
  tanh(Th[l])`` (monotonically equivalent to the reference's Fisher-z test);
  deletions apply between levels (PC-stable) exactly like the reference,
  where the per-level neighbour lists ``GPrime`` are frozen at level start,
* the separation set of a deleted ordered pair (X, Y) is the argmin-|rho|
  conditioning set found from X's side — deterministic, unlike the
  reference's atomicCAS first-writer-wins (`cuPC-S.cu:570-577`; the
  BASELINE parity target is adjacency-exact, sepsets valid up to
  tie-breaking).

A node stops enumerating when its candidate sets are exhausted or all of its
edges were already condemned this level (the analogue of the reference's
shared NoEdgeFlag early exit).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cigwas_tpu.constants import ML, PANEL_ALIGN, PMAX_RETAINED
from cigwas_tpu.ops import pcorr as pcorr_ops
from cigwas_tpu.utils.combinatorics import colex_combinations_chunk, colex_unrank
from cigwas_tpu.utils.stats import fisher_z

# Cost-model constants below (DENSE_L1_MAX, MAX_CHUNKS_PER_LAUNCH,
# ELEM_BUDGET, LOCAL_ELEM_BUDGET, MERGE_SLOT_BUDGET, DEV_RESIDENT_MAX and
# the L1 route gates) keep the values of the accelerator they were first
# tuned on; they are not yet derived on the H100 (ROADMAP 3.2). Every value
# changes only speed: the routes they choose between make identical
# decisions.

# combos per chunk (static kernel shape)
DEFAULT_CHUNK = 512
# largest panel for which level 1 runs as the dense v^3 masked sweep (one
# dispatch for LD-block sizes); above this the v^3 work dwarfs the
# ~sum(deg^2) neighbour-list enumeration, so level 1 goes through the same
# degree-bucketed path as levels >= 2 (identical tests and tie-breaking: the
# dense argmin and the lowest colex rank both prefer the smallest
# conditioning index). The gate sits above the largest supported
# --max-block-size
DENSE_L1_MAX = 16384
# max chunks fused into one device dispatch
MAX_CHUNKS_PER_LAUNCH = 256
# cap on (nodes x combos x neighbours x l) elements live per kernel call
ELEM_BUDGET = 1 << 26

# device-resident combo windows: identical (offset, shape) windows recur for
# every level of every block, so keep the uploaded arrays alive
_COMBOS_DEV_CACHE: dict = {}
_COMBOS_DEV_CACHE_MAX = 32


def _combos_seq_device(offset: int, chunk: int, n_chunks: int, l: int):
    key = (offset, chunk, n_chunks, l)
    hit = _COMBOS_DEV_CACHE.get(key)
    if hit is not None:
        return hit
    combos_np = colex_combinations_chunk(offset, chunk * n_chunks, l)
    dev = jnp.asarray(combos_np.reshape(n_chunks, chunk, l))
    if len(_COMBOS_DEV_CACHE) >= _COMBOS_DEV_CACHE_MAX:
        _COMBOS_DEV_CACHE.pop(next(iter(_COMBOS_DEV_CACHE)))
    _COMBOS_DEV_CACHE[key] = dev
    return dev


@dataclass
class SkeletonResult:
    G: np.ndarray  # (n, n) int32 adjacency
    sepset: np.ndarray | None  # (n, n, ML) int32, -1 padded
    pmax: np.ndarray | None  # (n, n) float32
    final_level: int


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _record_plan(stats, l: int, d_pad: int, nodes, node_tile: int, ct: int):
    """Note one local-sweep launch group in ``stats["level_detail"][l]
    ["plan"]`` as (d_pad, nodes, node_tile, ct): the launch shapes from
    which gathered bytes and the largest launch are computed."""
    if stats is not None:
        stats.setdefault("level_detail", {}).setdefault(l, {}).setdefault(
            "plan", []
        ).append((int(d_pad), int(len(nodes)), int(node_tile), int(ct)))


def _compact_neighbors(G: np.ndarray, nodes: np.ndarray, d_max: int):
    """Ascending neighbour indices per node, padded with 0 (`scan_compact`).

    O(edges) via row-major nonzero + slot scatter (an argsort of the full
    (nodes, n) mask costs O(n log n) per row and dominated the host side of
    every wave pass at large n).
    """
    rows = G[nodes].astype(bool)
    ri, ci = np.nonzero(rows)  # row-major -> cols ascending within each row
    deg = np.bincount(ri, minlength=len(nodes)).astype(np.int32)
    starts = np.cumsum(deg) - deg
    slot = np.arange(len(ri)) - np.repeat(starts, deg)
    nbrs = np.zeros((len(nodes), d_max), dtype=np.int32)
    ok = slot < d_max
    nbrs[ri[ok], slot[ok]] = ci[ok]
    return nbrs, deg


def _run_level_dense1_engine(C_dev, Gb: np.ndarray, rho_threshold: float, engine):
    """Level 1 via the mesh-sharded dense sweep (same tests/tie-breaking as
    `_run_level_dense1`; x-row slabs are sharded over the engine's mesh)."""
    rho_min, s_min = engine.level1_dense_minrho(C_dev, Gb.astype(bool))
    rho_min = np.asarray(rho_min)
    s_min = np.asarray(s_min)
    side = (rho_min < rho_threshold) & Gb.astype(bool)
    xs, ys = np.nonzero(side)
    return side | side.T, (xs, ys, s_min[xs, ys], rho_min[xs, ys])


def _run_level_dense1(C_dev, Gb: np.ndarray, rho_threshold: float):
    """Level 1 as one dense masked dispatch (no per-bucket round trips).

    Equivalent to the combinatorial path: candidates are exactly adj(x)\\{y}
    and the argmin breaks ties toward the smallest conditioning index, which
    is also the lowest colex rank of the neighbour-list enumeration. Only
    the int8 removal mask and the removed pairs' (s, |rho|) leave the device.

    Returns (removed, updates) with updates = (xs, ys, s_sel, rho_sel) for
    the ordered pairs condemned from x's side.
    """
    side, xs, ys, s_sel, rho_sel = pcorr_ops.level1_dense_screen(
        C_dev, Gb, rho_threshold
    )
    removed = side | side.T
    return removed, (xs, ys, s_sel, rho_sel)


# per-launch element budget for the dense local-panel sweeps: the biggest
# live tensor is (node_tile, ct, d, d) f32. Larger budgets mean fewer
# launches but (nt, ct, d, d) intermediates that no longer fit the fusion
# working set and round-trip through device memory. Env-overridable for
# measurements (ROADMAP 3.2).
LOCAL_ELEM_BUDGET = 1 << int(os.environ.get("CIGWAS_LOCAL_ELEM_BUDGET_LOG2", 26))
# merge a smaller degree bucket into the next one when upgrading its nodes'
# padded width costs fewer dense slots than this: the slot volume one
# launch's fixed cost is taken to be worth. The 2048-marker block collapses
# from ~14 launches per level to 1-3
MERGE_SLOT_BUDGET = 1 << 29
# levels routed through the dense local-panel recursion (`_run_level_local`)
# instead of the combinatorial chunk scan (`_run_level`); tests monkeypatch
# this to () to force-compare the two paths
LOCAL_LEVELS = (2, 3)
# largest panel routed through the device-resident level loop
# (`_run_levels_local_dev`): one dispatch per level and no host compaction,
# but one single-launch level-3 sweep at the level's global padded width,
# whose working set outgrows the fusion budget on larger panels, so those
# go through the bucketed host loop. Tests override via env or module
# attribute.
DEV_RESIDENT_MAX = int(os.environ.get("CIGWAS_DEV_RESIDENT_MAX", 1536))
# largest padded level-1 max degree for which level 1 ALWAYS runs as the
# neighbour-list local sweep (sum(deg^2) work); above it the bucketed
# cost model below decides (see _l1_route_local)
L1_LOCAL_MAX_WIDTH = int(os.environ.get("CIGWAS_L1_LOCAL_MAX_WIDTH", 128))
# slot-cost multiplier of the local route vs the dense sweep: a local
# sweep slot rides a per-node panel gather while a dense slot is one fused
# elementwise op, so local slots are charged this factor before comparing
# against vp^3. Conservative on purpose — mis-routing to dense costs a
# bounded v^3, mis-routing to local could pay per-node gathers for hubs.
L1_LOCAL_COST_RATIO = int(os.environ.get("CIGWAS_L1_LOCAL_COST_RATIO", 16))


def _l1_route_local(deg: np.ndarray, vp: int) -> bool:
    """True when level 1 should run as the degree-bucketed local sweep.

    A gate on the padded MAX degree alone would let one hub node above
    L1_LOCAL_MAX_WIDTH force the whole panel through the dense v^3 sweep.
    `_local_tile_plan` isolates hubs into their own narrow buckets, so the
    decision weighs the bucketed sum(d_pad^2) slot volume (charged the
    gather-feed factor L1_LOCAL_COST_RATIO) against the dense sweep's vp^3
    — a lone 4000-degree hub among ~100-degree nodes costs 1.6e7 extra
    local slots, not a 1.3e12-slot dense sweep.
    """
    dmax = int(deg.max()) if deg.size else 0
    if max(8, -(-dmax // 8) * 8) <= L1_LOCAL_MAX_WIDTH:
        return True
    active = deg >= 2
    if not active.any():
        return True
    d_pad = np.maximum(8, ((deg[active].astype(np.int64) + 7) // 8) * 8)
    local_slots = int((d_pad * d_pad).sum())
    return local_slots * L1_LOCAL_COST_RATIO < vp**3


def _local_tile_plan(deg_all: np.ndarray, active: np.ndarray, l: int):
    """Launch plan for the dense local-panel sweeps.

    Nodes are bucketed by padded degree (multiples of 8 — the sweep walls
    scale ~d^(l+1), so tight widths beat pow2 buckets), then small buckets
    are MERGED upward while the upgrade costs fewer dense slots than one
    launch is worth (`MERGE_SLOT_BUDGET`), and each group gets the largest
    node tile the element budget allows.

    Returns [(d_pad, nodes ascending, ct, node_tile), ...]. Results are
    d_pad-invariant: padded slots are masked out of every reduction, so
    merging buckets never changes outputs (the parity tests vs the
    combinatorial path run across many degrees).
    """
    buckets: dict = {}
    for x in active:
        d_pad = max(8, -(-int(deg_all[x]) // 8) * 8)
        buckets.setdefault(d_pad, []).append(int(x))

    groups: list = []
    pend_nodes: list = []
    pend_d = None
    for d in sorted(buckets):
        if pend_d is None:
            pend_nodes, pend_d = list(buckets[d]), d
            continue
        upgrade = len(pend_nodes) * (d ** (l + 1) - pend_d ** (l + 1))
        if upgrade <= MERGE_SLOT_BUDGET:
            pend_nodes.extend(buckets[d])
            pend_d = d
        else:
            groups.append((pend_d, pend_nodes))
            pend_nodes, pend_d = list(buckets[d]), d
    if pend_d is not None:
        groups.append((pend_d, pend_nodes))

    plan = []
    for d_pad, nodes in groups:
        cap = max(1, LOCAL_ELEM_BUDGET // (8 * d_pad * d_pad))
        if cap > 1:
            cap = 1 << (cap.bit_length() - 1)
        node_tile = min(_next_pow2(len(nodes)), cap)
        ct = 8
        for c in range(d_pad, 7, -8):
            if d_pad % c == 0 and node_tile * c * d_pad * d_pad <= LOCAL_ELEM_BUDGET:
                ct = c
                break
        plan.append(
            (d_pad, np.array(sorted(nodes), dtype=np.int32), ct, node_tile)
        )
    return plan


@partial(
    jax.jit, static_argnames=("l", "d_pad", "ct", "want_rho")
)
def _level_local_dev_step(C, Gd, rho_th, l: int, d_pad: int, ct: int,
                          want_rho: bool):
    """One whole skeleton level on device: compaction, local sweep, graph
    update — no host round trip besides the dispatch itself.

    Neighbour compaction is an ascending sort of masked indices (the
    device-side `scan_compact`, `cuPC-S.cu:6355-6432`); the sweep runs ALL
    nodes in one launch at the level's global padded width — the dynamic
    deg/t_hi caps inside `_pair_sweep` keep the work near the true-degree
    volume, so a single width costs only lane/sublane padding. Padded
    slots cannot remove edges (slot_ok) and nodes below degree l+1 have
    every conditioning set masked, so running them is exact.

    Returns (G_new, deg_new, side (n, d_pad) bool, nbrs, sep_vars
    (n, d_pad, l), rho_min or None).
    """
    n = Gd.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    keys = jnp.where(Gd, iota[None, :], jnp.int32(n))
    nbrs = jnp.sort(keys, axis=1)[:, :d_pad]
    nbrs = jnp.where(nbrs >= n, 0, nbrs)  # pad slots -> 0 (masked via deg)
    deg = jnp.sum(Gd, axis=1, dtype=jnp.int32)
    C_x = C[nbrs[:, :, None], nbrs[:, None, :]]
    c_row = C[iota[:, None], nbrs]
    if l == 1:
        rho_min, pos = pcorr_ops.level1_local_sweep_pre(C_x, c_row, deg)
        pos = pos[..., None]
    elif l == 2:
        rho_min, pos = pcorr_ops.level2_local_sweep_pre(C_x, c_row, deg, ct=ct)
    else:
        rho_min, pos = pcorr_ops.level3_local_sweep_pre(C_x, c_row, deg, ct=ct)
    slot_ok = jnp.arange(d_pad)[None, :] < deg[:, None]
    side = (rho_min < rho_th) & slot_ok
    rows = jnp.broadcast_to(iota[:, None], (n, d_pad))
    side_full = jnp.zeros((n, n), bool).at[rows, nbrs].max(side)
    removed = side_full | side_full.T
    G_new = Gd & ~removed
    sep_vars = jnp.take_along_axis(
        nbrs[:, None, :], pos.reshape(n, 1, d_pad * l), axis=2
    ).reshape(n, d_pad, l)
    return (
        G_new,
        jnp.sum(G_new, axis=1, dtype=jnp.int32),
        side,
        nbrs,
        sep_vars,
        rho_min if want_rho else None,
    )


def _run_levels_local_dev(
    C_dev,
    G0_dev,
    deg0: np.ndarray,
    th: np.ndarray,
    lmax: int,
    sepset: np.ndarray,
    pmax: np.ndarray | None,
    verbose: bool,
    stats: dict | None,
):
    """Device-resident levels 1..lmax (<= 3) of the standard skeleton.

    The adjacency stays on device between levels — per level the host
    issues ONE dispatch and fetches only the new degree vector (stop
    condition + next level's static width); the per-slot removal masks and
    minimizing conditioning sets are fetched asynchronously and folded
    into `sepset`/`pmax` after each level. This removes the per-level
    neighbour-list uploads and host compaction of the bucketed host loop.

    Returns (G_host, final_level, stopped).
    """
    n = int(G0_dev.shape[0])
    Gd = G0_dev
    deg = deg0
    final_level, stopped = 0, False
    for l in range(1, lmax + 1):
        nprime = int(deg.max()) if n else 0
        if nprime - 1 < l:
            return _final_fetch(Gd, stats), l - 1, True
        if verbose:
            print(f"[skeleton] level {l}: max degree {nprime} (device loop)")
        t_level = time.perf_counter() if stats is not None else 0.0
        d_pad = max(8, -(-nprime // 8) * 8)
        ct = 8
        for c in range(d_pad, 7, -8):
            if d_pad % c == 0 and n * c * d_pad * d_pad <= LOCAL_ELEM_BUDGET:
                ct = c
                break
        if stats is not None and l >= 2:
            stats["ci_tests"] = stats.get("ci_tests", 0) + int(
                sum(math.comb(int(dx), l) * int(dx) for dx in deg if dx >= l + 1)
            )
        Gd, deg_dev, side_dev, nbrs_dev, sep_dev, rho_dev = _level_local_dev_step(
            C_dev, Gd, jnp.float32(np.tanh(float(th[l]))), l, d_pad, ct,
            pmax is not None,
        )
        for a in (side_dev, nbrs_dev, sep_dev) + (
            (rho_dev,) if rho_dev is not None else ()
        ):
            a.copy_to_host_async()
        deg = np.asarray(deg_dev)
        side = np.asarray(side_dev)
        nbrs = np.asarray(nbrs_dev)
        sep_vars = np.asarray(sep_dev)
        xs, ys_slot = np.nonzero(side)
        if len(xs):
            ys = nbrs[xs, ys_slot]
            sepset[xs, ys, l:] = -1
            sepset[xs, ys, :l] = sep_vars[xs, ys_slot]
            if pmax is not None:
                pmax[xs, ys] = fisher_z(np.asarray(rho_dev)[xs, ys_slot])
        if stats is not None:
            stats.setdefault("level_wall_s", {})[l] = (
                time.perf_counter() - t_level
            )
        final_level = l
    return _final_fetch(Gd, stats), final_level, False


def _final_fetch(Gd, stats: dict | None) -> np.ndarray:
    t_mark = time.perf_counter() if stats is not None else 0.0
    G = _fetch_bool_packed(Gd)
    if stats is not None:
        stats["final_fetch_s"] = time.perf_counter() - t_mark
    return G


def _fetch_bool_packed(Gd) -> np.ndarray:
    """Fetch a device (n, n) bool adjacency as packed bits (8x fewer
    device-to-host bytes; kept from the earlier host link, unmeasured on
    the H100's PCIe link, ROADMAP 1.7)."""
    n = int(Gd.shape[0])
    packed = np.asarray(jnp.packbits(Gd, axis=1))
    return np.unpackbits(packed, axis=1, count=n).astype(bool)


def _run_level_local1(
    C_dev,
    G: np.ndarray,
    rho_threshold: float,
    verbose: bool = False,
    want_rho: bool = True,
    stats: dict | None = None,
):
    """Level 1 via the neighbour-list local sweep (lanes layout).

    Same candidate set and tie-breaking as `_run_level_dense1`, at
    sum(deg^2) cost instead of v^3 — the winning route whenever the level-1
    max degree is small against the panel (the caller gates on it). Returns
    (removed, (xs, ys, s_sel, rho_sel)) in the dense route's format
    (rho_sel None when want_rho=False — the production want_pmax=False
    path, which then rides the lean hit-bits fetch).
    """
    t_mark = time.perf_counter()

    def mark(name, amt=None):
        nonlocal t_mark
        if stats is not None:
            det = stats.setdefault("level_detail", {}).setdefault(1, {})
            if amt is not None:
                det[name] = det.get(name, 0) + amt
            else:
                now = time.perf_counter()
                det[name] = det.get(name, 0.0) + (now - t_mark)
                t_mark = now

    n = G.shape[0]
    Gb = G.astype(bool)
    deg_all = Gb.sum(axis=1)
    active = np.where(deg_all >= 2)[0]
    # SPARSE accumulation: dense (n, n) rho/sep scratch would cost host
    # memset/scan of O(n^2) per level; only the sub-threshold pairs ever
    # leave a launch
    xs_l: list = []
    ys_l: list = []
    s_l: list = []
    rho_l: list = []
    if active.size:
        pending = []
        for d_pad, nodes, ct, node_tile in _local_tile_plan(deg_all, active, 1):
            _record_plan(stats, 1, d_pad, nodes, node_tile, ct)
            for s0 in range(0, len(nodes), node_tile):
                tile = nodes[s0 : s0 + node_tile]
                pad = node_tile - len(tile)
                tile_p = (
                    np.concatenate([tile, np.full(pad, tile[-1], np.int32)])
                    if pad
                    else tile
                )
                nbrs, deg = _compact_neighbors(Gb, tile_p, d_pad)
                rho_dev, pos_dev = pcorr_ops.level1_local_sweep(
                    C_dev, jnp.asarray(tile_p), jnp.asarray(nbrs),
                    jnp.asarray(deg),
                )
                pending.append((tile, nbrs, deg, rho_dev, pos_dev))
        mark("dispatch")
        mark("launches", len(pending))
        for _, _, _, rho_dev, pos_dev in pending:
            rho_dev.copy_to_host_async()
            pos_dev.copy_to_host_async()
        _first = True
        for tile, nbrs, deg, rho_dev, pos_dev in pending:
            nt_real = len(tile)
            d_pad = nbrs.shape[1]
            valid = np.arange(d_pad)[None, :] < deg[:nt_real, None]
            rho_c = np.asarray(rho_dev)
            pos_c = np.asarray(pos_dev)
            hit = valid & (rho_c[:nt_real] < np.float32(rho_threshold))
            if _first:
                mark("device_wait")
                _first = False
            ri, ci = np.nonzero(hit)
            xs_l.append(tile[ri])
            ys_l.append(nbrs[ri, ci])
            s_l.append(nbrs[ri, pos_c[ri, ci]])
            if want_rho:
                rho_l.append(rho_c[ri, ci])
        mark("fetch_scatter")
        if verbose:
            print(f"[level 1] local-sweep launches: {len(pending)}")
    xs = np.concatenate(xs_l) if xs_l else np.empty(0, np.int64)
    ys = np.concatenate(ys_l) if ys_l else np.empty(0, np.int64)
    removed = np.zeros((n, n), dtype=bool)
    # symmetric removal via two O(k) scatters (a transpose-OR walks the
    # whole (n, n) matrix with strided reads — ~1 s at the 11k block)
    removed[xs, ys] = True
    removed[ys, xs] = True
    return removed, (
        xs, ys,
        np.concatenate(s_l) if s_l else np.empty(0, np.int32),
        (np.concatenate(rho_l) if rho_l else np.empty(0, np.float32))
        if want_rho else None,
    )


def _pack_hits_pos(rho, pos, rho_th):
    """want_pmax=False fetch: (hit bits (nt, ceil(d/8)) u8, positions
    (nt, d[, l]) u8). rho never leaves the device (nothing consumes it
    without pmax) and positions are neighbour-list SLOTS < d <= 256, so
    the fetch shrinks ~5x (kept from the earlier host link; unmeasured on
    the H100's PCIe link, ROADMAP 1.7)."""
    if pos.ndim == 2:
        pos = pos[:, :, None]
    hit = jnp.packbits(rho < rho_th, axis=1)
    return hit, pos.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("l", "ct"))
def _sweep_hits_xla(C, node_ixs, nbrs, deg, rho_th, l: int, ct: int):
    """XLA-gather local sweep with the lean (hit bits + uint8 positions)
    fetch — the same dispatch as the plain sweep, 5x fewer fetch bytes
    (see _pack_hits_pos)."""
    sweep = {
        2: pcorr_ops.level2_local_sweep,
        3: pcorr_ops.level3_local_sweep,
    }[l]
    rho, pos = sweep(C, node_ixs, nbrs, deg, ct)
    return _pack_hits_pos(rho, pos, rho_th)


def _run_level_local(
    C_dev,
    G: np.ndarray,
    l: int,
    rho_threshold: float,
    verbose: bool = False,
    engine=None,
    stats: dict | None = None,
    want_rho: bool = True,
):
    """Levels 2/3 via the dense local-panel recursion.

    One launch per (degree-bucket, node-tile) covers ALL C(deg, l)
    conditioning sets — no combination chunk streaming, no one-hot selection
    matmuls; each test costs O(1) fused VPU ops
    (:func:`cigwas_tpu.ops.pcorr.level2_local_sweep` /
    :func:`level3_local_sweep`). Same test set and colex tie-breaking as the
    combinatorial path.

    Returns (removed, (xs, ys, rho_sel, sep_sel)) where the update arrays
    cover exactly the ordered pairs condemned from x's side: rho_sel the
    minimizing |rho|, sep_sel (k, l) the minimizing conditioning VARIABLE
    indices (ascending). Sparse on purpose: dense (n, n[, l]) scratch would
    cost host memset/scan of O(n^2 l) per level.
    """
    assert l in (2, 3)
    t_mark = time.perf_counter()

    def mark(name):
        nonlocal t_mark
        if stats is not None:
            now = time.perf_counter()
            det = stats.setdefault("level_detail", {}).setdefault(l, {})
            det[name] = det.get(name, 0.0) + (now - t_mark)
            t_mark = now

    n = G.shape[0]
    Gb = G.astype(bool)
    deg_all = Gb.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    removed = np.zeros((n, n), dtype=bool)
    empty = (
        np.empty(0, np.int64), np.empty(0, np.int64),
        np.empty(0, np.float32), np.empty((0, l), np.int32),
    )
    mark("host_alloc")
    if active.size == 0:
        return removed, empty

    sweep = {2: pcorr_ops.level2_local_sweep, 3: pcorr_ops.level3_local_sweep}[l]
    if engine is not None:
        sweep = {2: engine.level2_local_sweep, 3: engine.level3_local_sweep}[l]

    pending = []
    for d_pad, nodes, ct, node_tile in _local_tile_plan(deg_all, active, l):
        if engine is not None:
            # BYTE-IDENTITY INVARIANT: XLA's fused elementwise numerics for
            # the local sweeps depend on the batch (node-tile) shape, so the
            # per-DEVICE shard shape must equal the single-device launch
            # shape — each device runs a full `node_tile`-sized tile and a
            # launch covers ndev tiles. (Verified: shard_map local shape S
            # is bit-equal to a plain jit at shape S; shapes S != S' are
            # not bit-equal to each other.)
            node_tile = node_tile * engine.ndev
        _record_plan(stats, l, d_pad, nodes, node_tile, ct)
        if stats is not None:
            stats["ci_tests"] = stats.get("ci_tests", 0) + int(
                sum(
                    math.comb(int(deg_all[x]), l) * int(deg_all[x])
                    for x in nodes
                )
            )
        for s0 in range(0, len(nodes), node_tile):
            tile = nodes[s0 : s0 + node_tile]
            pad = node_tile - len(tile)
            tile_p = (
                np.concatenate([tile, np.full(pad, tile[-1], np.int32)])
                if pad
                else tile
            )
            nbrs, deg = _compact_neighbors(Gb, tile_p, d_pad)
            # the lean hit-bits fetch packs neighbour-list SLOTS into
            # uint8, so it is only valid for d_pad <= 256; wider buckets
            # take the full rho fetch
            if not want_rho and engine is None and d_pad <= 256:
                got = _sweep_hits_xla(
                    C_dev, jnp.asarray(tile_p), jnp.asarray(nbrs),
                    jnp.asarray(deg), jnp.float32(rho_threshold), l, ct,
                )
                pending.append((tile, nbrs, deg, got, None))
            else:
                rho_dev, pos_dev = sweep(
                    C_dev, jnp.asarray(tile_p), jnp.asarray(nbrs),
                    jnp.asarray(deg), ct,
                )
                pending.append((tile, nbrs, deg, rho_dev, pos_dev))
    mark("dispatch")
    if stats is not None:
        det = stats.setdefault("level_detail", {}).setdefault(l, {})
        det["launches"] = det.get("launches", 0) + len(pending)

    for _, _, _, rho_dev, pos_dev in pending:
        if isinstance(rho_dev, tuple):
            for h in rho_dev:
                h.copy_to_host_async()
        else:
            rho_dev.copy_to_host_async()
        if pos_dev is not None:
            pos_dev.copy_to_host_async()
    first = True
    xs_l, ys_l, rho_l, sep_l = [], [], [], []
    for tile, nbrs, deg, rho_dev, pos_dev in pending:
        nt_real = len(tile)
        d_pad = nbrs.shape[1]
        if isinstance(rho_dev, tuple):  # lean want_pmax=False fetch
            hit_bits, pos_u8 = rho_dev
            hit = np.unpackbits(
                np.asarray(hit_bits), axis=1, count=d_pad
            ).astype(bool)[:nt_real]
            pos_c = np.asarray(pos_u8).astype(np.int32)
            rho_c = None
        else:
            rho_c = np.asarray(rho_dev)
            pos_c = np.asarray(pos_dev)
        if first:
            # the first fetch absorbs ALL in-flight device compute
            mark("device_wait")
            first = False
        valid = np.arange(d_pad)[None, :] < deg[:nt_real, None]
        if rho_c is None:
            hit = valid & hit
        else:
            hit = valid & (rho_c[:nt_real] < np.float32(rho_threshold))
        ri, ci = np.nonzero(hit)
        xs_l.append(tile[ri])
        ys_l.append(nbrs[ri, ci])
        if rho_c is not None:
            rho_l.append(rho_c[ri, ci])
        # positions -> variable indices via each node's neighbour list
        sep_l.append(nbrs[ri[:, None], pos_c[ri, ci]])
    mark("fetch_scatter")
    if verbose:
        print(f"[level {l}] local-sweep launches: {len(pending)}")
    xs = np.concatenate(xs_l) if xs_l else empty[0]
    ys = np.concatenate(ys_l) if ys_l else empty[1]
    # symmetric removal via two O(k) scatters (see _run_level_local1)
    removed[xs, ys] = True
    removed[ys, xs] = True
    mark("epilogue")
    return removed, (
        xs, ys,
        (np.concatenate(rho_l) if rho_l else empty[2]) if want_rho else None,
        np.concatenate(sep_l) if sep_l else empty[3],
    )


@partial(jax.jit, donate_argnums=(0,))
def _hetcor_scatter_bits(acc, tile, nbrs, bits, deg):
    """Scatter one launch's removal hit-bits into the device-resident
    (n, n) condition mask: per-launch HOST fetches would serialize on each
    launch's device completion, so hetcor levels accumulate on device and
    fetch ONE packed mask at the end."""
    d = nbrs.shape[1]
    hit = jnp.unpackbits(bits, axis=1, count=d).astype(bool)
    valid = jnp.arange(d)[None, :] < deg[:, None]
    return acc.at[tile[:, None], nbrs].max(hit & valid)


@jax.jit
def _packbits_rows(acc):
    return jnp.packbits(acc, axis=1)


def _run_level_local_hetcor1(
    C_dev,
    N_dev,
    t_dev,
    G: np.ndarray,
    th: float,
    verbose: bool = False,
    stats: dict | None = None,
):
    """Hetcor level 1 via the neighbour-list local sweep (bucketed tiles).

    Same candidate set, margins and removal decisions as the dense route
    (`hetcor1_dense_margin` — the kernels mirror each other op for op), at
    sum(deg^2) cost instead of v^3: the dense sweep's per-slot tanh makes
    it the dominant level-1 wall at summary-stat panel sizes.
    """
    t_mark = time.perf_counter()

    def mark(name):
        nonlocal t_mark
        if stats is not None:
            now = time.perf_counter()
            det = stats.setdefault("level_detail", {}).setdefault(1, {})
            det[name] = det.get(name, 0.0) + (now - t_mark)
            t_mark = now

    n = G.shape[0]
    Gb = G.astype(bool)
    deg_all = Gb.sum(axis=1)
    active = np.where(deg_all >= 2)[0]
    removed = np.zeros((n, n), dtype=bool)
    if active.size == 0:
        return removed
    cond = np.zeros((n, n), dtype=bool)
    mark("host_alloc")
    acc = None
    n_launch = 0
    for d_pad, nodes, ct, node_tile in _local_tile_plan(deg_all, active, 1):
        _record_plan(stats, 1, d_pad, nodes, node_tile, ct)
        for s0 in range(0, len(nodes), node_tile):
            tile = nodes[s0 : s0 + node_tile]
            pad = node_tile - len(tile)
            tile_p = (
                np.concatenate([tile, np.full(pad, tile[-1], np.int32)])
                if pad
                else tile
            )
            nbrs, deg = _compact_neighbors(Gb, tile_p, d_pad)
            m_dev = pcorr_ops.hetcor1_local_sweep_bits(
                C_dev, N_dev, t_dev, jnp.asarray(tile_p),
                jnp.asarray(nbrs), jnp.asarray(deg), jnp.float32(th),
            )
            # device-side accumulation: launches pipeline on the device
            # without per-launch host fetches (see _hetcor_scatter_bits)
            if acc is None:
                acc = jnp.zeros((n, n), jnp.bool_)
            acc = _hetcor_scatter_bits(
                acc, jnp.asarray(tile_p), jnp.asarray(nbrs), m_dev,
                jnp.asarray(deg),
            )
            n_launch += 1
    mark("dispatch")
    if acc is not None:
        packed = np.asarray(_packbits_rows(acc))
        mark("device_wait")
        cond = np.unpackbits(packed, axis=1, count=n).astype(bool)
    mark("fetch_scatter")
    if stats is not None:
        stats.setdefault("level_detail", {}).setdefault(1, {})["launches"] = (
            n_launch
        )
    if verbose:
        print(f"[hetcor level 1] local-sweep launches: {n_launch}")
    cond &= Gb
    return cond | cond.T


def _run_level_local_hetcor(
    C_dev,
    N_dev,
    t_dev,
    G: np.ndarray,
    l: int,
    th: float,
    verbose: bool = False,
    engine=None,
    stats: dict | None = None,
):
    """Hetcor levels 2/3 via the dense local-panel recursion: min margin
    over ALL conditioning sets per (x, y), per-test mean-ESS thresholds and
    time constraints included (same tests as the `level_scan_hetcor`
    enumeration; hetcor keeps no sepsets, so no positions are tracked).

    Returns the symmetric removal mask (margin < 0 from either side).
    """
    assert l in (2, 3)
    n = G.shape[0]
    Gb = G.astype(bool)
    deg_all = Gb.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    removed = np.zeros((n, n), dtype=bool)
    if active.size == 0:
        return removed

    sweep_bits = {
        2: pcorr_ops.hetcor2_local_sweep_bits,
        3: pcorr_ops.hetcor3_local_sweep_bits,
    }[l]
    if engine is not None:
        sweep = {
            2: engine.hetcor2_local_sweep,
            3: engine.hetcor3_local_sweep,
        }[l]
    if stats is not None:
        stats["ci_tests"] = stats.get("ci_tests", 0) + int(
            sum(
                math.comb(int(deg_all[x]), l) * int(deg_all[x])
                for x in active
            )
        )

    # bits fetch on the single-device route (only the margin sign is
    # consumed); the sharded engines keep their margin kernels
    cond = np.zeros((n, n), dtype=bool)
    margin_full = (
        np.full((n, n), np.inf, dtype=np.float32)
        if engine is not None else None
    )
    pending = []
    acc = None
    n_launch = 0
    for d_pad, nodes, ct, node_tile in _local_tile_plan(deg_all, active, l):
        if engine is not None:
            # per-DEVICE shard shape == single-device launch shape (see
            # _run_level_local)
            node_tile = node_tile * engine.ndev
        _record_plan(stats, l, d_pad, nodes, node_tile, ct)
        for s0 in range(0, len(nodes), node_tile):
            tile = nodes[s0 : s0 + node_tile]
            pad = node_tile - len(tile)
            tile_p = (
                np.concatenate([tile, np.full(pad, tile[-1], np.int32)])
                if pad
                else tile
            )
            nbrs, deg = _compact_neighbors(Gb, tile_p, d_pad)
            if engine is not None:
                m_dev = sweep(
                    C_dev, N_dev, t_dev, jnp.asarray(tile_p),
                    jnp.asarray(nbrs), jnp.asarray(deg), float(th), ct,
                )
                pending.append((tile, nbrs, deg, m_dev))
                continue
            m_dev = sweep_bits(
                C_dev, N_dev, t_dev, jnp.asarray(tile_p),
                jnp.asarray(nbrs), jnp.asarray(deg),
                jnp.float32(th), ct,
            )
            # device-side accumulation (see _hetcor_scatter_bits)
            if acc is None:
                acc = jnp.zeros((n, n), jnp.bool_)
            acc = _hetcor_scatter_bits(
                acc, jnp.asarray(tile_p), jnp.asarray(nbrs), m_dev,
                jnp.asarray(deg),
            )
            n_launch += 1

    if acc is not None:
        packed = np.asarray(_packbits_rows(acc))
        cond = np.unpackbits(packed, axis=1, count=n).astype(bool)
    for _, _, _, m_dev in pending:
        m_dev.copy_to_host_async()
    for tile, nbrs, deg, m_dev in pending:
        m_c = np.asarray(m_dev)
        nt_real = len(tile)
        d_pad = nbrs.shape[1]
        valid = np.arange(d_pad)[None, :] < deg[:nt_real, None]
        ri, ci = np.nonzero(valid)
        margin_full[tile[ri], nbrs[ri, ci]] = m_c[ri, ci]
    if verbose:
        print(
            f"[hetcor level {l}] local-sweep launches: "
            f"{n_launch + len(pending)}"
        )
    if margin_full is not None:
        cond |= (margin_full < 0) & Gb
    cond &= Gb
    return cond | cond.T


def _run_level(
    C_dev,
    G: np.ndarray,
    l: int,
    rho_threshold: float | None,
    chunk: int,
    hetcor_args=None,
    verbose: bool = False,
    engine=None,
    stats: dict | None = None,
):
    """All level-l tests; returns (removed, rho_min_full, rank_full).

    rho_threshold: tanh(Th[l]) for the plain skeleton; None for hetcor
    (where the kernel returns margins and removal is margin < 0).

    stats, if given, accumulates ``ci_tests`` — the exact number of
    (x, S, y) partial-correlation evaluations enumerated on device
    (each conditioning set S of node x is tested against all deg(x)
    neighbours y in one kernel row).
    """
    n = G.shape[0]
    Gb = G.astype(bool)
    deg_all = Gb.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    removed = np.zeros((n, n), dtype=bool)
    if active.size == 0:
        return removed, None, None

    stat_full = np.full((n, n), np.inf, dtype=np.float32)
    total_combos = {int(x): math.comb(int(deg_all[x]), l) for x in active}
    # colex ranks are exact Python bignums only when they can overflow
    # int64 (object arrays cost ~0.5s/level at n~2k otherwise)
    rank_dtype = (
        object if max(total_combos.values(), default=0) > (1 << 62) else np.int64
    )
    rank_full = np.zeros((n, n), dtype=rank_dtype)

    def removed_now():
        if hetcor_args is None:
            cond = stat_full < rho_threshold
        else:
            cond = stat_full < 0
        cond = cond & Gb
        return cond | cond.T

    # bucket active nodes by power-of-two degree: without this, every node
    # pays the busiest node's C(d_max, l) candidate count and d_max padding
    # (the reference handles the imbalance with per-node grid rows,
    # `cuPC-S.h:21-49`)
    buckets: dict = {}
    for x in active:
        d_pad = _next_pow2(max(int(deg_all[x]), 8))
        buckets.setdefault(d_pad, []).append(int(x))

    # wave-structured dispatch: every launch of a pass (across all degree
    # buckets) is dispatched asynchronously BEFORE any result is fetched, so
    # the host waits on the device once per pass instead of once per launch
    removed = np.zeros((n, n), dtype=bool)
    n_launches = 0
    work = [(d_pad, buckets[d_pad], 0) for d_pad in sorted(buckets)]
    while work:
        pending = []
        next_work = []
        for d_pad, remaining, offset in work:
            nodes = np.array(remaining, dtype=np.int32)
            per_node_elems = chunk * d_pad * max(l, 1)
            node_tile = max(1, min(len(nodes), ELEM_BUDGET // per_node_elems))
            if node_tile > 8:  # floor to a power of two to bound shapes
                node_tile = 1 << (node_tile.bit_length() - 1)
            node_tile = min(node_tile, _next_pow2(len(nodes)))
            if engine is not None:
                # node tiles are sharded over the mesh axis: the tile length
                # must divide evenly (shards pad with repeats of the last
                # node, whose duplicate results are min-merged idempotently)
                nd = engine.ndev
                node_tile = max(node_tile, nd)
                if node_tile % nd:
                    node_tile = -(-node_tile // nd) * nd

            max_left = max(total_combos[x] - offset for x in remaining)
            n_chunks = min(
                MAX_CHUNKS_PER_LAUNCH, max(1, -(-min(max_left, 1 << 30) // chunk))
            )
            # round the scan length up to a power of two: every distinct
            # length is a separate XLA compile; excess chunks are masked
            # via left_seq
            n_chunks = _next_pow2(n_chunks)
            combos_seq = _combos_seq_device(offset, chunk, n_chunks, l)

            for s0 in range(0, len(nodes), node_tile):
                tile = nodes[s0 : s0 + node_tile]
                pad = node_tile - len(tile)
                tile_p = (
                    np.concatenate([tile, np.full(pad, tile[-1], np.int32)])
                    if pad
                    else tile
                )
                nbrs, deg = _compact_neighbors(Gb, tile_p, d_pad)
                totals = np.array(
                    [
                        min(total_combos.get(int(x), 0) - offset, chunk * n_chunks)
                        for x in tile_p
                    ],
                    dtype=np.int64,
                )
                if stats is not None:
                    live = totals[: len(tile)].clip(min=0)
                    stats["ci_tests"] = stats.get("ci_tests", 0) + int(
                        (live * deg[: len(tile)].astype(np.int64)).sum()
                    )
                bases = chunk * np.arange(n_chunks, dtype=np.int64)[:, None]
                left_seq = np.clip(totals[None, :] - bases, 0, chunk).astype(np.int32)
                if pad:
                    left_seq[:, -pad:] = 0
                scan_minrho = (
                    engine.level_scan_minrho if engine is not None
                    else pcorr_ops.level_scan_minrho
                )
                scan_hetcor = (
                    engine.level_scan_hetcor if engine is not None
                    else pcorr_ops.level_scan_hetcor
                )
                if hetcor_args is None:
                    rho_dev, rank_dev = scan_minrho(
                        C_dev,
                        jnp.asarray(tile_p),
                        jnp.asarray(nbrs),
                        jnp.asarray(deg),
                        combos_seq,
                        jnp.asarray(left_seq),
                        l,
                    )
                else:
                    N_dev, t_dev, th = hetcor_args
                    rho_dev = scan_hetcor(
                        C_dev,
                        N_dev,
                        t_dev,
                        jnp.asarray(tile_p),
                        jnp.asarray(nbrs),
                        jnp.asarray(deg),
                        combos_seq,
                        jnp.asarray(left_seq),
                        jnp.float32(th),
                        l,
                    )
                    rank_dev = None
                pending.append((tile, nbrs, deg, offset, rho_dev, rank_dev))
                n_launches += 1
            next_work.append((d_pad, remaining, offset + chunk * n_chunks))

        # start all host copies before the first blocking read: one
        # round-trip latency per wave instead of one per launch
        for _, _, _, _, rho_dev, rank_dev in pending:
            rho_dev.copy_to_host_async()
            if rank_dev is not None:
                rank_dev.copy_to_host_async()
        for tile, nbrs, deg, offset, rho_dev, rank_dev in pending:
            rho_c = np.asarray(rho_dev)
            if rank_dev is not None:
                # launch-local ranks -> exact global colex ranks
                rank_c = np.asarray(rank_dev).astype(rank_dtype) + offset
            else:
                rank_c = np.zeros_like(rho_c, dtype=rank_dtype)
            # scatter the launch minima; each (x, y) appears at most
            # once per launch, so a flat masked update is safe
            nt_real = len(tile)
            d_pad = nbrs.shape[1]
            valid = np.arange(d_pad)[None, :] < deg[:nt_real, None]
            x_idx = np.repeat(tile, d_pad).reshape(nt_real, d_pad)[valid]
            y_idx = nbrs[:nt_real][valid]
            vals = rho_c[:nt_real][valid]
            ranks = rank_c[:nt_real][valid]
            better = vals < stat_full[x_idx, y_idx]
            stat_full[x_idx[better], y_idx[better]] = vals[better]
            rank_full[x_idx[better], y_idx[better]] = ranks[better]

        removed = removed_now()
        # prune finished nodes: combos exhausted, or all edges condemned
        live_edge = Gb & ~removed
        work = []
        for d_pad, remaining, offset in next_work:
            nodes = np.array(remaining, dtype=np.int64)
            unfinished = np.array([total_combos[x] > offset for x in remaining])
            alive = live_edge[nodes].any(axis=1)
            nxt = [x for x, k in zip(remaining, unfinished & alive) if k]
            if nxt:
                work.append((d_pad, nxt, offset))

    if verbose:
        print(f"[level {l}] device launches: {n_launches}")
    if hetcor_args is None:
        cond = (stat_full < rho_threshold) & Gb
    else:
        cond = (stat_full < 0) & Gb
    removed = cond | cond.T
    return removed, stat_full, rank_full


def skeleton(
    C: np.ndarray,
    thresholds: np.ndarray,
    max_level: int,
    chunk: int = DEFAULT_CHUNK,
    verbose: bool = False,
    C_dev=None,
    n_var: int | None = None,
    engine=None,
    stats: dict | None = None,
    want_pmax: bool = True,
    scratch: dict | None = None,
) -> SkeletonResult:
    """PC-stable skeleton over a dense correlation panel.

    Equivalent of `Skeleton` (`cuPC-S.cu:61-450`). Note the reference's
    level-0 kernel *overwrites* the adjacency from the correlations
    (`cal_Indepl0`, `cuPC-S.cu:458-484`), so no initial G is accepted here.

    stats, if given, collects instrumentation equivalent to the reference's
    per-level cudaEvent prints (`cuPC-S.cu:80-83,130-134`):
    ``level_wall_s`` maps level -> seconds, ``ci_tests`` counts the exact
    (x, S, y) evaluations enumerated by levels >= 2.

    C may be a jax device array (e.g. from
    :func:`cigwas_tpu.ops.corr.corr_panel_device`), in which case it is
    reused in place instead of being re-uploaded.

    engine: a :class:`cigwas_tpu.parallel.sharded.ShardedEngine` runs every
    level kernel SPMD over its mesh (node tiles / row slabs sharded, panel
    replicated); results are byte-identical to the single-device path.

    want_pmax=False skips every pMax computation and, when the panel lives
    on device, the host fetch of C it would require (returning pmax=None).
    The cusk pipeline never consumes pMax (the reference writes it only
    from its test harness), and the ~0.5 GB panel fetch of an 11k block is
    pure overhead.
    """
    if C_dev is None and isinstance(C, jax.Array):
        C_dev = C
    # pad the panel to the shape bucket; padded variables have corr 0 with
    # everything, so level 0 isolates them and they never re-enter. n_var
    # marks an input that is ALREADY padded (corr_panel_device) whose
    # logical size is n_var.
    v_real = n_var if n_var is not None else C.shape[0]
    pad = C.shape[0] - v_real
    if pad == 0 and C_dev is not None and C_dev.shape[0] > v_real:
        # adopt the device panel's own (inert) padding, whatever its size
        # (sharded panels align marker rows to the mesh as well as the
        # shape bucket)
        pad = C_dev.shape[0] - v_real
        if isinstance(C, jax.Array):
            C = C_dev
        else:
            C = np.pad(np.asarray(C, dtype=np.float32), ((0, pad), (0, pad)))
    elif pad == 0:
        pad = (-v_real) % PANEL_ALIGN
        if pad:
            if C_dev is not None and C_dev.shape[0] == v_real:
                C_dev = jnp.pad(C_dev, ((0, pad), (0, pad)))
            if isinstance(C, jax.Array):
                C = C_dev
            else:
                C = np.pad(np.asarray(C, dtype=np.float32), ((0, pad), (0, pad)))
    th = np.asarray(thresholds, dtype=np.float32)
    _t_enter = time.perf_counter()
    pre_l1 = None
    G0_dev = None
    if C_dev is not None and engine is None:
        # device-first flow: level-0 decisions on device, and the dense
        # level-1 sweep is dispatched BEFORE the big C fetch so the
        # transfer overlaps the kernel. Decisions (G) always come from the
        # device so later levels see a consistent graph.
        t_mark = time.perf_counter() if stats is not None else 0.0
        G0_dev = pcorr_ops.level0_screen(C_dev, jnp.float32(th[0]))
        G = _fetch_bool_packed(G0_dev)
        if stats is not None:
            # includes waiting out any in-flight async corr-panel compute
            # the caller dispatched: the first sync pays for it here
            stats["l0_wall_s"] = time.perf_counter() - t_mark
        # level-1 routing needs the post-level-0 degrees: the bucketed
        # local sweep costs ~sum(deg_pad^2) vs the dense sweep's v^3 (see
        # _l1_route_local). The dense sweep is only dispatched when it
        # will actually be used
        t_mark = time.perf_counter() if stats is not None else 0.0
        l1_local = _l1_route_local(G.sum(axis=1), int(C_dev.shape[0]))
        if (
            min(ML, max_level) >= 1
            and C_dev.shape[0] <= DENSE_L1_MAX
            and not l1_local
        ):
            pre_l1 = pcorr_ops.level1_dense_dispatch(
                C_dev, G0_dev, float(np.float32(np.tanh(float(th[1]))))
            )
        if stats is not None:
            stats["pre_l1_dispatch_s"] = time.perf_counter() - t_mark
        if want_pmax:
            t_mark = time.perf_counter() if stats is not None else 0.0
            C = np.asarray(C, dtype=np.float32)
            if stats is not None:
                stats["c_fetch_wall_s"] = time.perf_counter() - t_mark
    elif C_dev is not None:
        # sharded flow: level 0 on the replicated panel, level 1 sharded in
        # the level loop below
        G0_dev = pcorr_ops.level0_screen(C_dev, jnp.float32(th[0]))
        if want_pmax:
            C = np.asarray(C, dtype=np.float32)
        G = _fetch_bool_packed(G0_dev)
    else:
        C = np.asarray(C, dtype=np.float32)
        G = None
    n = C.shape[0]
    # depth = the run's own max level, not ML: a stage-1 run to level 3
    # only ever writes 3 slots, and the (n, n, 14) int32 array is 7.1 GB
    # at the 11k block (several seconds of memset + real memory pressure;
    # the reference pays the full n^2*ML*4 on the GPU, `cuPC-S.cu:85-91`).
    # Every consumer reshapes with stride -1 (`reduce_gcs`) or slices
    # per-pair, so the narrower stride is transparent.
    t_mark = time.perf_counter() if stats is not None else 0.0
    sep_depth = max(1, min(ML, max_level))
    if scratch is not None:
        # callers that run MANY blocks (CuskContext, bench) pass a scratch
        # dict so the GB-scale sepset buffer is allocated once: a fresh
        # allocation page-faults on first touch (seconds for 1.5 GB
        # at the 11k block) and heap fragmentation defeats page recycling.
        # The returned result ALIASES the buffer — the pipeline consumes
        # res.sepset before the next block, which is the contract.
        key = ("sepset", n, sep_depth)
        sepset = scratch.get(key)
        if sepset is None:
            sepset = np.empty((n, n, sep_depth), dtype=np.int32)
            scratch[key] = sepset
        sepset.fill(-1)
    else:
        sepset = np.full((n, n, sep_depth), -1, dtype=np.int32)
    pmax = np.zeros((n, n), dtype=np.float32) if want_pmax else None
    if stats is not None:
        stats["sepset_alloc_s"] = time.perf_counter() - t_mark

    # level 0: marginal screen, overwrites G
    if G is None or want_pmax:
        with np.errstate(invalid="ignore", divide="ignore"):
            z0 = fisher_z(np.asarray(C, dtype=np.float32))
    if G is None:
        # reference deletes iff res < th (`cuPC-S.cu:466-477`), NaN keeps the edge
        G = ~(z0 < th[0])
        np.fill_diagonal(G, False)
    if pmax is not None:
        deleted0 = ~G
        np.fill_diagonal(deleted0, False)
        pmax[deleted0] = z0[deleted0]

    if C_dev is None:
        C_dev = jnp.asarray(C)
    final_level = 0
    start_l = 1
    lmax_all = min(ML, max_level)
    deg0 = G.sum(axis=1)
    deg0_padded = max(8, -(-int(deg0.max()) // 8) * 8) if n else 8
    if (
        engine is None
        and pre_l1 is None
        and LOCAL_LEVELS == (2, 3)
        and lmax_all >= 1
        and n
        and deg0_padded <= 128
        and n <= DEV_RESIDENT_MAX
    ):
        # DEVICE-RESIDENT levels 1..3: adjacency stays on device, one
        # dispatch per level (see _run_levels_local_dev); the host loop
        # below picks up from level 4 (combinatorial enumeration)
        Gd0 = G0_dev if G0_dev is not None else jnp.asarray(G)
        G, final_level, stopped = _run_levels_local_dev(
            C_dev, Gd0, deg0, th, min(lmax_all, 3), sepset, pmax,
            verbose, stats,
        )
        start_l = (lmax_all + 1) if stopped else (final_level + 1)
    if stats is not None:
        # everything before the level loop that the l0 mark does not
        # cover (sepset alloc, pre-dispatches, fetches)
        stats["preamble_s"] = time.perf_counter() - _t_enter
    for l in range(start_l, min(ML, max_level) + 1):
        with jax.profiler.TraceAnnotation(f"skeleton_level_{l}"):
            deg = G.sum(axis=1)
            nprime = int(deg.max()) if n else 0
            if nprime - 1 < l:
                final_level = l - 1
                break
            if verbose:
                print(f"[skeleton] level {l}: max degree {nprime}")
            t_level = time.perf_counter() if stats is not None else 0.0
            # pre-round the threshold to f32 so the host-side compares (numpy
            # promotes f32 rho vs Python float to f64) decide identically to
            # the device-resident loop's f32 compare — which is also what the
            # CUDA reference does (route parity; ADVICE r3)
            rho_th = float(np.float32(np.tanh(float(th[l]))))
            l1_local_now = (
                l == 1
                and engine is None
                and pre_l1 is None
                and _l1_route_local(deg, int(C_dev.shape[0]))
            )
            if l1_local_now or (l == 1 and (pre_l1 is not None or n <= DENSE_L1_MAX)):
                if l1_local_now:
                    removed, (xs, ys, s_sel, rho_sel) = _run_level_local1(
                        C_dev, G, rho_th, verbose=verbose,
                        want_rho=pmax is not None, stats=stats,
                    )
                elif engine is not None:
                    removed, (xs, ys, s_sel, rho_sel) = _run_level_dense1_engine(
                        C_dev, G, rho_th, engine
                    )
                elif pre_l1 is not None:
                    side, xs, ys, s_sel, rho_sel = pcorr_ops.level1_dense_collect(pre_l1)
                    removed = side | side.T
                else:
                    removed, (xs, ys, s_sel, rho_sel) = _run_level_dense1(C_dev, G, rho_th)
                sepset[xs, ys, 0] = s_sel
                sepset[xs, ys, 1:] = -1
                if pmax is not None:
                    pmax[xs, ys] = fisher_z(rho_sel)
            elif l in LOCAL_LEVELS:
                removed, (xs, ys, rho_sel, sep_sel) = _run_level_local(
                    C_dev, G, l, rho_th, verbose=verbose,
                    engine=engine, stats=stats, want_rho=pmax is not None,
                )
                if len(xs):
                    if pmax is not None:
                        pmax[xs, ys] = fisher_z(rho_sel)
                    sepset[xs, ys, l:] = -1
                    sepset[xs, ys, :l] = sep_sel
            else:
                removed, rho_min, rank = _run_level(
                    C_dev, G, l, rho_th, chunk, verbose=verbose,
                    engine=engine, stats=stats,
                )
                # record sepsets & pmax for ordered pairs whose own side passed
                side = (rho_min < rho_th) & G
                xs, ys = np.nonzero(side)
                if len(xs):
                    if pmax is not None:
                        pmax[xs, ys] = fisher_z(rho_min[xs, ys])
                    sepset[xs, ys, l:] = -1
                    prev_x, nbr_x = -1, None
                    for x, y in zip(xs, ys):  # xs ascending from np.nonzero
                        if x != prev_x:
                            nbr_x = np.where(G[x])[0]
                            prev_x = x
                        sepset[x, y, :l] = nbr_x[colex_unrank(int(rank[x, y]), l)]
            G = G & ~removed
            if stats is not None:
                stats.setdefault("level_wall_s", {})[l] = (
                    time.perf_counter() - t_level
                )
            final_level = l

    # pMax post-processing (`cuPC-S.cu:424-442`): retained edges get the
    # sentinel, deleted pairs the max of both sides (full-matrix ops — the
    # triu fancy-indexing form costs ~0.5s at n~2k)
    if pmax is not None:
        mx = np.maximum(pmax, pmax.T)
        pmax = np.where(G, np.float32(PMAX_RETAINED), mx)
        np.fill_diagonal(pmax, 1.0)

    if pad:
        G = G[:v_real, :v_real]
        sepset = sepset[:v_real, :v_real]
        if pmax is not None:
            pmax = pmax[:v_real, :v_real]
    if stats is not None:
        stats["skeleton_wall_s"] = time.perf_counter() - _t_enter
    return SkeletonResult(
        G=G.astype(np.int32), sepset=sepset, pmax=pmax, final_level=final_level
    )


def hetcor_skeleton(
    C: np.ndarray,
    G: np.ndarray,
    N: np.ndarray,
    threshold: float,
    max_level: int,
    time_index: np.ndarray | None = None,
    chunk: int = DEFAULT_CHUNK,
    verbose: bool = False,
    ess_mode: str = "reference",
    engine=None,
    stats: dict | None = None,
) -> SkeletonResult:
    """Skeleton with per-pair effective sample sizes and time constraints.

    Equivalent of `hetcor_skeleton` (`hetcor-cuPC-S.cu:75-341`): honours the
    incoming adjacency (level 0 only deletes), uses per-test thresholds
    th / sqrt(mean_ess - l - 3), and returns adjacency only (no sepsets).

    ess_mode selects the `mean_ess` semantics for levels >= 1
    (`hetcor-cuPC-S.cu:3068-3089`):

    * ``"reference"`` (default) reproduces the reference exactly: each
      pairwise ESS is read through ``int loc_val = N[...]`` — truncated
      toward zero — and the subsequent ``isnan(loc_val)`` tests the
      already-converted int, so it never fires: a NaN entry converts to 0
      (CUDA float->int of NaN) and IS counted in the mean.
    * ``"float"`` is the intended behavior: full-precision pairwise ESS with
      NaN entries excluded from the mean.

    Level 0 always uses the raw per-pair N (`cal_Indepl0_ess`,
    `hetcor-cuPC-S.cu:343-377` reads the float directly).

    C and N may be jax device arrays (the cuskss flow keeps the
    summary-stat panels device-resident): padding, the level-0 screen and
    the ess-mode transform then all run on device, and only the packed
    level-0 decision bits cross the host link instead of the ~800 MB of
    assembled (v, v) panels at v ~ 10k.
    """
    if ess_mode not in ("reference", "float"):
        raise ValueError(f"unknown ess_mode: {ess_mode!r}")
    if engine is None and isinstance(C, jax.Array):
        v_real = int(C.shape[0])
        pad = (-v_real) % PANEL_ALIGN
        C_dev = C
        N_dev_raw = N if isinstance(N, jax.Array) else jnp.asarray(
            np.asarray(N, dtype=np.float32)
        )
        if pad:
            # inert shape-bucket padding, same semantics as the host path
            C_dev = jnp.pad(C_dev, ((0, pad), (0, pad)))
            N_dev_raw = jnp.pad(
                N_dev_raw, ((0, pad), (0, pad)), constant_values=10.0
            )
        n = v_real + pad
        G = np.asarray(G).astype(bool)
        G = np.pad(G, ((0, pad), (0, pad))) if pad else G.copy()
        if time_index is None:
            time_index = np.zeros(n, dtype=np.int32)
        else:
            time_index = np.asarray(time_index, dtype=np.int32)
            if pad:
                time_index = np.pad(time_index, (0, pad))
        # level 0 on device; the same NaN semantics as the host compare
        # (NaN threshold compares false and keeps the edge)
        delete0 = np.unpackbits(
            np.asarray(pcorr_ops.hetcor_l0_packed(
                C_dev, N_dev_raw, jnp.float32(threshold)
            )), axis=1, count=n,
        ).astype(bool)
        G &= ~delete0
        np.fill_diagonal(G, False)
        N_dev = (
            pcorr_ops.trunc_ref_ess(N_dev_raw)
            if ess_mode == "reference" else N_dev_raw
        )
        t_dev = jnp.asarray(time_index)
    else:
        C = np.asarray(C, dtype=np.float32)
        v_real = C.shape[0]
        align = PANEL_ALIGN
        if engine is not None:
            # row-sharded panels split (vp, vp) rows over the mesh axis
            align = math.lcm(PANEL_ALIGN, engine.ndev)
        pad = (-v_real) % align
        if pad:
            # shape bucket (see `skeleton`): padded vars carry corr 0,
            # finite ess, no incoming edges — inert at every level
            C = np.pad(C, ((0, pad), (0, pad)))
            G = np.pad(np.asarray(G), ((0, pad), (0, pad)))
            N = np.pad(np.asarray(N, dtype=np.float32), ((0, pad), (0, pad)),
                       constant_values=10.0)
            if time_index is not None:
                time_index = np.pad(
                    np.asarray(time_index, dtype=np.int32), (0, pad)
                )
        n = C.shape[0]
        G = np.asarray(G).astype(bool).copy()
        N = np.asarray(N, dtype=np.float32)
        if time_index is None:
            time_index = np.zeros(n, dtype=np.int32)
        time_index = np.asarray(time_index, dtype=np.int32)

        # level 0: delete-only marginal screen with per-pair N
        with np.errstate(invalid="ignore", divide="ignore"):
            z0 = fisher_z(C)
            loc_th = threshold / np.sqrt(N - 3.0)
        delete0 = z0 < loc_th
        G &= ~delete0
        np.fill_diagonal(G, False)

        if engine is not None:
            put = engine.put_panel
        else:
            # chunked uploads, kept from the earlier host link; unmeasured
            # on the H100's PCIe link (ROADMAP 1.7)
            from cigwas_tpu.ops.corr import _device_put_chunked as put
        C_dev = put(C)
        if ess_mode == "reference":
            # NaN-free N makes the kernels' NaN masks all-false, i.e.
            # every pair is counted — exactly the reference's dead NaN
            # check (see docstring)
            N_lvl = np.trunc(np.nan_to_num(N, nan=0.0)).astype(np.float32)
        else:
            N_lvl = N
        N_dev = put(N_lvl)
        t_dev = jnp.asarray(time_index)
    final_level = 0
    _t_enter = time.perf_counter()
    for l in range(1, min(ML, max_level) + 1):
        with jax.profiler.TraceAnnotation(f"hetcor_level_{l}"):
            deg = G.sum(axis=1)
            nprime = int(deg.max()) if n else 0
            if nprime - 1 < l:
                final_level = l - 1
                break
            if verbose:
                print(f"[hetcor_skeleton] level {l}: max degree {nprime}")
            t_level = time.perf_counter() if stats is not None else 0.0
            if l == 1 and engine is None and _l1_route_local(deg, n):
                # neighbour-list local sweep at sum(deg^2) cost; identical
                # margins to the dense route (see hetcor1_local_sweep)
                removed = _run_level_local_hetcor1(
                    C_dev, N_dev, t_dev, G.astype(np.int32), float(threshold),
                    verbose=verbose, stats=stats,
                )
            elif l == 1 and n <= DENSE_L1_MAX:
                # dense masked sweep, one dispatch (same tests as the
                # neighbour-list enumeration; see hetcor1_dense_margin)
                dense1 = (
                    engine.hetcor1_dense_margin if engine is not None
                    else pcorr_ops.hetcor1_dense_margin
                )
                margin = dense1(C_dev, N_dev, t_dev, G, float(threshold))
                cond = (margin < 0) & G
                removed = cond | cond.T
            elif l in LOCAL_LEVELS:
                removed = _run_level_local_hetcor(
                    C_dev, N_dev, t_dev, G.astype(np.int32), l, float(threshold),
                    verbose=verbose, engine=engine, stats=stats,
                )
            else:
                removed, _, _ = _run_level(
                    C_dev,
                    G.astype(np.int32),
                    l,
                    None,
                    chunk,
                    hetcor_args=(N_dev, t_dev, float(threshold)),
                    verbose=verbose,
                    engine=engine,
                    stats=stats,
                )
            G = G & ~removed
            if stats is not None:
                stats.setdefault("level_wall_s", {})[l] = (
                    time.perf_counter() - t_level
                )
            final_level = l
    else:
        final_level = min(ML, max_level)

    if pad:
        G = G[:v_real, :v_real]
    if stats is not None:
        stats["skeleton_wall_s"] = time.perf_counter() - _t_enter
    return SkeletonResult(
        G=G.astype(np.int32), sepset=None, pmax=None, final_level=final_level
    )
