"""Summary-statistic skeleton pipeline (`mps cuskss`).

Equivalent of `cuskss` (`cli.cpp:194-346`) plus the flag derivation of
`mps.cpp:31-101`: build the dense correlation + effective-sample-size
matrices from mxm/mxp/pxp inputs, then run the (optionally two-stage) hetcor
skeleton with ancestor reduction after each stage (`run_cusk`,
`cli.cpp:29-60`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

from cigwas_tpu.constants import ML
from cigwas_tpu.io import (
    MarkerSummaryStats,
    MarkerTraitSummaryStats,
    TraitSummaryStats,
    make_path,
    read_blocks_from_file,
    read_ints_from_binary,
    read_ints_from_lines,
)
from cigwas_tpu.io.results import ReducedGC
from cigwas_tpu.skeleton import hetcor_skeleton, reduce_gc, subset_variables
from cigwas_tpu.utils.stats import hetcor_threshold


@dataclass
class CuskssArgs:
    """Mirror of `CuskssArgs` (`cli.h:10-31`); flags as derived in `mps.cpp:49-53`."""

    merged: bool
    hetcor: bool
    trait_only: bool
    two_stage: bool
    time_indexed: bool
    alpha: float
    pearson_sample_size: float
    max_level_one: int
    max_level_two: int
    depth: int
    block_ix: int
    block_path: str
    marker_ixs_path: str
    mxm_path: str
    mxp_path: str
    mxp_se_path: str
    pxp_path: str
    pxp_se_path: str
    time_index_path: str
    outdir: str
    # `mean_ess` semantics for hetcor levels >= 1 ("reference" = int
    # truncation quirk, "float" = intended math); see
    # `cigwas_tpu.skeleton.cupc.hetcor_skeleton`.
    ess_mode: str = "reference"

    @classmethod
    def from_paths(
        cls,
        *,
        mxm: str = "NULL",
        mxp: str = "NULL",
        mxp_se: str = "NULL",
        pxp: str,
        pxp_se: str = "NULL",
        time_index: str = "NULL",
        block_index: int = 0,
        blockfile: str = "NULL",
        marker_indices: str = "NULL",
        alpha: float,
        max_level_one: int = 3,
        max_level_two: int = 14,
        max_depth: int = 1,
        num_samples: float,
        outdir: str = "./",
        ess_mode: str = "reference",
    ) -> "CuskssArgs":
        return cls(
            merged=marker_indices != "NULL",
            hetcor=mxp_se != "NULL",
            trait_only=mxm == "NULL",
            two_stage=max_level_two > 0,
            time_indexed=time_index != "NULL",
            alpha=alpha,
            pearson_sample_size=float(num_samples),
            max_level_one=max_level_one,
            max_level_two=max_level_two,
            depth=max_depth,
            block_ix=block_index,
            block_path=blockfile,
            marker_ixs_path=marker_indices,
            mxm_path=mxm,
            mxp_path=mxp,
            mxp_se_path=mxp_se,
            pxp_path=pxp,
            pxp_se_path=pxp_se,
            time_index_path=time_index,
            outdir=outdir,
            ess_mode=ess_mode,
        )


def make_square_cuskss_inputs(
    mxm: MarkerSummaryStats,
    mxp: MarkerTraitSummaryStats,
    pxp: TraitSummaryStats,
    pearson_sample_size: float,
    heterogeneous_sample_sizes: bool,
):
    """Dense correlation + ESS matrices, markers first then traits
    (`make_square_cuskss_inputs`, `cli.cpp:89-173`)."""
    p = pxp.get_num_phen()
    m = mxm.get_num_markers()
    n = m + p
    sq_corrs = np.ones((n, n), dtype=np.float32)
    sq_ess = np.full((n, n), pearson_sample_size, dtype=np.float32)
    sq_corrs[:m, :m] = mxm.get_corrs()
    mp = mxp.get_corrs()
    sq_corrs[:m, m:] = mp
    sq_corrs[m:, :m] = mp.T
    sq_corrs[m:, m:] = pxp.get_corrs()
    if heterogeneous_sample_sizes:
        mp_ess = mxp.get_sample_sizes()
        sq_ess[:m, m:] = mp_ess
        sq_ess[m:, :m] = mp_ess.T
        sq_ess[m:, m:] = pxp.get_sample_sizes()
    return sq_corrs, sq_ess


def _assemble_panels_jit(m_: int, p_: int, het_: bool):
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=())
    def assemble(tril_, mxp_, pxp_, mp_ess_, pp_ess_, n_):
        flat = jnp.nan_to_num(tril_.reshape(-1))
        i = jnp.arange(m_)
        r = jnp.maximum(i[:, None], i[None, :])
        c = jnp.minimum(i[:, None], i[None, :])
        Cmm = flat[(r * (r + 1)) // 2 + c]
        C = jnp.ones((m_ + p_, m_ + p_), jnp.float32)
        C = C.at[:m_, :m_].set(Cmm)
        C = C.at[:m_, m_:].set(mxp_)
        C = C.at[m_:, :m_].set(mxp_.T)
        C = C.at[m_:, m_:].set(pxp_)
        N = jnp.full((m_ + p_, m_ + p_), n_, jnp.float32)
        if het_:
            N = N.at[:m_, m_:].set(mp_ess_)
            N = N.at[m_:, :m_].set(mp_ess_.T)
            N = N.at[m_:, m_:].set(pp_ess_)
        return C, N

    return assemble


_ASSEMBLE_CACHE: dict = {}


def assemble_cuskss_panels_device(
    mxm_tril: np.ndarray,
    mxp: np.ndarray,
    pxp: np.ndarray,
    pearson_sample_size: float,
    mp_ess: np.ndarray | None = None,
    pp_ess: np.ndarray | None = None,
):
    """Device-resident `make_square_cuskss_inputs` (`cli.cpp:89-173`).

    Uploads the COMPACT parts — the (m(m+1)/2,) mxm lower triangle (the
    binary format of `marker_summary_stats.cpp:8-24`) plus the (m, p) and
    (p, p) blocks — and assembles the dense (v, v) corr/ESS panels ON
    DEVICE: ~4x fewer host-to-device bytes than the assembled squares,
    and the panels feed :func:`cigwas_tpu.skeleton.hetcor_skeleton`'s
    device path without ever existing on the host. NaN mxm entries map to
    0 exactly like the host loader. Returns (C_dev, N_dev), both (v, v)
    f32 with v = m + p.
    """
    import jax.numpy as jnp

    from cigwas_tpu.ops.corr import _device_put_chunked

    mxm_tril = np.asarray(mxm_tril, dtype=np.float32)
    m = int((np.sqrt(8 * mxm_tril.size + 1) - 1) / 2)
    if m * (m + 1) // 2 != mxm_tril.size:
        raise ValueError("mxm tril size is not triangular")
    mxp = np.asarray(mxp, dtype=np.float32)
    pxp = np.asarray(pxp, dtype=np.float32)
    p = pxp.shape[0]
    # chunked 2-D upload of the tril (1-D arrays ship whole otherwise)
    pad = (-mxm_tril.size) % 8192
    tril2 = np.pad(mxm_tril, (0, pad)).reshape(-1, 8192)
    tril_dev = _device_put_chunked(tril2)

    het = mp_ess is not None
    key = (m, p, het)
    fn = _ASSEMBLE_CACHE.get(key)
    if fn is None:
        fn = _assemble_panels_jit(m, p, het)
        _ASSEMBLE_CACHE[key] = fn
    mp_e = np.asarray(
        mp_ess if het else np.zeros((m, p)), dtype=np.float32
    )
    pp_e = np.asarray(
        pp_ess if pp_ess is not None else np.zeros((p, p)), dtype=np.float32
    )
    return fn(
        tril_dev, jnp.asarray(mxp), jnp.asarray(pxp), jnp.asarray(mp_e),
        jnp.asarray(pp_e), jnp.float32(pearson_sample_size),
    )


def run_cusk(
    gc: ReducedGC,
    threshold: float,
    max_depth: int,
    max_level: int,
    time_index_traits: list[int],
    verbose: bool = False,
    ess_mode: str = "reference",
    engine=None,
    stats: dict | None = None,
) -> ReducedGC:
    """One hetcor-skeleton stage + ancestor reduction (`run_cusk`, `cli.cpp:29-60`).

    engine: a `cigwas_tpu.parallel.sharded.ShardedEngine` /
    `RowShardedEngine` runs the hetcor level kernels SPMD over its mesh
    (byte-identical outputs; see `make_engine`).
    stats: optional dict collecting the hetcor skeleton's per-level walls
    and enumerated level >= 2 test counts (the cudaEvent prints of
    `hetcor-cuPC-S.cu:75-341` made structured).
    """
    time_index = np.zeros(gc.num_var, dtype=np.int32)
    time_index[gc.num_markers() :] = np.asarray(time_index_traits, dtype=np.int32)
    res = hetcor_skeleton(
        gc.C, gc.G, gc.S, threshold, max_level, time_index=time_index,
        verbose=verbose, ess_mode=ess_mode, engine=engine, stats=stats,
    )
    keep = subset_variables(res.G, gc.num_var, gc.num_markers(), max_depth)
    return reduce_gc(
        res.G,
        gc.C,
        gc.S,
        keep,
        gc.num_var,
        gc.num_phen,
        ML,
        index_map=gc.new_to_old_indices,
    )


def cuskss(
    args: CuskssArgs,
    verbose: bool = True,
    mesh=None,
    panel_mode: str = "replicated",
) -> ReducedGC:
    """Full cuskss workflow (`cuskss`, `cli.cpp:194-346`).

    mesh: a `jax.sharding.Mesh` runs every hetcor level kernel SPMD over it
    (the reference's multi-GPU analogue is one block per device via
    `ci-gwas.py`; here one block's tests shard over the mesh).
    panel_mode: "replicated" holds the full (v, v) correlation/ESS panels on
    every device; "rowsharded" splits them into (vp/D, vp) row strips with
    ring-pass level kernels for panels beyond one chip's HBM. Outputs are
    byte-identical across modes and to the single-device path.
    """
    from cigwas_tpu.parallel.sharded import make_engine

    engine = make_engine(mesh, panel_mode)
    if args.merged:
        marker_ixs = read_ints_from_binary(args.marker_ixs_path)
        block = None
    else:
        blocks = read_blocks_from_file(args.block_path)
        block = blocks[args.block_ix]
        marker_ixs = None

    if args.hetcor:
        pxp = TraitSummaryStats(args.pxp_path, se_path=args.pxp_se_path)
    else:
        pxp = TraitSummaryStats(args.pxp_path, sample_size=args.pearson_sample_size)
    num_phen = pxp.get_num_phen()

    time_index_traits = [1] * num_phen
    if args.time_indexed:
        time_index_traits = read_ints_from_lines(args.time_index_path)

    th = hetcor_threshold(args.alpha)

    if args.trait_only:
        num_var = num_phen
        gc = ReducedGC(
            num_var=num_var,
            num_phen=num_phen,
            max_level=args.max_level_one,
            new_to_old_indices=np.arange(num_var, dtype=np.int32),
            G=np.ones((num_var, num_var), dtype=np.int32),
            C=pxp.get_corrs(),
            S=pxp.get_sample_sizes(),
        )
        gc = run_cusk(
            gc, th, args.depth, args.max_level_one, time_index_traits,
            verbose=verbose, ess_mode=args.ess_mode, engine=engine,
        )
        gc.to_file(make_path(args.outdir, "trait_only", ""))
        if verbose:
            print(f"Retained {gc.num_markers()} markers")
        return gc

    mxm = MarkerSummaryStats(args.mxm_path)
    se_path = args.mxp_se_path if args.hetcor else None
    if args.merged:
        mxp = MarkerTraitSummaryStats(args.mxp_path, se_path=se_path, marker_ixs=marker_ixs)
    else:
        mxp = MarkerTraitSummaryStats(args.mxp_path, se_path=se_path, block=block)

    if pxp.get_num_phen() != mxp.get_num_phen():
        raise ValueError("Numbers of traits seem to differ between pxp and mxp")
    if mxm.get_num_markers() != mxp.get_num_markers():
        raise ValueError("Numbers of markers seem to differ between mxm and mxp")

    sq_corrs, sq_ess = make_square_cuskss_inputs(
        mxm, mxp, pxp, args.pearson_sample_size, args.hetcor
    )
    num_var = sq_corrs.shape[0]
    gc = ReducedGC(
        num_var=num_var,
        num_phen=num_phen,
        max_level=args.max_level_one,
        new_to_old_indices=np.arange(num_var, dtype=np.int32),
        G=np.ones((num_var, num_var), dtype=np.int32),
        C=sq_corrs,
        S=sq_ess,
    )
    if verbose:
        print("Starting first cusk stage")
    gc = run_cusk(
        gc, th, args.depth, args.max_level_one, time_index_traits,
        verbose=verbose, ess_mode=args.ess_mode, engine=engine,
    )
    if args.two_stage:
        if verbose:
            print("Starting second cusk stage")
        gc = run_cusk(
            gc, th, args.depth, args.max_level_two, time_index_traits,
            verbose=verbose, ess_mode=args.ess_mode,
            engine=engine.for_stage2() if engine is not None else None,
        )
    if verbose:
        print(f"Retained {gc.num_markers()} markers")
    if args.merged:
        gc.to_file(make_path(args.outdir, "cuskss_merged", ""))
    else:
        gc.to_file(make_path(args.outdir, block.to_file_string(), ""))
    return gc
