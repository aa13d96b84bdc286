"""Individual-level per-block skeleton pipeline (`mps cusk` / `mps block`).

Equivalents of `cli.cpp:432-678` (cusk) and `cli.cpp:362-411` (make_blocks):
load one LD block of genotypes + standardized phenotypes, build the dense
correlation panel on the device, run the two-stage PC-stable skeleton with
ancestor reduction in between, and write the `.mdim/.ixs/.adj/.corr/.sep`
block output.
"""

from __future__ import annotations

import numpy as np

from cigwas_tpu.blocking import block_chr
from cigwas_tpu.constants import ML
from cigwas_tpu.io import (
    BedDims,
    BfilesBase,
    BimInfo,
    load_phen,
    make_path,
    read_blocks_from_file,
    read_floats_from_line_range,
    write_marker_blocks_to_file,
)
from cigwas_tpu.io.bed import check_path, check_prepped_bed_path, read_block_from_bed, read_chr_from_bed
from cigwas_tpu.ops.corr import (
    banded_row_abs_sums,
    corr_panel_device,
    corr_panel_device_tiled,
    kendall_npn_corr_banded,
    marker_phen_corr_from_sums,
    phen_phen_corr,
    set_trait_blocks,
    marker_phen_sums_dispatch,
)
from cigwas_tpu.skeleton import reduce_gcs, skeleton, subset_variables
from cigwas_tpu.utils.stats import fisher_z, threshold_array


def make_blocks(
    bed_base_path: str,
    max_block_size: int,
    corr_width: int,
    out_path: str | None = None,
    verbose: bool = True,
    mesh=None,
) -> list:
    """Partition every chromosome into LD blocks (`make_blocks`, `cli.cpp:362-411`).

    The reference takes a device-mem budget to size its streaming batches;
    the device path tiles internally, so no budget parameter is needed. With a
    `mesh`, the banded correlation shards chromosome rows over the mesh with
    a ring boundary exchange (`parallel.sharded.make_banded_corr_sharded`).
    """
    bfiles = BfilesBase(bed_base_path)
    dims = BedDims.from_bfiles(bfiles)
    bim = BimInfo(bfiles.bim())
    out_path = out_path or bfiles.blocks(max_block_size)

    banded = kendall_npn_corr_banded
    if mesh is not None:
        from cigwas_tpu.parallel.sharded import make_banded_corr_sharded

        banded = make_banded_corr_sharded(mesh, mesh.axis_names[0])

    all_blocks = []
    for cid in bim.chr_ids:
        if verbose:
            print(f"[chr {cid}] loading bed data")
        chr_bed = read_chr_from_bed(bfiles.bed(), cid, bim, dims)
        if verbose:
            print(f"[chr {cid}] computing banded correlations")
        if mesh is None and chr_bed.shape[0] > 16384:
            # chromosome scale: reduce the band to row sums ON DEVICE
            # instead of fetching the full band (see
            # banded_row_abs_sums_streaming; float-ulp summation
            # differences vs the host path documented there)
            from cigwas_tpu.ops.corr import banded_row_abs_sums_streaming

            row_sums = banded_row_abs_sums_streaming(
                chr_bed, dims.num_samples, corr_width
            )
        else:
            band = banded(chr_bed, dims.num_samples, corr_width)
            row_sums = banded_row_abs_sums(band)
        blocks = block_chr(row_sums, cid, max_block_size)
        if verbose:
            print(f"[chr {cid}] partitioned into {len(blocks)} blocks")
        write_marker_blocks_to_file(blocks, out_path)
        all_blocks.extend(blocks)
    return all_blocks


def cusk(
    phen_path: str,
    bed_base_path: str,
    block_path: str,
    alpha: float,
    max_level: int,
    max_level_two: int,
    depth: int,
    outdir: str,
    block_index: int,
    verbose: bool = True,
    mesh=None,
):
    """Two-stage skeleton for a single LD block (`cusk`, `cli.cpp:432-678`).

    Returns the written ReducedGCS, or None if the block was skipped because
    no marker–phenotype correlation is significant (`cli.cpp:561-576`).

    mesh: a `jax.sharding.Mesh` runs the correlation panel and every level
    kernel SPMD over its devices (see `cigwas_tpu.parallel.sharded`); block
    outputs are byte-identical to the single-device path.
    """
    ctx = CuskContext(
        phen_path,
        bed_base_path,
        block_path,
        alpha,
        max_level,
        max_level_two,
        depth,
        outdir,
        verbose=verbose,
        mesh=mesh,
    )
    return ctx.finish(ctx.prepare(block_index))


class CuskContext:
    """Per-dataset state for running many cusk blocks (the `cusk-all` path).

    Loading `.phen`/`.bim`/`.dim` and validating the block list is done ONCE
    here instead of per block, and each block's work is split into

    * :meth:`prepare` — host file IO (bed block, means/stds slices) plus the
      device *dispatch* of the marker-phen pre-screen sums, and
    * :meth:`finish` — the pre-screen fetch, the fused correlation panel and
      the two-stage skeleton, and the block-output write.

    A runner can therefore call ``prepare(i+1)`` before ``finish(i)``: block
    i+1's disk reads and pre-screen dispatch overlap with block i's device
    work, hiding host IO and one device round-trip per block. `cusk`
    (`cli.cpp:432-678`) reloads everything per process invocation; this
    context is the replacement.
    """

    def __init__(
        self,
        phen_path: str,
        bed_base_path: str,
        block_path: str,
        alpha: float,
        max_level: int,
        max_level_two: int,
        depth: int,
        outdir: str,
        verbose: bool = True,
        mesh=None,
        panel_mode: str = "replicated",
    ):
        if panel_mode not in ("replicated", "rowsharded"):
            raise ValueError(f"unknown panel_mode: {panel_mode!r}")
        check_prepped_bed_path(bed_base_path)
        check_path(phen_path)
        check_path(block_path)
        check_path(outdir)

        self.phen = load_phen(phen_path)
        self.bfiles = BfilesBase(bed_base_path)
        self.dims = BedDims.from_file(self.bfiles.dim())
        if self.phen.num_samples != self.dims.num_samples:
            raise ValueError("different num samples in phen and dims")
        self.bim = BimInfo(self.bfiles.bim())
        self.max_level = max_level
        self.max_level_two = max_level_two
        self.depth = depth
        self.outdir = outdir
        self.verbose = verbose
        # per-context scratch reused across blocks (GB-scale sepset
        # buffers; see skeleton(scratch=...))
        self.scratch: dict = {}
        self.engine = None
        if mesh is not None:
            from cigwas_tpu.parallel.sharded import (
                RowShardedEngine,
                ShardedEngine,
            )

            axis = "marker" if "marker" in mesh.axis_names else mesh.axis_names[0]
            cls = RowShardedEngine if panel_mode == "rowsharded" else ShardedEngine
            self.engine = cls(mesh, axis)

        self.blocks = read_blocks_from_file(block_path)
        for b in self.blocks:
            if (
                b.first_marker_ix >= self.bim.get_num_markers_on_chr(b.chr_id)
                or b.last_marker_ix >= self.bim.get_num_markers_on_chr(b.chr_id)
            ):
                raise ValueError(
                    f"block out of bounds with first_ix: {b.first_marker_ix} "
                    f"last_ix: {b.last_marker_ix}"
                )
        self.Th = threshold_array(self.dims.num_samples, alpha)

    def prepare(self, block_index: int) -> dict:
        """Host IO + pre-screen dispatch for one block (no device fetch)."""
        block = self.blocks[block_index]
        num_markers = block.block_size()
        if self.verbose:
            print(
                f"Processing block {block_index + 1} / {len(self.blocks)} "
                f"({num_markers} markers)"
            )
        bedblock = read_block_from_bed(self.bfiles.bed(), block, self.dims, self.bim)
        chr_start = self.bim.get_global_chr_start(block.chr_id)
        means = read_floats_from_line_range(
            self.bfiles.means(),
            chr_start + block.first_marker_ix,
            chr_start + block.last_marker_ix,
        )
        stds = read_floats_from_line_range(
            self.bfiles.stds(),
            chr_start + block.first_marker_ix,
            chr_start + block.last_marker_ix,
        )
        if means.size != num_markers or stds.size != num_markers:
            raise ValueError("block size and number of means or stds differ")
        handles = marker_phen_sums_dispatch(
            bedblock, self.phen.data, self.dims.num_samples
        )
        return {
            "block": block,
            "bedblock": bedblock,
            "means": means,
            "stds": stds,
            "mp_handles": handles,
        }

    def finish(self, prep: dict):
        """Pre-screen fetch + panel + two-stage skeleton + output write."""
        block = prep["block"]
        bedblock = prep["bedblock"]
        means = prep["means"]
        stds = prep["stds"]
        num_markers = block.block_size()
        num_phen = self.phen.num_phen
        num_individuals = self.dims.num_samples
        Th = self.Th
        verbose = self.verbose

        # pre-screen: skip blocks without any significant marker-phen
        # correlation (`cli.cpp:561-576`)
        mp_corr = marker_phen_corr_from_sums(prep["mp_handles"], means, stds)
        with np.errstate(divide="ignore", invalid="ignore"):
            num_sig = int((fisher_z(mp_corr) >= Th[0]).sum())
        if num_sig == 0:
            if verbose:
                print("No significant correlations found. Skipping block.")
            return None
        if verbose:
            print(f"Found {num_sig} marker-phen correlations. Proceeding.")

        return self._run_block(
            block, bedblock, means, stds, mp_corr, num_markers, num_phen,
            num_individuals,
        )

    def _run_block(
        self, block, bedblock, means, stds, mp_corr, num_markers, num_phen,
        num_individuals,
    ):
        Th = self.Th
        verbose = self.verbose
        max_level = self.max_level
        max_level_two = self.max_level_two
        depth = self.depth
        phen = self.phen
        outdir = self.outdir
        num_var = num_markers + num_phen
        engine = self.engine
        # DEVICE-RESIDENT flow for every block size: the packed panel is
        # built on device, consumed by the skeleton in place, and only the
        # kept (k, k) submatrix is fetched for the reduction — pMax (which
        # the pipeline never consumes) is skipped, so no O(v^2) array
        # crosses the host link (the ~0.5 GB round trip of an 11k panel)
        if engine is not None:
            # sharded panel (marker rows over the mesh) + sharded skeleton;
            # the trait blocks come from the same host values as on one
            # device (see set_trait_blocks)
            C_dev, v_panel = engine.corr_panel_device(
                bedblock, phen.data, means, stds, num_individuals
            )
            C_dev = set_trait_blocks(
                C_dev, mp_corr, phen_phen_corr(phen.data), num_markers
            )
            res1 = skeleton(
                C_dev, Th, max_level, verbose=verbose, C_dev=C_dev,
                n_var=v_panel, engine=engine, want_pmax=False,
                scratch=self.scratch,
            )
        elif num_markers <= 4096:
            # fused single-dispatch panel: decode once
            C_dev, v_panel = corr_panel_device(
                bedblock, phen.data, means, stds, num_individuals
            )
            C_dev = set_trait_blocks(
                C_dev, mp_corr, phen_phen_corr(phen.data), num_markers
            )
            res1 = skeleton(
                C_dev, Th, max_level, verbose=verbose, C_dev=C_dev,
                n_var=v_panel, want_pmax=False, scratch=self.scratch,
            )
        else:
            # stripe-built panel (`corr_host.cu:208-420` analogue)
            C_dev, v_panel = corr_panel_device_tiled(
                bedblock, phen.data, means, stds, num_individuals,
                mp_corr=mp_corr,
            )
            res1 = skeleton(
                C_dev, Th, max_level, verbose=verbose, C_dev=C_dev,
                n_var=v_panel, want_pmax=False, scratch=self.scratch,
            )
        keep = subset_variables(res1.G, num_var, num_markers, depth)
        gcs = reduce_gcs(
            res1.G, C_dev, res1.sepset, keep, num_var, num_phen, max_level
        )

        # stage 2 (`reduced_gcs_cusk`, `cli.cpp:62-87`): Skeleton re-screens
        # from the reduced correlations (its level 0 rebuilds the adjacency)
        if verbose:
            print("Starting second cusk stage")
        res2 = skeleton(
            gcs.C, Th, max_level_two, verbose=verbose,
            engine=engine.for_stage2() if engine is not None else None,
        )
        keep2 = subset_variables(res2.G, gcs.num_var, gcs.num_markers(), depth)
        gcs2 = reduce_gcs(
            res2.G,
            gcs.C,
            res2.sepset,
            keep2,
            gcs.num_var,
            num_phen,
            ML,
            index_map=gcs.new_to_old_indices,
        )
        if verbose:
            print(f"Retained {gcs2.num_markers()} markers")
        gcs2.to_file(make_path(outdir, block.to_file_string(), ""))
        return gcs2
