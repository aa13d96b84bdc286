"""Multi-block / multi-host cusk runner.

The reference leaves block-level data parallelism to the user ("run mps cusk
once for each block", `README.md:57`). This runner makes it first class:

* single host: iterate this process's partition of the block list (the
  device pipeline keeps the chip busy within each block),
* multi host (`jax.distributed` wired by
  :func:`cigwas_tpu.parallel.distributed.init_distributed`, or one
  `python -m cigwas_tpu.parallel.distributed` worker per partition): each
  process takes its load-balanced share via
  :func:`cigwas_tpu.parallel.block_scheduler.partition_blocks`; the merge
  step then reads all block outputs from the shared filesystem exactly like
  the reference's workflow, so no cross-host communication is needed beyond
  the file system.
"""

from __future__ import annotations

import os

from cigwas_tpu.io import read_blocks_from_file
from cigwas_tpu.parallel.block_scheduler import partition_blocks
from cigwas_tpu.pipelines.cusk import CuskContext
from cigwas_tpu.utils.timing import StageTimer


def partition_mesh(
    devices_per_partition: int,
    partition_index: int | None = None,
    axis: str = "marker",
):
    """1-D mesh over THIS partition's group of the local devices.

    Partition p of the block list gets devices [p*g, (p+1)*g)
    (g = devices_per_partition) of the devices this process sees, so
    concurrent partition workers on one host each shard their blocks over a
    disjoint device group — block-DP across groups, panel-TP inside each
    (SURVEY §2.4 row 1). A process that sees exactly g devices was already
    given its group by its launcher (e.g. one worker per card with
    `CUDA_VISIBLE_DEVICES=p`) and uses them all. partition_index defaults to
    this process's `jax.process_index()` (0 single-process).
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    if partition_index is None:
        partition_index = jax.process_index()
    devs = jax.local_devices()
    if len(devs) == devices_per_partition:
        return Mesh(np.array(devs), (axis,))
    lo = devices_per_partition * partition_index
    hi = lo + devices_per_partition
    if hi > len(devs):
        raise ValueError(
            f"partition {partition_index} needs devices [{lo}, {hi}) but only "
            f"{len(devs)} are visible"
        )
    return Mesh(np.array(devs[lo:hi]), (axis,))


def run_all_blocks(
    phen_path: str,
    bed_base_path: str,
    block_path: str,
    alpha: float,
    max_level: int,
    max_level_two: int,
    depth: int,
    outdir: str,
    num_partitions: int | None = None,
    partition_index: int | None = None,
    verbose: bool = True,
    mesh=None,
    panel_mode: str = "replicated",
) -> dict:
    """Run cusk for every block assigned to this partition.

    mesh / panel_mode: run each of this partition's blocks SPMD over the
    given `jax.sharding.Mesh` (see `pipelines.cusk.CuskContext`). This
    composes block data-parallelism with panel tensor-parallelism — each
    partition owns a device GROUP and shards every block's panel inside it
    (SURVEY §2.4 row 1; the reference's per-block cluster loop is
    `ci-gwas.py:100-104`). Use :func:`partition_mesh` to carve the local
    devices into per-partition groups.

    Returns {block_file_string: num_markers_retained | None (skipped)}.
    """
    blocks = read_blocks_from_file(block_path)
    mine = partition_blocks(blocks, num_partitions, partition_index)
    index_of = {b.to_file_string(): i for i, b in enumerate(blocks)}
    timer = StageTimer(verbose=verbose, prefix="[run_all_blocks] ")
    results: dict = {}
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
        panel_mode=panel_mode,
    )
    # software pipeline: block i+1's host IO + pre-screen dispatch happen
    # before block i's finish, so disk reads and one device round-trip per
    # block hide behind the previous block's device work
    prepared = ctx.prepare(index_of[mine[0].to_file_string()]) if mine else None
    for i, b in enumerate(mine):
        stem = b.to_file_string()
        cur, prepared = prepared, (
            ctx.prepare(index_of[mine[i + 1].to_file_string()])
            if i + 1 < len(mine)
            else None
        )
        with timer.stage(stem):
            res = ctx.finish(cur)
        results[stem] = None if res is None else res.num_markers()
    if verbose:
        print(
            f"[run_all_blocks] processed {len(mine)} blocks in "
            f"{timer.total():.2f}s"
        )
    return results
