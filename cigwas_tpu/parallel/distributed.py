"""Multi-process / multi-host wiring.

The reference scales across hosts by having the user submit one `mps cusk`
job per block to a cluster (`ci-gwas.py:100-104`) and merging the per-block
outputs from the shared filesystem
(`cusk_postprocessing/merge_blocks.py:361-395`). The shared-filesystem
contract is kept — block outputs are self-describing files and the merge
step never needs cross-host communication — but process placement is first
class here:

* :func:`init_distributed` wires `jax.distributed` once per process, from
  arguments or the conventional env vars,
* :func:`process_partition` reports this process's (num_partitions, index),
  which :func:`cigwas_tpu.parallel.block_scheduler.partition_blocks` uses as
  its default, so `run_all_blocks`/`cusk-all` need no partition flags under
  a launcher,
* :func:`run_partition_process` is the per-process entry point of one
  partition worker: it runs the partition on whatever platform the caller
  gave the process (`JAX_PLATFORMS`, `CUDA_VISIBLE_DEVICES`) and prints one
  JSON line with its wall time.
"""

from __future__ import annotations

import json
import os
import sys
import time


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Initialize `jax.distributed` for this process (idempotent).

    Defaults come from the standard env vars (`JAX_COORDINATOR_ADDRESS`,
    `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID` — also accepted with a `CIGWAS_`
    prefix) or from a supported cluster environment (SLURM, GKE, ...), which
    `jax.distributed.initialize` auto-detects when called with no args.

    This replaces the reference's implicit "one cluster job per block"
    topology: after this call, `jax.process_count()/process_index()` define
    the block partition and every collective-capable backend is wired.
    """
    import jax

    def _env(name, cast):
        for key in (f"CIGWAS_{name}", f"JAX_{name}"):
            val = os.environ.get(key)
            if val is not None:
                return cast(val)
        return None

    coordinator_address = coordinator_address or _env("COORDINATOR_ADDRESS", str)
    num_processes = num_processes or _env("NUM_PROCESSES", int)
    process_id = process_id if process_id is not None else _env("PROCESS_ID", int)

    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def process_partition() -> tuple[int, int]:
    """(num_partitions, partition_index) for this process.

    The `jax.distributed` world if initialized, else (1, 0) — exactly the
    defaults `partition_blocks` applies when given `None`s.
    """
    import jax

    return jax.process_count(), jax.process_index()


def run_partition_process(argv=None) -> int:
    """CLI for one partition worker (one process per card or per host).

    Usage: python -m cigwas_tpu.parallel.distributed <phen> <bfiles> <blocks>
      <alpha> <max_level> <max_level_two> <depth> <outdir>
      <num_partitions> <partition_index>

    Runs `run_all_blocks` for the given partition on the devices this
    process sees, and prints one JSON line: {"partition": i, "wall_s": w,
    "results": {...}}.
    """
    argv = argv if argv is not None else sys.argv[1:]
    (phen, bfiles, blocks, alpha, max_level, max_level_two, depth, outdir,
     nparts, pindex) = argv
    from cigwas_tpu.parallel.runner import run_all_blocks

    t0 = time.perf_counter()
    results = run_all_blocks(
        phen, bfiles, blocks, float(alpha), int(max_level),
        int(max_level_two), int(depth), outdir,
        num_partitions=int(nparts), partition_index=int(pindex),
        verbose=False,
    )
    wall = time.perf_counter() - t0
    print(json.dumps({
        "partition": int(pindex),
        "wall_s": wall,
        "results": {k: v for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(run_partition_process())
