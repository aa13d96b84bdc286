"""Lightweight timing / tracing instrumentation.

Equivalent of the reference's cudaEvent "spent seconds" prints around
every level kernel (`cuPC-S.cu:80-83,130-134`): a stage timer that logs
wall-clock per named stage and can wrap the run in a `jax.profiler` trace
for detailed analysis.
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    """Collects named stage durations; optionally prints as it goes."""

    def __init__(self, verbose: bool = False, prefix: str = ""):
        self.verbose = verbose
        self.prefix = prefix
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.stages.append((name, dt))
        if self.verbose:
            print(f"{self.prefix}[{name}] spent seconds: {dt:.4f}", flush=True)

    def total(self) -> float:
        return sum(dt for _, dt in self.stages)

    def as_dict(self) -> dict:
        return dict(self.stages)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None = None):
    """jax.profiler trace when a directory is given (or via
    CIGWAS_TPU_TRACE_DIR), else a no-op."""
    trace_dir = trace_dir or os.environ.get("CIGWAS_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
