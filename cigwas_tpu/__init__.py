"""cigwas_tpu — a causal discovery engine for genome-wide association data.

A from-scratch JAX/XLA reimplementation of the capabilities of CI-GWAS
(medical-genomics-group/ci-gwas): massively parallel conditional-independence
testing (PC-stable skeleton search), LD blocking, marker/trait correlation
panels as int8 matmuls, separation-set selection, RFCI PAG orientation and
multivariable IVW Mendelian randomization.

Layer map (see SURVEY.md for the reference equivalents):

- :mod:`cigwas_tpu.io`        — PLINK .bed/.bim/.fam, .phen, summary stats, block files
- :mod:`cigwas_tpu.ops`       — device ops: 2-bit decode, correlation panels, batched CI tests
- :mod:`cigwas_tpu.skeleton`  — level-wise PC-stable skeleton engines (cuPC-S equivalents)
- :mod:`cigwas_tpu.blocking`  — LD-block boundary search
- :mod:`cigwas_tpu.pipelines` — cusk / cuskss end-to-end per-block workflows
- :mod:`cigwas_tpu.merge`     — block merging, sepselect, MR assumption checks
- :mod:`cigwas_tpu.pag`       — sRFCI R1–R10 PAG orientation
- :mod:`cigwas_tpu.mr`        — multivariable IVW Mendelian randomization
- :mod:`cigwas_tpu.parallel`  — device meshes, block scheduling, sharded panels
"""

import os as _os

from cigwas_tpu.constants import ML

__version__ = "0.1.0"
__all__ = ["ML", "__version__"]


# the persistent compile cache's default home: a fixed path, never one
# built from a temp name, a pid or the time, so later runs find what earlier
# runs cached
DEFAULT_COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compilation_cache() -> None:
    """Keep JAX's persistent compilation cache at one fixed place.

    JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so when it is set nothing
    is changed here. Otherwise the cache goes to `.jax_cache` at the root
    of the checkout (listed in `.gitignore`).
    """
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)


def _tune_malloc() -> None:
    """Keep GB-scale host buffers in the malloc arena (Linux glibc).

    glibc serves large allocations with mmap and returns them to the OS on
    free, so every per-block scratch array (the (n, n, l) sepsets, removal
    masks, ...) re-faults fresh pages — seconds per GB-scale `np.full` at
    the 11k block against a fraction of that from recycled pages.
    Raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD makes the first block pay
    the fault cost once and every later block reuse the pages.
    """
    if _os.environ.get("CIGWAS_TPU_NO_MALLOC_TUNE"):
        return
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: nothing to tune
        return
    libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
    libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD


_enable_compilation_cache()
_tune_malloc()
