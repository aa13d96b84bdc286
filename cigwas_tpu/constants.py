"""Global constants of the engine.

Mirrors the compile-time constants of the reference
(`cusk/include/mps/cuPC-S.h:21-51`, `corr_kernels.h:3`, `blocking.cpp:6`).
"""

# Maximum size of a conditioning set in the skeleton search.
# Reference: ML = 14 (`cuPC-S.h:49`). Separation sets are stored with this
# stride in the `.sep` output files.
ML: int = 14

# Tolerance for the LD-blocking window-size bisection
# (`blocking.cpp:6`, MAX_BLOCK_SIZE_TOL).
MAX_BLOCK_SIZE_TOL: int = 100

# Value written into pMax for retained edges (`cuPC-S.cu:438-439`).
PMAX_RETAINED: float = -100000.0

# PLINK .bed magic prefix (`bfiles_base.h:8-9`).
BED_PREFIX_BYTES: int = 3
BED_PREFIX_COL_MAJ: bytes = bytes([0x6C, 0x1B, 0x01])

# All device kernels see correlation panels padded up to a multiple of this
# (shape bucketing): every distinct panel size is a separate XLA compile.
# Padded variables are inert (corr 0 with everything -> isolated at level
# 0). The value is not yet derived on the H100 (ROADMAP 3.2).
PANEL_ALIGN: int = 128
