"""On-device 2-bit PLINK genotype decode.

The reference decodes .bed bytes with 1024-entry lookup tables on the GPU
(`bed_lut_gpu.h`, used by every kernel in `corr_kernels.cu`). Here the
decode is pure elementwise arithmetic — shift/mask the packed byte stream and
map the four 2-bit codes to (value, validity) with selects, producing
one-hot channels that feed the contingency matmuls directly.

Code semantics (LSB-first pairs within each byte):
    00 -> value 2, valid      10 -> value 1, valid
    01 -> missing             11 -> value 0, valid
"""

from __future__ import annotations

import jax.numpy as jnp

# Byte that packs four "missing" codes — used for padding sample tails so that
# padded entries contribute nothing to any statistic.
PAD_BYTE = 0x55


def unpack_bed_codes(bed_bytes: jnp.ndarray) -> jnp.ndarray:
    """(m, B) packed uint8 -> (m, 4*B) int32 2-bit codes (LSB-first)."""
    b = bed_bytes.astype(jnp.int32)
    # stack the four shifted views along a new trailing axis, then flatten
    parts = [(b >> s) & 0x3 for s in (0, 2, 4, 6)]
    codes = jnp.stack(parts, axis=-1)
    return codes.reshape(bed_bytes.shape[0], -1)


def geno_onehot(codes: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """(m, n) codes -> (3, m, n) one-hot over genotype values {0, 1, 2}.

    Missing genotypes (code 1) produce an all-zero column, i.e. validity is
    folded into the one-hot; the per-value channels are
    [value==0, value==1, value==2] = [code==3, code==2, code==0].

    int8 by default: the contingency matmuls consume {0,1} operands, and
    int8 x int8 -> int32 tensor-core GEMMs run at twice the bf16 rate on
    the H100 (data sheet); counts are exact integers either way.

    CHANNEL-MAJOR layout: `.reshape(3 * m, n)` orders rows [channel, marker],
    so the (3m, 3m) contingency matmul lands the nine per-channel-pair count
    matrices as CONTIGUOUS (m, m) blocks. The channel-minor alternative
    needs a (m, 3, m, 3) -> (m, m, 3, 3) transpose of the count matrix.
    """
    g0 = (codes == 3).astype(dtype)
    g1 = (codes == 2).astype(dtype)
    g2 = (codes == 0).astype(dtype)
    return jnp.stack([g0, g1, g2], axis=0)


def contingency_counts(ra: jnp.ndarray, ca: jnp.ndarray) -> jnp.ndarray:
    """(3mr, n) x (3mc, n) one-hot panels -> exact int32 counts (3mr, 3mc).

    The 3x3 genotype contingency tables of all marker pairs as ONE int8
    matmul (`corr_kernels.cu:408-454` computes them per-pair in registers).
    """
    return jnp.dot(ra, ca.T, preferred_element_type=jnp.int32)


def geno_value_valid(codes: jnp.ndarray, dtype=jnp.float32):
    """(m, n) codes -> (values, validity) float arrays.

    values: genotype count {0,1,2}; missing decodes to 2.0 with validity 0
    (matching bed_lut_a/bed_lut_b in the reference).
    """
    valid = (codes != 1).astype(dtype)
    values = (
        (codes == 0).astype(dtype) * 2.0
        + (codes == 2).astype(dtype) * 1.0
        + (codes == 1).astype(dtype) * 2.0
    )
    return values, valid
