"""Tests that need an NVIDIA GPU (marker ``gpu``).

They skip on the CPU, where the unit tests run; `python chip_smoke.py` runs
them in its own process on the card (a second JAX process could not get
the card's memory).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_onehot_selection_dots_are_exact(gpu_device):
    """The level kernels' f32 one-hot selection dots run at HIGHEST
    precision: on the card they select correlations and ESS values near
    5e5 exactly (TF32 would keep 10 mantissa bits)."""
    from cigwas_tpu.ops.pcorr import _combo_onehots

    rng = np.random.default_rng(0)
    d, K = 128, 512
    combos = rng.integers(0, d, (K, 1)).astype(np.int32)
    select = jax.jit(lambda s, x: jnp.dot(
        s, x, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST))
    for X in (rng.standard_normal((d, d)).astype(np.float32),
              rng.uniform(3e5, 5e5, (d, d)).astype(np.float32)):
        sel = _combo_onehots(jnp.asarray(combos), d, 1)[0]
        got = select(jax.device_put(sel, gpu_device),
                     jax.device_put(X, gpu_device))
        np.testing.assert_array_equal(np.asarray(got), X[combos[:, 0]])


def test_contingency_counts_exact_on_card(gpu_device):
    """Decode + int8 contingency matmul on the card: exact counts,
    missing genotypes included."""
    from cigwas_tpu.io.bed import decode_bed_values, encode_bed_values
    from cigwas_tpu.ops.corr import _kendall_counts_block, _prep_bytes

    rng = np.random.default_rng(1)
    m, n = 96, 1000
    g = rng.integers(0, 3, (m, n)).astype(np.float32)
    g[rng.random(g.shape) < 0.05] = np.nan
    bb = encode_bed_values(g)
    cols, n_chunks = _prep_bytes(bb, n, 1024)
    got = np.asarray(_kendall_counts_block(
        jax.device_put(cols[:32], gpu_device),
        jax.device_put(cols, gpu_device), n_chunks))
    vals, valid = decode_bed_values(bb, n)
    oh = np.concatenate([((vals == k) & (valid > 0)) for k in (0, 1, 2)])
    oh = oh.astype(np.int64)
    rows = np.concatenate([oh[k * m:k * m + 32] for k in range(3)])
    np.testing.assert_array_equal(got, rows @ oh.T)


def _pcorr(C, x, y, S):
    sub = C[np.ix_([x, y, *S], [x, y, *S])].astype(np.float64)
    P = np.linalg.inv(sub)
    return -P[0, 1] / np.sqrt(P[0, 0] * P[1, 1])


def test_skeleton_on_card_matches_bruteforce(gpu_device):
    """PC-stable skeleton on the card against a numpy brute-force oracle
    (partial correlations through the precision matrix, float64)."""
    from cigwas_tpu.skeleton import skeleton
    from cigwas_tpu.utils.stats import threshold_array

    rng = np.random.default_rng(2)
    v, n = 16, 3000
    X = rng.standard_normal((v, n))
    for i in range(1, v):
        X[i] += 0.6 * X[rng.integers(0, i)]
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(n, 1e-3)
    res = skeleton(jax.device_put(C, gpu_device), th, 3, n_var=v,
                   want_pmax=False)

    G = np.abs(0.5 * np.log((1 + C) / (1 - C))) >= th[0]
    np.fill_diagonal(G, False)
    for l in (1, 2, 3):
        remove = np.zeros_like(G)
        for x in range(v):
            nb = np.where(G[x])[0]
            for y in nb:
                for S in itertools.combinations([s for s in nb if s != y], l):
                    if abs(_pcorr(C, x, y, S)) < np.tanh(th[l]):
                        remove[x, y] = remove[y, x] = True
                        break
        G &= ~remove
    np.testing.assert_array_equal(res.G.astype(bool), G)
