"""Property tests for the hetcor (per-pair-ESS) skeleton.

The reference offers no golden with heterogeneous ESS (its ctest pins a
constant-N panel only, `cupc_tests.cpp:65-88`), so the engine is checked
against an independent BRUTE-FORCE numpy oracle that re-implements the
`hetcor-cuPC-S.cu` semantics from the paper trail:

* level 0 deletes iff fisher_z(C) < th / sqrt(N_pair - 3) with the RAW
  per-pair N (`cal_Indepl0_ess`, hetcor-cuPC-S.cu:343-377),
* level l >= 1 (PC-stable) enumerates S in adj(x) \\ {y} per ordered pair,
  testing |rho_xy|S| < tanh(th / sqrt(mean_ess - l - 3)) where mean_ess
  averages the pairwise ESS over all C(l+2, 2) variable pairs of the test
  (`hetcor-cuPC-S.cu:3055-3089`),
* ess_mode="reference" truncates each pairwise ESS toward zero with NaN -> 0
  and counts every pair (the reference's dead isnan-after-int-conversion);
  ess_mode="float" keeps full precision and excludes NaN pairs,
* conditioning variables must satisfy max t(S) <= max(t(x), t(y))
  (`valid_time_conditioning`),
* a non-finite per-test threshold (mean_ess <= l + 3) skips the test.

The oracle computes partial correlations through the precision matrix while
the engine uses Schur complements, so the comparison is decision-level
(adjacency), with fixed seeds whose margins are not borderline.
"""

import itertools

import numpy as np
import pytest

from cigwas_tpu.skeleton import hetcor_skeleton
from cigwas_tpu.utils.stats import fisher_z, hetcor_threshold


def _pcorr(C, x, y, S):
    ixs = [x, y] + list(S)
    sub = C[np.ix_(ixs, ixs)].astype(np.float64)
    try:
        P = np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        return 1.0
    denom = P[0, 0] * P[1, 1]
    if denom <= 0:
        return 1.0
    return float(-P[0, 1] / np.sqrt(denom))


def hetcor_oracle(C, G0, N, th, max_level, time_index=None, ess_mode="reference"):
    v = C.shape[0]
    G = np.asarray(G0).astype(bool).copy()
    if time_index is None:
        time_index = np.zeros(v, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        z0 = fisher_z(C)
        loc = th / np.sqrt(N - 3.0)
    G &= ~(z0 < loc)
    np.fill_diagonal(G, False)

    if ess_mode == "reference":
        N_l = np.trunc(np.nan_to_num(N, nan=0.0))
    else:
        N_l = N

    for l in range(1, max_level + 1):
        deg = G.sum(axis=1)
        if deg.max() - 1 < l:
            break
        remove = np.zeros_like(G)
        for x in range(v):
            if deg[x] < l + 1:
                continue
            nbrs = np.where(G[x])[0]
            for y in nbrs:
                others = [s for s in nbrs if s != y]
                for S in itertools.combinations(others, l):
                    if max(time_index[list(S)]) > max(time_index[x], time_index[y]):
                        continue
                    mem = [x, y, *S]
                    tot = cnt = 0.0
                    for i in range(len(mem)):
                        for j in range(i):
                            nij = N_l[mem[i], mem[j]]
                            if ess_mode == "float" and np.isnan(nij):
                                continue
                            tot += nij
                            cnt += 1
                    if cnt == 0:
                        continue  # all pairs NaN -> NaN threshold -> skip
                    mean_ess = tot / cnt
                    if mean_ess - l - 3.0 <= 0:
                        continue
                    th_test = np.tanh(th / np.sqrt(mean_ess - l - 3.0))
                    rho = abs(_pcorr(C, x, y, S))
                    if np.isfinite(rho) and rho < th_test:
                        remove[x, y] = remove[y, x] = True
        G &= ~remove
    return G.astype(np.int32)


def _random_panel(rng, v, n=4000):
    X = np.zeros((v, n))
    X[0] = rng.normal(size=n)
    for i in range(1, v):
        ps = rng.choice(i, size=min(i, 2), replace=False)
        X[i] = sum(0.55 * X[p] for p in ps) + rng.normal(size=n)
    return np.corrcoef(X).astype(np.float32), n


def _random_ess(rng, v, n, nan_frac=0.15):
    # fractional, asymmetrically-scaled per-pair ESS with NaN holes
    E = rng.uniform(0.3 * n, 1.2 * n, size=(v, v))
    E = (E + E.T) / 2
    nan_mask = rng.random((v, v)) < nan_frac
    nan_mask = np.triu(nan_mask, 1)
    nan_mask = nan_mask | nan_mask.T
    E[nan_mask] = np.nan
    np.fill_diagonal(E, n)
    return E.astype(np.float32)


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hetcor_matches_bruteforce_oracle(seed, ess_mode):
    rng = np.random.default_rng(seed)
    v = 12
    C, n = _random_panel(rng, v)
    N = _random_ess(rng, v, n)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    res = hetcor_skeleton(C, G0, N, th, 3, ess_mode=ess_mode)
    exp = hetcor_oracle(C, G0, N, th, 3, ess_mode=ess_mode)
    np.testing.assert_array_equal(res.G, exp)


@pytest.mark.parametrize("seed", [3, 4])
def test_hetcor_time_index_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    v = 12
    C, n = _random_panel(rng, v)
    N = _random_ess(rng, v, n, nan_frac=0.1)
    t_ix = rng.integers(0, 3, size=v).astype(np.int32)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    res = hetcor_skeleton(C, G0, N, th, 3, time_index=t_ix)
    exp = hetcor_oracle(C, G0, N, th, 3, time_index=t_ix, ess_mode="reference")
    np.testing.assert_array_equal(res.G, exp)


@pytest.mark.parametrize("seed", [5, 6])
def test_hetcor_dense_l1_matches_list_path_random_ess(seed, monkeypatch):
    """All three hetcor level-1 routes — the neighbour-list LOCAL sweep
    (default at small degrees), the dense margin sweep, and the
    combination-scan enumeration — must agree for heterogeneous
    (NaN-holed) ESS and time indices, both modes."""
    import cigwas_tpu.skeleton.cupc as cupc

    rng = np.random.default_rng(seed)
    v = 14
    C, n = _random_panel(rng, v)
    N = _random_ess(rng, v, n)
    t_ix = rng.integers(0, 2, size=v).astype(np.int32)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    for ess_mode in ("reference", "float"):
        local1 = hetcor_skeleton(
            C, G0, N, th, 2, time_index=t_ix, ess_mode=ess_mode
        )
        with pytest.MonkeyPatch.context() as mp:
            # disable the local-1 route -> dense sweep
            mp.setattr(cupc, "L1_LOCAL_MAX_WIDTH", 0)
            mp.setattr(cupc, "L1_LOCAL_COST_RATIO", 1 << 60)
            dense = cupc.hetcor_skeleton(
                C, G0, N, th, 2, time_index=t_ix, ess_mode=ess_mode
            )
            # additionally disable the dense sweep -> chunk enumeration
            mp.setattr(cupc, "DENSE_L1_MAX", 0)
            listp = cupc.hetcor_skeleton(
                C, G0, N, th, 2, time_index=t_ix, ess_mode=ess_mode
            )
        np.testing.assert_array_equal(local1.G, dense.G)
        np.testing.assert_array_equal(dense.G, listp.G)


def test_hetcor_modes_agree_on_integral_nanfree_ess():
    """With integral, NaN-free ESS the truncation semantics are inert: both
    modes must produce the same adjacency."""
    rng = np.random.default_rng(9)
    v = 12
    C, n = _random_panel(rng, v)
    N = np.round(_random_ess(rng, v, n, nan_frac=0.0)).astype(np.float32)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    a = hetcor_skeleton(C, G0, N, th, 3, ess_mode="reference")
    b = hetcor_skeleton(C, G0, N, th, 3, ess_mode="float")
    np.testing.assert_array_equal(a.G, b.G)


@pytest.mark.parametrize("seed", [7, 8])
def test_hetcor_local_path_matches_scan_path(seed):
    """Hetcor levels 2/3 route through the dense local-panel margin sweep;
    it must make the same removal decisions as the combination-scan
    enumeration (`level_scan_hetcor`)."""
    import cigwas_tpu.skeleton.cupc as cupc

    rng = np.random.default_rng(seed)
    v = 14
    C, n = _random_panel(rng, v)
    N = _random_ess(rng, v, n)
    t_ix = rng.integers(0, 3, size=v).astype(np.int32)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    local = hetcor_skeleton(C, G0, N, th, 3, time_index=t_ix)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cupc, "LOCAL_LEVELS", ())
        scan = cupc.hetcor_skeleton(C, G0, N, th, 3, time_index=t_ix)
    np.testing.assert_array_equal(local.G, scan.G)


@pytest.mark.parametrize("seed", [10, 11])
def test_hetcor_device_resident_panels_match_host_path(seed):
    """hetcor_skeleton with jax-array C/N (the device-resident cuskss
    flow: on-device padding, level-0 screen, ess transform) must make the
    same decisions as the host-array path."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    v = 14
    C, n = _random_panel(rng, v)
    N = _random_ess(rng, v, n)
    t_ix = rng.integers(0, 2, size=v).astype(np.int32)
    th = hetcor_threshold(1e-3)
    G0 = np.ones((v, v), np.int32)
    for ess_mode in ("reference", "float"):
        host = hetcor_skeleton(
            C, G0, N, th, 3, time_index=t_ix, ess_mode=ess_mode
        )
        dev = hetcor_skeleton(
            jnp.asarray(C), G0, jnp.asarray(N), th, 3, time_index=t_ix,
            ess_mode=ess_mode,
        )
        np.testing.assert_array_equal(host.G, dev.G)


def test_reduce_gc_device_arrays_gather_on_device():
    """reduce_gc with device C/S fetches only the kept (k, k) blocks."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import reduce_gc

    rng = np.random.default_rng(0)
    n, p = 6, 2
    G = (rng.random((n, n)) < 0.5).astype(np.int32)
    C = rng.normal(size=(n, n)).astype(np.float32)
    S = rng.uniform(10, 100, (n, n)).astype(np.float32)
    keep = np.array([0, 2, 3, 5])
    host = reduce_gc(G, C, S, keep, n, p, 14)
    dev = reduce_gc(G, jnp.asarray(C), jnp.asarray(S), keep, n, p, 14)
    np.testing.assert_array_equal(host.C, dev.C)
    np.testing.assert_array_equal(host.S, dev.S)
    np.testing.assert_array_equal(host.G, dev.G)


def test_hetcor1_scattered_neighbours_matches_oracle():
    """Hetcor level 1 through the local-sweep route on neighbour lists
    scattered over the panel (hub nodes with far-flung neighbours),
    NaN-holed heterogeneous ESS and time indices, against the brute-force
    oracle."""
    import jax.numpy as jnp

    import cigwas_tpu.skeleton.cupc as cupc

    rng = np.random.default_rng(44)
    v, n, hubs, dh = 300, 4000, 12, 30
    C, _ = _random_panel(rng, v, n)
    N = _random_ess(rng, v, n)
    t_ix = rng.integers(0, 3, size=v).astype(np.int32)
    th = hetcor_threshold(1e-3)
    G = np.zeros((v, v), np.int32)
    for h in rng.choice(v, hubs, replace=False):
        nb = rng.choice(v, dh, replace=False)
        nb = nb[nb != h]
        G[h, nb] = 1
        G[nb, h] = 1
    res = hetcor_skeleton(jnp.asarray(C), G, jnp.asarray(N), th, 1,
                          time_index=t_ix)
    assert cupc._l1_route_local(G.sum(axis=1), v)
    exp = hetcor_oracle(C, G, N, th, 1, time_index=t_ix)
    np.testing.assert_array_equal(res.G, exp)
    # the level must have decided something beyond the level-0 screen
    assert 0 < exp.sum() < G.sum()
