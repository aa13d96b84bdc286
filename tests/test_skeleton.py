import numpy as np
import pytest

from cigwas_tpu.constants import ML, PMAX_RETAINED
from cigwas_tpu.skeleton import hetcor_skeleton, skeleton
from cigwas_tpu.utils.stats import fisher_z, hetcor_threshold, threshold_array


def test_skeleton_n10_golden_adjacency(n10_fixture):
    """Pins the reference's `cuPC.expected_skeleton_n10` ctest
    (`cupc_tests.cpp:17-41`): exact adjacency parity."""
    C, A, alpha, n = n10_fixture
    res = skeleton(C, threshold_array(n, alpha), 14)
    assert np.array_equal(res.G, A)


def test_hetcor_skeleton_n10_golden_adjacency(n10_fixture):
    """Pins `hetcor_cuPC.expected_skeleton_n10` (`cupc_tests.cpp:65-88`):
    constant ESS matrix must reproduce the same adjacency."""
    C, A, alpha, n = n10_fixture
    N = np.full_like(C, float(n))
    res = hetcor_skeleton(
        C, np.ones_like(A), N, hetcor_threshold(alpha), 14
    )
    assert np.array_equal(res.G, A)


def test_skeleton_sepsets_are_valid_separators():
    """Sepsets must actually separate: conditioning on the recorded set makes
    the pair's partial correlation drop below the level threshold.

    Uses a sparse random DAG whose skeleton requires level >= 1 deletions
    (for the N10 fixture every deletion already happens at level 0)."""
    rng = np.random.default_rng(5)
    n_var, n = 8, 40000
    # chain with a few extra parents -> plenty of conditional independencies
    X = np.zeros((n_var, n))
    X[0] = rng.normal(size=n)
    for i in range(1, n_var):
        X[i] = 0.7 * X[i - 1] + rng.normal(size=n)
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(n, 1e-4)
    res = skeleton(C, th, 14)
    found_any = False
    for x in range(n_var):
        for y in range(n_var):
            S = res.sepset[x, y]
            S = S[S >= 0]
            if len(S) == 0:
                continue
            found_any = True
            assert res.G[x, y] == 0  # only deleted pairs have sepsets
            ixs = np.concatenate([[x, y], S])
            prec = np.linalg.inv(C[np.ix_(ixs, ixs)])
            pc = -prec[0, 1] / np.sqrt(prec[0, 0] * prec[1, 1])
            assert fisher_z(pc) < th[len(S)]
    assert found_any


def test_skeleton_pmax_retained_marker(n10_fixture):
    C, A, alpha, n = n10_fixture
    res = skeleton(C, threshold_array(n, alpha), 14)
    assert np.all(res.pmax[res.G.astype(bool)] == PMAX_RETAINED)
    assert np.all(np.diag(res.pmax) == 1.0)
    assert np.allclose(res.pmax, res.pmax.T)


def test_skeleton_max_level_zero_is_marginal_screen(n10_fixture):
    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    res = skeleton(C, th, 0)
    exp = (fisher_z(C) >= th[0]).astype(np.int32)
    np.fill_diagonal(exp, 0)
    assert np.array_equal(res.G, exp)


def test_hetcor_honors_initial_graph(n10_fixture):
    """hetcor level 0 deletes only — edges absent from the input adjacency
    must never reappear (`cal_Indepl0_ess`, commented-out else branch)."""
    C, A, alpha, n = n10_fixture
    N = np.full_like(C, float(n))
    G0 = np.ones_like(A)
    G0[0, :] = 0
    G0[:, 0] = 0
    res = hetcor_skeleton(C, G0, N, hetcor_threshold(alpha), 14)
    assert np.all(res.G[0] == 0)
    assert np.all(res.G[:, 0] == 0)


def test_hetcor_time_index_blocks_conditioning():
    """A conditioning variable with a later time index than both endpoints
    must be skipped (`valid_time_conditioning`)."""
    # build a chain x - z - y where z separates x and y
    rng = np.random.default_rng(7)
    z = rng.normal(size=20000)
    x = z + rng.normal(size=20000)
    y = z + rng.normal(size=20000)
    C = np.corrcoef(np.stack([x, y, z]))
    n = 20000
    N = np.full((3, 3), float(n), dtype=np.float32)
    th = hetcor_threshold(1e-3)
    # without time constraint: z separates x,y -> edge (0,1) removed
    res = hetcor_skeleton(C, np.ones((3, 3), np.int32), N, th, 14)
    assert res.G[0, 1] == 0
    # with z at a later time index, conditioning on z is forbidden -> edge kept
    res_t = hetcor_skeleton(
        C,
        np.ones((3, 3), np.int32),
        N,
        th,
        14,
        time_index=np.array([0, 0, 5], dtype=np.int32),
    )
    assert res_t.G[0, 1] == 1


def test_hetcor_per_pair_ess_level0():
    """Level-0 deletion uses the per-pair N: a weak correlation with small
    ESS is deleted, with large ESS it is retained."""
    C = np.array([[1.0, 0.05], [0.05, 1.0]], dtype=np.float32)
    th = hetcor_threshold(1e-4)
    small = hetcor_skeleton(C, np.ones((2, 2), np.int32), np.full((2, 2), 100.0), th, 0)
    large = hetcor_skeleton(
        C, np.ones((2, 2), np.int32), np.full((2, 2), 500000.0), th, 0
    )
    assert small.G[0, 1] == 0
    assert large.G[0, 1] == 1


def test_skeleton_chain_graph_exact():
    """Markov chain x0 -> x1 -> x2 -> x3: skeleton must be the path graph."""
    rng = np.random.default_rng(11)
    n = 50000
    x0 = rng.normal(size=n)
    x1 = x0 + rng.normal(size=n)
    x2 = x1 + rng.normal(size=n)
    x3 = x2 + rng.normal(size=n)
    C = np.corrcoef(np.stack([x0, x1, x2, x3])).astype(np.float32)
    res = skeleton(C, threshold_array(n, 1e-4), 14)
    exp = np.zeros((4, 4), dtype=np.int32)
    for i in range(3):
        exp[i, i + 1] = exp[i + 1, i] = 1
    assert np.array_equal(res.G, exp)
    # x0 and x2 separated by x1
    assert 1 in set(res.sepset[0, 2][res.sepset[0, 2] >= 0]) or 1 in set(
        res.sepset[2, 0][res.sepset[2, 0] >= 0]
    )


def test_second_stage_n10_golden_adjacency(n10_fixture):
    """Pins `cusk_second_stage.expected_skeleton_n10` (`cupc_tests.cpp:43-63`)."""
    from cigwas_tpu.skeleton.second_stage import cusk_second_stage

    C, A, alpha, n = n10_fixture
    res = cusk_second_stage(C, np.ones_like(A), threshold_array(n, alpha))
    assert np.array_equal(res.G, A)


def test_second_stage_sepsets_lower_pcorr():
    """Second-stage sepsets must contain exactly the single-var conditioners
    that lower the Fisher z below the marginal value."""
    from cigwas_tpu.skeleton.second_stage import cusk_second_stage

    rng = np.random.default_rng(3)
    n = 30000
    z = rng.normal(size=n)
    x = z + rng.normal(size=n)
    y = z + rng.normal(size=n)
    w = rng.normal(size=n)
    C = np.corrcoef(np.stack([x, y, z, w])).astype(np.float32)
    th = threshold_array(n, 1e-2)
    res = cusk_second_stage(C, np.ones((4, 4), np.int32), th)
    # pair (x, y): conditioning on z lowers z-statistic; w does not
    sep = res.sepset[0, 1]
    sep = set(sep[sep >= 0].tolist())
    assert 2 in sep
    assert 3 not in sep


def test_second_stage_degree_cap():
    from cigwas_tpu.skeleton.second_stage import PCORR_MAX_DEGREE, cusk_second_stage

    n = PCORR_MAX_DEGREE + 5
    # equicorrelated panel keeps every edge at level 0 -> degree > cap
    C = np.full((n, n), 0.5, dtype=np.float32)
    np.fill_diagonal(C, 1.0)
    with pytest.raises(ValueError, match="max degree"):
        cusk_second_stage(C, np.ones((n, n), np.int32), threshold_array(10000, 1e-4))


def test_skeleton_level_four_separation():
    """u and y share four parents: the edge u-y is separable only at level 4,
    exercising the batched-LU inverse path (l > 3)."""
    rng = np.random.default_rng(21)
    n = 200000
    X = rng.normal(size=(4, n))
    y = X.sum(axis=0) + 0.5 * rng.normal(size=n)
    u = X.sum(axis=0) + 0.5 * rng.normal(size=n)
    C = np.corrcoef(np.vstack([X, y[None], u[None]])).astype(np.float32)
    th = threshold_array(n, 1e-5)
    res = skeleton(C, th, 14)
    assert res.G[4, 5] == 0  # u - y separated
    # the recorded sepset must be exactly the four shared parents
    sep = set(res.sepset[4, 5][res.sepset[4, 5] >= 0]) | set(
        res.sepset[5, 4][res.sepset[5, 4] >= 0]
    )
    assert sep == {0, 1, 2, 3}
    # parents stay adjacent to both
    for i in range(4):
        assert res.G[i, 4] == 1 and res.G[i, 5] == 1


class TestHetcorEssMode:
    """The two `mean_ess` semantics (`hetcor-cuPC-S.cu:3068-3089`)."""

    @staticmethod
    def _panel(rho_target):
        """4-var panel whose only level-1 test of interest is (0,1|2):
        partial corr rho_{01|2} == rho_target, node 3 isolated."""
        c02 = c12 = 0.5
        c01 = rho_target * np.sqrt((1 - c02**2) * (1 - c12**2)) + c02 * c12
        C = np.eye(4, dtype=np.float32)
        C[0, 1] = C[1, 0] = c01
        C[0, 2] = C[2, 0] = c02
        C[1, 2] = C[2, 1] = c12
        return C

    def test_fractional_ess_truncation_flips_adjacency(self):
        """With fractional per-pair ESS, the reference's int truncation of
        each pairwise N (`int loc_val = N[...]`) lowers mean_ess, raising the
        per-test threshold -> an edge right at the boundary is deleted in
        'reference' mode but kept in 'float' mode."""
        alpha = 1e-2
        th = hetcor_threshold(alpha)
        ess = 102.9
        th_float = np.tanh(th / np.sqrt(ess - 1 - 3))
        th_ref = np.tanh(th / np.sqrt(np.trunc(ess) - 1 - 3))
        assert th_ref > th_float
        rho = float((th_ref + th_float) / 2)  # between the two thresholds
        C = self._panel(rho)
        N = np.full((4, 4), ess, dtype=np.float32)
        G = np.ones((4, 4), dtype=np.int32)

        res_ref = hetcor_skeleton(C, G.copy(), N, th, 14, ess_mode="reference")
        res_float = hetcor_skeleton(C, G.copy(), N, th, 14, ess_mode="float")
        assert res_ref.G[0, 1] == 0  # truncation raises the threshold
        assert res_float.G[0, 1] == 1
        assert not np.array_equal(res_ref.G, res_float.G)

    def test_nan_ess_counted_as_zero_in_reference_mode(self):
        """A NaN pairwise ESS converts to int 0 and IS counted by the
        reference's dead `isnan(loc_val)` check, dragging mean_ess down ->
        lower threshold. 'float' mode excludes it from the mean."""
        alpha = 1e-2
        th = hetcor_threshold(alpha)
        ess = 120.0
        # reference: mean over {(0,1)=NaN->0, (0,2)=120, (1,2)=120} = 80
        th_ref = np.tanh(th / np.sqrt(80.0 - 1 - 3))
        # float: NaN excluded -> mean = 120
        th_float = np.tanh(th / np.sqrt(120.0 - 1 - 3))
        assert th_ref > th_float
        rho = float((th_ref + th_float) / 2)
        C = self._panel(rho)
        N = np.full((4, 4), ess, dtype=np.float32)
        N[0, 1] = N[1, 0] = np.nan
        G = np.ones((4, 4), dtype=np.int32)
        # keep level 0 of the NaN pair alive: level 0 reads the raw float N
        # (NaN threshold compares false -> edge kept), both modes agree there
        res_ref = hetcor_skeleton(C, G.copy(), N, th, 14, ess_mode="reference")
        res_float = hetcor_skeleton(C, G.copy(), N, th, 14, ess_mode="float")
        assert res_ref.G[0, 1] == 0
        assert res_float.G[0, 1] == 1


def test_level1_list_path_matches_dense_path(n10_fixture, monkeypatch):
    """Panels above DENSE_L1_MAX run level 1 through the degree-bucketed
    neighbour-list engine instead of the dense v^3 sweep; results must be
    identical (same tests, same smallest-index tie-breaking)."""
    import cigwas_tpu.skeleton.cupc as cupc

    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    dense = skeleton(C, th, 3)
    monkeypatch.setattr(cupc, "DENSE_L1_MAX", 0)
    listp = cupc.skeleton(C, th, 3)
    np.testing.assert_array_equal(dense.G, listp.G)
    np.testing.assert_array_equal(dense.sepset, listp.sepset)
    np.testing.assert_array_equal(dense.pmax, listp.pmax)


def test_level1_hub_routes_local_and_matches_dense(monkeypatch):
    """A single hub node above L1_LOCAL_MAX_WIDTH must no longer force the
    whole panel through the dense v^3 sweep (VERDICT r4 #1): the bucketed
    cost model routes it local, and results stay identical to the dense
    route (same tests, same smallest-index tie-breaking)."""
    import cigwas_tpu.skeleton.cupc as cupc

    rng = np.random.default_rng(3)
    n = 4000
    n_z, n_w = 150, 20
    z = rng.normal(size=(n_z, n))
    hub = z.sum(axis=0) / np.sqrt(n_z) + 0.5 * rng.normal(size=n)
    w = np.zeros((n_w, n))
    w[0] = rng.normal(size=n)
    for i in range(1, n_w):
        w[i] = 0.7 * w[i - 1] + np.sqrt(1 - 0.49) * rng.normal(size=n)
    X = np.vstack([hub, z, w])
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(n, 0.05)

    # the hub's degree must exceed the all-or-nothing width gate for the
    # test to exercise the new routing
    res_local = skeleton(C, th, 3)
    deg0 = res_local.G.sum()  # touch to ensure it ran
    assert deg0 > 0
    assert cupc._l1_route_local(
        np.array([n_z + 5]), 256
    ), "cost model should route a lone hub local"
    monkeypatch.setattr(cupc, "L1_LOCAL_COST_RATIO", 1 << 60)
    res_dense = cupc.skeleton(C, th, 3)
    np.testing.assert_array_equal(res_local.G, res_dense.G)
    np.testing.assert_array_equal(res_local.sepset, res_dense.sepset)
    np.testing.assert_array_equal(res_local.pmax, res_dense.pmax)


def test_hetcor_level1_list_path_matches_dense(n10_fixture, monkeypatch):
    import cigwas_tpu.skeleton.cupc as cupc

    C, A, alpha, n = n10_fixture
    v = C.shape[0]
    N = np.full((v, v), float(n), dtype=np.float32)
    th0 = float(threshold_array(n, alpha)[0])
    dense = hetcor_skeleton(C, np.ones((v, v), np.int32), N, th0, 3)
    monkeypatch.setattr(cupc, "DENSE_L1_MAX", 0)
    listp = cupc.hetcor_skeleton(C, np.ones((v, v), np.int32), N, th0, 3)
    np.testing.assert_array_equal(dense.G, listp.G)


def test_level23_local_path_matches_combinatorial():
    """Levels 2/3 route through the dense local-panel recursion
    (`_run_level_local`); it must enumerate the SAME tests as the
    combinatorial chunk scan and pick the same minimizing sepsets.
    Adjacency/sepsets exact; pmax allclose (the recursion
    `cuPC-S.cu:664-699` and the Schur-complement inverse compute the same
    quantity through different float32 op orders)."""
    import cigwas_tpu.skeleton.cupc as cupc

    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        nv, n = 40, 20000
        X = np.zeros((nv, n))
        X[0] = rng.normal(size=n)
        for i in range(1, nv):
            ps = rng.choice(i, size=min(i, 3), replace=False)
            X[i] = sum(0.4 * X[p] for p in ps) + rng.normal(size=n)
        C = np.corrcoef(X).astype(np.float32)
        th = threshold_array(n, 0.01)
        local = skeleton(C, th, 4)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cupc, "LOCAL_LEVELS", ())
            combi = cupc.skeleton(C, th, 4)
        np.testing.assert_array_equal(local.G, combi.G)
        np.testing.assert_array_equal(local.sepset, combi.sepset)
        np.testing.assert_allclose(local.pmax, combi.pmax, rtol=1e-3, atol=1e-5)
        assert local.final_level == combi.final_level


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("ct", [8, 16])
def test_local_sweep_colex_tie_break(level, ct):
    """Exact-tie sepsets must resolve to the LOWEST colex rank. Variable 9
    duplicates variable 1 bit-for-bit, so a conditioning set using 9 ties
    with its 1-twin whenever swapping them leaves the kernel's conditioning
    SEQUENCE unchanged (identical rows -> identical float32 arithmetic):

    * 9 in a non-maximal slot of the pair sweep's (s, t): the twin keeps the
      same t, so the tie is exact and the twin's colex rank is lower -> the
      winning s position is never the 9 slot;
    * 9 as the pair sweep's t with s below the 1 slot: the twin {s, 1} has
      the same s and an identical t row at lower colex -> t == slot9 implies
      s > slot1 (this exercises the cross-chunk strict-< merge, since the
      two slots land in different ct=8 chunks).

    Twins that change the conditioning order (9 as the level-3 outer u) are
    NOT exact ties and are not asserted."""
    from cigwas_tpu.ops.pcorr import (
        RHO_BIG,
        level2_local_sweep,
        level3_local_sweep,
    )

    rng = np.random.default_rng(11)
    nv, n = 18, 4000
    X = rng.normal(size=(nv, n))
    for i in range(2, nv):
        X[i] += 0.5 * X[rng.integers(0, i)]
    X[9] = X[1]  # exact duplicate
    C = np.corrcoef(X).astype(np.float32)

    d = 16
    nodes = np.array([10, 12, 14], dtype=np.int32)
    nbrs = np.stack(
        [np.sort(rng.choice(nv, size=d, replace=False)) for _ in nodes]
    ).astype(np.int32)
    # force both twins into every neighbour list
    for r in range(len(nodes)):
        row = set(nbrs[r].tolist()) | {1, 9}
        row.discard(int(nodes[r]))
        pad = [v for v in range(nv) if v not in row]
        vals = sorted(row)[:d]
        while len(vals) < d:
            vals.append(pad.pop())
        nbrs[r] = np.sort(np.array(vals, dtype=np.int32))
    deg = np.full(len(nodes), d, dtype=np.int32)

    sweep = {2: level2_local_sweep, 3: level3_local_sweep}[level]
    rho, pos = sweep(C, nodes, nbrs, deg, ct)
    rho = np.asarray(rho)
    pos = np.asarray(pos)
    for r in range(len(nodes)):
        slot1 = int(np.where(nbrs[r] == 1)[0][0])
        slot9 = int(np.where(nbrs[r] == 9)[0][0])
        # y rows that ARE one of the twins can't use the other twin (y == s
        # is masked; conditioning var9 on its own copy is non-finite), so
        # the tie argument only applies to the remaining rows
        ys = [y for y in range(nbrs.shape[1]) if y not in (slot1, slot9)]
        live = rho[r][ys] < RHO_BIG
        assert live.any()
        p = pos[r][ys][live]  # ascending positions
        # s (and the level-3 middle element) never land on the 9 slot
        assert not (p[:, 0] == slot9).any()
        # 9 as the pair sweep's t with s < slot1: the twin {s, 1(, u)} keeps
        # the conditioning sequence, ties exactly, and sorts lower in colex
        bad = (p[:, 1] == slot9) & (p[:, 0] < slot1)
        assert not bad.any()


def test_local_tile_plan_merges_small_buckets():
    """`_local_tile_plan`: small degree buckets merge upward while the
    padded-width upgrade is cheaper than a dispatch floor; chunk sizes
    divide the padded width and tiles fit the element budget."""
    import numpy as np

    from cigwas_tpu.skeleton.cupc import (
        LOCAL_ELEM_BUDGET,
        MERGE_SLOT_BUDGET,
        _local_tile_plan,
    )

    deg = np.array([3] * 8 + [20] * 5 + [45] * 100 + [50] * 200)
    active = np.arange(len(deg))
    plan = _local_tile_plan(deg, active, 3)
    covered = np.concatenate([nodes for _, nodes, _, _ in plan])
    assert sorted(covered) == list(active)  # every node exactly once
    for d_pad, nodes, ct, node_tile in plan:
        assert d_pad % 8 == 0 and ct % 8 == 0 and d_pad % ct == 0
        assert node_tile & (node_tile - 1) == 0  # pow2
        assert node_tile * ct * d_pad * d_pad <= LOCAL_ELEM_BUDGET
        assert all(deg[n] <= d_pad for n in nodes)
    # the tiny 3/20-degree buckets merge into the 48-bucket: the upgrade
    # costs ~13 * (48^4 - 24^4) < MERGE_SLOT_BUDGET dense slots
    assert 13 * (48**4 - 24**4) < MERGE_SLOT_BUDGET
    assert len(plan) <= 2

    # an expensive upgrade must NOT merge: 4000 nodes at 48 would cost
    # 4000 * (56^4 - 48^4) > budget slots to lift into the 56 bucket
    deg2 = np.array([45] * 4000 + [55] * 50)
    plan2 = _local_tile_plan(deg2, np.arange(len(deg2)), 3)
    assert len(plan2) == 2
    assert plan2[0][0] == 48 and plan2[1][0] == 56


def _bruteforce_min_pcorr(C, x, nbrs, deg, y_slot, l):
    """Min |pcorr(x, y | S)| over every S of l live neighbour slots other
    than y, float64 through the precision matrix; sets touching a NaN
    entry are not tests. Returns (min, {value: [sets]})."""
    import itertools

    y = int(nbrs[y_slot])
    best, by_val = np.inf, {}
    live = [s for s in range(deg) if s != y_slot]
    for S in itertools.combinations(live, l):
        ixs = [x, y] + [int(nbrs[s]) for s in S]
        sub = C[np.ix_(ixs, ixs)].astype(np.float64)
        if np.isnan(sub).any():
            continue
        P = np.linalg.inv(sub)
        r = abs(P[0, 1] / np.sqrt(P[0, 0] * P[1, 1]))
        by_val.setdefault(r, []).append(S)
        best = min(best, r)
    return best, by_val


@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweeps_scattered_neighbours_match_bruteforce(l):
    """The level-1/2/3 local sweeps on neighbour lists scattered over the
    whole panel, with NaN correlations and padded slots, against a numpy
    brute-force partial-correlation oracle: the same minimum |rho| per
    (node, neighbour) and a minimizing set that attains it."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as pcorr_ops

    rng = np.random.default_rng(20 + l)
    vp, nt, d = 256, 5, 16
    X = rng.normal(size=(vp, 600))
    for i in range(1, vp):
        X[i] += 0.5 * X[rng.integers(0, i)]
    C = np.corrcoef(X).astype(np.float32)
    hole = np.triu(rng.random((vp, vp)) < 0.004, 1)
    C[hole | hole.T] = np.nan
    nodes = rng.choice(vp, nt, replace=False).astype(np.int32)
    nbrs = np.zeros((nt, d), np.int32)
    deg = rng.integers(l + 3, d + 1, nt).astype(np.int32)
    for r, x in enumerate(nodes):
        pool = np.setdiff1d(np.arange(vp), [x])
        nbrs[r, : deg[r]] = np.sort(rng.choice(pool, deg[r], replace=False))
    args = (jnp.asarray(C), jnp.asarray(nodes), jnp.asarray(nbrs),
            jnp.asarray(deg))
    if l == 1:
        rho, pos = pcorr_ops.level1_local_sweep(*args)
        pos = np.asarray(pos)[:, :, None]
    else:
        sweep = {2: pcorr_ops.level2_local_sweep,
                 3: pcorr_ops.level3_local_sweep}[l]
        rho, pos = sweep(*args, 8)
        pos = np.asarray(pos)
    rho = np.asarray(rho)
    checked = 0
    for r, x in enumerate(nodes):
        for y_slot in range(deg[r]):
            best, by_val = _bruteforce_min_pcorr(
                C, int(x), nbrs[r], int(deg[r]), y_slot, l)
            if not np.isfinite(best):
                assert rho[r, y_slot] == pcorr_ops.RHO_BIG
                continue
            np.testing.assert_allclose(rho[r, y_slot], best, atol=2e-5)
            chosen = tuple(int(s) for s in pos[r, y_slot])
            assert any(chosen in sets for v, sets in by_val.items()
                       if abs(v - best) < 2e-5), (r, y_slot, chosen)
            checked += 1
    assert checked > nt * l


@pytest.mark.parametrize("want_pmax", [False, True])
def test_skeleton_local_route_matches_scan_scattered(monkeypatch, want_pmax):
    """The host-loop local-panel route of levels 2/3 (the lean hit-bits
    fetch without pMax, the full rho fetch with it) against the
    combinatorial chunk scan, on an AR(1) panel whose level >= 2 degrees
    span several buckets: adjacency, sepsets and final level exact, pMax
    to float tolerance (different f32 op orders)."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import cupc

    rng = np.random.default_rng(5)
    v, n = 96, 900
    L = rng.normal(size=(v, n))
    for i in range(1, v):
        L[i] = 0.92 * L[i - 1] + np.sqrt(1 - 0.92**2) * L[i]
    C = np.corrcoef(L).astype(np.float32)
    Cp = np.zeros((128, 128), np.float32)
    Cp[:v, :v] = C
    np.fill_diagonal(Cp, 1.0)
    th = threshold_array(n, 1e-2)
    monkeypatch.setattr(cupc, "DEV_RESIDENT_MAX", 0)  # the host loop
    local = cupc.skeleton(jnp.asarray(Cp), th, 5, n_var=v,
                          want_pmax=want_pmax)
    monkeypatch.setattr(cupc, "LOCAL_LEVELS", ())
    scan = cupc.skeleton(jnp.asarray(Cp), th, 5, n_var=v,
                         want_pmax=want_pmax)
    assert local.final_level >= 2
    assert local.final_level == scan.final_level
    np.testing.assert_array_equal(local.G, scan.G)
    np.testing.assert_array_equal(local.sepset, scan.sepset)
    if want_pmax:
        np.testing.assert_allclose(local.pmax, scan.pmax, rtol=1e-3,
                                   atol=1e-5)


def test_level_local_wide_degree_positions_not_truncated():
    """Degrees above 256 must not route through the uint8 hit-bits fetch:
    neighbour-list slots would wrap mod 256 and give silently wrong
    sepsets on the production want_pmax=False path. At a 270-degree node
    both fetches must agree, with positions past slot 255 in use."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import cupc

    rng = np.random.default_rng(7)
    v = 384
    C = (0.3 * rng.normal(size=(v, v))).astype(np.float32)
    C = ((C + C.T) / 2).astype(np.float32)
    np.fill_diagonal(C, 1.0)
    G = np.zeros((v, v), np.int32)
    G[0, 1:271] = 1
    G[1:271, 0] = 1
    C_dev = jnp.asarray(C)
    lean = cupc._run_level_local(C_dev, G, 2, 0.9, want_rho=False)
    full = cupc._run_level_local(C_dev, G, 2, 0.9, want_rho=True)
    ra, (xa, ya, rho_a, sa) = lean
    rb, (xb, yb, _, sb) = full
    assert rho_a is None
    # the neighbour list is 1..270, so variable index == slot + 1
    assert (sa > 256).any()
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(sa, sb)


def test_level_local_threshold_is_traced_not_baked():
    """A second level run with a DIFFERENT threshold in the same process
    must decide with its own threshold: the lean-fetch kernel takes the
    threshold as a traced argument, so its jit cache entry is shared."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import cupc

    rng = np.random.default_rng(11)
    v = 256
    C = (0.4 * rng.normal(size=(v, v))).astype(np.float32)
    C = ((C + C.T) / 2).astype(np.float32)
    np.fill_diagonal(C, 1.0)
    G = np.zeros((v, v), np.int32)
    G[0, 1:65] = 1
    G[1:65, 0] = 1
    C_dev = jnp.asarray(C)
    loose = cupc._run_level_local(C_dev, G, 2, 0.9, want_rho=False)
    assert loose[1][0].size > 0
    tight = cupc._run_level_local(C_dev, G, 2, 1e-6, want_rho=False)
    tight_full = cupc._run_level_local(C_dev, G, 2, 1e-6, want_rho=True)
    np.testing.assert_array_equal(tight[0], tight_full[0])
    np.testing.assert_array_equal(tight[1][0], tight_full[1][0])
    np.testing.assert_array_equal(tight[1][3], tight_full[1][3])
    assert tight[1][0].size < loose[1][0].size
