#!/usr/bin/env python
"""Benchmark: conditional-independence test throughput on one GPU.

Phases (all on the card; the script refuses to run without a GPU):

1. fused step on a synthetic LD block: 2-bit decode -> Kendall-npn
   contingency panel (int8 matmul) -> level-0 Fisher screen -> dense level-1
   CI sweep. Timed AMORTIZED: K steps ride one dispatch inside `lax.scan`
   and the per-step time is (t_K - t_1) / (K - 1), which subtracts the
   dispatch+fetch floor (reported separately). Metric: CI tests/s, plus
   achieved FLOP/s against the card's peak rates (`PEAKS`).
2. attribution: the step's two dominant sub-phases timed alone
   (decode+contingency matmul; dense level-1 sweep).
3. production two-stage path: wall time of corr panel + 3-level skeleton on a
   2048-marker block, with per-level instrumentation — levels >= 2 report
   their exact enumerated (x, S, y) test count per second (the reference's
   hot loop, `cuPC-S.cu:486-3020`).
4. the reference-DEFAULT ~11k-marker block (`ci-gwas.py:75`) through the
   device-resident two-stage flow, with per-level walls.
5. cuskss/hetcor: a merged-scale summary-stat input (v ~ 10k, heterogeneous
   per-pair ESS) through the two-stage hetcor skeleton — the biobank-scale
   path (`cli.cpp:194-346`).
6. chromosome-scale `block`: a 50k-marker banded correlation + LD blocking
   pass (`corr_host.cu:1199-1531`).
7. block-throughput balance: `run_all_blocks` over a synthetic multi-block
   chromosome with 1 and 2 LPT partitions, run one after the other on the
   card (projected scaling).

Prints ONE JSON line. Any phase's failure fails the run.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

M = int(os.environ.get("CIGWAS_BENCH_M", 1024))  # markers
N = int(os.environ.get("CIGWAS_BENCH_N", 16384))  # individuals
P = 8  # traits
K_AMORT = int(os.environ.get("CIGWAS_BENCH_K", 8))  # steps fused per dispatch
REPS = int(os.environ.get("CIGWAS_BENCH_REPS", 3))

# Dense peak rates per device kind (as JAX reports it), from NVIDIA's H100
# data sheet, SXM part, without sparsity; they assume the card's full 700 W
# power limit. A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops": 1979e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def peak_rates(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {device_kind!r}")
    return PEAKS[device_kind]


def _build_step(m, p, th0, th1):
    import jax
    import jax.numpy as jnp

    from cigwas_tpu.ops.corr import _kendall_from_counts
    from cigwas_tpu.ops.decode import (
        contingency_counts,
        geno_onehot,
        geno_value_valid,
        unpack_bed_codes,
    )
    from cigwas_tpu.ops.pcorr import _level1_dense_padded

    def step(bed_bytes, phen):
        codes = unpack_bed_codes(bed_bytes)
        X = geno_onehot(codes).reshape(3 * m, -1)
        counts = contingency_counts(X, X).astype(jnp.float32)
        C_mm = _kendall_from_counts(counts, m, m)
        vals, valid = geno_value_valid(codes)
        n_val = valid.sum(axis=1, keepdims=True)
        mean = (vals * valid).sum(axis=1, keepdims=True) / n_val
        std = jnp.sqrt(((vals - mean) ** 2 * valid).sum(axis=1, keepdims=True) / n_val)
        hi = jax.lax.Precision.HIGHEST
        C_mp = (jnp.dot(vals * valid, phen.T, precision=hi)
                - mean * jnp.dot(valid, phen.T, precision=hi)) / (n_val * std)
        C_pp = jnp.dot(phen, phen.T, precision=hi) / phen.shape[1]
        C = jnp.concatenate(
            [
                jnp.concatenate([C_mm, C_mp], axis=1),
                jnp.concatenate([C_mp.T, C_pp], axis=1),
            ],
            axis=0,
        )
        v = C.shape[0]
        C = jnp.where(jnp.eye(v, dtype=bool), 1.0, C)
        z0 = jnp.abs(0.5 * jnp.log(jnp.abs((1 + C) / (1 - C))))
        G0 = (z0 >= th0) & ~jnp.eye(v, dtype=bool)
        # dense level-1 sweep via the PRODUCTION tiled kernel
        # (`pcorr._level1_dense_padded`); |atanh(rho)| < th <=> |rho| <
        # tanh(th), so the inner loop is transcendental-free. Pad the panel
        # to the tile; pad conditioning columns are masked through G.
        rho_th1 = jnp.tanh(jnp.float32(th1))
        pad = (-v) % 128
        Cp = jnp.pad(C, ((0, pad), (0, pad)))
        Gp = jnp.pad(G0, ((0, pad), (0, pad)))
        rho_min, _ = _level1_dense_padded(Cp, Gp, 128)
        G = G0 & (rho_min[:v, :v] >= rho_th1)
        return G.astype(jnp.int8)

    return step


def _phase_fused_step(result):
    import jax
    import jax.numpy as jnp

    from cigwas_tpu.utils.stats import threshold_array

    th = threshold_array(N, 1e-4)
    step = _build_step(M, P, float(th[0]), float(th[1]))

    def make_runner(k):
        @jax.jit
        def run(beds, phen):
            def body(acc, bb):
                return acc + step(bb, phen).astype(jnp.int32).sum(), None

            s, _ = jax.lax.scan(body, jnp.int32(0), beds)
            return s

        return run

    rng = np.random.default_rng(0)
    phen = rng.normal(size=(P, N)).astype(np.float32)
    phen_d = jax.device_put(phen)
    beds_k = jax.device_put(
        rng.integers(0, 256, size=(K_AMORT, M, N // 4), dtype=np.uint8)
    )
    beds_1 = beds_k[:1]
    run_k, run_1 = make_runner(K_AMORT), make_runner(1)

    # warmup/compile; fetching the scalar synchronizes with the device
    int(run_k(beds_k, phen_d))
    int(run_1(beds_1, phen_d))
    tk, t1 = [], []
    for _ in range(REPS):
        t0 = time.perf_counter()
        int(run_k(beds_k, phen_d))
        tk.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        int(run_1(beds_1, phen_d))
        t1.append(time.perf_counter() - t0)
    per_step = (min(tk) - min(t1)) / (K_AMORT - 1)
    floor = max(min(t1) - per_step, 0.0)

    v = M + P
    ci_tests = v * v + v * v * v  # level-0 + dense level-1 sweep
    # dominant arithmetic: the (3m, n) x (n, 3m) contingency matmul (int8)
    # plus the padded v^3 level-1 sweep (~5 f32 elementwise ops/element)
    vp = v + ((-v) % 128)
    matmul_flops = 2.0 * (3 * M) ** 2 * N
    sweep_flops = 5.0 * vp * vp * vp
    step_flops = matmul_flops + sweep_flops

    peaks = peak_rates(jax.devices()[0].device_kind)
    result.update(
        value=round(ci_tests / per_step, 1),
        step_seconds=round(per_step, 5),
        dispatch_floor_s=round(floor, 4),
        step_tflops=round(step_flops / per_step / 1e12, 2),
        share_of_int8_peak=round(step_flops / per_step / peaks["int8_ops"], 3),
        block_markers=M,
        individuals=N,
    )


def _phase_fused_step_attribution(result):
    """Attribution: time the fused step's two dominant sub-phases alone
    (decode -> int8 contingency matmul -> Kendall epilogue; dense level-1
    sweep), and a raw int8 matmul at the contingency shape."""
    import jax
    import jax.numpy as jnp

    from cigwas_tpu.ops.corr import _kendall_from_counts
    from cigwas_tpu.ops.decode import contingency_counts, geno_onehot, unpack_bed_codes
    from cigwas_tpu.ops.pcorr import _level1_dense_padded

    rng = np.random.default_rng(0)
    beds = jax.device_put(
        rng.integers(0, 256, size=(K_AMORT, M, N // 4), dtype=np.uint8)
    )

    @jax.jit
    def contingency_only(bb):
        def body(acc, b):
            codes = unpack_bed_codes(b)
            X = geno_onehot(codes).reshape(3 * M, -1)
            counts = contingency_counts(X, X).astype(jnp.float32)
            C = _kendall_from_counts(counts, M, M)
            # full-sum consumption: slicing one element would let XLA
            # narrow the matmul (measured: impossible >spec "rates")
            return acc + jnp.sum(C), None

        s, _ = jax.lax.scan(body, jnp.float32(0), bb)
        return s

    vp = M + P + ((-(M + P)) % 128)
    A = rng.normal(size=(vp, 256)).astype(np.float32)

    @jax.jit
    def build_panel(Ad):
        C = Ad @ Ad.T
        d = jax.lax.rsqrt(jnp.diagonal(C))
        C = C * d[:, None] * d[None, :]
        return C, (jnp.abs(C) > 0.05) & ~jnp.eye(vp, dtype=bool)

    C_dev, G_dev = build_panel(jax.device_put(A))
    float(jnp.asarray(C_dev[0, 0]))

    @jax.jit
    def sweep_only(C, G):
        def body(acc, _):
            # acc feeds back into C so XLA cannot hoist the loop-invariant
            # sweep out of the scan
            r, s = _level1_dense_padded(C + acc * 1e-30, G, 128)
            return acc + r[0, 0], None

        out, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(K_AMORT))
        return out

    def timed(fn, *args):
        float(jnp.asarray(fn(*args)))  # warm
        t0 = time.perf_counter()
        for _ in range(REPS):
            float(jnp.asarray(fn(*args)))
        return (time.perf_counter() - t0) / REPS / K_AMORT

    # the SHAPE CEILING: a raw int8 matmul at the contingency shape with
    # no decode and no epilogue, so the contingency's rate can be read
    # against what the card reaches at this shape, not only the data sheet
    X8 = jax.device_put(
        rng.integers(0, 2, size=(3 * M, N), dtype=np.int8)
    )

    @jax.jit
    def raw_int8(X):
        # loop-VARIANT input: a loop-invariant matmul would be hoisted out
        # of the scan and the amortized ceiling would read ~Kx too high
        def body(acc, k):
            c = contingency_counts(X + k.astype(jnp.int8), X)
            return acc + jnp.sum(c), None

        s, _ = jax.lax.scan(body, jnp.int32(0),
                            jnp.arange(K_AMORT, dtype=jnp.int32))
        return s

    t_cont = timed(contingency_only, beds)
    t_sweep = timed(sweep_only, C_dev, G_dev)
    t_raw = timed(raw_int8, X8)
    cont_flops = 2.0 * (3 * M) ** 2 * N
    sweep_flops = 4.0 * float(vp) ** 3
    result["attrib_contingency_s"] = round(t_cont, 5)
    result["attrib_contingency_tops"] = round(cont_flops / t_cont / 1e12, 1)
    result["attrib_l1_sweep_s"] = round(t_sweep, 5)
    result["attrib_l1_sweep_tflops"] = round(sweep_flops / t_sweep / 1e12, 2)
    result["attrib_shape_ceiling_tops"] = round(cont_flops / t_raw / 1e12, 1)
    result["mfu_vs_shape_ceiling"] = round(t_raw / t_cont, 3)


def _phase_block11k(result):
    """The reference's DEFAULT operating point: one ~11k-marker block
    (`ci-gwas.py:75` defaults max_block_size=11000) through the production
    device-resident two-stage flow, with per-level walls."""
    from cigwas_tpu.constants import ML
    from cigwas_tpu.io.bed import encode_bed_values
    from cigwas_tpu.ops.corr import corr_panel_device_tiled
    from cigwas_tpu.skeleton import reduce_gcs, skeleton, subset_variables
    from cigwas_tpu.utils.stats import threshold_array

    m = int(os.environ.get("CIGWAS_BENCH_M11K", 11000))
    n, p = N, P
    rng = np.random.default_rng(0)
    # AR(1) LD structure: a latent AR process over the marker axis gives
    # each marker a realistic correlated neighbourhood (deg ~80 at level 0)
    noise = rng.normal(size=(m, n)).astype(np.float32)
    ar = 0.92
    prev = np.empty((m, n), dtype=np.float32)
    acc = noise[0]
    prev[0] = acc
    scale = np.sqrt(1 - ar**2)
    for i in range(1, m):
        acc = ar * acc + scale * noise[i]
        prev[i] = acc
    pfreq = 1 / (1 + np.exp(-prev * 0.8))
    u1 = rng.random((m, n)).astype(np.float32)
    u2 = rng.random((m, n)).astype(np.float32)
    G = (u1 < pfreq).astype(np.float32) + (u2 < pfreq)
    # planted marker->trait effects (like the 2048 phase): a pure-noise
    # phenotype makes the depth-1 reduction trivial and stage 2 vacuous
    Y = rng.normal(size=(p, n)).astype(np.float32)
    for t in range(p):
        for k in rng.integers(0, m, 5):
            Y[t] += 0.2 * (G[k] - G[k].mean()) / G[k].std()
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    bb = encode_bed_values(G)
    means, stds = G.mean(axis=1), G.std(axis=1)
    th = threshold_array(n, 1e-4)

    scratch: dict = {}

    def run(stats=None, stats2=None):
        marks = {}
        t = time.perf_counter()
        C_dev, v = corr_panel_device_tiled(bb, Y, means, stds, n, stats=stats)
        marks["corr_dispatch"] = time.perf_counter() - t
        t = time.perf_counter()
        res1 = skeleton(
            C_dev, th, 3, C_dev=C_dev, n_var=v, want_pmax=False, stats=stats,
            scratch=scratch,
        )
        marks["stage1"] = time.perf_counter() - t
        t = time.perf_counter()
        keep = subset_variables(res1.G, m + p, m, 1)
        gcs = reduce_gcs(res1.G, C_dev, res1.sepset, keep, m + p, p, 3)
        res2 = skeleton(gcs.C, th, ML, want_pmax=False, stats=stats2)
        marks["reduce_stage2"] = time.perf_counter() - t
        return res1, marks

    run()  # warmup/compile
    # min-of-N over repeated runs
    best = None
    for _ in range(max(1, REPS)):
        stats: dict = {}
        stats2: dict = {}
        t0 = time.perf_counter()
        _, marks = run(stats=stats, stats2=stats2)
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, marks, stats, stats2)
    wall, marks, stats, stats2 = best
    result["block11k_wall_s"] = round(wall, 2)
    result["block11k_phase_wall_s"] = {k: round(v, 2) for k, v in marks.items()}
    lvl = stats.get("level_wall_s", {})
    result["block11k_level_wall_s"] = {k: round(v, 2) for k, v in lvl.items()}
    # stage-1 attribution: l0 (absorbs the async corr-panel compute, which
    # the dispatch mark alone cannot see), the dense-l1 pre-dispatch, the
    # sepset alloc, per-level walls, and whatever remains (host compaction
    # + routing). Panel host phases are attributed separately.
    attributed = (
        stats.get("l0_wall_s", 0.0)
        + stats.get("pre_l1_dispatch_s", 0.0)
        + stats.get("sepset_alloc_s", 0.0)
        + sum(lvl.values())
        + stats.get("final_fetch_s", 0.0)
    )
    result["block11k_stage1_attrib_s"] = {
        "l0_screen": round(stats.get("l0_wall_s", 0.0), 2),
        "pre_l1_dispatch": round(stats.get("pre_l1_dispatch_s", 0.0), 2),
        "sepset_alloc": round(stats.get("sepset_alloc_s", 0.0), 2),
        "levels": round(sum(lvl.values()), 2),
        "final_fetch": round(stats.get("final_fetch_s", 0.0), 2),
        "residual": round(
            stats.get("skeleton_wall_s", marks["stage1"]) - attributed, 2
        ),
    }
    result["block11k_panel_attrib_s"] = {
        k.replace("panel_", "").rstrip("_s"): round(v, 2)
        for k, v in stats.items() if k.startswith("panel_")
    }
    # stage-2 walls per level (ML=14 path: the combinatorial chunk scan's
    # device behavior at real degrees)
    result["block11k_stage2_level_wall_s"] = {
        k: round(v, 2) for k, v in stats2.get("level_wall_s", {}).items()
    }
    lvl2 = stats2.get("level_wall_s", {})
    deep2 = sum(w_ for l, w_ in lvl2.items() if l >= 2)
    if stats2.get("ci_tests") and deep2 > 0:
        result["block11k_stage2_level2plus_tests_per_sec"] = round(
            stats2["ci_tests"] / deep2, 1
        )
    deep = sum(w_ for l, w_ in lvl.items() if l >= 2)
    if stats.get("ci_tests") and deep > 0:
        result["block11k_level2plus_tests_per_sec"] = round(
            stats["ci_tests"] / deep, 1
        )


def _phase_cuskss(result):
    """First device benchmark of the summary-stat (cuskss/hetcor) path —
    the biobank-scale path BASELINE.md names:
    a merged-scale input (AR-LD mxm, mxp with planted effects + LD smear,
    pxp with SE-derived heterogeneous per-pair ESS) at v ~ 10k through the
    two-stage `run_cusk`, reporting wall + per-level walls + level>=2
    tests/s. Match: `cli.cpp:194-346`, `hetcor-cuPC-S.cu:75-341`.
    """
    from cigwas_tpu.io.results import ReducedGC
    from cigwas_tpu.pipelines.cuskss import run_cusk
    from cigwas_tpu.utils.stats import hetcor_threshold

    m = int(os.environ.get("CIGWAS_BENCH_MSS", 10000))
    p = 8
    n_gwas = 5.0e5  # UKB scale; thresholds at n=5e5 like `cupc_tests.cpp:13`
    rng = np.random.default_rng(2)
    # mxm: AR(1) LD correlation rho^|i-j| (the summary-stat form of the
    # 11k phase's latent AR panel); reference reads this as a binary tril
    # (`marker_summary_stats.cpp:8-24`)
    ii = np.arange(m, dtype=np.float32)
    mxm = (0.92 ** np.abs(ii[:, None] - ii[None, :])).astype(np.float32)
    # mxp: 5 planted causal markers per trait (|corr| ~ 0.03, well above
    # the marginal threshold at n=5e5) + GWAS sampling noise; LD smears
    # each effect over its AR neighbourhood exactly as real data would
    mxp = (rng.normal(size=(m, p)) / np.sqrt(n_gwas)).astype(np.float32)
    for t in range(p):
        for k in rng.integers(0, m, 5):
            mxp[:, t] += 0.03 * mxm[:, k]
    pxp = np.full((p, p), 0.1, np.float32) + 0.9 * np.eye(p, dtype=np.float32)
    v = m + p
    sq_corrs = np.ones((v, v), dtype=np.float32)
    sq_corrs[:m, :m] = mxm
    sq_corrs[:m, m:] = mxp
    sq_corrs[m:, :m] = mxp.T
    sq_corrs[m:, m:] = pxp
    # heterogeneous ESS: pearson N everywhere, per-entry GWAS sample sizes
    # on the mxp/pxp blocks — the layout `make_square_cuskss_inputs`
    # produces (`cli.cpp:89-173`); pxp entries follow the SE -> ESS map
    # N = ((1 - rho^2)/se)^2 (`trait_summary_stats.cpp:94-169`)
    sq_ess = np.full((v, v), n_gwas, dtype=np.float32)
    mp_ess = rng.uniform(3e5, 5e5, size=(m, p)).astype(np.float32)
    sq_ess[:m, m:] = mp_ess
    sq_ess[m:, :m] = mp_ess.T
    pp_se = (1.0 - pxp**2) / np.sqrt(rng.uniform(3e5, 5e5, size=(p, p)))
    with np.errstate(invalid="ignore", divide="ignore"):
        pp_ess = ((1.0 - pxp**2) / pp_se) ** 2
    np.fill_diagonal(pp_ess, n_gwas)  # rho=1 diagonal has no defined SE
    sq_ess[m:, m:] = pp_ess
    th = hetcor_threshold(1e-4)
    # stage the panels on device ONCE (timed separately): upload the
    # COMPACT inputs — the mxm lower triangle (the reference's binary
    # file format) + the mxp/pxp blocks — and assemble the (v, v) panels
    # on device (`assemble_cuskss_panels_device`); the cuskss flow keeps
    # them device-resident instead of re-uploading ~800 MB of assembled
    # squares per run
    import jax.numpy as jnp

    from cigwas_tpu.pipelines.cuskss import assemble_cuskss_panels_device

    t0 = time.perf_counter()
    tril = sq_corrs[:m, :m][np.tril_indices(m)]
    C_dev, N_dev = assemble_cuskss_panels_device(
        tril, mxp, pxp, n_gwas, mp_ess=mp_ess, pp_ess=sq_ess[m:, m:],
    )
    float(jnp.asarray(C_dev[0, 0]))
    float(jnp.asarray(N_dev[0, 0]))
    result["cuskss_upload_s"] = round(time.perf_counter() - t0, 2)
    gc0 = ReducedGC(
        num_var=v, num_phen=p, max_level=3,
        new_to_old_indices=np.arange(v, dtype=np.int32),
        G=np.ones((v, v), dtype=np.int32), C=C_dev, S=N_dev,
    )

    def run(stats1=None, stats2=None):
        g1 = run_cusk(gc0, th, 1, 3, [1] * p, stats=stats1)
        return run_cusk(g1, th, 1, 14, [1] * p, stats=stats2)

    run()  # warmup/compile
    best = None
    for _ in range(max(1, min(REPS, 2))):
        stats1: dict = {}
        stats2: dict = {}
        t0 = time.perf_counter()
        g2 = run(stats1=stats1, stats2=stats2)
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, stats1, stats2, g2)
    wall, stats1, stats2, g2 = best
    result["cuskss_markers"] = m
    result["cuskss_wall_s"] = round(wall, 2)
    result["cuskss_level_wall_s"] = {
        str(k): round(w, 2) for k, w in stats1.get("level_wall_s", {}).items()
    }
    result["cuskss_stage2_level_wall_s"] = {
        str(k): round(w, 2) for k, w in stats2.get("level_wall_s", {}).items()
    }
    result["cuskss_markers_retained"] = int(g2.num_markers())
    result["cuskss_l1_detail"] = {
        k: round(w, 2) if isinstance(w, float) else w
        for k, w in stats1.get("level_detail", {}).get(1, {}).items()
    }
    deep = sum(
        w for st in (stats1, stats2)
        for l, w in st.get("level_wall_s", {}).items() if l >= 2
    )
    tests = stats1.get("ci_tests", 0) + stats2.get("ci_tests", 0)
    if tests and deep > 0:
        result["cuskss_level2plus_tests_per_sec"] = round(tests / deep, 1)


def _phase_block50k(result):
    """Chromosome-scale `block`: stream a >= 50k-marker synthetic
    chromosome through the banded correlation + LD blocking. Reports wall
    and effective decoded-genotype GB/s. Match: `corr_host.cu:1199-1531`, `io.cpp:251-264`.
    """
    from cigwas_tpu.blocking import block_chr
    from cigwas_tpu.io.bed import encode_bed_values
    from cigwas_tpu.ops.corr import banded_row_abs_sums_streaming

    m = int(os.environ.get("CIGWAS_BENCH_M50K", 50000))
    n = 8192
    corr_width = 2000  # the reference default (`ci-gwas.py:89-90`)
    rng = np.random.default_rng(5)
    # AR(1) LD over the full chromosome, built row-blockwise to bound host
    # memory (the .bed bytes are what actually ship to the device)
    bb = np.empty((m, n // 4), dtype=np.uint8)
    acc = rng.normal(size=n).astype(np.float32)
    ar, scale = 0.92, float(np.sqrt(1 - 0.92**2))
    blk = 4096
    for b0 in range(0, m, blk):
        rows = np.empty((min(blk, m - b0), n), dtype=np.float32)
        for i in range(rows.shape[0]):
            acc = ar * acc + scale * rng.normal(size=n).astype(np.float32)
            rows[i] = acc
        pf = 1 / (1 + np.exp(-rows * 0.8))
        dose = (rng.random(rows.shape) < pf).astype(np.float32) + (
            rng.random(rows.shape) < pf
        )
        bb[b0 : b0 + rows.shape[0]] = encode_bed_values(dose)

    def run():
        sums = banded_row_abs_sums_streaming(bb, n, corr_width)
        return block_chr(sums, 1, 11000)

    blocks = run()  # warmup/compile
    best = None
    for _ in range(max(1, min(REPS, 2))):
        t0 = time.perf_counter()
        blocks = run()
        w = time.perf_counter() - t0
        best = w if best is None else min(best, w)
    result["block50k_wall_s"] = round(best, 2)
    result["block50k_blocks"] = len(blocks)
    # packed .bed bytes streamed through host->device per pass, and the
    # achieved contingency-matmul rate at the banded tile shapes
    result["block50k_bed_gbps"] = round((m * n / 4) / best / 1e9, 3)
    row_tile = 2048
    n_pad = 4 * (((n // 4 + 31) // 32) * 32)
    tiles = -(-m // row_tile)
    flops = tiles * 2.0 * (3 * row_tile) * (3 * (row_tile + corr_width)) * n_pad
    result["block50k_tops"] = round(flops / best / 1e12, 1)


def _phase_production_block(result):
    """Corr panel + 3-level skeleton on a banded 2048-marker block, with the
    per-level instrumentation surfacing level >= 2 enumerated-test rate."""
    from cigwas_tpu.io.bed import encode_bed_values
    from cigwas_tpu.ops.corr import corr_panel_device
    from cigwas_tpu.skeleton import skeleton
    from cigwas_tpu.utils.stats import threshold_array

    rng = np.random.default_rng(0)
    m, n, p = 2048, 16384, 8
    G = np.empty((m, n), dtype=np.float32)
    prev = rng.normal(size=n)
    for i in range(m):
        prev = 0.92 * prev + np.sqrt(1 - 0.92**2) * rng.normal(size=n)
        pfreq = 1 / (1 + np.exp(-prev * 0.8))
        G[i] = (rng.random(n) < pfreq) + (rng.random(n) < pfreq)
    Y = rng.normal(size=(p, n)).astype(np.float32)
    for t in range(p):
        for k in rng.integers(0, m, 5):
            Y[t] += 0.2 * (G[k] - G[k].mean()) / G[k].std()
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    bb = encode_bed_values(G)
    means = G.mean(axis=1)
    stds = G.std(axis=1)
    th = threshold_array(n, 1e-4)

    def run_block(stats=None):
        C_dev, v = corr_panel_device(bb, Y, means, stds, n)
        return skeleton(C_dev, th, 3, n_var=v, stats=stats)

    run_block()  # warmup/compile
    # min-of-N over repeated runs
    best = None
    for _ in range(max(1, REPS)):
        stats: dict = {}
        t0 = time.perf_counter()
        run_block(stats=stats)
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, stats)
    wall, stats = best
    result["block2048_wall_s"] = round(wall, 2)
    result["block2048_level_wall_s"] = {
        str(k): round(v, 3) for k, v in stats.get("level_wall_s", {}).items()
    }
    lvl_wall = stats.get("level_wall_s", {})
    deep_wall = sum(w for l, w in lvl_wall.items() if l >= 2)
    if stats.get("ci_tests") and deep_wall > 0:
        result["level2plus_ci_tests"] = int(stats["ci_tests"])
        result["level2plus_tests_per_sec"] = round(stats["ci_tests"] / deep_wall, 1)


def _phase_partition_scaling(result):
    """Projected block-throughput scaling from LPT partition balance: the two
    partition walls are measured one after the other on the one card, so
    scaling = t_1partition / (2 * max wall)."""
    from cigwas_tpu.cli import main as cli_main
    from cigwas_tpu.constants import BED_PREFIX_COL_MAJ
    from cigwas_tpu.io.bed import encode_bed_values
    from cigwas_tpu.parallel import run_all_blocks

    rng = np.random.default_rng(11)
    n = int(os.environ.get("CIGWAS_BENCH_SCALE_N", 8192))
    m = int(os.environ.get("CIGWAS_BENCH_SCALE_M", 3072))
    blk = max(64, m // 6)
    maf = rng.uniform(0.1, 0.5, m)
    dose = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )
    # polygenic traits: causal markers spread over every block, as in real
    # genome-wide data — all blocks pass the marker-phen pre-screen and the
    # partition balance is exercised on real skeleton work
    causal = np.arange(m // 64 // 2, m, m // 64)
    stdd = (dose - dose.mean(1, keepdims=True)) / dose.std(1, keepdims=True)
    y0 = stdd[causal[0::2]].sum(axis=0) * 0.25 + rng.normal(size=n)
    y1 = stdd[causal[1::2]].sum(axis=0) * 0.25 + 0.5 * y0
    Y = np.stack([y0, y1 + rng.normal(size=n)])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)

    with tempfile.TemporaryDirectory() as td:
        stem = os.path.join(td, "sim")
        with open(stem + ".bed", "wb") as f:
            f.write(BED_PREFIX_COL_MAJ)
            f.write(encode_bed_values(dose).tobytes())
        with open(stem + ".bim", "w") as f:
            for i in range(m):
                f.write(f"1\trs{i}\t0\t{1000 * i}\tA\tG\n")
        with open(stem + ".fam", "w") as f:
            for i in range(n):
                f.write(f"F{i} I{i} 0 0 0 -9\n")
        with open(stem + ".phen", "w") as f:
            f.write("FID\tIID\tT0\tT1\n")
            for i in range(n):
                f.write(f"F{i}\tI{i}\t" + "\t".join(f"{v:.6f}" for v in Y[:, i]) + "\n")
        cli_main(["prep-bed", stem])
        cli_main(["block", stem, str(blk), "10", "64"])
        blockfile = stem + f"_m{blk}.blocks"

        def one_pass(tag, nparts):
            outdir = os.path.join(td, f"out_{tag}")
            os.makedirs(outdir, exist_ok=True)
            walls = []
            for pi in range(nparts):
                t0 = time.perf_counter()
                run_all_blocks(
                    stem + ".phen", stem, blockfile, 1e-4, 3, 14, 1, outdir,
                    num_partitions=nparts, partition_index=pi, verbose=False,
                )
                walls.append(time.perf_counter() - t0)
            return np.array(walls)

        one_pass("warm", 1)  # compile warmup
        # min over reps tames host jitter; scaling is capped at 1.0 (one
        # card runs both partitions one after the other, so any apparent
        # superlinearity is noise)
        t1 = min(one_pass("p1a", 1)[0], one_pass("p1b", 1)[0])
        walls2 = np.minimum(one_pass("p2a", 2), one_pass("p2b", 2))
        result["blocks_wall_1part_s"] = round(t1, 2)
        result["blocks_wall_2part_s"] = [round(w, 2) for w in walls2]
        result["projected_scaling_2part"] = round(
            min(1.0, t1 / (2 * max(walls2))), 3
        )


def main() -> int:
    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()}", file=sys.stderr)
        return 1
    peak_rates(d0.device_kind)  # an unknown card is an error up front
    result = {
        "metric": "ci_tests_per_sec",
        "value": 0.0,
        "unit": "CI tests/s (level-0+1 partial-corr tests, fused step, amortized)",
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
    }
    _phase_fused_step(result)
    if os.environ.get("CIGWAS_BENCH_FULL", "1") != "0":
        _phase_fused_step_attribution(result)
        _phase_production_block(result)
        _phase_block11k(result)
        _phase_cuskss(result)
        _phase_block50k(result)
        _phase_partition_scaling(result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
