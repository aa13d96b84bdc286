#!/usr/bin/env python
"""Smoke run of the production path on an NVIDIA GPU — not a benchmark.

    python chip_smoke.py [--seed N] [--workdir DIR]
    python chip_smoke.py --multichip [--seed N] [--workdir DIR]

Without options it needs one GPU and drives, through the `ci-gwas-tpu` CLI
entry points and at the reference's default widths (`ci-gwas.py:75`):

* the individual-level pipeline on one seeded chromosome of 22,000 markers
  in AR(1) LD segments, 16,384 individuals and 3 traits with planted
  marker->trait effects and one trait->trait edge: prep-bed, block (max
  block 11000, corr width 2000), cusk-all (alpha 1e-4, levels 3/14, depth
  1), merge-block-outputs, sepselect, srfci, mvivw. The merged skeleton
  must hold exactly the planted trait edge and every planted SNP->trait
  adjacency;
* cuskss on summary statistics at v = 10,000 with heterogeneous per-pair
  sample sizes and distinct trait time indices;
* comparisons with the plain path on the CPU, computed by a child process
  that never opens the card: a 2,048-marker block (adjacency and sepsets
  exact), the hetcor skeleton at v = 2,048 (adjacency exact), and a
  512-row stripe of an 11k-marker correlation panel against a float64
  numpy Kendall-npn (int8 counts exact, |delta| <= 1e-5);
* a rerun of the 2,048-marker block, byte for byte;
* the `gpu`-marked tests, in this process.

Along the way it prints the card's name and power limit, each phase's wall
and compile seconds, the local-panel gather's achieved bytes/s from a
profiler trace, the lowering of the int8 contingency dot,
`memory_analysis()` of the largest level launch and the peak device memory
(all of it "smoke, not a benchmark"). Its last line is
`{"ok": true, "device": {...}}` when every phase passed; it exits non-zero
without that line when JAX finds no GPU or any phase fails.

--multichip needs four GPUs and runs only the paths that span cards:
`cusk --mesh 4` on one 11k block in both panel modes, and block-parallel
`cusk-all --num-partitions 4`, one process per card pinned with
`CUDA_VISIBLE_DEVICES`, each compared byte for byte with the one-card run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    markers: int = 22000  # one chromosome
    samples: int = 16384
    max_block: int = 11000  # ci-gwas.py:75 defaults
    corr_width: int = 2000
    alpha: float = 1e-4
    cuskss_markers: int = 9992  # v = 10,000 with 8 traits
    cuskss_traits: int = 8
    cmp_block: int = 2048
    cmp_hetcor_v: int = 2048
    stripe_rows: int = 512
    multichip_markers: int = 44000  # >= 4 blocks of <= 11000


FULL = Sizes()
# the rehearsal size for CPU runs of the same phases
TINY = Sizes(
    markers=640, samples=2048, max_block=320, corr_width=40,
    cuskss_markers=184, cuskss_traits=8, cmp_block=128, cmp_hetcor_v=96,
    stripe_rows=32, multichip_markers=1280,
)


# ---------------------------------------------------------------------------
# compile seconds, from JAX's own monitoring events
# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds XLA spent compiling in this process (JAX's backend-compile
    events; tracing and lowering are not counted)."""

    def __init__(self):
        self.total = 0.0
        self._installed = False

    def install(self) -> None:
        if self._installed:
            return
        import jax

        def listen(event, duration_secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.total += duration_secs

        jax.monitoring.register_event_duration_secs_listener(listen)
        self._installed = True


CLOCK = CompileClock()


@contextlib.contextmanager
def timed(name: str, walls: dict):
    t0, c0 = time.perf_counter(), CLOCK.total
    yield
    wall, comp = time.perf_counter() - t0, CLOCK.total - c0
    walls[name] = (wall, comp)
    log(f"{name}: wall {wall:.3f} s, compile {comp:.3f} s "
        "(smoke, not a benchmark)")


def cli(argv: list, walls: dict | None = None, name: str | None = None):
    """One `ci-gwas-tpu` subcommand, in process."""
    from cigwas_tpu.cli import main

    if walls is None:
        main([str(a) for a in argv])
        return
    with timed(name or argv[0], walls):
        main([str(a) for a in argv])


def card_info() -> str:
    """The card's name and power limit, from a child that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# seeded data
# ---------------------------------------------------------------------------


def simulate_genotypes(rng, m: int, n: int, keep: list, ar: float = 0.92,
                       seg=(400, 2400), rows: int = 1024):
    """Packed .bed bytes (m, ceil(n/4)) of AR(1) LD segments: a latent
    AR(1) process over the marker axis, restarted at random segment
    boundaries, sets each individual's allele frequency. Returns the bytes
    and the dosages of the `keep` rows."""
    from cigwas_tpu.io.bed import encode_bed_values

    bb = np.empty((m, (n + 3) // 4), np.uint8)
    kept = {}
    scale = np.float32(np.sqrt(1.0 - ar * ar))
    z = rng.standard_normal(n, dtype=np.float32)
    next_reset = 0
    for r0 in range(0, m, rows):
        k = min(rows, m - r0)
        lat = np.empty((k, n), np.float32)
        for i in range(k):
            if r0 + i == next_reset:
                z = rng.standard_normal(n, dtype=np.float32)
                next_reset += int(rng.integers(seg[0], seg[1]))
            else:
                z = np.float32(ar) * z + scale * rng.standard_normal(
                    n, dtype=np.float32)
            lat[i] = z
        pf = 1.0 / (1.0 + np.exp(-0.8 * lat))
        g = (rng.random((k, n), dtype=np.float32) < pf).astype(np.float32)
        g += rng.random((k, n), dtype=np.float32) < pf
        bb[r0:r0 + k] = encode_bed_values(g)
        for c in keep:
            if r0 <= c < r0 + k:
                kept[c] = g[c - r0].copy()
    return bb, kept


def plant_traits(rng, dosages: list, n: int) -> np.ndarray:
    """Three standardized traits: T0 <- SNPs 0, 1; T1 <- SNP 2 and T0;
    T2 <- SNP 3. The planted trait edge is T0 - T1."""

    def std(v):
        return (v - v.mean()) / v.std()

    d = [std(x) for x in dosages]
    y0 = 0.2 * d[0] + 0.2 * d[1] + rng.standard_normal(n)
    y1 = 0.2 * d[2] + 0.4 * std(y0) + rng.standard_normal(n)
    y2 = 0.2 * d[3] + rng.standard_normal(n)
    Y = np.stack([y0, y1, y2])
    return ((Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)).astype(
        np.float32)


def write_plink(stem: str, bb: np.ndarray, Y: np.ndarray) -> None:
    from cigwas_tpu.constants import BED_PREFIX_COL_MAJ

    m = bb.shape[0]
    n = Y.shape[1]
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(bb.tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\trs{i}\t0\t{1000 * (i + 1)}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))
    with open(stem + ".phen", "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(len(Y)))
                + "\n")
        f.writelines(
            f"F{i}\tI{i}\t" + "\t".join(f"{v:.6f}" for v in Y[:, i]) + "\n"
            for i in range(n)
        )


def chromosome(sz: Sizes, seed: int, m: int, stem: str):
    """Seeded chromosome with planted structure, written as PLINK files.
    Returns (bed bytes, traits, planted [(snp, trait)])."""
    rng = np.random.default_rng(seed)
    causal = [int(f * m) for f in (0.1, 0.35, 0.6, 0.85)]
    bb, kept = simulate_genotypes(rng, m, sz.samples, causal)
    Y = plant_traits(rng, [kept[c] for c in causal], sz.samples)
    write_plink(stem, bb, Y)
    planted = [(causal[0], 0), (causal[1], 0), (causal[2], 1), (causal[3], 2)]
    return bb, Y, planted


def hetcor_inputs(seed: int, v: int):
    """(C, N, time index) for a hetcor skeleton: sample correlations of a
    segmented AR(1) latent, heterogeneous per-pair sample sizes around the
    latent's own size, random time indices."""
    rng = np.random.default_rng(seed)
    n_lat = 3 * v
    X = np.empty((v, n_lat))
    X[0] = rng.standard_normal(n_lat)
    for i in range(1, v):
        e = rng.standard_normal(n_lat)
        X[i] = e if i % 256 == 0 else 0.8 * X[i - 1] + 0.6 * e
    C = np.corrcoef(X).astype(np.float32)
    N = rng.uniform(0.5 * n_lat, 1.5 * n_lat, (v, v))
    N = ((N + N.T) / 2).astype(np.float32)
    t = rng.integers(0, 4, v).astype(np.int32)
    return C, N, t


def read_bed_rows(stem: str, first: int, count: int, n: int) -> np.ndarray:
    bpr = (n + 3) // 4
    mm = np.memmap(stem + ".bed", np.uint8, mode="r", offset=3)
    return np.array(mm[first * bpr:(first + count) * bpr]).reshape(count, bpr)


def read_blocks(path: str) -> list:
    from cigwas_tpu.io.blocks import read_blocks_from_file

    return read_blocks_from_file(path)


def largest_block(blocks: list):
    return max(blocks, key=lambda b: b.block_size())


def files_identical(dir_a: str, dir_b: str, names: list) -> list:
    """Names whose bytes differ (or that are missing) between two dirs."""
    bad = []
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if not (os.path.exists(a) and os.path.exists(b)
                and filecmp.cmp(a, b, shallow=False)):
            bad.append(name)
    return bad


# ---------------------------------------------------------------------------
# numpy reference of the Kendall-npn panel
# ---------------------------------------------------------------------------


def numpy_counts(rows_bb: np.ndarray, cols_bb: np.ndarray, n: int):
    """Channel-major 3x3 contingency counts (3r, 3c) as float64, from
    float32 one-hot products (exact: every count < 2^24)."""
    from cigwas_tpu.io.bed import decode_bed_values

    def onehot(bb):
        vals, valid = decode_bed_values(bb, n)
        return np.concatenate(
            [((vals == g) & (valid > 0)).astype(np.float32) for g in (0, 1, 2)]
        )

    A = onehot(rows_bb)
    out = np.empty((A.shape[0], 3 * cols_bb.shape[0]), np.float64)
    c = cols_bb.shape[0]
    step = 2048
    for c0 in range(0, c, step):
        B = onehot(cols_bb[c0:c0 + step])
        k = B.shape[0] // 3
        prod = A @ B.T
        for g in range(3):
            out[:, g * c + c0:g * c + c0 + k] = prod[:, g * k:(g + 1) * k]
    return out


def numpy_kendall_npn(counts: np.ndarray, r: int, c: int) -> np.ndarray:
    """sin(pi/2 tau_b) per pair from its 3x3 table, in float64, from the
    textbook definition: concordant minus discordant pairs over the
    geometric mean of the pairs untied in each variable."""
    T = [[counts[a * r:(a + 1) * r, b * c:(b + 1) * c] for b in range(3)]
         for a in range(3)]
    conc = sum(T[a][b] * T[a2][b2]
               for a in range(3) for a2 in range(a + 1, 3)
               for b in range(3) for b2 in range(b + 1, 3))
    disc = sum(T[a][b] * T[a2][b2]
               for a in range(3) for a2 in range(a + 1, 3)
               for b in range(3) for b2 in range(b))
    rows = [sum(T[a][b] for b in range(3)) for a in range(3)]
    cols = [sum(T[a][b] for a in range(3)) for b in range(3)]
    tot = sum(rows)
    n0 = tot * (tot - 1) / 2
    n1 = sum(x * (x - 1) / 2 for x in rows)
    n2 = sum(x * (x - 1) / 2 for x in cols)
    tau = (conc - disc) / np.sqrt((n0 - n1) * (n0 - n2))
    return np.sin(np.pi / 2 * tau)


# ---------------------------------------------------------------------------
# the CPU side of the comparisons (child process, JAX_PLATFORMS=cpu)
# ---------------------------------------------------------------------------


def cpu_reference(cmpdir: str) -> None:
    """Computes the plain path's answers on the CPU into `cmpdir`."""
    with open(os.path.join(cmpdir, "config.json")) as f:
        cfg = json.load(f)
    import jax

    CLOCK.install()
    if jax.devices()[0].platform != "cpu":
        raise RuntimeError("the CPU reference must run on the CPU platform")
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import hetcor_skeleton
    from cigwas_tpu.utils.stats import hetcor_threshold

    walls: dict = {}
    out = os.path.join(cmpdir, "cpu_block")
    os.makedirs(out)
    cli(["cusk", 0, cfg["blockfile"], cfg["stem"], cfg["stem"] + ".phen",
         cfg["alpha"], 3, 14, 1, out], walls, "cpu cusk 2048 block")
    with timed("cpu hetcor skeleton", walls):
        C, N, t = hetcor_inputs(cfg["seed"], cfg["hetcor_v"])
        v = C.shape[0]
        res = hetcor_skeleton(
            jnp.asarray(C), np.ones((v, v), np.int32), jnp.asarray(N),
            hetcor_threshold(cfg["alpha"]), 3, time_index=t,
        )
        np.save(os.path.join(cmpdir, "cpu_hetcor.npy"), res.G)
    with timed("numpy Kendall-npn stripe", walls):
        n = cfg["samples"]
        cols = read_bed_rows(cfg["chr_stem"], cfg["stripe_first"],
                             cfg["stripe_cols"], n)
        rows = cols[: cfg["stripe_rows"]]
        counts = numpy_counts(rows, cols, n)
        npn = numpy_kendall_npn(counts, rows.shape[0], cols.shape[0])
        np.save(os.path.join(cmpdir, "cpu_counts.npy"), counts)
        np.save(os.path.join(cmpdir, "cpu_npn.npy"), npn)
    with open(os.path.join(cmpdir, "cpu_done.json"), "w") as f:
        json.dump(walls, f)


def start_cpu_reference(cmpdir: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         cmpdir],
        env=env,
    )


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------


def phase_pipeline(sz: Sizes, work: str, seed: int, walls: dict) -> dict:
    """Seeded chromosome through the seven CLI stages; planted structure
    must be recovered."""
    from scipy.io import mmread

    with timed("simulate chromosome", walls):
        stem = os.path.join(work, "chr")
        bb, Y, planted = chromosome(sz, seed, sz.markers, stem)
    blockfile = f"{stem}_m{sz.max_block}.blocks"
    out = os.path.join(work, "out")
    os.makedirs(out)
    merged = os.path.join(out, "merged_blocks")
    sep_stem = os.path.join(out, "max_sep_min_pc")
    a, n = sz.alpha, sz.samples
    cli(["prep-bed", stem], walls)
    cli(["block", stem, sz.max_block, 10, sz.corr_width], walls)
    cli(["cusk-all", blockfile, stem, stem + ".phen", a, 3, 14, 1, out], walls)
    cli(["merge-block-outputs", out, blockfile], walls)
    cli(["sepselect", merged, a, n], walls)
    cli(["srfci", sep_stem, a, n], walls)
    cli(["mvivw", merged, n], walls)

    blocks = read_blocks(blockfile)
    log(f"blocks: {[b.to_file_string() for b in blocks]}")
    for path in (sep_stem + "_estimated_pag.mtx",
                 merged + "_mvivw_results.tsv"):
        if not os.path.exists(path):
            raise AssertionError(f"missing output {path}")
    P = Y.shape[0]
    sam = mmread(merged + "_sam.mtx").toarray()
    gmi = np.fromfile(merged + ".ixs", dtype=np.int32)
    row_of = {int(g): P + i for i, g in enumerate(gmi)}
    trait_edges = sorted(
        (i, j) for i in range(P) for j in range(i + 1, P) if sam[i, j]
    )
    found = {
        (s, t): s in row_of and bool(sam[row_of[s], t]) for s, t in planted
    }
    snp_trait = int((sam[P:, :P] != 0).sum())
    log(f"merged skeleton: {len(gmi)} markers kept, trait edges "
        f"{trait_edges} (planted [(0, 1)]), planted SNP->trait adjacency "
        f"{found}, SNP-trait adjacencies in all {snp_trait}")
    if trait_edges != [(0, 1)] or not all(found.values()):
        raise AssertionError("planted structure not recovered")
    return {"bb": bb, "Y": Y, "stem": stem, "blocks": blocks}


def phase_prepare_compare(sz: Sizes, work: str, seed: int, chr_state: dict,
                          walls: dict) -> dict:
    """Writes the 2,048-marker block and the comparison config, and starts
    the CPU reference child."""
    cmpdir = os.path.join(work, "cmp")
    os.makedirs(cmpdir)
    with timed("simulate comparison block", walls):
        stem = os.path.join(cmpdir, "blk")
        chromosome(sz, seed + 1, sz.cmp_block, stem)
        blockfile = stem + ".blocks"
        with open(blockfile, "w") as f:
            f.write(f"1\t0\t{sz.cmp_block - 1}\n")
    cli(["prep-bed", stem], walls, "prep-bed comparison block")
    blk = largest_block(chr_state["blocks"])
    cfg = {
        "seed": seed, "alpha": sz.alpha, "samples": sz.samples,
        "stem": stem, "blockfile": blockfile, "hetcor_v": sz.cmp_hetcor_v,
        "chr_stem": chr_state["stem"],
        "stripe_first": blk.get_first_marker_global_ix(),
        "stripe_cols": blk.block_size(), "stripe_rows": sz.stripe_rows,
    }
    with open(os.path.join(cmpdir, "config.json"), "w") as f:
        json.dump(cfg, f)
    return {"cmpdir": cmpdir, "cfg": cfg,
            "child": start_cpu_reference(cmpdir)}


def phase_compare_device(sz: Sizes, state: dict, chr_state: dict,
                         walls: dict) -> dict:
    """The device side of the comparisons, and the byte-for-byte rerun."""
    import jax.numpy as jnp

    from cigwas_tpu.native import bed_col_stats
    from cigwas_tpu.ops.corr import (
        DEFAULT_SAMPLE_CHUNK, _kendall_counts_block, _prep_bytes,
        corr_panel_device_tiled,
    )
    from cigwas_tpu.skeleton import hetcor_skeleton
    from cigwas_tpu.utils.stats import hetcor_threshold

    cfg, cmpdir = state["cfg"], state["cmpdir"]
    runs = []
    for tag in ("a", "b"):
        out = os.path.join(cmpdir, f"dev_block_{tag}")
        os.makedirs(out)
        cli(["cusk", 0, cfg["blockfile"], cfg["stem"], cfg["stem"] + ".phen",
             sz.alpha, 3, 14, 1, out], walls, f"cusk 2048 block, run {tag}")
        runs.append(out)
    names = sorted(os.listdir(runs[0]))
    differ = files_identical(runs[0], runs[1], names)
    log(f"determinism: rerun of the 2048 block, files {names}, "
        f"differing {differ}")
    if differ or not names:
        raise AssertionError(f"rerun not byte-identical: {differ}")

    with timed("hetcor skeleton v=2048", walls):
        C, N, t = hetcor_inputs(cfg["seed"], cfg["hetcor_v"])
        v = C.shape[0]
        res = hetcor_skeleton(
            jnp.asarray(C), np.ones((v, v), np.int32), jnp.asarray(N),
            hetcor_threshold(sz.alpha), 3, time_index=t,
        )
        np.save(os.path.join(cmpdir, "dev_hetcor.npy"), res.G)

    with timed("panel stripe", walls):
        n = sz.samples
        first, mcols, r = (cfg["stripe_first"], cfg["stripe_cols"],
                           cfg["stripe_rows"])
        cols_bb = chr_state["bb"][first:first + mcols]
        chunk = min(DEFAULT_SAMPLE_CHUNK,
                    4 * (((cols_bb.shape[1] + 31) // 32) * 32))
        cols_p, n_chunks = _prep_bytes(cols_bb, n, chunk)
        counts = _kendall_counts_block(
            jnp.asarray(cols_p[:r]), jnp.asarray(cols_p), n_chunks)
        np.save(os.path.join(cmpdir, "dev_counts.npy"), np.asarray(counts))
        means, stds, _ = bed_col_stats(cols_bb, n)
        C_dev, _ = corr_panel_device_tiled(cols_bb, chr_state["Y"], means,
                                           stds, n)
        np.save(os.path.join(cmpdir, "dev_npn.npy"),
                np.asarray(C_dev[:r, :mcols]))
    return {"runs": runs}


def phase_compare_check(state: dict, dev: dict) -> None:
    """Waits for the CPU child and compares."""
    rc = state["child"].wait()
    if rc != 0:
        raise AssertionError(f"CPU reference child failed (exit {rc})")
    cmpdir = state["cmpdir"]
    with open(os.path.join(cmpdir, "cpu_done.json")) as f:
        for name, (wall, comp) in json.load(f).items():
            log(f"{name} (CPU child): wall {wall:.3f} s, compile {comp:.3f} s")

    dev_dir, cpu_dir = dev["runs"][0], os.path.join(cmpdir, "cpu_block")
    stems = sorted({os.path.splitext(f)[0] for f in os.listdir(dev_dir)})
    exact = [f"{s}{ext}" for s in stems for ext in (".adj", ".sep", ".ixs",
                                                    ".mdim")]
    differ = files_identical(dev_dir, cpu_dir, exact)
    corr_d = max(
        float(np.max(np.abs(
            np.fromfile(os.path.join(dev_dir, s + ".corr"), np.float32)
            - np.fromfile(os.path.join(cpu_dir, s + ".corr"), np.float32)
        ), initial=0.0))
        for s in stems
    )
    log(f"2048 block GPU vs CPU: adjacency/sepsets/indices "
        f"{'identical' if not differ else 'DIFFER ' + str(differ)}; "
        f"block .corr max |delta| {corr_d:.3e}")

    g_dev = np.load(os.path.join(cmpdir, "dev_hetcor.npy"))
    g_cpu = np.load(os.path.join(cmpdir, "cpu_hetcor.npy"))
    het_d = int(np.abs(g_dev.astype(np.int64) - g_cpu).max())
    log(f"hetcor v={g_dev.shape[0]} GPU vs CPU: adjacency max |delta| "
        f"{het_d} ({int(g_dev.sum()) // 2} edges)")

    c_dev = np.load(os.path.join(cmpdir, "dev_counts.npy")).astype(np.float64)
    c_cpu = np.load(os.path.join(cmpdir, "cpu_counts.npy"))
    cnt_d = float(np.abs(c_dev - c_cpu).max())
    npn_d = float(np.abs(
        np.load(os.path.join(cmpdir, "dev_npn.npy")).astype(np.float64)
        - np.load(os.path.join(cmpdir, "cpu_npn.npy"))
    ).max())
    log(f"panel stripe {c_dev.shape[0] // 3}x{c_dev.shape[1] // 3}: int8 "
        f"counts max |delta| {cnt_d:.1f}, Kendall-npn max |delta| "
        f"{npn_d:.3e} vs float64 numpy (limit 1e-5)")
    if differ or het_d or cnt_d or not npn_d <= 1e-5:
        raise AssertionError("device and CPU answers differ")


def write_cuskss_inputs(sz: Sizes, d: str, seed: int) -> dict:
    """Summary statistics for cuskss: AR(1) LD segments in mxm, planted
    marker->trait effects smeared by LD in mxp, one strong trait pair in
    pxp, per-entry sample sizes through standard errors, distinct trait
    time indices."""
    rng = np.random.default_rng(seed)
    m, p, n_gwas, ar = sz.cuskss_markers, sz.cuskss_traits, 5.0e5, 0.92
    seg = np.cumsum(np.isin(np.arange(m), np.cumsum(
        rng.integers(300, 1500, m // 300 + 1))))
    idx = np.arange(m)

    def ld_row(i, upto):
        j = idx[:upto]
        return np.where(seg[j] == seg[i], ar ** np.abs(i - j), 0.0)

    tril = np.concatenate([ld_row(i, i + 1) for i in range(m)]).astype(
        np.float32)
    tril.tofile(os.path.join(d, "mxm.bin"))
    mxp = rng.standard_normal((m, p)) / np.sqrt(n_gwas)
    for t in range(p):
        for k in rng.integers(0, m, 3):
            mxp[:, t] += 0.03 * ld_row(int(k), m)
    pxp = np.full((p, p), 0.1) + 0.9 * np.eye(p)
    pxp[0, 1] = pxp[1, 0] = 0.35
    mp_ess = rng.uniform(3e5, 5e5, (m, p))
    pp_ess = rng.uniform(3e5, 5e5, (p, p))
    pp_ess = (pp_ess + pp_ess.T) / 2
    mp_se = (1.0 - mxp ** 2) / np.sqrt(mp_ess)
    pp_se = (1.0 - pxp ** 2) / np.sqrt(pp_ess)
    np.fill_diagonal(pp_se, 1e-3)
    traits = [f"T{t}" for t in range(p)]

    def marker_table(path, vals):
        with open(path, "w") as f:
            f.write(" ".join(["chr", "snp", "ref"] + traits) + "\n")
            f.writelines(
                f"1 rs{i} A " + " ".join(f"{x:.9g}" for x in vals[i]) + "\n"
                for i in range(m)
            )

    def trait_table(path, vals):
        with open(path, "w") as f:
            f.write(" ".join(traits) + "\n")
            f.writelines(
                f"T{i} " + " ".join(f"{x:.9g}" for x in vals[i]) + "\n"
                for i in range(p)
            )

    marker_table(os.path.join(d, "mxp.txt"), mxp)
    marker_table(os.path.join(d, "mxp_se.txt"), mp_se)
    trait_table(os.path.join(d, "pxp.txt"), pxp)
    trait_table(os.path.join(d, "pxp_se.txt"), pp_se)
    time_index = rng.permutation(p) + 1
    with open(os.path.join(d, "time_index.txt"), "w") as f:
        f.writelines(f"{t}\n" for t in time_index)
    with open(os.path.join(d, "ss.blocks"), "w") as f:
        f.write(f"1\t0\t{m - 1}\n")
    return {"tril": tril, "mxp": mxp.astype(np.float32),
            "pxp": pxp.astype(np.float32), "mp_ess": mp_ess.astype(np.float32),
            "pp_ess": pp_ess.astype(np.float32), "n_gwas": n_gwas,
            "time_index": time_index.astype(np.int32)}


def phase_cuskss(sz: Sizes, work: str, seed: int, walls: dict) -> dict:
    d = os.path.join(work, "cuskss")
    out = os.path.join(d, "out")
    os.makedirs(out)
    with timed("simulate summary statistics", walls):
        data = write_cuskss_inputs(sz, d, seed + 2)
    cli(["cuskss", "--mxm", os.path.join(d, "mxm.bin"),
         "--mxp", os.path.join(d, "mxp.txt"),
         "--mxp-se", os.path.join(d, "mxp_se.txt"),
         "--pxp", os.path.join(d, "pxp.txt"),
         "--pxp-se", os.path.join(d, "pxp_se.txt"),
         "--time-index", os.path.join(d, "time_index.txt"),
         "--blockfile", os.path.join(d, "ss.blocks"), "--block-index", 0,
         "--alpha", sz.alpha, "--num-samples", int(data["n_gwas"]),
         "--outdir", out], walls)
    stem = os.path.join(out, f"1_0_{sz.cuskss_markers - 1}")
    with open(stem + ".mdim") as f:
        num_var, num_phen, _ = (int(x) for x in f.read().split())
    log(f"cuskss v={sz.cuskss_markers + sz.cuskss_traits}: completed, "
        f"{num_var - num_phen} markers retained for {num_phen} traits, "
        f"trait time indices {data['time_index'].tolist()}")
    if num_phen != sz.cuskss_traits or num_var <= num_phen:
        raise AssertionError("cuskss kept no marker")
    return data


# ---------------------------------------------------------------------------
# profiler trace: the local-panel gather's achieved bytes/s
# ---------------------------------------------------------------------------


def read_trace(trace_dir: str):
    """(host spans [(name, start, end)], device ops [(start, end, name)])
    from the newest `.xplane.pb` under trace_dir. Device ops come from the
    GPU planes' "XLA Ops" lines, or their stream lines when absent."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return [], []
    prof = ProfileData.from_file(paths[-1])
    spans, ops = [], []
    for plane in prof.planes:
        lines = list(plane.lines)
        if plane.name.startswith("/device:"):
            log(f"trace plane {plane.name}: lines "
                f"{[(ln.name, len(list(ln.events))) for ln in lines][:8]}")
        if plane.name.startswith("/device:GPU"):
            use = [ln for ln in lines if ln.name == "XLA Ops"] or [
                ln for ln in lines if ln.name.startswith("Stream")]
            for ln in use:
                ops.extend((ev.start_ns, ev.end_ns, ev.name)
                           for ev in ln.events)
        elif plane.name.startswith("/host:"):
            for ln in lines:
                spans.extend(
                    (ev.name, ev.start_ns, ev.end_ns) for ev in ln.events
                    if ev.name.startswith(("skeleton_level_", "hetcor_level_"))
                )
    return spans, ops


def busy_ns(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window_report(name: str, span, ops: list) -> dict:
    _, s0, s1 = span
    inside = [(s, e, nm) for s, e, nm in ops if s >= s0 and e <= s1]
    by_name: dict = {}
    for s, e, nm in inside:
        by_name[nm] = by_name.get(nm, 0) + (e - s)
    gather = [(s, e) for s, e, nm in inside if "gather" in nm.lower()]
    return {
        "span_s": (s1 - s0) / 1e9,
        "busy_s": busy_ns([(s, e) for s, e, _ in inside]) / 1e9,
        "gather_s": busy_ns(gather) / 1e9,
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:5],
    }


def gathered_bytes(stats: dict, level: int, panels: int) -> int:
    """Bytes the local-panel gathers of one level read: per launch the
    (node_tile, d, d) panel and the (node_tile, d) cross row, f32, per
    gathered panel."""
    plan = stats.get("level_detail", {}).get(level, {}).get("plan", [])
    return sum(
        -(-nodes // nt) * nt * (d * d + d) * 4 * panels
        for d, nodes, nt, _ in plan
    )


def report_gather(tag: str, stats: dict, level: int, panels: int,
                  spans: list, ops: list, span_name: str) -> None:
    """One level's window of the trace: device busy and idle share, the
    top ops, and the local-panel gather's achieved bytes/s."""
    span = next((sp for sp in spans if sp[0] == span_name), None)
    nbytes = gathered_bytes(stats, level, panels)
    if span is None:
        log(f"trace {tag}: no '{span_name}' span in the trace")
        return
    w = window_report(span_name, span, ops)
    top = ", ".join(f"{nm} {t / 1e6:.3f} ms" for nm, t in w["top"])
    idle = 1.0 - w["busy_s"] / w["span_s"] if w["span_s"] else float("nan")
    log(f"trace {tag}: host span {w['span_s']:.4f} s, device busy "
        f"{w['busy_s']:.4f} s, idle share {idle:.3f}; top ops: {top}")
    if not nbytes:
        log(f"gather {tag}: this level ran no local-panel gather")
        return
    if w["busy_s"] == 0:
        log(f"gather {tag}: no device ops found in the span")
        return
    import jax

    from bench import peak_rates

    peak = peak_rates(jax.devices()[0].device_kind)["hbm_bytes"]
    named = nbytes / w["gather_s"] if w["gather_s"] > 0 else float("inf")
    if named <= peak:
        log(f"gather {tag}: {nbytes:.4e} bytes in gather ops "
            f"{w['gather_s']:.4f} s = {named:.4e} B/s, "
            f"{named / peak:.2%} of {peak:.3g} B/s")
    else:
        # the panel gather is fused into its consumer (the ops named
        # "gather" fetch only part of the bytes), so only a lower bound
        rate = nbytes / w["busy_s"]
        log(f"gather {tag}: fused into the sweep; {nbytes:.4e} bytes over "
            f"the level's device busy time = {rate:.4e} B/s lower bound, "
            f"{rate / peak:.2%} of {peak:.3g} B/s")


def largest_launch_memory(stats: dict, vp: int) -> None:
    """`compiled.memory_analysis()` of the largest level-1..3 launch."""
    import jax
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as pcorr_ops
    from cigwas_tpu.skeleton import cupc

    entries = [
        (l, d, nt, ct)
        for l, det in stats.get("level_detail", {}).items()
        for d, _, nt, ct in det.get("plan", [])
    ]
    if not entries:
        log("memory_analysis: no local-sweep launch to analyse")
        return
    l, d, nt, ct = max(entries, key=lambda e: e[2] * e[1] ** 2
                       * (e[3] if e[0] > 1 else 1))
    i32 = jnp.int32
    args = (jax.ShapeDtypeStruct((vp, vp), jnp.float32),
            jax.ShapeDtypeStruct((nt,), i32),
            jax.ShapeDtypeStruct((nt, d), i32),
            jax.ShapeDtypeStruct((nt,), i32))
    if l == 1:
        lowered = pcorr_ops.level1_local_sweep.lower(*args)
    else:
        lowered = cupc._sweep_hits_xla.lower(
            *args, jax.ShapeDtypeStruct((), jnp.float32), l=l, ct=ct)
    mem = lowered.compile().memory_analysis()
    log(f"memory_analysis of the largest level launch (level {l}, node "
        f"tile {nt}, width {d}, t-chunk {ct}): arguments "
        f"{mem.argument_size_in_bytes} B, outputs {mem.output_size_in_bytes}"
        f" B, temporaries {mem.temp_size_in_bytes} B, code "
        f"{mem.generated_code_size_in_bytes} B (smoke, not a benchmark)")


def phase_trace(sz: Sizes, work: str, chr_state: dict, ss: dict,
                walls: dict) -> None:
    """Short profiler traces of stage 1 of the largest block and of hetcor
    level 1 at v = 10,000."""
    import jax

    from cigwas_tpu.native import bed_col_stats
    from cigwas_tpu.ops.corr import corr_panel_device_tiled
    from cigwas_tpu.pipelines.cuskss import assemble_cuskss_panels_device
    from cigwas_tpu.skeleton import hetcor_skeleton, skeleton
    from cigwas_tpu.utils.stats import hetcor_threshold, threshold_array

    blk = largest_block(chr_state["blocks"])
    first, m = blk.get_first_marker_global_ix(), blk.block_size()
    n = sz.samples
    bb = chr_state["bb"][first:first + m]
    means, stds, _ = bed_col_stats(bb, n)
    stats: dict = {}
    tdir = os.path.join(work, "trace_block")
    with timed(f"traced stage 1 of block {blk.to_file_string()}", walls):
        C_dev, v = corr_panel_device_tiled(bb, chr_state["Y"], means, stds, n)
        with jax.profiler.trace(tdir):
            skeleton(C_dev, threshold_array(n, sz.alpha), 3, C_dev=C_dev,
                     n_var=v, want_pmax=False, stats=stats)
    spans, ops = read_trace(tdir)
    log(f"trace: {len(ops)} device ops, spans "
        f"{sorted({s[0] for s in spans})}")
    for l in (1, 2, 3):
        report_gather(f"level {l}, {m}-marker block", stats, l, 1, spans, ops,
                      f"skeleton_level_{l}")
    largest_launch_memory(stats, int(C_dev.shape[0]))

    vv = sz.cuskss_markers + sz.cuskss_traits
    hstats: dict = {}
    tdir = os.path.join(work, "trace_hetcor")
    with timed(f"traced hetcor level 1 at v={vv}", walls):
        C_h, N_h = assemble_cuskss_panels_device(
            ss["tril"], ss["mxp"], ss["pxp"], ss["n_gwas"],
            mp_ess=ss["mp_ess"], pp_ess=ss["pp_ess"])
        t_ix = np.zeros(vv, np.int32)
        t_ix[sz.cuskss_markers:] = ss["time_index"]
        with jax.profiler.trace(tdir):
            hetcor_skeleton(C_h, np.ones((vv, vv), np.int32), N_h,
                            hetcor_threshold(sz.alpha), 1, time_index=t_ix,
                            stats=hstats)
    spans, ops = read_trace(tdir)
    report_gather(f"hetcor level 1, v={vv}", hstats, 1, 2, spans, ops,
                  "hetcor_level_1")


def contingency_lowering(sz: Sizes, chr_state: dict) -> None:
    """Which kernel the s8 x s8 -> s32 contingency dot lowers to."""
    import jax.numpy as jnp

    from cigwas_tpu.ops.corr import (
        DEFAULT_SAMPLE_CHUNK, _kendall_counts_block, _prep_bytes,
    )

    blk = largest_block(chr_state["blocks"])
    first, m = blk.get_first_marker_global_ix(), blk.block_size()
    bb = chr_state["bb"][first:first + m]
    chunk = min(DEFAULT_SAMPLE_CHUNK, 4 * (((bb.shape[1] + 31) // 32) * 32))
    cols, n_chunks = _prep_bytes(bb, sz.samples, chunk)
    txt = _kendall_counts_block.lower(
        jnp.asarray(cols[: sz.stripe_rows]), jnp.asarray(cols), n_chunks
    ).compile().as_text()
    hits = [ln.strip() for ln in txt.splitlines()
            if re.search(r"custom-call|gemm|cublas|\bdot\(", ln)]
    for ln in hits[:6]:
        log(f"contingency HLO: {ln[:260]}")
    gemm = [ln for ln in hits if "s8[" in ln and re.search(
        r"cublas|gemm|triton", ln)]
    log("contingency dot lowering: "
        + ("int8 GEMM (" + ("cuBLAS" if any("cublas" in g for g in gemm)
                            else "Triton") + ")" if gemm
           else "no int8 GEMM found in the optimized HLO"))


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.skipped = self.failed = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.failed:
            self.failed += 1


def phase_gpu_tests(require_card: bool) -> None:
    """The `gpu`-marked tests, in this process (a second process would
    need the card that this one holds)."""
    import pytest

    counts = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "--jax-platforms=keep",
         "-rs", os.path.join(REPO, "tests", "test_gpu.py")],
        plugins=[counts],
    )
    log(f"gpu tests: {counts.passed} passed, {counts.skipped} skipped, "
        f"{counts.failed} failed (pytest exit {int(rc)})")
    if rc != 0 or (require_card and (counts.skipped or not counts.passed)):
        raise AssertionError("gpu tests did not all pass on the card")


def run_single(sz: Sizes, work: str, seed: int, require_card: bool) -> bool:
    """Every one-card phase; True when all passed."""
    CLOCK.install()
    walls: dict = {}
    failed = []
    chr_state = ss = cmp_state = dev = None

    def attempt(name, fn, *args):
        try:
            return fn(*args)
        except Exception:  # the boundary: record, report, go on
            failed.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None

    chr_state = attempt("pipeline", phase_pipeline, sz, work, seed, walls)
    if chr_state is not None:
        cmp_state = attempt("prepare comparisons", phase_prepare_compare, sz,
                            work, seed, chr_state, walls)
    ss = attempt("cuskss", phase_cuskss, sz, work, seed, walls)
    if cmp_state is not None:
        dev = attempt("device comparisons", phase_compare_device, sz,
                      cmp_state, chr_state, walls)
    if chr_state is not None:
        attempt("contingency lowering", contingency_lowering, sz, chr_state)
    if chr_state is not None and ss is not None:
        attempt("trace", phase_trace, sz, work, chr_state, ss, walls)
    if cmp_state is not None:
        if dev is not None:
            attempt("comparisons", phase_compare_check, cmp_state, dev)
        else:
            cmp_state["child"].wait()
    attempt("gpu tests", phase_gpu_tests, require_card)

    import jax

    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device memory in use: {stats.get('peak_bytes_in_use')} B "
        "(smoke, not a benchmark)")
    log(f"phases failed: {failed}")
    return not failed


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def corr_delta(dir_a: str, dir_b: str, stem: str) -> dict:
    """Max |delta| between two `.corr` outputs, by trait-trait,
    trait-marker and marker-marker block."""
    with open(os.path.join(dir_a, stem + ".mdim")) as f:
        nv, npn, _ = (int(x) for x in f.read().split())
    a, b = (np.fromfile(os.path.join(d, stem + ".corr"), np.float32)
            .reshape(nv, nv) for d in (dir_a, dir_b))
    d = np.abs(a.astype(np.float64) - b)
    return {"trait-trait": float(d[:npn, :npn].max(initial=0)),
            "trait-marker": float(d[:npn, npn:].max(initial=0)),
            "marker-marker": float(d[npn:, npn:].max(initial=0))}


def multichip_mesh_child(work: str) -> None:
    """Child holding all four cards: one-card `cusk-all` on device 0, then
    `cusk --mesh 4` on the largest block in both panel modes."""
    with open(os.path.join(work, "multichip.json")) as f:
        cfg = json.load(f)
    import jax

    CLOCK.install()
    devs = jax.devices()
    if cfg["require_gpu"] and (devs[0].platform != "gpu" or len(devs) < 4):
        raise RuntimeError(f"--multichip needs four GPUs, found {devs}")
    walls: dict = {}
    stem, a = cfg["stem"], cfg["alpha"]
    cli(["prep-bed", stem], walls)
    cli(["block", stem, cfg["max_block"], 10, cfg["corr_width"]], walls)
    blockfile = cfg["blockfile"]
    one = os.path.join(work, "out_1card")
    os.makedirs(one)
    cli(["cusk-all", blockfile, stem, stem + ".phen", a, 3, 14, 1, one],
        walls, "cusk-all on one card")
    blocks = read_blocks(blockfile)
    # the largest block with outputs (blocks without a significant
    # marker-trait correlation are skipped by design)
    blk = largest_block([b for b in blocks if os.path.exists(
        os.path.join(one, b.to_file_string() + ".mdim"))])
    bi = blocks.index(blk)
    stem_b = blk.to_file_string()
    names = sorted(f for f in os.listdir(one) if f.startswith(stem_b + "."))
    result = {"blocks": len(blocks), "mesh": {}}
    for mode in ("replicated", "rowsharded"):
        out = os.path.join(work, f"out_mesh_{mode}")
        os.makedirs(out)
        cli(["cusk", bi, blockfile, stem, stem + ".phen", a, 3, 14, 1, out,
             "--mesh", 4, "--panel-mode", mode], walls,
            f"cusk --mesh 4 {mode} on {stem_b}")
        result["mesh"][mode] = files_identical(one, out, names) + sorted(
            set(os.listdir(out)) - set(names))
        log(f"cusk --mesh 4 --panel-mode {mode} on block {stem_b}: files "
            f"{names}, differing from one card "
            f"{result['mesh'][mode] or 'none'}")
        if stem_b + ".corr" in result["mesh"][mode]:
            log(f"  .corr max |delta| by block: "
                f"{corr_delta(one, out, stem_b)}")
    result["device"] = {"platform": devs[0].platform,
                        "kind": devs[0].device_kind, "count": len(devs)}
    with open(os.path.join(work, "mesh_result.json"), "w") as f:
        json.dump(result, f)


def run_multichip(sz: Sizes, work: str, seed: int, require_gpu: bool):
    """The four-card paths; returns the device dict or None on failure.
    This process stays on the CPU platform while its children hold the
    cards."""
    child_env = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cpu"
    t0 = time.perf_counter()
    stem = os.path.join(work, "chr")
    chromosome(sz, seed, sz.multichip_markers, stem)
    log(f"simulate chromosome of {sz.multichip_markers} markers: "
        f"{time.perf_counter() - t0:.3f} s")
    cfg = {"stem": stem, "alpha": sz.alpha, "max_block": sz.max_block,
           "corr_width": sz.corr_width, "require_gpu": require_gpu,
           "blockfile": f"{stem}_m{sz.max_block}.blocks"}
    with open(os.path.join(work, "multichip.json"), "w") as f:
        json.dump(cfg, f)
    rc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--multichip-mesh", work],
        env=child_env,
    ).returncode
    if rc != 0:
        log(f"mesh child failed (exit {rc})")
        return None
    with open(os.path.join(work, "mesh_result.json")) as f:
        mesh = json.load(f)

    four = os.path.join(work, "out_4proc")
    os.makedirs(four)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cigwas_tpu.cli", "cusk-all",
             cfg["blockfile"], stem, stem + ".phen", str(sz.alpha), "3",
             "14", "1", four, "--num-partitions", "4",
             "--partition-index", str(p)],
            env=dict(child_env, CUDA_VISIBLE_DEVICES=str(p)), cwd=REPO,
        )
        for p in range(4)
    ]
    rcs = [p.wait() for p in procs]
    log(f"cusk-all --num-partitions 4, one process per card: exit codes "
        f"{rcs}, wall {time.perf_counter() - t0:.3f} s")
    one = os.path.join(work, "out_1card")
    names = sorted(os.listdir(one))
    differ = files_identical(one, four, names) + sorted(
        set(os.listdir(four)) - set(names))
    from cigwas_tpu.merge import merge_block_outputs

    merged_differ = []
    for d in (one, four):
        merge_block_outputs(cfg["blockfile"], d + "/").write_mm(
            os.path.join(d, "merged_blocks"))
    merged = sorted(f for f in os.listdir(one) if f.startswith("merged_"))
    merged_differ = files_identical(one, four, merged)
    log(f"block-parallel vs one card: {len(names)} block files, differing "
        f"{differ or 'none'}; merged files {merged}, differing "
        f"{merged_differ or 'none'}")
    ok = (not any(mesh["mesh"].values()) and not any(rcs) and not differ
          and not merged_differ and mesh["blocks"] >= 4)
    return mesh["device"] if ok else None


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"))
    ap.add_argument("--multichip", action="store_true",
                    help="the four-card paths only (needs four GPUs)")
    ap.add_argument("--cpu-reference", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--multichip-mesh", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return 0
    if args.multichip_mesh:
        multichip_mesh_child(args.multichip_mesh)
        return 0

    if args.multichip:
        # this process stays off JAX while its children hold the cards:
        # ask the driver how many there are
        try:
            cards = card_info().splitlines()
        except (OSError, subprocess.CalledProcessError) as e:
            log(f"no GPU: {e}")
            return 1
        if len(cards) < 4:
            log(f"--multichip needs four GPUs, found {cards}")
            return 1
    else:
        import jax

        d0 = jax.devices()[0]
        if d0.platform != "gpu":
            log(f"no GPU: JAX found {jax.devices()}")
            return 1
        log(f"JAX {jax.__version__}, devices {jax.devices()}")
    work = os.path.abspath(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        if args.multichip:
            device = run_multichip(FULL, work, args.seed, require_gpu=True)
            ok = device is not None
        else:
            ok = run_single(FULL, work, args.seed, require_card=True)
            device = {"platform": d0.platform, "kind": d0.device_kind,
                      "count": len(jax.devices())}
        print(f"card: {card_info()}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
