"""Full-pipeline end-to-end test on simulated data with planted structure.

Mirrors the reference's validation strategy (SURVEY.md §4: simulation
against ground-truth DAGs) at miniature scale: simulate genotypes + traits
with known causal edges, run prep -> block -> cusk -> merge -> sepselect ->
srfci -> mvivw through the CLI entry points, and check that the planted
structure is recovered.
"""

import os

import numpy as np
import pytest

from cigwas_tpu.cli import main as cli_main
from cigwas_tpu.constants import BED_PREFIX_COL_MAJ
from cigwas_tpu.io.bed import encode_bed_values


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("simdata")
    rng = np.random.default_rng(42)
    n, m = 4000, 120
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )
    def std(v):
        return (v - v.mean()) / v.std()

    y0 = sum(0.35 * std(G[i]) for i in (10, 20, 30, 40)) + rng.normal(size=n)
    y1 = sum(0.35 * std(G[i]) for i in (50, 60, 70)) + 0.5 * y0 + rng.normal(size=n)
    y2 = rng.normal(size=n)
    Y = np.stack([y0, y1, y2])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)

    stem = str(tmp / "sim")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        for i in range(m):
            f.write(f"1\trs{i}\t0\t{1000 * i}\tA\tG\n")
    with open(stem + ".fam", "w") as f:
        for i in range(n):
            f.write(f"F{i} I{i} 0 0 0 -9\n")
    with open(stem + ".phen", "w") as f:
        f.write("FID\tIID\tT0\tT1\tT2\n")
        for i in range(n):
            f.write(f"F{i}\tI{i}\t" + "\t".join(f"{v:.6f}" for v in Y[:, i]) + "\n")
    return tmp, stem, n


def test_full_pipeline_recovers_planted_structure(sim_dataset):
    tmp, stem, n = sim_dataset
    out = tmp / "out"
    out.mkdir(exist_ok=True)

    cli_main(["prep-bed", stem])
    cli_main(["block", stem, "64", "10", "16"])
    blockfile = stem + "_m64.blocks"
    assert os.path.exists(blockfile)

    n_blocks = sum(1 for _ in open(blockfile))
    for bi in range(n_blocks):
        cli_main(
            ["cusk", str(bi), blockfile, stem, stem + ".phen", "0.001", "3", "14", "1", str(out)]
        )

    cli_main(["merge-block-outputs", str(out), blockfile])
    merged = str(out / "merged_blocks")
    assert os.path.exists(merged + "_sam.mtx")

    cli_main(["sepselect", merged, "0.001", str(n)])
    sep_stem = str(out / "max_sep_min_pc")
    assert os.path.exists(sep_stem + ".ssm")

    cli_main(["orient-v-structs", merged, "0.001", str(n)])
    cli_main(["srfci", sep_stem, "0.001", str(n)])
    assert os.path.exists(sep_stem + "_estimated_pag.mtx")

    cli_main(["mvivw", merged, str(n)])
    assert os.path.exists(merged + "_mvivw_results.tsv")
    assert os.path.exists(merged + "_iv_candidates.csv")

    # --- structure checks -------------------------------------------------
    from scipy.io import mmread

    sam = mmread(merged + "_sam.mtx").toarray()
    # trait-trait edges: only T0 (1-based ix 1) - T1 (ix 2)
    tt = sam[:3, :3]
    assert tt[0, 1] != 0 and tt[1, 0] != 0
    assert tt[0, 2] == 0 and tt[1, 2] == 0

    # markers 10, 50 are instruments of T0 and T1 respectively
    gmi = np.fromfile(merged + ".ixs", dtype=np.int32)
    marker_rows = {3 + i: int(g) for i, g in enumerate(gmi)}
    snp_of = {v: k for k, v in marker_rows.items()}
    for snp, trait in [(10, 0), (20, 0), (30, 0), (40, 0), (50, 1), (60, 1), (70, 1)]:
        assert snp in snp_of, f"planted SNP {snp} missing from merged skeleton"
        assert sam[snp_of[snp], trait] != 0, (snp, trait)

    # mvivw: T0 -> T1 effect present and positive, reverse ~ 0
    import pandas as pd

    mv = pd.read_csv(merged + "_mvivw_results.tsv", sep="\t")
    fwd = mv[(mv.source == 1) & (mv.sink == 2)].iloc[0]
    assert fwd.effect > 0.2
    assert fwd.p < 0.05


def test_estimated_pag_forces_marker_to_trait(sim_dataset):
    tmp, stem, n = sim_dataset
    out = tmp / "out"
    from scipy.io import mmread

    pag = mmread(str(out / "max_sep_min_pc_estimated_pag.mtx")).toarray()
    num_phen = 3
    mt = pag[num_phen:, :num_phen]
    tm = pag[:num_phen, num_phen:]
    assert set(np.unique(mt)) <= {0, 2}
    assert set(np.unique(tm)) <= {0, 3}
    # each nonzero marker-trait edge must be mirrored
    nz = np.argwhere(mt == 2)
    for i, j in nz:
        assert tm[j, i] == 3


def test_cusk_all_matches_per_block_runs(sim_dataset):
    """`cusk-all` (the first-class block runner) must produce byte-identical
    outputs to the individual per-block cusk invocations."""
    import hashlib

    tmp, stem, n = sim_dataset
    blockfile = stem + "_m64.blocks"
    ref = tmp / "out"
    if not os.path.exists(blockfile):  # allow running this test standalone
        ref.mkdir(exist_ok=True)
        cli_main(["prep-bed", stem])
        cli_main(["block", stem, "64", "10", "16"])
        for bi in range(sum(1 for _ in open(blockfile))):
            cli_main(
                ["cusk", str(bi), blockfile, stem, stem + ".phen", "0.001", "3", "14", "1", str(ref)]
            )
    out2 = tmp / "out_all"
    out2.mkdir(exist_ok=True)
    cli_main(
        ["cusk-all", blockfile, stem, stem + ".phen", "0.001", "3", "14", "1", str(out2)]
    )
    import re

    for f in sorted(os.listdir(ref)):
        # compare per-block outputs only (<chr>_<first>_<last>.*)
        if re.match(r"^\d+_\d+_\d+\.(adj|corr|ixs|sep|mdim)$", f):
            h1 = hashlib.md5(open(ref / f, "rb").read()).hexdigest()
            h2 = hashlib.md5(open(out2 / f, "rb").read()).hexdigest()
            assert h1 == h2, f


def test_partition_blocks_covers_all():
    from cigwas_tpu.io.blocks import MarkerBlock
    from cigwas_tpu.parallel import partition_blocks

    blocks = [MarkerBlock("1", i * 10, i * 10 + 5 + i) for i in range(7)]
    parts = [partition_blocks(blocks, 3, i) for i in range(3)]
    seen = [b.to_file_string() for p in parts for b in p]
    assert sorted(seen) == sorted(b.to_file_string() for b in blocks)
    # cost-balanced: no partition empty
    assert all(len(p) > 0 for p in parts)


def test_cli_cusk_mesh_flags(sim_dataset, tmp_path):
    """`cusk --mesh 0 --panel-mode rowsharded` runs SPMD over all (virtual)
    devices from the CLI and matches the plain run byte-for-byte."""
    import hashlib

    tmp, stem, n = sim_dataset
    blockfile = stem + "_m64.blocks"
    out_a = tmp_path / "plain"
    out_b = tmp_path / "meshed"
    out_a.mkdir()
    out_b.mkdir()
    cli_main(["cusk", "0", blockfile, stem, stem + ".phen", "0.001", "3",
              "14", "1", str(out_a)])
    cli_main(["cusk", "0", blockfile, stem, stem + ".phen", "0.001", "3",
              "14", "1", str(out_b), "--mesh", "0",
              "--panel-mode", "rowsharded"])
    fa = sorted(os.listdir(out_a))
    assert fa and fa == sorted(os.listdir(out_b))
    for f in fa:
        a = hashlib.md5(open(out_a / f, "rb").read()).hexdigest()
        b = hashlib.md5(open(out_b / f, "rb").read()).hexdigest()
        assert a == b, f


def test_postprocessing_stages_do_not_import_pandas(sim_dataset, tmp_path):
    """merge-block-outputs, sepselect and mvivw run without pandas, which
    the machines that run the pipeline need not have."""
    import subprocess
    import sys

    tmp, stem, n = sim_dataset
    src = tmp / "out"
    out = tmp_path / "out"
    out.mkdir()
    for f in os.listdir(src):
        if f.count("_") == 2 and not f.startswith(("merged", "max_sep")):
            (out / f).write_bytes((src / f).read_bytes())
    merged = str(out / "merged_blocks")
    code = f"""
import sys
from cigwas_tpu.cli import main
main(["merge-block-outputs", {str(out)!r}, {stem + "_m64.blocks"!r}])
main(["sepselect", {merged!r}, "0.001", "{n}"])
main(["mvivw", {merged!r}, "{n}"])
assert "pandas" not in sys.modules, "pandas was imported"
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(merged + "_mvivw_results.tsv")
    # the same results as the pipeline test's run
    assert open(merged + "_mvivw_results.tsv").read() == open(
        src / "merged_blocks_mvivw_results.tsv").read()


def test_mvivw_table_bytes_match_pandas_writer(sim_dataset, tmp_path):
    """`write_table` writes the bytes pandas' `to_csv` wrote for the same
    rows, so `_mvivw_results.tsv` and `_iv_candidates.csv` keep their
    format."""
    pd = pytest.importorskip("pandas")
    from cigwas_tpu.io.results import write_table
    from cigwas_tpu.merge import IV_COLUMNS, get_iv_candidates
    from cigwas_tpu.mr.mvivw import RESULT_COLUMNS, run_mvivw

    tmp, stem, n = sim_dataset
    merged = str(tmp / "out" / "merged_blocks")
    ours = tmp_path / "ours.tsv"
    rows = run_mvivw(merged, n, out_path=str(ours))
    df = pd.DataFrame(rows, columns=RESULT_COLUMNS)
    df["sk_adj"] = df["sk_adj"].map({True: "TRUE", False: "FALSE"})
    df.to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
    assert ours.read_bytes() == (tmp_path / "pandas.tsv").read_bytes()
    ivs = get_iv_candidates(merged)
    assert ivs
    write_table(str(tmp_path / "ivs.csv"), IV_COLUMNS, ivs)
    pd.DataFrame(ivs).to_csv(tmp_path / "ivs_pd.csv", index=False)
    assert (tmp_path / "ivs.csv").read_bytes() == (
        tmp_path / "ivs_pd.csv").read_bytes()
