"""Regression tests of the merge + sepselect chain against the reference's
own Python post-processing.

The reference's L6 stages (`cusk_postprocessing/merge_blocks.py`,
`sepselect.py`) are pure numpy/scipy. On the simulated per-block cusk outputs
below, this package's outputs were checked against both of them run side
by side:

* byte-identical `merged_blocks_{sam,scm}.mtx` / `.mdim` / `.ixs` (both
  writers emit the same hand-rolled MatrixMarket format),
* exact-equal parsed sepselect matrices (`max_sep_min_pc_{sam,scm,spm}.mtx`
  — the reference writes those via scipy `mmwrite`, whose header/formatting
  differs from our writer, so the comparison is on parsed values), and
  byte-identical `.mdim/.atr/.ut/.ssm`.

Those outputs are kept as digests in `tests/data/reference_diff_golden.json`
(taken from this package at a commit where they matched the reference's);
regenerate them with `python tests/test_reference_diff.py` only after a
deliberate behaviour change.
"""

import hashlib
import json
import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "reference_diff_golden.json")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _matrix_digest(path: str) -> str:
    from scipy.io import mmread

    a = mmread(path).toarray().astype(np.float64)
    return _digest(repr(a.shape).encode() + a.tobytes())


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def block_outputs(tmp_path_factory):
    """Simulated dataset -> per-block cusk outputs (reference file formats)."""
    from cigwas_tpu.cli import main as cli_main
    from cigwas_tpu.constants import BED_PREFIX_COL_MAJ
    from cigwas_tpu.io.bed import encode_bed_values

    tmp = tmp_path_factory.mktemp("refdiff")
    rng = np.random.default_rng(7)
    n, m = 3000, 80
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )

    def std(v):
        return (v - v.mean()) / v.std()

    y0 = sum(0.4 * std(G[i]) for i in (5, 15, 25)) + rng.normal(size=n)
    y1 = sum(0.4 * std(G[i]) for i in (35, 45)) + 0.5 * y0 + rng.normal(size=n)
    # y2 shares an instrument and a cause with y0 so the merged skeleton has
    # unshielded triples whose greedy pcorr path re-increases after
    # independence -> the reference records min-pcorr sepsets (it crashes
    # outright when none exist, `sepselect.py:319`)
    y2 = 0.4 * std(G[25]) + 0.3 * y0 + rng.normal(size=n)
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

    out = tmp / "blocks_out"
    out.mkdir()
    cli_main(["prep-bed", stem])
    cli_main(["block", stem, "40", "10", "16"])
    blockfile = stem + "_m40.blocks"
    n_blocks = sum(1 for _ in open(blockfile))
    assert n_blocks >= 2
    for bi in range(n_blocks):
        cli_main(
            ["cusk", str(bi), blockfile, stem, stem + ".phen", "0.001", "3", "14",
             "1", str(out)]
        )
    return tmp, blockfile, out, n


MERGED = ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs")
SEP_BYTES = (".mdim", ".atr", ".ut", ".ssm")
SEP_MATRICES = ("_sam.mtx", "_scm.mtx", "_spm.mtx")


def merged_digests(block_outputs) -> dict:
    from cigwas_tpu.merge.merge_blocks import merge_block_outputs

    tmp, blockfile, out, n = block_outputs
    ours_dir = tmp / "merged_ours"
    ours_dir.mkdir(exist_ok=True)
    merge_block_outputs(blockfile, str(out)).write_mm(
        str(ours_dir / "merged_blocks"))
    return {s: _digest((ours_dir / ("merged_blocks" + s)).read_bytes())
            for s in MERGED}


def sepselect_digests(block_outputs) -> dict:
    from cigwas_tpu.merge.merge_blocks import merge_block_outputs
    from cigwas_tpu.merge.sepselect import orient_v_structures_merged

    tmp, blockfile, out, n = block_outputs
    merged_dir = tmp / "merged_common"
    merged_dir.mkdir(exist_ok=True)
    stem = str(merged_dir / "merged_blocks")
    merge_block_outputs(blockfile, str(out)).write_mm(stem)
    # orient_v_structures_merged = sepselect + v-structure orientation (the
    # reference's bare sepselect_merged leaves pag=None, which its to_file
    # cannot serialize on modern scipy, `sepselect.py:552`)
    ours_stem = str(merged_dir / "ours_max_sep_min_pc")
    orient_v_structures_merged(stem, 0.001, n).to_file(ours_stem)
    out_d = {s: _digest(open(ours_stem + s, "rb").read()) for s in SEP_BYTES}
    out_d.update({s: _matrix_digest(ours_stem + s) for s in SEP_MATRICES})
    return out_d


def test_merge_blocks_byte_parity(golden, block_outputs):
    assert merged_digests(block_outputs) == golden["merged"]


def test_sepselect_parity(golden, block_outputs):
    assert sepselect_digests(block_outputs) == golden["sepselect"]


if __name__ == "__main__":
    import pathlib
    import tempfile

    class _Factory:
        def __init__(self, root):
            self.root = pathlib.Path(root)

        def mktemp(self, name):
            path = self.root / name
            path.mkdir()
            return path

    with tempfile.TemporaryDirectory() as d:
        outputs = block_outputs.__wrapped__(_Factory(d))
        digests = {"merged": merged_digests(outputs),
                   "sepselect": sepselect_digests(outputs)}
    with open(GOLDEN, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
