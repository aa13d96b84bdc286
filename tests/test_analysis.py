"""Regression tests of `cigwas_tpu.analysis` (the port of the reference's
`cusk/scripts/bdpc.py` analysis core): pleiotropy matrices/sets,
parent/ancestor sets, PAG extractions, edge tallies and association tables
on seeded synthetic inputs.

The expected values are goldens in `tests/data/analysis_golden.json`,
generated from `analysis.py` on these same seeded inputs at a commit where
every one of them was checked equal to `bdpc.py` run side by side (the
traversal rewrites are vectorized, so set/count equality against the
reference's queue-based walks was the parity contract). Regenerate with
`python tests/test_analysis.py` only after a deliberate behaviour change.
"""

import json
import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "analysis_golden.json")


def canon(x):
    """JSON-able canonical form: dicts and sets become sorted lists."""
    if isinstance(x, dict):
        return sorted(([canon(k), canon(v)] for k, v in x.items()),
                      key=json.dumps)
    if isinstance(x, (set, frozenset)):
        return sorted((canon(v) for v in x), key=json.dumps)
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def check(golden, key, value):
    assert canon(value) == golden[key], key


NUM_P = 3


def make_block_outputs(tmp):
    """Three synthetic blocks in the reference file formats (one written
    absent to exercise the missing-block skip)."""
    rng = np.random.default_rng(3)
    blockfile = os.path.join(tmp, "sim.blocks")
    specs = [("1", 0, 59, 12), ("1", 60, 99, 0), ("2", 0, 79, 9)]
    with open(blockfile, "w") as f:
        for chrom, a, b, _ in specs:
            f.write(f"{chrom}\t{a}\t{b}\n")
    # the reference's global_parent_sets has no missing-block tolerance
    # (bdpc.py:659-681 lacks the try/except its sibling has), so the
    # parent-set checks use a blockfile of present blocks only
    present_blockfile = os.path.join(tmp, "present.blocks")
    with open(present_blockfile, "w") as f:
        for chrom, a, b, num_m in specs:
            if num_m:
                f.write(f"{chrom}\t{a}\t{b}\n")
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir)
    for chrom, a, b, num_m in specs:
        if num_m == 0:
            continue  # missing block output
        n = num_m + NUM_P
        adj = np.zeros((n, n), np.int32)
        # random symmetric skeleton with phen-marker + marker-marker edges
        for _ in range(3 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[i, j] = adj[j, i] = 1
        corr = rng.normal(size=(n, n))
        corr = (((corr + corr.T) / 2) * adj).astype(np.float32)
        stem = os.path.join(outdir, f"{chrom}_{a}_{b}")
        with open(stem + ".mdim", "w") as f:
            f.write(f"{n}\t{NUM_P}\t3\n")
        adj.tofile(stem + ".adj")
        corr.tofile(stem + ".corr")
        np.full((n, n, 3), -1, np.int32).tofile(stem + ".sep")
        np.sort(
            rng.choice(b - a + 1, num_m, replace=False).astype(np.int32)
        ).tofile(stem + ".ixs")
    return blockfile, outdir + "/", present_blockfile


def make_pag_files(tmp):
    from scipy.io import mmwrite
    from scipy.sparse import coo_matrix

    rng = np.random.default_rng(5)
    num_phen, num_m = 4, 30
    n = num_phen + num_m
    pag = np.zeros((n, n), np.int64)
    marks = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (3, 2), (3, 3),
             (1, 3), (3, 1)]
    for _ in range(4 * n):
        i, j = rng.integers(0, n, 2)
        if i != j and pag[i, j] == 0:
            a, b = marks[rng.integers(len(marks))]
            pag[i, j], pag[j, i] = a, b
    pag_path = os.path.join(tmp, "pag.mtx")
    mmwrite(pag_path, coo_matrix(pag))
    pheno_path = os.path.join(tmp, "p.phen")
    with open(pheno_path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{i}" for i in range(num_phen))
                + "\n")
    return pag_path, pheno_path, pag, num_phen


@pytest.fixture(scope="module")
def block_outputs(tmp_path_factory):
    return make_block_outputs(str(tmp_path_factory.mktemp("bdpc")))


@pytest.fixture(scope="module")
def pag_files(tmp_path_factory):
    return make_pag_files(str(tmp_path_factory.mktemp("pag")))


def pleiotropy_mats(block_outputs, max_depth):
    from cigwas_tpu import analysis

    blockfile, outdir, _ = block_outputs
    return {
        "epm": analysis.global_epm(blockfile, outdir, max_depth=max_depth),
        "upm": analysis.global_upm(blockfile, outdir, max_depth=max_depth),
    }


def exclusive_pleiotropy_sets(block_outputs):
    from cigwas_tpu import analysis

    blockfile, outdir, _ = block_outputs
    return analysis.global_eps(blockfile, outdir)


def ancestor_and_parent_sets(block_outputs, depth):
    from cigwas_tpu import analysis

    blockfile, outdir, present_bf = block_outputs
    out = {"ancestors": analysis.global_ancestor_sets(blockfile, outdir,
                                                      depth=depth)}
    if depth == 1:
        out["parents"] = analysis.global_parent_sets(present_bf, outdir)
    return out


def pag_pleiotropy_sets(pag_files, depth):
    from cigwas_tpu import analysis

    pag_path, pheno_path, _, _ = pag_files
    return {
        "possible_child": analysis.pag_exclusive_pleiotropy_sets(
            pag_path, pheno_path, analysis.is_possible_child, depth),
        "child": analysis.pag_exclusive_pleiotropy_sets(
            pag_path, pheno_path, analysis.is_child, depth),
    }


def pag_paths_and_tallies(pag_files):
    from cigwas_tpu import analysis

    pag_path, pheno_path, pag, num_phen = pag_files
    return {
        # reachability saturates within num_phen hops, so the unbounded
        # result equals the reference's num_phen-bounded one
        "causal_paths": analysis.get_causal_paths(pag_path, pheno_path),
        "causal_paths_1": analysis.get_causal_paths(
            pag_path, pheno_path, max_path_len=1),
        "possibly_causal_paths": analysis.get_possibly_causal_paths(
            pag_path, pheno_path),
        "edge_types": analysis.pag_edge_types(pag_path, pheno_path),
        "x_to_y_edge_types": analysis.pag_x_to_y_edge_types(
            pag_path, pheno_path),
        "dag_directed": analysis.pag_to_dag_directed(pag),
        "dag_possibly_directed": analysis.pag_to_dag_possibly_directed(pag),
    }


def dag_helpers():
    from cigwas_tpu import analysis

    rng = np.random.default_rng(9)
    adj = np.triu(rng.random((12, 12)) < 0.3, k=1).astype(np.float64)
    adj *= rng.normal(size=adj.shape)
    return {
        "symmetric": analysis.make_adj_symmetric(adj),
        "link_types": analysis.make_link_type_dict(adj),
        "path_in_sem": analysis.path_in_sem(adj),
    }


def marker_pheno_associations(block_outputs, tmp):
    from cigwas_tpu import analysis
    from cigwas_tpu.merge import merge_block_outputs

    blockfile, outdir, _ = block_outputs
    gm = merge_block_outputs(blockfile, outdir)
    stem = os.path.join(tmp, "merged")
    gm.write_mm(stem)
    bim_path = os.path.join(tmp, "sim.bim")
    with open(bim_path, "w") as f:
        for i in range(200):
            f.write(f"1\trs{i}\t0\t{1000 + i}\tA\tC\n")
    table = analysis.marker_pheno_associations(
        bim_path=bim_path, corr_path=stem + "_scm.mtx",
        adj_path=stem + "_sam.mtx", ixs_path=stem + ".ixs", num_phen=NUM_P,
    )
    table = table.sort_values(["phenotype", "bim_line_ix"])
    return {
        col: table[col].tolist()
        for col in ["phenotype", "rsID", "bim_line_ix", "chr", "bp", "corr"]
    }


@pytest.mark.parametrize("max_depth", [1, 2, np.inf])
def test_global_pleiotropy_mats_match_reference(golden, block_outputs,
                                                max_depth):
    check(golden, f"pleiotropy_mats_{max_depth}",
          pleiotropy_mats(block_outputs, max_depth))


def test_global_eps_matches_reference(golden, block_outputs):
    check(golden, "exclusive_pleiotropy_sets",
          exclusive_pleiotropy_sets(block_outputs))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_global_ancestor_and_parent_sets_match_reference(
    golden, block_outputs, depth
):
    """depth=3 pins the reproduced queue-swap quirk (reference reach
    saturates at two marker hops, bdpc.py:852-860)."""
    check(golden, f"ancestor_and_parent_sets_{depth}",
          ancestor_and_parent_sets(block_outputs, depth))


@pytest.mark.parametrize("depth", [1, 2])
def test_pag_pleiotropy_sets_match_reference(golden, pag_files, depth):
    check(golden, f"pag_pleiotropy_sets_{depth}",
          pag_pleiotropy_sets(pag_files, depth))


def test_pag_paths_and_tallies_match_reference(golden, pag_files):
    check(golden, "pag_paths_and_tallies", pag_paths_and_tallies(pag_files))


def test_dag_helpers_match_reference(golden):
    check(golden, "dag_helpers", dag_helpers())


def test_marker_pheno_associations_match_reference(
    golden, block_outputs, tmp_path
):
    check(golden, "marker_pheno_associations",
          marker_pheno_associations(block_outputs, str(tmp_path)))


def test_plot_helpers_render(block_outputs, pag_files, tmp_path):
    """The plot entry points render on Agg without error (figure-level
    smoke; the numeric content is covered by the golden tests above)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cigwas_tpu import analysis

    blockfile, outdir, _ = block_outputs
    pag_path, pheno_path, _, num_phen = pag_files
    with open(tmp_path / "p3.phen", "w") as f:
        f.write("FID\tIID\tT0\tT1\tT2\n")
    fig, ax = plt.subplots()
    analysis.plot_skeleton_pleiotropy_mat(
        outdir, blockfile, str(tmp_path / "p3.phen"), ax=ax)
    plt.close(fig)
    fig, ax = plt.subplots()
    analysis.plot_pag(pag_path, pheno_path, ax=ax)
    plt.close(fig)
    fig, ax = plt.subplots()
    analysis.plot_pleiotropy_mat(pag_path, pheno_path, ax=ax)
    plt.close(fig)
    z = analysis.get_skeleton_pleiotropy_mat(
        outdir, blockfile, str(tmp_path / "p3.phen"))
    assert z.shape == (NUM_P, NUM_P)


def write_goldens() -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("bdpc", "pag"):
            os.makedirs(os.path.join(tmp, sub))
        blocks = make_block_outputs(os.path.join(tmp, "bdpc"))
        pags = make_pag_files(os.path.join(tmp, "pag"))
        out = {}
        for d in (1, 2, np.inf):
            out[f"pleiotropy_mats_{d}"] = pleiotropy_mats(blocks, d)
        out["exclusive_pleiotropy_sets"] = exclusive_pleiotropy_sets(blocks)
        for d in (1, 2, 3):
            out[f"ancestor_and_parent_sets_{d}"] = ancestor_and_parent_sets(
                blocks, d)
        for d in (1, 2):
            out[f"pag_pleiotropy_sets_{d}"] = pag_pleiotropy_sets(pags, d)
        out["pag_paths_and_tallies"] = pag_paths_and_tallies(pags)
        out["dag_helpers"] = dag_helpers()
        out["marker_pheno_associations"] = marker_pheno_associations(
            blocks, tmp)
    with open(GOLDEN, "w") as f:
        json.dump({k: canon(v) for k, v in out.items()}, f, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    write_goldens()
