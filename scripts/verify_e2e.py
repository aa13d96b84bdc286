#!/usr/bin/env python
"""End-to-end verify drive (see .claude/skills/verify/SKILL.md).

Simulates a small GWAS dataset with planted causal structure, runs every
pipeline stage through the public API on CPU, and checks that the merged
skeleton recovers exactly the planted edges (SNP10->T1, SNP50->T2, T1-T2).
"""

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from cigwas_tpu.constants import BED_PREFIX_COL_MAJ
    from cigwas_tpu.io.bed import encode_bed_values
    from cigwas_tpu import prep, pipelines, merge

    rng = np.random.default_rng(42)
    n, m, p = 4000, 120, 2
    G = rng.integers(0, 3, (m, n)).astype(np.float32)
    Gs = (G - G.mean(1, keepdims=True)) / G.std(1, keepdims=True)
    T1 = 0.4 * Gs[10] + rng.normal(size=n)
    T2 = 0.4 * Gs[50] + 0.5 * T1 + rng.normal(size=n)
    Y = np.stack([T1, T2])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)

    d = tempfile.mkdtemp(prefix="verify_e2e_")
    os.chdir(d)
    with open("sim.bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ + encode_bed_values(G).tobytes())
    with open("sim.bim", "w") as f:
        for j in range(m):
            f.write(f"1\tsnp{j}\t0\t{j * 1000 + 1}\tA\tC\n")
    with open("sim.fam", "w") as f:
        for i in range(n):
            f.write(f"f{i} i{i} 0 0 1 -9\n")
    with open("sim.phen", "w") as f:
        f.write("FID\tIID\tT1\tT2\n")
        for i in range(n):
            f.write(f"f{i}\ti{i}\t{Y[0, i]:.6f}\t{Y[1, i]:.6f}\n")

    prep.prep_bed("sim")
    pipelines.make_blocks("sim", 64, 16)
    blockfile = "sim_m64.blocks"
    nblocks = sum(1 for _ in open(blockfile))
    os.makedirs("out", exist_ok=True)
    for b in range(nblocks):
        pipelines.cusk("sim.phen", "sim", blockfile, 1e-3, 3, 14, 1, "out", b)
    gm = merge.merge_block_outputs(blockfile, "out/")
    gm.write_mm("out/merged_blocks")
    sep = merge.sepselect_merged("out/merged_blocks", 1e-3, n)
    sep.orient_v_structures(1e-3, n)
    sep.to_file("out/max_sep_min_pc")

    mk = {v: k for k, v in gm.gmi.items()}  # bim row -> global sparse index
    adj = lambda a, b: (a, b) in gm.sam or (b, a) in gm.sam
    ok_t1 = adj(1, mk[10])
    ok_t2 = adj(2, mk[50])
    ok_tt = adj(1, 2)
    # no false trait-trait edges beyond the planted one (p=2 so trivial) and
    # no other SNP-trait adjacencies at these effect sizes
    snp_trait = sorted(
        row for row, g in mk.items() if adj(1, g) or adj(2, g)
    )
    print(f"dir={d}")
    print(f"T1-snp10 adjacent: {ok_t1}")
    print(f"T2-snp50 adjacent: {ok_t2}")
    print(f"T1-T2 adjacent:    {ok_tt}")
    print(f"snp-trait adjacencies: {snp_trait}")
    assert ok_t1 and ok_t2 and ok_tt, "planted structure not recovered"
    assert snp_trait == [10, 50], f"false adjacencies: {snp_trait}"

    # determinism: re-run one block, outputs byte-identical
    import hashlib, glob
    before = {f: hashlib.sha256(open(f, "rb").read()).hexdigest()
              for f in glob.glob("out/1_*")}
    for b in range(nblocks):
        pipelines.cusk("sim.phen", "sim", blockfile, 1e-3, 3, 14, 1, "out", b)
    after = {f: hashlib.sha256(open(f, "rb").read()).hexdigest()
             for f in glob.glob("out/1_*")}
    assert before == after, "non-deterministic block outputs"
    print("determinism: byte-identical rerun OK")
    print("VERIFY PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
