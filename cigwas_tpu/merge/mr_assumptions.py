"""MR instrument-variable candidate selection and assumption checks.

Equivalent of `cusk_postprocessing/check_mr_assumptions.py`: every SNP parent
of a trait becomes an IV candidate for all (exposure, outcome) pairs; the
optional `check_ivs` performs reverse-causality and exclusion-restriction CI
tests against the merged correlation matrix. Both return the IV table as a
list of ``{"Exposure", "Outcome", "IV"}`` dict rows (1-based, for R);
:data:`IV_COLUMNS` is its column order.
"""

from __future__ import annotations

import numpy as np
from scipy.io import mmread

from cigwas_tpu.io.results import load_mdim
from cigwas_tpu.utils.stats import alpha_threshold, fisher_z

IV_COLUMNS = ["Exposure", "Outcome", "IV"]


def _indep(x, y, s_ixs, corr, sample_size, alpha) -> bool:
    ixs = np.concatenate([[x, y], s_ixs]).astype(int)
    prec = np.linalg.inv(corr[np.ix_(ixs, ixs)])
    pc = fisher_z(-(prec[0, 1] / np.sqrt(np.abs(prec[0, 0] * prec[1, 1]))))
    return pc < alpha_threshold(alpha, sample_size, len(s_ixs))


def _snp_parents(trait_ix: int, adj: np.ndarray, num_traits: int) -> np.ndarray:
    parents = np.where(adj[trait_ix, :])[0]
    # strict '>' like the reference (`check_mr_assumptions.py:28-30`)
    return parents[parents > num_traits]


def get_iv_candidates(result_basename: str) -> list[dict]:
    """IV candidate table: SNP parents of each exposure for every
    (exposure, outcome) pair, 1-based for R (`check_mr_assumptions.py:38-54`)."""
    adj = mmread(f"{result_basename}_sam.mtx").toarray()
    _, num_traits, *_ = load_mdim(result_basename)
    rows = []
    candidates = {
        t: set(int(s) for s in _snp_parents(t, adj, num_traits))
        for t in range(num_traits)
    }
    for e in range(num_traits):
        for o in range(num_traits):
            if e == o:
                continue
            for snp in candidates[e]:
                rows.append(
                    {"Exposure": e + 1, "Outcome": o + 1, "IV": snp + 1 - num_traits}
                )
    return rows


def check_ivs(
    result_basename: str,
    sample_size: int,
    accept_alpha: float,
    reject_alpha: float,
    relaxed_local_faithfulness: bool = False,
    check_reverse_causality: bool = False,
) -> list[dict]:
    """CI-test based IV filtering (`check_mr_assumptions.py:57-116`)."""
    adj = mmread(f"{result_basename}_sam.mtx").toarray()
    corr = mmread(f"{result_basename}_scm.mtx").toarray()
    np.fill_diagonal(corr, 1)
    _, num_traits, *_ = load_mdim(result_basename)
    traits = range(num_traits)
    candidates = {
        t: set(int(s) for s in _snp_parents(t, adj, num_traits)) for t in traits
    }

    rev_cause = {t: set() for t in traits}
    if check_reverse_causality:
        for outcome in traits:
            for exposure in traits:
                if exposure == outcome:
                    continue
                for snp in candidates[outcome]:
                    marg_dep = not _indep(
                        snp, exposure, [], corr, sample_size, accept_alpha
                    )
                    cond_ind = _indep(
                        snp, exposure, [outcome], corr, sample_size, reject_alpha
                    )
                    if marg_dep and cond_ind:
                        rev_cause[outcome].add(exposure)

    all_traits = set(traits)
    valid_exposures = {t: all_traits - (rev_cause[t] | {t}) for t in traits}

    iv_snps = {(e, o): set() for e in traits for o in traits if e != o}
    for outcome in traits:
        for exposure in valid_exposures[outcome]:
            for snp in candidates[exposure]:
                if relaxed_local_faithfulness:
                    marg_dep = True
                else:
                    marg_dep = not _indep(
                        snp, outcome, [], corr, sample_size, accept_alpha
                    )
                cond_ind = _indep(
                    snp,
                    outcome,
                    sorted(valid_exposures[outcome]),
                    corr,
                    sample_size,
                    reject_alpha,
                )
                if cond_ind and marg_dep:
                    iv_snps[(exposure, outcome)].add(snp)

    rows = []
    for (e, o), ivs in iv_snps.items():
        for snp in ivs:
            rows.append(
                {"Exposure": e + 1, "Outcome": o + 1, "IV": snp + 1 - num_traits}
            )
    return rows
