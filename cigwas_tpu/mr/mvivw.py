"""Multivariable inverse-variance-weighted Mendelian randomization.

Python equivalent of `mvivw/cig_mvivw.R`: for every outcome trait, regress
the SNP-outcome associations on the SNP-exposure associations of all other
traits, weighted by the outcome association variances, using the SNPs that
cusk selected as instruments (dropping the outcome's own parent SNPs).

The regression replaces the R `MendelianRandomization::mr_mvivw` call:

* ``robust=False``: random-effects multivariable IVW — weighted least
  squares with no intercept, standard errors scaled by max(1, sigma)
  (the mr_mvivw "random" model),
* ``robust=True`` (the reference's setting): an MM-type robust regression
  via iteratively reweighted least squares with Tukey bisquare psi and MAD
  scale. This follows the intent of `mr_mvivw(robust=TRUE)` (which uses
  robustbase::lmrob); coefficients agree closely but are not bit-identical
  to lmrob's S/MM implementation.

Input/output formats match the R script exactly: `_scm.mtx/_sam.mtx/.mdim`
in, TSV `source sink effect p sk_adj num_snps` out (`cig_mvivw.R:121-130`).
Results are returned as a list of dict rows with :data:`RESULT_COLUMNS`.
"""

from __future__ import annotations

import numpy as np
from scipy.io import mmread
from scipy.stats import norm

from cigwas_tpu.io.results import load_mdim, write_table

RESULT_COLUMNS = ["source", "sink", "effect", "p", "sk_adj", "num_snps"]


def _wls(X: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Weighted least squares without intercept; returns (beta, se, sigma)."""
    sw = np.sqrt(w)
    Xw = X * sw[:, None]
    yw = y * sw
    XtX = Xw.T @ Xw
    XtX_inv = np.linalg.pinv(XtX)
    beta = XtX_inv @ (Xw.T @ yw)
    resid = yw - Xw @ beta
    dof = max(X.shape[0] - X.shape[1], 1)
    sigma = np.sqrt(resid @ resid / dof)
    se = np.sqrt(np.diag(XtX_inv))
    return beta, se, sigma


def _bisquare_weights(u: np.ndarray, c: float = 4.685) -> np.ndarray:
    au = np.abs(u) / c
    w = (1 - au**2) ** 2
    w[au >= 1] = 0.0
    return w


def mv_ivw_regression(
    bx: np.ndarray,
    by: np.ndarray,
    byse: np.ndarray,
    robust: bool = True,
    max_iter: int = 50,
):
    """Multivariable IVW estimate; returns (estimates, std errors, p values)."""
    w = byse**-2.0
    if not robust:
        beta, se, sigma = _wls(bx, by, w)
        se = se * max(1.0, sigma)
    else:
        beta, se, sigma = _wls(bx, by, w)
        sw = np.sqrt(w)
        Xw = bx * sw[:, None]
        yw = by * sw
        for _ in range(max_iter):
            resid = yw - Xw @ beta
            scale = np.median(np.abs(resid)) / 0.6745
            if scale <= 0:
                break
            rw = _bisquare_weights(resid / scale)
            if rw.sum() < bx.shape[1] + 1:
                break
            Wr = rw
            XtX = Xw.T @ (Xw * Wr[:, None])
            new_beta = np.linalg.pinv(XtX) @ (Xw.T @ (yw * Wr))
            if np.allclose(new_beta, beta, atol=1e-10):
                beta = new_beta
                break
            beta = new_beta
        resid = yw - Xw @ beta
        scale = np.median(np.abs(resid)) / 0.6745
        dof = max(bx.shape[0] - bx.shape[1], 1)
        rw = _bisquare_weights(resid / max(scale, 1e-12))
        XtX = Xw.T @ (Xw * rw[:, None])
        XtX_inv = np.linalg.pinv(XtX)
        sigma_r = np.sqrt((rw * resid**2).sum() / dof) if rw.sum() > 0 else sigma
        se = np.sqrt(np.diag(XtX_inv)) * max(1.0, sigma_r)
    z = np.where(se > 0, beta / se, 0.0)
    p = 2 * norm.sf(np.abs(z))
    return beta, se, p


def run_mvivw(
    cusk_output_stem: str,
    num_samples: int,
    use_skeleton: bool = False,
    use_ld: bool = False,
    rm_counterfactual: bool = False,
    orientation_prior: str | None = None,
    out_path: str | None = None,
    robust: bool = True,
):
    """Per-outcome multivariable IVW over all traits (`cig_mvivw.R:50-130`).

    use_skeleton: restrict exposures to traits adjacent in the cusk skeleton
    and drop instruments of non-adjacent traits (the `-s` flag).
    """
    num_var, num_trait, *_ = load_mdim(cusk_output_stem)
    corrs = mmread(f"{cusk_output_stem}_scm.mtx").toarray()
    adj = mmread(f"{cusk_output_stem}_sam.mtx").toarray()

    fixed_links = None
    if rm_counterfactual:
        fixed_links = np.fromfile(orientation_prior, dtype=np.int32).reshape(
            num_trait, num_trait
        )

    pxp_adj = adj[:num_trait, :num_trait]
    mxp_adj = adj[:num_trait, num_trait:].T  # (num_snp, num_trait)
    B = corrs[:num_trait, num_trait:].T  # (num_snp, num_trait)
    SE = (1 - B * B) / np.sqrt(num_samples - 2)

    rows = []
    for outcome in range(num_trait):
        outcome_parents = np.where(mxp_adj[:, outcome] == 1)[0]
        all_rows = np.arange(B.shape[0])
        keep_rows = np.setdiff1d(all_rows, outcome_parents)

        if use_skeleton:
            tested = np.where(pxp_adj[:, outcome] == 1)[0]
            rm_rows = set(outcome_parents.tolist())
            for rm_trait in np.where(pxp_adj[:, outcome] != 1)[0]:
                rm_rows |= set(np.where(mxp_adj[:, rm_trait] == 1)[0].tolist())
            use_rows = np.setdiff1d(all_rows, np.array(sorted(rm_rows), dtype=int))
            bx = B[np.ix_(use_rows, tested)]
            by = B[use_rows, outcome]
            byse = SE[use_rows, outcome]
        elif rm_counterfactual:
            rm_traits = np.where(fixed_links[outcome] == 1)[0]
            rm_rows = set(outcome_parents.tolist())
            use_rows = np.setdiff1d(all_rows, np.array(sorted(rm_rows), dtype=int))
            tested = np.array(
                [
                    t
                    for t in range(num_trait)
                    if t != outcome and fixed_links[outcome, t] != 1
                ]
            )
            bx = B[np.ix_(use_rows, tested)]
            by = B[use_rows, outcome]
            byse = SE[use_rows, outcome]
        else:
            tested = np.array([t for t in range(num_trait) if t != outcome])
            bx = B[np.ix_(keep_rows, tested)]
            by = B[keep_rows, outcome]
            byse = SE[keep_rows, outcome]
            use_rows = keep_rows

        sufficient = bx.shape[0] > bx.shape[1]
        est = pvals = None
        if len(tested) > 0 and sufficient:
            est, _, pvals = mv_ivw_regression(bx, by, byse, robust=robust)

        for exposure in range(num_trait):
            if exposure == outcome:
                continue
            if sufficient and est is not None and exposure in tested:
                k = int(np.where(tested == exposure)[0][0])
                rows.append(
                    {
                        "source": exposure + 1,
                        "sink": outcome + 1,
                        "effect": float(est[k]),
                        "p": float(pvals[k]),
                        "sk_adj": bool(pxp_adj[exposure, outcome] == 1),
                        "num_snps": int(bx.shape[0]),
                    }
                )
            else:
                rows.append(
                    {
                        "source": exposure + 1,
                        "sink": outcome + 1,
                        "effect": 0.0,
                        "p": 1.0,
                        "sk_adj": bool(pxp_adj[exposure, outcome] == 1),
                        "num_snps": int(bx.shape[0]),
                    }
                )

    if out_path is not None:
        _write_results(out_path, rows)
    return rows


def _write_results(out_path: str, rows: list) -> None:
    """TSV with R's TRUE/FALSE for `sk_adj` (`cig_mvivw.R:121-130`)."""
    write_table(
        out_path, RESULT_COLUMNS,
        [dict(r, sk_adj="TRUE" if r["sk_adj"] else "FALSE") for r in rows],
        sep="\t",
    )


def run_mvivw_filtered(
    cusk_output_dir: str,
    num_samples: int,
    iv_rows,
    out_path: str | None = None,
    robust: bool = True,
):
    """Filtered-IV variant using a per-(exposure, outcome) IV table.

    Equivalent of `mvivw/cig_mvivw_filtered.R`: per outcome, the instrument
    set is the union of IVs listed for that outcome (1-based SNP indices)
    and the exposures those rows name; reads the cuskss_merged fileset.
    iv_rows: dict rows with "Exposure", "Outcome" and "IV" (as
    :func:`cigwas_tpu.merge.check_ivs` returns them).
    """
    stem = f"{cusk_output_dir}/cuskss_merged"
    num_var, num_trait, *_ = load_mdim(stem)
    corrs = mmread(f"{stem}_scm.mtx").toarray()
    adj = mmread(f"{stem}_sam.mtx").toarray()
    pxp_adj = adj[:num_trait, :num_trait]
    B = corrs[:num_trait, num_trait:].T
    SE = (1 - B * B) / np.sqrt(num_samples - 2)

    iv_exp = np.array([r["Exposure"] for r in iv_rows], dtype=np.int64)
    iv_out = np.array([r["Outcome"] for r in iv_rows], dtype=np.int64)
    iv_snp = np.array([r["IV"] for r in iv_rows], dtype=np.int64)
    rows = []
    for outcome in range(num_trait):
        sel = iv_out == outcome + 1
        ivs = np.unique(iv_snp[sel]) - 1  # to 0-based SNP rows
        exposures = np.unique(iv_exp[sel]) - 1
        bx = B[np.ix_(ivs, exposures)] if len(ivs) and len(exposures) else np.zeros((0, 0))
        by = B[ivs, outcome] if len(ivs) else np.zeros(0)
        byse = SE[ivs, outcome] if len(ivs) else np.zeros(0)
        sufficient = bx.shape[0] > bx.shape[1] and bx.shape[1] > 0
        est = pvals = None
        if sufficient:
            est, _, pvals = mv_ivw_regression(bx, by, byse, robust=robust)
        for exposure in range(num_trait):
            if exposure == outcome:
                continue
            if sufficient and exposure in exposures:
                k = int(np.where(exposures == exposure)[0][0])
                eff, p = float(est[k]), float(pvals[k])
            else:
                eff, p = 0.0, 1.0
            rows.append(
                {
                    "source": exposure + 1,
                    "sink": outcome + 1,
                    "effect": eff,
                    "p": p,
                    "sk_adj": bool(pxp_adj[exposure, outcome] == 1),
                    "num_snps": int(bx.shape[0]),
                }
            )
    if out_path is not None:
        _write_results(out_path, rows)
    return rows
