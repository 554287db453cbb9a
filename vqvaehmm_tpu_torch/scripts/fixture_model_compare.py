"""Regime recovery on the committed market fixture: the GMM stack, the
same GMM with a learned chain, and a Baum-Welch Gaussian HMM, against the
fixture's daily ground truth (counterpart of
scripts/fixture_model_compare.py).

  gmm                    SimpleRegimeDetector (10 float64 restarts of EM
                         over the 13 engineered features), no temporal
                         model: the reference's "improved" stack.
  gmm_plus_chain         the GMM's component densities as emissions,
                         (pi, A) by EM (models/hmm.py::fit_transitions_em),
                         decoded by the Viterbi kernel on the card.
  gaussian_hmm           models/hmm.py::fit_gaussian_em (diagonal
                         Gaussians, 4 restarts), its Viterbi path.
  heldout_*              the GMM (and its chain) fit on the first 80% of
                         days and scored on the last 20%.

The VAE-HMM and VQ rows (windows, not days: rates compare, denominators
do not) are the port's own quality_fixture.json and
vq_quality_fixture.json in --outdir, as the recipe's quality and vq
stages write them, where they are there; JAX's committed
artifacts/fixture_model_compare.json, quality_fixture.json and
vq_quality_fixture.json stand beside them under jax_artifact.  Output
<outdir>/fixture_model_compare.json, and one JSON line on stdout.

    python -m vqvaehmm_tpu_torch.scripts.fixture_model_compare
        [--device cuda]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import recipe
from ..core.device import resolve_device
from ..data import market
from ..models.gmm import SimpleRegimeDetector, prepare_regime_features
from ..models.hmm import fit_gaussian_em, fit_transitions_em
from ..ops.fused_viterbi import viterbi_fused
from ._common import device_record, jax_artifact, parser, write_json

ARTIFACT = "fixture_model_compare.json"
EM_ITERS = 40          # of the chain's and the Gaussian HMM's EM fits


def best_perm_balanced(pred, true, K):
    """Balanced accuracy (mean per-class recall) under the permutation
    that maximises raw accuracy: on the 90/8/2 fixture a constant
    calm-regime predictor scores 1/3 here, where its raw accuracy is some
    0.9."""
    return recipe._balanced_acc(pred, true,
                                recipe._best_perm_acc(pred, true, K)[1], K)


def switch_rate(states):
    """recipe._switch_rate of one day-by-day path, unrounded (that one
    takes (N, T) windows and rounds to 4 places)."""
    return float((np.diff(np.asarray(states)) != 0).mean())


def fixture_returns():
    """The fixture's daily returns (T, A) with the first, undefined row
    dropped (pandas' pct_change().dropna()), and each day's ground-truth
    regime."""
    prices, _, regimes = market.load_fixture_frames(recipe.FIXTURE)
    if regimes is None:
        raise ValueError("the fixture must carry __regime__ labels")
    ret = market._pct_change(prices.values)
    keep = ~np.isnan(ret).any(axis=1)
    return ret[keep], regimes[keep].astype(int)


def _chain_decode(det, feats, dev, fit_feats=None):
    """Viterbi path over `feats` of the chain whose (pi, A) EM fits on the
    GMM's component densities of `fit_feats` (default: feats)."""
    def log_obs(f):
        return det.gmm.log_prob_components(det._norm(f)).to(
            torch.float32)[None]                          # (1, T, K)
    lo_fit = log_obs(feats if fit_feats is None else fit_feats)
    log_pi, log_A, _ = fit_transitions_em(lo_fit, n_iters=EM_ITERS)
    lo = lo_fit if fit_feats is None else log_obs(feats)
    with torch.inference_mode():
        return viterbi_fused(log_pi, log_A, lo).states[0].cpu().numpy()


def _rows(out, prefix, suffix, pred, truth, K):
    out[f"{prefix}regime_acc_{suffix}"] = round(
        recipe._best_perm_acc(pred, truth, K)[0], 4)
    out[f"{prefix}regime_bal_acc_{suffix}"] = round(
        best_perm_balanced(pred, truth, K), 4)
    out[f"{prefix}switch_rate_{suffix}"] = round(switch_rate(pred), 4)


def compare(device, outdir: str) -> dict:
    dev = resolve_device(device)
    returns, truth = fixture_returns()
    K = int(truth.max()) + 1
    feats = prepare_regime_features(returns.astype(np.float32))
    assert len(feats) == len(truth)
    out = {"days": len(truth), "K": K,
           "majority_share": round(float(np.bincount(truth).max()
                                         / truth.size), 4),
           "switch_rate_ground_truth": round(switch_rate(truth), 4),
           "seeds": {"gmm": 0, "gaussian_hmm": 0}}

    # the reference's "improved" stack: a static GMM over the features
    det = SimpleRegimeDetector(n_regimes=K, seed=0, device=dev)
    det.fit(feats)
    _rows(out, "", "gmm", np.asarray(det.predict_regime(feats)), truth, K)
    # the fit's total log-likelihood, and each restart's: the restarts are
    # the port's own draws, not JAX's
    out["gmm_log_likelihood"] = round(det.gmm.log_likelihood_, 4)
    out["gmm_restart_log_likelihoods"] = [round(float(v), 4)
                                          for v in det.gmm.lls_]
    # the same emissions with learned dynamics: the chain's own value
    _rows(out, "", "gmm_plus_chain_viterbi",
          _chain_decode(det, feats, dev), truth, K)

    # a Baum-Welch Gaussian HMM (diagonal emissions) on z-scored features
    mu = feats.mean(0, keepdims=True)
    sd = feats.std(0, keepdims=True) + 1e-8
    z = torch.as_tensor(((feats - mu) / sd)[None], dtype=torch.float32,
                        device=dev)                            # (1, T, D)
    em = fit_gaussian_em(z, K=K, n_iters=EM_ITERS, seed=0, n_init=4)
    with torch.inference_mode():
        hmm_pred = em.model.posterior_mode(z)[0].cpu().numpy()
    _rows(out, "", "gaussian_hmm_viterbi", hmm_pred, truth, K)

    # held out: fit on the first 80% of days, score the last 20%
    cut = int(0.8 * len(truth))
    det_h = SimpleRegimeDetector(n_regimes=K, seed=0, device=dev)
    det_h.fit(feats[:cut])
    _rows(out, "heldout_", "gmm",
          np.asarray(det_h.predict_regime(feats[cut:])), truth[cut:], K)
    _rows(out, "heldout_", "gmm_plus_chain",
          _chain_decode(det_h, feats[cut:], dev,
                        fit_feats=feats[:cut]), truth[cut:], K)
    out["heldout_switch_rate_ground_truth"] = round(
        switch_rate(truth[cut:]), 4)

    # the port's own VAE-HMM and VQ window numbers, where the recipe's
    # quality and vq stages wrote them into the outdir
    for name, key in (("quality_fixture.json", "vae_hmm_windows"),
                      ("vq_quality_fixture.json", "vqvae_hmm_windows")):
        path = os.path.join(outdir, name)
        if os.path.exists(path):
            with open(path) as f:
                rows = json.load(f)
            out[key] = (rows if key == "vae_hmm_windows" else
                        {k: v for k, v in rows.items() if k.startswith(
                            ("regime_", "switch_rate", "codebook"))})
    out.update(device_record(dev))
    out["jax_artifact"] = {
        "source": "artifacts/fixture_model_compare.json, "
                  "artifacts/quality_fixture.json, "
                  "artifacts/vq_quality_fixture.json",
        "fixture_model_compare": jax_artifact(ARTIFACT),
        "quality_fixture": jax_artifact("quality_fixture.json"),
        "vq_quality_fixture": jax_artifact("vq_quality_fixture.json")}
    return out


def main(argv=None) -> int:
    ap = parser("fixture_model_compare", "The GMM stack, the GMM with a "
                "chain and a Gaussian HMM on the fixture's ground truth.")
    args = ap.parse_args(argv)
    out = compare(args.device, args.outdir)
    write_json(args.outdir, ARTIFACT, out)
    print(json.dumps({k: v for k, v in out.items() if k != "jax_artifact"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
