"""The four differences the seed studies left open between the port's
medians and the JAX package's, over every seed the port has run: each
metric's median, [min, max] and seed count on both sides, the gap between
the medians against each side's spread, the share of the port's seeds
below JAX's median, and where two arms share their seeds the paired
median and the sign count.  It reads JSON only (the port's under
--outdir, JAX's committed under artifacts/) and trains nothing.

    python -m vqvaehmm_tpu_torch.scripts.open_differences [--outdir DIR]

Writes <outdir>/open_differences.json and prints it.  The files read:
  (a) throughput_quality_ab.json (seeds 42-46) and
      throughput_quality_ab_seeds47-66.json: the bfloat16 arm's -ELBO;
  (b) vq_sweep.json (42-46) and vq_sweep_seeds47-66.json: the n8_c0.5
      arm's smoothed switch rate;
  (c) crash_regime_torch_ref_seeds42-61.json (the card) and
      crash_regime_torch_ref_cpu_1thread_seeds42-61.json: the reference
      model's accuracy;
  (d) crash_regime.json (42-44) and crash_regime_seeds45-64.json: the
      oversampled pools' smoothed crash recall.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from ._common import OUTDIR, jax_artifact, log, write_json

ARTIFACT = "open_differences.json"


def _read(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _by_seed(rows, value) -> Dict[int, float]:
    return {int(r["seed"]): float(value(r)) for r in rows}


def summary(port: Dict[int, float], jax: Dict[int, float],
            paired_port: Optional[Dict[int, float]] = None,
            paired_jax: Optional[Dict[int, float]] = None) -> dict:
    """Both sides' median, [min, max] and n; the medians' gap against each
    side's spread; the share of the port's seeds below JAX's median; the
    two-sided Mann-Whitney U test of the two samples; and with paired_*
    (the control arm, seed by seed) the paired deltas' median and sign
    count on each side."""
    from scipy.stats import mannwhitneyu

    def stats(d):
        v = np.array(sorted(d.values()))
        return {"median": round(float(np.median(v)), 4),
                "min": round(float(v.min()), 4),
                "max": round(float(v.max()), 4), "n": len(v),
                "seeds": sorted(d)}

    p, j = stats(port), stats(jax)
    gap = abs(p["median"] - j["median"])
    out = {"port": p, "jax": j, "median_gap": round(gap, 4),
           "jax_spread": round(j["max"] - j["min"], 4),
           "port_spread": round(p["max"] - p["min"], 4),
           "parts_by_jax_spread": gap > j["max"] - j["min"],
           "parts_by_port_spread": gap > p["max"] - p["min"],
           "port_share_below_jax_median": round(float(np.mean(
               [v < j["median"] for v in port.values()])), 4),
           "mann_whitney_p": round(float(mannwhitneyu(
               list(port.values()), list(jax.values())).pvalue), 4)}
    for side, arm, ctrl in (("port", port, paired_port),
                            ("jax", jax, paired_jax)):
        if ctrl is None:
            continue
        d = [arm[s] - ctrl[s] for s in sorted(arm) if s in ctrl]
        out[f"{side}_paired"] = {
            "median": round(float(np.median(d)), 4), "n": len(d),
            "above": int(sum(x > 0 for x in d)),
            "below": int(sum(x < 0 for x in d)),
            "equal": int(sum(x == 0 for x in d))}
    return out


def bf16_elbo(outdir: str) -> dict:
    """(a) the bfloat16 arm's -ELBO, paired with the float32 arm."""
    key = "final_neg_elbo_full_panel_f32"
    port: Dict[str, Dict[int, float]] = {"throughput": {}, "parity": {}}
    for name in ("throughput_quality_ab.json",
                 "throughput_quality_ab_seeds47-66.json"):
        d = _read(outdir, name)
        for arm in port:
            port[arm].update(_by_seed(d[arm]["per_seed"], lambda r: r[key]))
    j = jax_artifact("throughput_quality_ab.json")
    jax = {a: _by_seed(j[a]["per_seed"], lambda r: r[key]) for a in port}
    return summary(port["throughput"], jax["throughput"], port["parity"],
                   jax["parity"])


def vq_switch(outdir: str) -> dict:
    """(b) the n8_c0.5 VQ arm's smoothed switch rate, paired with the
    default point."""
    rows: List[dict] = []
    for name in ("vq_sweep.json", "vq_sweep_seeds47-66.json"):
        rows += _read(outdir, name)["seeds"]["per_seed"]
    jrows = jax_artifact("vq_sweep.json")["seeds"]["per_seed"]

    def arm(rs, a):
        return _by_seed(rs, lambda r: r[a]["switch_smoothed"])
    return summary(arm(rows, "n8_c0.5"), arm(jrows, "n8_c0.5"),
                   arm(rows, "default"), arm(jrows, "default"))


def torch_ref(outdir: str) -> dict:
    """(c) the reference model's accuracy on the card and on the CPU with
    one torch thread, each against JAX's."""
    jax = _by_seed(jax_artifact("crash_regime.json")["torch_ref"]
                   ["per_seed"], lambda r: r["acc"])
    out = {}
    for where, name in (("card", "crash_regime_torch_ref_seeds42-61.json"),
                        ("cpu_1thread", "crash_regime_torch_ref_cpu_"
                         "1thread_seeds42-61.json")):
        d = _read(outdir, name)
        out[where] = summary(_by_seed(d["torch_ref"]["per_seed"],
                                      lambda r: r["acc"]), jax)
        out[where]["device"] = d.get("power_limit") or d.get("device")
    card, cpu = (_by_seed(_read(outdir, n)["torch_ref"]["per_seed"],
                          lambda r: r["acc"]) for n in (
        "crash_regime_torch_ref_seeds42-61.json",
        "crash_regime_torch_ref_cpu_1thread_seeds42-61.json"))
    out["card_vs_cpu"] = summary(card, cpu, cpu, card)
    out["card_vs_cpu"]["equal_seeds"] = int(sum(card[s] == cpu[s]
                                                for s in card))
    return out


def crash_recall(outdir: str) -> dict:
    """(d) each oversampled pool's smoothed crash recall, paired with the
    current arm."""
    def recall(d, stage):
        return _by_seed(d[stage]["per_seed"],
                        lambda r: r["smoothed_argmax"]["recall_regime2"])

    port: Dict[str, Dict[int, float]] = {}
    for name in ("crash_regime.json", "crash_regime_seeds45-64.json"):
        d = _read(outdir, name)
        for stage in ("current", "oversample_gt", "oversample_vol"):
            port.setdefault(stage, {}).update(recall(d, stage))
    j = jax_artifact("crash_regime.json")
    jax = {s: recall(j, s) for s in port}
    return {s: summary(port[s], jax[s], port["current"], jax["current"])
            for s in ("oversample_gt", "oversample_vol")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vqvaehmm_tpu_torch.scripts.open_differences",
        description="The four open differences over every seed run.")
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)
    out = {"a_bf16_neg_elbo": bf16_elbo(args.outdir),
           "b_vq_n8_c0.5_switch_smoothed": vq_switch(args.outdir),
           "c_torch_ref_acc": torch_ref(args.outdir),
           "d_crash_recall_smoothed": crash_recall(args.outdir)}
    write_json(args.outdir, ARTIFACT, out)
    log(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
