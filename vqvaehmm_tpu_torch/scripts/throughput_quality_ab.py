"""Does the throughput configuration (bfloat16) train models as good as
the parity configuration (float32)?  Counterpart of
scripts/throughput_quality_ab.py.

Each seed trains the quality recipe (40 epochs at lr 1e-3, B=64) in both
arms through TrainPipeline with the device input pipeline, so per seed
the two arms see the same sample stream and differ only in numerics:

  parity      float32 ("highest"); on the card kernel C in float32
              (fused "auto").  JAX's parity arm is XLA with fused=False;
              here fused=False would put the plain path on the card
              (train/trainer.py::resolve_fused), so the arm is the
              kernel, and the JSON says so.
  throughput  bfloat16 ("default"); on the card kernel C's bfloat16 mode
              on the tensor cores.

Both arms are scored under the float32 model on the fixture's windows:
the negative ELBO, the smoothed posterior's argmax (the evidence kernel,
then the plain recursions) and the Viterbi path (the evidence and
Viterbi kernels).  Output <outdir>/throughput_quality_ab.json: per-seed
rows, [min, median, max] a metric, the paired deltas (throughput -
parity) with the switch rates, and JAX's distributions from
artifacts/throughput_quality_ab.json beside them.

    python -m vqvaehmm_tpu_torch.scripts.throughput_quality_ab
        [--seeds 42 43 44 45 46] [--epochs 40] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from .. import recipe
from ..core.device import resolve_device
from ..models.vae_hmm import VAEHMM
from ..train.pipeline import TrainPipeline
from ._common import (decode_scores, device_record, dist, inside,
                      jax_artifact, load_windows, log, parser, write_json)

ARTIFACT = "throughput_quality_ab.json"
VARIANTS = {
    "parity": (
        dict(compute_dtype="float32", matmul_precision="highest"),
        dict(fused="auto", input_pipeline="device"),
    ),
    "throughput": (
        dict(compute_dtype="bfloat16", matmul_precision="default"),
        dict(fused="auto", input_pipeline="device"),
    ),
}
DELTA_KEYS = ("final_neg_elbo_full_panel_f32",
              "regime_acc_smoothed_argmax", "regime_bal_acc_smoothed_argmax",
              "switch_rate_smoothed_argmax", "regime_acc_viterbi",
              "regime_bal_acc_viterbi", "switch_rate_viterbi")
PARITY_ARM = ("float32 through kernel C (fused 'auto') on the card and its "
              "plain version on the CPU; JAX's parity arm is XLA with "
              "fused=False, which in the port would put the plain path on "
              "the card")


def run_variant(outdir: str, tag: str, seed: int, model_over: dict,
                train_over: dict, epochs: int, device):
    """One arm at one seed: (float32 state_dict on the CPU, the epoch
    losses, wall seconds)."""
    cfg = recipe.recipe_config(outdir, quality=True)
    with tempfile.TemporaryDirectory(prefix=f"vqhmm_ab_{tag}_") as ck:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_over),
            training=dataclasses.replace(
                cfg.training, save_freq=0, seed=seed, num_epochs=epochs,
                checkpoint_dir=ck, **train_over))
        t0 = time.time()
        pipe = TrainPipeline(cfg, device=device)
        state = pipe.train(log_fn=None)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        wall = time.time() - t0
    # scored under the parity model whatever the arm trained in
    params = {k: v.detach().to("cpu", torch.float32)
              for k, v in state.model.state_dict().items()}
    return params, list(pipe.history), wall


def evaluate(outdir: str, params: dict, device) -> dict:
    """The float32 model's negative ELBO on every window, and its
    smoothed and Viterbi decodes scored against the ground truth."""
    dev = resolve_device(device)
    cfg = recipe.recipe_config(outdir, quality=True)
    model = VAEHMM(cfg.model, device=dev)   # float32, "highest"
    model.load_state_dict(params)
    model.eval()
    x, u, z = load_windows(outdir)
    with torch.no_grad():
        xt, ut = (torch.as_tensor(a, device=dev) for a in (x, u))
        lengths = torch.full((x.shape[0],), x.shape[2], dtype=torch.int32,
                             device=dev)
        elbo = float(model.compute_loss(xt, ut, lengths, 1.0))
    preds = recipe._decodes(model, x, u, dev, meanfield=False)
    return {"final_neg_elbo_full_panel_f32": round(elbo, 6),
            **decode_scores(preds, z)}


def paired_deltas(throughput_rows, parity_rows) -> dict:
    """Per seed, throughput minus parity, and the median."""
    deltas = {}
    for k in DELTA_KEYS:
        pairs = [t[k] - p[k] for t, p in zip(throughput_rows, parity_rows)]
        deltas[k] = {"per_seed": [round(d, 4) for d in pairs],
                     "median": round(float(np.median(pairs)), 4)}
    return deltas


def against_jax(out: dict, jax: dict) -> dict:
    """JAX's seeds, distributions and median deltas, and for each arm and
    metric whether the port's median lies inside JAX's [min, max]."""
    ref = {"source": "artifacts/throughput_quality_ab.json",
           "seeds": jax.get("seeds"),
           "backend": jax.get("backend"),
           "distributions": {a: jax[a]["distributions"]
                             for a in VARIANTS if a in jax},
           "deltas_median": {k: v["median"] for k, v in
                             jax.get("deltas_throughput_minus_parity",
                                     {}).items()},
           "switch_rate_ground_truth": jax.get("switch_rate_ground_truth")}
    ref["port_median_vs_jax_spread"] = {
        a: {k: inside(out[a]["distributions"].get(k), v)
            for k, v in ref["distributions"].get(a, {}).items()
            if k.startswith(("regime_", "switch_rate", "final_neg_elbo"))}
        for a in VARIANTS}
    return ref


def main(argv=None) -> int:
    ap = parser("throughput_quality_ab", "5-seed float32/bfloat16 A/B of "
                "the quality recipe, scored under the float32 model.")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46])
    ap.add_argument("--epochs", type=int, default=recipe.QUALITY_EPOCHS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    load_windows(args.outdir)

    out = {**device_record(device),
           "config": f"quality recipe ({args.epochs} epochs @ lr=1e-3, "
                     "B=64), both arms on the device input pipeline "
                     "(identical per-seed sample stream; precision/step "
                     "impl are the only differences)",
           "parity_arm": PARITY_ARM,
           "throughput_arm": "bfloat16 through kernel C's bfloat16 mode "
                             "(tensor cores) on the card and its plain "
                             "version on the CPU",
           "seeds": args.seeds, "epochs": args.epochs}
    for tag, (mo, to) in VARIANTS.items():
        rows = []
        for seed in args.seeds:
            log(f"=== {tag} seed {seed}: model={mo} training={to} ===")
            params, history, wall = run_variant(args.outdir, tag, seed, mo,
                                                to, args.epochs, device)
            row = {"seed": seed, "wall_seconds": round(wall, 1),
                   "final_train_loss": round(history[-1], 6)
                   if history else None,
                   **evaluate(args.outdir, params, device),
                   "train_history": history}
            log(f"  {json.dumps(row)}")
            rows.append(row)
        metric_keys = [k for k in rows[0] if k not in ("seed", "train_history")
                       and rows[0][k] is not None]
        out[tag] = {"model_overrides": mo,
                    "train_overrides": {k: str(v) for k, v in to.items()},
                    "per_seed": rows,
                    "distributions": {k: dist(rows, k) for k in metric_keys}}
    out["deltas_throughput_minus_parity"] = paired_deltas(
        out["throughput"]["per_seed"], out["parity"]["per_seed"])
    _, _, z = load_windows(args.outdir)
    out["switch_rate_ground_truth"] = recipe._switch_rate(z)
    jax = jax_artifact(ARTIFACT)
    out["jax_artifact"] = against_jax(out, jax) if jax else None
    write_json(args.outdir, ARTIFACT, out)
    print(json.dumps({
        "deltas": {k: v["median"] for k, v in
                   out["deltas_throughput_minus_parity"].items()},
        "parity_viterbi_switch":
            out["parity"]["distributions"]["switch_rate_viterbi"],
        "throughput_viterbi_switch":
            out["throughput"]["distributions"]["switch_rate_viterbi"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
