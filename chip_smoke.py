#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vqvaehmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports nothing of JAX.  Phases, each printing one line, any failure
exiting non-zero before a result is printed:

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every csrc/*.cu kernel from the checkout.
3. kernel A (fused serving forward) against its plain PyTorch version on
   the card, with the published weights: B in {1, 8, 64}, T in
   {37, 200, 512}, scalar and per-sequence valid_to, non-zero tails;
   max-abs error <= 1e-5 on q and <= 1e-4 on mu and logvar (both float32,
   different summation orders).  Row i of a B=8 call must be bit-equal to
   the same row computed alone.
4. kernel B (Viterbi) against its plain version at (B, T) in
   {(1, 200), (64, 200), (1, 2327)}, K=3, ragged lengths, and log_A
   given per sequence, per step and stationary: states equal, score
   within 1e-5 relative (the two run the same float operations in the
   same order).
5. serving: the published checkpoint behind the stdlib HTTP server on the
   card; /health, /infer in all four modes, /predict, and a wrong-shape
   request that must get a 400.  Every response is held against the same
   request computed by the plain path on the CPU in this process (mu,
   logvar <= 1e-4; mean-field q and /predict <= 1e-5; smoothed and
   filtered probabilities <= 1e-4, since the HMM recursions carry the two
   devices' rounding of the evidence over T steps; Viterbi states equal,
   or a path whose score under the CPU's evidence is within 1e-4 of the
   CPU optimum where two paths tie).  The launch counters of the serving
   forward, the Viterbi kernel and the evidence kernel are reset before
   this phase and must be non-zero after it.
6. times: each kernel and its plain version with CUDA events, median of 5
   windows with [min, max].
7. kernel C (fused loss and all 18 gradients) against its plain version
   (compute_loss plus autograd) on the card: the published weights at
   (B, T) in {(64, 200), (8, 200)} with ragged lengths, a case with every
   length <= 150 (valid_to < T), u in both layouts, beta in {0.1, 1.0};
   and the probe shape (B=256, T=512, C=16, K=8, hidden 256/128,
   trans_hidden 256) with fresh weights from a seed.  The loss within
   1e-5 relative, each gradient within 1e-4 * max|plain| max-abs (both
   float32, different summation orders); a second call bit-equal to the
   first; one launch a call.
8. kernel D (window gather) against its plain version and the host
   collate at B=64, T=200 on a pool of ragged synthetic sequences, with
   windows at the start and the end of a sequence, ln = min_len and
   ln = T: exactly equal.
9. training through TrainPipeline with the published configuration on
   the card (4 epochs of 15 steps, save_freq 2): the log shows
   `input_pipeline=device fused=True`; kernels C and D launch once a step
   each (counts reset just before the run); every epoch loss is finite;
   the same pipeline on the CPU (plain versions, the same index stream)
   gives per-epoch losses within 1e-4 relative; a run stopped by SIGTERM
   after epoch 2 and resumed ends bit-equal to the uninterrupted run; the
   trained .npz serves a mean-field request through the port's
   InferenceModel on the card, matching the CPU within 1e-4.
10. times: kernels C and D and their plain versions (kernel C's plain
   version is the forward plus the autograd backward), and the
   pipeline's training goodput in seqs/s from the log timestamps of the
   steady epochs (2-4).
11. profile: an 8-epoch TrainPipeline run without periodic checkpoints,
   its last epoch traced with torch.profiler on the card alone: the
   goodput of the untraced steady epochs (3-7), the profiler's overhead
   on the host, the device's busy share of the traced epoch's wall and
   (inferred) of an untraced step's, and the device time a step of
   kernel C, kernel D and the rest (clip, Adam).

12. kernel 8 (fused encoder) against its plain version with the published
   weights at (B, T) in {(1, 37), (8, 200), (64, 200), (460, 20),
   (1, 2327)}, valid_to None, scalar and per-sequence, non-zero tails:
   logits within 1e-5 max-abs (both float32, different summation orders);
   a row of a batched call bit-equal to the row alone.
13. kernel 11 (HMM evidence) against its plain version at (64, 200) with
   ragged lengths and (1, 2327), u in both layouts: log_obs and log_A
   within 1e-5 max-abs.
14. kernel 10 (one-kernel decode) against its plain version and against
   kernel 11 feeding kernel B: states equal, or the path's score under
   the plain evidence within 1e-4 absolute of the optimum's, or 32
   float32 roundings of that score, where two paths tie; the path frozen
   past each length.
15. bulk scoring at full width with the quality checkpoint and the
   committed Improved head: features from the fixture panel through
   data/market.py; `evaluate`; `Backtester.run(rebalance_freq=5)` with the
   head and with equal weights; `WalkForwardBacktest.run` (252/63/126,
   no retraining); `RegimeBacktest.run` with the argmax decode, the
   one-kernel decode and the model's two-stage decode.  Each is held
   against the same call with device="cpu" in this process: the MSE
   within 1e-5 relative, the weight schedule within 1e-5, every metric
   within 1e-4 relative (the ledger is float64 on the host in both), the
   decoded panel equal or explained by a score tie.  The launch counters
   of kernels 8, 10 and 11 are reset before the entry points are called
   and read just after them; nothing else launches a kernel in between
   (the decoded panels are recorded inside the closures the entry points
   call), and the counts must be exactly what those calls imply: kernel 8
   once a Backtester.run that trades and once an argmax decode of the
   panel, kernels 10 and 11 once each.  After the counts are read, kernel
   8 is also held against its plain version on the backtest's own stack
   of windows with the quality weights.
16. times: the three kernels and their plain versions at (64, 200),
   (460, 20) and (1, 2327), back to back with CUDA events (which holds
   the host's launch rate for a kernel of a few tens of microseconds)
   and as device-busy time a call on the profiler; the wall time of one
   `Backtester.run`, split into its parts, and of one whole-panel decode
   three ways.

The line before the last is a JSON summary of the kernels, each with the
least time the card could take for the same work (`bound_ms`: the larger
of its operations over 67 TFLOP/s of fp32 and its input and output bytes
over 3.35 TB/s, from this run's shapes); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "artifacts", "config_published.json")
CHECKPOINT = os.path.join(ROOT, "artifacts", "checkpoints_published",
                          "vae_hmm_trained.npz")
QUALITY_CONFIG = os.path.join(ROOT, "artifacts", "config_quality.json")
QUALITY_CHECKPOINT = os.path.join(ROOT, "artifacts", "checkpoints_quality",
                                  "vae_hmm_trained.npz")
HEAD_CHECKPOINT = os.path.join(ROOT, "artifacts", "portfolio_head.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "market_fixture.csv")
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def load_published(torch, device, config=CONFIG, checkpoint=CHECKPOINT):
    from vqvaehmm_tpu_torch.core.config import load_config
    from vqvaehmm_tpu_torch.data.checkpoint import (load_params_npz,
                                                    params_from_numpy)
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    model = VAEHMM(load_config(config).model, device=device)
    model.load_state_dict(params_from_numpy(load_params_npz(checkpoint)))
    return model.eval()


def bound_ms(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the fp32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def token_flops(cfg):
    """FLOPs a time step of the encoder, the prior MLP and the decoder."""
    C, H1, H2, K, D = (cfg.input_dim, cfg.hidden_dim, cfg.hidden_dim2,
                       cfg.K, cfg.hidden_dim)
    enc = 2 * (3 * C * H1 + 3 * H1 * H2 + H2 * K)
    prior = 2 * (cfg.u_dim * cfg.trans_hidden + cfg.trans_hidden * K * K)
    dec = 2 * (K * D + 3 * D * D + 3 * D * D + D * 2 * C)
    return enc, prior, dec


def weight_bytes(*modules) -> int:
    return sum(4 * p.numel() for m in modules for p in m.parameters())


def kernel_bounds(model, B, T):
    """bound_ms and bound_by of every kernel at (B, T) with the published
    widths: each input read once, each output written once."""
    cfg = model.cfg
    C, U, K = cfg.input_dim, cfg.u_dim, cfg.K
    enc, prior, dec = token_flops(cfg)
    N = B * T
    w_enc = weight_bytes(model.encoder)
    w_pri = weight_bytes(model.prior_module)
    w_all = weight_bytes(model)
    return {
        # x -> mu, logvar, q
        "fused_infer": bound_ms(N * (enc + K + dec),
                                4 * N * (3 * C + K) + 4 * B + w_all - w_pri),
        # log_A, log_obs, lengths, log_pi -> states, score
        "viterbi": bound_ms(B * (T - 1) * (2 * K * K + K),
                            4 * N * (K * K + K + 1) + 8 * B + 4 * K),
        # forward, and a backward of twice its operations; x, u, lengths
        # and the weights -> the loss and one gradient a weight
        "fused_train": bound_ms(3 * N * (enc + prior + dec),
                                4 * N * (C + U) + 4 * B + 2 * w_all + 4),
        # triples and the windows read -> the windows written
        "gather": bound_ms(0, 2 * 4 * N * (C + U) + 3 * 4 * B),
        # x, valid_to -> logits
        "fused_encode": bound_ms(N * enc, 4 * N * (C + K) + 4 * B + w_enc),
        # x, u -> log_obs, log_A
        "fused_evidence": bound_ms(
            N * (enc + prior + 4 * (K + K * K)),
            4 * N * (C + U + K + K * K) + 4 * B + w_enc + w_pri),
        # x, u, lengths -> states
        "fused_decode": bound_ms(
            N * (enc + prior + 4 * (K + K * K)) + B * (T - 1) * (2 * K * K
                                                                 + K),
            4 * N * (C + U + 1) + 8 * B + w_enc + w_pri),
    }


def phase_kernel_a(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward

    dev = model.device
    C = model.cfg.input_dim
    tol = {"mu": 1e-4, "logvar": 1e-4, "q": 1e-5}
    worst = {k: 0.0 for k in tol}
    rng = np.random.default_rng(0)
    n0 = fused_forward.launches
    for B in (1, 8, 64):
        for T in (37, 200, 512):
            x = torch.from_numpy(
                rng.normal(size=(B, C, T)).astype(np.float32)).to(dev)
            lens = rng.integers(1, T + 1, size=B)
            lens[0] = T
            for vt in (T - T // 5, torch.from_numpy(
                    lens.astype(np.int32)).to(dev)):
                got = fused_forward(model, x, valid_to=vt, use_kernel=True)
                want = fused_forward(model, x, valid_to=vt,
                                     use_kernel=False)
                torch.cuda.synchronize()
                for name, g, w in zip(tol, got, want):
                    if not torch.isfinite(g).all():
                        fail(f"kernel A {name} not finite at B={B} T={T}")
                    err = max_abs(g, w)
                    worst[name] = max(worst[name], err)
                    if err > tol[name]:
                        fail(f"kernel A {name} max-abs error {err:.3e} > "
                             f"{tol[name]:.0e} at B={B} T={T}")
    if fused_forward.launches - n0 != 18:
        fail(f"kernel A launched {fused_forward.launches - n0} times for "
             "18 cases")
    say("kernel A", "max-abs error vs plain over 18 cases: "
        + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.0e})"
                    for k, v in worst.items()))

    # a row of a batch is bit-equal to the same row computed alone
    B, T = 8, 200
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32)
                         ).to(dev)
    vt = torch.tensor([200, 150, 37, 199, 1, 120, 64, 200],
                      dtype=torch.int32, device=dev)
    batched = fused_forward(model, x, valid_to=vt, use_kernel=True)
    for i in range(B):
        solo = fused_forward(model, x[i:i + 1], valid_to=vt[i:i + 1],
                             use_kernel=True)
        for name, g, s in zip(("mu", "logvar", "q"), batched, solo):
            if not torch.equal(g[i:i + 1], s):
                fail(f"kernel A row {i} {name}: batched != solo")
    say("kernel A", f"batched rows bit-equal to solo rows (B={B}, T={T}, "
        "per-sequence valid_to)")
    return max(worst.values())


def viterbi_inputs(torch, np, rng, B, T, K, dev, a_shape):
    log_pi = torch.log_softmax(torch.from_numpy(
        rng.normal(size=K).astype(np.float32)), 0).to(dev)
    log_A = torch.log_softmax(torch.from_numpy(
        rng.normal(size=a_shape + (K, K)).astype(np.float32)), -1).to(dev)
    log_obs = torch.from_numpy(
        rng.normal(size=(B, T, K)).astype(np.float32) * 2.0).to(dev)
    lens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    lens[0] = T - 7
    return log_pi, log_A, log_obs, torch.from_numpy(lens).to(dev)


def phase_kernel_b(torch, np, dev):
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    rng = np.random.default_rng(1)
    K = 3
    worst = 0.0
    n0 = viterbi_fused.launches
    cases = [(1, 200, "B,T"), (64, 200, "B,T"), (1, 2327, "B,T"),
             (64, 200, "T"), (64, 200, "stationary")]
    for B, T, kind in cases:
        a_shape = {"B,T": (B, T), "T": (T,), "stationary": ()}[kind]
        args = viterbi_inputs(torch, np, rng, B, T, K, dev, a_shape)
        got = viterbi_fused(*args, use_kernel=True)
        want = viterbi_fused(*args, use_kernel=False)
        torch.cuda.synchronize()
        if not torch.equal(got.states, want.states):
            n = int((got.states != want.states).sum())
            fail(f"kernel B states differ at {n} steps (B={B} T={T} "
                 f"log_A {kind})")
        rel = float(((got.score.double() - want.score.double()).abs()
                     / want.score.double().abs().clamp(min=1.0)).max())
        worst = max(worst, max_abs(got.score, want.score))
        if rel > 1e-5:
            fail(f"kernel B score relative error {rel:.3e} > 1e-5 "
                 f"(B={B} T={T})")
    if viterbi_fused.launches - n0 != len(cases):
        fail(f"kernel B launched {viterbi_fused.launches - n0} times for "
             f"{len(cases)} cases")
    say("kernel B", f"states equal and scores within 1e-5 relative in "
        f"{len(cases)} cases (max-abs score error {worst:.3e})")
    return worst


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def _path_score(torch, log_pi, log_A, log_obs, states):
    """log p(z, x) of a path under one sequence's evidence (T steps)."""
    s = states.long()
    score = log_pi[s[0]] + log_obs[0, s[0]]
    for t in range(1, len(s)):
        score = score + log_A[t, s[t - 1], s[t]] + log_obs[t, s[t]]
    return float(score)


def phase_serve(torch, np):
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    with open(CONFIG) as f:
        model_section = json.load(f)["model"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg_path = os.path.join(tmp, "inference_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": model_section, "checkpoint_path": CHECKPOINT},
                  f)
    os.environ["VQHMM_REQUIRE_CHECKPOINT"] = "1"

    cpu = InferenceModel(cfg_path, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cuda")
    url = f"http://127.0.0.1:{port}"
    try:
        if not httpd.vqhmm_model.checkpoint_loaded:
            fail("the server did not load the published checkpoint")
        rng = np.random.default_rng(2)
        C, U = model_section["input_dim"], model_section["u_dim"]
        reqs = []
        for T in (37, 200, 512, 1500):
            reqs.append(("/infer", "mean_field", T))
        reqs += [("/infer", "viterbi", 200), ("/infer", "viterbi", 1500),
                 ("/infer", "smoothed", 200), ("/infer", "filtered", 200),
                 ("/predict", "predict", 200)]
        payloads = []
        for path, mode, T in reqs:
            p = {"x": rng.normal(size=(C, T)).astype(np.float32).tolist()}
            if mode in ("viterbi", "smoothed", "filtered"):
                p["u"] = rng.normal(size=(U, T)).astype(np.float32).tolist()
                p["mode"] = mode
            payloads.append(p)

        fused_forward.launches = 0
        viterbi_fused.launches = 0
        fused_evidence.launches = 0
        status, body, _ = _request(url + "/health")
        if status != 200 or body != {"status": "ok"}:
            fail(f"/health answered {status} {body}")
        responses, lat = [], {}
        for (path, mode, T), p in zip(reqs, payloads):
            times = []
            for _ in range(5):
                status, body, dt = _request(url + path, p)
                if status != 200:
                    fail(f"{path} {mode} T={T} answered {status}")
                times.append(dt)
            responses.append(body)
            lat.setdefault(mode, []).extend(times)
        try:
            _request(url + "/infer", {"x": [[1.0, 2.0]]})
            fail("a request with the wrong C was not refused")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"a request with the wrong C got {e.code}, not 400")
        launches = {"fused_infer": fused_forward.launches,
                    "viterbi": viterbi_fused.launches,
                    "fused_evidence": fused_evidence.launches}
        for name, n in launches.items():
            if n == 0:
                fail(f"the serving phase never launched the {name} kernel")
    finally:
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    # the same requests through the plain path on the CPU
    worst = {}
    for (path, mode, T), p, got in zip(reqs, payloads, responses):
        if path == "/predict":
            want = cpu.predict(p["x"])
            checks = {"weights": 1e-5, "regime_probs": 1e-5}
        else:
            want = cpu.infer(p["x"], u=p.get("u"), mode=mode)
            checks = {"mu": 1e-4, "logvar": 1e-4,
                      "regime_probs": 1e-5 if mode in ("mean_field",
                                                       "viterbi") else 1e-4}
        for key, tol in checks.items():
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.isfinite(g).all():
                fail(f"{path} {mode} T={T} {key}: shape {g.shape} vs "
                     f"{w.shape} or non-finite")
            err = float(np.abs(g - w).max())
            worst[f"{mode}.{key}"] = max(worst.get(f"{mode}.{key}", 0.0),
                                         err)
            if err > tol:
                fail(f"{path} {mode} T={T} {key} differs from the CPU plain "
                     f"path by {err:.3e} > {tol:.0e}")
        if mode == "viterbi":
            g, w = np.asarray(got["states"]), np.asarray(want["states"])
            if g.shape != (T,):
                fail(f"viterbi T={T}: states shape {g.shape}")
            if not np.array_equal(g, w):
                # ties: the GPU path must score as well as the CPU optimum
                m = cpu.model
                x = torch.tensor(p["x"])[None]
                u = torch.tensor(p["u"])[None]
                with torch.inference_mode():
                    log_pi, log_A = m.prior(u)
                    log_obs = m._hmm_evidence(x, torch.tensor([T]))
                sg = _path_score(torch, log_pi, log_A[0], log_obs[0],
                                 torch.from_numpy(g))
                sw = _path_score(torch, log_pi, log_A[0], log_obs[0],
                                 torch.from_numpy(w))
                if abs(sg - sw) > 1e-4 * max(1.0, abs(sw)):
                    fail(f"viterbi T={T}: states differ at "
                         f"{int((g != w).sum())} steps and the served path "
                         f"scores {sg} vs the CPU optimum {sw}")
                say("serve", f"viterbi T={T}: {int((g != w).sum())} steps "
                    f"differ on a tie (scores {sg} vs {sw})")
    say("serve", "published checkpoint served on the card matches the CPU "
        "plain path: " + ", ".join(f"{k} {v:.2e}"
                                   for k, v in sorted(worst.items())))
    say("serve", f"kernel launches while serving: {launches}; p50 latency "
        "ms: " + ", ".join(f"{m} {statistics.median(v) * 1e3:.3f}"
                           for m, v in lat.items()))
    return launches


def _time(torch, fn, iters=50, windows=5):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out), min(out), max(out)


def phase_times(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    dev = model.device
    rng = np.random.default_rng(3)
    res = {}
    with torch.inference_mode():
        for B in (64, 1):
            T = 200
            x = torch.from_numpy(rng.normal(size=(B, model.cfg.input_dim, T))
                                 .astype(np.float32)).to(dev)
            for use in (False, True):
                res[("fused_infer", B, use)] = _time(
                    torch, lambda: fused_forward(model, x, valid_to=T,
                                                 use_kernel=use))
            args = viterbi_inputs(torch, np, rng, B, T, model.cfg.K, dev,
                                  (B, T))
            for use in (False, True):
                res[("viterbi", B, use)] = _time(
                    torch, lambda: viterbi_fused(*args, use_kernel=use),
                    iters=50 if use else 3)
    for (name, B, use), (med, lo, hi) in res.items():
        say("times", f"{name} {'kernel' if use else 'plain '} B={B} T=200: "
            f"{med:.4f} ms [{lo:.4f}, {hi:.4f}]")
    return res


PROBE = dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128, u_dim=4,
             trans_hidden=256)


def train_inputs(torch, np, rng, B, T, C, U, dev, short=None, btu=False):
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(B, U, T)).astype(np.float32))
    if btu:
        u = u.transpose(1, 2).contiguous()
    lens = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lens[0] = T
    if short is not None:
        lens = np.minimum(lens, short)
    return x.to(dev), u.to(dev), torch.from_numpy(lens).to(dev)


def probe_model(torch, dev):
    from vqvaehmm_tpu_torch.core.config import ModelConfig
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    return VAEHMM(ModelConfig(**PROBE), device=dev,
                  generator=torch.Generator().manual_seed(7))


def phase_kernel_c(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads

    dev = model.device
    rng = np.random.default_rng(4)
    probe = probe_model(torch, dev)
    cases = [(model, 64, 200, 1.0, None, False),
             (model, 8, 200, 0.1, None, False),
             (model, 64, 200, 0.1, 150, False),
             (model, 8, 200, 1.0, 150, True),
             (probe, 256, 512, 1.0, None, False)]
    worst, worst_loss = 0.0, 0.0
    n0 = fused_loss_and_grads.launches
    for m, B, T, beta, short, btu in cases:
        cfg = m.cfg
        x, u, lens = train_inputs(torch, np, rng, B, T, cfg.input_dim,
                                  cfg.u_dim, dev, short, btu)
        loss, grads = fused_loss_and_grads(m, x, u, lens, beta,
                                           use_kernel=True)
        loss2, grads2 = fused_loss_and_grads(m, x, u, lens, beta,
                                             use_kernel=True)
        want_loss, want = fused_loss_and_grads(m, x, u, lens, beta,
                                               use_kernel=False)
        torch.cuda.synchronize()
        what = f"B={B} T={T} beta={beta} short={short} btu={btu}"
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads.values()):
            fail(f"kernel C gave a non-finite loss or gradient at {what}")
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        worst_loss = max(worst_loss, rel)
        if rel > 1e-5:
            fail(f"kernel C loss {float(loss)} vs plain {float(want_loss)}"
                 f" (relative {rel:.3e} > 1e-5) at {what}")
        for name, w in want.items():
            err = max_abs(grads[name], w)
            bound = 1e-4 * float(w.abs().max())
            worst = max(worst, err)
            if err > bound:
                fail(f"kernel C gradient {name} max-abs error {err:.3e} > "
                     f"{bound:.3e} at {what}")
        if not torch.equal(loss, loss2) or not all(
                torch.equal(grads[n], grads2[n]) for n in grads):
            fail(f"kernel C is not bit-equal across two calls at {what}")
    if fused_loss_and_grads.launches - n0 != 2 * len(cases):
        fail(f"kernel C launched {fused_loss_and_grads.launches - n0} "
             f"times for {2 * len(cases)} calls")
    say("kernel C", f"{len(cases)} cases: loss within {worst_loss:.3e} "
        f"relative (tol 1e-5), gradients within 1e-4 * max|plain| "
        f"(largest max-abs error {worst:.3e}), second call bit-equal")
    return worst


def synthetic_pool(np, rng, C, U):
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences

    xs, us, _ = synthetic_sequences(12, 400, C, U, 3, seed=5)
    lens = rng.integers(200, 401, size=12)
    return ([x[:, :n] for x, n in zip(xs, lens)],
            [u[:, :n] for u, n in zip(us, lens)], lens)


def gather_case(np, rng, lens, B, T, min_len):
    si = rng.integers(0, len(lens), size=B)
    ln = rng.integers(min_len, T + 1, size=B)
    ln[:8] = min_len
    ln[8:16] = T
    st = rng.integers(0, lens[si] - ln + 1)
    st[::4] = 0                                   # windows at the start
    st[1::4] = (lens[si] - ln)[1::4]              # windows at the end
    return [a.astype(np.int32) for a in (si, st, ln)]


def phase_kernel_d(torch, np, dev):
    from vqvaehmm_tpu_torch.data.dataset import collate_fn
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_windows,
                                               validate_triples)

    rng = np.random.default_rng(6)
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    px, pu = (torch.from_numpy(a).to(dev) for a in build_pools(xs, us))
    B, T = 64, 200
    worst = 0.0
    n0 = gather_windows.launches
    for _ in range(4):
        trip = gather_case(np, rng, lens, B, T, 20)
        validate_triples(*trip, lens, T)
        idx = [torch.from_numpy(a).to(dev) for a in trip]
        got = gather_windows(px, pu, *idx, T, use_kernel=True)
        want = gather_windows(px, pu, *idx, T, use_kernel=False)
        torch.cuda.synchronize()
        si, st, ln = trip
        host = collate_fn([(xs[i][:, s:s + n], us[i][:, s:s + n], n)
                           for i, s, n in zip(si, st, ln)], pad_to=T)
        for name, g, w, h in zip(("x", "u"), got, want, host):
            worst = max(worst, max_abs(g, w))
            if not torch.equal(g, w) or not np.array_equal(g.cpu().numpy(),
                                                           h):
                fail(f"kernel D {name} differs from its plain version or "
                     "the host collate")
    if gather_windows.launches - n0 != 4:
        fail(f"kernel D launched {gather_windows.launches - n0} times for 4 "
             "calls")
    say("kernel D", "4 batches at B=64, T=200 equal to the plain version "
        "and the host collate bit for bit")
    return worst


def _pipeline_cfg(ckpt_dir, **training):
    from vqvaehmm_tpu_torch.core.config import apply_overrides, load_config

    over = [f"training.checkpoint_dir={ckpt_dir}", "training.num_epochs=4",
            "training.save_freq=2"]
    over += [f"training.{k}={json.dumps(v)}" for k, v in training.items()]
    return apply_overrides(load_config(CONFIG), over)


def phase_train(torch, np):
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_windows
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # the main path: the published configuration on the card
        logs = []

        def log(msg):
            logs.append((time.perf_counter(), msg))

        cfg = _pipeline_cfg(os.path.join(tmp, "gpu"))
        pipe = TrainPipeline(cfg, device="cuda")
        fused_loss_and_grads.launches = 0
        gather_windows.launches = 0
        state = pipe.train(log_fn=log)
        torch.cuda.synchronize()
        launches = {"fused_train": fused_loss_and_grads.launches,
                    "gather": gather_windows.launches}
        t = cfg.training
        steps = t.num_epochs * (cfg.data.samples_per_epoch // t.batch_size)
        if not any(m.startswith("input_pipeline=device fused=True")
                   for _, m in logs):
            fail("the training log does not show input_pipeline=device "
                 f"fused=True: {[m for _, m in logs]}")
        for name, n in launches.items():
            if n != steps:
                fail(f"training launched the {name} kernel {n} times in "
                     f"{steps} steps")
        if state.step != steps:
            fail(f"training made {state.step} updates, not {steps}")
        gpu_hist = pipe.history
        if len(gpu_hist) != t.num_epochs or not np.isfinite(gpu_hist).all():
            fail(f"epoch losses {gpu_hist}")
        stamps = [ts for ts, m in logs if m.startswith("Epoch ")]
        seqs = t.batch_size * (cfg.data.samples_per_epoch // t.batch_size)
        goodput = (len(stamps) - 1) * seqs / (stamps[-1] - stamps[0])
        say("train", f"TrainPipeline on the card: {steps} steps, kernel "
            f"launches {launches}, epoch losses {gpu_hist}")

        # the same pipeline on the CPU: plain versions, same index stream
        cpu = TrainPipeline(_pipeline_cfg(os.path.join(tmp, "cpu"),
                                          input_pipeline="device"),
                            device="cpu")
        cpu.train(log_fn=None)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_hist, cpu.history))
        if rel > 1e-4:
            fail(f"card epoch losses {gpu_hist} vs CPU {cpu.history}: "
                 f"relative {rel:.3e} > 1e-4")
        say("train", f"CPU plain run: epoch losses {cpu.history}, largest "
            f"relative difference {rel:.3e} (tol 1e-4)")

        # exact resume: SIGTERM after epoch 2, then a rerun
        rcfg = _pipeline_cfg(os.path.join(tmp, "resume"))

        def preempt_at_2(msg):
            if msg.startswith("Epoch 2/"):
                os.kill(os.getpid(), signal.SIGTERM)

        first = TrainPipeline(rcfg, device="cuda")
        part = first.train(log_fn=preempt_at_2)
        meta = load_metadata(os.path.join(tmp, "resume", "vae_hmm_periodic"))
        if not first.preempted or part.step != steps // 2 or \
                not meta or not meta.get("preempted"):
            fail(f"SIGTERM did not stop training at epoch 2 (step "
                 f"{part.step}, metadata {meta})")
        second = TrainPipeline(rcfg, device="cuda")
        resumed = second.train(log_fn=None)
        if second.preempted or resumed.step != steps:
            fail(f"the resumed run ended at step {resumed.step}")
        ref = state.model.state_dict()
        for name, v in resumed.model.state_dict().items():
            if not torch.equal(v, ref[name]):
                fail(f"resumed run differs from the uninterrupted run at "
                     f"{name}")
        say("train", "SIGTERM at epoch 2 and resume: final parameters "
            "bit-equal to the uninterrupted run")

        # serve what the card trained
        with open(CONFIG) as f:
            model_section = json.load(f)["model"]
        cfg_path = os.path.join(tmp, "inference_config.json")
        with open(cfg_path, "w") as f:
            json.dump({"model": model_section, "checkpoint_path":
                       os.path.join(tmp, "gpu", "vae_hmm_trained.npz")}, f)
        served = InferenceModel(cfg_path, device="cuda")
        if not served.checkpoint_loaded:
            fail("InferenceModel did not load the trained .npz")
        x = np.random.default_rng(8).normal(size=(5, 200)).astype(
            np.float32).tolist()
        got, want = served.infer(x), InferenceModel(cfg_path,
                                                    device="cpu").infer(x)
        for key in ("mu", "logvar", "regime_probs"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.isfinite(g).all() or \
                    float(np.abs(g - w).max()) > 1e-4:
                fail(f"served {key} of the trained model: shape {g.shape} "
                     f"or values differ from the CPU by more than 1e-4")
        say("train", "the trained .npz serves a mean-field request on the "
            "card, equal to the CPU within 1e-4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, goodput


def phase_train_times(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import build_pools, gather_windows

    dev = model.device
    rng = np.random.default_rng(9)
    res = {}
    probe = probe_model(torch, dev)
    for m, B, T, iters in ((model, 64, 200, 20), (probe, 256, 512, 2)):
        x, u, lens = train_inputs(torch, np, rng, B, T, m.cfg.input_dim,
                                  m.cfg.u_dim, dev)
        for use in (False, True):
            res[("fused_train", B, T, use)] = _time(
                torch, lambda: fused_loss_and_grads(m, x, u, lens, 1.0,
                                                    use_kernel=use),
                iters=iters)
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    px, pu = (torch.from_numpy(a).to(dev) for a in build_pools(xs, us))
    idx = [torch.from_numpy(a).to(dev)
           for a in gather_case(np, rng, lens, 64, 200, 20)]
    for use in (False, True):
        res[("gather", 64, 200, use)] = _time(
            torch, lambda: gather_windows(px, pu, *idx, 200,
                                          use_kernel=use))
    for (name, B, T, use), (med, lo, hi) in res.items():
        say("times", f"{name} {'kernel' if use else 'plain '} B={B} "
            f"T={T}: {med:.4f} ms [{lo:.4f}, {hi:.4f}]")
    return res


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def phase_train_profile(torch, np):
    """Goodput of steady epochs without checkpoints, and where the time of
    one steady epoch of the pipeline goes on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    # CUPTI's set-up, outside the traced epoch
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    # the last epoch (8) is traced on the card alone (no host ops are
    # recorded), from just after the profiler starts to its log line;
    # epochs 3-7 are the untraced steady epochs.  Unlike them, epoch 8
    # draws no next epoch.
    prof = profile(activities=[ProfilerActivity.CUDA])
    stamps, begin = [], []

    def log(msg):
        if not msg.startswith("Epoch "):
            return
        stamps.append(time.perf_counter())
        if msg.startswith("Epoch 7/"):
            prof.start()
            begin.append(time.perf_counter())
        elif msg.startswith("Epoch 8/"):
            prof.stop()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        cfg = _pipeline_cfg(tmp, num_epochs=8, save_freq=0)
        pipe = TrainPipeline(cfg, device="cuda")
        pipe.train(log_fn=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = cfg.training
    B, steps = t.batch_size, cfg.data.samples_per_epoch // t.batch_size
    # gaps[k]: the wall of epoch k + 2, between two log lines
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    untraced = gaps[1:6]                                 # epochs 3-7
    steady = len(untraced) * steps * B / (sum(untraced) / 1e3)
    traced = 1e3 * (stamps[7] - begin[0]) / steps
    plain_step = statistics.median(untraced) / steps
    say("profile", f"TrainPipeline, save_freq 0, 8 epochs: ms between "
        f"epoch log lines {[round(g, 3) for g in gaps]}; goodput of the "
        f"untraced epochs 3-7: {steady:.1f} seqs/s")

    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    cats = {"kernel C": [], "kernel D": [], "other (clip, Adam, sums)": []}
    for e in ops:
        key = ("kernel C" if "fused_train" in e.name else "kernel D"
               if "gather_kernel" in e.name else "other (clip, Adam, sums)")
        cats[key].append((e.time_range.start, e.time_range.end))
    busy = _busy_us(iv for ivs in cats.values() for iv in ivs) / 1e3 / steps
    if busy <= 0.0:
        fail("the profiler saw no device time in the traced epoch")
    # the device time a step does not depend on the host, so its share
    # of an untraced step's wall is inferred from the trace
    say("profile", f"traced epoch 8: {traced:.4f} ms a step against "
        f"{plain_step:.4f} ms a step untraced (profiler overhead "
        f"{traced / plain_step:.3f}x); device busy {busy:.4f} ms a step: "
        f"{100 * busy / traced:.2f}% of the traced wall, "
        f"{100 * busy / plain_step:.2f}% of an untraced step (inferred)")
    for key, ivs in cats.items():
        say("profile", f"  device {key}: {_busy_us(ivs) / 1e3 / steps:.4f} "
            f"ms a step, {len(ivs)} ops in {steps} steps")

    sampler = DeviceEpochSampler(pipe.load_data(), "cuda")
    t0 = time.perf_counter()
    triples = sampler.sample_indices_fast(B)
    t1 = time.perf_counter()
    sampler.upload(*triples)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("profile", f"drawing an epoch's index triples {1e3 * (t1 - t0):.3f}"
        f" ms, uploading them {1e3 * (t2 - t1):.3f} ms (idle card)")
    return steady


def _randn(torch, np, rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def phase_kernel_8(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    dev = model.device
    C = model.cfg.input_dim
    rng = np.random.default_rng(12)
    worst, cases = 0.0, 0
    n0 = fused_encode.launches
    for B, T in ((1, 37), (8, 200), (64, 200), (460, 20), (1, 2327)):
        x = _randn(torch, np, rng, (B, C, T), dev)     # non-zero tails
        lens = rng.integers(1, T + 1, size=B)
        lens[0] = T
        for vt in (None, T - T // 5,
                   torch.from_numpy(lens.astype(np.int32)).to(dev)):
            got = fused_encode(model, x, valid_to=vt, use_kernel=True)
            want = fused_encode(model, x, valid_to=vt, use_kernel=False)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"kernel 8 logits {tuple(got.shape)} not finite or "
                     f"misshapen at B={B} T={T}")
            err = max_abs(got, want)
            worst, cases = max(worst, err), cases + 1
            if err > 1e-5:
                fail(f"kernel 8 logits max-abs error {err:.3e} > 1e-5 at "
                     f"B={B} T={T}")
    if fused_encode.launches - n0 != cases:
        fail(f"kernel 8 launched {fused_encode.launches - n0} times for "
             f"{cases} cases")
    B, T = 8, 200
    x = _randn(torch, np, rng, (B, C, T), dev)
    vt = torch.tensor([200, 150, 37, 199, 1, 120, 64, 200],
                      dtype=torch.int32, device=dev)
    batched = fused_encode(model, x, valid_to=vt, use_kernel=True)
    for i in range(B):
        solo = fused_encode(model, x[i:i + 1], valid_to=vt[i:i + 1],
                            use_kernel=True)
        if not torch.equal(batched[i:i + 1], solo):
            fail(f"kernel 8 row {i}: batched != solo")
    say("kernel 8", f"logits max-abs error vs plain over {cases} cases: "
        f"{worst:.3e} (tol 1e-5); batched rows bit-equal to solo rows "
        f"(B={B}, T={T}, per-sequence valid_to)")
    return worst


def decode_inputs(torch, np, rng, model, B, T, ragged, btu):
    """(x, u, lengths or None) on the model's device; x is non-zero past
    the lengths."""
    cfg = model.cfg
    x, u, lens = train_inputs(torch, np, rng, B, T, cfg.input_dim,
                              cfg.u_dim, model.device, None, btu)
    return x, u, (lens if ragged else None)


def phase_kernel_11(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    rng = np.random.default_rng(13)
    worst = 0.0
    cases = [(64, 200, True, False), (64, 200, True, True),
             (1, 2327, False, False), (1, 2327, False, True)]
    n0 = fused_evidence.launches
    for B, T, ragged, btu in cases:
        x, u, lens = decode_inputs(torch, np, rng, model, B, T, ragged, btu)
        got = fused_evidence(model, x, u, lens, use_kernel=True)
        want = fused_evidence(model, x, u, lens, use_kernel=False)
        torch.cuda.synchronize()
        for name, g, w in zip(("log_pi", "log_A", "log_obs"), got, want):
            if g.shape != w.shape or not g.is_contiguous() or \
                    not torch.isfinite(g).all():
                fail(f"kernel 11 {name} {tuple(g.shape)} misshapen, strided "
                     f"or not finite at B={B} T={T}")
            err = max_abs(g, w)
            worst = max(worst, err)
            if err > 1e-5:
                fail(f"kernel 11 {name} max-abs error {err:.3e} > 1e-5 at "
                     f"B={B} T={T} btu={btu}")
    if fused_evidence.launches - n0 != len(cases):
        fail(f"kernel 11 launched {fused_evidence.launches - n0} times for "
             f"{len(cases)} cases")
    say("kernel 11", f"log_obs and log_A max-abs error vs plain over "
        f"{len(cases)} cases: {worst:.3e} (tol 1e-5)")
    return worst


# two decodes of one evidence may part where two paths tie to float32
# rounding: their scores then agree to 1e-4 absolute or 32 float32 roundings
# of the score, the larger (about 1e-2 at T=2327, well under the cost of
# one wrong state)
TIE_ATOL, TIE_ULPS = 1e-4, 32


def _tie_gap(torch, evidence, got, want, lens):
    """(largest absolute gap, largest gap over its tolerance) between the
    scores of two decoded batches under one evidence, over the rows whose
    valid steps differ."""
    log_pi, log_A, log_obs = (a.double().cpu() for a in evidence)
    gap, excess = 0.0, 0.0
    for b in range(got.shape[0]):
        L = got.shape[1] if lens is None else int(lens[b])
        g, w = got[b, :L].cpu(), want[b, :L].cpu()
        if torch.equal(g, w):
            continue
        sg = _path_score(torch, log_pi, log_A[b, :L], log_obs[b, :L], g)
        sw = _path_score(torch, log_pi, log_A[b, :L], log_obs[b, :L], w)
        tol = max(TIE_ATOL, TIE_ULPS * torch.finfo(torch.float32).eps
                  * abs(sw))
        gap = max(gap, abs(sg - sw))
        excess = max(excess, abs(sg - sw) / tol)
    return gap, excess


def phase_kernel_10(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    rng = np.random.default_rng(14)
    cases = [(64, 200, True, False), (8, 200, True, True),
             (1, 2327, False, False)]
    worst, ties = 0.0, 0
    n0 = fused_viterbi_states.launches
    for B, T, ragged, btu in cases:
        x, u, lens = decode_inputs(torch, np, rng, model, B, T, ragged, btu)
        got = fused_viterbi_states(model, x, u, lens, use_kernel=True)
        plain = fused_viterbi_states(model, x, u, lens, use_kernel=False)
        ev = fused_evidence(model, x, u, lens, use_kernel=True)
        staged = viterbi_fused(*ev, lens, use_kernel=True).states
        torch.cuda.synchronize()
        what = f"B={B} T={T} btu={btu}"
        if got.dtype != torch.int32 or tuple(got.shape) != (B, T) or \
                int(got.min()) < 0 or int(got.max()) >= model.cfg.K:
            fail(f"kernel 10 states misshapen or out of range at {what}")
        plain_ev = fused_evidence(model, x, u, lens, use_kernel=False)
        for name, other in (("plain", plain), ("kernel 11 -> kernel B",
                                               staged)):
            if torch.equal(got, other):
                continue
            gap, excess = _tie_gap(torch, plain_ev, got, other, lens)
            worst, ties = max(worst, gap), ties + 1
            if excess > 1.0:
                fail(f"kernel 10 differs from {name} at "
                     f"{int((got != other).sum())} steps and scores "
                     f"{gap:.3e} apart, {excess:.1f} times the tolerance "
                     f"of a tie, at {what}")
        if lens is not None:
            for b in range(B):
                L = int(lens[b])
                if not bool((got[b, L:] == got[b, L - 1]).all()):
                    fail(f"kernel 10 path not frozen past length {L} in "
                         f"row {b} at {what}")
    if fused_viterbi_states.launches - n0 != len(cases):
        fail(f"kernel 10 launched {fused_viterbi_states.launches - n0} "
             f"times for {len(cases)} cases")
    say("kernel 10", f"{len(cases)} cases against plain and against kernel "
        f"11 -> kernel B: states equal except {ties} comparisons tied "
        f"within {worst:.3e} of score (tol {TIE_ATOL:g} or {TIE_ULPS} "
        "float32 roundings of the score); tails frozen")
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _metrics_gap(got, want) -> float:
    """Largest relative difference over BacktestResult.metrics."""
    if got.metrics.keys() != want.metrics.keys():
        fail(f"metrics {sorted(got.metrics)} vs {sorted(want.metrics)}")
    return max(_rel(got.metrics[k], v) for k, v in want.metrics.items())


def bulk_stack(torch, device):
    """The quality model and the Improved head on `device`, as closures
    for the backtester."""
    from vqvaehmm_tpu_torch.data.checkpoint import load_improved_head
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states

    model = load_published(torch, torch.device(device), QUALITY_CONFIG,
                           QUALITY_CHECKPOINT)
    head = load_improved_head(HEAD_CHECKPOINT, device=device)

    def posterior_fn(x):
        with torch.inference_mode():
            return model.posterior(x)

    def model_fn(q):
        with torch.inference_mode():
            return head(q)

    def equal_fn(q):
        n = head.cfg.n_assets
        return torch.full((q.shape[0], n), 1.0 / n, device=q.device)

    def one_kernel_decode(x, u):
        with torch.inference_mode():
            return fused_viterbi_states(model, x, u)

    def two_stage_decode(x, u):
        with torch.inference_mode():
            return model.viterbi_decode(x, u)

    return dict(model=model, head=head, posterior_fn=posterior_fn,
                model_fn=model_fn, equal_fn=equal_fn,
                decoders={"one_kernel": one_kernel_decode,
                          "two_stage": two_stage_decode})


def _recording(fn, log):
    """fn, appending each of its results to `log`."""
    def wrapped(*args):
        out = fn(*args)
        log.append(out)
        return out
    return wrapped


def phase_bulk(torch, np):
    from vqvaehmm_tpu_torch.backtest import (Backtester, RegimeBacktest,
                                             WalkForwardBacktest)
    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.eval.evaluate import evaluate
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    t0 = time.perf_counter()
    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x, u, ret, aligned = market.prepare_sequences(prices, regime)
    xs, us = market.create_sequences(x, u)
    recipe_ms = 1e3 * (time.perf_counter() - t0)
    seqs = (np.transpose(xs, (0, 2, 1)).astype(np.float32),
            np.transpose(us, (0, 2, 1)).astype(np.float32))
    data, u_data = np.transpose(x)[None], np.transpose(u)[None]
    panel = (data, aligned.values, ret.values)
    T = data.shape[2]
    say("bulk", f"fixture panel through data/market.py in {recipe_ms:.1f} ms:"
        f" {T} days, {aligned.values.shape[1]} assets, {len(seqs[0])} "
        "sequences of 100")

    gpu, cpu = bulk_stack(torch, "cuda"), bulk_stack(torch, "cpu")
    kw = dict(initial_capital=100000.0, tx_cost=0.001, slippage=0.0005)
    bt = {"cuda": Backtester(device="cuda", **kw),
          "cpu": Backtester(device="cpu", **kw)}
    worst = {}
    fused_encode.launches = 0
    fused_evidence.launches = 0
    fused_viterbi_states.launches = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bulk_")
    try:
        mse = {d: evaluate(QUALITY_CONFIG, QUALITY_CHECKPOINT, seqs,
                           output=os.path.join(tmp, d, "eval_results.txt"),
                           log_fn=None, device=d) for d in ("cuda", "cpu")}
        with open(os.path.join(tmp, "cuda", "eval_results.txt")) as f:
            written = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not np.isfinite(mse["cuda"]) or \
            written != f"Mean Recon MSE: {mse['cuda']}\n":
        fail(f"evaluate wrote {written!r} for an MSE of {mse['cuda']}")
    worst["evaluate MSE"] = _rel(mse["cuda"], mse["cpu"])
    if worst["evaluate MSE"] > 1e-5:
        fail(f"evaluate: MSE {mse['cuda']} on the card vs {mse['cpu']} on "
             "the CPU (> 1e-5 relative)")

    # Backtester.run with the head and with equal weights
    runs = 0                  # Backtester.run calls on the card that trade
    results = {}
    for name in ("model_fn", "equal_fn"):
        got, want = (bt[d].run(s[name], s["posterior_fn"], *panel,
                               rebalance_freq=5)
                     for d, s in (("cuda", gpu), ("cpu", cpu)))
        if len(got.equity_curve) != T or \
                not np.isfinite(got.equity_curve).all() or \
                not got.positions.any():
            fail(f"Backtester.run({name}): equity curve of "
                 f"{len(got.equity_curve)} steps, not finite or never "
                 "invested")
        worst[f"backtest {name}"] = _metrics_gap(got, want)
        results[name] = got
        runs += 1
    # walk-forward, no retraining
    wf = {d: WalkForwardBacktest(train_window=252, test_window=63,
                                 retrain_freq=126, backtester=bt[d]).run(
              s["model_fn"], s["posterior_fn"], lambda window: None, *panel)
          for d, s in (("cuda", gpu), ("cpu", cpu))}
    if len(wf["cuda"]) != len(wf["cpu"]) or not wf["cuda"]:
        fail(f"walk-forward windows: {len(wf['cuda'])} vs {len(wf['cpu'])}")
    worst["walk-forward"] = max(_metrics_gap(g, w)
                                for g, w in zip(wf["cuda"], wf["cpu"]))
    runs += len(wf["cuda"])       # each window trades from its warm-up
    # per-regime breakdown, three decodes.  The decoded panel is taken
    # from inside the closure RegimeBacktest.run calls, so that the window
    # of the launch counts holds the entry points' launches alone.
    counts, panel_decodes = {}, 0
    modes = [("argmax", {})] + [
        (name, dict(decode="viterbi", u=u_data)) for name in gpu["decoders"]]
    for name, extra in modes:
        regimes, per = {}, {}
        for d, s in (("cuda", gpu), ("cpu", cpu)):
            seen = []
            if name == "argmax":
                post = _recording(s["posterior_fn"], seen)
                call = dict(extra)
            else:
                post = s["posterior_fn"]
                call = dict(extra, decode_fn=_recording(s["decoders"][name],
                                                        seen))
            per[d] = RegimeBacktest(bt[d]).run(
                s["model_fn"], post, *panel, K=s["model"].cfg.K, **call)
            # the first result is the whole panel's
            if not seen or seen[0].shape[0] != 1 or seen[0].shape[-1] != T:
                fail(f"RegimeBacktest {name} on {d}: the run did not decode "
                     "the panel through the function it was given")
            if name == "argmax":
                regimes[d] = seen[0].argmax(dim=1)[0].cpu()
            else:
                if len(seen) != 1:
                    fail(f"RegimeBacktest {name} on {d}: decode_fn called "
                         f"{len(seen)} times")
                regimes[d] = seen[0][0].cpu()
        counts[name] = np.bincount(regimes["cuda"].numpy(),
                                   minlength=3).tolist()
        panel_decodes += name == "argmax"
        # a regime is backtested from 20 days on, and trades (one stack of
        # windows through posterior_fn) from 22 on
        runs += sum(1 for k in per["cuda"] if counts[name][k] > 21)
        if torch.equal(regimes["cuda"], regimes["cpu"]):
            if per["cuda"].keys() != per["cpu"].keys() or not per["cuda"]:
                fail(f"RegimeBacktest {name}: regimes {sorted(per['cuda'])} "
                     f"vs {sorted(per['cpu'])}")
            worst[f"regimes {name}"] = max(
                _metrics_gap(per["cuda"][k], per["cpu"][k])
                for k in per["cuda"])
        elif name == "argmax":
            fail(f"argmax regimes differ at "
                 f"{int((regimes['cuda'] != regimes['cpu']).sum())} steps")
        else:
            with torch.inference_mode():
                ev = fused_evidence(cpu["model"], torch.from_numpy(
                    data.astype(np.float32)), torch.from_numpy(
                    u_data.astype(np.float32)))
            gap, excess = _tie_gap(torch, ev, regimes["cuda"][None],
                                   regimes["cpu"][None], None)
            if excess > 1.0:
                fail(f"RegimeBacktest {name}: the card's path scores "
                     f"{gap:.3e} from the CPU's, {excess:.1f} times the "
                     "tolerance of a tie")
            say("bulk", f"regimes {name}: "
                f"{int((regimes['cuda'] != regimes['cpu']).sum())} steps "
                f"differ on a score tie ({gap:.3e} of score)")
    # the entry points are done: read the counts before anything else
    # touches a kernel
    launches = {"fused_encode": fused_encode.launches,
                "fused_evidence": fused_evidence.launches,
                "fused_decode": fused_viterbi_states.launches}
    expected = {"fused_encode": runs + panel_decodes, "fused_evidence": 1,
                "fused_decode": 1}
    if launches != expected:
        fail(f"the bulk path launched {launches}; its {runs} trading "
             f"Backtester.run calls, {panel_decodes} argmax decode of the "
             f"panel, one one-kernel decode and one two-stage decode imply "
             f"{expected}")
    for key, gap in worst.items():
        if key != "evaluate MSE" and gap > 1e-4:
            fail(f"{key}: a metric differs by {gap:.3e} relative from the "
                 "CPU's (> 1e-4)")

    # outside the counted window: the weight schedule against the CPU's,
    # and kernel 8 against its plain version on the schedule's own stack
    # of windows with the quality weights
    stacks = []

    def stack_posterior(x):
        stacks.append(x)
        return gpu["posterior_fn"](x)

    sched = {"cuda": bt["cuda"]._weight_schedule(
                 gpu["model_fn"], stack_posterior, data, T, 5),
             "cpu": bt["cpu"]._weight_schedule(
                 cpu["model_fn"], cpu["posterior_fn"], data, T, 5)}
    if not np.array_equal(sched["cuda"][0], sched["cpu"][0]):
        fail("the rebalance steps differ between the card and the CPU")
    worst["weights"] = float(np.abs(sched["cuda"][1] - sched["cpu"][1]).max())
    if worst["weights"] > 1e-5:
        fail(f"head weights differ by {worst['weights']:.3e} > 1e-5")
    windows = len(sched["cuda"][0])
    with torch.inference_mode():
        xw = stacks[0]
        err = max_abs(fused_encode(gpu["model"], xw, use_kernel=True),
                      fused_encode(gpu["model"], xw, use_kernel=False))
    if tuple(xw.shape) != (windows, gpu["model"].cfg.input_dim, 20) or \
            not xw.is_cuda:
        fail(f"the backtest's stack of windows is {tuple(xw.shape)} on "
             f"{xw.device}")
    worst["kernel 8 against plain on the stack"] = err
    if err > 1e-5:
        fail(f"kernel 8 logits on the backtest's {tuple(xw.shape)} stack "
             f"with the quality weights: max-abs error {err:.3e} > 1e-5")
    m = results["model_fn"].metrics
    say("bulk", f"evaluate MSE {mse['cuda']:.6g}; Backtester.run over "
        f"{windows} windows: total return {m['total_return']:.4f}, Sharpe "
        f"{m['sharpe_ratio']:.4f} (equal weight "
        f"{results['equal_fn'].metrics['sharpe_ratio']:.4f}); "
        f"{len(wf['cuda'])} walk-forward windows; regime counts {counts}")
    say("bulk", "card against CPU, largest difference: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; kernel launches {launches}")
    return launches, dict(panel=panel, data=data, u_data=u_data, gpu=gpu,
                          bt=bt["cuda"], windows=windows)


def _wall(torch, fn, repeats=5):
    """Host-clock ms of fn() ending in a synchronise: median, min, max."""
    out = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    out = out[1:]                                        # the first warms up
    return statistics.median(out), min(out), max(out)


def _device_ms(torch, fn, calls=10):
    """Device-busy ms a call of fn(), from a torch.profiler trace of the
    card alone: the union of its kernels' intervals over `calls` calls.
    Unlike a back-to-back event time, it does not contain the host's
    launch rate.  A trace that comes back without device events is taken
    again, twice; then the time is None and printed as not measured (the
    CUDA-event time beside it stands)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = _busy_us((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False))
        if busy > 0.0:
            return busy / 1e3 / calls
        say("times", f"a profiler trace of {calls} calls held no device "
            f"event (attempt {attempt + 1} of 3)")
    return None


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f} ms"


def phase_bulk_times(torch, np, model, bulk):
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    rng = np.random.default_rng(16)
    res = {}
    with torch.inference_mode():
        for B, T in ((64, 200), (460, 20), (1, 2327)):
            x, u, _ = decode_inputs(torch, np, rng, model, B, T, False,
                                    False)
            slow = 2 if T > 1000 else 10
            for use in (False, True):
                for name, fn, iters in (
                        ("fused_encode", lambda: fused_encode(
                            model, x, use_kernel=use), 50),
                        ("fused_evidence", lambda: fused_evidence(
                            model, x, u, use_kernel=use), 50),
                        ("fused_decode", lambda: fused_viterbi_states(
                            model, x, u, use_kernel=use),
                         20 if use else slow)):
                    res[(name, B, T, use)] = _time(torch, fn, iters=iters) \
                        + (_device_ms(torch, fn, 10 if use else 3),)
            fn = lambda: model.viterbi_decode(x, u)          # noqa: E731
            res[("two_stage", B, T, True)] = _time(torch, fn, iters=20) \
                + (_device_ms(torch, fn),)
    for (name, B, T, use), (med, lo, hi, dev_ms) in res.items():
        say("times", f"{name} {'kernel' if use else 'plain '} B={B} T={T}: "
            f"{med:.4f} ms [{lo:.4f}, {hi:.4f}] back to back; device busy "
            f"{_ms(dev_ms)} a call (profiler)")

    # one Backtester.run on the card, and its parts
    gpu, bt, panel = bulk["gpu"], bulk["bt"], bulk["panel"]
    run = _wall(torch, lambda: bt.run(gpu["model_fn"], gpu["posterior_fn"],
                                      *panel, rebalance_freq=5))
    parts = {"posterior_fn": [], "model_fn": []}

    def timed(name):
        def fn(a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gpu[name](a)
            torch.cuda.synchronize()
            parts[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return fn

    sched = _wall(torch, lambda: bt._weight_schedule(
        timed("model_fn"), timed("posterior_fn"), bulk["data"],
        bulk["data"].shape[2], 5))
    post = statistics.median(parts["posterior_fn"][1:])
    head = statistics.median(parts["model_fn"][1:])
    say("times", f"Backtester.run on the card ({bulk['windows']} windows of "
        f"20, {bulk['data'].shape[2]} days): {run[0]:.2f} ms [{run[1]:.2f}, "
        f"{run[2]:.2f}] of wall; the weight schedule {sched[0]:.2f} ms "
        f"(posterior_fn {post:.3f} ms, model_fn {head:.3f} ms, stacking, "
        f"upload and download the rest); the float64 ledger loop and the "
        f"metrics {run[0] - sched[0]:.2f} ms (by difference)")
    # one whole-panel decode three ways, host clock
    xd, ud = bt._tensor(bulk["data"]), bt._tensor(bulk["u_data"])
    m = gpu["model"]
    with torch.inference_mode():
        panel_ms = {
            "kernel 10": _wall(torch, lambda: fused_viterbi_states(m, xd, ud)),
            "kernel 11 + kernel B": _wall(torch,
                                          lambda: m.viterbi_decode(xd, ud)),
            "plain": _wall(torch, lambda: fused_viterbi_states(
                m, xd, ud, use_kernel=False), repeats=3)}
    say("times", f"whole-panel decode (B=1, T={xd.shape[2]}), wall ms: "
        + ", ".join(f"{k} {v[0]:.3f} [{v[1]:.3f}, {v[2]:.3f}]"
                    for k, v in panel_ms.items()))
    res["backtest_run_ms"] = run
    return res


def gather_library_ms(torch, np):
    """One advanced-indexing call over the two pools joined along the
    channels, for the same triples as the gather's timing (it does not
    zero the steps past each length)."""
    from vqvaehmm_tpu_torch.ops.gather import build_pools

    rng = np.random.default_rng(9)
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    pool = torch.cat([torch.from_numpy(a) for a in build_pools(xs, us)],
                     dim=1).cuda()
    si, st, _ = (torch.from_numpy(a).cuda().long()
                 for a in gather_case(np, rng, lens, 64, 200, 20))
    ch = torch.arange(pool.shape[1], device="cuda")
    pos = (st[:, None] + torch.arange(200, device="cuda")[None, :]).clamp(
        max=pool.shape[2] - 1)
    return _time(torch, lambda: pool[si[:, None, None], ch[None, :, None],
                                     pos[:, None, :]])[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script "
              "drives the CUDA port and needs a GPU", flush=True)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "vqvaehmm_tpu_torch")) or \
            not all(os.path.exists(f) for f in (
                CHECKPOINT, QUALITY_CHECKPOINT, HEAD_CHECKPOINT, FIXTURE)):
        print("FAIL: run chip_smoke.py from a checkout of the repository "
              "(vqvaehmm_tpu_torch/, the checkpoints and the fixture panel)",
              flush=True)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build
    from vqvaehmm_tpu_torch.ops import _build

    lib = _build.library()
    say("build", f"{', '.join(os.path.relpath(s, ROOT) for s in _build.sources())} "
        f"-> {os.path.relpath(lib._name, ROOT)} in {_build.build_seconds:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())

    dev = torch.device("cuda")
    model = load_published(torch, dev)
    # 3, 4: kernels against their plain versions
    with torch.inference_mode():
        err_a = phase_kernel_a(torch, np, model)
        err_b = phase_kernel_b(torch, np, dev)
    # 5. serving
    launches = phase_serve(torch, np)
    # 6. times
    times = phase_times(torch, np, model)
    # 7, 8: the training kernels against their plain versions
    err_c = phase_kernel_c(torch, np, load_published(torch, dev))
    err_d = phase_kernel_d(torch, np, dev)
    # 9. training
    train_launches, goodput = phase_train(torch, np)
    # 10. times
    ttimes = phase_train_times(torch, np, model)
    say("times", f"training goodput (TrainPipeline, published configuration,"
        f" epochs 2-4): {goodput:.1f} seqs/s")
    # 11. where a training step's time goes
    phase_train_profile(torch, np)
    # 12-14: the bulk-scoring kernels against their plain versions
    with torch.inference_mode():
        err_8 = phase_kernel_8(torch, np, model)
        err_11 = phase_kernel_11(torch, np, model)
        err_10 = phase_kernel_10(torch, np, model)
    # 15. bulk scoring
    bulk_launches, bulk = phase_bulk(torch, np)
    # 16. times
    btimes = phase_bulk_times(torch, np, model, bulk)
    bounds = kernel_bounds(model, 64, 200)

    kernels = [
        {"name": "fused_infer", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_infer.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_infer.py:45",
         "launches": launches["fused_infer"], "max_abs_err": err_a,
         "ms": times[("fused_infer", 64, True)][0],
         "plain_ms": times[("fused_infer", 64, False)][0],
         "bound_ms": bounds["fused_infer"][0],
         "bound_by": bounds["fused_infer"][1], "library_ms": None,
         "shape": "B=64 T=200"},
        {"name": "viterbi", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/viterbi.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_hmm.py:103",
         "also_replaces": ["vqvaehmm_tpu/ops/pallas_hmm.py:274",
                           "vqvaehmm_tpu/ops/pallas_hmm.py:333"],
         "launches": launches["viterbi"], "max_abs_err": err_b,
         "ms": times[("viterbi", 64, True)][0],
         "plain_ms": times[("viterbi", 64, False)][0],
         "bound_ms": bounds["viterbi"][0],
         "bound_by": bounds["viterbi"][1], "library_ms": None,
         "shape": "B=64 T=200"},
        {"name": "fused_train", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_train.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_train.py:82",
         "launches": train_launches["fused_train"], "max_abs_err": err_c,
         "ms": ttimes[("fused_train", 64, 200, True)][0],
         "plain_ms": ttimes[("fused_train", 64, 200, False)][0],
         "bound_ms": bounds["fused_train"][0],
         "bound_by": bounds["fused_train"][1], "library_ms": None,
         "shape": "B=64 T=200",
         "probe_ms": ttimes[("fused_train", 256, 512, True)][0],
         "probe_plain_ms": ttimes[("fused_train", 256, 512, False)][0]},
        {"name": "gather", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/gather.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_gather.py:140",
         "also_replaces": ["vqvaehmm_tpu/ops/pallas_gather.py:150"],
         "launches": train_launches["gather"], "max_abs_err": err_d,
         "ms": ttimes[("gather", 64, 200, True)][0],
         "plain_ms": ttimes[("gather", 64, 200, False)][0],
         "bound_ms": bounds["gather"][0],
         "bound_by": bounds["gather"][1],
         "library_ms": gather_library_ms(torch, np),
         "shape": "B=64 T=200"},
    ]
    for name, source, line, err in (
            ("fused_encode", "fused_encoder.cu", "pallas_encoder.py:32",
             err_8),
            ("fused_evidence", "fused_decode.cu", "pallas_decode.py:225",
             err_11),
            ("fused_decode", "fused_decode.cu", "pallas_decode.py:104",
             err_10)):
        entry = {"name": name, "route": "cuda",
                 "source": f"vqvaehmm_tpu_torch/csrc/{source}",
                 "replaces": f"vqvaehmm_tpu/ops/{line}",
                 "launches": bulk_launches[name], "max_abs_err": err,
                 "ms": btimes[(name, 64, 200, True)][0],
                 "plain_ms": btimes[(name, 64, 200, False)][0],
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": None, "shape": "B=64 T=200"}
        entry["device_ms"] = btimes[(name, 64, 200, True)][3]
        entry["plain_device_ms"] = btimes[(name, 64, 200, False)][3]
        for B, T in ((460, 20), (1, 2327)):
            entry[f"ms_{B}x{T}"] = btimes[(name, B, T, True)][0]
            entry[f"plain_ms_{B}x{T}"] = btimes[(name, B, T, False)][0]
            entry[f"device_ms_{B}x{T}"] = btimes[(name, B, T, True)][3]
            entry[f"bound_ms_{B}x{T}"] = kernel_bounds(model, B, T)[name][0]
        if name in launches:
            entry["serve_launches"] = launches[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
