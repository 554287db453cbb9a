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
   CPU optimum where two paths tie).  Both kernels' launch counters are
   reset before this phase and must be non-zero after it.
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

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def load_published(torch, device):
    from vqvaehmm_tpu_torch.core.config import load_config
    from vqvaehmm_tpu_torch.data.checkpoint import (load_params_npz,
                                                    params_from_numpy)
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    model = VAEHMM(load_config(CONFIG).model, device=device)
    model.load_state_dict(params_from_numpy(load_params_npz(CHECKPOINT)))
    return model.eval()


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
                    "viterbi": viterbi_fused.launches}
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
            not os.path.exists(CHECKPOINT):
        print("FAIL: run chip_smoke.py from a checkout of the repository "
              "(vqvaehmm_tpu_torch/ and the published checkpoint)",
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

    kernels = [
        {"name": "fused_infer", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_infer.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_infer.py:45",
         "launches": launches["fused_infer"], "max_abs_err": err_a,
         "ms": times[("fused_infer", 64, True)][0],
         "plain_ms": times[("fused_infer", 64, False)][0],
         "shape": "B=64 T=200"},
        {"name": "viterbi", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/viterbi.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_hmm.py:103",
         "also_replaces": ["vqvaehmm_tpu/ops/pallas_hmm.py:274",
                           "vqvaehmm_tpu/ops/pallas_hmm.py:333"],
         "launches": launches["viterbi"], "max_abs_err": err_b,
         "ms": times[("viterbi", 64, True)][0],
         "plain_ms": times[("viterbi", 64, False)][0],
         "shape": "B=64 T=200"},
        {"name": "fused_train", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_train.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_train.py:82",
         "launches": train_launches["fused_train"], "max_abs_err": err_c,
         "ms": ttimes[("fused_train", 64, 200, True)][0],
         "plain_ms": ttimes[("fused_train", 64, 200, False)][0],
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
         "shape": "B=64 T=200"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
