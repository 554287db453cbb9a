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

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
