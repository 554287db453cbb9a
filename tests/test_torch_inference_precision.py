"""The default-precision mode of the inference kernels A, 8, 11 and 10 on
the CPU: a float32 model whose matmul_precision is not "highest" runs
them with both operands of every product rounded to bfloat16 and float32
sums on a CUDA tensor (ops/fused_train.py::infer_bf16_mode), as the JAX
package's Pallas kernels run single bfloat16 passes at `highest=False`.

* On the CPU nothing changes: at "highest", "float32" and "default" the
  port's wrappers and InferenceModel equal JAX's kernels in interpret
  mode and JAX's InferenceModel, both float32 there (1e-4; states
  exactly, or a tie by score).
* The mode's plain versions (the references with bf16_operands=True)
  against JAX's kernels at highest=False in interpret mode, float32 on the
  CPU: within the first-order error bound that rounding every product's
  two operands to bfloat16 puts on each output (`_Bound`), and not equal
  to them.
* The routing helper's table; the new weight packs emulated on the CPU
  against the order of the CUDA sources; the mode's plans and gates.

The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 36)."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_fused_train_mma import _emulate_layer
from tests.torch_port import SMALL, close, inputs, model_pair, t
from vqvaehmm_tpu.ops.pallas_decode import fused_evidence as jax_evidence
from vqvaehmm_tpu.ops.pallas_decode import \
    fused_viterbi_states as jax_states
from vqvaehmm_tpu.ops.pallas_encoder import fused_encode as jax_encode
from vqvaehmm_tpu.ops.pallas_infer import fused_forward as jax_forward
from vqvaehmm_tpu_torch import ModelConfig
from vqvaehmm_tpu_torch.ops import _build
from vqvaehmm_tpu_torch.ops import fused_decode as fd
from vqvaehmm_tpu_torch.ops import fused_encoder as fe
from vqvaehmm_tpu_torch.ops import fused_infer as fi
from vqvaehmm_tpu_torch.ops.fused_train import (infer_bf16_mode,
                                                pack_mma_reference)
from vqvaehmm_tpu_torch.ops.nn import bf16_round

PRECISIONS = ("highest", "float32", "default")
PUBLISHED = dict(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
                 trans_hidden=128)


def _case(B, T, seed):
    """(x, u, lengths) with max(lengths) < T and x zero past it (the JAX
    evidence kernel does not mask x itself)."""
    x, u, lengths = inputs(B, T, seed=seed)
    lengths = np.minimum(lengths, T - 3)
    x[:, :, T - 3:] = 0.0
    return x, u, lengths


def _score(log_pi, log_A, log_obs, states, lengths):
    """log p(z, x) of each path over its valid steps (float64)."""
    out = np.zeros(states.shape[0])
    for b, s in enumerate(states):
        out[b] = log_pi[s[0]] + log_obs[b, 0, s[0]]
        for k in range(1, int(lengths[b])):
            out[b] += log_A[b, k, s[k - 1], s[k]] + log_obs[b, k, s[k]]
    return out


def _same_or_tied(got, want, evidence, lengths, slack):
    """States equal on every valid step, or `got` scoring within `slack` of
    `want` under `evidence`."""
    same = all(np.array_equal(got[b, :L], want[b, :L])
               for b, L in enumerate(lengths))
    if not same:
        ev = [np.asarray(a, np.float64) for a in evidence]
        np.testing.assert_allclose(_score(*ev, got, lengths),
                                   _score(*ev, want, lengths), rtol=0,
                                   atol=slack)


# ---------------------------------------------------------------------------
# (a) on the CPU every precision computes in float32, as JAX's does
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_cpu_path_matches_jax_kernels_at_every_precision(precision):
    """Kernels A, 8, 11 and 10 through the port's wrappers on the CPU
    against JAX's Pallas kernels in interpret mode at the same
    matmul_precision (highest=False for "float32" and "default"): within
    1e-4, the states equal or tied by score."""
    jm, params, tm = model_pair(seed=41, matmul_precision=precision)
    assert not infer_bf16_mode(tm.cfg, "cpu")
    B, T = 3, 24
    x, u, lengths = _case(B, T, seed=42)
    jx, ju, jl = (jnp.asarray(a) for a in (x, u, lengths))
    with torch.no_grad():
        got_a = fi.fused_forward(tm, t(x), valid_to=t(lengths))
        got_8 = fe.fused_encode(tm, t(x), valid_to=t(lengths))
        got_11 = fd.fused_evidence(tm, t(x), t(u), t(lengths))
        got_10 = fd.fused_viterbi_states(tm, t(x), t(u), t(lengths))
        # the float32 plain versions, bit for bit
        for g, w in zip(got_a, fi.fused_forward_reference(
                tm, t(x), valid_to=t(lengths))):
            assert torch.equal(g, w)
    for g, w, name in zip(got_a, jax_forward(jm, params, jx, valid_to=jl,
                                             interpret=True),
                          ("mu", "logvar", "q")):
        close(g, w, 1e-4, f"A {name}")
    close(got_8, jax_encode(params, jx, valid_to=jl, interpret=True,
                            highest=precision == "highest"), 1e-4, "8")
    want_11 = jax_evidence(jm, params, jx, ju, jl, interpret=True)
    for g, w, name in zip(got_11, want_11, ("log_pi", "log_A", "log_obs")):
        close(g, w, 1e-4, f"11 {name}")
    want_10 = np.asarray(jax_states(jm, params, jx, ju, jl, interpret=True))
    _same_or_tied(got_10.numpy(), want_10, want_11, lengths, 1e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A checkpoint of SMALL and a serving config of it at each precision."""
    import json

    import jax

    from vqvaehmm_tpu import make_model
    from vqvaehmm_tpu.data.checkpoint import save_params_npz

    tmp = tmp_path_factory.mktemp("precision")
    save_params_npz(str(tmp / "model.npz"),
                    make_model(**SMALL).init(jax.random.PRNGKey(5)))
    paths = {}
    for precision in PRECISIONS:
        path = tmp / f"{precision}.json"
        path.write_text(json.dumps({
            "model": {**SMALL, "matmul_precision": precision},
            "checkpoint_path": str(tmp / "model.npz")}))
        paths[precision] = str(path)
    return paths


@pytest.mark.parametrize("precision", PRECISIONS)
def test_infer_modes_match_jax_at_every_precision(served, precision):
    """The port's InferenceModel (what /infer answers with) on the CPU at
    each precision against JAX's InferenceModel on the same files: every
    mode within 1e-4, the Viterbi states equal."""
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    port = InferenceModel(served[precision], device="cpu")
    ref = JaxModel(served[precision])
    assert port.model.cfg.matmul_precision == precision
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 37)).tolist()
    u = rng.normal(size=(4, 37)).tolist()
    for mode in ("mean_field", "smoothed", "filtered", "viterbi"):
        got = port.infer(x, u=u, mode=mode)
        want = ref.infer(x, u=u, mode=mode)
        assert set(got) == set(want)
        for key in ("mu", "logvar", "regime_probs"):
            close(got[key], want[key], 1e-4, f"{mode} {key}")
        if mode == "viterbi":
            assert got["states"] == want["states"]


# ---------------------------------------------------------------------------
# (b) the mode's plain versions against JAX's kernels at highest=False
# ---------------------------------------------------------------------------

# the error of a product of two operands each rounded to the nearest
# bfloat16 (unit roundoff u = 2^-8): (1 + u)^2 - 1, and a float32 sum's own
# roundings over a few hundred terms on top (2^-16)
RHO = 2 * 2.0 ** -8 + 2.0 ** -16 + 2.0 ** -16


class _Bound:
    """First-order bounds, per output value, on how far the
    bfloat16-operand arithmetic can move the float32 model's outputs: a
    layer y = W h + b whose input carries an error e_h moves by at most
    RHO |W| |h| + (1 + RHO) |W| e_h; a ReLU or a mask does not widen it; a
    softmax moves a probability by at most half the largest move of its
    logits, a log-softmax by at most twice it.  |h| are the float32
    model's own activations."""

    def __init__(self, model, x, valid_to=None):
        self.m = model
        T = x.shape[-1]
        self.mask = torch.ones(1, 1, T) if valid_to is None else (
            torch.arange(T)[None, :] < torch.as_tensor(valid_to).reshape(
                -1, 1)).float()[:, None, :]
        self.x = x * self.mask

    @staticmethod
    def layer(mod, h, e):
        w = mod.weight.detach().abs()
        if w.dim() == 2:                       # a Linear on (..., in)
            return RHO * h.abs() @ w.t() + (1 + RHO) * e @ w.t()
        pad = w.shape[-1] // 2
        return (RHO * F.conv1d(h.abs(), w, padding=pad)
                + (1 + RHO) * F.conv1d(e, w, padding=pad))

    def encoder(self):
        """(logits bound, logits) of the encoder."""
        enc, m = self.m.encoder, self.mask
        h1 = torch.relu(enc.conv1(self.x)) * m
        e1 = self.layer(enc.conv1, self.x, torch.zeros_like(self.x)) * m
        h2 = torch.relu(enc.conv2(h1))
        e2 = self.layer(enc.conv2, h1, e1)
        return self.layer(enc.to_logits, h2, e2), enc.to_logits(h2)

    def forward(self):
        """Bounds of (mu, logvar, q) of the serving forward."""
        dec, m = self.m.decoder, self.mask
        e_l, logits = self.encoder()
        q = torch.softmax(logits, dim=1)
        e_q = 0.5 * e_l.amax(dim=1, keepdim=True).expand_as(q)
        E = dec.embeddings.weight.detach()
        e = torch.einsum("bkt,kd->bdt", q, E) * m
        e_e = (RHO * torch.einsum("bkt,kd->bdt", q, E.abs())
               + (1 + RHO) * torch.einsum("bkt,kd->bdt", e_q, E.abs())) * m
        hd1 = torch.relu(dec.conv1(e)) * m
        e_d1 = self.layer(dec.conv1, e, e_e) * m
        hd2 = torch.relu(dec.conv2(hd1))
        e_d2 = self.layer(dec.conv2, hd1, e_d1)
        out = self.layer(dec.to_params, hd2, e_d2)
        C = out.shape[1] // 2
        return out[:, :C], out[:, C:], e_q

    def evidence(self, u):
        """Bounds of (log_A (B, T, K, K), log_obs (B, T, K))."""
        net, K = self.m.prior_module.transition_net, self.m.cfg.K
        ut = u.transpose(1, 2)
        hp = torch.relu(net[0](ut))
        e_hp = self.layer(net[0], ut, torch.zeros_like(ut))
        e_ap = self.layer(net[2], hp, e_hp)
        B, T = e_ap.shape[:2]
        e_A = 2 * e_ap.reshape(B, T, K, K).amax(dim=-1, keepdim=True)
        e_l, _ = self.encoder()
        e_obs = 2 * e_l.amax(dim=1, keepdim=True).transpose(1, 2)
        return e_A.expand(B, T, K, K), e_obs.expand(B, T, K)


def _within(got, want, bound, what):
    err = (got.double() - torch.from_numpy(np.array(want)).double()).abs()
    assert float(err.max()) > 0, f"{what}: the mode changed nothing"
    assert bool((err <= bound.double()).all()), (
        f"{what}: {float((err - bound).max()):.3e} past the bound")
    return float((err / bound.double().clamp_min(1e-30)).max())


@pytest.mark.parametrize("widths,B,T", [(SMALL, 3, 24),
                                        (PUBLISHED, 2, 40)])
def test_bf16_plain_versions_within_rounding_bound_of_jax(widths, B, T):
    """Each plain version of the mode (bf16_operands=True) against JAX's
    kernel at highest=False in interpret mode (float32 on the CPU): every
    output within its _Bound, every output moved, and the decode equal or
    tied within the evidence bounds summed over the path.  The largest
    share of its bound an output's error takes: 0.17-0.47 at hidden 8/4,
    0.02-0.15 at the published widths, on the CPU."""
    jm, params, tm = model_pair(seed=43, **{**widths,
                                            "matmul_precision": "default"})
    x, u, lengths = _case(B, T, seed=44)
    jx, ju, jl = (jnp.asarray(a) for a in (x, u, lengths))
    tx, tu, tl = t(x), t(u), t(lengths)
    with torch.no_grad():
        a = fi.fused_forward_reference(tm, tx, valid_to=tl,
                                       bf16_operands=True)
        lg = fe.fused_encode_reference(tm, tx, valid_to=tl,
                                       bf16_operands=True)
        ev = fd.fused_evidence_reference(tm, tx, tu, tl, bf16_operands=True)
        st = fd.fused_viterbi_states_reference(tm, tx, tu, tl,
                                               bf16_operands=True)
        bound = _Bound(tm, tx, tl)
        b_a = bound.forward()
        b_lg, _ = bound.encoder()
        b_ev = _Bound(tm, tx, tl.max()).evidence(tu)
    shares = [_within(g, w, b, f"A {n}") for g, w, b, n in zip(
        a, jax_forward(jm, params, jx, valid_to=jl, interpret=True), b_a,
        ("mu", "logvar", "q"))]
    shares.append(_within(lg, jax_encode(params, jx, valid_to=jl,
                                         interpret=True, highest=False),
                          b_lg, "8"))
    want_ev = jax_evidence(jm, params, jx, ju, jl, interpret=True)
    close(ev[0], want_ev[0], 1e-6, "log_pi: used in no product")
    shares += [_within(g, w, b, f"11 {n}") for g, w, b, n in zip(
        ev[1:], want_ev[1:], b_ev, ("log_A", "log_obs"))]
    assert max(shares) < 1.0
    # a path optimal under one evidence scores within the two evidences'
    # gap, twice over and summed over the steps, of the other's optimum
    slack = 2 * float(b_ev[0].amax(dim=(2, 3)).sum(1).max()
                      + b_ev[1].amax(dim=2).sum(1).max())
    want_st = np.asarray(jax_states(jm, params, jx, ju, jl, interpret=True))
    _same_or_tied(st.numpy(), want_st, want_ev, lengths, slack)


# ---------------------------------------------------------------------------
# (c) the routing helper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0",
                                    torch.device("cuda", 1)])
def test_infer_bf16_mode_table(dtype, precision, device):
    """The mode exactly where JAX's kernels run single bfloat16 passes
    (`matmul_precision != "highest"`, "float32" included) and the port's
    route takes a kernel: a float32 model on a CUDA device.  A bfloat16
    model keeps its plain path, and the CPU float32 arithmetic."""
    cfg = ModelConfig(**SMALL, compute_dtype=dtype,
                      matmul_precision=precision)
    want = (dtype == "float32" and precision != "highest"
            and torch.device(device).type == "cuda")
    assert infer_bf16_mode(cfg, device) is want


def test_cpu_wrappers_keep_float32_at_default_precision():
    """On a CPU tensor a default-precision model's wrappers (use_kernel
    None or False) compute the float32 plain versions bit for bit, which
    are not the mode's; use_kernel=True raises, and nothing counts."""
    _, _, tm = model_pair(seed=45, matmul_precision="default")
    x, u, lengths = (t(a) for a in _case(2, 24, seed=46))
    counts = [(f.launches, f.bf16_launches) for f in (
        fi.fused_forward, fe.fused_encode, fd.fused_evidence,
        fd.fused_viterbi_states)]
    with torch.no_grad():
        for use in (None, False):
            for g, w, w16 in zip(
                    fi.fused_forward(tm, x, valid_to=lengths,
                                     use_kernel=use),
                    fi.fused_forward_reference(tm, x, valid_to=lengths),
                    fi.fused_forward_reference(tm, x, valid_to=lengths,
                                               bf16_operands=True)):
                assert torch.equal(g, w) and not torch.equal(g, w16)
            assert torch.equal(
                fe.fused_encode(tm, x, valid_to=lengths, use_kernel=use),
                fe.fused_encode_reference(tm, x, valid_to=lengths))
            for g, w in zip(fd.fused_evidence(tm, x, u, lengths,
                                              use_kernel=use),
                            fd.fused_evidence_reference(tm, x, u, lengths)):
                assert torch.equal(g, w)
        for fn in (fd.fused_evidence, fd.fused_viterbi_states):
            with pytest.raises(ValueError, match="CUDA"):
                fn(tm, x, u, lengths, use_kernel=True)
    assert counts == [(f.launches, f.bf16_launches) for f in (
        fi.fused_forward, fe.fused_encode, fd.fused_evidence,
        fd.fused_viterbi_states)]


# ---------------------------------------------------------------------------
# (d) the new packs against the order of the CUDA sources
# ---------------------------------------------------------------------------


def _packs(layers, tensors):
    """The plain pack of each layer (tile_mma.cuh's fragment order) and
    where it starts, laid end to end."""
    out, at = [], 0
    for (O, I, taps, *trans), w in zip(layers, tensors):
        packed = pack_mma_reference(w, taps, trans=bool(trans and trans[0]))
        assert packed.numel() == -(-O // 16) * 16 * taps * -(-I // 16) * 16
        out.append((at, packed))
        at += packed.numel()
    return out, at


def test_new_packs_follow_the_cuda_source():
    """Kernel A's bfloat16 pack (csrc/fused_infer.cu::packed_bf16, the jobs
    of vqhmm_fused_infer_pack) and kernels 8, 11 and 10's
    (csrc/encoder_mma.cuh::packed, pack_jobs): the layers in the source's
    order, the codebook as the transposed layer e = E^T q, each starting
    on a whole fragment; the wrappers' counts are the sums."""
    infer = (_build.CSRC / "fused_infer.cu").read_text()
    order = re.findall(r"p\.(\w+) = at; at \+= packed_elems\(([^)]*)\)",
                       infer)
    assert order == [("ew1", "H1, C, 3"), ("ew2", "H2, H1, 3"),
                     ("ew3", "K, H2, 1"), ("emb", "D, K, 1"),
                     ("dw1", "D, D, 3"), ("dw2", "D, D, 3"),
                     ("dw3", "2 * C, D, 1")]
    assert "{emb, D, K, 1, 1, at.emb}" in infer
    mma = (_build.CSRC / "encoder_mma.cuh").read_text()
    order = re.findall(r"p\.(\w+) = at; at \+= (?:d\.HP > 0 \? )?"
                       r"packed_elems\(([^)]*)\)", mma)
    assert order == [("w1", "d.H1, d.C, 3"), ("w2", "d.H2, d.H1, 3"),
                     ("w3", "d.K, d.H2, 1"), ("p1", "d.HP, d.U, 1"),
                     ("p2", "d.K * d.K, d.HP, 1")]
    _, _, tm = model_pair(seed=47, **PUBLISHED)
    C, H1, H2, K, D = 5, 64, 32, 3, 64
    enc, dec = tm.encoder, tm.decoder
    packs, total = _packs(fi.layers(C, H1, H2, K, D), [
        enc.conv1.weight, enc.conv2.weight, enc.to_logits.weight,
        dec.embeddings.weight, dec.conv1.weight, dec.conv2.weight,
        dec.to_params.weight])
    assert total == fi.packed_bf16(C, H1, H2, K, D)
    net = tm.prior_module.transition_net
    packs8, total8 = _packs(fe.layers(C, H1, H2, K, 4, 128), [
        enc.conv1.weight, enc.conv2.weight, enc.to_logits.weight,
        net[0].weight, net[2].weight])
    assert total8 == fe.packed_bf16(C, H1, H2, K, 4, 128)
    assert fe.packed_bf16(C, H1, H2, K) == packs8[3][0]
    for at, _ in packs + packs8:
        assert at % 256 == 0


def test_emulated_bf16_encoder_and_forward_from_the_packs():
    """The encoder and the serving forward rebuilt from their packed
    fragments and run in the kernels' order (chunks of 16, tap-major, a
    float32 sum a chunk; every operand rounded to bfloat16 where the
    kernels round it) give the mode's plain versions within 2^-8 of each
    output's largest magnitude: float32 sums in another order, and a
    bfloat16 operand that such a sum may round the other way (measured on
    the CPU: equal).  A layer out of the source's order, or a
    codebook packed untransposed, is off by the whole output."""
    _, _, tm = model_pair(seed=48, input_dim=5, hidden_dim=24, K=3,
                          hidden_dim2=20, u_dim=4, trans_hidden=12,
                          matmul_precision="default")
    C, H1, H2, K, D = 5, 24, 20, 3, 24
    x, _, lengths = _case(1, 40, seed=49)
    T, vt = x.shape[2], int(lengths[0])
    enc, dec = tm.encoder, tm.decoder
    ws = [enc.conv1.weight, enc.conv2.weight, enc.to_logits.weight,
          dec.embeddings.weight, dec.conv1.weight, dec.conv2.weight,
          dec.to_params.weight]
    bs = [enc.conv1.bias, enc.conv2.bias, enc.to_logits.bias, None,
          dec.conv1.bias, dec.conv2.bias, dec.to_params.bias]
    layers = fi.layers(C, H1, H2, K, D)
    packs, _ = _packs(layers, ws)
    mask = (torch.arange(T) < vt).float()

    def run(i, h, relu=False, masked=False):
        O, I, taps, _ = layers[i]
        y = _emulate_layer(packs[i][1], O, I, taps, h)
        if bs[i] is not None:
            y = y + bs[i].detach()[:, None]
        if relu:
            y = torch.relu(y)
        return y * mask if masked else y

    with torch.no_grad():
        h = run(0, t(x)[0] * mask, relu=True, masked=True)
        h = run(1, h, relu=True)
        logits = run(2, h)
        q = torch.softmax(logits, dim=0)
        e = run(3, q, masked=True)
        h = run(4, e, relu=True, masked=True)
        out = run(6, run(5, h, relu=True))
        want = fi.fused_forward_reference(tm, t(x), valid_to=vt,
                                          bf16_operands=True)
        want_lg = fe.fused_encode_reference(tm, t(x), valid_to=vt,
                                            bf16_operands=True)
    for got, ref in ((logits, want_lg[0]), (out[:C], want[0][0]),
                     (out[C:], want[1][0]), (q, want[2][0])):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=2 ** -8 * float(ref.abs().max()))
    assert torch.equal(bf16_round(packs[0][1]), packs[0][1])


# ---------------------------------------------------------------------------
# (e) the mode's plans and gates
# ---------------------------------------------------------------------------


def _st(n):
    return -(-n // 16) * 16 + 8


def _cfg(**kw):
    return ModelConfig(**{**PUBLISHED, "matmul_precision": "default", **kw})


@pytest.mark.parametrize("entry", [
    "vqhmm_fused_infer", "vqhmm_fused_infer_pack",
    "vqhmm_fused_infer_smem_bytes", "vqhmm_fused_infer_packed_floats",
    "vqhmm_encoder_pack", "vqhmm_encoder_packed_floats",
    "vqhmm_fused_encode", "vqhmm_fused_encode_smem_bytes",
    "vqhmm_fused_evidence", "vqhmm_fused_evidence_smem_bytes",
    "vqhmm_fused_decode", "vqhmm_fused_decode_plan"])
def test_mode_entries_take_bf16_as_the_sources_do(entry):
    """Each C entry of the four kernels takes its mode as an `int bf16`
    argument, one entry for both modes, and its ctypes signature
    (ops/_build.py) has as many arguments as the source's parameters, the
    mode's in the same place."""
    sigs = {**_build._SIGNATURES, **_build._SIZE_SIGNATURES}
    sources = "".join(p.read_text() for p in _build.sources())
    found = re.findall(rf'extern "C" (?:int|long long) {entry}\(([^)]*)\)',
                       sources)
    assert len(found) == 1
    params = [" ".join(p.split()) for p in found[0].split(",")]
    assert len(params) == len(sigs[entry])
    at = params.index("int bf16")
    assert sigs[entry][at] is _build._I
    assert not [n for n in sigs if n.startswith(entry) and "bf16" in n[
        len(entry):]]


def test_bf16_smem_follows_the_cuda_source():
    """The wrappers' shared-memory counts of the mode restate the CUDA
    sources' formulas: kernel A's operands (fused_infer.cu::
    bf16_operand_bytes) and encoder_mma.cuh::smem_bytes for kernels 8 and
    11 and the decode's stage region in front of its tiles; kernels A and
    11 then hold their weights where tile_mma.cuh::stage_plan puts them
    (resident at the published widths: the next item's raw inputs, the
    barriers, every packed value)."""
    infer = (_build.CSRC / "fused_infer.cu").read_text()
    assert ("return 2 * op_rows_bf16(tile) *\n             "
            "(tilemma::op_stride(C) +\n              "
            "2 * tilemma::op_stride(operand_bf16(H1, H2, K, D))) +\n"
            "         (int)sizeof(float) * row_stride(tile) * (K + 2 * C);"
            ) in infer
    assert "constexpr int MMA_THREADS = 256;" in infer
    assert f"constexpr int MMA_BLOCKS_PER_SM = {fi.MMA_BLOCKS_PER_SM};" \
        in infer
    assert "__launch_bounds__(MMA_THREADS, MMA_BLOCKS_PER_SM)\n    " \
        "fused_infer_bf16_kernel" in infer
    mma = (_build.CSRC / "encoder_mma.cuh").read_text()
    assert "return 2 * op_rows(tile) * (op_stride(d.C) + ru + 2 * " \
        "op_stride(widest(d))) +" in mma
    assert re.search(rf"constexpr int THREADS = {fe.MMA_THREADS};", mma)
    assert re.search(rf"constexpr int BLOCKS_PER_SM = "
                     rf"{fe.MMA_BLOCKS_PER_SM};", mma)
    for tile in fe.TILES:
        ops_a = 2 * (tile + 8) * (_st(5) + 2 * _st(64)) + 4 * (tile + 12) * 13
        assert fi.operand_bytes(tile, 5, 64, 32, 3, 64) == ops_a
        assert fi.smem_bytes(tile, 5, 64, 32, 3, 64, True) == \
            ops_a + 4 * 5 * (tile + 8) + fi.CTRL_BYTES + 2 * 36352
        assert fe.smem_bytes(_cfg(), tile, True) == \
            2 * (tile + 4) * (_st(5) + 2 * _st(64))
        ops_11 = 2 * (tile + 4) * (_st(5) + _st(4) + 2 * _st(128)) \
            + 4 * (tile + 8) * 12
        assert fd.evidence_stage_bytes(_cfg(), tile, True) == ops_11
        assert fd.evidence_smem_bytes(_cfg(), tile, True) == \
            ops_11 + fi.CTRL_BYTES + 2 * 13824
        stage = -(-ops_11 // 16) * 16
        assert fd.decode_smem_bytes(_cfg(), tile, 2, True) == stage + 4 * (
            2 * tile * 13 + 2048 + 32 * 12 + 68)
        # the second designs of 8 and 10: the next item's raw x window
        # (kernel 8), the barriers and every packed value (9728, 13824)
        assert fe.encode_stage(tile, fe.encoder_dims(_cfg())).bytes == \
            fe.smem_bytes(_cfg(), tile, True) + 4 * 5 * (tile + 4) \
            + fi.CTRL_BYTES + 2 * 9728
        assert fd.decode_smem_bytes(_cfg(), tile, 2, True, True) == \
            stage + fi.CTRL_BYTES + 2 * 13824 + 4 * (
                2 * tile * 13 + 2048 + 32 * 12 + 68)


@pytest.mark.parametrize("B,T,tile", [(64, 200, 64), (1, 200, 16),
                                      (460, 20, 64), (1, 2327, 16),
                                      (8, 512, 16), (1, 1, 16)])
def test_bf16_plans_at_the_published_widths(B, T, tile):
    """Kernel A's plan in the mode: the widest tile with a block for every
    SM; kernels 8 and 11's: 256 threads, at most 3 blocks an SM, the tile
    of the fewest waves x steps, as in float32."""
    plan = fi.launch_plan(B, T, 5, 64, 32, 3, 64, bf16=True)
    assert plan.tile == tile and plan.blocks == B * -(-T // tile)
    assert plan.smem == fi.smem_bytes(tile, 5, 64, 32, 3, 64, True)
    for p in (fe.encode_plan(_cfg(), B, T, bf16=True),
              fd.evidence_plan(_cfg(), B, T, bf16=True)):
        assert p.threads == fe.MMA_THREADS and p.per_sm <= 3
        assert p.smem <= fi.SMEM_LIMIT
    # the float32 mode's plans are their own
    assert fe.encode_plan(_cfg(), B, T).threads != fe.MMA_THREADS or \
        fe.encode_plan(_cfg(), B, T).smem != \
        fe.encode_plan(_cfg(), B, T, bf16=True).smem


def test_bf16_gates_at_their_edges():
    """The mode stages no weights, so layers past a float32 weight buffer
    are taken; its edge is a block's shared memory at the narrowest tile:
    kernel 8 takes hidden_dim2 up to 2880 (operand rows of 2888 values),
    kernel A hidden widths while 2 x 24 rows of x and two operands fit,
    kernels 11 and 10 a trans_hidden while the stage (and a tile) fits."""
    assert not fe.encode_supported(_cfg(hidden_dim2=2052), 1, 8)
    assert fe.encode_supported(_cfg(hidden_dim2=2052), 1, 8, bf16=True)
    assert fe.encode_supported(_cfg(hidden_dim2=2880), 1, 8, bf16=True)
    assert not fe.encode_supported(_cfg(hidden_dim2=2881), 1, 8, bf16=True)
    assert fe.smem_bytes(_cfg(hidden_dim2=2880), 16, True) <= fi.SMEM_LIMIT \
        < fe.smem_bytes(_cfg(hidden_dim2=2881), 16, True)
    # there its second design has no room for its weights: the first runs
    assert fe.encode_plan(_cfg(hidden_dim2=2880), 1, 8, bf16=True)[-2:] == \
        ("direct", 0)
    # kernel A: the widest operand at tile 16
    edge = max(h for h in range(16, 4000, 16)
               if fi.smem_bytes(16, 5, 8, h, 3, 8, True) <= fi.SMEM_LIMIT)
    assert fi.launch_plan(1, 8, 5, 8, edge, 3, 8, bf16=True).tile == 16
    with pytest.raises(ValueError, match="bfloat16"):
        fi.launch_plan(1, 8, 5, 8, edge + 1, 3, 8, bf16=True)
    with pytest.raises(ValueError, match="hidden widths"):
        fi.launch_plan(1, 8, 5, 8, 2052, 3, 8)
    assert fi.launch_plan(1, 8, 5, 8, 2052, 3, 8, bf16=True).tile == 16
    # kernels 11 and 10
    hp = max(h for h in range(16, 4000, 16)
             if fd.decode_smem_bytes(_cfg(trans_hidden=h), 16, 1, True)
             <= fi.SMEM_LIMIT)
    assert fd.supported(_cfg(trans_hidden=hp), 0, 0, bf16=True)
    assert not fd.supported(_cfg(trans_hidden=hp + 1), 0, 0, bf16=True)
    assert not fd.supported(_cfg(trans_hidden=6148), 0, 0)
    assert not fd.supported(_cfg(K=9), 0, 0, bf16=True)
    assert not fd.supported(dataclasses.replace(
        _cfg(), compute_dtype="bfloat16"), 0, 0, bf16=True)


def test_model_plain_route_takes_the_mode_only_where_asked():
    """VAEHMM.encode(fused=False), compute_loss and forward keep the
    model's own products at every precision; only the wrappers' plain
    route and the references take bf16_operands."""
    _, _, tm = model_pair(seed=50, matmul_precision="default")
    x, u, lengths = (t(a) for a in inputs(2, 24, seed=51))
    with torch.no_grad():
        logits = tm.encode(x, fused=False)
        assert torch.equal(logits, fe.fused_encode_reference(tm, x))
        assert not torch.equal(logits, fe.fused_encode_reference(
            tm, x, bf16_operands=True))
        (mu, _), q = tm(x)
        assert torch.equal(q, torch.softmax(logits, dim=1))
        assert torch.equal(mu, fi.fused_forward_reference(tm, x)[0])
        _, _, tm32 = model_pair(seed=50)
        assert torch.equal(tm.compute_loss(x, u, lengths),
                           tm32.compute_loss(x, u, lengths))


def test_card_bars_are_the_smoke_scripts():
    """tests/test_torch_cuda.py holds the mode against its plain version
    to the bars of chip_smoke.py's phase 36, one per output."""
    import chip_smoke

    from tests import test_torch_cuda as card

    assert card.BF16_INFER_TOL == chip_smoke.BF16_INFER_TOL
    assert set(card.BF16_INFER_TOL) == {"mu", "logvar", "q", "logits",
                                        "log_A", "log_obs"}
    assert (card.BF16_INFER_EXACT, card.BF16_INFER_SHARE) == (
        chip_smoke.BF16_INFER_EXACT, chip_smoke.BF16_INFER_SHARE)
