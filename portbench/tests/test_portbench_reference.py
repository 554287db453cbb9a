"""The benchmark's reference against the port's plain CPU paths at a tiny
size (this test imports both; the reference imports nothing of the
port)."""

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.reference import hmm as ref_hmm
from portbench.reference import precision
from portbench.reference import train as ref_train
from portbench.reference import vaehmm as ref

MODEL = {"input_dim": 3, "u_dim": 2, "hidden_dim": 8, "hidden_dim2": 6,
         "K": 3, "trans_hidden": 10, "compute_dtype": "float32",
         "matmul_precision": "highest"}
D = ref.dims_of(MODEL)


def _port(weights):
    from vqvaehmm_tpu_torch.core.config import ModelConfig
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    m = VAEHMM(ModelConfig(**MODEL))
    m.load_state_dict(weights)
    return m


def _batch(seed=3, B=4, T=17):
    g = torch.Generator().manual_seed(seed)
    x, u = data.regime_panels(torch, B, T, D.C, D.U, D.K, g)
    lengths = torch.tensor([T, T - 5, 9, 4][:B])
    keep = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, None]
    return x * keep, u * keep, lengths


def test_layout_matches_the_port():
    w = data.make_weights(torch, D, 5, "cpu")
    port = _port(w)
    assert {n: tuple(p.shape) for n, p in port.state_dict().items()} == \
        {n: tuple(t.shape) for n, t in w.items()}


def test_loss_and_gradients_match_the_port():
    from vqvaehmm_tpu_torch.ops.fused_train import loss_and_grads

    w = data.make_weights(torch, D, 11, "cpu")
    x, u, lengths = _batch()
    loss, grads = ref.loss_and_grads(w, x, u, lengths, 0.3)
    p_loss, p_grads = loss_and_grads(_port(w), x, u, lengths, 0.3)
    assert loss == pytest.approx(float(p_loss), rel=1e-6)
    for n, g in grads.items():
        assert torch.allclose(g, p_grads[n], rtol=1e-5, atol=1e-7), n


def test_posterior_and_evidence_match_the_port():
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    w = data.make_weights(torch, D, 12, "cpu")
    x, u, lengths = _batch(seed=4)
    port = _port(w)
    with torch.no_grad():
        assert torch.allclose(ref.posterior(w, x), port.posterior(x),
                              atol=1e-6)
        mine = ref.evidence(w, x, u, lengths)
        theirs = fused_evidence(port, x, u, lengths, use_kernel=False)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b, atol=1e-5)


def test_viterbi_scores_match_the_port():
    from vqvaehmm_tpu_torch.ops.hmm import viterbi

    w = data.make_weights(torch, D, 13, "cpu")
    x, u, lengths = _batch(seed=5)
    with torch.no_grad():
        log_pi, log_A, log_obs = ref.evidence(w, x, u, lengths)
        port = viterbi(log_pi, log_A, log_obs, lengths)
        best = ref_hmm.best_score(log_pi, log_A, log_obs, lengths)
        mine = ref_hmm.best_path(log_pi, log_A, log_obs, lengths)
    assert torch.allclose(best, port.score.double(), atol=1e-4)
    for states in (port.states, mine):
        got = ref_hmm.path_score(log_pi, log_A, log_obs, states, lengths)
        assert torch.allclose(got, best, atol=1e-4)
    worse = port.states.clone()
    worse[0, : int(lengths[0]) // 2] = (worse[0, : int(lengths[0]) // 2]
                                        + 1) % D.K
    got = ref_hmm.path_score(log_pi, log_A, log_obs, worse, lengths)
    assert float(best[0] - got[0]) > 1e-3


def test_windows_match_the_port():
    from vqvaehmm_tpu_torch.ops.gather import gather_windows_reference

    g = torch.Generator().manual_seed(6)
    px, pu = data.regime_panels(torch, 5, 40, D.C, D.U, D.K, g)
    si, st, ln = (np.array(a, np.int32) for a in
                  ([0, 4, 2], [3, 0, 30], [20, 7, 10]))
    x, u, lens = ref_train.windows(px, pu, si, st, ln, 25)
    px2, pu2 = gather_windows_reference(px, pu, *(torch.from_numpy(a) for a
                                                  in (si, st, ln)), 25)
    assert torch.equal(x, px2) and torch.equal(u, pu2)
    assert lens.tolist() == [20, 7, 10]


def test_clipped_adam_matches_the_port():
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer

    w = data.make_weights(torch, D, 14, "cpu")
    port = _port(w)
    opt = make_optimizer(port, 1e-3, 1.0)
    mine = ref_train.Adam(w, 1e-3)
    params = dict(w)
    g = torch.Generator().manual_seed(15)
    for scale in (0.01, 3.0, 0.5):
        grads = {n: scale * torch.randn(t.shape, generator=g)
                 for n, t in w.items()}
        for n, p in port.named_parameters():
            p.grad = grads[n].clone()
        opt.update()
        params = mine.step(params, ref_train.clip_by_global_norm(grads, 1.0))
    for n, p in port.named_parameters():
        assert torch.allclose(p.detach(), params[n], rtol=1e-6, atol=1e-8), n


def test_roundings():
    one = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                        -(1.0 + 3 * 2 ** -11)])
    assert precision.tf32(one).tolist() == [1.0, 1.0 + 2 ** -9, 1.0,
                                            -(1.0 + 2 ** -9)]
    assert precision.bf16(torch.tensor([1.0 + 2 ** -9])).item() == 1.0
    t = torch.tensor([448.0, 1.0, 0.3])
    assert precision.fp8(t).tolist() == [448.0, 1.0, 0.3125]
    assert precision.exact(t) is t
