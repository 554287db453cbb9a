"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, the harness's look for a chip skipped, the
rest of the run driven on the CPU.  (The cells run on one chip, so no
exchange between chips can be left out.)"""

import time

import pytest
import torch

from portbench.harness import core

TRAIN = ["f32.train-b1024", "bf16.train-b2048"]
SCORE = ["f32.score-books", "bf16.score-books"]


def _broken_train(monkeypatch, fault):
    from vqvaehmm_tpu_torch.data import device_sampler
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.train import trainer

    chunks = device_sampler.gather_epoch_chunks

    def first_batch(*a, **k):
        # every step of a chunk trains on the chunk's first batch
        for s0, x, u in chunks(*a, **k):
            yield s0, x[:1].expand_as(x), u[:1].expand_as(u)

    def stale_chunk(*a, **k):
        # every chunk's steps take their lengths from the first chunk's
        for _, x, u in chunks(*a, **k):
            yield 0, x, u

    if fault in ("first_batch", "stale_chunk"):
        if fault == "stale_chunk":
            # a chunk a batch, so that the epoch has more than one
            monkeypatch.setattr(gather, "EPOCH_CHUNK_BYTES", 1)
        monkeypatch.setattr(device_sampler, "gather_epoch_chunks",
                            {"first_batch": first_batch,
                             "stale_chunk": stale_chunk}[fault])
        return
    if fault == "unchanged":
        # a step that returns its state unchanged
        monkeypatch.setattr(trainer.ClippedAdam, "update", lambda self: None)
        return
    orig = trainer.fused_loss_and_grads

    def half(model, x, u, lengths, beta, *a, **k):
        h = x.shape[0] // 2
        return orig(model, x[:h], u[:h], lengths[:h], beta, *a, **k)

    def altered(model, x, u, lengths, beta, *a, **k):
        loss, grads = orig(model, x, u, lengths, beta, *a, **k)
        grads["encoder.conv1.weight"] = 2.0 * grads["encoder.conv1.weight"]
        return loss, grads

    monkeypatch.setattr(trainer, "fused_loss_and_grads",
                        {"half_batch": half, "altered": altered}[fault])


def _broken_score(monkeypatch, fault):
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    post, decode = VAEHMM.posterior, VAEHMM.viterbi_decode

    def half_post(self, x, *a, **k):
        q = post(self, x, *a, **k)
        q[x.shape[0] // 2:] = 0.0
        return q

    def half_decode(self, x, u, lengths=None, *a, **k):
        z = decode(self, x, u, lengths, *a, **k)
        z[x.shape[0] // 2:] = 0
        return z

    def altered_decode(self, x, u, lengths=None, *a, **k):
        z = decode(self, x, u, lengths, *a, **k)
        n = int(lengths[0]) // 2
        z[0, :n] = (z[0, :n] + 1) % self.cfg.K
        return z

    if fault == "half_batch":
        monkeypatch.setattr(VAEHMM, "posterior", half_post)
        monkeypatch.setattr(VAEHMM, "viterbi_decode", half_decode)
    else:
        monkeypatch.setattr(VAEHMM, "viterbi_decode", altered_decode)


# a scoring request keeps no state between requests, so it has no state
# to leave unchanged
CASES = [(c, f) for c in TRAIN for f in ("unchanged", "half_batch",
                                         "altered", "first_batch",
                                         "stale_chunk")] \
    + [(c, f) for c in SCORE for f in ("half_batch", "altered")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    (_broken_train if cell in TRAIN else _broken_score)(monkeypatch, fault)
    result = core.run(small, cell, 31337, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert result["correct"] is False
    over = [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]
    assert over, result["checks"]
