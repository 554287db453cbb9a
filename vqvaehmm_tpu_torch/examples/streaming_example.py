"""Streaming regime detection (the JAX package's
examples/streaming_example.py on the port): feed market frames one tick
at a time.

The online filter (models/online.py) does O(1) work a frame, its settled
posteriors equal the batch `filtered_posterior`, and `peek` gives a
provisional posterior of the newest tick.  On the card each step of the
filter is one launch of kernel 11 (the evidence kernel): a tick settles
one frame and peeks two, so T ticks and the end of the stream take
3T - 1 launches, and the batch check one more.

    python -m vqvaehmm_tpu_torch.examples.streaming_example [--device cpu]
"""

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.synthetic import synthetic_sequences
from ..models.online import OnlineFilter
from ..models.vae_hmm import make_model
from . import parser

HEADER = "tick  settled_t  p(regime)                    peek(newest)"


def run(device="cuda", init: Optional[dict] = None, log_fn=print) -> dict:
    """The example on `device` with the model's parameters init (a
    state_dict) or drawn from seed 0.  log_fn prints the stream's lines as
    they settle.  Returns the settled columns [(tick, t, q, peek)], the
    end of the stream [(t, q)], the batch filtered posterior's last column
    and whether the last settled column matches it."""
    log_fn = log_fn or (lambda *a: None)
    dev = resolve_device(device)
    model = make_model(5, 32, 3, 16, u_dim=4, trans_hidden=32, device=dev,
                       generator=torch.Generator().manual_seed(0)).eval()
    if init is not None:
        model.load_state_dict(init)

    xs, us, _ = synthetic_sequences(1, 60, seed=0)
    x, u = np.asarray(xs[0]), np.asarray(us[0])

    f = OnlineFilter(model)
    ticks, end = [], []
    log_fn(HEADER)
    for t in range(x.shape[1]):
        settled = f.update(x[:, t], u[:, t])
        peek = f.peek()
        for s, q in settled:
            ticks.append((t, s, q, peek))
            log_fn(f"{t:4d}  {s:9d}  {np.round(q, 3)}  "
                   f"{np.round(peek, 3)}")
    for s, q in f.finish():
        end.append((s, q))
        log_fn(f" end  {s:9d}  {np.round(q, 3)}")

    # the streamed columns equal the batch filtered posterior
    with torch.inference_mode():
        batch = model.filtered_posterior(
            torch.as_tensor(x[None], device=dev),
            torch.as_tensor(u[None], device=dev),
            torch.tensor([x.shape[1]], dtype=torch.int32, device=dev))
    last = batch[0, :, -1].cpu().numpy()
    return {"ticks": ticks, "end": end, "batch_last": last,
            "matches": bool(np.allclose(last, end[-1][1], atol=1e-5))}


def main(argv=None) -> int:
    args = parser("streaming_example", __doc__.splitlines()[0]).parse_args(
        argv)
    out = run(args.device)
    print("matches batch filtered_posterior:", out["matches"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
