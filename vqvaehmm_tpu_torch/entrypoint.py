"""The deployment's MODE switch for the port: the counterpart of the
repository's entrypoint.sh, onto vqvaehmm_tpu_torch's modules, on the card.

    MODE=serve python -m vqvaehmm_tpu_torch.entrypoint
    MODE=train python -m vqvaehmm_tpu_torch.entrypoint training.num_epochs=2

It reads the variables entrypoint.sh reads: MODE (default serve),
TRAIN_CONFIG, VQHMM_INFERENCE_CONFIG, PORT and WORKERS, and replaces
itself (os.execvp) with:

  train       python -m vqvaehmm_tpu_torch.train.pipeline <TRAIN_CONFIG>
              [overrides] --device cuda
  serve       python -m vqvaehmm_tpu_torch.serve.httpd --config
              <VQHMM_INFERENCE_CONFIG> --port <PORT> --device cuda
  serve-prod  gunicorn -k uvicorn.workers.UvicornWorker -w <WORKERS> -b
              0.0.0.0:<PORT> 'vqvaehmm_tpu_torch.serve.app:create_app()'
  serve-asgi  uvicorn --host 0.0.0.0 --port <PORT> --factory
              vqvaehmm_tpu_torch.serve.asgi:create_asgi_app

The port has no module-level app (a model is not built when a module is
imported), so the two ASGI servers call its factories, which read
VQHMM_INFERENCE_CONFIG themselves.  The arguments after the module's name
go to the end of the command (before train's --device): the training
CLI's `section.key=value` overrides, or a server's own flags.  An unknown
MODE exits 1 with entrypoint.sh's message.
"""

from __future__ import annotations

import os
import sys
from typing import List, Mapping, Sequence

MODES = ("train", "serve", "serve-prod", "serve-asgi")


def command(mode: str, env: Mapping[str, str], extra: Sequence[str] = (),
            python: str = "python") -> List[str]:
    """The argv MODE `mode` runs under the variables `env`, with `extra`
    appended; ValueError for an unknown mode."""
    port = env.get("PORT", "8000")
    if mode == "train":
        return [python, "-m", "vqvaehmm_tpu_torch.train.pipeline",
                env.get("TRAIN_CONFIG", "configs/train_config.json"),
                *extra, "--device", "cuda"]
    if mode == "serve":
        return [python, "-m", "vqvaehmm_tpu_torch.serve.httpd", "--config",
                env.get("VQHMM_INFERENCE_CONFIG", "inference_config.json"),
                "--port", port, "--device", "cuda", *extra]
    if mode == "serve-prod":
        return ["gunicorn", "-k", "uvicorn.workers.UvicornWorker",
                "-w", env.get("WORKERS", "4"), "-b", f"0.0.0.0:{port}",
                "vqvaehmm_tpu_torch.serve.app:create_app()", *extra]
    if mode == "serve-asgi":
        return ["uvicorn", "--host", "0.0.0.0", "--port", port, "--factory",
                "vqvaehmm_tpu_torch.serve.asgi:create_asgi_app", *extra]
    raise ValueError(f"unknown MODE={mode} ({'|'.join(MODES)})")


def main(argv=None) -> int:
    mode = os.environ.get("MODE", "serve")
    try:
        argv = command(mode, os.environ,
                       sys.argv[1:] if argv is None else argv,
                       python=sys.executable)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    sys.stdout.flush()
    os.execvp(argv[0], argv)
    return 0            # not reached: execvp replaces the process


if __name__ == "__main__":
    sys.exit(main())
