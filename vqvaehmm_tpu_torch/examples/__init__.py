"""The JAX package's examples/ on the port, one module each, run as

    python -m vqvaehmm_tpu_torch.examples.<name> [--device cuda|cpu]

(default cuda; --device cpu runs the kernels' plain versions).  Each
prints what its JAX counterpart under examples/ prints and exposes
`main(argv=None)` and `run(device, ...)`, which returns the numbers it
prints.  `calibration_example` is numpy only and needs pandas, as the JAX
one does."""

import argparse


def parser(name: str, what: str) -> argparse.ArgumentParser:
    """The examples' one flag: --device (default cuda)."""
    ap = argparse.ArgumentParser(
        prog=f"python -m vqvaehmm_tpu_torch.examples.{name}",
        description=what)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap
