"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \
        [--control tf32|bf16|fp8] [--fault half_batch] [--seconds 1]

For each seed it makes the cell's set-up as a run does, runs a short
window where the cell compares what its window produced (the scoring
cells; a training cell compares its set-up's steps), and prints one JSON
line with the numbers compared.  Without options the program computes
(the lower readings); with --control the reference computes in that
rounding in the program's place (the upper readings); with --fault a
training cell's reference is given the planted fault.  The benchmark's
own runs never run this."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import argparse
    import json

    from portbench.harness import device as dev_mod
    from portbench.harness.core import Context
    from portbench.harness.manifest import Manifest

    p = argparse.ArgumentParser(prog="portbench/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    manifest = Manifest()
    dev_mod.use_checkout_caches(manifest.root)
    import torch

    device = torch.device(args.device)
    cell = manifest.workload(args.workload)
    traffic = manifest.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(torch, device, seed, cell,
                      manifest.config(cell["config"]), traffic,
                      manifest.cell(args.workload), args.control)
        loop = manifest.loop(traffic).Loop(ctx)
        if loop.CHECKS_WINDOW:
            loop.window(args.seconds)
        loop.drop_program()
        checks = loop.check(args.fault) if args.fault else loop.check()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del loop, ctx
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
