"""Run one cell of the port's benchmark and print its result's line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding BENCHMARK.json, portbench/ and the
program (`vqvaehmm_tpu_torch`).  It needs the CUDA devices the cell asks
for and exits with code 2 and no result without them.  The last line of
standard output is the result (JSON); the last lines of standard error
are the numbers compared, each beside its limit."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, is where modules are found
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))

from portbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
