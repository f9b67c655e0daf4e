"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device, with
--trace 1 a breakdown, and last the checks) and, as the last lines of
standard error, each number the check compared beside its limit. Exits
non-zero, printing no result, without a CUDA card, without the program, or
when a module of the JAX side is loaded."""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# torch's NVRTC kernel cache at a fixed path inside the checkout, so that a
# second run there finds every kernel built
KERNEL_CACHE = ROOT / ".bench_cache" / "torch_kernels"
KERNEL_CACHE.mkdir(parents=True, exist_ok=True)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(KERNEL_CACHE)
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
