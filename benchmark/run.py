"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the system under test
(casualhdrsplat_torch) beside this folder.  Needs CUDA devices: without
them it exits with an error and prints no result.  Every cache of the
program lies inside the checkout (the port's kernels build into
casualhdrsplat_torch/_build/; toolkit and compiler caches into
.bench_cache/).
"""

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the wall clock (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


if __name__ == "__main__":
    START = _process_start()
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], START))
