"""One run of one benchmark cell of the PyTorch port on the card.

    python3 h100_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The last line of standard output is the
result (JSON); see ``README.md`` beside this file.
"""
import time

T_NOW = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux: its start
    tick against the uptime; elsewhere the moment this module ran)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return T_NOW - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_NOW


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))

from h100_bench.bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
