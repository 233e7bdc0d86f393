#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with as many CUDA cards as the
cell asks for. Caches of compiled kernels go to fixed directories inside
the checkout."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".port_bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
