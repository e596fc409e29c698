"""Run one cell of BENCHMARK.json once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``compared``: each compared number beside its limit), and the
compared numbers as the last lines of standard error. Exits non-zero,
printing no result, without enough CUDA devices, or if JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, '.portbench_cache')
# Kernel build caches at fixed paths inside the checkout.
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['USE_FLAX'] = '0'
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == '__main__':
    from portbench.harness import runner
    sys.exit(runner.main(parse(), T_START))
