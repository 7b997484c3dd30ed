"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload x4_frames_fast --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout, on a machine with the cell's CUDA devices.
Without them it exits 2 and prints no result.  See `harness.py`.
"""

import time

T_PROC = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    # Kernel caches at fixed paths inside the checkout (the port builds
    # its own into rusty_sr_tpu_torch/_build/).
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    from portbench.harness import main
    sys.exit(main(t_proc=T_PROC))
