"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (discogan_modernized_torch).
The cell's pieces are found by name (portbench/harness.py). With --trace 0
the result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics. It needs as many CUDA cards as the cell asks for, and
prints no result without them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"
# Every compiler and kernel cache of the process inside the checkout, at
# fixed paths, set before torch is imported.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("USE_FLAX", "0")
os.environ["OMP_NUM_THREADS"] = "1"  # one process, one compute thread: steady load
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    started = harness.process_start_time() or time.time()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload, ROOT)

    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = harness.driver(spec).run(spec, args.seed, args.seconds, bool(args.trace),
                                      torch.device("cuda", 0), started)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
