"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for. The last line of standard output is the result's JSON object; the
numbers that decide ``correct`` are the last lines of standard error. A run
that finds JAX or the JAX package loaded once its window has closed prints
no result and exits non-zero.
Every cache the run writes stays inside ``benchmark/.cache`` of the
checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# Fixed cache directories inside the checkout, so a second run finds what
# the first one built; the autotune cache path is never written, so the
# registry takes its first fit.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["SPUTNIK_TPU_TORCH_TUNE_CACHE"] = str(ROOT / "benchmark" / "no_tune_cache.json")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    torch.set_num_threads(2)
    chips = harness.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); "
                    f"torch.cuda.is_available()={torch.cuda.is_available()}")
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the run loaded {loaded}: JAX or the JAX package, which no run may use; no result")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
