"""Run one cell of the benchmark once on this machine's CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic, loop, limits and metrics are files
found by name (harness.py). The last line of standard output is the
result as one JSON object; the numbers the check compared, each beside
its limit, are the last lines of standard error and the result's last
key. Without as many CUDA devices as the cell asks for, it exits 3 and
prints no result; it exits 4, with no result, when a module of JAX or of
the JAX package is loaded once the window has closed, checked then and
again just before the result is printed. The seconds the set-up spent
compiling kernels (a checkout's first run) are inside setup_s and also
reported apart, under the result's "build" key. Build and kernel caches
stay inside the checkout (the program's own under orion_tpu_torch/_build/,
others under .portbench_cache/).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import harness
    import torch

    cell = harness.Cell(args.workload, ROOT)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), root=ROOT,
                                  t_start=T_START)
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        print(f"[portbench] card after the run: {card}", file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired):
        pass
    try:
        harness.assert_no_forbidden("before the result was printed")
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    b = result["build"]
    print(f"[portbench] compiled in this run's set-up: {b['seconds']:.3f} s "
          f"({', '.join(b['compiled']) or 'nothing: every kernel cached'})",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
