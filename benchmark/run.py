"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``ompi_release_tpu_torch``.
Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and
``breakdown`` with ``--trace 1``), then ``checks``: each number the
correctness check compared, with its limit. Needs an NVIDIA card: with
none, or fewer than the cell asks for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches stay at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
