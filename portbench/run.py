"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Needs as many
CUDA devices as the cell asks for; prints the result as the last line of
standard output (one JSON object) and each number the comparison held
against its limit on standard error.  See ``pb_cell.py``.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = HERE.parent
    src = root / "src"
    if not (src / "repro_torch").is_dir() or not (root / "BENCHMARK.json"
                                                  ).is_file():
        print("portbench: not a checkout of the program (no src/repro_torch "
              "or BENCHMARK.json here)", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(HERE))
    import pb_cell
    return pb_cell.run(args, T_PROC0)


if __name__ == "__main__":
    sys.exit(main())
