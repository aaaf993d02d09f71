"""The benchmark's one command:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the CUDA devices the
cell asks for. It prints one JSON line, the run's result, last on standard
output, and the numbers the check compared, each beside its limit, last
on standard error. It exits non-zero, printing no result, without the
card, when the program is missing, or when JAX was loaded.
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from benchmark import harness

    t_start = harness.process_start()
    try:
        return harness.main(args, ROOT, t_start)
    except harness.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 5


if __name__ == "__main__":
    sys.exit(main())
