"""Runs one benchmark cell once and prints its result as the last line of
standard output:

    python3 detbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, with no result, where the
card or the program is missing or the run fails.
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _main() -> int:
    sys.path.insert(0, str(ROOT))
    from detbench import harness

    try:
        harness.main(sys.argv[1:], start=START, root=ROOT)
    except harness.NoChip as err:
        print(f"detbench: {err}", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(_main())
