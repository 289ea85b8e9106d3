"""A copy of the benchmark whose traffic mixes are cut to sizes a CPU test
can hold (2 canvases of 128x160 per batch, pools of 3, 1-5 boxes per
image in training), for dry runs of
the harness with the look for a card skipped."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {"batch": 2, "canvas": [128, 160], "pool": 3, "check_batches": 1,
         "trace_seconds": 0.5}
BOXES = [1, 5]


def tiny_root(tmp: Path) -> Path:
    root = tmp / "bench"
    shutil.copytree(REPO / "detbench", root / "detbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "detbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(SMALL)
        if "boxes_per_image" in mix:
            mix["boxes_per_image"] = BOXES
        path.write_text(json.dumps(mix))
    return root


def dry_run(root: Path, workload: str, seed: int = 2 ** 31 + 7,
            seconds: float = 1.0, trace: int = 0):
    """``harness.main`` on the CPU in a fresh process -> (the last line of
    standard output as JSON, standard error)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from detbench import harness\n"
        f"harness.main(['--workload', {workload!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], "
        f"root={str(root)!r}, device='cpu')\n"
        "print('forbidden', json.dumps(harness.forbidden_modules()), "
        "file=sys.stderr)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr
