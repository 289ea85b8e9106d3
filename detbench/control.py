"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed, the program's numbers (a short window at the
cell's load, its detections of the sampled batches against the reference
at the configuration's precision) and, for the first ``--control`` seeds,
the control's (the reference one step below that precision, held against
the same reference). A training cell's readings are its set-up's first
steps, with no window:

    python3 detbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 --control 3
    python3 detbench/control.py --workload <cell> --seeds 1,2,3 --control 0 --fault half_batch

One JSON line per seed on standard output, also appended to ``--out``
where it is given. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, control: bool, device,
             fault: str = "") -> dict:
    import torch

    from detbench import harness
    from detbench.faults import FAULTS

    setup = harness.set_up(cell, seed, device)
    if cell.traffic["mode"] == "train":
        loop = harness.TrainLoop(setup)
        if fault:
            loop.step = FAULTS[fault](loop.step)
        first = loop.first_steps(cell.traffic["check_steps"])
        del loop
        setup.model = None
        gc.collect()
        torch.cuda.empty_cache()
        detail = {"losses": first["losses"]}
        out = {"seed": seed, "fault": fault, "detail": detail}
        if control:
            out["program"], out["control"] = harness.check_train(
                setup, cell, first, control=True, detail=detail)
        else:
            out["program"] = harness.check_train(setup, cell, first,
                                                 detail=detail)
        return out
    keep = harness.check_sample(cell, seed)
    loop = harness.InferLoop(setup, cell.traffic["in_flight"], keep)
    if fault:
        loop.step = FAULTS[fault](loop.step)
    for _ in range(len(setup.pool)):
        loop.call()
    loop.drain()
    records = loop.run(seconds)
    outputs = loop.keep
    del loop
    setup.model = None
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed, "fault": fault, "batches": len(records)}
    if control:
        out["program"], out["control"] = harness.check_infer(
            setup, cell, seed, outputs, control=True)
    else:
        out["program"] = harness.check_infer(setup, cell, seed, outputs)
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", default="", help="a fault of detbench/faults.py "
                   "planted in the program")
    p.add_argument("--out", default="", help="a file to append the lines to")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from detbench import harness

    cell = harness.Bench(ROOT).cell(args.workload)
    device = harness.require_chips(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        start = time.perf_counter()
        line = readings(cell, seed, args.seconds, i < args.control, device,
                        args.fault)
        line["seconds"] = time.perf_counter() - start
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
