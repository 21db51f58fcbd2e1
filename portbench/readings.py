"""The readings a cell's correctness limit is set from, in one process.

    python3 portbench/readings.py --workload <name> --seconds <s> \\
        --seeds 11,12,... --control-seeds 21,22,23

Runs the cell (untraced, at its own size and load) once for each of
``--seeds`` and prints each run's ``gap``; then, for each of
``--control-seeds``, a run with the control in the program's place (the
reference computed in TF32, every matrix product on TF32-rounded operands,
answering the window's whole batches), judged by the same check. The lower
reading is the largest of the program's, the upper the smallest of the
control's. The last line of standard output is one JSON object of all of
them. Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness, registry
    if not torch.cuda.is_available():
        harness.log("readings need a CUDA card")
        return 2
    cell = registry.cell(args.workload, ROOT)
    out = {"workload": cell.name, "card": harness.card_limit(),
           "program": {}, "control": {}}
    ctl = harness.control(cell, torch.device("cuda"))
    ctl_mix = harness.control_overrides(cell.traffic)
    runs = [("program", int(s), None, None)
            for s in args.seeds.split(",") if s]
    runs += [("control", int(s), ctl, ctl_mix)
             for s in args.control_seeds.split(",") if s]
    for side, seed, fn, overrides in runs:
        t = time.perf_counter()
        r = harness.run(cell, seed, args.seconds, False, fn=fn,
                        overrides=overrides)
        g = r["checks"]["gap"]["value"]
        out[side][seed] = {"gap": g, "correct": r["correct"],
                           "failed": r["failed"],
                           "states": r["checked_states"],
                           "calls": r["attempted"],
                           "evals_per_s": r["metrics"]["evals_per_s"]
                           ["value"]}
        harness.log(f"{side} seed {seed}: gap {g!r} over "
                    f"{r['checked_states']} states of {r['attempted']} "
                    f"calls, correct {r['correct']} "
                    f"({time.perf_counter() - t:.1f} s)")
    gp = [v["gap"] for v in out["program"].values()]
    gc_ = [v["gap"] for v in out["control"].values()]
    out["lower"] = max(gp) if gp else None
    out["upper"] = min(gc_) if gc_ else None
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
