"""The readings the limits of the comparison are set from (card only):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control 7,8,9] [--faults half,unchanged,altered] [--seconds 2]

For each seed, one run of the cell with a short window (the program against
the reference); with --control, the control in the program's place (the
reference in bfloat16); with --faults, each named fault planted in the
program (controls.faulty).  The kept frames are drawn among the
window's first frames (the kind's short(): check_within = check_frames), so a slow stand-in
renders no more than it is compared on.  One JSON line a run:
{"what", "seed", "checks": {name: value}, "correct"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import controls, program, registry, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    run.set_caches()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = registry.workload(registry.benchmark(), args.workload)
    traffic = registry.traffic(cell["traffic"])
    short = registry.kind(traffic["kind"]).short(traffic)

    def one(what, seed, P, seconds):
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, seconds, False, t0, dev,
                           program=P, traffic_changes=short)
        line = dict(what=what, seed=seed, correct=res["correct"],
                    checks={k: v["value"] for k, v in res["checks"].items()},
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for s in seeds:
        one("program", s, program.load(), args.seconds)
    for s in (int(s) for s in args.control.split(",") if s):
        one("control", s, controls.reference_program(low=True), 0.0)
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for name in (f for f in args.faults.split(",") if f):
        for s in fault_seeds:
            one(f"fault:{name}", s, controls.faulty(program.load(), name),
                0.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
