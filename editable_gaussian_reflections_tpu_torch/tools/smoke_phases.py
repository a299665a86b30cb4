"""Where a chip_smoke.py run spends its wall time, phase by phase.

    python -m editable_gaussian_reflections_tpu_torch.tools.smoke_phases \\
        run <checkout> [<checkout> ...] [--out chiprun_out/smoke_phases]
    python -m editable_gaussian_reflections_tpu_torch.tools.smoke_phases \\
        read <log> [<log> ...]

`run` runs `python3 -u chip_smoke.py` in each checkout in turn (say, an
unpacked `git archive` of the parent and one of the change, in one call on
one card, so that both see the same host) and writes each run's output to
<out>/<checkout's name>.log, every line stamped with the epoch second at
which it arrived, the first line the start.  `read` reads such logs.
Both print, for each log, the seconds of each phase (from the previous
phase's last line, or the start, to its own last line: phase 1's include
the kernels' build), all but the last phase together, and the total;
`run` exits with the first non-zero exit code of a smoke.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

START = "smoke_phases: start"
# "phase 5b: ..." is phase 5's
PHASE = re.compile(r"phase (\d+)")


def phase_seconds(lines) -> dict:
    """{phase: seconds, ..., "total": seconds} of a stamped log's lines
    ("<epoch> <text>", the first the start)."""
    stamped = [ln.split(" ", 1) for ln in lines if ln.strip()]
    if not stamped or not stamped[0][1].startswith(START):
        raise ValueError("a stamped log starts with its start line")
    t0 = prev = float(stamped[0][0])
    last = {}
    for ts, text in stamped[1:]:
        m = PHASE.match(text)
        if m:
            last[int(m.group(1))] = float(ts)
    out = {}
    for phase in sorted(last, key=lambda k: last[k]):
        out[phase] = last[phase] - prev
        prev = last[phase]
    out["total"] = float(stamped[-1][0]) - t0
    return out


def report(name: str, secs: dict) -> dict:
    phases = [k for k in secs if k != "total"]
    before_last = sum(secs[k] for k in phases[:-1])
    print(f"{name}: " + ", ".join(f"{k} {secs[k]:.1f}" for k in phases)
          + f"; all but the last phase {before_last:.1f} s, total "
          f"{secs['total']:.1f} s", flush=True)
    return dict(secs, before_last=before_last)


def run(checkout: Path, log: Path) -> int:
    with open(log, "w") as f:
        f.write(f"{time.time():.6f} {START} {checkout}\n")
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                                cwd=checkout, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            f.write(f"{time.time():.6f} {line}")
        return proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smoke_phases")
    ap.add_argument("mode", choices=("run", "read"))
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--out", default="chiprun_out/smoke_phases")
    args = ap.parse_args(argv)
    rc, res = 0, {}
    for path in map(Path, args.paths):
        log = path
        if args.mode == "run":
            Path(args.out).mkdir(parents=True, exist_ok=True)
            log = Path(args.out) / f"{path.resolve().name}.log"
            code = run(path, log)
            print(f"{path}: exit {code}", flush=True)
            rc = rc or code
        secs = phase_seconds(log.read_text().splitlines())
        res[str(path)] = report(str(path), secs)
    if args.mode == "run":
        (Path(args.out) / "phases.json").write_text(json.dumps(res, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
