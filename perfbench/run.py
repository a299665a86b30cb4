"""One run of one cell: `python3 -m perfbench --workload <cell> --seed <n>
--seconds <s> --trace 0|1`.

Set-up (inputs from the seed, the kernels built or loaded, the warm-up or
the checked first steps), the measured window, with --trace 1 a traced
stretch after it, then, with the program's state freed, the reference's
comparison.  The last line of standard output is the result (JSON); the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.  Without a CUDA device, or with
fewer devices than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from . import work

ROOT = Path(__file__).resolve().parent.parent
# the CUDA driver's cache of compiled kernels stays in the checkout, at a
# fixed path (the program builds its own kernels under build/kernels)
CACHES = dict(CUDA_CACHE_PATH="build/perfbench/cuda")
# the JAX stack and the JAX package, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "editable_gaussian_reflections_tpu")


def set_caches(root: Path = ROOT) -> None:
    for var, rel in CACHES.items():
        os.environ[var] = str(root / rel)


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench", description=__doc__
                                 .split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device, program=None, root: Path = ROOT,
             traffic_changes: dict | None = None) -> dict:
    """One run of cell `name` on `device`: the result's dict.  `program`
    replaces the program's entry points (perfbench.program.load()), and
    `traffic_changes` some of the traffic mix's parameters (calibrate.py's
    short windows)."""
    import torch

    from . import check, program as prog, registry
    from .reference.ops.plain.render_kernel import WalkOptions

    bench = registry.benchmark(root)
    cell = registry.workload(bench, name)
    config = registry.config(bench, cell["config"], root)
    traffic = dict(registry.traffic(cell["traffic"]), **(traffic_changes or {}))
    kind = registry.kind(traffic["kind"])
    P = program or prog.load()
    if torch.device(device).type == "cuda":
        P.build_all(prog.kernel_sources(P.csrc))
    driver = kind.Driver(P, config, traffic, seed, device)
    win, kept = driver.run(seconds, trace, t_start)
    opts = WalkOptions()
    t_ref = time.perf_counter()
    numbers = kind.compare(driver, kept, opts)
    print(f"perfbench: set-up {win.setup_s:.1f} s, window {win.seconds:.1f} s"
          f" ({win.attempted} items), reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    ok, shown = check.judge(numbers, config["limits"][traffic["kind"]])
    ok = ok and win.failed == 0 and win.attempted > 0

    run = RunView(config=config, win=win, counts=opts.counts,
                  items_checked=driver.checked_items,
                  symbols=prog.kernel_symbols(P.csrc))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_for(bench, name, section):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    result = dict(correct=bool(ok), attempted=win.attempted,
                  failed=win.failed, metrics=metrics,
                  device=device_info(device, win, trace))
    if trace and win.stretch is not None:
        from .profile import breakdown

        result["breakdown"] = breakdown(win.stretch)
    result["checks"] = shown
    return result


class RunView:
    """What a metric reader reads: the window, the traced stretch, the
    reference's counts over the `items_checked` steps or frames it
    recomputed, and the cell's shapes."""

    def __init__(self, config, win, counts, items_checked, symbols):
        self.config, self.win = config, win
        self.counts, self.items_checked = counts, items_checked
        self.symbols = symbols

    # -- the window -----------------------------------------------------
    def mean_item_ms(self) -> float | None:
        """The window's time over the steps or frames it ran."""
        if self.win.attempted == 0:
            return None
        return self.win.seconds / self.win.attempted * 1e3

    def p95_item_ms(self) -> float | None:
        """The 95th percentile of every waited-for item's own latency."""
        from .drivers import percentile

        if not self.win.item_s:
            return None
        return percentile(self.win.item_s, 95.0) * 1e3

    # -- the traced stretch ---------------------------------------------
    @property
    def stretch(self):
        return self.win.stretch

    def kernel_ms(self, source: str) -> float | None:
        """Device ms a step or frame of the program's kernels built from
        csrc/<source>.cu; None where the stretch ran none."""
        if self.stretch is None:
            return None
        syms = [s for s, src in self.symbols.items() if src == source]
        ms = self.stretch.ms_matching(syms)
        return ms / self.stretch.items if ms > 0 else None

    def plain_ms(self) -> float | None:
        """Device ms a step or frame of every operation that is not one of
        the program's hand-written kernels (PyTorch's own kernels, copies
        and fills)."""
        if self.stretch is None:
            return None
        return self.stretch.ms_not_matching(list(self.symbols)) / \
            self.stretch.items

    def idle_pct(self) -> float | None:
        if self.stretch is None or self.stretch.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.stretch.busy_s / self.stretch.window_s)

    # -- counted work ---------------------------------------------------
    def gaussians(self) -> int:
        sc = self.config["scene"]
        return sc["init_num_pts"] + sc["init_num_pts_farfield"]

    def rays(self) -> int:
        return self.config["width"] * self.config["height"]

    def roofline_pct(self, source: str) -> float | None:
        """Kernel `source`'s counted bound over its device time, in %."""
        ms = self.kernel_ms(source)
        w = work.walk_work(source, self.counts, self.items_checked,
                           self.gaussians(), self.rays(),
                           self.config["num_bounces"] + 1)
        if ms is None or w is None:
            return None
        return 100.0 * work.bound_seconds(*w) / (ms / 1e3)

    def mfu_pct(self, flops: float | None) -> float | None:
        """`flops` a step or frame over its time in the window at the
        card's FP32 peak, in %."""
        ms = self.mean_item_ms()
        if ms is None or flops is None:
            return None
        return 100.0 * flops / (ms / 1e3) / work.PEAK_FLOPS_FP32


def device_info(device, win, trace: bool) -> dict:
    import torch

    dev = torch.device(device)
    info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
                count=1, memory_peak_bytes=win.memory_peak_bytes)
    if trace and win.stretch is not None:
        info.update(busy_s=win.stretch.busy_s, window_s=win.stretch.window_s)
    return info


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    set_caches()
    import torch

    from . import registry

    torch.set_num_threads(1)

    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few are available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
