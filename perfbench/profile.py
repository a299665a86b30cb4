"""The traced stretch of a `--trace 1` run: a few steps or frames under
torch.profiler (CUPTI), reduced to what the per-layer readers take.

- `window_s`: the stretch, from the start to the end of its
  "perfbench.window" span (the loop and its closing synchronize);
- `busy_s`: the union of the device operations' intervals (kernels,
  copies, fills) inside it; the idle share is 1 - busy / window;
- `device_ms[name]`: each device operation's summed time, by its name;
- `gaps`: the device's idle intervals, each named by the harness span and
  the innermost host operation that was running when it began.
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "perfbench.window"


@dataclass
class Stretch:
    window_s: float
    busy_s: float
    items: int
    device_ms: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)

    def ms_matching(self, symbols) -> float:
        """Summed device ms of the operations whose name holds one of
        `symbols` (kernel function names)."""
        return sum(ms for name, ms in self.device_ms.items()
                   if any(_holds(name, s) for s in symbols))

    def ms_not_matching(self, symbols) -> float:
        return sum(ms for name, ms in self.device_ms.items()
                   if not any(_holds(name, s) for s in symbols))


def _holds(name: str, symbol: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])",
                     name) is not None


def short_name(name: str) -> str:
    """A device operation's name without its template arguments and
    parameter list."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:64]


def capture(loop, items: int, device) -> Stretch:
    """Run loop() (which runs `items` steps or frames, each in a
    record_function span of the harness) under the profiler, inside the
    window span, and reduce what it recorded."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # the profiler warns that it clears its events between cycles; it
        # runs one cycle here
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                loop()
                if cuda:
                    torch.cuda.synchronize(device)
        events = prof.profiler.kineto_results.events()
    return reduce(events, items)


def reduce(events, items: int) -> Stretch:
    """The Stretch of a list of kineto events (name(), device_type(),
    start_ns(), duration_ns()), the host's and the device's."""
    host, dev, window = [], [], None
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW_SPAN:
                window = (start, start + dur)
            host.append((start, start + dur, name))
        elif dur > 0 and not _annotation(e):
            dev.append((start, start + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    dev.sort()
    device_ms = {}
    for a, b, n in dev:
        device_ms[n] = device_ms.get(n, 0.0) + (b - a) / 1e6
    busy, gaps, cur = 0, [], w0
    for a, b, _n in dev:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    named = list(zip(_names_at(host, [a for a, _b in gaps]),
                     [(b - a) / 1e9 for a, b in gaps]))
    named.sort(key=lambda g: -g[1])
    return Stretch(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, items=items,
                   device_ms=device_ms, gaps=named)


def _annotation(event) -> bool:
    """A device-side copy of a host span (record_function), not work."""
    marked = getattr(event, "is_user_annotation", None)
    return (marked is not None and marked()) or \
        event.name().startswith("perfbench.")


def _names_at(host, times) -> list:
    """For each of the ascending `times`, the harness span and the
    innermost host operation running then (the latest-started of each
    kind), by one sweep over the host events."""
    import heapq

    host = sorted(host)
    names, i = [], 0
    active = {True: [], False: []}       # harness spans / other operations
    for t in times:
        while i < len(host) and host[i][0] <= t:
            a, b, n = host[i]
            heapq.heappush(active[n.startswith("perfbench.")], (-a, b, n))
            i += 1
        parts = []
        for kind in (True, False):
            heap = active[kind]
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            # an event that ended under a later-started one is popped when
            # it surfaces; the top is the latest-started still running
            if heap:
                parts.append(heap[0][2])
        names.append(" > ".join(parts) if parts else "host idle")
    return names


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each [name, seconds per step or frame] (operations merged by their
    short name; gaps summed by name)."""
    ops, gaps = {}, {}
    for name, ms in stretch.device_ms.items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + ms / 1e3 / stretch.items
    for name, s in stretch.gaps:
        gaps[name] = gaps.get(name, 0.0) + s / stretch.items
    return dict(
        device_ops=[[k, v] for k, v in sorted(ops.items(),
                                              key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                             key=lambda kv: -kv[1])[:top]])
