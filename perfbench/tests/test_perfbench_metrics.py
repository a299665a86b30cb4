"""The metric arithmetic: the idle share from a synthetic timeline, the
mean over a window with a stall, the 95th percentile over every frame, and
the counted work on a tiny shape."""

from __future__ import annotations


import pytest
import torch

from perfbench import drivers, profile, registry, work
from perfbench.run import RunView

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start_us, dur_us):
        self._n, self._d, self._s, self._u = name, dev, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._u * 1000)


def timeline():
    """A 100 us window: kernels at 10-30 (overlapped by 20-40), 50-60 and
    90-120 (clipped at 100); the host in a step span with a sync inside."""
    return [
        Ev(profile.WINDOW_SPAN, CPU, 0, 100),
        Ev("perfbench.step", CPU, 0, 95),
        Ev("cudaStreamSynchronize", CPU, 60, 30),
        Ev("void trace_slots_kernel<32>(HitsParams)", CUDA, 10, 20),
        Ev("void at::native::elementwise_kernel<128>(int)", CUDA, 20, 20),
        Ev("Memcpy DtoD (Device -> Device)", CUDA, 50, 10),
        Ev("void trace_slots_kernel<32>(HitsParams)", CUDA, 90, 30),
        # the device-side copy of a harness span is no work
        Ev("perfbench.step", CUDA, 0, 95),
    ]


def test_idle_share_from_a_synthetic_timeline():
    s = profile.reduce(timeline(), items=2)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [10, 40) + [50, 60) + [90, 100) = 50 us
    assert s.busy_s == pytest.approx(50e-6)
    gaps = dict((round(g * 1e6), n) for n, g in s.gaps)
    assert set(gaps) == {10, 30}
    assert gaps[30] == "perfbench.step > cudaStreamSynchronize"
    assert gaps[10] == "perfbench.step"
    assert s.ms_matching(["trace_slots_kernel"]) == pytest.approx(0.030)
    assert s.ms_not_matching(["trace_slots_kernel"]) == pytest.approx(0.030)
    b = profile.breakdown(s)
    assert b["device_ops"][0] == ["trace_slots_kernel", pytest.approx(15e-6)]
    assert len(b["idle_gaps"]) <= 10


def run_view(seconds, items, item_s=(), stretch=None, counts=None):
    win = drivers.Window(seconds=seconds, attempted=items,
                         item_s=list(item_s), stretch=stretch)
    config = dict(scene=dict(init_num_pts=3, init_num_pts_farfield=1),
                  width=2, height=2, num_bounces=2)
    return RunView(config=config, win=win, counts=counts or {},
                   items_checked=2,
                   symbols={"trace_slots_kernel": "trace_slots"})


def test_mean_over_a_window_with_a_stall():
    # 9 frames of 0.1 s and one stalled 2 s one: the mean is the window's
    # time over the frames, the stall included
    lat = [0.1] * 9 + [2.0]
    v = run_view(seconds=sum(lat), items=10, item_s=lat)
    assert registry.reader("frame_ms")(v) == pytest.approx(290.0)


def test_p95_over_every_frame():
    lat = [i / 1000 for i in range(1, 201)]       # 1..200 ms
    v = run_view(seconds=sum(lat), items=200, item_s=lat)
    assert registry.reader("frame_p95_ms")(v) == pytest.approx(190.0)
    assert drivers.percentile([5.0], 95.0) == 5.0


def test_counted_work_on_a_tiny_shape():
    counts = {"trace_slots": dict(valid_pairs=600, kept_hits=300)}
    flops, nbytes = work.walk_work("trace_slots", counts, items=3,
                                   gaussians=4, rays_per_item=4, passes=3)
    # a step: 200 valid pairs, 100 kept hits, 12 rays over its passes
    assert flops == 34 * 200 + 22 * 100
    assert nbytes == 4 * (6 * 12 + 21 * 4 * 3 + 3 * 100 + 12)
    assert work.walk_work("render_culled", counts, 3, 4, 4, 3) is None
    frame = work.walk_work("render_culled",
                           {"render_culled": dict(valid_pairs=20,
                                                  kept_hits=10)},
                           items=1, gaussians=4, rays_per_item=4, passes=3)
    assert frame[1] == 4 * (6 * 12 + 21 * 12 + 13 * 12)
    assert work.bound_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    step = work.step_flops(counts, items=3, gaussians=4)
    assert step == 34 * 200 + (22 + 42) * 100 + 10 * 21 * 4


def test_readers_say_nothing_without_a_trace_or_counts():
    v = run_view(seconds=1.0, items=1)
    assert v.kernel_ms("trace_slots") is None
    assert v.idle_pct() is None
    assert v.roofline_pct("trace_slots") is None
    assert registry.reader("frame_mfu")(v) is None
    assert registry.reader("train_step_mfu")(v) is None


def test_roofline_and_idle_from_a_stretch():
    s = profile.reduce(timeline(), items=2)
    counts = {"render_culled": dict(valid_pairs=10, kept_hits=4)}
    v = run_view(seconds=1.0, items=1, stretch=s, counts=counts)
    assert v.idle_pct() == pytest.approx(50.0)
    assert v.kernel_ms("trace_slots") == pytest.approx(0.015)
    assert v.kernel_ms("render_culled") is None
    assert v.plain_ms() == pytest.approx(0.015)
