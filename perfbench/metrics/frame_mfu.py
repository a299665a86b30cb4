"""A frame's counted operations (work.frame_flops) over its time in the
window at the card's FP32 peak (%)."""

from perfbench import work


def read(run):
    return run.mfu_pct(work.frame_flops(run.counts, run.items_checked))
