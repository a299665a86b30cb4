"""The training step's counted operations (work.step_flops) over its time
in the window at the card's FP32 peak (%)."""

from perfbench import work


def read(run):
    return run.mfu_pct(work.step_flops(run.counts, run.items_checked,
                                       run.gaussians()))
