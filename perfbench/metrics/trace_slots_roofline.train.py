"""trace_slots' counted bound (work.walk_work) over its device time a
training step (%)."""


def read(run):
    return run.roofline_pct("trace_slots")
