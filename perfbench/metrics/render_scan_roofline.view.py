"""render_scan's counted bound (work.walk_work) over its device time a
frame (%)."""


def read(run):
    return run.roofline_pct("render_scan")
