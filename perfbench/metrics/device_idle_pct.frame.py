"""The device's idle share of the traced stretch of frames (%): 1 - busy /
window, busy the union of every device operation's interval."""


def read(run):
    return run.idle_pct()
