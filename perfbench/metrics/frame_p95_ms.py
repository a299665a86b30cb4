"""The 95th percentile (nearest rank) of every frame's own latency in the
window, from its dispatch to the end of its synchronize (ms)."""


def read(run):
    return run.p95_item_ms()
