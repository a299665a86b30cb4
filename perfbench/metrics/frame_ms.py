"""The window's time over the frames it ran (ms), each frame waited for."""


def read(run):
    return run.mean_item_ms()
