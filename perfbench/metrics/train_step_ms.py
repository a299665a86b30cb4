"""The window's time over the training steps it ran (ms): a closed loop
with no synchronize between steps and one at the window's end."""


def read(run):
    return run.mean_item_ms()
