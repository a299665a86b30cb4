"""Device ms a frame of every operation that is not one of the program's
hand-written kernels (csrc/): the prepare and wavefront layers' plain
PyTorch."""


def read(run):
    return run.plain_ms()
