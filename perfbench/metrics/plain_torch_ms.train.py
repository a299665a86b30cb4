"""Device ms a training step of every operation that is not one of the
program's hand-written kernels (csrc/): the prepare, wavefront, backward
and optimizer layers' plain PyTorch."""


def read(run):
    return run.plain_ms()
