"""Device ms a training step of the kernels of csrc/scatter_grads.cu."""


def read(run):
    return run.kernel_ms("scatter_grads")
