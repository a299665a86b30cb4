"""Device ms a training step of the kernels of csrc/trace_slots.cu."""


def read(run):
    return run.kernel_ms("trace_slots")
