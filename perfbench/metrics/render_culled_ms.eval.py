"""Device ms a frame of the kernels of csrc/render_culled.cu."""


def read(run):
    return run.kernel_ms("render_culled")
