"""Device ms a frame of the kernels of csrc/render_scan.cu."""


def read(run):
    return run.kernel_ms("render_scan")
