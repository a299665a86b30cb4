"""Process start to the first timed step or frame (s): imports, the inputs
from the seed, the kernels built or loaded, warm-up or the checked first
steps."""


def read(run):
    return run.win.setup_s
