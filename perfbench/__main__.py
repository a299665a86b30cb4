import os
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    # load from one process with few threads: the host's other cores stay
    # free for the CUDA runtime
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    from perfbench.run import main

    raise SystemExit(main(t_start=T_START))
