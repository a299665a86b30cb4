"""The benchmark of the PyTorch and CUDA port
(editable_gaussian_reflections_tpu_torch) on one NVIDIA H100.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace 0|1

runs one cell of BENCHMARK.json once and prints, as its last line of
standard output, one JSON object (correct, attempted, failed, metrics,
device, breakdown with --trace 1, and the numbers compared beside their
limits under "checks").

Layout, found by the names BENCHMARK.json gives:
  configs/<config>.json   a configuration: scene sizes, frame, the
                          program's keywords, what was reduced or assumed,
                          and the limits of the comparison per traffic kind;
  traffic/<traffic>.json  a traffic mix: the parameters the general loop of
                          its kind reads;
  kinds/<kind>.py         a traffic kind: the loop its mixes drive and the
                          comparison of what that loop kept;
  metrics/<metric>.py     the reader of one metric, end-to-end or per-layer;
  reference/              the plain PyTorch reference the comparison holds
                          the program to (a frozen copy of the port's plain
                          versions; it imports nothing of the program).
"""
