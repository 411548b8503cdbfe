"""portbench: the benchmark of raleigh_tpu_torch, the PyTorch and CUDA
port, on an NVIDIA H100.

One command runs one cell (``BENCHMARK.json``'s ``workloads``):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, one cell or one metric is
a file of its own, found by its name: ``configs/<name>.json`` (sizes,
source, the input maker and the reference), ``workloads/<name>.json``
(the solve, its limits and why), ``tasks/<name>.py`` (the kind of solve
a workload names: the program's set-up and call, and its checks against
the reference; ``partial_hevp`` where it names none),
``makers/<name>.py`` (inputs from the seed), ``references/<name>.py``
(plain float64 answers), ``metrics/<name>.py`` (one reader a metric)
and ``rooflines/<name>.py`` (a kernel's bytes a launch).  The benchmark
imports nothing of the JAX package, and its references nothing of the
program.
"""
