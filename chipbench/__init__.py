"""The benchmark of the PyTorch and CUDA port (``callireader_tpu_torch``).

    python3 -m chipbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the CUDA device of this machine
and prints one JSON line. Each configuration, traffic mix and per-layer
metric is a file of its own here, found by its name: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``, and each cell's limits,
``limits/<cell>.json``; a configuration names its driver
(``drivers/<driver>.py``). ``reference/`` holds the plain float32
models that decide ``correct``, ``flops.py`` the operation and byte counts
of the roofline and mfu metrics. Nothing here imports JAX or the JAX
package.
"""
