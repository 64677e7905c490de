"""The benchmark of ``textgcn_tpu_torch`` on one NVIDIA H100 a cell.

Run one cell once from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the root lists the cells and metrics; each cell,
configuration, traffic mix and per-layer metric is a file of its own
here (see ``harness.py``).  Nothing here imports JAX or the JAX package.
"""
