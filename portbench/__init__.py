"""The benchmark of graphlearninglayer_tpu_torch on NVIDIA H100s.

``python -m portbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``; see ``run.py`` and
``README.md``.  Nothing here imports JAX or the JAX package, and nothing
under ``reference/`` imports the measured program.
"""
