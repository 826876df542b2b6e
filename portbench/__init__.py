"""portbench — the benchmark of ``srcnn_cpp_tpu_torch`` on NVIDIA cards.

``python -m portbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`portbench.run`).
Configurations, traffic mixes, end-to-end and per-layer metrics are files
of their own under ``configs/``, ``traffic/``, ``end_to_end/`` and
``metrics/``; the plain reference
that decides ``correct`` is ``reference/``.  Nothing here imports JAX or
the JAX package, and ``reference/`` imports nothing of the program.
"""
