"""Benchmark of the PyTorch/CUDA port (``kbo_tpu_torch``) on H100 cards: a
cell takes one card or four.

``python3 -m kbo_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell needs
is found by name: its configuration under ``configs/``, its traffic mix under
``traffic/``, the verb that mix names under ``verbs/`` and each metric's
reader under ``metrics/``. The plain reference that decides ``correct`` is
``reference/kbo_ref.py``.
"""
