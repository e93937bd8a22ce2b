"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the checkout's root names the cells (configuration
x traffic mix) and the metrics; ``run.py`` runs one cell once.  Each
configuration is a file under ``configs/``, whose architecture has a
module under ``models/`` (weights, the program's front door, the plain
reference under ``reference/``, the work counts), each traffic mix a
data file under ``traffic/`` that ``traffic.py`` reads, and each metric a
reader under ``metrics/``.
Nothing here imports JAX or the JAX package.
"""
