"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

Mirrors ``src/repro/`` module for module.  It imports ``torch``, numpy and
the standard library only: never ``jax`` and never ``repro``.  Plain
tensor code is PyTorch; every Pallas TPU kernel on the ported path is a
hand-written CUDA kernel under ``csrc/``, launched for CUDA tensors, with
its plain PyTorch version taken for CPU tensors.
"""
