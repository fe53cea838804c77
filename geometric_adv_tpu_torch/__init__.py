"""geometric_adv_tpu_torch — the PyTorch/CUDA port of ``geometric_adv_tpu``.

The JAX package beside it stays the reference. This package imports
``torch`` and never ``jax``; it mirrors the reference's layout (``ops``,
``models``, ``train``, ``attack``, ``cli``) so each module's counterpart is
found by path. Every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), bound through ctypes in ``ops/cuda/``.
"""

__version__ = "0.1.0"
