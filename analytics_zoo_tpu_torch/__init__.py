"""PyTorch/CUDA port of ``analytics_zoo_tpu`` for one NVIDIA H100.

Subpackage and module names mirror the JAX package, so every file here
has one counterpart there (``ops/pallas_detout.py`` ↔
``analytics_zoo_tpu/ops/pallas_detout.py``).  The JAX package is the
reference this port is held against; nothing here imports it or JAX.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  On the CPU every hand-written kernel is replaced by its
plain PyTorch version (what the CPU tests run); with no GPU and no
explicit CPU device they raise.  Kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``utils/cuda_build.py``).
"""

__version__ = "0.1.0"
