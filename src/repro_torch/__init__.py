"""PyTorch / CUDA port of the EdgeLLM serving path for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it.  Module names mirror the reference so each counterpart is easy to
find: ``core/quant.py`` (int4 packing), ``core/compiler.py``
(``quantize_model``), ``kernels/`` (hand-written sm_90a kernels beside their
plain PyTorch versions), ``models/`` (the dense transformer's serving half),
``serving/engine.py`` (continuous batching) and ``launch/serve.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On a
CUDA tensor every kernel op launches its hand kernel or raises; on a CPU
tensor it runs the plain PyTorch version (what the CPU tests exercise).
"""
