"""PyTorch + CUDA port of the serving workload for NVIDIA Hopper, and the
device plugin that advertises the cards (``plugin/``, ``nvidia.com/gpu``).

The JAX package ``k8s_device_plugin_tpu`` is the reference; this package
mirrors its layout (``models/``, ``ops/``, ``parallel/``, ``plugin/``,
``kubelet/``, ``utils/``) so every module has
an obvious counterpart, and it imports nothing of it: what it needs from
the reference's jax-free modules it keeps as its own copy.

Kernels live in ``csrc/`` as hand-written CUDA C++ for ``sm_90a``, built by
``nvcc`` at first use (``ops/_build.py``) and bound with ``ctypes``.  Each
kernel wrapper keeps a plain PyTorch version of the same math beside it;
the wrapper takes that version only for CPU tensors.
"""
