"""cfun_tpu_torch: the PyTorch + CUDA port of cfun_tpu, for one NVIDIA H100.

The JAX package ``cfun_tpu`` is the reference; this package imports nothing
of it (nor JAX) and keeps its own copies of the host code it needs.  Module
names follow ``cfun_tpu`` so each file's counterpart is easy to find.

Layout: device volumes and feature maps are channel-first, NCDHW
``[batch, C, D, H, W]`` (the JAX package keeps NDHWC); boxes are
``(z1, y1, x1, z2, y2, x2)`` with the far corner exclusive, normalized to
[0, 1] inside the head pipeline; host volumes are the reference's
``[H, W, D]``.  Parameters are nested dicts of tensors with PyTorch
layouts (``weights.py``).

Every Pallas kernel of the JAX package on the served path is a CUDA kernel
written for Hopper (``csrc/``, built by ``_build.py`` with ``nvcc`` and
bound with ctypes), with a plain PyTorch version beside it that CPU
tensors use.  The host side of serving (mold and unmold) is C++ with
OpenMP (``csrc/host_ops.cc``, built by ``_build.py`` with ``g++``, bound
in ``native.py``).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
