"""PyTorch/CUDA port of ``avatar_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's subpackage and module names, so each module's
counterpart is easy to find. Parameters are nested dicts of tensors with
the JAX package's tree structure; linear weights are stored ``[out, in]``
and conv weights ``[out, in, kt, kh, kw]`` (PyTorch's layouts).

The attention kernels of the DiT are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (``ops/kernel_build.py``).
Entry points run on ``"cuda"`` unless the caller asks for ``"cpu"``.
"""
