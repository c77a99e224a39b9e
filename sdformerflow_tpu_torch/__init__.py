"""PyTorch port of sdformerflow_tpu for NVIDIA Hopper (H100).

The JAX package ``sdformerflow_tpu`` is the reference; this package mirrors
its module tree file for file and keeps its public layouts (time-major,
channels-last ``[T, B, H, W, C]``) at module boundaries. It imports ``torch``
and never ``jax``.

Ported so far: the SDformerFlow-en4 eval forward behind
:class:`sdformerflow_tpu_torch.serving.FlowServer`, with two hand-written
Hopper kernels on its path (``ops/hopper_attn.py`` in CUDA C++,
``ops/hopper_psn.py`` in Triton). Importing the package imports nothing else.
"""
