"""PyTorch port of sdformerflow_tpu for NVIDIA Hopper (H100).

The JAX package ``sdformerflow_tpu`` is the reference; this package mirrors
its module tree file for file and keeps its public layouts (time-major,
channels-last ``[T, B, H, W, C]``) at module boundaries. It imports ``torch``
and never ``jax``.

Ported so far: the SDformerFlow-en4 serving forward behind
:class:`sdformerflow_tpu_torch.serving.FlowServer` (voxel and raw-event
requests, the fused embed, the s2d head), its train step and trainer, at
the DSEC and the MDR/MVSEC geometries, the DSEC and MVSEC evaluations and
the MDR trainer (``eval_dsec``, ``eval_mvsec``, ``train_mdr``), the ANN
family, the deployment surface (``training/export.py`` through
``torch.export`` and its ``export_model`` CLI, the HTTP front ``serve``,
``flow_client`` and ``bench_serving``), with every TPU kernel of the JAX
package as a hand-written CUDA C++ kernel under ``csrc/`` (wrappers in
``ops/hopper_*.py``). Importing the package imports nothing else.
"""
