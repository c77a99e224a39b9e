"""Tensor-level ops and the hand-written Hopper kernels."""
