"""The benchmark's plain references: plain PyTorch, no module of the
program, no JAX. Each works out again what the program derives from the
inputs the harness makes (weights, augmentation decisions, batches)."""
