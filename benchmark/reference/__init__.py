"""The benchmark's plain references: frozen copies of the port's plain
PyTorch paths, held under the benchmark so that no later change to the
program moves them. They import nothing of the program, of JAX or of the
JAX package, take only the weights and inputs the benchmark makes, and
compute in float32 with TF32 off (``precision.py``)."""
