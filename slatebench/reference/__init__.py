"""The plain reference the benchmark judges the program by (NumPy and plain
PyTorch only; nothing of the program, its oracles or its test helpers)."""
