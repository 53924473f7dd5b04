"""Kernel wrappers, each beside its plain PyTorch version, and the nvcc
build of `csrc/` (`_build.py`)."""
