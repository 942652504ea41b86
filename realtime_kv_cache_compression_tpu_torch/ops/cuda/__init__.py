"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version. Nothing here compiles or imports a GPU toolchain at import
time: the kernels build on first use on a CUDA tensor (`_build.py`)."""
