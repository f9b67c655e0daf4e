"""The port's hand-written CUDA kernels (sources in `gf3x_torch/csrc/`),
each wrapper beside its plain PyTorch version: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises."""
