"""The port's hand-written CUDA kernels for Hopper.

Each kernel package holds the wrapper that launches its kernel (with a
plain-integer launch count), and the plain PyTorch version of the same
function that the wrapper runs for tensors on the CPU. Sources live in
``repro_torch/csrc``; ``_build`` compiles them with nvcc at first use.
"""
