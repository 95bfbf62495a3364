"""Hand-written Hopper kernels of the port.

Each kernel directory carries kernel.py (builds and launches the CUDA
kernel from `repro_torch/csrc/`), ops.py (the public wrapper: a CUDA
tensor goes to the kernel, a CPU tensor to the plain PyTorch version)
and ref.py (the numpy oracle and the plain PyTorch version).

  rs_parity — GF(256) Reed-Solomon parity for ec(k,p) containers
"""
