"""PyTorch / CUDA port of the ROS2 object store (see README.md).

`repro_torch` mirrors `repro`'s layout: `core/` is the storage stack
(numpy plus threads, as in the reference), `kernels/<name>/` holds each
hand-written GPU kernel beside its plain PyTorch version, and `csrc/`
holds the CUDA sources, built with `nvcc` on first use. Everything runs
on the CUDA card unless the caller passes `device="cpu"`.
"""
