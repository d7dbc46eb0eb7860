"""POCO in PyTorch and CUDA, for NVIDIA Hopper cards.

A port of `poco_tpu` (JAX) that keeps its layouts, names and numerics:
the batch dict of `models/poco.py`, the reference torch state_dict names
(`backbone.`, `head.`, `uncert_head.`), and fp32 SMPL math. Plain tensor
code is PyTorch; the SMPL skinning stage is a CUDA kernel written for
`sm_90a` (`csrc/skinning.cu`), built with nvcc at first use.

Importing a module builds nothing: kernels are built and loaded inside
the calls that launch them.
"""
