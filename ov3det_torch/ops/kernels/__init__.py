"""Hand-written Hopper kernels of the port, each beside its plain version.

`fps`, `ball_group`, `attention` and `auction` each hold a wrapper that
launches its CUDA kernel (`ov3det_torch/csrc/*.cu`) for CUDA tensors and
counts the launch in its `launches` attribute (the attention wrappers count
their radius variants in `radius_launches`); CPU tensors take the plain
version in the same module.  `_build` compiles and binds the sources at
first use.
"""
