"""Hand-written Hopper kernels of the port, each beside its plain version.

`fps`, `ball_group`, `attention`, `auction`, `nms`, `quant_conv`,
`points_in_box` and `ball_query` (the first-K query) each hold wrappers
that launch their CUDA kernels (`ov3det_torch/csrc/*.cu`) for CUDA tensors
and count the launches in a `launches` attribute (the attention wrappers
count their radius variants in `radius_launches`); CPU tensors take the
plain version in the same module.  `_build` compiles and binds the sources
at first use.
"""
