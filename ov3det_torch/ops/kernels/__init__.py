"""Hand-written Hopper kernels of the port, each beside its plain version.

`fps`, `ball_group`, `attention`, `auction`, `nms`, `quant_conv`,
`points_in_box`, `ball_query` (the first-K query), `roi_align` (the
teacher's RoIAlign), `attn_pool` (CLIP's attention pool: `pool_tokens`
and `pool_attend`) and `normalise` (the teacher's input normalisation) each hold wrappers that launch their CUDA kernels
(`ov3det_torch/csrc/*.cu`) for CUDA tensors and count the launches in a
`launches` attribute (the attention wrappers count their radius variants
in `radius_launches`); CPU tensors take the plain version in the same
module (RoIAlign's, `roi_align_plain`, lives in `ops/roi_align.py`).  `_build` compiles and binds the sources
at first use.
"""
