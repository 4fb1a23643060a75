"""PyTorch/CUDA port of ov3det.

Mirrors the module paths of the JAX package `ov3det`, which stays the
reference.  The port imports torch and numpy only.  Its entry points
(`ov3det_torch.engine.infer.Detector`, `ov3det_torch.models.Model3DETR`)
run on CUDA unless the caller passes `device="cpu"`.
"""
