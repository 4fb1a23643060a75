"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Small detector configurations for both packages, synthetic batches from a
numpy seed, and the JAX package's random-init variables with random
BatchNorm statistics (so eval-mode BN is not an identity), as numpy.
The JAX side runs what the TPU runs: exact FPS (fps_shards = 1) and the
Pallas ball-group in interpret mode (OV3DET_BALLGROUP=pallas, set by the
caller).
"""
from __future__ import annotations

import numpy as np

B, N_POINTS, NPRE, NQUERY = 2, 2048, 256, 32
INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")

_SMALL = dict(preenc_npoints=NPRE, preenc_nsample=16, num_queries=NQUERY,
              preenc_mlp=(32, 64, 64), num_semcls=10, num_angle_bin=12,
              clip_embed_dim=64)


def configs(compute_dtype: str = "float32"):
    """(JAX ModelConfig, port ModelConfig): encoder 2 x 64, decoder 2 x 64."""
    from ov3det import config as jc
    from ov3det_torch import config as tc

    j = jc.ModelConfig(
        encoder=jc.EncoderConfig(num_layers=2, dim=64, ffn_dim=64, num_heads=4),
        decoder=jc.DecoderConfig(num_layers=2, dim=64, ffn_dim=64, num_heads=4),
        fps_shards=1, query_fps_shards=1, compute_dtype=compute_dtype, **_SMALL,
    )
    t = tc.ModelConfig(
        encoder=tc.EncoderConfig(num_layers=2, dim=64, ffn_dim=64, num_heads=4),
        decoder=tc.DecoderConfig(num_layers=2, dim=64, ffn_dim=64, num_heads=4),
        compute_dtype=compute_dtype, **_SMALL,
    )
    return j, t


def make_batch(seed: int = 0, batch_size: int = B, num_points: int = N_POINTS) -> dict:
    from ov3det.datasets import make_batch as jax_make_batch

    return jax_make_batch(np.random.default_rng(seed), batch_size=batch_size,
                          num_points=num_points, num_semcls=_SMALL["num_semcls"],
                          num_angle_bin=_SMALL["num_angle_bin"])


def randomize_batch_stats(tree: dict, rng: np.random.Generator) -> dict:
    """Random running means (about 0.1) and variances (0.5 to 3)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_batch_stats(v, rng)
        elif k == "var":
            out[k] = (0.5 + np.abs(rng.normal(size=v.shape))).astype(np.float32)
        else:
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return out


def to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_model_and_variables(jcfg, batch: dict, seed: int = 0):
    """(flax Model3DETR, variables as numpy with random batch stats)."""
    import jax
    import jax.numpy as jnp

    from ov3det.models import Model3DETR

    model = Model3DETR(jcfg)
    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    variables = to_numpy(model.init(jax.random.PRNGKey(seed), inputs, train=False))
    variables["batch_stats"] = randomize_batch_stats(
        variables["batch_stats"], np.random.default_rng(seed + 1))
    return model, variables


def jax_forward(model, variables, batch: dict) -> dict:
    import jax.numpy as jnp

    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    out = model.apply(variables, inputs, train=False)
    return {k: np.asarray(v) for k, v in out.items()}
