"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Small detector configurations for both packages, synthetic batches from a
numpy seed, the JAX package's random-init variables with random BatchNorm
statistics (so eval-mode BN is not an identity), as numpy, and the two-step
training comparison.  The JAX side runs what the TPU runs: exact FPS (fps_shards = 1) and the
Pallas ball-group in interpret mode (OV3DET_BALLGROUP=pallas, set by the
caller).
"""
from __future__ import annotations

import dataclasses

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


def masked_configs(compute_dtype: str = "float32"):
    """(JAX ModelConfig, port ModelConfig) of a small masked ScanNet-like
    detector: `configs` with the masked encoder (3 layers of 64, the
    reference's radii), an interim SA of 64 channels, 1 angle bin."""
    j, t = configs(compute_dtype)
    kw = dict(num_angle_bin=1, interim_nsample=8, interim_mlp=(64, 64, 64))
    j = dataclasses.replace(j, encoder=dataclasses.replace(j.encoder, kind="masked", num_layers=3),
                            **kw)
    t = dataclasses.replace(t, encoder=dataclasses.replace(t.encoder, kind="masked", num_layers=3),
                            **kw)
    return j, t


def masked_batch(seed: int = 0) -> dict:
    """A batch of `make_batch`'s size with one angle bin (angle labels 0)."""
    from ov3det.datasets import make_batch as jax_make_batch

    return jax_make_batch(np.random.default_rng(seed), batch_size=B, num_points=N_POINTS,
                          num_semcls=10, num_angle_bin=1)


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


def zero_dropout(m):
    """A ModelConfig (either package's) with every dropout at 0."""
    return dataclasses.replace(m, encoder=dataclasses.replace(m.encoder, dropout=0.0),
                               decoder=dataclasses.replace(m.decoder, dropout=0.0),
                               mlp_dropout=0.0)


def assert_two_steps_match(batch: dict, jq, tq, jm, tm, lr: float) -> None:
    """Two steps of JAX's `make_train_step` and of the port's from the same
    weights, dropout at 0 and no warm-up, with the tolerances of
    `tests/test_torch_train.py`'s docstring.  jq, tq: the two packages'
    TrainConfigs; jm, tm: their ModelConfigs (f32), which replace the run's."""
    import jax
    import jax.numpy as jnp
    import torch

    from ov3det.engine.schedule import make_lr_schedule as jax_schedule
    from ov3det.engine.train import TrainState
    from ov3det.engine.train import build_optimizer as jax_build_optimizer
    from ov3det.engine.train import make_train_step as jax_make_train_step
    from ov3det.losses.criterion import compute_assignments as jax_assignments
    from ov3det_torch.engine import train as T
    from ov3det_torch.losses.criterion import compute_assignments
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR

    jm, tm = zero_dropout(jm), zero_dropout(tm)
    jcfg = dataclasses.replace(jq, model=jm, optim=dataclasses.replace(jq.optim, warm_lr_epochs=0))
    tcfg = dataclasses.replace(tq, model=tm, optim=dataclasses.replace(tq.optim, warm_lr_epochs=0))
    rotated = jm.num_angle_bin > 1
    model, variables = jax_model_and_variables(jm, batch)

    # JAX: make_train_step from these variables; the matcher's masks of step 1
    tx = jax_build_optimizer(jcfg.optim, jax_schedule(jcfg.optim, jcfg.max_epoch, 100))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       frozen=jax.tree_util.tree_map(jnp.asarray, variables["frozen"]),
                       opt_state=tx.init(params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jout, _ = model.apply(variables, {k: jbatch[k] for k in INPUT_KEYS}, train=True,
                          mutable=["batch_stats"])
    jassign = jax_assignments(jout, dict(jbatch, nactual_gt=jnp.sum(jbatch["gt_box_present"], 1)
                                         .astype(jnp.int32)), jcfg.loss, rotated_boxes=rotated)
    jstep = jax_make_train_step(model, tx, jcfg.loss, jm.num_angle_bin, jm.num_semcls)
    want = []
    for i in range(2):
        state, metrics = jstep(state, jbatch, jax.random.PRNGKey(i))
        want.append(({k: float(v) for k, v in metrics.items()}, from_flax_variables({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats),
            "frozen": variables["frozen"]})))

    # the port: build from the same weights, two steps
    net = Model3DETR(tm, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    opt = T.build_optimizer(net, tcfg.optim, T.make_lr_schedule(tcfg.optim, tcfg.max_epoch, 100))
    step = T.make_train_step(net, opt, tcfg.loss, tm.num_angle_bin, tm.num_semcls)
    tbatch = T.batch_to_device(batch, "cpu")
    start = {k: v.clone() for k, v in net.state_dict().items()}

    net.train()
    with torch.no_grad():
        tout = net({k: tbatch[k] for k in INPUT_KEYS}, torch.Generator())
    net.load_state_dict(start)  # the probe forward moved the running stats
    targets = dict(tbatch, nactual_gt=tbatch["gt_box_present"].sum(1).long())
    assign = compute_assignments(tout, targets, tcfg.loss, rotated_boxes=rotated)
    for k in ("per_prop_gt_inds", "proposal_matched_mask"):
        np.testing.assert_array_equal(assign[k].numpy(), np.asarray(jassign[k]), err_msg=k)

    gen = torch.Generator().manual_seed(0)
    for i, rtol in enumerate((1e-4, 2e-3)):
        got = step(tbatch, gen)
        metrics, sd_want = want[i]
        assert set(got) == set(metrics)
        for k, w in metrics.items():
            np.testing.assert_allclose(float(got[k]), w, rtol=rtol, atol=1e-6,
                                       err_msg=f"{k}, step {i}")
        sd = net.state_dict()
        for k, w in sd_want.items():
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(sd["pos_embedding.gauss_B"].numpy(),
                                   sd_want["pos_embedding.gauss_B"].numpy(), rtol=0, atol=1e-6)
        if i == 0:
            diffs = torch.cat([(sd[k] - w).abs().flatten() for k, w in sd_want.items()
                               if "running" not in k and k != "text_embed"])
            assert float((diffs <= 1e-6).float().mean()) >= 0.995
            assert float(diffs.max()) <= 2 * lr
    # gauss_B moved by the weight decay alone
    assert not torch.equal(net.pos_embedding.gauss_B.detach(), start["pos_embedding.gauss_B"])
    assert net.pos_embedding.gauss_B.grad is None
