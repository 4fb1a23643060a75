"""Reference 3DETR checkpoints in the port, on the CPU against the JAX
package: the first-K ball query and its grouping, and the checkpoint
loader.

- `ball_query` (JAX's `method="first_k"`) returns JAX's indices exactly, on random
  clouds (balls empty, partial and full) and at the r^2 boundary, where the
  expanded distance of `_pairwise_d2` and a direct subtraction disagree;
  `group_points` equals JAX's bit for bit;
- a random reference-layout state dict (the port's seeded model with random
  BatchNorm statistics, written out by `to_reference_state_dict`) goes
  through JAX's `convert_3detr_checkpoint` into JAX's model, and through the
  port's `convert_reference_state_dict` into the port's, both with
  `ball_query_method="first_k"` and exact FPS: the converted tree has the
  shapes of JAX's init, the port's state dict round-trips, and the eval
  outputs agree within 1e-4 (f32; the vanilla and the masked encoder);
- `load_reference_checkpoint` reads a `.pth` with DDP's `module.` prefix.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pointcloud import ball_query as jax_ball_query
from ov3det.ops.pointcloud import group_points as jax_group_points
from ov3det_torch.ops.pointcloud import ball_query, group_points
from tests import torch_parity as tp


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ first-K ball query
@pytest.mark.parametrize("radius,nsample", [(0.2, 16), (0.7, 64), (0.05, 8)])
def test_first_k_ball_query_equals_jax(radius, nsample):
    rng = np.random.default_rng(int(radius * 100) + nsample)
    xyz = rng.uniform(-1, 1, (2, 700, 3)).astype(np.float32)
    centers = np.concatenate([xyz[:, :40], rng.uniform(-1.5, 1.5, (2, 24, 3))], 1).astype(np.float32)
    want = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample,
                                     method="first_k"))
    got = ball_query(_t(xyz), _t(centers), radius, nsample)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    counts = (np.asarray(want)[..., 1:] != np.asarray(want)[..., :1]).sum(-1)
    assert counts.min() == 0  # some ball holds one point or none
    if radius == 0.7:
        assert counts.max() == nsample - 1  # some ball is full


def test_first_k_ball_query_chunks_the_centers(monkeypatch):
    """Chunks of 1 and 7 centers give the indices of one chunk."""
    import ov3det_torch.ops.kernels.ball_query as bq

    rng = np.random.default_rng(3)
    xyz = _t(rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32))
    centers = xyz[:, :20].clone()
    whole = ball_query(xyz, centers, 0.3, 16)
    for elements in (600, 7 * 600):
        monkeypatch.setattr(bq, "FIRST_K_ELEMENTS", elements)
        np.testing.assert_array_equal(ball_query(xyz, centers, 0.3, 16).numpy(), whole.numpy())


def test_first_k_ball_query_at_the_r2_boundary():
    # center (10, 0, 0), points just past r along x: at |c| = 10 the expanded
    # |c|^2 + |x|^2 - 2 c.x rounds some of them into the ball that a direct
    # subtraction leaves out; JAX's first-K takes the expanded form
    radius = 0.2
    c0, r2 = np.float32(10.0), np.float32(radius * radius)
    direct = lambda p: (p - c0) * (p - c0)  # noqa: E731
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    p = np.nextafter(np.float32(c0 + np.float32(radius)), np.float32(0))
    while not (direct(p) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    q = p
    while expanded(q) < r2:  # the first point out under both formulas
        q = np.nextafter(q, np.float32(20))
    xyz = np.zeros((1, 6, 3), np.float32)
    xyz[0, :, 0] = [30.0, q, p, c0 - np.float32(0.1), 40.0, c0]
    centers = np.array([[[c0, 0, 0], [30.0, 0, 0], [-5.0, 0, 0]]], np.float32)
    want = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, 4,
                                     method="first_k"))
    got = ball_query(_t(xyz), _t(centers), radius, 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].tolist() == [2, 3, 5, 2]  # p in, q out, the tail the first hit
    assert got[0, 2].tolist() == [0, 0, 0, 0]  # an empty ball: index 0 throughout


@pytest.mark.parametrize("channels", [0, 5])
def test_group_points_equals_jax(channels):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    centers = xyz[:, :32].copy()
    feats = rng.normal(size=(2, 500, channels)).astype(np.float32) if channels else None
    inds = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(centers), 0.3, 16,
                                     method="first_k"))
    want = jax_group_points(jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
                            jnp.asarray(centers), jnp.asarray(inds), 0.3)
    got = group_points(_t(xyz), None if feats is None else _t(feats), _t(centers),
                       _t(inds).long(), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_k_features_get_their_gradient():
    rng = np.random.default_rng(5)
    xyz = _t(rng.uniform(-1, 1, (1, 200, 3)).astype(np.float32))
    feats = _t(rng.normal(size=(1, 200, 4)).astype(np.float32)).requires_grad_()
    inds = ball_query(xyz, xyz[:, :10], 0.4, 8)
    group_points(xyz, feats, xyz[:, :10], inds, 0.4)[..., 3:].sum().backward()
    want = np.bincount(inds.reshape(-1).numpy(), minlength=200)
    np.testing.assert_array_equal(feats.grad[0, :, 0].numpy(), want.astype(np.float32))


# ------------------------------------------------------------ reference checkpoints
def _configs(kind: str):
    j, t = tp.masked_configs() if kind == "masked" else tp.configs()
    return (dataclasses.replace(j, ball_query_method="first_k"),
            dataclasses.replace(t, ball_query_method="first_k"))


def _reference_state_dict(tm, batch_stats_seed: int = 9) -> dict:
    """The port's seeded model, random BatchNorm statistics, in the
    reference layout (numpy)."""
    from ov3det_torch.models.convert_3detr import to_reference_state_dict
    from ov3det_torch.models.detr3d import Model3DETR

    net = Model3DETR(tm, device="cpu", seed=4)
    rng = np.random.default_rng(batch_stats_seed)
    sd = net.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = _t((0.1 * rng.normal(size=v.shape)).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = _t((0.5 + np.abs(rng.normal(size=v.shape))).astype(np.float32))
        elif k == "text_embed":
            sd[k] = _t(rng.normal(size=v.shape).astype(np.float32))
    return to_reference_state_dict(sd), sd


@pytest.mark.parametrize("kind", ["vanilla", "masked"])
def test_reference_checkpoint_forward_matches_jax(kind):
    import chex

    from ov3det.models import Model3DETR as JModel
    from ov3det.models.convert_3detr import convert_3detr_checkpoint
    from ov3det_torch.models.convert_3detr import convert_reference_state_dict
    from ov3det_torch.models.detr3d import Model3DETR

    jm, tm = _configs(kind)
    ref, port_sd = _reference_state_dict(tm)
    kw = dict(enc_heads=tm.encoder.num_heads, dec_heads=tm.decoder.num_heads)
    # the port reads the depths and the encoder's kind from the keys
    jvars = convert_3detr_checkpoint(ref, enc_layers=tm.encoder.num_layers,
                                     dec_layers=tm.decoder.num_layers, enc_kind=kind, **kw)
    batch = tp.masked_batch(2) if kind == "masked" else tp.make_batch(2)
    model = JModel(jm)
    inputs = {k: jnp.asarray(batch[k]) for k in tp.INPUT_KEYS}
    init = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs, train=False))
    chex.assert_trees_all_equal_shapes(jvars["params"], init["params"])
    chex.assert_trees_all_equal_shapes(jvars["batch_stats"], init["batch_stats"])

    converted = convert_reference_state_dict(ref, **kw)
    assert converted.keys() == port_sd.keys()
    for k, v in port_sd.items():  # the round trip is exact
        np.testing.assert_array_equal(converted[k].numpy(), v.numpy(), err_msg=k)

    want = jax.jit(functools.partial(model.apply, train=False))(jvars, inputs)
    net = Model3DETR(tm, device="cpu")
    net.load_state_dict(converted)
    with torch.inference_mode():
        got = net({k: _t(batch[k]) for k in tp.INPUT_KEYS})
    np.testing.assert_array_equal(got["query_xyz"].numpy(), np.asarray(want["query_xyz"]))
    assert set(want) <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=k)


def test_load_reference_checkpoint_reads_a_pth(tmp_path):
    from ov3det_torch.models.convert_3detr import load_reference_checkpoint

    _, tm = _configs("vanilla")
    ref, port_sd = _reference_state_dict(tm)
    path = tmp_path / "checkpoint_best.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in ref.items()},
                "epoch": 3}, path)
    got = load_reference_checkpoint(str(path))
    assert got.keys() == port_sd.keys()
    for k, v in port_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

