"""The masked-encoder ScanNet path of the port (3DETR-m) on the CPU against
the JAX package: the radius bias of the attention kernels (their plain
versions against the Pallas kernels in interpret mode), the ball-group's
feature gradient, the interim set abstraction, the masked encoder on both
of its routes and the whole masked eval forward.

Tolerances.  f32 values that only the summation order separates: 1e-5
absolute on the attention (as `test_torch_ops.py`), 1e-4 on modules and the
whole forward (as `test_torch_model.py`).  bf16: 2e-2 absolute on the
attention output and gradients, 3e-2 on the forward's logits, centers and
sizes, where the two frameworks round at different places.  Masks, picks
and FPS indices are exact; the ball-group gradient sums the same values in
another order (1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.models.pointnet import PointnetSAModule as JSA
from ov3det.models.transformer import MaskedTransformerEncoder as JMasked
from ov3det.ops.pallas.attention_kernel import _radius_bias, fused_attention
from ov3det.ops.pallas.ball_group_kernel import ball_group_pallas
from ov3det_torch import config as tc
from ov3det_torch.models import convert
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.models.pointnet import PointnetSAModule
from ov3det_torch.models.transformer import MaskedTransformerEncoder
from ov3det_torch.ops import pointcloud
from ov3det_torch.ops.kernels import attention, ball_group
from tests import torch_parity as tp

RADII = (0.4 ** 2, 0.8 ** 2, 1.2 ** 2)  # EncoderConfig.masking_radius


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or dict(rtol=1e-4, atol=1e-4)))


def _tokens(rng, B, N, scale=1.0):
    """Token coordinates as the encoder sees them: FPS picks of a room-sized
    cloud, so neighbours are spread as on the main path."""
    return (rng.uniform(-1, 1, size=(B, N, 3)) * scale).astype(np.float32)


# -------------------------------------------------------- radius attention
def _qkv(seed, B=2, H=2, N=256, D=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3)]


def _heads(a):  # (B, N, H, D) -> (B*H, N, D)
    B, N, H, D = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, N, D)))


def test_radius_mask_equals_pallas_bias_exactly():
    rng = np.random.default_rng(0)
    for r in RADII:
        xyz = _tokens(rng, 2, 512, 2.0)
        want = np.stack([np.asarray(_radius_bias(jnp.asarray(x), jnp.asarray(x), r * r)) == 0
                         for x in xyz])
        got = attention.radius_mask(_t(xyz), _t(xyz), r * r)
        np.testing.assert_array_equal(got.numpy(), want)  # bit for bit
        assert 0.001 < want.mean() < 0.9 and want[:, np.arange(512), np.arange(512)].all()


@pytest.mark.parametrize("dtype,rate", [("float32", 0.0), ("float32", 0.3),
                                        ("bfloat16", 0.0), ("bfloat16", 0.3)])
def test_radius_attention_plain_matches_pallas_vjp(dtype, rate):
    q, k, v = _qkv(1)
    B, N, H, D = q.shape
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    xyz = _tokens(np.random.default_rng(3), B, N, 1.5)
    r2, seed = RADII[1] * RADII[1], 77
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def fn(q, k, v):
        return fused_attention(q, k, v, dropout_rate=rate, dropout_seed=seed,
                               q_xyz=jnp.asarray(xyz), k_xyz=jnp.asarray(xyz),
                               radius_sq=r2, interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    tq, tk, tv = (_heads(a).to(td).requires_grad_() for a in (q, k, v))
    out = attention.fused_attention(tq, tk, tv, rate,
                                    torch.tensor([seed], dtype=torch.int32) if rate else None,
                                    (_t(xyz), _t(xyz), r2))
    out.backward(_heads(g).to(td))
    assert out.dtype == td and all(t.grad.dtype == td for t in (tq, tk, tv))

    def back(t):  # (B*H, N, D) -> (B, N, H, D)
        return t.detach().float().numpy().reshape(B, H, N, D).transpose(0, 2, 1, 3)

    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(back(out), np.asarray(want.astype(jnp.float32)), rtol=0, atol=atol)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(back(t.grad), np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=atol)


def test_radius_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v = (_heads(a) for a in _qkv(4, N=128))
    xyz = _t(_tokens(np.random.default_rng(5), 2, 128))
    radius = (xyz, xyz, RADII[0] * RADII[0])
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    before = [(w.launches, w.radius_launches) for w in
              (attention.attention_fwd, attention.attention_dq, attention.attention_dkv)]
    out, lse = attention.attention_fwd(q, k, v, radius=radius)
    want, want_lse = attention.attention_fwd_plain(q, k, v, radius=radius)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    # the LSE is that of the in-radius keys alone
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) / np.sqrt(q.shape[-1])
    inside = attention.radius_mask(*radius).repeat_interleave(2, dim=0)
    ref = torch.logsumexp(torch.where(inside, s, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse[..., 0].numpy(), ref.numpy(), rtol=0, atol=1e-5)
    delta = (do * out).sum(-1, keepdim=True)
    np.testing.assert_array_equal(
        attention.attention_dq(q, k, v, do, lse, delta, radius=radius).numpy(),
        attention.attention_dq_plain(q, k, v, do, lse, delta, radius=radius).numpy())
    for a, b in zip(attention.attention_dkv(q, k, v, do, lse, delta, radius=radius),
                    attention.attention_dkv_plain(q, k, v, do, lse, delta, radius=radius)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert before == [(w.launches, w.radius_launches) for w in
                      (attention.attention_fwd, attention.attention_dq, attention.attention_dkv)]
    assert not any(torch.isnan(t).any() for t in (out, lse))


# ------------------------------------------------- ball-group feature gradient
def _ball_group_case(name):
    rng = np.random.default_rng(11)
    radius, K, N, M = 0.3, 8, 512, 64
    xyz = _tokens(rng, 2, N)
    if name == "ragged_n":
        xyz = xyz[:, :N - 5]  # N not a multiple of K: a shorter last bucket
    centers = xyz[:, rng.choice(xyz.shape[1], M, replace=False)].copy()
    if name == "empty_balls":
        centers[:, ::4] += 10.0  # a quarter of the balls hold no point
    if name == "empty_slots":
        radius = 0.12  # most balls miss most buckets: slots copy the first pick
    feats = rng.normal(size=(2, xyz.shape[1], 16)).astype(np.float32)
    return xyz, feats, centers, radius, K


@pytest.mark.parametrize("name", ["random", "ragged_n", "empty_balls", "empty_slots"])
def test_ball_group_feature_grad_matches_pallas_vjp(name):
    xyz, feats, centers, radius, K = _ball_group_case(name)
    g = np.random.default_rng(12).normal(size=(2, K, centers.shape[1], 3 + 16)).astype(np.float32)

    def fn(f):
        return ball_group_pallas(jnp.asarray(xyz), f, jnp.asarray(centers), radius, K, True, True)

    want, vjp = jax.vjp(fn, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = _t(feats).requires_grad_()
    got = pointcloud.ball_group(_t(xyz), tf, _t(centers), radius, K)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(_t(g))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    _, has = ball_group.bucket_picks(_t(xyz), _t(centers), radius, K)
    if name == "empty_balls":
        assert not has[:, ::4].any() and (tf.grad != 0).any()
    if name == "empty_slots":
        assert (~has).float().mean() > 0.5 and has.any(-1).float().mean() > 0.5


def test_ball_group_gradient_lands_where_jax_puts_it_at_the_boundary():
    # center c = (10, 0, 0) and a point at distance just above r along x: the
    # forward's direct subtraction leaves it out, the backward's expanded
    # |c|^2 + |x|^2 - 2 c.x rounds it in (at |c| = 10 the expansion loses
    # ~1e-5 of d2), so JAX sends it a gradient the forward never used
    radius, K = 0.2, 1
    c0 = np.float32(10.0)
    r2 = np.float32(radius * radius)
    direct = lambda p: (p - c0) * (p - c0)  # noqa: E731
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    p = np.nextafter(np.float32(c0 + np.float32(radius)), np.float32(0))
    while not (direct(p) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    xyz = np.zeros((1, 4, 3), np.float32)
    xyz[0, :, 0] = [30.0, p, c0 - np.float32(0.1), 40.0]  # bucket 0: the boundary point first
    centers = np.array([[[c0, 0, 0]]], np.float32)
    feats = np.arange(8, dtype=np.float32).reshape(1, 4, 2)
    fwd_pick, _ = ball_group.bucket_picks(_t(xyz), _t(centers), radius, K)
    bwd_pick, _ = ball_group.bucket_picks_expanded(_t(xyz), _t(centers), radius, K)
    assert fwd_pick.item() == 2 and bwd_pick.item() == 1  # the two formulas split here

    g = np.ones((1, K, 1, 5), np.float32)
    _, vjp = jax.vjp(lambda f: ball_group_pallas(jnp.asarray(xyz), f, jnp.asarray(centers),
                                                 radius, K, True, True), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    tf = _t(feats).requires_grad_()
    out = pointcloud.ball_group(_t(xyz), tf, _t(centers), radius, K)
    np.testing.assert_array_equal(out[0, 0, 0, 3:].detach().numpy(), feats[0, 2])
    out.backward(_t(g))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(want))
    assert tf.grad[0, 1].tolist() == [1.0, 1.0] and tf.grad[0, 2].tolist() == [0.0, 0.0]


# ------------------------------------------------------------- modules
def _init(module, *args, **kw):
    variables = tp.to_numpy(module.init(jax.random.PRNGKey(3), *args, **kw))
    if "batch_stats" in variables:
        variables["batch_stats"] = tp.randomize_batch_stats(variables["batch_stats"],
                                                            np.random.default_rng(4))
    return variables


def _sa_state(v: dict) -> dict:
    sd = convert._mlp("m", v["params"], v["batch_stats"])
    return {k[2:]: _t(np.asarray(w, np.float32)) for k, w in sd.items()}


def test_interim_sa_forward_and_feature_grad_match_flax():
    rng = np.random.default_rng(6)
    xyz = _tokens(rng, 2, 512)
    feats = rng.normal(size=(2, 512, 32)).astype(np.float32)
    w = rng.normal(size=(2, 256, 48)).astype(np.float32)
    jm = JSA(npoint=256, radius=0.4, nsample=16, mlp_dims=(48, 48), fps_shards=1)
    v = _init(jm, jnp.asarray(xyz), jnp.asarray(feats))
    want_xyz, want_feats, want_inds = jm.apply(v, jnp.asarray(xyz), jnp.asarray(feats))
    jgrad = jax.grad(lambda f: jnp.sum(jm.apply(v, jnp.asarray(xyz), f)[1] * w))(
        jnp.asarray(feats))
    m = PointnetSAModule(256, 0.4, 16, 32, (48, 48)).eval()
    m.load_state_dict(_sa_state(v))
    tf = _t(feats).requires_grad_()
    new_xyz, new_feats, inds = m(_t(xyz), tf)
    np.testing.assert_array_equal(inds.numpy(), np.asarray(want_inds))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    _close(new_feats, want_feats)
    (new_feats * _t(w)).sum().backward()
    assert (tf.grad != 0).any()
    _close(tf.grad, jgrad)


@pytest.mark.parametrize("route", ["mask", "fused"])
def test_masked_encoder_matches_flax(route, monkeypatch):
    # "fused": 1024 tokens, layer 0 on the fused attention with the radius
    # bias (the JAX side forced through its Pallas kernel, the port's CPU
    # tensors through the plain version); layers 1-2 at 512 tokens take the
    # port's mask path.  "mask": 256 tokens, the boolean mask throughout on
    # both sides (JAX's automatic dispatch on the CPU)
    N = 1024 if route == "fused" else 256
    if route == "fused":
        monkeypatch.setenv("OV3DET_ATTENTION", "fused")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, N, 64)).astype(np.float32)
    xyz = _tokens(rng, 2, N, 1.5)
    interim = JSA(npoint=N // 2, radius=0.4, nsample=8, mlp_dims=(64, 64), fps_shards=1)
    jm = JMasked(num_layers=3, dim=64, masking_radius=RADII, interim_downsample=interim,
                 num_heads=4, ffn_dim=96)
    v = _init(jm, jnp.asarray(x), jnp.asarray(xyz))
    want_xyz, want, want_inds = jm.apply(v, jnp.asarray(x), jnp.asarray(xyz))

    m = MaskedTransformerEncoder(3, 64, RADII, 4, 96).eval()
    sa = PointnetSAModule(N // 2, 0.4, 8, 64, (64, 64)).eval()
    params = dict(v["params"])
    sa.load_state_dict(_sa_state({"params": params.pop("interim_downsample"),
                                  "batch_stats": v["batch_stats"]["interim_downsample"]}))
    sd = {}
    for name, sub in params.items():
        sd.update(convert._transformer_layer(f"layers.{name.rsplit('_', 1)[1]}", sub))
    m.load_state_dict({k: _t(np.asarray(w, np.float32)) for k, w in sd.items()})

    seen = []
    real = attention.fused_attention
    monkeypatch.setattr("ov3det_torch.models.transformer.fused_attention",
                        lambda *a: seen.append(a[-1] is not None) or real(*a))
    got_xyz, got, inds = m(_t(x), _t(xyz), sa)
    assert seen == ([True] if route == "fused" else [])
    np.testing.assert_array_equal(inds.numpy(), np.asarray(want_inds))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, N // 2, 64)
    _close(got, want)


# ------------------------------------------------------------ whole slice
@pytest.fixture(scope="module")
def bridged():
    import os

    os.environ["OV3DET_BALLGROUP"] = "pallas"
    try:
        batch = tp.masked_batch(seed=0)
        jcfg, _ = tp.masked_configs("float32")
        _, variables = tp.jax_model_and_variables(jcfg, batch)
    finally:
        del os.environ["OV3DET_BALLGROUP"]
    return batch, variables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_masked_eval_forward_matches_jax(bridged, dtype):
    from ov3det.models import Model3DETR as JModel

    batch, variables = bridged
    jcfg, tcfg = tp.masked_configs(dtype)
    want = tp.jax_forward(JModel(jcfg), variables, batch)
    model = Model3DETR(tcfg, device="cpu")
    sd = convert.from_flax_variables(variables)
    assert set(sd) == set(model.state_dict())  # the interim SA once, not under encoder.
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model({k: _t(batch[k]) for k in tp.INPUT_KEYS})
    np.testing.assert_array_equal(got["query_xyz"].numpy(), want["query_xyz"])
    assert got["query_inds"].max() < tp.NPRE // 2  # seeds among the interim's tokens
    assert set(want) <= set(got)
    if dtype == "float32":
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            _close(got[key], w)
    else:
        for key in ("sem_cls_logits", "center_normalized", "size_normalized"):
            _close(got[key], want[key].astype(np.float32), rtol=0, atol=3e-2)


def test_masked_detector_registers_its_interim_sa_once():
    # 3DETR-m at full width: scannet_quick with the masked encoder, built as
    # scripts/scannet_masked_timing.py builds it
    tq = tc.scannet_quick()
    cfg = dataclasses.replace(tq.model, encoder=tc.EncoderConfig(kind="masked", dropout=0.3))
    net = Model3DETR(cfg, device="cpu")
    assert len(net.encoder_to_decoder_projection.layers) == 2  # one hidden layer
    sa = net.interim_downsample
    assert (sa.npoint, sa.radius, sa.nsample) == (1024, 0.4, 32)
    assert sa.layers[0].in_features == 3 + 256 and sa.layers[-1].out_features == 256
    keys = net.state_dict().keys()
    assert any(k.startswith("interim_downsample.") for k in keys)
    assert not any(k.startswith("encoder.interim") for k in keys)
