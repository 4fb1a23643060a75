"""The port's modules and its whole eval forward against the JAX package,
with the same weights (carried across by `from_flax_variables`) and the same
inputs.  At f32 only the summation order differs: rtol/atol 1e-4.  At bf16
the two frameworks round at different places: 3e-2 on the logits, centers
and sizes.  FPS indices are exact at both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det import config as jc
from ov3det.datasets import make_batch as jax_make_batch
from ov3det.geometry import boxes as jboxes
from ov3det.models.mlp import GenericMLP as JGenericMLP
from ov3det.models.pointnet import PointnetSAModule as JSA
from ov3det.models.pos_embed import PositionEmbeddingCoords as JPos
from ov3det.models.transformer import TransformerDecoder as JDecoder
from ov3det.models.transformer import TransformerEncoderLayer as JEncLayer
from ov3det.ops import furthest_point_sample as jax_fps
from ov3det.ops import gather_points as jax_gather
from ov3det_torch import config as tc
from ov3det_torch.datasets.synthetic import make_batch
from ov3det_torch.geometry import boxes as tboxes
from ov3det_torch.models import convert
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.models.mlp import GenericMLP
from ov3det_torch.models.pointnet import PointnetSAModule
from ov3det_torch.models.pos_embed import PositionEmbeddingCoords
from ov3det_torch.models.transformer import TransformerDecoder, TransformerEncoderLayer
from tests import torch_parity as tp

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _port_state(sd_fn, prefix, *args):
    """Run a converter helper on one module's tree; strip the prefix."""
    return {k[len(prefix) + 1:]: _t(np.asarray(v, np.float32))
            for k, v in sd_fn(prefix, *args).items()}


# ------------------------------------------------------------ config, data
def _same_train_config(tq, jq):
    """Every field of the port's TrainConfig equals the JAX one's."""
    j, t = jq.model, tq.model
    for f in dataclasses.fields(t):
        if f.name in ("encoder", "decoder"):
            assert dataclasses.asdict(getattr(t, f.name)) == dataclasses.asdict(getattr(j, f.name))
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    # the training part: loss, matcher, optimiser, the teacher, the data
    # fields, the run
    assert dataclasses.asdict(tq.loss) == dataclasses.asdict(jq.loss)
    assert dataclasses.asdict(tq.optim) == dataclasses.asdict(jq.optim)
    # the teacher's fields but JAX's `image_size`, which nothing reads
    for f in dataclasses.fields(tq.teacher):
        assert getattr(tq.teacher, f.name) == getattr(jq.teacher, f.name), f.name
    for f in dataclasses.fields(tq.data):
        assert getattr(tq.data, f.name) == getattr(jq.data, f.name), f.name
    assert tq.max_epoch == jq.max_epoch


def test_config_rejects_what_is_not_ported():
    # the first-K ball query of reference checkpoints is ported: accepted, as
    # JAX's field; an unknown method is refused
    first_k = tc.ModelConfig(ball_query_method="first_k")
    assert first_k.ball_query_method == jc.ModelConfig(ball_query_method="first_k").ball_query_method
    with pytest.raises(ValueError):
        tc.ModelConfig(ball_query_method="knn")
    # the masked encoder is ported: accepted, with the reference's radii
    masked = tc.ModelConfig(encoder=tc.EncoderConfig(kind="masked", dropout=0.3))
    assert dataclasses.asdict(masked.encoder) == dataclasses.asdict(
        jc.EncoderConfig(kind="masked", dropout=0.3))
    assert masked.encoder.masking_radius == jc.EncoderConfig().masking_radius
    with pytest.raises(ValueError):
        tc.ModelConfig(encoder=tc.EncoderConfig(kind="masked", num_layers=2))
    _same_train_config(tc.sunrgbd_quick(), jc.sunrgbd_quick())
    _same_train_config(tc.scannet_quick(), jc.scannet_quick())


@pytest.mark.parametrize("kw", [dict(num_points=2048, num_angle_bin=12, num_semcls=20),
                                dict(num_points=1003, num_angle_bin=1, use_color=True)])
def test_synthetic_batches_are_bit_identical(kw):
    want = jax_make_batch(np.random.default_rng(11), batch_size=3, **kw)
    got = make_batch(np.random.default_rng(11), batch_size=3, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_box_geometry_matches_jax():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(2, 7, 3)).astype(np.float32)
    lo, hi = xyz.min(1) - 0.5, xyz.max(1) + 0.5
    _close(tboxes.shift_scale_points(_t(xyz), (_t(lo), _t(hi))),
           jboxes.shift_scale_points(jnp.asarray(xyz), (jnp.asarray(lo), jnp.asarray(hi))))
    ang = rng.uniform(-4, 4, size=(2, 7)).astype(np.float32)
    _close(tboxes.rotz_batch(_t(ang)), jboxes.rotz_batch(jnp.asarray(ang)))
    _close(tboxes.flip_axis_to_depth(_t(xyz)), jboxes.flip_axis_to_depth(jnp.asarray(xyz)))
    size = rng.uniform(0.1, 2, size=(2, 7, 3)).astype(np.float32)
    _close(tboxes.corners_from_upright_depth_param(_t(xyz), _t(size), _t(ang)),
           jboxes.corners_from_upright_depth_param(
               jnp.asarray(xyz), jnp.asarray(size), jnp.asarray(ang)))
    cls = rng.integers(0, 12, size=(2, 7))
    res = rng.uniform(-0.2, 0.2, size=(2, 7)).astype(np.float32)
    _close(tboxes.bin_to_angle(_t(cls), _t(res), 12),
           jboxes.bin_to_angle(jnp.asarray(cls), jnp.asarray(res), 12))


# ------------------------------------------------------------ modules
def _init(module, *args, **kw):
    variables = module.init(jax.random.PRNGKey(3), *args, **kw)
    variables = tp.to_numpy(variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = tp.randomize_batch_stats(
            variables["batch_stats"], np.random.default_rng(4))
    return variables


def test_generic_mlp_eval_bn_matches_flax():
    x = np.random.default_rng(0).normal(size=(2, 10, 24)).astype(np.float32)
    jm = JGenericMLP(hidden_dims=[32, 32], output_dim=16, norm="bn",
                     output_use_norm=True, output_use_activation=True)
    v = _init(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = GenericMLP(24, [32, 32], 16, norm="bn", output_use_norm=True,
                   output_use_activation=True).eval()
    m.load_state_dict(_port_state(convert._mlp, "m", v["params"], v["batch_stats"]))
    _close(m(_t(x)), want)


@pytest.mark.parametrize("pos_type", ["fourier", "sine"])
def test_position_embedding_matches_flax(pos_type):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-2, 2, size=(2, 50, 3)).astype(np.float32)
    lo, hi = xyz.min(1), xyz.max(1)
    jm = JPos(d_pos=64, pos_type=pos_type)
    args = (jnp.asarray(xyz), (jnp.asarray(lo), jnp.asarray(hi)))
    v = _init(jm, *args)
    m = PositionEmbeddingCoords(64, pos_type=pos_type)
    if pos_type == "fourier":
        m.load_state_dict({"gauss_B": _t(v["params"]["gauss_B"])})
    _close(m(_t(xyz), (_t(lo), _t(hi))), jm.apply(v, *args))


@pytest.mark.parametrize("channels", [0, 3])
def test_pointnet_sa_matches_flax(channels):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1, 1, size=(2, 1024, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 1024, channels)).astype(np.float32) if channels else None
    jm = JSA(npoint=128, radius=0.3, nsample=16, mlp_dims=(32, 64), fps_shards=1)
    jargs = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    v = _init(jm, *jargs)
    want_xyz, want_feats, want_inds = jm.apply(v, *jargs)
    m = PointnetSAModule(128, 0.3, 16, channels, (32, 64)).eval()
    m.load_state_dict(_port_state(convert._mlp, "m", v["params"], v["batch_stats"]))
    new_xyz, new_feats, inds = m(_t(xyz), None if feats is None else _t(feats))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(want_inds))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    _close(new_feats, want_feats)


@pytest.mark.parametrize("tokens", [128, 1024])
def test_encoder_layer_matches_flax(tokens, monkeypatch):
    # 1024 tokens: 1M query-key pairs, the kernel's dispatch (the JAX side
    # forced through its Pallas kernel, the port's CPU tensors through the
    # plain version); 128 tokens: the plain matmul + softmax path
    monkeypatch.setenv("OV3DET_ATTENTION", "fused" if tokens == 1024 else "xla")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, tokens, 64)).astype(np.float32)
    pos = rng.normal(size=(2, tokens, 64)).astype(np.float32)
    jm = JEncLayer(dim=64, num_heads=4, ffn_dim=96)
    v = _init(jm, jnp.asarray(x), pos=jnp.asarray(pos))
    want = jm.apply(v, jnp.asarray(x), pos=jnp.asarray(pos))
    m = TransformerEncoderLayer(64, 4, 96).eval()
    m.load_state_dict(_port_state(convert._transformer_layer, "m", v["params"]))
    _close(m(_t(x), pos=_t(pos)), want)


@pytest.mark.parametrize("batch", [1, 2])
def test_attention_kernel_gets_contiguous_heads(batch, monkeypatch):
    # the CUDA kernel takes contiguous (BH, N, D) tensors only; at batch 1
    # the head split is a strided view unless it is copied
    from ov3det_torch.models import transformer

    seen, real = [], transformer.fused_attention

    def spy(q, k, v, *args):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, *args)

    monkeypatch.setattr(transformer, "fused_attention", spy)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(batch, 1024, 64)).astype(np.float32))
    transformer.MultiheadAttention(64, 4)(x, x, x)
    assert seen == [True]


def test_decoder_matches_flax():
    rng = np.random.default_rng(4)
    tgt = np.zeros((2, 16, 64), np.float32)
    mem, qpos = (rng.normal(size=s).astype(np.float32) for s in ((2, 128, 64), (2, 16, 64)))
    mpos = rng.normal(size=(2, 128, 64)).astype(np.float32)
    jm = JDecoder(num_layers=2, dim=64, num_heads=4, ffn_dim=80)
    jargs = (jnp.asarray(tgt), jnp.asarray(mem))
    jkw = dict(query_pos=jnp.asarray(qpos), mem_pos=jnp.asarray(mpos))
    v = _init(jm, *jargs, **jkw)
    want = jm.apply(v, *jargs, **jkw)
    m = TransformerDecoder(2, 64, 4, 80).eval()
    sd = {}
    for name, sub in v["params"].items():
        if name == "LayerNorm_0":  # the final norm
            sd.update(convert._norm("norm", sub))
        else:
            sd.update(convert._transformer_layer(f"layers.{name.rsplit('_', 1)[1]}", sub))
    sd = {k: _t(np.asarray(w, np.float32)) for k, w in sd.items()}
    m.load_state_dict(sd)
    got = m(_t(tgt), _t(mem), query_pos=_t(qpos), mem_pos=_t(mpos))
    assert got.shape == (2, 2, 16, 64)
    _close(got, want)


# ------------------------------------------------------------ whole slice
@pytest.fixture(scope="module")
def bridged():
    """One JAX init (f32 config; the variables are the same at bf16)."""
    import os

    os.environ["OV3DET_BALLGROUP"] = "pallas"
    try:
        batch = tp.make_batch(seed=0)
        jcfg, _ = tp.configs("float32")
        _, variables = tp.jax_model_and_variables(jcfg, batch)
    finally:
        del os.environ["OV3DET_BALLGROUP"]
    return batch, variables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_eval_forward_matches_jax(bridged, dtype):
    from ov3det.models import Model3DETR as JModel

    batch, variables = bridged
    jcfg, tcfg = tp.configs(dtype)
    want = tp.jax_forward(JModel(jcfg), variables, batch)
    model = Model3DETR(tcfg, device="cpu")
    model.load_state_dict(convert.from_flax_variables(variables))
    with torch.inference_mode():
        got = model({k: _t(batch[k]) for k in tp.INPUT_KEYS})

    # FPS query seeds: exact at any compute dtype
    pre_inds = jax_fps(jnp.asarray(batch["point_clouds"]), tp.NPRE, shards=1)
    pre_xyz = jax_gather(jnp.asarray(batch["point_clouds"]), pre_inds)
    want_qinds = np.asarray(jax_fps(pre_xyz, tp.NQUERY, shards=1))
    np.testing.assert_array_equal(got["query_inds"].numpy(), want_qinds)
    np.testing.assert_array_equal(got["query_xyz"].numpy(), want["query_xyz"])

    assert set(want) <= set(got)
    if dtype == "float32":
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            _close(got[key], w)
    else:
        for key in ("sem_cls_logits", "center_normalized", "size_normalized"):
            assert got[key].dtype == getattr(torch, str(want[key].dtype)), key
            _close(got[key], want[key].astype(np.float32), rtol=0, atol=3e-2)


# ------------------------------------------------------------ training mode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_statistics_match_flax(dtype):
    import flax.linen as fnn

    from ov3det_torch.models.mlp import BatchNorm

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 10, 24)) * 1.5 + 0.5).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = tp.to_numpy(bn.init(jax.random.PRNGKey(0), jx))
    v["params"]["scale"] = rng.uniform(0.5, 2, 24).astype(np.float32)
    v["params"]["bias"] = rng.normal(size=24).astype(np.float32)
    v["batch_stats"] = tp.randomize_batch_stats(v["batch_stats"], rng)
    want, upd = bn.apply(v, jx, mutable=["batch_stats"])
    m = BatchNorm(24).train()
    m.load_state_dict(_port_state(convert._norm, "m", v["params"], v["batch_stats"]))
    got = m(_t(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, rtol=0, atol=1e-6)
    _close(m.running_mean, upd["batch_stats"]["mean"], rtol=0, atol=1e-6)
    _close(m.running_var, upd["batch_stats"]["var"], rtol=0, atol=1e-6)


def test_encoder_layer_training_gradients_match_flax(monkeypatch):
    # 1024 tokens: the fused attention, forward and backward; the JAX side
    # through its Pallas kernels and custom VJP in interpret mode
    monkeypatch.setenv("OV3DET_ATTENTION", "fused")
    rng = np.random.default_rng(8)
    x, pos = (rng.normal(size=(2, 1024, 64)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(2, 1024, 64)).astype(np.float32)
    jm = JEncLayer(dim=64, num_heads=4, ffn_dim=96, dropout=0.0)
    v = _init(jm, jnp.asarray(x), pos=jnp.asarray(pos))

    def loss(params, x, pos):
        out = jm.apply({"params": params}, x, pos=pos, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(v["params"], jnp.asarray(x), jnp.asarray(pos))
    m = TransformerEncoderLayer(64, 4, 96, dropout=0.0).train()
    m.load_state_dict(_port_state(convert._transformer_layer, "m", v["params"]))
    tx, tpos = _t(x).requires_grad_(), _t(pos).requires_grad_()
    (m(tx, pos=tpos, generator=torch.Generator()) * _t(w)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(tx.grad, jgrads[1], **tol)
    _close(tpos.grad, jgrads[2], **tol)
    want = _port_state(convert._transformer_layer, "m", tp.to_numpy(jgrads[0]))
    for name, p in m.named_parameters():
        _close(p.grad, want[name].numpy(), **tol)


def test_decoder_attention_dropout_mask_is_shared_across_batch_and_heads():
    # flax drops `broadcast_dropout` for the decoder's attention function,
    # so nn.dot_product_attention draws ONE (NQ, NK) mask; q = 0 makes every
    # weight 1/NK and v = identity reads each weight back
    from ov3det_torch.models.transformer import dot_product_attention

    B, H, NQ, NK, rate = 3, 4, 16, 32, 0.3
    q = torch.zeros(B, NQ, H, NK)
    eye = torch.eye(NK)[None, :, None, :].expand(B, NK, H, NK)
    out = dot_product_attention(q, q[:, :1].expand(B, NK, H, NK), eye, rate,
                                torch.Generator().manual_seed(0))  # (B, NQ, H, NK)
    kept = out != 0
    assert (kept == kept[:1, :, :1]).all()  # the same mask in every batch row and head
    assert 0.5 < kept.float().mean() < 0.9
    np.testing.assert_allclose(out[kept].numpy(), 1 / NK / (1 - rate), rtol=1e-6)

    # the encoder's residual dropout is per element instead
    from ov3det_torch.models.mlp import dropout
    mask = dropout(torch.ones(B, NQ, 64), 0.3, torch.Generator().manual_seed(0)) != 0
    assert not (mask == mask[:1]).all()


def test_training_forward_needs_a_generator_and_detaches_probabilities():
    _, tcfg = tp.configs("float32")
    model = Model3DETR(tcfg, device="cpu").train()
    batch = tp.make_batch(seed=1)
    inputs = {k: _t(batch[k]) for k in tp.INPUT_KEYS}
    with pytest.raises(ValueError, match="Generator"):
        model(inputs)
    out = model(inputs, torch.Generator().manual_seed(0))
    assert out["sem_cls_logits"].requires_grad
    assert not out["sem_cls_prob"].requires_grad and not out["objectness_prob"].requires_grad
    again = model(inputs, torch.Generator().manual_seed(0))  # the same draws, the same output
    torch.testing.assert_close(again["sem_cls_logits"], out["sem_cls_logits"], rtol=0, atol=0)
