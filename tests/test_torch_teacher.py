"""The port's frozen RegionCLIP teacher against the JAX package's, on the CPU.

The same numpy inputs and the JAX package's own weights (its init, with
random BatchNorm statistics, carried over by `from_flax_teacher_variables`)
go through both.  Sizes are those of `tests/test_teacher_parity.py`: width
16, one block a stage, embed 32, pooler 6, 64 x 96 images, plus width 80
(RN50x4's channels) with one block a stage.

Tolerances: box projection, clamped to the image as the teacher uses it,
1e-4 px plus two f32 ulps (2.5e-7 relative: at 730 px one ulp is 6.1e-5 px,
and the frameworks sum the 3 x 3 products in different orders); unclamped,
2e-6 of the largest coordinate (off-image corners divide by depths near 0,
which magnifies those ulps); RoIAlign 1e-5 in f32 and 1e-2 of the
largest value in bf16 (the tent weights and each contraction rounded to
bf16); the backbone, the res5 head, the whole teacher, the positional-grid
resize and `make_teacher_fn` 1e-4 of the largest value in f32 (conv sums in
another order), cosine >= 0.999 per region in bf16; `QuantConv` on the same
input: the int32 products and the outputs equal (the same f32 operations in
the same order); `quantize_teacher_params`: int8 kernels equal, folded
scales and biases 1e-6 relative, activation scales 2e-2 relative (each is
the abs-max of a bf16 activation that earlier dynamically quantised layers
produced, in each framework's summation order); the int8 teacher from
JAX's quantised tree: cosine >= 0.999 per region.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ov3det.models import clip_resnet as jcr
from ov3det.models import regionclip as jrc
from ov3det.ops import roi_align as jroi
from ov3det.utils import calibration as jcal
from ov3det_torch.models import clip_resnet as tcr
from ov3det_torch.models import regionclip as trc
from ov3det_torch.models.convert import from_flax_teacher_variables
from ov3det_torch.ops import roi_align as troi
from ov3det_torch.utils import calibration as tcal
from tests.torch_parity import jax_quantize_teacher, to_numpy

TINY = dict(width=16, layers=(1, 1, 1, 1), embed_dim=32, pooler_resolution=6,
            pooler_scale=1.0 / 16.0, image_resolution=96)
WIDE = dict(TINY, width=80, embed_dim=640)
H, W = 64, 96


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_bn(tree: dict, rng) -> dict:
    """The tree with BatchNorm statistics off their init, so they matter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            out[k] = dict(v, mean=rng.uniform(-0.2, 0.2, v["mean"].shape).astype(np.float32),
                          var=rng.uniform(0.6, 1.6, v["var"].shape).astype(np.float32),
                          scale=rng.uniform(0.8, 1.2, v["scale"].shape).astype(np.float32))
        elif isinstance(v, dict):
            out[k] = _random_bn(v, rng)
        else:
            out[k] = v
    return out


def jax_variables(kw: dict, seed: int) -> dict:
    """The JAX teacher's f32 init, numpy leaves, random BN statistics."""
    teacher = jrc.RegionCLIPTeacher(**kw)
    v = jax.jit(lambda: teacher.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
                                     jnp.zeros((1, 1, 4))))()
    return _random_bn(to_numpy(v), np.random.default_rng(seed))


def jax_apply(kw: dict, variables: dict, images, boxes, **extra) -> np.ndarray:
    """The JAX teacher's features, as f32 numpy (one compiled program)."""
    teacher = jrc.RegionCLIPTeacher(**kw, **extra)
    return np.asarray(jax.jit(teacher.apply)(variables, jnp.asarray(images), jnp.asarray(boxes)),
                      np.float32)


def _boxes(rng, B, Q, w=W, h=H):
    x1 = rng.uniform(0, w - 36, (B, Q)).astype(np.float32)
    y1 = rng.uniform(0, h - 24, (B, Q)).astype(np.float32)
    return np.stack([x1, y1, x1 + rng.uniform(8, 34, (B, Q)), y1 + rng.uniform(8, 22, (B, Q))],
                    -1).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def tiny():
    return jax_variables(TINY, 3)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """JAX's quantised tree of `tiny` (default calibration batch)."""
    return jax_quantize_teacher(tiny, jrc.RegionCLIPTeacher(compute_dtype="int8", **TINY))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    return images, _boxes(rng, 2, 5)


# ------------------------------------------------------------ projection, RoIAlign
def test_project_boxes_to_image_matches_jax():
    rng = np.random.default_rng(1)
    B, Q = 3, 17
    centers = np.stack([rng.uniform(-1.5, 1.5, (B, Q)), rng.uniform(1.5, 5, (B, Q)),
                        rng.uniform(-0.8, 1.2, (B, Q))], -1).astype(np.float32)
    sizes = rng.uniform(0.2, 2.0, (B, Q, 3)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, (B, Q)).astype(np.float32)
    rtilt = np.stack([np.eye(3, dtype=np.float32) + rng.normal(0, 0.03, (3, 3)).astype(np.float32)
                      for _ in range(B)])
    K = np.tile(np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]], np.float32), (B, 1, 1))
    hw = np.array([[530, 730], [480, 640], [530, 730]], np.int32)
    for image_hw in (None, hw):
        want = jcal.project_boxes_to_image(
            jcal.SunrgbdCalibration(rtilt, K), jnp.asarray(centers), jnp.asarray(sizes),
            jnp.asarray(angles), None if image_hw is None else jnp.asarray(image_hw))
        got = tcal.project_boxes_to_image(
            tcal.SunrgbdCalibration(_t(rtilt), _t(K)), _t(centers), _t(sizes), _t(angles),
            None if image_hw is None else _t(image_hw))
        if image_hw is None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=2e-6 * np.abs(np.asarray(want)).max())
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7, atol=1e-4)
    assert (got[..., 2] >= got[..., 0]).all() and (got[..., 2] <= 730).all()
    assert (got[..., :2] > 0).any() and (got[..., 2:] < got.new_tensor([730, 530])).any()
    uvd = np.concatenate([rng.uniform(0, 700, (B, 5, 2)), rng.uniform(1, 5, (B, 5, 1))],
                         -1).astype(np.float32)
    jc, tc_ = jcal.SunrgbdCalibration(rtilt, K), tcal.SunrgbdCalibration(_t(rtilt), _t(K))
    np.testing.assert_allclose(tc_.project_image_to_upright_depth(_t(uvd)).numpy(),
                               np.asarray(jc.project_image_to_upright_depth(jnp.asarray(uvd))),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_matches_jax(dtype):
    rng = np.random.default_rng(9)
    B, Q = 3, 7
    feats = rng.normal(size=(B, 12, 16, 5)).astype(np.float32)
    boxes = _boxes(rng, B, Q, w=64, h=48)
    boxes[0, 0] = [-6.0, -4.0, 90.0, 70.0]  # taps clipped at every border
    boxes[1, 1] = [5.0, 5.0, 5.5, 6.5]  # tiny
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    flat_idx = np.repeat(np.arange(B), Q).astype(np.int32)
    want_b = np.asarray(jroi.roi_align_batched(jnp.asarray(feats, jdt), jnp.asarray(boxes),
                                               spatial_scale=0.25, output_size=4), np.float32)
    got_b = troi.roi_align_batched(_t(feats).to(tdt), _t(boxes), 0.25, 4)
    assert got_b.dtype == tdt and got_b.shape == (B, Q, 4, 4, 5)
    want_g = np.asarray(jroi.roi_align(jnp.asarray(feats, jdt), jnp.asarray(boxes.reshape(-1, 4)),
                                       jnp.asarray(flat_idx), spatial_scale=0.25, output_size=4),
                        np.float32)
    got_g = troi.roi_align(_t(feats).to(tdt), _t(boxes.reshape(-1, 4)), _t(flat_idx).long(),
                           0.25, 4)
    for got, want in ((got_b, want_b), (got_g, want_g)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        else:
            assert _rel(got.float().numpy(), want) <= 1e-2
    np.testing.assert_allclose(want_b.reshape(-1, 4, 4, 5), want_g,
                               atol=1e-5 if dtype == "float32" else 0.05)


# ------------------------------------------------------------ the towers
def test_backbone_and_res5_head_match_jax(tiny):
    params = tiny["params"]
    state = from_flax_teacher_variables(tiny)
    teacher = trc.RegionCLIPTeacher(device="cpu", **TINY).load(state)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax.jit(jcr.CLIPResNetBackbone(16, (1, 1, 1, 1)).apply)({"params": params["backbone"]},
                                                                  jnp.asarray(x))
    with torch.no_grad():
        got = teacher.backbone(_t(x))
    assert got.shape == (2, H // 16, W // 16, 256)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4
    pooled = rng.normal(size=(3, 6, 6, 256)).astype(np.float32)
    want = jax.jit(jcr.CLIPResNetRes5Head(16, 1, 32, 96).apply)({"params": params["roi_head"]},
                                                               jnp.asarray(pooled))
    with torch.no_grad():
        got = teacher.roi_head(_t(pooled))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("width", [16, 80])
def test_teacher_matches_jax(width, inputs, request):
    kw = TINY if width == 16 else WIDE
    variables = request.getfixturevalue("tiny") if width == 16 else jax_variables(kw, 17)
    images, boxes = inputs
    want = jax_apply(kw, variables, images, boxes)
    teacher = trc.RegionCLIPTeacher(device="cpu", **kw).load(from_flax_teacher_variables(variables))
    with torch.no_grad():
        got = teacher(_t(images), _t(boxes))
    assert got.dtype == torch.float32 and got.shape == (2, 5, kw["embed_dim"])
    assert _rel(got.numpy(), want) <= 1e-4

    # bf16: the port's cast of the f32 state equals the conversion of JAX's
    # cast tree, and the bf16 towers agree in direction
    jcast = to_numpy(jrc.cast_teacher_params(variables, "bfloat16"))
    state = trc.cast_teacher_params(from_flax_teacher_variables(variables), "bfloat16")
    theirs = from_flax_teacher_variables(jcast)
    assert set(state) == set(theirs)
    for k, v in theirs.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    assert state["roi_head.attnpool.c_proj.weight"].dtype == torch.float32
    assert state["backbone.stem.bn1.var"].dtype == torch.float32
    assert state["backbone.layer1.block0.conv2.weight"].dtype == torch.bfloat16
    want_bf = jax_apply(kw, jcast, images, boxes, compute_dtype="bfloat16")
    bf16 = trc.RegionCLIPTeacher(device="cpu", compute_dtype="bfloat16", **kw).load(state)
    with torch.no_grad():
        got_bf = bf16(_t(images), _t(boxes))
    assert _cos(got_bf.reshape(10, -1), want_bf.reshape(10, -1)).min() >= 0.999


@pytest.mark.parametrize("cin,cout,k,mode", [(8, 16, 3, "folded"), (40, 40, 3, "dynamic"),
                                             (320, 320, 3, "folded"), (2560, 640, 1, "folded"),
                                             (1280, 640, 1, "dynamic")])
def test_quant_conv_matches_jax(cin, cout, k, mode):
    rng = np.random.default_rng(cin + k)
    x = (rng.normal(size=(2, 7, 9, cin)) * rng.uniform(0.5, 3)).astype(np.float32)
    x_bf = jnp.asarray(x, jnp.bfloat16)  # the trunk's activations are bf16
    kq = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    scale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    params = {"kernel_q": kq, "scale": scale}
    if mode == "folded":
        params.update(a_scale=np.float32(np.abs(x).max() * 1.25 / 127),
                      bias=rng.normal(size=cout).astype(np.float32))
    jmod = jcr.QuantConv(cout, (k, k), k // 2, jnp.bfloat16, static_act=mode == "folded",
                         use_bias=mode == "folded")
    want, stats = jmod.apply({"params": params}, x_bf, mutable=["quant_stats"])
    tmod = tcr.QuantConv(cin, cout, k, k // 2, torch.bfloat16, mode)
    state = from_flax_teacher_variables({"params": {"c": params}})
    tmod.load_state_dict({k[2:]: v for k, v in state.items()})
    x_t = _t(x_bf.astype(jnp.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = tmod(x_t)
        xq, s_x = tmod.quantize(x_t)
        acc = tcr.int8_conv(xq, tmod.kernel_q, k, k // 2)
    # JAX's int32 accumulators on the same int8 input
    jxq = jnp.asarray(xq.numpy())
    dn = jax.lax.conv_dimension_numbers(jxq.shape, kq.shape, ("NHWC", "HWIO", "NHWC"))
    jacc = jax.lax.conv_general_dilated(jxq, jnp.asarray(kq), (1, 1), [(k // 2, k // 2)] * 2,
                                        dimension_numbers=dn, preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if mode == "dynamic":
        assert float(tmod.a_max) == float(np.asarray(stats["quant_stats"]["a_max"]).max())


def test_quantize_teacher_params_matches_jax(tiny, tiny_int8):
    teacher = trc.RegionCLIPTeacher(device="cpu", compute_dtype="int8", **TINY)
    ours = trc.quantize_teacher_params(from_flax_teacher_variables(tiny), "int8", teacher=teacher)
    theirs = from_flax_teacher_variables(tiny_int8)
    assert set(ours) == set(theirs)
    assert "backbone.stem.conv1.weight" in ours and "backbone.stem.bn1.var" in ours
    assert not any(".bn2." in k or ".downsample_bn." in k for k in ours)  # folded away
    n_a = 0
    for k, want in theirs.items():
        got = ours[k]
        assert got.dtype == want.dtype, k
        if k.endswith("kernel_q"):
            assert torch.equal(got, want), k
        elif k.endswith("a_scale"):
            n_a += 1
            assert abs(float(got) / float(want) - 1) <= 2e-2, (k, float(got), float(want))
        else:
            scale = want.float().abs().max().clamp(min=1e-30)
            assert float((got.float() - want.float()).abs().max() / scale) <= 1e-6, k
    assert n_a == 18  # the stem's conv2 and conv3, and 4 convs in each bottleneck
    teacher.load(ours)  # the int8 teacher takes the port's own quantised state


def test_int8_teacher_matches_jax(tiny, tiny_int8, inputs):
    images, boxes = inputs
    want = jax_apply(TINY, tiny_int8, images, boxes, compute_dtype="int8")
    teacher = trc.RegionCLIPTeacher(device="cpu", compute_dtype="int8", **TINY)
    teacher.load(from_flax_teacher_variables(tiny_int8))
    with torch.no_grad():
        got = teacher(_t(images), _t(boxes))
    assert got.dtype == torch.float32
    assert _cos(got.reshape(10, -1).numpy(), want.reshape(10, -1)).min() >= 0.999
    # the region head in chunks of 4 regions (2 images x 2 queries) gives the same
    chunked = trc.RegionCLIPTeacher(device="cpu", compute_dtype="int8", roi_chunk_regions=4, **TINY)
    chunked.load(from_flax_teacher_variables(tiny_int8))
    with torch.no_grad():
        np.testing.assert_allclose(chunked(_t(images), _t(boxes)).numpy(), got.numpy(),
                                   rtol=0, atol=1e-6)


def test_positional_grid_resize_matches_jax(inputs):
    rng = np.random.default_rng(4)
    for src, dst in (((2, 2), (3, 3)), ((5, 5), (3, 4)), ((3, 3), (6, 2))):
        grid = rng.normal(size=(*src, 7)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(grid), (*dst, 7), method="bilinear")
        got = tcr.resize_bilinear(_t(grid), *dst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # image_resolution 64: a 2 x 2 grid for the 3 x 3 tokens of a 6 x 6 pool
    kw = dict(TINY, image_resolution=64)
    variables = jax_variables(kw, 5)
    assert variables["params"]["roi_head"]["attnpool"]["positional_embedding"].shape == (5, 512)
    images, boxes = inputs
    want = jax_apply(kw, variables, images, boxes)
    teacher = trc.RegionCLIPTeacher(device="cpu", **kw).load(from_flax_teacher_variables(variables))
    with torch.no_grad():
        assert _rel(teacher(_t(images), _t(boxes)).numpy(), want) <= 1e-4


def _ov_batch_and_outputs(rng, B=2, L=3, Q=6):
    K = np.array([[52.0, 0, W / 2], [0, 52.0, H / 2], [0, 0, 1]], np.float32)
    batch = {"image": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "image_height": np.array([H, H - 10], np.int32)[:B],
             "image_width": np.array([W, W - 20], np.int32)[:B],
             "calib_Rtilt": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
             "calib_K": np.tile(K, (B, 1, 1))}
    outputs = {"center_unnormalized": np.stack(
                   [rng.uniform(-1, 1, (L, B, Q)), rng.uniform(2, 4, (L, B, Q)),
                    rng.uniform(-0.5, 0.8, (L, B, Q))], -1).astype(np.float32),
               "size_unnormalized": rng.uniform(0.3, 1.5, (L, B, Q, 3)).astype(np.float32),
               "angle_continuous": rng.uniform(-np.pi, np.pi, (L, B, Q)).astype(np.float32)}
    return batch, outputs


@pytest.mark.parametrize("per_layer", [False, True])
def test_make_teacher_fn_matches_jax(tiny, per_layer):
    batch, outputs = _ov_batch_and_outputs(np.random.default_rng(8))
    jfn = jrc.make_teacher_fn(jrc.RegionCLIPTeacher(**TINY), per_layer=per_layer)
    want = np.asarray(jax.jit(jfn)(tiny, {k: jnp.asarray(v) for k, v in batch.items()},
                                   {k: jnp.asarray(v) for k, v in outputs.items()}))
    teacher = trc.RegionCLIPTeacher(device="cpu", **TINY).load(from_flax_teacher_variables(tiny))
    out_t = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    got = trc.make_teacher_fn(teacher, per_layer=per_layer)({k: _t(v) for k, v in batch.items()},
                                                          out_t)
    assert got.shape == ((3, 2, 6, 32) if per_layer else (2, 6, 32)) and not got.requires_grad
    assert _rel(got.numpy(), want) <= 1e-4


def test_convert_torch_checkpoint_matches_jax(tmp_path, inputs):
    from tests.ref_oracle import CLIPModifiedResNet

    torch.manual_seed(5)
    net = CLIPModifiedResNet(layers=(1, 1, 1, 1), output_dim=32, width=16, image_resolution=96)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.6, 1.6)
    path = tmp_path / "regionclip_tiny.pth"
    torch.save({"model": {f"backbone.visual.{k}": v for k, v in net.state_dict().items()}}, path)
    jvars = jrc.convert_torch_checkpoint(str(path), layers=(1, 1, 1, 1))
    images, boxes = inputs
    want = jax_apply(TINY, jvars, images, boxes)
    state = trc.convert_torch_checkpoint(str(path), layers=(1, 1, 1, 1))
    ref = from_flax_teacher_variables(to_numpy(jvars))
    assert set(state) == set(ref)
    for k, v in ref.items():
        assert torch.equal(state[k], v), k
    teacher = trc.RegionCLIPTeacher(device="cpu", **TINY).load(state)
    with torch.no_grad():
        assert _rel(teacher(_t(images), _t(boxes)).numpy(), want) <= 1e-4
