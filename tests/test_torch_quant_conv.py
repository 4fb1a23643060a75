"""The teacher's W8A8 trunk conv (`ov3det_torch.ops.kernels.quant_conv`) and
the tower restructured around it, on the CPU, against the JAX package.

Every comparison is bit for bit (the same f32 operations in the same order):
  * `quant_conv_plain` against JAX's `QuantConv` in its three modes, at
    C_in 8, 40 and 80, C_out 16 and 40, 1 x 1 and 3 x 3 kernels, on odd
    images of 15 and 63 pixels;
  * a JAX "folded" `Bottleneck` (stride 1 with and without a downsample,
    stride 2) against the port's chained block (`Bottleneck.chain`, each
    epilogue carrying the residual, the ReLU and the next quantise).  At
    stride 2 JAX's block runs with an average pool that sums in f32:
    XLA on the CPU sums a bf16 window in bf16, rounding after each add,
    where the port (`F.avg_pool2d`, and the kernel) sums in f32 and rounds
    once, as XLA on the TPU does.  Against JAX's own bf16 pool the block
    stays within 2e-2 of the largest output (here 0.6% and 0.9%: a pooled
    value one bf16 ulp off moves an int8 code by one now and then, and a
    quarter of the outputs by an ulp or more);
  * the plain pool and quantise (`pool_quantize_plain`) against JAX's
    `avg_pool` (f32, and bf16 summed in f32) then `QuantConv`'s quantise;
  * the fused int8 teacher (`fused=True`: the chain) against the unfused
    module path (`fused=False`) from the same state, the calibration too.
"""
import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ov3det.models import clip_resnet as jcr
from ov3det_torch.models import clip_resnet as tcr
from ov3det_torch.models import regionclip as trc
from ov3det_torch.models.convert import from_flax_teacher_variables
from ov3det_torch.ops.kernels import quant_conv as qc

TINY = dict(width=16, layers=(2, 1, 2, 2), embed_dim=32, pooler_resolution=6,
            pooler_scale=1.0 / 16.0, image_resolution=96)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _jax_quantize(x, s):
    """`QuantConv.__call__`'s quantise (`ov3det/models/clip_resnet.py:116`)."""
    return jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127, 127).astype(jnp.int8)


@pytest.mark.parametrize("mode", ["folded", "static", "dynamic"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", [16, 40])
@pytest.mark.parametrize("cin", [8, 40, 80])
@pytest.mark.parametrize("image", [(1, 3, 5), (1, 7, 9)])
def test_quant_conv_plain_matches_jax(image, cin, cout, k, mode):
    rng = np.random.default_rng(cin * 7 + cout + k)
    x = _bf16(rng.normal(size=(*image, cin)) * rng.uniform(0.5, 3))
    kq = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    scale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    params = {"kernel_q": kq, "scale": scale}
    if mode != "dynamic":
        params["a_scale"] = np.float32(np.abs(x).max() * 1.25 / 127)
    if mode == "folded":
        params["bias"] = rng.normal(size=cout).astype(np.float32)
    jmod = jcr.QuantConv(cout, (k, k), k // 2, jnp.bfloat16, static_act=mode != "dynamic",
                         use_bias=mode == "folded")
    # op by op: under jit XLA may turn the dynamic scale's / 127 into a product
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    tmod = tcr.QuantConv(cin, cout, k, k // 2, torch.bfloat16, mode)
    state = from_flax_teacher_variables({"params": {"c": params}})
    tmod.load_state_dict({key[2:]: v for key, v in state.items()})
    x_t = _t(x).to(torch.bfloat16)
    with torch.no_grad():
        xq, s_x = tmod.quantize(x_t)
        bias = tmod.bias if mode == "folded" else None
        got, none = qc.quant_conv_plain(xq, tmod.kernel_q, k, k // 2, s_x, tmod.scale, bias)
        again, _ = qc.quant_conv(xq, tmod.kernel_q, k, k // 2, s_x, tmod.scale, bias)
    assert none is None and got.dtype == torch.bfloat16 and got.shape == (*image, cout)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(again, got)  # the wrapper on CPU tensors is the plain version


def _bottleneck_params(jblock, x, rng) -> dict:
    """Random "folded" parameters for `jblock`: int8 kernels, per-channel
    scales that keep each conv's output near unit size, BN-folded biases,
    activation scales of 4 sigma."""
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    params = {}
    for name, leaves in shapes["params"].items():
        kq = leaves["kernel_q"].shape
        fan_in = kq[0] * kq[1] * kq[2]
        params[name] = {
            "kernel_q": rng.integers(-127, 128, kq, dtype=np.int8),
            "scale": (rng.uniform(0.5, 1.5, kq[3]) / (73.6 * np.sqrt(fan_in))).astype(np.float32),
            "bias": rng.normal(0, 0.3, kq[3]).astype(np.float32),
            "a_scale": np.float32(rng.uniform(3.5, 4.5) / 127),
        }
    return params


def _f32_sum_pool(x, window, stride):
    """flax's avg_pool with the window summed in f32 and rounded once."""
    return nn.avg_pool(x.astype(jnp.float32), (window, window),
                       strides=(stride, stride)).astype(x.dtype)


@pytest.mark.parametrize("inplanes,planes,stride", [(64, 16, 1), (32, 16, 1), (64, 16, 2),
                                                    (48, 24, 2)])
def test_folded_bottleneck_matches_jax(inplanes, planes, stride, monkeypatch):
    rng = np.random.default_rng(inplanes + planes + stride)
    x = _bf16(np.maximum(rng.normal(size=(2, 7, 9, inplanes)), 0) * 1.5)
    jblock = jcr.Bottleneck(planes, stride, jnp.bfloat16, quant="folded")
    params = _bottleneck_params(jblock, x, rng)
    apply = lambda: np.asarray(jax.jit(jblock.apply)(  # noqa: E731
        {"params": params}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    own_pool = apply()
    monkeypatch.setattr(jcr, "_avg_pool", _f32_sum_pool)
    want = apply()

    tblock = tcr.Bottleneck(inplanes, planes, stride, torch.bfloat16, "folded")
    assert tblock.chained and tblock.has_downsample == (inplanes != 4 * planes or stride > 1)
    tblock.load_state_dict(from_flax_teacher_variables({"params": params}))
    unfused = tcr.Bottleneck(inplanes, planes, stride, torch.bfloat16, "folded", fused=False)
    unfused.load_state_dict(tblock.state_dict())
    x_t = _t(x).to(torch.bfloat16)
    with torch.no_grad():
        got = tblock(x_t)
        plain = unfused(x_t)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (want > 0).mean() > 0.2  # the ReLU leaves a signal
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, plain)
    if stride == 1:
        np.testing.assert_array_equal(own_pool, want)
    else:
        assert np.abs(own_pool - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [1, 2])
def test_pool_quantize_plain_matches_jax(pool, dtype):
    rng = np.random.default_rng(pool)
    x = (rng.normal(size=(2, 9, 11, 24)) * np.exp(rng.uniform(-3, 3, (2, 9, 11, 24))))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xj = jnp.asarray(x, jdt)
    scales = [np.float32(0.05), np.float32(0.013)]
    pooled = _f32_sum_pool(xj, pool, pool) if pool > 1 else xj  # for f32: JAX's own pool
    want = [np.asarray(_jax_quantize(pooled, s)) for s in scales]
    got = qc.pool_quantize_plain(_t(np.asarray(xj.astype(jnp.float32))).to(tdt), pool,
                                 [_t(s) for s in scales])
    assert [g.shape for g in got] == [(2, 9 // pool, 11 // pool, 24)] * 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w)
    assert all(-127 <= int(g.min()) and int(g.max()) <= 127 for g in got)
    assert int(got[1].abs().max()) == 127  # the smaller scale clips


def _random_bn_state(state: dict, rng) -> dict:
    """The teacher's f32 state with its BatchNorm statistics off their init."""
    out = dict(state)
    for key, v in state.items():
        module, leaf = key.rsplit(".", 1)
        if ".bn" in f".{module.rsplit('.', 1)[-1]}" or module.endswith("downsample_bn"):
            lo, hi = {"scale": (0.8, 1.2), "bias": (-0.2, 0.2), "mean": (-0.2, 0.2),
                      "var": (0.6, 1.6)}[leaf]
            out[key] = torch.from_numpy(rng.uniform(lo, hi, v.shape).astype(np.float32))
    return out


def test_fused_int8_teacher_equals_unfused(monkeypatch):
    """The chained tower (2 blocks in layer1, 3 and 4; res5 in chunks)
    against the unfused module path: the calibration's activation scales
    and the int8 features equal bit for bit."""
    fused = trc.RegionCLIPTeacher(device="cpu", compute_dtype="int8", roi_chunk_regions=4, **TINY)
    unfused = fused.clone(fused=False)
    assert fused.hparams["fused"] and not unfused.hparams["fused"]
    state = _random_bn_state(trc.init_teacher_state(fused, seed=4), np.random.default_rng(4))
    q_fused = trc.quantize_teacher_params(state, "int8", teacher=fused)
    q_unfused = trc.quantize_teacher_params(state, "int8", teacher=unfused)
    assert set(q_fused) == set(q_unfused)
    for key, v in q_fused.items():
        assert torch.equal(v, q_unfused[key]), key
    fused.load(q_fused)
    unfused.load(q_unfused)
    assert fused.backbone.layer1.block0.chained and not unfused.backbone.layer1.block0.chained
    rng = np.random.default_rng(5)
    images = _t(rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8))
    x1 = rng.uniform(0, 60, (2, 5)).astype(np.float32)
    y1 = rng.uniform(0, 40, (2, 5)).astype(np.float32)
    boxes = _t(np.stack([x1, y1, x1 + rng.uniform(8, 34, (2, 5)), y1 + rng.uniform(8, 22, (2, 5))],
                        -1).astype(np.float32))
    calls = {"quant_conv": 0, "pool_quantize": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tcr, "quant_conv", counted("quant_conv", tcr.quant_conv))
    monkeypatch.setattr(tcr, "pool_quantize", counted("pool_quantize", tcr.pool_quantize))
    with torch.no_grad():
        got = fused(images, boxes)
        # the backbone's 2 + 7 + 4 + 7 convs and res5's 7 in each of 3 chunks;
        # the passes: the stem's 2, 2 in layer2's and layer3's stride-2
        # blocks, 3 a chunk (the RoI features, two pooled inputs)
        assert calls == {"quant_conv": 20 + 3 * 7, "pool_quantize": 2 + 4 + 3 * 3}
        want = unfused(images, boxes)
        assert calls == {"quant_conv": 41, "pool_quantize": 15}  # the unfused path calls neither
        feat = fused.backbone(torch.zeros(1, 64, 96, 3, dtype=torch.bfloat16))
    assert got.shape == (2, 5, 32) and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert feat.dtype == torch.bfloat16 and feat.shape == (1, 4, 6, 256)


def test_chain_into_a_stride_1_downsample():
    """`run_blocks` on a chain whose second block reads its input twice
    unpooled (conv1 and a stride-1 downsample, two int8 forms from one
    quantise pass after the first block): the unfused blocks' bits."""
    rng = np.random.default_rng(8)
    blocks, plain = [], []
    for inplanes, planes in ((32, 8), (32, 16)):
        a = tcr.Bottleneck(inplanes, planes, 1, torch.bfloat16, "folded")
        b = tcr.Bottleneck(inplanes, planes, 1, torch.bfloat16, "folded", fused=False)
        state = {}
        for key, v in a.state_dict().items():
            if v.dtype == torch.int8:
                state[key] = torch.from_numpy(rng.integers(-127, 128, v.shape, dtype=np.int8))
            elif key.endswith("a_scale"):
                state[key] = torch.tensor(np.float32(4 / 127))
            elif key.endswith("bias"):
                state[key] = torch.from_numpy(rng.normal(0, 0.3, v.shape).astype(np.float32))
            else:
                fan_in = a.get_submodule(key.rsplit(".", 1)[0]).kernel_q.shape[1]
                state[key] = torch.from_numpy((rng.uniform(0.5, 1.5, v.shape)
                                               / (73.6 * np.sqrt(fan_in))).astype(np.float32))
        a.load_state_dict(state)
        b.load_state_dict(state)
        blocks.append(a)
        plain.append(b)
    assert not blocks[0].has_downsample and len(blocks[1].in_scales()) == 2
    x = _t(np.maximum(rng.normal(size=(2, 5, 7, 32)), 0).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = tcr.run_blocks(blocks, x)
        want = plain[1](plain[0](x))
    assert got.shape == (2, 5, 7, 64) and (got > 0).float().mean() > 0.2
    assert torch.equal(got, want)


def test_static_tower_fused_equals_unfused():
    """"static" mode keeps its BatchNorm modules and is not chained; with
    `fused` its product goes through `quant_conv` (the plain version here)
    and gives the unfused module path's bits."""
    rng = np.random.default_rng(6)
    a = tcr.ResNetStage(32, 8, 2, 2, torch.bfloat16, "static")
    b = tcr.ResNetStage(32, 8, 2, 2, torch.bfloat16, "static", fused=False)
    assert not a.block0.chained
    state = {}
    for key, v in a.state_dict().items():
        if v.dtype == torch.int8:
            state[key] = torch.from_numpy(rng.integers(-127, 128, v.shape, dtype=np.int8))
        elif key.endswith("a_scale"):
            state[key] = torch.tensor(np.float32(rng.uniform(0.02, 0.05)))
        elif ".conv" in key or "downsample_conv" in key:  # the dequant's per-channel scale
            state[key] = torch.from_numpy(rng.uniform(1e-3, 2e-2, v.shape).astype(np.float32))
        else:  # BatchNorm statistics and affine
            state[key] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    a.load_state_dict(state)
    b.load_state_dict(state)
    x = _t(rng.normal(size=(2, 6, 8, 32)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got, want = a(x), b(x)
    assert got.shape == (2, 3, 4, 32) and torch.equal(got, want)


def test_wrappers_check_their_inputs():
    """CPU tensors take the plain versions; a tensor on neither device, a
    kernel of the wrong shape, a padding other than "same" and a call that
    writes nothing raise."""
    rng = np.random.default_rng(7)
    xq = _t(rng.integers(-127, 128, (1, 3, 5, 16), dtype=np.int8))
    kq = _t(rng.integers(-127, 128, (8, 9 * 16), dtype=np.int8))
    s, scale = torch.tensor(0.02), torch.full((8,), 0.01)
    y, q = qc.quant_conv(xq, kq, 3, 1, s, scale, relu=True, s_next=torch.tensor(0.05))
    y2, q2 = qc.quant_conv_plain(xq, kq, 3, 1, s, scale, relu=True, s_next=torch.tensor(0.05))
    assert torch.equal(y, y2) and torch.equal(q, q2) and q.dtype == torch.int8
    assert y.min() >= 0
    x = torch.randn(1, 4, 6, 16)
    assert all(torch.equal(g, w) for g, w in zip(qc.pool_quantize(x, 2, [s, s * 2]),
                                                  qc.pool_quantize_plain(x, 2, [s, s * 2])))
    with pytest.raises(ValueError):
        qc.quant_conv(xq.to("meta"), kq.to("meta"), 3, 1, s, scale)
    with pytest.raises(ValueError):
        qc.pool_quantize(x.to("meta"), 2, [s])
    with pytest.raises(ValueError):
        qc.quant_conv(xq, kq, 1, 0, s, scale)  # the kernel holds 3 x 3 taps
    with pytest.raises(ValueError):
        qc.quant_conv(xq, kq, 3, 0, s, scale)  # not "same"
    with pytest.raises(ValueError):
        qc.quant_conv(xq, kq, 3, 1, s, scale, out_bf16=False)
    with pytest.raises(ValueError):
        qc.pool_quantize(x, 3, [s])
