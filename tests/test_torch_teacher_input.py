"""The teacher's input end on the CPU: the normalisation and the stem's bn1
and ReLU folded into the quantise pass, against the JAX package.

- `normalise_plain` equals JAX's `(images - _PIXEL_MEAN) * (1.0 /
  _PIXEL_STD)` cast to the compute dtype bit for bit (NaN to NaN), on uint8
  and f32 canvases (NaN, infinities, -0 among the f32 ones), into bf16 and
  f32;
- the folded pass's plain version (`pool_quantize_plain(..., affine=)`: the
  stem's `FrozenBatchNorm.affine()`, relu(x * w + b) in the tensor's dtype,
  then `QuantConv`'s quantise) equals flax's `FrozenBatchNorm`, `nn.relu`
  and the quantise of `ov3det/models/clip_resnet.py:116` bit for bit, at
  C 40, in bf16 and f32, with NaN, infinities and -0, and on values whose
  quotient by the scale lies on a half-integer;
- both kernels emulated in numpy in their order (the normalise pass's
  pieces of 16 values, the first channel of piece t being t mod 3 and the
  constants rotated to it, the tail a value a thread; the folded pass's
  pieces of `pass_launch`, the channel of a piece's first value from
  `FastDiv` by C and advancing a value with a wrap at C, the product and the
  sum each rounded to the input type, the ReLU keeping NaN, a NaN quantised
  to 0 as the plain version's conversion gives it, the quantise by the
  reciprocal with the division's redo) equal the plain versions bit for
  bit, and the arithmetic they emulate is read from the sources;
- the wrappers on CPU tensors take the plain versions; the affine is
  refused at pool 2 and on the first design; a tiny int8 teacher's chained
  stem hands conv1's raw output on, and the fused teacher equals the
  unfused module path bit for bit.

The kernels themselves run only on the card, where chip_smoke.py
(`check_teacher_input`) holds them against these plain versions bit for
bit on an OV batch's own inputs.
"""
from pathlib import Path

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.models import clip_resnet as jcr
from ov3det.models import regionclip as jrc
from ov3det_torch.models import clip_resnet as tcr
from ov3det_torch.models import regionclip as trc
from ov3det_torch.ops.kernels import normalise as nk
from ov3det_torch.ops.kernels import quant_conv as qc
from tests.test_torch_pool_quantize_hopper import _bf16_round, _codes, fast_div, fast_div_apply

CSRC = Path(nk.__file__).resolve().parents[2] / "csrc"
F32 = np.float32
OV_CANVASES = (8, 530, 730, 3)  # an OV batch
STEM = (8, 265, 365, 40)  # conv1's output at that batch


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _same(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit for bit, NaN to NaN (of any payload), in f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------------------ the normalisation
def _canvases(rng, shape, kind: str) -> np.ndarray:
    if kind == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    x = rng.uniform(-20, 275, shape).astype(np.float32)
    flat = x.reshape(-1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 255.0, 1e-45, -1e30], np.float32)
    flat[rng.choice(flat.size, 64, replace=False)] = np.resize(specials, 64)
    return x


def test_the_port_keeps_jax_constants():
    np.testing.assert_array_equal(trc._PIXEL_MEAN, jrc._PIXEL_MEAN)
    np.testing.assert_array_equal(trc._INV_STD, np.float32(1.0) / jrc._PIXEL_STD)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_normalise_plain_equals_jax(kind, out):
    rng = np.random.default_rng(len(kind) + len(out))
    images = _canvases(rng, (2, 37, 53, 3), kind)
    want = (jnp.asarray(images) - jrc._PIXEL_MEAN) * (1.0 / jrc._PIXEL_STD)
    if out == "bfloat16":
        want = want.astype(jnp.bfloat16)
    got = nk.normalise_plain(torch.from_numpy(images), torch.from_numpy(trc._PIXEL_MEAN),
                             torch.from_numpy(trc._INV_STD),
                             torch.bfloat16 if out == "bfloat16" else None)
    assert got.dtype == (torch.bfloat16 if out == "bfloat16" else torch.float32)
    _same(_f32(got), np.asarray(want.astype(jnp.float32)))


def emulate_normalise(images: np.ndarray, mean: np.ndarray, inv_std: np.ndarray,
                      bf16: bool) -> np.ndarray:
    """`normalise_kernel` in numpy: piece t holds flat values 16 t .. 16 t +
    15, its constants rotated to channel t mod 3 and value e taking rotation
    e mod 3; the values past the last piece take channel i mod 3."""
    flat = images.reshape(-1).astype(np.float32)
    n = flat.size
    pieces = n // nk.VEC
    out = np.empty(n, np.float32)
    t = np.arange(pieces)
    c0 = t % 3
    rot = (c0[:, None] + np.arange(3)) % 3  # mr[j] = m[(c0 + j) % 3]
    mr, sr = mean[rot], inv_std[rot]
    e = np.arange(nk.VEC)
    v = flat[:pieces * nk.VEC].reshape(pieces, nk.VEC)
    with np.errstate(invalid="ignore"):
        out[:pieces * nk.VEC] = ((v - mr[:, e % 3]) * sr[:, e % 3]).reshape(-1)
        i = np.arange(pieces * nk.VEC, n)
        out[i] = (flat[i] - mean[i % 3]) * inv_std[i % 3]
    out = out.astype(np.float32)
    return _bf16_round(out) if bf16 else out


@pytest.mark.parametrize("shape", [(2, 37, 53, 3), (1, 5, 7, 3), (3, 4, 4, 3), (1, 1, 1, 3)])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_emulated_normalise_equals_the_plain_version(shape, kind):
    rng = np.random.default_rng(sum(shape))
    images = _canvases(rng, shape, kind) if np.prod(shape) >= 64 else \
        rng.integers(0, 256, shape).astype(np.uint8 if kind == "uint8" else np.float32)
    for bf16 in (True, False):
        want = nk.normalise_plain(torch.from_numpy(images), torch.from_numpy(trc._PIXEL_MEAN),
                                  torch.from_numpy(trc._INV_STD),
                                  torch.bfloat16 if bf16 else None)
        got = emulate_normalise(images, trc._PIXEL_MEAN, trc._INV_STD, bf16)
        _same(got, _f32(want).reshape(-1))


def test_normalise_launch_at_the_ov_batch():
    images = torch.zeros(OV_CANVASES, dtype=torch.uint8)
    launch = nk.normalise_launch(images)
    assert launch["pieces"] * nk.VEC == images.numel() and launch["tail"] == 0
    assert nk.normalise_launch(torch.zeros((1, 5, 7, 3)))["tail"] == 105 % 16


def test_normalise_mirrors_the_source():
    src = (CSRC / "normalise.cu").read_text()
    assert "constexpr int kVec = 16;" in src  # VEC
    assert "return __fmul_rn(__fsub_rn(x, mean), inv_std);" in src
    assert "const uint32_t c0 = t % 3u;" in src
    assert "c0 == 0 ? m[1] : c0 == 1 ? m[2] : m[0]" in src
    assert "for (int e = 0; e < kVec; ++e) v[e] = normalised(v[e], mr[e % 3], sr[e % 3]);" in src
    assert "normalised(static_cast<float>(x[i]), m[i % 3], s[i % 3])" in src
    assert "__floats2bfloat162_rn(v[2 * j], v[2 * j + 1])" in src


def test_normalise_wrapper_on_cpu_tensors():
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (1, 6, 9, 3), dtype=np.uint8))
    mean, inv = torch.from_numpy(trc._PIXEL_MEAN), torch.from_numpy(trc._INV_STD)
    for dtype in (torch.bfloat16, None):
        assert torch.equal(nk.normalise(images, mean, inv, dtype),
                           nk.normalise_plain(images, mean, inv, dtype))
    with pytest.raises(ValueError, match="canvases"):
        nk.normalise(images[..., :2], mean, inv)
    with pytest.raises(ValueError, match="bf16 or f32"):
        nk.normalise(images, mean, inv, torch.float16)


# ------------------------------------------------------------------ bn1, the ReLU, the quantise
def _var_on(target: float) -> np.float32:
    """A variance whose var + eps (the module's 1e-5) is `target` in f32."""
    eps, t = F32(1e-5), F32(target)
    var = t - eps
    while var + eps != t:
        var = np.nextafter(var, np.float32(np.inf) if var + eps < t else np.float32(-np.inf))
    return var


def _bn_params(rng, C: int) -> dict:
    """Random statistics and affine, the variances where var + eps is a power
    of 4: there rsqrt is exact, so torch's and XLA's (which differ by an ulp
    elsewhere on the CPU) give the same w and b."""
    return {"scale": rng.uniform(0.5, 2.0, C).astype(F32),
            "bias": rng.normal(0, 1.0, C).astype(F32),
            "mean": rng.normal(0, 0.5, C).astype(F32),
            "var": np.array([_var_on(4.0 ** k) for k in rng.integers(-2, 2, C)], F32)}


def _torch_bn(params: dict, dtype) -> tcr.FrozenBatchNorm:
    bn = tcr.FrozenBatchNorm(len(params["scale"]), dtype)
    for k, v in params.items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    return bn


def _jax_bn_relu(params: dict, x: np.ndarray, dtype) -> jnp.ndarray:
    bn = jcr.FrozenBatchNorm(dtype=dtype)
    return fnn.relu(bn.apply({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                             jnp.asarray(x, dtype if dtype is not None else jnp.float32)))


def _jax_quantize(y: jnp.ndarray, s) -> np.ndarray:
    """`QuantConv.__call__`'s quantise (`ov3det/models/clip_resnet.py:116`)."""
    xf = y.astype(jnp.float32)
    return np.asarray(jnp.clip(jnp.round(xf / F32(s)), -127, 127).astype(jnp.int8))


def _stem_values(rng, shape, bf16: bool, specials: bool) -> np.ndarray:
    x = (rng.normal(size=shape) * np.exp(rng.uniform(-2, 2, shape))).astype(F32)
    if specials:
        flat = x.reshape(-1)
        vals = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 3e38, -3e38, 1e-40], F32)
        flat[rng.choice(flat.size, 48, replace=False)] = np.resize(vals, 48)
    return _bf16_round(x) if bf16 else x


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_folded_pass_plain_equals_jax(dtype, specials):
    """bn1 (the affine in f32, cast once), the ReLU and the quantise, C 40."""
    rng = np.random.default_rng(len(dtype) + specials)
    bf16 = dtype == "bfloat16"
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, None)
    params = _bn_params(rng, 40)
    x = _stem_values(rng, (2, 9, 11, 40), bf16, specials)
    s = F32(0.021)
    bn = _torch_bn(params, tdt if bf16 else None)
    xt = torch.from_numpy(x).to(tdt)
    y_jax = _jax_bn_relu(params, x, jdt)
    # the affine and the ReLU, as floats
    _same(_f32(qc.affine_relu_plain(xt, *bn.affine())), np.asarray(y_jax.astype(jnp.float32)))
    _same(_f32(torch.relu(bn(xt))), np.asarray(y_jax.astype(jnp.float32)))
    # then the codes
    got = qc.pool_quantize_plain(xt, 1, [torch.tensor(s)], affine=bn.affine())[0]
    np.testing.assert_array_equal(got.numpy(), _jax_quantize(y_jax, s))
    if specials:  # NaN stays NaN through the ReLU and quantises to 0, as JAX's does
        nan = np.isnan(np.asarray(y_jax.astype(jnp.float32)))
        assert nan.any() and (got.numpy()[nan] == 0).all()


def _half_integer_case():
    """bn1 with w = 1 and b = 0.125 exactly (var + eps = 1 in f32), x a
    multiple of 0.25: every y = x + 0.125 lies on a half-integer of s =
    0.25, and the quantise rounds each half to even."""
    C = 40
    params = {"scale": np.ones(C, F32), "bias": np.full(C, 0.125, F32),
              "mean": np.zeros(C, F32), "var": np.full(C, _var_on(1.0), F32)}
    x = (np.random.default_rng(9).integers(-100, 100, (1, 4, 6, C)) * 0.25).astype(F32)
    return params, x, F32(0.25)


def test_folded_pass_on_half_integers():
    params, x, s = _half_integer_case()
    bn = _torch_bn(params, torch.bfloat16)
    w, b = bn.affine()
    assert (w.float() == 1).all() and (b.float() == 0.125).all()
    got = qc.pool_quantize_plain(torch.from_numpy(x).to(torch.bfloat16), 1, [torch.tensor(s)],
                                 affine=(w, b))[0].numpy()
    want = _jax_quantize(_jax_bn_relu(params, x, jnp.bfloat16), s)
    np.testing.assert_array_equal(got, want)
    assert ((np.maximum(x + 0.125, 0) / s) % 1 == 0.5).sum() > 100  # quotients on half-integers


def emulate_folded_pass(x: np.ndarray, w: np.ndarray, b: np.ndarray, scales, bf16: bool) -> tuple:
    """`pool_quantize_vec<T, 1, VEC, true>` in numpy: piece t is the flat
    values out = t VEC .. out + VEC - 1, its first channel out - FastDiv(out,
    C) C, the channel of the next value one more, wrapping at C; each value
    round(round(x * w[c]) + b[c]) in the input type, then the ReLU (NaN
    stays), a NaN handed to the quantise as 0 (the plain version's code of
    NaN), then `_codes` (the reciprocal, the division's redo).  Returns
    (one int8 array a scale, the values the division redid)."""
    B, H, W, C = x.shape
    launch = qc.pass_launch(B, H, W, C, 1)
    vec, items = launch["vec"], launch["items"]
    rnd = _bf16_round if bf16 else (lambda a: a.astype(F32))
    flat = x.reshape(-1)
    out0 = np.arange(items, dtype=np.int64) * vec
    c = out0 - fast_div_apply(out0, fast_div(C)).astype(np.int64) * C
    v = np.empty((items, vec), F32)
    with np.errstate(all="ignore"):
        for e in range(vec):
            y = rnd((flat[out0 + e] * w[c]).astype(F32))
            y = rnd((y + b[c]).astype(F32))
            y = np.where(y < 0, F32(0), y)  # the ReLU keeps NaN
            v[:, e] = np.where(np.isnan(y), F32(0), y)  # the quantise's code of NaN: 0
            c = np.where(c + 1 == C, 0, c + 1)
    outs, redone = [], 0
    for s in scales:
        codes, n = _codes(v, F32(s))
        outs.append(codes.reshape(x.shape))
        redone += n
    return outs, redone


FOLD_SHAPES = [(2, 9, 11, 40), (1, 3, 5, 40), (2, 5, 7, 8), (1, 6, 4, 24), (1, 3, 3, 8)]


@pytest.mark.parametrize("n_scales", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_emulated_folded_pass_equals_the_plain_version(shape, dtype, n_scales):
    """Pieces of 16 and of 8 values (1 x 3 x 5 x 40 and 1 x 3 x 3 x 8 hold no
    whole number of 16), C below the piece (8: the channel wraps twice in a
    piece) and C 40, the stem's, where a piece crosses pixels."""
    rng = np.random.default_rng(sum(shape) + len(dtype) + n_scales)
    bf16 = dtype == "bfloat16"
    tdt = torch.bfloat16 if bf16 else torch.float32
    x = _stem_values(rng, shape, bf16, specials=np.prod(shape) >= 400)
    bn = _torch_bn(_bn_params(rng, shape[-1]), tdt if bf16 else None)
    w, b = bn.affine()
    scales = [F32(0.03), F32(0.011)][:n_scales]
    want = qc.pool_quantize_plain(torch.from_numpy(x).to(tdt), 1,
                                  [torch.tensor(s) for s in scales], affine=(w, b))
    got, _ = emulate_folded_pass(x, _f32(w), _f32(b), scales, bf16)
    for g, p in zip(got, want):
        np.testing.assert_array_equal(g, p.numpy())


def test_emulated_folded_pass_on_half_integers():
    params, x, s = _half_integer_case()
    w, b = _torch_bn(params, torch.bfloat16).affine()
    got, redone = emulate_folded_pass(x, _f32(w), _f32(b), [s], True)
    want = _jax_quantize(_jax_bn_relu(params, x, jnp.bfloat16), s)
    np.testing.assert_array_equal(got[0], want)
    assert redone == int(((np.maximum(x + 0.125, 0) / s) % 1 == 0.5).sum())  # each redone


def test_folded_pass_launch_at_the_stem():
    launch = qc.pass_launch(*STEM, 1)
    assert launch == {"design": "vec", "vec": 16, "items": int(np.prod(STEM)) // 16}
    assert STEM[-1] <= qc.AFFINE_MAX_C and int(np.prod(STEM)) < 2 ** 31


def test_folded_pass_mirrors_the_source():
    src = (CSRC / "quant_conv.cu").read_text()
    body = src[src.index("__device__ __forceinline__ void bn_relu("):]
    body = body[:body.index("\n}\n")]
    assert "float y = Io<T>::round(__fmul_rn(v[e / 8][e % 8], wb[c]));" in body
    assert "y = Io<T>::round(__fadd_rn(y, wb[C + c]));" in body
    assert "y = y < 0.f ? 0.f : y;" in body
    assert "v[e / 8][e % 8] = y == y ? y : 0.f;" in body
    assert "c = c + 1 == C ? 0 : c + 1;" in body
    assert "if constexpr (AFFINE) bn_relu<T, VEC>(v, pass_affine, p.C, out - p.chans.div(out) * p.C);" \
        in src
    assert "constexpr int kAffineMaxC = 2048;" in src  # AFFINE_MAX_C
    # pool 1 divides no pixel by C / VEC, which is 0 at C 8 in pieces of 16
    assert "make_fast_div(static_cast<uint32_t>(pool == 1 ? 1 : C / vec))" in src
    assert qc.AFFINE_MAX_C == 2048


def test_folded_pass_wrapper_on_cpu_tensors():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_stem_values(rng, (1, 4, 4, 40), True, False)).to(torch.bfloat16)
    w, b = _torch_bn(_bn_params(rng, 40), torch.bfloat16).affine()
    s = [torch.tensor(0.02)]
    got = qc.pool_quantize(x, 1, s, affine=(w, b))
    assert torch.equal(got[0], qc.pool_quantize_plain(x, 1, s, affine=(w, b))[0])
    with pytest.raises(ValueError, match="pool 1"):
        qc.pool_quantize(x, 2, s, affine=(w, b))
    with pytest.raises(ValueError, match="pool 1"):
        qc.pool_quantize(x, 1, s, affine=(w, b), _impl="first")
    with pytest.raises(ValueError, match="affine's w and b"):
        qc.pool_quantize(x, 1, s, affine=(w.float(), b.float()))


# ------------------------------------------------------------------ the teacher
TINY = dict(width=16, layers=(1, 1, 1, 1), embed_dim=32, pooler_resolution=6,
            image_resolution=96)


def test_tiny_int8_teacher_fused_equals_unfused():
    """The chained stem's `first` is conv1 alone; the fused teacher (bn1 and
    the ReLU in the quantise pass) equals the unfused module path bit for
    bit, on uint8 and f32 canvases."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    boxes = np.concatenate([trc.calibration_boxes(rng, 64.0, 96.0, n=4) for _ in range(2)])
    f32 = trc.RegionCLIPTeacher(**TINY, device="cpu")
    state = trc.init_teacher_state(f32, seed=3)
    for key in [k for k in state if k.startswith("backbone.stem.bn1.")]:  # bn1 off its init
        state[key] = torch.from_numpy(rng.uniform(0.5, 1.5, state[key].shape).astype(F32))
    fused = trc.RegionCLIPTeacher(**TINY, compute_dtype="int8", device="cpu")
    q = trc.quantize_teacher_params(state, "int8", teacher=fused,
                                    calib=(images[:1].astype(F32), boxes[:1]))
    fused.load(q)
    unfused = fused.clone(fused=False).load(q)
    assert fused.backbone.stem.chained and not unfused.backbone.stem.chained
    x = torch.randn(1, 8, 8, 3).to(torch.bfloat16)
    stem = fused.backbone.stem
    assert torch.equal(stem.first(x), stem.conv1(x))
    with torch.no_grad():
        for canvases in (images, images.astype(F32)):
            a = fused(torch.from_numpy(canvases), torch.from_numpy(boxes))
            b = unfused(torch.from_numpy(canvases), torch.from_numpy(boxes))
            assert torch.isfinite(a).all() and torch.equal(a, b)
