"""The set abstraction's shared MLP on the CPU: training-mode BatchNorm, the
ReLU and the max-pool, forward and backward, against autograd and JAX.

- `BnRelu` (`models/pointnet.py`) on CPU tensors runs the four kernels'
  plain versions (their arithmetic as torch ops: the sums, the apply, the
  tie-splitting pooled backward and the closed-form input gradient) and is
  held against the autograd VJP of the module expression (`bn_relu_plain`:
  `BatchNorm`, `relu`, `amax`) from one state: the output, dy, dweight, dbias
  and the running statistics, at both slot axes and a hidden width, in f32
  and bf16, on seeded values, on duplicated slots (ties), on ReLU zeros
  (whole units at 0), on a NaN and on a constant channel; in eval mode the
  output, the running statistics left alone, and a backward that raises
  (the kernels' backward is training mode's);
- `BatchNorm.statistics`, the one helper both paths take their statistics
  from, gives the module's forward its bits;
- the clamp of the variance: the gradient term through the variance passes
  at var_raw == 0 and stops below, as torch.clamp's backward does (JAX's
  jnp.maximum would halve it at 0);
- under a sharded data group (two ranks with the same rows, the
  all-reduce stood in by a doubling): the global sums and the all-reduced
  count, with dweight and dbias kept as this rank's;
- the plain path (`PointnetSAModule` on the CPU) against JAX's
  `PointnetSAModule(train=True)` through `jax.vjp`, with weights crossed by
  the bridge's `_mlp`: the output, the Dense kernels' gradients, the
  BatchNorm scale and bias gradients, the updated batch statistics and the
  input-feature gradient of an interim-shaped module, on the bucketed
  (slot axis 1) and first-K (slot axis 2) layouts;
- `PointnetSAModule` on the CPU computes what the module expression
  computes, bit for bit, and the wrappers take their plain versions on CPU
  tensors without counting; the constants the wrapper mirrors are read from
  the source.

Tolerances.  f32 values that only the order of a sum separates: 1e-5 of the
largest value on the forward and the running statistics, 1e-4 on the
gradients (a sum over all rows of products, then a division by P); against
JAX, 1e-4 (the repository's module tolerance, `test_torch_model.py`).  bf16
outputs and dy: one bf16 ulp or 1e-3 of the largest value (the statistics'
order may move a value across a rounding boundary).  Masks, NaN positions
and tie counts are exact.

The kernels themselves run only on the card, where chip_smoke.py
(`check_bn_relu`) holds them against these plain versions.
"""
import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.models.pointnet import PointnetSAModule as JSA
from ov3det_torch.models import convert
from ov3det_torch.models import pointnet as tpn
from ov3det_torch.models.mlp import BatchNorm
from ov3det_torch.models.pointnet import PointnetSAModule
from ov3det_torch.ops.kernels import bn_relu as br

CSRC = Path(br.__file__).resolve().parents[2] / "csrc" / "bn_relu.cu"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _norm(C: int, seed: int, training: bool = True) -> BatchNorm:
    rng = np.random.default_rng(seed)
    n = BatchNorm(C)
    with torch.no_grad():
        n.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
        n.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, C).astype(np.float32)))
        n.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, C).astype(np.float32)))
        n.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)))
    return n.train(training)


def _y(shape, seed: int, dtype=torch.float32, case: str = "seeded", axis=None) -> torch.Tensor:
    """Dense outputs: seeded values with per-channel offsets and scales, and
    the crafted cases."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    y = rng.normal(size=shape) * rng.uniform(0.5, 2.0, C) + rng.normal(0, 0.5, C)
    if case == "ties":  # empty slots copy the first pick: many slots a unit equal
        k_axis = axis or 1
        idx = [slice(None)] * len(shape)
        for k in range(1, shape[k_axis], 2):
            src, dst = list(idx), list(idx)
            src[k_axis], dst[k_axis] = 0, k
            y[tuple(dst)] = y[tuple(src)]
    elif case == "relu zeros":  # half the channels far below 0: whole units ReLU'd to 0
        y[..., : C // 2] -= 50.0 * (np.arange(C // 2) % 2)
        y[..., : C // 2] = np.where(rng.uniform(size=y[..., : C // 2].shape) < 0.5,
                                   -1e3, y[..., : C // 2])
    elif case == "constant channel":
        y[..., 1] = 0.1
    elif case == "nan":
        y.reshape(-1)[5 * C + 3] = np.nan
    return torch.from_numpy(y.astype(np.float32)).to(dtype)


def _grad(shape, seed: int) -> torch.Tensor:
    """An incoming gradient, bf16-representable so that both dtypes see it."""
    g = np.random.default_rng(seed + 100).normal(size=shape).astype(np.float32)
    return torch.from_numpy(g).to(torch.bfloat16).float()


def _out_shape(y, axis):
    if axis is None:
        return tuple(y.shape)
    return tuple(d for i, d in enumerate(y.shape) if i != axis)


def _vjp(fn, y, norm, axis, gout):
    yr = y.clone().requires_grad_()
    out = fn(yr, norm, axis)
    dy, dw, db = torch.autograd.grad(out, [yr, norm.weight, norm.bias], gout.to(out.dtype))
    return out.detach(), dy, dw, db


def _kernels(y, norm, axis):
    return tpn.BnRelu.apply(y, norm.weight, norm.bias, norm, axis)


def _close(got, want, tol: float, what: str) -> None:
    got, want = got.detach().float(), want.detach().float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_g, nan_w), f"{what}: NaN positions differ"
    got, want = got.masked_fill(nan_g, 0), want.masked_fill(nan_w, 0)
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: {err} > {tol} of {scale}"


def _bf16_close(got, want, what: str) -> None:
    """Within one bf16 ulp of the larger magnitude, or 1e-3 of the largest."""
    got, want = got.detach().float(), want.detach().float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_g, nan_w), f"{what}: NaN positions differ"
    got, want = got.masked_fill(nan_g, 0), want.masked_fill(nan_w, 0)
    m = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m)))) - 7)
    floor = 1e-3 * max(want.abs().max().item(), 1e-30)
    assert ((got - want).abs() <= torch.clamp(ulp, min=floor)).all(), what


SHAPES = {None: (2, 8, 32, 16), 1: (2, 8, 32, 32), 2: (2, 32, 8, 32)}
CASES = ("seeded", "ties", "relu zeros", "constant channel", "nan")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("axis", [None, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_kernels_arithmetic_matches_autograd_vjp(case, axis, dtype, training):
    shape = SHAPES[axis]
    y = _y(shape, 1, dtype, case, axis)
    gout = _grad(_out_shape(y, axis), 2)
    na, nb = _norm(shape[-1], 3, training), _norm(shape[-1], 3, training)
    want = _vjp(tpn.bn_relu_plain, y, na, axis, gout)
    if not training:
        yr = y.clone().requires_grad_()
        out = _kernels(yr, nb, axis)
        if dtype == torch.bfloat16 and axis is None:
            _bf16_close(out, want[0], "output")
            assert out.dtype == torch.bfloat16
        else:
            _close(out, want[0], 1e-5, "output")
            assert out.dtype == torch.float32
        for got_stat, want_stat in ((nb.running_mean, na.running_mean),
                                    (nb.running_var, na.running_var)):
            assert torch.equal(got_stat, want_stat)
        with pytest.raises(RuntimeError, match="eval-mode"):
            torch.autograd.grad(out, [yr], gout.to(out.dtype))
        return
    got = _vjp(_kernels, y, nb, axis, gout)
    tol_out, tol_grad = 1e-5, 1e-4
    if dtype == torch.bfloat16 and axis is None:
        _bf16_close(got[0], want[0], "output")
        assert got[0].dtype == torch.bfloat16
    else:
        _close(got[0], want[0], tol_out, "output")
        assert got[0].dtype == torch.float32
    if dtype == torch.bfloat16:
        _bf16_close(got[1], want[1], "dy")
    else:
        _close(got[1], want[1], tol_grad, "dy")
    assert got[1].dtype == dtype
    _close(got[2], want[2], tol_grad, "dweight")
    _close(got[3], want[3], tol_grad, "dbias")
    _close(nb.running_mean, na.running_mean, 1e-5, "running_mean")
    _close(nb.running_var, na.running_var, 1e-5, "running_var")
    if case == "nan":  # the whole channel
        assert torch.isnan(want[0]).any() and torch.isnan(want[2]).any()


def test_ties_split_the_gradient_evenly():
    """A unit whose every slot is the same value: each slot takes grad / K,
    as torch's amax backward and JAX's reduce_max JVP give it."""
    y = _y((1, 4, 3, 8), 5)
    y[:, 1:] = y[:, :1]
    norm = _norm(8, 6, training=False)
    s = torch.rsqrt(norm.running_var + norm.eps)
    scale = s * norm.weight
    pooled = br.bn_relu_apply_plain(y, norm.running_mean, scale, norm.bias, 1)
    gout = torch.ones_like(pooled)
    sums, q = br.bn_relu_grad_sums_plain(y, gout, norm.running_mean, scale, norm.bias, s, 1, pooled)
    assert torch.equal(q, torch.full_like(q, 0.25))
    # the statistics held fixed: zero sums leave dy = scale * g
    dy = br.bn_relu_grad_apply_plain(y, gout, norm.running_mean, scale, norm.bias, s,
                                     torch.zeros_like(sums), 1.0, torch.zeros(8), 1, pooled, q)
    live = pooled > 0
    want = torch.where(live.unsqueeze(1), 0.25 * scale, torch.zeros(()))
    assert torch.equal(dy, want.expand_as(dy))
    yr = y.clone().requires_grad_()
    out = torch.relu((yr - norm.running_mean) * scale + norm.bias).amax(1)
    (auto,) = torch.autograd.grad(out, yr, gout)
    assert torch.equal(dy, auto)


def test_variance_clamp_passes_at_zero_and_stops_below():
    """bn_relu_grad_apply keeps the term through the variance where var_raw
    >= 0 (torch.clamp's backward at 0 passes the gradient) and drops it
    below 0."""
    C = 8
    y = _y((4, 8, C), 7)
    grad = _grad(y.shape, 8)
    mean, s = torch.full((C,), 0.3), torch.full((C,), 2.0)
    scale, bias = s * 1.5, torch.full((C,), 0.2)
    sums = torch.stack([torch.full((C,), 3.0), torch.full((C,), -5.0)])
    var_raw = torch.tensor([0.0, -1e-9, 1.0, -0.0, 0.0, -2.0, 5.0, 0.0])
    got = br.bn_relu_grad_apply_plain(y, grad, mean, scale, bias, s, sums, 32.0, var_raw)
    r = br._values(y, mean, scale, bias)
    g = torch.where(r <= 0, 0.0, grad)
    xh = (y - mean) * s
    c2 = torch.where(var_raw >= 0, sums[1] / 32.0, 0.0)
    assert torch.equal(c2 != 0, torch.tensor([True, False, True, True, True, False, True, True]))
    assert torch.equal(got, scale * ((g - sums[0] / 32.0) - xh * c2))
    v = torch.tensor([0.0, -1.0, 1.0], requires_grad=True)
    (d,) = torch.autograd.grad(torch.clamp(v, min=0.0).sum(), v)
    assert torch.equal(d, torch.tensor([1.0, 0.0, 1.0]))


def test_constant_channel_clamps_in_both():
    """A channel of one value: mean y^2 - mean^2 rounds below 0 in both the
    module and the kernels' statistics here, and both stop the variance's
    term; their gradients agree."""
    y = torch.full((2, 8, 16, 8), 0.1) + torch.arange(8) * (torch.arange(8) != 1)
    n = _norm(8, 9)
    mean, var, var_raw, count = copy.deepcopy(n).statistics(br.bn_stats(y), y.numel() // 8)
    x = y.reshape(-1, 8)
    module_raw = (x * x).mean(0) - x.mean(0) * x.mean(0)
    assert var_raw[1] < 0 and module_raw[1] < 0 and var[1] == 0
    gout = _grad(y.shape, 10)
    want = _vjp(tpn.bn_relu_plain, y, copy.deepcopy(n), None, gout)
    got = _vjp(_kernels, y, copy.deepcopy(n), None, gout)
    for a, b, what in zip(got, want, ("output", "dy", "dweight", "dbias")):
        _close(a, b, 1e-4, what)


def _old_batch_norm(norm, x):
    """`BatchNorm.forward` as it read before `statistics`: the means of x
    and x^2 over the leading axes."""
    x = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(axes)
    var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
    with torch.no_grad():
        norm.running_mean.copy_(0.9 * norm.running_mean + (1 - 0.9) * mean)
        norm.running_var.copy_(0.9 * norm.running_var + (1 - 0.9) * var)
    return (x - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


@pytest.mark.parametrize("shape", [(2, 8, 32, 16), (3, 17, 5, 24), (4, 100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_norm_statistics_keep_the_forward_bits(shape, dtype):
    """The module's training forward through `statistics` (sums over the
    rows, then / count) gives the old forward's bits: the output, the input
    and parameter gradients and the running statistics."""
    y = _y(shape, 21, dtype)
    gout = _grad(shape, 22)
    na, nb = _norm(shape[-1], 23), _norm(shape[-1], 23)
    want = _vjp(lambda t, n, _: _old_batch_norm(n, t), y, na, None, gout)
    got = _vjp(lambda t, n, _: n(t), y, nb, None, gout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(nb.buffers(), na.buffers()):
        assert torch.equal(a, b)


def test_sharded_group_sums_globally_and_keeps_local_parameter_grads(monkeypatch):
    """Two ranks holding the same rows, the all-reduce a doubling: the
    kernels' Function against the module under the same stand-in (its
    differentiable all-reduce doubles the gradient of the sums too).  The
    count is the all-reduced tensor; dweight and dbias are this rank's."""
    from ov3det_torch.models import mlp
    from ov3det_torch.parallel import mesh

    group = mesh.DataGroup(rank=0, world=2, backend="gloo")
    monkeypatch.setattr(mlp, "data_group", lambda: group)
    monkeypatch.setattr(mesh, "data_group", lambda: group)
    monkeypatch.setattr(tpn, "data_group", lambda: group)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, *a, **k: t.mul_(2))
    for axis in (None, 1):
        shape = SHAPES[axis]
        y = _y(shape, 11)
        gout = _grad(_out_shape(y, axis), 12)
        na, nb = _norm(shape[-1], 13), _norm(shape[-1], 13)
        want = _vjp(tpn.bn_relu_plain, y, na, axis, gout)
        got = _vjp(_kernels, y, nb, axis, gout)
        for a, b, what in zip(got, want, ("output", "dy", "dweight", "dbias")):
            _close(a, b, 1e-4, f"{what}, axis {axis}")
        _close(nb.running_var, na.running_var, 1e-5, "running_var")


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    y = _y((2, 4, 8, 16), 14)
    norm = _norm(16, 15, training=False)
    s = torch.rsqrt(norm.running_var + norm.eps)
    scale = s * norm.weight
    before = (br.bn_stats.launches, br.bn_relu_apply.launches, br.bn_relu_grad_sums.launches,
              br.bn_relu_grad_apply.launches)
    assert torch.equal(br.bn_stats(y), br.bn_stats_plain(y))
    pooled = br.bn_relu_apply(y, norm.running_mean, scale, norm.bias, 2)
    assert torch.equal(pooled, br.bn_relu_apply_plain(y, norm.running_mean, scale, norm.bias, 2))
    gout = _grad(pooled.shape, 16)
    sums, q = br.bn_relu_grad_sums(y, gout, norm.running_mean, scale, norm.bias, s, 2, pooled)
    want_sums, want_q = br.bn_relu_grad_sums_plain(y, gout, norm.running_mean, scale, norm.bias,
                                                   s, 2, pooled)
    assert torch.equal(sums, want_sums) and torch.equal(q, want_q)
    var_raw = norm.running_var - 1.0
    dy = br.bn_relu_grad_apply(y, gout, norm.running_mean, scale, norm.bias, s, sums, 64.0,
                               var_raw, 2, pooled, q)
    assert torch.equal(dy, br.bn_relu_grad_apply_plain(y, gout, norm.running_mean, scale,
                                                       norm.bias, s, sums, 64.0, var_raw, 2,
                                                       pooled, q))
    assert (br.bn_stats.launches, br.bn_relu_apply.launches, br.bn_relu_grad_sums.launches,
            br.bn_relu_grad_apply.launches) == before


@pytest.mark.parametrize("shape,axis", [((2, 8, 12), None), ((2, 3, 4, 2048), None),
                                        ((2, 3, 4, 4), None), ((2, 3, 4, 8), 3),
                                        ((2, 3, 8), 1)])
def test_the_kernels_refuse_what_they_do_not_take(shape, axis):
    with pytest.raises(ValueError):
        br._check(torch.empty(shape), axis, "bn_relu")
    with pytest.raises(ValueError):
        br._check(torch.empty((2, 3, 4, 8), dtype=torch.float16), None, "bn_relu")


def test_sums_grid():
    """`stat_blocks`: at most 4 CTAs an SM, each at least 8 passes of the
    rows it holds at once (1 of the pooled units), and the units covered."""
    for units, C in ((8 * 64 * 2048, 256), (8 * 64 * 2048, 64), (100, 16), (1, 8),
                     (8 * 2048, 256)):
        blocks, per = br.stat_blocks(units, C, 132)
        assert 1 <= blocks <= 132 * br.STAT_CTAS_PER_SM and blocks * per >= units
        assert (blocks - 1) * per < units
    assert br.stat_blocks(8 * 64 * 2048, 256, 132)[0] == 528
    assert br.stat_blocks(8 * 2048, 256, 132) == (256, 64)  # rows: 8 passes of 8 rows
    assert br.stat_blocks(8 * 2048, 256, 132, passes=1) == (528, 32)  # pooled units


def test_source_constants():
    src = CSRC.read_text()
    for name, value in (("kVec", br.VEC), ("kMaxC", br.MAX_C), ("kThreads", br.THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # each operation of the forward value rounded on its own, shared by all passes
    assert "relu_keep_nan(__fadd_rn(__fmul_rn(__fsub_rn(y, mean), scale), bias))" in src
    assert src.count("bn_relu_value(") >= 7
    assert "atomicAdd" not in src


def _old_forward(m, xyz, feats):
    """PointnetSAModule.forward as it read before the kernels: the module
    expression after each Dense, then amax."""
    inds = tpn.furthest_point_sample(xyz, m.npoint)
    new_xyz = tpn.gather_points(xyz, inds)
    h = tpn.ball_group(xyz, feats, new_xyz, m.radius, m.nsample)
    for layer, norm in zip(m.layers, m.norms):
        h = torch.relu(norm(layer(h)))
    return new_xyz, h.amax(dim=1), inds


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_cpu_module_keeps_its_bits(training):
    rng = np.random.default_rng(17)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(2, 256, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    a = PointnetSAModule(64, 0.4, 8, 8, (16, 24), compute_dtype=torch.bfloat16)
    for layer in a.layers:
        layer.reset_parameters(gen)
    b = copy.deepcopy(a)
    a.train(training), b.train(training)
    fa, fb = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    got, want = a(xyz, fa), _old_forward(b, xyz, fb)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    w_out = _grad(got[1].shape, 18)
    (got[1] * w_out).sum().backward()
    (want[1] * w_out).sum().backward()
    assert torch.equal(fa.grad, fb.grad)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad)
    for ba, bb in zip(a.buffers(), b.buffers()):
        assert torch.equal(ba, bb)


# ------------------------------------------------------------------ vs JAX
def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("method", ["bucketed", "first_k"])
def test_plain_path_matches_jax_train_mode_vjp(method, monkeypatch):
    """An interim-shaped module (8 feature channels in, widths 16 and 24) in
    training mode: JAX's `PointnetSAModule(train=True)` with its batch
    statistics mutable, through `jax.vjp` in the parameters and the input
    features, against the port's module on the CPU and autograd."""
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted
    rng = np.random.default_rng(19)
    B, N, C_in, M, K = 2, 256, 8, 64, 8
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C_in)).astype(np.float32)
    w = rng.normal(size=(B, M, 24)).astype(np.float32)
    jm = JSA(npoint=M, radius=0.4, nsample=K, mlp_dims=(16, 24), fps_shards=1,
             ball_query_method=method)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(xyz), jnp.asarray(feats))
    params, stats = v["params"], v["batch_stats"]

    def f(p, x):
        (_, out, _), new = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(xyz), x,
                                    train=True, mutable=["batch_stats"])
        return out, new["batch_stats"]

    out, vjp, new_stats = jax.vjp(f, params, jnp.asarray(feats), has_aux=True)
    g_params, g_feats = vjp(jnp.asarray(w))

    m = PointnetSAModule(M, 0.4, K, C_in, (16, 24), ball_query_method=method).train()
    sd = convert._mlp("m", jax.tree_util.tree_map(np.asarray, params),
                      jax.tree_util.tree_map(np.asarray, stats))
    m.load_state_dict({k[2:]: _t(a) for k, a in sd.items()})
    tf = _t(feats).requires_grad_()
    _, got, _ = m(_t(xyz), tf)
    (got * _t(w)).sum().backward()

    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **tol)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(g_feats), **tol)
    assert np.abs(np.asarray(g_feats)).max() > 0
    for i in range(2):
        gd = np.asarray(g_params[f"Dense_{i}"]["kernel"])
        np.testing.assert_allclose(m.layers[i].weight.grad.numpy().T, gd,
                                   atol=1e-4 * np.abs(gd).max(), rtol=1e-4)
        for ours, theirs in ((m.norms[i].weight.grad, "scale"), (m.norms[i].bias.grad, "bias")):
            gj = np.asarray(g_params[f"BatchNorm_{i}"][theirs])
            np.testing.assert_allclose(ours.numpy(), gj, atol=1e-4 * np.abs(gj).max(), rtol=1e-4)
        for ours, theirs in ((m.norms[i].running_mean, "mean"), (m.norms[i].running_var, "var")):
            np.testing.assert_allclose(ours.numpy(), np.asarray(new_stats[f"BatchNorm_{i}"][theirs]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [1, 2])
def test_pooled_strides_address_the_slots(axis):
    """`_pooled_shape`'s (B, K, M, C) and strides: the kernels read slot k of
    unit (b, m) at b sB + k sK + m sM (+ c), which is y's element."""
    y = torch.arange(2 * 5 * 7 * 8, dtype=torch.float32).reshape(2, 5, 7, 8)
    B, K, M, C, sB, sK, sM = br._pooled_shape(y, axis)
    flat = y.reshape(-1)
    for b in range(B):
        for k in range(K):
            for m in range(M):
                want = y[b, k, m] if axis == 1 else y[b, m, k]
                assert torch.equal(flat[b * sB + k * sK + m * sM:][:C], want)
    assert (B, M, C) == tuple(y.amax(dim=axis).shape)
