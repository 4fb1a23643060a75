"""The transformer's "add & norm" on the CPU: x_new = x + dropout(branch),
then LayerNorm(x_new), forward and backward, against autograd and JAX.

- `AddNorm` (`models/mlp.py`) on CPU tensors runs the kernels' plain
  versions (`add_norm_plain`, `add_norm_grad_plain`: the closed-form input
  gradient, `add_norm_param_grads_plain`) and is held against the autograd
  VJP of the module expression (x + where(keep, branch / keep_prob, 0), the
  division flax's: by the keep probability rounded to branch's dtype, then
  `LayerNorm.forward` as it read before the kernels): y, x_new, dx, dbranch, dweight and dbias, for an f32
  and a bf16 x, an f32 and a bf16 branch and no branch (the norm alone),
  with dropout and without, on seeded rows, on constant rows (var_raw
  above, at and below 0) and on a NaN; and in eval mode, the forward;
- the clamp of the variance: the gradient term through the variance passes
  at var_raw == 0 and stops below, as torch.clamp's backward does;
- the plain path (`LayerNorm.add`, `LayerNorm` on the CPU) against flax's
  `nn.LayerNorm(epsilon=1e-5)` applied to x + jnp.where(keep, b / keep_prob,
  0) through `jax.vjp`, with the same keep mask; the port's dropout
  (`dropped`) equal to flax's `nn.Dropout` bit for bit in bf16 and f32,
  forward and VJP;
- the encoder and decoder layers on the CPU keep their bits (forward,
  gradients, the generator's stream), and dropout split into its mask and
  its application keeps its bits;
- under a data group of two ranks (a stand-in), a rank's mask, x_new, y,
  dx and dbranch are its rows of the global ones, and its dweight and dbias
  its own share (the two add up to the global ones within 1e-5);
- the wrappers take their plain versions on CPU tensors without counting,
  refuse the widths and dtypes the kernels do not take, and the constants
  they mirror are read from the source; the backward's grid (`grad_blocks`)
  and its parameter sums in one launch, emulated in numpy (each CTA's
  partial row, then each column over the CTAs' rows, every 32nd in block
  order a lane, then the lanes' butterfly), against the f64 sums.

Tolerances.  x_new, the dropout's values and the forward's y are the module
expression's own ops on the CPU: equal bit for bit (x_new and the dropout
to flax's too).  Gradients, where the
closed form and autograd sum in different orders: 1e-4 of the largest value
in f32 (the repository's module tolerance), one bf16 ulp or 1e-3 of the
largest value in bf16 (the order may move a value across a rounding
boundary).  Against JAX: 1e-5 of the largest value on the forward, 1e-4 on
the gradients.  The emulated parameter sums against f64: 1e-5 of the
largest value (f32 sums of at most 64 rows a lane, 8 warps, 9 CTAs a lane
and 5 butterfly steps: some 86 roundings, 6e-6 at most).  NaN positions are exact.

The kernels themselves run only on the card, where chip_smoke.py
(`check_add_norm`) holds them against these plain versions.
"""
import copy
import re
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det_torch.models import mlp
from ov3det_torch.models import transformer as ttr
from ov3det_torch.models.mlp import AddNorm, LayerNorm
from ov3det_torch.ops.kernels import add_norm as an

CSRC = Path(an.__file__).resolve().parents[2] / "csrc" / "add_norm.cu"
KEEP_PROB = 0.9
# constants c whose constant row gives var_raw = mean(c^2) - mean(c)^2 above,
# at and below 0 in f32 (searched on the CPU's reductions)
CONSTANTS = (0.0099999998, 0.0119939977, 0.0149849951)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _rows(shape, seed: int, dtype=torch.float32, case: str = "seeded") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * rng.uniform(0.5, 2.0, shape[:-1] + (1,)) + rng.normal(
        0, 0.5, shape[:-1] + (1,))
    if case == "constant rows":
        for i, c in enumerate(CONSTANTS):
            x.reshape(-1, shape[-1])[i] = c
    elif case == "nan":
        x.reshape(-1)[3 * shape[-1] + 5] = np.nan
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _norm(C: int, seed: int) -> LayerNorm:
    rng = np.random.default_rng(seed)
    n = LayerNorm(C)
    with torch.no_grad():
        n.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
        n.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, C).astype(np.float32)))
    return n


def _keep(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=shape) < KEEP_PROB)


def _grad(shape, seed: int) -> torch.Tensor:
    """A bf16-representable gradient."""
    g = np.random.default_rng(seed + 100).normal(size=shape).astype(np.float32)
    return torch.from_numpy(g).to(torch.bfloat16).float()


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


def _grad_close(got, want, what: str) -> None:
    if got.dtype == torch.bfloat16:
        _bf16_close(got, want, what)
    else:
        _close(got, want, 1e-4, what)


def _old_norm(norm, x):
    """`LayerNorm.forward` as it read before the kernels: the module
    expression in f32."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


def _rounded(keep_prob: float, dtype) -> float:
    """flax's divisor: the keep probability rounded to the input's dtype."""
    return torch.tensor(keep_prob, dtype=dtype).item()


def _module(x, branch, norm, keep):
    """The module expression: x + where(keep, branch / keep_prob, 0) (the
    division flax's) and the norm, as the layers computed them before the
    kernels."""
    if branch is None:
        return (_old_norm(norm, x),)
    x_new = x + (branch if keep is None else torch.where(
        keep, branch / _rounded(KEEP_PROB, branch.dtype), 0.0))
    return x_new, _old_norm(norm, x_new)


def _function(x, branch, norm, keep):
    out = AddNorm.apply(x, branch, norm.weight, norm.bias, keep, KEEP_PROB, norm.eps)
    return (out,) if branch is None else out


def _vjp(fn, x, branch, norm, keep, grads):
    xr = x.clone().requires_grad_()
    br = None if branch is None else branch.clone().requires_grad_()
    outs = fn(xr, br, norm, keep)
    wrt = [xr, norm.weight, norm.bias] + ([] if br is None else [br])
    got = torch.autograd.grad(outs, wrt, grads[-len(outs):])
    return [o.detach() for o in outs], got


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (x, branch, dropout) the kernels take: a bf16 x with an f32 branch only
COMBOS = [("f32", None, False), ("bf16", None, False), ("f32", "f32", False),
          ("f32", "f32", True), ("f32", "bf16", False), ("f32", "bf16", True),
          ("bf16", "f32", False), ("bf16", "f32", True)]
CASES = ("seeded", "constant rows", "nan")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"x{c[0]}-br{c[1]}-{'drop' if c[2] else 'nodrop'}")
def test_plain_versions_match_autograd_vjp(combo, case):
    xd, bd, drop = combo
    shape = (2, 6, 32)
    x = _rows(shape, 1, DTYPES[xd], case)
    branch = None if bd is None else _rows(shape, 2, DTYPES[bd])
    keep = _keep(shape, 3) if drop else None
    grads = [_grad(shape, 4), _grad(shape, 5)]
    na, nb = _norm(shape[-1], 6), _norm(shape[-1], 6)
    want_out, want = _vjp(_module, x, branch, na, keep, grads)
    got_out, got = _vjp(_function, x, branch, nb, keep, grads)
    for g, w in zip(got_out, want_out):  # x_new and y: the module's own ops
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert got[0].dtype == x.dtype
    _grad_close(got[0], want[0], "dx")
    _close(got[1], want[1], 1e-4, "dweight")
    _close(got[2], want[2], 1e-4, "dbias")
    if branch is not None:
        assert got[3].dtype == branch.dtype
        _grad_close(got[3], want[3], "dbranch")
        if keep is not None:
            assert (got[3][~keep] == 0).all()
    if case == "nan":  # the row, and every parameter's gradient
        assert torch.isnan(want_out[-1]).any() and torch.isnan(want[1]).all()


@pytest.mark.parametrize("branch", [None, "bf16"])
def test_eval_mode_forward(branch):
    """Eval mode: no mask, no gradient; the module's forward equals the
    Function's (what a request runs on the card)."""
    shape = (3, 4, 16)
    x = _rows(shape, 7)
    b = None if branch is None else _rows(shape, 8, torch.bfloat16)
    norm = _norm(16, 9).eval()
    with torch.no_grad():
        got = _function(x, b, norm, None)
        if b is None:
            want = (norm(x),)
        else:
            want = norm.add(x, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_variance_clamp_passes_at_zero_and_stops_below():
    """Constant rows whose var_raw is above, at and below 0: the closed
    form keeps the variance's gradient term where var_raw >= 0 and drops it
    below, as torch.clamp's backward does."""
    x = _rows((1, 3, 16), 10, case="constant rows")
    _, _, stats = an.add_norm_plain(x, torch.ones(16), torch.zeros(16), 1e-5)
    var_raw = stats[2]
    assert var_raw[0] > 0 and var_raw[1] == 0 and var_raw[2] < 0
    norm = _norm(16, 11)
    grads = [_grad(x.shape, 12)]
    _, want = _vjp(_module, x, None, norm, None, grads)
    _, got = _vjp(_function, x, None, norm, None, grads)
    _close(got[0], want[0], 1e-4, "dx")
    # the term itself, on seeded rows: kept where var_raw is 0, dropped below
    x = _rows((1, 3, 16), 13)
    _, _, stats = an.add_norm_plain(x, torch.ones(16), torch.zeros(16), 1e-5)
    w = norm.weight.detach()
    dx, _ = an.add_norm_grad_plain(x, grads[0], stats, w, torch.float32)
    at_zero, below = stats.clone(), stats.clone()
    at_zero[2], below[2] = 0.0, -1e-30
    dx_zero, _ = an.add_norm_grad_plain(x, grads[0], at_zero, w, torch.float32)
    dx_below, _ = an.add_norm_grad_plain(x, grads[0], below, w, torch.float32)
    mean, r = stats[0].reshape(1, 3, 1), stats[1].reshape(1, 3, 1)
    gw = grads[0] * w
    assert torch.equal(dx_zero, dx)
    assert torch.equal(dx_below, r * ((gw - gw.sum(-1, keepdim=True) / 16) - 0.0))
    assert not torch.equal(dx_below, dx)


# ------------------------------------------------------------------ vs JAX
def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


@pytest.mark.parametrize("branch,drop", [(None, False), ("bf16", True), ("bf16", False),
                                         ("f32", True)])
def test_plain_path_matches_flax_vjp(branch, drop):
    """flax `nn.LayerNorm(epsilon=1e-5)` on x + jnp.where(keep, b / keep_prob,
    0) through `jax.vjp` (the same keep mask, the norm's scale and bias the
    module's weight and bias) against the port's CPU path (`LayerNorm.add`,
    `LayerNorm`) and its autograd: x_new, y and every gradient."""
    shape = (2, 5, 24)
    x = _rows(shape, 20)
    b = None if branch is None else _rows(shape, 21, DTYPES[branch])
    keep = _keep(shape, 22) if drop else None
    g_res, g_y = _grad(shape, 23), _grad(shape, 24)
    norm = _norm(shape[-1], 25)
    jb = None if b is None else jnp.asarray(b.float().numpy(), jnp.bfloat16 if branch == "bf16"
                                             else jnp.float32)
    ln = fnn.LayerNorm(epsilon=1e-5)
    params = {"params": {"scale": jnp.asarray(norm.weight.detach().numpy()),
                         "bias": jnp.asarray(norm.bias.detach().numpy())}}

    def f(xj, bj, p):
        if bj is None:
            return (ln.apply(p, xj),)
        # flax's own division (`nn.Dropout`'s): a weak-typed Python float
        d = bj if keep is None else jnp.where(jnp.asarray(keep.numpy()), bj / KEEP_PROB, 0)
        x_new = xj + d
        return x_new, ln.apply(p, x_new)

    outs, pull = jax.vjp(f, jnp.asarray(x.numpy()), jb, params)
    cots = (jnp.asarray(g_y.numpy()),) if b is None else (jnp.asarray(g_res.numpy()),
                                                          jnp.asarray(g_y.numpy()))
    dx_j, db_j, dp_j = pull(cots)
    grads = [g_res, g_y] if b is not None else [g_y]
    got_out, got = _vjp(lambda xr, br, n, k: (n(xr),) if br is None else n.add(xr, br, k, KEEP_PROB),
                        x, b, norm, keep, grads)
    if b is not None:  # x_new: flax's dropout and the f32 add, bit for bit
        assert torch.equal(got_out[0], _t(outs[0]))
    for g, w in zip(got_out, outs):
        _close(g, _t(w), 1e-5, "forward")
    _close(got[0], _t(dx_j), 1e-4, "dx")
    _close(got[1], _t(dp_j["params"]["scale"]), 1e-4, "dweight")
    _close(got[2], _t(dp_j["params"]["bias"]), 1e-4, "dbias")
    if b is not None:
        _grad_close(got[3], _t(np.asarray(db_j, np.float32)).to(got[3].dtype), "dbranch")


def test_flax_dropout_rounds_the_keep_probability_to_bf16():
    """flax `nn.Dropout` divides by the keep probability rounded to the
    input's dtype (a weak-typed Python float: 0.9 is 0.8984375 in bf16) and
    rounds the quotient to that dtype.  The port's dropout (`dropped`, what
    `mlp.dropout` and the add & norm's plain version apply) equals it bit for
    bit in bf16 and f32, forward and through `jax.vjp` against autograd, with
    flax's own mask; in bf16 the f32 keep probability would give other bits."""
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        b = _rows((4, 8, 32), 26, dtype)
        ct = _rows((4, 8, 32), 27, dtype)
        jb = jnp.asarray(b.float().numpy(), jdtype)
        drop = fnn.Dropout(1.0 - KEEP_PROB, deterministic=False)
        out, pull = jax.vjp(lambda v: drop.apply({}, v, rngs={"dropout": jax.random.PRNGKey(0)}),
                            jb)
        (flax_grad,) = pull(jnp.asarray(ct.float().numpy(), jdtype))
        flax_v = _t(np.asarray(out, np.float32))
        keep = flax_v != 0
        assert 0 < keep.sum() < keep.numel()
        br = b.clone().requires_grad_()
        port = an.dropped(br, keep, KEEP_PROB)
        port.backward(ct)
        assert port.dtype == br.grad.dtype == dtype
        assert torch.equal(port.float(), flax_v), str(dtype)
        assert torch.equal(br.grad.float(), _t(np.asarray(flax_grad, np.float32))), str(dtype)
        if dtype == torch.bfloat16:  # the f32 keep probability: kept values an ulp apart
            f32_div = torch.where(keep, (b.float() / np.float32(KEEP_PROB)).to(dtype), 0.0)
            assert not torch.equal(f32_div.float(), flax_v)
            _bf16_close(f32_div, flax_v, "the f32 divisor against flax's")


# ------------------------------------------------------- the layers' bits
def _old_dropout(x, rate, generator, batch_dim=0):
    """`models.mlp.dropout` as it read before the mask was split out, with
    flax's division (by the keep probability rounded to x's dtype)."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    b = x.shape[batch_dim]
    keep = (torch.rand(list(x.shape), generator=generator, device=x.device) < keep_prob).narrow(
        batch_dim, 0, b)
    return torch.where(keep, x / _rounded(keep_prob, x.dtype), 0.0)


def _old_encoder_layer(m, x, pos, generator):
    rate = m.dropout if m.training else 0.0
    y = _old_norm(m.norm1, x)
    qk = ttr._with_pos(y, pos)
    x = x + _old_dropout(m.self_attn(qk, qk, y, generator), rate, generator)
    y = _old_dropout(m.act(m.linear1(_old_norm(m.norm2, x))), rate, generator)
    return x + _old_dropout(m.linear2(y), rate, generator)


def _old_decoder_layer(m, tgt, memory, query_pos, mem_pos, generator):
    rate = m.dropout if m.training else 0.0
    y = _old_norm(m.norm1, tgt)
    qk = ttr._with_pos(y, query_pos)
    tgt = tgt + _old_dropout(m.self_attn(qk, qk, y, generator), rate, generator)
    y = _old_norm(m.norm2, tgt)
    ca = m.cross_attn(ttr._with_pos(y, query_pos), ttr._with_pos(memory, mem_pos), memory,
                      generator)
    tgt = tgt + _old_dropout(ca, rate, generator)
    y = _old_dropout(torch.relu(m.linear1(_old_norm(m.norm3, tgt))), rate, generator)
    return tgt + _old_dropout(m.linear2(y), rate, generator)


def _randomise(module, seed: int):
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, mlp.Dense):
            sub.reset_parameters(gen)
        elif isinstance(sub, LayerNorm):
            with torch.no_grad():
                sub.weight.uniform_(0.5, 1.5, generator=gen)
                sub.bias.normal_(0, 0.3, generator=gen)
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layers_keep_their_bits_on_the_cpu(kind, training, dtype):
    """A layer's forward, its gradients and the generator's stream after it
    equal the layer as it read before the kernels, bit for bit."""
    C = 32
    if kind == "encoder":
        a = _randomise(ttr.TransformerEncoderLayer(C, 4, 48, 0.2, compute_dtype=dtype), 30)
    else:
        a = _randomise(ttr.TransformerDecoderLayer(C, 4, 48, 0.2, compute_dtype=dtype), 30)
    b = copy.deepcopy(a)
    a.train(training), b.train(training)
    x = _rows((2, 16, C), 31)
    pos = _rows((2, 16, C), 32)
    memory, mem_pos = _rows((2, 24, C), 33), _rows((2, 24, C), 34)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    if kind == "encoder":
        got = a(xa, pos=pos, generator=ga)
        want = _old_encoder_layer(b, xb, pos, gb)
    else:
        got = a(xa, memory, query_pos=pos, mem_pos=mem_pos, generator=ga)
        want = _old_decoder_layer(b, xb, memory, pos, mem_pos, gb)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ga.get_state(), gb.get_state())
    g = _grad(got.shape, 35)
    (got.float() * g).sum().backward()
    (want.float() * g).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad), name


def test_decoder_final_norm_keeps_its_bits():
    """The decoder stack (its final norm once a layer) on the CPU equals the
    stack of old layers with the old norm expression."""
    C = 32
    a = _randomise(ttr.TransformerDecoder(2, C, 4, 48, 0.2, torch.bfloat16), 40).train()
    b = copy.deepcopy(a)
    tgt, memory = _rows((2, 8, C), 41), _rows((2, 24, C), 42)
    qp, mp = _rows((2, 8, C), 43), _rows((2, 24, C), 44)
    got = a(tgt, memory, query_pos=qp, mem_pos=mp, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    inter, t = [], tgt
    for layer in b.layers:
        t = _old_decoder_layer(layer, t, memory, qp, mp, gen)
        inter.append(_old_norm(b.norm, t))
    assert torch.equal(got, torch.stack(inter))


@pytest.mark.parametrize("batch_dim", [0, 1])
def test_dropout_split_keeps_its_bits(batch_dim):
    """`dropout` = `dropped(x, dropout_mask(x))`, and both equal the
    expression before the split, with the same draw from the generator."""
    x = _rows((4, 6, 16), 50, torch.bfloat16)
    got = mlp.dropout(x, 0.3, torch.Generator().manual_seed(3), batch_dim)
    want = _old_dropout(x, 0.3, torch.Generator().manual_seed(3), batch_dim)
    keep = mlp.dropout_mask(x, 0.3, torch.Generator().manual_seed(3), batch_dim)
    assert torch.equal(got, want) and torch.equal(an.dropped(x, keep, 0.7), want)
    assert mlp.dropout_mask(x, 0.0, None) is None and mlp.dropout(x, 0.0, None) is x


def test_a_ranks_add_norm_is_its_rows_of_the_global_one(monkeypatch):
    """Under a data group of two ranks (a stand-in: no collective runs), each
    rank's mask is its rows of one draw over the global batch, so its x_new
    and y are its rows of the global ones; dweight and dbias stay the
    rank's (the two ranks' add up to the global ones)."""
    from ov3det_torch.parallel import DataGroup

    shape = (4, 6, 16)
    x, b = _rows(shape, 70), _rows(shape, 71, torch.bfloat16)
    gy, gr = _grad(shape, 72), _grad(shape, 73)
    norm = _norm(16, 74)
    keep = mlp.dropout_mask(b, 0.3, torch.Generator().manual_seed(9))
    (x_new, y), grads = _vjp(_function, x, b, norm, keep, [gr, gy])
    dw, db = torch.zeros(16), torch.zeros(16)
    for rank in range(2):
        group = DataGroup(rank, 2, "gloo")
        monkeypatch.setattr(mlp, "data_group", lambda: group)
        rows = slice(2 * rank, 2 * rank + 2)
        mask = mlp.dropout_mask(b[rows], 0.3, torch.Generator().manual_seed(9))
        assert torch.equal(mask, keep[rows])
        (xn_r, y_r), g = _vjp(_function, x[rows], b[rows], norm, mask, [gr[rows], gy[rows]])
        assert torch.equal(xn_r, x_new[rows]) and torch.equal(y_r, y[rows])
        assert torch.equal(g[0], grads[0][rows]) and torch.equal(g[3], grads[3][rows])
        dw, db = dw + g[1], db + g[2]
    _close(dw, grads[1], 1e-5, "dweight summed over the ranks")
    _close(db, grads[2], 1e-5, "dbias summed over the ranks")


# ------------------------------------------------------------- the wrappers
def test_wrappers_take_plain_versions_on_cpu_without_counting():
    shape = (2, 3, 16)
    x, b = _rows(shape, 60), _rows(shape, 61, torch.bfloat16)
    keep = _keep(shape, 62)
    w, bias = torch.full((16,), 1.25), torch.full((16,), 0.5)
    before = (an.add_norm.launches, an.add_norm_grad.launches)
    got = an.add_norm(x, w, bias, 1e-5, b, keep, KEEP_PROB)
    want = an.add_norm_plain(x, w, bias, 1e-5, b, keep, KEEP_PROB)
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    x_new, _, stats = got
    gy, gr = _grad(shape, 63), _grad(shape, 64)
    dx, db, sums = an.add_norm_grad(x_new, gy, stats, w, torch.float32, gr, torch.bfloat16, keep,
                                    KEEP_PROB)
    want_dx, want_db = an.add_norm_grad_plain(x_new, gy, stats, w, torch.float32, gr,
                                              torch.bfloat16, keep, KEEP_PROB)
    assert torch.equal(dx, want_dx) and torch.equal(db, want_db)
    assert torch.equal(sums, an.add_norm_param_grads_plain(x_new, gy, stats))
    assert (an.add_norm.launches, an.add_norm_grad.launches) == before


@pytest.mark.parametrize("shape,dtype,branch", [
    ((2, 8, 12), torch.float32, None), ((2, 8, 776), torch.float32, None),
    ((2, 8, 4), torch.float32, None), ((2, 8, 16), torch.float16, None),
    ((0, 16), torch.float32, None), ((2, 8, 16), torch.bfloat16, torch.bfloat16),
    ((2, 8, 16), torch.float32, torch.float16)])
def test_the_kernels_refuse_what_they_do_not_take(shape, dtype, branch):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        an._check(x, None if branch is None else torch.zeros(shape, dtype=branch), "add_norm")
    with pytest.raises(ValueError):  # a branch of another shape
        an._check(torch.zeros(2, 8, 16), torch.zeros(2, 4, 16), "add_norm")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        an.add_norm(torch.zeros(2, 16, device="meta"), torch.ones(16), torch.zeros(16), 1e-5)


def test_widths_the_paths_use_are_taken():
    for C in (64, 256, 640, 768):
        an._check(torch.zeros(3, C), torch.zeros(3, C, dtype=torch.bfloat16), "add_norm")
        an._check(torch.zeros(3, C, dtype=torch.bfloat16), None, "add_norm")


def test_grad_grid():
    """`grad_blocks`: one wave of the CTAs the launch bounds keep resident
    (BWD_CTAS_WIDE an SM at C 256, BWD_CTAS_GENERIC else; a cooperative
    launch refuses more), a row a warp where the rows are few, the rows
    covered with no empty CTA."""
    for C, ctas in ((256, an.BWD_CTAS_WIDE), (640, an.BWD_CTAS_GENERIC), (64, 1)):
        for rows in (16384, 8192, 2048, 1024, 77 * 270, 5, 1):
            blocks, per = an.grad_blocks(rows, 132, C)
            assert 1 <= blocks <= 132 * ctas and blocks * per >= rows
            assert (blocks - 1) * per < rows and per % an.WARPS == 0
    assert an.grad_blocks(1024, 132, 256) == (128, 8)  # the decoder: a row a warp
    assert an.grad_blocks(2048, 132, 256) == (256, 8)
    assert an.grad_blocks(16384, 132, 256) == (256, 64)  # the encoder: 8 rows a warp
    assert an.grad_blocks(1024, 132, 64) == (128, 8)


def test_divisor_is_the_keep_probability_rounded():
    """The kernels' and the plain versions' divisor: the keep probability in
    the branch's dtype, as flax forms it for a weak-typed Python float."""
    for p in (0.9, 0.7, 1.0, 0.5):
        assert an.divisor(p, torch.float32) == float(np.float32(p))
        assert an.divisor(p, torch.bfloat16) == float(jnp.asarray(p, jnp.bfloat16))
    assert an.divisor(0.9, torch.bfloat16) == 0.8984375
    assert an._divisor_of(torch.zeros(2, dtype=torch.bfloat16), 0.9) == 0.8984375


def test_kernel_quotient_is_the_division_on_every_bf16():
    """The bf16 dropout's product by the f32 reciprocal of the divisor,
    rounded to bf16 (`quotient<bf16>` of csrc/add_norm.cu, and `dropped` on
    bf16 through `reciprocal`), equals the IEEE quotient rounded to bf16
    (flax's) on all 65 536 bf16 bit patterns for every bf16 divisor in
    [0.5, 1] (every other keep probability differs from one of these by a
    power of two), NaNs at the same places."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    xb = torch.from_numpy(x.copy()).bfloat16()
    nan = torch.isnan(xb)
    keep = torch.ones_like(xb, dtype=torch.bool)
    divisors = (np.arange(0x3F00, 0x3F81, dtype=np.uint32) << 16).view(np.float32)
    for d in divisors:
        with np.errstate(all="ignore"):
            want = torch.from_numpy(x / d).bfloat16()  # numpy's f32 division is IEEE
            kernel = torch.from_numpy(x * (np.float32(1.0) / d)).bfloat16()
        port = an.dropped(xb, keep, float(d))
        assert float(np.float32(1.0) / d) == an.reciprocal(float(d))
        for got in (kernel, port):
            assert torch.equal(torch.isnan(got), nan) and torch.equal(torch.isnan(want), nan)
            assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16)), float(d)


def _emulated_param_sums(x, gy, stats, sms: int = 132) -> torch.Tensor:
    """(2, C) f32: dweight and dbias as one launch of `add_norm_bwd` sums them
    on a card of `sms` SMs: each lane's f32 sums over its warp's rows in row
    order (a fused multiply-add for dy * xhat), the CTA's 8 warps added in
    order into its partial row; then each column over the CTAs' rows, lane
    l of a warp adding rows l, l + 32, ... in order, and the lanes' sums in
    the butterfly of `warp_sum` (xor 16, 8, 4, 2, 1)."""
    C = x.shape[-1]
    mean, r = (stats[i].numpy().astype(np.float32)[:, None] for i in (0, 1))
    h, g = x.reshape(-1, C).float().numpy(), gy.reshape(-1, C).float().numpy()
    xh = (h - mean) * r  # f32, each operation rounded
    rows = h.shape[0]
    blocks, per = an.grad_blocks(rows, sms, C)
    pad = blocks * per - rows
    xh = np.concatenate([xh, np.zeros((pad, C), np.float32)])
    g = np.concatenate([g, np.zeros((pad, C), np.float32)])
    # CTA b's row j * WARPS + w is warp w's j-th
    xh = xh.reshape(blocks, per // an.WARPS, an.WARPS, C)
    g = g.reshape(blocks, per // an.WARPS, an.WARPS, C)
    pw = np.zeros((blocks, an.WARPS, C), np.float32)
    pb = np.zeros_like(pw)
    for j in range(per // an.WARPS):
        pw = (g[:, j].astype(np.float64) * xh[:, j] + pw).astype(np.float32)
        pb = pb + g[:, j]
    part = np.zeros((blocks, 2, C), np.float32)
    for w in range(an.WARPS):
        part += np.stack([pw[:, w], pb[:, w]], axis=1)
    lanes = np.zeros((32, 2, C), np.float32)
    for b in range(blocks):
        lanes[b % 32] += part[b]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    assert (lanes == lanes[:1]).all()  # every lane the same bits
    return torch.from_numpy(lanes[0])


@pytest.mark.parametrize("rows,C", [(1024, 256), (16384, 256), (2000, 640)])
def test_one_launch_param_sums_emulated(rows, C):
    """The one-launch backward's dweight and dbias, emulated over the grid of
    `grad_blocks`, within 1e-5 of the largest value of the f64 sums
    (`add_norm_param_grads_plain` in f64) at the decoder's 1 024 rows, the
    encoder's 16 384 and a generic width; the emulation adds the partial rows
    in the kernel's fixed order, so any CTA may come last."""
    x = _rows((rows, C), 80)
    gy = _grad((rows, C), 81)
    _, _, stats = an.add_norm_plain(x, torch.ones(C), torch.zeros(C), 1e-5)
    got = _emulated_param_sums(x, gy, stats)
    want = an.add_norm_param_grads_plain(x.double(), gy.double(), stats.double())
    _close(got[0], want[0], 1e-5, "dweight")
    _close(got[1], want[1], 1e-5, "dbias")


def test_source_constants():
    src = CSRC.read_text()
    for name, value in (("kVec", an.VEC), ("kMaxC", an.MAX_C), ("kThreads", an.THREADS),
                        ("kWideC", an.WIDE_C), ("kBwdCtasWide", an.BWD_CTAS_WIDE),
                        ("kBwdCtasGeneric", an.BWD_CTAS_GENERIC)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # y's operations each rounded as the plain version's torch ops round them
    assert ("__fadd_rn(__fmul_rn(__fsub_rn(v[k][e], mean), __fmul_rn(r, wv[e])), bv[e])"
            in src)
    assert "const float var = var_raw < 0.f ? 0.f : var_raw;" in src
    assert "const float r = rsqrtf(__fadd_rn(var, eps));" in src
    # the dropout's value: the IEEE quotient by the rounded keep probability,
    # rounded to branch's dtype (`quotient`, held below); its VJP the same
    # quotient of dx in branch's dtype
    assert "kept(in.keep[k], e) ? quotient<BrT>(d[e], keep_div, keep_inv) : 0.f" in src
    assert "kept(in.keep[k], e) ? quotient<BrT>(round_to<BrT>(d[e]), keep_div, keep_inv)" in src
    assert "const float keep_inv = __frcp_rn(keep_div);" in src
    assert "return round_to<bf16>(__fmul_rn(x, inv));" in src and "return __fdiv_rn(x, d);" in src
    assert "inv_keep" not in src
    # the clamp's backward: the term kept at var_raw == 0, dropped below
    assert ("const float c2 = in.var_raw >= 0.f ? __fdiv_rn(sb, static_cast<float>(width)) : 0.f;"
            in src)
    # one kernel a backward: a cooperative launch, a grid barrier, no atomics
    assert "add_norm_finish" not in src and "atomicAdd(" not in src and "atomicInc(" not in src
    assert "cg::this_grid().sync();" in src and "cudaLaunchAttributeCooperative" in src
