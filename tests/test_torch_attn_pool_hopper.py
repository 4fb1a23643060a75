"""CLIP's attention pool as the Hopper kernels compute it, on the CPU.

`pool_tokens` and `pool_attend` (`ov3det_torch/ops/kernels/attn_pool.py`)
run `csrc/attn_pool.cu` on the card only; here their plain versions are
held against the einsum code they replace in `AttentionPool2d.forward` (the
mean token by `torch.mean`, the concatenated tokens, two einsums and a
softmax) and, through the module, against the JAX package's
`AttentionPool2d` with the same weights (`models.convert`): f32 within 1e-5
of the largest value, bf16 cosine >= 0.999 a region.  The plain mean token
sums in index order, `torch.mean` in its own: f32 within 1e-6 relative, bf16
within 1 bf16 ulp.  Small width: C 64, 4 heads, a 3 x 3 grid and a 5 x 5 one
read through the resized positional grid.

Both designs' arithmetic is emulated: the first (`pool_attend_mma`: exact
bf16 products, the weights in three bf16 terms) and the routed cluster
(`pool_attend_cluster`: partial logits a channel slice of C / CLUSTER summed
in rank order, the softmax in a warp's order, z in three terms), each within
1 bf16 ulp of `pool_attend_plain`; the module with the cluster's order
against JAX.  The cluster's route, shared-memory arithmetic and register
arrays are held against the source's constants, and `_impl` is checked.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ov3det.models import clip_resnet as jcr
from ov3det_torch.models import clip_resnet as tcr
from ov3det_torch.models.convert import from_flax_teacher_variables
from ov3det_torch.ops.kernels import attn_pool as kap

C, HEADS, SPACIAL, OUT = 64, 4, 3, 32
R = 5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _inputs(rng, side: int, dtype: torch.dtype):
    """x (R, L, C), pos (L + 1, C), u (R, heads, C) in dtype, L = side^2."""
    L = side * side
    x = torch.from_numpy(rng.normal(size=(R, L, C)).astype(np.float32) * 2).to(dtype)
    pos = torch.from_numpy(rng.normal(size=(L + 1, C)).astype(np.float32) * 0.2).to(dtype)
    u = torch.from_numpy(rng.normal(size=(R, HEADS, C)).astype(np.float32) * 0.3).to(dtype)
    return x, pos, u


def _former_tokens(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The tokens as `AttentionPool2d.forward` built them before the kernels:
    the mean token by torch.mean, the concatenation, the positional add."""
    mean = x.float().mean(dim=1, keepdim=True)
    return torch.cat([mean.to(x.dtype), x], dim=1) + pos[None]


def _former_z(tokens: torch.Tensor, u: torch.Tensor, out_dtype) -> torch.Tensor:
    tokens_f = tokens.float()
    attn = torch.einsum("bkc,bhc->bhk", tokens_f, u.float()) / math.sqrt(C // HEADS)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhk,bkc->bhc", attn, tokens_f).to(out_dtype)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().numpy(), b.float().numpy()
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float((np.abs(a - b) / ulp).max())


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_tokens_plain_matches_the_mean(dtype, side):
    x, pos, _ = _inputs(np.random.default_rng(side), side, dtype)
    got = kap.pool_tokens_plain(x, pos[0])
    want = _former_tokens(x, pos)[:, 0]
    assert got.dtype == dtype and got.shape == (R, C)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    else:
        assert _bf16_ulps(got, want) <= 1
    # the order is the index order, each sum rounded in f32 on its own
    acc = np.zeros((R, C), np.float32)
    for k in range(x.shape[1]):
        acc = acc + x[:, k].float().numpy()
    mean = torch.from_numpy(acc / np.float32(x.shape[1])).to(dtype)
    assert torch.equal(got, mean + pos[0])
    assert torch.equal(kap.pool_tokens(x, pos[0]), got)


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_pool_attend_plain_matches_the_einsums(dtype, out_dtype, side):
    x, pos, u = _inputs(np.random.default_rng(10 + side), side, dtype)
    tokens = _former_tokens(x, pos)
    got = kap.pool_attend_plain(x, pos, tokens[:, 0], u, C // HEADS, out_dtype)
    assert got.dtype == out_dtype and got.shape == (R, HEADS, C)
    assert torch.equal(got, _former_z(tokens, u, out_dtype))  # the same operations
    assert torch.equal(kap.pool_attend(x, pos, tokens[:, 0], u, C // HEADS, out_dtype), got)
    # with its own token 0 it moves no further than the mean token did
    z = kap.pool_attend_plain(x, pos, kap.pool_tokens_plain(x, pos[0]), u, C // HEADS, out_dtype)
    want = _former_z(tokens, u, torch.float32)
    assert (z.float() - want).abs().max() <= 2e-2 * want.abs().max()


def _jax_pool(side: int, dtype, seed: int):
    """The JAX module, its variables (random biases, positional grid) and a
    seeded input of side x side tokens."""
    mod = jcr.AttentionPool2d(C, HEADS, SPACIAL, OUT, dtype=dtype)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, side, side, C)).astype(np.float32)
    variables = jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.asarray(x, dtype or jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables)["params"]
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        params[name]["bias"] = rng.normal(size=params[name]["bias"].shape).astype(np.float32) * 0.1
    return mod, {"params": params}, x


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_jax(dtype, side, monkeypatch):
    jdt, tdt = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    mod, variables, x = _jax_pool(side, jdt, 20 + side)
    want = np.asarray(jax.jit(mod.apply)(variables, jnp.asarray(x, jdt or jnp.float32)),
                      np.float32)
    pool = tcr.AttentionPool2d(C, HEADS, SPACIAL, OUT, dtype=tdt)
    pool.load_state_dict(from_flax_teacher_variables(variables))
    calls = []
    for name in ("pool_tokens", "pool_attend"):  # the module reaches both wrappers
        fn = getattr(tcr, name)
        monkeypatch.setattr(tcr, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    with torch.no_grad():
        got = pool(torch.from_numpy(x).to(tdt or torch.float32)).numpy()
    assert calls == ["pool_tokens", "pool_attend"]
    assert got.shape == (R, OUT) and got.dtype == np.float32
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999


def test_argument_checks():
    x, pos, u = _inputs(np.random.default_rng(1), 3, torch.bfloat16)
    t0 = kap.pool_tokens(x, pos[0])
    with pytest.raises(ValueError, match="f32 or bf16 tokens"):
        kap.pool_tokens(x.half(), pos[0].half())
    with pytest.raises(ValueError, match=r"pos\[0\]"):
        kap.pool_tokens(x, pos[0].float())
    with pytest.raises(ValueError, match=r"pos\[0\]"):
        kap.pool_tokens(x, pos[:2])
    with pytest.raises(ValueError, match="pos"):
        kap.pool_attend(x, pos[1:], t0, u, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="token0"):
        kap.pool_attend(x, pos, t0[:2], u, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="u"):
        kap.pool_attend(x, pos, t0, u.float(), 16, torch.bfloat16)
    with pytest.raises(ValueError, match="u"):
        kap.pool_attend(x, pos, t0, u[..., :8], 16, torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        kap.pool_attend(x, pos, t0, u, 16, torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        kap.pool_attend(x, pos, t0, u, 0, torch.bfloat16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kap.pool_attend(*(t.to("meta") for t in (x, pos, t0, u)), 16, torch.bfloat16)
    assert kap.pool_tokens.launches == 0 and kap.pool_attend.launches == 0


def test_source_mirrors_the_wrapper():
    """The wrapper's limits are the source's."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / kap.SOURCE).read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxTokens"] == kap.MAX_TOKENS and consts["kMaxHeads"] == kap.MAX_HEADS
    assert consts["kTile"] == kap.TILE and consts["kThreads"] == kap.THREADS
    assert not re.search(r"\batomic\w*\s*\(|\bred\.", src)  # fixed-order sums, no atomic op
    # the cluster design: its size, slice and limits, and both designs' entries
    assert consts["kCluster"] == kap.CLUSTER <= 8  # the portable cluster limit
    assert consts["kClusterMaxSlice"] == kap.CLUSTER_MAX_SLICE
    assert consts["kClusterMaxTokens"] == kap.CLUSTER_MAX_TOKENS
    assert consts["kClusterMaxHeads"] == kap.CLUSTER_MAX_HEADS
    assert "pool_attend_cluster<" in src and "pool_attend_mma<" in src
    entries = set(re.findall(r'extern "C" int (ov3_\w+)\(', src))
    assert entries == set(kap._SIGNATURES)
    assert {kap._entry(None, True), kap._entry("first", True)} <= entries


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even), kept in f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("side", [3, 9])
def test_tensor_core_arithmetic_within_tolerance(side):
    """`pool_attend_mma`'s numbers, emulated: bf16 products exact, f32 sums
    (here exact, in f64), the softmax weights split into three bf16 terms
    (each the rounding of what the terms before leave): z within 1 bf16 ulp
    of the plain version, and the split within 2^-24 of each weight."""
    rng = np.random.default_rng(40 + side)
    x, pos, u = _inputs(rng, side, torch.bfloat16)
    token0 = kap.pool_tokens_plain(x, pos[0])
    tokens = torch.cat([token0[:, None], x + pos[None, 1:]], dim=1).float().numpy()
    logits = np.einsum("bkc,bhc->bhk", tokens.astype(np.float64), u.float().numpy())
    logits = (logits.astype(np.float32) / np.float32(math.sqrt(C // HEADS))).astype(np.float64)
    a = np.exp(logits - logits.max(-1, keepdims=True))
    a = (a / a.sum(-1, keepdims=True)).astype(np.float32)
    terms, rest = [], a
    for _ in range(3):
        terms.append(_bf16(rest))
        rest = (rest - terms[-1]).astype(np.float32)
    split = sum(t.astype(np.float64) for t in terms)
    assert np.abs(split - a).max() <= 2.0 ** -24 * np.abs(a).max()
    z = np.einsum("bhk,bkc->bhc", split, tokens.astype(np.float64)).astype(np.float32)
    got = torch.from_numpy(z).to(torch.bfloat16)
    want = kap.pool_attend_plain(x, pos, token0, u, C // HEADS, torch.bfloat16)
    assert _bf16_ulps(got, want) <= 1


def _xor_sum(lanes: np.ndarray) -> np.float32:
    """A warp's sum of its 32 lanes' f32 values by the xor-shuffle tree."""
    s = lanes.astype(np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        s = (s + s[np.arange(32) ^ o]).astype(np.float32)
    assert np.all(s == s[0])
    return s[0]


def _cluster_z(x, pos, token0, u, head_dim: int, out_dtype) -> torch.Tensor:
    """`pool_attend_cluster` of csrc/attn_pool.cu emulated: each of the
    CLUSTER CTAs' partial logits over its channel slice (the tensor cores'
    exact bf16 products summed, here in f64, rounded to f32), the partials
    summed in rank order in f32, divided by sqrt(hd); the softmax of a head
    as its warp takes it (lane l the tokens l, l + 32, l + 64: the max, expf,
    each lane's sum in order, then the xor tree, a divide); z of each slice
    from the weights' three bf16 terms (exact products, here summed in f64)."""
    tokens = torch.cat([token0[:, None], x + pos[None, 1:]], dim=1).float().numpy()
    uf = u.float().numpy()
    R, L, C = tokens.shape
    heads = uf.shape[1]
    S = C // kap.CLUSTER
    sqrt_hd = np.float32(math.sqrt(head_dim))
    logits = np.zeros((R, heads, L), np.float32)
    for rank in range(kap.CLUSTER):
        sl = slice(rank * S, (rank + 1) * S)
        part = np.einsum("bkc,bhc->bhk", tokens[..., sl].astype(np.float64), uf[..., sl])
        logits = (logits + part.astype(np.float32)).astype(np.float32)
    logits = (logits / sqrt_hd).astype(np.float32)
    lanes = np.full((R, heads, 96), -np.inf, np.float32)
    lanes[..., :L] = logits
    m = lanes.reshape(R, heads, 3, 32).max(axis=(2, 3), keepdims=True).reshape(R, heads, 1)
    e = np.where(np.arange(96) < L, np.exp((lanes - m).astype(np.float32)).astype(np.float32), 0)
    a = np.zeros((R, heads, L), np.float32)
    for b in range(R):
        for h in range(heads):
            per_lane = np.zeros(32, np.float32)
            for j in range(3):  # a lane's tokens in order
                per_lane = (per_lane + e[b, h, 32 * j:32 * j + 32]).astype(np.float32)
            a[b, h] = (e[b, h, :L] / _xor_sum(per_lane)).astype(np.float32)
    terms, rest = [], a
    for _ in range(3):
        terms.append(_bf16(rest))
        rest = (rest - terms[-1]).astype(np.float32)
    z = sum(np.einsum("bhk,bkc->bhc", t.astype(np.float64), tokens.astype(np.float64))
            for t in reversed(terms))
    return torch.from_numpy(z.astype(np.float32)).to(out_dtype)


@pytest.mark.parametrize("side", [3, 9])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cluster_order_within_tolerance(side, out_dtype):
    """The cluster's order (partial logits a channel slice summed in rank
    order, the warp's softmax, z in three bf16 terms) within 1 bf16 ulp of
    `pool_attend_plain` at every element in bf16, 1e-5 of the largest value
    in f32 (the f32 logits in another order)."""
    rng = np.random.default_rng(50 + side)
    x, pos, u = _inputs(rng, side, torch.bfloat16)
    token0 = kap.pool_tokens_plain(x, pos[0])
    got = _cluster_z(x, pos, token0, u, C // HEADS, out_dtype)
    want = kap.pool_attend_plain(x, pos, token0, u, C // HEADS, out_dtype)
    if out_dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("side", [3, 5])
def test_module_in_the_cluster_order_matches_jax(side, monkeypatch):
    """The bf16 module with its attention in the cluster's order against the
    JAX package's `AttentionPool2d` at the module test's tolerance (cosine
    >= 0.999 a region)."""
    mod, variables, x = _jax_pool(side, jnp.bfloat16, 60 + side)
    want = np.asarray(jax.jit(mod.apply)(variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    pool = tcr.AttentionPool2d(C, HEADS, SPACIAL, OUT, dtype=torch.bfloat16)
    pool.load_state_dict(from_flax_teacher_variables(variables))
    monkeypatch.setattr(tcr, "pool_attend", _cluster_z)
    with torch.no_grad():
        got = pool(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999


def _cluster_smem(tokens: int, heads: int, C: int, out_bytes: int) -> int:
    """The cluster's shared memory a CTA, as the source's header counts it:
    the token rows (or z's staging, the larger), aux (u's rows or the
    weights' three bf16 terms, the larger) and the f32 partial logits."""
    S = C // kap.CLUSTER
    Lp, Hp = -(-tokens // 16) * 16, -(-heads // 16) * 16
    token_rows = max(Lp * (S + 8) * 2, heads * (S + 8) * out_bytes)
    aux = max(Hp * (S + 8) * 2, 3 * Hp * (Lp + 8) * 2)
    return token_rows + aux + Hp * Lp * 4


def test_cluster_route_and_shared_memory():
    """The teacher's pool (82 tokens, 40 heads, C 2560) runs the cluster:
    112,896 bytes a CTA in bf16 or f32 out, two CTAs an SM within Hopper's
    228 KB (1 KB reserved a CTA); the register arrays cover its slice,
    tokens and heads; shapes past a limit take the first design."""
    assert kap.cluster_takes(82, 40, 2560)
    assert _cluster_smem(82, 40, 2560, 2) == _cluster_smem(82, 40, 2560, 4) == 112_896
    most = _cluster_smem(kap.CLUSTER_MAX_TOKENS, kap.CLUSTER_MAX_HEADS,
                         kap.CLUSTER * kap.CLUSTER_MAX_SLICE, 4)
    assert 2 * (most + 1024) <= 228 * 1024
    # the source's register arrays: pass 2's n-tiles a warp, the softmax's
    # tokens a lane and heads a warp, the positional chunks a thread
    warps = kap.THREADS // 32
    assert kap.CLUSTER_MAX_SLICE // 8 // warps == 5
    assert kap.CLUSTER_MAX_TOKENS // 32 == 3 and kap.CLUSTER_MAX_HEADS // kap.CLUSTER <= warps
    assert -(-(kap.CLUSTER_MAX_TOKENS - 1) * (kap.CLUSTER_MAX_SLICE // 8) // kap.THREADS) == 15
    for shape in ((82, 40, 2560 + 64), (82, 40, 2560 + 2560), (97, 40, 2560), (82, 49, 2560),
                  (82, 40, 64)):
        assert not kap.cluster_takes(*shape)
    assert kap.cluster_takes(96, 48, 2048) and kap.cluster_takes(2, 1, 128)


def test_impl_argument():
    """`_impl` is None (the routed design) or "first", and chooses between
    CUDA kernels only: CPU tensors refuse "first"; nothing counts a launch."""
    x, pos, u = _inputs(np.random.default_rng(2), 3, torch.bfloat16)
    t0 = kap.pool_tokens(x, pos[0])
    with pytest.raises(ValueError, match="CUDA kernels"):
        kap.pool_attend(x, pos, t0, u, 16, torch.bfloat16, _impl="first")
    with pytest.raises(ValueError, match="_impl"):
        kap.pool_attend(x, pos, t0, u, 16, torch.bfloat16, _impl="cluster")
    assert kap.pool_attend.launches == 0
