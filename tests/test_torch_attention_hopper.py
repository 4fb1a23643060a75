"""What the Hopper (wgmma) designs of the attention forward, dq and dk/dv
rely on, checked on the CPU: the route by shape, the base-2 online softmax,
the hoisted form of the dropout hash, the swizzled tile layout and dq's
arithmetic from the saved LSE.  The kernels
themselves run only on the card, where chip_smoke.py holds them against
their plain versions and against the first (mma.sync) design.

Tolerances.  The base-2 softmax against `attention_fwd_plain`, both f32:
1e-6 of the largest value (the two differ only in where f32 rounds: one
multiply by scale * log2(e) against a multiply by scale, exp2 against exp).
The hash and the layout are exact.  bf16 against the Pallas kernels in
interpret mode: 2e-2 absolute, as `test_torch_ops.py`; the emulation of the
wgmma dq against `attention_dq_plain` and against the Pallas `_dq_kernel`:
2e-2 of the largest value (ds is rounded to bf16 in all three; the
emulation differs in exp2 of a fused multiply-add against exp, and in
summing tile by tile).
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.attention_kernel import fused_attention
from ov3det_torch.ops.kernels import attention

CSRC = Path(attention.__file__).resolve().parents[2] / "csrc"
TILE = 64  # keys (forward, dq) or queries (dk/dv) per loop tile of the wgmma kernels
HASH_ROW, HASH_COL = np.uint32(0xC2B2AE35), np.uint32(0x27D4EB2F)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("dtype,D,NQ,NK,want", [
    (torch.bfloat16, 64, 2048, 2048, "wgmma"),  # the encoder of both configs
    (torch.bfloat16, 64, 1024, 1024, "wgmma"),
    (torch.bfloat16, 64, 128, 256, "wgmma"),
    (torch.bfloat16, 64, 192, 192, "mma"),      # a multiple of 64, not of 128
    (torch.bfloat16, 64, 128, 192, "mma"),
    (torch.bfloat16, 64, 64, 128, "mma"),
    (torch.bfloat16, 32, 2048, 2048, "mma"),
    (torch.bfloat16, 16, 256, 256, "mma"),
    (torch.float32, 64, 2048, 2048, "mma"),
    (torch.float32, 32, 256, 256, "mma"),
])
def test_route_depends_on_the_shape_alone(dtype, D, NQ, NK, want):
    assert attention._route(dtype, D, NQ, NK) == want


def test_route_mirrors_the_launch_functions_rule():
    header = (CSRC / "attention_hopper.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", header))
    assert int(consts["kHeadDim"]) == attention._HOPPER_D
    assert int(consts["kCtaRows"]) == attention._HOPPER_TILE
    assert int(consts["kLoopRows"]) == TILE
    assert ("return is_bf16 && D == kHeadDim && NQ % kCtaRows == 0 && NK % kCtaRows == 0;"
            in header)
    for source, entries in (("attention_fwd.cu", ("ov3_attention_fwd",)),
                            ("attention_bwd.cu", ("ov3_attention_dq", "ov3_attention_dkv"))):
        text = (CSRC / source).read_text()
        # one rule per kernel, and both entry points of each
        assert text.count("by_shape && hopper::takes(NQ, NK, D, is_bf16)") == len(entries)
        for entry in entries:
            assert f'extern "C" int {entry}(' in text and f'extern "C" int {entry}_mma(' in text


@pytest.mark.parametrize("name", ["attention_fwd", "attention_dq", "attention_dkv"])
@pytest.mark.parametrize("impl", ["mma", "wgmma"])
def test_impl_is_refused_on_cpu_tensors(name, impl):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 128, 64, generator=g).bfloat16() for _ in range(4))
    wrapper = getattr(attention, name)
    before = (wrapper.launches, wrapper.radius_launches)
    with pytest.raises(ValueError, match="_impl"):
        if name == "attention_fwd":
            wrapper(q, k, v, _impl=impl)
        else:
            stats = torch.zeros(2, 128, 1)
            wrapper(q, k, v, do, stats, stats, _impl=impl)
    assert (wrapper.launches, wrapper.radius_launches) == before
    if name == "attention_fwd":  # without it the CPU still takes the plain version
        out, _ = wrapper(q, k, v)
        np.testing.assert_array_equal(out.float().numpy(),
                                      attention.attention_fwd_plain(q, k, v)[0].float().numpy())


# ------------------------------------------------------- base-2 softmax
def _base2_forward(q, k, v, radius=None):
    """The wgmma forward's arithmetic in plain f32 PyTorch: tiles of 64
    keys, the score times scale * log2(e), a running max in base-2 units,
    exp2, the radius as a select against -1e9, the LSE converted back."""
    BH, NQ, D = q.shape
    c = np.float32(attention._scale(D)) * np.float32(1.4426950408889634)
    m = torch.full((BH, NQ, 1), -math.inf)
    l = torch.zeros(BH, NQ, 1)
    o = torch.zeros(BH, NQ, D)
    for kt in range(0, k.shape[1], TILE):
        x = torch.matmul(q, k[:, kt:kt + TILE].transpose(1, 2)) * float(c)
        if radius is not None:
            q_xyz, k_xyz, r2 = radius
            inside = attention.radius_mask(q_xyz, k_xyz[:, kt:kt + TILE], r2)
            heads = BH // q_xyz.shape[0]
            x = torch.where(inside.repeat_interleave(heads, dim=0), x, torch.tensor(-1e9))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        a = torch.exp2(m - m_new)  # 0 on the first tile
        p = torch.exp2(x - m_new)
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + torch.matmul(p, v[:, kt:kt + TILE])
        m = m_new
    return o / l, m * 0.6931471805599453 + torch.log(l)


@pytest.mark.parametrize("with_radius", [False, True])
def test_base2_online_softmax_equals_the_plain_version(with_radius):
    rng = np.random.default_rng(11)
    B, H, N, D = 2, 2, 256, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B * H, N, D)).astype(np.float32))
               for _ in range(3))
    radius = None
    if with_radius:
        # clustered tokens: the keys of whole 64-key tiles lie outside the
        # radius of most rows, the first tile included
        xyz = rng.uniform(-0.1, 0.1, size=(B, N, 3)).astype(np.float32)
        xyz += 5.0 * (np.arange(N) // TILE)[None, :, None].astype(np.float32)
        radius = (torch.from_numpy(xyz), torch.from_numpy(xyz), 0.3 ** 2)
        inside = attention.radius_mask(*radius)
        tiles_outside = ~inside.view(B, N, N // TILE, TILE).any(-1)
        assert tiles_outside[:, TILE:, 0].all()  # the first tile, for every later row
        assert inside.diagonal(dim1=1, dim2=2).all()  # each row sees its own token
    out, lse = _base2_forward(q, k, v, radius)
    want, want_lse = attention.attention_fwd_plain(q, k, v, radius=radius)
    assert not out.isnan().any() and not lse.isnan().any()
    assert ((out - want).abs().max() / want.abs().max()).item() <= 1e-6
    assert ((lse - want_lse).abs().max() / want_lse.abs().max()).item() <= 1e-6


# -------------------------------------------------------- hoisted hash
def _finalise(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _hoisted_mask(seed, BH, NQ, NK, threshold, kernel):
    """The (BH, NQ, NK) keep mask as the wgmma kernels form the hash, in
    wrapping uint32 arithmetic: the term of a thread's own rows (queries in
    the forward and dq, keys in dk/dv) once, the other term starting at the
    thread's column pair 2 * t4 and advanced by 64 * its constant a tile,
    plus a compile-time constant (8 n + j) * its constant."""
    keep = np.zeros((BH, NQ, NK), bool)
    rows_own = kernel in ("fwd", "dq")  # their loop walks the keys in tiles of 64
    own_c, loop_c = (HASH_ROW, HASH_COL) if rows_own else (HASH_COL, HASH_ROW)
    n_own, n_loop = (NQ, NK) if rows_own else (NK, NQ)
    with np.errstate(over="ignore"):
        for bh in range(BH):
            base = np.uint32(seed & 0xFFFFFFFF) * np.uint32(0x9E3779B9) + np.uint32(bh) * np.uint32(0x85EBCA6B)
            own = base + np.arange(n_own, dtype=np.uint32) * own_c  # once a thread
            for t4 in range(4):
                moving = np.uint32(2 * t4) * loop_c
                for tile in range(n_loop // TILE):
                    for n in range(8):
                        for j in range(2):
                            other = tile * TILE + 8 * n + 2 * t4 + j
                            h = _finalise(own + (moving + np.uint32(8 * n + j) * loop_c))
                            if rows_own:
                                keep[bh, :, other] = h >= np.uint32(threshold)
                            else:
                                keep[bh, other, :] = h >= np.uint32(threshold)
                    moving = moving + np.uint32(TILE) * loop_c  # advanced once a tile
    return keep


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 31 - 1, -2 ** 31])
def test_hoisted_hash_equals_drop_mask_exactly(seed, kernel):
    BH, NQ, NK, rate = 3, 128, 192, 0.1
    keep_scale, threshold = attention.dropout_params(rate)
    want = attention.drop_mask(torch.tensor([seed], dtype=torch.int32), BH, NQ, NK, rate).numpy()
    got = _hoisted_mask(seed, BH, NQ, NK, threshold, kernel)
    np.testing.assert_array_equal(got, want != 0)  # bit for bit
    assert set(np.unique(want)) == {np.float32(0.0), np.float32(keep_scale)}


# ------------------------------------------------------ swizzled layout
def _swizzled_offset(row, chunk):
    """`hopper::swizzled_offset`: the byte offset of 16-byte chunk `chunk`
    of row `row` in a tile of 128-byte rows with the 128-byte swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


@pytest.mark.parametrize("rows", [64, 128])
def test_swizzled_offset_is_a_bijection_that_keeps_chunks_whole(rows):
    header = (CSRC / "attention_hopper.cuh").read_text()
    assert "static_cast<uint32_t>(row) * 128u + (static_cast<uint32_t>(chunk ^ (row & 7)) << 4)" in header
    offsets = np.array([[_swizzled_offset(r, c) for c in range(8)] for r in range(rows)])
    assert sorted(offsets.ravel()) == list(range(0, rows * 128, 16))  # onto, one to one
    assert (offsets % 16 == 0).all()  # a chunk's 8 bf16 values stay together
    assert (offsets // 128 == np.arange(rows)[:, None]).all()  # and in their row's 128 bytes
    # address bits 4-6 xor bits 7-9: what the descriptors' swizzle mode undoes
    linear = np.arange(rows)[:, None] * 128 + np.arange(8)[None, :] * 16
    np.testing.assert_array_equal(offsets, linear ^ (((linear >> 7) & 7) << 4))
    # the eight rows of a group put one column chunk in eight different chunks' banks
    for c in range(8):
        assert len({(_swizzled_offset(r, c) % 128) for r in range(8)}) == 8


# --------------------------------- the plain versions at a wgmma-route shape
def test_plain_versions_match_pallas_at_a_shape_the_wgmma_design_takes():
    rng = np.random.default_rng(21)
    B, N, H, D, rate, seed = 1, 256, 2, 64, 0.1, 99
    q, k, v, g = (rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(4))
    assert attention._route(torch.bfloat16, D, N, N) == "wgmma"

    def fn(q, k, v):
        return fused_attention(q, k, v, dropout_rate=rate, dropout_seed=seed, interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jnp.bfloat16))

    def heads(a):  # (B, N, H, D) -> (B*H, N, D)
        t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, N, D)))
        return t.bfloat16()

    tq, tk, tv = (heads(a).requires_grad_() for a in (q, k, v))
    out = attention.fused_attention(tq, tk, tv, rate, torch.tensor([seed], dtype=torch.int32))
    out.backward(heads(g))

    def back(t):  # (B*H, N, D) -> (B, N, H, D)
        return t.detach().float().numpy().reshape(B, H, N, D).transpose(0, 2, 1, 3)

    np.testing.assert_allclose(back(out), np.asarray(want.astype(jnp.float32)), rtol=0, atol=2e-2)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(back(t.grad), np.asarray(w.astype(jnp.float32)), rtol=0, atol=2e-2)


# ------------------------------------------------ the wgmma dq's arithmetic
def _dq_emulation(q, k, v, do, lse, delta, rate=0.0, seed=None, radius=None):
    """The wgmma dq's arithmetic in plain f32 PyTorch: tiles of 64 keys, the
    probabilities as exp2 of one multiply-add from the saved LSE times
    log2(e), the radius as a select to 0, the mask from the hash, ds rounded
    to bf16 before ds k, the sum over the tiles in f32 in their order."""
    BH, NQ, D = q.shape
    scale = np.float32(attention._scale(D))
    c = float(scale * np.float32(1.4426950408889634))
    lse2 = lse * float(np.float32(1.4426950408889634))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    mask = None if rate == 0.0 else attention.drop_mask(seed, BH, NQ, k.shape[1], rate)
    acc = torch.zeros(BH, NQ, D)
    for kt in range(0, k.shape[1], TILE):
        cols = slice(kt, kt + TILE)
        s = torch.matmul(qf, kf[:, cols].transpose(1, 2))
        dp = torch.matmul(dof, vf[:, cols].transpose(1, 2))
        e = torch.exp2(s * c - lse2)
        if radius is not None:
            q_xyz, k_xyz, r2 = radius
            inside = attention.radius_mask(q_xyz, k_xyz[:, cols], r2)
            e = torch.where(inside.repeat_interleave(BH // q_xyz.shape[0], dim=0), e,
                            torch.tensor(0.0))
        if mask is not None:
            dp = dp * mask[:, :, cols]
        ds = e * (dp - delta) * float(scale)
        acc += torch.matmul(ds.bfloat16().float(), kf[:, cols])
    return acc.to(q.dtype)


@pytest.mark.parametrize("with_radius", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_dq_emulation_matches_plain_and_pallas(rate, with_radius):
    rng = np.random.default_rng(31)
    B, N, H, D, seed = 1, 256, 2, 64, 5
    q, k, v, g = (rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(4))
    assert attention._route(torch.bfloat16, D, N, N) == "wgmma"
    xyz = rng.uniform(0.0, 1.5, size=(B, N, 3)).astype(np.float32)
    r2 = 0.5 ** 2
    extra = dict(q_xyz=jnp.asarray(xyz), k_xyz=jnp.asarray(xyz), radius_sq=r2) if with_radius else {}

    def fn(q, k, v):
        return fused_attention(q, k, v, dropout_rate=rate, dropout_seed=seed, interpret=True,
                               **extra)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    pallas_dq = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
    pallas_dq = pallas_dq.transpose(0, 2, 1, 3).reshape(B * H, N, D)

    def heads(a):  # (B, N, H, D) -> (B*H, N, D)
        t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, N, D)))
        return t.bfloat16()

    tq, tk, tv, do = (heads(a) for a in (q, k, v, g))
    tseed = torch.tensor([seed], dtype=torch.int32)
    radius = (torch.from_numpy(xyz), torch.from_numpy(xyz), r2) if with_radius else None
    if with_radius:
        share = attention.radius_mask(*radius).float().mean().item()
        assert 0.05 < share < 0.6  # the radius cuts most pairs and keeps some
    out, lse = attention.attention_fwd_plain(tq, tk, tv, rate, tseed, radius)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    got = _dq_emulation(tq, tk, tv, do, lse, delta, rate, tseed, radius).float()
    want = attention.attention_dq_plain(tq, tk, tv, do, lse, delta, rate, tseed, radius).float()
    assert not got.isnan().any()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    assert (np.abs(got.numpy() - pallas_dq).max() / np.abs(pallas_dq).max()) <= 2e-2
