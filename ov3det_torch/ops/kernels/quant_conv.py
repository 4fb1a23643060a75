"""The teacher's W8A8 trunk conv: the CUDA kernels' wrappers and their plain
versions.

`quant_conv` launches `ov3det_torch/csrc/quant_conv.cu`'s int8
implicit-GEMM conv, the counterpart of `QuantConv.__call__`
(`ov3det/models/clip_resnet.py:99-128`: XLA's int8 `conv_general_dilated`
with int32 accumulation and the elementwise ops XLA fuses around it; not a
Pallas kernel), with its epilogue carrying the dequant, the folded
BatchNorm, the block's residual and ReLU and the next conv's quantise.  Two
designs compute it: `quant_conv_wgmma` (warp-specialised `wgmma` on a
persistent grid) for C_in a multiple of 16, the first design
(`quant_conv_kernel`, `mma.sync`) for the rest (`_route`); `_impl="mma"`
keeps a CUDA call on the first design.
`pool_quantize` launches the pass that quantises what no epilogue can: an
input as it is, or after a 2 x 2 average pool (the anti-aliased stride-2
blocks, the stem's output): `pool_quantize_vec` (16 channels a thread,
32-bit indices, no division on the common path) for every tensor below
2^31 elements (`pass_launch`), the first design (`pool_quantize_kernel`)
above; `_impl="first"` keeps a CUDA call on the first design.

The plain versions (`quant_conv_plain`, `pool_quantize_plain`) are the
unfused module path's torch ops in the same order (`int8_conv`: an im2col
of the int8 activations and `torch._int_mm`; then the elementwise ops): the
CPU path, and the kernels' oracle on the card, which the kernels equal bit
for bit.  A CUDA tensor never takes them through the wrappers: those launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/quant_conv.cu"
REPLACES = ("ov3det/models/clip_resnet.py:99 (QuantConv.__call__: int8 conv_general_dilated "
            "and its dequant, XLA, not Pallas)")
POOL_REPLACES = ("ov3det/models/clip_resnet.py:53 (_avg_pool) and :116 (QuantConv's quantise): "
                 "XLA, not Pallas")


def im2col_int8(xq: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * H * W, k * k * C), stride 1, K in (kh, kw,
    C) order, zero padding (the quantized zero)."""
    B, H, W, C = xq.shape
    if kernel_size == 1:
        return xq.reshape(B * H * W, C)
    p = padding
    xp = F.pad(xq, (0, 0, p, p, p, p))
    Ho, Wo = H + 2 * p - kernel_size + 1, W + 2 * p - kernel_size + 1
    views = [xp[:, i:i + Ho, j:j + Wo, :] for i in range(kernel_size) for j in range(kernel_size)]
    return torch.stack(views, dim=3).reshape(B * Ho * Wo, kernel_size * kernel_size * C)


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, kernel_size: int,
              padding: int) -> torch.Tensor:
    """Exact int32 conv of int8 (B, H, W, C) with the int8 (C_out, K) kernel
    -> (B, H', W', C_out), as `torch._int_mm(im2col, kernel_q.t())`.  On the
    card `_int_mm` takes more than 16 rows and K, C_out multiples of 8: the
    trunk's channels are, and fewer rows are padded with zero rows."""
    B = xq.shape[0]
    a = im2col_int8(xq, kernel_size, padding).contiguous()
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = F.pad(a, (0, 0, 0, 17 - M))
    y = torch._int_mm(a, kernel_q.t())[:M]
    Ho = xq.shape[1] + 2 * padding - kernel_size + 1
    return y.view(B, Ho, -1, kernel_q.shape[0])


def quantize_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8, in f32, round half to even."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def quant_conv_plain(xq: torch.Tensor, kernel_q: torch.Tensor, k: int, padding: int,
                     s_x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None, relu: bool = False,
                     s_next: Optional[torch.Tensor] = None, out_bf16: bool = True,
                     dtype: Optional[torch.dtype] = torch.bfloat16) -> tuple:
    """The W8A8 conv and its epilogue as torch ops: xq (B, H, W, C_in) int8,
    kernel_q (C_out, k * k * C_in) int8, stride 1 -> (out, out_q).

    out = the int32 conv as f32, times (s_x * scale), plus `bias`, cast to
    `dtype` (None: f32); plus `residual` (of `dtype`, rounded again); ReLU.
    `out` is returned when `out_bf16` (the output in the compute dtype, bf16
    on the trunk), else None; `out_q`, the output quantised at `s_next`
    for the next conv, when `s_next` is given, else None."""
    y = int8_conv(xq, kernel_q, k, padding)
    out = y.float() * (s_x * scale)
    if bias is not None:
        out = out + bias
    if dtype is not None:
        out = out.to(dtype)
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.relu(out)
    return (out if out_bf16 else None), (quantize_plain(out, s_next) if s_next is not None else None)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax `nn.avg_pool(x, (k, k), strides=(k, k))` (VALID) on (B, H, W, C),
    as `F.avg_pool2d` on the channels-last NCHW view: the k * k values summed
    in f32, row by row, then divided, rounded once to x's dtype."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def pool_quantize_plain(x: torch.Tensor, pool: int, scales: Sequence[torch.Tensor]) -> list:
    """(B, H, W, C) -> one (B, H / pool, W / pool, C) int8 tensor a scale:
    `avg_pool(x, pool)` when pool > 1, then each quantised at its scale."""
    if pool > 1:
        x = avg_pool(x, pool)
    return [quantize_plain(x, s) for s in scales]


WGMMA_ROWS = 128  # output pixels a tile of the wgmma design


def _route(c_in: int, c_out: int, k: int) -> str:
    """The design `ov3_quant_conv` launches for a conv, as `wg::takes` of
    `csrc/quant_conv.cu` decides it: "wgmma" when C_in is a multiple of 16
    (its 16-byte gathers never straddle two taps), else "mma" (the first
    design, 8-byte gathers).  C_out and k do not enter: every C_out that is
    a multiple of 8 has an N tile, and any k with 2 * padding == k - 1."""
    del c_out, k
    return "wgmma" if c_in % 16 == 0 else "mma"


def _n_tile(c_out: int, depth: int) -> int:
    """The wgmma design's N tile for C_out and K = k * k * C_in
    (`wg::n_tile`): 160 where the products dominate (K >= 1024, C_out above
    80), else 80, which leaves a consumer thread registers for its epilogue
    (it holds N-tile int32 sums)."""
    return 80 if c_out <= 80 or depth < 1024 else 160


def persistent_tiles(M: int, N: int, K: int, sms: int) -> list:
    """The wgmma design's tile order: [CTA b's (m0, n0) tiles in the order it
    takes them], one CTA an SM (at most one a tile).  Tile t is M tile
    t // NT and N tile t % NT, and CTA b takes t = b, b + grid, ...: the N
    tiles of an M tile are neighbours, so the CTAs at work share A in L2.
    Its two consumer warpgroups take the CTA's tiles in turn."""
    bn = _n_tile(N, K)
    nt = -(-N // bn)
    tiles = -(-M // WGMMA_ROWS) * nt
    grid = min(tiles, sms)
    return [[((t // nt) * WGMMA_ROWS, (t % nt) * bn) for t in range(b, tiles, grid)]
            for b in range(grid)]


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the route
    by shape, "mma" the first design whatever the shape."""
    if impl is None:
        return "ov3_quant_conv"
    if impl != "mma":
        raise ValueError(f"quant_conv: _impl is None (the route by shape) or 'mma', got {impl!r}")
    if not on_cuda:
        raise ValueError("quant_conv: _impl chooses between CUDA kernels; these tensors lie on "
                         "the CPU")
    return "ov3_quant_conv_mma"


def _scalar(s: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    if not (isinstance(s, torch.Tensor) and s.numel() == 1 and s.dtype == torch.float32
            and s.device == dev):
        raise ValueError(f"quant_conv: {what} must be a one-value f32 tensor on {dev}")
    return s.contiguous()


def _out_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_conv writes bf16 or f32, not {dtype}")
    return dtype


def quant_conv(xq: torch.Tensor, kernel_q: torch.Tensor, k: int, padding: int,
               s_x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None, relu: bool = False,
               s_next: Optional[torch.Tensor] = None, out_bf16: bool = True,
               dtype: Optional[torch.dtype] = torch.bfloat16, _impl: Optional[str] = None) -> tuple:
    """:func:`quant_conv_plain`'s function: CUDA tensors launch the kernel
    (C_in and C_out multiples of 8, 2 * padding == k - 1; the scales one-value
    f32 tensors on the card, read there), one launch with no host wait, of
    the design `_route` picks or, with `_impl="mma"`, of the first design;
    CPU tensors take :func:`quant_conv_plain`."""
    if xq.dim() != 4 or xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise ValueError(f"quant_conv expects (B, H, W, C) int8 activations and an int8 kernel, "
                         f"got {tuple(xq.shape)} {xq.dtype}, {kernel_q.dtype}")
    B, H, W, C = xq.shape
    N = kernel_q.shape[0]
    if tuple(kernel_q.shape) != (N, k * k * C) or 2 * padding != k - 1:
        raise ValueError(f"quant_conv: kernel {tuple(kernel_q.shape)} for k {k}, C_in {C}, "
                         f"padding {padding} (stride 1, same size)")
    if not out_bf16 and s_next is None:
        raise ValueError("quant_conv: nothing to write (out_bf16 False and no s_next)")
    entry = _entry(_impl, xq.device.type == "cuda")
    if xq.device.type == "cpu":
        return quant_conv_plain(xq, kernel_q, k, padding, s_x, scale, bias, residual, relu,
                                s_next, out_bf16, dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"quant_conv runs on cuda or cpu tensors, got {xq.device}")
    if C % 8 or N % 8:
        raise ValueError(f"quant_conv kernel takes C_in and C_out multiples of 8, got {C}, {N}")
    dev, out_dtype = xq.device, _out_dtype(dtype)
    s_x = _scalar(s_x, dev, "s_x")
    s_next = _scalar(s_next, dev, "s_next") if s_next is not None else None
    vectors = [t for t in (scale, bias) if t is not None]
    if any(t.shape != (N,) or t.dtype != torch.float32 or t.device != dev for t in vectors):
        raise ValueError(f"quant_conv: scale and bias must be ({N},) f32 on {dev}")
    if residual is not None and (tuple(residual.shape) != (B, H, W, N)
                                 or residual.dtype != out_dtype or residual.device != dev):
        raise ValueError(f"quant_conv: residual {tuple(residual.shape)} {residual.dtype}, "
                         f"expected {(B, H, W, N)} {out_dtype} on {dev}")
    xq, kernel_q, scale = xq.contiguous(), kernel_q.contiguous(), scale.contiguous()
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    _aligned(xq, kernel_q, residual)
    out = torch.empty((B, H, W, N), dtype=out_dtype, device=dev) if out_bf16 else None
    out_q = torch.empty((B, H, W, N), dtype=torch.int8, device=dev) if s_next is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            xq.data_ptr(), kernel_q.data_ptr(), s_x.data_ptr(), scale.data_ptr(),
            _ptr(bias), _ptr(residual), _ptr(s_next), _ptr(out), _ptr(out_q),
            B, H, W, C, N, k, padding, int(relu), int(out_dtype == torch.float32), stream)
    _build.check(lib, status, "quant_conv")
    quant_conv.launches += 1
    return out, out_q


quant_conv.launches = 0


def pass_launch(B: int, H: int, W: int, C: int, pool: int) -> dict:
    """The launch `ov3_pool_quantize` makes for a (B, H, W, C) input: design
    "vec" (`pool_quantize_vec`) while B H W C is below 2^31, else "first";
    for "vec", `vec` values a thread (16 channels, or 8 where C at pool 2,
    or B H W C at pool 1, is not a multiple of 16) and `items`, the
    outputs' pieces of `vec` values, which a grid of one wave (the CTAs the
    card's SMs hold at once) takes a grid apart."""
    elements = B * H * W * C
    if elements >= 2 ** 31:
        return dict(design="first")
    vec = 16 if (elements if pool == 1 else C) % 16 == 0 else 8
    return dict(design="vec", vec=vec, items=B * (H // pool) * (W // pool) * C // vec)


def _pass_entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point of the pass for the private `_impl` argument: None
    is the route (`pass_launch`), "first" the first design."""
    if impl is None:
        return "ov3_pool_quantize"
    if impl != "first":
        raise ValueError(f"pool_quantize: _impl is None (the route) or 'first', got {impl!r}")
    if not on_cuda:
        raise ValueError("pool_quantize: _impl chooses between CUDA kernels; this tensor lies on "
                         "the CPU")
    return "ov3_pool_quantize_first"


def pool_quantize(x: torch.Tensor, pool: int, scales: Sequence[torch.Tensor],
                  _impl: Optional[str] = None) -> list:
    """:func:`pool_quantize_plain`'s function for one or two scales: CUDA
    tensors (bf16 or f32, C a multiple of 8) launch the pass, one launch
    with no host wait, of the design `pass_launch` picks or, with
    `_impl="first"`, of the first design; CPU tensors take the plain
    version."""
    if x.dim() != 4 or pool not in (1, 2) or len(scales) not in (1, 2):
        raise ValueError(f"pool_quantize expects (B, H, W, C), pool 1 or 2 and one or two "
                         f"scales, got {tuple(x.shape)}, {pool}, {len(scales)}")
    entry = _pass_entry(_impl, x.device.type == "cuda")
    if x.device.type == "cpu":
        return pool_quantize_plain(x, pool, scales)
    if x.device.type != "cuda":
        raise ValueError(f"pool_quantize runs on cuda or cpu tensors, got {x.device}")
    B, H, W, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or C % 8 or H < pool or W < pool:
        raise ValueError(f"pool_quantize kernel takes bf16 or f32 with C a multiple of 8 and "
                         f"at least the pool, got {tuple(x.shape)} {x.dtype}")
    dev = x.device
    ss = [_scalar(s, dev, "the scale") for s in scales]
    x = x.contiguous()
    _aligned(x)
    outs = [torch.empty((B, H // pool, W // pool, C), dtype=torch.int8, device=dev) for _ in ss]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            x.data_ptr(), B, H, W, C, pool, int(x.dtype == torch.float32), ss[0].data_ptr(),
            ss[1].data_ptr() if len(ss) > 1 else None, outs[0].data_ptr(),
            outs[1].data_ptr() if len(ss) > 1 else None, stream)
    _build.check(lib, status, "pool_quantize")
    pool_quantize.launches += 1
    return outs


pool_quantize.launches = 0


def _aligned(*tensors) -> None:
    """The kernels read and write 16 bytes at a time: every tensor must
    start on a 16-byte boundary (a fresh allocation does; a view may not)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"quant_conv: a {tuple(t.shape)} operand is not 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


_SIGNATURES = {
    **{name: ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p], ctypes.c_int)
       for name in ("ov3_quant_conv", "ov3_quant_conv_mma")},
    **{name: ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5, ctypes.c_int)
       for name in ("ov3_pool_quantize", "ov3_pool_quantize_first")},
}


def _lib() -> ctypes.CDLL:
    return _build.load("quant_conv", _SIGNATURES)
