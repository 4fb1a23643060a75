"""Pre-norm transformer encoder/decoder for point tokens.

Counterpart of `ov3det/models/transformer.py:42-322`: the vanilla and the
radius-masked encoder, and the decoder.  Layout is channels-last (B, N, C);
the multi-head attention keeps flax's (B, N, H, D) head layout.

Attention dispatch, as `fused_attention_eligible` without its TPU test:
shapes with NQ * NK >= 1M, NQ and NK multiples of 128 and D a multiple of 8
(the encoder's 2048 x 2048 self-attention, the masked encoder's 2048 and
1024 tokens) go through the fused attention
(`ops.kernels.attention.fused_attention`: the CUDA kernels forward and
backward, an autograd function), the masked encoder's radius as the
kernels' radius bias; every other attention (the decoder's, a masked layer
at fewer tokens) is the plain matmul + softmax of flax's
`nn.dot_product_attention`, in the working dtype, with the masked layer's
boolean mask filled in as flax does.

Training-mode dropout, as the JAX package has it:
  * residual and FFN dropouts per element (flax `nn.Dropout`);
  * attention-weight dropout on the fused path per (b, h, q, k), from the
    kernel's hash of an int32 seed drawn from the generator;
  * attention-weight dropout on the plain path with ONE (NQ, NK) mask
    shared across batch and heads: flax's `MultiHeadDotProductAttention`
    drops the `broadcast_dropout` argument for an attention function that
    does not take it, so `nn.dot_product_attention` runs with its default
    `broadcast_dropout=True`.
Every mask comes from the `torch.Generator` passed to `forward`.

The pre-norm "add & norm" (the residual x + dropout(attention) and the
LayerNorm after it, and each LayerNorm alone) runs on CUDA tensors as the
kernels of `ops/kernels/add_norm.py` (`LayerNorm.add`, `AddNorm`).  Each
layer's last residual add, x + dropout(FFN), stays a plain add: the next
layer's norm1 (and, in the decoder, the final norm, which reads the same
state) could take it as their prologue, but the add's output is the layer's
and the stack's output, and the decoder would need one pass with two norms.

Under a data group (`ov3det_torch.parallel`), as under the JAX package's
mesh: the kernel's seed is the draw, equal on every rank, plus the rank
(`s + jax.lax.axis_index(DATA_AXIS)`, `ov3det/models/transformer.py:119-121`;
the hash counts `b` within the rank's rows), the broadcast (NQ, NK) mask is
one draw, equal on every rank, and the element-wise masks are the rank's
rows of a global draw (`models/mlp.py` `dropout`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ov3det_torch.models.mlp import Dense, LayerNorm, dropout, dropout_mask
from ov3det_torch.ops.kernels.attention import fused_attention
from ov3det_torch.parallel.mesh import data_group

ACTIVATIONS = {  # the encoder's choices (EncoderConfig.activation)
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
}


def fused_attention_eligible(NQ: int, NK: int, D: int) -> bool:
    """True where the JAX package sends attention to its kernel on a TPU."""
    return NQ % 128 == 0 and NK % 128 == 0 and D % 8 == 0 and NQ * NK >= 1024 * 1024


def dot_product_attention(q, k, v, dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax `nn.dot_product_attention`: q scaled by 1/sqrt(D), scores,
    softmax and the value product all in q's dtype.  `mask` (broadcast to
    (B, H, NQ, NK), True = may attend) fills the scores it excludes with the
    dtype's `finfo.min` before the softmax.  With dropout the weights are
    multiplied by keep / keep_prob in that dtype, `keep` one (NQ, NK) draw
    broadcast over batch and heads (flax's default `broadcast_dropout=True`).
    q (B, NQ, H, D), k and v (B, NK, H, D) -> (B, NQ, H, D)."""
    depth = q.shape[-1]
    q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("training-mode attention dropout needs a torch.Generator")
        keep_prob = 1.0 - dropout_rate
        keep = torch.rand(w.shape[-2:], generator=generator, device=w.device) < keep_prob
        w = w * (keep.to(w.dtype) / torch.tensor(keep_prob, dtype=w.dtype))  # a CPU scalar: no copy
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class MultiheadAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` (qkv_features = out_features =
    dim) with the port's attention dispatch and, in training, attention-weight
    dropout at `dropout`."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = Dense(dim, dim, compute_dtype=compute_dtype, init="xavier")
        self.k_proj = Dense(dim, dim, compute_dtype=compute_dtype, init="xavier")
        self.v_proj = Dense(dim, dim, compute_dtype=compute_dtype, init="xavier")
        self.out_proj = Dense(dim, dim, compute_dtype=compute_dtype, init="xavier")

    def forward(self, q_in, k_in, v_in, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, radius=None):
        """`mask`: a boolean mask for the plain path; `radius`: (q_xyz,
        k_xyz, r2) for the fused path, which callers take only where
        `fused_attention_eligible` holds."""
        B, NQ, _ = q_in.shape
        NK = k_in.shape[1]
        H = self.num_heads
        q = self.q_proj(q_in).view(B, NQ, H, -1)
        k = self.k_proj(k_in).view(B, NK, H, -1)
        v = self.v_proj(v_in).view(B, NK, H, -1)
        D = q.shape[-1]
        rate = self.dropout if self.training else 0.0
        eligible = fused_attention_eligible(NQ, NK, D) and mask is None
        if radius is not None and not eligible:
            raise ValueError("the radius bias runs only on the fused path: check "
                             "fused_attention_eligible first")
        if eligible:
            def heads(x, n):  # (B, N, H, D) -> (B*H, N, D); at B = 1 reshape is a strided view
                return x.transpose(1, 2).reshape(B * H, n, D).contiguous()

            seed = None
            if rate > 0.0:
                if generator is None:
                    raise ValueError("training-mode attention dropout needs a torch.Generator")
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=q.device, dtype=torch.int32)
                seed = seed + (g.rank if (g := data_group()) else 0)
            out = fused_attention(heads(q, NQ), heads(k, NK), heads(v, NK), rate, seed, radius)
            out = out.view(B, H, NQ, D).transpose(1, 2)
        else:
            out = dot_product_attention(q, k, v, rate, generator, mask)
        return self.out_proj(out.reshape(B, NQ, H * D))


def _with_pos(x, pos):
    return x if pos is None else x + pos


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention layer (reference models/transformer.py:213-295)."""

    def __init__(self, dim: int, num_heads: int = 4, ffn_dim: int = 128, dropout: float = 0.1,
                 activation: str = "relu", compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dropout = dropout
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads, dropout, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Dense(dim, ffn_dim, compute_dtype=compute_dtype, init="xavier")
        self.linear2 = Dense(ffn_dim, dim, compute_dtype=compute_dtype, init="xavier")

    def forward(self, x, pos=None, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, radius=None):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(x)
        qk = _with_pos(y, pos)
        attn = self.self_attn(qk, qk, y, generator, mask, radius)
        x, y = self.norm2.add(x, attn, dropout_mask(attn, rate, generator), 1.0 - rate)
        y = dropout(self.act(self.linear1(y)), rate, generator)
        return x + dropout(self.linear2(y), rate, generator)


class TransformerEncoder(nn.Module):
    """Vanilla encoder: full self-attention over all point tokens."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 4, ffn_dim: int = 128,
                 dropout: float = 0.1, activation: str = "relu",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, ffn_dim, dropout, activation, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, feats, xyz, pos=None, generator: Optional[torch.Generator] = None):
        """Returns (xyz, feats, None): the vanilla encoder does not downsample."""
        for layer in self.layers:
            feats = layer(feats, pos=pos, generator=generator)
        return xyz, feats, None


class MaskedTransformerEncoder(nn.Module):
    """Radius-masked encoder with the interim set abstraction after layer 0
    (`ov3det/models/transformer.py:216-259`, reference
    models/transformer.py:144-209).

    Layer i lets a token attend to the tokens within `masking_radius[i]`
    (a distance, compared with the squared distance: see
    `EncoderConfig.masking_radius`).  Where the fused attention takes the
    layer, the radius is its in-kernel bias with the expanded distance of
    `_radius_bias`; elsewhere a (B, 1, N, N) boolean mask from the directly
    subtracted distance goes to the plain attention.  The interim
    downsample is passed to `forward`: its weights belong to the detector
    (`interim_downsample`), as in the JAX variable tree.
    """

    def __init__(self, num_layers: int, dim: int, masking_radius, num_heads: int = 4,
                 ffn_dim: int = 128, dropout: float = 0.1, activation: str = "relu",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(masking_radius) != num_layers:
            raise ValueError("masking_radius needs one radius per layer")
        self.masking_radius = tuple(masking_radius)
        self.head_dim = dim // num_heads
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, ffn_dim, dropout, activation, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, feats, xyz, interim_downsample: nn.Module, pos=None,
                generator: Optional[torch.Generator] = None):
        """Returns (xyz, feats, inds) of the 1/2 downsampled tokens; inds are
        the interim FPS indices."""
        inds = None
        for idx, layer in enumerate(self.layers):
            r = self.masking_radius[idx]
            N = feats.shape[1]
            mask = radius = None
            if fused_attention_eligible(N, N, self.head_dim):
                radius = (xyz, xyz, r * r)
            else:
                diff = xyz[:, :, None, :] - xyz[:, None, :, :]
                d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                      + diff[..., 2] * diff[..., 2])
                mask = (d2 < r * r)[:, None]
            feats = layer(feats, pos=pos, generator=generator, mask=mask, radius=radius)
            if idx == 0:
                xyz, feats, inds = interim_downsample(xyz, feats)
        return xyz, feats, inds


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self + cross attention (reference models/transformer.py:298-393)."""

    def __init__(self, dim: int, num_heads: int = 4, ffn_dim: int = 256, dropout: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads, dropout, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = MultiheadAttention(dim, num_heads, dropout, compute_dtype)
        self.norm3 = LayerNorm(dim)
        self.linear1 = Dense(dim, ffn_dim, compute_dtype=compute_dtype, init="xavier")
        self.linear2 = Dense(ffn_dim, dim, compute_dtype=compute_dtype, init="xavier")

    def forward(self, tgt, memory, query_pos=None, mem_pos=None,
                generator: Optional[torch.Generator] = None):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(tgt)
        qk = _with_pos(y, query_pos)
        sa = self.self_attn(qk, qk, y, generator)
        tgt, y = self.norm2.add(tgt, sa, dropout_mask(sa, rate, generator), 1.0 - rate)
        ca = self.cross_attn(_with_pos(y, query_pos), _with_pos(memory, mem_pos), memory,
                             generator)
        tgt, y = self.norm3.add(tgt, ca, dropout_mask(ca, rate, generator), 1.0 - rate)
        y = dropout(torch.relu(self.linear1(y)), rate, generator)
        return tgt + dropout(self.linear2(y), rate, generator)


class TransformerDecoder(nn.Module):
    """Decoder returning the final-normed state after every layer, stacked
    as (num_layers, B, Q, C) (reference models/transformer.py:114-139)."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 4, ffn_dim: int = 256,
                 dropout: float = 0.1, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(dim, num_heads, ffn_dim, dropout, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, tgt, memory, query_pos=None, mem_pos=None,
                generator: Optional[torch.Generator] = None):
        inter = []
        for layer in self.layers:
            tgt = layer(tgt, memory, query_pos=query_pos, mem_pos=mem_pos, generator=generator)
            inter.append(self.norm(tgt))
        return torch.stack(inter, dim=0)
