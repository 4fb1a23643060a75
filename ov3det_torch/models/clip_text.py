"""CLIP text tower of the port, for open-vocabulary class embeddings.

Counterpart of `ov3det/models/clip_text.py` (the CLIP RN50x4 `encode_text`
path the reference uses to build its frozen classifier matrix, reference
3DOVDet_tools/extract_class_features.py:14-36): a causal transformer over
BPE tokens, pre-LN blocks (LayerNorm eps 1e-5, flax's numerics), QuickGELU,
the final LayerNorm, the EOT token taken at `argmax(token_ids)` and the
projection into the joint space (640-d for RN50x4), in f32.  The attention
is plain matmul and softmax over a causal mask, as flax's
`MultiHeadDotProductAttention` computes it (the query scaled by hd^-0.5
first).

The module keeps the state-dict names of CLIP's torch text tower
(`token_embedding.weight`, `transformer.resblocks.{i}.attn.in_proj_weight`,
...), so `convert_text_checkpoint` is a renaming; `models.convert.
from_flax_text_variables` carries the JAX tower's parameters across.  The
tokenizer is a copy of the JAX package's (it needs CLIP's BPE merges file,
which the repository does not hold).
"""
from __future__ import annotations

import gzip
import html
import math
import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ov3det_torch.device import resolve_device
from ov3det_torch.models.mlp import LayerNorm

# standard CLIP prompt templates used for classifier-embedding ensembling
PROMPT_TEMPLATES = [
    "a photo of a {}.",
    "a photo of the {}.",
    "a photo of one {}.",
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
    "there is a {} in the scene.",
    "there is the {} in the scene.",
    "this is a {} in the scene.",
    "this is the {} in the scene.",
    "this is one {} in the scene.",
]


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class CausalSelfAttention(nn.Module):
    """torch `nn.MultiheadAttention`'s parameters (`in_proj_weight` (3w, w),
    `in_proj_bias`, `out_proj`), computed as flax's attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, W = x.shape
        hd = W // self.heads
        qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
        logits = (q / math.sqrt(hd)) @ k.transpose(-1, -2)  # (B, H, T, T)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, W))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = CausalSelfAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict(c_fc=nn.Linear(width, 4 * width), gelu=QuickGELU(),
                                             c_proj=nn.Linear(4 * width, width)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPTextEncoder(nn.Module):
    """token ids (B, context_length) -> (B, embed_dim) f32.  Built on
    `device` (CUDA unless the caller passes "cpu"; raises when CUDA is asked
    for and absent) with CLIP's initialisation drawn from a CPU generator
    seeded with `seed`, so one seed gives the same weights on every
    device."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 640,
                 heads: int = 10, layers: int = 12, embed_dim: int = 640, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.hparams = dict(vocab_size=vocab_size, context_length=context_length, width=width,
                            heads=heads, layers=layers, embed_dim=embed_dim)
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """CLIP's text initialisation (openai/CLIP model.py
        `initialize_parameters`), biases 0 and LayerNorms 1 and 0."""
        width, layers = self.hparams["width"], self.hparams["layers"]
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        attn_std, fc_std = width ** -0.5, (2 * width) ** -0.5
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        for block in self.transformer.resblocks:
            block.attn.in_proj_weight.normal_(0.0, attn_std, generator=generator)
            block.attn.out_proj.weight.normal_(0.0, proj_std, generator=generator)
            block.mlp.c_fc.weight.normal_(0.0, fc_std, generator=generator)
            block.mlp.c_proj.weight.normal_(0.0, proj_std, generator=generator)
            for bias in (block.attn.in_proj_bias, block.attn.out_proj.bias, block.mlp.c_fc.bias,
                         block.mlp.c_proj.bias):
                bias.zero_()
            block.ln_1.reset_parameters()
            block.ln_2.reset_parameters()
        self.ln_final.reset_parameters()
        self.text_projection.normal_(0.0, width ** -0.5, generator=generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        B, T = token_ids.shape
        token_ids = token_ids.long()
        x = self.token_embedding(token_ids) + self.positional_embedding[:T]
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_final(x)
        pooled = x[torch.arange(B, device=x.device), token_ids.argmax(dim=-1)]
        return pooled.float() @ self.text_projection.float()


def convert_text_checkpoint(path: str) -> dict:
    """The text tower of a CLIP or RegionCLIP torch checkpoint (`{"model":
    ...}` or a bare state dict; the tower bare or under `lang_encoder.` /
    `text_encoder.`) as f32 CPU tensors under the names of
    `CLIPTextEncoder`, for its `load_state_dict`; as many blocks as the
    checkpoint holds."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    prefix = next((p for p in ("lang_encoder.", "text_encoder.", "")
                   if f"{p}transformer.resblocks.0.attn.in_proj_weight" in sd), None)
    if prefix is None:
        raise KeyError(f"{path}: no CLIP text tower (transformer.resblocks.0.attn.in_proj_weight, "
                       "bare or under lang_encoder. / text_encoder.)")
    names = ["token_embedding.weight", "positional_embedding", "text_projection",
             "ln_final.weight", "ln_final.bias"]
    layers = sum(k.startswith(f"{prefix}transformer.resblocks.") and k.endswith(".attn.in_proj_weight")
                 for k in sd)
    for i in range(layers):
        names += [f"transformer.resblocks.{i}.{n}" for n in (
            "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
            "attn.out_proj.bias", "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
            "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")]
    return {n: torch.as_tensor(sd[prefix + n]).float().cpu() for n in names}


class SimpleBPETokenizer:
    """CLIP's byte-pair tokenizer, loaded from the standard merges file.

    The merges vocabulary (`bpe_simple_vocab_16e6.txt.gz`) is not vendored
    (zero-egress build); supply a local copy.  Algorithm follows the public
    CLIP tokenizer: byte-level unicode mapping, lowercase, basic regex
    splitting, greedy lowest-rank pair merging, `</w>` end-of-word marker.
    A copy of the JAX package's tokenizer.
    """

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = self._bytes_to_unicode()
        merges = gzip.open(bpe_path, "rt", encoding="utf-8").read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|"""
            r"""[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    @staticmethod
    def _bytes_to_unicode():
        bs = (
            list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1))
        )
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        return dict(zip(bs, [chr(c) for c in cs]))

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        text = re.sub(r"\s+", " ", text)
        tokens = []
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens

    def __call__(self, texts) -> np.ndarray:
        """texts: list[str] -> (len(texts), context_length) int32 ids."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [sot] + self.encode(t)[: self.context_length - 2] + [eot]
            out[i, : len(ids)] = ids
        return out


def tokenize_prompts(class_names, tokenizer, templates=PROMPT_TEMPLATES) -> np.ndarray:
    """class names -> (C, num_templates, context_len) prompt token ids."""
    rows = [tokenizer([tpl.format(name) for tpl in templates]) for name in class_names]
    return np.stack(rows, 0)


@torch.no_grad()
def extract_class_embeddings(encoder: CLIPTextEncoder, tokenized_prompts: np.ndarray) -> np.ndarray:
    """Prompt-ensembled class embeddings (reference
    extract_class_features.py:25-33) on the encoder's device: per class,
    encode every template, L2-normalize, average, re-normalize.  Returns
    (num_classes, embed_dim) f32 numpy."""
    C, P, T = tokenized_prompts.shape
    device = encoder.positional_embedding.device
    flat = torch.from_numpy(np.ascontiguousarray(tokenized_prompts.reshape(C * P, T))).to(device)
    feats = encoder(flat)
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    feats = feats.reshape(C, P, -1).mean(dim=1)
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats.cpu().numpy()
