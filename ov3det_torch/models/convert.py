"""Carry the JAX package's detector weights over to the port.

`from_flax_variables` maps the flax variable tree of `ov3det.models.Model3DETR`
(`{"params", "batch_stats", "frozen"}`, leaves as numpy arrays; the names
are those `ov3det/models/convert_3detr.py:37-215` targets) onto the
`state_dict` of `ov3det_torch.models.detr3d.Model3DETR`:

  Dense_i kernel (in, out)         -> layers.i.weight (out, in), .bias
  BatchNorm_i scale/bias, mean/var -> norms.i.weight/.bias, .running_mean/_var
  LayerNorm_i scale/bias           -> norm{i+1}.weight/.bias (decoder: norm)
  MultiHeadDotProductAttention_j   -> self_attn / cross_attn:
      query/key/value kernel (d, H, hd) -> {q,k,v}_proj.weight (H*hd, d)
      out kernel (H, hd, d)             -> out_proj.weight (d, H*hd)
  pos_embedding/gauss_B, frozen/text_embed as they are.

`from_flax_teacher_variables` maps the JAX package's RegionCLIP teacher
tree (`ov3det.models.regionclip`) onto the flat state of
`ov3det_torch.models.regionclip.RegionCLIPTeacher`, for its f32 tree, the
tree of `cast_teacher_params` (bf16 leaves) and that of
`quantize_teacher_params` (`kernel_q`, `scale`, `a_scale`, `bias`, the
folded BatchNorms gone):

  conv kernel (kh, kw, in, out)    -> weight (out, in, kh, kw)
  kernel_q (kh, kw, in, out) int8  -> kernel_q (out, kh * kw * in)
  dense kernel (in, out), bias     -> weight (out, in), bias
  BatchNorm, positional grid, scale, a_scale, bias: as they are.

The masked encoder's tree needs nothing more: its interim set abstraction
sits in the detector's scope (`interim_downsample/Dense_i`,
`BatchNorm_i` -> `interim_downsample.layers.i`, `.norms.i`), its layers
under `encoder` as the vanilla ones, and its projection with one hidden
layer is a `GenericMLP` like the other.
"""
from __future__ import annotations

import numpy as np
import torch


def _dense(prefix: str, p: dict) -> dict:
    kernel = np.asarray(p["kernel"])
    out = {f"{prefix}.weight": kernel.reshape(kernel.shape[0], -1).T}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"]).reshape(-1)
    return out


def _norm(prefix: str, p: dict, stats: dict | None = None) -> dict:
    out = {f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"]}
    if stats is not None:
        out[f"{prefix}.running_mean"] = stats["mean"]
        out[f"{prefix}.running_var"] = stats["var"]
    return out


def _mlp(prefix: str, params: dict, stats: dict) -> dict:
    """GenericMLP and the SA shared MLP: Dense_i -> layers.i, BatchNorm_i ->
    norms.i."""
    out = {}
    for name, p in params.items():
        kind, i = name.rsplit("_", 1)
        if kind == "Dense":
            out.update(_dense(f"{prefix}.layers.{i}", p))
        elif kind == "BatchNorm":
            out.update(_norm(f"{prefix}.norms.{i}", p, stats.get(name)))
        else:
            raise KeyError(f"unexpected {prefix}/{name}")
    return out


def _attention(prefix: str, p: dict) -> dict:
    out = {}
    for src, dst in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj")):
        out.update(_dense(f"{prefix}.{dst}", p[src]))
    kernel = np.asarray(p["out"]["kernel"])  # (H, hd, d)
    out[f"{prefix}.out_proj.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    out[f"{prefix}.out_proj.bias"] = p["out"]["bias"]
    return out


def _transformer_layer(prefix: str, p: dict) -> dict:
    out = {}
    attn_names = {"MultiHeadDotProductAttention_0": "self_attn",
                  "MultiHeadDotProductAttention_1": "cross_attn"}
    for name, sub in p.items():
        kind, i = name.rsplit("_", 1)
        if kind == "MultiHeadDotProductAttention":
            out.update(_attention(f"{prefix}.{attn_names[name]}", sub))
        elif kind == "LayerNorm":
            out.update(_norm(f"{prefix}.norm{int(i) + 1}", sub))
        elif kind == "Dense":
            out.update(_dense(f"{prefix}.linear{int(i) + 1}", sub))
        else:
            raise KeyError(f"unexpected {prefix}/{name}")
    return out


def from_flax_variables(variables: dict) -> dict:
    """{"params", "batch_stats", "frozen"} (numpy leaves) -> port state_dict
    of float32 CPU tensors, loadable with `Model3DETR.load_state_dict`."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name == "encoder":
            for layer, sub in p.items():
                i = layer.rsplit("_", 1)[1]
                sd.update(_transformer_layer(f"encoder.layers.{i}", sub))
        elif name == "decoder":
            for layer, sub in p.items():
                if layer == "LayerNorm_0":  # the final norm
                    sd.update(_norm("decoder.norm", sub))
                else:
                    i = layer.rsplit("_", 1)[1]
                    sd.update(_transformer_layer(f"decoder.layers.{i}", sub))
        elif name == "pos_embedding":
            sd["pos_embedding.gauss_B"] = p["gauss_B"]
        else:
            sd.update(_mlp(name, p, stats.get(name, {})))
    sd["text_embed"] = variables["frozen"]["text_embed"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _teacher_tensor(a) -> torch.Tensor:
    """A numpy leaf of the teacher's tree as a tensor of its dtype (bf16
    leaves, ml_dtypes' bfloat16, cross as their bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_flax_teacher_variables(variables: dict) -> dict:
    """{"params": {"backbone", "roi_head"}} of the JAX teacher (numpy leaves)
    -> the state `RegionCLIPTeacher.load` takes (CPU tensors)."""
    out = {}

    def walk(tree: dict, prefix: str) -> None:
        for name, v in tree.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, key)
                continue
            t = _teacher_tensor(v)
            if name == "kernel_q":  # (kh, kw, in, out) -> (out, kh kw in)
                out[key] = t.reshape(-1, t.shape[-1]).t().contiguous()
            elif name == "kernel" and t.dim() == 4:
                out[f"{prefix}.weight"] = t.permute(3, 2, 0, 1).contiguous()
            elif name == "kernel":
                out[f"{prefix}.weight"] = t.t().contiguous()
            else:
                out[key] = t

    walk(variables["params"], "")
    return out
