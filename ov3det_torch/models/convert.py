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

`from_flax_text_variables` maps the JAX package's CLIP text tower
(`ov3det.models.clip_text.CLIPTextEncoder`) onto the torch-CLIP names of
`ov3det_torch.models.clip_text.CLIPTextEncoder`:

  attn_i query/key/value kernel (w, H, hd), bias (H, hd)
                                   -> attn.in_proj_weight (3w, w), in_proj_bias
  attn_i out kernel (H, hd, w)     -> attn.out_proj.weight (w, w), .bias
  ln1_i / ln2_i / ln_final         -> ln_1 / ln_2 / ln_final .weight .bias
  mlp_fc_i / mlp_proj_i            -> mlp.c_fc / mlp.c_proj .weight .bias
  token_embedding, positional_embedding, text_projection: as they are.

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
    if "text_embed" in variables.get("frozen", {}):  # a reference checkpoint may lack it
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


def from_flax_text_variables(variables: dict) -> dict:
    """{"params": ...} of the JAX text tower (numpy leaves) -> the state
    dict of the port's `CLIPTextEncoder` (f32 CPU tensors)."""
    params = variables["params"]
    sd = {"token_embedding.weight": params["token_embedding"],
          "positional_embedding": params["positional_embedding"],
          "text_projection": params["text_projection"],
          "ln_final.weight": params["ln_final"]["scale"],
          "ln_final.bias": params["ln_final"]["bias"]}
    layers = sum(1 for name in params if name.startswith("attn_"))
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        attn = params[f"attn_{i}"]
        qkv = [np.asarray(attn[n]["kernel"]) for n in ("query", "key", "value")]
        sd[p + "attn.in_proj_weight"] = np.concatenate([k.reshape(k.shape[0], -1).T for k in qkv])
        sd[p + "attn.in_proj_bias"] = np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(-1) for n in ("query", "key", "value")])
        out = np.asarray(attn["out"]["kernel"])  # (H, hd, w)
        sd[p + "attn.out_proj.weight"] = out.reshape(-1, out.shape[-1]).T
        sd[p + "attn.out_proj.bias"] = attn["out"]["bias"]
        for src, dst in ((f"ln1_{i}", "ln_1"), (f"ln2_{i}", "ln_2")):
            sd[f"{p}{dst}.weight"] = params[src]["scale"]
            sd[f"{p}{dst}.bias"] = params[src]["bias"]
        for src, dst in ((f"mlp_fc_{i}", "mlp.c_fc"), (f"mlp_proj_{i}", "mlp.c_proj")):
            sd[f"{p}{dst}.weight"] = np.asarray(params[src]["kernel"]).T
            sd[f"{p}{dst}.bias"] = params[src]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
