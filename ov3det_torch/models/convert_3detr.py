"""Load reference-format (torch) 3DETR checkpoints into the port.

The reference trains torch Model3DETR (reference models/model_3detr.py) and
the upstream 3DETR project publishes golden checkpoints
(reference utils/download_weights.py:9-37).  `convert_3detr_checkpoint` is a
copy of `ov3det/models/convert_3detr.py:37-215`: it maps such a state_dict
onto the flax-named tree (`{"params", "batch_stats", "frozen"}`, numpy
leaves); `models.convert.from_flax_variables` then carries that tree onto
the port's state_dict, so the port has one weight bridge.  The encoder
and decoder depths and the encoder's kind are read from the state_dict's
keys, where JAX takes them as arguments; the heads stay arguments.
`load_reference_checkpoint` reads the `.pth` and does both.  These models
group with `ball_query_method="first_k"`, the neighbourhoods they were
trained with.  `to_reference_state_dict` writes a port state_dict in the
reference layout, the inverse of the two.

Key layout facts encoded here:
  * GenericMLP is an nn.Sequential "layers" whose indices depend on
    (hidden count, norm?, dropout?, output norm/activation)
    (reference models/helpers.py:45-112);
  * torch nn.MultiheadAttention packs q/k/v into in_proj_weight
    (reference models/transformer.py:223,307-308);
  * Conv1d 1x1 weights (out, in, 1) are this framework's Dense kernels
    transposed;
  * BatchNorm running stats land in the `batch_stats` collection;
  * the frozen text-embedding classifier (mlp_heads.sem_cls_head.weight)
    lands in the `frozen` collection.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ov3det_torch.models.convert import from_flax_variables


def _t(a):
    return np.asarray(a)


def _conv1d_kernel(w):  # (out, in, 1) -> (in, out)
    return _t(w)[:, :, 0].T


def _attn(sd: Dict[str, np.ndarray], prefix: str, num_heads: int) -> dict:
    d = sd[f"{prefix}.in_proj_weight"].shape[1]
    hd = d // num_heads
    qw, kw, vw = np.split(_t(sd[f"{prefix}.in_proj_weight"]), 3, axis=0)
    qb, kb, vb = np.split(_t(sd[f"{prefix}.in_proj_bias"]), 3, axis=0)

    def proj(w, b):
        return {
            "kernel": w.T.reshape(d, num_heads, hd),
            "bias": b.reshape(num_heads, hd),
        }

    return {
        "query": proj(qw, qb),
        "key": proj(kw, kb),
        "value": proj(vw, vb),
        "out": {
            "kernel": _t(sd[f"{prefix}.out_proj.weight"]).T.reshape(num_heads, hd, d),
            "bias": _t(sd[f"{prefix}.out_proj.bias"]),
        },
    }


def _ln(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _generic_mlp(sd, prefix, num_hidden, norm=True, dropout=False,
                 output_norm=False):
    """Map a reference GenericMLP Sequential onto Dense_i/BatchNorm_i params.

    Sequential layout per hidden layer: conv, [norm], act, [dropout];
    then the output conv, [output norm], [output act]
    (reference models/helpers.py:73-98)."""
    params, stats = {}, {}
    idx = 0
    for i in range(num_hidden):
        params[f"Dense_{i}"] = {"kernel": _conv1d_kernel(sd[f"{prefix}.layers.{idx}.weight"])}
        if f"{prefix}.layers.{idx}.bias" in sd:
            params[f"Dense_{i}"]["bias"] = _t(sd[f"{prefix}.layers.{idx}.bias"])
        idx += 1
        if norm:
            params[f"BatchNorm_{i}"] = _ln(sd, f"{prefix}.layers.{idx}")
            stats[f"BatchNorm_{i}"] = {
                "mean": _t(sd[f"{prefix}.layers.{idx}.running_mean"]),
                "var": _t(sd[f"{prefix}.layers.{idx}.running_var"]),
            }
            idx += 1
        idx += 1  # activation
        if dropout:
            idx += 1
    params[f"Dense_{num_hidden}"] = {
        "kernel": _conv1d_kernel(sd[f"{prefix}.layers.{idx}.weight"])
    }
    if f"{prefix}.layers.{idx}.bias" in sd:
        params[f"Dense_{num_hidden}"]["bias"] = _t(sd[f"{prefix}.layers.{idx}.bias"])
    idx += 1
    if output_norm:
        params[f"BatchNorm_{num_hidden}"] = _ln(sd, f"{prefix}.layers.{idx}")
        stats[f"BatchNorm_{num_hidden}"] = {
            "mean": _t(sd[f"{prefix}.layers.{idx}.running_mean"]),
            "var": _t(sd[f"{prefix}.layers.{idx}.running_var"]),
        }
    return params, stats


def _pointnet_sa(sd, prefix, num_layers=3):
    """PointnetSAModuleVotes shared MLP: mlp_module.layer{i}.conv/bn
    (external pointnet2; conv2d 1x1 + BatchNorm2d)."""
    params, stats = {}, {}
    for i in range(num_layers):
        conv_key = f"{prefix}.mlp_module.layer{i}.conv.weight"
        if conv_key not in sd:  # some exports use .0/.1 indices
            conv_key = f"{prefix}.mlp_module.layer{i}.weight"
        w = _t(sd[conv_key])  # (out, in, 1, 1)
        params[f"Dense_{i}"] = {"kernel": w[:, :, 0, 0].T}
        for bn_prefix in (
            f"{prefix}.mlp_module.layer{i}.bn.bn",
            f"{prefix}.mlp_module.layer{i}.bn",
        ):
            if f"{bn_prefix}.weight" in sd:
                params[f"BatchNorm_{i}"] = _ln(sd, bn_prefix)
                stats[f"BatchNorm_{i}"] = {
                    "mean": _t(sd[f"{bn_prefix}.running_mean"]),
                    "var": _t(sd[f"{bn_prefix}.running_var"]),
                }
                break
    return params, stats


def _enc_layer(sd, prefix, num_heads):
    return {
        "MultiHeadDotProductAttention_0": _attn(sd, f"{prefix}.self_attn", num_heads),
        "LayerNorm_0": _ln(sd, f"{prefix}.norm1"),
        "LayerNorm_1": _ln(sd, f"{prefix}.norm2"),
        "Dense_0": {
            "kernel": _t(sd[f"{prefix}.linear1.weight"]).T,
            "bias": _t(sd[f"{prefix}.linear1.bias"]),
        },
        "Dense_1": {
            "kernel": _t(sd[f"{prefix}.linear2.weight"]).T,
            "bias": _t(sd[f"{prefix}.linear2.bias"]),
        },
    }


def _dec_layer(sd, prefix, num_heads):
    out = _enc_layer(sd, prefix, num_heads)
    out["MultiHeadDotProductAttention_1"] = _attn(
        sd, f"{prefix}.multihead_attn", num_heads
    )
    out["LayerNorm_2"] = _ln(sd, f"{prefix}.norm3")
    return out


def _blocks(sd: Dict[str, np.ndarray], prefix: str) -> int:
    """The number of blocks `{prefix}.{i}.*` the state_dict holds."""
    return len({k[len(prefix) + 1:].split(".")[0] for k in sd if k.startswith(prefix + ".")})


def convert_3detr_checkpoint(
    state_dict: Dict[str, np.ndarray],
    enc_heads: int = 4,
    dec_heads: int = 4,
) -> dict:
    """torch state_dict -> {"params", "batch_stats", "frozen"} trees; the
    masked encoder when the state_dict holds its interim SA module."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
          for k, v in state_dict.items()}
    params, stats = {}, {}
    enc_layers, dec_layers = _blocks(sd, "encoder.layers"), _blocks(sd, "decoder.layers")
    masked = any(k.startswith("encoder.interim_downsampling.") for k in sd)

    p, s = _pointnet_sa(sd, "pre_encoder")
    params["pre_encoder"], stats["pre_encoder"] = p, s

    enc = {}
    for i in range(enc_layers):
        enc[f"TransformerEncoderLayer_{i}"] = _enc_layer(
            sd, f"encoder.layers.{i}", enc_heads
        )
    if masked:
        # the interim SA module is instantiated in Model3DETR's own scope
        # (then *called* inside the masked encoder), so its variables live
        # at the top level, not under encoder/
        p, s = _pointnet_sa(sd, "encoder.interim_downsampling")
        params["interim_downsample"], stats["interim_downsample"] = p, s
    params["encoder"] = enc

    hidden = 1 if masked else 2
    p, s = _generic_mlp(
        sd, "encoder_to_decoder_projection", hidden, norm=True, output_norm=True
    )
    params["encoder_to_decoder_projection"] = p
    stats["encoder_to_decoder_projection"] = s

    params["pos_embedding"] = {"gauss_B": _t(sd["pos_embedding.gauss_B"])}
    p, _ = _generic_mlp(sd, "query_projection", 1, norm=False)
    params["query_projection"] = p

    dec = {"LayerNorm_0": _ln(sd, "decoder.norm")}
    for i in range(dec_layers):
        dec[f"TransformerDecoderLayer_{i}"] = _dec_layer(
            sd, f"decoder.layers.{i}", dec_heads
        )
    params["decoder"] = dec

    for head in ("visual_embed_head", "center_head", "size_head",
                 "angle_cls_head", "angle_residual_head"):
        if f"mlp_heads.{head}.layers.0.weight" in sd:
            p, s = _generic_mlp(sd, f"mlp_heads.{head}", 2, norm=True, dropout=True)
            params[head] = p
            stats[head] = s
    if "mlp_heads.angle_residual_head.layers.0.weight" not in sd and \
            "mlp_heads.angle_reg_head.layers.0.weight" in sd:
        p, s = _generic_mlp(sd, "mlp_heads.angle_reg_head", 2, norm=True, dropout=True)
        params["angle_residual_head"] = p
        stats["angle_residual_head"] = s

    frozen = {}
    if "mlp_heads.sem_cls_head.weight" in sd:
        frozen["text_embed"] = _t(sd["mlp_heads.sem_cls_head.weight"])

    return {"params": params, "batch_stats": stats, "frozen": frozen}


def convert_reference_state_dict(state_dict: Dict[str, np.ndarray], **kwargs) -> dict:
    """A reference state_dict -> the port's state_dict (f32 CPU tensors);
    `kwargs` those of `convert_3detr_checkpoint`."""
    return from_flax_variables(convert_3detr_checkpoint(state_dict, **kwargs))


def load_reference_checkpoint(path: str, **kwargs) -> dict:
    """Load a reference .pth checkpoint file (`{"model": ...}` or a bare
    state_dict, DDP's `module.` prefix stripped) and convert it to the
    port's state_dict.  Without `mlp_heads.sem_cls_head.weight` (the frozen
    text-embedding head) the result has no `text_embed`: load it with
    `strict=False` and the head with `main.load_text_embed`.  The file is
    unpickled in full, as the JAX package reads it: load only checkpoints
    you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return convert_reference_state_dict(sd, **kwargs)


def _reference_mlp(out: dict, sd: dict, src: str, dst: str, stride: int) -> None:
    """A port GenericMLP or SA shared MLP (`layers.j`, `norms.j`) -> the
    reference Sequential, whose hidden layer j starts at index j * stride
    (conv, [norm], act, [dropout]) and whose output conv sits after them."""
    j = 0
    while f"{src}.layers.{j}.weight" in sd:
        out[f"{dst}.layers.{j * stride}.weight"] = sd[f"{src}.layers.{j}.weight"][..., None]
        if f"{src}.layers.{j}.bias" in sd:
            out[f"{dst}.layers.{j * stride}.bias"] = sd[f"{src}.layers.{j}.bias"]
        for stat in ("weight", "bias", "running_mean", "running_var"):
            if f"{src}.norms.{j}.{stat}" in sd:
                out[f"{dst}.layers.{j * stride + 1}.{stat}"] = sd[f"{src}.norms.{j}.{stat}"]
        j += 1


def _reference_sa(out: dict, sd: dict, src: str, dst: str) -> None:
    j = 0
    while f"{src}.layers.{j}.weight" in sd:
        out[f"{dst}.mlp_module.layer{j}.conv.weight"] = sd[f"{src}.layers.{j}.weight"][..., None, None]
        for stat in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.mlp_module.layer{j}.bn.bn.{stat}"] = sd[f"{src}.norms.{j}.{stat}"]
        j += 1


def to_reference_state_dict(state_dict: dict) -> dict:
    """The port's state_dict -> the reference 3DETR layout (numpy), which
    `convert_3detr_checkpoint` reads back."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    out = {"pos_embedding.gauss_B": sd["pos_embedding.gauss_B"],
           "mlp_heads.sem_cls_head.weight": sd["text_embed"]}
    _reference_sa(out, sd, "pre_encoder", "pre_encoder")
    _reference_sa(out, sd, "interim_downsample", "encoder.interim_downsampling")
    _reference_mlp(out, sd, "encoder_to_decoder_projection", "encoder_to_decoder_projection", 3)
    _reference_mlp(out, sd, "query_projection", "query_projection", 2)
    for head in ("visual_embed_head", "center_head", "size_head", "angle_cls_head",
                 "angle_residual_head"):
        _reference_mlp(out, sd, head, f"mlp_heads.{head}", 4)
    attn = {"self_attn": "self_attn", "cross_attn": "multihead_attn"}
    for key, v in sd.items():
        part = key.split(".")
        if part[0] not in ("encoder", "decoder") or part[1] not in ("layers", "norm"):
            continue
        if len(part) > 3 and part[3] in attn:
            prefix = ".".join(part[:3] + [attn[part[3]]])
            if part[4] == "out_proj":
                out[f"{prefix}.out_proj.{part[5]}"] = v
            elif part[4] == "q_proj":  # q, k, v -> in_proj, once for the three
                kind = part[5]
                out[f"{prefix}.in_proj_{kind}"] = np.concatenate(
                    [sd[".".join(part[:4] + [p, kind])] for p in ("q_proj", "k_proj", "v_proj")])
        else:
            out[key] = v
    return out
