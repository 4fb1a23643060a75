"""Extract prompt-ensembled CLIP text embeddings for a concept list.

Counterpart of `ov3det/tools/extract_class_features.py` (reference
3DOVDet_tools/extract_class_features.py:14-36) on the port's text tower:
for each concept, encode all prompt templates, L2-normalize, average,
re-normalize, and save the (num_concepts, embed_dim) matrix that
`ov3det_torch.main --clip_embed_path` loads as the detector's frozen
classification head (its rows: the classes, then the no-object row).  The
tower's width, depth, projection, vocabulary and context are read from the
checkpoint's shapes, where JAX takes `--width --layers --embed_dim`; the
other flags are JAX's, plus `--device` (default `cuda`, which raises
without a card).

Usage:
  python -m ov3det_torch.tools.extract_class_features \\
      --concepts concepts_scannet.txt \\
      --clip_ckpt regionclip_pretrained-cc_rn50x4.pth \\
      --bpe_vocab bpe_simple_vocab_16e6.txt.gz \\
      --out concepts_scannet.npy
"""
from __future__ import annotations

import argparse

import numpy as np

from ov3det_torch.models.clip_text import (
    CLIPTextEncoder,
    SimpleBPETokenizer,
    convert_text_checkpoint,
    extract_class_embeddings,
    tokenize_prompts,
)


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser()
    p.add_argument("--concepts", required=True, help="one concept per line")
    p.add_argument("--clip_ckpt", required=True, help="CLIP/RegionCLIP torch ckpt")
    p.add_argument("--bpe_vocab", required=True, help="bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--out", required=True, help="output .npy path")
    p.add_argument("--heads", type=int, default=10, help="attention heads (RN50x4: 10)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the tower; cuda raises without a card")
    args = p.parse_args(argv)

    with open(args.concepts) as fh:
        concepts = [ln.strip() for ln in fh.read().splitlines() if ln.strip()]
    tokenizer = SimpleBPETokenizer(args.bpe_vocab)
    prompts = tokenize_prompts(concepts, tokenizer)

    state = convert_text_checkpoint(args.clip_ckpt)
    vocab, width = state["token_embedding.weight"].shape
    encoder = CLIPTextEncoder(vocab_size=vocab, context_length=state["positional_embedding"].shape[0],
                              width=width, heads=args.heads,
                              layers=sum(n.endswith(".attn.in_proj_weight") for n in state),
                              embed_dim=state["text_projection"].shape[1], device=args.device)
    encoder.load_state_dict(state)
    emb = extract_class_embeddings(encoder, prompts)
    np.save(args.out, emb)
    print(f"saved {emb.shape} class embeddings to {args.out}")
    return emb


if __name__ == "__main__":
    main()
