"""Symmetric CLIP-style contrastive loss (ULIP).

A copy of `ov3det/losses/clip_loss.py` (reference utils/ulip_losses.py:
14-53, CLIPLoss): symmetric InfoNCE between point-cloud embeddings and the
text embeddings of their labels, logit scale 1/0.07.  The reference builds
it inside the criterion and never calls it (criterion.py:107), and no step
of either package calls it.  The JAX version's `axis_name` gather across
devices waits for multi-GPU (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import torch


def clip_contrastive_loss(pc_embed: torch.Tensor, text_embed_per_sample: torch.Tensor,
                          logit_scale: float = 1.0 / 0.07):
    """pc_embed, text_embed_per_sample (B, D) -> (loss, {"clip_loss",
    "clip_acc"}), the accuracy in percent."""
    pc = pc_embed / torch.clamp(torch.linalg.vector_norm(pc_embed, dim=-1, keepdim=True), min=1e-8)
    tx = text_embed_per_sample / torch.clamp(
        torch.linalg.vector_norm(text_embed_per_sample, dim=-1, keepdim=True), min=1e-8)
    logits = logit_scale * pc @ tx.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    logp_pc = torch.log_softmax(logits, dim=-1)
    logp_tx = torch.log_softmax(logits.t(), dim=-1)
    loss = -0.5 * (logp_pc[labels, labels].mean() + logp_tx[labels, labels].mean())
    acc = (logits.argmax(-1) == labels).float().mean() * 100.0
    return loss, {"clip_loss": loss, "clip_acc": acc}
