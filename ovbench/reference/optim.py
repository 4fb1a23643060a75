"""AdamW with global-norm clipping as optax chains them, plain PyTorch.

`optax.chain(clip_by_global_norm(clip), adamw(schedule, wd))` over every
parameter (a missing gradient is a zero gradient; every parameter is
decayed): b1 0.9, b2 0.999, eps 1e-8 outside the square root, the bias
corrections with the count after the increment (in f32), the decay added
to the Adam direction before the learning rate scales it, the learning
rate of update c (1 the first) `schedule(c - 1)`.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def lr_schedule(optim: dict, max_epoch: int, iters_per_epoch: int):
    """Linear warm-up from warm_lr to base_lr over warm_lr_epochs, then a
    cosine down to final_lr over the rest of the run, per iteration."""
    max_iters = max(max_epoch * iters_per_epoch, 1)

    def schedule(step: int) -> float:
        frac = min(max(step / max_iters, 0.0), 1.0)
        warm = optim["warm_lr_epochs"]
        if warm > 0 and frac <= warm / max_epoch:
            return optim["warm_lr"] + frac * max_epoch * (
                (optim["base_lr"] - optim["warm_lr"]) / max(warm, 1))
        return optim["final_lr"] + 0.5 * (optim["base_lr"] - optim["final_lr"]) * (
            1.0 + math.cos(math.pi * frac))

    return schedule


class AdamW:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, optim: dict, schedule):
        self.params = list(params)
        self.clip, self.wd = optim["clip_gradient"], optim["weight_decay"]
        self.schedule = schedule
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; the raw gradients' global norm."""
        self.count += 1
        c = self.count
        lr = self.schedule(c - 1)
        bc1 = float(1 - np.float32(self.b1) ** np.float32(c))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(c))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float() for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if self.clip > 0:
            factor = torch.where(g_norm < self.clip, torch.ones_like(g_norm), self.clip / g_norm)
            grads = [g * factor for g in grads]
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.wd > 0:
                upd = upd + self.wd * p
            p.add_(-lr * upd)
        return g_norm
