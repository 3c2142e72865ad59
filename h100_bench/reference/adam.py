"""Adam (Kingma and Ba, 2015) in plain PyTorch, as ``torch.optim.Adam``
defines its update with weight decay 0: first and second moments with
bias correction, ``θ ← θ − lr/(1 − β1^t) · m / (√v / √(1 − β2^t) + ε)``."""
from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """One update of every parameter that has a gradient."""
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            if g is None:
                continue
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            self.params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
