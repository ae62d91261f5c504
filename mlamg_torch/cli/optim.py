"""The trainers' optimiser: optax's Adam, step for step.

:class:`Adam` repeats ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0), optionally behind ``optax.clip_by_global_norm``, on a list of
tensors: ``train_gradient`` steps the flat weight vector with
``chain(clip_by_global_norm(100), adam(cosine_decay_schedule(lr, steps,
alpha)))``, ``pretrain_dataset`` the module's parameters with plain
``adam(lr)``.  optax's step count starts at 0: the first update's learning
rate is ``schedule(0)`` and its bias correction uses count 1.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


class Adam:
    """optax's ``adam(lr)``, after ``clip_by_global_norm(clip)`` when
    ``clip`` is given; ``lr`` is a float or a schedule of the step count.
    :meth:`step` updates the tensors in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, clip: float | None = None):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.b1, self.b2, self.eps, self.eps_root, self.clip = b1, b2, eps, eps_root, clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if not bool(norm < self.clip):
                grads = [(g / norm) * self.clip for g in grads]
        lr = -self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g ** 2 + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            p.copy_(p + lr * update)
