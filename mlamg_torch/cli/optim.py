"""The trainers' optimiser: optax's Adam, step for step.

:class:`Adam` repeats ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0), optionally behind ``optax.clip_by_global_norm``, on a list of
tensors: ``train_gradient`` steps the flat weight vector with
``chain(clip_by_global_norm(100), adam(cosine_decay_schedule(lr, steps,
alpha)))``, ``pretrain_dataset`` the module's parameters with plain
``adam(lr)``.  optax's step count starts at 0: the first update's learning
rate is ``schedule(0)`` and its bias correction uses count 1.

With ``xla_fused`` (float32 tensors only) the update rounds as optax's does
inside ``train_cf_interp``'s jitted step on XLA's CPU backend: the moment
updates and the final ``p - lr u`` are fused multiply-adds (:func:`fma32`)
-- ``mu = fma(1 - b1, g, b1 mu)``, ``nu = fma(b2, nu, (1 - b2) g^2)``, ``p =
fma(-lr, u, p)`` -- and the first moment's bias correction is folded into
the denominator, ``u = mu / (bc1 (sqrt(nu / bc2) + eps))``.  Which product
LLVM fuses depends on the program around the update (a jitted update alone
fuses the other product of ``nu``'s); these are the choices of that step,
found by comparing its weights after two steps.  Its float32 weights then
follow JAX's bit for bit from the same gradients.
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
                 eps: float = 1e-8, eps_root: float = 0.0, clip: float | None = None,
                 xla_fused: bool = False):
        self.params = list(params)
        if xla_fused and any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("Adam(xla_fused=True) takes float32 tensors only")
        self.xla_fused = xla_fused
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
        if self.xla_fused:
            self._fused_step(grads, lr, bc1, bc2)
            return
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g ** 2 + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            p.copy_(p + lr * update)

    def _fused_step(self, grads, lr: float, bc1: float, bc2: float) -> None:
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(torch.float32)
            mu.copy_(fma32(g, 1 - self.b1, self.b1 * mu))
            nu.copy_(fma32(nu, self.b2, (1 - self.b2) * (g * g)))
            # a full tensor as divisor: PyTorch divides by a scalar as a
            # multiply by its reciprocal, which rounds otherwise; the square
            # root taken in float64 and rounded once is the correctly rounded
            # float32 one, which PyTorch's vectorised CPU sqrt is not always
            v = nu / torch.full_like(nu, _f32(bc2)) + self.eps_root
            den = torch.sqrt(v.to(torch.float64)).to(torch.float32) + self.eps
            p.copy_(fma32(mu / (_f32(bc1) * den), lr, p))


def _f32(v: float) -> float:
    """``v`` rounded to float32 (as a Python float)."""
    return float(torch.tensor(v, dtype=torch.float32))


def fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (a fused multiply-add) for float32
    ``a``, ``c`` and a float ``b`` (rounded to float32 first): the product
    is exact in float64, the sum is rounded to odd there (53 >= 24 + 2
    bits), then to float32."""
    f64 = torch.float64
    prod = a.to(f64) * _f32(b)
    c = c.to(f64)
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
