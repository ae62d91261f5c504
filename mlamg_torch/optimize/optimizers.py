"""Gradient-free optimizers on the host (counterpart of
``mlamg_tpu/optimize/optimizers.py``), on numpy vectors:

- :class:`PseudoGradientOptimizer`: Adam moments driven by a pluggable
  pseudo-gradient estimate g(x, key);
- :class:`SPSA`: the simultaneous-perturbation two-point gradient estimate;
- :class:`CuckooSearch`: Lévy-flight search over a (P, W) population.

The draws are the JAX package's (:mod:`mlamg_torch.utils.prng`), with its
default types in 64-bit mode (float64 and int64, ``DEFAULT_FLOAT``), and
the arithmetic is its op by op, so SPSA repeats its steps bit for bit;
CuckooSearch's Lévy flights draw normals, which ``erf_inv`` gives within
a few ulps of JAX's.
"""

from __future__ import annotations

from math import gamma, pi, sin
from typing import Callable

import numpy as np

from mlamg_torch.utils import prng

DEFAULT_FLOAT = np.float64  # jax's default float type with 64-bit mode on


class PseudoGradientOptimizer:
    """Adam moments over a pseudo-gradient callback g(x, key) -> (W,)."""

    def __init__(self, grad_estimate: Callable, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
        self.g = grad_estimate
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m = None
        self.v = None
        self.t = 0

    def step(self, x: np.ndarray, key) -> np.ndarray:
        g = self.g(x, key)
        if self.m is None:
            self.m = np.zeros_like(x)
            self.v = np.zeros_like(x)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        mhat = self.m / (1 - self.b1**self.t)
        vhat = self.v / (1 - self.b2**self.t)
        return x - self.lr * mhat / (np.sqrt(vhat) + self.eps)


class SPSA(PseudoGradientOptimizer):
    """Two-point simultaneous-perturbation gradient of scalar f."""

    def __init__(self, f: Callable, c: float = 1e-2, **kw):
        self.f = f
        self.c = c

        def grad(x, key):
            delta = np.sign(prng.rademacher(key, x.shape, np.float32, DEFAULT_FLOAT)).astype(
                x.dtype)
            fp = self.f(x + self.c * delta)
            fm = self.f(x - self.c * delta)
            return (fp - fm) / (2 * self.c) * delta

        super().__init__(grad, **kw)


class CuckooSearch:
    """Cuckoo search with Lévy flights over a (P, W) population; f maps a
    (W,) vector to a scalar to minimise."""

    def __init__(self, f: Callable, pop, pa: float = 0.25, alpha: float = 0.01,
                 beta: float = 1.5, key=None):
        self.f = f
        self.pop = np.asarray(pop)
        self.pa, self.alpha, self.beta = pa, alpha, beta
        self.key = key if key is not None else prng.PRNGKey(0)
        self.fitness = self._map(self.pop)

    def _map(self, pop: np.ndarray) -> np.ndarray:
        return np.asarray([self.f(row) for row in pop])

    def _levy(self, key, shape):
        # Mantegna's algorithm
        beta = self.beta
        sigma = (
            gamma(1 + beta) * sin(pi * beta / 2)
            / (gamma((1 + beta) / 2) * beta * 2 ** ((beta - 1) / 2))
        ) ** (1 / beta)
        k1, k2 = prng.split(key)
        u = prng.normal(k1, shape, DEFAULT_FLOAT) * sigma
        v = np.abs(prng.normal(k2, shape, DEFAULT_FLOAT))
        return u / v ** (1 / beta)

    def step(self):
        P, W = self.pop.shape
        self.key, k1, k2, k3 = prng.split(self.key, 4)
        best = self.pop[np.argmin(self.fitness)]
        # Lévy flight toward the best
        step = self.alpha * self._levy(k1, (P, W)) * (self.pop - best[None, :])
        cand = self.pop + step
        cand_fit = self._map(cand)
        improve = cand_fit < self.fitness
        self.pop = np.where(improve[:, None], cand, self.pop)
        self.fitness = np.where(improve, cand_fit, self.fitness)
        # abandon a fraction pa of worst nests
        drop = prng.bernoulli(k2, self.pa, (P,), DEFAULT_FLOAT)
        i, j = prng.randint(k3, (2, P), 0, P)
        new = self.pop + prng.uniform(self.key, (P, 1), DEFAULT_FLOAT) * (self.pop[i] - self.pop[j])
        new_fit = self._map(new)
        take = drop & (new_fit < self.fitness)
        self.pop = np.where(take[:, None], new, self.pop)
        self.fitness = np.where(take, new_fit, self.fitness)

    def best(self):
        i = int(np.argmin(self.fitness))
        return self.pop[i], float(self.fitness[i])
