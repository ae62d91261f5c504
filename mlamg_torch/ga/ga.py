"""Population genetic algorithm on the host (counterpart of
``mlamg_tpu/ga/ga.py``, whose numpy operators it repeats line for line).

The population is a (P, W) numpy array and the fitness a user-supplied
function over it, where all the compute lives (in this package the
model-and-solver loop of :mod:`mlamg_torch.train`).  The genetic operators
are O(P W) elementwise numpy work; their random streams come from
``np.random.RandomState`` seeded by a key that :meth:`ParallelGA._split`
advances deterministically, so a run started from the same population,
fitness and key gives the JAX package's generations bit for bit, and a
checkpointed key resumes the same stream.

Selection is steady_state, roulette or greedy, with elitism (the best
individual always survives), restart around the best, and
``stochastic_iteration`` for a minibatch fitness.  Two opt-in refinements:
``adaptive_sigma`` (the mutation scale follows Rechenberg's 1/5-success
rule) and ``mutation_sparsity`` (mutate a random per-weight subset instead
of whole folds); ``mutation_scope`` freezes the weights outside a mask.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class GAConfig:
    crossover_probability: float = 0.5
    mutation_probability: float = 0.3
    mutation_min_perturb: float = -1.0
    mutation_max_perturb: float = 1.0
    steady_state_top_use: float = 1.0 / 3.0
    steady_state_bottom_discard: float = 1.0 / 3.0
    selection: str = "steady_state"  # steady_state | roulette | greedy
    restart_every: Optional[int] = None
    # -- adaptive refinements (off by default = reference behavior) --------
    adaptive_sigma: bool = False
    sigma_target_success: float = 0.2
    sigma_rate: float = 0.35
    sigma_min_factor: float = 1e-3
    sigma_max_factor: float = 2.0
    mutation_sparsity: Optional[float] = None  # per-weight mutate prob
    # boolean (W,) mask: only these weights ever mutate (None = all).  Lets
    # a fine-tune search the aggregation subnets alone while freezing an
    # already-good interpolation head (ablations show the two train at
    # very different difficulty).
    mutation_scope: Optional[object] = None


class ParallelGA:
    """Population GA over a (P, W) numpy array.

    Parameters
    ----------
    initial_population : (P, W) array
    fitness_func : (population (M, W), generation) -> (M,) fitness array.
        Evaluated only for individuals whose fitness is unknown.  This is
        where all the compute lives (it may return any array-like; it is
        copied to the host).
    fold_ids : (W,) int32 fold assignment (see mlamg_torch.ga.codec) or
        None for weight-wise operators.
    key : RNG state. Accepts a PRNGKey array (shape (2,) uint32, also what
        checkpoints store) or an int seed.
    """

    def __init__(
        self,
        initial_population,
        fitness_func: Callable,
        config: GAConfig | None = None,
        fold_ids=None,
        key=None,
    ):
        self.population = np.array(initial_population, dtype=np.float64 if
                                   np.asarray(initial_population).dtype ==
                                   np.float64 else np.float32)
        self.population_size, self.num_weights = self.population.shape
        self.fitness = np.zeros(self.population_size, self.population.dtype)
        self.computed = np.zeros(self.population_size, dtype=bool)
        self.fitness_func = fitness_func
        self.cfg = config or GAConfig()
        self.fold_ids = None if fold_ids is None else np.asarray(fold_ids)
        self.num_folds = (
            int(np.max(self.fold_ids)) + 1 if fold_ids is not None else None
        )
        self.key = self._coerce_key(key)
        self.num_generation = 0
        self.sigma0 = max(
            abs(self.cfg.mutation_min_perturb), abs(self.cfg.mutation_max_perturb)
        )
        self.sigma = self.sigma0
        self._last_new: np.ndarray = np.zeros(0, np.int64)
        self._pre_gen_best: float = -np.inf
        # per-generation offspring diagnostics (populated by iteration());
        # flat-fitness stagnation is undiagnosable without them.
        self.last_stats: dict = {}

    @staticmethod
    def _coerce_key(key) -> np.ndarray:
        if key is None:
            key = 0
        if np.isscalar(key):
            return np.array([0, int(key) & 0xFFFFFFFF], np.uint32)
        return np.asarray(key).astype(np.uint32).reshape(2)

    # -- helpers ------------------------------------------------------------

    def _split(self) -> np.random.RandomState:
        """Fresh host RNG; advances self.key deterministically (the key is
        checkpointed, so training resumes with an identical stream)."""
        k0, k1 = int(self.key[0]), int(self.key[1])
        seed = (k0 * 2654435761 + k1 * 40503 + 0x9E3779B9) % (2**31 - 1)
        self.key = np.array(
            [(k0 + 1) & 0xFFFFFFFF, (k1 ^ ((seed << 1) & 0xFFFFFFFF)) & 0xFFFFFFFF],
            np.uint32,
        )
        return np.random.RandomState(seed)

    def compute_fitness(self):
        if self.computed.all():
            return
        idx = np.where(~self.computed)[0]
        vals = self.fitness_func(self.population[idx], self.num_generation)
        self.fitness[idx] = np.asarray(vals, dtype=self.fitness.dtype)
        self.computed[idx] = True

    def best_solution(self):
        self.compute_fitness()
        i = int(np.argmax(self.fitness))
        return self.population[i].copy(), float(self.fitness[i]), i

    # -- genetic operators (host-side numpy) ---------------------------------

    def _crossover_pairs(self, num: int, parents_idx: np.ndarray, probs):
        """num offspring by fold-wise (or single-point) crossover."""
        rng = self._split()
        n_pairs = num // 2
        p1 = rng.choice(parents_idx, n_pairs, p=probs)
        p2 = rng.choice(parents_idx, n_pairs, p=probs)
        # re-draw collisions once; exact distinctness is not load-bearing
        coll = p2 == p1
        p2[coll] = parents_idx[
            (np.searchsorted(parents_idx, p2[coll]) + 1) % len(parents_idx)
        ]
        do_cross = rng.rand(n_pairs) < self.cfg.crossover_probability
        A = self.population[p1]
        B = self.population[p2]
        if self.fold_ids is not None:
            coin = rng.rand(n_pairs, self.num_folds) < 0.5
            mask = coin[:, self.fold_ids]  # (n_pairs, W)
        else:
            pt = rng.randint(0, self.num_weights, (n_pairs, 1))
            mask = np.arange(self.num_weights)[None, :] < pt
        if self.cfg.mutation_scope is not None:
            # out-of-scope ("frozen") weights must not be exchanged either:
            # crossover mixing them would let the frozen head drift between
            # individuals even though mutation never touches it.  Forcing
            # the mask True outside the scope makes each child keep its own
            # parent's frozen genes (child1<-A, child2<-B).
            mask = mask | ~np.asarray(self.cfg.mutation_scope, bool)[None, :]
        child1 = np.where(mask, A, B)
        child2 = np.where(mask, B, A)
        # when not crossing, children are the parents themselves
        child1 = np.where(do_cross[:, None], child1, A)
        child2 = np.where(do_cross[:, None], child2, B)
        off = np.concatenate([child1, child2], axis=0)
        carried = np.concatenate([~do_cross, ~do_cross])
        carried_fit = np.concatenate([self.fitness[p1], self.fitness[p2]])
        return off, carried, carried_fit

    def _selection_steady_state(self):
        n_discard = int(self.cfg.steady_state_bottom_discard * self.population_size)
        n_top = max(2, int(self.cfg.steady_state_top_use * self.population_size))
        if n_discard == 0:
            return
        order = np.argsort(-self.fitness)
        top = np.sort(order[:n_top])
        probs = np.full(n_top, 1.0 / n_top)
        num = ((n_discard + 1) // 2) * 2
        off, carried, carried_fit = self._crossover_pairs(num, top, probs)
        worst = order[::-1][:n_discard]
        self.population[worst] = off[:n_discard]
        # Replaced rows are always marked unknown (reference parga.py:188):
        # with crossover off the offspring are parent copies, and leaving
        # them "computed" would silently disable mutation -> a no-op GA.
        self.computed[worst] = False
        self._last_new = worst

    def _selection_roulette(self):
        probs = self.fitness / max(np.sum(np.abs(self.fitness)), 1e-30)
        probs = np.maximum(probs, 0)
        probs = probs / max(probs.sum(), 1e-30)
        num = ((self.population_size + 1) // 2) * 2
        idx = np.arange(self.population_size)
        off, carried, carried_fit = self._crossover_pairs(num, idx, probs)
        self.population = off[: self.population_size]
        self.fitness = carried_fit[: self.population_size].astype(
            self.fitness.dtype
        )
        self.computed = carried[: self.population_size].copy()
        self._last_new = np.where(~self.computed)[0]

    def _selection_greedy(self):
        best, fit, _ = self.best_solution()
        self.population = np.broadcast_to(
            best[None, :], self.population.shape
        ).copy()
        self.fitness[:] = fit
        self.computed[:] = False
        self._last_new = np.arange(self.population_size)

    def _mutation(self):
        new = np.where(~self.computed)[0]
        if len(new) == 0:
            return
        rng = self._split()
        sub = self.population[new]
        if self.cfg.adaptive_sigma:
            lo, hi = -self.sigma, self.sigma
        else:
            lo, hi = self.cfg.mutation_min_perturb, self.cfg.mutation_max_perturb
        if self.cfg.mutation_sparsity is not None:
            mask = rng.rand(*sub.shape) < self.cfg.mutation_sparsity
        elif self.fold_ids is not None:
            coin = rng.rand(len(new), self.num_folds) < self.cfg.mutation_probability
            mask = coin[:, self.fold_ids]
        else:
            mask = rng.rand(*sub.shape) < self.cfg.mutation_probability
        noise = rng.uniform(lo, hi, sub.shape).astype(sub.dtype)
        if self.cfg.mutation_scope is not None:
            mask = mask & np.asarray(self.cfg.mutation_scope, bool)[None, :]
        self.population[new] = sub + noise * mask
        self.computed[new] = False

    def _record_stats(self):
        """Offspring diagnostics for the generation just evaluated."""
        if len(self._last_new) == 0:
            self.last_stats = {}
            return
        off = np.asarray(self.fitness[self._last_new], np.float64)
        self.last_stats = dict(
            n_offspring=int(len(off)),
            accept_rate=float(np.mean(off > self._pre_gen_best)),
            offspring_best=float(off.max()),
            offspring_mean=float(off.mean()),
            offspring_std=float(off.std()),
            sigma=float(self.sigma),
        )

    def _adapt_sigma(self):
        """Rechenberg 1/5-success rule on the just-evaluated offspring."""
        self._record_stats()
        if not self.cfg.adaptive_sigma or len(self._last_new) == 0:
            return
        success = float(np.mean(self.fitness[self._last_new] > self._pre_gen_best))
        self.sigma *= float(
            np.exp(self.cfg.sigma_rate * (success - self.cfg.sigma_target_success))
        )
        self.sigma = float(
            np.clip(
                self.sigma,
                self.cfg.sigma_min_factor * self.sigma0,
                self.cfg.sigma_max_factor * self.sigma0,
            )
        )

    def restart(self):
        """Re-seed population around the best (reference parga.py:217-227)."""
        best, fit, _ = self.best_solution()
        rng = self._split()
        noise = rng.uniform(
            -1.0, 1.0, (self.population_size - 1, self.num_weights)
        ).astype(self.population.dtype)
        self.population = np.concatenate(
            [best[None, :], best[None, :] + noise], axis=0
        )
        self.fitness[0] = fit
        self.computed[:] = False
        self.computed[0] = True

    # -- iterations ---------------------------------------------------------

    def iteration(self):
        cfg = self.cfg
        if (
            cfg.restart_every is not None
            and self.num_generation > 0
            and self.num_generation % cfg.restart_every == 0
        ):
            self.restart()
        self.num_generation += 1
        best, best_fit, _ = self.best_solution()
        self._pre_gen_best = best_fit
        {
            "steady_state": self._selection_steady_state,
            "roulette": self._selection_roulette,
            "greedy": self._selection_greedy,
        }[cfg.selection]()
        if cfg.mutation_probability != 0.0:
            self._mutation()
        self.compute_fitness()
        self._adapt_sigma()
        # elitism: previous best replaces current worst
        worst = int(np.argmin(self.fitness))
        self.population[worst] = best
        self.fitness[worst] = best_fit
        self.computed[worst] = True

    def stochastic_iteration(self):
        """Minibatch-fitness variant: recompute everything against the
        current batch first (reference parga.py:254-270)."""
        self.num_generation += 1
        self.computed[:] = False
        self.compute_fitness()
        best, best_fit, _ = self.best_solution()
        self._pre_gen_best = best_fit
        {
            "steady_state": self._selection_steady_state,
            "roulette": self._selection_roulette,
            "greedy": self._selection_greedy,
        }[self.cfg.selection]()
        self._mutation()
        self.compute_fitness()
        self._adapt_sigma()
        worst = int(np.argmin(self.fitness))
        self.population[worst] = best
        self.fitness[worst] = best_fit
        self.computed[worst] = True
