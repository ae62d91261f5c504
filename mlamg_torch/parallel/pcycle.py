"""Row-partitioned two-level and multilevel AMG solves (counterpart of
``mlamg_tpu/parallel/pcycle.py``).

- smoothing: weighted-Jacobi sweeps of the local rows, each after a halo
  exchange;
- residual: the local ELL product on the halo-extended iterate;
- Galerkin coarse operator, "AP then reduce": each shard forms AP from
  its halo-extended P rows, and A_H = psum(P_loc^T AP_loc) is replicated;
- coarse solve: the replicated dense LU of A_H (``mg/coarse.py``), or a
  replicated V-cycle over a coarse :class:`~mlamg_torch.mg.cycle.Hierarchy`;
- restriction / prolongation: local (n_loc, k) products and one psum;
- convergence: residual norms by psum, read out as the serial solver
  reads them (``_conv_factor``).

The JAX package runs the iteration as one ``while_loop``; here it is a
host loop, which reads the residual norm each iteration only when
``res_tol > 0``.
"""

from __future__ import annotations

import torch

from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import _conv_factor, vcycle
from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh
from mlamg_torch.parallel.pspmv import PartitionedELL, as_sharded, local_spmv


def _split_rows(A: PartitionedELL, P_rows, lay: _comm.Layout, dtype) -> _comm.Sharded:
    """(n, k) or (S, n_loc, k) prolongator rows as this process's shards.
    A tensor stays on its device until its shards move to theirs."""
    P = _comm.as_tensor(P_rows)
    if P.ndim == 2:
        S, n_loc = A.num_shards, A.n_loc
        pad = S * n_loc - P.shape[0]
        if pad:
            P = torch.cat([P, P.new_zeros((pad, P.shape[1]))])
        P = P.view(S, n_loc, P.shape[1])
    return _comm.split(P, lay, dtype)


def _inv_diagonal(A: PartitionedELL, data: _comm.Sharded, col: _comm.Sharded) -> _comm.Sharded:
    diag_col = torch.arange(A.n_loc) + A.halo

    def inv(d, c):
        diag = (d * (c == diag_col.to(c.device)[:, None])).sum(-1)
        return torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)

    return _comm.zip_map(inv, data, col)


class DistributedCycle:
    """One distributed cycle, set up once for a matrix, prolongator and
    right-hand side: with ``hierarchy`` None a two-level cycle (the
    distributed RAP and a replicated LU), else a replicated V-cycle over
    ``hierarchy`` below level 0.  ``cycle(x)`` runs one iteration on a
    sharded iterate; :meth:`solve` iterates."""

    def __init__(self, A: PartitionedELL, P_rows, b, mesh: Mesh, *, pre: int = 1,
                 post: int = 1, omega: float = 0.666, singular: bool = False, hierarchy=None):
        if A.halo is None:
            raise ValueError("the distributed cycle needs a halo-encoded partition")
        self.A, self.mesh, self.pre, self.post = A, mesh, pre, post
        self.omega, self.singular = omega, singular
        self.data, self.col = A.to_global(mesh)
        self.layout = self.data.layout
        dtype = A.data.dtype
        self.P = _split_rows(A, P_rows, self.layout, dtype)
        self.dinv = _inv_diagonal(A, self.data, self.col)
        self.b = as_sharded(A, b, mesh, dtype)
        if hierarchy is not None:
            hiers = [_comm.to_device(hierarchy, p.device) for p in self.P.parts]
            self._coarse = [lambda r, h=h: vcycle(h, r, torch.zeros_like(r), omega=omega,
                                                  nu=max(pre, 1)) for h in hiers]
        else:
            self._coarse = [CoarseSolver.factor(a).solve for a in self._galerkin()]

    def _galerkin(self) -> list:
        """A_H = psum(P_loc^T AP_loc), AP from each shard's halo-extended
        P rows, one (s, n_loc, k) gather per ELL slot."""
        P_ext = _comm.ring_halo(self.P, self.A.halo, 0.0)
        partial = []
        for d, c, p, pe in zip(self.data.parts, self.col.parts, self.P.parts, P_ext.parts):
            sid = torch.arange(pe.shape[0], device=pe.device).view(-1, 1)
            ap = torch.zeros_like(p)
            for j in range(d.shape[2]):
                ap.addcmul_(d[:, :, j, None], pe[sid, c[:, :, j]])
            partial.append(torch.bmm(p.transpose(1, 2), ap))
            del ap
        return _comm.psum(_comm.Sharded(tuple(partial), self.layout))

    def spmv(self, v: _comm.Sharded) -> _comm.Sharded:
        return _comm.zip_map(local_spmv, self.data, self.col, _comm.ring_halo(v, self.A.halo, 0.0))

    def _smooth(self, x, nu: int):
        omega = self.omega
        for _ in range(nu):
            x = _comm.zip_map(lambda xp, dp, bp, yp: xp + omega * dp * (bp - yp),
                              x, self.dinv, self.b, self.spmv(x))
        return x

    def __call__(self, x: _comm.Sharded) -> _comm.Sharded:
        x = self._smooth(x, self.pre)
        r = _comm.zip_map(torch.sub, self.b, self.spmv(x))
        r_H = _comm.psum(_comm.zip_map(lambda p, rp: torch.bmm(rp[:, None, :], p)[:, 0],
                                       self.P, r))
        x = _comm.Sharded(tuple(xp + p @ solve(rh) for xp, p, solve, rh in
                                zip(x.parts, self.P.parts, self._coarse, r_H)), self.layout)
        x = self._smooth(x, self.post)
        if self.singular:
            total = _comm.psum(x.map(lambda p: p.sum(1)))
            x = _comm.Sharded(tuple(p - t / self.A.shape[0] for p, t in zip(x.parts, total)),
                              self.layout)
        return x

    def residual_norm(self, x: _comm.Sharded) -> torch.Tensor:
        res = _comm.zip_map(lambda bp, yp: ((bp - yp) ** 2).sum(1), self.b, self.spmv(x))
        return torch.sqrt(_comm.psum(res)[0])

    def solve(self, x0, res_tol: float, max_iter: int):
        """Iterate from ``x0`` until the residual norm is at most
        ``res_tol`` (read each iteration only when ``res_tol > 0``) or
        ``max_iter`` cycles.  Returns (x sharded, conv, err, iters)."""
        x = as_sharded(self.A, x0, self.mesh, self.A.data.dtype)
        err = torch.zeros(max_iter, dtype=self.A.data.dtype, device=self.P.parts[0].device)
        iters = 0
        while iters < max_iter:
            x = self(x)
            e = self.residual_norm(x)
            err[iters] = e
            iters += 1
            if res_tol > 0 and float(e) <= res_tol:
                break
        return x, _conv_factor(err, iters), err, iters


def ptwolevel_solve(A: PartitionedELL, P_rows, b, x0, mesh: Mesh, *,
                    pre_smoothing_steps: int = 1, post_smoothing_steps: int = 1,
                    jacobi_weight: float = 0.666, res_tol: float = 1e-8, max_iter: int = 300,
                    singular: bool = False):
    """Distributed two-level solve; returns (x (S, n_loc) sharded, conv,
    err, iters).

    ``A`` is a halo-encoded PartitionedELL; ``P_rows`` the (n, k) dense
    prolongator (a host array every process holds, or a tensor, split per
    shard on its device) or its (S, n_loc, k) rows; ``b`` and ``x0`` (n,)
    vectors or (S, n_loc) arrays, sharded or not.
    """
    cycle = DistributedCycle(A, P_rows, b, mesh, pre=pre_smoothing_steps,
                             post=post_smoothing_steps, omega=jacobi_weight, singular=singular)
    return cycle.solve(x0, res_tol, max_iter)


def pvcycle_solve(A: PartitionedELL, P0_rows, coarse_hierarchy, b, x0, mesh: Mesh, *,
                  omega: float = 0.666, nu: int = 1, res_tol: float = 1e-8,
                  max_iter: int = 200):
    """Distributed multilevel V-cycle solve.

    Level 0 is row-partitioned; below it every shard runs the replicated
    V-cycle over ``coarse_hierarchy`` (a :class:`~mlamg_torch.mg.cycle.Hierarchy`
    whose finest operator is A_1 = P0^T A P0), or with None the two-level
    cycle whose A_1 is formed distributed and LU-solved.
    """
    cycle = DistributedCycle(A, P0_rows, b, mesh, pre=nu, post=nu, omega=omega,
                             hierarchy=coarse_hierarchy)
    return cycle.solve(x0, res_tol, max_iter)
