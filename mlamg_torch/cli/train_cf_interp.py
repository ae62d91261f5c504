"""Train the C/F-interpolation network and show its deployment win
(counterpart of ``mlamg_tpu/cli/train_cf_interp.py``).

1. Training operators: the pinned pressure Laplacians of lid-driven-cavity
   systems at several resolutions (the Schur block the learned
   preconditioner serves), each with its greedy C/F splitting and unit
   test vectors from ``RandomState(seed)``.
2. Adam (optax's jitted update, :class:`~mlamg_torch.cli.optim.Adam` with
   ``xla_fused``) on ``amg_loss`` of
   P = CFInterpolationNetwork(A, splitting), from flax's initial weights
   (:func:`~mlamg_torch.models.gnn.init_flax_` of ``PRNGKey(seed)``).  As
   in the JAX CLI, the weights are float32 and the systems, the forward
   and the backward float64.
3. Evaluation: FGMRES on held-out pressure Laplacians, and the Stokes
   Schur round trip at ``--eval-size``, with LearnedAMGPreconditioner
   (the trained network) against its classical fallback.

The checkpoint (``--checkpoint``) holds the JAX package's parameter tree
and ``net_config``, so either package deploys it; ``--out`` writes the
JAX CLI's JSON.

    python -m mlamg_torch.cli.train_cf_interp --epochs 60 --out cf.json [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mlamg_torch.device import resolve_device


def pinned_pressure_laplacian(system):
    """Ap with dof 0 pinned (removes the Neumann nullspace)."""
    import scipy.sparse as sp

    Ap = system.Ap.tolil()
    Ap[0, :] = 0.0
    Ap[:, 0] = 0.0
    Ap[0, 0] = 1.0
    return sp.csr_matrix(Ap)


def cf_inputs(A_scipy, theta: float, dtype=torch.float64, device=None):
    """(A as CSR, is_coarse, c_rank, num_coarse) of the greedy C/F
    splitting of ``A_scipy`` at strength ``theta``."""
    from mlamg_torch.graph.coarsening import greedy_coarsening
    from mlamg_torch.models.cf_interp import cf_rank
    from mlamg_torch.ops.sparse import CSR

    dev = resolve_device(device)
    n = A_scipy.shape[0]
    _, _, C = greedy_coarsening(A_scipy, theta)
    is_coarse = np.zeros(n, bool)
    is_coarse[C] = True
    c_rank, num_c = cf_rank(is_coarse)
    return (CSR.from_scipy(A_scipy, dtype=dtype, device=dev),
            torch.from_numpy(is_coarse).to(dev),
            torch.from_numpy(c_rank.astype(np.int64)).to(dev), num_c)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train CF-interp net, demo deployment")
    p.add_argument("--train-sizes", type=int, nargs="+", default=[8, 10, 12])
    p.add_argument("--eval-sizes", type=int, nargs="+", default=[14, 16, 20],
                   help="held-out resolutions for the pressure-solve "
                        "comparison (learned vs classical PC)")
    p.add_argument("--eval-rhs-seeds", type=int, default=5,
                   help="random right-hand sides per resolution "
                        "(mean +- std error bars)")
    p.add_argument("--eval-size", type=int, default=14,
                   help="resolution of the full Stokes Schur round trip")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--theta", type=float, default=0.56)
    p.add_argument("--test-vecs", type=int, default=8)
    p.add_argument("--dims", type=int, nargs="+", default=[8, 8, 16])
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


@dataclasses.dataclass
class CFTraining:
    """The network, its optimiser and the training operators: ``train``
    holds (A, is_coarse, c_rank, num_coarse, test vectors) per size."""

    net: torch.nn.Module
    opt: object
    train: list
    device: torch.device
    dtype: torch.dtype = torch.float64

    def step(self, i: int) -> float:
        """One Adam step on operator ``i`` (the gradient in float32, the
        weights' type); returns its amg_loss before the step."""
        from mlamg_torch.models.loss import amg_loss

        Ac, is_c, c_rank, num_c, tv = self.train[i]
        loss = amg_loss(self.net(Ac, is_c, c_rank, num_c), Ac, tv)
        self.opt.step(torch.autograd.grad(loss, self.opt.params))
        return float(loss.detach())


def prepare(args: argparse.Namespace) -> CFTraining:
    """The training operators, the network at flax's initial weights
    (float32) and optax's Adam."""
    from mlamg_torch.cli.optim import Adam
    from mlamg_torch.data.stokes import lid_driven_cavity
    from mlamg_torch.models.cf_interp import CFInterpolationNetwork
    from mlamg_torch.models.gnn import init_flax_
    from mlamg_torch.utils import prng

    dev = resolve_device(args.device)
    dtype = torch.float64
    rng = np.random.RandomState(args.seed)
    train = []
    for nres in args.train_sizes:
        A = pinned_pressure_laplacian(lid_driven_cavity(n=nres, Re=10.0))
        Ac, is_c, c_rank, num_c = cf_inputs(A, args.theta, dtype, dev)
        tv = rng.randn(A.shape[0], args.test_vecs)
        tv /= np.linalg.norm(tv, axis=0, keepdims=True)
        train.append((Ac, is_c, c_rank, num_c, torch.from_numpy(tv).to(dev, dtype)))
    net = CFInterpolationNetwork(dims=tuple(args.dims), K=args.K)
    init_flax_(net, prng.PRNGKey(args.seed))
    net.to(dev)
    return CFTraining(net, Adam(list(net.parameters()), args.lr, xla_fused=True), train, dev, dtype)


def evaluate(args: argparse.Namespace, net, device, dtype=torch.float64, log=print) -> dict:
    """The pressure solves at ``--eval-sizes`` (FGMRES iterations, learned
    against classical, ``--eval-rhs-seeds`` right-hand sides each) and the
    Schur round trip at ``--eval-size``; the JAX CLI's JSON fields."""
    from mlamg_torch.data.stokes import lid_driven_cavity
    from mlamg_torch.deploy import LearnedAMGPreconditioner, Options, SchurFieldsplitSolver
    from mlamg_torch.mg.krylov import fgmres

    pc_opts = Options({"mlamg_amg_rtol": 0.0, "mlamg_max_iter": 2,
                       "mlamg_greedy_theta": args.theta})
    pressure = []
    for nres in args.eval_sizes:
        A_eval = pinned_pressure_laplacian(lid_driven_cavity(n=nres, Re=10.0))
        pcs = {"learned": LearnedAMGPreconditioner(A_eval, pc_opts, net=net, dtype=dtype,
                                                   device=device),
               "classical": LearnedAMGPreconditioner(A_eval, pc_opts, dtype=dtype,
                                                     device=device)}
        Ad = pcs["learned"].A
        iters = {k: [] for k in pcs}
        for sd in range(args.eval_rhs_seeds):
            b = torch.from_numpy(np.random.RandomState(1000 + sd).randn(A_eval.shape[0]))
            b = b.to(device, dtype)
            for name, pc in pcs.items():
                iters[name].append(int(fgmres(Ad, b, M=pc, tol=1e-8)[2]))
        row = {"n_res": nres, "n_p": A_eval.shape[0]}
        for name in pcs:
            row[f"fgmres_{name}_mean"] = float(np.mean(iters[name]))
            row[f"fgmres_{name}_std"] = float(np.std(iters[name]))
        row["win_pct"] = round(100.0 * (1.0 - row["fgmres_learned_mean"] /
                                        max(row["fgmres_classical_mean"], 1e-9)), 1)
        pressure.append(row)
        log(f"pressure solve n={nres}: {row}")

    s = lid_driven_cavity(n=args.eval_size, Re=10.0, dt=0.05)
    A_eval = pinned_pressure_laplacian(s)

    def run(pc):
        x, _, iters = SchurFieldsplitSolver(s, pc, dtype=dtype, device=device).solve(tol=1e-8)
        r = s.saddle_matrix() @ x.cpu().numpy().astype(np.float64) - s.rhs()
        return int(iters), float(np.linalg.norm(r))

    it_l, r_l = run(LearnedAMGPreconditioner(A_eval, pc_opts, net=net, dtype=dtype,
                                             device=device))
    it_c, r_c = run(LearnedAMGPreconditioner(A_eval, pc_opts, dtype=dtype, device=device))
    return {"pressure_solves": pressure, "eval_size": args.eval_size, "n_p": s.n_p,
            "fgmres_iters_learned": it_l, "fgmres_iters_classical": it_c,
            "resid_learned": r_l, "resid_classical": r_c}


def main(argv=None, log=print, record: dict | None = None) -> dict:
    """Train, save, evaluate; returns the JAX CLI's JSON record.  A
    ``record`` dict receives the seconds of each epoch and of the
    evaluation."""
    from mlamg_torch.convert import params_from_cfnet
    from mlamg_torch.utils.checkpoint import save_checkpoint

    args = parse_args(argv)
    run = prepare(args)
    dev = run.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses0, tot, epoch_s = None, [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tot = [run.step(i) for i in range(len(run.train))]
        sync()
        epoch_s.append(time.perf_counter() - t0)
        if losses0 is None:
            losses0 = list(tot)
        if (epoch + 1) % 10 == 0 or epoch == args.epochs - 1:
            log(f"epoch {epoch + 1}: amg_loss per matrix {np.round(tot, 4)}")

    if args.checkpoint:
        # net_config pins the forward the weights were trained under
        save_checkpoint(args.checkpoint, generation=args.epochs,
                        best_params=params_from_cfnet(run.net),
                        extra=dict(net_config=dict(dims=list(args.dims), K=args.K,
                                                   row_normalize=bool(run.net.row_normalize))))
    t0 = time.perf_counter()
    with torch.no_grad():
        result = evaluate(args, run.net, dev, run.dtype, log)
    result.update(train_loss_first_epoch=losses0, train_loss_last_epoch=tot)
    if record is not None:
        record.update(seconds_per_epoch=epoch_s, seconds_eval=time.perf_counter() - t0)
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
