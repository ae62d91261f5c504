#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mlamg_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases (each prints one JSON line; any failure exits non-zero):

1. device: the card's name and power limit from nvidia-smi.
2. kernels: build every CUDA kernel from ``mlamg_torch/ops/csrc`` with nvcc
   (one process per source, all started together), then hold ``well_spmv``
   at every LANES, plain and affine (alpha=-1, c), against its plain
   version on the sliced pack (``sliced_spmv_reference``, bit for bit) and
   against the plain version on the ELL arrays (``well_spmv_reference``,
   to 1e-5 * max|y|): on the RCM-ordered random-hull FEM matrix, and at
   sigma 1 and 256 on a banded matrix with uneven row degrees, one with
   empty rows and one with n = 32k + 5.  Time kernel and the torch.sparse
   CSR matvec with CUDA events, L2-cold (a 256 MB buffer written and read
   back between launches, each launch between its own events, median of
   20) and warm (100 back to back), queued behind a spin kernel so that
   host time does not count; and the plain versions over 50 warmed calls.
   Then ``ordered_sum`` (``ordered_sum_phase``): the kernel against the
   plain chain of adds bit for bit, timed L2-cold and warm beside its byte
   bound, the plain chain's time and both wrappers' host time and device
   operations a call (the kernel must be one), at the learned cell's
   shapes and at a tree_sum level of a 600k and a 16.8M vector; its
   launches in a learned build and cycle on test grid 0.
3. path: the unstructured multilevel SA-AMG solve, as bench.py drives the
   JAX package: ``build_unstructured_hierarchy(alpha=0.2, max_levels=5,
   min_coarse=1200, lloyd_maxiter=5, fmt="well")`` on the 600k-dof hull
   (seed 7), then ``uvcycle_solve`` W(4,4) Chebyshev from a seed-0 random
   x0 with b = 0.  Checks the conv factor against the JAX package's
   0.4811 (+-0.03) and <= 20 W-cycles to 1e-6, that the solve launched the
   kernel exactly as often as the cycle's structure says, that the kernel
   agrees with the plain version on every level operator, that the
   permuted system solves the original one (relative residual < 1e-4 in
   float64 scipy), and that a small hierarchy's cycle on the card matches
   the same cycle on the CPU.  Times a W-cycle with CUDA events and reads
   a torch.profiler trace of three W-cycles for the device's busy time and
   idle share.  Then, per level: n, nnz, pack slots, LANES, the kernel's
   cold and warm time against its nonzero bound, and launches per W-cycle,
   with the sum of launches x warm time beside the trace's ``well_spmv``
   time, and the fine level's bandwidth and gather spans; and the sweeps
   behind the kernel's choices: every LANES at every level, sigma 1
   against 256 at levels 0-1.
4. galerkin: the sparse Galerkin setup on the same 600k hull (not meshed
   again): the path's hierarchy built with ``rap_mode="device"`` (the
   pattern-masked products on the card; the path phase's ``"auto"`` is the
   host product) and the same W(4,4) solve on it, held to the path phase's
   checks (conv, cycles, residual, launches).  Level 0's aggregates equal
   the host hierarchy's, and level 0's A_H from ``rap_masked`` is within
   1e-4 * max|A_H| of the host product on the same (A, agg, omega).
   Prints per level the aggregate entries that differ (deeper levels
   aggregate an A_H that rounding moves), the branch, pt_width and
   ap_width and the product's seconds; setup seconds and profile of both
   modes and the device setup's peak memory.  ``rap_learned`` with a random
   P-hat, against a float64 scipy oracle (rtol = atol = 2e-4): on the
   1500-node hull with random aggregates (the JAX package's test) and on
   the 600k level 0 with its Lloyd aggregates.
   ``build_hierarchy(sparse_levels=1)`` on the 256^2 Poisson in float64 on
   the card and on the CPU: the coarse CSR equal (pattern) and within
   1e-12 relative, and ``vcycle_solve`` to a relative residual of 1e-8 on
   both.
5. dia_kernel: hold ``dia_spmv`` against ``dia_spmv_reference`` (plain and
   affine, 1e-5 * max|y|) on the 4096^2 five-point Poisson and on a
   random banded matrix with n = 128*64 + 37; time kernel, plain version
   and the torch.sparse CSR matvec on the 4096^2 fine level.
6. structured: the all-DIA hierarchy as bench.py's ``bench_vcycle_16m``
   drives the JAX package: ``build_structured_hierarchy(kind="bilinear",
   sides=(2,)*7, min_coarse=900)`` on the 4096^2 Poisson (16.8M dofs), then
   Chebyshev V-cycles (nu=2) from a seed-0 x0 with b = 0.  Checks the conv
   factor (bench formula over 6 cycles) against the JAX package's 0.1393
   (+-0.03), the ``dia_spmv`` launches of setup and cycles against the
   counts derived from the hierarchy, the kernel on every level operator,
   and a seed-1 random right-hand side solved to a float64 relative
   residual below 1e-3.  Times a V-cycle (CUDA events and wall clock) and
   reads a torch.profiler trace of three V-cycles.
7. twolevel: ``bench_twolevel``'s configuration: ``twolevel_solve`` on the
   512^2 Poisson with a factored SA prolongator over 16x16 boxes
   (omega 0.65) and an inverse coarse solve, 24 iterations fused and
   unfused; checks the kernel on the S and S^T factors and the launches.
8. small_structured: one 64^2 bilinear V-cycle and one 64^2 box-SA fused
   two-level iteration on the card against the same on the CPU.
9. eval: the learned two-level evaluation through the port's CLI functions
   (``mlamg_torch.cli.evaluate_dataset``: ``load_model``, ``evaluate``) on
   the card in float32 with the ablations, on ``data_out/2d_iso/test``
   (``runs_iso_r5``) and ``data_out/2d_aniso/test`` (``runs_aniso_r5_c``).
   Checks every method's mean against the committed JSON of the JAX CLI
   (within 0.01), ML below Lloyd on 2d_iso, a second 2d_iso run on the card
   equal per grid, and the same evaluation on the CPU within 0.02 per grid
   (and counts the grids whose FullAggNet centers or agg_id differ between
   card and CPU).  Neither spmv kernel is on this path: it checks that
   ``well_spmv`` and ``dia_spmv`` launch 0 times (``ordered_sum``'s
   launches are counted).  Prints seconds per method, ms per two-level
   iteration (CUDA events) and per FullAggNet forward on the largest
   2d_iso grid, and a torch.profiler trace of one ML conv; the phase must
   finish within 90 s.
10. train: gradient training through the port's CLI functions
   (``mlamg_torch.cli.train_gradient``: ``prepare``, ``GradientRun.step``,
   ``discrete_losses``; ``mlamg_torch.cli.pretrain_dataset.main``) on the
   card in float32, on the 40 grids of ``data_out/2d_iso/train``.  Checks
   that ``make_buckets`` at step 128 gives 2 buckets and that the Lloyd
   reference convs measured on the card (max_iter 75, multicolor GS) equal
   the committed ``.ref_convs_olson.json`` within 1e-4 per grid (read,
   never written); takes 2 Adam steps from ``runs_iso_r5/grad_best.ckpt``
   with the recipe's settings (weight noise 0.01, tau 0.08 -> 0.015 over
   600 steps, lr 3e-3) and holds the first step's loss (1e-4 relative) and
   gradient (1e-2 relative in norm, outside the tensors whose gradients
   the rounding can set, ``amplified_grad``; the whole gradient's gap and
   cosine printed) against the same step on the CPU (run in a worker
   process beside the card's work, with PyTorch's deterministic algorithms
   so that every run gives the same reference), the discrete train and test losses
   after both steps against the CPU run's (within 0.02) and 1 pretraining
   epoch from scratch (the mean bce within 1e-3 relative, mse_c and mse_p
   within 0.25: the float32 bounds sit above what rounding moves on this
   model, see ``TRAIN_GRAD_RTOL``); then the first step and the epoch in float64 on
   the first 12 grids, card against CPU (a second worker): loss and gradient outside
   ``amplified_grad`` within 1e-10, the epoch's bce and mse_p within 1e-9
   (mse_c printed; see ``F64_PRETRAIN_RTOL``); saves the
   trained weights and evaluates them
   through ``cli.evaluate_dataset.load_model`` on a test grid (the same
   conv as the trained module).  Neither spmv kernel is on this path (0
   launches of each).  Prints s per step and per epoch (card and CPU), the
   CUDA-event time of one loss and backward on the largest training grid,
   whether two card runs of it give the same gradient bits, and a
   torch.profiler trace of it; the phase must finish within 150 s.

11. ga, in a fresh process (see ``main``): GA training through the port's CLI functions
   (``mlamg_torch.cli.train_dataset``: ``prepare``, ``train``, ``report``)
   on the card in float32 with ``scripts/run_headline_iso_ga.sh``'s flags
   (bucket step 128, init perturbation 0.05, mutation 0.08, adaptive
   sigma, fold depth 2) from ``runs_iso_r5/grad_best.ckpt`` on the 40
   grids of ``data_out/2d_iso/train``, with the solve settings of the
   committed reference cache (max_iter 75, residual norm), cut to
   population 6 (the script's 24) and 1 generation: 6 + 3 fitness
   evaluations of 40 grids each, at full width.  Checks 2 buckets; the
   reference convs read from the committed ``.ref_convs_olson.json``
   (within 1e-4; the cache unchanged and nothing measured); population
   row 0 equal to the checkpoint's flat weights and 3 folds; generation
   0's convs of the 6 individuals on the first bucket's 12 grids against
   the same on the CPU (a worker with PyTorch's deterministic algorithms,
   within 0.02 per grid; the largest gap and whether both devices order
   the individuals alike printed); the train loss never rising
   (elitism); the final checkpoint's population, fitness, key and sigma
   equal to the GA's; its best_params through
   ``cli.evaluate_dataset.load_model`` giving, on a test grid, the conv
   the GA measured; 0 launches of either spmv kernel.  Prints s per
   individual (40 grids) and per generation, the best individual's test
   loss, the ``Profiler`` tree, the CUDA-event time of one individual's
   fitness on the larger bucket and a torch.profiler trace of it; the
   phase must finish within 150 s.

12. ns, in a fresh process: the Navier-Stokes deployment through
   ``mlamg_torch.cli.solve_ns.main`` on the card in float32, at the JAX
   CLI's problems at the size of the reference's unsteady-cylflow demo:
   the lid-driven cavity at n 128 (n_u 32,512, n_p 16,384) with each
   Schur preconditioner (pcdr, sa, mlamg with ``runs_cf_interp/cf_best.ckpt``)
   and the cylinder at h 0.01 (n_u 17,410, n_p 9,250) with pcdr, Re 100,
   dt 0.1, tol 1e-6, cut to 3 time steps.  Checks every step: FGMRES
   stopped before its 600 iterations, and the float64 scipy residual of
   the saddle system over |b| is within a factor 10 of FGMRES's estimate
   and at most 10 x tol.  Before that, ``train_cf_interp``'s pressure
   solves on the card in its float64 (pinned pressure Laplacians of
   cavities n 14, 16, 20, five right-hand sides, learned against the
   classical fallback: means within 0.5 of ``runs_cf_interp/cf_interp.json``,
   learned below classical; float32 printed) and its Schur round trip
   (within 2 iterations, float64 residual below 1e-5), and each Schur
   preconditioner's apply on the card against the CPU in float64 where it
   is well posed (the pinned cavity-14 Laplacian; PCDR on that system),
   within 1e-10.  After it, cavity
   n 32, 2 steps, each preconditioner on the card and on the CPU (a
   worker): in float64 equal iterations and solutions (velocity and
   mean-free pressure) within 1e-9 (pcdr) or 1e-6 (sa, mlamg, whose
   coarse LU of the unpinned Laplacian is exactly singular); in float32
   pcdr within 3 iterations and 1e-5, sa and mlamg only converged with
   a float64 residual within 10 x tol on both (their float32 iteration
   counts are set by rounding).  Prints setup seconds with the dense LUs
   apart, iterations and seconds per step, ms per FGMRES iteration (CUDA
   events) and a torch.profiler trace of one cavity-128 pcdr FGMRES
   iteration; 0 launches of either spmv kernel; the phase must finish
   within 150 s.

13. tools, in a fresh process: the remaining trainers and tools through
   their CLI functions on the card.  ``train_cf_interp.main`` with
   ``scripts/repro_cf_interp.sh``'s flags (60 epochs, sizes 8 10 12,
   float64), its checkpoint and JSON in a temporary directory: the first
   epoch's three losses within 1e-9 relative of
   ``runs_cf_interp/cf_interp.json``, the last epoch's within
   ``TOOLS_CF_LAST_RTOL`` of it (a chaotic 180 steps: this bound catches a
   gross defect only) and within ``TOOLS_CF_DEVICE_RTOL`` of the same
   training in a CPU worker, the pressure-solve means within
   0.5 of the JSON's with learned below classical, the Schur round trip
   within 2 iterations of the JSON's with float64 residuals below 1e-5;
   then that card-trained checkpoint deployed: ``solve_ns.main`` on the
   cavity n 32, 2 steps, ``--schur-pc mlamg``, float64, each step
   converged with a float64 residual at most 10 x tol.
   ``train_convergence.main`` at the model's full width (dims 16 32 16,
   K 10) on the 40 grids of ``data_out/2d_iso/train``, cut to 3 splittings
   a grid and 5 epochs, its samples cached: the samples of the first 8
   grids against a CPU worker's (features within 1e-6, labels within
   ``EVAL_CPU_TOL``, the samples whose aggregates differ counted), the
   first epoch's train mse against the same epoch on the CPU from the
   cache (``TOOLS_CONV_MSE_RTOL``); val and test correlation printed beside
   the committed ``results/convergence_predictor.json`` (not held).
   ``evaluate_model.main`` on ``data_out/2d_iso/test/isotropic_0000.grid``
   with ``runs_iso_r5/grad_best.ckpt``: Lloyd, random and ML convs within
   ``EVAL_CPU_TOL`` of the CPU's, the same connectivity verdict.
   ``optimize_grid_param.main`` at its defaults cut to 3 generations:
   generation 0's convs within ``EVAL_CPU_TOL`` of the CPU's, the best conv
   never rising.  ``create_data.main`` with the 2d_iso recipe: the files
   that differ from ``data_out/2d_iso`` counted (printed only: the card
   machine's scipy may triangulate otherwise; the CPU tests hold the
   bytes).  Prints seconds per epoch, per sample build and per
   generation, the CUDA-event time of one ``train_cf_interp`` Adam step
   and a torch.profiler trace of it; 0 launches of either spmv kernel;
   the phase must finish within 150 s.

14. dist, in a fresh process started before the 600k hull is meshed (the
   card is idle while the host meshes; the main process waits for it
   before phase 2 times any kernel): the row-partitioned and
   population-parallel paths (``mlamg_torch.parallel``).  Small parity in
   float64 on the 16^2 Poisson over 8 virtual shards of the card: the
   distributed two-level solve and both modes of the distributed V-cycle
   solve in the serial solves' iterations with conv within 1e-10 of them
   and of the same runs on the CPU, pspmv and pspmv_halo within 1e-12 of
   scipy, pbf (symmetric and directed) and plloyd equal to the serial
   Bellman-Ford and Lloyd; the same runs through a world-size-1 NCCL
   process group (``initialize`` on a local TCP port) bit for bit.
   ``weak_scaling`` with 8 virtual shards at the JAX CLI's defaults (nx
   128, ny_loc 32, boxes 4) and at the card size (nx 512, ny_loc 64, boxes
   8): ms per two-level cycle and us per halo SpMV at S = 1, 2, 4, 8.  The
   S = 8 card-size solve (n 262,144, k 4,096, the dense P 4.3 GB) in
   float32 to 1e-6 |r0| from a seed-0 x0 with b = 0: conv within 1e-3 of
   the serial ``twolevel_solve`` with the same P, float64 relative
   residual below 1e-5; setup and solve seconds and peak memory.
   ``plloyd`` on its strength graph from n/64 seeds of RandomState(0), 5
   iterations, equal to the serial ``lloyd_aggregation`` (seconds and
   Bellman-Ford sweeps printed).  The GA's bucketed fitness of 4 weight
   vectors on 4 ``data_out/2d_iso/train`` grids with a mesh of 2 pop
   shards on the card equal to the unsharded fitness bit for bit.  The
   numbers behind ``visualize model-error`` and ``model-passes`` on
   ``data_out/2d_iso/test/isotropic_0000.grid``, card against CPU in
   float64: the error within 1e-6 of its largest entry, the masks equal
   (float32 printed).  A torch.profiler trace of one S = 8 cycle; 0
   launches of either spmv kernel; the phase must finish within 150 s.

15. examples, in a fresh process of the dist phase's pool, started when
   the dist phase ends (so still while the host meshes the 600k hull, and
   never beside dist's timings; fresh because dist's profiler session
   slows every later launch of its process): the seven
   ``examples_torch/`` scripts through their ``main``.  Each runs on the
   card at its defaults in float32 (its last line and seconds printed),
   then in float64 on the card and in a CPU worker beside it; the lines
   before the first one that rounding sets (``EXAMPLES_HELD``: all of
   ``ga_smoke``, ``learn_p_r``, ``diff_topk_training`` and
   ``edge_removal_aggregation``, the first 2 of
   ``poisson1d_differentiable``, 3 of ``matconv_ga``, 1 of
   ``reinforce_centers``; ``tests/test_torch_examples.py`` says why) are
   held card against CPU: counts equal, printed decimals within one unit
   of their last digit, the rest of each line equal.  0 launches of either
   spmv kernel; the phase must finish within 150 s.

16. bench, in this process after small_structured (the hull and the 4096^2
   Poisson are still held, so neither is built again): ``bench_torch``'s
   seven cells (``bench_torch.run_cells``, the port's counterpart of
   bench.py) with 30 wall-time samples each.  Checks that every cell
   passed its own check (kernels against their plain versions, the cycles'
   convergence factors below 1, both Galerkin products against scipy, the
   FullAggNet forward's centers, aggregates and P), that the seven metric
   names and units are bench.py's, that ``dia_spmv`` launched on the
   spmv, twolevel and vcycle_16m cells and ``well_spmv`` on the
   unstructured and unstructured_multilevel cells; prints every cell's
   value, wall and device times and idle share (wall times here follow
   the earlier phases' profiler sessions, so ``python3 bench_torch.py`` in
   its own process gives the benchmark's numbers); the phase must finish
   within 150 s.

Then one line ``{"kernels": [...]}`` with each kernel's launches on its
main path (``launches_galerkin``: ``well_spmv`` in the device-built
hierarchy's solve; ``launches_bench``: on bench_torch's cells;
``launches_eval``, ``launches_train``, ``launches_ga``,
``launches_ns``, ``launches_tools``, ``launches_dist``,
``launches_examples``: on the evaluation's, training's, the GA's, the
Navier-Stokes, the tools', the distributed path and the examples: 0
for the two spmv kernels), its largest error against the plain version
over every check, its time, the plain version's and the library call's
time, and its bound (``well_spmv``: from the stored nonzeros,
``bound_ell_ms`` counts the ELL slots and ``bound_sliced_ms`` the pack's;
``dia_spmv``: (D + 2) * 4 B per row; ``ordered_sum``: each value read and
each sum written once, and its phase line's times); the nvidia-smi line;
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
KERNELS = ("well_spmv", "dia_spmv", "ordered_sum")
SPMV_KERNELS = ("well_spmv", "dia_spmv")  # off the learned, training and deployment paths
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
N_DOFS = 600_000  # interior dofs of the random-hull FEM matrix (bench.py hull600k)
SEED = 7
REF_CONV = 0.4811  # JAX package, same configuration (BENCH_r05.json)
CONV_TOL = 0.03
MAX_CYCLES = 20
KERNEL_RTOL = 1e-5
FLUSH_BYTES = 256 << 20  # written between L2-cold launches: over 5x the 50 MB L2
SPIN_CYCLES = 20_000_000  # ~10 ms spin that timed launches queue behind
COLD_ITERS, WARM_ITERS = 20, 100
HEAT_FLUSHES = 50  # ~10 ms of buffer writes before a cold timing
WCYCLE = dict(nu=4, lmin_frac=1 / 15, gamma=2)  # bench.py hull600k: W(4,4) Chebyshev
GRID = 4096  # structured path: GRID^2 five-point Poisson (bench.py bench_vcycle_16m)
REF_CONV_16M = 0.1393  # JAX package, same configuration (BENCH_r05.json)
VCYCLE = dict(nu=2, smoother="chebyshev")
TWOLEVEL_GRID, TWOLEVEL_SIDE, TWOLEVEL_ITERS = 512, 16, 24  # bench.py bench_twolevel
# learned two-level evaluation: (family, grids, checkpoint, committed JAX CLI summary)
EVAL_RUNS = (
    ("2d_iso", "data_out/2d_iso/test", "runs_iso_r5/grad_best.ckpt",
     "results/eval_2d_iso_test_rel/eval_test_alpha0.1.json"),
    ("2d_aniso", "data_out/2d_aniso/test", "runs_aniso_r5_c/grad_best.ckpt",
     "results/eval_2d_aniso_test_c/eval_test_alpha0.1.json"),
)
EVAL_METHODS = ("lloyd", "random", "ml", "ml_agg_only", "ml_int_only")
# card against CPU, per grid: sound runs read at most 1.13e-7 (evaluation,
# weights moved 1e-3 over seeds 0-4) and 1.67e-6 (GA generation 0, five
# populations); moving the card's weights by 1e-6 moved the ML convs 0.061,
# a GA population by 1e-5 0.271 (scripts/eval_cpu_spread.py on an H100,
# PERF.md §6)
EVAL_MEAN_TOL, EVAL_CPU_TOL, EVAL_SECONDS = 0.01, 1e-4, 90.0
# gradient training: scripts/repro_iso_r5.sh's recipe, 2 of its 600 steps
TRAIN_DATA, TRAIN_START = "data_out/2d_iso", "runs_iso_r5/grad_best.ckpt"
TRAIN_ARGS = ("--steps", "600", "--bucket-step", "128", "--eval-every", "20",
              "--checkpoint-every", "40", "--rel-strength", "true", "--weight-noise", "0.01",
              "--tau-final", "0.015", "--start-model", TRAIN_START)
TRAIN_STEPS, TRAIN_BUCKETS = 2, 2
REF_CONV_TOL, TRAIN_LOSS_RTOL, TRAIN_DISCRETE_TOL, TRAIN_SECONDS = 1e-4, 1e-4, 0.02, 150.0
# the GA: scripts/run_headline_iso_ga.sh's flags from the committed
# runs_iso_r5 checkpoint, with the solve settings of the committed reference
# cache and of the runs_iso_ga_r5 run (max_iter 75, residual norm); cut to
# population 6 (the script's 24) and 1 generation (2 took the phase to 176 s
# of its 150 on an H100, PERF.md §6), never in grids or width
GA_ARGS = ("--population-size", "6", "--max-generations", "1", "--start-model", TRAIN_START,
           "--bucket-step", "128", "--init-perturb", "0.05", "--mutation-perturb", "0.08",
           "--adaptive-sigma", "true", "--fold-depth", "2", "--max-iter", "75",
           "--error-norm", "false", "--test-loss-every", "5", "--checkpoint-every", "5")
GA_FOLDS, GA_CPU_GRIDS, GA_SECONDS = 3, 12, 150.0
# the Navier-Stokes deployment (solve_ns): the JAX CLI's problems at the sizes
# of the reference's unsteady-cylflow demo, float32, cut to 3 time steps
NS_CKPT, NS_CF_JSON = "runs_cf_interp/cf_best.ckpt", "runs_cf_interp/cf_interp.json"
NS_STEP = ("--re", "100", "--dt", "0.1", "--steps", "3", "--tol", "1e-6")
NS_FULL = {
    "cavity128_pcdr": ("--n", "128", "--schur-pc", "pcdr"),
    "cavity128_sa": ("--n", "128", "--schur-pc", "sa"),
    "cavity128_mlamg": ("--n", "128", "--schur-pc", "mlamg", "--pnet-model", NS_CKPT),
    "cylinder001_pcdr": ("--problem", "cylinder", "--h", "0.01", "--schur-pc", "pcdr"),
}
NS_TOL, NS_MAX_ITERS = 1e-6, 600  # solve_ns's FGMRES: tol, restart 30 x 20 restarts
# card against CPU: cavity n 32, 2 steps, each Schur preconditioner
NS_SMALL = {pc: ("--n", "32", "--steps", "2", "--schur-pc", pc) + (
    ("--pnet-model", NS_CKPT) if pc == "mlamg" else ()) for pc in ("pcdr", "sa", "mlamg")}
# train_cf_interp's pressure solves: learned and classical means within 0.5
# of its JSON; the Schur round trip within 2 iterations, float64 residual
NS_MEAN_TOL, NS_SCHUR_ITER_TOL, NS_SCHUR_RES = 0.5, 2, 1e-5
# the float64 scipy residual of every full-width step within a factor 10 of
# FGMRES's own estimate, and at most 10x the tolerance
NS_RES_FACTOR = 10.0
# Card against CPU at cavity n 32 (scripts/ns_float32_spread.py on an H100,
# seeds 0-4, and the ns phase; PERF.md §6).  float64: pcdr read <= 1e-12 and
# equal iterations; sa and mlamg, whose coarse LU of the unpinned Laplacian
# is exactly singular, read up to 4.5e-7 with equal iterations (the bound
# catches a run that fails, not a smoother defect: mlamg with Jacobi weight
# 0.6 read 1.4e-7; the pinned applies below catch that).  float32: pcdr read
# <= 2 iterations and 2.8e-6 apart; sa and mlamg 40 against 151 iterations
# (rounding sets them), so only their convergence is held.  The cylinder
# PCDR with C dropped on the card fails every bound (NaN after 571).
NS_F64_RTOL, NS_SINGULAR_RTOL = 1e-9, 1e-6
NS_F32_ITER_BAND, NS_F32_RTOL = 3, 1e-5
# each Schur preconditioner's apply on the pinned cavity-14 Laplacian (PCDR
# on the cavity-14 system), card against CPU in float64
NS_APPLY_RTOL = 1e-10
NS_SECONDS = 150.0
# the remaining trainers and tools, in a fresh process: train_cf_interp with
# scripts/repro_cf_interp.sh's flags (60 epochs, sizes 8 10 12, float64),
# its card-trained checkpoint deployed in solve_ns (cavity n 32, 2 steps,
# float64), train_convergence at the model's full width (dims 16 32 16, K 10)
# on the 40 grids of data_out/2d_iso/train cut to 3 splittings a grid (one
# per regime; the CLI's default is 4) and 5 epochs (its default 40),
# evaluate_model on one 2d_iso test grid, optimize_grid_param at its
# defaults cut to 3 generations (its default 30), and create_data's 2d_iso
# recipe (scripts/repro_iso_r5.sh)
TOOLS_CF_ARGS = ("--epochs", "60")
TOOLS_DEPLOY = ("--n", "32", "--steps", "2", "--schur-pc", "mlamg", "--float64")
TOOLS_CONV_ARGS = ("data_out/2d_iso/train", "--per-grid", "3", "--epochs", "5")
TOOLS_CONV_JSON = "results/convergence_predictor.json"  # printed beside, not held
TOOLS_EVAL_ARGS = ("data_out/2d_iso/test/isotropic_0000.grid", "--model", TRAIN_START)
TOOLS_OPT_ARGS = ("--generations", "3")
TOOLS_DATA_DIR = "data_out/2d_iso"
TOOLS_DATA_ARGS = ("--n-grids", "50", "--type", "isotropic", "--dof-min", "64", "--dof-max", "250",
                   "--split", "0.2", "--seed", "7")
# train_cf_interp's first epoch against its committed JSON: float64 with
# the JAX CLI's float32 weights, initial draw and Adam rounding, so it
# agrees to ~1e-14 on the CPU (tests/test_torch_trainers.py)
TOOLS_CF_FIRST_RTOL = 1e-9
# The last epoch (after 180 Adam steps) is chaotic against the JSON: the
# port's steps follow the JAX CLI's to 1e-12, but a 1e-12 gap grows to
# 10-20% of the losses by epoch 26 (on the CPU against JAX).  On an H100
# (scripts/tools_spread.py, PERF.md section 6) the last epoch's largest gap
# to the JSON read 0.208 as trained, 0.070 and 0.179 from initial weights
# moved one float32 ulp down and up, 0.155 with the learning rate times
# 1 + 1e-3 and 0.301 times 10, the same on the card and the CPU to 1e-14:
# the JSON bound catches only a gross defect such as the tenfold rate.
# The card against the CPU is what holds the training: every variant's
# last epoch agreed to <= 6e-15 there, and the learning rate times 1 + 1e-3
# moved it 0.155.  train_convergence's first epoch (float32) read card vs
# CPU 1.5e-9 to 9.0e-9 over the five variants, initial weights moved one
# ulp 2.3e-8 and 3.3e-8, the learning rate times 1 + 1e-2 8.2e-5.
TOOLS_CF_LAST_RTOL, TOOLS_CF_DEVICE_RTOL, TOOLS_CONV_MSE_RTOL = 0.25, 1e-9, 1e-6
TOOLS_CONV_CPU_GRIDS, TOOLS_FEATURE_TOL = 8, 1e-6
TOOLS_SECONDS = 150.0
# the distributed path (mlamg_torch/parallel): small float64 parity on
# DIST_SMALL_NX^2 over 8 virtual shards (conv within 1e-10 of the serial
# solve and of the CPU, the SpMVs within 1e-12 of scipy, the CPU tests'
# bounds); weak_scaling at the JAX CLI's defaults and at the card size
# (S = 1, 2, 4, 8; at S = 8 n = 262,144 and k = 4,096, the dense P 4.3 GB);
# the S = 8 card-size two-level solve in float32 to DIST_CARD_RES * |r0|,
# its conv within DIST_CARD_CONV_ATOL of the serial solve with the same P
# and its float64 relative residual below DIST_CARD_RESIDUAL; plloyd on its
# strength graph from n/64 seeds of RandomState(0), 5 iterations
DIST_SMALL_NX, DIST_CONV_ATOL, DIST_SPMV_ATOL = 16, 1e-10, 1e-12
WEAK_DEFAULT = ("--nx", "128", "--ny-loc", "32", "--agg", "4", "--virtual-devices", "8")
WEAK_CARD = ("--nx", "512", "--ny-loc", "64", "--agg", "8", "--virtual-devices", "8")
DIST_CARD_RES, DIST_CARD_CONV_ATOL, DIST_CARD_RESIDUAL = 1e-6, 1e-3, 1e-5
DIST_LLOYD_RATIO, DIST_LLOYD_MAXITER = 64, 5
DIST_FIT_GRIDS, DIST_FIT_POP = 4, 4
DIST_VIZ_RTOL, DIST_VIZ_CYCLES = 1e-6, 10
DIST_SECONDS = 150.0
# the examples phase: the seven examples_torch scripts; the float64 lines
# held card against CPU, per script (None: every line), those before the
# first line that rounding sets (tests/test_torch_examples.py)
EXAMPLES_HELD = {"ga_smoke": None, "poisson1d_differentiable": 2, "learn_p_r": None,
                 "diff_topk_training": None, "matconv_ga": 3,
                 "edge_removal_aggregation": None, "reinforce_centers": 1}
EXAMPLES_SECONDS = 150.0
# bench_torch's cells: bench.py's metrics and units, the kernel each cell's
# path must launch, and the cells' wall-time samples here
BENCH_METRICS = {
    "spmv": ("spmv_hbm_roofline_fraction", "fraction_of_peak_hbm_bw"),
    "unstructured": ("unstructured_spmv_gnnz_per_s", "Gnnz/s"),
    "twolevel": ("twolevel_cycle_ms", "ms/iteration"),
    "vcycle_16m": ("vcycle_16m_ms", "ms/V-cycle"),
    "unstructured_multilevel": ("vcycle_unstructured_600k_ms", "ms/W-cycle"),
    "rap": ("rap_spgemm_mnnz_per_s", "Mnnz(A)/s"),
    "model_forward": ("fullaggnet_forward_ms", "ms/forward"),
}
BENCH_KERNEL = {"spmv": "dia_spmv", "twolevel": "dia_spmv", "vcycle_16m": "dia_spmv",
                "unstructured": "well_spmv", "unstructured_multilevel": "well_spmv"}
BENCH_SAMPLES, BENCH_SECONDS = 30, 150.0
# the sparse Galerkin setup on the 600k hull: the device product's level-0
# A_H within 1e-4 * max|A_H| of the host product's (the JAX package's bound,
# tests/test_amg_unstructured.py), rap_learned within rtol = atol = 2e-4 of
# a float64 scipy oracle (the same test), and build_hierarchy(sparse_levels=1)
# on the GALERKIN_GRID^2 Poisson in float64, card against CPU, 1e-12 relative
GALERKIN_AH_RTOL, GALERKIN_LEARNED_TOL, GALERKIN_SPARSE_RTOL = 1e-4, 2e-4, 1e-12
GALERKIN_GRID, GALERKIN_SOLVE_RTOL = 256, 1e-8
# The trained model amplifies rounding in the backward as in the forward: in
# float32 PNet's gradient on the card differs from the CPU's by ~2e-3 of its
# size (1.89e-3 outside the NNConv root Dense on an H100, PERF.md §6).
# One float32 pretraining epoch, 40 Adam steps along gradients that
# rounding sets in the root Dense, moves mse_c and mse_p by rounding alone:
# up to 0.066 / 0.125 card vs CPU over seeds 0-4, 0.119 / 0.081 on the CPU
# from seed 0's weights moved one ulp, 0.159 / 0.171 between the JAX
# package's jitted epoch and this one on the CPU; a doubled learning rate
# moves mse_p 0.45.  bce moved 4.7e-5 card vs CPU (seed 1), ~1.5e-4 between
# JAX's epoch and this one (seed 1), and 0.011 with the targets of alpha 0.11
# (scripts/pretrain_float32_spread.py, PERF.md §6).  Each bound sits
# between the largest reading of rounding and the defect it must catch.  In float64 the
# same step's loss agreed exactly and its gradient outside
# ``amplified_grad`` to 1.1e-15, and the epoch's bce and mse_p to 2e-16:
# the float64 bounds below catch a card-only defect that the float32 ones
# could miss.  The epoch's mse_c is not bounded in float64: Adam takes a
# full step along CNet's root Dense gradient, which rounding sets even in
# float64 (92% apart there), and mse_c moved 4.1% (the float32 bound holds
# it).
TRAIN_GRAD_RTOL, PRETRAIN_BCE_RTOL, PRETRAIN_MSE_RTOL = 1e-2, 1e-3, 0.25
F64_LOSS_RTOL, F64_GRAD_RTOL, F64_PRETRAIN_RTOL = 1e-10, 1e-10, 1e-9
F64_GRIDS = 12  # the float64 step and epoch take the first 12 of the 40 grids
# seed 0's initial weights (dim 8, 2 convs, 2 iterations, relative strength):
# the exactly rounded sum of squares (math.fsum) of this package's draw
# (numpy, so the same on every machine) and of the JAX package's
# FullAggNet.init(PRNGKey(0)) on the CPU (jax 0.9); equal since erf_inv's
# float32 log1p is XLA's (prng.log1p_f32; with numpy's, 190 weights differed
# by float32 ulps and the sum read 1472.3356676804133)
WITNESS_INIT_SUM_SQ = JAX_INIT_SUM_SQ = 1472.3356655974217
# gradients the rounding of the backward's sums can set: the root Dense of
# the NNConvs, whose node features start constant (tests/test_torch_soft_pipeline.py
# finds the first three of each MPNN set by it even on the CPU, where two runs
# of one step differ there); the card-vs-CPU bound holds for the rest of the
# gradient, and the whole gradient's gap and cosine are printed beside it
def amplified_grad(path: str) -> bool:
    return "/node_conv_" in path and "/Dense_3/" in path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` warmed calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_kernel(W, rng, label: str) -> tuple[float, float]:
    """Hold well_spmv against its plain versions at every LANES, plain and
    affine: equal to ``sliced_spmv_reference`` (the kernel's arithmetic on
    the pack) bit for bit, and within 1e-5 * max|y| of
    ``well_spmv_reference`` (the ELL arrays).  Returns the largest
    (absolute, relative) error against the latter."""
    import torch
    from mlamg_torch.ops.unstructured import (
        LANES, sliced_spmv_reference, well_spmv, well_spmv_reference,
    )

    n = W.shape[0]
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).to(W.device)
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).to(W.device)
    abs_err = rel_err = 0.0
    for form, cc, alpha in (("plain", None, 1.0), ("affine", c, -1.0)):
        ref = well_spmv_reference(W, x, cc, alpha)
        scale = float(ref.abs().max())
        for lanes in LANES:
            Wl = dataclasses.replace(W, lanes=lanes)
            y = well_spmv(Wl, x, cc, alpha)
            torch.cuda.synchronize()
            what = f"well_spmv {form} on {label}, lanes {lanes}"
            check(bool(torch.isfinite(y).all()), f"{what}: non-finite values")
            check(torch.equal(y, sliced_spmv_reference(Wl, x, cc, alpha)),
                  f"{what}: differs from sliced_spmv_reference")
            err = float((y - ref).abs().max())
            check(err <= KERNEL_RTOL * scale, f"{what}: max err {err} > {KERNEL_RTOL} * {scale}")
            abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
    return abs_err, rel_err


def banded_matrix(rng, n: int = 700, band: int = 60):
    """Non-FEM banded matrix with uneven row degrees (tests/test_unstructured.py)."""
    import scipy.sparse as sp

    A = sp.random(n, n, density=0.01, format="lil", random_state=rng)
    A.setdiag(1.0)
    coo = sp.csr_matrix(A).tocoo()
    keep = np.abs(coo.row - coo.col) <= band
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
    ).astype(np.float32)


def empty_rows_matrix(rng, n: int = 1000):
    """Banded matrix whose first 64 rows (two whole slices) and every 7th
    row are empty."""
    import scipy.sparse as sp

    A = banded_matrix(rng, n).tolil()
    for r in [*range(64), *range(64, n, 7)]:
        A.rows[r], A.data[r] = [], []
    return sp.csr_matrix(A)


def kernel_matrices(rng) -> dict:
    """The small matrices every kernel check runs on besides the hull."""
    return {"banded": banded_matrix(rng), "empty rows": empty_rows_matrix(rng),
            "n = 32k + 5": banded_matrix(rng, n=32 * 40 + 5, band=90)}


def ell_to_scipy(W):
    """The scipy matrix of a WindowedELL's ELL arrays."""
    import scipy.sparse as sp

    n = W.shape[0]
    data, col = W.data[:, :n].cpu().numpy(), W.col[:, :n].cpu().numpy()
    rows = np.broadcast_to(np.arange(n), col.shape)
    A = sp.csr_matrix((data.ravel(), (rows.ravel(), col.ravel())), shape=W.shape)
    A.sum_duplicates()
    A.eliminate_zeros()  # the padding slots' zeros, summed into column `first`
    check(A.nnz == W.nnz, f"ELL arrays unpack to {A.nnz} nonzeros, not {W.nnz}")
    return A


def queued_ms(fn, iters: int, flush=None) -> float:
    """Device time of one ``fn()`` in ms.  The calls queue behind a spin
    kernel, so the host's time between launches does not count.  Without
    ``flush``: the mean over ``iters`` calls back to back (warm).  With it
    (cold): before each call the buffer is written, which evicts L2, then
    read, so that L2 holds clean lines and the call does not pay to write
    the buffer's dirty lines back; each call sits between its own pair of
    events, and the median over ``iters`` calls is returned.  Writing the
    buffer HEAT_FLUSHES times first brings the card's clocks up after the
    host's work."""
    import torch

    fn()
    if flush is not None:
        for _ in range(HEAT_FLUSHES):
            flush.fill_(0.0)
            flush.sum()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    if flush is None:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        flush.sum()
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def cold_warm_ms(fn, flush) -> tuple[float, float]:
    return queued_ms(fn, COLD_ITERS, flush), queued_ms(fn, WARM_ITERS)


def spmv_bound_ms(W, slots: int, index_bytes: int = 0) -> float:
    """Least time of y = A x on this card when it streams ``slots`` value
    and column pairs (8 B each) and ``index_bytes`` more, reads x and
    writes y: the bytes over the HBM rate (the flops are far below the
    compute bound).  ``slots`` is W.nnz for the nonzero bound."""
    return (slots * 8 + index_bytes + 2 * W.shape[0] * 4) / HBM_BYTES_PER_S * 1e3


def kernel_times_us(W, flush) -> dict:
    """well_spmv's L2-cold and warm time on W, in us."""
    import torch
    from mlamg_torch.ops.unstructured import well_spmv

    x = torch.randn(W.shape[0], device=W.device)
    cold, warm = cold_warm_ms(lambda: well_spmv(W, x), flush)
    return {"cold_us": cold * 1e3, "warm_us": warm * 1e3}


def kernel_phase(Ap, rng, flush) -> dict:
    """Check well_spmv and time it at the main path's fine level.  ``ms``
    is the L2-cold time (the pack, 35.5 MB, fits in the 50 MB L2, so
    back-to-back launches would be partly warm); ``warm_ms`` the
    back-to-back time."""
    import torch
    from mlamg_torch.ops.unstructured import (
        WindowedELL, sliced_spmv_reference, well_spmv, well_spmv_reference,
    )

    W = WindowedELL.from_scipy(Ap, device="cuda")
    errs = [check_kernel(W, rng, "hull")]
    errs += [check_kernel(WindowedELL.from_scipy(M, device="cuda", sigma=sigma), rng,
                          f"{label}, sigma {sigma}")
             for label, M in kernel_matrices(rng).items() for sigma in (1, W.sigma)]

    n = W.shape[0]
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(Ap.indptr.astype(np.int64)),
        torch.from_numpy(Ap.indices.astype(np.int64)),
        torch.from_numpy(Ap.data.astype(np.float32)),
        size=Ap.shape, check_invariants=True,
    ).cuda()
    y_lib = torch.mv(A_csr, x)
    y_ref = well_spmv_reference(W, x)
    check(float((y_lib - y_ref).abs().max()) <= KERNEL_RTOL * float(y_ref.abs().max()),
          "torch.sparse CSR matvec disagrees with the plain version")

    ms, warm_ms = cold_warm_ms(lambda: well_spmv(W, x), flush)
    library_ms, library_warm_ms = cold_warm_ms(lambda: torch.mv(A_csr, x), flush)
    affine_ms = queued_ms(lambda: well_spmv(W, x, c, -1.0), COLD_ITERS, flush)
    # the plain versions: 50 warmed calls back to back
    plain_ms = cuda_ms(lambda: well_spmv_reference(W, x))
    affine_plain_ms = cuda_ms(lambda: well_spmv_reference(W, x, c, -1.0))
    sliced_plain_ms = cuda_ms(lambda: sliced_spmv_reference(W, x))
    nnz = int(Ap.nnz)
    affine_bound_ms = max((nnz * 8 + 3 * n * 4) / HBM_BYTES_PER_S,
                          (2 * nnz + 2 * n) / F32_FLOPS) * 1e3
    return {
        "name": "well_spmv",
        "route": "cuda",
        "source": "mlamg_torch/ops/csrc/well_spmv.cu",
        "replaces": "mlamg_tpu/ops/unstructured.py:141",
        "max_abs_err": max(e[0] for e in errs),
        "max_rel_err": max(e[1] for e in errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(spmv_bound_ms(W, nnz), 2 * nnz / F32_FLOPS * 1e3),
        "bound_by": "bytes",
        "library_ms": library_ms,
        "warm_ms": warm_ms,
        "library_warm_ms": library_warm_ms,
        "sliced_plain_ms": sliced_plain_ms,
        "bound_ell_ms": spmv_bound_ms(W, W.width * W.n_pad),
        # the pack's slots, plus row_perm, slice_ptr and slice_w
        "bound_sliced_ms": spmv_bound_ms(W, W.slots, (W.row_perm.numel() + 2 * W.n_slices) * 4),
        "affine_ms": affine_ms,
        "affine_plain_ms": affine_plain_ms,
        "affine_bound_ms": affine_bound_ms,
        "sigma": W.sigma,
        "lanes": W.lanes,
        "n": n,
        "nnz": nnz,
        "w": W.width,
        "n_pad": W.n_pad,
        "slots": W.slots,
    }


def level_table(h, flush, cycle: dict = WCYCLE) -> list:
    """Per level of the hierarchy: size, the kernel's L2-cold and warm
    time in us, its nonzero bound, and launches per cycle (one visit's
    SpMVs times the visits)."""
    return [{"level": l, "n": lev.A.shape[0], "nnz": lev.A.nnz,
             "ell_slots": lev.A.width * lev.A.n_pad, "slots": lev.A.slots,
             "lanes": lev.A.lanes, **kernel_times_us(lev.A, flush),
             "bound_us": spmv_bound_ms(lev.A, lev.A.nnz) * 1e3,
             "launches_per_cycle": launches}
            for l, (lev, launches) in enumerate(zip(h.levels, level_launches(h, **cycle)))]


def gather_spans(W, sizes=(32, 256)) -> dict:
    """Why the kernel stages no window of x in shared memory (host
    numbers): the bandwidth of an operator without empty rows, and the
    column span (max - min + 1) that each block of ``size`` consecutive
    rows gathers from: mean, 95th percentile and max."""
    A = ell_to_scipy(W)
    A.sort_indices()
    n = A.shape[0]
    rows = np.arange(n)
    lo, hi = A.indices[A.indptr[:-1]], A.indices[A.indptr[1:] - 1]
    out = {"bandwidth": int(np.maximum(hi - rows, rows - lo).max())}
    for size in sizes:
        m = -(-n // size) * size
        lo_p, hi_p = np.full(m, n), np.full(m, -1)
        lo_p[:n], hi_p[:n] = lo, hi
        span = hi_p.reshape(-1, size).max(1) - lo_p.reshape(-1, size).min(1) + 1
        out[f"span_{size}"] = {"mean": float(span.mean()),
                               "p95": float(np.percentile(span, 95)), "max": int(span.max())}
    return out


def sweep_phase(h, flush) -> dict:
    """The kernel's design choices, timed on the hierarchy's operators:
    every LANES at every level; sigma = 1 against the default at levels 0
    and 1."""
    from mlamg_torch.ops.unstructured import LANES, WindowedELL

    times = partial(kernel_times_us, flush=flush)
    out = {"lanes": [], "sigma": []}
    for l, lev in enumerate(h.levels):
        W = lev.A
        by_lanes = {L: times(dataclasses.replace(W, lanes=L)) for L in LANES}
        best = min(by_lanes, key=lambda L: by_lanes[L]["cold_us"])
        out["lanes"].append({"level": l, "rule": W.lanes, "fastest": best,
                             "rule_over_fastest": by_lanes[W.lanes]["cold_us"]
                             / by_lanes[best]["cold_us"],
                             **{str(L): t for L, t in by_lanes.items()}})
        if l < 2:
            W1 = dataclasses.replace(WindowedELL.from_scipy(ell_to_scipy(W), device="cuda",
                                                            sigma=1), lanes=W.lanes)
            out["sigma"].append({"level": l, "slots": {"1": W1.slots, str(W.sigma): W.slots},
                                 "1": times(W1), str(W.sigma): times(W)})
    return out


def level_launches(h, nu: int, gamma: int, **_) -> list:
    """well_spmv launches of one uvcycle per level: per level visit
    2*(nu+1) Chebyshev residuals, one residual, and one SpMV per omega each
    in restriction and interpolation; level l is visited gamma**l times."""
    return [gamma ** l * (2 * (nu + 1) + 1 + 2 * len(lev.omegas))
            for l, lev in enumerate(h.levels)]


def launches_per_cycle(h, nu: int, gamma: int) -> int:
    """well_spmv launches of one uvcycle (see level_launches)."""
    return sum(level_launches(h, nu, gamma))


def device_trace(fn, iters: int, kernel: str = "well_spmv", warmup: bool = True,
                 cpu: bool = True) -> dict:
    """Profile ``iters`` calls of ``fn`` with torch.profiler and read the
    device's timeline: busy time (union of kernel, copy and set intervals)
    against the span from the first to the last device activity, and
    ``kernel``'s own time.  All times in ms per call.  ``warmup`` runs
    ``fn`` once first; ``cpu=False`` records the device's activity alone
    (a smaller trace for a long call).  The device's activities are read
    from the profiler's events: writing and reading them as a JSON trace
    took longer than the profiled call itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=[*activities, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy_us, end = 0.0, -np.inf
    for lo, hi, _ in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    spmv = [hi - lo for lo, hi, name in spans if kernel in name]
    by_name: dict = {}
    for lo, hi, name in spans:
        t, k = by_name.get(name, (0.0, 0))
        by_name[name] = (t + hi - lo, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "device_ops": len(spans) / iters,
        "busy_ms": busy_us / iters / 1e3,
        "span_ms": span_us / iters / 1e3,
        "idle_share": (1.0 - busy_us / span_us) if span_us > 0 else None,
        f"{kernel}_kernels": len(spmv) / iters,
        f"{kernel}_ms": sum(spmv) / iters / 1e3,
        "top_ops": [[name[:100], t / iters / 1e3, k / iters] for name, (t, k) in top],
    }


def path_phase(A, rng) -> tuple[dict, int, list, object]:
    import torch
    from mlamg_torch.mg.amg_unstructured import (
        build_unstructured_hierarchy, uvcycle, uvcycle_solve,
    )
    from mlamg_torch.utils.profiler import LAUNCHES

    dev = "cuda"
    n = A.shape[0]
    cycle = WCYCLE
    prof: dict = {}

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    t0 = time.time()
    h, perm = build_unstructured_hierarchy(
        A, alpha=0.2, max_levels=5, min_coarse=1200, lloyd_maxiter=5,
        fmt="well", device=dev, profile_out=prof,
    )
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    x0 = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).to(dev)
    b = torch.zeros(n, dtype=torch.float32, device=dev)
    t0 = time.time()
    x, conv, err, iters = uvcycle_solve(h, b, x0, res_tol=1e-6, max_iter=40, **cycle)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = LAUNCHES["well_spmv"]
    # ---------------------------------------------------------------------

    hist = err[:iters].cpu().numpy()
    expected = iters * (launches_per_cycle(h, cycle["nu"], cycle["gamma"]) + 1)
    check(launches == expected,
          f"well_spmv launched {launches} times in the solve, expected {expected}")
    check(bool(np.isfinite(hist).all()) and bool(torch.isfinite(x).all()),
          "solve produced non-finite values")
    check(abs(conv - REF_CONV) <= CONV_TOL,
          f"conv factor {conv} not within {CONV_TOL} of {REF_CONV}")
    check(iters <= MAX_CYCLES and hist[-1] <= 1e-6,
          f"{iters} W-cycles, final residual {hist[-1]} (want <= {MAX_CYCLES} to 1e-6)")

    level_errs = [check_kernel(lev.A, rng, f"level {l}")
                  for l, lev in enumerate(h.levels)]

    cycle_ms = cuda_ms(lambda: uvcycle(h, b, x0, **cycle), iters=5, warmup=1)
    t0 = time.time()
    for _ in range(5):
        uvcycle(h, b, x0, **cycle)
    torch.cuda.synchronize()
    cycle_wall_ms = (time.time() - t0) / 5 * 1e3
    trace = device_trace(lambda: uvcycle(h, b, x0, **cycle), iters=3)

    # permuted system with a random right-hand side, checked in the
    # original ordering in float64
    rhs = np.random.RandomState(1).randn(n).astype(np.float32)
    xs, _, _, iters_rhs = uvcycle_solve(
        h, torch.from_numpy(rhs[perm]).to(dev), torch.zeros_like(b),
        res_tol=1e-6 * float(np.linalg.norm(rhs)), max_iter=40, **cycle,
    )
    sol = np.empty(n, np.float64)
    sol[perm] = xs.cpu().numpy()
    rel_res = float(np.linalg.norm(A.astype(np.float64) @ sol - rhs) / np.linalg.norm(rhs))
    check(rel_res < 1e-4, f"permuted-system relative residual {rel_res} >= 1e-4")

    return {
        "phase": "path",
        "perm": perm,
        "n": n,
        "nnz": int(A.nnz),
        "num_levels": h.num_levels,
        "levels": [
            {"n": lev.A.shape[0], "nnz": lev.A.nnz, "k": lev.k, "w": lev.A.width}
            for lev in h.levels
        ],
        "coarse_k": int(h.coarse.lu.shape[0]),
        "setup_s": setup_s,
        "setup_profile_s": prof,
        "conv": conv,
        "iters": iters,
        "residual_history": [float(v) for v in hist],
        "solve_s": solve_s,
        "ms_per_wcycle": cycle_ms,
        "wall_ms_per_wcycle": cycle_wall_ms,
        "wcycle_trace": trace,
        "well_spmv_launches": launches,
        "well_spmv_launches_per_wcycle": launches_per_cycle(h, cycle["nu"], cycle["gamma"]),
        "level_kernel_rel_err": [e[1] for e in level_errs],
        "rhs_iters": iters_rhs,
        "rhs_rel_residual": rel_res,
    }, launches, level_errs, h


def small_cycle_phase() -> dict:
    """One W-cycle of a small hierarchy on the card against the same
    cycle on the CPU (where well_spmv is the plain version)."""
    import torch
    from mlamg_torch.data import Grid
    from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy, uvcycle

    A = Grid.random_2d_unstructured(1500, seed=3).A.astype(np.float32)
    kw = dict(alpha=0.2, max_levels=4, min_coarse=60, lloyd_maxiter=5, fmt="well")
    x0 = np.random.RandomState(0).randn(A.shape[0]).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        h, _ = build_unstructured_hierarchy(A, device=dev, **kw)
        x = torch.from_numpy(x0).to(dev)
        out[dev] = uvcycle(h, torch.zeros_like(x), x, nu=3, lmin_frac=1 / 15,
                           gamma=2).cpu().numpy()
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    scale = float(np.abs(out["cpu"]).max())
    check(err <= 1e-4 * scale, f"small W-cycle cuda vs cpu: {err} > 1e-4 * {scale}")
    return {"phase": "small_cycle", "n": A.shape[0], "max_abs_err": err, "scale": scale}


def allclose_sparse(got, want, rtol: float, atol: float) -> float:
    """max(|got - want| - rtol * |want|) over the union of both patterns
    (numpy's allclose holds where it is <= atol)."""
    return float((abs(got - want) - rtol * abs(want)).max())


def learned_p(A_sp, agg: np.ndarray, rng):
    """A random P-hat on A's coordinates with columns mapped through
    ``agg`` (FullAggNet's P = P-hat Agg), on the card, and its float64 scipy
    oracle P^T A P with duplicates summed."""
    import scipy.sparse as sp
    import torch
    from mlamg_torch.ops.sparse import CSR

    A_sp = sp.csr_matrix(A_sp)
    A_sp.sort_indices()  # the entry order of CSR.from_scipy
    n, k = A_sp.shape[0], int(agg.max()) + 1
    coo = A_sp.tocoo()
    phat = rng.randn(A_sp.nnz).astype(np.float32)
    A_dev = CSR.from_scipy(A_sp, device="cuda")
    data = torch.zeros(A_dev.nnz_pad, dtype=torch.float32)
    data[:A_sp.nnz] = torch.from_numpy(phat)
    agg_dev = torch.from_numpy(agg.astype(np.int64)).cuda()
    P_dev = CSR(data.cuda(), A_dev.row, agg_dev[A_dev.col], A_dev.indptr, (n, k), A_dev.nnz)
    P_sp = sp.csr_matrix((phat.astype(np.float64), (coo.row, agg[coo.col])), shape=(n, k))
    P_sp.sum_duplicates()
    return A_dev, P_dev, k, (P_sp.T @ (A_sp.astype(np.float64) @ P_sp)).tocsr()


def sparse_levels_run(device: str) -> dict:
    """build_hierarchy(sparse_levels=1) on the GALERKIN_GRID^2 Poisson as a
    float64 CSR on ``device``, and vcycle_solve of A x = A x* (x* from seed
    1) to a relative residual of GALERKIN_SOLVE_RTOL."""
    import torch
    from mlamg_torch.mg.cycle import build_hierarchy, vcycle_solve
    from mlamg_torch.ops.sparse import CSR

    A = poisson2d(GALERKIN_GRID).astype(np.float64)
    t0 = time.time()
    h = build_hierarchy(CSR.from_scipy(A, dtype=torch.float64, device=device), alpha=0.1,
                        sparse_levels=1)
    build_s = time.time() - t0
    b = A @ np.random.RandomState(1).randn(A.shape[0])
    tol = GALERKIN_SOLVE_RTOL * float(np.linalg.norm(b))
    t0 = time.time()
    _, conv, err, iters = vcycle_solve(h, torch.from_numpy(b).to(device),
                                       torch.zeros(A.shape[0], dtype=torch.float64,
                                                   device=device),
                                       res_tol=tol, max_iter=500)
    solve_s = time.time() - t0
    return {"A1": h.As[1], "P0": h.Ps[0], "build_s": build_s, "solve_s": solve_s,
            "conv": conv, "iters": iters, "res": float(err[iters - 1]), "tol": tol}


def galerkin_phase(A, path: dict, h_host) -> tuple[dict, int]:
    """The sparse Galerkin setup on the card: the 600k hull's hierarchy with
    rap_mode="device" beside the path phase's host-product one, its W(4,4)
    solve, rap_learned, and build_hierarchy(sparse_levels=1)."""
    import torch
    from mlamg_torch.mg.amg_unstructured import (
        build_unstructured_hierarchy, galerkin_patterns, host_prolongator, rap_learned,
        rap_masked, uvcycle_solve,
    )
    from mlamg_torch.mg.interp import smoothed_aggregation
    from mlamg_torch.ops.sparse import CSR
    from mlamg_torch.utils.profiler import LAUNCHES

    t_phase = time.time()
    dev = "cuda"
    n = A.shape[0]
    cycle = WCYCLE
    prof: dict = {}
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    t0 = time.time()
    h, perm = build_unstructured_hierarchy(
        A, alpha=0.2, max_levels=5, min_coarse=1200, lloyd_maxiter=5,
        fmt="well", device=dev, profile_out=prof, rap_mode="device",
    )
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    x0 = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).to(dev)
    b = torch.zeros(n, dtype=torch.float32, device=dev)
    x, conv, err, iters = uvcycle_solve(h, b, x0, res_tol=1e-6, max_iter=40, **cycle)
    torch.cuda.synchronize()
    launches = LAUNCHES["well_spmv"]
    # ---------------------------------------------------------------------

    hist = err[:iters].cpu().numpy()
    expected = iters * (launches_per_cycle(h, cycle["nu"], cycle["gamma"]) + 1)
    check(launches == expected,
          f"galerkin: well_spmv launched {launches} times in the solve, expected {expected}")
    check(bool(np.isfinite(hist).all()) and bool(torch.isfinite(x).all()),
          "galerkin: solve produced non-finite values")
    check(abs(conv - REF_CONV) <= CONV_TOL,
          f"galerkin: conv factor {conv} not within {CONV_TOL} of {REF_CONV}")
    check(iters <= MAX_CYCLES and hist[-1] <= 1e-6,
          f"galerkin: {iters} W-cycles, final residual {hist[-1]} "
          f"(want <= {MAX_CYCLES} to 1e-6)")
    check(all(br in ("masked", "wide") for br in prof["rap_branch"]),
          f"galerkin: branches {prof['rap_branch']}")
    check(path["setup_profile_s"]["rap_branch"] == ["host"] * len(h_host.levels),
          "galerkin: the path phase's rap_mode='auto' did not take the host product")

    # level 0: the same aggregates; the device product's A_H against the
    # host product's on the same (A, agg, omega), A_H being level 0's
    # product before truncation (the stored level 1 is truncated and
    # RCM-ordered by its own pattern)
    lev_h, lev_d = h_host.levels[0], h.levels[0]
    check(np.array_equal(perm, path["perm"]), "galerkin: the fine-level permutation differs")
    check(lev_h.k == lev_d.k and torch.equal(lev_h.agg.cpu(), lev_d.agg.cpu()),
          "galerkin: level 0's aggregates differ between the host and device products")
    A0 = ell_to_scipy(lev_d.A)
    agg0, k0 = lev_d.agg.cpu().numpy(), lev_d.k
    a_width = int(np.diff(A0.indptr).max())
    _, APpat, AHpat = galerkin_patterns(A0, agg0, k0)
    A0_dev = CSR.from_scipy(A0, device=dev)
    P0 = smoothed_aggregation(A0_dev, lev_d.agg, k0, omega=lev_d.omegas[0])
    level0 = partial(
        rap_masked, A0_dev, P0, CSR.from_scipy(APpat, device=dev),
        CSR.from_scipy(AHpat, device=dev), a_width=a_width, p_width=a_width,
        pt_width=int(np.bincount(agg0[A0.tocoo().col], minlength=k0).max()),
        ap_width=int(np.diff(APpat.indptr).max()))
    torch.cuda.synchronize()
    t0 = time.time()
    AH_dev = level0().to_scipy()
    level0_rap_s = time.time() - t0
    # where the product's time goes: device ops, busy time and idle share
    level0_trace = device_trace(level0, iters=1, kernel="index", warmup=False, cpu=False)
    P_host = host_prolongator(A0, agg0, k0, lev_d.Dinv.cpu().numpy(), lev_d.omegas)
    AH_host = (P_host.T @ (A0 @ P_host)).tocsr()
    ah_gap = float(abs(AH_dev - AH_host).max())
    ah_scale = float(abs(AH_host).max())
    check(ah_gap <= GALERKIN_AH_RTOL * ah_scale,
          f"galerkin: level 0 A_H device vs host {ah_gap} > {GALERKIN_AH_RTOL} * {ah_scale}")
    levels = []
    for l, (lh, ld, br, rl) in enumerate(zip(h_host.levels, h.levels, prof["rap_branch"],
                                             prof["rap_levels"])):
        same_n = lh.agg.numel() == ld.agg.numel()
        levels.append({
            "level": l, "n": ld.agg.numel(), "k_host": lh.k, "k_device": ld.k,
            "agg_entries_differing": (int((lh.agg != ld.agg).sum()) if same_n else None),
            "branch": br, **rl,
            "host_rap_s": path["setup_profile_s"]["rap_levels"][l]["rap_s"],
        })

    # rap_learned: a random P-hat on A's coordinates.  JAX's test draws random
    # aggregates (n // 10 of them) on its 1500-node hull: the same here on
    # that hull.  At 600k random aggregates give a near-dense coarse pattern,
    # so level 0 keeps its own (local) Lloyd aggregates, as FullAggNet's are
    rng = np.random.RandomState(5)
    learned = {}
    from mlamg_torch.data import Grid

    small = Grid.random_2d_unstructured(1500, seed=3).A.astype(np.float32)
    for label, A_l, agg_l in (("hull1500_random_agg", small,
                               rng.randint(0, 150, size=1500).astype(np.int64)),
                              ("hull600k_level0_lloyd_agg", A0, agg0.astype(np.int64))):
        A_dev, P_dev, k_l, oracle = learned_p(A_l, agg_l, rng)
        torch.cuda.synchronize()
        t0 = time.time()
        got = rap_learned(A_dev, P_dev, A_l, agg_l, k_l).to_scipy()
        seconds = time.time() - t0
        excess = allclose_sparse(got.astype(np.float64), oracle, GALERKIN_LEARNED_TOL, 0.0)
        check(excess <= GALERKIN_LEARNED_TOL,
              f"galerkin: rap_learned {label} misses the float64 oracle by {excess}")
        learned[label] = {"n": A_l.shape[0], "k": k_l, "nnz": int(got.nnz), "seconds": seconds,
                          "excess_over_rtol": excess,
                          "max_abs_err": float(abs(got - oracle).max()),
                          "scale": float(abs(oracle).max())}
    del h, A0_dev, P0

    # build_hierarchy(sparse_levels=1): card against CPU in float64
    card, cpu = sparse_levels_run("cuda"), sparse_levels_run("cpu")
    A1c, A1h = card["A1"], cpu["A1"]
    check(isinstance(A1c, CSR) and isinstance(card["P0"], CSR),
          "galerkin: sparse_levels=1 kept no CSR coarse level")
    for name in ("row", "col", "indptr"):
        check(torch.equal(getattr(A1c, name).cpu(), getattr(A1h, name)),
              f"galerkin: sparse coarse level's {name} differs card vs CPU")
    s_gap = float((A1c.data.cpu() - A1h.data).abs().max())
    s_scale = float(A1h.data.abs().max())
    check(s_gap <= GALERKIN_SPARSE_RTOL * s_scale,
          f"galerkin: sparse coarse level card vs CPU {s_gap} > "
          f"{GALERKIN_SPARSE_RTOL} * {s_scale}")
    for run, dev_name in ((card, "card"), (cpu, "CPU")):
        check(run["res"] <= run["tol"],
              f"galerkin: sparse-level vcycle_solve on the {dev_name}: residual "
              f"{run['res']} > {run['tol']} after {run['iters']} cycles")

    host_prof = path["setup_profile_s"]
    return {
        "phase": "galerkin",
        "n": n,
        "setup_s": {"host": path["setup_s"], "device": setup_s},
        "setup_profile_s": {"host": host_prof, "device": prof},
        "device_setup_peak_bytes": peak_bytes,
        "device_setup_peak_over_start_bytes": peak_bytes - base_bytes,
        "levels": levels,
        "level0_ah_max_abs_gap": ah_gap,
        "level0_ah_scale": ah_scale,
        "level0_masked_rap_s": level0_rap_s,
        "level0_masked_rap_trace": level0_trace,
        "conv": conv,
        "iters": iters,
        "residual_history": [float(v) for v in hist],
        "well_spmv_launches": launches,
        "rap_learned": learned,
        "sparse_levels": {
            "grid": GALERKIN_GRID,
            "coarse_n": A1h.shape[0], "coarse_nnz": int(A1h.mask.sum()),
            "coarse_capacity": A1h.nnz_pad,
            "card_vs_cpu_max_abs": s_gap, "scale": s_scale,
            **{f"{key}_{dev_name}": run[key] for run, dev_name in ((card, "card"), (cpu, "cpu"))
               for key in ("build_s", "solve_s", "conv", "iters", "res")},
        },
        "seconds": time.time() - t_phase,
    }, launches


def poisson2d(nx: int):
    """nx^2 five-point Poisson in float32 (bench.py's construction)."""
    import scipy.sparse as sp

    I = sp.eye(nx, format="csr", dtype=np.float32)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), dtype=np.float32)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def check_dia_kernel(A, rng, label: str) -> tuple[float, float]:
    """Hold dia_spmv against dia_spmv_reference, plain and affine.
    Returns the largest (absolute, relative) error of the two calls."""
    import torch
    from mlamg_torch.ops.dia import dia_spmv, dia_spmv_reference

    n = A.shape[0]
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).to(A.device)
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).to(A.device)
    abs_err = rel_err = 0.0
    for form, cc, alpha in (("plain", None, 1.0), ("affine", c, -1.0)):
        y = dia_spmv(A, x, cc, alpha)
        torch.cuda.synchronize()
        ref = dia_spmv_reference(A, x, cc, alpha)
        check(bool(torch.isfinite(y).all()), f"dia_spmv returned non-finite values on {label}")
        err, scale = float((y - ref).abs().max()), float(ref.abs().max())
        check(err <= KERNEL_RTOL * scale,
              f"dia_spmv {form} on {label}: max err {err} > {KERNEL_RTOL} * {scale}")
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
    return abs_err, rel_err


def host_us(fn, calls: int) -> float:
    """Host time of one ``fn()`` in us: ``calls`` back to back, timed
    before the synchronise that ends them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def ordered_sum_phase(flush) -> dict:
    """Hold the ordered-sum kernel against the plain chain bit for bit and
    time it where the learned cell calls it (a Dense of (250, 8, 8) over
    dim 1; the CSR spmv slot sum of the largest 2d_iso test grid, 1,628
    entries, width 10; a restriction's slot sum, width 36) and at one
    tree_sum level of a 600k and a 16.8M vector: L2-cold and warm, the
    plain chain's cold time, and both versions' host time and device
    operations a call (a device-only profiler pass); then its launches in
    a learned build and cycle on test grid 0."""
    import torch
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.mg.learned import build_learned_twolevel, learned_solve
    from mlamg_torch.ops.segment import (
        ordered_sum, ordered_sum_reference, slot_sum, slot_sum_reference,
    )
    from mlamg_torch.ops.sparse import CSR, segment_slots
    from mlamg_torch.utils.profiler import LAUNCHES

    grids = Grid.load_dir("data_out/2d_iso/test")
    A = CSR.from_scipy(max(grids, key=lambda g: g.A.shape[0]).A, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    spmv_vals, restrict_vals = randn(A.nnz_pad), randn(900)
    restrict_slots = segment_slots(torch.arange(900, device="cuda") % 25, 25)
    dense, tree600k, tree16m = randn(A.shape[0], 8, 8), randn(600_000), randn(GRID * GRID)
    # name -> (kernel call, plain call, least bytes)
    cases = {
        "dense_250x8x8": (lambda: ordered_sum(dense, 1),
                          lambda: ordered_sum_reference(dense, 1),
                          dense.numel() * 4 + dense.numel() // 8 * 4),
        "spmv_slots_w10": (lambda: slot_sum(spmv_vals, A.row_slots),
                           lambda: slot_sum_reference(spmv_vals, A.row_slots),
                           A.nnz * 4 + A.row_slots.numel() * 8 + A.shape[0] * 4),
        "restrict_slots_w36": (lambda: slot_sum(restrict_vals, restrict_slots),
                               lambda: slot_sum_reference(restrict_vals, restrict_slots),
                               900 * 4 + 900 * 8 + 25 * 4),
        "tree_level_600k": (lambda: ordered_sum(tree600k.view(-1, 32), 1),
                            lambda: ordered_sum_reference(tree600k.view(-1, 32), 1),
                            600_000 * 4 + 600_000 // 32 * 4),
        "tree_level_16.8M": (lambda: ordered_sum(tree16m.view(-1, 32), 1),
                             lambda: ordered_sum_reference(tree16m.view(-1, 32), 1),
                             GRID * GRID * 4 + GRID * GRID // 32 * 4),
    }
    check(A.row_slots.shape[1] == 10 and restrict_slots.shape[1] == 36,
          f"ordered_sum: slot widths {A.row_slots.shape[1]}, {restrict_slots.shape[1]}")
    times = {}
    for name, (fn, plain, nbytes) in cases.items():
        before = LAUNCHES["ordered_sum"]
        got = fn()
        torch.cuda.synchronize()
        check(LAUNCHES["ordered_sum"] == before + 1, f"ordered_sum {name}: not one launch")
        # device operations of one call, from a device-only profiler pass
        launches = device_trace(fn, 1, cpu=False)["device_ops"]
        plain_launches = device_trace(plain, 1, cpu=False)["device_ops"]
        check(launches == 1, f"ordered_sum {name}: {launches} device operations a call")
        want = plain()
        view = torch.int32 if got.dtype == torch.float32 else torch.int64
        check(torch.equal(got.view(view), want.view(view)),
              f"ordered_sum {name}: differs from the plain chain")
        cold, warm = cold_warm_ms(fn, flush)
        times[name] = {
            "cold_us": cold * 1e3, "warm_us": warm * 1e3,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "plain_cold_us": queued_ms(plain, COLD_ITERS, flush) * 1e3,
            "plain_warm_us": queued_ms(plain, max(1, int(800 // plain_launches))) * 1e3,
            "host_us": host_us(fn, 200),
            "plain_host_us": host_us(plain, max(1, int(2000 // plain_launches))),
            "launches": launches,
            "plain_launches": plain_launches,
        }

    grid = grids[0]
    net, _ = load_model("runs_iso_r5/grad_best.ckpt", grids, device="cuda")
    A0 = CSR.from_scipy(grid.A, device="cuda")
    b = randn(A0.shape[0])
    counts = {}
    for what, cycles in (("build", None), ("solve_1", 1), ("solve_3", 3)):
        before = LAUNCHES["ordered_sum"]
        if cycles is None:
            h = build_learned_twolevel(net, A0, math.ceil(0.1 * A0.shape[0]))
        else:
            learned_solve(h, b, res_tol=0.0, max_iter=cycles)
        torch.cuda.synchronize()
        counts[what] = LAUNCHES["ordered_sum"] - before
    return {
        "name": "ordered_sum",
        "route": "cuda",
        "source": "mlamg_torch/ops/csrc/ordered_sum.cu",
        "replaces": "no TPU kernel: the chains of elementwise adds of ops/segment.py",
        "times": times,
        "bound_by": "bytes (the launch itself at the learned shapes)",
        "launches_per_learned_build": counts["build"],
        "launches_per_learned_cycle": (counts["solve_3"] - counts["solve_1"]) / 2,
        "launches_learned_solve_3": counts["solve_3"],
    }


def dia_kernel_phase(A_sp, Ad, rng) -> tuple[dict, list]:
    """Check dia_spmv on the fine Poisson level and a ragged banded matrix,
    time it on the fine level (D = 5: its 470 MB exceed the 50 MB L2)."""
    import scipy.sparse as sp
    import torch
    from mlamg_torch.ops.dia import DIA, dia_spmv, dia_spmv_reference

    n_b = 128 * 64 + 37
    offsets = [-130, -128, -1, 0, 1, 127, 256]
    banded = sp.diags([rng.randn(n_b - abs(o)) for o in offsets], offsets,
                      shape=(n_b, n_b)).tocsr().astype(np.float32)
    errs = [check_dia_kernel(Ad, rng, "4096^2 Poisson"),
            check_dia_kernel(DIA.from_scipy(banded, device="cuda"), rng, "banded")]

    n, D = Ad.shape[0], len(Ad.offsets)
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(A_sp.indptr.astype(np.int64)),
        torch.from_numpy(A_sp.indices.astype(np.int64)),
        torch.from_numpy(A_sp.data.astype(np.float32)),
        size=A_sp.shape, check_invariants=False,
    ).cuda()
    y_ref = dia_spmv_reference(Ad, x)
    check(float((torch.mv(A_csr, x) - y_ref).abs().max()) <= KERNEL_RTOL * float(y_ref.abs().max()),
          "torch.sparse CSR matvec disagrees with the plain DIA version")

    ms = cuda_ms(lambda: dia_spmv(Ad, x))
    plain_ms = cuda_ms(lambda: dia_spmv_reference(Ad, x))
    library_ms = cuda_ms(lambda: torch.mv(A_csr, x))
    affine_ms = cuda_ms(lambda: dia_spmv(Ad, x, c, -1.0))
    affine_plain_ms = cuda_ms(lambda: dia_spmv_reference(Ad, x, c, -1.0))
    del A_csr
    # least bytes: each diagonal value read once, x read, y written (c read
    # in the affine form); 2 flops per stored value (+2 per row affine)
    bound_ms = max((D + 2) * 4 * n / HBM_BYTES_PER_S, 2 * D * n / F32_FLOPS) * 1e3
    affine_bound_ms = max((D + 3) * 4 * n / HBM_BYTES_PER_S,
                          (2 * D + 2) * n / F32_FLOPS) * 1e3
    return {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "mlamg_torch/ops/csrc/dia_spmv.cu",
        "replaces": "mlamg_tpu/ops/pallas_kernels.py:60",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "affine_ms": affine_ms,
        "affine_plain_ms": affine_plain_ms,
        "affine_bound_ms": affine_bound_ms,
        "n": n,
        "D": D,
        "nnz": int(A_sp.nnz),
    }, errs


def vcycle_launches(h, nu: int, gamma: int = 1) -> int:
    """dia_spmv launches of one Chebyshev cycle: per level visit 2*(nu+1)
    Chebyshev residuals, one residual, and one SpMV per factor each in
    restriction and interpolation (none for a bilinear P); level l is
    visited gamma**l times."""
    return sum(
        gamma ** l * (2 * (nu + 1) + 1 + 2 * len(getattr(P, "Ss", ())))
        for l, P in enumerate(h.Ps)
    )


def probe_launches(h) -> int:
    """dia_spmv launches of the setup: per level one SpMV of A and one per
    factor each way, for each of the probe's (2Ry+1)(2Rx+1) colours."""
    from mlamg_torch.mg.structured import probe_reach

    total = 0
    for A, P in zip(h.As, h.Ps):
        _, (Ry, Rx) = probe_reach(A, P)
        total += (2 * Ry + 1) * (2 * Rx + 1) * (1 + 2 * len(getattr(P, "Ss", ())))
    return total


def stage_seconds(h) -> dict:
    """Host seconds of the structured setup's stages, re-run on the built
    hierarchy: each level's Galerkin probe, then the coarse inverse."""
    import torch
    from mlamg_torch.mg.coarse import CoarseSolver
    from mlamg_torch.mg.structured import dia_galerkin_probe

    probe_s = []
    for A, P in zip(h.As, h.Ps):
        torch.cuda.synchronize()
        t0 = time.time()
        A_next = dia_galerkin_probe(A, P)
        torch.cuda.synchronize()
        probe_s.append(time.time() - t0)
    t0 = time.time()
    CoarseSolver.factor(A_next.todense(), method="inverse")
    torch.cuda.synchronize()
    return {"probe_per_level": probe_s, "coarse_inverse": time.time() - t0}


def structured_phase(A_sp, Ad, stages: dict, rng) -> tuple[dict, int, list]:
    import torch
    from mlamg_torch.mg.cycle import vcycle
    from mlamg_torch.mg.structured import build_structured_hierarchy
    from mlamg_torch.ops.matmul import spmv_affine
    from mlamg_torch.utils.profiler import LAUNCHES

    n = Ad.shape[0]
    x0 = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).cuda()
    b = torch.zeros_like(x0)
    norm0 = float(torch.linalg.vector_norm(x0))

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    t0 = time.time()
    h = build_structured_hierarchy(Ad, GRID, GRID, sides=(2,) * 7, min_coarse=900,
                                   kind="bilinear")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_launches = LAUNCHES["dia_spmv"]
    x, norms = x0, []
    t0 = time.time()
    while len(norms) < 30 and (len(norms) < 6 or norms[-1] > 1e-6 * norm0):
        x = vcycle(h, b, x, **VCYCLE)
        norms.append(float(torch.linalg.vector_norm(x)))
    cycles_s = time.time() - t0
    launches = LAUNCHES["dia_spmv"]
    # ---------------------------------------------------------------------

    per_cycle = vcycle_launches(h, VCYCLE["nu"])
    check(h.num_levels == 7 and h.coarse.lu.shape == (1024, 1024),
          f"hierarchy has {h.num_levels} smoothed levels, coarse {tuple(h.coarse.lu.shape)}")
    check(setup_launches == probe_launches(h),
          f"setup launched dia_spmv {setup_launches} times, expected {probe_launches(h)}")
    check(launches - setup_launches == len(norms) * per_cycle,
          f"{len(norms)} V-cycles launched dia_spmv {launches - setup_launches} times, "
          f"expected {len(norms) * per_cycle}")
    check(bool(np.isfinite(norms).all()), "V-cycles produced non-finite values")
    conv = float((norms[5] / norms[1]) ** (1.0 / 4))  # bench.py: 6 cycles, skip the first
    check(abs(conv - REF_CONV_16M) <= CONV_TOL,
          f"conv factor {conv} not within {CONV_TOL} of {REF_CONV_16M}")
    check(norms[-1] <= 1e-6 * norm0, f"||x|| fell only to {norms[-1] / norm0} in {len(norms)} cycles")

    level_errs = [check_dia_kernel(A, rng, f"level {l}") for l, A in enumerate(h.As)]

    cycle_ms = cuda_ms(lambda: vcycle(h, b, x0, **VCYCLE), iters=10, warmup=2)
    t0 = time.time()
    for _ in range(10):
        vcycle(h, b, x0, **VCYCLE)
    torch.cuda.synchronize()
    cycle_wall_ms = (time.time() - t0) / 10 * 1e3
    trace = device_trace(lambda: vcycle(h, b, x0, **VCYCLE), iters=3, kernel="dia_spmv")

    # random right-hand side: V-cycles until the f32 residual reaches
    # 1e-6 * ||b|| or stops falling, then the float64 residual on the host
    rhs = np.random.RandomState(1).randn(n).astype(np.float32)
    bnorm = float(np.linalg.norm(rhs))
    bt = torch.from_numpy(rhs).cuda()
    xs, res = torch.zeros_like(bt), []
    for _ in range(20):
        xs = vcycle(h, bt, xs, **VCYCLE)
        res.append(float(torch.linalg.vector_norm(spmv_affine(Ad, xs, c=bt, alpha=-1.0))))
        if res[-1] <= 1e-6 * bnorm or (len(res) > 1 and res[-1] >= res[-2]):
            break
    sol = xs.cpu().numpy().astype(np.float64)
    rel_res = float(np.linalg.norm(A_sp.astype(np.float64) @ sol - rhs) / bnorm)
    check(rel_res < 1e-3, f"random-rhs float64 relative residual {rel_res} >= 1e-3")

    return {
        "phase": "structured",
        "n": n,
        "nnz": int(A_sp.nnz),
        "levels": [{"n": A.shape[0], "D": len(A.offsets)} for A in h.As],
        "coarse_k": int(h.coarse.lu.shape[0]),
        "setup_s": setup_s,
        "setup_stages_s": {**stages, **stage_seconds(h)},
        "conv": conv,
        "cycles_to_1e-6": len(norms),
        "norms": norms,
        "cycles_s": cycles_s,
        "dia_spmv_launches_setup": setup_launches,
        "dia_spmv_launches_cycles": launches - setup_launches,
        "dia_spmv_launches_per_vcycle": per_cycle,
        "level_kernel_rel_err": [e[1] for e in level_errs],
        "ms_per_vcycle": cycle_ms,
        "wall_ms_per_vcycle": cycle_wall_ms,
        "vcycle_trace": trace,
        "rhs_f32_rel_residuals": [r / bnorm for r in res],
        "rhs_cycles": len(res),
        "rhs_f64_rel_residual": rel_res,
    }, launches, level_errs


def twolevel_phase(rng) -> tuple[dict, int, list]:
    """bench.py bench_twolevel through the port, fused and unfused."""
    import torch
    from mlamg_torch.mg.coarse import CoarseSolver
    from mlamg_torch.mg.cycle import coarse_operator, twolevel_solve
    from mlamg_torch.mg.factored import BoxAgg2D, factored_sa
    from mlamg_torch.ops.dia import DIA
    from mlamg_torch.utils.profiler import LAUNCHES

    nx, side, iters = TWOLEVEL_GRID, TWOLEVEL_SIDE, TWOLEVEL_ITERS
    A_sp = poisson2d(nx)
    n = A_sp.shape[0]
    x0 = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).cuda()
    b = torch.zeros_like(x0)

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    t0 = time.time()
    Ad = DIA.from_scipy(A_sp)
    P = factored_sa(Ad, BoxAgg2D(ny=nx, nx=nx, sy=side, sx=side), omega=0.65)
    coarse = CoarseSolver.factor(coarse_operator(Ad, P), method="inverse")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    out = {}
    for fused in (True, False):
        LAUNCHES.clear()
        _, conv, _, it = twolevel_solve(Ad, P, b, x0, res_tol=0.0, max_iter=iters,
                                        coarse=coarse, fused_jacobi=fused)
        torch.cuda.synchronize()
        out[fused] = dict(conv=conv, iters=it, launches=LAUNCHES["dia_spmv"])
    # ---------------------------------------------------------------------

    per_iter = 1 + 1 + 2 + 2 * len(P.Ss)  # pre, post, two residuals, S and S^T
    for fused, r in out.items():
        check(r["iters"] == iters and 0.0 < r["conv"] < 1.0 and np.isfinite(r["conv"]),
              f"two-level (fused={fused}): conv {r['conv']} after {r['iters']} iterations")
        check(r["launches"] == iters * per_iter,
              f"two-level (fused={fused}) launched dia_spmv {r['launches']} times, "
              f"expected {iters * per_iter}")
    check(abs(out[True]["conv"] - out[False]["conv"]) <= 1e-3,
          f"fused and unfused two-level conv differ: {out[True]['conv']} vs {out[False]['conv']}")

    factor_errs = [check_dia_kernel(S, rng, f"512^2 SA factor {i}")
                   for i, S in enumerate(P.Ss + P.Sts)]
    solve = partial(twolevel_solve, Ad, P, b, x0, res_tol=0.0, max_iter=iters, coarse=coarse)
    ms_fused = cuda_ms(lambda: solve(fused_jacobi=True), iters=3, warmup=1) / iters
    ms_unfused = cuda_ms(lambda: solve(fused_jacobi=False), iters=3, warmup=1) / iters
    return {
        "phase": "twolevel",
        "n": n,
        "k": P.shape[1],
        "setup_s": setup_s,
        "conv_fused": out[True]["conv"],
        "conv_unfused": out[False]["conv"],
        "iters": iters,
        "dia_spmv_launches_fused": out[True]["launches"],
        "dia_spmv_launches_unfused": out[False]["launches"],
        "dia_spmv_launches_per_iteration": per_iter,
        "ms_per_iteration_fused": ms_fused,
        "ms_per_iteration_unfused": ms_unfused,
        "factor_kernel_rel_err": [e[1] for e in factor_errs],
    }, out[True]["launches"] + out[False]["launches"], factor_errs


def small_structured_phase() -> dict:
    """One 64^2 bilinear V-cycle and one 64^2 box-SA fused two-level
    iteration on the card against the same on the CPU (where dia_spmv is
    the plain version)."""
    import torch
    from mlamg_torch.mg.cycle import twolevel_solve, vcycle
    from mlamg_torch.mg.factored import BoxAgg2D, factored_sa
    from mlamg_torch.mg.structured import build_structured_hierarchy
    from mlamg_torch.ops.dia import DIA

    A_sp = poisson2d(64)
    x0 = np.random.RandomState(0).randn(A_sp.shape[0]).astype(np.float32)
    out = {"vcycle": {}, "twolevel": {}}
    for dev in ("cuda", "cpu"):
        Ad = DIA.from_scipy(A_sp, device=dev)
        x = torch.from_numpy(x0).to(dev)
        h = build_structured_hierarchy(Ad, 64, 64, sides=(2,) * 6, min_coarse=16,
                                       kind="bilinear")
        out["vcycle"][dev] = vcycle(h, torch.zeros_like(x), x, **VCYCLE).cpu().numpy()
        P = factored_sa(Ad, BoxAgg2D(64, 64, 4, 4), omega=0.65)
        y, _, _, _ = twolevel_solve(Ad, P, torch.zeros_like(x), x, res_tol=0.0, max_iter=1,
                                    fused_jacobi=True)
        out["twolevel"][dev] = y.cpu().numpy()
    res = {"phase": "small_structured", "n": A_sp.shape[0]}
    for name, r in out.items():
        err = float(np.abs(r["cuda"] - r["cpu"]).max())
        scale = float(np.abs(r["cpu"]).max())
        check(err <= 1e-4 * scale, f"small {name} cuda vs cpu: {err} > 1e-4 * {scale}")
        res[f"{name}_max_abs_err"], res[f"{name}_scale"] = err, scale
    return res


def bench_phase(hull, poisson) -> tuple[dict, dict]:
    """bench_torch's seven cells in this process on the 600k hull and the
    4096^2 Poisson already built (see the module docstring)."""
    import bench_torch
    from mlamg_torch.utils.profiler import LAUNCHES

    t0 = time.time()
    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    results, errors = bench_torch.run_cells(device="cuda", samples=BENCH_SAMPLES,
                                            hull=hull, poisson=poisson)
    launches = {k: LAUNCHES[k] for k in KERNELS}
    # ---------------------------------------------------------------------
    seconds = time.time() - t0
    check(not errors, f"bench cells failed: {errors}")
    check({name: (r["metric"], r["unit"]) for name, r in results.items()} == BENCH_METRICS,
          f"bench metrics {[r['metric'] for r in results.values()]} are not bench.py's")
    for name, kernel in BENCH_KERNEL.items():
        check(results[name]["launches"][kernel] > 0, f"{kernel} never launched on the {name} cell")
    check(seconds <= BENCH_SECONDS, f"bench phase took {seconds:.1f} s (limit {BENCH_SECONDS} s)")
    keys = ("value", "spmv_us", "warm_us", "library_us", "conv_factor", "iters_to_1e6",
            "setup_s", "wall_ms", "wall_tail_ms", "tail_pct", "device_ms", "idle",
            "fused_wall_ms", "fused_device_ms", "launches", "check")
    return {"phase": "bench", "seconds": seconds, "launches": launches,
            "cells": {name: {"metric": r["metric"], **{k: r[k] for k in keys if k in r}}
                      for name, r in results.items()}}, launches


def eval_phase() -> tuple[dict, dict]:
    """The learned two-level evaluation (phase 8 of the module docstring).
    Returns the phase's line and the CUDA kernels' launches on its path."""
    import torch
    from mlamg_torch.cli.evaluate_dataset import evaluate, load_model
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.mg.cycle import twolevel_solve
    from mlamg_torch.utils.profiler import LAUNCHES
    from mlamg_torch.train import GridBundle, SolveOptions, measured_conv

    t_phase = time.time()
    quiet = dict(ablations=True, log=lambda *_: None)
    data = {fam: (Grid.load_dir(d), ck, ref) for fam, d, ck, ref in EVAL_RUNS}

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    card, seconds, nets = {}, {}, {}
    for fam, (grids, ck, _) in data.items():
        t0 = time.time()
        nets[fam], _ = load_model(ck, grids, device="cuda")
        card[fam], seconds[fam] = evaluate(grids, nets[fam], device="cuda", **quiet)
        torch.cuda.synchronize()
        seconds[fam]["total"] = time.time() - t0
    launches = {k: LAUNCHES[k] for k in KERNELS}
    # ---------------------------------------------------------------------

    check(not any(launches[k] for k in SPMV_KERNELS),
          f"eval path launched CUDA kernels: {launches}")
    out = {"phase": "eval", "launches": launches, "seconds": seconds, "means": {},
           "committed_means": {}}
    for fam, (grids, ck, ref) in data.items():
        with open(ref) as f:
            committed = json.load(f)
        means = {m: float(card[fam][m].mean()) for m in EVAL_METHODS}
        out["means"][fam] = means
        out["committed_means"][fam] = {m: committed[m] for m in EVAL_METHODS}
        for m in EVAL_METHODS:
            v = card[fam][m]
            check(bool(np.isfinite(v).all()) and v.shape == (len(grids),),
                  f"eval {fam} {m}: {v}")
            check(abs(means[m] - committed[m]) <= EVAL_MEAN_TOL,
                  f"eval {fam} {m}: mean {means[m]} not within {EVAL_MEAN_TOL} of {committed[m]}")
    check(out["means"]["2d_iso"]["ml"] < out["means"]["2d_iso"]["lloyd"],
          f"2d_iso: ML {out['means']['2d_iso']['ml']} not below Lloyd "
          f"{out['means']['2d_iso']['lloyd']}")

    grids_iso = data["2d_iso"][0]
    again, _ = evaluate(grids_iso, nets["2d_iso"], device="cuda", **quiet)
    for m in EVAL_METHODS:
        check(np.array_equal(again[m], card["2d_iso"][m]),
              f"second 2d_iso run on the card differs for {m}")
    out["repeat_identical"] = True

    out["cpu_max_abs_diff"], out["forward_differs_cpu"] = {}, {}
    for fam, (grids, ck, _) in data.items():
        net_cpu, _ = load_model(ck, grids, device="cpu")
        cpu, _ = evaluate(grids, net_cpu, device="cpu", **quiet)
        out["cpu_max_abs_diff"][fam] = {
            m: float(np.abs(cpu[m] - card[fam][m]).max()) for m in EVAL_METHODS}
        for m in EVAL_METHODS:
            check(out["cpu_max_abs_diff"][fam][m] <= EVAL_CPU_TOL,
                  f"eval {fam} {m}: card and CPU differ by {out['cpu_max_abs_diff'][fam][m]}")
        differ = 0
        with torch.no_grad():
            for g in grids:
                fwd = [net(b.A, b.k) for net, b in
                       ((nets[fam], GridBundle.from_grid(g, 0.1, device="cuda")),
                        (net_cpu, GridBundle.from_grid(g, 0.1, device="cpu")))]
                differ += not (torch.equal(fwd[0][0].cpu(), fwd[1][0])
                               and torch.equal(fwd[0][3].cpu(), fwd[1][3]))
        out["forward_differs_cpu"][fam] = differ

    # timings on the largest 2d_iso grid
    g = max(grids_iso, key=lambda g: g.n)
    b = GridBundle.from_grid(g, 0.1, device="cuda")
    net = nets["2d_iso"]
    with torch.no_grad():
        P = net(b.A, b.k)[1]
        opts = SolveOptions(smoother="multicolor_gs")
        iters = 20
        args = {"colors": b.colors, "num_colors": b.num_colors}
        solve = partial(twolevel_solve, b.A, P, torch.zeros_like(b.x0), b.x0, res_tol=0.0,
                        max_iter=iters, smoother="multicolor_gs", smoother_args=args)
        out["largest_2d_iso"] = {
            "n": g.n, "k": b.k, "num_colors": b.num_colors,
            "ms_per_twolevel_iteration": cuda_ms(solve, iters=3, warmup=1) / iters,
            "ms_per_fullaggnet_forward": cuda_ms(lambda: net(b.A, b.k), iters=5, warmup=1),
            "ml_conv_trace": device_trace(
                lambda: measured_conv(b.A, P, b.x0, opts, b.colors, b.num_colors),
                iters=1, kernel="spmv"),
        }
    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= EVAL_SECONDS,
          f"eval phase took {out['seconds_phase']:.1f} s (limit {EVAL_SECONDS} s)")
    return out, launches


def _quiet(fn, *args, **kw):
    """(fn's result, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue()


def _cpu_worker_setup() -> None:
    """A CPU worker of the train phase: the cores the card's host thread
    leaves, shared by two workers, and PyTorch's deterministic algorithms,
    so that the backward of a gather adds in a fixed order (its threaded
    CPU default varies from run to run; the card's sorts).  The reference
    is then the same in every run: the discrete losses after the steps,
    chaotic in the rounding-set gradients, give the same gap each time."""
    import torch

    torch.set_num_threads(max(1, ((os.cpu_count() or 2) - 2) // 2))
    torch.use_deterministic_algorithms(True)


def _train_reference_cpu(argv: list, pre_argv: list, tmp: str) -> dict:
    """The train phase's steps and pretraining epoch on the CPU (run in a
    worker process)."""
    import torch
    from mlamg_torch.cli import pretrain_dataset, train_gradient

    _cpu_worker_setup()
    t0 = time.time()
    run = train_gradient.prepare(train_gradient.parse_args([*argv, "--device", "cpu"]),
                                 log=lambda *_: None)
    out = {"seconds_per_step": []}
    for it in range(TRAIN_STEPS):
        t1 = time.time()
        loss, g = run.step(it)
        out["seconds_per_step"].append(time.time() - t1)
        if it == 0:
            out.update(soft_loss_first_step=loss, first_grad=g.double().numpy())
    out["discrete_train"], out["discrete_test"] = run.discrete_losses()
    t1 = time.time()
    (_, parts), _ = _quiet(pretrain_dataset.main, [
        *pre_argv, "--device", "cpu", "--out", f"{tmp}/pretrain_cpu.ckpt"])
    out.update(seconds_pretrain_epoch=time.time() - t1, seconds_total=time.time() - t0,
               pretrain=parts.tolist(), threads=torch.get_num_threads())
    return out


def _first_step_and_epoch64(argv: list, pre_argv: list, tmp: str, device: str) -> dict:
    """The first training step's soft loss and gradient, and the mean parts
    of one pretraining epoch, in float64 on ``device``."""
    import torch
    from mlamg_torch.cli import pretrain_dataset, train_gradient

    if device == "cpu":
        _cpu_worker_setup()
    t0 = time.time()
    run = train_gradient.prepare(train_gradient.parse_args([*argv, "--device", device]),
                                 log=lambda *_: None, dtype=torch.float64)
    loss, g = run.grad(0)
    (_, parts), _ = _quiet(pretrain_dataset.main, [
        *pre_argv, "--device", device, "--out", f"{tmp}/pretrain64_{device}.ckpt"],
        dtype=torch.float64)
    return dict(soft_loss=loss, grad=g.cpu().numpy(), pretrain=parts.tolist(),
                seconds=time.time() - t0)


def _grad_gaps(ga, gb, net) -> dict:
    """Card gradient ``ga`` against CPU gradient ``gb`` (flat, float64):
    the relative gap in norm outside ``amplified_grad``'s tensors and of the
    whole, the whole's cosine, the amplified tensors' share of the norm and
    the ten tensors with the largest gaps."""
    import torch
    from mlamg_torch.convert import param_leaves

    leaves = param_leaves(net)
    rest = torch.cat([torch.full((p.numel(),), not amplified_grad("/".join(path[1:])))
                      for path, p, _ in leaves])
    gaps, pos = [], 0
    for path, p, _ in leaves:
        a, b = ga[pos:pos + p.numel()], gb[pos:pos + p.numel()]
        pos += p.numel()
        gaps.append((float((a - b).norm()), float(b.norm()), "/".join(path[1:])))
    return dict(rel_gap=float((ga - gb)[rest].norm() / gb[rest].norm()),
                rel_gap_whole=float((ga - gb).norm() / gb.norm()),
                cosine_whole=float(ga @ gb / (ga.norm() * gb.norm())),
                amplified_share_of_norm=float(gb[~rest].norm() / gb.norm()),
                largest_gaps=sorted(gaps, reverse=True)[:10])


def _rel_gaps(a, b) -> list:
    return (np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))).tolist()


def pretrain_seed_witness(epochs: int = 10, devices=("cuda", "cpu")) -> dict:
    """Seed 0's initial weights as flax's ``init(PRNGKey(0))`` draws them
    (their sum of squares against this package's on another machine,
    ``WITNESS_INIT_SUM_SQ``, and the JAX package's, ``JAX_INIT_SUM_SQ``),
    then ``epochs`` of the recipe's pretraining from them on each device at
    once, each device's progress lines (``p 0.02976`` is PNet's head dead:
    an all-zero output; JAX reads ``p 0.02503`` at epoch 10,
    ``runs_iso_r5/pretrain.log``).  Not part of :func:`main`; run it alone:
    ``python3 -c "import json, chip_smoke; print(json.dumps(chip_smoke.pretrain_seed_witness()))"``.
    """
    import torch
    from mlamg_torch.cli.common import dataset_bf_width, load_dataset_grids
    from mlamg_torch.ga.codec import flatten_params
    from mlamg_torch.models.agg_interp import FullAggNet
    from mlamg_torch.models.gnn import init_flax_
    from mlamg_torch.utils import prng

    grids, _ = load_dataset_grids(TRAIN_DATA)
    net = init_flax_(FullAggNet(dim=8, num_conv=2, iterations=2, bf_width=dataset_bf_width(grids),
                                rel_strength=True), prng.PRNGKey(0))
    vec = flatten_params(net)[0].double().numpy()
    out = {"torch": torch.__version__, "init_sum_sq": math.fsum(vec * vec),
           "init_first_nonzero": vec[vec != 0][:4].tolist()}
    out["init_rel_gap_jax"] = abs(out["init_sum_sq"] - JAX_INIT_SUM_SQ) / JAX_INIT_SUM_SQ
    check(out["init_sum_sq"] == WITNESS_INIT_SUM_SQ,
          f"seed 0's initial weights: sum of squares {out['init_sum_sq']!r}, "
          f"not {WITNESS_INIT_SUM_SQ!r}")
    check(out["init_rel_gap_jax"] <= 1e-8, f"initial weights vs JAX's: {out}")
    argv = [TRAIN_DATA, "--epochs", str(epochs), "--rel-strength", "true"]
    with (tempfile.TemporaryDirectory() as tmp,
          multiprocessing.get_context("spawn").Pool(len(devices)) as pool):
        jobs = {d: pool.apply_async(_pretrain_lines, (argv, d, tmp)) for d in devices}
        for d, job in jobs.items():
            out[d] = job.get()
    return out


def _pretrain_lines(argv: list, device: str, tmp: str) -> dict:
    from mlamg_torch.cli import pretrain_dataset

    if device == "cpu":
        _cpu_worker_setup()
    t0 = time.time()
    (_, parts), log = _quiet(pretrain_dataset.main,
                             [*argv, "--device", device, "--out", f"{tmp}/{device}.ckpt"])
    return {"lines": log.strip().splitlines()[1:-1], "last_parts": parts.tolist(),
            "seconds": time.time() - t0}


def train_phase() -> tuple[dict, dict]:
    """Gradient training (phase 9 of the module docstring).  Returns the
    phase's line and the CUDA kernels' launches on its path; a failed
    check prints what the phase measured so far to stderr."""
    out: dict = {"phase": "train"}
    try:
        return _train_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _train_phase(out: dict) -> tuple[dict, dict]:
    import torch
    from mlamg_torch.cli import pretrain_dataset, train_gradient
    from mlamg_torch.cli.common import compute_reference_convs, load_dataset_grids
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.ga.codec import assign_flat
    from mlamg_torch.models.soft_pipeline import soft_conv_loss
    from mlamg_torch.utils.profiler import LAUNCHES
    from mlamg_torch.train import GridBundle, SolveOptions, bundle_conv, make_buckets
    from mlamg_torch.utils.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    train_grids, test_grids = load_dataset_grids(TRAIN_DATA)
    with (tempfile.TemporaryDirectory() as tmp,
          multiprocessing.get_context("spawn").Pool(2) as pool):
        argv = [TRAIN_DATA, *TRAIN_ARGS, "--out", tmp]
        pre_argv = [TRAIN_DATA, "--epochs", "1", "--rel-strength", "true"]
        cpu_job = pool.apply_async(_train_reference_cpu, (argv, pre_argv, tmp))
        argv64, pre_argv64 = ([*a, "--limit", str(F64_GRIDS)] for a in (argv, pre_argv))
        cpu64_job = pool.apply_async(_first_step_and_epoch64, (argv64, pre_argv64, tmp, "cpu"))

        # --- the main path: counts set to 0 just before, read just after ---
        LAUNCHES.clear()
        t0 = time.time()
        run = train_gradient.prepare(train_gradient.parse_args([*argv, "--device", "cuda"]),
                                     log=lambda *_: None)
        start = run.vec.clone()
        torch.cuda.synchronize()
        out["seconds_prepare"] = time.time() - t0
        step_s = []
        for it in range(TRAIN_STEPS):
            t0 = time.time()
            loss, g = run.step(it)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            if it == 0:
                first = (loss, g.double().cpu())
        t0 = time.time()
        discrete = run.discrete_losses()
        out["seconds_discrete_eval"] = time.time() - t0
        t0 = time.time()
        (_, pre_card), pre_log = _quiet(pretrain_dataset.main, [
            *pre_argv, "--device", "cuda", "--out", f"{tmp}/pretrain.ckpt"])
        torch.cuda.synchronize()
        out["seconds_pretrain_epoch"] = time.time() - t0
        launches = {k: LAUNCHES[k] for k in KERNELS}
        # ---------------------------------------------------------------------

        check(not any(launches[k] for k in SPMV_KERNELS),
              f"train path launched CUDA kernels: {launches}")
        out.update(launches=launches, train_buckets=len(run.buckets), seconds_per_step=step_s,
                   soft_loss_first_step=first[0], discrete_train=discrete[0],
                   discrete_test=discrete[1], pretrain_card=pre_card.tolist(),
                   pretrain_log=pre_log.strip().splitlines()[1])
        check(len(run.buckets) == TRAIN_BUCKETS, f"{len(run.buckets)} train buckets")
        check(np.isfinite(first[0]) and bool(torch.isfinite(first[1]).all()),
              f"train: first step loss {first[0]}")
        moved = float((run.vec - start).abs().max())
        check(moved > 0, "train: the weights did not move")
        out["max_weight_change"] = moved

        # the first step and an epoch in float64 on the card, on the first
        # F64_GRIDS grids (compared with the CPU's at the end)
        card64 = _first_step_and_epoch64(argv64, pre_argv64, tmp, "cuda")

        # the reference convs measured on the card against the committed cache
        t0 = time.time()
        opts75 = SolveOptions(max_iter=75, smoother="multicolor_gs")
        bundles, _ = make_buckets(train_grids, 0.1, torch.float32, step=128, device="cuda")
        refs = compute_reference_convs(bundles, "olson", opts75)
        with open(f"{TRAIN_DATA}/train/.ref_convs_olson.json") as f:
            committed = json.load(f)
        check(committed["settings"]["max_iter"] == 75, "committed ref cache settings")
        names = [g.extra["filename"].rsplit("/", 1)[-1] for g in train_grids]
        ref_gap = max(abs(r - committed["convs"][nm]) for r, nm in zip(refs, names))
        out.update(ref_conv_max_abs_gap=ref_gap, seconds_ref_convs=time.time() - t0,
                   train_lloyd_conv=float(np.mean(refs)))
        check(ref_gap <= REF_CONV_TOL, f"reference convs differ from the cache by {ref_gap}")

        # round trip: the trained weights through evaluate_dataset's loader
        path = f"{tmp}/trained.ckpt"
        save_checkpoint(path, generation=TRAIN_STEPS, best_params=run.unravel(run.vec),
                        extra=dict(net_config=run.net_config))
        net2, _ = load_model(path, test_grids, device="cuda")
        assign_flat(run.net, run.vec)
        b = GridBundle.from_grid(test_grids[0], 0.1, device="cuda")
        opts = SolveOptions(smoother="multicolor_gs")
        with torch.no_grad():
            convs = [bundle_conv(b, net(b.A, b.k)[1], opts) for net in (run.net, net2)]
        out["round_trip_convs"] = convs
        check(convs[0] == convs[1] and np.isfinite(convs[0]), f"round trip: {convs}")

        # the same steps and epoch on the CPU, computed beside the card's work
        # (the card's work comes first, so that the phase waits on the slower)
        cpu = cpu_job.get(timeout=TRAIN_SECONDS * 4)
        out["cpu"] = {k: v for k, v in cpu.items() if k != "first_grad"}
        first_cpu = (cpu["soft_loss_first_step"], torch.from_numpy(cpu["first_grad"]))
        discrete_cpu = (cpu["discrete_train"], cpu["discrete_test"])
        pre_cpu = np.asarray(cpu["pretrain"])
        loss_gap = abs(first[0] - first_cpu[0]) / abs(first_cpu[0])
        g32 = _grad_gaps(first[1], first_cpu[1], run.net)
        out.update(first_loss_rel_gap=loss_gap, first_grad=g32)
        check(loss_gap <= TRAIN_LOSS_RTOL, f"train: first loss card {first[0]} cpu {first_cpu[0]}")
        check(g32["rel_gap"] <= TRAIN_GRAD_RTOL, f"train: gradient card vs cpu {g32['rel_gap']}")
        discrete_gap = [abs(a - b) for a, b in zip(discrete, discrete_cpu)]
        out["discrete_gap_cpu_run"] = discrete_gap
        check(max(discrete_gap) <= TRAIN_DISCRETE_TOL,
              f"train: discrete (train, test) card {discrete} cpu {discrete_cpu}")
        pre_gap = _rel_gaps(pre_card[1:], pre_cpu[1:])
        out["pretrain_rel_gap"] = pre_gap
        check(pre_gap[0] <= PRETRAIN_BCE_RTOL and max(pre_gap[1:]) <= PRETRAIN_MSE_RTOL,
              f"pretrain (bce, mse_c, mse_p) card vs cpu: {pre_gap}")

        # the first step and the epoch in float64, card against CPU
        cpu64 = cpu64_job.get(timeout=TRAIN_SECONDS * 4)
        f64 = dict(seconds_card=card64["seconds"], seconds_cpu=cpu64["seconds"],
                   loss_rel_gap=abs(card64["soft_loss"] - cpu64["soft_loss"])
                   / abs(cpu64["soft_loss"]),
                   grad=_grad_gaps(torch.from_numpy(card64["grad"]),
                                   torch.from_numpy(cpu64["grad"]), run.net),
                   pretrain_rel_gap=_rel_gaps(card64["pretrain"][1:], cpu64["pretrain"][1:]))
        out["float64"] = f64
        check(f64["loss_rel_gap"] <= F64_LOSS_RTOL, f"train: float64 loss gap {f64['loss_rel_gap']}")
        check(f64["grad"]["rel_gap"] <= F64_GRAD_RTOL,
              f"train: float64 gradient gap {f64['grad']['rel_gap']}")
        bce_gap, _, mse_p_gap = f64["pretrain_rel_gap"]
        check(max(bce_gap, mse_p_gap) <= F64_PRETRAIN_RTOL,
              f"train: float64 pretrain (bce, mse_c, mse_p) gap {f64['pretrain_rel_gap']}")

        # one grid's loss and backward: time, determinism, trace (after the
        # CPU workers have finished, so that they do not slow the host)
        bi = max(range(len(run.buckets)), key=lambda i: max(run.buckets[i].n_real))
        bk = run.buckets[bi]
        j = int(np.argmax(bk.n_real))

        def loss_and_backward():
            run.net.zero_grad(set_to_none=True)
            conv, _ = soft_conv_loss(run.net, bk.As[j], bk.k, run.tvs[bi][j], run.cfg,
                                     pad=bk.pad(j), colors=bk.colors[j], num_colors=bk.num_colors)
            conv.backward()

        grads = []
        for _ in range(2):
            loss_and_backward()
            grads.append(torch.cat([p.grad.reshape(-1) for p in run.net.parameters()
                                    if p.grad is not None]).cpu())
        out["largest_grid"] = {
            "n": bk.pad(j)[0], "n_pad": bk.As[j].shape[0], "k": bk.k,
            "ms_loss_and_backward": cuda_ms(loss_and_backward, iters=3, warmup=1),
            "repeat_grad_identical": bool(torch.equal(grads[0], grads[1])),
            "repeat_grad_max_abs_diff": float((grads[0] - grads[1]).abs().max()),
            "trace": device_trace(loss_and_backward, iters=1, kernel="index"),
        }

    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= TRAIN_SECONDS,
          f"train phase took {out['seconds_phase']:.1f} s (limit {TRAIN_SECONDS} s)")
    return out, launches


def _ga_reference_cpu(argv: list) -> dict:
    """Generation 0's per-grid convs of the GA phase's first bucket on the
    CPU (run in a worker process)."""
    from mlamg_torch.cli import train_dataset
    from mlamg_torch.train import bucketed_convs, population_convs

    _cpu_worker_setup()
    t0 = time.time()
    run = train_dataset.prepare(train_dataset.parse_args([*argv, "--device", "cpu"]),
                                log=lambda *_: None)
    pop = run.ga.population.copy()
    convs = population_convs(run.net, pop,
                             lambda m: bucketed_convs(m, run.train_buckets[:1], run.opts))
    run.writer.close()
    return dict(population=pop, convs=convs, seconds=time.time() - t0)


def ga_phase() -> tuple[dict, dict]:
    """The GA (phase 10 of the module docstring).  Returns the phase's line
    and the CUDA kernels' launches on its path; a failed check prints what
    the phase measured so far to stderr."""
    out: dict = {"phase": "ga"}
    try:
        return _ga_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _ga_phase(out: dict) -> tuple[dict, dict]:
    import torch
    from mlamg_torch.cli import train_dataset
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.convert import fullaggnet_from_params
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.ga import flatten_params
    from mlamg_torch.utils.profiler import LAUNCHES
    from mlamg_torch.train import bucketed_convs, measured_conv
    from mlamg_torch.utils.checkpoint import load_checkpoint
    from mlamg_torch.utils.profiler import Profiler

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    cache_path = f"{TRAIN_DATA}/train/.ref_convs_olson.json"
    with open(cache_path) as f:
        cache_text = f.read()
    with (tempfile.TemporaryDirectory() as tmp,
          multiprocessing.get_context("spawn").Pool(1) as pool):
        argv = [TRAIN_DATA, *GA_ARGS]
        cpu_job = pool.apply_async(_ga_reference_cpu, (
            [*argv, "--checkpoint-dir", f"{tmp}/cpu", "--metrics-dir", f"{tmp}/cpu/runs"],))
        args = train_dataset.parse_args([*argv, "--device", "cuda", "--checkpoint-dir",
                                         f"{tmp}/ck", "--metrics-dir", f"{tmp}/runs"])
        lines: list = []
        Profiler.reset()

        # --- the main path: counts set to 0 just before, read just after ---
        LAUNCHES.clear()
        t0 = time.time()
        run = train_dataset.prepare(args, log=lines.append)
        torch.cuda.synchronize()
        out["seconds_prepare"] = time.time() - t0
        pop0 = run.ga.population.copy()
        t0 = time.time()
        run.ga.compute_fitness()
        out["seconds_generation_0"] = time.time() - t0
        gen0_convs = run.fitness.last_convs.copy()
        t0 = time.time()
        res = train_dataset.train(run, log=lines.append)
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in KERNELS}
        out["seconds_train"] = time.time() - t0
        # ---------------------------------------------------------------------

        check(not any(launches[k] for k in SPMV_KERNELS),
              f"GA path launched CUDA kernels: {launches}")
        reports = res["reports"]
        out.update(launches=launches, lines=lines,
                   seconds_per_individual=out["seconds_generation_0"] / len(pop0),
                   seconds_per_generation=res["seconds_per_generation"],
                   train_losses=[r["train_loss"] for r in reports],
                   test_loss_best=reports[-1]["test_loss"],
                   profiler={k: [v[0], v[1]] for k, v in Profiler.tree().items()})
        check(len(run.train_buckets) == TRAIN_BUCKETS, f"{len(run.train_buckets)} train buckets")

        # the reference convs: the committed cache's, read and never written
        with open(cache_path) as f:
            committed = json.load(f)
        names = [g.extra["filename"].rsplit("/", 1)[-1] for g in Grid.load_dir(
            f"{TRAIN_DATA}/train")]
        ref_gap = max(abs(b.ref_conv - committed["convs"][nm]) for b, nm in zip(run.train, names))
        out["ref_conv_max_abs_gap"] = ref_gap
        check(ref_gap <= REF_CONV_TOL, f"GA reference convs differ from the cache by {ref_gap}")
        with open(cache_path) as f:
            check(f.read() == cache_text, "the committed reference cache changed")
        check(not any(n.startswith(".ref_convs") for n in os.listdir(f"{tmp}/ck")),
              "the GA measured reference convs instead of reading the cache")

        # the start: row 0 the checkpoint's weights, 3 folds
        start = flatten_params(fullaggnet_from_params(
            load_checkpoint(TRAIN_START)["best_params"], run.net_config, device="cpu"))[0].numpy()
        check(np.array_equal(pop0[0], start), "population row 0 is not the checkpoint's weights")
        check(len(run.fold_names) == GA_FOLDS, f"folds: {run.fold_names}")
        out.update(weights=int(pop0.shape[1]), folds=run.fold_names)

        # elitism: the train loss never rises
        losses = out["train_losses"]
        check(all(b <= a for a, b in zip(losses, losses[1:])), f"train loss rose: {losses}")

        # the checkpoint written at the end holds the GA's state
        ck = load_checkpoint(reports[-1]["checkpoint"])
        for k in ("population", "fitness", "key"):
            check(np.array_equal(np.asarray(ck[k]), np.asarray(getattr(run.ga, k))),
                  f"checkpoint {k} differs from the GA's")
        check(ck["sigma"] == run.ga.sigma, f"checkpoint sigma {ck['sigma']} != {run.ga.sigma}")

        # its best_params through evaluate_dataset's loader, on a test grid,
        # give the conv the GA measured for them
        tb = run.test_buckets[0]
        net2, _ = load_model(reports[-1]["checkpoint"], Grid.load_dir(f"{TRAIN_DATA}/test"),
                             device="cuda")
        with torch.no_grad():
            P = net2(tb.As[0], tb.k, pad=tb.pad(0))[1]
            conv = measured_conv(tb.As[0], P, tb.x0[0], run.opts, colors=tb.colors[0],
                                 num_colors=tb.num_colors)
        measured = float(run.test_fitness.last_convs[0, 0])
        out["round_trip_convs"] = [conv, measured]
        check(conv == measured and np.isfinite(conv), f"round trip: {conv} vs {measured}")

        # one individual's fitness on the larger bucket: time and trace
        big = max(run.train_buckets, key=lambda b: b.As[0].shape[0])
        t0 = time.time()
        with torch.no_grad():
            fit_big = partial(bucketed_convs, run.net, [big], run.opts)
            out["larger_bucket"] = {
                "grids": len(big.As), "n_pad": big.As[0].shape[0], "k": big.k,
                "ms_per_individual": cuda_ms(fit_big, iters=1, warmup=0),
                "trace": device_trace(fit_big, iters=1, kernel="spmv", warmup=False, cpu=False),
            }
        out["seconds_larger_bucket"] = time.time() - t0

        # generation 0 on the CPU, computed beside the card's work
        cpu = cpu_job.get(timeout=GA_SECONDS * 4)
        check(np.array_equal(cpu["population"], pop0), "CPU worker drew another population")
        n_cpu = cpu["convs"].shape[1]
        check(n_cpu == GA_CPU_GRIDS, f"first bucket holds {n_cpu} grids")
        card = gen0_convs[:, :n_cpu]
        gap = float(np.abs(card - cpu["convs"]).max())
        refs = np.asarray([run.train[i].ref_conv for i in run.train_buckets[0].idx])
        order = [np.argsort((c / refs[None, :]).mean(1), kind="stable").tolist()
                 for c in (card, cpu["convs"])]
        out.update(cpu_seconds=cpu["seconds"], cpu_max_abs_gap=gap,
                   cpu_same_fitness_order=order[0] == order[1], fitness_order=order)
        check(gap <= EVAL_CPU_TOL, f"GA generation 0: card and CPU convs differ by {gap}")

    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= GA_SECONDS,
          f"GA phase took {out['seconds_phase']:.1f} s (limit {GA_SECONDS} s)")
    return out, launches


def _pinned(A):
    """A with dof 0 pinned: ``train_cf_interp``'s pressure Laplacian."""
    import scipy.sparse as sp

    A = A.tolil()
    A[0, :] = 0.0
    A[:, 0] = 0.0
    A[0, 0] = 1.0
    return sp.csr_matrix(A)


def _ns_small_runs(device: str, float64: bool) -> dict:
    """NS_SMALL through ``solve_ns.main`` on ``device``: per run n_u and,
    per step, the iterations, the float64 residual over |b| and the
    solution."""
    from mlamg_torch.cli import solve_ns

    out = {}
    for pc, args in NS_SMALL.items():
        argv = [*args, "--device", device] + (["--float64"] if float64 else [])
        r = solve_ns.main(argv, log=lambda *_: None)
        out[pc] = dict(iters=[st["iters"] for st in r["steps"]],
                       res=[st["res"] / np.linalg.norm(st["b"].astype(np.float64))
                            for st in r["steps"]],
                       x=[st["x"].astype(np.float64) for st in r["steps"]],
                       n_u=r["system"].n_u)
    return out


def _ns_reference_cpu() -> dict:
    """The card-against-CPU runs of the ns phase on the CPU (a worker)."""
    _cpu_worker_setup()
    t0 = time.time()
    out = {"f64": _ns_small_runs("cpu", True), "f32": _ns_small_runs("cpu", False)}
    out["seconds"] = time.time() - t0
    return out


def _flow_gap(a, b, n_u: int) -> float:
    """max |a - b| / max |b| over the velocity and the mean-free pressure
    (an enclosed flow fixes the pressure up to a constant)."""
    def canon(x):
        return np.concatenate([x[:n_u], x[n_u:] - x[n_u:].mean()])

    a, b = canon(a), canon(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ns_card_vs_cpu(card: dict, cpu: dict, bounds: dict) -> tuple[dict, list]:
    """Per preconditioner: both devices' iterations and float64 residuals
    per step and the largest solution gap.  ``bounds[pc]`` is (iteration
    band, solution rtol), or None where only convergence is held: each
    step below NS_MAX_ITERS with a float64 residual within NS_RES_FACTOR x
    tol on both devices.  Returns the readings and the failed checks."""
    out, failed = {}, []
    for pc in NS_SMALL:
        a, b = card[pc], cpu[pc]
        gap = max(_flow_gap(x, y, a["n_u"]) for x, y in zip(a["x"], b["x"]))
        out[pc] = {"iters_card": a["iters"], "iters_cpu": b["iters"], "gap": gap,
                   "res_card": a["res"], "res_cpu": b["res"]}
        ok = all(i < NS_MAX_ITERS for i in a["iters"] + b["iters"]) and all(
            r <= NS_RES_FACTOR * NS_TOL for r in a["res"] + b["res"])
        if bounds[pc] is not None:
            band, rtol = bounds[pc]
            ok = ok and gap <= rtol and all(
                abs(i - j) <= band for i, j in zip(a["iters"], b["iters"]))
        if not ok:
            failed.append(f"{pc}: {out[pc]}")
    return out, failed


def ns_phase() -> tuple[dict, dict]:
    """The Navier-Stokes deployment (phase 11 of the module docstring).
    Returns the phase's line and the CUDA kernels' launches on its path; a
    failed check prints what the phase measured so far to stderr."""
    out: dict = {"phase": "ns"}
    try:
        return _ns_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _ns_phase(out: dict) -> tuple[dict, dict]:
    import torch
    from mlamg_torch.cli import solve_ns
    from mlamg_torch.data.stokes import lid_driven_cavity
    from mlamg_torch.deploy import LearnedAMGPreconditioner, Options, SchurFieldsplitSolver
    from mlamg_torch.deploy.fieldsplit import _CallableOp
    from mlamg_torch.mg.krylov import fgmres
    from mlamg_torch.utils.profiler import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    with open(NS_CF_JSON) as f:
        ref = json.load(f)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu_job = pool.apply_async(_ns_reference_cpu)

        # --- train_cf_interp's pressure solves and Schur round trip, in its
        # float64 (float32 stalls at tol 1e-8: printed, not checked) ---
        t0 = time.time()
        opts = {"mlamg_amg_rtol": 0.0, "mlamg_max_iter": 2, "mlamg_greedy_theta": 0.56}
        learned_opts = Options(dict(opts, mlamg_pnet_model=NS_CKPT))
        out["pressure_solves"] = []
        for row in ref["pressure_solves"]:
            A = _pinned(lid_driven_cavity(n=row["n_res"], Re=10.0).Ap)
            got = {"n_res": row["n_res"]}
            for dtype, tag in ((torch.float64, ""), (torch.float32, "_f32")):
                pcs = {"learned": LearnedAMGPreconditioner(A, learned_opts, dtype=dtype,
                                                           device="cuda"),
                       "classical": LearnedAMGPreconditioner(A, Options(opts), dtype=dtype,
                                                             device="cuda")}
                for name, pc in pcs.items():
                    its = [fgmres(pc.A, torch.from_numpy(np.random.RandomState(1000 + sd).randn(
                        A.shape[0])).to("cuda", dtype), M=pc, tol=1e-8)[2] for sd in range(5)]
                    got[f"{name}{tag}"] = float(np.mean(its))
            out["pressure_solves"].append(got)
            for name in ("learned", "classical"):
                want = row[f"fgmres_{name}_mean"]
                check(abs(got[name] - want) <= NS_MEAN_TOL,
                      f"pressure solve n {row['n_res']}: {name} mean {got[name]} vs {want}")
            check(got["learned"] < got["classical"],
                  f"pressure solve n {row['n_res']}: learned {got['learned']} not below "
                  f"classical {got['classical']}")
        s = lid_driven_cavity(n=ref["eval_size"], Re=10.0, dt=0.05)
        A = _pinned(s.Ap)
        out["schur_round_trip"] = {}
        for name, o in (("learned", learned_opts), ("classical", Options(opts))):
            pc = LearnedAMGPreconditioner(A, o, dtype=torch.float64, device="cuda")
            x, _, iters = SchurFieldsplitSolver(s, pc, dtype=torch.float64,
                                                device="cuda").solve(tol=1e-8)
            res = float(np.linalg.norm(s.saddle_matrix() @ x.cpu().numpy() - s.rhs()))
            want = ref[f"fgmres_iters_{name}"]
            out["schur_round_trip"][name] = {"iters": iters, "json_iters": want, "res": res}
            check(abs(iters - want) <= NS_SCHUR_ITER_TOL and res < NS_SCHUR_RES,
                  f"Schur round trip {name}: {iters} iterations (JSON {want}), residual {res}")
        out["seconds_pressure"] = time.time() - t0

        # each preconditioner's apply, card against CPU, where it is well
        # posed: on the pinned Laplacian (PCDR on the system itself)
        from mlamg_torch.deploy import PCDRPreconditioner, SAPreconditioner

        v = np.random.RandomState(7).randn(s.n_p)
        out["apply_card_vs_cpu"] = {}
        for name, make in (
                ("pcdr", lambda d: PCDRPreconditioner(s, dtype=torch.float64, device=d)),
                ("sa", lambda d: SAPreconditioner(A, Options({"pyamg_alpha": 0.2}),
                                                  dtype=torch.float64, device=d)),
                ("mlamg", lambda d: LearnedAMGPreconditioner(
                    A, Options(dict(opts, mlamg_max_iter=4)), dtype=torch.float64, device=d)),
                ("mlamg_net", lambda d: LearnedAMGPreconditioner(
                    A, Options(dict(opts, mlamg_max_iter=4, mlamg_pnet_model=NS_CKPT)),
                    dtype=torch.float64, device=d))):
            y = [make(d)(torch.from_numpy(v).to(d)).cpu().numpy() for d in ("cuda", "cpu")]
            gap = float(np.abs(y[0] - y[1]).max() / np.abs(y[1]).max())
            out["apply_card_vs_cpu"][name] = gap
            check(gap <= NS_APPLY_RTOL, f"{name} apply: card and CPU differ by {gap}")

        # --- the main path: counts set to 0 just before, read just after ---
        LAUNCHES.clear()
        runs = {}
        for name, args in NS_FULL.items():
            runs[name] = solve_ns.main([*args, *NS_STEP, "--device", "cuda"],
                                       log=lambda *_: None)
            torch.cuda.synchronize()
            if name != "cavity128_pcdr":  # only that one is traced below
                runs[name]["solver"] = None
        launches = {k: LAUNCHES[k] for k in KERNELS}
        # ---------------------------------------------------------------------

        out["launches"] = launches
        out["full"], failed = {}, []
        for name, r in runs.items():
            steps = []
            for st in r["steps"]:
                bnorm = float(np.linalg.norm(st["b"].astype(np.float64)))
                res, est = st["res"] / bnorm, st["fgmres_res"] / bnorm
                steps.append({"iters": st["iters"], "seconds": st["seconds"],
                              "res_f64": res, "res_fgmres": est,
                              "ms_per_iteration": 1e3 * st["seconds"] / max(st["iters"], 1)})
                if not (st["iters"] < NS_MAX_ITERS and np.isfinite(st["x"]).all()
                        and res <= NS_RES_FACTOR * max(est, NS_TOL)
                        and est <= NS_RES_FACTOR * res and res <= NS_RES_FACTOR * NS_TOL):
                    failed.append(f"{name}: {steps[-1]}")
            sysm = r["system"]
            out["full"][name] = {"n_u": sysm.n_u, "n_p": sysm.n_p, "setup_s": r["setup_s"],
                                 "steps": steps}

        # ms per FGMRES iteration by CUDA events (step 0 solved again), and a
        # trace of one FGMRES iteration of the cavity-128 PCDR solve
        r = runs["cavity128_pcdr"]
        solver = r["solver"]
        b0 = torch.from_numpy(r["steps"][0]["b"]).to("cuda")
        iters0 = r["steps"][0]["iters"]
        out["cavity128_pcdr_ms_per_iteration_events"] = cuda_ms(
            lambda: solver.solve(b0, tol=NS_TOL), iters=1, warmup=0) / iters0
        op = _CallableOp(solver.matvec, solver.n_u + solver.n_p)
        out["cavity128_pcdr_iteration_trace"] = device_trace(
            lambda: fgmres(op, b0, M=solver.preconditioner, restart=1, max_restarts=1,
                           tol=NS_TOL), iters=1, kernel="trs")
        del runs, solver, r
        torch.cuda.empty_cache()

        # --- card against CPU, cavity n 32: float64, then float32 ---
        t0 = time.time()
        card64 = _ns_small_runs("cuda", True)
        card32 = _ns_small_runs("cuda", False)
        out["seconds_card_small"] = time.time() - t0
        cpu = cpu_job.get(timeout=NS_SECONDS * 4)
        out["cpu_seconds"] = cpu["seconds"]
        out["f64"], failed64 = _ns_card_vs_cpu(card64, cpu["f64"], dict(
            pcdr=(0, NS_F64_RTOL), sa=(0, NS_SINGULAR_RTOL), mlamg=(0, NS_SINGULAR_RTOL)))
        out["f32"], failed32 = _ns_card_vs_cpu(card32, cpu["f32"], dict(
            pcdr=(NS_F32_ITER_BAND, NS_F32_RTOL), sa=None, mlamg=None))

    check(not any(launches[k] for k in SPMV_KERNELS),
          f"ns path launched CUDA kernels: {launches}")
    check(not failed, f"ns full-width steps: {failed}")
    check(not failed64, f"ns card vs CPU, float64: {failed64}")
    check(not failed32, f"ns card vs CPU, float32: {failed32}")
    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= NS_SECONDS,
          f"ns phase took {out['seconds_phase']:.1f} s (limit {NS_SECONDS} s)")
    return out, launches


def _tools_reference_cpu() -> dict:
    """The tools phase's CPU side (a worker): the samples of the first
    grids, evaluate_model and optimize_grid_param."""
    from mlamg_torch.cli import evaluate_model, optimize_grid_param, train_convergence
    from mlamg_torch.data.grid import Grid

    _cpu_worker_setup()
    t0 = time.time()
    grids = Grid.load_dir(TOOLS_CONV_ARGS[0])[:TOOLS_CONV_CPU_GRIDS]
    aggs: list = []
    samples = train_convergence.build_samples(grids, 0.1, int(TOOLS_CONV_ARGS[2]), seed=0,
                                              device="cpu", aggs=aggs)
    out = {"features": [f.numpy() for _, f, _ in samples],
           "labels": [label for _, _, label in samples], "aggs": aggs}
    out["evaluate"] = evaluate_model.main([*TOOLS_EVAL_ARGS, "--device", "cpu"],
                                          log=lambda *_: None)
    out["optimize"] = optimize_grid_param.main([*TOOLS_OPT_ARGS, "--device", "cpu"],
                                               log=lambda *_: None)
    out["seconds"] = time.time() - t0
    return out


def _tools_cf_last_cpu() -> list:
    """train_cf_interp's training on the CPU (a worker): the last epoch's
    losses."""
    from mlamg_torch.cli import train_cf_interp

    _cpu_worker_setup()
    args = train_cf_interp.parse_args([*TOOLS_CF_ARGS, "--device", "cpu"])
    run = train_cf_interp.prepare(args)
    last = []
    for _ in range(args.epochs):
        last = [run.step(i) for i in range(len(run.train))]
    return last


def _tools_conv_epoch_cpu(cache: str) -> dict:
    """The first train_convergence epoch on the CPU from the card's sample
    cache (a worker)."""
    from mlamg_torch.cli import train_convergence

    _cpu_worker_setup()
    record: dict = {}
    argv = [*TOOLS_CONV_ARGS[:-1], "1", "--cache-samples", cache, "--device", "cpu"]
    train_convergence.main(argv, log=lambda *_: None, record=record)
    return {"train_mse": record["train_mse"][0], "seconds": record["seconds_per_epoch"][0]}


def tools_phase() -> tuple[dict, dict]:
    """The remaining trainers and tools (phase 13 of the module docstring).
    Returns the phase's line and the CUDA kernels' launches on its path; a
    failed check prints what the phase measured so far to stderr."""
    out: dict = {"phase": "tools"}
    try:
        return _tools_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _tools_phase(out: dict) -> tuple[dict, dict]:
    import filecmp

    import torch
    from mlamg_torch.cli import (create_data, evaluate_model, optimize_grid_param, solve_ns,
                                 train_cf_interp, train_convergence)
    from mlamg_torch.utils.profiler import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    quiet = lambda *_: None  # noqa: E731
    with open(NS_CF_JSON) as f:
        ref = json.load(f)
    with open(TOOLS_CONV_JSON) as f:
        conv_ref = json.load(f)
    with (tempfile.TemporaryDirectory() as tmp,
          multiprocessing.get_context("spawn").Pool(1) as pool):
        cf_cpu_job = pool.apply_async(_tools_cf_last_cpu)
        cpu_job = pool.apply_async(_tools_reference_cpu)
        ckpt, cache = f"{tmp}/cf.ckpt", f"{tmp}/samples.npz"
        cf_rec, conv_rec = {}, {}

        # --- the main path: counts set to 0 just before, read just after ---
        LAUNCHES.clear()
        t0 = time.time()
        cf = train_cf_interp.main([*TOOLS_CF_ARGS, "--checkpoint", ckpt, "--out", f"{tmp}/cf.json",
                                   "--device", "cuda"], log=quiet, record=cf_rec)
        out["cf_seconds"] = time.time() - t0
        t0 = time.time()
        deploy = solve_ns.main([*TOOLS_DEPLOY, "--pnet-model", ckpt, "--device", "cuda"], log=quiet)
        out["deploy_seconds"] = time.time() - t0
        t0 = time.time()
        conv = train_convergence.main([*TOOLS_CONV_ARGS, "--cache-samples", cache,
                                       "--device", "cuda"], log=quiet, record=conv_rec)
        out["conv_seconds"] = time.time() - t0
        conv_cpu_job = pool.apply_async(_tools_conv_epoch_cpu, (cache,))
        t0 = time.time()
        ev = evaluate_model.main([*TOOLS_EVAL_ARGS, "--device", "cuda"], log=quiet)
        out["evaluate_seconds"] = time.time() - t0
        opt = optimize_grid_param.main([*TOOLS_OPT_ARGS, "--device", "cuda"], log=quiet)
        t0 = time.time()
        written = create_data.main([f"{tmp}/data", *TOOLS_DATA_ARGS, "--device", "cuda"],
                                   log=quiet)
        out["create_data_seconds"] = time.time() - t0
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in KERNELS}
        # ---------------------------------------------------------------------
        out["launches"] = launches

        # train_cf_interp against its committed JSON
        first = [_rel(a, b) for a, b in zip(cf["train_loss_first_epoch"],
                                             ref["train_loss_first_epoch"])]
        last = [_rel(a, b) for a, b in zip(cf["train_loss_last_epoch"],
                                            ref["train_loss_last_epoch"])]
        out["cf"] = {"first_epoch": cf["train_loss_first_epoch"], "first_epoch_gaps": first,
                     "last_epoch": cf["train_loss_last_epoch"], "last_epoch_gaps": last,
                     "seconds_per_epoch": float(np.mean(cf_rec["seconds_per_epoch"])),
                     "seconds_first_epoch": cf_rec["seconds_per_epoch"][0],
                     "seconds_eval": cf_rec["seconds_eval"],
                     "pressure": [[r["n_res"], r["fgmres_learned_mean"], r["fgmres_classical_mean"]]
                                  for r in cf["pressure_solves"]],
                     "schur": [cf["fgmres_iters_learned"], cf["fgmres_iters_classical"],
                               cf["resid_learned"], cf["resid_classical"]]}
        check(len(first) == 3 and max(first) <= TOOLS_CF_FIRST_RTOL,
              f"train_cf_interp first epoch: {out['cf']['first_epoch']} vs "
              f"{ref['train_loss_first_epoch']}")
        check(max(last) <= TOOLS_CF_LAST_RTOL,
              f"train_cf_interp last epoch: gaps {last} (bound {TOOLS_CF_LAST_RTOL})")
        cf_cpu = cf_cpu_job.get(timeout=TOOLS_SECONDS * 4)
        out["cf"]["last_epoch_cpu"] = cf_cpu
        out["cf"]["last_epoch_card_vs_cpu"] = [
            _rel(a, b) for a, b in zip(cf["train_loss_last_epoch"], cf_cpu)]
        check(max(out["cf"]["last_epoch_card_vs_cpu"]) <= TOOLS_CF_DEVICE_RTOL,
              f"train_cf_interp last epoch, card vs CPU: {out['cf']['last_epoch_card_vs_cpu']}")
        for got, want in zip(cf["pressure_solves"], ref["pressure_solves"]):
            for name in ("learned", "classical"):
                g, w = got[f"fgmres_{name}_mean"], want[f"fgmres_{name}_mean"]
                check(abs(g - w) <= NS_MEAN_TOL,
                      f"card-trained pressure solve n {got['n_res']}: {name} {g} vs {w}")
            check(got["fgmres_learned_mean"] < got["fgmres_classical_mean"],
                  f"card-trained pressure solve n {got['n_res']}: learned not below classical")
        for name in ("learned", "classical"):
            it, want = cf[f"fgmres_iters_{name}"], ref[f"fgmres_iters_{name}"]
            check(abs(it - want) <= NS_SCHUR_ITER_TOL and cf[f"resid_{name}"] < NS_SCHUR_RES,
                  f"card-trained Schur round trip {name}: {it} (JSON {want}), "
                  f"residual {cf[f'resid_{name}']}")

        # the card-trained checkpoint deployed
        out["deploy"] = []
        for st in deploy["steps"]:
            res = st["res"] / float(np.linalg.norm(st["b"].astype(np.float64)))
            out["deploy"].append({"iters": st["iters"], "res_f64": res, "seconds": st["seconds"]})
            check(st["iters"] < NS_MAX_ITERS and res <= NS_RES_FACTOR * NS_TOL,
                  f"deployed card-trained checkpoint: {out['deploy'][-1]}")

        # the remaining checks against the CPU worker
        cpu = cpu_job.get(timeout=TOOLS_SECONDS * 4)
        cpu_epoch = conv_cpu_job.get(timeout=TOOLS_SECONDS * 4)
        out["cpu_seconds"] = cpu["seconds"] + cpu_epoch["seconds"]
        m = len(cpu["labels"])
        feat_gap = max(float(np.abs(a - b).max())
                       for a, b in zip(conv_rec["features"][:m], cpu["features"]))
        label_gaps = [abs(a - b) for a, b in zip(conv_rec["labels"][:m], cpu["labels"])]
        agg_differ = sum(int((a != b).any()) for a, b in zip(conv_rec["aggs"][:m], cpu["aggs"]))
        mse_gap = _rel(conv_rec["train_mse"][0], cpu_epoch["train_mse"])
        out["conv"] = {"samples": len(conv_rec["labels"]), "cpu_samples": m,
                       "feature_gap": feat_gap, "label_gap": max(label_gaps),
                       "samples_with_other_aggregates": agg_differ,
                       "first_epoch_mse": [conv_rec["train_mse"][0], cpu_epoch["train_mse"]],
                       "first_epoch_mse_gap": mse_gap, "train_mse": conv_rec["train_mse"],
                       "seconds_samples": conv_rec["seconds_samples"],
                       "seconds_per_epoch": float(np.mean(conv_rec["seconds_per_epoch"])),
                       "cpu_seconds_epoch": cpu_epoch["seconds"],
                       "val_corr": conv["val_corr"], "test_corr": conv["test_corr"],
                       "committed_test_corr": conv_ref["test_corr"],
                       "n_train_val_test": [conv["n_train"], conv["n_val"], conv["n_test"]]}
        check(feat_gap <= TOOLS_FEATURE_TOL, f"train_convergence features: {out['conv']}")
        check(max(label_gaps) <= EVAL_CPU_TOL, f"train_convergence labels: {out['conv']}")
        check(mse_gap <= TOOLS_CONV_MSE_RTOL, f"train_convergence first epoch: {out['conv']}")

        out["evaluate"] = {k: [ev[k], cpu["evaluate"][k]]
                           for k in ("lloyd_conv", "random_conv", "ml_conv")}
        out["evaluate"]["connected"] = [ev["connected"], cpu["evaluate"]["connected"]]
        check(all(abs(a - b) <= EVAL_CPU_TOL for a, b in (out["evaluate"][k] for k in (
            "lloyd_conv", "random_conv", "ml_conv"))) and ev["connected"] == cpu["evaluate"][
            "connected"], f"evaluate_model card vs CPU: {out['evaluate']}")

        seed_gap = float(np.abs(opt["seed_convs"] - cpu["optimize"]["seed_convs"]).max())
        convs = [float(c) for c in opt["convs"]]
        out["optimize"] = {"convs": convs, "cpu_convs": [float(c) for c in cpu["optimize"]["convs"]],
                           "seed_conv_gap": seed_gap,
                           "seconds_per_generation": opt["seconds_per_generation"]}
        check(seed_gap <= EVAL_CPU_TOL, f"optimize_grid_param generation 0: {out['optimize']}")
        check(all(b <= a for a, b in zip(convs, convs[1:])),
              f"optimize_grid_param best conv rose: {convs}")

        rel = [os.path.relpath(p, f"{tmp}/data") for p in written]
        out["create_data"] = {"files": len(rel), "differ_from_committed": sum(
            not filecmp.cmp(os.path.join(tmp, "data", r), os.path.join(TOOLS_DATA_DIR, r),
                            shallow=False) for r in rel)}

        # a trace of one Adam step of train_cf_interp (last: a profiler
        # session slows every later launch of its process)
        run = train_cf_interp.prepare(train_cf_interp.parse_args(["--device", "cuda"]))
        out["cf_step_ms_events"] = cuda_ms(lambda: run.step(0), iters=3, warmup=1)
        out["cf_step_trace"] = device_trace(lambda: run.step(0), iters=1, kernel="nextafter")

    check(not any(launches[k] for k in SPMV_KERNELS),
          f"tools path launched CUDA kernels: {launches}")
    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= TOOLS_SECONDS,
          f"tools phase took {out['seconds_phase']:.1f} s (limit {TOOLS_SECONDS} s)")
    return out, launches


def _dist_small(device: str, mesh) -> dict:
    """The small float64 parity runs of the dist phase on ``mesh`` (8 row
    shards on ``device``): the distributed two-level solve, both modes of
    the distributed V-cycle solve, pspmv and pspmv_halo, pbf (symmetric
    and directed) and plloyd, each beside its serial counterpart on the
    same device.  Returns host arrays and numbers."""
    import scipy.sparse as sp
    import torch
    from mlamg_torch import parallel as par
    from mlamg_torch.cli.weak_scaling import banded_poisson, box_aggregates
    from mlamg_torch.graph.bellman_ford import bellman_ford
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.mg.coarse import CoarseSolver
    from mlamg_torch.mg.cycle import Hierarchy, twolevel_solve, vcycle_solve
    from mlamg_torch.mg.interp import sa_interpolation_dense
    from mlamg_torch.ops import matmul
    from mlamg_torch.ops.sparse import CSR

    f64, nx = torch.float64, DIST_SMALL_NX
    rng = np.random.RandomState(0)
    A = banded_poisson(nx, nx)
    n = A.shape[0]
    Ac = CSR.from_scipy(A, dtype=f64, device=device)
    agg0 = torch.from_numpy(box_aggregates(nx, nx, 2)).to(device)
    P0 = sa_interpolation_dense(Ac, agg0, int(agg0.max()) + 1, omega=0.65)
    A1 = matmul.rap_dense(Ac, P0)
    agg1 = torch.from_numpy(box_aggregates(nx // 2, nx // 2, 2)).to(device)
    T1 = (agg1[:, None] == torch.arange(int(agg1.max()) + 1, device=device)).to(f64)
    Dinv1 = 1.0 / torch.diagonal(A1)
    P1 = T1 - 0.65 * Dinv1[:, None] * (A1 @ T1)
    coarse = CoarseSolver.factor(P1.T @ A1 @ P1)
    h_coarse = Hierarchy((A1,), (P1,), (Dinv1,), coarse)
    h_full = Hierarchy((Ac, A1), (P0, P1), (1.0 / Ac.diagonal(), Dinv1), coarse)
    x0 = rng.randn(n)
    x0 /= np.linalg.norm(x0)
    x0_t, zero = torch.from_numpy(x0).to(device), torch.zeros(n, dtype=f64, device=device)
    Ap = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=f64, device=device)
    out: dict = {}

    def solved(res):
        x, conv, err, iters = res
        return {"x": par.gather_global(x).ravel()[:n], "conv": conv,
                "err": err.cpu().numpy(), "iters": iters}

    out["twolevel"] = solved(par.ptwolevel_solve(Ap, P0, zero, x0_t, mesh, res_tol=1e-8))
    out["pvcycle_two_level"] = solved(par.pvcycle_solve(Ap, P0, None, zero, x0_t, mesh,
                                                        res_tol=1e-8, max_iter=300))
    out["pvcycle_multilevel"] = solved(par.pvcycle_solve(Ap, P0, h_coarse, zero, x0_t, mesh,
                                                         res_tol=1e-8))
    _, conv, _, iters = twolevel_solve(Ac, P0, zero, x0_t, res_tol=1e-8, max_iter=300)
    out["twolevel_serial"] = {"conv": conv, "iters": iters}
    _, conv, _, iters = vcycle_solve(h_full, zero, x0_t, res_tol=1e-8, max_iter=200)
    out["vcycle_serial"] = {"conv": conv, "iters": iters}

    x = rng.randn(n)
    Ag = par.PartitionedELL.from_scipy(A, 8, dtype=f64, device=device)
    out["spmv_err"] = float(np.abs(par.gather_global(par.pspmv(Ag, Ag.shard_x(x, mesh), mesh))
                                   .ravel()[:n] - A @ x).max())
    out["spmv_halo_err"] = float(np.abs(par.gather_global(par.pspmv_halo(
        Ap, Ap.shard_x(x, mesh), mesh)).ravel()[:n] - A @ x).max())

    m = 64
    lo = rng.rand(m - 1) + 0.1
    for name, up in (("pbf", lo), ("pbf_directed", rng.rand(m - 1) + 0.1)):
        C = sp.diags([lo, up], [-1, 1]).tocsr()
        centers = np.array([5, 40])
        cmask = np.zeros((8, 8), bool)
        cmask.ravel()[centers] = True
        dist, near = par.pbf(par.pbf_partition(C, 8, halo=1, device=device), cmask, mesh)
        d_ref, n_ref = bellman_ford(CSR.from_scipy(C, dtype=f64, device=device),
                                    torch.from_numpy(centers).to(device))
        out[name] = {"dist": par.gather_global(dist), "near": par.gather_global(near),
                     "serial_dist": d_ref.cpu().numpy(), "serial_near": n_ref.cpu().numpy()}

    G = abs(banded_poisson(12, 12))
    G.setdiag(0)
    G.eliminate_zeros()
    seeds = np.sort(rng.permutation(G.shape[0])[:12])
    agg, centers = par.plloyd(par.PartitionedELL.from_scipy(G, 8, halo=12, dtype=f64,
                                                            device=device), seeds, mesh, maxiter=4)
    agg_s, roots_s, _ = lloyd_aggregation(CSR.from_scipy(G, dtype=f64, device=device),
                                          seeds=seeds, maxiter=4)
    out["plloyd"] = {"agg": par.gather_global(agg).ravel()[:G.shape[0]],
                     "centers": centers.cpu().numpy(), "serial_agg": agg_s.cpu().numpy(),
                     "serial_roots": roots_s.cpu().numpy()}
    return out


def _check_dist_small(res: dict, where: str) -> None:
    """The small runs' checks against their serial counterparts."""
    for name, serial in (("twolevel", "twolevel_serial"), ("pvcycle_two_level", "twolevel_serial"),
                         ("pvcycle_multilevel", "vcycle_serial")):
        got, want = res[name], res[serial]
        check(got["iters"] == want["iters"] and abs(got["conv"] - want["conv"]) <= DIST_CONV_ATOL,
              f"{where} {name}: {got['iters']} iterations, conv {got['conv']} against the serial "
              f"{want['iters']}, {want['conv']}")
    check(max(res["spmv_err"], res["spmv_halo_err"]) <= DIST_SPMV_ATOL,
          f"{where} pspmv / pspmv_halo: {res['spmv_err']} / {res['spmv_halo_err']} from scipy")
    for name in ("pbf", "pbf_directed"):
        r = res[name]
        check(np.array_equal(r["dist"].ravel()[:64], r["serial_dist"])
              and np.array_equal(r["near"].ravel()[:64], r["serial_near"]),
              f"{where} {name} differs from the serial Bellman-Ford")
    r = res["plloyd"]
    check(np.array_equal(r["agg"], r["serial_agg"])
          and np.array_equal(np.sort(r["centers"]), np.sort(r["serial_roots"])),
          f"{where} plloyd differs from the serial Lloyd aggregation")


def _dist_same_bits(a: dict, b: dict) -> bool:
    """Two small runs equal bit for bit (solves, Bellman-Ford, Lloyd)."""
    for name in ("twolevel", "pvcycle_two_level", "pvcycle_multilevel"):
        x, y = a[name], b[name]
        if not (np.array_equal(x["x"], y["x"]) and np.array_equal(x["err"], y["err"])
                and x["conv"] == y["conv"] and x["iters"] == y["iters"]):
            return False
    return all(np.array_equal(a[k][f], b[k][f]) for k, f in
               (("pbf", "dist"), ("pbf", "near"), ("pbf_directed", "dist"),
                ("pbf_directed", "near"), ("plloyd", "agg"), ("plloyd", "centers")))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_phase() -> tuple[dict, dict]:
    """The distributed path (phase 14 of the module docstring).  Returns
    the phase's line and the CUDA kernels' launches on its path; a failed
    check prints what the phase measured so far to stderr."""
    out: dict = {"phase": "dist"}
    try:
        return _dist_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _dist_phase(out: dict) -> tuple[dict, dict]:
    import torch
    import torch.distributed as dist
    from mlamg_torch import parallel as par
    from mlamg_torch.cli import visualize, weak_scaling
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.ga import flatten_params, init_population
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.mg.coarse import CoarseSolver
    from mlamg_torch.mg.cycle import twolevel_solve
    from mlamg_torch.ops.sparse import CSR
    from mlamg_torch.utils.profiler import LAUNCHES
    from mlamg_torch.parallel import distributed
    from mlamg_torch.parallel.pcycle import DistributedCycle
    from mlamg_torch.train import GridBundle, SolveOptions, make_buckets
    from mlamg_torch.train import make_population_fitness_bucketed
    from mlamg_torch.utils import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)
    t_phase = time.time()
    quiet = lambda *_: None  # noqa: E731
    LAUNCHES.clear()

    # --- small float64 parity: 8 virtual shards on the card, the serial
    # solves on the card, the same runs on the CPU ---
    t0 = time.time()
    card = _dist_small("cuda", par.make_mesh(pop=1, row=8, devices=["cuda"] * 8))
    _check_dist_small(card, "card")
    cpu = _dist_small("cpu", par.make_mesh(pop=1, row=8, devices=["cpu"] * 8))
    _check_dist_small(cpu, "cpu")
    gaps = {name: abs(card[name]["conv"] - cpu[name]["conv"])
            for name in ("twolevel", "pvcycle_two_level", "pvcycle_multilevel")}
    out["small"] = {"iters": {k: card[k]["iters"] for k in gaps}, "conv_card_vs_cpu": gaps,
                    "spmv_err": card["spmv_err"], "spmv_halo_err": card["spmv_halo_err"],
                    "seconds": time.time() - t0}
    check(max(gaps.values()) <= DIST_CONV_ATOL, f"small solves card vs CPU conv gaps {gaps}")

    # --- the same runs through torch.distributed: a world-size-1 NCCL group
    # holding the 8 shards, bit for bit the single-process run ---
    t0 = time.time()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    par.initialize(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                   local_device_count=8, device="cuda")
    try:
        out["nccl"] = {"backend": str(dist.get_backend()), "world_size": dist.get_world_size()}
        nccl = _dist_small("cuda", par.make_mesh(pop=1, row=8))
    finally:
        distributed.shutdown()
    out["nccl"]["seconds"] = time.time() - t0
    check("nccl" in out["nccl"]["backend"], f"the process group's backend: {out['nccl']}")
    out["nccl"]["same_bits"] = _dist_same_bits(nccl, card)
    check(out["nccl"]["same_bits"], "the NCCL world-size-1 run differs from the single-process run")

    # --- weak scaling at the JAX CLI's defaults and at the card size ---
    t0 = time.time()
    for tag, argv in (("weak_default", WEAK_DEFAULT), ("weak_card", WEAK_CARD)):
        rows = weak_scaling.main([*argv, "--device", "cuda"], log=quiet)["rows"]
        check([r["shards"] for r in rows] == [1, 2, 4, 8]
              and all(np.isfinite([r["spmv_us_per_iter"], r["cycle_ms_per_iter"]]).all()
                      and r["spmv_us_per_iter"] > 0 and r["cycle_ms_per_iter"] > 0 for r in rows),
              f"{tag} rows: {rows}")
        out[tag] = rows
    out["weak_seconds"] = time.time() - t0

    # --- the S = 8 card-size solve in float32, against the serial solve
    # with the same P (its coarse operator formed with cuSPARSE) ---
    nx, ny, side = (int(WEAK_CARD[i]) for i in (1, 3, 5))
    S = 8
    A = weak_scaling.banded_poisson(nx, ny * S)
    n = A.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P, k = weak_scaling.box_prolongator(A, nx, ny * S, side, "cuda")
    mesh8 = par.make_mesh(pop=1, row=S, devices=["cuda"] * S)
    Ap = par.PartitionedELL.from_scipy(A, S, halo=nx, device="cuda")
    x0 = np.random.RandomState(0).randn(n).astype(np.float32)
    r0 = float(np.linalg.norm(A @ x0.astype(np.float64)))
    zero = torch.zeros(n, device="cuda")
    t0 = time.time()
    cycle = DistributedCycle(Ap, P, zero, mesh8)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    t0 = time.time()
    xs, conv, _, iters = cycle.solve(x0, DIST_CARD_RES * r0, 1000)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    x = par.gather_global(xs).ravel()[:n].astype(np.float64)
    rel = float(np.linalg.norm(A @ x)) / r0
    Acsr = torch.sparse_csr_tensor(torch.from_numpy(A.indptr.astype(np.int64)),
                                   torch.from_numpy(A.indices.astype(np.int64)),
                                   torch.from_numpy(A.data.astype(np.float32)), A.shape,
                                   device="cuda")
    coarse = CoarseSolver.factor(P.T @ (Acsr @ P))
    t0 = time.time()
    _, conv_s, _, iters_s = twolevel_solve(CSR.from_scipy(A, device="cuda"), P, zero,
                                           torch.from_numpy(x0).to("cuda"),
                                           res_tol=DIST_CARD_RES * r0, max_iter=1000,
                                           coarse=coarse)
    torch.cuda.synchronize()
    out["card_solve"] = {"n": n, "nnz": int(A.nnz), "k": k, "shards": S, "iters": iters,
                         "conv": conv, "serial_iters": iters_s, "serial_conv": conv_s,
                         "float64_rel_residual": rel, "setup_s": setup_s, "solve_s": solve_s,
                         "ms_per_cycle": solve_s / iters * 1e3,
                         "serial_s": time.time() - t0, "peak_gb": peak / 1e9}
    check(abs(conv - conv_s) <= DIST_CARD_CONV_ATOL and rel < DIST_CARD_RESIDUAL,
          f"card-size distributed solve: {out['card_solve']}")
    del Acsr, coarse

    # --- plloyd on the S = 8 strength graph against the serial Lloyd ---
    G = abs(A)
    G.setdiag(0)
    G.eliminate_zeros()
    seeds = np.sort(np.random.RandomState(0).choice(n, n // DIST_LLOYD_RATIO, replace=False))
    Gp = par.PartitionedELL.from_scipy(G, S, halo=nx, device="cuda")
    record: dict = {}
    torch.cuda.synchronize()
    t0 = time.time()
    agg, centers = par.plloyd(Gp, seeds, mesh8, maxiter=DIST_LLOYD_MAXITER, record=record)
    torch.cuda.synchronize()
    plloyd_s = time.time() - t0
    t0 = time.time()
    agg_s, roots_s, _ = lloyd_aggregation(CSR.from_scipy(G, device="cuda"), seeds=seeds,
                                          maxiter=DIST_LLOYD_MAXITER)
    torch.cuda.synchronize()
    out["plloyd"] = {"n": n, "k": len(seeds), "seconds": plloyd_s,
                     "serial_seconds": time.time() - t0, "sweeps": record["sweeps"],
                     "total_sweeps": sum(record["sweeps"])}
    check(np.array_equal(par.gather_global(agg).ravel()[:n], agg_s.cpu().numpy())
          and np.array_equal(np.sort(centers.cpu().numpy()), np.sort(roots_s.cpu().numpy())),
          "card-size plloyd differs from the serial Lloyd aggregation")

    # --- the GA's bucketed fitness over a pop mesh of 2 shards on the card ---
    grids = Grid.load_dir(os.path.join(TRAIN_DATA, "train"))[:DIST_FIT_GRIDS]
    bundles, buckets = make_buckets(grids, 0.1, torch.float32, step=128, device="cuda")
    net, _ = load_model(TRAIN_START, grids, device="cuda")
    population = init_population(prng.PRNGKey(1), flatten_params(net)[0].float().cpu(),
                                 DIST_FIT_POP, perturb=0.05)
    opts = SolveOptions(max_iter=75, smoother="multicolor_gs")
    fits = {}
    for tag, mesh in (("plain", None), ("mesh", par.make_mesh(pop=2, row=1,
                                                              devices=["cuda", "cuda"]))):
        fitness = make_population_fitness_bucketed(net, bundles, buckets, opts, mesh=mesh)
        t0 = time.time()
        fits[tag] = (fitness(population, 0), fitness.last_convs)
        out[f"fitness_{tag}_seconds"] = time.time() - t0
    out["fitness"] = fits["mesh"][0].tolist()
    check(np.array_equal(fits["mesh"][0], fits["plain"][0])
          and np.array_equal(fits["mesh"][1], fits["plain"][1]),
          f"pop-sharded fitness {fits['mesh'][0]} differs from the unsharded {fits['plain'][0]}")

    # --- the numbers behind visualize model-error and model-passes, card
    # against CPU (float64 held; float32 printed) ---
    g = Grid.load(TOOLS_EVAL_ARGS[0])
    viz: dict = {}
    for dtype in (torch.float64, torch.float32):
        res = {}
        for device in ("cuda", "cpu"):
            b = GridBundle.from_grid(g, 0.1, dtype, device=device)
            net_v = visualize.load_net(TRAIN_START, g, device, dtype=dtype)
            res[device] = (*visualize.model_error(net_v, b, DIST_VIZ_CYCLES),
                           visualize.model_passes(net_v, b))
        (e_c, conv_c, m_c), (e_h, conv_h, m_h) = res["cuda"], res["cpu"]
        viz[str(dtype)[6:]] = {
            "error_rel_gap": float(np.abs(e_c - e_h).max() / np.abs(e_h).max()),
            "conv_card": conv_c, "conv_cpu": conv_h,
            "masks_equal": all(np.array_equal(a, b) for a, b in zip(m_c, m_h))}
    out["viz"] = viz
    check(viz["float64"]["error_rel_gap"] <= DIST_VIZ_RTOL and viz["float64"]["masks_equal"],
          f"visualize numbers card vs CPU: {viz['float64']}")

    launches = {k: LAUNCHES[k] for k in KERNELS}
    check(not any(launches[k] for k in SPMV_KERNELS),
          f"the distributed path launched CUDA kernels: {launches}")

    # a trace of one distributed cycle at S = 8 (last: a profiler session
    # slows every later launch of its process)
    out["cycle_trace"] = device_trace(lambda: cycle(xs), iters=1, kernel="gemv", cpu=False)
    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= DIST_SECONDS,
          f"dist phase took {out['seconds_phase']:.1f} s (limit {DIST_SECONDS} s)")
    return out, launches


class _Enough(Exception):
    """Raised by :func:`_run_example`'s print once the held lines are in."""


def _run_example(name: str, argv: list, limit=None) -> tuple[list, float]:
    """(lines printed, seconds) of ``examples_torch/<name>.py``'s ``main(argv)``,
    stopped once ``limit`` lines are in."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines: list = []

    def record(*args, sep=" ", end="\n", **_):
        lines.extend((sep.join(map(str, args)) + end).splitlines())
        if limit is not None and len(lines) >= limit:
            raise _Enough

    mod.print = record
    t0 = time.time()
    try:
        mod.main(argv)
    except _Enough:
        pass
    return lines, time.time() - t0


def _examples_cpu() -> dict:
    """The held float64 lines of every example on the CPU (a worker)."""
    _cpu_worker_setup()
    return {name: _run_example(name, ["--device", "cpu", "--dtype", "float64"], held)
            for name, held in EXAMPLES_HELD.items()}


def _lines_agree(a: str, b: str) -> bool:
    """Two printed lines agree: the same words and integers, and decimals
    within one unit of their last printed digit (a value on a rounding
    boundary may print either way)."""
    ta, tb = a.replace(",", " ").split(), b.replace(",", " ").split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        xs, ys = x.strip("[]()"), y.strip("[]()")
        try:
            fx, fy = float(xs), float(ys)
        except ValueError:
            return False
        if "." not in xs or "." not in ys:
            return False  # an integer (a count) differs
        unit = 10.0 ** -max(len(xs.split(".")[1]), len(ys.split(".")[1]))
        if abs(fx - fy) > unit * 1.0001:
            return False
    return True


def examples_phase() -> tuple[dict, dict]:
    """The seven examples (phase 15 of the module docstring).  Returns the
    phase's line and the CUDA kernels' launches over it."""
    out: dict = {"phase": "examples"}
    try:
        return _examples_phase(out)
    except SystemExit:
        print(json.dumps(out, default=str), file=sys.stderr, flush=True)
        raise


def _examples_phase(out: dict) -> tuple[dict, dict]:
    import torch
    from mlamg_torch.utils.profiler import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    LAUNCHES.clear()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
        cpu_job = ex.submit(_examples_cpu)
        scripts = {}
        for name, held in EXAMPLES_HELD.items():
            lines32, s32 = _run_example(name, ["--dtype", "float32"])
            check(len(lines32) > 0, f"{name} printed nothing on the card")
            lines64, s64 = _run_example(name, ["--dtype", "float64"], held)
            scripts[name] = {"last_line_float32": lines32[-1], "lines_float32": len(lines32),
                             "seconds_float32": s32, "lines_float64": lines64,
                             "seconds_float64_held": s64}
        cpu = cpu_job.result()
    out["scripts"] = scripts
    for name, (lines, seconds) in cpu.items():
        card_lines = scripts[name]["lines_float64"]
        held = len(lines)
        scripts[name].update(
            lines_held=held, seconds_float64_cpu_held=seconds,
            lines_equal=sum(a == b for a, b in zip(card_lines, lines)),
            lines_agree=sum(_lines_agree(a, b) for a, b in zip(card_lines, lines)))
        if held != len(card_lines) or scripts[name]["lines_agree"] != held:
            scripts[name]["lines_float64_cpu"] = lines
    bad = {n: v for n, v in scripts.items()
           if v["lines_held"] == 0 or v["lines_agree"] != v["lines_held"]
           or len(v["lines_float64"]) != v["lines_held"]}
    check(not bad, f"examples: float64 lines on the card differ from the CPU's: {bad}")
    launches = {k: LAUNCHES[k] for k in KERNELS}
    out["launches"] = launches
    check(not any(launches[k] for k in SPMV_KERNELS),
          f"the examples launched CUDA kernels: {launches}")
    out["seconds_phase"] = time.time() - t_phase
    check(out["seconds_phase"] <= EXAMPLES_SECONDS,
          f"examples phase took {out['seconds_phase']:.1f} s (limit {EXAMPLES_SECONDS} s)")
    return out, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is false")
    import mlamg_torch  # noqa: F401  (fails outside the repository)
    from mlamg_torch import native
    from mlamg_torch.data import Grid
    from mlamg_torch.ops import _build
    from mlamg_torch.ops.dia import DIA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    libs = _build.build_kernels()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": sorted(p.name for p in libs.values())})

    # --- slice 9: the distributed path (no kernel on its path), in a fresh
    # process for the same reason as the ga phase below; it runs while this
    # process meshes the 600k hull on the host, when the card is idle, and
    # ends before any kernel is timed ---
    # --- slice 10: the examples, in a fresh process of the same pool once
    # dist is done, still beside the meshing ---
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                             max_tasks_per_child=1) as ex:
        dist_job = ex.submit(dist_phase)
        examples_job = ex.submit(examples_phase)

        # --- slice 1: the unstructured multilevel solve (well_spmv) ---
        t0 = time.time()
        A = Grid.random_2d_unstructured(N_DOFS, seed=SEED).A.astype(np.float32)
        perm = native.rcm_ordering(A)
        Ap = A[perm][:, perm].tocsr()
        emit({"phase": "matrix", "n": A.shape[0], "nnz": int(A.nnz),
              "seconds": time.time() - t0, "native_rcm": native.available()})
        t0 = time.time()
        dist_line, dist_launches = dist_job.result()
        dist_line["waited_after_meshing_s"] = time.time() - t0
        examples_line, examples_launches = examples_job.result()
        examples_line["waited_after_meshing_s"] = time.time() - t0
    emit(dist_line)
    emit(examples_line)
    kernel_launches_dist = dist_launches

    rng = np.random.RandomState(0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    kernel = kernel_phase(Ap, rng, flush)
    emit({"phase": "kernels", **{k: kernel[k] for k in ("max_rel_err", "ms", "warm_ms")}})
    osum = ordered_sum_phase(flush)
    emit({"phase": "ordered_sum_kernel", **osum})
    path, launches, level_errs, h = path_phase(A, rng)
    emit({key: v for key, v in path.items() if key != "perm"})
    levels = level_table(h, flush)
    emit({"phase": "levels", "levels": levels,
          "launches_x_warm_ms_per_wcycle": sum(r["launches_per_cycle"] * r["warm_us"]
                                               for r in levels) / 1e3,
          "trace_well_spmv_ms_per_wcycle": path["wcycle_trace"]["well_spmv_ms"],
          "fine_level_gather_spans": gather_spans(h.levels[0].A)})
    emit({"phase": "sweeps", **sweep_phase(h, flush)})
    del flush
    galerkin, galerkin_launches = galerkin_phase(A, path, h)
    emit(galerkin)
    kernel["launches_galerkin"] = galerkin_launches
    del h
    emit(small_cycle_phase())
    kernel["launches"] = launches
    kernel["max_abs_err"] = max(kernel["max_abs_err"], *(e[0] for e in level_errs))
    kernel["max_rel_err"] = max(kernel["max_rel_err"], *(e[1] for e in level_errs))
    del Ap

    # --- slice 2: the structured all-DIA hierarchy (dia_spmv) ---
    stages = {}
    t0 = time.time()
    A16 = poisson2d(GRID)
    stages["matrix"] = time.time() - t0
    t0 = time.time()
    Ad = DIA.from_scipy(A16)
    torch.cuda.synchronize()
    stages["from_scipy"] = time.time() - t0
    emit({"phase": "structured_matrix", "n": A16.shape[0], "nnz": int(A16.nnz),
          "offsets": list(Ad.offsets), **stages, "native_dia": native.available()})
    dia, dia_errs = dia_kernel_phase(A16, Ad, rng)
    emit({"phase": "dia_kernel", **{k: dia[k] for k in ("ms", "plain_ms", "library_ms")}})
    structured, dia_launches, level_errs = structured_phase(A16, Ad, stages, rng)
    emit(structured)
    del Ad
    twolevel, twolevel_launches, factor_errs = twolevel_phase(rng)
    emit(twolevel)
    emit(small_structured_phase())
    all_errs = dia_errs + level_errs + factor_errs

    # --- slice 11: bench_torch's cells (both kernels on their cells) ---
    bench_line, bench_launches = bench_phase(A, A16)
    emit(bench_line)
    kernel["launches_bench"] = bench_launches["well_spmv"]
    dia.update(launches_bench=bench_launches["dia_spmv"])
    osum["launches_bench"] = bench_launches["ordered_sum"]
    del A, A16
    torch.cuda.empty_cache()

    # --- slice 3: the learned two-level evaluation (no kernel on its path) ---
    eval_line, eval_launches = eval_phase()
    emit(eval_line)
    kernel["launches_eval"] = eval_launches["well_spmv"]
    dia.update(launches_eval=eval_launches["dia_spmv"])
    osum["launches_eval"] = eval_launches["ordered_sum"]

    # --- slice 4: gradient training (no kernel on its path) ---
    train_line, train_launches = train_phase()
    emit(train_line)
    kernel["launches_train"] = train_launches["well_spmv"]
    dia.update(launches_train=train_launches["dia_spmv"])
    osum["launches_train"] = train_launches["ordered_sum"]

    # --- slice 5: the GA (no kernel on its path), in a fresh process: a
    # torch.profiler session leaves CUPTI attached to this one, and every
    # later launch then costs the host more (generation 0 took 79.5 s after
    # the earlier phases' traces, 52-54 s alone on an H100; PERF.md §6) ---
    torch.cuda.empty_cache()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
        ga_line, ga_launches = ex.submit(ga_phase).result()
    emit(ga_line)
    kernel["launches_ga"] = ga_launches["well_spmv"]
    dia.update(launches_ga=ga_launches["dia_spmv"])
    osum["launches_ga"] = ga_launches["ordered_sum"]

    # --- slice 6: the Navier-Stokes deployment (no kernel on its path), in
    # a fresh process for the same reason ---
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
        ns_line, ns_launches = ex.submit(ns_phase).result()
    emit(ns_line)
    kernel["launches_ns"] = ns_launches["well_spmv"]
    dia.update(launches_ns=ns_launches["dia_spmv"])
    osum["launches_ns"] = ns_launches["ordered_sum"]

    # --- slice 8: the remaining trainers and tools (no kernel on their
    # path), in a fresh process for the same reason ---
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
        tools_line, tools_launches = ex.submit(tools_phase).result()
    emit(tools_line)
    kernel["launches_tools"] = tools_launches["well_spmv"]
    dia.update(launches_tools=tools_launches["dia_spmv"])
    osum["launches_tools"] = tools_launches["ordered_sum"]
    kernel["launches_dist"] = kernel_launches_dist["well_spmv"]
    dia.update(launches_dist=kernel_launches_dist["dia_spmv"])
    osum["launches_dist"] = kernel_launches_dist["ordered_sum"]
    kernel["launches_examples"] = examples_launches["well_spmv"]
    dia.update(launches_examples=examples_launches["dia_spmv"])
    osum["launches_examples"] = examples_launches["ordered_sum"]
    dia.update(
        launches=dia_launches,
        launches_vcycles=structured["dia_spmv_launches_cycles"],
        launches_twolevel=twolevel_launches,
        max_abs_err=max(e[0] for e in all_errs),
        max_rel_err=max(e[1] for e in all_errs),
    )

    emit({"kernels": [kernel, dia, osum]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
