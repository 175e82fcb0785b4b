#!/usr/bin/env python3
"""GPU check of the PyTorch port (manifold_gp_torch) on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):
  1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     build of the kernels from csrc/ with nvcc (timed);
  2. kernels vs plain at a small layout (10,240-point torus): the forward
     SpMV with f32, bf16 and x3 panels through both entry points
     (resident/stream) at B = 1, 7, 8, 9, 37, 48, 64, 100, 125, 128, 129,
     200 and 300 (every batch-tile template, each tile border, a second
     batch tile, three tiles with a ragged tail); the panel-cotangent kernel K3 with f32 and bf16 output through
     both entry points (bwd_blocks_call, block_bwd_blocks) at B = 1, 8, 15,
     16, 17, 37, 48, 64, 128, 129 and 200 (every batch class, the k padding
     to the mma depth 16, the chunked contraction above 64);
  2c. the DIA band kernel K4 vs plain at small DIA layouts (1,500- and
     10,240-point k = 8 curves at B = 1, 2, 3, 4, 5, 8, 17, 33, 37, 64, 99,
     100, 127, 128, 129, 200: every template of dia.dia_plan, the row
     runs its shared-memory budget caps at a few columns, each ragged
     float4 group, the 128-column chunks; and two
     synthetic layouts that take the general template: gapped offsets
     within +-512 and D = 128 offsets within +-512), f32 and bf16 bands,
     through dia_matvec_call and through make_matvec_ad's forward and
     bar_pv, each record with its template;
  3. the serving slice: serve the 262,144-point torus campaign
     (examples_torch/run_large.py::serve_campaign) with the launch counts
     reset to 0 just before and read just after; requires >= 1,543 forward
     launches, finite outputs and RMSE vs truth below half the label-noise
     floor;
  3L. serve the same torus with the config's default eigensolver, block
     LOBPCG (200 iterations, 100 modes), the launch counts reset just
     before and read just after: >= 200 forward launches at B = 300 and
     >= 201 at B = 100 in the basis; the basis's eigenvalues against phase
     3's, RMSE vs truth, exact and reference-metric NLL, LOVE variances
     (rank 100) against the exact ones, 64 posterior samples; then one
     more basis solve under torch.profiler for its split (kernel, GEMM,
     eigh/qr/svd, the rest). Fails on non-finite output or missing
     launches, not on RMSE;
  3M. the SRMNIST-shaped 10,010-point cloud (d = 64, 10 clusters, k = 50,
     randomwalk, 100 modes, the default config: LOBPCG on the forward
     kernel at B = 100 and 300), its eval_basis held to a host f64 ARPACK
     shift-invert oracle on the same graph;
  4. kernels vs plain at the main paths' own shapes (the served layout), with
     times: kernel (CUDA events around 10 back-to-back launches, median of
     5), plain version, library yardstick
     (one torch.bmm over the pre-gathered operand, used nowhere in the port)
     and the bound (bytes or operations at the card's published peaks, both
     from manifold_gp_torch/utils/roofline.py). The
     forward kernel at B = 125 (the basis solve's width; f32, bf16 and x3
     panels) and (4a) at B = 1, 48 and 100 with bf16 panels (the widths and
     panel type of one training gradient; 100 is average_variance's) and
     x3 panels at B = 48, and f32 panels at LOBPCG's B = 100 and 300,
     through cuda_spmv.block_matvec, each record with its batch tile; (4b) the panel-cotangent kernel at B = 1, 48 and 100
     (three 32-column chunks and a 4-column tail) through cuda_spmv.block_bwd_blocks, each record with its batch class,
     and the edge path's gather after it (flat[edge_flat], flat[diag_flat]);
  5. the 16,384-point serve held to the JAX package's numbers
     (examples_torch/serve_pins.json), and the port's lobpcg_smallest on
     the 16,384-point Laplacian from the numpy start block of its
     "pins_lobpcg", held to JAX's eigenvalues;
  6. the training slice: train_campaign at 262,144 points (3 epochs of
     manifold_informed_train from the campaign's initial hyperparameters
     with its rank-15 pivoted-Cholesky preconditioner rebuilt every 10
     epochs, the same 3 epochs with Jacobi beside them, then at the initial
     and at the trained hyperparameters, for pivoted Cholesky, Jacobi and
     spectral deflation: the build, CG iterations, one gradient), launch
     counts reset just before and read just after; requires >= 12
     panel-cotangent and >= 150 forward launches per gradient, finite
     losses and gradients and a loss that falls;
  6a. the torus preconditioners side by side (from phase 6's records and
     the phase's model): each pivoted-Cholesky build takes >= 90 forward
     launches (15 composed matvecs x 6), the built M satisfies
     ||M^-1 (L (L' x) + d x) - x|| / ||x|| <= 1e-4 on 4 random columns;
     CG iterations on y and on 48 Rademacher columns and one gradient with
     each preconditioner (deflation from phase 3's 100-mode basis at the
     trained point, from a basis solved at the initial one); one mBCG loss
     and gradient at the trained point beside the plain-SLQ loss; then one
     gradient with panel-space cotangents for its peak memory;
  7. the 16,384-point loss and gradients held to the JAX package's numbers
     (examples_torch/train_pins.json): edge-space cotangents to its "pins",
     panel-space cotangents over bf16 panels to its "pins_panel"; edge-
     against panel-space cotangents on the card, and a checkpointed run
     resumed on the card against the uninterrupted one;
  7a. the same loss and gradients with the pivoted-Cholesky preconditioner
     held to "pins_pivchol", and its loss to the Jacobi pin's (the
     preconditioner enters only the gradient's solves);
  8. the curve training slice: train_campaign(manifold="curve", k=8) at
     262,144 points (3 epochs on DIA bands with pivoted Cholesky, 3 with
     Jacobi, then both preconditioners at the initial and at the reached
     hyperparameters), every launch count reset just before and read just
     after; requires >= 192 K4 launches per gradient (32 Lanczos steps x 3
     Neumann terms x nu = 2), >= 90 per pivoted-Cholesky build, K5
     launches (the band cotangent), no block-ELL launch, finite losses and
     gradients, a loss that falls;
  8a. serve the same curve on the host f64 basis at the hyperparameters
     phase 8 reached: finite outputs, RMSE vs truth below the label-noise
     floor;
  8b. K4 vs plain at the served layout (B = 1, 100, 128) with times: kernel,
     plain version, library yardstick (one torch.sparse.mm of the same L_sym
     as CSR, used nowhere in the port) and the bound, and the kernel's and
     the yardstick's device-only times (20 calls in one CUDA graph,
     replayed: at B = 1 the host's enqueue paces back-to-back launches);
     the block-ELL forward
     kernel on the same graph (use_dia=False) at B = 128; and both formats
     on the k = 16 and k = 24 curves (DIA forced with 128 offsets; K4 with
     its yardstick and bound): the DIA-vs-panel crossover on this card;
     and at the served k = 8 curve's layout (phase 8's: D = 21) and the
     k = 16 curve's (the curve262k cell's: D = 43) the band-cotangent
     kernel K5 at B = 1, 100 and 128 against its plain
     version and float64 (one launch a call, bit for bit from call to
     call, its error against float64 no larger than the plain version's),
     timed (kernel, device only, plain) beside its bound
     (utils/roofline.py band_grad_bytes);
  9. the 16,384-point curve held to the JAX package's numbers
     (examples_torch/curve_pins.json): loss and gradients with shared
     probes, serve RMSE/NLL on the host f64 basis;
  10. the semisupervised spiral (examples_torch/run_spiral.py): 10,010
     points in R^20, 1,001 labeled, k = 10 (block-ELL, S = 3), 100 modes;
     the pinned 30-epoch protocol: manifold_informed_train on the labeled
     block's Schur complement (nested CG), test_model (block LOBPCG basis,
     Nystrom features), the vanilla RBF GP (vanilla_train, BBMM above
     max_cholesky = 1000) and the hybrid blend, with the launch counts reset
     just before and read just after; requires forward launches at B = 64
     and B = 1, K3 launches, finite results and examples/spiral_pins.json's
     rule (IMGP beats vanilla, IMGP RMSE <= 1.2 x pin + 1e-4); prints the
     median epoch, inner and outer CG iterations, the training's peak
     memory, the LOBPCG basis seconds and one traced gradient's device idle
     share; then holds the forward kernel (f32 panels at the trained
     bandwidth, B = 1, 64, 100, 300) and K3 (f32 out, B = 1, 64) to their
     plain versions at the spiral's layout, after the counts are read;
  10a. the spiral at 5,005 points (500 labeled, block-ELL) held to the JAX
     package's semisupervised loss and gradients at two points, and the
     vanilla BBMM loss at the 10,010-point spiral's labeled points
     (examples_torch/semisup_pins.json, tests/_semisup_pins.py; loss 1e-4,
     gradients 5e-3 of the largest). At lengthscale 1 the two packages'
     pivoted Cholesky picks different pivots among f32 ties, so there the
     loss is held to the dense f64 loss within the largest deviation of
     JAX's estimate over 32 probe seeds, and the port's pivots are printed.
  11. srmnist10k-semisup (examples_torch/run_rmnist.py semisupervised): the
     SRMNIST digits surrogate (10,010 images in R^784, 1,001 labeled by the
     notebooks' CPU seed-1337 split), built into a temporary cache
     directory and fingerprinted against examples_torch/dataset_pins.json
     (a mismatch, e.g. from another scipy, is printed, not failed); k = 50
     (block-ELL, S = 3), 100 modes, the notebook's 100 epochs on the Schur
     complement, the vanilla Matern-2.5 GP (BBMM), the hybrid test_model;
     launch counts reset just before and read just after; requires training
     forward launches at B = 64 (SLQ probes), 100 (average_variance) and 1,
     K3 launches at B = 64 and 1, finite results and the surrogate pins'
     rule (RMSE within 0.05, NLL within 0.15); prints the phase seconds,
     the median epoch, inner CG iterations per Schur apply, the training's
     peak memory, the LOBPCG basis seconds and one traced gradient's idle
     share; then holds the forward kernel (B = 1, 64, 100, 300) and K3
     (f32 out, B = 1, 64, 100) to their plain versions at SRMNIST's layout;
  11a. SRMNIST supervised (100 labeled, dense, 500 epochs): finite results,
     the pins' rule, and no kernel launch;
  11b. the 1-D dumbbell at the reference's pretrained hyperparameters
     (examples_torch/eval_pretrained.py, dense, no kernel launch): on JAX's
     kNN graph held to dataset_pins.json (vanilla 1e-3, IMGP 1e-2: f32's
     rounding at noise / outputscale = 6e-5); beneath it, the f64 witness
     (host f64 basis, JAX's kNN choice, the posterior computed in f64 from
     the card's features) within 1e-5 of JAX's, and the port's own
     posterior code run in f64 on those features within 1e-7 of it; on
     the card's own search, printed, with the check
     that its edges differ from JAX's only in tied neighbours; the
     reference stochastic metric's mean +/- sd;
  12. dragon4k (examples_torch/run_2d.py): 4,882 training vertices, k = 10,
     nu = 1 (block-ELL, S = 5), 100 epochs and the vanilla RBF GP; requires
     forward launches at B = 64 and 1, K3 launches, finite results and IMGP
     RMSE < 0.9 (tests/test_dragon_smoke.py's bound); prints RMSE/NLL
     beside JAX's recorded 0.0434 / -1.6139; then holds the forward kernel
     (B = 1, 64, 100) and K3 (f32 out, B = 1, 64) to their plain versions
     at the dragon's layout.
  13. the JAX package's production campaign cycle
     (examples_torch/run_large.py::run_campaign): the 262,144-point torus
     (260,096 training points), 3 epochs, checkpoints and a
     pivoted-Cholesky refresh every epoch, run twice in one fresh cache
     directory; the graph is IVF (2,048 lists, nprobe 16). Fails if the
     first run hits a cache or the second misses one, if the second result
     differs from the first in any bit, if RMSE vs truth is not below the
     label-noise floor, on a non-finite loss or NLL, or without forward and
     K3 launches over the first run (counts reset just before it), or if
     five loss-and-gradient evaluations at the trained point from one probe
     seed differ in any bit (all in PyTorch's default mode); then both
     block-ELL kernels held to their plain versions at the campaign's own
     layout: f32 panels (B = 1, 48, 100, 125), the training's bf16 panels
     (B = 1, 48, 100) and K3 (f32 out, B = 1, 48);
  13a. graph backends on the campaign's training points: the exact device
     search and IVF (k-means and lists, search, host symmetrize timed
     apart), IVF recall of the 15 neighbours against the exact search
     (>= 0.95), a second IVF build equal bit for bit, the share of edges
     that differ, the IVF peak memory; the
     brute-force host search (g++ build of the package's native library)
     against the device search at 65,536 points, whose picks must differ
     only in f32 ties;
  13b. multi_start_train: 4 random restarts x 10 steps on the 10,010-point
     SRMNIST-shaped cloud (k = 50, block-ELL), the seconds a restart
     against one manifold_informed_train of 10 epochs; fails on a
     non-finite loss, a best that is not the argmin, or no forward / K3
     launch; then holds the forward kernel (B = 1, 64) and K3 (f32 out,
     B = 1, 64) to their plain versions at the cloud's layout, in its panel
     type, at the best restart's coefficients.
  14. the row-sharded multi-GPU path (manifold_gp_torch.parallel) at world
     size 1 over NCCL (a FileStore in a temporary directory): the
     262,144-point torus at the campaign's training config (bf16 panels,
     edge-space cotangents, 48 probes, Jacobi) on a mesh kernel and on the
     single-device kernel, same graph, parameters and probes: loss within
     1e-4 relative, gradients within 5e-3 of the largest; 3 epochs of
     manifold_informed_train on the mesh, every loss finite, forward and K3
     launches (counts reset just before, read just after); the mesh LOBPCG
     basis (f32 panels, B = 100 and 300): eigenvalues of all 100 modes
     within 2e-5 of the Gershgorin bound of one device's LOBPCG in the
     mesh's padded row order from the same start block, and of the lowest
     90 of one device's node-order basis (how far the row order alone moves
     the top modes is printed); the posterior's RMSE vs truth below the
     noise floor; prints gradient and epoch seconds mesh against one
     device, the collectives per gradient and the peak memory;
  14c. the sharded kNN searches (manifold_gp_torch.parallel.knn) at world
     size 1 over NCCL: build_graph_sharded on the campaign's 260,096
     training points (k = 16) with the replicated and the ring schedule,
     each timed beside phase 13a's exact build, against the exact graph (at
     most 1e-4 of the edges may differ, in f32 ties only); the sharded IVF
     search on the campaign's index (2,048 lists, nprobe 16) equal to
     ivf_search's; phase 14's mesh loss and gradients on a mesh model over
     the sharded-built graph (bit for bit where the edges are equal);
  14b. both block-ELL kernels at every shard layout of world size 4 (the
     torus graph's tables built in one process, no collective): the forward
     kernel (bf16 panels at B = 1, 12, 24, 25, 48, 50 and 100, f32 at
     B = 100 and 300) and K3 (f32 out at B = 1, 12, 24, 25, 48 and 50, bf16
     out at the probe split's widths 12, 24, 25 and 50) on each shard's
     panels and exchanged window against their plain versions, the stacked
     shards against the single-device product (K3 on the used panel slots);
     then, at the torus's own layout, the forward kernel (bf16 panels, both
     entry points) and K3 (f32 and bf16 out) at the probe split's widths,
     each timed with its bound (utils/roofline.py) and torch.bmm;
  14a. world size 2 as two spawned processes sharing the card over gloo
     (the kernels built in phase 1; no rank builds): the 16,384-point torus
     on the fused mesh path; first, in this process, both kernels at its
     two shard layouts as in 14b; then loss and gradients against one
     device at phase 14's tolerances, the halo and gather exchanges within
     1e-6, parameters bit-identical on both ranks after 3 epochs, the
     LOBPCG basis as in phase 14; on both ranks build_graph_sharded
     (replicated) and the sharded IVF search equal to one device's, and the
     ring schedule raising (gloo has no CUDA send/recv); then the probe
     split: a single-device model under use_mesh, its 48 probes split
     24 / 24 and 100 one-hot columns 50 / 50, loss and gradients against one
     process's at phase 14's tolerances, the average variance at 1e-4, two
     all-reduces a gradient (printed with its seconds), loss, gradients and
     parameters after 3 epochs bit-identical on both ranks; a rank that
     fails or passes 300 s fails the phase (the children are killed).
Then a line of each phase's seconds, one JSON line with the kernel table,
and the last line {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Imports nothing of JAX or of the JAX package. Needs CUDA and the rest of
the repository next to this file.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"
BASIS_APPLIES = 4 * 64 * 6 + 6 + 1  # Chebyshev: 4 chunks x 64, +1 RR, x6 iters, +1
SMALL_TOL = 1e-5  # max |kernel - plain| / max |plain|: f32 sum order only
                  # (bf16 and x3 products are exact in f32 on both sides)
BF16_OUT_TOL = 2.0 ** -7  # bf16 output: one rounding step where the two f32
                          # sums straddle a rounding boundary
EDGE_PANEL_RTOL = 5e-2  # of the largest gradient: the panel path rounds its
                        # panel cotangents (and K3's factors) to bf16, the
                        # edge path keeps f32; 1.7e-2 was measured
K3_PER_GRADIENT = 12   # 2 terms (quad, Hutchinson) x 3 Neumann applies x nu = 2
FWD_PER_GRADIENT = 150  # 24 Lanczos steps x 6 alone are 144
K4_PER_GRADIENT = 192  # curve: 32 Lanczos steps x 3 Neumann applies x nu = 2
PIVCHOL_BUILD = 90  # rank 15 x (3 Neumann applies x nu = 2) forward launches at B = 1
PIVCHOL_INVARIANT = 1e-4  # ||M^-1 M x - x|| / ||x|| of the built preconditioner
SPIRAL_EPOCHS = 30  # examples/spiral_pins.json's protocol (max_iter = 30)
LOBPCG_MODES = 100  # the torus campaign's modes: LOBPCG's block width m
LOBPCG_ITERS = 200  # InferenceConfig.eigensolver_max_iter: one apply at B = 3m
                    # and one at B = m an iteration, plus one at B = m
ORACLE_RTOL, ORACLE_ATOL = 2e-2, 1e-4  # eval_basis eigenvalues vs ARPACK (f64)
ALIGN_MIN = 0.95  # |<eigvec_j, oracle_j>| of modes away from clusters, held
ALIGN_MODES = 20  # on the lowest 20 modes (tests/test_eval_basis_10k.py's block):
                  # the top of a 100-wide block still rotates after 200
                  # iterations (an H100 read 0.86 and 0.52 at modes 93, 94;
                  # JAX's own CPU run one mode at 0.943), so it is recorded
# the 1-D pretrained evaluation vs JAX's numbers on JAX's kNN graph (relative).
# At noise / outputscale = 6e-5 (feature-space system cond 7.3e4, posterior
# covariance cond 1.8e6) an f32 evaluation lands ~1e-3 from the exact one:
# an H100's NLL 6.8e-3, JAX's 1.4e-3, and the two packages' f32 bases move
# the exact metrics 2.4e-4 more, 8.4e-3 in all: IMGP is held at 1e-2. The
# layers beneath are held tightly: the posterior computed in f64 from the
# card's features (one basis, one kNN choice) to JAX's at WITNESS_RTOL, and
# the port's own posterior code run in f64 on them at MODEL_F64_RTOL.
PRETRAINED_RTOL = {"imgp_rmse": 1e-2, "imgp_nll": 1e-2, "imgp_nll_love": 1e-2,
                   "vanilla_rmse": 1e-3, "vanilla_nll": 1e-3}
WITNESS_RTOL = 1e-5  # f64 posterior from f32 features: an H100 read 2.3e-7
MODEL_F64_RTOL = 1e-7  # the port's posterior code in f64: the CPU read 3.0e-9
DRAGON_VANILLA_EPOCHS = 10  # of run_2d.py's 100: the vanilla BBMM baseline
                            # takes 52 s at 100 and runs no kernel
DRAGON_RMSE_MAX = 0.9  # tests/test_dragon_smoke.py's bound
GAP_FRAC = 5e-3  # of the top oracle eigenvalue: a mode closer to a neighbour
                 # than this is inside a cluster and has no unique vector
# K4's phase-2c widths: B = 1 (row template), up to 16 (row runs capped by
# the shared-memory budget), 17-128, ragged float4 groups, and above 128
# (column chunks).
DIA_WIDTHS = (1, 2, 3, 4, 5, 8, 17, 33, 37, 64, 99, 100, 127, 128, 129, 200)
EDGE_TIES = 1e-4  # share of kNN edges the port's and JAX's searches may
                  # pick differently where two distances tie in f32 (one
                  # edge in 57,878 on the 16k curve)

CAMPAIGN_N = 262_144  # phase 13: the campaign's default size (260,096 training points)
CAMPAIGN_EPOCHS = 3  # of its 50
# what the second campaign run must reproduce exactly (its caches hit)
CAMPAIGN_SAME = ("value", "final_loss", "history", "graphbandwidth_trained",
                 "lengthscale_trained", "noise_trained", "outputscale_trained",
                 "rmse_noisy_test", "nll_noisy_test", "num_edges", "cg_iters_initial",
                 "cg_iters_trained")
IVF_RECALL_MIN = 0.95  # phase 13a: IVF (nprobe 16 of 2,048 lists) against the exact search
HOST_KNN_N = 65_536  # phase 13a: the brute-force host search's size
TIE_SQDIST = 2e-6  # a neighbour tie: f32 rounding of |q|^2 + |x|^2 - 2 q.x at |x|^2 <= 2
GRAD_REPEATS = 5  # phase 13: loss-and-gradient evaluations held bit for bit
RESTARTS, RESTART_STEPS = 4, 10  # phase 13b

PEAK_CARD = "H100"  # the name the bounds' peaks are looked up by (main sets the card's)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


PHASE_SECONDS: dict = {}  # "phase 14c" -> its seconds (each phase ends where the next begins)
_CURRENT_PHASE: list = []


def phase(title: str):
    """Print a phase's header and start its clock (closing the previous
    phase's into ``PHASE_SECONDS``); ``phase(None)`` closes the last."""
    now = time.perf_counter()
    if _CURRENT_PHASE:
        name, t0 = _CURRENT_PHASE.pop()
        PHASE_SECONDS[name] = now - t0
    if title is not None:
        _CURRENT_PHASE.append((title.split(":")[0], now))
        print(f"== {title}")


def bound(nbytes: int, flops: int, dtype_bytes: int) -> dict:
    """The bound fields of a record: the larger of the bytes' time at the
    card's memory rate and the operations' at its peak for their type
    (``manifold_gp_torch.utils.roofline``)."""
    from manifold_gp_torch.utils import roofline

    ms, by = roofline.bound_ms(nbytes, flops, dtype_bytes, PEAK_CARD)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes, "flops": flops}


def fwd_timing(layout):
    """``compare``'s ``timing=`` at a block layout: the forward kernel, its
    plain version and one ``torch.bmm`` over the gathered operand (x3
    panels have no single library call), with the bound: panels, block ids,
    operand and output moved once, the panels' products at the peak of
    their type."""
    import torch

    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.utils import roofline

    def fwd(bc, panels, pv, s):
        nrb = layout.num_row_blocks
        b = pv.shape[1]
        x3 = panels.dim() == 4
        mv = roofline.matvec_bytes(layout, b,
                                   buf_dtype_bytes=panels.element_size() * (2 if x3 else 1))
        rec = bound(mv["total"] + mv["index"], roofline.matvec_flops(layout, b, 3 if x3 else 1),
                    4 if panels.dtype == torch.float32 else 2)
        ms = time_ms(lambda: cuda_spmv.block_matvec(layout, panels, pv))
        plain_ms = time_ms(lambda: cuda_spmv.block_matvec_plain(bc, panels, pv, s_max=s),
                           reps=3, runs=2)
        library_ms = None
        if not x3:
            cb = pv.reshape(-1, 128, b).index_select(0, bc).reshape(nrb, s * 128, b)
            cb = cb.to(panels.dtype)
            library_ms = time_ms(lambda: torch.bmm(panels, cb))
            del cb
        return {"panels": "float32x3" if x3 else str(panels.dtype).replace("torch.", ""),
                "batch_tile": cuda_spmv._batch_tile(b),
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **rec}

    return fwd


def bwd_timing(layout, edge_gather: bool = True):
    """``compare_bwd``'s ``timing=`` at a block layout: K3, its plain
    version and one ``torch.bmm``, with the bound (the panel-sized output
    written once, the cotangent, operand and block ids read once; the
    products at the peak of the output's type) and, with f32 output and
    ``edge_gather``, the edge path's gather after it."""
    import torch

    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.utils import roofline

    def bwd(bc, g, pv, s, out_dtype):
        nrb = layout.num_row_blocks
        b = pv.shape[1]
        ob = 4 if out_dtype == torch.float32 else 2
        rec = bound(roofline.bwd_blocks_bytes(layout, b, out_dtype_bytes=ob)["total"],
                    roofline.block_matvec_flops(layout, b), ob)

        def kernel():
            cuda_spmv.block_bwd_blocks(layout, g, pv, out_dtype=out_dtype)

        def plain():
            cuda_spmv.bwd_blocks_plain(bc, g, pv, s_max=s, out_dtype=out_dtype)

        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3, runs=2)
        cb = pv.reshape(-1, 128, b).index_select(0, bc).reshape(nrb, s * 128, b)
        cbt = cb.to(out_dtype).transpose(1, 2)
        g3 = g.reshape(nrb, 128, b).to(out_dtype)
        del cb
        library_ms = time_ms(lambda: torch.bmm(g3, cbt))
        del cbt, g3
        gather_ms = None
        if out_dtype == torch.float32 and edge_gather:  # what the edge path does with K3's output
            flat = cuda_spmv.block_bwd_blocks(layout, g, pv).reshape(-1)
            gather_ms = time_ms(lambda: (flat[layout.edge_flat], flat[layout.diag_flat]))
            del flat
        torch.cuda.empty_cache()
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "edge_gather_ms": gather_ms, **rec}

    return bwd


def time_ms(fn, reps: int = 5, runs: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``runs`` back-to-back calls
    between two CUDA events: the host's enqueue time between two launches
    overlaps the device's work instead of adding to it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def graph_ms(fn, runs: int = 20, reps: int = 5) -> float:
    """Device time per call: ``runs`` calls captured in one CUDA graph,
    replayed between two events (median of ``reps``), so no host enqueue
    paces a call shorter than the host's own work."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def panel_sets(layout, coeffs):
    import torch

    from manifold_gp_torch.ops.block_sparse import assemble

    return {
        "float32": assemble(layout, coeffs.diag, coeffs.triu),
        "bfloat16": assemble(layout, coeffs.diag, coeffs.triu, dtype=torch.bfloat16),
        "float32x3": assemble(layout, coeffs.diag, coeffs.triu, dtype="float32x3"),
    }


def compare(layout, panels, pv, label, timing=None):
    """Kernel (both entry points) vs plain on the card; returns a record."""
    import torch

    from manifold_gp_torch.ops import cuda_spmv

    bc = layout.block_col.reshape(-1)
    s = layout.max_blocks
    want = cuda_spmv.block_matvec_plain(bc, panels, pv, s_max=s)
    scale = float(want.abs().max())
    rec = {"case": label, "batch": int(pv.shape[1]), "scale": scale}
    for entry in ("resident_matvec_call", "stream_matvec_call"):
        got = getattr(cuda_spmv, entry)(bc, panels, pv, s_max=s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(scale, 1e-30)
        rec[entry] = {"max_abs_err": err, "max_rel_err": rel}
        ok = bool(torch.isfinite(got).all()) and rel <= SMALL_TOL
        print(f"  {label:<34} B={pv.shape[1]:<4} {entry:<21} max_rel_err={rel:.3e} "
              f"(threshold {SMALL_TOL:.0e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {label} {entry} rel={rel}")
    del want
    if timing is not None:
        rec.update(timing(bc, panels, pv, s))
    return rec


class _Cut(Exception):
    pass


class _CutAt:
    """A ``metrics=`` recorder that interrupts training at an epoch."""

    def __init__(self, epoch):
        self.epoch = epoch

    def record(self, epoch, **values):
        if epoch == self.epoch:
            raise _Cut


def compare_bwd(layout, g, pv, out_dtype, label, timing=None):
    """Panel-cotangent kernel (both entry points) vs plain on the card."""
    import torch

    from manifold_gp_torch.ops import cuda_spmv

    bc = layout.block_col.reshape(-1)
    s = layout.max_blocks
    tol = SMALL_TOL if out_dtype == torch.float32 else BF16_OUT_TOL
    want = cuda_spmv.bwd_blocks_plain(bc, g, pv, s_max=s, out_dtype=out_dtype)
    scale = float(want.abs().max())
    rec = {"case": label, "batch": int(pv.shape[1]), "scale": scale,
           "out_dtype": str(out_dtype).replace("torch.", ""),
           "batch_class": cuda_spmv._bwd_batch_class(int(pv.shape[1]))}
    for entry, call in (
        ("bwd_blocks_call", lambda: cuda_spmv.bwd_blocks_call(bc, g, pv, s_max=s,
                                                              out_dtype=out_dtype)),
        ("block_bwd_blocks", lambda: cuda_spmv.block_bwd_blocks(layout, g, pv,
                                                                out_dtype=out_dtype)),
    ):
        got = call()
        torch.cuda.synchronize()
        # compare in slices of row blocks: no second panel-sized f32 buffer
        err, finite = 0.0, True
        for lo in range(0, got.shape[0], 256):
            d = got[lo:lo + 256].float() - want[lo:lo + 256].float()
            err = max(err, float(d.abs().max()))
            finite = finite and bool(torch.isfinite(d).all())
        del got
        rel = err / max(scale, 1e-30)
        rec[entry] = {"max_abs_err": err, "max_rel_err": rel}
        ok = finite and rel <= tol
        print(f"  {label:<34} B={pv.shape[1]:<4} {entry:<21} max_rel_err={rel:.3e} "
              f"(threshold {tol:.0e}; class {rec['batch_class']}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {label} {entry} rel={rel}")
    del want
    torch.cuda.empty_cache()
    if timing is not None:
        rec.update(timing(bc, g, pv, s, out_dtype))
    return rec


def hold_at_layout(model, params, label, fwd_widths, bwd_widths, seed, dev,
                   panel_dtype=None):
    """Both block-ELL kernels against their plain versions at a trained
    model's own layout (panels of ``panel_dtype``, default f32, at its
    coefficients): the forward kernel through both entry points at
    ``fwd_widths``, K3 with f32 output at ``bwd_widths``. Run after a
    phase's counts are read: these launches are not the main path's.
    Returns the records."""
    import torch

    from manifold_gp_torch.ops.block_sparse import BlockLayout, assemble, permute_in

    layout = model.kernel.block_layout
    if not isinstance(layout, BlockLayout):
        fail(f"{label} took {type(layout).__name__}, not block-ELL")
    with torch.no_grad():
        coeffs = model.kernel.coeffs(params)
        panels = assemble(layout, coeffs.diag, coeffs.triu, dtype=panel_dtype)
    dtype_name = "float32" if panel_dtype is None else str(panel_dtype).replace("torch.", "")
    gen = torch.Generator(device=dev).manual_seed(seed)
    records = []
    for batch in fwd_widths:
        v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
        records.append(compare(layout, panels, permute_in(layout, v).contiguous(),
                               f"{label} {dtype_name}"))
    for batch in bwd_widths:
        v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
        gct = torch.randn((layout.num_padded, batch), generator=gen, device=dev)
        records.append(compare_bwd(layout, gct, permute_in(layout, v).contiguous(),
                                   torch.float32, f"{label} bwd float32"))
    del panels, coeffs
    torch.cuda.empty_cache()
    return records


def compare_dia(layout, band, pv, label):
    """K4 vs plain on the card through dia_matvec_call and through
    make_matvec_ad's forward and bar_pv; returns a record."""
    import torch

    from manifold_gp_torch.ops import dia

    want = dia.matvec_permuted(layout, band, pv)
    scale = float(want.abs().max())
    plan = dia.dia_plan(layout.offsets, layout.halfwidth, int(pv.shape[1]), band.element_size())
    rec = {"case": label, "batch": int(pv.shape[1]), "scale": scale,
           "band": str(band.dtype).replace("torch.", ""), "template": plan.template,
           "rows_per_thread": plan.rows_per_thread, "rows_per_block": plan.rows_per_block}
    g = torch.randn(pv.shape, generator=torch.Generator(device=pv.device).manual_seed(3),
                    device=pv.device)
    want_bar = dia.matvec_permuted(layout, band, g)
    pvr = pv.clone().requires_grad_(True)
    fwd = dia.make_matvec_ad(layout)(band, pvr)
    fwd.backward(g)
    for entry, got, ref in (("dia_matvec_call", dia.dia_matvec_call(layout, band, pv), want),
                            ("make_matvec_ad", fwd.detach(), want),
                            ("bar_pv", pvr.grad, want_bar)):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        rec[entry] = {"max_abs_err": err, "max_rel_err": rel}
        ok = bool(torch.isfinite(got).all()) and rel <= SMALL_TOL
        print(f"  {label:<34} B={pv.shape[1]:<4} {entry:<21} max_rel_err={rel:.3e} "
              f"(threshold {SMALL_TOL:.0e}; {plan.template}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K4 disagrees with its plain version: {label} {entry} rel={rel}")
    return rec


def band_grad_check(layout, g, pv, band_dtype, label):
    """K5 (``dia.bar_band`` on the card) at one width: against
    ``bar_band_plain`` on the card and both against the same sum in float64
    (max error over the largest |entry|), one launch a call, bit for bit
    from call to call, zero past the D used lanes; with times: the kernel
    (CUDA events; and device only, replayed in a CUDA graph), the plain
    version, and the bound (``roofline.band_grad_bytes`` at the card's
    memory rate, ``matvec_flops`` at its f32 peak). Returns a record."""
    import torch

    from manifold_gp_torch.ops import dia
    from manifold_gp_torch.utils import roofline

    b = int(pv.shape[1])
    plan = dia.band_grad_plan(layout.offsets, layout.halfwidth, b)
    before = dia.dia_band_grad_launch_count
    got = dia.bar_band(layout, g, pv, band_dtype)
    launches = dia.dia_band_grad_launch_count - before
    same = torch.equal(got, dia.bar_band(layout, g, pv, band_dtype))
    plain = dia.bar_band_plain(layout, g, pv, band_dtype)
    exact = dia.bar_band_plain(layout, g.double(), pv.double(), torch.float64)
    scale = float(exact.abs().max())
    err = float((got.double() - exact).abs().max()) / scale
    plain_err = float((plain.double() - exact).abs().max()) / scale
    vs_plain = float((got.double() - plain.double()).abs().max()) / max(
        float(plain.double().abs().max()), 1e-30)
    clean = not got[:, layout.num_offsets:].any()
    del exact, plain
    f32 = band_dtype == torch.float32
    ok = (launches == 1 and same and clean and bool(torch.isfinite(got).all())
          and err <= plain_err + (2.0 ** -24 if f32 else 2.0 ** -9)
          and vs_plain <= (SMALL_TOL if f32 else BF16_OUT_TOL))
    del got
    rec = {"case": label, "batch": b, "band": str(band_dtype).replace("torch.", ""),
           "num_padded": layout.num_padded, "num_offsets": layout.num_offsets,
           "template": plan.template, "rows_per_block": plan.rows_per_block,
           "launches": launches, "max_rel_err": err, "plain_max_rel_err": plain_err,
           "vs_plain_rel_err": vs_plain}
    out_bytes = torch.empty((), dtype=band_dtype).element_size()
    rec.update(bound(roofline.band_grad_bytes(layout, b, out_dtype_bytes=out_bytes)["total"],
                     roofline.matvec_flops(layout, b), 4))
    rec.update({
        "ms": time_ms(lambda: dia.bar_band(layout, g, pv, band_dtype)),
        "device_ms": graph_ms(lambda: dia.bar_band(layout, g, pv, band_dtype)),
        "plain_ms": time_ms(lambda: dia.bar_band_plain(layout, g, pv, band_dtype), reps=3,
                            runs=2)})
    torch.cuda.empty_cache()
    print(f"  {label:<34} B={b:<4} K5 {plan.template} (TR={plan.rows_per_block}): "
          f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}); vs float64 {err:.3e} "
          f"(plain {plain_err:.3e}), vs plain {vs_plain:.3e} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"K5 disagrees with its plain version or float64: {label} B={b} {rec} "
             f"same={same} clean={clean}")
    return rec


def synthetic_dia(offsets, n, band_dtype, seed, device):
    """A DIA layout in band order with these offsets, random band lanes in
    its N true rows and zero halo rows (the layout contract)."""
    import numpy as np
    import torch

    from manifold_gp_torch.ops import dia

    layout = dia.layout_from_offsets(offsets, n, device=device)
    lanes = np.random.default_rng(seed).standard_normal((n, layout.num_offsets))
    band = torch.zeros((layout.num_padded, dia.BAND_WIDTH), device=device)
    band[dia.TILE:dia.TILE + n, :layout.num_offsets] = torch.from_numpy(
        lanes.astype(np.float32)).to(device)
    return layout, band.to(band_dtype)


def band_csr(layout, band):
    """The operator of a DIA band as a CUDA CSR matrix [Npd, Npd] (its
    nonzero band entries), for the library yardstick."""
    import torch

    npd, d = layout.num_padded, layout.num_offsets
    offs = torch.tensor(layout.offsets, device=band.device)
    rows = torch.arange(npd, device=band.device)[:, None].expand(npd, d)
    cols = rows + offs[None, :]
    vals = band[:, :d].float()
    keep = (vals != 0) & (cols >= 0) & (cols < npd)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]), vals[keep],
                                  (npd, npd)).coalesce()
    return coo.to_sparse_csr()


def arpack_oracle(graph, coeffs, m):
    """The smallest ``m`` eigenpairs of the symmetric Laplacian of
    ``coeffs`` on ``graph`` in f64 on the host (scipy ARPACK, shift-invert
    just below the spectrum), and the degrees: numpy (values, vectors, deg)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    n = graph.num_nodes
    rows, cols = graph.rows.cpu().numpy(), graph.cols.cpu().numpy()
    triu = coeffs.triu.cpu().numpy().astype(np.float64)
    adj = sp.coo_matrix((np.concatenate([triu, triu]),
                         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
                        shape=(n, n)).tocsc()
    lap = sp.diags(coeffs.diag.cpu().numpy().astype(np.float64)) - adj
    vals, vecs = spl.eigsh(lap, k=m, sigma=-1e-3, which="LM")
    order = np.argsort(vals)
    return vals[order], vecs[:, order], coeffs.deg.cpu().numpy().astype(np.float64)


def rademacher_draws(seed: int, shapes):
    """The draws tests/_semisup_pins.py shares with the port: one +-1
    float32 array per shape, in order from one numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(2 * rng.integers(0, 2, shape) - 1).astype(np.float32) for shape in shapes]


def semisup_parity(pins: dict, device) -> dict:
    """Phase 10a: the port's losses and gradients at the points of
    ``examples_torch/semisup_pins.json`` on the same probes: the
    semisupervised Schur loss at 5,005 points and the vanilla BBMM loss at
    the 10,010-point spiral's labeled points. Returns, for each pinned
    point, the port's numbers, the loss's relative difference from the JAX
    pin (and, where the pin has one, from its dense f64 loss), the largest
    gradient difference over the largest pinned gradient, and for the
    vanilla points the port's pivot order."""
    import torch

    from examples_torch.run_large import loss_and_grad
    from examples_torch.run_spiral import build_problem
    from manifold_gp_torch import InferenceConfig, RBFKernel, VanillaGP

    cg_kw = dict(cg_tolerance=pins["cg_tolerance"], cg_max_iter=pins["cg_max_iter"])

    def compare(loss, grads, pin):
        scale = max(abs(v) for v in pin["grads"].values())
        rec = {"loss": loss, "grads": {k: grads[k] for k in pin["grads"]},
               "loss_rel": abs(loss - pin["loss"]) / abs(pin["loss"]),
               "grad_rel_of_max": max(abs(grads[k] - v) for k, v in pin["grads"].items())
               / scale}
        if "exact_loss" in pin:
            rec["exact_rel"] = abs(loss - pin["exact_loss"]) / abs(pin["exact_loss"])
        return rec

    sp = pins["semisup"]
    model, labeled, *_ = build_problem(n=sp["n"], num_labeled=sp["num_labeled"], k=sp["k"],
                                       device=device, max_cholesky=0,
                                       num_probes=sp["num_probes"],
                                       lanczos_max_iter=sp["lanczos_max_iter"], **cg_kw)
    layout = model.kernel.block_layout
    out = {"semisup_layout": {"layout": type(layout).__name__,
                              "max_blocks": getattr(layout, "max_blocks", None),
                              "num_row_blocks": getattr(layout, "num_row_blocks", None),
                              "num_edges": int(model.kernel.graph.num_edges)}}
    (probes,) = rademacher_draws(pins["probe_seed"], [(int(labeled.sum()), sp["num_probes"])])
    probes = torch.from_numpy(probes).to(model.device)
    for label, pin in sp["pins"].items():
        loss, grads = loss_and_grad(model, model.init_params(**pin["hypers"]), probes=probes)
        out[f"semisup_{label}"] = compare(loss, grads, pin)
    vp = pins["vanilla"]
    full, labeled, train_y, *_ = build_problem(n=vp["n"], num_labeled=vp["num_labeled"],
                                               device=device)
    cfg = InferenceConfig(max_cholesky=1000, num_probes=vp["num_probes"],
                          lanczos_max_iter=vp["lanczos_max_iter"], **cg_kw)
    vmodel = VanillaGP(full.train_x, train_y, RBFKernel(device=device), cfg=cfg)
    n_lab, p = int(labeled.sum()), vp["num_probes"]
    z1, z2, zr = (torch.from_numpy(z).to(vmodel.device) for z in rademacher_draws(
        pins["probe_seed"], [(vp["precond_rank"], p), (n_lab, p), (n_lab, p)]))
    for label, pin in vp["pins"].items():
        params = {k: v.detach().requires_grad_(True)
                  for k, v in vmodel.init_params(**pin["hypers"]).items()}
        with torch.no_grad():
            # zm = L z1 + sqrt(d) z2 from the port's own preconditioner:
            # what its sample() draws, on the JAX pins' numpy draws
            _, pobj = vmodel.pivchol_precond(params)
            zm = pobj.L @ z1 + torch.sqrt(pobj.d)[:, None] * z2
        loss = vmodel.mll_loss(params, probes=(zm, zr))
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        out[f"vanilla_{label}"] = {
            **compare(float(loss.detach()), {k: float(g) for k, g in zip(names, grads)}, pin),
            "hold_loss": pin["hold_loss"],
            "pivots": torch.argmax(pobj.L.abs(), dim=0).tolist()}
    return out


def cloud_vs_arpack(dev):
    """Phase 3M: ``eval_basis`` of a default-config kernel on the
    SRMNIST-shaped cloud (LOBPCG on the forward kernel), held to
    ``arpack_oracle``: all 100 eigenvalues (eigval[0] is forced to 0)
    within ORACLE_RTOL/ORACLE_ATOL, and each of the lowest ALIGN_MODES
    modes farther than GAP_FRAC of the top eigenvalue from its neighbours
    aligned with the oracle's (after the same D^-1/2 recovery) better than
    ALIGN_MIN, at least 3 such modes; every mode's alignment is recorded."""
    import numpy as np
    import torch

    from manifold_gp_torch import RiemannMaternKernel
    from manifold_gp_torch.ops import cuda_spmv
    from examples_torch.run_large import srmnist_points

    x = srmnist_points()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel = RiemannMaternKernel(nu=2, x=x, nearest_neighbors=50,
                                 laplacian_normalization="randomwalk", num_modes=100,
                                 device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = kernel.init_params(graphbandwidth=0.5, lengthscale=1.0)
    cuda_spmv.launch_count = 0
    cuda_spmv.launch_count_by_batch.clear()
    t0 = time.perf_counter()
    val, vec = kernel.eval_basis(params)
    torch.cuda.synchronize()
    basis_s = time.perf_counter() - t0
    by_batch = {str(b): c for b, c in sorted(cuda_spmv.launch_count_by_batch.items())}
    launches = cuda_spmv.launch_count
    val, vec = val.cpu().numpy(), vec.cpu().numpy()
    t0 = time.perf_counter()
    ov, ovec, deg = arpack_oracle(kernel.graph, kernel.coeffs(params), 100)
    oracle_s = time.perf_counter() - t0
    tol = ORACLE_ATOL + ORACLE_RTOL * np.abs(ov[1:])
    err_of_tol = np.abs(val[1:] - ov[1:]) / tol
    orec = ovec / np.sqrt(deg)[:, None]
    orec = orec / np.linalg.norm(orec, axis=0, keepdims=True)
    aligned = {}
    for j in range(1, len(ov) - 1):
        if min(ov[j] - ov[j - 1], ov[j + 1] - ov[j]) >= GAP_FRAC * ov[-1]:
            aligned[j] = abs(float(vec[:, j] @ orec[:, j]))
    held = {j: dot for j, dot in aligned.items() if j < ALIGN_MODES}
    layout = kernel.block_layout
    rec = {"n": kernel.graph.num_nodes, "num_edges": int(kernel.graph.num_edges),
           "max_blocks": int(layout.max_blocks), "num_row_blocks": int(layout.num_row_blocks),
           "kernel_build_s": build_s, "basis_s": basis_s, "oracle_s": oracle_s,
           "spmv_launches": launches, "spmv_launches_by_batch": by_batch,
           "eig_max_err_of_tol": float(err_of_tol.max()),
           "eig_worst_mode": int(np.argmax(err_of_tol)) + 1,
           "modes_checked": len(held), "min_alignment": min(held.values(), default=None),
           "min_alignment_all_modes": min(aligned.values(), default=None),
           "alignment": aligned, "eigval": [float(v) for v in val],
           "oracle": [float(v) for v in ov]}
    print(f"  N={rec['n']} edges={rec['num_edges']} S={rec['max_blocks']} row blocks="
          f"{rec['num_row_blocks']}; kernel built in {build_s:.2f} s, basis {basis_s:.2f} s "
          f"(forward launches {by_batch}), ARPACK {oracle_s:.2f} s")
    print(f"  eigenvalues: max |err| / (atol + rtol |oracle|) = {rec['eig_max_err_of_tol']:.3f} "
          f"(mode {rec['eig_worst_mode']}; must be <= 1); {len(held)} of the lowest "
          f"{ALIGN_MODES} modes away from clusters, min alignment {rec['min_alignment']} "
          f"(> {ALIGN_MIN}); all {len(aligned)} such modes of the block: min "
          f"{rec['min_alignment_all_modes']}")
    if by_batch.get("300", 0) < LOBPCG_ITERS or by_batch.get("100", 0) < LOBPCG_ITERS + 1:
        fail(f"the 10k LOBPCG basis launched the forward kernel {by_batch} times")
    if not (np.isfinite(val).all() and np.isfinite(vec).all()):
        fail("non-finite 10k basis")
    if not rec["eig_max_err_of_tol"] <= 1.0:
        fail(f"10k basis eigenvalues miss the ARPACK oracle: {rec['eig_max_err_of_tol']:.3f}")
    if len(held) < 3 or not rec["min_alignment"] > ALIGN_MIN:
        fail(f"10k basis eigenvectors miss the ARPACK oracle: {held}")
    return rec


def reference_protocols(dev) -> dict:
    """Phases 11, 11a, 11b and 12: the reference datasets and protocols
    through the port's example scripts, each with its launch counts reset
    just before and read just after. Returns their report entries and the
    kernels line's launch counts of these paths (``forward``, ``bwd_blocks``:
    entries of ``launches_by_path``; ``required``: counts that must be > 0)."""
    import tempfile

    import numpy as np
    import scipy
    import torch

    from examples_torch import eval_pretrained, reference_protocol as rp
    from examples_torch.profile_gradient import trace_gradient
    from examples_torch.run_2d import run_experiment as run_dragon
    from examples_torch.run_rmnist import check_pins as rmnist_check_pins
    from examples_torch.run_rmnist import dataset_fingerprint
    from examples_torch.run_rmnist import run_experiment as run_rmnist
    from manifold_gp_torch.ops import cg as cg_ops
    from manifold_gp_torch.ops.knn import knn_search
    from manifold_gp_torch.utils import manifold_1D_dataset

    report = {}

    # -- phase 11: SRMNIST semisupervised at 10,010 points --------------------
    phase("phase 11: srmnist10k-semisup (the notebook protocol, 100 epochs)")
    dpins = json.loads((ROOT / "examples_torch" / "dataset_pins.json").read_text())
    cg_ops.iteration_log = None
    torch.cuda.empty_cache()
    # one dataset build for 11 and 11a, in a directory of its own (the
    # cache key ignores the build's size)
    cache = tempfile.TemporaryDirectory()
    handles = {}
    rp.reset_launch_counts()
    srm = run_rmnist("semisupervised", device=dev, handles=handles, cache_dir=cache.name)
    srm_all = rp.launch_snapshot()
    fp = dataset_fingerprint(*handles.pop("dataset"))
    fp_pin = dpins["srmnist_surrogate"]
    fp_match = all(fp[k] == fp_pin[k] for k in fp)
    srm_fwd_by = srm["train_launches"]["forward_by_batch"]
    srm_bwd_by = srm["train_launches"]["bwd_blocks_by_batch"]
    smodel, sparams = handles["model"], handles["params"]
    srm_profile = trace_gradient(smodel, sparams,
                                 generator=torch.Generator(device=dev).manual_seed(5))
    srm_failures, srm_src = rmnist_check_pins(srm, "semisupervised", srm["data"] == "mnist")
    inner, outer = srm["inner_cg"], srm["outer_cg"]
    print(f"  data {srm['data']}; fingerprint {'matches' if fp_match else 'DIFFERS from'} "
          f"dataset_pins.json (built with scipy {fp_pin['scipy']}; this machine's scipy "
          f"{scipy.__version__})")
    print(f"  layout {srm['layout']} S={srm['max_blocks']} row blocks={srm['num_row_blocks']}; "
          f"{srm['loss_evaluations']} loss evaluations in {srm['phase_s']['training']:.2f} s (median epoch "
          f"{srm['epoch_s_median']:.4f} s, first {srm['epoch_s_first']:.3f} s); phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in srm["phase_s"].items()))
    print(f"  training launches: forward {srm['train_launches']['forward']} by width "
          f"{srm_fwd_by}, K3 {srm['train_launches']['bwd_blocks']} by width {srm_bwd_by}; "
          f"eval forward by width {srm['eval_forward_launches_by_batch']}")
    print(f"  inner CG per Schur apply: mean {inner.get('mean', 0):.3f}, max {inner.get('max', 0)} "
          f"({inner['solves']} solves); outer CG: mean {outer.get('mean', 0):.3f}, max "
          f"{outer.get('max', 0)} ({outer['solves']} solves); training peak "
          f"{srm['train_peak_mem_bytes'] / 1e9:.3f} GB")
    print(f"  IMGP RMSE {srm['rmse_manifold']:.6f} NLL {srm['nll_manifold']:.6f}; vanilla RMSE "
          f"{srm['rmse_vanilla']:.6f} NLL {srm['nll_vanilla']:.6f}; LOBPCG basis "
          f"{srm['phase_s']['basis']:.3f} s, vanilla {srm['phase_s']['vanilla']:.2f} s")
    print(f"  one gradient at the trained point: wall {srm_profile['wall_ms']:.1f} ms, device "
          f"{srm_profile['device_ms']:.1f} ms, idle {srm_profile['device_idle_share']:.3f}")
    print(f"  check-pins ({srm_src}): {'OK' if not srm_failures else srm_failures}")
    srm.update(fingerprint=fp, fingerprint_matches=fp_match, scipy=scipy.__version__,
               launches=srm_all, gradient_profile=srm_profile)
    report["srmnist_semisup"] = srm
    for key in ("imgp_loss", "rmse_manifold", "nll_manifold", "rmse_vanilla", "nll_vanilla"):
        if not np.isfinite(srm[key]):
            fail(f"SRMNIST semisupervised {key} is not finite: {srm[key]}")
    # the Schur path's widths: SLQ probes (cfg.num_probes = 64) and the
    # quadratic term (1) with their backwards, average_variance's 100
    for width in ("64", "100", "1"):
        if srm_fwd_by.get(width, 0) <= 0:
            fail(f"SRMNIST training made no forward launch at B = {width}: {srm_fwd_by}")
    for width in ("64", "1"):
        if srm_bwd_by.get(width, 0) <= 0:
            fail(f"SRMNIST training made no K3 launch at B = {width}: {srm_bwd_by}")
    if srm_failures:
        fail(f"SRMNIST semisupervised check-pins: {srm_failures}")
    # both kernels against their plain versions at SRMNIST's layout
    srm["kernel_vs_plain"] = hold_at_layout(
        smodel, sparams, "srmnist", (1, 64, LOBPCG_MODES, 3 * LOBPCG_MODES), (1, 64, 100), 11, dev)
    del handles, smodel, sparams

    phase("phase 11a: SRMNIST supervised (100 labeled, dense, 500 epochs)")
    rp.reset_launch_counts()
    srm_sup = run_rmnist("supervised", device=dev, cache_dir=cache.name)
    srm_sup_launches = rp.launch_snapshot()
    cache.cleanup()
    sup_failures, sup_src = rmnist_check_pins(srm_sup, "supervised", srm_sup["data"] == "mnist")
    print(f"  supervised: {srm_sup['loss_evaluations']} loss evaluations, median epoch "
          f"{srm_sup['epoch_s_median']:.4f} s; IMGP RMSE {srm_sup['rmse_manifold']:.6f} NLL "
          f"{srm_sup['nll_manifold']:.6f}; vanilla RMSE {srm_sup['rmse_vanilla']:.6f} NLL "
          f"{srm_sup['nll_vanilla']:.6f}; phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in srm_sup["phase_s"].items()))
    print(f"  supervised launches {srm_sup_launches}; check-pins ({sup_src}): "
          f"{'OK' if not sup_failures else sup_failures}")
    srm_sup["launches"] = srm_sup_launches
    report["srmnist_sup"] = srm_sup
    for key in ("imgp_loss", "rmse_manifold", "nll_manifold", "rmse_vanilla", "nll_vanilla"):
        if not np.isfinite(srm_sup[key]):
            fail(f"SRMNIST supervised {key} is not finite: {srm_sup[key]}")
    if srm_sup_launches["forward"] or srm_sup_launches["bwd_blocks"] or srm_sup_launches["dia"]:
        fail(f"the dense supervised SRMNIST launched a kernel: {srm_sup_launches}")
    if sup_failures:
        fail(f"SRMNIST supervised check-pins: {sup_failures}")

    # -- phase 11b: the 1-D dumbbell at the reference's pretrained values -------
    phase("phase 11b: dumbbell-pretrained vs the JAX pins (examples_torch/dataset_pins.json)")
    ppins = dpins["dumbbell_pretrained"]
    wpin = ppins["f64_witness"]
    jax_idx = np.asarray(ppins["knn_idx"])
    rp.reset_launch_counts()
    shared = eval_pretrained.run_experiment(device=dev, knn_idx=jax_idx)
    own = eval_pretrained.run_experiment(device=dev)
    wh = {}
    wf32 = eval_pretrained.run_experiment(device=dev, seeds=0, knn_idx=jax_idx,
                                          eigensolver="host_f64", handles=wh)
    with torch.no_grad():
        witness = eval_pretrained.f64_witness(wh, jax_idx,
                                              lambda a: torch.as_tensor(a, device=dev))
    model_f64 = eval_pretrained.model_metrics_in_f64(wh, witness["z"])
    pre_launches = rp.launch_snapshot()
    del wh
    x1, _, _ = manifold_1D_dataset()
    x1t = torch.as_tensor(x1, device=dev)
    ties = eval_pretrained.tie_only_difference(
        x1, knn_search(x1t, x1t, 10, self_query=True)[1].cpu().numpy(), jax_idx)
    pre_fail = []
    for label, rec in (("JAX's graph", shared), ("own search", own)):
        st = rec["imgp_nll_reference_metric"]
        rels = {k: rec[k] / ppins[k] - 1.0 for k in PRETRAINED_RTOL}
        print(f"  {label}: " + ", ".join(f"{k} {rec[k]:.6f} (pin {ppins[k]:.6f}, rel {rels[k]:+.2e})"
                                         for k in PRETRAINED_RTOL))
        print(f"    reference stochastic metric, {st['seeds']} seeds: {st['mean']:.4f} +/- "
              f"{st['sd']:.4f} (reference notebook -3.2100; JAX "
              f"{ppins['imgp_nll_reference_metric']['mean']:.4f} +/- "
              f"{ppins['imgp_nll_reference_metric']['sd']:.4f})")
        if label == "JAX's graph":
            pre_fail += [f"{k} rel {rels[k]:.2e} > {tol}" for k, tol in PRETRAINED_RTOL.items()
                         if not abs(rels[k]) <= tol]
        if not all(np.isfinite(rec[k]) for k in PRETRAINED_RTOL):
            pre_fail.append(f"{label}: non-finite metric")
    w_rels = {k: witness[k] / wpin[k] - 1.0 for k in ("rmse", "nll", "cond")}
    m_rels = {k: model_f64[k] / witness[k] - 1.0 for k in ("rmse", "nll")}
    own_gap = {k: wf32[f"imgp_{k}"] / witness[k] - 1.0 for k in ("rmse", "nll")}
    print(f"  f64 witness (host f64 basis, JAX's kNN): " + ", ".join(
        f"{k} {witness[k]:.8g} (JAX {wpin[k]:.8g}, rel {w_rels[k]:+.2e})" for k in w_rels)
        + f"; threshold {WITNESS_RTOL:.0e}")
    print(f"  the port's posterior code in f64 on those features: " + ", ".join(
        f"{k} rel {v:+.2e}" for k, v in m_rels.items()) + f" (threshold {MODEL_F64_RTOL:.0e})")
    print(f"  f32 on that basis vs the f64 witness: card " + ", ".join(
        f"{k} {v:+.2e}" for k, v in own_gap.items()) + "; JAX " + ", ".join(
            f"{k} {wpin['f32']['imgp_' + k] / wpin[k] - 1.0:+.2e}" for k in own_gap))
    print(f"  the card's kNN vs JAX's: {ties}")
    report["dumbbell_pretrained"] = {
        "jax_graph": shared, "own_graph": own, "knn_vs_jax": ties, "launches": pre_launches,
        "f64_witness": {**{k: witness[k] for k in w_rels}, "rel_to_jax": w_rels,
                        "model_f64": model_f64, "model_f64_rel": m_rels,
                        "f32": {k: wf32[k] for k in ("imgp_rmse", "imgp_nll")},
                        "f32_rel_to_witness": own_gap}}
    pre_fail += [f"f64 witness {k} rel {v:.2e} > {WITNESS_RTOL}" for k, v in w_rels.items()
                 if not abs(v) <= WITNESS_RTOL]
    pre_fail += [f"the posterior code in f64: {k} rel {v:.2e} > {MODEL_F64_RTOL}"
                 for k, v in m_rels.items() if not abs(v) <= MODEL_F64_RTOL]
    if not ties["ties_only"]:
        pre_fail.append(f"the card's kNN differs from JAX's beyond ties: {ties}")
    if pre_launches["forward"] or pre_launches["bwd_blocks"] or pre_launches["dia"]:
        pre_fail.append(f"the dense 1-D evaluation launched a kernel: {pre_launches}")
    if pre_fail:
        fail(f"dumbbell pretrained evaluation: {pre_fail}")

    # -- phase 12: the dragon mesh, supervised on block-ELL ---------------------
    phase("phase 12: dragon4k (run_2d.py, 100 epochs)")
    torch.cuda.empty_cache()
    handles = {}
    rp.reset_launch_counts()
    dragon = run_dragon(device=dev, vanilla_max_iter=DRAGON_VANILLA_EPOCHS, handles=handles)
    dragon_all = rp.launch_snapshot()
    drg_fwd_by = dragon["train_launches"]["forward_by_batch"]
    drg_bwd_by = dragon["train_launches"]["bwd_blocks_by_batch"]
    dragon["launches"] = dragon_all
    report["dragon"] = dragon
    print(f"  layout {dragon['layout']} S={dragon['max_blocks']} row blocks="
          f"{dragon['num_row_blocks']}; {dragon['loss_evaluations']} loss evaluations in "
          f"{dragon['train_s']:.2f} s (median epoch {dragon['epoch_s_median']:.4f} s); CG "
          f"{dragon['cg']}; eval {dragon['eval_s']:.2f} s, vanilla {dragon['vanilla_s']:.2f} s")
    print(f"  training launches: forward {dragon['train_launches']['forward']} by width "
          f"{drg_fwd_by}, K3 {dragon['train_launches']['bwd_blocks']} by width {drg_bwd_by}")
    print(f"  IMGP RMSE {dragon['imgp_rmse']:.6f} NLL {dragon['imgp_nll']:.6f} (JAX recorded "
          f"0.0434 / -1.6139, PARITY.md); vanilla ({DRAGON_VANILLA_EPOCHS} epochs) RMSE "
          f"{dragon['vanilla_rmse']:.6f} NLL {dragon['vanilla_nll']:.6f}")
    for key in ("imgp_loss", "imgp_rmse", "imgp_nll", "vanilla_rmse", "vanilla_nll"):
        if not np.isfinite(dragon[key]):
            fail(f"dragon {key} is not finite: {dragon[key]}")
    if not dragon["params_finite"]:
        fail("the dragon's trained hyperparameters are not finite")
    for width in ("64", "1"):
        if drg_fwd_by.get(width, 0) <= 0:
            fail(f"the dragon's training made no forward launch at B = {width}: {drg_fwd_by}")
    if dragon["train_launches"]["bwd_blocks"] <= 0:
        fail("the dragon's training launched no panel cotangent (K3)")
    if not dragon["imgp_rmse"] < DRAGON_RMSE_MAX:
        fail(f"dragon IMGP RMSE {dragon['imgp_rmse']} >= {DRAGON_RMSE_MAX}")
    # both kernels against their plain versions at the dragon's layout (S = 5)
    dragon["kernel_vs_plain"] = hold_at_layout(
        handles["model"], handles["params"], "dragon", (1, 64, LOBPCG_MODES), (1, 64), 12, dev)
    del handles

    paths = {
        "forward": {"srmnist_semisup": srm_all["forward"],
                    "srmnist_semisup_train_by_batch": srm_fwd_by,
                    "srmnist_semisup_eval_by_batch": srm["eval_forward_launches_by_batch"],
                    "srmnist_sup": srm_sup_launches["forward"],
                    "dragon": dragon_all["forward"], "dragon_train_by_batch": drg_fwd_by},
        "bwd_blocks": {"srmnist_semisup": srm_all["bwd_blocks"],
                       "srmnist_semisup_by_batch": srm_bwd_by,
                       "srmnist_sup": srm_sup_launches["bwd_blocks"],
                       "dragon": dragon_all["bwd_blocks"], "dragon_by_batch": drg_bwd_by},
        "required": [srm_all["forward"], srm_all["bwd_blocks"], dragon_all["forward"],
                     dragon_all["bwd_blocks"]],
    }
    return report, paths


def production_campaign(dev) -> tuple:
    """Phases 13, 13a and 13b: the JAX package's production campaign cycle
    through ``examples_torch/run_large.py::run_campaign`` (twice, in one
    fresh cache directory), the graph backends side by side, and multi-start
    training. Returns their report entries and the kernels line's launch
    counts of these paths (as ``reference_protocols`` does)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from examples_torch import reference_protocol as rp
    from examples_torch.run_large import (
        campaign_data,
        campaign_graph_backend,
        cloud_model,
        loss_and_grad,
        run_campaign,
        torus_points,
    )
    from manifold_gp_torch.kernels.riemann import _panel_dtype_of
    from manifold_gp_torch.ops.graph import pin_self_match, symmetrize_knn_edges
    from manifold_gp_torch.ops.knn import ivf_build, ivf_search, knn_search
    from manifold_gp_torch.utils import (
        manifold_informed_train,
        multi_start_train,
        random_restarts,
    )
    from manifold_gp_torch.utils import native

    report = {}

    # -- phase 13: the torus campaign, twice, one fresh cache ------------------
    phase("phase 13: the 262,144-point torus campaign (run_campaign) twice in one fresh cache")
    torch.cuda.empty_cache()
    cache = tempfile.mkdtemp(prefix="mgp_campaign_")
    kw = dict(n=CAMPAIGN_N, manifold="torus", epochs=CAMPAIGN_EPOCHS, checkpoint_every=1,
              precond_refresh=1, cache_dir=cache, device=dev)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        rp.reset_launch_counts()
        t0 = time.perf_counter()
        first, params, model = run_campaign(metrics_path=f"{cache}/metrics.jsonl", **kw)
        first_s = time.perf_counter() - t0
        first_launches = rp.launch_snapshot()
        first_peak = torch.cuda.max_memory_allocated(dev)
        metric_rows = len(pathlib.Path(cache, "metrics.jsonl").read_text().splitlines())
        ckpt = sorted(p.name for p in pathlib.Path(cache).glob("campaign_*.ckpt.npz"))
        t0 = time.perf_counter()
        second, _, _ = run_campaign(**kw)
        second_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    same = {key: first[key] == second[key] for key in CAMPAIGN_SAME}
    # the library's own determinism, in PyTorch's default mode: one loss and
    # its gradients at the trained point, evaluated again from the same probes
    repeats = [loss_and_grad(model, params, generator=torch.Generator(device=dev).manual_seed(5))
               for _ in range(GRAD_REPEATS)]
    repeat_same = all(r == repeats[0] for r in repeats[1:])
    print(f"  graph [{first['graph_backend']}] {first['graph_build_s']:.2f} s, "
          f"{first['num_edges']} edges; layout {first['layout_s']:.2f} s; CG iterations initial "
          f"{first['cg_iters_initial']}, trained {first['cg_iters_trained']}")
    print(f"  {CAMPAIGN_EPOCHS} epochs {first['train_s']:.2f} s (epochs "
          + ", ".join(f"{t:.3f}" for t in first["epoch_s"]) + " s); basis "
          f"{first['basis_s']:.2f} s; eval {first['eval_s']:.2f} s; first run {first_s:.1f} s, "
          f"peak {first_peak / 1e9:.3f} GB")
    print(f"  RMSE vs truth {first['value']:.6f} (noise floor {first['noise_floor_rmse']:.6f}); "
          f"noisy test RMSE {first['rmse_noisy_test']:.6f} NLL {first['nll_noisy_test']:.6f}; "
          f"final loss {first['final_loss']:.6f}; trained bandwidth "
          f"{first['graphbandwidth_trained']:.6f} lengthscale {first['lengthscale_trained']:.6f} "
          f"noise {first['noise_trained']:.6g} outputscale {first['outputscale_trained']:.6f}")
    print(f"  launches over the first run: forward {first_launches['forward']} by width "
          f"{first_launches['forward_by_batch']}, K3 {first_launches['bwd_blocks']} by width "
          f"{first_launches['bwd_blocks_by_batch']}; metrics rows {metric_rows}; checkpoint {ckpt}")
    print(f"  second run {second_s:.1f} s: graph hit {second['graph_cache_hit']} "
          f"({second['graph_build_s']:.2f} s), basis hit {second['basis_cache_hit']} "
          f"({second['basis_s']:.3f} s), {CAMPAIGN_EPOCHS} epochs {second['train_s']:.2f} s; "
          f"identical: {all(same.values())}")
    print(f"  {GRAD_REPEATS} loss-and-gradient evaluations at the trained point from one "
          f"probe seed: loss {repeats[0][0]!r}, equal bit for bit: {repeat_same}")
    report["campaign"] = {"first": first, "second": second, "grad_repeats": repeats,
                          "grad_repeats_same": repeat_same, "first_s": first_s,
                          "second_s": second_s, "first_peak_mem_bytes": first_peak,
                          "launches": first_launches, "metrics_rows": metric_rows,
                          "checkpoints": ckpt, "identical": same}
    if first["graph_cache_hit"] or first["basis_cache_hit"]:
        fail("the campaign's first run hit a cache in a fresh directory")
    if not (second["graph_cache_hit"] and second["basis_cache_hit"]):
        fail("the campaign's second run missed a cache")
    if not first["graph_backend"].startswith("ivf-"):
        fail(f"the 262k campaign built its graph with {first['graph_backend']}, not IVF")
    if not all(same.values()):
        fail(f"the second campaign run differs from the first: {same}")
    if not repeat_same:
        fail(f"the loss and gradients at the trained point differ between evaluations: {repeats}")
    if not first["value"] < first["noise_floor_rmse"]:
        fail(f"campaign RMSE vs truth {first['value']} >= noise floor {first['noise_floor_rmse']}")
    if not (np.isfinite(first["final_loss"]) and np.isfinite(first["nll_noisy_test"])):
        fail("the campaign's loss or NLL is not finite")
    if first_launches["forward"] <= 0 or first_launches["bwd_blocks"] <= 0:
        fail(f"the campaign launched no forward kernel or no K3: {first_launches}")
    if metric_rows != CAMPAIGN_EPOCHS or not ckpt:
        fail(f"the campaign wrote {metric_rows} metrics rows and checkpoints {ckpt}")
    # the campaign's layout: f32 panels at the basis's widths, bf16 panels
    # (the training's) at the trainer's, K3 at the trainer's
    report["campaign"]["kernel_vs_plain"] = hold_at_layout(
        model, params, "campaign", (1, 48, 100, 125), (1, 48), 13, dev) + hold_at_layout(
        model, params, "campaign", (1, 48, 100), (), 14, dev, panel_dtype=torch.bfloat16)
    del model, params

    # -- phase 13a: graph backends side by side -------------------------------
    phase("phase 13a: graph backends on the campaign's training points")
    torch.cuda.empty_cache()
    train_x = campaign_data(CAMPAIGN_N, 2048, 0, "torus")[0]
    n_tr, k = train_x.shape[0], 16
    xt = torch.from_numpy(train_x).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (sqd_e, idx_e), exact_search_s = timed(lambda: knn_search(xt, xt, k, self_query=True))
    g_exact, exact_host_s = timed(lambda: symmetrize_knn_edges(
        sqd_e.cpu().numpy(), idx_e.cpu().numpy(), n_tr, x=train_x, device=dev))
    backend, ivf_kw = campaign_graph_backend(n_tr, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    index, ivf_build_s = timed(lambda: ivf_build(xt, nlist=ivf_kw["ivf_nlist"],
                                                 kmeans_iters=ivf_kw["ivf_kmeans_iters"]))
    (sqd_i, idx_i), ivf_search_s = timed(lambda: ivf_search(
        index, xt, k, nprobe=ivf_kw["ivf_nprobe"], self_query=True))
    ivf_peak = torch.cuda.max_memory_allocated(dev)
    # the k-means sums run in a fixed order: a second build is the same index
    again = ivf_build(xt, nlist=ivf_kw["ivf_nlist"], kmeans_iters=ivf_kw["ivf_kmeans_iters"])
    ivf_repeats = bool(torch.equal(again.centroids, index.centroids)
                       and torch.equal(again.lists, index.lists))
    del again
    g_ivf, ivf_host_s = timed(lambda: symmetrize_knn_edges(
        sqd_i.cpu().numpy(), idx_i.cpu().numpy(), n_tr, x=train_x, device=dev))
    # recall of the k - 1 neighbours past the self-match
    recall = float((idx_i[:, 1:, None] == idx_e[:, None, 1:]).any(-1).float().mean())
    e_exact, e_ivf = edge_keys(g_exact), edge_keys(g_ivf)
    common = np.intersect1d(e_exact, e_ivf).size
    graphs = {
        "n": n_tr, "k": k,
        "exact": {"search_s": exact_search_s, "host_s": exact_host_s,
                  "build_graph_s": exact_search_s + exact_host_s, "num_edges": int(e_exact.size)},
        "ivf": {"backend": backend, "nlist": index.nlist, "list_width": int(index.lists.shape[1]),
                "kmeans_build_s": ivf_build_s, "search_s": ivf_search_s, "host_s": ivf_host_s,
                "build_graph_s": ivf_build_s + ivf_search_s + ivf_host_s,
                "num_edges": int(e_ivf.size), "peak_mem_bytes": ivf_peak},
        "ivf_recall": recall,
        "ivf_build_repeats": ivf_repeats,
        "edges_differ_share": 1.0 - common / e_exact.size,
        "ivf_only_edges": int(e_ivf.size - common),
    }
    print(f"  exact (device) {graphs['exact']['build_graph_s']:.2f} s = search "
          f"{exact_search_s:.2f} + host {exact_host_s:.2f}, {e_exact.size} edges")
    print(f"  IVF [{backend}] {graphs['ivf']['build_graph_s']:.2f} s = k-means and lists "
          f"{ivf_build_s:.2f} + search {ivf_search_s:.2f} + host {ivf_host_s:.2f}, "
          f"{e_ivf.size} edges; {index.nlist} lists, width {index.lists.shape[1]}; peak "
          f"{ivf_peak / 1e9:.3f} GB")
    print(f"  IVF recall@{k - 1} {recall:.6f}; edges of the exact graph missing from IVF's "
          f"{graphs['edges_differ_share']:.6f}; IVF-only edges {graphs['ivf_only_edges']}; "
          f"a second IVF build equal bit for bit: {ivf_repeats}")
    del xt, sqd_e, idx_e, sqd_i, idx_i, index, g_exact, g_ivf

    # the brute-force host search against the exact device search
    x_host = torus_points(HOST_KNN_N, seed=0)[0]
    _, native_build_s = timed(native.build_native)
    # build_graph's "host" steps: the search, the self pin, the host tail
    (sqd_h, idx_h), host_search_s = timed(lambda: native.knn_search_host(x_host, x_host, k))
    self_moved = int((idx_h[:, 0] != np.arange(HOST_KNN_N)).sum())
    (sqd_h, idx_h), pin_s = timed(lambda: pin_self_match(sqd_h, idx_h))
    g_host, host_host_s = timed(lambda: symmetrize_knn_edges(sqd_h, idx_h, HOST_KNN_N, x=x_host,
                                                             device=dev))
    xh_t = torch.from_numpy(x_host).to(dev)
    (sqd_d, idx_d), dev_search_s = timed(lambda: knn_search(xh_t, xh_t, k, self_query=True))
    g_dev, dev_host_s = timed(lambda: symmetrize_knn_edges(
        sqd_d.cpu().numpy(), idx_d.cpu().numpy(), HOST_KNN_N, x=x_host, device=dev))
    h_keys, d_keys = edge_keys(g_host), edge_keys(g_dev)
    tie_gap = knn_tie_gap(x_host, idx_h, idx_d.cpu().numpy())
    graphs["host_vs_device"] = {
        "n": HOST_KNN_N, "native_build_s": native_build_s,
        "host_search_s": host_search_s, "self_match_moved_rows": self_moved,
        "host_build_graph_s": host_search_s + pin_s + host_host_s,
        "device_search_s": dev_search_s, "device_build_graph_s": dev_search_s + dev_host_s,
        "host_edges": int(h_keys.size), "device_edges": int(d_keys.size),
        "edges_differ": int(np.setxor1d(h_keys, d_keys).size), **tie_gap}
    hv = graphs["host_vs_device"]
    print(f"  {HOST_KNN_N} points: host brute force {hv['host_build_graph_s']:.2f} s (search "
          f"{host_search_s:.2f}; g++ build {native_build_s:.2f} s, not in it) against the "
          f"device's {hv['device_build_graph_s']:.2f} s (search {dev_search_s:.2f}); edges "
          f"{hv['host_edges']} / {hv['device_edges']}, {hv['edges_differ']} differ on "
          f"{hv['rows_differ']} rows (the host search left {self_moved} self-matches out of "
          f"column 0: f32 ties at distance 0); largest f64 excess over a row's true k-th "
          f"distance: host "
          f"{hv['host_excess']:.3g}, device {hv['device_excess']:.3g} (ties within {TIE_SQDIST})")
    report["graph_backends"] = graphs
    if not recall >= IVF_RECALL_MIN:
        fail(f"IVF recall {recall} < {IVF_RECALL_MIN}")
    if not ivf_repeats:
        fail("a second IVF build on the same points gave another index")
    if max(hv["host_excess"], hv["device_excess"]) > TIE_SQDIST:
        fail(f"the host and device searches differ beyond ties: {hv}")
    del xh_t, g_host, g_dev

    # -- phase 13b: multi-start training ---------------------------------------
    phase(f"phase 13b: multi_start_train, {RESTARTS} random restarts x {RESTART_STEPS} steps, "
          "on the 10,010-point SRMNIST-shaped cloud (k = 50)")
    torch.cuda.empty_cache()
    cmodel = cloud_model(device=dev)
    inits = random_restarts(cmodel, 0, RESTARTS, graphbandwidth_range=(0.3, 1.0),
                            lengthscale_range=(0.5, 5.0))
    rp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, best_loss, losses = multi_start_train(cmodel, inits, lr=0.1, max_iter=RESTART_STEPS - 1)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    ms_launches = rp.launch_snapshot()
    single_init = {key: v.detach().clone() for key, v in inits[0].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manifold_informed_train(cmodel, single_init, lr=0.1, max_iter=RESTART_STEPS - 1,
                            tolerance=1e-2, num_rand_vec=100)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    layout = cmodel.kernel.block_layout
    losses = [float(v) for v in losses]
    multi = {"restarts": RESTARTS, "steps": RESTART_STEPS, "losses": losses, "best": best_loss,
             "best_index": int(np.argmin(losses)), "seconds": multi_s,
             "s_per_restart": multi_s / RESTARTS, "single_train_s": single_s,
             "launches": ms_launches, "max_blocks": int(layout.max_blocks),
             "num_row_blocks": int(layout.num_row_blocks),
             "inits": [{"graphbandwidth": float(cmodel.kernel.graphbandwidth(p)),
                        "lengthscale": float(cmodel.kernel.lengthscale(p))} for p in inits]}
    print(f"  layout S={multi['max_blocks']} row blocks={multi['num_row_blocks']}; inits "
          + ", ".join(f"({i['graphbandwidth']:.3f}, {i['lengthscale']:.3f})" for i in multi["inits"]))
    print(f"  final losses {[round(v, 6) for v in losses]}, best {multi['best_index']}; "
          f"{multi_s:.2f} s, {multi['s_per_restart']:.3f} s a restart against "
          f"{single_s:.3f} s for one manifold_informed_train of {RESTART_STEPS} epochs "
          f"(with its two outputscale estimates)")
    print(f"  launches: forward {ms_launches['forward']} by width "
          f"{ms_launches['forward_by_batch']}, K3 {ms_launches['bwd_blocks']}")
    report["multistart"] = multi
    if not all(np.isfinite(losses)):
        fail(f"multi-start losses are not finite: {losses}")
    if best_loss != min(losses) or not all(torch.isfinite(v).all() for v in best.values()):
        fail(f"multi-start best {best_loss} is not the argmin of {losses}, or not finite")
    if ms_launches["forward"] <= 0 or ms_launches["bwd_blocks"] <= 0:
        fail(f"multi-start launched no forward kernel or no K3: {ms_launches}")
    multi["kernel_vs_plain"] = hold_at_layout(
        cmodel, best, "multistart", (1, 64), (1, 64), 15, dev,
        panel_dtype=_panel_dtype_of(cmodel.kernel.cfg))
    del cmodel, best, inits

    paths = {
        "forward": {"campaign": first_launches["forward"],
                    "campaign_by_batch": first_launches["forward_by_batch"],
                    "multistart": ms_launches["forward"],
                    "multistart_by_batch": ms_launches["forward_by_batch"]},
        "bwd_blocks": {"campaign": first_launches["bwd_blocks"],
                       "campaign_by_batch": first_launches["bwd_blocks_by_batch"],
                       "multistart": ms_launches["bwd_blocks"]},
        "required": [first_launches["forward"], first_launches["bwd_blocks"],
                     ms_launches["forward"], ms_launches["bwd_blocks"]],
    }
    return report, paths


MESH_LOSS_RTOL = 1e-4  # phase 14/14a: mesh loss vs one device (the parity pins' tolerance)
MESH_GRAD_RTOL = 5e-3  # of the largest gradient (the parity pins' tolerance)
MESH_EIG_TOL = 2e-5  # of the Gershgorin bound: mesh LOBPCG eigenvalues, all 100 modes,
# vs one device's LOBPCG in the mesh's padded row order (``row_order_witness``); vs one
# device's node-order basis on the lowest MESH_EIG_MODES: the block's top modes still
# rotate after 200 iterations (phase 3L reads them up to 9 % off Chebyshev's), and the
# witness gives how far the row order alone moves them (printed)
MESH_EIG_MODES = 90
MESH_EXCHANGE_RTOL = 1e-6  # phase 14a: halo vs gather exchange, loss
MESH_WS2_N = 16_384  # phase 14a: the torus size two processes share the card at
MESH_RANK_TIMEOUT_S = 300  # phase 14a: a rank that passes this fails the phase
MESH_SHARDS = 4  # phase 14b: the world size whose shard layouts are held
# the widths the mesh paths run each kernel at: training's bf16 forward at B = 1
# (the mean solve), 48 (the probes) and 100 (the average variance), the basis's f32
# forward at B = 100 and 300, and K3 (f32 out) at B = 1 and 48
MESH_FWD_WIDTHS = {"bfloat16": (1, 12, 24, 25, 48, 50, 100), "float32": (100, 300)}
MESH_BWD_WIDTHS = (1, 12, 24, 25, 48, 50)
# the probe split's widths (phase 14a): the torus training's 48 probes and 100
# one-hot columns of the average variance over 2 and 4 ranks; K3 also with bf16 out
PROBE_SPLIT_WIDTHS = (12, 24, 25, 50)
PROBE_SPLIT_PROBES, PROBE_SPLIT_ONE_HOT = 48, 100


def _mesh_rank_ws2(rank: int, world_size: int, workdir: str):
    """One rank of phase 14a (started by torch.multiprocessing, spawn): the
    16,384-point torus on a gloo mesh of ``world_size`` processes sharing
    the card; writes its numbers to ``workdir``/rank<r>.json."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from examples_torch.run_large import CAMPAIGN_HYPERS, INITIAL_HYPERS, loss_and_grad
    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.ops.graph import graph_from_edges
    from manifold_gp_torch.parallel import init_distributed, make_mesh
    from manifold_gp_torch.parallel.block_spmv import (
        exchange_name,
        make_sharded_matern_precision_matvec_fused,
    )
    from manifold_gp_torch.parameters import GreaterThan
    from manifold_gp_torch.utils import manifold_informed_train

    work = pathlib.Path(workdir)
    init_distributed(backend="gloo", init_method=f"file://{work / 'store'}",
                     world_size=world_size, rank=rank, timeout_s=120)
    mesh = make_mesh(device="cuda")
    data = np.load(work / "inputs.npz")
    spec = json.loads((work / "spec.json").read_text())
    cfg = InferenceConfig(**spec["cfg"])
    graph = graph_from_edges(data["rows"], data["cols"], data["sqdist"], int(data["n"]),
                             device=mesh.device)
    kernel = RiemannMaternKernel(
        nu=2, x=data["x"], nearest_neighbors=spec["k"], laplacian_normalization="randomwalk",
        num_modes=spec["num_modes"], bump_scale=10.0, cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(spec["gb_min"]), mesh=mesh)
    model = RiemannGP(data["x"], data["y"], kernel, cfg=cfg)
    probes = torch.from_numpy(data["probes"]).to(mesh.device)
    out = {"rank": rank, "device": str(mesh.device), "halo": kernel._mesh_fused.halo}
    def gather_operator(params, coeffs=None, permuted_io=False):
        # the kernel's fused mesh operator, with the whole-vector gather exchange
        c = kernel.coeffs(params) if coeffs is None else coeffs
        return make_sharded_matern_precision_matvec_fused(
            kernel._mesh_fused, c, kernel.nu, kernel.lengthscale(params),
            kernel.laplacian_normalization,
            dtype=torch.bfloat16 if cfg.spmv_dtype == "bfloat16" else None,
            grad_space=cfg.solve_cotangent, exchange="gather")

    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    t0 = time.perf_counter()
    for exchange in ("auto", "gather"):
        if exchange == "gather":
            kernel.precision_matvec = gather_operator
        value, grads = loss_and_grad(model, model.init_params(**INITIAL_HYPERS), probes=probes)
        out[exchange] = {"exchange": exchange_name(kernel._mesh_fused, exchange),
                         "loss": value, "grads": grads}
    del kernel.precision_matvec  # back to the class's operator
    params, _, history = manifold_informed_train(
        model, model.init_params(**INITIAL_HYPERS), lr=0.1, max_iter=2, tolerance=1e-2,
        num_rand_vec=100, seed=0)
    out["history"] = history
    out["param_bits"] = {k: np.asarray(v.detach().cpu().numpy(), np.float32).view(
        np.uint32).tolist() for k, v in params.items()}
    kernel.cfg = cfg.replace(eigensolver="lobpcg")
    eigval, _ = kernel.eval_basis(kernel.init_params(
        graphbandwidth=CAMPAIGN_HYPERS["graphbandwidth"],
        lengthscale=CAMPAIGN_HYPERS["lengthscale"]))
    torch.cuda.synchronize()
    out["eigval"] = eigval.cpu().numpy().tolist()
    out["seconds"] = time.perf_counter() - t0
    out["forward_launches"] = cuda_spmv.launch_count
    out["bwd_blocks_launches"] = cuda_spmv.bwd_launch_count
    out["knn"] = _rank_sharded_knn(mesh, data, spec["k"])
    out["probe"] = _rank_probe_split(mesh, data, spec, cfg, graph, probes)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _rank_sharded_knn(mesh, data, k: int) -> dict:
    """Phase 14a, on a rank: ``build_graph_sharded`` (replicated) on the
    raw training points against the parent's exact graph, the sharded IVF
    search on the parent's index against its ``ivf_search``, and the ring
    schedule, which must raise on a gloo group over CUDA tensors."""
    import numpy as np
    import torch

    from manifold_gp_torch.ops.knn import IVFIndex
    from manifold_gp_torch.parallel import (
        build_graph_sharded,
        sharded_ivf_search,
        sharded_knn_search,
    )

    dev = mesh.device
    n = int(data["n"])
    xr = torch.from_numpy(data["x_raw"]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = build_graph_sharded(xr, k, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    keys = np.sort(g.rows.cpu().numpy().astype(np.int64) * n + g.cols.cpu().numpy())
    exact = np.sort(data["rows"].astype(np.int64) * n + data["cols"])
    index = IVFIndex(centroids=torch.from_numpy(data["ivf_centroids"]).to(dev),
                     lists=torch.from_numpy(data["ivf_lists"]).to(dev),
                     list_mask=torch.from_numpy(data["ivf_mask"]).to(dev), database=xr)
    d, i = sharded_ivf_search(index, xr, k, mesh, nprobe=int(data["ivf_nprobe"]),
                              self_query=True)
    ivf_equal = bool(np.array_equal(i.cpu().numpy(), data["ivf_i"])
                     and np.array_equal(d.cpu().numpy(), data["ivf_d"]))
    try:
        sharded_knn_search(xr, xr, k, mesh, schedule="ring")
        ring = None
    except RuntimeError as exc:
        ring = str(exc)
    return {"build_graph_s": build_s, "num_edges": int(keys.size),
            "edges_differ": int(np.setxor1d(keys, exact).size), "ivf_equal": ivf_equal,
            "ring_raised": ring}


def _rank_probe_split(mesh, data, spec, cfg, graph, probes) -> dict:
    """Phase 14a, on a rank: a single-device model on the card under a
    user's ``use_mesh``: its 48 probe columns split 24 / 24 over the two
    ranks and its 100 one-hot columns 50 / 50. One loss and gradient (the
    collectives it took, the seconds of a second one), the average
    variance, and 3 epochs of training (the parameters' bits)."""
    import numpy as np
    import torch

    from examples_torch.run_large import INITIAL_HYPERS, loss_and_grad
    from manifold_gp_torch import RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.parallel import mesh as pmesh
    from manifold_gp_torch.parameters import GreaterThan
    from manifold_gp_torch.utils import manifold_informed_train

    kernel = RiemannMaternKernel(
        nu=2, x=data["x"], nearest_neighbors=spec["k"], laplacian_normalization="randomwalk",
        num_modes=spec["num_modes"], bump_scale=10.0, cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(spec["gb_min"]), device=mesh.device)
    model = RiemannGP(data["x"], data["y"], kernel, cfg=cfg)
    idx = torch.from_numpy(data["one_hot_idx"]).to(mesh.device)
    fwd0, bwd0 = dict(cuda_spmv.launch_count_by_batch), dict(cuda_spmv.bwd_launch_count_by_batch)
    with pmesh.use_mesh(mesh):
        pmesh.collective_counts.clear()
        value, grads = loss_and_grad(model, model.init_params(**INITIAL_HYPERS), probes=probes)
        per_grad = dict(pmesh.collective_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grad(model, model.init_params(**INITIAL_HYPERS), probes=probes)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        with torch.no_grad():
            avg = float(model.average_variance(model.init_params(**INITIAL_HYPERS),
                                               num_rand_vec=PROBE_SPLIT_ONE_HOT, idx=idx))
        params, _, history = manifold_informed_train(
            model, model.init_params(**INITIAL_HYPERS), lr=0.1, max_iter=2, tolerance=1e-2,
            num_rand_vec=PROBE_SPLIT_ONE_HOT, seed=0)

    def delta(now, before):
        return {str(b): c - before.get(b, 0) for b, c in sorted(now.items())
                if c - before.get(b, 0)}

    return {"loss": value, "grads": grads, "collectives_per_gradient": per_grad,
            "grad_s": grad_s, "avg_var": avg, "history": history,
            "param_bits": {k: np.asarray(v.detach().cpu().numpy(), np.float32).view(
                np.uint32).tolist() for k, v in params.items()},
            "forward_by_batch": delta(cuda_spmv.launch_count_by_batch, fwd0),
            "bwd_by_batch": delta(cuda_spmv.bwd_launch_count_by_batch, bwd0)}


def _grad_gap(grads, ref):
    """max |grad - ref| over the parameters, over max |ref|."""
    keys = [k for k, v in ref.items() if v is not None]
    scale = max(abs(ref[k]) for k in keys)
    return max(abs(grads[k] - ref[k]) for k in keys) / max(scale, 1e-30)


def _shard_window(tables, sh, pv):
    """Rank ``sh.rank``'s exchanged window of the global padded operand
    ``pv`` [rows, B] (as ``parallel.block_spmv._exchange`` builds it), its
    block ids and its column-block count."""
    import torch

    from manifold_gp_torch.ops.block_sparse import BLOCK

    if tables.halo is None:
        return pv, sh.block_col, tables.nrb
    own = pv[sh.row_lo:sh.row_lo + sh.lrows]
    if tables.ndev == 1 or tables.halo == 0:
        return own, sh.block_col_halo, sh.window_blocks
    width = tables.halo * BLOCK
    rows = torch.arange(-width, 0, device=pv.device) + sh.row_lo
    left = pv[rows % tables.rows]
    right = pv[(torch.arange(width, device=pv.device) + sh.row_lo + sh.lrows) % tables.rows]
    return torch.cat([left, own, right]).contiguous(), sh.block_col_halo, sh.window_blocks


def hold_shard_layouts(kernel, params, world_size: int, seed: int) -> tuple:
    """Both block-ELL kernels at every shard layout of ``world_size`` for a
    single-device kernel's graph (tables built in this process, no
    collective): the forward kernel at the mesh paths' panel types and
    widths (``MESH_FWD_WIDTHS``) and K3 (f32 out at ``MESH_BWD_WIDTHS``, bf16
    out at ``PROBE_SPLIT_WIDTHS``) on
    each shard's panels and exchanged window against their plain versions,
    and the stacked shards against the single-device product (K3 on the
    used panel slots). Returns the tables and the records; fails on a
    mismatch."""
    import numpy as np
    import torch

    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.ops.block_sparse import assemble, permute_in
    from manifold_gp_torch.parallel import mesh as pmesh
    from manifold_gp_torch.parallel.block_spmv import (
        _local_bwd_blocks,
        _local_matvec,
        assemble_sharded,
        build_mesh_block_tables,
        shard_tables,
    )

    dev = kernel.device
    layout = kernel.block_layout
    n = kernel.graph.num_nodes
    tables = build_mesh_block_tables(
        kernel.graph, pmesh.Mesh(group=None, rank=0, world_size=world_size, device=dev))
    shards = [tables.local] + [shard_tables(tables, r) for r in range(1, world_size)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    tag = f"ws={world_size}"
    records = []

    def embed(v):
        out = torch.zeros((tables.rows, v.shape[1]), device=dev)
        out[tables.row_of_node] = v
        return out

    def held(label, got, want, tol=SMALL_TOL):
        scale = float(want.abs().max())
        rel = float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)
        ok = bool(torch.isfinite(got).all()) and rel <= tol
        print(f"  {tag} {label:<44} max_rel_err={rel:.3e} (threshold {tol:.0e}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"shard layouts {tag}: {label} rel={rel}")
        return rel

    with torch.no_grad():
        c = kernel.coeffs(params)
        for dtype, widths in ((torch.bfloat16, MESH_FWD_WIDTHS["bfloat16"]),
                              (None, MESH_FWD_WIDTHS["float32"])):
            name = "float32" if dtype is None else "bfloat16"
            whole = assemble(layout, c.diag, c.triu, dtype=dtype)
            for batch in widths:
                v = torch.randn((n, batch), generator=gen, device=dev)
                pv = embed(v)
                want_all = cuda_spmv.block_matvec(layout, whole, permute_in(layout, v).contiguous())
                outs = []
                for sh in shards:
                    panels = assemble_sharded(tables, c.diag, c.triu, dtype=dtype, shard=sh)
                    window, ids, ncb = _shard_window(tables, sh, pv)
                    got = _local_matvec(tables, ids, panels, window, ncb)
                    want = cuda_spmv.block_matvec_plain(ids, panels, window, s_max=tables.s_max)
                    rel = held(f"shard {sh.rank} forward {name} B={batch}", got, want)
                    records.append({"world_size": world_size, "kernel": "forward",
                                    "shard": sh.rank, "panels": name, "batch": batch,
                                    "max_rel_err": rel})
                    outs.append(got)
                    del panels, want
                stacked = torch.cat(outs)[:layout.num_padded]
                records.append({"world_size": world_size, "kernel": "forward",
                                "shard": "stacked", "panels": name, "batch": batch,
                                "max_rel_err": held(f"stacked vs one device {name} B={batch}",
                                                    stacked, want_all)})
                del outs, stacked, want_all
            del whole
        # K3 writes every slot; a short row's unused slots (zero panel
        # columns, discarded by assembly's transpose) read other operand
        # blocks in a shard's window than on one device: held on used slots
        bc = tables.block_col_np
        used = np.ones(bc.shape, bool)
        used[:, 1:] = np.diff(bc, axis=1) > 0
        used = np.cumprod(used, axis=1).astype(bool)
        slot_mask = torch.from_numpy(np.repeat(used, 128, axis=1)).to(dev)[:, None, :]
        for out_dtype, widths in ((torch.float32, MESH_BWD_WIDTHS),
                                  (torch.bfloat16, PROBE_SPLIT_WIDTHS)):
            out_name = str(out_dtype).replace("torch.", "")
            tol = SMALL_TOL if out_dtype == torch.float32 else BF16_OUT_TOL
            for batch in widths:
                v = torch.randn((n, batch), generator=gen, device=dev)
                pv = embed(v)
                g = torch.randn((tables.rows, batch), generator=gen, device=dev)
                want_all = cuda_spmv.block_bwd_blocks(layout, g[:layout.num_padded].contiguous(),
                                                      permute_in(layout, v).contiguous(),
                                                      out_dtype=out_dtype)
                for sh in shards:
                    window, ids, ncb = _shard_window(tables, sh, pv)
                    gl = g[sh.row_lo:sh.row_lo + sh.lrows]
                    got = _local_bwd_blocks(tables, ids, gl, window, ncb, out_dtype)
                    want = cuda_spmv.bwd_blocks_plain(ids, gl.contiguous(), window,
                                                      s_max=tables.s_max, out_dtype=out_dtype)
                    rel = held(f"shard {sh.rank} K3 {out_name} B={batch}", got, want, tol)
                    lo_b = sh.row_lo // 128
                    hi_b = min(lo_b + sh.lrb, layout.num_row_blocks)
                    if hi_b > lo_b:
                        keep = slot_mask[lo_b:hi_b]
                        held(f"shard {sh.rank} K3 {out_name} vs one device (used slots) "
                             f"B={batch}", got[:hi_b - lo_b] * keep, want_all[lo_b:hi_b] * keep,
                             tol)
                    records.append({"world_size": world_size, "kernel": "K3", "shard": sh.rank,
                                    "out": out_name, "batch": batch, "max_rel_err": rel})
                    del got, want
                del want_all
    return tables, records


def row_order_witness(kernel, params, tables):
    """Eigenvalues of one-device LOBPCG on ``kernel``'s own operator (its
    single-device SpMV) taken in ``tables``' padded row order, padding rows
    pinned at the Gershgorin bound, from the single-device start block
    embedded there: the mesh basis's row order and start, without its
    sharded SpMV or its collectives. Read against the node-order basis, it
    shows how far the row order alone moves each mode."""
    import torch

    from manifold_gp_torch.kernels.riemann import _matrix_free_smallest
    from manifold_gp_torch.ops.block_sparse import assemble
    from manifold_gp_torch.ops.laplacian import gershgorin_bound, laplacian_matvec

    dev = kernel.device
    ron = tables.row_of_node
    with torch.no_grad():
        c = kernel.coeffs(params)
        bound = gershgorin_bound(kernel.graph, c)
        block = (kernel.block_layout, assemble(kernel.block_layout, c.diag, c.triu))
        mask = torch.from_numpy(tables.row_mask_np).to(dev)[:, None]

        def embed(v):
            out = v.new_zeros((tables.rows,) + tuple(v.shape[1:]))
            out[ron] = v
            return out

        def mv(v):
            lv = laplacian_matvec(kernel.graph, c, v[ron], "symmetric", block=block)
            return mask * embed(lv) + bound * (1.0 - mask) * v

        n = kernel.graph.num_nodes
        eigval, _ = _matrix_free_smallest(kernel.cfg, mv, n, min(kernel.num_modes, n), bound,
                                          dev, embed=embed)
        eigval = eigval.clone()
        eigval[0] = 0.0
    return eigval, float(bound)


def hold_probe_widths(kernel, params, seed: int) -> list:
    """The forward kernel (bf16 panels, both entry points) and K3 (f32 and
    bf16 out, both entry points) against their plain versions at the probe
    split's widths (``PROBE_SPLIT_WIDTHS``) on ``kernel``'s own block
    layout, each timed against its bound and one ``torch.bmm``. Returns the
    records."""
    import torch

    from manifold_gp_torch.ops.block_sparse import assemble, permute_in

    layout = kernel.block_layout
    dev = kernel.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    fwd, bwd = fwd_timing(layout), bwd_timing(layout, edge_gather=False)
    records = []
    with torch.no_grad():
        c = kernel.coeffs(params)
        panels = assemble(layout, c.diag, c.triu, dtype=torch.bfloat16)
        for batch in PROBE_SPLIT_WIDTHS:
            v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
            pv = permute_in(layout, v).contiguous()
            rec = compare(layout, panels, pv, "probe split bfloat16", timing=fwd)
            rec["max_rel_err"] = max(rec[e]["max_rel_err"] for e in
                                     ("resident_matvec_call", "stream_matvec_call"))
            records.append(rec)
            gct = torch.randn((layout.num_padded, batch), generator=gen, device=dev)
            for out_dtype in (torch.float32, torch.bfloat16):
                rec = compare_bwd(layout, gct, pv, out_dtype,
                                  f"probe split bwd {str(out_dtype)[6:]}", timing=bwd)
                rec["max_rel_err"] = max(rec[e]["max_rel_err"] for e in
                                         ("bwd_blocks_call", "block_bwd_blocks"))
                records.append(rec)
        del panels
    torch.cuda.empty_cache()
    for r in records:
        kind = (f"forward bf16 TB={r['batch_tile']}" if "batch_tile" in r
                else f"K3 {r['out_dtype']} out class {r['batch_class']}")
        print(f"    {kind} B={r['batch']}: ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"max_rel_err={r['max_rel_err']:.2e}")
    return records


def sharded_knn_phase(camp, mesh, loss_mesh, grads_mesh, probes, exact_build_s) -> dict:
    """Phase 14c: on ``mesh`` (world size 1 over NCCL), the campaign's
    exact graph built again by ``build_graph_sharded`` on both schedules
    (timed; at most ``EDGE_TIES`` of the edges may differ, in f32 ties
    only), the campaign's IVF index (2,048 lists, nprobe 16) searched by
    ``sharded_ivf_search`` against ``ivf_search`` (equal), and phase 14's
    mesh loss and gradients on a mesh model over the sharded-built graph
    (bit for bit where the edges are equal, else at the parity
    tolerances)."""
    import numpy as np
    import torch

    from examples_torch.run_large import (
        INITIAL_HYPERS,
        build_campaign,
        campaign_data,
        campaign_graph_backend,
        loss_and_grad,
    )
    from manifold_gp_torch.ops.knn import ivf_build, ivf_search, knn_search
    from manifold_gp_torch.parallel import build_graph_sharded, sharded_ivf_search
    from manifold_gp_torch.parallel import sharded_knn_search

    dev = mesh.device
    train_x = campaign_data(CAMPAIGN_N, 2048, 0, "torus")[0]
    xt = torch.from_numpy(train_x).to(dev)
    k = camp.model.kernel.nearest_neighbors
    exact = edge_keys(camp.graph)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {"n": int(train_x.shape[0]), "k": k, "exact_build_graph_s_13a": exact_build_s}
    graphs = {}
    for sched in ("replicated", "ring"):
        g, secs = timed(lambda: build_graph_sharded(train_x, k, mesh, schedule=sched))
        graphs[sched] = g
        keys = edge_keys(g)
        differ = int(np.setxor1d(keys, exact).size)
        rec = {"build_graph_s": secs, "num_edges": int(keys.size), "edges_differ": differ,
               "edges_differ_share": differ / exact.size}
        if differ:  # where the picks differ, they must be f32 ties
            _, idx_s = sharded_knn_search(xt, xt, k, mesh, self_query=True, schedule=sched)
            _, idx_e = knn_search(xt, xt, k, self_query=True)
            rec.update(knn_tie_gap(train_x, idx_e.cpu().numpy(), idx_s.cpu().numpy()))
        out[sched] = rec
        print(f"  build_graph_sharded({sched!r}) {secs:.2f} s (phase 13a's exact build "
              f"{exact_build_s if exact_build_s is None else round(exact_build_s, 2)} s); "
              f"{keys.size} edges, {differ} differ from the exact graph's "
              f"(share {differ / exact.size:.2e}, threshold {EDGE_TIES:.0e})")
        if differ / exact.size > EDGE_TIES or max(rec.get("host_excess", 0.0),
                                                   rec.get("device_excess", 0.0)) > TIE_SQDIST:
            fail(f"phase 14c: the {sched} sharded graph differs from the exact one beyond ties")
    _, ivf_kw = campaign_graph_backend(train_x.shape[0], dev)
    index, ivf_build_s = timed(lambda: ivf_build(xt, nlist=ivf_kw["ivf_nlist"],
                                                 kmeans_iters=ivf_kw["ivf_kmeans_iters"]))
    (d1, i1), single_s = timed(lambda: ivf_search(index, xt, k, nprobe=ivf_kw["ivf_nprobe"],
                                                  self_query=True))
    (d2, i2), sharded_s = timed(lambda: sharded_ivf_search(index, xt, k, mesh,
                                                           nprobe=ivf_kw["ivf_nprobe"],
                                                           self_query=True))
    ivf_equal = bool(torch.equal(i1, i2) and torch.equal(d1, d2))
    out["ivf"] = {"nlist": index.nlist, "nprobe": ivf_kw["ivf_nprobe"], "build_s": ivf_build_s,
                  "search_s": single_s, "sharded_search_s": sharded_s, "equal": ivf_equal}
    print(f"  IVF ({index.nlist} lists, nprobe {ivf_kw['ivf_nprobe']}): sharded search "
          f"{sharded_s:.2f} s vs {single_s:.2f} s one device; results equal: {ivf_equal}")
    if not ivf_equal:
        fail("phase 14c: the sharded IVF search differs from ivf_search")
    del index, d1, i1, d2, i2, xt

    # phase 14's mesh loss and gradients on the (replicated) sharded-built graph
    camp_sh = build_campaign(n=CAMPAIGN_N, precond_type="jacobi", mesh=mesh,
                             graph_builder=lambda x, kk, d: graphs["replicated"])
    del graphs
    same_edges = bool(np.array_equal(edge_keys(camp_sh.graph), exact))
    v, g = loss_and_grad(camp_sh.model, camp_sh.model.init_params(**INITIAL_HYPERS),
                         probes=probes)
    loss_rel = abs(v - loss_mesh) / abs(loss_mesh)
    grad_rel = _grad_gap(g, grads_mesh)
    bitwise = v == loss_mesh and g == grads_mesh
    out["mesh_loss"] = {"edges_equal": same_edges, "loss": v, "loss_rel": loss_rel,
                        "grad_rel_of_max": grad_rel, "bit_for_bit": bitwise}
    print(f"  mesh loss on the sharded-built graph {v:.7f} vs phase 14's {loss_mesh:.7f}: "
          f"bit for bit {bitwise} (edges equal: {same_edges}); rel {loss_rel:.2e}, gradients "
          f"{grad_rel:.2e} of the largest")
    if (same_edges and not bitwise) or loss_rel > MESH_LOSS_RTOL or grad_rel > MESH_GRAD_RTOL:
        fail("phase 14c: the mesh loss on the sharded-built graph differs")
    del camp_sh
    torch.cuda.empty_cache()
    return out


def mesh_phases(dev, smi_line, exact_build_s=None) -> tuple:
    """Phases 14, 14a and 14b: the row-sharded multi-GPU path of
    ``manifold_gp_torch.parallel`` at world size 1 over NCCL (full width),
    at world size 2 as two gloo processes sharing the card, and the two
    block-ELL kernels at every shard layout of world size 4. Returns their
    report entries and the kernels line's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as tmp

    from examples_torch.run_large import (
        CAMPAIGN_HYPERS,
        INITIAL_HYPERS,
        EpochLog,
        build_campaign,
        campaign_data,
        loss_and_grad,
        mesh_twin,
        rademacher_numpy,
    )
    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.ops.knn import default_nlist, ivf_build, ivf_search
    from manifold_gp_torch.parallel import init_distributed, make_mesh
    from manifold_gp_torch.parallel import mesh as pmesh
    from manifold_gp_torch.parallel.block_spmv import exchange_name
    from manifold_gp_torch.utils import manifold_informed_train

    report = {}
    # -- phase 14: the mesh path at world size 1 over NCCL ---------------------
    phase("phase 14: the 262,144-point torus on a mesh kernel, world size 1 over NCCL")
    print(f"  {smi_line}")
    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="mgp_mesh_")
    init_distributed(backend="nccl", init_method=f"file://{store}/store", world_size=1, rank=0,
                     timeout_s=120)
    mesh = make_mesh(device=str(dev))
    camp = build_campaign(n=CAMPAIGN_N, device=dev, precond_type="jacobi")
    single = camp.model
    t0 = time.perf_counter()
    twin = mesh_twin(camp, mesh, precond_type="jacobi")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    tables = twin.kernel._mesh_fused
    if tables is None:
        fail("phase 14: the torus did not take the fused mesh layout")
    n = single.num_data
    probes = torch.from_numpy(rademacher_numpy(14, n, camp.cfg.num_probes)).to(dev)

    def timed_grad(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loss_and_grad(model, model.init_params(**INITIAL_HYPERS), probes=probes)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (v1, g1), _ = timed_grad(single)
    (v1, g1), grad_s_single = timed_grad(single)
    # the mesh's main path: counts to 0 just before, read just after
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    pmesh.collective_counts.clear()
    (vm, gm), _ = timed_grad(twin)
    per_grad = dict(pmesh.collective_counts)
    (vm, gm), grad_s_mesh = timed_grad(twin)
    torch.cuda.reset_peak_memory_stats(dev)
    log = EpochLog()
    _, _, history = manifold_informed_train(
        twin, twin.init_params(**INITIAL_HYPERS), lr=0.1, max_iter=CAMPAIGN_EPOCHS - 1,
        tolerance=1e-2, num_rand_vec=100, seed=0, metrics=log)
    torch.cuda.synchronize()
    mesh_peak = int(torch.cuda.max_memory_allocated(dev))
    mesh_train = {"forward": cuda_spmv.launch_count, "bwd_blocks": cuda_spmv.bwd_launch_count}
    log1 = EpochLog()
    manifold_informed_train(single, single.init_params(**INITIAL_HYPERS), lr=0.1,
                            max_iter=CAMPAIGN_EPOCHS - 1, tolerance=1e-2, num_rand_vec=100,
                            seed=0, metrics=log1)
    loss_rel = abs(vm - v1) / abs(v1)
    grad_rel = _grad_gap(gm, g1)
    epoch_mesh = float(np.median([r["seconds"] for r in log.rows]))
    epoch_single = float(np.median([r["seconds"] for r in log1.rows]))
    print(f"  tables {tables_s:.2f} s (S={tables.s_max}, row blocks {tables.nrb}, halo "
          f"{tables.halo}); loss mesh {vm:.7f} vs one device {v1:.7f} (rel {loss_rel:.2e}, "
          f"threshold {MESH_LOSS_RTOL:.0e}); gradients {grad_rel:.2e} of the largest "
          f"(threshold {MESH_GRAD_RTOL:.0e})")
    print(f"  gradient {grad_s_mesh:.4f} s mesh vs {grad_s_single:.4f} s one device; epoch "
          f"{epoch_mesh:.4f} s vs {epoch_single:.4f} s (median of {CAMPAIGN_EPOCHS}); "
          f"collectives per gradient {per_grad}; peak memory {mesh_peak / 2**30:.2f} GiB")
    print(f"  mesh epochs: {history}; launches forward {mesh_train['forward']}, K3 "
          f"{mesh_train['bwd_blocks']}")
    if not loss_rel <= MESH_LOSS_RTOL or not grad_rel <= MESH_GRAD_RTOL:
        fail("phase 14: the mesh loss or gradients differ from one device's")
    if not np.isfinite(history).all():
        fail("phase 14: a non-finite mesh training loss")
    if min(mesh_train.values()) <= 0:
        fail("phase 14: a kernel of the mesh training path was never launched")

    # serve: LOBPCG (f32 panels, B = 100 and 300) on both kernels
    params_t = twin.init_params(**CAMPAIGN_HYPERS)
    twin.kernel.cfg = twin.kernel.cfg.replace(eigensolver="lobpcg")
    single.kernel.cfg = single.kernel.cfg.replace(eigensolver="lobpcg")
    cuda_spmv.launch_count = 0
    cuda_spmv.launch_count_by_batch.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    basis_m = twin.kernel.eval_basis(params_t)
    torch.cuda.synchronize()
    basis_s_mesh = time.perf_counter() - t0
    mesh_serve = {"forward": cuda_spmv.launch_count,
                  "forward_by_batch": {str(b): c for b, c in
                                       sorted(cuda_spmv.launch_count_by_batch.items())}}
    t0 = time.perf_counter()
    basis_1 = single.kernel.eval_basis(params_t)
    torch.cuda.synchronize()
    basis_s_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    eig_w, bound = row_order_witness(single.kernel, params_t, tables)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    gaps = (torch.abs(basis_m[0] - basis_1[0]) / bound).cpu().numpy()
    gaps_w = (torch.abs(basis_m[0] - eig_w) / bound).cpu().numpy()
    order_gaps = (torch.abs(eig_w - basis_1[0]) / bound).cpu().numpy()
    eig_gap = float(gaps.max())
    worst = np.argsort(gaps)[::-1][:5]
    twin.kernel.eval_basis = lambda p: basis_m
    twin.eval(params_t)
    post = twin.posterior(params_t, camp.test_x)
    mean = post.mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean - camp.test_y_true) ** 2)))
    print(f"  LOBPCG basis {basis_s_mesh:.2f} s mesh vs {basis_s_single:.2f} s one device; "
          f"eigenvalues at most {eig_gap:.2e} of the bound apart; "
          f"forward launches {mesh_serve['forward_by_batch']}; RMSE vs truth {rmse:.6f} "
          f"(noise floor {camp.noise_floor_rmse:.4f})")
    held_gap = float(gaps[:MESH_EIG_MODES].max())
    print(f"  vs one device in node order: largest gaps (of the bound {bound:.4f}) at modes "
          f"{worst.tolist()}: {gaps[worst].tolist()}; modes 0-{MESH_EIG_MODES - 1}: "
          f"{held_gap:.2e} (threshold {MESH_EIG_TOL:.0e})")
    print(f"  vs one device in the mesh's row order ({witness_s:.2f} s): all modes "
          f"{gaps_w.max():.2e} (threshold {MESH_EIG_TOL:.0e}); the row order alone moves "
          f"modes {MESH_EIG_MODES}-99 by {order_gaps[MESH_EIG_MODES:].tolist()}, modes "
          f"0-{MESH_EIG_MODES - 1} by at most {order_gaps[:MESH_EIG_MODES].max():.2e}")
    basis_ok = held_gap <= MESH_EIG_TOL and gaps_w.max() <= MESH_EIG_TOL
    if not (np.isfinite(mean).all() and rmse < camp.noise_floor_rmse):
        fail("phase 14: the mesh posterior is not below the noise floor")
    if mesh_serve["forward"] <= 0:
        fail("phase 14: the forward kernel was never launched serving on the mesh")
    report["mesh_ws1"] = {
        "n": CAMPAIGN_N, "tables_s": tables_s, "max_blocks": tables.s_max,
        "num_row_blocks": tables.nrb, "halo": tables.halo, "loss_mesh": vm,
        "loss_single": v1, "loss_rel": loss_rel, "grad_rel_of_max": grad_rel,
        "grad_s_mesh": grad_s_mesh, "grad_s_single": grad_s_single,
        "epoch_s_mesh": epoch_mesh, "epoch_s_single": epoch_single,
        "epoch_log": log.rows, "collectives_per_gradient": per_grad,
        "peak_mem_bytes": mesh_peak, "train_launches": mesh_train,
        "basis_s_mesh": basis_s_mesh, "basis_s_single": basis_s_single,
        "eig_gap_of_bound": eig_gap, "eig_gaps_of_bound": gaps.tolist(),
        "eig_gaps_vs_row_order_witness": gaps_w.tolist(),
        "row_order_gaps_of_bound": order_gaps.tolist(), "witness_s": witness_s,
        "serve_launches": mesh_serve, "rmse_vs_truth": rmse,
        "noise_floor_rmse": camp.noise_floor_rmse, "seconds": time.perf_counter() - t_phase,
        "card": smi_line,
    }

    # -- phase 14c: the sharded graph builds and IVF search over NCCL ----------
    phase(f"phase 14c: sharded kNN graph builds and IVF search, world size 1 over NCCL, "
          f"{CAMPAIGN_N:,}-point torus")
    report["mesh_knn_ws1"] = sharded_knn_phase(camp, mesh, vm, gm, probes, exact_build_s)
    torch.distributed.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)

    # -- phase 14b: both kernels at every shard layout of world size 4 ---------
    phase(f"phase 14b: K1 and K3 at the {MESH_SHARDS} shard layouts of the torus")
    t0 = time.perf_counter()
    tables4, records = hold_shard_layouts(single.kernel, params_t, MESH_SHARDS, seed=141)
    torch.cuda.empty_cache()
    print(f"  the probe split's widths B = {PROBE_SPLIT_WIDTHS} at the torus layout, timed")
    probe_records = hold_probe_widths(single.kernel, params_t, seed=145)
    report["mesh_shards"] = {"world_size": MESH_SHARDS, "halo": tables4.halo,
                             "num_row_blocks": tables4.nrb, "exchange": exchange_name(tables4),
                             "records": records, "probe_width_records": probe_records,
                             "seconds": time.perf_counter() - t0}
    del tables4

    # -- phase 14a: world size 2, two processes sharing the card, gloo ---------
    phase(f"phase 14a: world size 2 over gloo, two processes on the one card, "
          f"{MESH_WS2_N:,}-point torus")
    t0 = time.perf_counter()
    camp2 = build_campaign(n=MESH_WS2_N, device=dev, precond_type="jacobi")
    ref = camp2.model
    n2 = ref.num_data
    probes2 = rademacher_numpy(142, n2, camp2.cfg.num_probes)
    v_ref, g_ref = loss_and_grad(ref, ref.init_params(**INITIAL_HYPERS),
                                 probes=torch.from_numpy(probes2).to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_and_grad(ref, ref.init_params(**INITIAL_HYPERS), probes=torch.from_numpy(probes2).to(dev))
    torch.cuda.synchronize()
    grad_s_ref = time.perf_counter() - t1
    ref.kernel.cfg = ref.kernel.cfg.replace(eigensolver="lobpcg")
    pref = ref.init_params(**CAMPAIGN_HYPERS)
    eig_ref = ref.kernel.eval_basis(pref)[0].cpu().numpy()
    # both kernels at the two ranks' shard layouts, and the basis's row-order witness
    tables2, records2 = hold_shard_layouts(ref.kernel, pref, 2, seed=143)
    eig_w2, bound2 = row_order_witness(ref.kernel, pref, tables2)
    eig_w2 = eig_w2.cpu().numpy()
    del tables2
    # the sharded searches' references (the raw training points' exact graph is
    # camp2's) and the probe split's: the average variance on one process
    x_raw = campaign_data(MESH_WS2_N, 2048, 0, "torus")[0]
    xr = torch.from_numpy(x_raw).to(dev)
    index2 = ivf_build(xr, nlist=default_nlist(x_raw.shape[0]))
    ivf_d, ivf_i = ivf_search(index2, xr, ref.kernel.nearest_neighbors, nprobe=16,
                              self_query=True)
    one_hot_idx = np.random.default_rng(144).integers(0, n2, PROBE_SPLIT_ONE_HOT)
    with torch.no_grad():
        avg_ref = float(ref.average_variance(ref.init_params(**INITIAL_HYPERS),
                                             num_rand_vec=PROBE_SPLIT_ONE_HOT,
                                             idx=torch.from_numpy(one_hot_idx).to(dev)))
    work = pathlib.Path(tempfile.mkdtemp(prefix="mgp_ws2_"))
    g2 = camp2.graph
    np.savez(work / "inputs.npz", rows=g2.rows.cpu().numpy(), cols=g2.cols.cpu().numpy(),
             sqdist=g2.sqdist.cpu().numpy(), n=g2.num_nodes,
             x=ref.kernel.x.cpu().numpy(), y=ref.train_y.cpu().numpy(), probes=probes2,
             x_raw=x_raw, ivf_centroids=index2.centroids.cpu().numpy(),
             ivf_lists=index2.lists.cpu().numpy(), ivf_mask=index2.list_mask.cpu().numpy(),
             ivf_nprobe=16, ivf_d=ivf_d.cpu().numpy(), ivf_i=ivf_i.cpu().numpy(),
             one_hot_idx=one_hot_idx)
    del xr, index2, ivf_d, ivf_i
    import dataclasses as _dc

    (work / "spec.json").write_text(json.dumps({
        "cfg": _dc.asdict(camp2.cfg), "k": ref.kernel.nearest_neighbors,
        "num_modes": ref.kernel.num_modes, "gb_min": camp2.gb_min}))
    del camp2, ref
    torch.cuda.empty_cache()
    ctx = tmp.start_processes(_mesh_rank_ws2, args=(2, str(work)), nprocs=2, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 14a: a rank passed {MESH_RANK_TIMEOUT_S} s")
    except Exception as exc:  # a rank raised: ProcessRaisedException / ProcessExitedException
        fail(f"phase 14a: a rank failed: {exc}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(5)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    checks = []
    for r in ranks:
        halo, gath = r["auto"], r["gather"]
        lrel = abs(halo["loss"] - v_ref) / abs(v_ref)
        grel = _grad_gap(halo["grads"], g_ref)
        xrel = abs(halo["loss"] - gath["loss"]) / abs(halo["loss"])
        egaps = np.abs(np.asarray(r["eigval"]) - eig_ref) / bound2
        egap = float(egaps[:MESH_EIG_MODES].max())
        wgap = float((np.abs(np.asarray(r["eigval"]) - eig_w2) / bound2).max())
        print(f"  rank {r['rank']} largest eigenvalue gaps at modes "
              f"{np.argsort(egaps)[::-1][:5].tolist()}: {np.sort(egaps)[::-1][:5].tolist()}; "
              f"all modes vs one device in the mesh's row order {wgap:.2e} (threshold "
              f"{MESH_EIG_TOL:.0e})")
        checks.append({"rank": r["rank"], "loss_rel": lrel, "grad_rel_of_max": grel,
                       "exchange_rel": xrel, "eig_gap_of_bound": egap,
                       "eig_gap_vs_row_order_witness": wgap,
                       "exchanges": [halo["exchange"], gath["exchange"]], "halo": r["halo"],
                       "seconds": r["seconds"], "forward_launches": r["forward_launches"],
                       "bwd_blocks_launches": r["bwd_blocks_launches"]})
        print(f"  rank {r['rank']} ({r['device']}): loss {halo['loss']:.7f} vs one device "
              f"{v_ref:.7f} (rel {lrel:.2e}); gradients {grel:.2e} of the largest; exchanges "
              f"{halo['exchange']} (halo {r['halo']}) vs {gath['exchange']}: rel {xrel:.2e} "
              f"(threshold {MESH_EXCHANGE_RTOL:.0e}); eigenvalues {egap:.2e} of the bound; "
              f"{r['seconds']:.1f} s; launches forward {r['forward_launches']} K3 "
              f"{r['bwd_blocks_launches']}")
        if not (lrel <= MESH_LOSS_RTOL and grel <= MESH_GRAD_RTOL):
            fail(f"phase 14a: rank {r['rank']}'s loss or gradients differ from one device's")
        if not xrel <= MESH_EXCHANGE_RTOL:
            fail(f"phase 14a: rank {r['rank']}'s halo and gather losses differ")
        basis_ok = basis_ok and egap <= MESH_EIG_TOL and wgap <= MESH_EIG_TOL
        if not np.isfinite(r["history"]).all():
            fail(f"phase 14a: rank {r['rank']} trained to a non-finite loss")
    probe_checks = []
    for r in ranks:
        kn, pr = r["knn"], r["probe"]
        lrel = abs(pr["loss"] - v_ref) / abs(v_ref)
        grel = _grad_gap(pr["grads"], g_ref)
        arel = abs(pr["avg_var"] - avg_ref) / abs(avg_ref)
        print(f"  rank {r['rank']} sharded graph (replicated) {kn['build_graph_s']:.2f} s, "
              f"{kn['edges_differ']} of {kn['num_edges']} edges differ from one device's; "
              f"sharded IVF equal to ivf_search: {kn['ivf_equal']}; ring over gloo on CUDA "
              f"raised: {kn['ring_raised']!r}")
        print(f"  rank {r['rank']} probe split ({PROBE_SPLIT_PROBES // 2} of "
              f"{PROBE_SPLIT_PROBES} probes, {PROBE_SPLIT_ONE_HOT // 2} of "
              f"{PROBE_SPLIT_ONE_HOT} one-hot columns): loss {pr['loss']:.7f} vs one process "
              f"{v_ref:.7f} (rel {lrel:.2e}, threshold {MESH_LOSS_RTOL:.0e}); gradients "
              f"{grel:.2e} of the largest (threshold {MESH_GRAD_RTOL:.0e}); average variance rel "
              f"{arel:.2e}; collectives per gradient {pr['collectives_per_gradient']}; gradient "
              f"{pr['grad_s']:.4f} s (one process {grad_s_ref:.4f} s); forward launches by B "
              f"{pr['forward_by_batch']}, K3 "
              f"{pr['bwd_by_batch']}")
        if kn["edges_differ"] / max(kn["num_edges"], 1) > EDGE_TIES:
            fail(f"phase 14a: rank {r['rank']}'s sharded graph differs from one device's")
        if not kn["ivf_equal"]:
            fail(f"phase 14a: rank {r['rank']}'s sharded IVF differs from ivf_search")
        if not kn["ring_raised"] or "gloo" not in kn["ring_raised"]:
            fail("phase 14a: the ring schedule on gloo over CUDA tensors did not raise")
        if not (lrel <= MESH_LOSS_RTOL and grel <= MESH_GRAD_RTOL and arel <= MESH_LOSS_RTOL):
            fail(f"phase 14a: rank {r['rank']}'s probe-split loss, gradients or average "
                 "variance differ from one process's")
        if pr["collectives_per_gradient"] != {"all_reduce": 2}:
            fail(f"phase 14a: the probe split took {pr['collectives_per_gradient']} collectives "
                 "a gradient, not the pair's two all-reduces")
        widths = {int(b) for b in pr["forward_by_batch"]}
        if not {PROBE_SPLIT_PROBES // 2, PROBE_SPLIT_ONE_HOT // 2} <= widths or \
                str(PROBE_SPLIT_PROBES // 2) not in pr["bwd_by_batch"]:
            fail("phase 14a: the probe split did not launch the kernels at its widths")
        probe_checks.append({"rank": r["rank"], "loss_rel": lrel, "grad_rel_of_max": grel,
                             "avg_var_rel": arel, **{k: pr[k] for k in (
                                 "collectives_per_gradient", "grad_s", "forward_by_batch",
                                 "bwd_by_batch", "history")}, "knn": kn})
    probe_same = ranks[0]["probe"]["param_bits"] == ranks[1]["probe"]["param_bits"] and \
        ranks[0]["probe"]["loss"] == ranks[1]["probe"]["loss"] and \
        ranks[0]["probe"]["grads"] == ranks[1]["probe"]["grads"]
    print(f"  probe split: loss, gradients and parameters after 3 epochs bit-identical on both "
          f"ranks: {probe_same}")
    if not probe_same:
        fail("phase 14a: the probe split's ranks differ")
    same = ranks[0]["param_bits"] == ranks[1]["param_bits"] and \
        ranks[0]["auto"]["loss"] == ranks[1]["auto"]["loss"]
    print(f"  parameters after 3 Adam epochs bit-identical on both ranks: {same}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    if not same:
        fail("phase 14a: the two ranks' parameters differ")
    ws2 = {"forward": sum(r["forward_launches"] for r in ranks),
           "bwd_blocks": sum(r["bwd_blocks_launches"] for r in ranks)}
    split = {"forward": sum(sum(r["probe"]["forward_by_batch"].values()) for r in ranks),
             "bwd_blocks": sum(sum(r["probe"]["bwd_by_batch"].values()) for r in ranks)}
    if min(ws2.values()) <= 0:
        fail("phase 14a: a kernel of the world-size-2 path was never launched")
    report["mesh_ws2"] = {"n": MESH_WS2_N, "ranks": checks, "params_identical": same,
                          "probe_split": probe_checks, "probe_split_identical": probe_same,
                          "avg_var_single": avg_ref, "grad_s_single": grad_s_ref,
                          "loss_single": v_ref, "shard_records": records2,
                          "seconds": time.perf_counter() - t0}
    if not basis_ok:
        fail("phase 14: the mesh basis differs from one device's")
    paths = {
        "forward": {"mesh_train": mesh_train["forward"], "mesh_serve": mesh_serve["forward"],
                    "mesh_serve_by_batch": mesh_serve["forward_by_batch"],
                    "mesh_ws2": ws2["forward"], "probe_split_ws2": split["forward"],
                    "probe_split_ws2_by_batch": ranks[0]["probe"]["forward_by_batch"]},
        "bwd_blocks": {"mesh_train": mesh_train["bwd_blocks"],
                       "mesh_ws2": ws2["bwd_blocks"], "probe_split_ws2": split["bwd_blocks"],
                       "probe_split_ws2_by_batch": ranks[0]["probe"]["bwd_by_batch"]},
        "required": [mesh_train["forward"], mesh_train["bwd_blocks"], mesh_serve["forward"],
                     ws2["forward"], ws2["bwd_blocks"], split["forward"], split["bwd_blocks"]],
    }
    return report, paths


def edge_keys(graph):
    """A graph's edges as sorted int64 keys row * N + col."""
    import numpy as np

    n = graph.num_nodes
    return np.sort(graph.rows.cpu().numpy().astype(np.int64) * n + graph.cols.cpu().numpy())


def knn_tie_gap(x, idx_a, idx_b) -> dict:
    """Where two self-query kNN results pick other neighbours (columns past
    the self-match), how far each pick lies beyond the row's true (k-1)-th
    smallest squared distance, in f64: 0 for a right choice, and at most the
    f32 rounding of the distances for a tie."""
    import numpy as np

    a, b = np.asarray(idx_a)[:, 1:], np.asarray(idx_b)[:, 1:]
    rows = np.flatnonzero((np.sort(a, axis=1) != np.sort(b, axis=1)).any(axis=1))
    x64 = np.asarray(x, np.float64)
    excess = {"host_excess": 0.0, "device_excess": 0.0}
    for r in rows:
        d = np.sum((x64 - x64[r]) ** 2, axis=1)
        d[r] = np.inf
        kth = np.partition(d, a.shape[1] - 1)[a.shape[1] - 1]
        excess["host_excess"] = max(excess["host_excess"], float(d[a[r]].max() - kth))
        excess["device_excess"] = max(excess["device_excess"], float(d[b[r]].max() - kth))
    return {"rows_differ": int(rows.size), **excess}


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    csrc = ROOT / "manifold_gp_torch" / "csrc"
    if not all((csrc / name).exists() for name in
               ("block_ell_spmv.cu", "block_ell_bwd_blocks.cu", "dia_spmv.cu",
                "dia_band_grad.cu")):
        fail(f"the manifold_gp_torch package is not next to {__file__}")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from manifold_gp_torch.ops import cuda_spmv, dia
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.ops.block_sparse import (
        BlockLayout,
        assemble,
        build_block_layout,
        permute_in,
    )
    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from examples_torch.run_large import (
        CAMPAIGN_HYPERS,
        CURVE_HYPERS,
        INITIAL_HYPERS,
        build_campaign,
        curve_points,
        launch_counts,
        launches_since,
        layout_record,
        lobpcg_eigvals,
        loss_and_grad,
        rademacher_numpy,
        serve_campaign,
        srmnist_points,
        torus_points,
        train_campaign,
    )

    report = {}
    # -- phase 1: device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    phase("phase 1: device")
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    global PEAK_CARD
    from manifold_gp_torch.utils import roofline

    if roofline.card_peaks(kind) is None:
        peak_key = "H100 (SXM figures; card not in the table)"
    else:
        PEAK_CARD = kind
        peak_key = roofline.card_peaks(kind)[0]
    hbm_bps, f32_flops, bf16_flops = roofline.card_peaks(PEAK_CARD)[1]
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} device {kind} "
          f"(peaks, utils/roofline.py: {peak_key}: {hbm_bps / 1e12} TB/s, f32 "
          f"{f32_flops / 1e12} TFLOP/s, bf16 {bf16_flops / 1e12} TFLOP/s)")
    t0 = time.perf_counter()
    lib_path = cuda_spmv.build_library()
    cuda_spmv._load()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s: {lib_path.relative_to(ROOT)}")
    for line in cuda_spmv.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    report.update(device=kind, nvidia_smi=smi_line, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, peaks=peak_key)
    dev = torch.device("cuda", 0)

    # -- phase 2: kernel vs plain, small layout -----------------------------
    phase("phase 2: kernel vs plain at a small layout")
    xs, _, _ = torus_points(10_240, seed=1)
    g = build_graph(xs, 16, device=dev)
    small_layout = build_block_layout(g)
    small_coeffs = laplacian_coeffs(g, 0.05)
    print(f"  small layout: N={small_layout.num_nodes} S={small_layout.max_blocks} "
          f"row blocks={small_layout.num_row_blocks}")
    gen = torch.Generator(device=dev).manual_seed(0)
    small = []
    for dtype, panels in panel_sets(small_layout, small_coeffs).items():
        for batch in (1, 7, 8, 9, 37, 48, 64, 100, 125, 128, 129, 200, 300):
            v = torch.randn((small_layout.num_nodes, batch), generator=gen, device=dev)
            small.append(compare(small_layout, panels, permute_in(small_layout, v).contiguous(),
                                 f"small {dtype}"))
    report["small"] = small
    small_bwd = []
    for out_dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 8, 15, 16, 17, 37, 48, 64, 128, 129, 200):
            v = torch.randn((small_layout.num_nodes, batch), generator=gen, device=dev)
            gct = torch.randn((small_layout.num_padded, batch), generator=gen, device=dev)
            small_bwd.append(compare_bwd(small_layout, gct,
                                         permute_in(small_layout, v).contiguous(), out_dtype,
                                         f"small bwd {str(out_dtype)[6:]}"))
    report["small_bwd"] = small_bwd

    phase("phase 2c: DIA band kernel K4 vs plain at small layouts")
    small_dia = []
    for n_small in (1500, 10_240):
        xc, _ = curve_points(n_small, seed=1)
        gc = build_graph(xc, 8, device=dev)
        dl = dia.build_dia_layout(gc, max_offsets=128)
        if dl is None:
            fail(f"the {n_small}-point k=8 curve has no DIA layout")
        cc = laplacian_coeffs(gc, 2.0 * float(gc.sqdist.median().sqrt()))
        print(f"  {n_small}-point curve: D={dl.num_offsets} W={dl.halfwidth} Npd={dl.num_padded}")
        for band_dtype in (torch.float32, torch.bfloat16):
            band = dia.assemble(dl, cc.diag, cc.triu, dtype=band_dtype)
            for batch in DIA_WIDTHS:
                v = torch.randn((n_small, batch), generator=gen, device=dev)
                small_dia.append(compare_dia(dl, band, dia.permute_in(dl, v).contiguous(),
                                             f"curve{n_small} {str(band_dtype)[6:]}"))
    for name, offsets in (("gapped", dia.GAPPED_OFFSETS), ("wide", dia.spread_offsets())):
        for band_dtype in (torch.float32, torch.bfloat16):
            sl, sband = synthetic_dia(offsets, 3000, band_dtype, seed=len(offsets), device=dev)
            print(f"  synthetic {name}: D={sl.num_offsets} W={sl.halfwidth} Npd={sl.num_padded}")
            for batch in (1, 3, 37, 100, 128, 200):
                pv = torch.randn((sl.num_padded, batch), generator=gen, device=dev)
                pv[:dia.TILE] = 0.0
                pv[dia.TILE + sl.num_nodes:] = 0.0
                rec = compare_dia(sl, sband, pv, f"{name} {str(band_dtype)[6:]}")
                if batch > 1 and rec["template"] != "general":
                    fail(f"the {name} layout took the {rec['template']} template")
                small_dia.append(rec)
    report["small_dia"] = small_dia

    # -- phase 3: the slice at 262,144 points ------------------------------
    phase("phase 3: serve the 262,144-point torus")
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    result, params, model = serve_campaign(n=262_144, device=dev)
    launches = cuda_spmv.launch_count
    serve_bwd_launches = cuda_spmv.bwd_launch_count  # serving takes no gradient
    # the served basis at the trained hyperparameters, kept for phase 6a's
    # deflation (serve_campaign hands eval_basis the solved one)
    served_basis = model.kernel.eval_basis(params)
    result["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    result["spmv_launches"] = launches
    print("  " + json.dumps(result))
    print(f"  graph {result['graph_build_s']:.2f} s, layout {result['layout_s']:.2f} s, "
          f"basis {result['basis_s']:.2f} s, eval {result['eval_s']:.2f} s; "
          f"S={result['max_blocks']} row blocks={result['num_row_blocks']} "
          f"panels={result['panel_bytes_f32'] / 1e9:.3f} GB; kernel launches={launches}")
    print(f"  test RMSE {result['rmse_noisy_test']:.6f} NLL {result['nll_noisy_test']:.6f} "
          f"RMSE vs truth {result['rmse_vs_truth']:.6f} (noise floor "
          f"{result['noise_floor_rmse']:.6f})")
    report["serve_262k"] = result
    if launches < BASIS_APPLIES:
        fail(f"the SpMV kernel launched {launches} times on the main path (< {BASIS_APPLIES})")
    if not result["finite"]:
        fail("non-finite basis or posterior at 262k")
    if not result["rmse_vs_truth"] < 0.5 * result["noise_floor_rmse"]:
        fail(f"RMSE vs truth {result['rmse_vs_truth']} is not below half the noise floor")

    # -- phase 3L: the same torus with the default eigensolver (LOBPCG) -----
    phase("phase 3L: serve the 262,144-point torus with block LOBPCG (the config default)")
    from examples_torch.profile_gradient import profile_basis

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    cuda_spmv.launch_count_by_batch.clear()
    # LOVE at the modes' rank and above the Krylov exhaustion rank m + 1
    lres, lparams, lmodel = serve_campaign(n=262_144, device=dev, eigensolver="lobpcg",
                                           love_ranks=(100, 128), num_samples=64)
    lobpcg_launches = cuda_spmv.launch_count
    lres["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    lres["spmv_launches"] = lobpcg_launches
    lres["spmv_launches_by_batch"] = {str(b): c for b, c in
                                      sorted(cuda_spmv.launch_count_by_batch.items())}
    lob_vals = lmodel.kernel.eval_basis(lparams)[0]  # the solved basis, served
    cheb_vals = served_basis[0]
    rel = (torch.abs(lob_vals[1:] - cheb_vals[1:]) / cheb_vals[1:]).cpu()
    lres["eigval_vs_chebyshev"] = {
        "max_rel": float(rel.max()), "median_rel": float(rel.median()),
        "modes_within_1e-3": int((rel <= 1e-3).sum()) + 1,
        "modes_within_1e-2": int((rel <= 1e-2).sum()) + 1,
        "lobpcg": [float(v) for v in lob_vals.cpu()],
        "chebyshev": [float(v) for v in cheb_vals.cpu()]}
    lres["profile"] = profile_basis(lmodel.kernel, lparams)
    by_kind = lres["profile"]["device_ms_by_kind"]
    print("  " + json.dumps({k: v for k, v in lres.items()
                             if k not in ("eigval_vs_chebyshev", "profile")}))
    print(f"  basis {lres['basis_s']:.2f} s (Chebyshev, phase 3: {result['basis_s']:.2f} s); "
          f"forward launches by batch width {lres['basis_spmv_launches_by_batch']}; peak "
          f"memory {lres['peak_mem_bytes'] / 1e9:.3f} GB")
    print(f"  profiled solve: wall {lres['profile']['wall_ms']:.1f} ms, device "
          f"{lres['profile']['device_ms']:.1f} ms (idle {lres['profile']['device_idle_share']:.3f}): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in by_kind.items()))
    print(f"  eigenvalues vs Chebyshev: max rel {rel.max():.3e}, median {rel.median():.3e}, "
          f"{lres['eigval_vs_chebyshev']['modes_within_1e-2']} of 100 within 1e-2")
    print(f"  RMSE vs truth {lres['rmse_vs_truth']:.6f} (Chebyshev {result['rmse_vs_truth']:.6f}; "
          f"half the noise floor {0.5 * lres['noise_floor_rmse']:.6f}); NLL exact "
          f"{lres['nll_noisy_test']:.6f}, reference metric {lres['nll_noisy_test_reference']:.6f} "
          f"(Chebyshev exact {result['nll_noisy_test']:.6f}, reference "
          f"{result['nll_noisy_test_reference']:.6f})")
    for rank, rec in lres["love"].items():
        print(f"  LOVE rank {rank}: eval {rec['eval_s']:.3f} s, variances vs exact max rel "
              f"{rec['var_max_rel']:.3e} (max diff / max var {rec['var_max_diff_of_max']:.3e})")
    print(f"  exact variances in [{lres['exact_var_range'][0]:.3e}, "
          f"{lres['exact_var_range'][1]:.3e}]; 64 samples in {lres['samples_s']:.3f} s, "
          f"sample mean max |z| {lres['samples_mean_max_z']:.2f}")
    report["serve_262k_lobpcg"] = lres
    by_batch = lres["basis_spmv_launches_by_batch"]
    if by_batch.get("300", 0) < LOBPCG_ITERS or by_batch.get("100", 0) < LOBPCG_ITERS + 1:
        fail(f"the LOBPCG basis launched the forward kernel {by_batch} times by batch width "
             f"(< {LOBPCG_ITERS} at B=300 or < {LOBPCG_ITERS + 1} at B=100)")
    if not lres["finite"]:
        fail("non-finite LOBPCG basis, posterior, LOVE variances or samples at 262k")
    del lmodel, lparams, lob_vals
    torch.cuda.empty_cache()

    # -- phase 3M: the SRMNIST-shaped cloud against an f64 ARPACK oracle -----
    phase("phase 3M: the 10,010-point SRMNIST-shaped cloud, default config, vs ARPACK")
    report["cloud_10k"] = cloud_vs_arpack(dev)

    # -- phase 4: kernel vs plain at the main path's shapes -----------------
    phase("phase 4: kernel vs plain at the main path's shapes (B=125)")
    kernel = model.kernel
    layout = kernel.block_layout
    main_coeffs = kernel.coeffs(params)
    v = torch.randn((layout.num_nodes, 125), generator=gen, device=dev)
    pv = permute_in(layout, v).contiguous()
    del v, model

    timing = fwd_timing(layout)

    main = []
    for dtype, panels in panel_sets(layout, main_coeffs).items():
        rec = compare(layout, panels, pv, f"main {dtype}", timing=timing)
        del panels
        torch.cuda.empty_cache()
        print(f"    TB={rec['batch_tile']} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})")
        main.append(rec)
    report["main"] = main

    phase("phase 4a: forward kernel at the training path's widths")
    main_fwd_train = []
    for dtype, batches in (("bfloat16", (1, 48, 100)), ("float32x3", (48,))):
        tpanels = assemble(layout, main_coeffs.diag, main_coeffs.triu,
                           dtype=torch.bfloat16 if dtype == "bfloat16" else dtype)
        for batch in batches:
            v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
            rec = compare(layout, tpanels, permute_in(layout, v).contiguous(),
                          f"main {dtype}", timing=timing)
            print(f"    TB={rec['batch_tile']} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={rec['library_ms']} bound_ms={rec['bound_ms']:.4f} "
                  f"({rec['bound_by']})")
            main_fwd_train.append(rec)
            del v
        del tpanels
        torch.cuda.empty_cache()
    report["main_fwd_train"] = main_fwd_train

    phase("phase 4c: forward kernel with f32 panels at LOBPCG's widths (B = 100, 300)")
    main_fwd_lobpcg = []
    lpanels = assemble(layout, main_coeffs.diag, main_coeffs.triu)
    for batch in (LOBPCG_MODES, 3 * LOBPCG_MODES):
        v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
        rec = compare(layout, lpanels, permute_in(layout, v).contiguous(), "main float32",
                      timing=timing)
        print(f"    TB={rec['batch_tile']} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})")
        main_fwd_lobpcg.append(rec)
        del v
        torch.cuda.empty_cache()
    del lpanels
    torch.cuda.empty_cache()
    b100, b300 = main_fwd_lobpcg
    print(f"  B=300 against 3 x B=100: {b300['ms']:.4f} vs {3 * b100['ms']:.4f} ms")
    report["main_fwd_lobpcg"] = main_fwd_lobpcg

    timing_bwd = bwd_timing(layout)

    phase("phase 4b: panel-cotangent kernel vs plain at the training path's shapes")
    main_bwd = []
    for batch in (1, 48, 100):
        v = torch.randn((layout.num_nodes, batch), generator=gen, device=dev)
        pvb = permute_in(layout, v).contiguous()
        gct = torch.randn((layout.num_padded, batch), generator=gen, device=dev)
        del v
        # f32 is what the training path's edge-space backward asks for; bf16
        # is the panel-space backward's type for bf16 panels
        for out_dtype in (torch.float32, torch.bfloat16):
            rec = compare_bwd(layout, gct, pvb, out_dtype,
                              f"main bwd {str(out_dtype)[6:]}", timing=timing_bwd)
            print(f"    class {rec['batch_class']} ms={rec['ms']:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                  f"edge_gather_ms={rec['edge_gather_ms']}")
            main_bwd.append(rec)
    report["main_bwd"] = main_bwd
    main_shape = [layout.num_row_blocks, layout.max_blocks]
    del pv, pvb, gct, kernel, layout, main_coeffs, params
    torch.cuda.empty_cache()

    # -- phase 5: 16,384 points against the JAX package's numbers ----------
    phase("phase 5: serve 16,384 points, held to the JAX pins")
    pins = json.loads((ROOT / "examples_torch" / "serve_pins.json").read_text())
    r16, _, _ = serve_campaign(n=pins["n"], device=dev, num_test=pins["num_test"])
    checks = {}
    for key in ("rmse_vs_truth", "rmse_noisy_test", "nll_noisy_test"):
        rel = abs(r16[key] - pins[key]) / abs(pins[key])
        checks[key] = {"port": r16[key], "jax": pins[key], "rel": rel}
        print(f"  {key}: port {r16[key]:.7f} jax {pins[key]:.7f} rel {rel:.2e} "
              f"(rtol {pins['rtol']})")
        if not rel <= pins["rtol"]:
            fail(f"16k {key} differs from the JAX pin by {rel:.2e} > {pins['rtol']}")
    for key in ("num_edges", "max_blocks", "num_row_blocks"):
        if r16[key] != pins[key]:
            fail(f"16k {key}: port {r16[key]} != JAX {pins[key]}")
    lpin = pins["pins_lobpcg"]
    lvals, lbound = lobpcg_eigvals(lpin, device=dev)
    gap = float(np.max(np.abs(lvals - np.asarray(lpin["eigval"])))) / lbound
    print(f"  LOBPCG on the 16k Laplacian from the pinned numpy start block: max |port - JAX| / "
          f"bound = {gap:.3e} (atol {lpin['atol_of_bound']:.1e}; the port's CPU run: "
          f"{lpin['port_cpu_max_diff_of_bound']:.3e}); bound port {lbound:.6f} jax "
          f"{lpin['bound']:.6f}")
    if not (np.isfinite(lvals).all() and gap <= lpin["atol_of_bound"]):
        fail(f"16k LOBPCG eigenvalues differ from the JAX pins by {gap:.3e} of the bound")
    report["serve_16k"] = {"result": r16, "checks": checks,
                           "lobpcg": {"max_diff_of_bound": gap, "bound": lbound,
                                      "eigval": [float(v) for v in lvals]}}

    # -- phase 6: the training slice at 262,144 points ----------------------
    phase("phase 6: train the 262,144-point torus")
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    tres, tparams, tmodel = train_campaign(
        n=262_144, epochs=3, device=dev,
        deflation_bases={"initial": None, "trained": served_basis})
    train_fwd, train_bwd = cuda_spmv.launch_count, cuda_spmv.bwd_launch_count
    tres["spmv_launches"], tres["bwd_blocks_launches"] = train_fwd, train_bwd
    del served_basis
    if tres["num_edges"] != result["num_edges"]:
        fail(f"the training graph ({tres['num_edges']} edges) is not the served one "
             f"({result['num_edges']}): phase 3's basis does not fit it")
    print("  " + json.dumps({k: v for k, v in tres.items()
                             if k not in ("epoch_log", "jacobi_epoch_log", "gradients")}))
    for row, jrow in zip(tres["epoch_log"], tres["jacobi_epoch_log"]):
        print(f"  epoch {row['epoch']}: loss {row['loss']:.6f} in {row['seconds']:.3f} s "
              f"(Jacobi: {jrow['loss']:.6f} in {jrow['seconds']:.3f} s)  "
              f"noise {row['noise']:.5f} outputscale {row['outputscale']:.4f} "
              f"lengthscale {row['lengthscale']:.4f} graphbandwidth {row['graphbandwidth']:.4f}")
    for label, recs in tres["gradients"].items():
        for pname, rec in recs.items():
            if rec["bwd_blocks_launches"] < K3_PER_GRADIENT:
                fail(f"{rec['bwd_blocks_launches']} panel-cotangent launches in the {pname} "
                     f"gradient at {label} hyperparameters (< {K3_PER_GRADIENT})")
            if rec["spmv_launches"] < FWD_PER_GRADIENT:
                fail(f"{rec['spmv_launches']} forward launches in the {pname} gradient at "
                     f"{label} hyperparameters (< {FWD_PER_GRADIENT})")
    print(f"  training ({tres['precond_type']}, rebuilt every {tres['precond_refresh']} epochs): "
          f"{tres['s_per_epoch']:.3f} s per epoch (median; Jacobi {tres['jacobi_s_per_epoch']:.3f}), "
          f"launches forward {tres['train_launches']['spmv_launches']} / panel-cotangent "
          f"{tres['train_launches']['bwd_blocks_launches']} over {tres['epochs']} epochs; "
          f"peak memory {tres['peak_mem_bytes'] / 1e9:.3f} GB (edge-space cotangents)")
    if not tres["finite"]:
        fail("non-finite loss or gradient in the 262k training phase")
    if tres["train_launches"]["bwd_blocks_launches"] < K3_PER_GRADIENT * tres["epochs"]:
        fail("the panel-cotangent kernel launched fewer than 12 times per epoch")
    if tres["train_launches"]["spmv_launches"] < FWD_PER_GRADIENT * tres["epochs"]:
        fail("the forward kernel launched fewer than 150 times per epoch")
    for name in ("history", "jacobi_history"):
        if not tres[name][-1] < tres[name][0]:
            fail(f"the training loss did not fall: {name} {tres[name]}")

    phase("phase 6a: the torus preconditioners side by side")
    from examples_torch.run_large import build_precond

    for label, recs in tres["gradients"].items():
        for pname, rec in recs.items():
            extra = (f", basis solved in {rec['basis_s']:.2f} s" if "basis_s" in rec else "")
            print(f"  {label:<7} {pname:<9} build {rec['build_s'] * 1e3:8.1f} ms "
                  f"({rec['build_launches']['spmv_launches']} forward launches{extra}); CG "
                  f"iterations y {rec['cg_iters']['y']}, 48 columns {rec['cg_iters']['columns']}; "
                  f"gradient {rec['seconds']:.3f} s, forward {rec['spmv_launches']}, "
                  f"panel-cotangent {rec['bwd_blocks_launches']}, loss {rec['loss']:.6f}")
        if recs["pivchol"]["build_launches"]["spmv_launches"] < PIVCHOL_BUILD:
            fail(f"the pivoted-Cholesky build at {label} hyperparameters launched the forward "
                 f"kernel {recs['pivchol']['build_launches']['spmv_launches']} times "
                 f"(< {PIVCHOL_BUILD})")
    invariant = {}
    for label, hypers in (("initial", INITIAL_HYPERS), ("trained", CAMPAIGN_HYPERS)):
        pobj, build_s, build_launches = build_precond(tmodel, tmodel.init_params(**hypers),
                                                      "pivchol")
        x = torch.randn((tmodel.num_data, 4), generator=gen, device=dev)
        mx = pobj.L @ (pobj.L.T @ x) + pobj.d[:, None] * x
        err = float(torch.linalg.norm(pobj.apply(mx) - x) / torch.linalg.norm(x))
        invariant[label] = {"rel_err": err, "build_s": build_s, "build_launches": build_launches,
                            "rank": int(pobj.L.shape[1]),
                            "d_min": float(pobj.d.min()), "d_max": float(pobj.d.max())}
        print(f"  {label}: rebuilt in {build_s * 1e3:.1f} ms "
              f"({build_launches['spmv_launches']} forward launches); "
              f"||M^-1 M x - x|| / ||x|| = {err:.2e} (threshold {PIVCHOL_INVARIANT:.0e})")
        if build_launches["spmv_launches"] < PIVCHOL_BUILD:
            fail(f"a pivoted-Cholesky build launched the forward kernel "
                 f"{build_launches['spmv_launches']} times (< {PIVCHOL_BUILD})")
        if not err <= PIVCHOL_INVARIANT:
            fail(f"the pivoted-Cholesky preconditioner at {label} hyperparameters misses "
                 f"its invariant: {err:.2e}")
        del pobj, x, mx
    cfg = tmodel.cfg
    tmodel.cfg = cfg.replace(slq_precond_quadrature=True)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mbcg_loss, mbcg_grads = loss_and_grad(tmodel, tmodel.init_params(**CAMPAIGN_HYPERS),
                                          generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    mbcg = {"loss": mbcg_loss, "grads": mbcg_grads, "seconds": time.perf_counter() - t0,
            **launches_since(before),
            "plain_slq_loss": tres["gradients"]["trained"]["pivchol"]["loss"]}
    tmodel.cfg = cfg
    print(f"  mBCG at the trained hyperparameters (pivoted Cholesky built inside): loss "
          f"{mbcg_loss:.6f} against the plain quadrature's {mbcg['plain_slq_loss']:.6f}; "
          f"{mbcg['seconds']:.3f} s, forward {mbcg['spmv_launches']}, panel-cotangent "
          f"{mbcg['bwd_blocks_launches']}; gradients {mbcg_grads}")
    if not all(v == v and abs(v) != float("inf")
               for v in (mbcg_loss, *[g for g in mbcg_grads.values() if g is not None])):
        fail(f"non-finite mBCG loss or gradient: {mbcg_loss} {mbcg_grads}")
    tres["precond_invariant"], tres["mbcg"] = invariant, mbcg

    # the same gradient with panel-space cotangents, for its peak memory
    tmodel.kernel.cfg = tmodel.kernel.cfg.replace(solve_cotangent="panel")
    del tparams
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    panel_loss, panel_grads = loss_and_grad(
        tmodel, tmodel.init_params(**INITIAL_HYPERS),
        generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    tres["panel_mode"] = {"loss": panel_loss, "grads": panel_grads,
                          "seconds": time.perf_counter() - t0,
                          "peak_mem_bytes": int(torch.cuda.max_memory_allocated(dev))}
    print(f"  panel-space cotangents, one gradient at the initial hyperparameters: "
          f"{tres['panel_mode']['seconds']:.3f} s, peak memory "
          f"{tres['panel_mode']['peak_mem_bytes'] / 1e9:.3f} GB, loss {panel_loss:.6f}")
    report["train_262k"] = tres
    del tmodel
    torch.cuda.empty_cache()

    # -- phase 7: 16,384-point loss and gradients against the JAX pins -------
    phase("phase 7: loss and gradients at 16,384 points, held to the JAX pins")
    tpins = json.loads((ROOT / "examples_torch" / "train_pins.json").read_text())
    raw_names = list(tpins["pins"]["initial"]["grads"])
    parity = {}
    by_mode = {}
    # one campaign, both cotangent spaces: the two modes share the graph and
    # panels, so they differ only in the backward
    camp = build_campaign(
        n=tpins["n"], device=dev, num_test=tpins["num_test"], k=tpins["k"],
        seed=tpins["seed"], precond_type="jacobi",
        cg_tolerance=tpins["cg_tolerance"], cg_max_iter=tpins["cg_max_iter"])
    rec = layout_record(camp, tpins["n"], tpins["k"], 100)
    for key in ("num_edges", "max_blocks", "num_row_blocks"):
        if rec[key] != tpins[key]:
            fail(f"16k training {key}: port {rec[key]} != JAX {tpins[key]}")
    probes = torch.from_numpy(rademacher_numpy(
        tpins["probe_seed"], camp.model.num_data, tpins["num_probes"])).to(dev)
    for mode in ("edge", "panel"):
        camp.model.kernel.cfg = camp.model.kernel.cfg.replace(solve_cotangent=mode)
        torch.cuda.reset_peak_memory_stats(dev)
        by_mode[mode] = {
            label: loss_and_grad(camp.model, camp.model.init_params(**pin["hypers"]),
                                 probes=probes)
            for label, pin in tpins["pins"].items()
        }
        parity[f"peak_mem_bytes_{mode}"] = int(torch.cuda.max_memory_allocated(dev))
    # phase 7a's numbers: edge-space cotangents, pivoted Cholesky
    camp.model.kernel.cfg = camp.model.kernel.cfg.replace(solve_cotangent="edge")
    camp.model.cfg = camp.model.cfg.replace(precond_type="pivchol")
    by_mode["pivchol"] = {
        label: loss_and_grad(camp.model, camp.model.init_params(**pin["hypers"]),
                             probes=probes)
        for label, pin in tpins["pins_pivchol"].items()
    }
    del camp, probes
    torch.cuda.empty_cache()
    for label, pin in tpins["pins"].items():
        loss, grads = by_mode["edge"][label]
        rel = abs(loss - pin["loss"]) / abs(pin["loss"])
        gscale = max(abs(v) for v in pin["grads"].values())
        gerr = max(abs(grads[k] - pin["grads"][k]) for k in raw_names) / gscale
        ploss, pgrads = by_mode["panel"][label]
        ppin = tpins["pins_panel"][label]
        prel = abs(ploss - ppin["loss"]) / abs(ppin["loss"])
        pscale = max(abs(v) for v in ppin["grads"].values())
        pgerr = max(abs(pgrads[k] - ppin["grads"][k]) for k in raw_names) / pscale
        ep_loss = abs(loss - ploss) / abs(loss)
        ep_grad = max(abs(grads[k] - pgrads[k]) for k in raw_names) / gscale
        parity[label] = {"port": {"loss": loss, "grads": grads}, "jax": pin,
                         "loss_rel": rel, "grad_rel_of_max": gerr,
                         "panel": {"loss": ploss, "grads": pgrads, "jax": ppin,
                                   "loss_rel": prel, "grad_rel_of_max": pgerr},
                         "edge_vs_panel_loss_rel": ep_loss,
                         "edge_vs_panel_grad_rel_of_max": ep_grad}
        print(f"  {label}: loss port {loss:.7f} jax {pin['loss']:.7f} rel {rel:.2e} "
              f"(rtol {tpins['loss_rtol']}); gradients max diff / max |grad| {gerr:.2e} "
              f"(rtol {tpins['grad_rtol']}); edge vs panel: loss {ep_loss:.2e}, "
              f"gradients {ep_grad:.2e} (rtol {EDGE_PANEL_RTOL})")
        print(f"  {label}, panel-space cotangents over bf16 panels: loss port {ploss:.7f} "
              f"jax {ppin['loss']:.7f} rel {prel:.2e}; gradients max diff / max |grad| "
              f"{pgerr:.2e}")
        if not all(v is not None and v == v for v in grads.values() if v is not None):
            fail(f"16k {label}: non-finite gradient")
        if not rel <= tpins["loss_rtol"]:
            fail(f"16k {label} loss differs from the JAX pin by {rel:.2e}")
        if not gerr <= tpins["grad_rtol"]:
            fail(f"16k {label} gradients differ from the JAX pins by {gerr:.2e}")
        if not prel <= tpins["loss_rtol"]:
            fail(f"16k {label} panel-space loss differs from the JAX pin by {prel:.2e}")
        if not pgerr <= tpins["grad_rtol"]:
            fail(f"16k {label} panel-space gradients differ from the JAX pins by {pgerr:.2e}")
        if not (ep_loss <= 1e-5 and ep_grad <= EDGE_PANEL_RTOL):
            fail(f"16k {label}: edge and panel cotangents disagree "
                 f"(loss {ep_loss:.2e}, gradients {ep_grad:.2e})")
    # checkpoint -> resume on the card: the generator states of a CUDA run
    # travel through the .npz file (the CPU tests cannot reach that)
    import tempfile

    from manifold_gp_torch.utils import manifold_informed_train

    camp = build_campaign(n=tpins["n"], device=dev, num_test=tpins["num_test"], k=tpins["k"],
                          seed=tpins["seed"], precond_type="jacobi")
    kw = dict(lr=1e-1, num_rand_vec=100, seed=5, update_norm=1)
    _, _, straight = manifold_informed_train(
        camp.model, camp.model.init_params(**INITIAL_HYPERS), max_iter=3, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = pathlib.Path(tmp) / "train.ckpt.npz"
        try:  # the same run, cut off when epoch 2 reports: its checkpoint is of epoch 2
            manifold_informed_train(camp.model, camp.model.init_params(**INITIAL_HYPERS),
                                    max_iter=3, checkpoint_path=ckpt, checkpoint_every=2,
                                    metrics=_CutAt(2), **kw)
        except _Cut:
            pass
        else:
            fail("the interrupted run was not interrupted")
        _, _, resumed = manifold_informed_train(
            camp.model, camp.model.init_params(**INITIAL_HYPERS), max_iter=3,
            checkpoint_path=ckpt, checkpoint_every=100, **kw)
    del camp
    torch.cuda.empty_cache()
    # same probes and indices from the restored generators
    resume_err = max(abs(a - b) / abs(a) for a, b in zip(straight[2:], resumed))
    parity["resume"] = {"straight": straight, "resumed_tail": resumed, "max_rel": resume_err}
    print(f"  checkpoint/resume at 16k: epochs 2-3 after a resume {resumed} vs uninterrupted "
          f"{straight[2:]} (max rel {resume_err:.2e}, rtol 1e-4)")
    if len(resumed) != 2 or not resume_err <= 1e-4:
        fail(f"a resumed run does not reproduce the uninterrupted one: {resumed} vs {straight}")
    print(f"  peak memory at 16k: edge {parity['peak_mem_bytes_edge'] / 1e9:.3f} GB, "
          f"panel {parity['peak_mem_bytes_panel'] / 1e9:.3f} GB")
    phase("phase 7a: loss and gradients at 16,384 points with pivoted Cholesky, "
          "held to the JAX pins")
    for label, pin in tpins["pins_pivchol"].items():
        loss, grads = by_mode["pivchol"][label]
        rel = abs(loss - pin["loss"]) / abs(pin["loss"])
        jac_rel = abs(loss - tpins["pins"][label]["loss"]) / abs(tpins["pins"][label]["loss"])
        gscale = max(abs(v) for v in pin["grads"].values())
        gerr = max(abs(grads[k] - pin["grads"][k]) for k in raw_names) / gscale
        parity[label]["pivchol"] = {"loss": loss, "grads": grads, "jax": pin, "loss_rel": rel,
                                    "loss_rel_to_jacobi_pin": jac_rel, "grad_rel_of_max": gerr}
        print(f"  {label}: loss port {loss:.7f} jax {pin['loss']:.7f} rel {rel:.2e}, against "
              f"the Jacobi pin {jac_rel:.2e} (rtol {tpins['loss_rtol']}); gradients max diff / "
              f"max |grad| {gerr:.2e} (rtol {tpins['grad_rtol']})")
        if not all(v == v for v in grads.values() if v is not None):
            fail(f"16k {label}: non-finite gradient with pivoted Cholesky")
        if not (rel <= tpins["loss_rtol"] and jac_rel <= tpins["loss_rtol"]):
            fail(f"16k {label} pivoted-Cholesky loss differs from the JAX pins by {rel:.2e} "
                 f"(pivchol) / {jac_rel:.2e} (Jacobi)")
        if not gerr <= tpins["grad_rtol"]:
            fail(f"16k {label} pivoted-Cholesky gradients differ from the JAX pins by {gerr:.2e}")
    report["train_16k"] = parity

    # -- phase 8: the curve training slice at 262,144 points ------------------
    phase("phase 8: train the 262,144-point curve at k = 8 (DIA bands)")
    torch.cuda.empty_cache()
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = dia.dia_launch_count = 0
    dia.dia_band_grad_launch_count = 0
    cres, _, cmodel = train_campaign(n=262_144, epochs=3, device=dev, manifold="curve", k=8)
    curve_counts = launch_counts()
    cres["launches"] = curve_counts
    print("  " + json.dumps({k: v for k, v in cres.items()
                             if k not in ("epoch_log", "jacobi_epoch_log", "gradients")}))
    print(f"  layout: DIA, D={cres['num_offsets']} offsets, halfwidth W={cres['halfwidth']}, "
          f"Npd={cres['num_padded']} rows, band {cres['band_bytes_f32'] / 1e6:.1f} MB stored "
          f"({cres['band_bytes_used_f32'] / 1e6:.1f} MB in the D used lanes)")
    for row, jrow in zip(cres["epoch_log"], cres["jacobi_epoch_log"]):
        print(f"  epoch {row['epoch']}: loss {row['loss']:.6f} in {row['seconds']:.3f} s "
              f"(Jacobi: {jrow['loss']:.6f} in {jrow['seconds']:.3f} s)  "
              f"noise {row['noise']:.5f} outputscale {row['outputscale']:.4f} "
              f"lengthscale {row['lengthscale']:.4f} graphbandwidth {row['graphbandwidth']:.4f}")
    if cres["layout"] != "dia":
        fail(f"the k=8 curve did not take the DIA layout: {cres['layout']}")
    for label, recs in cres["gradients"].items():
        for pname, rec in recs.items():
            print(f"  {label:<7} {pname:<7} build {rec['build_s'] * 1e3:7.1f} ms "
                  f"({rec['build_launches']['dia_launches']} K4 launches); CG iterations y "
                  f"{rec['cg_iters']['y']}, 128 columns {rec['cg_iters']['columns']}; gradient "
                  f"{rec['seconds']:.3f} s, K4 launches {rec['dia_launches']}, "
                  f"loss {rec['loss']:.6f}")
            if rec["dia_launches"] < K4_PER_GRADIENT:
                fail(f"{rec['dia_launches']} K4 launches in the curve {pname} gradient at {label} "
                     f"hyperparameters (< {K4_PER_GRADIENT})")
        if recs["pivchol"]["build_launches"]["dia_launches"] < PIVCHOL_BUILD:
            fail(f"the curve's pivoted-Cholesky build at {label} hyperparameters launched K4 "
                 f"{recs['pivchol']['build_launches']['dia_launches']} times (< {PIVCHOL_BUILD})")
    print(f"  training ({cres['precond_type']}): {cres['s_per_epoch']:.3f} s per epoch (median; "
          f"Jacobi {cres['jacobi_s_per_epoch']:.3f}), K4 launches "
          f"{cres['train_launches']['dia_launches']} over {cres['epochs']} epochs, "
          f"{curve_counts['dia_launches']} in the phase (K5 "
          f"{curve_counts['band_grad_launches']}); peak memory "
          f"{cres['peak_mem_bytes'] / 1e9:.3f} GB")
    if curve_counts["spmv_launches"] or curve_counts["bwd_blocks_launches"]:
        fail(f"block-ELL kernels launched on the DIA path: {curve_counts}")
    if not curve_counts["band_grad_launches"]:
        fail("K5 (the band cotangent) never launched on the curve's training path")
    if cres["train_launches"]["dia_launches"] < K4_PER_GRADIENT * cres["epochs"]:
        fail("K4 launched fewer than 192 times per epoch")
    if not cres["finite"]:
        fail("non-finite loss or gradient in the 262k curve training phase")
    for name in ("history", "jacobi_history"):
        if not cres[name][-1] < cres[name][0]:
            fail(f"the curve training loss did not fall: {name} {cres[name]}")
    report["curve_train_262k"] = cres
    del cmodel
    torch.cuda.empty_cache()

    phase("phase 8a: serve the 262,144-point curve on the host f64 basis")
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = dia.dia_launch_count = 0
    sres, sparams, smodel = serve_campaign(n=262_144, device=dev, manifold="curve", k=8,
                                           hypers=cres["trained_hypers"])
    sres["launches"] = launch_counts()
    print("  " + json.dumps(sres))
    print(f"  graph {sres['graph_build_s']:.2f} s, layout {sres['layout_s']:.2f} s, "
          f"basis {sres['basis_s']:.2f} s (host f64), eval {sres['eval_s']:.2f} s; "
          f"test RMSE {sres['rmse_noisy_test']:.6f} NLL {sres['nll_noisy_test']:.6f} "
          f"RMSE vs truth {sres['rmse_vs_truth']:.6f} (noise floor "
          f"{sres['noise_floor_rmse']:.6f}; no k = 8 number to hold it to)")
    if not sres["finite"]:
        fail("non-finite basis or posterior on the 262k curve")
    if not sres["rmse_vs_truth"] < sres["noise_floor_rmse"]:
        fail(f"curve RMSE vs truth {sres['rmse_vs_truth']} is not below the noise floor")
    report["curve_serve_262k"] = sres

    phase("phase 8b: K4 vs plain at the served curve layout, and DIA vs panels")
    dlayout = smodel.kernel.block_layout
    dcoeffs = smodel.kernel.coeffs(sparams)
    dband = dia.assemble(dlayout, dcoeffs.diag, dcoeffs.triu)
    csr = band_csr(dlayout, dband)

    def dia_timing(layout, band, pv, csr=None):
        b = pv.shape[1]
        rec = bound(roofline.matvec_bytes(layout, b, buf_dtype_bytes=band.element_size())["total"],
                    roofline.matvec_flops(layout, b), 4)
        rec.update({
            "ms": time_ms(lambda: dia.dia_matvec_call(layout, band, pv)),
            "device_ms": graph_ms(lambda: dia.dia_matvec_call(layout, band, pv)),
            "plain_ms": time_ms(lambda: dia.matvec_permuted(layout, band, pv), reps=3, runs=2),
            "library_ms": None if csr is None else time_ms(lambda: torch.sparse.mm(csr, pv)),
            "library_device_ms": None if csr is None else graph_ms(
                lambda: torch.sparse.mm(csr, pv))})
        if csr is not None:
            lib = torch.sparse.mm(csr, pv)
            rec["library_rel_err"] = float((lib - dia.matvec_permuted(layout, band, pv)).abs().max()
                                           / lib.abs().max())
        return rec

    def host_us(fn, calls=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def dia_host_us(layout, band, pv, csr):
        """Where K4's time per call goes at a width whose kernel is shorter
        than the host's work (B = 1): the wrapper, the bare C entry with
        the wrapper's arguments made once, and the wrapper's output
        allocation alone; sparse.mm beside them."""
        npd, b = pv.shape
        lib = cuda_spmv._load()
        offsets, d, w, kind, rows, block = dia._launch_args(layout.offsets, layout.halfwidth,
                                                            b, band.element_size())
        out = torch.empty_like(pv)
        bare = (band.data_ptr(), pv.data_ptr(), out.data_ptr(), offsets, d, w, npd, b,
                dia.BAND_WIDTH, 0, kind, rows, block, torch.cuda.current_stream().cuda_stream)
        return {"dia_matvec_call": host_us(lambda: dia.dia_matvec_call(layout, band, pv)),
                "c_entry": host_us(lambda: lib.dia_spmv(*bare)),
                "torch.empty": host_us(lambda: torch.empty((npd, b), device=pv.device)),
                "sparse.mm": host_us(lambda: torch.sparse.mm(csr, pv))}

    main_dia = []
    band_grad = []  # K5 on the k = 8 curve, then the k = 16 curve (the curve262k cell's)
    for batch in (1, 100, 128):
        v = torch.randn((dlayout.num_nodes, batch), generator=gen, device=dev)
        pv = dia.permute_in(dlayout, v).contiguous()
        rec = compare_dia(dlayout, dband, pv, "served curve float32")
        rec.update(dia_timing(dlayout, dband, pv, csr))
        print(f"    {rec['template']} (R={rec['rows_per_thread']}, TR={rec['rows_per_block']}): "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}); device only (graph replay) {rec['device_ms']:.4f} vs "
              f"sparse.mm {rec['library_device_ms']:.4f}; sparse.mm vs plain "
              f"{rec['library_rel_err']:.1e}")
        if batch == 1:
            rec["host_us"] = dia_host_us(dlayout, dband, pv, csr)
            print("    host us per call (2,000 calls, synchronised before and after): " +
                  ", ".join(f"{k} {v:.1f}" for k, v in rec["host_us"].items()))
        main_dia.append(rec)
        # K5 at the widths phase 8's backward passes launch it with on this layout
        gb = dia.permute_in(dlayout, torch.randn((dlayout.num_nodes, batch), generator=gen,
                                                 device=dev)).contiguous()
        band_grad.append(band_grad_check(dlayout, gb, pv, torch.float32,
                                         "served curve float32"))
        del gb
    del csr
    report["main_dia"] = main_dia

    def panel_ms(graph, coeffs, pv_nodes):
        blayout = build_block_layout(graph)
        panels = assemble(blayout, coeffs.diag, coeffs.triu)
        pvb = permute_in(blayout, pv_nodes).contiguous()
        ms = time_ms(lambda: cuda_spmv.block_matvec(blayout, panels, pvb))
        return ms, blayout.max_blocks, blayout.num_row_blocks

    crossover = []
    v128 = torch.randn((dlayout.num_nodes, 128), generator=gen, device=dev)
    pms, s_blocks, nrb = panel_ms(smodel.kernel.graph, dcoeffs, v128)
    k4 = main_dia[-1]  # B = 128, the probes' width
    crossover.append({"k": 8, "num_offsets": dlayout.num_offsets, "halfwidth": dlayout.halfwidth,
                      "batch": 128, "dia_ms": k4["ms"], "template": k4["template"],
                      "library_ms": k4["library_ms"], "bound_ms": k4["bound_ms"],
                      "panel_ms": pms, "max_blocks": s_blocks, "num_row_blocks": nrb})
    del smodel, sparams, dband, v128
    torch.cuda.empty_cache()
    # the k = 16 and k = 24 curves: DIA forced (128 offsets allowed) against panels
    xc, _ = curve_points(262_144, seed=0)
    for k_wide in (16, 24):
        gk = build_graph(xc, k_wide, device=dev)
        ck = laplacian_coeffs(gk, 2.0 * float(gk.sqdist.median().sqrt()))
        lk = dia.build_dia_layout(gk, max_offsets=128)
        if lk is None:
            fail(f"the k={k_wide} curve has no DIA layout even with 128 offsets")
        bk = dia.assemble(lk, ck.diag, ck.triu)
        vk = torch.randn((lk.num_nodes, 128), generator=gen, device=dev)
        pvk = dia.permute_in(lk, vk).contiguous()
        rec = compare_dia(lk, bk, pvk, f"k{k_wide} curve float32")
        csr = band_csr(lk, bk)
        rec.update(dia_timing(lk, bk, pvk, csr))
        del csr
        if k_wide == 16:  # curve262k's layout: K5 at the backward's widths and B = 100
            for batch in (1, 100, 128):
                gb = dia.permute_in(lk, torch.randn((lk.num_nodes, batch), generator=gen,
                                                    device=dev)).contiguous()
                pb = pvk if batch == 128 else dia.permute_in(lk, torch.randn(
                    (lk.num_nodes, batch), generator=gen, device=dev)).contiguous()
                band_grad.append(band_grad_check(lk, gb, pb, torch.float32,
                                                 "k16 curve float32"))
                del gb, pb
        pms, s_blocks, nrb = panel_ms(gk, ck, vk)
        crossover.append({"k": k_wide, "num_offsets": lk.num_offsets, "halfwidth": lk.halfwidth,
                          "batch": 128, "dia_ms": rec["ms"], "template": rec["template"],
                          "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
                          "max_rel_err": rec["dia_matvec_call"]["max_rel_err"],
                          "panel_ms": pms, "max_blocks": s_blocks, "num_row_blocks": nrb})
        del gk, ck, lk, bk, vk, pvk
        torch.cuda.empty_cache()
    for row in crossover:
        print(f"  crossover k={row['k']}: D={row['num_offsets']} W={row['halfwidth']} DIA "
              f"{row['dia_ms']:.4f} ms ({row['template']}; sparse.mm {row['library_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f}) vs block-ELL f32 panels {row['panel_ms']:.4f} ms "
              f"(S={row['max_blocks']}) at B={row['batch']}")
    report["dia_vs_panels"] = crossover
    report["band_grad"] = band_grad
    k5 = band_grad[-1]  # B = 128, the probes' width

    # -- phase 9: 16,384-point curve against the JAX pins -------------------
    phase("phase 9: the 16,384-point curve, held to the JAX pins")
    cpins = json.loads((ROOT / "examples_torch" / "curve_pins.json").read_text())
    camp = build_campaign(n=cpins["n"], device=dev, num_test=cpins["num_test"], k=cpins["k"],
                          seed=cpins["seed"], manifold="curve",
                          cg_tolerance=cpins["cg_tolerance"], cg_max_iter=cpins["cg_max_iter"])
    rec = layout_record(camp, cpins["n"], cpins["k"], cpins["num_modes"])
    for key in ("num_offsets", "halfwidth", "num_padded"):
        if rec[key] != cpins[key]:
            fail(f"16k curve {key}: port {rec[key]} != JAX {cpins[key]}")
    if abs(rec["num_edges"] - cpins["num_edges"]) > EDGE_TIES * cpins["num_edges"]:
        fail(f"16k curve edges: port {rec['num_edges']} vs JAX {cpins['num_edges']}")
    probes = torch.from_numpy(rademacher_numpy(
        cpins["probe_seed"], camp.model.num_data, cpins["num_probes"])).to(dev)
    closs, cgrads = loss_and_grad(camp.model, camp.model.init_params(**cpins["train"]["hypers"]),
                                  probes=probes)
    pin = cpins["train"]
    crel = abs(closs - pin["loss"]) / abs(pin["loss"])
    cscale = max(abs(v) for v in pin["grads"].values())
    cgerr = max(abs(cgrads[k] - pin["grads"][k]) for k in pin["grads"]) / cscale
    print(f"  edges port {rec['num_edges']} jax {cpins['num_edges']}; D={rec['num_offsets']} "
          f"W={rec['halfwidth']} Npd={rec['num_padded']}")
    print(f"  loss port {closs:.7f} jax {pin['loss']:.7f} rel {crel:.2e} "
          f"(rtol {cpins['loss_rtol']}); gradients max diff / max |grad| {cgerr:.2e} "
          f"(rtol {cpins['grad_rtol']})")
    if not crel <= cpins["loss_rtol"]:
        fail(f"16k curve loss differs from the JAX pin by {crel:.2e}")
    if not cgerr <= cpins["grad_rtol"]:
        fail(f"16k curve gradients differ from the JAX pins by {cgerr:.2e}")
    del camp, probes
    r16c, _, _ = serve_campaign(n=cpins["n"], device=dev, num_test=cpins["num_test"],
                                manifold="curve", k=cpins["k"], hypers=cpins["serve"]["hypers"])
    serve_checks = {}
    for key in ("rmse_vs_truth", "rmse_noisy_test", "nll_noisy_test"):
        rel = abs(r16c[key] - cpins["serve"][key]) / abs(cpins["serve"][key])
        serve_checks[key] = {"port": r16c[key], "jax": cpins["serve"][key], "rel": rel}
        print(f"  serve {key}: port {r16c[key]:.7f} jax {cpins['serve'][key]:.7f} rel {rel:.2e} "
              f"(rtol {cpins['serve_rtol']})")
        if not rel <= cpins["serve_rtol"]:
            fail(f"16k curve serve {key} differs from the JAX pin by {rel:.2e}")
    report["curve_16k"] = {"loss": closs, "grads": cgrads, "loss_rel": crel,
                           "grad_rel_of_max": cgerr, "serve": serve_checks,
                           "num_edges": rec["num_edges"]}

    # -- phase 10: the semisupervised spiral at 10,010 points ----------------
    phase("phase 10: spiral10k-semisup (Schur IMGP, vanilla baseline, blend)")
    from examples_torch.profile_gradient import trace_gradient
    from examples_torch.run_spiral import PINS_PATH, check_pins, run_experiment
    from manifold_gp_torch.ops import cg as cg_ops

    del r16c
    torch.cuda.empty_cache()
    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    cuda_spmv.launch_count_by_batch.clear()
    cuda_spmv.bwd_launch_count_by_batch.clear()
    handles = {}
    spiral = run_experiment(max_iter=SPIRAL_EPOCHS, device=dev, handles=handles)
    spiral_fwd, spiral_bwd = cuda_spmv.launch_count, cuda_spmv.bwd_launch_count
    spiral_fwd_by = {str(b): c for b, c in sorted(cuda_spmv.launch_count_by_batch.items())}
    spiral_bwd_by = {str(b): c for b, c in sorted(cuda_spmv.bwd_launch_count_by_batch.items())}
    smodel, sparams = handles["model"], handles["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_spmv.launch_count_by_batch.clear()
    smodel.kernel.eval_basis(sparams)
    torch.cuda.synchronize()
    spiral_basis_s = time.perf_counter() - t0
    basis_by = {str(b): c for b, c in sorted(cuda_spmv.launch_count_by_batch.items())}
    spiral_profile = trace_gradient(smodel, sparams,
                                    generator=torch.Generator(device=dev).manual_seed(5))
    spiral.update(launches={"forward": spiral_fwd, "bwd_blocks": spiral_bwd,
                            "forward_by_batch": spiral_fwd_by, "bwd_blocks_by_batch": spiral_bwd_by},
                  basis_s=spiral_basis_s, basis_launches_by_batch=basis_by,
                  gradient_profile=spiral_profile)
    pins_failures = check_pins(spiral, json.loads(PINS_PATH.read_text()))
    inner, outer = spiral["inner_cg"], spiral["outer_cg"]
    print(f"  layout {spiral['layout']} S={spiral['max_blocks']} row blocks="
          f"{spiral['num_row_blocks']}; {SPIRAL_EPOCHS} epochs in {spiral['train_s']:.2f} s "
          f"(median epoch {spiral['epoch_s_median']:.4f} s, first {spiral['epoch_s_first']:.3f} s)")
    print(f"  launches (training and IMGP eval): forward {spiral_fwd} by width {spiral_fwd_by}, "
          f"K3 {spiral_bwd} by width {spiral_bwd_by}")
    print(f"  inner CG per Schur apply: mean {inner.get('mean', 0):.3f}, max {inner.get('max', 0)} "
          f"({inner['solves']} solves); outer CG: mean {outer.get('mean', 0):.3f}, max "
          f"{outer.get('max', 0)} ({outer['solves']} solves); training peak "
          f"{spiral['train_peak_mem_bytes'] / 1e9:.3f} GB, allocated after the first / last "
          f"epoch {spiral['allocated_bytes_after_epoch']}")
    print(f"  IMGP RMSE {spiral['imgp_rmse']:.6f} NLL {spiral['imgp_nll']:.6f} (eval "
          f"{spiral['imgp_eval_s']:.2f} s); vanilla RMSE {spiral['vanilla_rmse']:.6f} NLL "
          f"{spiral['vanilla_nll']:.6f} ({spiral['vanilla_s']:.2f} s); advantage "
          f"{spiral['advantage']:.3f}; hybrid blend RMSE {spiral['hybrid_rmse']:.6f} NLL "
          f"{spiral['hybrid_nll']:.6f} ({spiral['hybrid_s']:.2f} s)")
    print(f"  LOBPCG basis {spiral_basis_s:.3f} s, launches by width {basis_by}; one gradient at "
          f"the trained point: wall {spiral_profile['wall_ms']:.1f} ms, device "
          f"{spiral_profile['device_ms']:.1f} ms, idle {spiral_profile['device_idle_share']:.3f}")
    print(f"  check-pins ({PINS_PATH.relative_to(ROOT)}): "
          f"{'OK' if not pins_failures else pins_failures}")
    report["spiral_10k"] = spiral
    for key in ("imgp_loss", "imgp_rmse", "imgp_nll", "vanilla_loss", "vanilla_rmse",
                "vanilla_nll", "hybrid_rmse", "hybrid_nll"):
        if not np.isfinite(spiral[key]):
            fail(f"spiral {key} is not finite: {spiral[key]}")
    if not (spiral_fwd_by.get("64", 0) > 0 and spiral_fwd_by.get("1", 0) > 0):
        fail(f"the spiral's training made no forward launch at B = 64 or B = 1: {spiral_fwd_by}")
    if spiral_bwd <= 0:
        fail("the spiral's training launched no panel cotangent (K3)")
    if pins_failures:
        fail(f"spiral check-pins: {pins_failures}")
    # The kernels against their plain versions at the spiral's own layout
    # (S = 3, the widths its training and basis launch).
    spiral["kernel_vs_plain"] = hold_at_layout(
        smodel, sparams, "spiral", (1, 64, LOBPCG_MODES, 3 * LOBPCG_MODES), (1, 64), 10, dev)
    del handles, smodel, sparams

    phase("phase 10a: spiral5k-semisup parity (and the vanilla BBMM loss) vs the JAX pins")
    spins = json.loads((ROOT / "examples_torch" / "semisup_pins.json").read_text())
    cg_ops.iteration_log = None
    parity = semisup_parity(spins, device=dev)
    lay = parity.pop("semisup_layout")
    for key in ("layout", "max_blocks", "num_row_blocks"):
        if lay[key] != spins["semisup"][key]:
            fail(f"spiral5k {key}: port {lay[key]} != JAX {spins['semisup'][key]}")
    if abs(lay["num_edges"] - spins["semisup"]["num_edges"]) > EDGE_TIES * lay["num_edges"]:
        fail(f"spiral5k edges: port {lay['num_edges']} vs JAX {spins['semisup']['num_edges']}")
    vpins = spins["vanilla"]["pins"]
    for label, rec in parity.items():
        hold_loss = rec.get("hold_loss", True)
        pin = vpins.get(label.removeprefix("vanilla_"), {}) if label.startswith("vanilla") else {}
        held = (f"rtol {spins['loss_rtol']}" if hold_loss else
                f"vs the f64 loss {rec['exact_rel']:.3e}, limit {pin['exact_rtol']:.3e}")
        print(f"  {label}: loss {rec['loss']:.7f} rel {rec['loss_rel']:.2e} ({held}); "
              f"gradients {rec['grad_rel_of_max']:.2e} of the largest (rtol {spins['grad_rtol']})"
              + (f"; pivots {rec['pivots']}" if "pivots" in rec else ""))
        if hold_loss and not rec["loss_rel"] <= spins["loss_rtol"]:
            fail(f"{label} loss differs from the JAX pin by {rec['loss_rel']:.2e}")
        if not hold_loss and not rec["exact_rel"] <= pin["exact_rtol"]:
            fail(f"{label} loss differs from the f64 loss by {rec['exact_rel']:.2e}")
        if not rec["grad_rel_of_max"] <= spins["grad_rtol"]:
            fail(f"{label} gradients differ from the JAX pins by {rec['grad_rel_of_max']:.2e}")
    report["spiral_parity"] = {"layout": lay, **parity}

    ref_report, ref_paths = reference_protocols(dev)
    report.update(ref_report)
    prod_report, prod_paths = production_campaign(dev)
    report.update(prod_report)
    mesh_report, mesh_paths = mesh_phases(
        dev, smi_line, report["graph_backends"]["exact"]["build_graph_s"])
    report.update(mesh_report)

    # -- result --------------------------------------------------------------
    f32 = main[0]
    bwd = next(r for r in main_bwd if r["batch"] == 48 and r["out_dtype"] == "float32")
    if min(launches, lobpcg_launches, train_fwd, train_bwd, curve_counts["dia_launches"],
           spiral_fwd, spiral_bwd, *ref_paths["required"], *prod_paths["required"],
           *mesh_paths["required"]) <= 0:
        fail("a kernel of a main path was never launched on it")
    kernels = [{
        "name": "block_ell_spmv",
        "route": "cuda",
        "source": "manifold_gp_torch/csrc/block_ell_spmv.cu",
        "replaces": "manifold_gp_tpu/ops/pallas_spmv.py:207",
        "also_replaces": "manifold_gp_tpu/ops/pallas_spmv.py:126",
        "launches": launches,
        "launches_by_path": {
            "serve": launches, "serve_lobpcg": lobpcg_launches,
            "serve_lobpcg_by_batch": report["serve_262k_lobpcg"]["spmv_launches_by_batch"],
            "cloud_10k_lobpcg": report["cloud_10k"]["spmv_launches"], "train": train_fwd,
            "precond_build": tres["gradients"]["trained"]["pivchol"]["build_launches"][
                "spmv_launches"],
            "spiral_semisup": spiral_fwd, "spiral_semisup_by_batch": spiral_fwd_by,
            "spiral_basis_by_batch": spiral["basis_launches_by_batch"],
            **ref_paths["forward"], **prod_paths["forward"], **mesh_paths["forward"]},
        "max_abs_err": f32["stream_matvec_call"]["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "panels": "float32",
        "batch_tile": f32["batch_tile"],
        "shape": [*main_shape, 125],
        "other_shapes": [
            {k: r[k] for k in ("panels", "batch", "batch_tile", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
            for r in main[1:] + main_fwd_train + main_fwd_lobpcg
        ],
    }, {
        "name": "block_ell_bwd_blocks",
        "route": "cuda",
        "source": "manifold_gp_torch/csrc/block_ell_bwd_blocks.cu",
        "replaces": "manifold_gp_tpu/ops/pallas_spmv.py:317",
        "launches": train_bwd,
        "launches_by_path": {"serve": serve_bwd_launches, "train": train_bwd,
                             "spiral_semisup": spiral_bwd,
                             "spiral_semisup_by_batch": spiral_bwd_by,
                             **ref_paths["bwd_blocks"], **prod_paths["bwd_blocks"],
                             **mesh_paths["bwd_blocks"]},
        "max_abs_err": bwd["block_bwd_blocks"]["max_abs_err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "output": "float32",
        "batch_class": bwd["batch_class"],
        "shape": [*main_shape, 48],
        "edge_gather_ms": bwd["edge_gather_ms"],
        "other_shapes": [
            {k: r[k] for k in ("batch", "out_dtype", "batch_class", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
            | {"max_rel_err": r["block_bwd_blocks"]["max_rel_err"]}
            for r in main_bwd if r is not bwd
        ],
    }, {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "manifold_gp_torch/csrc/dia_spmv.cu",
        "replaces": "manifold_gp_tpu/ops/dia.py:192",
        "launches": curve_counts["dia_launches"],
        "launches_by_path": {"curve_train": curve_counts["dia_launches"],
                             "curve_serve": sres["launches"]["dia_launches"],
                             "curve_precond_build": cres["gradients"]["trained"]["pivchol"][
                                 "build_launches"]["dia_launches"]},
        "max_abs_err": k4["dia_matvec_call"]["max_abs_err"],
        "max_rel_err": k4["dia_matvec_call"]["max_rel_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
        "band": "float32",
        "template": k4["template"],
        "device_ms": k4["device_ms"],
        "library_device_ms": k4["library_device_ms"],
        "shape": [dlayout.num_padded, dlayout.num_offsets, 128],
        "other_shapes": [
            {k: r[k] for k in ("batch", "template", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_device_ms")}
            | {"max_rel_err": r["dia_matvec_call"]["max_rel_err"]}
            | {k: r[k] for k in ("host_us",) if k in r}
            for r in main_dia if r is not k4
        ],
    }, {
        "name": "dia_band_grad",
        "route": "cuda",
        "source": "manifold_gp_torch/csrc/dia_band_grad.cu",
        "replaces": "none: the band cotangent the JAX package leaves to XLA",
        "launches": curve_counts["band_grad_launches"],
        "launches_by_path": {"curve_train": curve_counts["band_grad_launches"]},
        **{k: k5[k] for k in ("max_rel_err", "plain_max_rel_err", "ms", "device_ms",
                              "plain_ms", "bound_ms", "bound_by", "band", "template")},
        "shape": [k5["num_padded"], k5["num_offsets"], 128],
        "other_shapes": [
            {k: r[k] for k in ("num_offsets", "batch", "template", "ms", "device_ms", "plain_ms",
                               "bound_ms", "bound_by", "max_rel_err", "plain_max_rel_err")}
            for r in band_grad if r is not k5
        ],
    }]
    report["kernels"] = kernels
    phase(None)
    report["phase_seconds"] = dict(PHASE_SECONDS)
    print("phase seconds: " + ", ".join(f"{name[6:]} {secs:.1f}"
                                        for name, secs in PHASE_SECONDS.items()))
    report["total_s"] = time.perf_counter() - t_start
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s; details in {OUT.relative_to(ROOT)}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
