#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every kernel
on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and the script exits non-zero):

1. Build every CUDA kernel from ``fedml_tpu_torch/ops/csrc`` with nvcc, one
   process per source, all started together.
2. Hold K1 (BN forward) and K2 (BN backward) against their plain versions
   on the card: ResNet-56's BN shapes at batch 64, unpacked and folded over
   the packed schedule's two lanes ([rows, 2*C]), a ragged row count,
   scalar-load channel counts (C = 7, 300) and shapes past the kernels'
   on-chip capacity (planned C = 64, C = 16, then C = 64 again, and 10^6
   rows), and deeplab_lite's unpacked C = 128 and unet's four widths at
   phase 16's batch ([1024, 128]; [16384, 16], [4096, 32], [1024, 64],
   [256, 128]); K2 also at one row and fewer rows than the card holds blocks; f32
   and bf16, ReLU on and off, both bit-identical over two calls; then a
   small CifarResNet forward and backward through the kernels against the
   same model on the CPU, and two steps of ResNet-56 through them at batch
   512.
3. Time each kernel at the main path's shapes with CUDA events, beside its
   plain version, ``F.batch_norm`` (+ReLU) as a library yardstick, and its
   byte/operation bound: the unpacked shapes, then the folded ones.
4. Train 2 rounds of FedAvg (ResNet-56, ``bn_impl="pallas"``, bf16, 32
   non-IID synthetic CIFAR-10-shaped clients, 8 per round, batch 64, lr 0.1,
   momentum 0.9), evaluate, and check the loss and the kernel launch counts.
4b. The same 2 rounds under the packing schedule of ``bench.py``'s flagship
   (``pack_lanes=2``, ``packed_conv="off"``): the cohort in two lanes folded
   into the channel axis, 57 K1 and 57 K2 per executed packed step, none in
   ``evaluate_global``; then a small f32 packed round on the card against the
   same round unpacked; one bf16 packed step of ResNet-56 at batch 64 against
   the two lanes' plain bf16 and f32 steps (logits, gradients, BN statistics);
   a control (round 0 unpacked and packed with the plain BN, a change of
   summation order only); the grouped conv timed against two ungrouped
   convs and one lane's, and one 3x3 conv a stage of L = 2, 4, 8 lanes
   under the grouped and the blockdiag lowering (and blockdiag's patch
   gather and scatter alone) beside their useful and streamed bounds; and
   a profile of 5 packed steps.
4c. The zoo on the same federation and widths: 2 packed rounds of FedOpt
   with server adam (server_lr 0.01; bench.py's adaptive arm), one packed
   round each of FedProx (mu 0.01), FedNova (momentum 0.9) and FedAGC
   (clipping 1e-2), one plain round of FedAvg with client adam (amsgrad, lr
   1e-3): finite losses, 57 K1 + 57 K2 per executed packed or live step,
   FedOpt's server state on the card and nonzero, small f32 FedOpt-adam and
   client-adam rounds packed against unpacked, the server step's time, a
   profile of 5 packed FedOpt steps and one of 5 client-adam steps.
4f. The joint packed lowerings (``packed_conv``), the counterpart of
   ``bench.py``'s packed-conv A/B (``_bench_packed_conv_ab``), on phase 4b's
   federation and model: off, grouped and blockdiag at 2 lanes, FedOpt-adam
   (server lr 0.01) under off and blockdiag, off and blockdiag at 4 and 8
   lanes. Each arm: 2 warm rounds, then the same 2 rounds timed, ending in a
   sync: real images/s, rounds/s, the speed-up over off, executed packed
   steps a round, 57 K1 + 57 K2 and one replay an executed step, a 5-step
   profile (device ms a step, busy share, the conv/GEMM, im2col and copy
   families), useful and streamed conv FLOPs a step, peak memory. Gates:
   round 0 under grouped equal to off bit for bit (cuDNN's deterministic
   algorithms); an f32 blockdiag round of a small CifarResNet within the
   end-to-end bound of its off round; the f32 blockdiag packed mesh round
   within 1e-5 (relative norm) of the blockdiag simulation round. It runs
   after phase 4c, before 4d and 4e.
4d. The cross-silo paradigm (``CrossSiloFedAvgAPI``, one rank) in
   ``bench.py``'s cross-silo configuration: the 32 flagship silos, every
   one every round, data resident; arms (a) the packed mesh (2 lanes), (b)
   the grouped schedule (``bucket_groups=6``), (c) resident-sharded, (d)
   FedOpt with server adam on (a), (e) (a) at 8 and 16 silos and the fit
   T(c) = a + b*c. Each: a warm-up round, then 2 timed rounds (1 for (d))
   ending in a sync, real and padded images/s, 57 K1 + 57 K2 and one
   replay per executed step, finite losses, a 5-step profile; FedOpt's
   server state on the card and nonzero; a small f32 packed and resident
   mesh round against the simulation round (relative norm 1e-5); one
   packed mesh round at 8 silos under a world-size-1 NCCL process group
   (``file://`` store in a temporary directory) bit-identical to the
   group-less round, its all-reduce profiled and timed.
4e. The cross-device paradigm. (a) The flagship's host round
   (``device_data="off"``) streamed in chunks of 4 clients (2 a round),
   packed in 2 lanes, bf16 through K1/K2: the pipeline off, at depth 2, and
   at depth 2 under the speed policy with the population's count prior
   (its cohorts equal to the CPU ``plan_cohort``'s); a warm-up round, then
   2 timed rounds ending in a sync; rounds/s, real images/s, the stage rows,
   ``stream_stats``; 57 K1 + 57 K2 and one replay a packed step; the
   pipelined rounds bit-identical to the serial ones. Then f32 ResNet-56 on
   6 small clients: the unchunked streamed round equal to the batch host
   round bit for bit, chunked against unchunked within rtol 1e-6 / atol
   1e-7 (plain) and 1e-5 / 1e-6 (packed), and chunks of 4 and 1 clients
   (a capture mid-round under a running prefetcher) pipelined equal to
   serial. (b) bench.py's r05 basis row: ``lr`` on the 342,477-client
   stackoverflow LR task, 50 a round, bf16, the pipeline off against depth
   2 (3 warm-up rounds, prime, 3 timed). (c) bench.py's fedsched arms on a
   million clients: 50 a round batched, 1,000 a round streamed in chunks of
   250 at 4 lanes, uniform and speed. (b) and (c) run no TPU kernel. The
   phase runs after phase 12 (see ``main``).
5. Hold K3 (lanes 3x3 conv, also the dgrad), K4 (its wgrad) and K7 (K3's
   probe variants) against their plain versions at the lanes path's conv
   shapes at batch 64, 1 and 3 and five ragged shapes (the last takes the
   CUDA-core K3 in bf16: its tensor-core stage does not fit), f32 and bf16, K3,
   K4 and K7's kernel mode bit-identical over two calls and K7's kernel mode
   equal to K3, its patches and copy modes exact; then a small lanes
   CifarResNet on the card against the same model on the CPU.
6. Time K3 and K4 at those shapes in bf16 beside their plain versions,
   ``F.conv2d`` / ``torch.nn.grad.conv2d_weight`` and their bounds.
7. The K7 probe (the counterpart of ``tools/lanes_probe.py``): per-call
   times of the library conv, K3, its patch build, one copy, K4, forward +
   dgrad and forward + wgrad at the probe shapes, and K3's device time split
   into the mma loop with its W2 staging (kernel - copy), the tap gather
   (patches - copy) and staging plus copy-out (copy), each mode beside its
   bound.
8. Train the same 2 rounds with ``conv_impl="lanes", bn_impl="xla"`` and
   check the loss and the launch counts (72 K3 and 36 K4 per live step, 36
   K3 per eval batch, no BN kernel).

9. Hold K6 (flash attention) and K5 (fused cross-entropy) against their
   plain versions: K6 at path (B)'s and path (A)'s shapes, causal and not,
   a shifted query window, ragged T at each head dim, 4 merged K/V chunks
   with a fully future one, f32 and bf16, and in bf16 every Tq, Tk at the
   tensor-core kernel's tile edges (63, 64, 65, 129) and the diagonal
   mid-tile, each bf16 case bit-identical over two calls; K5 at 16384 x 10004, vocab 90,
   1003 and a ragged N, f32 and bf16 logits, int32 and int64 labels; then
   a small TransformerLM through both on the card against the CPU.
10. Time K6 and K5 at path (B)'s shapes beside their plain versions,
   ``F.scaled_dot_product_attention`` / ``F.cross_entropy`` and bounds
   (K6's: the largest of its bytes, its tensor-core FLOPs and one
   exponential per live score at 16 per clock per SM and the card's
   ``nvidia-smi clocks.max.sm``); device time both from the profiler and
   from CUDA events behind a primed queue (``queued_device_ms``).
11. Path (A): 2 FedAvg rounds of ``transformer`` (dim 256, 8 heads, 4
   layers, bf16) on the synthetic fed_shakespeare federation (100 clients,
   10 a round, batch 4, sequences of 80); 4 K6 per live step and per eval
   batch, no other kernel.
12. Path (B): 5 steps of the one-card LM step (``transformer_nwp``
   widths, vocab 10004, T = 8192, batch 2, bf16, remat, SGD lr 0.1) on one
   fixed batch; 8 K6 and 1 K5 per step, the loss falls; tokens/s, ms/step
   and peak memory.

13. The entry point and the training loop, after phase 4e, with no profile.
   (a) The README quickstart through ``experiments.run.main`` on the card
   (``lr`` on ``synthetic_1_1``, 30 clients, 10 a round, 50 rounds, batch 10,
   lr 0.3): its final Test/Acc, rounds/s and phase times; then the same line
   as FedOpt-adam (server lr 0.01) for 4 rounds with checkpoints every 2
   rounds, straight, and stopped at round 2 and resumed from its
   ``latest.ckpt``: the two final checkpoints (variables and server state)
   equal bit for bit. (b) The launcher at the flagship's widths (ResNet-56,
   32 clients, 8 a round, batch 64, lr 0.1, momentum 0.9, 3 rounds) on the
   CIFAR-10 stand-in through the launcher's bundle (plain BN, f32: no K1/K2
   launch): real images/s, Test/Acc per round, the checkpoint's bytes. (c)
   The flagship's packed bf16 ``train()`` through K1/K2 (phase 4b's
   federation and model, ``frequency_of_the_test=2``, checkpoints every 2
   rounds): 4 rounds straight twice, then 2 rounds and 2 more from
   ``resume_from``; the resumed variables equal the straight ones bit for
   bit wherever the two straight runs agree (when they part, all four runs
   again under cuDNN's deterministic algorithms, and then they must agree),
   the eval rounds equal, 57 K1 + 57 K2 and one replay an executed packed
   step; save and restore ms, the checkpoint's bytes, ``history["timing"]``.
14. Robust aggregation, hierarchical FL and the silo harness, after phase
   13, with no profile, on the flagship (ResNet-56, ``bn_impl="pallas"``,
   bf16, batch 64, 2 rounds an arm): FedAvg packed in 2 lanes (the
   yardstick); FedAvg-robust (attacker 0 poisons half its records, the
   clip at ``ROBUST_NORM_BOUND``, DP noise 1e-3) plain and packed, each
   client's update norm before the clip and each aggregate's noise
   recorded; hierarchical FL at G = 2 with 2 group rounds (the host round)
   and the one-rank mesh at G = 1; SiloFedAvg on 8 silos (packed, 3
   rounds, patience 2, per-client exit, checkpoints). Gates: 57 K1 + 57 K2
   and one replay an executed step (every group round's), none in any
   evaluation; finite losses; the bound binds on at least half of round
   0's clients; each round's noise over the ~0.86 M weight floats within
   5 sigma/sqrt(n) of mean 0 and 2% of its standard deviation, the BN
   statistics bit-equal to the noise-free aggregate; the restored
   ``model_best.ckpt`` bit-equal to the variables it saved; and in f32 on a
   small CifarResNet through K1/K2, sharing the server generator, the
   packed robust round within rtol 1e-4 / atol 1e-5 of the plain one, the
   one-rank robust and hierarchical meshes within 1e-5 (relative norm) of
   their simulations, and one group round within the end-to-end bound of
   FedAvg. Real images/s of each arm.
15. Decentralized FL, streaming FedAvg and TurboAggregate, after phase 14,
   with no profile, on the flagship (ResNet-56, ``bn_impl="pallas"``, bf16,
   batch 64, 2 rounds an arm, the first with its capture): (a) DSGD on 16
   nodes (the flagship's recipe at 16 clients, the symmetric topology at
   ``neighbor_num=2``), (b) PushSum on them, (c) the DSGD mesh on one rank
   without a process group; (d) ``StreamingFedAvgAPI`` on the 32-client
   flagship, 8 a round, ``stream_aggregate="off"`` at pipeline depth 0,
   (e) ``"deterministic"`` at depth 2; (f) ``TurboAggregateAPI`` on it.
   Gates: 57 K1 + 57 K2 and one replay a live step, none in any
   evaluation; finite losses; PushSum's mass N (rtol 1e-5) every round; the
   native host batcher available and its batches equal to its Python
   form's; and in f32 on a small CifarResNet through K1/K2 (cuDNN's
   deterministic algorithms): the one-rank mesh round equal to the
   simulator's bit for bit (DSGD, PushSum), the streamed round equal to
   FedAvg's host round bit for bit, ``deterministic`` within rtol 1e-6 /
   atol 1e-7 of ``off``, TurboAggregate within 1e-4 of the plain weighted
   mean. Real images/s and steps a round of each arm, the mix's ms (CUDA
   events), the host MPC's ms a round and its largest |x * w| beside the
   field's ~1024, the streamed arms' ``stream_stats``.

16. FedGKT and FedSeg, after phase 15, bf16 through K1/K2, each arm's
   figures from 2 warm rounds (after one round with its captures) ending in
   a sync: (a) FedGKT on the flagship's federation (32 clients, every one
   every round), resnet8 / resnet56_server at full depth, epochs 1 and
   epochs_server 1, nesterov SGD at lr 0.1, batch 64: real images/s, the
   client and server phase ms, steps a round, n_pad, the union feature
   tensor's bytes, peak memory, Test/Acc and the losses; 7 K1 + 7 K2 a
   client step and 38 a server step (counted from the pair's modules first),
   one replay a step, none in the extraction, logits and evaluation passes;
   one client and one server step captured against eager; a 5-step profile
   of the server step. (b) FedSeg of ``deeplab_lite`` (width 32, 2 blocks a
   stage) on the synthetic blob task (16 clients x 128 records, 32 x 32, 4
   classes), 8 a round, batch 16: 16 K1 + 16 K2 and one replay a step;
   real images/s, mIoU, FWIoU, the confusion total. (c) ``unet`` on the
   same federation: 14 a step. (d) In f32: a one-rank NCCL
   ``CrossSiloFedSegAPI`` round within 1e-5 (relative norm) of the
   ``FedSegAPI`` round, and a CI-depth GKT round (lr 0.01) through K1/K2
   against the plain BN's within ``GKT_BN_GATE`` (client features, server
   logits).
17. FedNAS, SplitNN and VFL, after phase 16. (a) The DARTS search at the
   launcher's full width (channels 16, 8 layers, 4 steps, multiplier 4:
   929 BatchNorms a forward, all through K1/K2 with ReLU off), f32, on 2
   CIFAR-10-shaped clients of 2 batches of 64, both every round,
   lr 0.025; first-order, then unrolled (the exact second-order
   architect, through the BN wrapper's differentiable backward): round 0
   with its capture, then 2 timed rounds (1 unrolled) ending in a sync;
   real images/s, ``FEDNAS_LAUNCHES`` K1 + K2 and one replay a step, none in
   the evaluation; peak memory; a one-step profile (first-order) or a replay's
   CUDA-event time (unrolled). (a) and (b) run cuDNN's deterministic
   algorithms. (b) In f32, on the full width at 3 layers
   (``FEDNAS_GATE_SIZE``): one step of each architect captured against eager;
   one search step of each architect through K1/K2 against the
   plain BN (the alpha gradient, the weights and BN statistics, the
   alphas, each within its ``FEDNAS_*_GATE``; a second plain BN's distance,
   the TPU kernel's one-pass variance in plain PyTorch, reported beside it);
   a one-rank NCCL
   ``CrossSiloFedNASAPI`` round within 1e-5 of ``FedNASAPI``'s; K1/K2 at
   ``DARTS_BN_SHAPES`` against their plain versions and, twice
   differentiated, against the plain BN's second derivative
   (``SECOND_ORDER_GATE``). (c) A SplitNN ring (split CNN, 2 clients) and a
   VFL fit (the lending_club stand-in) on the card, with the one-rank
   party-sharded VFL step against the fused one within 1e-5.

18. The BN zoo, dropout and the FedML baselines, after phase 17. (a) bf16
   through K1/K2 on CIFAR-10-shaped non-IID synthetic clients (4 of 2
   batches of 64, all every round, lr 0.1, momentum 0.9): ``mobilenet``,
   ``mobilenet_v3`` (small), ``vgg16``, ``efficientnet-b0`` and
   ``resnet56_w128`` each round 0 with its capture, then 2 timed rounds
   ending in a sync: real images/s, ``ZOO_BNS`` K1 + K2 and one replay a
   step, none in the evaluation, peak memory, a one-step profile (busy
   share, K1 + K2 ms); every other ``ZOO_BNS`` name (``efficientnet-b7``:
   K1/K2 at C = 3840) one captured step, its launches and a finite loss.
   (b) In f32: K1/K2 against their plain versions at C = 1152 .. 3840
   (``WIDE_BN_SHAPES``, and ``WIDE_REREAD_SHAPES`` past the on-chip rows)
   and at every [rows, C] of the zoo's K1 calls at batch 64 (recorded in
   (a); the timed arms' equal ``ZOO_BN_SHAPES``), f32 and bf16, ReLU on and
   off, bit-identical over two calls; the gradients and BN statistics'
   update of one batch of ``ZOO_STEP_NAMES`` through K1/K2 against the
   plain BN's within ``ZOO_GRAD_GATE``, which the bf16-rounded plain BN
   must exceed (the plain BN again and the one-pass one beside); captured = eager
   with dropout on (``cnn_dropout``, ``efficientnet-b0``) over 3 replays
   under 3 keys, the replayed masks equal to the eager ones and different
   from each other; the packed ``cnn_dropout`` round (2 lanes, off and
   blockdiag) lane by lane against its clients' plain training within
   ``DROPOUT_PACKED_TOL``. (c) FedML's baselines a round each
   (``BASELINES``): ``resnet18_gn`` on fed_cifar100, ``rnn`` on
   shakespeare, ``rnn_stackoverflow`` on stackoverflow_nwp, ``lr`` on
   stackoverflow_lr and ``cnn_dropout`` on femnist packed in 2 lanes.
19. The mesh axes beyond clients, after phase 18. (a) Path (B)'s q/k/v
   (T = 8192) through ring attention of 4 virtual ranks on one card
   (``ring_attention``'s ``hop`` seam, Tl = 2048): 16 K6 a forward, bf16
   against dense K6 at ``RING_TOL``, f32 output and q/k/v gradients against
   the plain ring's, the ring's time beside dense K6's; Ulysses' layout of
   4 virtual ranks (the all-to-all done by hand on the card, K6 on H/4
   heads of the whole sequence, the inverse reshard) against dense K6. Then under a world-size-1 NCCL group:
   (b) the sp, tp and pp builders and (c) ``MoeTransformerLM`` (4 experts,
   top-2) on a one-rank ep mesh, each at ``transformer_nwp``'s widths, T =
   8192, batch 2, bf16: 5 steps with a falling loss, ``MESH_K6`` K6 and 1 K5
   a step, ms/step, tokens/s, peak memory, device ms by family of one
   profiled step, and each builder's f32 step at T = 512 within
   ``MESH_GATE`` of the single-device step; (d) the streaming centralized
   trainer on a one-rank batch mesh, bf16 ResNet-56 through K1/K2 (57 a
   step), and in f32 under cuDNN's deterministic algorithms that trainer and
   a FedGKT round with ``server_mesh`` within ``MESH_GATE`` of their
   mesh-less runs.
20. The FedAvg edge runtime (``distributed/fedavg_edge.py``), after phase
   19, its ranks built through ``build_edge_rank(..., bundle=)`` and
   ``comm.local.run_ranks``; every live step a replay of the workers'
   shared captured step. (a) f32 ResNet-56 through K1/K2 under cuDNN's
   deterministic algorithms in JAX's equivalence set-up (``EDGE_GATE``: 8
   clients x 128 records, batch 128, 4 workers of one client, 2 rounds):
   the edge over the local transport with the wire round trip against the
   port's FedAvgAPI on the same bundle given the edge's orders within
   ``EDGE_TOL`` (the distance with the simulation's own orders printed
   beside), the same federation over the in-repo MQTT broker on loopback
   bit for bit, and the streaming aggregator on round 0's uploads (arrival
   orders bit for bit, the batch mean within ``EDGE_STREAM_TOL``). (b) The bf16
   flagship federation (32 x 1562 records, 8 workers of one client, batch
   64): FedAvgAPI, then the edge over the local transport (raw; q8 both
   ways) and over MQTT, 1 warm and 2 timed rounds each: real
   images/s, K1/K2 a round (57 x its live steps, exactly), encode / decode
   ms and bytes a round, and the device-span share (CUDA events around each
   worker's training over the round's wall). gRPC is not attempted on the
   card.

Every live step of phases 4, 4b, 4c, 4f, 4d, 4e, 8, 11, 13, 14, 15, 16, 17 and 18 is a replay of the step
captured as one CUDA graph (``parallel/capture.py``): each round checks one
replay a live (or executed packed) step and the kernels' launch counts, to
which a replay adds the launches its capture recorded. Each of those phases
but 4f, 4d, 4e, 13, 14, 15, 16, 17 and 18 (in 4c the FedOpt-adam packed run and the client-adam plain
run; 4d's and 4f's arms take their steps from the same trainers; 4e's are neither
re-run eagerly nor profiled) then runs
one client's first 12 live steps (or one packed cohort) through the eager
step (``capture=False``) twice and captured once: when the eager runs
repeat bit for bit, the captured run must too, else it may be no farther
from the first eager run than the second is, and the tensors one eager
step already changes name the op. Then 5 steps of each arm are profiled
(wall and device ms per step, busy share, GPU activities, the host's
launch calls, K1 and K2 by name: 57 a step on the BN paths), the captured
graph's kernel nodes are read through libcuda's graph API (57 K1 + 57 K2
nodes, all cooperative, on the BN paths; 72 K3 and 36 cooperative K4 on
the lanes path; 4 K6 on path (A)), and the grid-barrier words of each
capturing stream must be back at zero. Phases 4 and 4b also run their
rounds again from the same weights through the eager step, for real
images/s both ways. Phase 12 profiles one more (eager) step.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
``results/chip_smoke.json``. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
SEED = 0
EPS = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores (the work of K1/K2 is elementwise f32) and bf16
# FLOP/s on the tensor cores (the least time of a bf16 conv, K3/K4).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# exponentials per clock per SM on the special-function units (K6's third
# bound: one exp per live score)
EXP_PER_CLOCK_PER_SM = 16

# ResNet-56 train-mode BNs per local step at batch 64, by (rows, C, relu):
# stage 1 (32x32x16): stem + 9 first-of-block BNs with ReLU, 9 without;
# stages 2 and 3: 9 with ReLU, 9 second-of-block + 1 projection without.
MAIN_PATH_BNS = {
    (65536, 16, True): 10, (65536, 16, False): 9,
    (16384, 32, True): 9, (16384, 32, False): 10,
    (4096, 64, True): 9, (4096, 64, False): 10,
}
BNS_PER_STEP = sum(MAIN_PATH_BNS.values())      # 57
# the packed flagship (pack_lanes=2): the same BNs, each over both lanes'
# channels, [rows, 2*C]; phase 4f also packs 4 and 8 lanes, [rows, L*C]
PACK_LANES = 2
PACKED_CONV_LANES = (2, 4, 8)
PACKED_BNS_BY_LANES = {L: {(n, L * C, relu): k for (n, C, relu), k in MAIN_PATH_BNS.items()}
                       for L in PACKED_CONV_LANES}
PACKED_BNS = PACKED_BNS_BY_LANES[PACK_LANES]
FOLDED_SHAPES = sorted({(n, C) for bns in PACKED_BNS_BY_LANES.values() for n, C, _ in bns},
                       reverse=True)
# K1 and K2 checks: the path's shapes and a ragged row count; C = 7 and C =
# 300 (scalar loads; two columns a thread at 300 in bf16); shapes past the
# on-chip capacity, whose second pass reads rows again from device memory.
# K2 alone also at one row, 37 rows and fewer rows than the card holds
# blocks: K1, as the TPU kernel, takes var = E[x^2] - mean^2, which at a row
# or two misses the plain two-pass variance by more than its tolerance, so
# it is checked at >= 256 rows (unet's bottleneck).
CHECK_SHAPES = [(65536, 16), (16384, 32), (4096, 64), *FOLDED_SHAPES,
                (1024, 128),   # deeplab_lite's stage 3 and ASPP at phase 16's batch 16
                # unet at phase 16's batch 16 (f32 there: flax promotes its convs)
                (16384, 16), (4096, 32), (1024, 64), (256, 128),
                (12347, 24)]   # last: ragged
SCALAR_SHAPES = [(8_191, 7), (4_096, 300)]
REREAD_SHAPE = (1_000_000, 16)
# A plan sets its kernel's shared-memory limit, and a plan past its on-chip
# rows asks for more at C = 64 than at C = 16: a C = 64 plan, a new C = 16
# plan, then the C = 64 shape again, which must still launch.
K2_PLAN_ORDER = [(100_003, 64), (200_003, 16), (100_003, 64)]
# past the rows a block keeps on chip: K2 (x and g on chip) at all of
# these, K1 (x alone, twice the rows) at 10^6 x 16 and 100,003 x 64
REREAD_SHAPES = {REREAD_SHAPE, *K2_PLAN_ORDER}
K1_REREAD_SHAPES = {REREAD_SHAPE, K2_PLAN_ORDER[0]}
K1_SHAPES = [*CHECK_SHAPES, *SCALAR_SHAPES, *K2_PLAN_ORDER, REREAD_SHAPE]
BN_CHECK_SHAPES = [*CHECK_SHAPES, (1, 16), (200, 64), (1000, 300), (37, 7), *SCALAR_SHAPES,
                   *K2_PLAN_ORDER, REREAD_SHAPE]
# Phase 18: K1/K2 past C = 1024 (EfficientNet's widths: b0's 1152 and
# 1280, b2's 2112, b7's 2560 and 3840) at the zoo's row counts (batch 64 at
# 1x1, 4 at 2x2), and two shapes past the on-chip rows at C > 1024
WIDE_BN_SHAPES = [(64, 1152), (256, 1152), (64, 1280), (64, 2112), (64, 2560), (64, 3840)]
WIDE_REREAD_SHAPES = [(8192, 2112), (2048, 3840)]
# ResNet-56 on the BN kernels at this batch: its C = 32 and C = 16 layers
# keep a block's full budget of rows on chip, at two sizes of shared memory
BN_BIG_BATCH = 512

# ResNet-56 lanes (conv_impl="lanes") K3 calls per local step at batch 64,
# by (Ci, Co, H, W): stage 1's 18 convs forward and as dgrad; stage 2
# block 0's 16->32 conv at 32x32 (before the subsample) and its dgrad
# 32->16; stage 2's 17 other convs at 16x16 forward and as dgrad.
CONV_CALLS = {(16, 16, 32, 32): 36, (16, 32, 32, 32): 1, (32, 16, 32, 32): 1,
              (32, 32, 16, 16): 34}
WGRAD_CALLS = {(16, 16, 32, 32): 18, (16, 32, 32, 32): 1, (32, 32, 16, 16): 17}
CONV_PER_STEP = sum(CONV_CALLS.values())       # 72
WGRAD_PER_STEP = sum(WGRAD_CALLS.values())     # 36
CONV_BATCH = 64
# ragged (N, Ci, Co, H, W): one row tile; several with a partial last one;
# rows wider than a block's 256 threads; 3 channels on rows so wide that the
# bf16 K3's tensor-core stage (Ci padded to 16) does not fit even at one row,
# so that it runs the CUDA-core kernel
CONV_RAGGED = [(3, 12, 20, 10, 14), (3, 20, 12, 10, 14), (3, 20, 12, 37, 13), (1, 8, 8, 3, 300),
               (1, 3, 8, 2, 1200)]
PROBE_SHAPES = [(16, 16, 32, 32), (32, 32, 16, 16)]
EVAL_BATCH = 256      # make_eval_fn's default batch

# The transformer LM paths. (B): q, k, v [B, H, T, D] of the one-card LM
# step (transformer_nwp widths: 8 heads of 32; T = 8192, batch 2) and its
# K5 rows (B*T of vocab 10004); with remat each of the 4 blocks runs K6
# twice per step. (A): FedAvg of `transformer` at batch 4, sequences of 80.
LM_BATCH, LM_SEQ = 2, 8192
ATTN_B = (LM_BATCH, 8, LM_SEQ, LM_SEQ, 32)
ATTN_A = (4, 8, 80, 80, 32)
XENT_B = (LM_BATCH * LM_SEQ, 10004)
LM_K6_PER_STEP = 8

# K3 (and K7 "kernel") against its plain version: f32, the sum over 9*Ci
# terms runs in another order (up to ~1e-6 at |y| ~ 2); bf16 outputs: both
# round an f32 value that differs in its last bits, so one bf16 ulp may
# flip. K4 sums N*H*W products per entry in another order: relative 1e-4
# of the largest entry. K7 "patches" and "copy" move values and are exact.
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
WGRAD_RTOL = 1e-4

# Tolerances of the kernel-vs-plain comparison. f32: the kernel sums in a
# different order (per-thread f32, f64 combination, E[x^2] - mean^2) than
# the plain two-pass version. bf16 outputs: both round an f32 value that
# differs in its last bits, so one bf16 ulp (2^-7 relative) may flip.
TOL = {
    "float32": {"y": (1e-5, 1e-4), "stat": (1e-4, 1e-5), "dx": (1e-4, 1e-4), "dgb": (1e-4, 1e-3)},
    "bfloat16": {"y": (1e-2, 1e-2), "stat": (1e-4, 1e-5), "dx": (1e-2, 1e-2), "dgb": (1e-4, 1e-3)},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def assert_close(name, got, want, rtol, atol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside rtol={rtol} "
            f"atol={atol}; first at {i}: got {got.flatten()[i].item()}, "
            f"want {want.flatten()[i].item()}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    return float(err.max())


def _same_bits(name, first, second) -> None:
    """Two calls of a deterministic kernel on the same inputs must agree
    bit for bit (a tensor or a tuple of tensors)."""
    import torch

    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(firsts, seconds)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def cuda_time_ms(fn, iters: int = 40, repeats: int = 5, warmup: int = 5) -> float:
    """Median over ``repeats`` of the mean ms per call over ``iters``
    back-to-back calls, by CUDA events: what a caller waits per call,
    host launch cost included where it exceeds the device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


# torch.profiler loses the first device records of a window, in two ways
# (on the H100): now and then whatever ran in the first milliseconds of
# the window, and late in a long process the first few records of every
# window, whatever idle, sync or spin came first. So a window opens
# with ``SENTINELS`` short spins (``torch.cuda._sleep`` of
# ``SENTINEL_CYCLES``) and ``PROFILE_PAD_S`` of idle before the work; no
# count includes the sentinels, and a window whose work still lost records
# is profiled again, at most ``PROFILE_ATTEMPTS`` times
# (tools/torch_profile_window.py counts lost windows, plain and as here).
# Late windows have lost their first 17 records every time (after phase 4e,
# and with phase 4f's windows before phase 4d's NCCL window), so 32, and a
# window profiled again doubles them.
SENTINELS = 32
SENTINEL_CYCLES = 2_000
PROFILE_PAD_S = 0.01
PROFILE_ATTEMPTS = 5
# the host calls whose every launch makes at least one device record
KERNEL_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch)")
# profile windows opened, sentinel records lost in them (all, and the most
# in one window), and windows whose work lost records and were profiled
# again
PROFILE_TALLY = {"windows": 0, "sentinel_records_lost": 0, "most_sentinel_records_lost": 0,
                 "profiled_again": 0}


def _launches(events) -> list:
    """The kernel and graph launch calls among a profile's ``events``, in
    the order the host made them."""
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CPU
                   and KERNEL_LAUNCH.match(e.name)), key=lambda e: e.time_range.start)


def lost_device_records(events) -> int:
    """Kernel and graph launches in a profile's ``events`` that left no
    device record: the device records of a launch carry its correlation id."""
    from torch.autograd import DeviceType

    recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
    return sum(e.id not in recorded for e in _launches(events))


def profile_window(fn, sentinels: int = SENTINELS, pad_s: float = PROFILE_PAD_S) -> tuple:
    """``fn()`` under torch.profiler (host and CUDA activity), in a window
    that opens after a sync with ``sentinels`` sentinel launches, a sync
    and ``pad_s`` of idle, and ends with a sync. Returns ``(profile,
    events, sentinel records lost)``: ``events`` are the profile's without
    the sentinels' launches and records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(sentinels):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    if not sentinels:
        return prof, events, 0
    ids = {e.id for e in _launches(events)[:sentinels]}
    dropped = [e for e in events if e.id in ids and (e.device_type == DeviceType.CUDA
                                                     or KERNEL_LAUNCH.match(e.name))]
    recorded = [e for e in dropped if e.device_type == DeviceType.CUDA]
    if any("spin" not in e.name for e in recorded):
        raise AssertionError("the profile window's first launches are not all its sentinels: "
                             f"{sorted({e.name for e in recorded})}")
    keep = {id(e) for e in dropped}
    return prof, [e for e in events if id(e) not in keep], sentinels - len(recorded)


def profiled(fn, what: str) -> tuple:
    """``fn()`` in a ``profile_window``. A window whose work lost device
    records (``lost_device_records``) is profiled again, behind twice the
    sentinels; after
    ``PROFILE_ATTEMPTS`` such windows this raises. Returns ``(profile,
    events)`` as ``profile_window`` does."""
    for attempt in range(PROFILE_ATTEMPTS):
        # each window again opens behind twice the sentinels of the last
        sentinels = SENTINELS * 2 ** attempt
        prof, events, sentinel_lost = profile_window(fn, sentinels)
        PROFILE_TALLY["windows"] += 1
        PROFILE_TALLY["sentinel_records_lost"] += sentinel_lost
        PROFILE_TALLY["most_sentinel_records_lost"] = max(
            PROFILE_TALLY["most_sentinel_records_lost"], sentinel_lost)
        lost = lost_device_records(events)
        if not lost:
            return prof, events
        PROFILE_TALLY["profiled_again"] += 1
        from torch.autograd import DeviceType
        launches = _launches(events)
        recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
        t0 = launches[0].time_range.start
        detail = [(i, e.name, e.time_range.start - t0) for i, e in enumerate(launches)
                  if e.id not in recorded][:8]
        log(f"[profile] {what}: {sentinel_lost} of {sentinels} sentinel records lost, and "
            f"{lost} launches' device records of the work (index, call, us after its first "
            f"launch): {detail} of {len(launches)} launches; profiling again")
    raise AssertionError(f"{what}: the profiler lost device records in {PROFILE_ATTEMPTS} "
                         "windows")


def device_ms(fn, iters: int = 20):
    """Device time per call: the summed durations of every GPU kernel and
    copy the profiler traces over ``iters`` calls (no host time), from a
    window that lost no device record (``profiled``). None when every
    window lost records, or when the calls launched nothing."""
    from torch.autograd import DeviceType

    fn()

    def calls():
        for _ in range(iters):
            fn()

    try:
        _, events = profiled(calls, "device_ms")
    except AssertionError:
        return None
    total_us = sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


def queued_device_ms(fn, sm_clock_mhz: float, iters: int = 10, repeats: int = 3) -> float:
    """Device time per call without the profiler: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues
    ``iters`` calls between two CUDA events, so the events time the calls
    back to back with no host gap. The spin lasts 3x the host's enqueue
    time of those calls (at least 20 ms); a host that outran it raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = max(3 * host_s, 0.02)
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * sm_clock_mhz * 1e6))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s >= spin_s:
            raise AssertionError(f"queued timing: the host took {enqueue_s:.4f} s to enqueue, "
                                 f"longer than the {spin_s:.4f} s spin")
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def bn_bound(n: int, C: int, elt: int, relu: bool, backward: bool) -> tuple[float, float]:
    """(bytes, flops) the function must move and do: each input read once,
    each output written once. K1 reads x and writes y (plus gamma, beta in
    and mean, rstd, var out); K2 reads x, dy, y (ReLU mask only) and
    gamma, mean, rstd, and writes dx, dgamma, dbeta."""
    if backward:
        nbytes = (3 + (1 if relu else 0)) * n * C * elt + 6 * C * 4
        flops = 14 * n * C
    else:
        nbytes = 2 * n * C * elt + 5 * C * 4
        flops = 8 * n * C
    return nbytes, flops


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def conv_bound(kind: str, n: int, ci: int, co: int, hw: int, elt: int = 2
               ) -> tuple[float, float]:
    """(bytes, flops) of one call, each input read once and each output
    written once: K3 reads x and W2 and writes y; K4 reads x and dY and
    writes the f32 dW2; K7 "patches" reads the min(Co, Ci) channels its rows
    come from and "copy" its Co channels, and both write [N, Co, HW]."""
    flops = 2 * n * hw * co * 9 * ci
    if kind == "conv_fwd":
        return elt * (n * ci * hw + co * 9 * ci + n * co * hw), flops
    if kind == "conv_wgrad":
        return elt * (n * ci * hw + n * co * hw) + 4 * co * 9 * ci, flops
    return elt * (n * min(co, ci) * hw + n * co * hw), 0


def phase_build():
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    info = build.build()
    total = time.perf_counter() - t0
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {total:.2f} s")
    return {"seconds": total, "per_source": {k: v["seconds"] for k, v in info.items()}}


def check_bn_shape(rng, n: int, C: int, with_k1: bool, k1_reread: bool, k2_reread: bool,
                   err: dict, cases: list, verbose: bool = True) -> None:
    """K1 (when ``with_k1``) and K2 against their plain versions at one [n, C]
    shape, f32 and bf16, ReLU on and off, each bit-identical over two calls;
    ``k1_reread`` / ``k2_reread``: the shape must exceed that kernel's
    on-chip rows. Adds the worst errors to ``err`` and a record a case to
    ``cases``, and logs each case when ``verbose``."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    dev = torch.device("cuda")
    x_np = (rng.normal(size=(n, C)) * 1.5 + 0.3).astype(np.float32)
    dy_np = rng.normal(size=(n, C)).astype(np.float32)
    g = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        x = torch.tensor(x_np, device=dev).to(dtype)
        dy = torch.tensor(dy_np, device=dev).to(dtype)
        for relu in (True, False):
            tag = f"[{n}x{C} {str(dtype).split('.')[1]} relu={relu}]"
            y_p, m_p, r_p, v_p = bn.bn_relu_fwd_plain(x, g, b, EPS, relu)
            e_y = fplan = None
            if with_k1:
                got = bn.bn_fwd_cuda(x, g, b, EPS, relu)
                _same_bits(f"K1 {tag}", got, bn.bn_fwd_cuda(x, g, b, EPS, relu))
                y_k, m_k, r_k, v_k = got
                e_y = assert_close(f"K1 y {tag}", y_k, y_p, *tol["y"])
                assert_close(f"K1 mean {tag}", m_k, m_p, *tol["stat"])
                assert_close(f"K1 var {tag}", v_k, v_p, *tol["stat"])
                assert_close(f"K1 rstd {tag}", r_k, r_p, *tol["stat"])
                if y_k.dtype != x.dtype:
                    raise AssertionError(f"K1 y dtype {y_k.dtype} != {x.dtype}")
                err["bn_fwd"] = max(err["bn_fwd"], e_y)
                fplan = bn.fwd_plan(x)
                if k1_reread and not fplan["rows_per_block"] > fplan["cap"]:
                    raise AssertionError(f"K1 {tag} was meant to exceed the on-chip rows: "
                                         f"{fplan}")
            # K2 on the plain forward's outputs, so only the backward differs
            dx_k, dg_k, db_k = bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, relu)
            _same_bits(f"K2 {tag}", (dx_k, dg_k, db_k),
                       bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, relu))
            dx_p, dg_p, db_p = bn.bn_relu_bwd_plain(x, y_p, dy, g, m_p, r_p, relu)
            e_dx = assert_close(f"K2 dx {tag}", dx_k, dx_p, *tol["dx"])
            e_dg = assert_close(f"K2 dgamma {tag}", dg_k, dg_p, *tol["dgb"])
            e_db = assert_close(f"K2 dbeta {tag}", db_k, db_p, *tol["dgb"])
            err["bn_bwd"] = max(err["bn_bwd"], e_dx)
            plan = bn.bwd_plan(x, relu)
            if k2_reread and not plan["rows_per_block"] > plan["cap"]:
                raise AssertionError(f"K2 {tag} was meant to exceed the on-chip rows: {plan}")
            cases.append({"case": tag, "y": e_y, "dx": e_dx, "dgamma": e_dg, "dbeta": e_db,
                          "k1_plan": fplan, "k2_plan": plan})
            if not verbose:
                continue

            def shown(p):
                return (f"{p['blocks']} blocks x {p['threads']} threads, loads of {p['V']}, "
                        f"{min(p['cap'], p['rows_per_block'])} of {p['rows_per_block']} "
                        f"rows a block on chip")

            k1 = ("K1 not checked" if e_y is None
                  else f"K1 y {e_y:.3g}, repeat bit-identical, {shown(fplan)}")
            log(f"[check] {tag}: max|err| {k1}; K2 dx {e_dx:.3g}, dgamma {e_dg:.3g}, "
                f"dbeta {e_db:.3g}, repeat bit-identical, {shown(plan)}")


def bn_wide_check() -> tuple:
    """Phase 18 (b): K1 and K2 against their plain versions at the channel
    counts past 1024 (``WIDE_BN_SHAPES``, ``WIDE_REREAD_SHAPES``) with phase
    2's tolerances, bit-identical over two calls, each on the kernels' wide
    instantiation where a thread owns more columns than the narrow one holds.
    Returns (worst errors, cases)."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED + 18)
    err = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    cases = []
    for n, C in [*WIDE_BN_SHAPES, *WIDE_REREAD_SHAPES]:
        reread = (n, C) in WIDE_REREAD_SHAPES
        check_bn_shape(rng, n, C, True, reread, reread, err, cases)
    torch.cuda.synchronize()
    wide = sorted({c["case"].split()[0] for c in cases
                   if c["k2_plan"]["cols"] > (4 if c["k2_plan"]["V"] == 1 else 1)})
    log(f"[check] K1/K2 past C = 1024: {len(cases)} cases, worst y {err['bn_fwd']:.3g}, "
        f"dx {err['bn_bwd']:.3g}; wide instantiation at {', '.join(wide)}")
    return err, cases


def phase_check():
    """Each kernel against its plain version on the same card tensors."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    err = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    cases = []
    for n, C in BN_CHECK_SHAPES:
        check_bn_shape(rng, n, C, (n, C) in K1_SHAPES, (n, C) in K1_REREAD_SHAPES,
                       (n, C) in REREAD_SHAPES, err, cases)
    torch.cuda.synchronize()

    # a small CifarResNet through the kernels on the card vs its plain
    # path on the CPU, same weights and inputs (f32, TF32 off)
    from fedml_tpu_torch.models.resnet import CifarResNet

    torch.manual_seed(SEED)
    cpu = CifarResNet(1, 10, widths=(16, 32, 64), bn_impl="pallas")
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = CifarResNet(1, 10, widths=(16, 32, 64), bn_impl="pallas")
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    xs = torch.tensor(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    before = dict(bn.LAUNCHES)
    out_c, out_g = cpu(xs), gpu(xs.to(dev))
    out_c.square().sum().backward()
    out_g.square().sum().backward()
    torch.cuda.synchronize()
    if bn.LAUNCHES["bn_fwd"] - before["bn_fwd"] != 9 or bn.LAUNCHES["bn_bwd"] - before["bn_bwd"] != 9:
        raise AssertionError(f"small model did not run its 9 BNs through the kernels: {bn.LAUNCHES}")
    # relative L2 error per tensor, 1e-3 (with a 1e-4 per-element floor
    # under the norm for tensors near zero): f32 convs on cuDNN and on the
    # CPU sum in other orders, and BN's backward amplifies that noise
    worst = 0.0
    pairs = [("logits", out_g.detach(), out_c.detach())]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    pairs += [(k, v, cpu.get_buffer(k)) for k, v in gpu.named_buffers()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-3:
            raise AssertionError(f"small model {name}: relative L2 error {rel:.3g} >= 1e-3")
    log(f"[check] small CifarResNet GPU kernels vs CPU plain: worst relative L2 error {worst:.3g}")

    # ResNet-56 in bf16 through the kernels at a large batch, two steps: the
    # second launches the plans the first made, after every later plan
    big = CifarResNet(9, 10, dtype=torch.bfloat16, bn_impl="pallas")
    big.reset_parameters(torch.Generator().manual_seed(SEED))
    big.to(dev)
    xb = torch.tensor(rng.normal(size=(BN_BIG_BATCH, 32, 32, 3)).astype(np.float32), device=dev)
    bn.reset_launches()
    losses = []
    for _ in range(2):
        big.zero_grad(set_to_none=True)
        loss = big(xb).float().square().mean()
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    if bn.LAUNCHES != {"bn_fwd": 2 * BNS_PER_STEP, "bn_bwd": 2 * BNS_PER_STEP}:
        raise AssertionError(f"ResNet-56 at batch {BN_BIG_BATCH} did not run its BNs through "
                             f"the kernels: {bn.LAUNCHES}")
    if not (np.isfinite(losses).all()
            and all(bool(torch.isfinite(p.grad).all()) for p in big.parameters())):
        raise AssertionError(f"ResNet-56 at batch {BN_BIG_BATCH}: non-finite loss or gradient")
    log(f"[check] ResNet-56 BN path at batch {BN_BIG_BATCH}: 2 steps through K1/K2, "
        f"finite losses {losses[0]:.4f}, {losses[1]:.4f} and gradients")
    cases.append({"case": f"[ResNet-56 bf16 batch {BN_BIG_BATCH}, 2 steps]", "losses": losses})
    return err, cases, worst


def phase_time(bns: dict = MAIN_PATH_BNS, label: str = "unpacked"):
    """Per-call times at one path's BN shapes in bf16, and the per-step
    totals over ResNet-56's 57 BNs."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    rows = []
    for (n, C, relu), count in bns.items():
        x = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev).to(torch.bfloat16)
        dy = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        b = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        y, mean, rstd, _ = bn.bn_fwd_cuda(x, g, b, EPS, relu)

        def lib_fwd():
            out = F.batch_norm(x, None, None, g, b, training=True, eps=EPS)
            return torch.relu(out) if relu else out

        xl = x.detach().requires_grad_(True)
        gl, bl = g.detach().requires_grad_(True), b.detach().requires_grad_(True)
        out_l = F.batch_norm(xl, None, None, gl, bl, training=True, eps=EPS)
        out_l = torch.relu(out_l) if relu else out_l

        variants = {
            "bn_fwd": {"": lambda: bn.bn_fwd_cuda(x, g, b, EPS, relu),
                       "plain_": lambda: bn.bn_relu_fwd_plain(x, g, b, EPS, relu),
                       "library_": lib_fwd},
            "bn_bwd": {"": lambda: bn.bn_bwd_cuda(x, y, dy, g, mean, rstd, relu),
                       "plain_": lambda: bn.bn_relu_bwd_plain(x, y, dy, g, mean, rstd, relu),
                       "library_": lambda: torch.autograd.grad(
                           out_l, (xl, gl, bl), dy, retain_graph=True)},
        }
        for kern, fns in variants.items():
            rec = {}
            for prefix, fn in fns.items():
                rec[f"{prefix}ms"] = cuda_time_ms(fn)
                rec[f"{prefix}device_ms"] = device_ms(fn)
            nbytes, flops = bn_bound(n, C, 2, relu, kern == "bn_bwd")
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
            rec.update(kernel=kern, rows=n, C=C, relu=relu, calls_per_step=count)
            rows.append(rec)
            us = {k: ("n/m" if v is None else f"{v * 1e3:.1f}") for k, v in rec.items()
                  if k.endswith("ms") and k != "bound_ms"}
            log(f"[time] {kern} {n}x{C} bf16 relu={relu}: kernel {us['ms']} us "
                f"(device {us['device_ms']}), plain {us['plain_ms']} (device "
                f"{us['plain_device_ms']}), library {us['library_ms']} (device "
                f"{us['library_device_ms']}), bound {rec['bound_ms'] * 1e3:.2f} us "
                f"({rec['bound_by']}); {count}/step")
    torch.cuda.synchronize()
    for kern in ("bn_fwd", "bn_bwd"):
        mine = [r for r in rows if r["kernel"] == kern]
        total = {k: (None if any(r[k] is None for r in mine)
                     else sum(r[k] * r["calls_per_step"] for r in mine))
                 for k in ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                           "library_device_ms", "bound_ms")}
        ms = {k: "n/m" if v is None else f"{v:.4f}" for k, v in total.items()}
        log(f"[time] {kern} per {label} step ({BNS_PER_STEP} calls, bf16): events {ms['ms']} ms, device "
            f"{ms['device_ms']}; plain {ms['plain_ms']} (device {ms['plain_device_ms']}); "
            f"F.batch_norm {ms['library_ms']} (device {ms['library_device_ms']}); bound "
            f"{ms['bound_ms']}")
    return rows


def _conv_inputs(rng, n, ci, co, h, w, dtype, dev):
    """Activations, a W2 at lecun scale and a cotangent, rounded to dtype."""
    import torch

    def t(a):
        return torch.tensor(a.astype(np.float32), device=dev).to(dtype)

    return (t(rng.normal(size=(n, ci, h * w))),
            t(rng.normal(size=(co, 9 * ci)) / np.sqrt(9 * ci)),
            t(rng.normal(size=(n, co, h * w))))


def phase_check_conv():
    """K3, K4 and K7 against their plain versions on the same card tensors,
    then a small lanes CifarResNet on the card against the CPU."""
    import torch

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    err = {"conv_fwd": 0.0, "conv_wgrad": 0.0, "conv_variant": 0.0}
    cases = []
    # the path's shapes at batch 64, and at 1 and 3 images (fewer items
    # than the bf16 K4 has blocks), then the ragged ones
    shapes = [(nb, *s) for nb in (CONV_BATCH, 1, 3) for s in CONV_CALLS] + CONV_RAGGED
    for n, ci, co, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            tag = f"[{n}x{ci}->{co} @{h}x{w} {dname}]"
            x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, dtype, dev)
            y_k = cl.conv_fwd_cuda(x, w2, h, w)
            e_y = assert_close(f"K3 {tag}", y_k, cl.conv_fwd_plain(x, w2, h, w), *CONV_TOL[dname])
            _same_bits(f"K3 {tag}", y_k, cl.conv_fwd_cuda(x, w2, h, w))
            dw_p = cl.conv_wgrad_plain(x, dy, h, w)
            scale = float(dw_p.abs().max())
            dw_k = cl.conv_wgrad_cuda(x, dy, h, w)
            e_w = assert_close(f"K4 {tag}", dw_k, dw_p, WGRAD_RTOL, WGRAD_RTOL * scale)
            _same_bits(f"K4 {tag}", dw_k, cl.conv_wgrad_cuda(x, dy, h, w))
            rec = {"case": tag, "conv_fwd": e_y, "conv_wgrad": e_w, "dw2_max": scale}
            for mode in cl.VARIANT_MODES:
                if mode == "copy" and co > ci:
                    continue
                got = cl.conv_variant_cuda(mode, x, w2, h, w)
                want = cl.conv_variant_plain(mode, x, w2, h, w)
                if mode == "kernel":
                    rec[f"conv_variant_{mode}"] = assert_close(
                        f"K7 {mode} {tag}", got, want, *CONV_TOL[dname])
                    _same_bits(f"K7 {mode} {tag}", got, cl.conv_variant_cuda(mode, x, w2, h, w))
                    if not torch.equal(got, y_k):
                        raise AssertionError(f"K7 kernel {tag} is not K3's output bit for bit")
                elif not torch.equal(got, want):
                    raise AssertionError(f"K7 {mode} {tag} is not bit-exact")
                else:
                    rec[f"conv_variant_{mode}"] = 0.0
                err["conv_variant"] = max(err["conv_variant"], rec[f"conv_variant_{mode}"])
            err["conv_fwd"] = max(err["conv_fwd"], e_y)
            err["conv_wgrad"] = max(err["conv_wgrad"], e_w)
            cases.append(rec)
            log(f"[check] {tag}: max|err| K3 {e_y:.3g}, K4 {e_w:.3g} (max|dW2| {scale:.3g}; "
                f"K3, K4 and K7 kernel repeats bit-identical, K7 kernel = K3), "
                f"K7 {', '.join(f'{k[13:]} {v:.3g}' for k, v in rec.items() if k.startswith('conv_variant'))}")
    torch.cuda.synchronize()

    # a small lanes CifarResNet: stages 1-2 (widths 16, 32) on the lanes
    # layout, 4 kernel-routed 3x3 convs -> 4 forward + 4 dgrad K3, 4 K4
    from fedml_tpu_torch.models.resnet import CifarResNet

    cpu = CifarResNet(1, 10, widths=(16, 32, 64), conv_impl="lanes")
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = CifarResNet(1, 10, widths=(16, 32, 64), conv_impl="lanes")
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    xs = torch.tensor(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    before = dict(cl.LAUNCHES)
    out_c, out_g = cpu(xs), gpu(xs.to(dev))
    out_c.square().sum().backward()
    out_g.square().sum().backward()
    torch.cuda.synchronize()
    ran = {k: cl.LAUNCHES[k] - before[k] for k in cl.LAUNCHES}
    if ran != {"conv_fwd": 8, "conv_wgrad": 4, "conv_variant": 0}:
        raise AssertionError(f"small lanes model did not run its 4 convs through K3/K4: {ran}")
    # relative L2 per tensor, 1e-3 as for the BN model above
    worst = 0.0
    pairs = [("logits", out_g.detach(), out_c.detach())]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    pairs += [(k, v, cpu.get_buffer(k)) for k, v in gpu.named_buffers()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-3:
            raise AssertionError(f"small lanes model {name}: relative L2 error {rel:.3g} >= 1e-3")
    log(f"[check] small lanes CifarResNet GPU kernels vs CPU plain: worst relative L2 "
        f"error {worst:.3g}")
    return err, cases, worst


def _time_fns(fns: dict) -> dict:
    """Events and profiler device ms per call for each ``prefix: fn``."""
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn)
        rec[f"{prefix}device_ms"] = device_ms(fn)
    return rec


def phase_time_conv():
    """Per-call K3 and K4 times at the lanes path's shapes, batch 64, bf16."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    rows = []
    for kern, calls in (("conv_fwd", CONV_CALLS), ("conv_wgrad", WGRAD_CALLS)):
        for (ci, co, h, w), count in calls.items():
            n = CONV_BATCH
            x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, torch.bfloat16, dev)
            x4, dy4 = x.view(n, ci, h, w), dy.view(n, co, h, w)
            w4 = cl._w2_inv(w2, ci, co)
            if kern == "conv_fwd":
                fns = {"": lambda: cl.conv_fwd_cuda(x, w2, h, w),
                       "plain_": lambda: cl.conv_fwd_plain(x, w2, h, w),
                       "library_": lambda: F.conv2d(x4, w4, padding=1)}
            else:
                fns = {"": lambda: cl.conv_wgrad_cuda(x, dy, h, w),
                       "plain_": lambda: cl.conv_wgrad_plain(x, dy, h, w),
                       "library_": lambda: torch.nn.grad.conv2d_weight(
                           x4, (co, ci, 3, 3), dy4, padding=1)}
            rec = _time_fns(fns)
            nbytes, flops = conv_bound(kern, n, ci, co, h * w)
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            rec.update(kernel=kern, n=n, ci=ci, co=co, h=h, w=w, calls_per_step=count)
            rows.append(rec)
            us = {k: ("n/m" if v is None else f"{v * 1e3:.1f}") for k, v in rec.items()
                  if k.endswith("ms") and k != "bound_ms"}
            log(f"[time] {kern} {n}x{ci}->{co} @{h}x{w} bf16: kernel {us['ms']} us (device "
                f"{us['device_ms']}), plain {us['plain_ms']} (device {us['plain_device_ms']}), "
                f"library {us['library_ms']} (device {us['library_device_ms']}), bound "
                f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); {count}/step")
    torch.cuda.synchronize()
    return rows


def phase_probe():
    """The K7 probe: per-call times of the conv's parts at the probe shapes
    (batch 64, bf16), counterpart of tools/lanes_probe.py main(). Back-to-
    back calls timed by CUDA events replace the TPU's two-point scan."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device("cuda")
    cl.reset_launches()
    rows = []
    for ci, co, h, w in PROBE_SHAPES:
        n = CONV_BATCH
        x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, torch.bfloat16, dev)
        wk = cl._w2_inv(w2, ci, co)
        xg, wg = x.detach().requires_grad_(True), wk.detach().requires_grad_(True)
        fns = {
            "library": lambda: F.conv2d(x.view(n, ci, h, w), wk, padding=1),
            "kernel": lambda: cl.conv_fwd_cuda(x, w2, h, w),
            "patches": lambda: cl.conv_variant_cuda("patches", x, w2, h, w),
            "copy": lambda: cl.conv_variant_cuda("copy", x, w2, h, w),
            "wgrad": lambda: cl.conv_wgrad_cuda(x, dy, h, w),
            "f+dgrad": lambda: torch.autograd.grad(cl.conv3x3_lanes(xg, wk, h, w), xg, dy),
            "f+wgrad": lambda: torch.autograd.grad(cl.conv3x3_lanes(x, wg, h, w), wg, dy),
        }
        rec = {name: cuda_time_ms(fn) for name, fn in fns.items()}
        modes = ("kernel", "patches", "copy")
        for mode in modes:
            rec[f"{mode}_device_ms"] = device_ms(fns[mode])
            if mode != "kernel":
                rec[f"{mode}_plain_ms"] = cuda_time_ms(
                    lambda m=mode: cl.conv_variant_plain(m, x, w2, h, w))
            nbytes, flops = conv_bound("conv_fwd" if mode == "kernel" else mode, n, ci, co, h * w)
            rec[f"{mode}_bound_ms"], _ = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        dms = [rec[f"{m}_device_ms"] for m in modes]
        # the three modes stage the same rows and copy out through the same
        # tile; kernel fills it from the mma loop (whose ldmatrix reads take
        # the taps as offsets: no gather of its own), patches by gathering
        # the patch rows, copy from the centre tap
        rec["split_device_ms"] = None if None in dms else {
            "mma loop and W2 (kernel - copy)": dms[0] - dms[2],
            "tap gather (patches - copy)": dms[1] - dms[2],
            "stage and copy-out (copy)": dms[2]}
        rec.update(n=n, ci=ci, co=co, h=h, w=w)
        rows.append(rec)
        log(f"[probe] c{ci}-{co}@{h}x{w} bf16 batch {n}, us/call (events): " + ", ".join(
            f"{k} {rec[k] * 1e3:.1f}" for k in fns))
        shown = [f"{m} " + ("n/m" if d is None else f"{d * 1e3:.2f}")
                 + f" (bound {rec[m + '_bound_ms'] * 1e3:.2f})" for m, d in zip(modes, dms)]
        split = ("not measured" if rec["split_device_ms"] is None else ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in rec["split_device_ms"].items()))
        log(f"[probe] c{ci}-{co}@{h}x{w} device us/call: {', '.join(shown)}; split: {split}")
    torch.cuda.synchronize()
    launches = dict(cl.LAUNCHES)
    if launches["conv_variant"] == 0:
        raise AssertionError("the probe launched no K7")
    return rows, launches


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:
        return "attention kernel (K6)"
    if "xent_kernel" in name:
        return "cross-entropy kernel (K5)"
    if "conv_fwd_" in name or "conv_wgrad_" in name:
        return "lanes conv kernels (K3/K4)"
    if any(f"::{k}" in name or name.startswith(k) for k in
           ("bn_fwd_onepass", "bn_bwd_onepass")):
        return "bn kernels (K1/K2)"
    # the blockdiag lowering's patch scatter (the backward of its strided
    # windows); its forward gather is a direct copy (copies)
    if any(k in low for k in ("unfold", "im2col", "col2im")):
        return "im2col / col2im"
    # cuBLAS's Hopper GEMMs are named nvjet_* (the blockdiag GEMMs)
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "gemm",
                              "nchw", "nhwc", "nvjet", "cutlass")):
        return "library convolution / gemm"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach)"
    if any(k in low for k in ("memcpy", "memset", "direct_copy")):
        return "copies"
    return "other elementwise / reductions"


def api_trainer(api):
    """The trainer an API's rounds run: the packed lane program (the
    simulation round's, or the cross-silo packed mesh round's) or the plain
    local trainer."""
    pm = getattr(api, "_packed_mesh", None)
    if pm is not None:
        return pm["round_fn"].lanes
    return api._packed_train if api._packed_train is not None else api._local_train


def train_block(api) -> tuple:
    """``(rows, tx, ty, tm)``: the clients an API keeps on the card and
    their stacked train tensors: the whole federation (simulation), the
    rank's block (cross-silo packed mesh, in plan order; resident) or the
    rank's block of the grouped schedule's last group (its largest
    clients)."""
    if getattr(api, "_packed_mesh", None) is not None:
        return (api._packed_mesh["rows"],) + tuple(api._packed_mesh["data"])
    if getattr(api, "_dev_sharded", None) is not None:
        return tuple(api._dev_sharded)
    if getattr(api, "_dev_groups", None) is not None:
        rows, _, *data = api._dev_groups[-1]
        return (rows, *data)
    return (np.arange(api.dataset.num_clients), *api._dev_train)


def client_run(api, trainer=None, client: int = 0, steps: int = 5):
    """``(run, live steps)``: ``run()`` trains one client's first ``steps``
    batches of real records from ``api.variables`` through ``trainer`` (the
    API's own by default) and returns its LocalResult."""
    import torch

    trainer = trainer or api._local_train
    rows, tx, ty, tm = train_block(api)
    count = min(int(api.dataset.train_counts[rows[client]]), steps * api.config.batch_size)

    def run():
        return trainer(api.variables, tx[client], ty[client], tm[client], count,
                       torch.Generator().manual_seed(1))

    return run, -(-count // api.config.batch_size)


def cohort_run(api, trainer=None, steps: int = 5):
    """``(run, executed packed steps, real images)``: ``run()`` trains the
    first ``lanes`` clients, one a lane, each on its first ``steps``
    batches, through the packed ``trainer`` (the API's own by default) and
    returns its PackedResult."""
    from fedml_tpu_torch.parallel.packed import executed_steps, plan_packing

    trainer = trainer or api_trainer(api)
    c = api.config
    clients = np.arange(c.pack_lanes)
    rows, tx, ty, tm = train_block(api)
    counts = np.minimum(api.dataset.train_counts[rows[clients]],
                        steps * c.batch_size).astype(np.float32)
    plan = plan_packing(counts, c.batch_size, 1, c.pack_lanes)
    orders = api._round_orders(0, c.pack_lanes)

    def run():
        return trainer(api.variables, tx, ty, tm, clients, counts, orders, plan)

    return run, len(executed_steps(plan.live)), float(counts.sum())


def step_profile(api, client: int = 0, steps: int = 5, trainer=None) -> dict:
    """The first ``steps`` live steps of one client's local training (its
    first ``steps`` batches of real records) through ``trainer`` (the API's
    own by default), as tools/torch_step_profile.py profiles a whole
    client: wall ms per step (unprofiled, ending in a sync), device ms per
    step by kernel family under torch.profiler, the busy share = device time
    over the unprofiled wall, and the host's launch calls. Few steps keep
    the profiler's post-processing (~3,300 events a step) short. The rounds
    before it have warmed the path up."""
    run, steps = client_run(api, trainer, client, steps)
    return {"client": client, **_profile(lambda: float(run().train_loss), steps)}


def packed_step_profile(api, steps: int = 5, trainer=None) -> dict:
    """``steps`` packed steps of the first ``lanes`` clients, one a lane
    (each client's first ``steps`` batches), through the packed ``trainer``
    (the round's by default): per step as ``step_profile``, and per real
    image."""
    run, steps, real = cohort_run(api, trainer, steps)
    prof = _profile(lambda: float(run().train_loss), steps)
    return {"clients": list(range(api.config.pack_lanes)), "lanes": api.config.pack_lanes,
            "real_images": real,
            "gpu_activities_per_real_image": prof["gpu_activities_per_step"] * steps / real,
            "device_ms_per_real_image": prof["device_ms_per_step"] * steps / real,
            "wall_ms_per_real_image": prof["wall_ms_per_step"] * steps / real, **prof}


# the host calls that put work on the card (CUDA runtime and libcuda API
# names, as torch.profiler records them)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|"
                         r"Memset)")
# kernels counted by name in a profile: K1 and K2
NAMED_KERNELS = ("bn_fwd_onepass", "bn_bwd_onepass")


def _profile(run, steps: int, op_tables: bool = True) -> dict:
    """Profile one call of ``run`` (``steps`` training steps), then time an
    unprofiled call: per-step wall, device time by kernel family, busy share,
    GPU activities, host launch calls, K1 and K2 by name, and (``op_tables``)
    the host operators that launched the most device time."""
    import torch
    from torch.autograd import DeviceType

    prof, events = profiled(run, f"{steps} steps")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_family, n, launches, graphs, named = {}, 0, 0, 0, dict.fromkeys(NAMED_KERNELS, 0)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            n += 1
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            for k in named:
                named[k] += k in e.name
        elif HOST_LAUNCH.match(e.name):
            launches += 1
            graphs += e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
    total = sum(by_family.values())
    # the host-side operators that launched the most device time, and those
    # that took the most host time themselves
    ops = ([e for e in prof.key_averages() if e.device_type == DeviceType.CPU] if op_tables
           else [])
    top = sorted((e for e in ops if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]
    return {"live_steps": steps, "wall_ms_per_step": wall_s / steps * 1e3,
            "device_ms_per_step": total, "device_busy_share": total * steps / (wall_s * 1e3),
            "gpu_activities_per_step": n / steps,
            # CUDA runtime and libcuda calls that enqueue work (kernels,
            # graphs, copies, fills) as the profiler sees them, and of them
            # the graph launches
            "host_launches_per_step": launches / steps, "graph_launches_per_step": graphs / steps,
            "kernels_by_name": named,
            "device_ms_per_step_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "top_ops": [{"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top],
            "top_host_ops": [{"name": e.key, "host_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                              "calls_per_step": e.count / steps} for e in host]}


# -- the captured step: eager against captured --------------------------------

# live steps of one client (or of each lane's client) in the eager-against-
# captured gate
GATE_STEPS = 12
# CUgraphNodeType CU_GRAPH_NODE_TYPE_KERNEL and CUkernelNodeAttrID
# CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE (cuda.h)
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE = 2
# the cooperative kernels: K1, K2 and the bf16 K4
COOPERATIVE_KERNELS = ("bn_fwd_onepass", "bn_bwd_onepass", "conv_wgrad_mma")
# the port's kernels as a graph's nodes are counted: K1, K2, the bf16 K4,
# the bf16 K3 (and the CUDA-core one), the bf16 K6
GRAPH_KERNELS = (*COOPERATIVE_KERNELS, "conv_fwd_mma", "conv_fwd_kernel", "flash_fwd_")
# each path's step graph: its kernel nodes, and K1/K2 by name a step
BN_GRAPH = {"bn_fwd_onepass": BNS_PER_STEP, "bn_bwd_onepass": BNS_PER_STEP}


def trainer_programs(trainer) -> list:
    """The step programs (``parallel/capture.CapturedStep``) of a plain or
    packed trainer."""
    if hasattr(trainer, "lanes"):
        return [p for lanes in trainer.lanes.values() for p in lanes.programs.values()]
    return list(trainer.programs.values())


def step_programs(api) -> list:
    """The step programs of the API's trainer."""
    return trainer_programs(api_trainer(api))


def one_step_profile(prog) -> dict:
    """One turn of a trainer's step loop under the profiler: the gathers
    into the step's static inputs, the step (a graph replay, or the eager
    body), the loss sum. Returns the host's launch calls, the graph
    launches, the GPU activities and K1 and K2 by name. The step trains
    the module from wherever it stands; every client reloads it."""
    import torch
    from torch.autograd import DeviceType

    src = [t.clone() for t in prog.inputs]
    idx = torch.arange(src[0].shape[0], device=src[0].device)
    total = torch.zeros((), device=src[0].device)

    def turn():
        nonlocal total
        for a, b in zip(src, prog.inputs):
            torch.index_select(a, 0, idx, out=b)
        out = prog()
        total = total + (out if out.dim() == 0 else out.sum())

    _, events = profiled(turn, "one turn of the step loop")
    rec = {"host_launches": 0, "graph_launches": 0, "gpu_activities": 0,
           "kernels_by_name": dict.fromkeys(NAMED_KERNELS, 0)}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            rec["gpu_activities"] += 1
            for k in NAMED_KERNELS:
                rec["kernels_by_name"][k] += k in e.name
        elif HOST_LAUNCH.match(e.name):
            rec["host_launches"] += 1
            rec["graph_launches"] += e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
    return rec


def replays(api) -> int:
    return sum(p.replays for p in step_programs(api))


def eager_trainer(api):
    """The API's trainer built again with ``capture=False``: the same step
    body, run eagerly."""
    from fedml_tpu_torch.parallel.local import make_local_train_fn
    from fedml_tpu_torch.parallel.packed import make_packed_cohort_train

    kw = dict(api._local_train_kwargs(), capture=False)
    if api._packed_train is None:
        return make_local_train_fn(api.bundle, api.task, **kw)
    hooks = api._packing_hooks()
    return make_packed_cohort_train(api.bundle, api.task, int(api.dataset.train_x.shape[1]),
                                    client_transform=hooks.get("client_transform"),
                                    reduce_extras=hooks.get("reduce_extras"),
                                    packed_conv=api.config.packed_conv, **kw)


def _outcome(res) -> dict:
    """A trainer's result as named tensors: its variables and losses."""
    out = {f"variables/{k}": v for k, v in res.variables.items()}
    out["train_loss"] = res.train_loss
    if getattr(res, "first_loss", None) is not None:
        out["first_loss"] = res.first_loss
    return out


def _distance(a: dict, b: dict) -> tuple[float, list]:
    """The largest absolute difference over every tensor, and the names of
    the tensors whose bits differ."""
    import torch

    names = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max()) for k in names),
                default=0.0)
    return worst, names


def _capture_verdict(tag: str, e1: dict, e2: dict, c: dict, explain=None) -> dict:
    """The captured run ``c`` against two eager runs ``e1``, ``e2`` of the
    same work (named tensors): eager runs that repeat bit for bit make the
    captured run's bits the gate; else it may be no farther from the first
    eager run than the second is, and ``explain()``, if given, names the
    tensors that one eager step already changes between two runs."""
    d_ee, diff_ee = _distance(e1, e2)
    d_ce, diff_ce = _distance(c, e1)
    rec = {"eager_vs_eager": d_ee, "eager_vs_eager_tensors": len(diff_ee),
           "captured_vs_eager": d_ce, "captured_vs_eager_tensors": len(diff_ce),
           "tensors": len(e1)}
    if not diff_ee:
        if diff_ce:
            raise AssertionError(f"{tag} the eager runs repeat bit for bit and the captured run "
                                 f"differs by up to {d_ce:.3g} in {len(diff_ce)} tensors: "
                                 f"{diff_ce[:6]}")
        rec["verdict"] = "bit-identical"
        return rec
    note = ""
    if explain is not None:
        ops = rec["eager_differs_after_one_step_in"] = explain()
        note = f"; one eager step differs in {ops[:6]}"
    if d_ce > d_ee:
        raise AssertionError(f"{tag} captured run {d_ce:.3g} from eager, farther than the "
                             f"eager runs from each other ({d_ee:.3g}){note}")
    rec["verdict"] = f"within the eager runs' distance{note}"
    return rec


def capture_gate(api, eager, tag: str, packed: bool) -> dict:
    """One client's first GATE_STEPS live steps (or one packed cohort's),
    eager twice, then captured. Eager runs that repeat bit for bit make the
    captured run's bits the gate; else the captured run may be no farther
    from the first eager run than the second is, and the tensors that one
    eager step already changes between two runs name the op that differs."""
    import torch

    def runner(trainer, steps=GATE_STEPS):
        if packed:
            run, n, _ = cohort_run(api, trainer, steps)
        else:
            run, n = client_run(api, trainer, 0, steps)
        return run, n

    run_e, steps = runner(eager)
    run_c, _ = runner(None)
    e1, e2 = _outcome(run_e()), _outcome(run_e())
    r0 = replays(api)
    c = _outcome(run_c())
    torch.cuda.synchronize()
    if replays(api) - r0 != steps:
        raise AssertionError(f"{tag} the captured run replayed {replays(api) - r0} times for "
                             f"{steps} live steps")
    def one_step_ops():
        one_e, _ = runner(eager, 1)
        return _distance(_outcome(one_e()), _outcome(one_e()))[1]

    rec = {"steps": steps, **_capture_verdict(tag, e1, e2, c, one_step_ops)}
    log(f"{tag} eager vs captured over {steps} live steps: {rec['verdict']} (eager-eager "
        f"{rec['eager_vs_eager']:.3g} in {rec['eager_vs_eager_tensors']} of {len(e1)} tensors, "
        f"captured-eager {rec['captured_vs_eager']:.3g} in {rec['captured_vs_eager_tensors']})")
    return rec


def _cu(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUresult {code}")


def graph_kernel_nodes(graph) -> dict:
    """The kernel nodes of a captured graph, read through libcuda's graph API:
    each kernel's node count and how many of those nodes are cooperative."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    g = vp(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    _cu(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    by_name: dict = {}
    kernel_nodes = 0
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        kernel_nodes += 1
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_uint64 * 16)()
        _cu(cu.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            _cu(cu.cuFuncGetName(ctypes.byref(name), vp(params[0])), "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(ctypes.byref(name), vp(params[7])), "cuKernelGetName")
        attr = (ctypes.c_int * 16)()
        _cu(cu.cuGraphKernelNodeGetAttribute(vp(node), _CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE,
                                             attr), "cuGraphKernelNodeGetAttribute")
        key = next((k for k in GRAPH_KERNELS if k in name.value.decode()), "other")
        rec = by_name.setdefault(key, {"nodes": 0, "cooperative": 0})
        rec["nodes"] += 1
        rec["cooperative"] += bool(attr[0])
    return {"nodes": n.value, "kernel_nodes": kernel_nodes, "by_name": by_name}


def capture_arms(api, tag: str, smi: str, packed: bool = False, graph_kernels=None,
                 named_per_step: int = 0) -> dict:
    """The phase's path on one client (or one packed cohort), eager and
    captured: the gate, both profiles (wall, device, busy share, host
    launches per step), the captured graph's kernel nodes against
    ``graph_kernels`` (name -> nodes; K1, K2 and K4's all cooperative), K1
    and K2 by name in each profile against ``named_per_step`` a step, and
    the grid-barrier words of every capturing stream, zero after the
    replays."""
    import torch

    from fedml_tpu_torch.ops.grid_barrier import barrier_words

    eager = eager_trainer(api)
    gate = capture_gate(api, eager, tag, packed)
    prof_fn = packed_step_profile if packed else step_profile
    profiles = {"eager": prof_fn(api, trainer=eager), "captured": prof_fn(api)}
    for arm, prof in profiles.items():
        extra = (f" ({prof['gpu_activities_per_real_image']:.2f} GPU activities per real image)"
                 if packed else "")
        log(f"{tag} {arm} step: wall {prof['wall_ms_per_step']:.2f} ms, device "
            f"{prof['device_ms_per_step']:.3f} ms (busy share {prof['device_busy_share']:.3f}), "
            f"{prof['gpu_activities_per_step']:.0f} GPU activities{extra}, "
            f"{prof['host_launches_per_step']:.1f} host launches "
            f"({prof['graph_launches_per_step']:.1f} graph launches); K1/K2 by name "
            f"{prof['kernels_by_name']} over {prof['live_steps']} steps; device ms by family "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_per_step_by_family"].items())
            + f"; {smi}")
        for k, v in prof["kernels_by_name"].items():
            if v != named_per_step * prof["live_steps"]:
                raise AssertionError(f"{tag} {arm}: the profile counts {v} {k} kernels over "
                                     f"{prof['live_steps']} steps; expected {named_per_step} a step")
    if profiles["captured"]["graph_launches_per_step"] != 1.0:
        raise AssertionError(f"{tag} the captured step made "
                             f"{profiles['captured']['graph_launches_per_step']} graph launches")
    progs = step_programs(api)
    # one turn of the step loop each way: the host's launches a step, and
    # the profiler's count of K1 and K2 in one replayed step
    one = {"eager": one_step_profile(trainer_programs(eager)[0]),
           "captured": one_step_profile(progs[0])}
    log(f"{tag} one turn of the step loop: " + "; ".join(
        f"{arm} {r['host_launches']} host launches ({r['graph_launches']} graph), "
        f"{r['gpu_activities']} GPU activities, {r['kernels_by_name']}" for arm, r in one.items()))
    for arm, r in one.items():
        if any(v != named_per_step for v in r["kernels_by_name"].values()) or \
                r["graph_launches"] != (arm == "captured"):
            raise AssertionError(f"{tag} one {arm} step: {r}; expected {named_per_step} of each "
                                 f"of K1 and K2 and {int(arm == 'captured')} graph launch")
    nodes = [graph_kernel_nodes(p.graph) for p in progs]
    for rec in nodes:
        got = {k: v["nodes"] for k, v in rec["by_name"].items() if k != "other"}
        want = {k: v for k, v in (graph_kernels or {}).items() if v}
        if got != want:
            raise AssertionError(f"{tag} the captured graph holds kernel nodes {got}; expected "
                                 f"{want}")
        for k in COOPERATIVE_KERNELS:
            if k in rec["by_name"] and rec["by_name"][k]["cooperative"] != rec["by_name"][k]["nodes"]:
                raise AssertionError(f"{tag} {k}: {rec['by_name'][k]} cooperative nodes")
    words = [int(barrier_words(p.stream.device, p.stream.cuda_stream)[0]) for p in progs]
    if any(words):
        raise AssertionError(f"{tag} grid-barrier arrival words {words} after the replays")
    log(f"{tag} captured graph(s): {nodes}; warm-up launches (not counted) "
        f"{[p.warmup_launches for p in progs]}; launches a replay adds "
        f"{[p.launches_per_step for p in progs]}; barrier arrival words {words}")
    torch.cuda.synchronize()
    return {"gate": gate, "profiles": profiles, "one_step": one, "graph_nodes": nodes,
            "launches_per_replay": [p.launches_per_step for p in progs],
            "warmup_launches": [p.warmup_launches for p in progs], "replays": replays(api)}


def eager_rounds(api, init: dict, tag: str, smi: str, captured: tuple) -> dict:
    """The phase's rounds again from the same initial variables, through
    the eager step (``capture=False``), for real images/s beside the
    captured rounds': the same launch counts, and the losses side by
    side."""
    packed = api._packed_train is not None
    name = "_packed_train" if packed else "_local_train"
    kept = getattr(api, name)
    setattr(api, name, eager_trainer(api))
    api.variables = {k: v.clone() for k, v in init.items()}
    api.server_state = api.init_server_state()
    try:
        rounds, metrics, _eval_s, trained, _launches = run_rounds(api, f"{tag} eager", smi)
    finally:
        setattr(api, name, kept)
    c_rounds, _, _, c_trained, _ = captured
    if trained != c_trained:
        raise AssertionError(f"{tag} eager rounds launched {trained}; the captured {c_trained}")
    e_s = sum(r["seconds"] for r in rounds)
    c_s = sum(r["seconds"] for r in c_rounds)
    real = sum(r["real_images"] for r in rounds)
    rec = {"rounds": rounds, "eval": metrics, "real_images_per_s": real / e_s,
           "captured_real_images_per_s": real / c_s,
           "loss_eager_minus_captured": [r["loss"] - c["loss"] for r, c in zip(rounds, c_rounds)]}
    log(f"{tag} real images/s: captured {real / c_s:.1f}, eager {real / e_s:.1f} "
        f"({e_s / c_s:.3f}x the captured rounds' wall); losses eager - captured "
        f"{rec['loss_eager_minus_captured']}; {smi}")
    return rec


@functools.lru_cache(maxsize=1)
def flagship_data():
    """The flagship's federation, made once for every phase that trains on
    it (phases 4, 4b, 4c and 8; the APIs only read it)."""
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    return make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, 32, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)


def flagship_api(bn_impl: str = "pallas", conv_impl: str = "xla", api_cls=None, ds=None,
                 mesh=None, api_kw: Optional[dict] = None, **config):
    """bench.py's flagship cut to 2 rounds: ResNet-56 FedAvg (or
    ``api_cls``) on 32 non-IID synthetic CIFAR-10-shaped clients, 8 a
    round, batch 64, bf16; ``config`` overrides FedConfig fields, ``mesh``
    is a cross-silo API's client mesh, ``api_kw`` more keyword arguments of
    the API class."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models import create_model

    ds = ds or flagship_data()
    base = dict(model="resnet56", dataset="cifar10", client_num_in_total=32,
                client_num_per_round=8, comm_round=2, batch_size=64, epochs=1, lr=0.1,
                momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                async_rounds=True)
    cfg = FedConfig(**{**base, **config})
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl=bn_impl, conv_impl=conv_impl)
    return (api_cls or FedAvgAPI)(ds, cfg, bundle, **({"mesh": mesh} if mesh else {}),
                                  **(api_kw or {}))


def run_rounds(api, tag: str, smi: str, replayed: Optional[int] = None,
               on_round=None, eval_finite: bool = True) -> tuple:
    """The configured rounds (one sync each), then evaluate_global. Returns
    (rounds, metrics, eval seconds, launches after the rounds, launches
    after the evaluation); the counters are set to 0 just before. With
    ``replayed``, the rounds must have replayed the captured step that many
    times: once a live (or executed packed) step. ``on_round(api, r)``
    runs after each round's sync; a dict it returns joins that round's
    record. ``eval_finite=False`` leaves the evaluation's loss to the
    caller's check."""
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl

    bn.reset_launches()
    cl.reset_launches()
    r0 = replays(api)
    rounds = []
    for r in range(api.config.comm_round):
        t = time.perf_counter()
        loss = float(api.run_round(r))        # one sync per round
        dt = time.perf_counter() - t
        real, executed = api.round_counts(r)
        rounds.append({"round": r, "loss": loss, "seconds": dt, "real_images": real,
                       "executed_images": executed, "real_images_per_s": real / dt,
                       **((on_round(api, r) or {}) if on_round is not None else {})})
        log(f"{tag} round {r}: loss {loss:.4f}, {dt:.2f} s, {real} real images "
            f"({executed} executed), {real / dt:.1f} real images/s")
        if not np.isfinite(loss):
            raise AssertionError(f"round {r} loss is not finite: {loss}")
    trained = {**bn.LAUNCHES, **cl.LAUNCHES}
    if replayed is not None and replays(api) - r0 != replayed:
        raise AssertionError(f"{tag} the rounds replayed the captured step "
                             f"{replays(api) - r0} times; expected {replayed}, one a step")
    t = time.perf_counter()
    metrics = api.evaluate_global()
    eval_s = time.perf_counter() - t
    launches = {**bn.LAUNCHES, **cl.LAUNCHES}
    log(f"{tag} evaluate_global: {metrics} in {eval_s:.2f} s; launches {launches}")
    train_s = sum(r["seconds"] for r in rounds)
    log(f"{tag} {len(rounds)} rounds in {train_s:.2f} s: {len(rounds) / train_s:.4f} rounds/s, "
        f"{sum(r['real_images'] for r in rounds) / train_s:.1f} real images/s; {smi}")
    if not ((np.isfinite(metrics["loss"]) or not eval_finite) and 0.0 <= metrics["acc"] <= 1.0):
        raise AssertionError(f"evaluate_global gave {metrics}")
    return rounds, metrics, eval_s, trained, launches


def phase_train(smi: str, bn_impl: str = "pallas", conv_impl: str = "xla"):
    """2 FedAvg rounds of the flagship in one configuration; checks the
    kernels' launch counts over the rounds and over evaluate_global."""
    import torch

    tag = f"[train {conv_impl}/{bn_impl}]"
    t0 = time.perf_counter()
    api = flagship_api(bn_impl, conv_impl)
    ds, cfg = api.dataset, api.config
    torch.cuda.synchronize()
    log(f"{tag} set-up (data {ds.train_x.shape}, model, placement) {time.perf_counter() - t0:.1f} s")

    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    init = {k: v.clone() for k, v in api.variables.items()}
    captured = run_rounds(api, tag, smi, replayed=steps)
    rounds, metrics, eval_s, trained, launches = captured
    train_s = sum(r["seconds"] for r in rounds)
    # per live step: the BN path runs 57 K1 + 57 K2; the lanes path 72 K3
    # (36 forward + 36 dgrad) and 36 K4, and 36 K3 per eval batch
    eval_batches = -(-ds.test_x.shape[0] // EVAL_BATCH)
    per_step = ({"bn_fwd": BNS_PER_STEP, "bn_bwd": BNS_PER_STEP} if bn_impl == "pallas"
                else {"conv_fwd": CONV_PER_STEP, "conv_wgrad": WGRAD_PER_STEP})
    per_eval = {"conv_fwd": CONV_PER_STEP // 2} if conv_impl == "lanes" else {}
    for k in trained:
        want = per_step.get(k, 0) * steps
        if trained[k] != want:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {per_step.get(k, 0)} x {steps} live steps = {want}")
        want_eval = per_eval.get(k, 0) * eval_batches
        if launches[k] - trained[k] != want_eval:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected {want_eval}")
    bn_path = bn_impl == "pallas"
    arms = capture_arms(api, tag, smi, graph_kernels=BN_GRAPH if bn_path else
                        {"conv_fwd_mma": CONV_PER_STEP, "conv_wgrad_mma": WGRAD_PER_STEP},
                        named_per_step=BNS_PER_STEP if bn_path else 0)
    # the eager arm's rounds: phase 4 only (the lanes path's would add ~40 s)
    eager = eager_rounds(api, init, tag, smi, captured) if bn_path else None
    return {"bn_impl": bn_impl, "conv_impl": conv_impl, "rounds": rounds, "eval": metrics,
            "step_profile": arms["profiles"]["captured"], "capture": arms, "eager_rounds": eager,
            "eval_s": eval_s, "steps": steps, "eval_batches": eval_batches,
            "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s,
            "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}


def phase_train_packed(smi: str):
    """The flagship's 2 rounds under the packing schedule (pack_lanes=2):
    57 K1 and 57 K2 per executed packed step and none in evaluate_global;
    a small f32 packed round on the card against the same round unpacked;
    the flagship's bf16 step against its plain steps; the summation-order
    control; the conv timing; a profile of 5 packed steps."""
    import torch

    from fedml_tpu_torch.parallel.packed import executed_steps

    tag = "[train packed]"
    t0 = time.perf_counter()
    api = flagship_api(pack_lanes=PACK_LANES, packed_conv="off")
    torch.cuda.synchronize()
    log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; {api.packed_status()}")
    if not api.packed_status()["scheduled"]:
        raise AssertionError(f"{tag} the packed schedule does not apply: {api.packed_status()}")
    plans = [api._packed_plan(api.sample(r)) for r in range(api.config.comm_round)]
    per_round = [{"lanes": pl.n_lanes, "T": pl.T, "executed_steps": len(executed_steps(pl.live)),
                  "lane_steps": pl.live.sum(1).astype(int).tolist()} for pl in plans]
    log(f"{tag} plans: {per_round}")
    steps = sum(r["executed_steps"] for r in per_round)
    init = {k: v.clone() for k, v in api.variables.items()}
    captured = run_rounds(api, tag, smi, replayed=steps)
    rounds, metrics, eval_s, trained, launches = captured
    train_s = sum(r["seconds"] for r in rounds)
    for k in ("bn_fwd", "bn_bwd"):
        if trained[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {BNS_PER_STEP} x {steps} packed steps")
        if launches[k] != trained[k]:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected 0")
    if any(trained[k] for k in ("conv_fwd", "conv_wgrad")):
        raise AssertionError(f"{tag} the packed path launched a lanes conv kernel: {trained}")
    replay = packed_replay_check()
    bf16_check = packed_bf16_step_check()
    control = order_control()
    conv_timing = packed_conv_timing()
    arms = capture_arms(api, tag, smi, packed=True, graph_kernels=BN_GRAPH,
                        named_per_step=BNS_PER_STEP)
    eager = eager_rounds(api, init, tag, smi, captured)
    return {"pack_lanes": PACK_LANES, "plans": per_round, "rounds": rounds, "eval": metrics,
            "step_profile": arms["profiles"]["captured"], "capture": arms,
            "eager_rounds": eager, "replay_check": replay, "bf16_step_check": bf16_check,
            "order_control": control, "conv_timing": conv_timing,
            "eval_s": eval_s, "steps": steps,
            "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s,
            "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}


def packed_replay_check(api_cls=None, tag: str = "[train packed]", **extra) -> dict:
    """One f32 round of a small CifarResNet (widths 8/16/16, 8x8 images, 4
    clients, 3 a round, 2 epochs) on the card, packed in two lanes against
    unpacked, from the same weights and orders: the CPU test's tolerance
    (variables rtol 1e-4 / atol 1e-5, loss rtol 1e-5). ``api_cls`` (FedAvg
    by default) and ``extra`` config fields pick the algorithm."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "packed-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    apis = []
    for lanes in (PACK_LANES, 0):
        cfg = FedConfig(**{**dict(model="cifar-small", client_num_in_total=4,
                                  client_num_per_round=3, comm_round=1, batch_size=8, epochs=2,
                                  lr=0.05, momentum=0.9, seed=SEED, device_data="on",
                                  pack_lanes=lanes), **extra})
        bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                        bn_impl="pallas"), (8, 8, 3))
        apis.append((api_cls or FedAvgAPI)(ds, cfg, bundle))
    packed, plain = apis
    packed.variables = {k: v.clone() for k, v in plain.variables.items()}
    plan = packed._packed_plan(packed.sample(0))
    if plan.k_max < 2 or plan.live.min() > 0:
        raise AssertionError("the replay check's cohort should put two clients in a lane and "
                             "give a lane dead steps")
    loss_p, loss_u = packed.run_round(0), plain.run_round(0)
    if not abs(loss_p - loss_u) <= 1e-5 * abs(loss_u):
        raise AssertionError(f"packed round loss {loss_p} != unpacked {loss_u} at rtol 1e-5")
    worst = 0.0
    for k, v in plain.variables.items():
        worst = max(worst, assert_close(f"packed replay {k}", packed.variables[k], v, 1e-4, 1e-5))
    log(f"{tag} f32 replay on the card: loss {loss_p:.7f} vs {loss_u:.7f} unpacked, "
        f"variables within {worst:.3g} (rtol 1e-4, atol 1e-5)")
    return {"loss_packed": loss_p, "loss_unpacked": loss_u, "max_abs_err": worst}


# The packed flagship's bf16 step against its plain steps. Both bf16 steps
# round in their own order (the grouped conv, the folded BN sums), so
# neither is the other's reference: each is held against the exact step
# (f32, TF32 off) on the same inputs, and the packed step's relative L2
# distance from it may be at most this multiple of the plain bf16 step's,
# per lane and quantity (logits, gradients, BN running statistics). A
# fault of the packed path (lanes' channels mixed, a wrong cast) gives an
# error of order one, far above bf16's own.
PACKED_BF16_RATIO = 2.0
# ResNet-56's 3x3 convs at batch 64, one per stage, (C, H = W): the packed
# path's grouped conv over two lanes against two ungrouped convs and one
PACKED_CONV_SHAPES = ((16, 32), (32, 16), (64, 8))
# every conv of the flagship's twin, (Ci, Co, k, stride, H = W of the
# input): the stem, each stage's 3x3, the stride-2 3x3 (SAME pads (0, 1))
# and 1x1 projection of stages 2 and 3
TWIN_CONVS = ((3, 16, 3, 1, 32), (16, 16, 3, 1, 32), (16, 32, 3, 2, 32), (16, 32, 1, 2, 32),
              (32, 32, 3, 1, 16), (32, 64, 3, 2, 16), (32, 64, 1, 2, 16), (64, 64, 3, 1, 8))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def packed_bf16_step_check() -> dict:
    """One train step of the lane-stacked ResNet-56 (bf16, the BN kernels,
    batch 64) over two lanes of different weights and batches (lane 1 with
    24 padding records) against each lane's plain step in bf16 and in f32
    on the same inputs: logits, per-lane gradients and BN running
    statistics within PACKED_BF16_RATIO x the plain bf16 step's error."""
    import torch

    from fedml_tpu_torch.core.tasks import classification_loss
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.packed_conv import unstack_variables

    dev = torch.device("cuda")
    L, bs = PACK_LANES, 64
    rng = np.random.default_rng(SEED + 11)
    x = torch.tensor(rng.normal(size=(L, bs, 32, 32, 3)).astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, 10, size=(L, bs)), device=dev)
    m = torch.ones(L, bs, device=dev)
    m[1, bs - 24:] = 0.0
    def model(dtype):
        return create_model("resnet56", 10, dtype=dtype, bn_impl="pallas").module.to(dev)

    weights = [create_model("resnet56", 10, bn_impl="pallas").init(100 + lane, device=dev)
               for lane in range(L)]

    names = [k for k, _ in model(torch.float32).named_parameters()]
    stats = [k for k, _ in model(torch.float32).named_buffers()]

    def record(logits, loss, grads: dict, buffers: dict) -> dict:
        def flat(ts):
            return torch.cat([t.detach().float().reshape(-1) for t in ts])
        return {"logits": logits.detach().float(), "loss": loss.detach().float().view(1),
                "grads": flat(grads[k] for k in names), "bn_stats": flat(buffers[k] for k in stats)}

    plain = {}
    for dtype in (torch.float32, torch.bfloat16):
        for lane in range(L):
            mod = model(dtype)
            mod.load_state_dict(weights[lane])
            mod.train()
            logits = mod(x[lane])
            loss = classification_loss(logits, y[lane], m[lane])
            loss.backward()
            plain[dtype, lane] = record(logits, loss, {k: p.grad for k, p in mod.named_parameters()},
                                        dict(mod.named_buffers()))
    twin = model(torch.bfloat16).lane_stacked(L)
    twin.load_state_dict({k: torch.cat([w[k] for w in weights]) for k in weights[0]})
    twin.train()
    logits = twin(x)
    losses = torch.stack([classification_loss(logits[lane], y[lane], m[lane]) for lane in range(L)])
    losses.sum().backward()
    grads = {k: p.grad for k, p in twin.named_parameters()}
    buffers = dict(twin.named_buffers())
    out, worst = {}, 0.0
    for lane in range(L):
        got = record(logits[lane], losses[lane], unstack_variables(grads, lane, L),
                     unstack_variables(buffers, lane, L))
        ref, pl = plain[torch.float32, lane], plain[torch.bfloat16, lane]
        for q in ref:
            if not bool(torch.isfinite(got[q]).all()):
                raise AssertionError(f"packed bf16 step: lane {lane} {q} is not finite")
            rec = {"plain_vs_f32": _rel(pl[q], ref[q]), "packed_vs_f32": _rel(got[q], ref[q]),
                   "packed_vs_plain": _rel(got[q], pl[q])}
            out[f"lane{lane}/{q}"] = rec
            if q == "loss":     # one number: reported, held through the logits
                continue
            ratio = rec["packed_vs_f32"] / rec["plain_vs_f32"]
            worst = max(worst, ratio)
            if not ratio <= PACKED_BF16_RATIO:
                raise AssertionError(
                    f"packed bf16 step: lane {lane} {q} lies {rec['packed_vs_f32']:.3g} from the "
                    f"f32 step, {ratio:.2f}x the plain bf16 step's {rec['plain_vs_f32']:.3g} "
                    f"(limit {PACKED_BF16_RATIO}x)")
    log("[train packed] bf16 step at the flagship's shapes, relative L2 from the f32 step, "
        "plain bf16 / packed bf16 (packed vs plain): " + "; ".join(
            f"{k} {v['plain_vs_f32']:.3g} / {v['packed_vs_f32']:.3g} ({v['packed_vs_plain']:.3g})"
            for k, v in out.items()) + f"; worst ratio {worst:.3f} (limit {PACKED_BF16_RATIO})")
    return {"quantities": out, "worst_ratio": worst, "limit": PACKED_BF16_RATIO}


def order_control() -> dict:
    """Round 0 of the flagship, unpacked and packed, with the plain BN
    (``bn_impl="xla"``) in place of K1/K2: from the same weights, data and
    orders as phases 4 and 4b, a change of summation order only. Their
    losses beside phase 4's and 4b's show how far bf16 rounding alone moves
    a round's loss."""
    out = {}
    for lanes in (0, PACK_LANES):
        api = flagship_api("xla", pack_lanes=lanes)
        out["packed" if lanes else "unpacked"] = float(api.run_round(0))
    log(f"[train packed] control, round 0 with the plain BN: unpacked {out['unpacked']:.4f}, "
        f"packed {out['packed']:.4f}")
    return out


def packed_conv_timing() -> list:
    """Forward and backward (input and weight gradients) of one 3x3 conv a
    stage, bf16, batch 64, channels last: two lanes as the packed path runs
    them (one groups=2 conv over [N, H, W, 2C]), as two ungrouped convs, and
    one lane alone; CUDA events and device ms per call."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    rows = []

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev,
                            dtype=torch.bfloat16)

    for C, hw in PACKED_CONV_SHAPES:
        n = 64
        xs = [t(n, hw, hw, C).permute(0, 3, 1, 2).requires_grad_() for _ in range(PACK_LANES)]
        ws = [t(C, C, 3, 3).requires_grad_() for _ in range(PACK_LANES)]
        gys = [t(n, hw, hw, C).permute(0, 3, 1, 2) for _ in range(PACK_LANES)]
        xg = torch.cat([x.detach() for x in xs], 1).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        wg = torch.cat([w.detach() for w in ws]).requires_grad_()
        gyg = torch.cat(gys, 1).contiguous(memory_format=torch.channels_last)

        def grouped():
            F.conv2d(xg, wg, padding=1, groups=PACK_LANES).backward(gyg)

        def split():
            for x, w, gy in zip(xs, ws, gys):
                F.conv2d(x, w, padding=1).backward(gy)

        def one():
            F.conv2d(xs[0], ws[0], padding=1).backward(gys[0])

        rec = {"C": C, "hw": hw, "n": n, **_time_fns({"grouped_": grouped, "split_": split,
                                                       "one_lane_": one})}
        rows.append(rec)
        log(f"[time] conv fwd+bwd {n}x{C}@{hw}x{hw} bf16, device ms (events): grouped x2 "
            f"{rec['grouped_device_ms']} ({rec['grouped_ms']:.4f}), split x2 "
            f"{rec['split_device_ms']} ({rec['split_ms']:.4f}), one lane "
            f"{rec['one_lane_device_ms']} ({rec['one_lane_ms']:.4f})")
    return {"l2_grouped_split_one": rows, "lowerings": lowering_timing(t)}


def lowering_bound(impl: str, L: int, n: int, C: int, hw: int, elt: int = 2) -> dict:
    """Bounds of one 3x3 SAME conv of L lanes, forward and backward (input
    and weight gradients), bf16 on the tensor cores. Useful basis: each
    lane's conv, x, dy and w read once, y, dx and dw written once, 3 x 2 *
    n*hw^2*9*C^2 FLOPs a lane. Streamed basis (blockdiag): its GEMMs stream
    L x those FLOPs, and its patch matrix [n*hw^2, L*9*C] is written and
    read forward, read again by the weight gradient, and its gradient
    written and read: 5 x its bytes more; the grouped conv's streamed
    basis is its useful one."""
    act = n * hw * hw * L * C
    nbytes = elt * (4 * act + 2 * 9 * L * C * C)
    flops = 3 * 2 * act * 9 * C
    s_bytes, s_flops = ((nbytes + 5 * elt * 9 * act, L * flops) if impl == "blockdiag"
                        else (nbytes, flops))
    (ub, uby), (sb, sby) = (bound_ms(nbytes, flops, PEAK_BF16_FLOPS),
                            bound_ms(s_bytes, s_flops, PEAK_BF16_FLOPS))
    return {"useful_bytes": nbytes, "useful_flops": flops, "bound_ms": ub, "bound_by": uby,
            "streamed_bytes": s_bytes, "streamed_flops": s_flops, "streamed_bound_ms": sb,
            "streamed_bound_by": sby}


def lowering_timing(t) -> list:
    """Forward and backward (input and weight gradients) of one 3x3 conv a
    stage of L = 2, 4, 8 lanes on the folded NHWC layout, bf16, batch 64,
    under the grouped and the blockdiag lowering (``ops/packed_conv.py``),
    and the blockdiag's patch gather alone with its backward (the scatter):
    CUDA events and device ms per call beside the bounds
    (``lowering_bound``). ``t(*shape)`` makes a bf16 tensor on the card."""
    import torch

    from fedml_tpu_torch.ops.packed_conv import conv_blockdiag, conv_grouped, patches

    rows = []
    for L in PACKED_CONV_LANES:
        for C, hw in PACKED_CONV_SHAPES:
            n = 64
            x, w = t(n, hw, hw, L * C).requires_grad_(), t(L * C, C, 3, 3).requires_grad_()
            gy, gp = t(n, hw, hw, L * C), t(n, hw, hw, L * C * 9)

            def fwd_bwd(conv, x=x, w=w, gy=gy, L=L):
                return torch.autograd.grad(conv(x, w, L), (x, w), gy)

            rec = {"lanes": L, "C": C, "hw": hw, "n": n, **_time_fns({
                "grouped_": lambda f=fwd_bwd: f(conv_grouped),
                "blockdiag_": lambda f=fwd_bwd: f(conv_blockdiag),
                "im2col_": lambda x=x, gp=gp: torch.autograd.grad(patches(x, 3, 3), x, gp)}),
                   **{f"{impl}_bound": lowering_bound(impl, L, n, C, hw)
                      for impl in ("grouped", "blockdiag")}}
            rows.append(rec)
            g, bd = rec["grouped_bound"], rec["blockdiag_bound"]
            log(f"[time] lowering fwd+bwd L={L} {n}x{C}@{hw}x{hw} bf16, device ms (events): "
                f"grouped {rec['grouped_device_ms']} ({rec['grouped_ms']:.4f}, bound "
                f"{g['bound_ms']:.4f} {g['bound_by']}), blockdiag {rec['blockdiag_device_ms']} "
                f"({rec['blockdiag_ms']:.4f}, bound {bd['bound_ms']:.4f} useful / "
                f"{bd['streamed_bound_ms']:.4f} streamed {bd['streamed_bound_by']}), of it "
                f"im2col gather + scatter {rec['im2col_device_ms']} ({rec['im2col_ms']:.4f})")
    torch.cuda.synchronize()
    return rows


# The zoo phase's FedOpt server lr: 0.01, as
# tests/test_algorithms.py::test_fedadam_runs. The bench arm keeps
# FedConfig's default of 1.0: an Adam step of 1.0 on every weight each
# round is a divergence test, not a smoke test.
ZOO_SERVER_LR = 0.01


def server_step_timing(api) -> dict:
    """FedOpt's server step on ResNet-56's parameters (the round's one
    step after the aggregate), on a copy of the server state."""
    import copy

    import torch

    update = api.crosssilo_hooks()["server_update"]
    state = copy.deepcopy(api.server_state)
    agg = {k: v * 0.999 if v.is_floating_point() else v for k, v in api.variables.items()}

    def fn():
        return update(api.variables, agg, None, 1.0, state, None)

    from fedml_tpu_torch.core.pytree import split_params

    rec = {"ms": cuda_time_ms(fn, iters=10), "device_ms": device_ms(fn, iters=5),
           "params": sum(v.numel() for v in split_params(api.variables)[0].values())}
    torch.cuda.synchronize()
    return rec


def phase_train_zoo(smi: str):
    """The algorithms of the hook contract on the packed flagship (FedOpt
    with server adam is bench.py's adaptive arm, bench.py:262-280) and
    FedAvg with client adam on the plain one, on the flagship's federation
    and widths (ResNet-56, ``bn_impl="pallas"``, bf16, 32 clients, 8 a
    round, batch 64): finite losses, 57 K1 + 57 K2 per executed packed or
    live step (the hooks add no BN launch) and none in ``evaluate_global``;
    FedOpt's server state after its rounds on the card and nonzero, its
    step count the rounds; small f32 FedOpt-adam and client-adam rounds
    packed against unpacked on the card; FedOpt's server step timed;
    profiles of 5 packed FedOpt steps and of 5 client-adam steps."""
    import torch

    from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
    from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
    from fedml_tpu_torch.core.optim import state_tensors
    from fedml_tpu_torch.parallel.packed import executed_steps

    runs = (   # (label, algorithm, FedConfig overrides, rounds); "packed": pack_lanes=2
        ("fedopt-adam", FedOptAPI,
         dict(server_optimizer="adam", server_lr=ZOO_SERVER_LR, packed=True), 2),
        ("fedprox", FedProxAPI, dict(fedprox_mu=0.01, packed=True), 1),
        ("fednova", FedNovaAPI, dict(packed=True), 1),     # momentum 0.9, the flagship's
        ("fedagc", FedAGCAPI, dict(packed=True), 1),       # clipping 1e-2, the default
        # amsgrad at Adam's customary 1e-3 (the flagship's 0.1 is an SGD step)
        ("fedavg-client-adam", FedAvgAPI, dict(client_optimizer="adam", lr=1e-3), 1),
    )
    ds = flagship_data()
    out, launches = {}, {"bn_fwd": 0, "bn_bwd": 0}
    for label, cls, overrides, n_rounds in runs:
        tag = f"[zoo {label}]"
        cfg = dict(overrides)
        packed = cfg.pop("packed", False)
        if packed:
            cfg.update(pack_lanes=PACK_LANES, packed_conv="off")
        t0 = time.perf_counter()
        api = flagship_api(api_cls=cls, ds=ds, comm_round=n_rounds, **cfg)
        torch.cuda.synchronize()
        status = api.packed_status()
        log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; {status}")
        if status["scheduled"] != packed:
            raise AssertionError(f"{tag} packed_status {status}; expected scheduled={packed}")
        if packed:
            steps = sum(len(executed_steps(api._packed_plan(api.sample(r)).live))
                        for r in range(n_rounds))
        else:
            steps = sum(api.round_counts(r)[1] // api.config.batch_size for r in range(n_rounds))
        rounds, metrics, eval_s, trained, after_eval = run_rounds(api, tag, smi,
                                                                 replayed=steps)
        for k in launches:
            if trained[k] != BNS_PER_STEP * steps or after_eval[k] != trained[k]:
                raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds and "
                                     f"{after_eval[k] - trained[k]} in evaluate_global; expected "
                                     f"{BNS_PER_STEP} x {steps} steps and 0")
            launches[k] += after_eval[k]
        if any(trained[k] for k in ("conv_fwd", "conv_wgrad")):
            raise AssertionError(f"{tag} launched a lanes conv kernel: {trained}")
        train_s = sum(r["seconds"] for r in rounds)
        rec = {"algorithm": cls.__name__, "config": overrides, "packed": packed, "steps": steps,
               "rounds": rounds, "eval": metrics, "eval_s": eval_s, "launches": after_eval,
               "rounds_per_s": len(rounds) / train_s,
               "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}
        if cls is FedOptAPI:
            tensors, counts = state_tensors(api.server_state["opt"])
            if not all(t.is_cuda for t in tensors + counts):
                raise AssertionError(f"{tag} the server state is not on the card")
            if not any(bool(t.abs().max() > 0) for t in tensors) or \
                    any(int(c) != n_rounds for c in counts):
                raise AssertionError(f"{tag} server state zero, or its count is not {n_rounds}: "
                                     f"counts {[int(c) for c in counts]}")
            rec["server_state_abs_max"] = max(float(t.abs().max()) for t in tensors)
            rec["server_step"] = server_step_timing(api)
            log(f"{tag} server state on the card, |max| {rec['server_state_abs_max']:.4g}, "
                f"count {[int(c) for c in counts]}; server step {rec['server_step']['ms']:.3f} ms "
                f"(device {rec['server_step']['device_ms']}) over "
                f"{rec['server_step']['params']} parameters; {smi}")
        if cls is FedOptAPI or not packed:     # eager and captured, profiled
            rec["capture"] = capture_arms(api, tag, smi, packed=packed, graph_kernels=BN_GRAPH,
                                          named_per_step=BNS_PER_STEP)
            rec["step_profile"] = rec["capture"]["profiles"]["captured"]
        out[label] = rec
        del api
    out["replay_check"] = packed_replay_check(FedOptAPI, "[zoo fedopt-adam]",
                                              server_optimizer="adam", server_lr=ZOO_SERVER_LR)
    # the lane program's per-lane adam state (moments, [L] step count) on
    # the card: a lane's second client starts from fresh state
    out["client_adam_replay_check"] = packed_replay_check(
        None, "[zoo client adam]", client_optimizer="adam", lr=0.01)
    out["launches"] = launches
    return out


# -- phase 4f: the joint packed lowerings ---------------------------------------

# bench.py's packed-conv A/B (_bench_packed_conv_ab, bench.py:168): the
# flagship's packed round under each lowering, its adaptive arm (FedOpt
# with server adam at phase 4c's server lr), and packing at L = 4 and 8:
# (label, lanes, packed_conv, FedOpt-adam)
PACKED_CONV_ARMS = (
    ("off-L2", 2, "off", False), ("grouped-L2", 2, "grouped", False),
    ("blockdiag-L2", 2, "blockdiag", False),
    ("fedopt-off-L2", 2, "off", True), ("fedopt-blockdiag-L2", 2, "blockdiag", True),
    ("off-L4", 4, "off", False), ("blockdiag-L4", 4, "blockdiag", False),
    ("off-L8", 8, "off", False), ("blockdiag-L8", 8, "blockdiag", False))
# warm rounds, then the same rounds timed (bench.py's discipline: the timed
# rounds' cohorts and steps are the warm ones')
AB_WARM, AB_TIMED = 2, 2
# the end-to-end bound of a joint lowering against off
# (tests/test_packed_conv.py:177-192): weights 2 x W_RTOL / 4 x W_ATOL,
# losses rtol 1e-2
E2E_RTOL, E2E_ATOL, E2E_LOSS_RTOL = 2e-2, 6e-3, 1e-2
PROFILE_FAMILIES = ("library convolution / gemm", "im2col / col2im", "copies",
                    "bn kernels (K1/K2)")


def step_conv_flops(api) -> dict:
    """Conv FLOPs of one executed packed step (L lanes x the batch) of the
    API's model: useful (each lane's convs forward, their input gradients
    but the stem's, their weight gradients) and streamed (the blockdiag
    GEMMs stream L x the useful FLOPs; the grouped conv the useful ones)."""
    import torch

    from fedml_tpu_torch.models.resnet import Conv

    model, fwd = api.bundle.module, []
    hooks = [m.register_forward_hook(
        lambda m, i, o: fwd.append(2 * o.shape[1] * o.shape[2] * m.weight.numel()))
        for m in model.modules() if isinstance(m, Conv)]
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, *api.bundle.input_shape, device=api.device))
    finally:
        for h in hooks:
            h.remove()
    c = api.config
    useful = c.pack_lanes * c.batch_size * (3 * sum(fwd) - fwd[0])    # the stem: no dgrad
    return {"convs": len(fwd), "useful": useful,
            "streamed": useful * (c.pack_lanes if c.packed_conv == "blockdiag" else 1)}


def packed_conv_arm(label: str, lanes: int, impl: str, fedopt: bool, ds, smi: str) -> dict:
    """One arm of the A/B: the flagship's packed round at ``lanes`` lanes
    under ``impl``; AB_WARM rounds, then the same rounds timed, ending in a
    sync: real images/s, rounds/s, executed packed steps, 57 K1 + 57 K2 and
    one replay a step; a 5-step profile (device ms a step, busy share, the
    conv/GEMM, im2col and copy families); conv FLOPs a step; peak memory
    over the arm."""
    import torch

    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.parallel.packed import executed_steps

    tag = f"[packed_conv {label}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    extra = dict(server_optimizer="adam", server_lr=ZOO_SERVER_LR) if fedopt else {}
    api = flagship_api(api_cls=FedOptAPI if fedopt else None, ds=ds, pack_lanes=lanes,
                       packed_conv=impl, **extra)
    status = api.packed_status()
    want = {"scheduled": True, "packed_conv_active": impl != "off",
            "reason": "packed_conv=off" if impl == "off" else None}
    if status != want or api._packed_train.packed_conv != impl:
        raise AssertionError(f"{tag} packed_status {status}, lowering "
                             f"{api._packed_train.packed_conv}; expected {want}")
    warm, warm_s = _rounds(api, 0, AB_WARM)
    plans = [api._packed_plan(api.sample(r)) for r in range(AB_TIMED)]
    if any(p.n_lanes != lanes for p in plans):
        raise AssertionError(f"{tag} plans of {[p.n_lanes for p in plans]} lanes")
    steps = [len(executed_steps(p.live)) for p in plans]
    bn.reset_launches()
    r0 = replays(api)
    losses, dt = _rounds(api, 0, AB_TIMED)
    launches, replayed = dict(bn.LAUNCHES), replays(api) - r0
    peak = {"allocated_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.max_memory_reserved()}
    real = sum(api.round_counts(r)[0] for r in range(AB_TIMED))
    if not all(np.isfinite(warm + losses)):
        raise AssertionError(f"{tag} a loss is not finite: {warm + losses}")
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * sum(steps):
            raise AssertionError(f"{tag} {k} launched {launches[k]} times; expected "
                                 f"{BNS_PER_STEP} x {sum(steps)} executed packed steps")
    if replayed != sum(steps):
        raise AssertionError(f"{tag} {replayed} replays for {sum(steps)} steps")
    prof = packed_step_profile(api)
    for k, v in prof["kernels_by_name"].items():
        if v != BNS_PER_STEP * prof["live_steps"]:
            raise AssertionError(f"{tag} the profile counts {v} {k} over {prof['live_steps']} "
                                 f"steps; expected {BNS_PER_STEP} a step")
    fam = prof["device_ms_per_step_by_family"]
    rec = {"lanes": lanes, "packed_conv": impl, "algorithm": type(api).__name__,
           "setup_and_warm_s": time.perf_counter() - t0 - dt, "warm_round_s": warm_s / AB_WARM,
           "losses": losses, "seconds": dt, "rounds_per_s": AB_TIMED / dt,
           "real_images": real, "real_images_per_s": real / dt,
           "executed_steps_per_round": steps, "launches": launches, "replays": replayed,
           "step_profile": prof, "families_ms": {f: fam.get(f, 0.0) for f in PROFILE_FAMILIES},
           "conv_flops_per_step": step_conv_flops(api), "peak_memory": peak}
    f = rec["conv_flops_per_step"]
    log(f"{tag} {AB_TIMED} rounds in {dt:.3f} s: {rec['rounds_per_s']:.4f} rounds/s, "
        f"{rec['real_images_per_s']:.1f} real images/s; executed packed steps a round {steps}; "
        f"5-step profile: device {prof['device_ms_per_step']:.3f} ms a step (busy "
        f"{prof['device_busy_share']:.3f}, wall {prof['wall_ms_per_step']:.2f} ms), families "
        f"{ {k: round(v, 4) for k, v in rec['families_ms'].items()} }; conv FLOPs a step "
        f"useful {f['useful'] / 1e9:.2f} G, streamed {f['streamed'] / 1e9:.2f} G; peak "
        f"{peak['allocated_bytes'] / 2**30:.2f} GiB allocated, "
        f"{peak['reserved_bytes'] / 2**30:.2f} GiB reserved; {smi}")
    del api
    return rec


def grouped_equals_off(ds) -> dict:
    """Round 0 of the packed flagship (2 lanes, bf16, K1/K2) under grouped
    and under off from the same weights, under cuDNN's deterministic
    algorithms (its default ones may part two identical rounds): bit for
    bit, since both run one grouped conv call."""
    import torch

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        off, grouped = (flagship_api(ds=ds, pack_lanes=PACK_LANES, packed_conv=impl)
                        for impl in ("off", "grouped"))
        grouped.variables = {k: v.clone() for k, v in off.variables.items()}
        losses = (float(off.run_round(0)), float(grouped.run_round(0)))
        differ = [k for k, v in off.variables.items() if not torch.equal(grouped.variables[k], v)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    if differ or losses[0] != losses[1]:
        raise AssertionError(f"[packed_conv] the grouped round differs from the off round: "
                             f"losses {losses}, tensors {differ[:6]}")
    log(f"[packed_conv] grouped round 0 equals the off round bit for bit (loss {losses[0]}), "
        f"{len(off.variables)} tensors")
    return {"loss": losses[0], "tensors": len(off.variables), "bit_identical": True}


def blockdiag_e2e_check() -> dict:
    """One f32 packed round of the small CifarResNet through K1/K2 (widths
    8/16/16, 8x8 images, 4 clients, 3 a round, 2 lanes, 2 epochs;
    ``packed_replay_check``'s round, TF32 off for F.conv2d and
    torch.matmul) under blockdiag against the same round under off from the
    same weights and orders, within the replay check's rtol 1e-4 / atol
    1e-5 (loss rtol 1e-5); the distance printed as max |diff| and as its
    share of that tolerance and of the end-to-end bound."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "packed-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    run = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=3, comm_round=1,
               batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED, device_data="on",
               pack_lanes=PACK_LANES)
    off, bd = (FedAvgAPI(ds, FedConfig(**run, packed_conv=impl), ModelBundle(
        "cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"), (8, 8, 3)))
        for impl in ("off", "blockdiag"))
    bd.variables = {k: v.clone() for k, v in off.variables.items()}
    loss_off, loss_bd = float(off.run_round(0)), float(bd.run_round(0))
    worst, share, tight = 0.0, 0.0, 0.0
    for k, v in off.variables.items():
        d, ref = (bd.variables[k].float() - v.float()).abs(), v.float().abs()
        worst = max(worst, float(d.max()))
        share = max(share, float((d / (E2E_ATOL + E2E_RTOL * ref)).max()))
        tight = max(tight, float((d / (1e-5 + 1e-4 * ref)).max()))
    rec = {"loss_off": loss_off, "loss_blockdiag": loss_bd, "max_abs_diff": worst,
           "share_of_bound": share, "share_of_replay_tolerance": tight,
           "bound": {"rtol": E2E_RTOL, "atol": E2E_ATOL, "loss_rtol": E2E_LOSS_RTOL},
           "gate": {"rtol": 1e-4, "atol": 1e-5, "loss_rtol": 1e-5}}
    log(f"[packed_conv] f32 blockdiag round against off on the card: loss {loss_bd:.7f} vs "
        f"{loss_off:.7f}, variables max |diff| {worst:.3g}: {share:.3g} of the bound rtol "
        f"{E2E_RTOL} / atol {E2E_ATOL}, {tight:.3g} of rtol 1e-4 / atol 1e-5")
    # held at the replay check's tolerance, which holds the round's update
    # and not only its weights; the end-to-end bound above is looser in
    # both terms
    if (not share <= 1.0 or not tight <= 1.0
            or not abs(loss_bd - loss_off) <= 1e-5 * abs(loss_off)):
        raise AssertionError(f"[packed_conv] the f32 blockdiag round is outside rtol 1e-4 / "
                             f"atol 1e-5 (loss rtol 1e-5) of the off round: {rec}")
    return rec


def lowering_check() -> dict:
    """Each conv of the flagship's twin (``TWIN_CONVS``) at L = 2, 4, 8
    lanes, batch 64, f32 (TF32 off), under blockdiag and grouped against
    the per-lane convs (``conv_vmap``) on the same card tensors: the
    forward and both gradients, each within 1e-4 (forward) or 1e-3
    (gradients) relative to the reference and to its largest entry."""
    import torch

    from fedml_tpu_torch.ops.packed_conv import conv_blockdiag, conv_grouped, conv_vmap

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    worst = {"y": 0.0, "dx": 0.0, "dw": 0.0}
    for L in PACKED_CONV_LANES:
        for ci, co, k, s, hw in TWIN_CONVS:
            ho = -(-hw // s)
            x = t(64, hw, hw, L * ci).requires_grad_()
            w = t(L * co, ci, k, k, scale=(ci * k * k) ** -0.5).requires_grad_()
            gy = t(64, ho, ho, L * co)
            want = (conv_vmap(x, w, L, s),)
            want += torch.autograd.grad(want[0], (x, w), gy)
            for name, conv in (("blockdiag", conv_blockdiag), ("grouped", conv_grouped)):
                y = conv(x, w, L, s)
                if tuple(y.shape) != (64, ho, ho, L * co) or not y.is_contiguous():
                    raise AssertionError(f"[packed_conv] {name} L={L} {ci}->{co} k{k} s{s}: "
                                         f"output {tuple(y.shape)}, contiguous "
                                         f"{y.is_contiguous()}")
                got = (y,) + torch.autograd.grad(y, (x, w), gy)
                for q, a, b, tol in zip(("y", "dx", "dw"), got, want, (1e-4, 1e-3, 1e-3)):
                    a, b = a.detach(), b.detach()
                    scale = float(b.abs().max())
                    e = assert_close(f"[packed_conv] {name} {q} L={L} {ci}->{co} k{k} s{s}",
                                     a, b, tol, tol * scale)
                    worst[q] = max(worst[q], e / scale)
    torch.cuda.synchronize()
    log(f"[packed_conv] blockdiag and grouped against the per-lane convs, every twin conv at "
        f"L = {PACKED_CONV_LANES}, batch 64, f32: largest |err| / max|ref| y {worst['y']:.3g}, "
        f"dx {worst['dx']:.3g}, dw {worst['dw']:.3g} (bounds 1e-4, 1e-3, 1e-3)")
    return {"convs": len(TWIN_CONVS) * len(PACKED_CONV_LANES), "worst_rel_to_max": worst}


def phase_train_packed_conv(smi: str) -> dict:
    """Phase 4f: bench.py's packed-conv A/B on the flagship (ResNet-56,
    bn_impl="pallas", bf16, 8 of 32 clients, batch 64): off, grouped and
    blockdiag at 2 lanes, FedOpt-adam under off and blockdiag, off and
    blockdiag at 4 and 8 lanes (``packed_conv_arm``); the speed-up over off;
    the gates: every twin conv under both lowerings against the per-lane
    convs (``lowering_check``), grouped = off bit for bit, the f32 blockdiag
    round within rtol 1e-4 / atol 1e-5 of off, the f32 blockdiag mesh round
    within 1e-5 of the blockdiag simulation round."""
    import gc

    import torch

    ds = flagship_data()
    out, launches = {"arms": {}, "lowering_check": lowering_check()}, {"bn_fwd": 0, "bn_bwd": 0}
    for label, lanes, impl, fedopt in PACKED_CONV_ARMS:
        rec = out["arms"][label] = packed_conv_arm(label, lanes, impl, fedopt, ds, smi)
        for k in launches:
            launches[k] += rec["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()
    for label, rec in out["arms"].items():
        base = out["arms"][label.replace(rec["packed_conv"], "off")]
        rec["speedup_over_off"] = rec["real_images_per_s"] / base["real_images_per_s"]
    log("[packed_conv] real images/s (speed-up over off), device ms a packed step: " + "; ".join(
        f"{label} {r['real_images_per_s']:.1f} ({r['speedup_over_off']:.3f}x), "
        f"{r['step_profile']['device_ms_per_step']:.3f}" for label, r in out["arms"].items())
        + f"; {smi}")
    out["grouped_equals_off"] = grouped_equals_off(ds)
    out["f32_blockdiag_vs_off"] = blockdiag_e2e_check()
    out["f32_mesh"] = small_crosssilo_check("blockdiag")
    out["launches"] = launches
    return out


# -- phase 4d: the cross-silo paradigm ------------------------------------------

# bench.py's cross-silo configuration (bench.py:101-131): full
# participation, resident data, the grouped schedule's bucket_groups=6, the
# packed mesh's 2 lanes; and the weak-scaling points (bench.py:980-1008)
CROSSSILO_BUCKET_GROUPS = 6
WEAK_SCALING_SILOS = (8, 16)


@functools.lru_cache(maxsize=None)
def silo_data(silos: int):
    """``silos`` silos of the flagship's records each (1562, hetero, seed 0);
    32 is the flagship's federation."""
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    if silos == 32:
        return flagship_data()
    return make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, silos, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)


def crosssilo_api(ds, api_cls=None, mesh=None, **config):
    """The flagship under the cross-silo paradigm (``CrossSiloFedAvgAPI`` or
    ``api_cls``) on one rank (``mesh``, or the process group's): every silo
    every round, the data resident."""
    from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI

    base = dict(client_num_in_total=ds.num_clients, client_num_per_round=ds.num_clients,
                device_data="on", bucket_groups=CROSSSILO_BUCKET_GROUPS, rounds_per_step=1)
    return flagship_api(api_cls=api_cls or CrossSiloFedAvgAPI, ds=ds, mesh=mesh,
                        **{**base, **config})


def crosssilo_steps(api) -> int:
    """The steps one round of a cross-silo API executes on this rank: the
    packed mesh's steps where one of its lanes is live, else every client's
    live steps."""
    from fedml_tpu_torch.parallel.packed import executed_steps, rank_plan

    pm = api._packed_mesh
    if pm is not None:
        return len(executed_steps(rank_plan(pm["plan"], api.mesh.world_size,
                                            api.mesh.rank).live))
    return api.round_counts(0)[1] // api.config.batch_size


def crosssilo_arm(api, tag: str, smi: str, timed: int = 2) -> dict:
    """One warm-up round, then ``timed`` rounds ending in a host sync: real
    and padded images/s, rounds/s, K1 and K2 launches (57 + 57 a step) and
    one replay a step over the timed rounds, finite losses; then a profile of
    5 steps (packed: of two silos' first 5 batches in the two lanes)."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    t = time.perf_counter()
    warm = float(api.run_round(0))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    steps = crosssilo_steps(api) * timed
    bn.reset_launches()
    r0 = sum(p.replays for p in step_programs(api))
    t = time.perf_counter()
    losses = [api.run_round(r) for r in range(1, timed + 1)]
    losses = [float(x) for x in losses]          # the host sync
    dt = time.perf_counter() - t
    launches = dict(bn.LAUNCHES)
    replayed = sum(p.replays for p in step_programs(api)) - r0
    counts = [api.round_counts(r) for r in range(1, timed + 1)]
    real, padded = sum(c[0] for c in counts), sum(c[1] for c in counts)
    rec = {"schedule": ("packed mesh" if api._packed_mesh is not None else
                        "grouped" if api._group_plan is not None else "resident"),
           "silos": api.dataset.num_clients, "warmup_round_s": warm_s, "warmup_loss": warm,
           "losses": losses, "seconds": dt, "round_s": dt / timed, "rounds_per_s": timed / dt,
           "real_images": real, "padded_images": padded, "real_images_per_s": real / dt,
           "padded_images_per_s": padded / dt, "steps": steps, "replays": replayed,
           "launches": launches}
    if api._group_plan is not None:
        rec["groups"] = [(len(i), int(b)) for i, b in api._group_plan]
    if api._packed_mesh is not None:
        rec["plan"] = {"lanes": api._packed_mesh["plan"].n_lanes, "T": api._packed_mesh["plan"].T}
    log(f"{tag} {rec['schedule']}, {rec['silos']} silos: warm-up round {warm_s:.2f} s; "
        f"{timed} rounds in {dt:.3f} s: {rec['rounds_per_s']:.4f} rounds/s, "
        f"{rec['real_images_per_s']:.1f} real images/s ({rec['padded_images_per_s']:.1f} "
        f"padded), losses {losses}; {steps} steps, {replayed} replays, launches {launches}; {smi}")
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"{tag} a loss is not finite: {[warm] + losses}")
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {launches[k]} times over {timed} rounds; "
                                 f"expected {BNS_PER_STEP} x {steps} steps")
    if replayed != steps:
        raise AssertionError(f"{tag} {replayed} replays for {steps} steps")
    prof = packed_step_profile(api) if api._packed_mesh is not None else step_profile(api)
    for k, v in prof["kernels_by_name"].items():
        if v != BNS_PER_STEP * prof["live_steps"]:
            raise AssertionError(f"{tag} the profile counts {v} {k} over {prof['live_steps']} "
                                 f"steps; expected {BNS_PER_STEP} a step")
    log(f"{tag} 5-step profile: wall {prof['wall_ms_per_step']:.2f} ms, device "
        f"{prof['device_ms_per_step']:.3f} ms a step (busy {prof['device_busy_share']:.3f}), "
        f"{prof['host_launches_per_step']:.1f} host launches a step; {smi}")
    rec["step_profile"] = prof
    return rec


def small_crosssilo_check(packed_conv: str = "off") -> dict:
    """The small CifarResNet (widths 8/16/16, 8x8 images, 4 silos, 2
    epochs) in f32 on the card: one packed mesh round and one resident
    mesh round against the simulation round from the same weights and
    orders, by the relative global norm of the parameters' difference
    (bound 1e-5, tests/test_crosssilo.py:40). Under a joint lowering
    (``packed_conv`` not "off"), the packed mesh round alone, against the
    simulation's packed round under the same lowering."""
    from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "xsilo-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    base = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
                comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED,
                device_data="on", packed_conv=packed_conv)
    joint = packed_conv != "off"

    def bundle():
        return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                      bn_impl="pallas"), (8, 8, 3))

    sim = FedAvgAPI(ds, FedConfig(**base, pack_lanes=PACK_LANES if joint else 0), bundle())
    init = {k: v.clone() for k, v in sim.variables.items()}
    loss_sim = float(sim.run_round(0))
    want = split_params(sim.variables)[0]
    out = {"packed_conv": packed_conv, "loss_simulation": loss_sim}
    arms = (("packed", dict(pack_lanes=PACK_LANES)),) + (() if joint else (("resident", {}),))
    for label, kw in arms:
        cs = CrossSiloFedAvgAPI(ds, FedConfig(**base, **kw), bundle())
        if cs._packed_mesh is not None and \
                cs._packed_mesh["round_fn"].lanes.packed_conv != packed_conv:
            raise AssertionError(f"[crosssilo] the packed mesh does not run {packed_conv}")
        cs.variables = {k: v.clone() for k, v in init.items()}
        loss = float(cs.run_round(0))
        rel = float(tree_global_norm(tree_sub(split_params(cs.variables)[0], want))
                    / tree_global_norm(want))
        out[label] = {"loss": loss, "rel_norm": rel}
        if not rel < 1e-5 or not abs(loss - loss_sim) <= 1e-5 * abs(loss_sim):
            raise AssertionError(f"[crosssilo] f32 {label} mesh round {rel:.3g} (relative norm) "
                                 f"from the simulation round, loss {loss} vs {loss_sim}")
    log(f"[crosssilo] f32 mesh rounds ({packed_conv}) on the card against the simulation "
        f"round: {out}")
    return out


def nccl_one_rank_check(ds, smi: str) -> dict:
    """One packed mesh round of ``ds`` under a world-size-1 NCCL process
    group (a ``file://`` store in a temporary directory, no network) against
    the same round without a group, from the same weights: bit for bit. The
    round's all-reduce (its flat buffer) profiled under the group (the
    host's ``nccl:all_reduce`` record, the device's NCCL records) and timed
    by CUDA events, with the group and without one."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType

    from fedml_tpu_torch.parallel.crosssilo import all_reduce_flat
    from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh, init_multihost

    plain = crosssilo_api(ds, pack_lanes=PACK_LANES)
    init = {k: v.clone() for k, v in plain.variables.items()}
    loss_plain = float(plain.run_round(0))
    want = {k: v.clone() for k, v in plain.variables.items()}
    del plain
    tmp = tempfile.mkdtemp(prefix="nccl-store-")
    try:
        init_multihost(f"file://{tmp}/store", 1, 0, timeout_s=120)
        mesh = client_mesh()
        if mesh.group is None or mesh.world_size != 1:
            raise AssertionError(f"[crosssilo nccl] the mesh has no one-rank group: {mesh}")
        api = crosssilo_api(ds, mesh=mesh, pack_lanes=PACK_LANES)
        api.variables = {k: v.clone() for k, v in init.items()}
        loss = float(api.run_round(0))
        differ = [k for k, v in want.items() if not torch.equal(api.variables[k], v)]
        if differ or loss != loss_plain:
            raise AssertionError(f"[crosssilo nccl] the NCCL round differs from the group-less "
                                 f"round: loss {loss} vs {loss_plain}, tensors {differ[:6]}")
        buf = [v.float() for v in api.variables.values()]
        _, events = profiled(lambda: all_reduce_flat(mesh, buf), "one-rank NCCL all-reduce")
        host = sorted({e.name for e in events if e.device_type == DeviceType.CPU
                       and ("nccl" in e.name.lower() or "allreduce" in e.name.replace("_", ""))})
        device = sorted({e.name for e in events if e.device_type == DeviceType.CUDA
                         and "nccl" in e.name.lower()})
        if not any("allreduce" in n.replace("_", "") for n in host):
            raise AssertionError(f"[crosssilo nccl] the profile holds no NCCL all-reduce: {host}")
        # the round's tail collective, timed: the flat buffer's assembly and
        # the one call, under the group and without one
        tail_ms = {"nccl": cuda_time_ms(lambda: all_reduce_flat(mesh, buf), iters=20),
                   "no_group": cuda_time_ms(lambda: all_reduce_flat(
                       ClientMesh(1, 0, None, mesh.device), buf), iters=20)}
        backend = dist.get_backend()
        del api
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"silos": ds.num_clients, "backend": backend, "loss": loss, "bit_identical": True,
           "host_nccl_records": host, "device_nccl_kernels": device,
           "buffer_floats": sum(b.numel() for b in buf), "all_reduce_flat_ms": tail_ms}
    log(f"[crosssilo nccl] one packed mesh round under a world-size-1 {backend} group equals "
        f"the group-less round bit for bit (loss {loss}); its all-reduce of "
        f"{rec['buffer_floats']} floats: host {host}, device kernels {device}; "
        f"all_reduce_flat {tail_ms['nccl']:.4f} ms under the group, {tail_ms['no_group']:.4f} "
        f"ms without; {smi}")
    return rec


def phase_train_crosssilo(smi: str) -> dict:
    """Phase 4d: bench.py's cross-silo configuration on one rank, arms (a)
    packed mesh, (b) grouped, (c) resident, (d) FedOpt-adam on (a), (e) (a)
    at 8 and 16 silos with the fit T(c) = a + b*c; the f32 gate, the
    world-size-1 NCCL gate, FedOpt's server state on the card."""
    import gc

    import torch

    from fedml_tpu_torch.algorithms.fedopt import CrossSiloFedOptAPI
    from fedml_tpu_torch.core.optim import state_tensors

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}
    arms = (("a-packed", None, dict(pack_lanes=PACK_LANES), 2),
            ("b-grouped", None, dict(pack_lanes=0), 2),
            ("c-resident", None, dict(pack_lanes=0, bucket_groups=1), 2),
            ("d-fedopt-adam", CrossSiloFedOptAPI,
             dict(pack_lanes=PACK_LANES, server_optimizer="adam", server_lr=ZOO_SERVER_LR), 1))
    expect = {"a-packed": "packed mesh", "b-grouped": "grouped", "c-resident": "resident",
              "d-fedopt-adam": "packed mesh"}
    for label, cls, cfg, timed in arms:
        tag = f"[crosssilo {label}]"
        t0 = time.perf_counter()
        api = crosssilo_api(silo_data(32), cls, **cfg)
        torch.cuda.synchronize()
        log(f"{tag} set-up {time.perf_counter() - t0:.1f} s")
        rec = crosssilo_arm(api, tag, smi, timed)
        if rec["schedule"] != expect[label]:
            raise AssertionError(f"{tag} ran the {rec['schedule']} schedule")
        if cls is CrossSiloFedOptAPI:
            tensors, counts = state_tensors(api.server_state["opt"])
            if not all(t.is_cuda for t in tensors + counts) or \
                    not any(bool(t.abs().max() > 0) for t in tensors):
                raise AssertionError(f"{tag} the server state is not on the card, or zero")
            rec["server_state_abs_max"] = max(float(t.abs().max()) for t in tensors)
            rec["server_state_count"] = [int(c) for c in counts]
            log(f"{tag} server state on the card, |max| {rec['server_state_abs_max']:.4g}, "
                f"count {rec['server_state_count']}")
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][label] = rec
        del api
        free()
    scaling = {32: out["arms"]["a-packed"]}
    for silos in WEAK_SCALING_SILOS:
        api = crosssilo_api(silo_data(silos), pack_lanes=PACK_LANES)
        scaling[silos] = rec = crosssilo_arm(api, f"[crosssilo e-{silos}-silos]", smi)
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][f"e-packed-{silos}"] = rec
        del api
        free()
    T = {c: r["round_s"] for c, r in scaling.items()}
    b = (T[32] - T[8]) / (32 - 8)
    a = T[8] - b * 8
    out["weak_scaling"] = {"round_s": T, "fit_overhead_ms": a * 1e3, "fit_per_silo_ms": b * 1e3,
                           "midpoint_pred_s": a + b * 16,
                           "midpoint_err": abs(a + b * 16 - T[16]) / T[16]}
    log(f"[crosssilo e] T(c) {T}; fit a + b*c through 8 and 32: a {a * 1e3:.1f} ms, b "
        f"{b * 1e3:.2f} ms a silo; at 16 predicted {a + b * 16:.4f} s against {T[16]:.4f} s; "
        f"{smi}")
    out["f32_check"] = small_crosssilo_check()
    out["nccl_one_rank"] = nccl_one_rank_check(silo_data(WEAK_SCALING_SILOS[0]), smi)
    free()
    out["launches"] = launches
    return out


# -- phase 4e: the cross-device paradigm ----------------------------------------

# arm (a): the flagship's host round streamed in sub-cohort chunks of 4
# clients (2 a round), packed in 2 lanes, with the pipeline off and at depth
# 2, and a scheduled arm (speed policy under the population's count prior)
XDEV_CHUNK, XDEV_DEPTH = 4, 2
XDEV_WARM, XDEV_TIMED = 1, 2
# arm (b), bench.py's r05 basis row (bench.py:284-391): stackoverflow LR at
# its 342,477 clients, 50 a round; arm (c), bench.py's fedsched arms
# (bench.py:394-): a million clients, 1,000 a round in 250-client chunks
R05_CLIENTS, R05_COHORT, R05_ROUNDS = 342_477, 50, 3
SCHED_CLIENTS, SCHED_COHORT, SCHED_CHUNK, SCHED_LANES, SCHED_ROUNDS = \
    1_000_000, 1_000, 250, 4, 3
# the f32 chunked-against-unchunked tolerances (tests/test_fedsched.py:35
# and :337)
STREAM_TOL = {"plain": (1e-6, 1e-7), "packed": (1e-5, 1e-6)}


def _rounds(api, first: int, n: int, sync: bool = True) -> tuple:
    """Rounds ``first .. first + n - 1``; ``(losses, seconds)``, the
    seconds ending in a host sync."""
    import torch

    t = time.perf_counter()
    losses = [api.run_round(r) for r in range(first, first + n)]
    losses = [float(x) for x in losses]            # the host sync
    if sync:
        torch.cuda.synchronize()
    return losses, time.perf_counter() - t


def stream_steps(api, rounds) -> int:
    """The packed steps the streamed rounds execute: each chunk's plan's
    steps where some lane is live."""
    from fedml_tpu_torch.parallel.packed import executed_steps, plan_packing

    c = api.config
    total = 0
    for r in rounds:
        sampled, _ = api._round_plan(r)
        counts = np.asarray(api.dataset.train_counts, np.float64)[sampled]
        for start, size in api._stream_chunk_spec(len(sampled)):
            plan = plan_packing(counts[start:start + size], c.batch_size, c.epochs, c.pack_lanes)
            total += 0 if plan is None else len(executed_steps(plan.live))
    return total


def crossdevice_flagship_arm(label: str, smi: str, init: Optional[dict] = None,
                             **config) -> dict:
    """One arm of (a): the flagship's host round, streamed and packed, warm-up
    rounds, then timed rounds ending in a sync; K1/K2 at exactly 57 a packed
    step and one replay a step over the timed rounds; the stage rows."""
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.utils.metrics import round_stats

    tag = f"[crossdevice a {label}]"
    c = dict(device_data="off", stream_aggregate="deterministic", cohort_chunk=XDEV_CHUNK,
             pack_lanes=PACK_LANES, comm_round=XDEV_WARM + XDEV_TIMED, **config)
    api = flagship_api(**c)
    if config.get("cohort_policy", "uniform") != "uniform":
        from fedml_tpu_torch.data.sched import plan_cohort, snapshot_from_counts

        snap = snapshot_from_counts(api.dataset.train_counts)
        api.set_cohort_profiler(snap)
        cfg = api.config
        for r in range(cfg.comm_round):
            want = plan_cohort(r, cfg.client_num_in_total, cfg.client_num_per_round, cfg.seed,
                               cfg.cohort_policy, snap)
            if not np.array_equal(api.sample(r), want):
                raise AssertionError(f"{tag} round {r}: cohort {api.sample(r)} is not the "
                                     f"CPU plan_cohort's {want}")
    if init is not None:
        api.variables = {k: v.clone() for k, v in init.items()}
    if not api.packed_status()["scheduled"] or api._dev_train is not None:
        raise AssertionError(f"{tag} not a streamed packed host round: {api.packed_status()}")
    warm, warm_s = _rounds(api, 0, XDEV_WARM)
    api._stage_rows.clear()
    timed = range(XDEV_WARM, XDEV_WARM + XDEV_TIMED)
    steps = stream_steps(api, timed)
    bn.reset_launches()
    r0 = sum(p.replays for p in trainer_programs(api._stream_packed))
    losses, dt = _rounds(api, XDEV_WARM, XDEV_TIMED)
    launches = dict(bn.LAUNCHES)
    replayed = sum(p.replays for p in trainer_programs(api._stream_packed)) - r0
    real = sum(api.round_counts(r)[0] for r in timed)
    rec = {"arm": label, "config": {k: v for k, v in c.items() if k != "comm_round"},
           "cohorts": [api.sample(r).tolist() for r in timed],
           "warmup_losses": warm, "warmup_s": warm_s, "losses": losses, "seconds": dt,
           "rounds_per_s": XDEV_TIMED / dt, "real_images": real, "real_images_per_s": real / dt,
           "steps": steps, "replays": replayed, "launches": launches,
           "stage": round_stats(api._stage_rows, api.config.host_pipeline_depth),
           "stream_stats": dict(api.stream_stats)}
    log(f"{tag} {XDEV_TIMED} rounds in {dt:.3f} s: {rec['rounds_per_s']:.4f} rounds/s, "
        f"{rec['real_images_per_s']:.1f} real images/s, losses {losses}; {steps} packed steps, "
        f"{replayed} replays, launches {launches}; stages {rec['stage']}; stream "
        f"{rec['stream_stats']}; {smi}")
    if not all(np.isfinite(warm + losses)):
        raise AssertionError(f"{tag} a loss is not finite: {warm + losses}")
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {launches[k]} times; expected "
                                 f"{BNS_PER_STEP} x {steps} executed packed steps")
    if replayed != steps:
        raise AssertionError(f"{tag} {replayed} replays for {steps} packed steps")
    rec["variables"] = {k: v.clone() for k, v in api.variables.items()}
    api.close()
    return rec


def crossdevice_f32_gates(smi: str) -> dict:
    """ResNet-56 at full width in f32 through K1/K2 on a small host-fed
    federation (6 CIFAR-shaped clients of 64 records, batch 16, all six a
    round), from one set of weights: two unchunked streamed rounds (no
    packing) against two batch host rounds, bit for bit; one chunked round
    against one unchunked, plain and packed, at STREAM_TOL (a deep net
    carries one round's fold-order difference into the next many times
    over, so the tolerance holds a round, as tests/test_fedsched.py's does
    for ``lr`` over three); and two rounds in chunks of 4 and 1 clients
    (round 0's second chunk captures its one-lane step while the prefetcher
    builds round 1) at depth 2 against depth 0, bit for bit. cuDNN runs
    its deterministic algorithms here (restored after): its default f32
    wgrad may sum in a run-dependent order, which would part any two
    rounds of this unstable small federation, whatever the fold did."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model

    ds = make_synthetic_classification("xdev-gate", (32, 32, 3), 10, 6, records_per_client=64,
                                       partition_method="hetero", partition_alpha=0.5,
                                       batch_size=16, seed=SEED)
    base = dict(model="resnet56", client_num_in_total=6, client_num_per_round=6,
                batch_size=16, epochs=1, lr=0.1, momentum=0.9, seed=SEED,
                frequency_of_the_test=10_000, device_data="off")
    init = None

    def run(rounds: int = 1, **config):
        nonlocal init
        api = FedAvgAPI(ds, FedConfig(**{**base, "comm_round": rounds, **config}),
                        create_model("resnet56", 10, input_shape=(32, 32, 3), bn_impl="pallas"))
        if init is None:
            init = {k: v.clone() for k, v in api.variables.items()}
        api.variables = {k: v.clone() for k, v in init.items()}
        losses = [float(api.run_round(r)) for r in range(api.config.comm_round)]
        out = (losses, {k: v.clone() for k, v in api.variables.items()}, api.stream_stats)
        api.close()
        return out

    def same(a, b, what):
        if a[0] != b[0] or any(not torch.equal(a[1][k], b[1][k]) for k in a[1]):
            bad = [k for k in a[1] if not torch.equal(a[1][k], b[1][k])]
            raise AssertionError(f"[crossdevice gates] {what}: losses {a[0]} vs {b[0]}, "
                                 f"tensors differ {bad[:6]}")

    def close(a, b, what, tol):
        rtol, atol = tol
        np.testing.assert_allclose(a[0], b[0], rtol=rtol, atol=atol, err_msg=what)
        return max(assert_close(f"{what} {k}", a[1][k], b[1][k], rtol, atol) for k in a[1])

    stream = dict(stream_aggregate="deterministic")
    mid = dict(stream, pack_lanes=PACK_LANES, cohort_chunk=4, client_num_per_round=5)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = run(2)
        same(batch, run(2), "two batch host rounds")
        same(batch, run(2, **stream), "the unchunked streamed rounds against the batch host rounds")
        unchunked = run(**stream)
        err = {"plain": close(run(**stream, cohort_chunk=3), unchunked,
                              "chunked against unchunked (plain)", STREAM_TOL["plain"])}
        packed_one = run(**stream, pack_lanes=PACK_LANES)
        err["packed"] = close(run(**stream, pack_lanes=PACK_LANES, cohort_chunk=3), packed_one,
                              "chunked against unchunked (packed)", STREAM_TOL["packed"])
        serial = run(2, **mid)
        same(serial, run(2, **mid, host_pipeline_depth=XDEV_DEPTH),
             "chunks of 4 and 1 at depth 2 against depth 0")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[crossdevice gates] f32 ResNet-56 on the card: unchunked stream == batch host round "
        f"bit for bit; chunked vs unchunked max |err| {err} (tolerances {STREAM_TOL}); chunks "
        f"4+1 pipelined == serial bit for bit; {smi}")
    return {"stream_equals_batch": True, "pipelined_equals_serial": True,
            "chunked_max_abs_err": err, "tolerance": STREAM_TOL, "losses_batch": batch[0],
            "losses_unchunked": unchunked[0], "losses_packed": packed_one[0],
            "losses_chunks_4_1": serial[0]}


def r05_basis_arm(smi: str) -> dict:
    """(b) bench.py's r05 basis row: ``lr`` on the 342,477-client
    stackoverflow LR task, 50 a round, bf16, async rounds, the pipeline off
    against depth 2: 3 warm-up rounds, ``prime(1, wait=True)``, 3 timed
    rounds. No TPU kernel runs on this path."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.crossdevice import load_stackoverflow_lr_full
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils.metrics import round_stats

    t0 = time.perf_counter()
    ds = load_stackoverflow_lr_full(client_num_in_total=R05_CLIENTS, batch_size=10)
    setup_s = time.perf_counter() - t0

    def measure(depth: int) -> dict:
        cfg = FedConfig(model="lr", dataset="stackoverflow_lr", client_num_in_total=R05_CLIENTS,
                        client_num_per_round=R05_COHORT, comm_round=R05_ROUNDS, batch_size=10,
                        epochs=1, lr=0.05, seed=SEED, frequency_of_the_test=10_000,
                        dtype="bfloat16", async_rounds=True, host_pipeline_depth=depth)
        api = FedAvgAPI(ds, cfg, create_model("lr", ds.class_num,
                                              input_shape=ds.train_x.shape[2:]))
        warm, _ = _rounds(api, 1, R05_ROUNDS)
        api._stage_rows.clear()
        ds.materialized_rows = 0
        pf = api._host_prefetcher()
        if pf is not None:
            pf.prime(1, wait=True)
        r0 = replays(api)
        losses, dt = _rounds(api, 1, R05_ROUNDS)
        real = sum(api.round_counts(r)[0] for r in range(1, R05_ROUNDS + 1))
        row = {"depth": depth, "rounds_per_s": R05_ROUNDS / dt,
               "clients_per_s": R05_ROUNDS * R05_COHORT / dt, "examples_per_s": real / dt,
               "seconds": dt, "materialized_rows": int(ds.materialized_rows),
               "replays": replays(api) - r0, "losses": losses, "warmup_losses": warm,
               "stage": round_stats(api._stage_rows, depth),
               "on_card": all(v.is_cuda for v in api.variables.values())}
        api.close()
        if not (row["on_card"] and row["replays"] > 0 and np.isfinite(warm + losses).all()):
            raise AssertionError(f"[crossdevice b] depth {depth}: {row}")
        return row

    off, on = measure(0), measure(XDEV_DEPTH)
    rec = {"clients_total": R05_CLIENTS, "clients_per_round": R05_COHORT,
           "dataset_setup_s": setup_s, "off": off, "on": on,
           "speedup": on["rounds_per_s"] / off["rounds_per_s"]}
    for row in (off, on):
        log(f"[crossdevice b] r05 basis (lr, no TPU kernel on this path), depth "
            f"{row['depth']}: {row['rounds_per_s']:.4f} rounds/s, {row['clients_per_s']:.2f} "
            f"clients/s, {row['examples_per_s']:.1f} examples/s, {row['materialized_rows']} "
            f"materialized rows, stages {row['stage']}; {smi}")
    log(f"[crossdevice b] pipeline speed-up {rec['speedup']:.3f}x; {smi}")
    return rec


def fedsched_arms(smi: str) -> dict:
    """(c) bench.py's fedsched arms on a million-client synthetic
    federation: ``cohort50_batch``, ``streamed_uniform`` (1,000 a round in
    chunks of 250, 4 lanes) and ``streamed_speed`` (the same under the
    population's count prior). 3 warm-up rounds, then 3 timed rounds. No
    TPU kernel runs on this path."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
    from fedml_tpu_torch.data.sched import snapshot_from_counts
    from fedml_tpu_torch.models import create_model

    t0 = time.perf_counter()
    ds = make_synthetic_crossdevice("xdev-sched", 1024, 32, SCHED_CLIENTS, batch_size=8,
                                    mean_records=12.0, max_records=96, seed=SEED)
    setup_s = time.perf_counter() - t0

    def measure(label, cohort, policy="uniform", streaming=False, snapshot=None) -> dict:
        cfg = FedConfig(model="lr", dataset="xdev-sched", client_num_in_total=SCHED_CLIENTS,
                        client_num_per_round=cohort, comm_round=SCHED_ROUNDS, batch_size=8,
                        epochs=1, lr=0.1, seed=SEED, frequency_of_the_test=10_000,
                        async_rounds=True, cohort_policy=policy,
                        stream_aggregate="deterministic" if streaming else "off",
                        cohort_chunk=SCHED_CHUNK if streaming else 0,
                        pack_lanes=SCHED_LANES if streaming else 0)
        api = FedAvgAPI(ds, cfg, create_model("lr", ds.class_num, input_shape=(1024,)))
        if snapshot is not None:
            api.set_cohort_profiler(snapshot)
        warm, _ = _rounds(api, 1, SCHED_ROUNDS)
        trainer = api._stream_packed if streaming else api._local_train
        r0 = sum(p.replays for p in trainer_programs(trainer))
        losses, dt = _rounds(api, 1, SCHED_ROUNDS)
        real = sum(api.round_counts(r)[0] for r in range(1, SCHED_ROUNDS + 1))
        row = {"arm": label, "clients_per_round": cohort, "policy": policy,
               "rounds_per_s": SCHED_ROUNDS / dt, "clients_per_s": SCHED_ROUNDS * cohort / dt,
               "examples_per_s": real / dt, "seconds": dt, "losses": losses,
               "replays": sum(p.replays for p in trainer_programs(trainer)) - r0,
               "stream": None if api.stream_stats is None else dict(api.stream_stats)}
        api.close()
        if not (row["replays"] > 0 and np.isfinite(warm + losses).all()):
            raise AssertionError(f"[crossdevice c] {label}: {row}")
        log(f"[crossdevice c] {label} (lr, no TPU kernel on this path): "
            f"{row['clients_per_s']:.2f} clients/s, {row['examples_per_s']:.1f} examples/s, "
            f"{row['rounds_per_s']:.4f} rounds/s; stream {row['stream']}; {smi}")
        return row

    basis = measure("cohort50_batch", 50)
    uniform = measure("streamed_uniform", SCHED_COHORT, streaming=True)
    speed = measure("streamed_speed", SCHED_COHORT, "speed", True,
                    snapshot_from_counts(ds.train_counts, 1.0))
    model_bytes = (1024 * 32 + 32) * 4 + 8
    for row in (uniform, speed):
        if row["stream"]["accumulator_bytes"] != model_bytes or row["stream"]["chunks"] != 4:
            raise AssertionError(f"[crossdevice c] {row['arm']}: stream {row['stream']}, "
                                 f"expected 4 chunks and {model_bytes} accumulator bytes")
    return {"clients_total": SCHED_CLIENTS, "dataset_setup_s": setup_s,
            "arms": [basis, uniform, speed],
            "policy_uplift_clients_per_s": speed["clients_per_s"] / uniform["clients_per_s"],
            "accumulator_bytes": model_bytes}


def phase_train_crossdevice(smi: str) -> dict:
    """Phase 4e: (a) the flagship's streamed and packed host round through
    K1/K2, the pipeline at depth 0 and 2 and the speed policy at depth 2,
    with the f32 gates; (b) bench.py's r05 basis row; (c) its fedsched
    arms."""
    import gc

    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"arms": {}}
    launches = {"bn_fwd": 0, "bn_bwd": 0}
    serial = crossdevice_flagship_arm("depth-0", smi)
    free()
    piped = crossdevice_flagship_arm(f"depth-{XDEV_DEPTH}", smi, init=None,
                                     host_pipeline_depth=XDEV_DEPTH)
    free()
    differ = [k for k in serial["variables"]
              if not torch.equal(serial["variables"][k], piped["variables"][k])]
    if differ or serial["losses"] != piped["losses"]:
        raise AssertionError(f"[crossdevice a] the pipelined rounds differ from the serial ones: "
                             f"losses {piped['losses']} vs {serial['losses']}, tensors "
                             f"{differ[:6]}")
    speed = crossdevice_flagship_arm(f"speed-depth-{XDEV_DEPTH}", smi,
                                     host_pipeline_depth=XDEV_DEPTH, cohort_policy="speed")
    free()
    for rec in (serial, piped, speed):
        rec.pop("variables")
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][rec["arm"]] = rec
    out["pipeline_speedup"] = piped["rounds_per_s"] / serial["rounds_per_s"]
    log(f"[crossdevice a] the pipelined rounds equal the serial rounds bit for bit; pipeline "
        f"speed-up {out['pipeline_speedup']:.3f}x; {smi}")
    out["f32_gates"] = crossdevice_f32_gates(smi)
    free()
    out["r05_basis"] = r05_basis_arm(smi)
    free()
    out["fedsched"] = fedsched_arms(smi)
    free()
    out["launches"] = launches
    return out


# -- phase 13: the entry point and the training loop ---------------------------

# (a) the README quickstart, then FedOpt-adam on it with checkpoints, straight
# and stopped at round 2 and resumed; (b) the launcher at the flagship's
# widths (the CIFAR-10 stand-in: no files); (c) the flagship's packed bf16
# train() through K1/K2, straight twice and resumed
QUICKSTART = ("--algorithm fedavg --dataset synthetic_1_1 --model lr --client_num_in_total 30 "
              "--client_num_per_round 10 --comm_round 50 --batch_size 10 --lr 0.3")
QUICKSTART_FEDOPT = "--algorithm fedopt --server_optimizer adam --server_lr 0.01 --comm_round 4"
LAUNCH_FLAGSHIP = ("--algorithm fedavg --dataset cifar10 --model resnet56 "
                   "--client_num_in_total 32 --client_num_per_round 8 --batch_size 64 --lr 0.1 "
                   "--momentum 0.9 --comm_round 3 --frequency_of_the_test 1")
LOOP_ROUNDS, LOOP_HALF = 4, 2


def _ckpt_differ(a: str, b: str) -> list:
    """The leaves (variables, then server state) in which two checkpoint
    files differ, or their round indices if those differ."""
    import torch

    from fedml_tpu_torch.utils.checkpoint import load_checkpoint

    ca, cb = load_checkpoint(a), load_checkpoint(b)
    if ca["round_idx"] != cb["round_idx"]:
        return [f"round_idx {ca['round_idx']} != {cb['round_idx']}"]

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in leaves(v, f"{path}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{path}/{i}")]
        return [] if tree is None else [(path, tree)]

    la = leaves({"variables": ca["variables"], "server_state": ca["server_state"]})
    lb = leaves({"variables": cb["variables"], "server_state": cb["server_state"]})
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["the trees differ"]
    return [p for (p, x), (_, y) in zip(la, lb) if x.dtype != y.dtype or not torch.equal(x, y)]


def launcher_quickstart(smi: str, tmp: str) -> dict:
    """(a): the README quickstart through ``experiments.run.main`` on the
    card; then the same line as FedOpt-adam for 4 rounds with checkpoints
    every 2 rounds, straight, and stopped at round 2 and resumed from its
    ``latest.ckpt``: the two final checkpoints equal bit for bit."""
    import os

    from fedml_tpu_torch.experiments.run import main as launch
    from fedml_tpu_torch.ops import batchnorm as bn

    tag = "[loop a]"
    bn.reset_launches()
    t0 = time.perf_counter()
    h = launch(QUICKSTART.split())
    wall = time.perf_counter() - t0
    rec = {"argv": QUICKSTART, "Test/Acc": h["Test/Acc"], "Test/Loss": h["Test/Loss"],
           "rounds_per_sec": h["rounds_per_sec"], "timing": h["timing"], "call_s": wall}
    log(f"{tag} quickstart: final Test/Acc {h['Test/Acc'][-1]:.4f}, Test/Loss "
        f"{h['Test/Loss'][-1]:.4f} after {len(h['Test/Acc'])} evals; rounds_per_sec "
        f"{h['rounds_per_sec']}; timing {h['timing']}; main() {wall:.2f} s; {smi}")
    if not (np.isfinite(h["Test/Loss"]).all() and h["Test/Acc"][-1] > 0.5):
        raise AssertionError(f"{tag} the quickstart did not learn: Test/Acc {h['Test/Acc']}")
    base = QUICKSTART.split()[2:] + QUICKSTART_FEDOPT.split()
    d_full, d_half, d_res = (os.path.join(tmp, n) for n in ("a-full", "a-half", "a-resumed"))
    runs = {}
    for name, extra in (
            ("straight", ["--checkpoint_dir", d_full, "--checkpoint_frequency", "2"]),
            ("first_half", ["--comm_round", "2", "--checkpoint_dir", d_half,
                            "--checkpoint_frequency", "2"]),
            ("resumed", ["--resume_from", os.path.join(d_half, "latest.ckpt"),
                         "--checkpoint_dir", d_res, "--checkpoint_frequency", "2"])):
        hh = launch(base + extra)
        runs[name] = {"round": hh["round"], "Test/Acc": hh["Test/Acc"],
                      "rounds_per_sec": hh["rounds_per_sec"], "timing": hh["timing"]}
    differ = _ckpt_differ(os.path.join(d_full, "latest.ckpt"), os.path.join(d_res, "latest.ckpt"))
    rec["fedopt"] = runs
    rec["fedopt_resume_differ"] = differ
    log(f"{tag} FedOpt-adam 4 rounds straight {runs['straight']['round']} / "
        f"{runs['straight']['Test/Acc']}; resumed at 2: {runs['resumed']['round']} / "
        f"{runs['resumed']['Test/Acc']}; final checkpoints differ in {differ or 'nothing'}")
    if differ:
        raise AssertionError(f"{tag} the resumed FedOpt run's final state differs from the "
                             f"uninterrupted run's: {differ[:6]}")
    if runs["resumed"]["Test/Acc"] != runs["straight"]["Test/Acc"][-len(runs["resumed"]["round"]):]:
        raise AssertionError(f"{tag} the resumed eval rounds differ: {runs}")
    if sum(bn.LAUNCHES.values()):
        raise AssertionError(f"{tag} lr launched BN kernels: {bn.LAUNCHES}")
    return rec


def launcher_flagship(smi: str, tmp: str) -> dict:
    """(b): the launcher at the flagship's widths on the CIFAR-10 stand-in
    (160 records a client): the launcher's bundle (plain BatchNorm, f32, as
    the JAX launcher's), so no K1/K2 launch; real images/s over the timed
    train phase, Test/Acc per round, the checkpoint's bytes."""
    import os

    from fedml_tpu_torch.core.config import add_args, config_from_args
    from fedml_tpu_torch.data.sched import CohortScheduler
    from fedml_tpu_torch.experiments import _load
    from fedml_tpu_torch.experiments.run import main as launch
    from fedml_tpu_torch.ops import batchnorm as bn

    tag = "[loop b]"
    ckdir = os.path.join(tmp, "b")
    argv = LAUNCH_FLAGSHIP.split() + ["--checkpoint_dir", ckdir, "--checkpoint_frequency", "3"]
    bn.reset_launches()
    h = launch(argv)
    launches = dict(bn.LAUNCHES)
    cfg = config_from_args(add_args().parse_args(LAUNCH_FLAGSHIP.split()[2:]))
    ds = _load(cfg)
    sched = CohortScheduler(cfg.cohort_policy, cfg.seed, cfg.client_num_in_total,
                            cfg.client_num_per_round)
    real = int(sum(ds.train_counts[sched.sample(r)].sum() for r in range(cfg.comm_round)))
    t = h["timing"]
    ck_bytes = os.path.getsize(os.path.join(ckdir, "latest.ckpt"))
    rec = {"argv": LAUNCH_FLAGSHIP, "dataset": ds.name, "n_pad": int(ds.train_x.shape[1]),
           "round": h["round"], "Test/Acc": h["Test/Acc"], "Test/Loss": h["Test/Loss"],
           "timing": t, "real_images": real,
           "real_images_per_s": real / t["time/train_s"], "checkpoint_bytes": ck_bytes,
           "launches": launches}
    log(f"{tag} {ds.name}, ResNet-56 f32 plain BN: Test/Acc per round {h['Test/Acc']}; "
        f"{real} real images in {t['time/train_s']} s of train phase: "
        f"{rec['real_images_per_s']:.1f} real images/s, {h['rounds_per_sec']} rounds/s; "
        f"checkpoint {ck_bytes} bytes; K1/K2 {launches}; {smi}")
    if h["round"] != [0, 1, 2] or not np.isfinite(h["Test/Loss"]).all():
        raise AssertionError(f"{tag} history {h}")
    if sum(launches.values()):
        raise AssertionError(f"{tag} the launcher's ResNet-56 launched BN kernels: {launches}")
    return rec


def packed_steps(api, rounds) -> int:
    """The executed packed steps (some lane live) of the API's rounds."""
    from fedml_tpu_torch.parallel.packed import executed_steps

    total = 0
    for r in rounds:
        plan = api._masked_packed_plan(*api._round_plan(r))
        total += 0 if plan is None else len(executed_steps(plan.live))
    return total


def loop_run(tag: str, smi: str, tmp: str, name: str, **config) -> dict:
    """One flagship ``train()`` (packed, bf16, K1/K2, checkpoints every 2
    rounds): its history, final state, K1/K2 launches (exactly 57 a packed
    step) and, straight, the save and restore times."""
    import gc
    import os

    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    ckdir = os.path.join(tmp, name)
    api = flagship_api(pack_lanes=PACK_LANES, async_rounds=False, frequency_of_the_test=2,
                       checkpoint_frequency=2, checkpoint_dir=ckdir, **config)
    start = 0 if not api.config.resume_from else LOOP_HALF
    steps = packed_steps(api, range(start, api.config.comm_round))
    bn.reset_launches()
    r0 = sum(p.replays for p in trainer_programs(api._packed_train))
    h = api.train()
    launches = dict(bn.LAUNCHES)
    replayed = sum(p.replays for p in trainer_programs(api._packed_train)) - r0
    rec = {"run": name, "round": list(h["round"]), "Test/Acc": list(h["Test/Acc"]),
           "Test/Loss": list(h["Test/Loss"]), "timing": h["timing"], "steps": steps,
           "replays": replayed, "launches": launches,
           "variables": {k: v.clone() for k, v in api.variables.items()},
           "checkpoint_bytes": os.path.getsize(os.path.join(ckdir, "latest.ckpt"))}
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {name}: {k} launched {launches[k]} times; expected "
                                 f"{BNS_PER_STEP} x {steps} executed packed steps")
    if replayed != steps:
        raise AssertionError(f"{tag} {name}: {replayed} replays for {steps} packed steps")
    if name == "straight":
        path = os.path.join(tmp, "timed.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.save(path, LOOP_ROUNDS)
        t1 = time.perf_counter()
        api.restore(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec.update(save_ms=(t1 - t0) * 1e3, restore_ms=(t2 - t1) * 1e3)
    log(f"{tag} {name}: rounds {start}..{api.config.comm_round - 1}, eval rounds {h['round']}, "
        f"Test/Acc {h['Test/Acc']}; {steps} packed steps, {replayed} replays, launches "
        f"{launches}; timing {h['timing']}"
        + (f"; save {rec['save_ms']:.2f} ms, restore {rec['restore_ms']:.2f} ms of a "
           f"{rec['checkpoint_bytes']}-byte checkpoint" if "save_ms" in rec else "") + f"; {smi}")
    del api
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def flagship_loop(smi: str, tmp: str) -> dict:
    """(c): the flagship's packed bf16 train() through K1/K2, 4 rounds
    straight twice, then 2 rounds and 2 more from ``resume_from``. The
    resumed variables must equal the straight ones bit for bit wherever the
    two straight runs agree bit for bit, and the eval rounds must match;
    when the straight runs part, the runs are made again under cuDNN's
    deterministic algorithms."""
    import os

    import torch

    tag = "[loop c]"
    out = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            sub = os.path.join(tmp, f"c-det{int(deterministic)}")
            runs = [loop_run(tag, smi, sub, "straight", comm_round=LOOP_ROUNDS),
                    loop_run(tag, smi, sub, "straight-again", comm_round=LOOP_ROUNDS),
                    loop_run(tag, smi, sub, "first-half", comm_round=LOOP_HALF)]
            runs.append(loop_run(tag, smi, sub, "resumed", comm_round=LOOP_ROUNDS,
                                 resume_from=os.path.join(sub, "first-half", "latest.ckpt")))
        finally:
            torch.backends.cudnn.deterministic = False
        a, b, _, res = runs
        agree = [k for k in a["variables"] if torch.equal(a["variables"][k], b["variables"][k])]
        out = {"cudnn_deterministic": deterministic, "agree": len(agree),
               "tensors": len(a["variables"])}
        if len(agree) == len(a["variables"]) or deterministic:
            break
        log(f"{tag} the two straight runs agree bit for bit in {len(agree)} of "
            f"{len(a['variables'])} tensors; again under cuDNN's deterministic algorithms")
    differ = [k for k in agree if not torch.equal(res["variables"][k], a["variables"][k])]
    n = len(res["round"])
    evals_equal = (res["round"] == a["round"][-n:] and res["Test/Acc"] == a["Test/Acc"][-n:]
                   and res["Test/Loss"] == a["Test/Loss"][-n:])
    out.update(runs=[{k: v for k, v in r.items() if k != "variables"} for r in runs],
               resumed_differ=differ, evals_equal=evals_equal,
               launches={k: sum(r["launches"][k] for r in runs) for k in ("bn_fwd", "bn_bwd")})
    log(f"{tag} straight runs agree in {len(agree)} of {len(a['variables'])} tensors (cuDNN "
        f"deterministic: {out['cudnn_deterministic']}); the resumed run differs from the "
        f"straight one in {differ or 'none'} of those; eval rounds {res['round']} equal: "
        f"{evals_equal}; {smi}")
    if differ or not evals_equal:
        raise AssertionError(f"{tag} the resumed run is not the uninterrupted one: tensors "
                             f"{differ[:6]}, evals {res['round']} {res['Test/Acc']} vs "
                             f"{a['round']} {a['Test/Acc']}")
    if len(agree) != len(a["variables"]):
        raise AssertionError(f"{tag} two straight runs part even under cuDNN's deterministic "
                             f"algorithms ({len(agree)} of {len(a['variables'])} tensors agree)")
    return out


def phase_train_loop(smi: str) -> dict:
    """Phase 13: the command-line entry point and train() with checkpoints
    and resume: (a) the README quickstart and FedOpt-adam resumed, (b) the
    launcher at the flagship's widths, (c) the flagship's packed train()
    through K1/K2 resumed bit for bit."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        out = {"quickstart": launcher_quickstart(smi, tmp),
               "launcher_flagship": launcher_flagship(smi, tmp),
               "flagship_loop": flagship_loop(smi, tmp)}
    out["launches"] = out["flagship_loop"]["launches"]
    return out


# -- phase 14: robust aggregation, hierarchical FL, the silo harness -------------

# the DP noise's standard deviation and the clip bound of the robust arms: the
# bound lies below most of round 0's client update norms on the flagship, so
# it binds on at least half of the clients (on an H100 they read 29.8-43.6
# plain and 27.7-44.6 packed; each arm prints them)
ROBUST_STDDEV = 1e-3
ROBUST_NORM_BOUND = 32.0
ROBUST_POISON_FRAC = 0.5
HIER_GROUPS, HIER_GROUP_ROUNDS = 2, 2
SILO_SILOS, SILO_ROUNDS = 8, 3


def update_norms(gvars: dict, stacked: dict) -> list:
    """Each stacked client's update norm over the weight leaves (the norm
    ``clip_update_by_norm`` bounds), as device scalars."""
    from fedml_tpu_torch.core.aggregation import is_weight_path

    names = [k for k in gvars if is_weight_path(k) and gvars[k].is_floating_point()]
    sq = sum((stacked[k].float() - gvars[k].float()).reshape(stacked[k].shape[0], -1)
             .square().sum(1) for k in names)
    return list(sq.sqrt())


def noise_stats(noisy: dict, clean: dict, stddev: float) -> dict:
    """The noise the server added, ``noisy - clean`` over the float weight
    leaves: its count, mean and standard deviation; and whether every other
    leaf (the BN statistics) is bit-equal to the noise-free aggregate."""
    import torch

    from fedml_tpu_torch.core.aggregation import is_weight_path

    names = [k for k in clean if is_weight_path(k) and clean[k].is_floating_point()]
    d = torch.cat([(noisy[k].float() - clean[k].float()).reshape(-1) for k in names])
    others = [k for k in clean if k not in names]
    return {"n": d.numel(), "mean": float(d.mean()), "std": float(d.std()),
            "stats_leaves": len(others),
            "stats_bit_equal": all(torch.equal(noisy[k], clean[k]) for k in others)}


def robust_probe_cls():
    """``FedAvgRobustAPI`` that records, without changing what it computes,
    each client's update norm before the clip and the noise of each
    aggregate: in ``aggregate`` on the plain round, in the hooks on the
    packed one."""
    from fedml_tpu_torch.algorithms.robust import FedAvgRobustAPI
    from fedml_tpu_torch.core.aggregation import robust_aggregate

    class RobustProbe(FedAvgRobustAPI):
        def __init__(self, *a, **kw):
            self.norms, self.noise = [], []
            super().__init__(*a, **kw)

        def aggregate(self, variables, stacked, counts, infos, rng, server_state):
            c = self.config
            self.norms.append(update_norms(variables, stacked))
            clean = robust_aggregate(variables, stacked, counts, norm_bound=c.norm_bound)
            noisy, state = super().aggregate(variables, stacked, counts, infos, rng,
                                             server_state)
            self.noise.append(noise_stats(noisy, clean, c.stddev))
            return noisy, state

        def crosssilo_hooks(self):
            hooks = super().crosssilo_hooks()
            transform, update = hooks["client_transform"], hooks["server_update"]
            member_norms = []

            def client_transform(gvars, stacked):
                member_norms.extend(update_norms(gvars, stacked))
                return transform(gvars, stacked)

            def server_update(vars0, agg, extras, total, server_state, rng):
                noisy, state = update(vars0, agg, extras, total, server_state, rng)
                self.norms.append(list(member_norms))
                member_norms.clear()
                self.noise.append(noise_stats(noisy, agg, self.config.stddev))
                return noisy, state

            return dict(client_transform=client_transform, server_update=server_update)

    return RobustProbe


def robust_arm(label: str, smi: str, packed: bool) -> dict:
    """FedAvg-robust on the flagship (attacker 0 poisons half its records,
    the clip at ``ROBUST_NORM_BOUND``, noise ``ROBUST_STDDEV``), 2 rounds,
    plain or packed in 2 lanes: finite losses, 57 K1 + 57 K2 and one replay
    an executed step, none in the evaluation; the bound binds on at least
    half of round 0's clients; each round's noise over the ~0.86 M weight
    floats within 5 sigma/sqrt(n) of mean 0 and 2% of the standard
    deviation, the BN statistics bit-equal to the noise-free aggregate;
    the backdoor's success on the triggered test set."""
    from fedml_tpu_torch.parallel.packed import executed_steps

    tag = f"[robust {label}]"
    cfg = dict(norm_bound=ROBUST_NORM_BOUND, stddev=ROBUST_STDDEV,
               poison_frac=ROBUST_POISON_FRAC)
    if packed:
        cfg.update(pack_lanes=PACK_LANES, packed_conv="off")
    api = flagship_api(api_cls=robust_probe_cls(), ds=flagship_data(), **cfg)
    if api.packed_status()["scheduled"] != packed:
        raise AssertionError(f"{tag} packed_status {api.packed_status()}")
    rounds = range(api.config.comm_round)
    if packed:
        steps = sum(len(executed_steps(api._packed_plan(api.sample(r)).live)) for r in rounds)
    else:
        steps = sum(api.round_counts(r)[1] // api.config.batch_size for r in rounds)
    rounds_rec, metrics, eval_s, trained, after_eval = run_rounds(api, tag, smi, replayed=steps)
    check_bn_launches(tag, trained, after_eval, steps)
    norms = [[float(x) for x in r] for r in api.norms]
    clipped = [sum(x > ROBUST_NORM_BOUND for x in r) for r in norms]
    if len(norms) != len(rounds) or 2 * clipped[0] < len(norms[0]):
        raise AssertionError(f"{tag} norm_bound {ROBUST_NORM_BOUND} binds on {clipped} of the "
                             f"clients; update norms {norms}")
    for r, st in enumerate(api.noise):
        bound = 5 * ROBUST_STDDEV / st["n"] ** 0.5
        if (not abs(st["mean"]) <= bound or not abs(st["std"] - ROBUST_STDDEV)
                <= 0.02 * ROBUST_STDDEV or not st["stats_bit_equal"]):
            raise AssertionError(f"{tag} round {r} noise {st}: mean within {bound:.3g} of 0, "
                                 f"std within 2% of {ROBUST_STDDEV}, statistics untouched")
    backdoor = api.evaluate_backdoor()
    train_s = sum(r["seconds"] for r in rounds_rec)
    rec = {"packed": packed, "steps": steps, "rounds": rounds_rec, "eval": metrics,
           "update_norms": norms, "clipped": clipped, "norm_bound": ROBUST_NORM_BOUND,
           "noise": api.noise, "backdoor": backdoor, "launches": after_eval,
           "real_images_per_s": sum(r["real_images"] for r in rounds_rec) / train_s}
    log(f"{tag} update norms {[[round(x, 4) for x in r] for r in norms]}; the bound "
        f"{ROBUST_NORM_BOUND} clips {clipped}; noise {api.noise}; backdoor {backdoor}; "
        f"{rec['real_images_per_s']:.1f} real images/s; {smi}")
    return rec


def check_bn_launches(tag: str, trained: dict, after_eval: dict, steps: int) -> None:
    for k in ("bn_fwd", "bn_bwd"):
        if trained[k] != BNS_PER_STEP * steps or after_eval[k] != trained[k]:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds and "
                                 f"{after_eval[k] - trained[k]} in the evaluation; expected "
                                 f"{BNS_PER_STEP} x {steps} steps and 0")
    if any(trained[k] for k in ("conv_fwd", "conv_wgrad")):
        raise AssertionError(f"{tag} launched a lanes conv kernel: {trained}")


def hierarchical_arm(label: str, smi: str, groups: int, mesh: bool) -> dict:
    """Hierarchical FL on the flagship's federation (8 clients a round, the
    host round), ``HIER_GROUP_ROUNDS`` group rounds a round, 2 rounds: the
    simulator at ``groups`` groups, or the one-rank mesh (``groups`` 1):
    finite losses, 57 K1 + 57 K2 and one replay a step (every group round's
    live steps), none in the evaluation."""
    from fedml_tpu_torch.algorithms.hierarchical import (CrossSiloHierarchicalFedAvgAPI,
                                                         HierarchicalFedAvgAPI)

    tag = f"[hierarchical {label}]"
    cls = CrossSiloHierarchicalFedAvgAPI if mesh else HierarchicalFedAvgAPI
    api = flagship_api(api_cls=cls, ds=flagship_data(), group_num=groups,
                       group_comm_round=HIER_GROUP_ROUNDS)
    rounds = range(api.config.comm_round)
    steps = HIER_GROUP_ROUNDS * sum(api.round_counts(r)[1] // api.config.batch_size
                                    for r in rounds)
    rounds_rec, metrics, eval_s, trained, after_eval = run_rounds(api, tag, smi, replayed=steps)
    check_bn_launches(tag, trained, after_eval, steps)
    train_s = sum(r["seconds"] for r in rounds_rec)
    return {"groups": groups, "group_rounds": HIER_GROUP_ROUNDS, "mesh": mesh,
            "mesh_shape": api.mesh.shape if mesh else None, "steps": steps,
            "rounds": rounds_rec, "eval": metrics, "launches": after_eval,
            "real_images_per_s": sum(r["real_images"] for r in rounds_rec) / train_s}


def silo_arm(smi: str, tmp: str) -> dict:
    """SiloFedAvg on the 8-silo federation (flagship widths, bf16, packed in
    2 lanes), ``SILO_ROUNDS`` rounds with the global patience 2 and the
    per-client exit (patience 1): finite losses, 57 K1 + 57 K2 and one
    replay an executed packed step (exited clients' spans frozen), none in
    the global or the per-client evaluations; ``model_best.ckpt`` restored
    bit-equal to the variables it saved."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.silo import SiloRunner
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl
    from fedml_tpu_torch.parallel.packed import executed_steps
    from fedml_tpu_torch.utils.checkpoint import load_checkpoint

    tag = "[silo fedavg]"

    class Counted(FedAvgAPI):
        steps = 0

        def run_round(self, round_idx):
            plan = self._masked_packed_plan(*self._round_plan(round_idx))
            self.steps += len(executed_steps(plan.live))
            return super().run_round(round_idx)

    class Runner(SiloRunner):
        saved = {}

        def _save(self, name, round_idx, extra=None):
            super()._save(name, round_idx, extra)
            self.saved[name] = {k: v.detach().clone() for k, v in self.api.variables.items()}

    ds = silo_data(SILO_SILOS)
    cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=SILO_SILOS,
                    client_num_per_round=SILO_SILOS, comm_round=SILO_ROUNDS, batch_size=64,
                    epochs=1, lr=0.1, momentum=0.9, dtype="bfloat16", frequency_of_the_test=1,
                    seed=SEED, pack_lanes=PACK_LANES, device_data="on")
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:], dtype=torch.bfloat16,
                          bn_impl="pallas")
    runner = Runner(ds, cfg, api_cls=Counted, bundle=bundle, patience=2, model_dir=tmp,
                    client_patience=1)
    bn.reset_launches()
    cl.reset_launches()
    r0 = replays(runner.api)
    t = time.perf_counter()
    hist = runner.train()
    dt = time.perf_counter() - t
    launches = {**bn.LAUNCHES, **cl.LAUNCHES}
    steps, replayed = runner.api.steps, replays(runner.api) - r0
    exits = {k: v for k, v in hist.items() if k.endswith("stopped_round")}
    log(f"{tag} {len(hist['round'])} rounds in {dt:.2f} s (evaluations included): losses "
        f"{hist['GLOBAL/Train/Loss']}, Test/Acc {hist['GLOBAL/Test/Acc']}, best round "
        f"{hist['best_round']}, exits {exits}; {steps} steps, {replayed} replays, launches "
        f"{launches}; {smi}")
    if not np.all(np.isfinite(hist["GLOBAL/Train/Loss"])):
        raise AssertionError(f"{tag} a loss is not finite: {hist['GLOBAL/Train/Loss']}")
    if replayed != steps:
        raise AssertionError(f"{tag} {replayed} replays for {steps} steps")
    check_bn_launches(tag, launches, launches, steps)
    best = load_checkpoint(os.path.join(tmp, "model_best.ckpt"))
    if best["round_idx"] != hist["best_round"]:
        raise AssertionError(f"{tag} model_best.ckpt holds round {best['round_idx']}, the best "
                             f"round is {hist['best_round']}")
    runner.api.restore(os.path.join(tmp, "model_best.ckpt"))
    saved = runner.saved["model_best.ckpt"]
    differ = [k for k, v in saved.items() if not (torch.equal(runner.api.variables[k], v)
                                                   and torch.equal(best["variables"][k], v.cpu()))]
    if differ:
        raise AssertionError(f"{tag} the restored model_best.ckpt differs from the variables it "
                             f"saved: {differ[:6]}")
    real = sum(int(ds.train_counts.sum()) for _ in hist["round"])
    return {"silos": SILO_SILOS, "rounds": hist["round"], "history": {
        k: v for k, v in hist.items() if k.startswith("GLOBAL") or k.endswith("stopped_round")
        or k.startswith("best")}, "steps": steps, "launches": launches, "seconds": dt,
        "best_restored_bit_equal": True,
        # the rounds' wall time with the global and per-client evaluations
        "real_images_per_s": real / dt}


def robust_hier_f32_checks() -> dict:
    """The f32 gates on a small CifarResNet through K1/K2 (widths 8/16/16,
    8x8 images, 4 clients, 2 epochs, TF32 off), each pair from the same
    weights, sharing the server generator: (a) the packed robust round
    (clip, noise, poison) against the plain one at the zoo phase's packed
    bound (variables rtol 1e-4 / atol 1e-5, loss rtol 1e-5); (b) the
    one-rank robust mesh, packed and resident, and (c) the one-rank
    hierarchical mesh (G = 1, 2 group rounds) against their simulations
    within 1e-5 (relative norm, tests/test_crosssilo.py:40); (d)
    hierarchical FL with one group round (G = 2) against FedAvg's host
    round within the end-to-end bound."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.hierarchical import (CrossSiloHierarchicalFedAvgAPI,
                                                         HierarchicalFedAvgAPI)
    from fedml_tpu_torch.algorithms.robust import CrossSiloFedAvgRobustAPI, FedAvgRobustAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "robust-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    base = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=3,
                comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED)
    robust = dict(norm_bound=0.5, stddev=ROBUST_STDDEV, poison_frac=ROBUST_POISON_FRAC,
                  device_data="on")

    def make(cls, **kw):
        return cls(ds, FedConfig(**{**base, **kw}), ModelBundle(
            "cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"), (8, 8, 3)))

    def rel(a, b):
        pa, pb = split_params(a.variables)[0], split_params(b.variables)[0]
        return float(tree_global_norm(tree_sub(pa, pb)) / tree_global_norm(pb))

    def pair(ref, other):
        other.variables = {k: v.clone() for k, v in ref.variables.items()}
        return float(ref.run_round(0)), float(other.run_round(0))

    out = {}
    plain, packed = make(FedAvgRobustAPI, **robust), make(FedAvgRobustAPI, **robust, pack_lanes=2)
    loss_u, loss_p = pair(plain, packed)
    worst = 0.0
    for k, v in plain.variables.items():
        worst = max(worst, assert_close(f"robust packed {k}", packed.variables[k], v, 1e-4, 1e-5))
    if not abs(loss_p - loss_u) <= 1e-5 * abs(loss_u):
        raise AssertionError(f"[robust] f32 packed loss {loss_p} vs plain {loss_u}")
    out["packed_vs_plain"] = {"loss_plain": loss_u, "loss_packed": loss_p, "max_abs_err": worst}
    full = dict(robust, client_num_per_round=4)
    for label, kw in (("packed", dict(pack_lanes=2)), ("resident", {})):
        sim, mesh = make(FedAvgRobustAPI, **full), make(CrossSiloFedAvgRobustAPI, **full, **kw)
        loss_s, loss_m = pair(sim, mesh)
        out[f"robust_mesh_{label}"] = {"loss_sim": loss_s, "loss_mesh": loss_m,
                                       "rel_norm": rel(mesh, sim)}
    hier = dict(client_num_per_round=4, group_num=1, group_comm_round=2)
    sim, mesh = make(HierarchicalFedAvgAPI, **hier), make(CrossSiloHierarchicalFedAvgAPI, **hier)
    loss_s, loss_m = pair(sim, mesh)
    out["hierarchical_mesh"] = {"loss_sim": loss_s, "loss_mesh": loss_m, "rel_norm": rel(mesh, sim)}
    for label in ("robust_mesh_packed", "robust_mesh_resident", "hierarchical_mesh"):
        r = out[label]
        if not r["rel_norm"] < 1e-5 or not abs(r["loss_mesh"] - r["loss_sim"]) <= \
                1e-5 * abs(r["loss_sim"]):
            raise AssertionError(f"[robust/hierarchical] f32 {label} one-rank mesh round {r}")
    one = dict(client_num_per_round=4, device_data="off")
    flat, hier1 = make(FedAvgAPI, **one), make(HierarchicalFedAvgAPI, **one, group_num=2)
    loss_f, loss_h = pair(flat, hier1)
    share = 0.0
    for k, v in flat.variables.items():
        d, ref = (hier1.variables[k].float() - v.float()).abs(), v.float().abs()
        share = max(share, float((d / (E2E_ATOL + E2E_RTOL * ref)).max()))
    out["hierarchical_gr1_vs_fedavg"] = {"loss_fedavg": loss_f, "loss_hierarchical": loss_h,
                                         "share_of_bound": share, "rel_norm": rel(hier1, flat)}
    if not share <= 1.0 or not abs(loss_h - loss_f) <= E2E_LOSS_RTOL * abs(loss_f):
        raise AssertionError(f"[hierarchical] one group round outside the end-to-end bound of "
                             f"FedAvg: {out['hierarchical_gr1_vs_fedavg']}")
    log(f"[robust/hierarchical] f32 gates on the card: {out}")
    return out


def phase_train_robust(smi: str) -> dict:
    """Phase 14: robust aggregation, hierarchical FL and the silo harness on
    the flagship (ResNet-56, ``bn_impl="pallas"``, bf16, batch 64), through
    K1/K2, profiled nowhere: FedAvg-robust plain and packed, hierarchical
    at G = 2 and the one-rank mesh at G = 1, SiloFedAvg on 8 silos, FedAvg
    packed on the same federation for its images/s; the f32 gates."""
    import gc
    import tempfile

    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}

    def add(label, rec):
        out["arms"][label] = rec
        for k in launches:
            launches[k] += rec["launches"][k]
        free()

    add("fedavg-packed", fedavg_packed_arm(smi))
    add("robust-plain", robust_arm("plain", smi, packed=False))
    add("robust-packed", robust_arm("packed", smi, packed=True))
    add("hierarchical-g2", hierarchical_arm("G=2", smi, HIER_GROUPS, mesh=False))
    add("hierarchical-mesh-g1", hierarchical_arm("one-rank mesh G=1", smi, 1, mesh=True))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_silo_") as tmp:
        add("silo-fedavg", silo_arm(smi, tmp))
    out["f32_checks"] = robust_hier_f32_checks()
    free()
    out["launches"] = launches
    log("[robust] real images/s (silo's with its evaluations): " + ", ".join(
        f"{k} {v['real_images_per_s']:.1f}" for k, v in out["arms"].items()) + f"; {smi}")
    return out


def fedavg_packed_arm(smi: str) -> dict:
    """FedAvg packed in 2 lanes on the flagship, 2 rounds: the yardstick
    beside the robust arms' images/s."""
    from fedml_tpu_torch.parallel.packed import executed_steps

    tag = "[robust fedavg-packed]"
    api = flagship_api(ds=flagship_data(), pack_lanes=PACK_LANES, packed_conv="off")
    steps = sum(len(executed_steps(api._packed_plan(api.sample(r)).live))
                for r in range(api.config.comm_round))
    rounds_rec, metrics, eval_s, trained, after_eval = run_rounds(api, tag, smi, replayed=steps)
    check_bn_launches(tag, trained, after_eval, steps)
    train_s = sum(r["seconds"] for r in rounds_rec)
    return {"steps": steps, "rounds": rounds_rec, "eval": metrics, "launches": after_eval,
            "real_images_per_s": sum(r["real_images"] for r in rounds_rec) / train_s}


# -- phase 15: gossip (DSGD, PushSum, the one-rank mesh), streaming FedAvg, TurboAggregate --

# the gossip arms' federation: the flagship's recipe at 16 nodes (~25 steps
# a node a round); every node trains every round
GOSSIP_NODES = 16
# TurboAggregate's aggregate against the plain weighted mean of the same
# client states (tests/test_turboaggregate.py:105's bound)
TURBO_ATOL = 1e-4


def gossip_data():
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    return make_synthetic_classification(
        "cifar10-bench-16", (32, 32, 3), 10, GOSSIP_NODES, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)


def turbo_probe_cls():
    """``TurboAggregateAPI`` that also takes the plain weighted mean of the
    same client states (``core/pytree.tree_weighted_mean``) and records,
    each round, the secure aggregate's largest distance from it over the
    floats that did not wrap beside ``mpc_stats``; what it computes is
    unchanged."""
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
    from fedml_tpu_torch.core.pytree import tree_stack, tree_weighted_mean

    class TurboProbe(TurboAggregateAPI):
        def __init__(self, *a, **kw):
            self.mpc_rounds = []
            super().__init__(*a, **kw)

        def secure_aggregate(self, client_vars, wn):
            import torch

            out = super().secure_aggregate(client_vars, wn)
            plain = tree_weighted_mean(tree_stack(list(client_vars)), torch.as_tensor(wn))
            err = 0.0
            for k in out:
                d = (out[k].double() - plain[k].double()).abs()
                if k in self.wrapped:
                    d = d[~self.wrapped[k].to(d.device)]
                err = max(err, float(d.max()) if d.numel() else 0.0)
            self.mpc_rounds.append(dict(self.mpc_stats, max_abs_err_vs_plain_mean=err))
            return out

    return TurboProbe


def zoo_arm(label: str, smi: str, api, on_round=None, eval_finite: bool = True) -> dict:
    """2 rounds of one of phase 15's APIs (the first with its capture), then
    the evaluation: finite losses, 57 K1 + 57 K2 and one replay a live step,
    none in the evaluation; real images/s and steps a round."""
    tag = f"[zoo gossip/stream/turbo {label}]"
    bs = api.config.batch_size
    steps_per_round = [api.round_counts(r)[1] // bs for r in range(api.config.comm_round)]
    steps = sum(steps_per_round)
    rounds_rec, metrics, eval_s, trained, after_eval = run_rounds(
        api, tag, smi, replayed=steps, on_round=on_round, eval_finite=eval_finite)
    check_bn_launches(tag, trained, after_eval, steps)
    train_s = sum(r["seconds"] for r in rounds_rec)
    return {"steps_per_round": steps_per_round, "steps": steps, "rounds": rounds_rec,
            "eval": metrics, "eval_s": eval_s, "launches": after_eval,
            "real_images_per_s": sum(r["real_images"] for r in rounds_rec) / train_s}


def gossip_arm(label: str, smi: str, mode: str, mesh: bool) -> dict:
    """(a)-(c): DSGD or PushSum on the 16 nodes over the symmetric topology
    (``neighbor_num=2``), the simulator or the one-rank mesh without a
    process group. PushSum's mass must stay N (rtol 1e-5) every round. The
    mix's CUDA-event ms on the final node state (``mix_stacked``: one f32
    product over the flat [16, 860,026] view), the consensus distance and
    node 0's evaluation."""
    import torch

    from fedml_tpu_torch.algorithms.decentralized import (DecentralizedFedAPI,
                                                          MeshDecentralizedFedAPI)
    from fedml_tpu_torch.parallel.gossip import mix_stacked

    api = flagship_api(api_cls=MeshDecentralizedFedAPI if mesh else DecentralizedFedAPI,
                       ds=gossip_data(), api_kw={"mode": mode},
                       client_num_in_total=GOSSIP_NODES, client_num_per_round=GOSSIP_NODES)
    if mesh and (api.mesh.world_size != 1 or api.mesh.group is not None):
        raise AssertionError(f"[gossip {label}] not the group-less one-rank mesh: {api.mesh}")

    def mass(api, r):
        total = float(api.ps_weights.sum())
        if mode == "pushsum" and not abs(total - GOSSIP_NODES) <= 1e-5 * GOSSIP_NODES:
            raise AssertionError(f"[gossip {label}] round {r}: PushSum mass {total}, not "
                                 f"{GOSSIP_NODES}")
        w = api.ps_weights
        return {"ps_weights_sum": total, "ps_weights_min": float(w.min()),
                "ps_weights_max": float(w.max())}

    rec = zoo_arm(label, smi, api, on_round=mass)
    rec["mix_ms"] = cuda_time_ms(lambda: mix_stacked(api.node_vars, api.W), iters=10,
                                 repeats=3, warmup=2)
    rec.update(mode=mode, mesh=mesh, nodes=GOSSIP_NODES,
               consensus_distance=api.consensus_distance(), node0_eval=api.evaluate_node(0),
               topology_degree=[int(x) for x in (api.W > 0).sum(0).tolist()])
    log(f"[gossip {label}] steps a round {rec['steps_per_round']}, "
        f"{rec['real_images_per_s']:.1f} real images/s, mix {rec['mix_ms']:.4f} ms (events), "
        f"consensus distance {rec['consensus_distance']:.6g}, node 0 {rec['node0_eval']}, "
        f"mass {[r['ps_weights_sum'] for r in rec['rounds']]}; {smi}")
    del api
    torch.cuda.empty_cache()
    return rec


def native_batches_check(ds) -> dict:
    """The native batcher is the one that runs (``native.available()``),
    and its batches equal the Python form's on client 0's round-0 orders:
    the real-first order of each epoch cut to its live steps, as the
    streamed round feeds it."""
    import torch

    from fedml_tpu_torch import native
    from fedml_tpu_torch.core.rng import client_generator
    from fedml_tpu_torch.parallel.local import real_first

    if not native.available():
        raise AssertionError("[stream] the native host pipeline is not available")
    x, _, mask = ds.client_arrays(0)
    bs = 64
    steps = -(-int(ds.train_counts[0]) // bs)
    g = client_generator(SEED, 0, 0)
    order = real_first(torch.randperm(len(mask), generator=g),
                       torch.from_numpy(np.array(mask)))[:steps * bs].numpy()[None]
    forms = [native.HostPipeline(x, None, bs, orders=order, native=n) for n in (True, False)]
    try:
        for _ in range(2 * steps):
            a, b = (p.next_batch()[0] for p in forms)
            if not np.array_equal(a, b):
                raise AssertionError("[stream] native and Python batches differ")
    finally:
        for p in forms:
            p.close()
    return {"available": True, "batches_compared": 2 * steps, "equal": True}


def stream_arm(label: str, smi: str, mode: str, depth: int) -> dict:
    """(d)/(e): StreamingFedAvgAPI on the flagship (32 clients, 8 a round),
    ``stream_aggregate`` ``mode``, the round pipeline at ``depth``: its
    ``stream_stats`` and the stage rows beside the arm's images/s."""
    from fedml_tpu_torch.algorithms.streaming_fedavg import StreamingFedAvgAPI

    api = flagship_api(api_cls=StreamingFedAvgAPI, ds=flagship_data(), stream_aggregate=mode,
                       host_pipeline_depth=depth)
    try:
        rec = zoo_arm(label, smi, api, on_round=lambda a, r: {"stream_stats": a.stream_stats})
    finally:
        api.close()
    rec.update(mode=mode, depth=depth, stream_stats=api.stream_stats,
               stage_rows=list(api._stage_rows))
    log(f"[stream {label}] steps a round {rec['steps_per_round']}, "
        f"{rec['real_images_per_s']:.1f} real images/s, stream_stats {api.stream_stats}, "
        f"stages {rec['stage_rows']}; {smi}")
    return rec


def turbo_arm(smi: str) -> dict:
    """(f): TurboAggregateAPI on the flagship (32 clients, 8 a round): the
    host MPC's ms a round, its largest |x * w| and total beside the field's
    limit, the floats that wrapped (by leaf), and its distance from the
    plain weighted mean of the same client states over the others, which
    must be within ``TURBO_ATOL``. A wrapped float is the JAX package's
    arithmetic too (the field holds totals below ~1024 at 20 fractional
    bits); the evaluation's loss must be finite unless a float wrapped."""
    api = flagship_api(api_cls=turbo_probe_cls(), ds=flagship_data())
    rec = zoo_arm("turboaggregate", smi, api, eval_finite=False,
                  on_round=lambda a, r: {"mpc": a.mpc_rounds[-1]})
    mpc = api.mpc_rounds
    rec["mpc_rounds"] = mpc
    log(f"[turbo] steps a round {rec['steps_per_round']}, {rec['real_images_per_s']:.1f} real "
        f"images/s, MPC {[round(m['mpc_ms'], 1) for m in mpc]} ms a round over "
        f"{mpc[0]['floats']} floats x {mpc[0]['clients']} clients, max |x*w| "
        f"{[m['max_abs_xw'] for m in mpc]} and max |total| {[m['max_abs_total'] for m in mpc]} "
        f"against the field's {mpc[0]['field_limit']:.6g}: wrapped "
        f"{[(m['wrapped_floats'], m['wrapped_leaves']) for m in mpc]}; max |secure - plain "
        f"mean| elsewhere {[m['max_abs_err_vs_plain_mean'] for m in mpc]}; evaluation "
        f"{rec['eval']}; {smi}")
    worst = max(m["max_abs_err_vs_plain_mean"] for m in mpc)
    if not worst <= TURBO_ATOL:
        raise AssertionError(f"[turbo] the secure aggregate lies {worst} from the plain mean "
                             f"where nothing wrapped, above {TURBO_ATOL}")
    if not np.isfinite(rec["eval"]["loss"]) and not any(m["wrapped_floats"] for m in mpc):
        raise AssertionError(f"[turbo] evaluation {rec['eval']} with no wrapped float")
    return rec


def zoo_gossip_f32_gates(smi: str) -> dict:
    """The f32 gates on a small CifarResNet through K1/K2 (widths 8/16/16,
    8x8 images, 4 clients, 2 epochs), TF32 off and cuDNN's deterministic
    algorithms on (restored after), as phase 4e's: (1) the one-rank mesh
    round equal to the simulator round bit for bit, DSGD and PushSum, 2
    rounds; (2) the streamed round (``off``) equal to FedAvg's host round
    bit for bit, 2 rounds (the host round on the whole record axis,
    ``bucket_quantum_batches=0``); (3) ``deterministic`` within rtol 1e-6 /
    atol 1e-7 of ``off`` over a round (tests/test_fedsched.py:35); (4)
    TurboAggregate's aggregate within ``TURBO_ATOL`` of the plain weighted
    mean of the same client states, 2 rounds, its largest |x * w| printed
    against the field's ~1024."""
    import torch

    from fedml_tpu_torch.algorithms.decentralized import (DecentralizedFedAPI,
                                                          MeshDecentralizedFedAPI)
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.streaming_fedavg import StreamingFedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "gossip-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    base = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
                comm_round=2, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED)

    def make(cls, **kw):
        extra = {k: kw.pop(k) for k in ("mode",) if k in kw}
        return cls(ds, FedConfig(**{**base, **kw}), ModelBundle(
            "cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"), (8, 8, 3)),
            **extra)

    def rounds(api, n):
        return [float(api.run_round(r)) for r in range(n)]

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("dsgd", "pushsum"):
            sim, mesh = make(DecentralizedFedAPI, mode=mode), make(MeshDecentralizedFedAPI,
                                                                   mode=mode)
            mesh.variables = {k: v.clone() for k, v in sim.variables.items()}
            mesh.init_nodes()
            ls, lm = rounds(sim, 2), rounds(mesh, 2)
            differ = [k for k, v in sim.node_vars.items() if not torch.equal(mesh.node_vars[k], v)]
            if ls != lm or differ or not torch.equal(sim.ps_weights, mesh.ps_weights):
                raise AssertionError(f"[gossip gates] {mode}: one-rank mesh {lm} vs simulator "
                                     f"{ls}; node leaves differ {differ[:6]}")
            out[f"mesh_equals_sim_{mode}"] = {"losses": ls, "bit_equal": True}
        host_kw = dict(client_num_per_round=3, device_data="off", bucket_quantum_batches=0)
        host, streamed = make(FedAvgAPI, **host_kw), make(StreamingFedAvgAPI, **host_kw)
        streamed.variables = {k: v.clone() for k, v in host.variables.items()}
        lh, lst = rounds(host, 2), rounds(streamed, 2)
        differ = [k for k, v in host.variables.items() if not torch.equal(streamed.variables[k], v)]
        if lh != lst or differ:
            raise AssertionError(f"[stream gates] streamed {lst} vs host round {lh}; leaves "
                                 f"differ {differ[:6]}")
        out["stream_equals_host_round"] = {"losses": lh, "bit_equal": True}
        off, det = make(StreamingFedAvgAPI, **host_kw), make(
            StreamingFedAvgAPI, **host_kw, stream_aggregate="deterministic")
        det.variables = {k: v.clone() for k, v in off.variables.items()}
        lo, ld = rounds(off, 1), rounds(det, 1)
        np.testing.assert_allclose(ld, lo, rtol=1e-6, atol=1e-7)
        err = max(assert_close(f"[stream gates] deterministic vs off {k}", det.variables[k], v,
                               1e-6, 1e-7) for k, v in off.variables.items())
        out["deterministic_vs_off"] = {"losses": [lo, ld], "max_abs_err": err,
                                       "stream_stats": det.stream_stats}
        turbo = make(turbo_probe_cls())
        lt = rounds(turbo, 2)
        worst = max(m["max_abs_err_vs_plain_mean"] for m in turbo.mpc_rounds)
        if not worst <= TURBO_ATOL or any(m["wrapped_floats"] for m in turbo.mpc_rounds):
            raise AssertionError(f"[turbo gates] secure aggregate {worst} from the plain mean, "
                                 f"above {TURBO_ATOL}: {turbo.mpc_rounds}")
        out["turbo_vs_plain_mean"] = {"losses": lt, "max_abs_err": worst, "atol": TURBO_ATOL,
                                      "mpc_rounds": turbo.mpc_rounds}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[zoo gossip/stream/turbo gates] f32 on the card: {out}; {smi}")
    return out


def phase_train_zoo_gossip(smi: str) -> dict:
    """Phase 15: decentralized FL (DSGD, PushSum, the one-rank mesh),
    streaming FedAvg (off at depth 0, deterministic at depth 2) and
    TurboAggregate on the flagship (ResNet-56, ``bn_impl="pallas"``, bf16,
    batch 64), through K1/K2, profiled nowhere; the native batcher's check
    and the f32 gates."""
    import gc

    import torch

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}

    def add(label, rec):
        out["arms"][label] = rec
        for k in launches:
            launches[k] += rec["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()

    add("dsgd", gossip_arm("(a) DSGD", smi, "dsgd", mesh=False))
    add("pushsum", gossip_arm("(b) PushSum", smi, "pushsum", mesh=False))
    add("dsgd-mesh", gossip_arm("(c) DSGD one-rank mesh", smi, "dsgd", mesh=True))
    out["native"] = native_batches_check(flagship_data())
    add("stream-off", stream_arm("(d) off, depth 0", smi, "off", 0))
    add("stream-deterministic", stream_arm("(e) deterministic, depth 2", smi, "deterministic", 2))
    add("turboaggregate", turbo_arm(smi))
    out["f32_checks"] = zoo_gossip_f32_gates(smi)
    out["launches"] = launches
    log("[zoo gossip/stream/turbo] real images/s: " + ", ".join(
        f"{k} {v['real_images_per_s']:.1f}" for k, v in out["arms"].items()) + f"; {smi}")
    return out


# -- phase 16: FedGKT (resnet8 / resnet56_server) and FedSeg (deeplab_lite, unet) --

# train-mode BNs a step, each one K1 and one K2 launch: GKT's client (stem + 3
# blocks of 2) and server (two stages of 9 blocks, 2 a block, plus each
# stage's projection); deeplab_lite (stem 1, stages 4 + 5 + 5, ASPP 1) and
# unet (7 conv blocks of 2)
GKT_BNS = {"client": 7, "server": 38}
SEG_BNS = {"deeplab_lite": 16, "unet": 14}
# the FedSeg federation: the synthetic blob task at 32 x 32, 4 classes
SEG_DATA = dict(num_clients=16, records_per_client=128, image_size=32, num_classes=4,
                batch_size=16, seed=SEED)
# GKT's f32 gate (K1/K2 against the plain BN over one CI-depth round):
# client features and server logits, relative norm. The round runs at lr
# 0.01: at lr 0.1 it is chaotic (on the CPU, two plain BNs that differ
# only in their op order ended 9e-7 or 1.4e-2 apart in server logits as the
# thread count changed; at lr 0.01, 2e-7 to 1.4e-6: tests/torch_gkt_seg_chaos.py)
GKT_BN_GATE = 1e-4
GKT_GATE_LR = 0.01


def gkt_api(ds, bn_impl: str = "pallas", blocks: tuple = (3, 9), dtype: str = "bfloat16",
            **config):
    """FedGKT on ``ds``: resnet8 / resnet56_server (or ``blocks``), every
    client every round, epochs 1 and epochs_server 1, nesterov SGD at lr
    0.1, batch 64."""
    import torch

    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models.gkt import create_gkt_pair

    base = dict(model="resnet56", dataset="cifar10", client_num_in_total=ds.num_clients,
                client_num_per_round=ds.num_clients, comm_round=3, batch_size=64, epochs=1,
                epochs_server=1, lr=0.1, dtype=dtype, frequency_of_the_test=10_000, seed=SEED)
    cfg = FedConfig(**{**base, **config})
    pair = create_gkt_pair(ds.class_num, tuple(ds.train_x.shape[2:]), *blocks,
                           dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                           bn_impl=bn_impl)
    return FedGKTAPI(ds, cfg, pair)


def kernel_bns(module) -> int:
    """The BatchNorms of ``module`` that launch K1/K2 in train mode."""
    from fedml_tpu_torch.models.norm import PallasBatchNorm

    return sum(isinstance(m, PallasBatchNorm) and m.use_kernel for m in module.modules())


def gkt_capture_gate(api, kind: str) -> dict:
    """One step of GKT's ``kind`` program on its first batch (client 0's, or
    the union's), captured against its eager body twice, each from the same
    state: when the eager steps repeat bit for bit, the captured one must
    equal them; else it may be no farther from the first than the second
    is. The state is put back after."""
    import torch

    prog = api.program(kind)
    if kind == "client":
        api._load_client(0)
        src = (api._x[0], api._y[0], api._mask[0], api.server_logits[0])
    else:
        n = api.C * api.n_pad
        src = (api._feats.view((n,) + api.pair.feature_shape), api._y.view(n),
               api._mask.view(n), api._clogits.view(n, -1))
    for s, dst in zip(src, prog.inputs):
        dst.copy_(s[:dst.shape[0]])
    saved = [t.detach().clone() for t in prog.state()]

    def step(fn):
        with torch.no_grad():
            for t, v in zip(prog.state(), saved):
                t.copy_(v)
        loss = fn()
        torch.cuda.synchronize()
        return {"loss": loss.detach().clone(),
                **{f"state/{i}": t.detach().clone() for i, t in enumerate(prog.state())}}

    # the gate's launches and replay count no step of the rounds
    replays, launches = prog.replays, dict(bn_counts())
    captured = step(prog)
    e1, e2 = step(lambda: prog.body(*prog.inputs)), step(lambda: prog.body(*prog.inputs))
    step(lambda: torch.zeros(()))                       # the state back
    prog.replays = replays
    bn_counts().update(launches)

    tag = f"[gkt capture {kind}]"
    rec = _capture_verdict(tag, e1, e2, captured)
    log(f"{tag} one step, eager vs captured: {rec['verdict']} ({rec})")
    return rec


def bn_counts() -> dict:
    from fedml_tpu_torch.ops import batchnorm as bn

    return bn.LAUNCHES


def gkt_arm(smi: str) -> dict:
    """(a): FedGKT on the flagship's federation at full depth, bf16 through
    K1/K2. Round 0 with its captures, then 2 timed rounds (each phase ending
    in a sync): 7 K1 + 7 K2 a client step and 38 a server step, one replay a
    step, none in the extraction, logits or evaluation passes; real images/s,
    client and server phase ms, n_pad, the union's bytes, peak memory,
    Test/Acc and the losses; captured = eager for one step of each program;
    a 5-step profile of the server step."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl

    tag = "[train gkt/seg (a) FedGKT]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = gkt_api(flagship_data())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bns = {"client": kernel_bns(api.pair.client.module),
           "server": kernel_bns(api.pair.server.module)}
    if bns != GKT_BNS:
        raise AssertionError(f"{tag} the pair has {bns} kernel BNs, not {GKT_BNS}")
    steps_c, steps_s = api.round_steps()
    closs, sloss = api.run_round(0)                       # with the captures
    torch.cuda.synchronize()
    bn.reset_launches()
    cl.reset_launches()
    r0 = {k: p.replays for k, p in api.programs.items()}
    rounds = []
    for r in (1, 2):
        t = time.perf_counter()
        closs = api.client_phase(r)
        torch.cuda.synchronize()
        tc = time.perf_counter()
        sloss = api.server_phase(r)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        rec = {"round": r, "client_ms": (tc - t) * 1e3, "server_ms": (ts - tc) * 1e3,
               "seconds": ts - t, "client_loss": float(closs.mean()),
               "server_loss": float(sloss)}
        if not (np.isfinite(rec["client_loss"]) and np.isfinite(rec["server_loss"])):
            raise AssertionError(f"{tag} round {r}: non-finite losses {rec}")
        rounds.append(rec)
        log(f"{tag} round {r}: client phase {rec['client_ms']:.1f} ms, server phase "
            f"{rec['server_ms']:.1f} ms, losses {rec['client_loss']:.4f} / "
            f"{rec['server_loss']:.4f}")
    trained = dict(bn.LAUNCHES)
    replayed = {k: p.replays - r0[k] for k, p in api.programs.items()}
    want = 2 * (GKT_BNS["client"] * steps_c + GKT_BNS["server"] * steps_s)
    if any(trained[k] != want for k in ("bn_fwd", "bn_bwd")) or any(cl.LAUNCHES.values()):
        raise AssertionError(f"{tag} launched {trained} (lanes {dict(cl.LAUNCHES)}) over 2 "
                             f"rounds; expected 2 x (7 x {steps_c} + 38 x {steps_s}) = {want}")
    if replayed != {"client": 2 * steps_c, "server": 2 * steps_s}:
        raise AssertionError(f"{tag} replays {replayed}; expected one a step: "
                             f"{2 * steps_c} client, {2 * steps_s} server")
    t = time.perf_counter()
    sums = api.evaluate()
    eval_s = time.perf_counter() - t
    if dict(bn.LAUNCHES) != trained:
        raise AssertionError(f"{tag} the evaluation launched BN kernels: {bn.LAUNCHES}")
    acc = sums["correct"] / max(sums["count"], 1.0)
    loss = sums["loss_sum"] / max(sums["count"], 1.0)
    if not (np.isfinite(loss) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"{tag} evaluation {sums}")
    peak = torch.cuda.max_memory_allocated()
    real = int(np.asarray(api.dataset.train_counts).sum())
    train_s = sum(r["seconds"] for r in rounds)
    gates = {k: gkt_capture_gate(api, k) for k in ("client", "server")}
    prog = api.program("server")
    n = api.C * api.n_pad
    fx = api._feats.view((n,) + api.pair.feature_shape)

    def five_server_steps():
        loss = None
        for s in range(5):
            idx = torch.arange(s * 64, (s + 1) * 64, device=fx.device)
            for src, dst in zip((fx, api._y.view(n), api._mask.view(n),
                                 api._clogits.view(n, -1)), prog.inputs):
                torch.index_select(src, 0, idx, out=dst)
            loss = prog()
        return float(loss)

    profile = _profile(five_server_steps, 5)
    out = {"setup_s": setup_s, "clients": api.C, "n_pad": api.n_pad,
           "union_feature_bytes": api._feats.numel() * api._feats.element_size(),
           "client_steps_per_round": steps_c, "server_steps_per_round": steps_s,
           "rounds": rounds, "real_images_per_round": real,
           "real_images_per_s": 2 * real / train_s, "peak_memory_bytes": peak,
           "eval": {"Test/Acc": acc, "Test/Loss": loss, **sums}, "eval_s": eval_s,
           "launches": trained, "replays": replayed, "capture_gate": gates,
           "server_step_profile": profile}
    log(f"{tag} {steps_c} client + {steps_s} server steps a round, n_pad {api.n_pad}, union "
        f"{out['union_feature_bytes']} B, {out['real_images_per_s']:.1f} real images/s over 2 "
        f"warm rounds, peak {peak / 2**30:.2f} GiB, Test/Acc {acc:.4f}, server step "
        f"{profile['device_ms_per_step']:.3f} ms of device (busy "
        f"{profile['device_busy_share']:.3f}, K1+K2 "
        f"{profile['device_ms_per_step_by_family'].get('bn kernels (K1/K2)', 0.0):.3f} ms); "
        f"{smi}")
    del api, prog
    return out


def seg_arm(label: str, model: str, smi: str) -> dict:
    """(b)/(c): FedSeg of ``model`` (bf16 through K1/K2; unet's convs run in
    f32, as flax promotes them) on the synthetic blob federation, 8 of 16
    clients a round, batch 16. Round 0 with its capture, then 2 timed rounds
    ending in a sync: ``SEG_BNS[model]`` K1 + K2 and one replay a live step,
    none in the evaluation; real images/s, mIoU, FWIoU, the confusion
    total."""
    import torch

    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.segmentation import make_synthetic_segmentation
    from fedml_tpu_torch.models import create_model

    tag = f"[train gkt/seg {label}]"
    ds = make_synthetic_segmentation(**SEG_DATA)
    cfg = FedConfig(model=model, dataset="pascal_voc", client_num_in_total=16,
                    client_num_per_round=8, comm_round=3, batch_size=16, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED)
    kw = {"dtype": torch.bfloat16} if model == "deeplab_lite" else {}
    api = FedSegAPI(ds, cfg, create_model(model, 4, input_shape=(32, 32, 3), bn_impl="pallas",
                                          **kw))
    if kernel_bns(api.bundle.module) != SEG_BNS[model]:
        raise AssertionError(f"{tag} {kernel_bns(api.bundle.module)} kernel BNs, not "
                             f"{SEG_BNS[model]}")
    _rounds(api, 0, 1)                                  # with its capture
    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in (1, 2))
    r0 = replays(api)
    bn_counts().update({"bn_fwd": 0, "bn_bwd": 0})
    losses, train_s = _rounds(api, 1, 2)
    trained = dict(bn_counts())
    scores = api.evaluate_global()
    after = dict(bn_counts())
    want = SEG_BNS[model] * steps
    if (any(trained[k] != want for k in trained) or after != trained
            or replays(api) - r0 != steps or not np.isfinite(losses).all()):
        raise AssertionError(f"{tag} launched {trained} ({after} after the evaluation), "
                             f"{replays(api) - r0} replays, losses {losses}; expected "
                             f"{SEG_BNS[model]} x {steps} steps, one replay each")
    real = sum(api.round_counts(r)[0] for r in (1, 2))
    out = {"model": model, "steps": steps, "losses": losses, "seconds": train_s,
           "real_images_per_s": real / train_s, "eval": scores, "launches": trained}
    log(f"{tag} {steps} steps over 2 warm rounds, {out['real_images_per_s']:.1f} real images/s, "
        f"mIoU {scores['mIoU']:.4f}, FWIoU {scores['FWIoU']:.4f}, confusion total "
        f"{scores['confusion_total']:.0f}; {smi}")
    return out


def gkt_seg_f32_gates(smi: str) -> dict:
    """In f32 with TF32 off and cuDNN's deterministic algorithms: (1) a
    one-rank NCCL ``CrossSiloFedSegAPI`` round (``deeplab_lite`` through
    K1/K2, 4 clients, all of them) within 1e-5 (relative norm) of the
    ``FedSegAPI`` round from the same weights; (2) a GKT round at CI depth
    (client 1 block, server 1 a stage, lr ``GKT_GATE_LR``) with
    ``bn_impl="pallas"`` against the same round with ``"xla"`` from the same
    weights and orders: client features and new server logits within
    ``GKT_BN_GATE`` (relative norm)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.algorithms.fedseg import CrossSiloFedSegAPI, FedSegAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.segmentation import make_synthetic_segmentation
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.mesh import client_mesh, init_multihost

    def rel(a: dict, b: dict) -> float:
        num = sum(float(((a[k].double() - v.double()) ** 2).sum()) for k, v in b.items())
        return (num / max(sum(float((v.double() ** 2).sum()) for v in b.values()), 1e-30)) ** 0.5

    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ds = make_synthetic_segmentation(num_clients=4, records_per_client=16, image_size=32,
                                         num_classes=4, batch_size=8, seed=SEED)
        cfg = FedConfig(model="deeplab_lite", client_num_in_total=4, client_num_per_round=4,
                        comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED)

        def bundle():
            return create_model("deeplab_lite", 4, input_shape=(32, 32, 3), bn_impl="pallas")

        sim = FedSegAPI(ds, cfg, bundle())
        init = {k: v.clone() for k, v in sim.variables.items()}
        loss_sim = float(sim.run_round(0))
        tmp = tempfile.mkdtemp(prefix="nccl-store-")
        try:
            init_multihost(f"file://{tmp}/store", 1, 0, timeout_s=120)
            mesh = CrossSiloFedSegAPI(ds, cfg, bundle(), mesh=client_mesh())
            if mesh.mesh.group is None or mesh.mesh.world_size != 1:
                raise AssertionError(f"[gkt/seg gates] not a one-rank group: {mesh.mesh}")
            mesh.variables = {k: v.clone() for k, v in init.items()}
            loss_mesh = float(mesh.run_round(0))
            backend = dist.get_backend()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
        d = rel(mesh.variables, sim.variables)
        if not d < 1e-5:
            raise AssertionError(f"[gkt/seg gates] the NCCL CrossSiloFedSegAPI round lies {d} "
                                 f"(relative norm) from the FedSegAPI round, above 1e-5")
        out["crosssilo_fedseg_vs_fedseg"] = {"backend": backend, "relative_norm": d,
                                             "losses": [loss_sim, loss_mesh]}
        gds = make_synthetic_classification("gkt-gate", (32, 32, 3), 10, 4,
                                            records_per_client=64, partition_method="hetero",
                                            partition_alpha=0.5, batch_size=16, seed=SEED)
        apis = {b: gkt_api(gds, bn_impl=b, blocks=(1, 1), dtype="float32", batch_size=16,
                           lr=GKT_GATE_LR) for b in ("pallas", "xla")}
        plain = apis["xla"]
        apis["pallas"].client_vars = {k.replace("BatchNorm", "PallasBatchNorm"): v.clone()
                                      for k, v in plain.client_vars.items()}
        apis["pallas"].server_vars = {k.replace("BatchNorm", "PallasBatchNorm"): v
                                      for k, v in plain.server_vars.items()}
        bn_counts().update({"bn_fwd": 0, "bn_bwd": 0})
        for api in apis.values():
            api.run_round(0)
        torch.cuda.synchronize()
        steps_c, steps_s = apis["pallas"].round_steps()
        # CI depth: client stem + 1 block (3 BNs), server 2 projecting blocks (6)
        want = 3 * steps_c + 6 * steps_s
        if bn_counts() != {"bn_fwd": want, "bn_bwd": want}:
            raise AssertionError(f"[gkt/seg gates] the pallas GKT round launched {bn_counts()}, "
                                 f"not 3 x {steps_c} + 6 x {steps_s}")
        gate = {}
        for name in ("_feats", "server_logits"):
            a, b = getattr(apis["pallas"], name), getattr(plain, name)
            gate[name] = float((a.double() - b.double()).norm() / b.double().norm())
        if not all(v <= GKT_BN_GATE for v in gate.values()):
            raise AssertionError(f"[gkt/seg gates] the pallas GKT round lies {gate} (relative "
                                 f"norm) from the plain one, above {GKT_BN_GATE}")
        out["gkt_pallas_vs_xla"] = {"relative_norm": gate, "bound": GKT_BN_GATE,
                                    "client_steps": steps_c, "server_steps": steps_s}
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"[gkt/seg gates] f32 on the card: {out}; {smi}")
    return out


def phase_train_gkt_seg(smi: str) -> dict:
    """Phase 16: FedGKT (a) and FedSeg of deeplab_lite (b) and unet (c),
    bf16 through K1/K2, then the f32 gates (d)."""
    import gc

    import torch

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}
    for label, run in (("gkt", lambda: gkt_arm(smi)),
                       ("deeplab_lite", lambda: seg_arm("(b) deeplab_lite", "deeplab_lite", smi)),
                       ("unet", lambda: seg_arm("(c) unet", "unet", smi))):
        rec = out["arms"][label] = run()
        for k in launches:
            launches[k] += rec["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()
    out["f32_checks"] = gkt_seg_f32_gates(smi)
    out["launches"] = launches
    log("[train gkt/seg] real images/s: " + ", ".join(
        f"{k} {v['real_images_per_s']:.1f}" for k, v in out["arms"].items()) + f"; {smi}")
    return out


# -- phase 17: FedNAS, SplitNN, VFL ---------------------------------------------

# the launcher's full-width DARTS search net (fedml_tpu/experiments/__init__.py:195-196)
FEDNAS_SIZE = dict(channels=16, layers=8, steps=4, multiplier=4)
FEDNAS_BNS = 929
# K1 and K2 a search step at FEDNAS_SIZE (counted on the CPU from the wrapper
# calls): first-order, the alpha step's forward and its backward to the
# alphas (which reaches 829 of the BNs) and the weight step's forward and
# backward; unrolled, the train half's forward, its create_graph backward, the
# validation forward at the unrolled weights and its backward (through both
# forwards' BNs), and the weight step's forward and backward
FEDNAS_LAUNCHES = {False: {"bn_fwd": 2 * FEDNAS_BNS, "bn_bwd": 1758},
                   True: {"bn_fwd": 3 * FEDNAS_BNS, "bn_bwd": 3616}}
# CIFAR-10-shaped clients: 2 of 128 records (2 batches of 64), both every round
FEDNAS_DATA = dict(num_clients=2, records_per_client=128, batch_size=64)
# the gates' search net: the full width at 3 layers (one normal cell, two
# reduction cells: every primitive at stride 1 and 2, 359 BNs)
FEDNAS_GATE_SIZE = dict(FEDNAS_SIZE, layers=3)
FEDNAS_LR = 0.025          # DARTS' weight learning rate
# the f32 gates' bounds (relative norm): one search step through K1/K2 against
# the plain BN. At uniform softmax weights the alpha gradient is a difference of
# nearly equal op contributions: rounding-level changes of every BN move it by
# up to ~1e-2 (two plain BNs, the two-pass variance and the TPU kernel's
# one-pass one, read 1.5e-4 to 9.5e-3 apart on the card), and the alphas after
# an Adam first step count its sign flips (3.6e-2 apart). Those two are held at
# about 3x the largest plain-vs-plain distance seen, the weights and BN
# statistics, well conditioned, at 1e-5.
FEDNAS_GRAD_GATE = 3e-2    # the alpha gradient of each architect
FEDNAS_STATE_GATE = 1e-5   # the weights and BN statistics after the step
FEDNAS_ALPHA_GATE = 1e-1   # the alphas after the step
SECOND_ORDER_GATE = 1e-4   # K1/K2 twice differentiated against the plain BN's
# K1/K2 at the DARTS shapes not in CHECK_SHAPES: the stem (C = 48) at batch 64
# and the unrolled architect's half batches at every width
DARTS_BN_SHAPES = [(65536, 48), (32768, 48), (32768, 16), (8192, 32), (2048, 64)]


def fednas_data(seed: int = SEED, **kw):
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    d = {**FEDNAS_DATA, **kw}
    return make_synthetic_classification("cifar10-shaped", (32, 32, 3), 10, d["num_clients"],
                                         records_per_client=d["records_per_client"],
                                         partition_method="homo", batch_size=d["batch_size"],
                                         seed=seed)


def fednas_api(ds, unrolled: bool, bn_impl: str = "pallas", size: Optional[dict] = None,
               api_cls=None, capture: bool = True, **kw):
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI
    from fedml_tpu_torch.core.config import FedConfig

    cfg = FedConfig(model="darts", dataset="cifar10", client_num_in_total=ds.num_clients,
                    client_num_per_round=ds.num_clients, comm_round=3,
                    batch_size=FEDNAS_DATA["batch_size"],
                    epochs=1, lr=FEDNAS_LR, unrolled=int(unrolled), seed=SEED,
                    frequency_of_the_test=10_000)
    return (api_cls or FedNASAPI)(ds, cfg, **(size or FEDNAS_SIZE), bn_impl=bn_impl,
                                  capture=capture, **kw)


def _fill_batch(api, client: int = 0, start: int = 0) -> None:
    """The step program's static inputs: ``client``'s records from ``start``."""
    import torch

    prog = api.program()
    bs = prog.inputs[0].shape[0]
    for a, dst in zip((api.dataset.train_x, api.dataset.train_y, api.dataset.train_mask),
                      prog.inputs):
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a[client, start:start + bs])))


def fednas_capture_gate(api, tag: str) -> dict:
    """One search step on client 0's first batch from the global state,
    captured against the eager body twice (``_capture_verdict``): weights,
    BN statistics, alphas, both optimizers' states and the loss. Under
    cuDNN's deterministic algorithms the eager steps repeat bit for bit, so
    the captured step must too (cuDNN's default algorithms part two eager
    full-width steps by ~8e-8)."""
    import torch

    prog = api.program()
    replays, launches = prog.replays, dict(bn_counts())

    def step(fn):
        api._load(api.variables, api.alphas)
        _fill_batch(api)
        loss = fn()
        torch.cuda.synchronize()
        return {"loss": loss.detach().clone(),
                **{f"state/{i}": t.detach().clone() for i, t in enumerate(prog.state())}}

    captured = step(prog)
    e1, e2 = step(lambda: prog.body(*prog.inputs)), step(lambda: prog.body(*prog.inputs))
    prog.replays = replays
    bn_counts().update(launches)
    rec = _capture_verdict(tag, e1, e2, captured)
    log(f"{tag} one search step, eager vs captured: {rec['verdict']} ({rec})")
    return rec


def fednas_arm(unrolled: bool, smi: str) -> dict:
    """(a): the full-width search through K1/K2 (f32, bn_impl="pallas") on 2
    CIFAR-10-shaped clients of 2 batches of 64, both every round. Round 0
    with its capture, then 2 timed rounds (1 unrolled) ending in a sync:
    real images/s, one replay and FEDNAS_LAUNCHES K1 + K2 a step, none in
    the evaluation; peak memory; first-order, a one-step profile (busy
    share, K1 + K2 device ms); unrolled, a replay's CUDA-event time.
    Captured = eager is held in (b) (``fednas_step_capture_gate``)."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl

    tag = f"[train fednas/split/vfl (a) {'unrolled' if unrolled else 'first-order'}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = fednas_api(fednas_data(), unrolled)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if kernel_bns(api.module) != FEDNAS_BNS:
        raise AssertionError(f"{tag} {kernel_bns(api.module)} kernel BNs, not {FEDNAS_BNS}")
    bs = api.config.batch_size
    steps = int(sum(-(-int(c) // bs) for c in api.dataset.train_counts))
    t = time.perf_counter()
    api.run_round(0)                                   # with the capture
    torch.cuda.synchronize()
    round0_s = time.perf_counter() - t
    prog = api.program()
    bn.reset_launches()
    cl.reset_launches()
    r0 = prog.replays
    rounds = []
    timed_rounds = (1,) if unrolled else (1, 2)
    for r in timed_rounds:
        t = time.perf_counter()
        loss = float(api.run_round(r))
        rounds.append({"round": r, "seconds": time.perf_counter() - t, "loss": loss})
        if not np.isfinite(loss):
            raise AssertionError(f"{tag} round {r}: loss {loss}")
    log(f"{tag} round 0 with the capture {round0_s:.1f} s, then {rounds}")
    trained = dict(bn.LAUNCHES)
    n_steps = len(timed_rounds) * steps
    want = {k: n_steps * v for k, v in FEDNAS_LAUNCHES[unrolled].items()}
    per_step = dict(prog.launches_per_step[0]) if prog.launches_per_step else None
    if trained != want or any(cl.LAUNCHES.values()) or prog.replays - r0 != n_steps:
        raise AssertionError(f"{tag} launched {trained} (lanes {dict(cl.LAUNCHES)}), "
                             f"{prog.replays - r0} replays over {len(timed_rounds)} round(s) of "
                             f"{steps} steps; "
                             f"expected {want}, one replay a step (the capture recorded "
                             f"{per_step} a step)")
    t = time.perf_counter()
    sums = api.evaluate()
    eval_s = time.perf_counter() - t
    if dict(bn.LAUNCHES) != trained:
        raise AssertionError(f"{tag} the evaluation launched BN kernels: {bn.LAUNCHES}")
    acc = sums["correct"] / max(sums["count"], 1.0)
    if not (np.isfinite(sums["loss_sum"]) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"{tag} evaluation {sums}")
    peak = torch.cuda.max_memory_allocated()
    from fedml_tpu_torch.models.darts import derive_genotype

    genotype = derive_genotype(api.alphas, api.steps_cfg, api.multiplier)

    def one_step():
        _fill_batch(api, 1)
        return float(prog())

    t = time.perf_counter()
    if unrolled:
        # a replay's device time by CUDA events (a profile of its ~183k
        # kernels costs ~25 s late in the script)
        _fill_batch(api, 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        prog()
        end.record()
        torch.cuda.synchronize()
        profile = {"replay_event_ms": start.elapsed_time(end)}
    else:
        profile = _profile(one_step, 1, op_tables=False)
    profile_s = time.perf_counter() - t
    real = int(np.asarray(api.dataset.train_counts).sum())
    train_s = sum(r["seconds"] for r in rounds)
    out = {"unrolled": unrolled, "setup_s": setup_s, "round0_s": round0_s, "rounds": rounds,
           "profile_s": profile_s,
           "steps_per_round": steps, "real_images_per_round": real,
           "real_images_per_s": len(rounds) * real / train_s,
           "ms_per_step": train_s / (len(rounds) * steps) * 1e3,
           "peak_memory_bytes": peak, "eval": {"Test/Acc": acc, **sums}, "eval_s": eval_s,
           "genotype": [list(genotype.normal), list(genotype.reduce)],
           "launches": trained, "launches_per_step": per_step,
           "warmup_launches": prog.warmup_launches, "step_profile": profile}
    if unrolled:
        shown = f"a replay {profile['replay_event_ms']:.2f} ms of CUDA events"
    else:
        fam = profile["device_ms_per_step_by_family"]
        log(f"{tag} a step's device ms by family {fam}")
        shown = (f"a step {profile['device_ms_per_step']:.2f} ms of device, busy "
                 f"{profile['device_busy_share']:.3f}, K1+K2 "
                 f"{fam.get('bn kernels (K1/K2)', 0.0):.2f} ms, "
                 f"{profile['gpu_activities_per_step']:.0f} GPU activities")
    log(f"{tag} {steps} steps a round, {out['real_images_per_s']:.1f} real images/s over "
        f"{len(rounds)} warm round(s) ({out['ms_per_step']:.1f} ms a step; round 0 with the "
        f"capture {round0_s:.1f} s, the profile {profile_s:.1f} s), K1/K2 {per_step} a step, "
        f"peak {peak / 2**30:.2f} GiB, Test/Acc {acc:.4f}; {shown}; {smi}")
    del api, prog
    return out


def bn_fwd_onepass_plain(x2d, gamma, beta, eps: float = 1e-5, relu: bool = True):
    """The plain forward with the TPU kernel's variance, E[x^2] - mean^2
    clamped at 0 (``fedml_tpu/ops/batchnorm.py``'s), in place of the two-pass
    one: another plain BN, the control of ``fednas_bn_gate``."""
    import torch

    x32 = x2d.to(torch.float32)
    mean = x32.mean(0)
    var = torch.clamp_min((x32 * x32).mean(0) - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd * gamma.to(torch.float32) + beta.to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype), mean, rstd, var


def fednas_step_capture_gate(unrolled: bool) -> dict:
    """Captured = eager (``fednas_capture_gate``) for one search step of the
    gates' net (FEDNAS_GATE_SIZE, through K1/K2); unrolled, the capture
    holds the double backward, the BN wrapper's plain second-order vjp and
    the depthwise convs' ``_GroupedConv`` backward."""
    api = fednas_api(fednas_data(num_clients=1, records_per_client=64), unrolled,
                     size=FEDNAS_GATE_SIZE)
    _fill_batch(api)
    api.program()()                                     # the capture
    return fednas_capture_gate(
        api, f"[fednas gate {'unrolled' if unrolled else 'first-order'} capture]")


def fednas_bn_gate(unrolled: bool) -> dict:
    """One search step of the gates' net through K1/K2 against the plain BN
    from the same state and batch (f32): the architect's alpha gradient
    before the step, then the weights, BN statistics and alphas after it,
    relative norms within their FEDNAS_*_GATE. Reported beside it, a second
    plain BN against the first: the wrapper with ``bn_fwd_onepass_plain``
    (the TPU kernel's one-pass variance) and the plain backward, which
    differ from the plain BN by rounding only."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    ds = fednas_data(num_clients=1, records_per_client=64)
    apis = {b: fednas_api(ds, unrolled, bn_impl="xla" if b == "xla" else "pallas",
                          size=FEDNAS_GATE_SIZE, capture=False)
            for b in ("xla", "pallas", "onepass")}
    plain = apis["xla"].variables
    for b in ("pallas", "onepass"):
        apis[b].variables = {k.replace("BatchNorm", "PallasBatchNorm"): v.clone()
                             for k, v in plain.items()}
        apis[b].alphas = {k: v.clone() for k, v in apis["xla"].alphas.items()}
    got = {}
    kernels = (bn.bn_fwd_cuda, bn.bn_bwd_cuda)
    for b, api in apis.items():
        if b == "onepass":
            bn.bn_fwd_cuda, bn.bn_bwd_cuda = bn_fwd_onepass_plain, bn.bn_relu_bwd_plain
        try:
            api._load(api.variables, api.alphas)
            _fill_batch(api)
            grads = [g.detach().clone() for g in api._alpha_grads(*api.program().inputs)]
            api._load(api.variables, api.alphas)
            api.program()()
            torch.cuda.synchronize()
        finally:
            bn.bn_fwd_cuda, bn.bn_bwd_cuda = kernels
        state = {k.replace("PallasBatchNorm", "BatchNorm"): v.detach().clone()
                 for k, v in api.module.state_dict().items()}
        got[b] = (grads, state, [a.detach().clone() for a in api._alphas.values()])

    def rel(a: list, b: list) -> float:
        num = sum(float(((x.double() - y.double()) ** 2).sum()) for x, y in zip(a, b))
        return (num / max(sum(float((y.double() ** 2).sum()) for y in b), 1e-300)) ** 0.5

    def distances(b: str) -> dict:
        (g, st, a), (gp, sp, ap) = got[b], got["xla"]
        weights = [n for n in sp if not n.endswith((".mean", ".var"))]
        stats = [n for n in sp if n.endswith((".mean", ".var"))]
        return {"alpha_grad": rel(g, gp), "weights": rel([st[n] for n in weights],
                                                         [sp[n] for n in weights]),
                "bn_stats": rel([st[n] for n in stats], [sp[n] for n in stats]),
                "alphas": rel(a, ap)}

    control = distances("onepass")
    bounds = {"alpha_grad": FEDNAS_GRAD_GATE, "alphas": FEDNAS_ALPHA_GATE,
              "weights": FEDNAS_STATE_GATE, "bn_stats": FEDNAS_STATE_GATE}
    rec = {"kernels": distances("pallas"), "control": control, "bounds": bounds,
           "alpha_grad_scale": max(float(g.abs().max()) for g in got["xla"][0])}
    tag = f"[fednas gate {'unrolled' if unrolled else 'first-order'}]"
    log(f"{tag} K1/K2 against the plain BN {rec['kernels']}; the one-pass plain BN against "
        f"it {control}; bounds {bounds}")
    bad = {k: v for k, v in rec["kernels"].items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"{tag} K1/K2 against the plain BN: {bad} above {bounds}")
    return rec


def darts_bn_checks() -> dict:
    """K1/K2 at DARTS_BN_SHAPES (f32, relu off; the stem's C = 48 affine,
    the others gamma = 1 / beta = 0) against their plain versions (phase
    2's tolerances), and the BN twice differentiated through the kernels
    (``fused_bn_relu`` on the card: K1, K2, then the plain vjp of the
    backward) against the plain BN's (``models/norm._bn_plain``): the first
    and the second derivative of ``sum(sin(y) * w)`` (its squared norm's
    gradient), relative norm within SECOND_ORDER_GATE. These launches count
    no path's."""
    import torch

    from fedml_tpu_torch.models.norm import _bn_plain
    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED + 17)
    dev = torch.device("cuda")
    launches = dict(bn.LAUNCHES)
    tol = TOL["float32"]
    out = []
    for n, C in DARTS_BN_SHAPES:
        x = torch.tensor((rng.normal(size=(n, C)) * 1.5 + 0.3).astype(np.float32), device=dev)
        dy = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev)
        w = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev)
        if C == 48:
            g = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
            b = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        else:
            g, b = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        tag = f"[darts bn {n}x{C}]"
        y_p, m_p, r_p, v_p = bn.bn_relu_fwd_plain(x, g, b, EPS, False)
        y_k, m_k, r_k, v_k = bn.bn_fwd_cuda(x, g, b, EPS, False)
        e_y = assert_close(f"K1 y {tag}", y_k, y_p, *tol["y"])
        assert_close(f"K1 var {tag}", v_k, v_p, *tol["stat"])
        dx_k, dg_k, db_k = bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, False)
        dx_p, dg_p, db_p = bn.bn_relu_bwd_plain(x, y_p, dy, g, m_p, r_p, False)
        e_dx = assert_close(f"K2 dx {tag}", dx_k, dx_p, *tol["dx"])
        assert_close(f"K2 dgamma {tag}", dg_k, dg_p, *tol["dgb"])

        def derivatives(fn):
            xs = x.clone().requires_grad_(True)
            (first,) = torch.autograd.grad((torch.sin(fn(xs)) * w).sum(), xs, create_graph=True)
            (second,) = torch.autograd.grad((first * first).sum(), xs)
            return first.detach(), second

        f_k, s_k = derivatives(lambda xs: bn.fused_bn_relu(xs, g, b, EPS, False)[0])
        f_p, s_p = derivatives(lambda xs: _bn_plain(xs, g, b, EPS, False, [1, -1])[0])
        rec = {"shape": [n, C], "k1_y": e_y, "k2_dx": e_dx, "first": _rel(f_k, f_p),
               "second": _rel(s_k, s_p), "second_scale": float(s_p.abs().max())}
        if not (rec["first"] <= SECOND_ORDER_GATE and rec["second"] <= SECOND_ORDER_GATE):
            raise AssertionError(f"{tag} the twice-differentiated kernels lie {rec} from the "
                                 f"plain BN's, above {SECOND_ORDER_GATE}")
        out.append(rec)
        log(f"[check] {tag} f32 relu=False: K1 y {e_y:.3g}, K2 dx {e_dx:.3g}; first derivative "
            f"{rec['first']:.3g}, second {rec['second']:.3g} (relative norm) of the plain BN's")
    bn.LAUNCHES.update(launches)
    return {"cases": out, "max_abs_err": {"bn_fwd": max(r["k1_y"] for r in out),
                                          "bn_bwd": max(r["k2_dx"] for r in out)}}


def fednas_nccl_gate() -> dict:
    """A one-rank NCCL ``CrossSiloFedNASAPI`` round (the launcher's --ci
    search net through K1/K2, f32, first-order, 4 clients) against
    ``FedNASAPI``'s from the same state: variables and alphas within 1e-5
    (relative norm)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.algorithms.fednas import CrossSiloFedNASAPI
    from fedml_tpu_torch.parallel.mesh import client_mesh, init_multihost

    size = dict(channels=4, layers=2, steps=2, multiplier=2)
    ds = fednas_data(records_per_client=128)
    sim = fednas_api(ds, False, size=size)
    init = ({k: v.clone() for k, v in sim.variables.items()},
            {k: v.clone() for k, v in sim.alphas.items()})
    loss_sim = float(sim.run_round(0))
    tmp = tempfile.mkdtemp(prefix="nccl-store-")
    try:
        init_multihost(f"file://{tmp}/store", 1, 0, timeout_s=120)
        mesh = fednas_api(ds, False, size=size, api_cls=CrossSiloFedNASAPI, mesh=client_mesh())
        if mesh.mesh.group is None or mesh.mesh.world_size != 1:
            raise AssertionError(f"[fednas nccl] not a one-rank group: {mesh.mesh}")
        mesh.variables, mesh.alphas = init
        loss_mesh = float(mesh.run_round(0))
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    a = [*mesh.variables.values(), *mesh.alphas.values()]
    b = [*sim.variables.values(), *sim.alphas.values()]
    d = (sum(float(((x.double() - y.double()) ** 2).sum()) for x, y in zip(a, b))
         / sum(float((y.double() ** 2).sum()) for y in b)) ** 0.5
    if not d < 1e-5:
        raise AssertionError(f"[fednas nccl] the NCCL CrossSiloFedNASAPI round lies {d} "
                             f"(relative norm) from FedNASAPI's, above 1e-5")
    return {"backend": backend, "relative_norm": d, "bit_identical": d == 0.0,
            "losses": [loss_sim, loss_mesh]}


def splitnn_arm(smi: str) -> dict:
    """(c) SplitNN: ``create_split_cnn`` (features 32, hidden 128) on 2
    CIFAR-10-shaped clients of 128 records, batch 64, lr 0.005, momentum
    0.9 (at 0.02 the fresh lower stages on these images diverge for a
    ring): a ring with the capture, then one timed ring ending in a sync:
    real images/s, one replay a step, finite losses, the validation
    accuracy through the last client's stage. No TPU kernel."""
    import torch

    from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models.split import create_split_cnn

    ds = fednas_data()
    bs = FEDNAS_DATA["batch_size"]
    cfg = FedConfig(dataset="cifar10", client_num_in_total=ds.num_clients,
                    client_num_per_round=ds.num_clients, comm_round=2, batch_size=bs, epochs=1,
                    lr=0.005, momentum=0.9, seed=SEED)
    api = SplitNNAPI(ds, cfg, *create_split_cnn(10, (32, 32, 3)))
    api.run_round(0)
    prog = api._epoch.program
    r0 = prog.replays
    t = time.perf_counter()
    losses = [float(v) for v in api.run_round(1)]
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t
    acc = api._eval_client(ds.num_clients - 1)
    steps = int(sum(-(-int(c) // bs) for c in ds.train_counts))
    if prog.replays - r0 != steps or not np.isfinite(losses).all() or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"[splitnn] {prog.replays - r0} replays for {steps} steps, losses "
                             f"{losses}, val_acc {acc}")
    real = int(np.asarray(ds.train_counts).sum())
    out = {"steps": steps, "ring_s": ring_s, "real_images_per_s": real / ring_s,
           "losses": losses, "val_acc": acc}
    log(f"[train fednas/split/vfl (c) splitnn] a ring of {steps} steps "
        f"{out['real_images_per_s']:.1f} real images/s, losses {losses}, val_acc {acc:.4f}; {smi}")
    return out


def vfl_arm(smi: str) -> dict:
    """(c) VFL: ``VFLAPI`` (the fused step, captured) on the lending_club
    table's synthetic stand-in (parties of 17 and 25 features, 512 rows),
    hidden 16, lr 0.05, batch 64, 5 epochs: its record and steps/s; then the
    party-sharded step on one rank (both parties on the card) against the
    fused step from the same state over 4 batches, within 1e-5."""
    import torch

    from fedml_tpu_torch.algorithms.vfl import VFLAPI, make_sharded_vfl_step, pad_party_params
    from fedml_tpu_torch.data.vertical import load_vertical
    from fedml_tpu_torch.parallel.mesh import client_mesh

    vds = load_vertical("lending_club", str(ROOT / "no-such-dir"), seed=SEED)
    api = VFLAPI(vds, hidden_dim=16, lr=0.05, batch_size=64, seed=SEED)
    init = [{k: v.detach().clone() for k, v in p.items()} for p in api.params]
    t = time.perf_counter()
    last = api.fit(epochs=5, seed=SEED)
    fit_s = time.perf_counter() - t
    if not (np.isfinite(last["Train/Loss"]) and last["Test/Acc"] > 0.6):
        raise AssertionError(f"[vfl] fit {last}")
    steps = 5 * (len(vds.train_y) // 64)
    # the sharded step against the fused one
    fused = VFLAPI(vds, hidden_dim=16, lr=0.05, batch_size=64, seed=SEED)
    with torch.no_grad():
        for mine, theirs in zip(fused.params, init):
            for k in mine:
                mine[k].copy_(theirs[k])
    params = pad_party_params(init, vds.party_dims)
    step, tx = make_sharded_vfl_step(client_mesh(), lr=0.05)
    opt = tx.init(list(params.values()))
    d_max = max(vds.party_dims)
    worst = 0.0
    for s in range(4):
        idx = np.arange(s * 64, s * 64 + 64)
        xs = np.zeros((vds.num_parties, 64, d_max), np.float32)
        for p in range(vds.num_parties):
            xs[p, :, :vds.party_dims[p]] = vds.train_parts[p][idx]
        y = torch.from_numpy(vds.train_y[idx]).cuda()
        a = float(step(params, opt, torch.from_numpy(xs).cuda(), y))
        b = float(fused.step([torch.from_numpy(p[idx]).cuda() for p in vds.train_parts], y))
        worst = max(worst, abs(a - b))
    want = pad_party_params([{k: v.detach() for k, v in p.items()} for p in fused.params],
                            vds.party_dims)
    worst_p = max(float((params[k] - want[k]).abs().max()) for k in want)
    if not (worst <= 1e-5 and worst_p <= 1e-5):
        raise AssertionError(f"[vfl] the one-rank sharded step lies {worst} (loss) / {worst_p} "
                             "(parameters) from the fused step, above 1e-5")
    out = {"dataset": vds.name, "record": last, "fit_s": fit_s, "steps": steps,
           "steps_per_s": steps / fit_s, "sharded_vs_fused": {"loss": worst, "params": worst_p}}
    log(f"[train fednas/split/vfl (c) vfl] {vds.name}: {steps} steps in {fit_s:.2f} s with 5 "
        f"evaluations, Test/Acc {last['Test/Acc']:.4f}; one-rank sharded step vs fused: loss "
        f"{worst:.3g}, parameters {worst_p:.3g}; {smi}")
    return out


def phase_train_fednas_split_vfl(smi: str) -> dict:
    """Phase 17: the full-width FedNAS search through K1/K2, first-order (a)
    and unrolled; the f32 gates (b), both under cuDNN's deterministic
    algorithms; a SplitNN ring and a VFL fit (c)."""
    import gc

    import torch

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}
    # cuDNN's deterministic algorithms throughout: the captured-vs-eager and
    # kernel-vs-plain gates then compare one algorithm's sums
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for unrolled in (False, True):
            rec = out["arms"]["unrolled" if unrolled else "first_order"] = fednas_arm(unrolled,
                                                                                      smi)
            for k in launches:
                launches[k] += rec["launches"][k]
            gc.collect()
            torch.cuda.empty_cache()
        gates = {"first_order": fednas_bn_gate(False), "unrolled": fednas_bn_gate(True),
                 "first_order_capture": fednas_step_capture_gate(False),
                 "unrolled_capture": fednas_step_capture_gate(True), "nccl": fednas_nccl_gate()}
        log(f"[fednas gates] f32 on the card: {gates}; {smi}")
        out["darts_bn"] = darts_bn_checks()
    finally:
        torch.backends.cudnn.deterministic = det
    out["f32_checks"] = gates
    gc.collect()
    torch.cuda.empty_cache()
    out["splitnn"] = splitnn_arm(smi)
    out["vfl"] = vfl_arm(smi)
    out["launches"] = launches
    log("[train fednas/split/vfl] real images/s: " + ", ".join(
        f"{k} {v['real_images_per_s']:.1f}" for k, v in out["arms"].items()) + f"; {smi}")
    return out


def attention_bound(b: int, h: int, tq: int, tk: int, d: int, causal: bool, elt: int = 2
                    ) -> tuple[float, float, int]:
    """(bytes, flops, live scores) of one K6 call at offsets 0: q, k, v
    read once, the f32 o, m, l written once; 2 FLOPs per multiply-add of
    q.k and of p.v over the live (query, key) pairs, each of which also
    takes one exponential."""
    live = b * h * (int(np.clip(np.arange(tq) + 1, 0, tk).sum()) if causal else tq * tk)
    nbytes = elt * b * h * (tq + 2 * tk) * d + 4 * b * h * tq * (d + 2)
    return nbytes, 4 * live * d, live


def exp_ms(n_exp: int, sm_clock_mhz: float, n_sm: int) -> float:
    """Least time of ``n_exp`` f32 exponentials on the special-function
    units: 16 per clock per SM (Hopper's MUFU rate) at the SM clock."""
    return n_exp / (EXP_PER_CLOCK_PER_SM * n_sm * sm_clock_mhz * 1e6) * 1e3


def xent_bound(n: int, v: int, elt: int = 4, label_bytes: int = 8) -> tuple[float, float]:
    """(bytes, flops) of one K5 call: the logits and labels read once, the
    f32 losses written once; max, subtract, exp and add per logit."""
    return elt * n * v + (label_bytes + 4) * n, 4 * n * v


def _close_partial(name, got, want) -> float:
    """K6's (o, m, l) against the plain version's. Both sum in f32 in other
    orders over up to Tk terms: m within 1e-5; l rtol 1e-5; o compared
    after dividing both by the plain l (its scale: o's row is a sum of l's
    worth of v rows), atol 2e-5."""
    import torch

    (o, m, l), (po, pm, pl) = got, want
    assert_close(f"{name} m", m, pm, 0.0, 1e-5)
    assert_close(f"{name} l", l, pl, 1e-5, 1e-5)
    den = torch.where(pl == 0, torch.ones_like(pl), pl)[..., None]
    return assert_close(f"{name} o/l", o / den, po / den, 0.0, 2e-5)


# -- phase 18: the BN zoo through K1/K2, dropout, the FedML baselines -------------

# K1 = K2 launches a step (one per BatchNorm of a forward) of the zoo nets
ZOO_BNS = {"mobilenet": 27, "mobilenet_v3": 34, "mobilenet_v3/large": 46, "vgg11": 8,
           "vgg16": 13, "vgg19": 16, "efficientnet-b0": 49, "efficientnet-b1": 69,
           "efficientnet-b2": 69, "efficientnet-b3": 78, "efficientnet-b4": 96,
           "efficientnet-b5": 116, "efficientnet-b6": 134, "efficientnet-b7": 163,
           "resnet56_w64": 57, "resnet56_w128": 57, "resnet56_nonorm": 0}
# (a)'s timed arms; every other name of ZOO_BNS gets one captured step
ZOO_TIMED = ("mobilenet", "mobilenet_v3", "vgg16", "efficientnet-b0", "resnet56_w128")
# the timed arms' K1/K2 calls a step at batch 64 by (rows, C, relu), as
# MAIN_PATH_BNS (rows = 64 x the BN's spatial size at 32 x 32 input); each
# arm checks its recorded calls against these, and (b) holds K1/K2 against
# their plain versions at every [rows, C] of the zoo's recorded calls
ZOO_BN_SHAPES = {
    "mobilenet": {(65536, 32, True): 2, (65536, 64, True): 1, (16384, 64, True): 1,
                  (16384, 128, True): 3, (4096, 128, True): 1, (4096, 256, True): 3,
                  (1024, 256, True): 1, (1024, 512, True): 11, (256, 512, True): 1,
                  (256, 1024, True): 3},
    "mobilenet_v3": {(65536, 16, False): 1, (16384, 16, False): 1, (16384, 16, True): 1,
                     (16384, 72, True): 1, (4096, 24, False): 2, (4096, 72, True): 1,
                     (4096, 88, True): 2, (4096, 96, False): 1, (1024, 40, False): 3,
                     (1024, 48, False): 2, (1024, 96, False): 1, (1024, 120, False): 2,
                     (1024, 144, False): 2, (1024, 240, False): 4, (1024, 288, False): 1,
                     (256, 96, False): 3, (256, 288, False): 1, (256, 576, False): 5},
    "vgg16": {(65536, 64, True): 2, (16384, 128, True): 2, (4096, 256, True): 3,
              (1024, 512, True): 3, (256, 512, True): 3},
    "efficientnet-b0": {(16384, 16, False): 1, (16384, 32, False): 2, (16384, 96, False): 1,
                        (4096, 24, False): 2, (4096, 96, False): 1, (4096, 144, False): 3,
                        (1024, 40, False): 2, (1024, 144, False): 1, (1024, 240, False): 3,
                        (256, 80, False): 3, (256, 112, False): 3, (256, 240, False): 1,
                        (256, 480, False): 6, (256, 672, False): 5, (64, 192, False): 4,
                        (64, 320, False): 1, (64, 672, False): 1, (64, 1152, False): 8,
                        (64, 1280, False): 1},
    "resnet56_w128": {(65536, 128, True): 10, (65536, 128, False): 9, (16384, 128, True): 9,
                      (16384, 128, False): 10, (4096, 128, True): 9, (4096, 128, False): 10},
}
# CIFAR-10-shaped non-IID clients: 4 of 128 records (2 batches of 64), all every round
ZOO_DATA = dict(num_clients=4, records_per_client=128, batch_size=64)
ZOO_LR = 0.1
# (b)'s gradient gate: one f32 forward and backward of each net on one batch
# of 64 through K1/K2 against the plain BN, under cuDNN's deterministic
# algorithms: the parameters' gradients and the BN statistics' update, each
# the norm of the difference over the plain BN's own norm, so no learning
# rate scales the reading. Beside it three readings: the plain BN again (the
# noise floor), the one-pass plain BN (the TPU kernel's variance: another
# rounding of the same BN) and the plain BN with its y and dx rounded to bf16
# (a BN of lower precision). Each bound lies between the one-pass and the
# bf16 readings of a run with no bound (H100, 700 W; PERF.md §6): the
# gradients' one-pass 3.6e-6 .. 3.4e-3 (K1/K2 3.8e-6 .. 8.1e-3; mobilenet's
# and vgg16's deep BNs over 256 rows make theirs ill-conditioned), bf16
# 0.12 .. 0.88; the statistics' update one-pass <= 2.4e-6, bf16 >= 7.1e-4.
# The gate fails too where the bf16 BN lies inside a bound: it could not tell.
ZOO_GRAD_GATE = {"grads": 3e-2, "bn_stat_update": 3e-5}
ZOO_STEP_NAMES = ("mobilenet", "mobilenet_v3", "vgg16", "efficientnet-b0")
# the packed cnn_dropout lane against its client's plain round: the JAX
# package's bound for its dropout packed parity
# (tests/test_packed_everywhere.py::test_dropout_model_packed_parity)
DROPOUT_PACKED_TOL = (1e-4, 1e-5)
CAPTURE_REPLAYS = 3


def _zoo_name(name: str) -> tuple:
    """(registry name, factory kwargs) of a ZOO_BNS entry."""
    if name == "mobilenet_v3/large":
        return "mobilenet_v3", {"mode": "large"}
    return name, {}


def zoo_api(name: str, num_clients: int, records: int, dtype: str = "bfloat16",
            bn_impl: str = "pallas", comm_round: int = 3, **cfg_kw):
    """FedAvg of a ZOO_BNS net on CIFAR-10-shaped non-IID synthetic clients
    (all every round, batch 64, lr ZOO_LR, momentum 0.9), each step captured."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model

    model, kw = _zoo_name(name)
    ds = make_synthetic_classification("cifar10-zoo", (32, 32, 3), 10, num_clients,
                                       records_per_client=records, batch_size=64, seed=SEED)
    cfg = FedConfig(model=model, client_num_in_total=num_clients,
                    client_num_per_round=num_clients, comm_round=comm_round, batch_size=64,
                    lr=ZOO_LR, momentum=0.9, dtype=dtype, frequency_of_the_test=10_000,
                    seed=SEED, device_data="on", **cfg_kw)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return FedAvgAPI(ds, cfg, create_model(model, 10, input_shape=(32, 32, 3), dtype=tdt,
                                           bn_impl=bn_impl, **kw))


def record_bn_shapes(bundle, batch: int = 64) -> dict:
    """The (rows, C, relu) of every K1 call of one train-mode forward of a
    copy of ``bundle``'s module on a batch of ``batch`` 32 x 32 x 3 images
    (in the dtype of its parameters), counted."""
    import collections
    import copy

    import torch

    from fedml_tpu_torch.models.norm import PallasBatchNorm

    m = copy.deepcopy(bundle.module).train()
    seen = collections.Counter()

    def hook(mod, inp, out):
        x = inp[0]
        seen[(x.numel() // x.shape[-1], x.shape[-1], mod.fuse_relu)] += 1

    for mod in m.modules():
        if isinstance(mod, PallasBatchNorm) and mod.use_kernel:
            mod.register_forward_hook(hook)
    p = next(m.parameters())
    gen = torch.Generator(device=p.device).manual_seed(SEED)
    x = torch.randn((batch, 32, 32, 3), generator=gen, device=p.device).to(p.dtype)
    with torch.no_grad():
        key = torch.zeros((), dtype=torch.int64, device=p.device)
        m(x, dropout_key=key) if bundle.uses_dropout else m(x)
    del m
    return dict(seen)


def zoo_bn_arm(name: str, smi: str) -> dict:
    """(a) one timed arm: round 0 with its capture, then 2 warm rounds
    ending in a sync; ZOO_BNS[name] K1 + K2 and one replay a live step,
    none in the evaluation; real images/s, peak memory, and a one-step
    profile (device ms, busy share, K1 + K2 ms)."""
    import torch

    tag = f"[zoo (a) {name}]"
    torch.cuda.reset_peak_memory_stats()
    api = zoo_api(name, ZOO_DATA["num_clients"], ZOO_DATA["records_per_client"])
    if kernel_bns(api.bundle.module) != ZOO_BNS[name]:
        raise AssertionError(f"{tag} {kernel_bns(api.bundle.module)} kernel BNs, not "
                             f"{ZOO_BNS[name]}")
    shapes = record_bn_shapes(api.bundle)
    if shapes != ZOO_BN_SHAPES[name]:
        raise AssertionError(f"{tag} K1 calls at batch 64 {shapes}, not ZOO_BN_SHAPES' "
                             f"{ZOO_BN_SHAPES[name]}")
    t = time.perf_counter()
    _rounds(api, 0, 1)                                   # with its capture
    round0_s = time.perf_counter() - t
    bs = api.config.batch_size
    steps = sum(api.round_counts(r)[1] // bs for r in (1, 2))
    r0 = replays(api)
    bn_counts().update({"bn_fwd": 0, "bn_bwd": 0})
    losses, train_s = _rounds(api, 1, 2)
    trained = dict(bn_counts())
    metrics = api.evaluate_global()
    after = dict(bn_counts())
    want = ZOO_BNS[name] * steps
    if (any(v != want for v in trained.values()) or after != trained
            or replays(api) - r0 != steps or not np.isfinite(losses).all()
            or not np.isfinite(metrics["loss"])):
        raise AssertionError(f"{tag} launched {trained} ({after} after the evaluation), "
                             f"{replays(api) - r0} replays, losses {losses}, eval {metrics}; "
                             f"expected {ZOO_BNS[name]} x {steps} steps, one replay each")
    peak = torch.cuda.max_memory_allocated()
    prog = step_programs(api)[0]
    profile = _profile(lambda: prog(), 1, op_tables=False)
    fam = profile["device_ms_per_step_by_family"]
    k12 = fam.get("bn kernels (K1/K2)", 0.0)
    real = sum(api.round_counts(r)[0] for r in (1, 2))
    out = {"model": name, "steps": steps, "losses": losses, "seconds": train_s,
           "round0_s": round0_s, "real_images_per_s": real / train_s,
           "ms_per_step": train_s / steps * 1e3, "bns_per_step": ZOO_BNS[name],
           "launches": trained, "peak_memory_bytes": peak, "eval": metrics,
           "step_profile": profile, "k1k2_device_ms": k12,
           "k1k2_share": k12 / max(profile["device_ms_per_step"], 1e-12),
           "bn_shapes": sorted([*k, v] for k, v in shapes.items())}
    log(f"{tag} {steps} steps over 2 warm rounds: {out['real_images_per_s']:.1f} real images/s "
        f"({out['ms_per_step']:.2f} ms a step; round 0 with the capture {round0_s:.1f} s), "
        f"K1 = K2 = {ZOO_BNS[name]} a step, a step {profile['device_ms_per_step']:.3f} ms of "
        f"device (busy {profile['device_busy_share']:.3f}, K1+K2 {k12:.3f} ms = "
        f"{out['k1k2_share']:.3f}), peak {peak / 2**30:.2f} GiB, Test/Acc "
        f"{metrics['acc']:.4f}; {smi}")
    del api, prog
    return out


def zoo_one_step(name: str, smi: str) -> dict:
    """(a) an untimed name: one client of one batch, one round, so one
    captured step: its capture recorded ZOO_BNS[name] K1 + K2, the loss is
    finite."""
    tag = f"[zoo (a) {name}]"
    api = zoo_api(name, 1, 64, comm_round=1)
    shapes = record_bn_shapes(api.bundle)
    if sum(shapes.values()) != ZOO_BNS[name]:
        raise AssertionError(f"{tag} {sum(shapes.values())} K1 calls a forward, not "
                             f"{ZOO_BNS[name]}: {shapes}")
    bn_counts().update({"bn_fwd": 0, "bn_bwd": 0})
    t = time.perf_counter()
    loss, _ = _rounds(api, 0, 1)
    seconds = time.perf_counter() - t
    prog = step_programs(api)[0]
    per_step = {k: v for d in prog.launches_per_step for k, v in d.items()
                if k in ("bn_fwd", "bn_bwd")}
    want = {"bn_fwd": ZOO_BNS[name], "bn_bwd": ZOO_BNS[name]}
    if per_step != want or dict(bn_counts()) != want or prog.replays != 1 \
            or not np.isfinite(loss).all():
        raise AssertionError(f"{tag} the captured step recorded {per_step} (counted "
                             f"{dict(bn_counts())}, {prog.replays} replays), loss {loss}; "
                             f"expected {want}, one replay")
    widest = max((m.mean.numel() for m in api.bundle.module.modules()
                  if hasattr(m, "use_kernel") and m.use_kernel), default=0)
    log(f"{tag} one captured step: K1 = K2 = {ZOO_BNS[name]}, widest BN C = {widest}, loss "
        f"{loss[0]:.4f}, {seconds:.1f} s with the capture; {smi}")
    del api, prog
    return {"model": name, "loss": loss[0], "seconds": seconds, "launches": dict(bn_counts()),
            "widest_bn": widest, "bn_shapes": sorted([*k, v] for k, v in shapes.items())}


def _rel_dicts(a: dict, b: dict, keys) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys)
    return (num / max(sum(float((b[k].double() ** 2).sum()) for k in keys), 1e-300)) ** 0.5


def bn_zoo_check(shapes) -> tuple:
    """(b) K1 and K2 against their plain versions at every [rows, C] of the
    zoo's recorded K1 calls (``shapes``, (rows, C, relu) triples), f32 and
    bf16, ReLU on and off, with phase 2's tolerances and bit-identical over
    two calls, one summary line. Returns (worst errors, cases)."""
    import torch

    rng = np.random.default_rng(SEED + 20)
    err = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    cases = []
    todo = sorted({(n, C) for n, C, _ in shapes}, reverse=True)
    for n, C in todo:
        check_bn_shape(rng, n, C, True, False, False, err, cases, verbose=False)
    torch.cuda.synchronize()
    log(f"[check] K1/K2 at the zoo's {len(todo)} BN shapes (rows {min(n for n, _ in todo)}.."
        f"{max(n for n, _ in todo)}, C {min(c for _, c in todo)}..{max(c for _, c in todo)}): "
        f"{len(cases)} cases within phase 2's tolerances, worst y {err['bn_fwd']:.3g}, "
        f"dx {err['bn_bwd']:.3g}, each repeat bit-identical")
    return err, cases


def bn_fwd_bf16_plain(x2d, gamma, beta, eps: float = 1e-5, relu: bool = True):
    """The plain forward with y rounded to bf16: a BN of lower precision,
    the control that ``zoo_step_gate`` must refuse."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    y, mean, rstd, var = bn.bn_relu_fwd_plain(x2d, gamma, beta, eps, relu)
    return y.to(torch.bfloat16).to(y.dtype), mean, rstd, var


def bn_bwd_bf16_plain(x2d, y, dy, gamma, mean, rstd, relu: bool = True):
    """The plain backward with dx rounded to bf16 (``bn_fwd_bf16_plain``'s)."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    dx, dgamma, dbeta = bn.bn_relu_bwd_plain(x2d, y, dy, gamma, mean, rstd, relu)
    return dx.to(torch.bfloat16).to(dx.dtype), dgamma, dbeta


def zoo_step_gate(name: str) -> dict:
    """(b) one f32 forward and backward of ``name`` on one batch of 64
    through K1/K2 against the plain BN, from the same weights, under cuDNN's
    deterministic algorithms: the parameters' gradients and the BN
    statistics' update (after - before), each as the norm of the difference
    over the plain BN's, within ZOO_GRAD_GATE. Beside it: the plain BN again,
    the one-pass plain BN and the bf16-rounded plain BN, which must lie past
    the bound. EfficientNet's dropout takes one fixed key in every arm."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import batchnorm as bn

    model, kw = _zoo_name(name)
    rng = np.random.default_rng(SEED + 18)
    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(size=(64, 32, 32, 3)).astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, 10, 64), device=dev)
    key = torch.tensor(18, dtype=torch.int64, device=dev)
    plain = create_model(model, 10, input_shape=(32, 32, 3), bn_impl="xla", **kw)
    init = plain.init(SEED, dev)
    stats = [k for k in init if k.endswith((".mean", ".var"))]
    # arm -> (bn_impl, the wrapper's forward and backward, None for K1/K2)
    arms = {"plain": ("xla", None), "plain_again": ("xla", None), "kernels": ("pallas", None),
            "onepass": ("pallas", (bn_fwd_onepass_plain, bn.bn_relu_bwd_plain)),
            "bf16": ("pallas", (bn_fwd_bf16_plain, bn_bwd_bf16_plain))}
    kernels = (bn.bn_fwd_cuda, bn.bn_bwd_cuda)
    got = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arm, (impl, swap) in arms.items():
            bundle = create_model(model, 10, input_shape=(32, 32, 3), bn_impl=impl, **kw)
            m = bundle.module.to(dev)
            m.load_state_dict({k.replace("BatchNorm", "PallasBatchNorm") if impl != "xla"
                               else k: v for k, v in init.items()})
            if swap is not None:
                bn.bn_fwd_cuda, bn.bn_bwd_cuda = swap
            try:
                m.train()
                out = m(x, dropout_key=key) if bundle.uses_dropout else m(x)
                F.cross_entropy(out, y).backward()
                torch.cuda.synchronize()
            finally:
                bn.bn_fwd_cuda, bn.bn_bwd_cuda = kernels
            after = {k.replace("PallasBatchNorm", "BatchNorm"): v
                     for k, v in m.state_dict().items()}
            got[arm] = {**{f"grad/{k.replace('PallasBatchNorm', 'BatchNorm')}":
                           p.grad.detach().clone() for k, p in m.named_parameters()},
                        **{f"stat/{k}": (after[k] - init[k]).detach().clone() for k in stats}}
            del bundle, m
    finally:
        torch.backends.cudnn.deterministic = det
    ref = got["plain"]
    grads = [k for k in ref if k.startswith("grad/")]
    deltas = [k for k in ref if k.startswith("stat/")]

    def dist(arm):
        return {"grads": _rel_dicts(got[arm], ref, grads),
                "bn_stat_update": _rel_dicts(got[arm], ref, deltas)}

    rec = {"model": name, "bound": ZOO_GRAD_GATE,
           **{arm: dist(arm) for arm in arms if arm != "plain"}}
    log(f"[zoo (b) gradient gate {name}] against the plain BN: K1/K2 {rec['kernels']}; "
        f"the plain BN again {rec['plain_again']}, the one-pass plain BN {rec['onepass']}, "
        f"the bf16-rounded plain BN {rec['bf16']}; bound {ZOO_GRAD_GATE}")
    if not all(rec["kernels"][k] <= bound < rec["bf16"][k]
               for k, bound in ZOO_GRAD_GATE.items()):
        raise AssertionError(f"[zoo (b) gradient gate {name}] K1/K2 must lie within "
                             f"{ZOO_GRAD_GATE} and the bf16-rounded BN past it: {rec}")
    return rec


def dropout_capture_gate(name: str) -> dict:
    """(b) captured = eager with dropout on, f32 under cuDNN's deterministic
    algorithms: the step of ``name`` (``cnn_dropout``, or ``efficientnet-b0``
    with its stochastic depth and head dropout) captured once and replayed
    CAPTURE_REPLAYS times, each under a new key and from the same state,
    against the eager step under that key: bit for bit (or no farther than
    a second eager run). The masks themselves: ``keep_mask`` of a key input
    captured and replayed under each key equals the eager mask, and the
    masks of the replays differ."""
    import torch

    from fedml_tpu_torch.core.tasks import get_task
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.dropout import keep_mask
    from fedml_tpu_torch.parallel.capture import CapturedStep
    from fedml_tpu_torch.parallel.local import make_batch_sgd_step, make_optimizer, module_state

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 19)
    shape = (28, 28, 1) if name == "cnn_dropout" else (32, 32, 3)
    classes = 62 if name == "cnn_dropout" else 10
    bundle = create_model(name, classes, input_shape=shape, bn_impl="pallas")
    bundle.init(SEED, dev)
    module = bundle.module
    opt = make_optimizer("sgd", 0.05, 0.9)(module.parameters())
    opt.zero_grad(set_to_none=False)
    step = make_batch_sgd_step(bundle, get_task("classification", classes))
    inputs = [torch.tensor(rng.normal(size=(32, *shape)).astype(np.float32), device=dev),
              torch.tensor(rng.integers(0, classes, 32), device=dev),
              torch.ones(32, device=dev), torch.zeros((), dtype=torch.int64, device=dev)]
    prog = CapturedStep(lambda bx, by, bm, k: step(module, opt, bx, by, bm, None, k), inputs,
                        lambda: module_state(module, opt))
    saved = [t.detach().clone() for t in prog.state()]

    def run(fn, key):
        with torch.no_grad():
            for t, v in zip(prog.state(), saved):
                t.copy_(v)
        inputs[3].fill_(key)
        loss = fn()
        torch.cuda.synchronize()
        return {"loss": loss.detach().clone(),
                **{f"state/{i}": t.detach().clone() for i, t in enumerate(prog.state())}}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    verdicts = []
    try:
        for i, key in enumerate(range(101, 101 + CAPTURE_REPLAYS)):
            captured = run(prog, key)
            e1 = run(lambda: prog.body(*prog.inputs), key)
            e2 = run(lambda: prog.body(*prog.inputs), key)
            verdicts.append(_capture_verdict(f"[dropout capture {name} key {key}]", e1, e2,
                                             captured))
        run(lambda: torch.zeros((), device=dev), 0)          # the state back
    finally:
        torch.backends.cudnn.deterministic = det
    # the masks: keep_mask of a key input inside a captured graph
    kin = torch.zeros((), dtype=torch.int64, device=dev)
    mshape = (32, 12, 12, 64)
    mprog = CapturedStep(lambda k: keep_mask(k, 0, mshape, 0.25), [kin], lambda: [])
    masks = []
    for key in range(101, 101 + CAPTURE_REPLAYS):
        kin.fill_(key)
        got = mprog().clone()
        if not torch.equal(got, keep_mask(kin.clone(), 0, mshape, 0.25)):
            raise AssertionError(f"[dropout capture {name}] the replayed mask under key {key} "
                                 "differs from the eager one")
        masks.append(got)
    if mprog.replays != CAPTURE_REPLAYS or any(torch.equal(a, b) for i, a in enumerate(masks)
                                               for b in masks[i + 1:]):
        raise AssertionError(f"[dropout capture {name}] the replays' masks repeat")
    keep = [float(m.float().mean()) for m in masks]
    log(f"[dropout capture {name}] {CAPTURE_REPLAYS} replays under keys 101..: "
        f"{[v['verdict'] for v in verdicts]}; replayed masks equal the eager ones, differ "
        f"from each other, keep shares {keep}")
    return {"model": name, "verdicts": verdicts, "keep_shares": keep}


def dropout_packed_gate() -> dict:
    """(b) the packed ``cnn_dropout`` round (2 lanes, ``packed_conv`` off
    and blockdiag; f32) lane by lane against its clients' plain local
    training from the same orders: each lane's variables (the packed
    round with the other lane's weight 0) within DROPOUT_PACKED_TOL of its
    client's, the masks coming from the same step keys."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model

    ds = make_synthetic_classification("femnist-gate", (28, 28, 1), 62, 2,
                                       records_per_client=48, batch_size=16, seed=SEED)
    rtol, atol = DROPOUT_PACKED_TOL
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl in ("off", "blockdiag"):
            cfg = FedConfig(model="cnn_dropout", client_num_in_total=2, client_num_per_round=2,
                            comm_round=1, batch_size=16, epochs=2, lr=0.05, momentum=0.9,
                            pack_lanes=2, packed_conv=impl, device_data="on", seed=SEED)
            api = FedAvgAPI(ds, cfg, create_model("cnn_dropout", 62))
            init = {k: v.clone() for k, v in api.variables.items()}
            sampled = api.sample(0)
            orders, keys = api._round_orders(0, len(sampled)), api._round_keys(0, len(sampled))
            plan = api._masked_packed_plan(sampled, None)
            tx, ty, tm = api._dev_train
            worst = 0.0
            for pos in range(2):        # the cohort position whose lane is kept
                w = np.zeros(2, np.float32)
                w[pos] = 1.0
                packed = api._packed_train(init, tx, ty, tm, sampled, w, orders, plan,
                                           keys).variables
                c = int(sampled[pos])
                plain = api._local_train(init, tx[c], ty[c], tm[c], int(ds.train_counts[c]),
                                         orders=orders[pos], key=int(keys[pos])).variables
                for k, v in plain.items():
                    a, b = packed[k].float(), v.float()
                    err = float(((a - b).abs() - atol - rtol * b.abs()).max())
                    worst = max(worst, float((a - b).abs().max()))
                    if err > 0:
                        raise AssertionError(f"[dropout packed {impl}] client {c} {k}: "
                                             f"max |diff| {float((a - b).abs().max()):.3g} "
                                             f"outside rtol {rtol} / atol {atol}")
            out[impl] = {"max_abs_diff": worst, "packed_conv": api._packed_train.packed_conv}
            log(f"[dropout packed {impl}] 2 lanes of cnn_dropout against their clients' plain "
                f"training: max |diff| {worst:.3g} (bound rtol {rtol} / atol {atol})")
    finally:
        torch.backends.cudnn.deterministic = det
    return out


# (c) FedML's cross-device baselines: (model, dataset, loader kwargs, config)
BASELINES = (
    ("resnet18_gn", "fed_cifar100", dict(client_num_in_total=8), dict(batch_size=20)),
    ("rnn", "shakespeare", dict(client_num_in_total=8), dict(batch_size=4)),
    ("rnn_stackoverflow", "stackoverflow_nwp", dict(client_num_in_total=8),
     dict(batch_size=16)),
    ("lr", "stackoverflow_lr", dict(client_num_in_total=8), dict(batch_size=10, lr=0.3)),
    ("cnn_dropout", "femnist", dict(client_num_in_total=8),
     dict(batch_size=20, pack_lanes=2, packed_conv="blockdiag")),
)


def baseline_arm(model: str, dataset: str, load_kw: dict, cfg_kw: dict, smi: str) -> dict:
    """(c) one FedML baseline: the stand-in federation, 4 clients a round,
    round 0 with its captures, then one timed round ending in a sync, and
    an evaluation; finite loss and metrics."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    tag = f"[baseline (c) {model} on {dataset}]"
    ds = load_dataset(dataset, seed=SEED, batch_size=cfg_kw["batch_size"], **load_kw)
    kw = dict(lr=0.05, momentum=0.9)
    kw.update(cfg_kw)
    cfg = FedConfig(model=model, dataset=dataset, client_num_in_total=ds.num_clients,
                    client_num_per_round=4, comm_round=2, frequency_of_the_test=10_000,
                    seed=SEED, device_data="on", **kw)
    api = FedAvgAPI(ds, cfg, create_model(model, ds.class_num,
                                          input_shape=ds.train_x.shape[2:] or None))
    t = time.perf_counter()
    loss0, _ = _rounds(api, 0, 1)
    round0_s = time.perf_counter() - t
    loss1, seconds = _rounds(api, 1, 1)
    metrics = api.evaluate_global()
    torch.cuda.synchronize()
    if not (np.isfinite(loss0 + loss1).all() and np.isfinite(metrics["loss"])):
        raise AssertionError(f"{tag} losses {loss0 + loss1}, eval {metrics}")
    real = api.round_counts(1)[0]
    status = api.packed_status()
    log(f"{tag} round 0 {loss0[0]:.4f} ({round0_s:.1f} s with the captures), round 1 "
        f"{loss1[0]:.4f} in {seconds:.2f} s ({real / seconds:.1f} real records/s), eval "
        f"{metrics}; packed {status}; {smi}")
    return {"model": model, "dataset": dataset, "losses": loss0 + loss1, "round0_s": round0_s,
            "seconds": seconds, "real_records_per_s": real / seconds, "eval": metrics,
            "packed": status}


def phase_train_zoo_bn(smi: str) -> dict:
    """Phase 18: (a) the BN zoo through K1/K2 in bf16, (b) the f32 gates
    (K1/K2 past C = 1024 and at every BN shape of the zoo, the gradients of
    four zoo nets against the plain BN's, captured = eager with dropout, the
    packed cnn_dropout lanes), (c) the FedML baselines."""
    import gc

    import torch

    out = {"arms": {}, "one_step": {}}
    launches = {"bn_fwd": 0, "bn_bwd": 0}
    for name in ZOO_TIMED:
        rec = out["arms"][name] = zoo_bn_arm(name, smi)
        for k in launches:
            launches[k] += rec["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()
    for name in ZOO_BNS:
        if name not in ZOO_TIMED:
            rec = out["one_step"][name] = zoo_one_step(name, smi)
            for k in launches:
                launches[k] += rec["launches"][k]
            gc.collect()
    out["launches"] = launches
    out["wide_err"], out["wide_cases"] = bn_wide_check()
    shapes = {(n, C, relu) for rec in [*out["arms"].values(), *out["one_step"].values()]
              for n, C, relu, _ in rec["bn_shapes"]}
    out["zoo_shape_err"], out["zoo_shape_cases"] = bn_zoo_check(shapes)
    out["step_gates"] = {n: zoo_step_gate(n) for n in ZOO_STEP_NAMES}
    out["dropout_capture"] = {n: dropout_capture_gate(n)
                              for n in ("cnn_dropout", "efficientnet-b0")}
    out["dropout_packed"] = dropout_packed_gate()
    out["baselines"] = {m: baseline_arm(m, d, lk, ck, smi) for m, d, lk, ck in BASELINES}
    log("[zoo] real images/s: " + ", ".join(
        f"{k} {v['real_images_per_s']:.1f}" for k, v in out["arms"].items())
        + f"; K1/K2 launches {launches}; {smi}")
    return out


def phase_check_lm():
    """K6 and K5 against their plain versions on the same card tensors, then
    a small TransformerLM through both kernels on the card against the same
    model on the CPU."""
    import torch

    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe

    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda")
    err = {"attention": 0.0, "xent": 0.0}
    cases = []

    def qkv(b, h, tq, tk, d, dtype):
        return [torch.tensor(rng.normal(size=s).astype(np.float32), device=dev).to(dtype)
                for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]

    # (B, H, Tq, Tk, D, q_offset, k_offset, causal): path (B), path (A), a
    # shifted query window, ragged T at each head dim, one non-causal case
    shapes = [ATTN_B + (0, 0, True), ATTN_B + (0, 0, False), ATTN_A + (0, 0, True),
              (2, 2, 32, 64, 32, 32, 0, True), (2, 2, 37, 37, 16, 0, 0, True),
              (1, 3, 300, 300, 64, 0, 0, True), (2, 2, 300, 37, 128, 263, 0, True),
              (2, 2, 64, 64, 128, 0, 0, False)]
    cases_by_dtype = [(s, dt) for s in shapes for dt in (torch.float32, torch.bfloat16)]
    # the bf16 kernel's tiles (64 query rows, 64 keys): every Tq, Tk at a
    # tile edge, the diagonal mid-tile by a query or key offset, D = 16 and
    # 128 at T = 300, a non-causal ragged case
    edges = (63, 64, 65, 129)
    tiles = [(2, 2, tq, tk, 32, 0, 0, True) for tq in edges for tk in edges]
    tiles += [(2, 2, 64, 129, 32, 29, 0, True), (2, 2, 129, 129, 64, 0, 37, True),
              (2, 2, 300, 300, 16, 0, 0, True), (2, 2, 300, 300, 128, 0, 0, True),
              (2, 2, 65, 129, 32, 0, 0, False)]
    cases_by_dtype += [(s, torch.bfloat16) for s in tiles]
    for (b, h, tq, tk, d, qo, ko, causal), dtype in cases_by_dtype:
        tag = (f"[{b},{h},{tq},{tk},{d}] offsets {qo},{ko} causal={causal} "
               f"{str(dtype).split('.')[1]}")
        q, k, v = qkv(b, h, tq, tk, d, dtype)
        args = (qo, ko, causal, d ** -0.5)
        got = att.block_partial_cuda(q, k, v, *args)
        e = _close_partial(f"K6 {tag}", got, att.block_partial_plain(q, k, v, *args))
        if dtype == torch.bfloat16:
            _same_bits(f"K6 {tag}", got, att.block_partial_cuda(q, k, v, *args))
        err["attention"] = max(err["attention"], e)
        cases.append({"case": f"K6 {tag}", "o_over_l": e})
        log(f"[check] K6 {tag}: max|err| o/l {e:.3g}"
            + ("; repeat bit-identical" if dtype == torch.bfloat16 else ""))
        del q, k, v, got
    # 4 K/V chunks with nonzero k_offset merged by merge_partials; the query
    # rows 0..15 see nothing of chunks 1-3, and chunk 3 of rows 0..47
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(2, 2, 64, 64, 32, dtype)
        got = want = None
        for i in range(4):
            sl = slice(16 * i, 16 * (i + 1))
            args = (q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(), 0, 16 * i, True,
                    32 ** -0.5)
            pg, pw = att.block_partial_cuda(*args), att.block_partial_plain(*args)
            got = pg if got is None else att.merge_partials(got, pg)
            want = pw if want is None else att.merge_partials(want, pw)
        dead = att.block_partial_cuda(q[:, :, :16].contiguous(), k[:, :, 48:].contiguous(),
                                      v[:, :, 48:].contiguous(), 0, 48, True, 32 ** -0.5)
        if not (bool((dead[1] == att.NEG_INF).all()) and bool((dead[2] == 0).all())
                and bool((dead[0] == 0).all())):
            raise AssertionError("K6: a fully future chunk must give m=-1e30, l=0, o=0")
        e = assert_close(f"K6 4-chunk merge {dtype}", att.normalize_partial(*got),
                         att.normalize_partial(*want), 0.0, 2e-5)
        err["attention"] = max(err["attention"], e)
        cases.append({"case": f"K6 4-chunk merge {dtype}", "out": e})
        log(f"[check] K6 4 chunks merged, {dtype}: max|err| {e:.3g}; dead chunk exact")
    torch.cuda.synchronize()

    # K5: the LM path's rows, the char vocab, an odd vocab, ragged N
    for n, v in ((XENT_B[0], XENT_B[1]), (4 * 80, 90), (100, 1003), (37, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"[{n}x{v} {str(dtype).split('.')[1]}]"
            lg = torch.tensor((rng.normal(size=(n, v)) * 3).astype(np.float32), device=dev).to(dtype)
            lb = torch.tensor(rng.integers(0, v, n), device=dev)
            # f32 sums over V terms in other orders: 2e-5 absolute at losses ~10
            e = assert_close(f"K5 {tag}", xe.xent_cuda(lg, lb), xe.xent_plain(lg, lb), 0.0, 2e-5)
            e32 = assert_close(f"K5 int32 labels {tag}", xe.xent_cuda(lg, lb.int()),
                               xe.xent_plain(lg, lb), 0.0, 2e-5)
            err["xent"] = max(err["xent"], e, e32)
            cases.append({"case": f"K5 {tag}", "loss": max(e, e32)})
            log(f"[check] K5 {tag}: max|err| {max(e, e32):.3g}")
    torch.cuda.synchronize()

    # a small TransformerLM (head dim 32, remat) on the card through K6/K5
    # vs the CPU's plain path, same weights and tokens (f32, TF32 off)
    from fedml_tpu_torch.models.transformer import TransformerLM

    kw = dict(vocab_size=97, dim=64, heads=2, layers=2, max_len=64, remat=True,
              attn_impl="pallas")
    cpu = TransformerLM(**kw)
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = TransformerLM(**kw)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.tensor(rng.integers(0, 97, (3, 40)))
    y = torch.tensor(rng.integers(0, 97, (3, 40)))
    att.reset_launches()
    xe.reset_launches()
    losses = []
    for m, dv in ((cpu, "cpu"), (gpu, dev)):
        logits = m(x.to(dv))
        loss = xe.masked_cross_entropy(logits, y.to(dv), impl="pallas").mean()
        loss.backward()
        losses.append((logits.detach().cpu(), loss.detach().cpu()))
    torch.cuda.synchronize()
    ran = (att.LAUNCHES["attention"], xe.LAUNCHES["xent"])
    if ran != (4, 1):
        raise AssertionError(f"small LM: expected 4 K6 (2 blocks, forward + remat) and 1 K5 "
                             f"launches on the card, got {ran}")
    worst = 0.0
    pairs = [("logits", losses[1][0], losses[0][0]), ("loss", losses[1][1], losses[0][1])]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-4:
            raise AssertionError(f"small LM {name}: relative L2 error {rel:.3g} >= 1e-4")
    log(f"[check] small TransformerLM GPU kernels vs CPU plain: worst relative L2 error "
        f"{worst:.3g}")
    return err, cases, worst


def phase_time_lm(sm_clock_mhz: float):
    """K6 and K5 at path (B)'s shapes (bf16 q, k, v [2, 8, 8192, 32] causal;
    f32 logits [16384, 10004]) beside their plain versions, the library
    yardsticks and their bounds. K6's bound is the largest of its bytes,
    its tensor-core FLOPs and its exponentials at ``sm_clock_mhz``."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe

    rng = np.random.default_rng(SEED + 6)
    dev = torch.device("cuda")
    slow = dict(iters=5, repeats=3, warmup=2)
    b, h, tq, tk, d = ATTN_B
    q, k, v = (torch.tensor(rng.normal(size=(b, h, tq, d)).astype(np.float32), device=dev)
               .to(torch.bfloat16) for _ in range(3))
    sc = d ** -0.5
    fns = {"": lambda: att.block_partial_cuda(q, k, v, 0, 0, True, sc),
           "plain_": lambda: att.block_partial_plain(q, k, v, 0, 0, True, sc),
           "library_": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
    rows = []
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn, **(slow if prefix == "plain_" else {}))
        rec[f"{prefix}device_ms"] = device_ms(fn, iters=5)
        rec[f"{prefix}queued_ms"] = queued_device_ms(
            fn, sm_clock_mhz, **(dict(iters=2, repeats=1) if prefix == "plain_" else {}))
    nbytes, flops, live = attention_bound(b, h, tq, tk, d, True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "tensor-core FLOPs": flops / PEAK_BF16_FLOPS * 1e3,
             "exponentials": exp_ms(live, sm_clock_mhz, n_sm)}
    rec["bound_ms"] = max(terms.values())
    rec["bound_by"] = "bytes" if terms["bytes"] == rec["bound_ms"] else "operations"
    rec.update(kernel="attention", shape=[b, h, tq, tk, d], dtype="bfloat16", causal=True,
               calls_per_step=LM_K6_PER_STEP, gflop=flops / 1e9, live_scores=live,
               bound_parts=terms, sm_clock_mhz=sm_clock_mhz, n_sm=n_sm)
    log(f"[time] attention bound terms at {sm_clock_mhz:.0f} MHz x {n_sm} SMs: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in terms.items()))
    rows.append(rec)
    del q, k, v
    n, vv = XENT_B
    lg = torch.tensor(rng.normal(size=(n, vv)).astype(np.float32), device=dev)
    lb = torch.tensor(rng.integers(0, vv, n), device=dev)
    fns = {"": lambda: xe.xent_cuda(lg, lb), "plain_": lambda: xe.xent_plain(lg, lb),
           "library_": lambda: F.cross_entropy(lg, lb, reduction="none")}
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn, iters=20)
        rec[f"{prefix}device_ms"] = device_ms(fn)
        rec[f"{prefix}queued_ms"] = queued_device_ms(fn, sm_clock_mhz, iters=20)
    nbytes, flops = xent_bound(n, vv)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec.update(kernel="xent", shape=[n, vv], dtype="float32", calls_per_step=1)
    rows.append(rec)
    for rec in rows:
        us = {k: ("n/m" if val is None else f"{val:.4f}") for k, val in rec.items()
              if k.endswith("ms") and k != "bound_ms"}
        log(f"[time] {rec['kernel']} {rec['shape']} {rec['dtype']}: kernel {us['ms']} ms "
            f"(device {us['device_ms']}, queued {us['queued_ms']}), plain {us['plain_ms']} "
            f"(device {us['plain_device_ms']}, queued {us['plain_queued_ms']}), library "
            f"{us['library_ms']} (device {us['library_device_ms']}, queued "
            f"{us['library_queued_ms']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    torch.cuda.synchronize()
    return rows


def phase_train_lm_fedavg(smi: str):
    """Path (A): 2 FedAvg rounds of the registered ``transformer`` (dim 256,
    8 heads, 4 layers, bf16 compute, f32 parameters) on the synthetic
    fed_shakespeare federation (100 clients, vocab 90, sequences of 80),
    10 clients a round, batch 4, SGD lr 0.1 momentum 0.9; then
    evaluate_global. Checks 4 K6 per live step and per eval batch, and no
    other kernel."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.shakespeare import load_fed_shakespeare
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl
    from fedml_tpu_torch.ops import xent as xe

    tag = "[train transformer/fed_shakespeare]"
    t0 = time.perf_counter()
    ds = load_fed_shakespeare(data_dir=str(ROOT / "data" / "fed_shakespeare" / "datasets"),
                              client_num_in_total=100, batch_size=4, seed=SEED)
    cfg = FedConfig(model="transformer", dataset="fed_shakespeare", client_num_in_total=100,
                    client_num_per_round=10, comm_round=2, batch_size=4, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                    async_rounds=True)
    bundle = create_model("transformer", ds.class_num, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, attn_impl="auto")
    api = FedAvgAPI(ds, cfg, bundle)
    torch.cuda.synchronize()
    seq_len = ds.train_x.shape[2]
    log(f"{tag} set-up (data {ds.train_x.shape}, {ds.name}, model, placement) "
        f"{time.perf_counter() - t0:.1f} s")
    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    mods = (att, xe, bn, cl)
    for mod in mods:
        mod.reset_launches()
    r0 = replays(api)
    rounds = []
    for r in range(cfg.comm_round):
        t = time.perf_counter()
        loss = float(api.run_round(r))
        dt = time.perf_counter() - t
        real, executed = api.round_counts(r)
        rounds.append({"round": r, "loss": loss, "seconds": dt, "real_sequences": real,
                       "executed_sequences": executed, "real_tokens_per_s": real * seq_len / dt})
        log(f"{tag} round {r}: loss {loss:.4f}, {dt:.2f} s, {real} real sequences "
            f"({executed} executed), {real * seq_len / dt:.1f} real tokens/s")
        if not np.isfinite(loss):
            raise AssertionError(f"round {r} loss is not finite: {loss}")
    trained = {k: val for mod in mods for k, val in mod.LAUNCHES.items()}
    if replays(api) - r0 != steps:
        raise AssertionError(f"{tag} the rounds replayed the captured step "
                             f"{replays(api) - r0} times for {steps} live steps")
    t = time.perf_counter()
    metrics = api.evaluate_global()
    eval_s = time.perf_counter() - t
    launches = {k: val for mod in mods for k, val in mod.LAUNCHES.items()}
    train_s = sum(r["seconds"] for r in rounds)
    tokens = sum(r["real_sequences"] for r in rounds) * seq_len
    log(f"{tag} evaluate_global: {metrics} in {eval_s:.2f} s; launches {launches}")
    log(f"{tag} {len(rounds)} rounds in {train_s:.2f} s: {len(rounds) / train_s:.4f} rounds/s, "
        f"{tokens / train_s:.1f} real tokens/s over {steps} live steps; {smi}")
    if not (np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0):
        raise AssertionError(f"evaluate_global gave {metrics}")
    eval_batches = -(-ds.test_x.shape[0] // EVAL_BATCH)
    layers = bundle.module.layers
    for k in trained:
        want = layers * steps if k == "attention" else 0
        if trained[k] != want:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {want}")
        want_eval = layers * eval_batches if k == "attention" else 0
        if launches[k] - trained[k] != want_eval:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected {want_eval}")
    arms = capture_arms(api, tag, smi, graph_kernels={"flash_fwd_": layers})
    return {"rounds": rounds, "eval": metrics, "eval_s": eval_s, "steps": steps,
            "eval_batches": eval_batches, "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s, "real_tokens_per_s": tokens / train_s,
            "step_profile": arms["profiles"]["captured"], "capture": arms}


def phase_train_lm_step(smi: str, steps: int = 5):
    """Path (B): the one-card LM train step (make_sp_lm_train_step on a 1x1
    mesh) of ``transformer_nwp`` at its widths (vocab 10004, dim 256, 8
    heads, 4 layers), T = 8192, batch 2, bf16, remat, attn_impl="pallas",
    SGD lr 0.1, ``steps`` steps on one fixed batch cut from a synthetic
    token stream. Checks 8 K6 and 1 K5 per step and a falling loss, then
    profiles one more step."""
    import torch
    from torch.autograd import DeviceType

    from fedml_tpu_torch.data.shakespeare import _synthetic_nwp
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe
    from fedml_tpu_torch.parallel.local import make_optimizer
    from fedml_tpu_torch.parallel.sequence import make_sp_lm_train_step, sp_mesh

    tag = "[lm step T=8192]"
    dev = torch.device("cuda")
    b, vocab = LM_BATCH, XENT_B[1]
    t0 = time.perf_counter()
    ds = _synthetic_nwp("lm-stream", 1, vocab, LM_SEQ, b, SEED)
    x = torch.from_numpy(ds.train_x[0, :b]).to(dev)
    y = torch.from_numpy(ds.train_y[0, :b]).to(dev)
    mask = torch.ones((b, LM_SEQ), dtype=torch.float32, device=dev)
    bundle = create_model("transformer_nwp", vocab, seq_len=LM_SEQ, attn_impl="pallas", remat=True,
                          dtype=torch.bfloat16)
    bundle.init(SEED, dev)
    module = bundle.module
    step = make_sp_lm_train_step(module, sp_mesh(1, 1), attn_impl="pallas")
    opt = make_optimizer("sgd", 0.1)(module.parameters())
    torch.cuda.synchronize()
    log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; batch {tuple(x.shape)}")
    att.reset_launches()
    xe.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step(opt, x, y, mask)))
        secs.append(time.perf_counter() - t1)
    launches = {**att.LAUNCHES, **xe.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    tokens = b * LM_SEQ
    steady = secs[1:] or secs
    ms = float(np.mean(steady)) * 1e3
    log(f"{tag} losses {[round(v, 4) for v in losses]}; ms/step {[round(s * 1e3, 1) for s in secs]}"
        f" (mean of steps 2-{steps}: {ms:.1f}); {tokens / ms * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss must be finite and fall: {losses}")
    want = {"attention": LM_K6_PER_STEP * steps, "xent": steps}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}; expected {want}")
    _, events = profiled(lambda: step(opt, x, y, mask), f"{tag} step")
    by_family, n = {}, 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            n += 1
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(by_family.values())
    log(f"{tag} profiled step: device {total:.2f} ms (busy share {total / ms:.3f} of the "
        f"unprofiled step), {n} GPU activities; device ms by family "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])))
    return {"losses": losses, "seconds": secs, "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
            "peak_memory_bytes": peak, "launches": launches, "device_ms_per_step": total,
            "device_busy_share": total / ms, "gpu_activities_per_step": n,
            "device_ms_per_step_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))}


# -- phase 19: the mesh axes beyond clients (sp, tp, ep, pp, dp) -------------------------

MESH_SP = 4                 # virtual ranks of the ring on one card (phase 19a)
MESH_STEPS = 5
MESH_N_MICRO = 2
# K6 and K5 launches a step of each builder at one rank, path (B)'s shapes:
# sp runs path (B)'s remat module (each block's K6 twice), tp and the MoE
# LM no remat (once), the pipeline layers x n_micro forwards; K5 once
MESH_K6 = {"sp": 8, "tp": 4, "pp": 4 * MESH_N_MICRO, "moe": 4}
MESH_GATE_T = 512           # the f32 gate's sequence (batch 2, transformer_nwp widths)
MESH_GATE = 1e-5            # relative norm of any tensor against the single-device step
# the ring's bf16 output against dense K6: both round an f32 value that
# differs in its last bits (the ring merges 4 partials), so one bf16 ulp may
# flip; f32 output against the plain ring as K6's o/l (atol 2e-5), the
# gradients (the plain recompute behind cotangents of m and l) rtol 1e-4
RING_TOL = {"bf16": (1e-2, 1e-2), "out": (0.0, 2e-5), "grad": (1e-4, 1e-4)}
DP_DATA = dict(num_clients=4, records_per_client=256, batch_size=64)


class VirtualRing:
    """Virtual rank ``index`` of a ring whose every shard lies on this card
    (``ring_attention``'s ``hop`` seam): hop i hands over the shard of rank
    ``index - i``, as the ring's i-th ``ppermute`` would."""

    def __init__(self, ks, vs, index):
        self.ks, self.vs, self.index, self.hops = ks, vs, index, 0

    def __call__(self, k, v):
        self.hops += 1
        src = (self.index - self.hops) % len(self.ks)
        return self.ks[src], self.vs[src]


def virtual_ring(q, k, v, impl: str):
    """Ring attention of ``MESH_SP`` virtual ranks, one after the other,
    their outputs concatenated back along T."""
    import torch

    from fedml_tpu_torch.parallel.sequence import ring_attention

    qs, ks, vs = (torch.chunk(t, MESH_SP, dim=2) for t in (q, k, v))
    return torch.cat([ring_attention(qs[i], ks[i], vs[i], axis_name="sp", axis_size=MESH_SP,
                                     impl=impl, hop=VirtualRing(ks, vs, i))
                      for i in range(MESH_SP)], dim=2)


def virtual_all_to_all(shards: list, split: int, concat: int) -> list:
    """The tiled all-to-all of ``parallel/collectives.all_to_all`` over
    virtual ranks whose shards all lie on this card: chunk j of rank i's
    ``split`` axis goes to rank j, which concatenates what it receives along
    ``concat`` in rank order."""
    import torch

    parts = [torch.chunk(s, len(shards), dim=split) for s in shards]
    return [torch.cat([p[j] for p in parts], dim=concat) for j in range(len(shards))]


def virtual_ulysses(q, k, v, impl: str):
    """Ulysses' layout over ``MESH_SP`` virtual ranks: each rank's sequence
    shard resharded to its H / n heads of the whole sequence, K6 there (one
    launch a rank), and the inverse reshard; the outputs concatenated back
    along T."""
    import torch

    from fedml_tpu_torch.ops.attention import attention

    qs, ks, vs = (virtual_all_to_all(list(torch.chunk(t, MESH_SP, dim=2)), 1, 2)
                  for t in (q, k, v))
    outs = [attention(a.contiguous(), b.contiguous(), c.contiguous(), impl=impl)
            for a, b, c in zip(qs, ks, vs)]
    return torch.cat(virtual_all_to_all(outs, 2, 1), dim=2)


def ring_check(smi: str) -> dict:
    """Phase 19a: path (B)'s q/k/v (T = 8192, Tl = 2048) through the ring of
    4 virtual ranks: bf16 K6 against dense K6, its launches, its time; in
    f32 the ring's output and q/k/v gradients against the plain ring's;
    Ulysses' layout of 4 virtual ranks (K6 on H/4 heads of the whole
    sequence) against dense K6."""
    import torch

    from fedml_tpu_torch.ops import attention as att

    b, h, t, _, d = ATTN_B
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda") for _ in range(3))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    att.reset_launches()
    ring = virtual_ring(qb, kb, vb, "pallas")
    launches = att.LAUNCHES["attention"]
    if launches != MESH_SP * MESH_SP:
        raise AssertionError(f"[mesh ring] {launches} K6 launches a ring forward; expected "
                             f"{MESH_SP * MESH_SP}")
    dense = att.attention(qb, kb, vb, impl="pallas")
    err_bf16 = assert_close("[mesh ring] bf16 ring vs dense K6", ring, dense, *RING_TOL["bf16"])
    ring_ms = cuda_time_ms(lambda: virtual_ring(qb, kb, vb, "pallas"), iters=3, repeats=3,
                           warmup=1)
    dense_ms = cuda_time_ms(lambda: att.attention(qb, kb, vb, impl="pallas"), iters=3,
                            repeats=3, warmup=1)
    att.reset_launches()
    uly = virtual_ulysses(qb, kb, vb, "pallas")
    uly_launches = att.LAUNCHES["attention"]
    if uly_launches != MESH_SP:
        raise AssertionError(f"[mesh ring] {uly_launches} K6 launches a Ulysses forward; "
                             f"expected {MESH_SP}")
    err_uly = assert_close("[mesh ring] bf16 Ulysses vs dense K6", uly, dense,
                           *RING_TOL["bf16"])
    uly_ms = cuda_time_ms(lambda: virtual_ulysses(qb, kb, vb, "pallas"), iters=3, repeats=3,
                          warmup=1)
    ct = torch.randn((b, h, t, d), generator=g, device="cuda")
    outs, grads = [], []
    for impl in ("pallas", "xla"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = virtual_ring(*leaves, impl)
        (out * ct).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad for x in leaves])
    err_out = assert_close("[mesh ring] f32 ring K6 vs plain", outs[0], outs[1], *RING_TOL["out"])
    err_grad = max(assert_close(f"[mesh ring] f32 d{n} K6 vs plain", a, p, *RING_TOL["grad"])
                   for n, a, p in zip("qkv", *grads))
    rec = {"shape": [b, h, t, d], "virtual_ranks": MESH_SP, "k6_launches_a_forward": launches,
           "bf16_vs_dense_max_abs_err": err_bf16, "f32_out_max_abs_err": err_out,
           "f32_grad_max_abs_err": err_grad, "ring_ms": ring_ms, "dense_ms": dense_ms,
           "ulysses_k6_launches_a_forward": uly_launches,
           "ulysses_bf16_vs_dense_max_abs_err": err_uly,
           "ulysses_bit_identical": bool(torch.equal(uly, dense)), "ulysses_ms": uly_ms}
    log(f"[mesh ring] sp={MESH_SP} virtual ranks on one card, [B,H,T,D]={rec['shape']} bf16: "
        f"{launches} K6 a forward, {ring_ms:.3f} ms (dense K6 {dense_ms:.3f} ms), max|err| vs "
        f"dense {err_bf16:.3g}; f32 vs the plain ring: out {err_out:.3g}, grads {err_grad:.3g}; "
        f"Ulysses' layout: {uly_launches} K6 on [B,H/{MESH_SP},T,D] a forward, {uly_ms:.3f} ms, "
        f"max|err| vs dense {err_uly:.3g} (bit for bit: {rec['ulysses_bit_identical']}); {smi}")
    return rec


def _lm_batch(t: int, b: int = LM_BATCH):
    import torch

    from fedml_tpu_torch.data.shakespeare import _synthetic_nwp

    ds = _synthetic_nwp("lm-stream", 1, XENT_B[1], t, b, SEED)
    x = torch.from_numpy(ds.train_x[0, :b]).cuda()
    y = torch.from_numpy(ds.train_y[0, :b]).cuda()
    return x, y, torch.ones((b, t), dtype=torch.float32, device=x.device)


def mesh_builder(kind: str, t: int, dtype):
    """``(run, params)`` of one builder at one rank over the bound NCCL
    group: ``run()`` is one step of ``kind`` (sp, tp, pp or moe) on a
    fresh ``transformer_nwp``-wide model from seed ``SEED``; ``params()``
    its whole state dict."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.moe import MoeTransformerLM
    from fedml_tpu_torch.parallel import pipeline as pp
    from fedml_tpu_torch.parallel import tensor as tp
    from fedml_tpu_torch.parallel.local import make_optimizer
    from fedml_tpu_torch.parallel.sequence import make_sp_lm_train_step, sp_mesh

    x, y, m = _lm_batch(t)
    if kind == "moe":
        module = MoeTransformerLM(XENT_B[1], max_len=max(4096, t), attn_impl="pallas",
                                  dtype=dtype)
        module.reset_parameters(torch.Generator().manual_seed(SEED))
        module.cuda()
    else:
        module = create_model("transformer_nwp", XENT_B[1], seq_len=t, attn_impl="pallas",
                              remat=kind == "sp", dtype=dtype).module
        module.reset_parameters(torch.Generator().manual_seed(SEED))
        module.cuda()
    sgd = make_optimizer("sgd", 0.1)
    if kind == "sp":
        step, opt = make_sp_lm_train_step(module, sp_mesh(1, 1), attn_impl="pallas"), \
            sgd(module.parameters())
        return (lambda: step(opt, x, y, m)), module.state_dict
    if kind == "pp":
        mesh = pp.pp_mesh(1, 1)
        params = pp.place_pp_params(pp.stack_pipeline_params(module.state_dict(),
                                                             module.layers), mesh)
        opt = sgd(pp.pipeline_parameters(params))
        step = pp.make_pp_lm_train_step(module, mesh, n_micro=MESH_N_MICRO, attn_impl="pallas")
        return (lambda: step(params, opt, x, y, m)), \
            (lambda: pp.unstack_pipeline_params(params, module.layers))
    mesh = (tp.ep_mesh if kind == "moe" else tp.tp_mesh)(1, 1)
    twin = (tp.shard_params_ep if kind == "moe" else tp.shard_params_tp)(module, mesh)
    step, opt = tp.make_tp_lm_train_step(twin, mesh), sgd(twin.parameters())
    return (lambda: step(opt, x, y, m)), (lambda: tp.gather_params(twin, mesh))


def plain_lm_step(kind: str, t: int) -> dict:
    """The single-device step (no mesh, no collective) of ``kind``'s model
    from seed ``SEED``, f32: the module's state dict after one SGD step."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.moe import MoeTransformerLM
    from fedml_tpu_torch.ops.xent import masked_cross_entropy
    from fedml_tpu_torch.parallel.local import make_optimizer

    x, y, m = _lm_batch(t)
    if kind == "moe":
        module = MoeTransformerLM(XENT_B[1], max_len=max(4096, t), attn_impl="pallas")
    else:
        module = create_model("transformer_nwp", XENT_B[1], seq_len=t, attn_impl="pallas",
                              remat=kind == "sp").module
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.cuda()
    opt = make_optimizer("sgd", 0.1)(module.parameters())
    per = masked_cross_entropy(module(x), y, m, impl="pallas")
    (per.sum() / m.sum()).backward()
    opt.step()
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _rel_state(a: dict, b: dict) -> float:
    import torch

    if set(a) != set(b):
        raise AssertionError(f"state dicts differ in keys: {sorted(set(a) ^ set(b))[:6]}")
    a = {k: v.detach().float() for k, v in a.items()}
    return max(float(torch.linalg.vector_norm(a[k] - b[k].float()))
               / max(float(torch.linalg.vector_norm(b[k].float())), 1e-30) for k in b)


def mesh_builder_arm(kind: str, smi: str) -> dict:
    """Phase 19b/c: ``kind``'s builder at path (B)'s shapes, bf16: 5 steps
    with a falling loss, its K6/K5 launches a step, ms/step, tokens/s, peak
    memory, device ms by family of one profiled step; then the f32 gate at
    T = ``MESH_GATE_T``: one step against the single-device step."""
    import torch
    from torch.autograd import DeviceType

    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe

    tag = f"[mesh {kind}]"
    run, _ = mesh_builder(kind, LM_SEQ, torch.bfloat16)
    torch.cuda.synchronize()
    att.reset_launches()
    xe.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(MESH_STEPS):
        t1 = time.perf_counter()
        losses.append(float(run()))
        secs.append(time.perf_counter() - t1)
    launches = {**att.LAUNCHES, **xe.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    want = {"attention": MESH_K6[kind] * MESH_STEPS, "xent": MESH_STEPS}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}; expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss must be finite and fall: {losses}")
    ms = float(np.mean(secs[1:])) * 1e3
    tokens = LM_BATCH * LM_SEQ
    _, events = profiled(run, f"{tag} step")
    by_family = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(by_family.values())
    del run
    gate_run, gate_params = mesh_builder(kind, MESH_GATE_T, torch.float32)
    gate_run()
    rel = _rel_state(gate_params(), plain_lm_step(kind, MESH_GATE_T))
    if not rel <= MESH_GATE:
        raise AssertionError(f"{tag} f32 step at T={MESH_GATE_T} is {rel:.3g} (relative norm) "
                             f"from the single-device step; bound {MESH_GATE}")
    rec = {"losses": losses, "seconds": secs, "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "peak_memory_bytes": peak, "launches": launches,
           "k6_per_step": MESH_K6[kind], "k5_per_step": 1, "device_ms_per_step": total,
           "device_ms_per_step_by_family": dict(sorted(by_family.items(),
                                                       key=lambda kv: -kv[1])),
           "f32_gate_rel": rel}
    log(f"{tag} T={LM_SEQ} batch {LM_BATCH} bf16 at one rank over NCCL: losses "
        f"{[round(v, 4) for v in losses]}; {ms:.1f} ms/step, {rec['tokens_per_s']:.1f} tokens/s, "
        f"peak {peak / 2**30:.2f} GiB; {MESH_K6[kind]} K6 + 1 K5 a step; device "
        f"{total:.2f} ms a profiled step: " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["device_ms_per_step_by_family"].items())
        + f"; f32 gate at T={MESH_GATE_T}: {rel:.3g} from the single-device step; {smi}")
    return rec


def dp_data():
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    return make_synthetic_classification(
        "cifar10-dp", (32, 32, 3), 10, DP_DATA["num_clients"],
        records_per_client=DP_DATA["records_per_client"], partition_method="homo",
        batch_size=DP_DATA["batch_size"], seed=SEED)


def streaming_trainer(ds, dtype: str, mesh):
    import torch

    from fedml_tpu_torch.algorithms.centralized import StreamingCentralizedTrainer
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models import create_model

    cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=ds.num_clients,
                    client_num_per_round=ds.num_clients, comm_round=1,
                    batch_size=DP_DATA["batch_size"], epochs=1, lr=0.1, momentum=0.9,
                    dtype=dtype, frequency_of_the_test=1, seed=SEED)
    bundle = create_model("resnet56", 10, input_shape=(32, 32, 3), bn_impl="pallas",
                          dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return StreamingCentralizedTrainer(ds, cfg, bundle, mesh=mesh)


def dp_arm(smi: str) -> dict:
    """Phase 19d: data parallelism at one rank over the NCCL group. The
    streaming trainer with a one-rank batch mesh on the bf16 ResNet-56
    flagship (K1/K2 57 a step, images/s); then, f32 under cuDNN's
    deterministic algorithms, the streaming trainer and one FedGKT round
    with ``server_mesh``, each against its mesh-less run."""
    import torch

    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models.gkt import create_gkt_pair
    from fedml_tpu_torch.ops import batchnorm as bnk
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh

    ds = dp_data()
    mesh = batch_mesh(1)
    steps = ds.train_counts.sum() // DP_DATA["batch_size"]
    tr = streaming_trainer(ds, "bfloat16", mesh)
    torch.cuda.synchronize()
    bnk.reset_launches()
    t0 = time.perf_counter()
    hist = tr.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(bnk.LAUNCHES)
    if launches != {"bn_fwd": BNS_PER_STEP * steps, "bn_bwd": BNS_PER_STEP * steps}:
        raise AssertionError(f"[mesh dp] K1/K2 {launches} over {steps} steps; expected "
                             f"{BNS_PER_STEP} each a step")
    if not np.isfinite(hist["Test/Loss"][-1]):
        raise AssertionError(f"[mesh dp] non-finite evaluation: {hist}")
    del tr
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for m in (None, mesh):
            tr = streaming_trainer(ds, "float32", m)
            tr.train()
            runs.append(tr.variables)
        stream_rel = _rel_state(runs[1], runs[0])
        gds = dp_data()
        cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=4,
                        client_num_per_round=4, comm_round=1, batch_size=64, epochs=1,
                        epochs_server=1, lr=0.1, frequency_of_the_test=10_000, seed=SEED)
        gkt = []
        for m in (None, mesh):
            pair = create_gkt_pair(10, (32, 32, 3), 3, 9, dtype=torch.float32, bn_impl="pallas")
            api = FedGKTAPI(gds, cfg, pair, server_mesh=m)
            api.run_round(0)
            gkt.append({**api.server_vars, "server_logits": api.server_logits})
        gkt_rel = _rel_state(gkt[1], gkt[0])
    finally:
        torch.backends.cudnn.deterministic = cudnn
    if not (stream_rel <= MESH_GATE and gkt_rel <= MESH_GATE):
        raise AssertionError(f"[mesh dp] one-rank mesh vs no mesh, f32: streaming {stream_rel:.3g}"
                             f", GKT server {gkt_rel:.3g}; bound {MESH_GATE}")
    images = steps * DP_DATA["batch_size"]
    rec = {"steps": int(steps), "seconds": secs, "images_per_s": images / secs,
           "launches": launches, "test": {k: v[-1] for k, v in hist.items()},
           "f32_streaming_rel": stream_rel, "f32_gkt_server_rel": gkt_rel}
    log(f"[mesh dp] StreamingCentralizedTrainer on a one-rank NCCL batch mesh, bf16 ResNet-56: "
        f"{steps} steps in {secs:.2f} s ({images / secs:.1f} images/s, eval included), K1/K2 "
        f"{launches}; f32 against the mesh-less runs: streaming {stream_rel:.3g}, FedGKT "
        f"server {gkt_rel:.3g}; {smi}")
    return rec


def phase_train_mesh_axes(smi: str) -> dict:
    """Phase 19: the ring of 4 virtual ranks on one card, then under a
    world-size-1 NCCL group (a ``file://`` store in a temporary directory)
    the sp, tp and pp builders, the MoE LM on a one-rank ep mesh and data
    parallelism (streaming trainer, FedGKT's server)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from fedml_tpu_torch.parallel.mesh import init_multihost

    ring = ring_check(smi)
    tmp = tempfile.mkdtemp(prefix="mesh-store-")
    try:
        init_multihost(f"file://{tmp}/store", 1, 0, timeout_s=120)
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"[mesh] the one-rank group runs {backend}, not NCCL")
        arms = {kind: mesh_builder_arm(kind, smi) for kind in ("sp", "tp", "pp", "moe")}
        dp = dp_arm(smi)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"attention": sum(a["launches"]["attention"] for a in arms.values()),
                "xent": sum(a["launches"]["xent"] for a in arms.values()), **dp["launches"]}
    return {"ring": ring, "builders": arms, "dp": dp, "backend": backend, "launches": launches}


# -- phase 20: the FedAvg edge runtime ------------------------------------------

# (a) the f32 gate: JAX's equivalence set-up (tests/test_fedavg_edge.py:41-60)
# at ResNet-56's full width and depth, full-batch epochs (128 records a
# client, batch 128), one client a worker
EDGE_GATE = dict(clients=8, records=128, workers=4, rounds=2)
# JAX's tolerances of the edge against the simulation
# (tests/test_fedavg_edge.py:70-77): weights rtol / atol, acc rtol, loss rtol
EDGE_TOL = dict(rtol=1e-5, atol=1e-6, acc=1e-6, loss=1e-4)
# the streaming aggregator against the batch one (tests/test_fedsched.py:35)
EDGE_STREAM_TOL = dict(rtol=1e-6, atol=1e-7)
# (b) the flagship federation over 8 workers: 1 warm round, then 2 timed
EDGE_WORKERS = 8
EDGE_ROUNDS = 3


def edge_gate_data():
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    g = EDGE_GATE
    return make_synthetic_classification(
        "edge-gate", (32, 32, 3), 10, g["clients"], records_per_client=g["records"],
        partition_method="homo", batch_size=g["records"], seed=SEED)


class EdgeRecorder:
    """What phase 20 reads of an edge run without touching the port: the
    aggregator's round closes (time, accepted weight, kernel launches and
    codec totals at each), the workers' local training wrapped in CUDA
    events, and the uploads of round 0 (``keep_uploads``)."""

    def __init__(self, keep_uploads: bool = False, profile_round: Optional[int] = None):
        self.closes = []
        #: a round profiled whole (torch.profiler, CUDA activity only, from
        #: the close of the round before to its own close) and its reading
        self.profile_round = profile_round
        self.profile = None
        self._prof = None
        self.spans = []
        #: (round, what, host seconds): local_train_s, worker_call_s, aggregate_s
        self.host = []
        self.uploads = {} if keep_uploads else None
        self.codec = {"encode_s": 0.0, "decode_s": 0.0, "bytes": 0, "messages": 0}
        self.t0 = None

    def aggregator_cls(self, base):
        rec = self

        class Recording(base):
            def add_local_trained_result(self, index, model_params, sample_num):
                if rec.uploads is not None and not rec.closes:
                    rec.uploads[index] = ({k: v.copy() for k, v in model_params.items()},
                                          float(sample_num))
                super().add_local_trained_result(index, model_params, sample_num)

            def aggregate(self):
                from fedml_tpu_torch.ops import batchnorm as bn

                rec.closes.append({"t": time.perf_counter(),
                                   "weight": sum(self.sample_num_dict[i] for i in self.model_dict),
                                   "launches": dict(bn.LAUNCHES), "codec": dict(rec.codec)})
                rec.profile_step(len(rec.closes) - 1)
                t = time.perf_counter()
                out = super().aggregate()
                rec.host.append((len(rec.closes), "aggregate_s", time.perf_counter() - t))
                rec.closes[-1]["finite"] = all(bool(np.isfinite(v).all()) for v in out.values())
                return out

        return Recording

    def profile_step(self, closed: int) -> None:
        """At the close of round ``closed`` (on the server's thread): open
        the profile window before the profiled round, close it at its end.
        Every upload of a round follows its worker's copy out, so the
        round's device work is done when it closes."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.profile_round is None:
            return
        if closed == self.profile_round - 1:
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._prof_t0 = time.perf_counter()
        elif closed == self.profile_round:
            torch.cuda.synchronize()
            self._prof.stop()
            wall = time.perf_counter() - self._prof_t0
            spans = sorted((e.start_ns(), e.end_ns())
                           for e in self._prof.profiler.kineto_results.events()
                           if e.device_type() == torch.autograd.DeviceType.CUDA)
            busy, end = 0, None
            for a, b in spans:          # the union of the device's intervals
                if end is None or a > end:
                    busy += b - a
                    end = b
                elif b > end:
                    busy += b - end
                    end = b
            self.profile = {"round": closed, "wall_s": wall, "device_activities": len(spans),
                            "device_busy_ms": busy / 1e6, "busy_share": busy / 1e9 / wall}
            self._prof = None

    def comm_cls(self):
        from fedml_tpu_torch.comm import Message
        from fedml_tpu_torch.comm.local import LocalCommunicationManager

        rec = self

        class TimedLocal(LocalCommunicationManager):
            """The local transport's wire round trip, encode and decode
            timed apart."""

            def send_message(self, msg):
                t = time.perf_counter()
                buf = msg.to_bytes(msg.codec or self.codec)
                t1 = time.perf_counter()
                out = Message.from_bytes(buf)
                t2 = time.perf_counter()
                c = rec.codec
                c["encode_s"] += t1 - t
                c["decode_s"] += t2 - t1
                c["bytes"] += len(buf)
                c["messages"] += 1
                self.router.post(msg.get_receiver_id(), out)

        return TimedLocal

    def wrap_trainer(self, trainer) -> None:
        """CUDA events around each client's local training; host seconds of
        it and of the worker's whole call on the device thread (the copies
        in and out included)."""
        import torch

        fn, train, spans, host = trainer.local_train, trainer._train, self.spans, self.host

        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans.append((len(self.closes), s, e))
            host.append((len(self.closes), "local_train_s", time.perf_counter() - t))
            return out

        def timed_train(*a, **kw):
            t = time.perf_counter()
            out = train(*a, **kw)
            host.append((len(self.closes), "worker_call_s", time.perf_counter() - t))
            return out

        trainer.local_train = timed
        trainer._train = timed_train


def edge_run(ds, cfg, bundle, workers: int, rec: EdgeRecorder, comm_factory=None,
             init: Optional[dict] = None, wire_roundtrip: bool = True):
    """One edge federation built through the port's own seams
    (``build_edge_rank(..., bundle=, aggregator=)`` and
    ``comm.local.run_ranks``), recorded by ``rec``; returns the aggregator."""
    from fedml_tpu_torch.comm.local import LocalRouter, run_ranks
    from fedml_tpu_torch.distributed.fedavg_edge import (FedAVGAggregator,
                                                         StreamingFedAVGAggregator,
                                                         build_edge_rank)

    base = StreamingFedAVGAggregator if cfg.stream_aggregate != "off" else FedAVGAggregator
    agg = rec.aggregator_cls(base)(init if init is not None else bundle.init(cfg.seed), workers,
                                   cfg, dataset=ds, bundle=bundle)
    size = workers + 1
    if comm_factory is None:
        router = LocalRouter(size)
        timed = rec.comm_cls()

        def comm_factory(r):
            return timed(router, r, wire_roundtrip=wire_roundtrip, codec=cfg.wire_codec)

    def make(rank, comm):
        m = build_edge_rank(ds, cfg, rank, size, comm, bundle=bundle, aggregator=agg)
        if rank:
            rec.wrap_trainer(m.trainer)
        return m

    rec.t0 = time.perf_counter()
    run_ranks(make, size, comm_factory=comm_factory, timeout=600.0)
    return agg


def _max_rel(a: dict, b: dict) -> tuple:
    """(max |a - b|, max |a - b| / (atol + rtol |b|) over EDGE_TOL) of two
    state dicts."""
    worst, ratio = 0.0, 0.0
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        d = np.abs(x - y)
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (EDGE_TOL["atol"] + EDGE_TOL["rtol"] * np.abs(y))).max()))
    return worst, ratio


def edge_gate(smi: str) -> dict:
    """(a) f32 through K1/K2 under cuDNN's deterministic algorithms: the
    edge over the local transport with the wire round trip against the
    port's FedAvgAPI on the same bundle (given the edge's orders, and on its
    own), the same federation over the in-repo MQTT broker bit for bit, and
    the streaming aggregator on round 0's uploads against the batch one."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.core.rng import client_generator
    from fedml_tpu_torch.distributed.fedavg_edge import (FedAVGAggregator,
                                                         StreamingFedAVGAggregator)
    from fedml_tpu_torch.models import create_model

    tag = "[edge gate]"
    g = EDGE_GATE
    ds = edge_gate_data()
    n_pad = int(ds.train_x.shape[1])
    if n_pad != g["records"]:
        raise AssertionError(f"{tag} n_pad {n_pad}: the gate needs full-batch epochs")
    cfg = FedConfig(model="resnet56", dataset="edge-gate", client_num_in_total=g["clients"],
                    client_num_per_round=g["workers"], comm_round=g["rounds"],
                    batch_size=g["records"], epochs=1, lr=0.01, momentum=0.9,
                    frequency_of_the_test=1, seed=SEED)
    bundle = create_model("resnet56", 10, input_shape=(32, 32, 3), bn_impl="pallas")
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        init = bundle.init(cfg.seed)
        local_rec = EdgeRecorder(keep_uploads=True)
        local = edge_run(ds, cfg, bundle, g["workers"], local_rec, init=init)
        with MqttBroker(0) as broker:
            mqtt = edge_run(ds, cfg, bundle, g["workers"], EdgeRecorder(), init=init,
                            comm_factory=lambda r: MqttCommManager(
                                "127.0.0.1", broker.port, r, g["workers"]))

        def edge_orders(r, i):
            ci = int(api.sample(r)[i])
            gen = client_generator(cfg.seed, r, ci)
            return [torch.randperm(n_pad, generator=gen) for _ in range(cfg.epochs)]

        sims = {}
        for label, hook in (("edge_orders", edge_orders), ("own_orders", None)):
            api = FedAvgAPI(ds, cfg, bundle, order_hook=hook)
            api.variables = {k: v.clone() for k, v in init.items()}
            hist = api.train()
            sims[label] = (api.variables, hist)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    out = {}
    for label, (svars, hist) in sims.items():
        worst, ratio = _max_rel(local.variables, {k: v.cpu().numpy() for k, v in svars.items()})
        acc = [h["acc"] for h in local.test_history]
        loss = [h["loss"] for h in local.test_history]
        acc_d = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(acc, hist["Test/Acc"]))
        loss_d = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(loss, hist["Test/Loss"]))
        out[label] = {"weights_max_abs": worst, "weights_tol_ratio": ratio,
                      "acc_rel": acc_d, "loss_rel": loss_d, "edge_acc": acc, "sim_acc":
                      hist["Test/Acc"], "edge_loss": loss, "sim_loss": hist["Test/Loss"]}
        log(f"{tag} edge (local, wire round trip) against FedAvgAPI ({label}): weights max "
            f"|d| {worst:.3e} ({ratio:.3f} of rtol {EDGE_TOL['rtol']} / atol "
            f"{EDGE_TOL['atol']}), acc rel {acc_d:.3e}, loss rel {loss_d:.3e}; edge loss "
            f"{loss}, sim {hist['Test/Loss']}; {smi}")
    o = out["edge_orders"]
    if not (o["weights_tol_ratio"] <= 1.0 and o["acc_rel"] <= EDGE_TOL["acc"]
            and o["loss_rel"] <= EDGE_TOL["loss"]):
        raise AssertionError(f"{tag} the edge misses FedAvgAPI: {o}")
    same = all(np.array_equal(mqtt.variables[k], local.variables[k]) for k in local.variables)
    if not same or mqtt.test_history != local.test_history:
        raise AssertionError(f"{tag} the MQTT federation differs from the local one")
    log(f"{tag} MQTT federation over the in-repo broker = local transport, bit for bit")
    # the streaming aggregator on round 0's uploads: any arrival order bit
    # for bit in deterministic mode, and the batch mean within EDGE_STREAM_TOL
    ups = local_rec.uploads
    if len(ups) != g["workers"]:
        raise AssertionError(f"{tag} recorded {len(ups)} round-0 uploads")

    def streamed(order):
        agg = StreamingFedAVGAggregator(init, g["workers"],
                                        cfg.replace(stream_aggregate="deterministic"))
        for i in order:
            agg.add_local_trained_result(i, *ups[i])
        return agg, agg.aggregate()

    fwd, a = streamed(sorted(ups))
    rev, b = streamed(sorted(ups, reverse=True))
    batch = FedAVGAggregator(init, g["workers"], cfg)
    for i in sorted(ups):
        batch.add_local_trained_result(i, *ups[i])
    want = batch.aggregate()
    if not all(np.array_equal(a[k], b[k]) for k in a) or rev.stream_peak_held < 2:
        raise AssertionError(f"{tag} the deterministic fold depends on the arrival order")
    worst = 0.0
    for k in want:
        np.testing.assert_allclose(a[k], want[k], **EDGE_STREAM_TOL, err_msg=f"{tag} streaming {k}")
        worst = max(worst, float(np.abs(a[k].astype(np.float64) - want[k]).max()))
    log(f"{tag} streaming aggregator (deterministic) on round 0's {len(ups)} uploads: "
        f"arrival orders bit for bit (held {rev.stream_peak_held}), batch mean within "
        f"{worst:.3e} (rtol {EDGE_STREAM_TOL['rtol']} / atol {EDGE_STREAM_TOL['atol']}), "
        f"{fwd.stream_nbytes} accumulator bytes after the close; {smi}")
    return {"sim": out, "mqtt_bit_for_bit": True, "stream_max_abs": worst,
            "stream_peak_held": rev.stream_peak_held}


def edge_config(**config):
    """The flagship federation (phase 4's) for phase 20 (b): 8 workers of
    one client each, EDGE_ROUNDS rounds, bf16, evaluated after the last."""
    from fedml_tpu_torch.core.config import FedConfig

    return FedConfig(**{**dict(model="resnet56", dataset="cifar10", client_num_in_total=32,
                               client_num_per_round=EDGE_WORKERS, comm_round=EDGE_ROUNDS,
                               batch_size=64, epochs=1, lr=0.1, momentum=0.9,
                               dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED),
                        **config})


def edge_speed_arm(label: str, ds, bundle, smi: str, comm_factory=None, profile: bool = False,
                   **config) -> dict:
    """(b) One bf16 flagship federation: 8 workers of one client each over
    EDGE_ROUNDS rounds; round 0 warms up (the capture), rounds 1-2 are
    timed. Real images/s, K1/K2 a round (57 x the round's live steps,
    exactly), encode / decode ms and bytes a round, and the device-span
    share (CUDA events around each worker's local training over the round's
    wall: an upper bound of the busy share). With ``profile`` one more
    round runs under torch.profiler for the device's busy share (the union
    of its activity over the round's wall), outside the timed rounds."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    tag = f"[edge {label}]"
    cfg = edge_config(**config, **({"comm_round": EDGE_ROUNDS + 1} if profile else {}))
    rec = EdgeRecorder(profile_round=EDGE_ROUNDS if profile else None)
    bn.reset_launches()
    agg = edge_run(ds, cfg, bundle, EDGE_WORKERS, rec, comm_factory=comm_factory)
    torch.cuda.synchronize()
    launches = dict(bn.LAUNCHES)
    from fedml_tpu_torch.core.rng import sample_clients

    rounds = []
    prev = {"t": rec.t0, "launches": {"bn_fwd": 0, "bn_bwd": 0},
            "codec": {"encode_s": 0.0, "decode_s": 0.0, "bytes": 0, "messages": 0}}
    for r, close in enumerate(rec.closes):
        counts = ds.train_counts[sample_clients(r, 32, EDGE_WORKERS, SEED)]
        steps = int(sum(-(-int(c) // cfg.batch_size) for c in counts))
        wall = close["t"] - prev["t"]
        ran = {k: close["launches"][k] - prev["launches"][k] for k in ("bn_fwd", "bn_bwd")}
        if any(v != BNS_PER_STEP * steps for v in ran.values()):
            raise AssertionError(f"{tag} round {r}: launches {ran}, expected {BNS_PER_STEP} x "
                                 f"{steps} live steps")
        span_ms = sum(s.elapsed_time(e) for i, s, e in rec.spans if i == r)
        codec = {k: close["codec"][k] - prev["codec"][k] for k in prev["codec"]}
        # the round's host seconds on the device thread (aggregate: the
        # close before this round's broadcast)
        host = {k: sum(v for i, kk, v in rec.host if i == r and kk == k)
                for k in ("local_train_s", "worker_call_s", "aggregate_s")}
        rounds.append({"round": r, "seconds": wall, "real_images": float(close["weight"]),
                       "host_s": host, "weights_finite": close["finite"],
                       "real_images_per_s": float(close["weight"]) / wall, "steps": steps,
                       "bn_launches": ran, "device_span_ms": span_ms,
                       "device_span_share": span_ms / 1e3 / wall,
                       "encode_ms": codec["encode_s"] * 1e3, "decode_ms": codec["decode_s"] * 1e3,
                       "wire_bytes": codec["bytes"], "messages": codec["messages"]})
        prev = close
        log(f"{tag} round {r}: {wall:.3f} s, {close['weight']:.0f} real images "
            f"({close['weight'] / wall:.1f}/s), {steps} steps, K1/K2 {ran}, device span "
            f"{span_ms:.1f} ms ({span_ms / 1e3 / wall:.3f} of the wall); device thread: "
            f"local training {host['local_train_s']:.3f} s, worker calls "
            f"{host['worker_call_s']:.3f} s, aggregate {host['aggregate_s']:.3f} s; encode "
            f"{codec['encode_s'] * 1e3:.1f} ms, decode {codec['decode_s'] * 1e3:.1f} ms, "
            f"{codec['bytes']} bytes in {codec['messages']} messages")
    if len(rounds) != cfg.comm_round:
        raise AssertionError(f"{tag} {len(rounds)} rounds closed")
    timed = rounds[1:EDGE_ROUNDS]
    secs = sum(r["seconds"] for r in timed)
    real = sum(r["real_images"] for r in timed)
    loss = agg.test_history[-1]["loss"]
    finite = [r["weights_finite"] for r in rounds]
    log(f"{tag} aggregates finite by round {finite}, final loss {loss}")
    # a lossy codec's result is no correctness claim: its arm is timed only
    if cfg.wire_codec == "raw" and not (np.isfinite(loss) and all(finite)):
        raise AssertionError(f"{tag} final loss {loss}, finite aggregates {finite}")
    # the codec is timed on the local transport only (MQTT encodes inside
    # its manager)
    timed_codec = all(r["messages"] for r in timed)

    def per_round(key):
        return sum(r[key] for r in timed) / len(timed) if timed_codec else None

    rec_out = {"rounds": rounds, "real_images_per_s": real / secs, "launches": launches,
               "final": agg.test_history[-1],
               "device_span_share": sum(r["device_span_ms"] for r in timed) / 1e3 / secs,
               "encode_ms_per_round": per_round("encode_ms"),
               "decode_ms_per_round": per_round("decode_ms"),
               "wire_bytes_per_round": per_round("wire_bytes"), "profiled_round": rec.profile}
    if profile:
        # the profiler slows the host ~7x (a record a kernel of every
        # replay), so the profiled round gives the device's busy time of its
        # steps, and the timed rounds' busy share is that time a step over
        # their own (unprofiled) wall
        p = rec.profile
        p["device_busy_ms_per_step"] = p["device_busy_ms"] / rounds[p["round"]]["steps"]
        rec_out["busy_share"] = (p["device_busy_ms_per_step"] * sum(r["steps"] for r in timed)
                                 / 1e3 / secs)
        log(f"{tag} profiled round {p['round']}: {p['device_activities']} device activities, "
            f"{p['device_busy_ms']:.1f} ms of device busy ({p['device_busy_ms_per_step']:.3f} ms a "
            f"live step) in a {p['wall_s']:.3f} s window; rounds 1-2 at that device time a step: "
            f"busy share {rec_out['busy_share']:.3f}; {smi}")
    codec_txt = (f"encode {rec_out['encode_ms_per_round']:.1f} / decode "
                 f"{rec_out['decode_ms_per_round']:.1f} ms and "
                 f"{rec_out['wire_bytes_per_round']:.0f} bytes a round" if timed_codec
                 else "codec not timed on this transport")
    log(f"{tag} rounds 1-2: {rec_out['real_images_per_s']:.1f} real images/s, device span "
        f"share {rec_out['device_span_share']:.3f}, {codec_txt}; final "
        f"{agg.test_history[-1]}; {smi}")
    return rec_out


def edge_sim_arm(ds, bundle, smi: str) -> dict:
    """The port's plain FedAvgAPI on the same federation and bundle in the
    same call: round 0 warm, rounds 1-2 timed."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI

    tag = "[edge sim]"
    api = FedAvgAPI(ds, edge_config(), bundle)
    rounds = []
    for r in range(EDGE_ROUNDS):
        t = time.perf_counter()
        loss = float(api.run_round(r))
        dt = time.perf_counter() - t
        real, _ = api.round_counts(r)
        rounds.append({"round": r, "seconds": dt, "real_images": real, "loss": loss})
        log(f"{tag} round {r}: {dt:.3f} s, {real} real images ({real / dt:.1f}/s), loss {loss:.4f}")
    secs = sum(r["seconds"] for r in rounds[1:])
    out = {"rounds": rounds, "real_images_per_s": sum(r["real_images"] for r in rounds[1:]) / secs}
    log(f"{tag} rounds 1-2: {out['real_images_per_s']:.1f} real images/s; {smi}")
    return out


def phase_train_edge(smi: str) -> dict:
    """Phase 20: the FedAvg edge runtime, (a) the f32 gates, (b) the bf16
    flagship federation over the local transport (raw, then q8) and over
    MQTT, beside the plain FedAvgAPI."""
    import importlib.util

    import torch

    from fedml_tpu_torch.comm.mqtt_backend import HAS_PAHO, MqttCommManager
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import batchnorm as bn

    has_grpc = importlib.util.find_spec("grpc") is not None
    log(f"[edge] transports: local router, MQTT over the in-repo broker on loopback (paho "
        f"{'installed' if HAS_PAHO else 'absent: the in-repo socket client'}); gRPC is not "
        f"attempted on the card (grpc {'installed' if has_grpc else 'not installed'} here; the "
        f"gRPC federation is held on the CPU by tests/test_torch_fedavg_edge.py)")
    gate = edge_gate(smi)
    ds = flagship_data()
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl="pallas")
    sim = edge_sim_arm(ds, bundle, smi)
    bn.reset_launches()
    arms = {"local_raw": edge_speed_arm("local raw", ds, bundle, smi, profile=True)}
    # q8 both ways on full weights (q8 delta uploads ended this federation
    # at a NaN loss on the card; the cause is not established)
    arms["local_q8"] = edge_speed_arm("local q8", ds, bundle, smi, wire_codec="q8")
    with MqttBroker(0) as broker:
        arms["mqtt_raw"] = edge_speed_arm(
            "mqtt raw", ds, bundle, smi,
            comm_factory=lambda r: MqttCommManager("127.0.0.1", broker.port, r, EDGE_WORKERS))
    launches = {k: sum(a["launches"][k] for a in arms.values()) for k in ("bn_fwd", "bn_bwd")}
    log(f"[edge] real images/s, rounds 1-2: FedAvgAPI {sim['real_images_per_s']:.1f}, edge "
        + ", ".join(f"{k} {a['real_images_per_s']:.1f} ({a['real_images_per_s'] / sim['real_images_per_s']:.3f}x)"
                    for k, a in arms.items()) + f"; K1/K2 over the edge arms {launches}; {smi}")
    return {"gate": gate, "sim": sim, "arms": arms, "launches": launches}


def sm_clock() -> float:
    """The card's maximum SM clock in MHz (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    if not (ROOT / "fedml_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (fedml_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    sm_clock_mhz = sm_clock()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}; max SM clock {sm_clock_mhz:.0f} MHz")

    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {seconds[name]:.1f} s")
        return out

    build_info = timed("build", phase_build)
    err, cases, model_err = timed("check", phase_check)
    timing = timed("time", phase_time)
    timing_packed_by_lanes = {L: timed(f"time_packed_L{L}", phase_time, bns, f"{L}-lane packed")
                              for L, bns in PACKED_BNS_BY_LANES.items()}
    timing_packed = timing_packed_by_lanes[PACK_LANES]
    train = timed("train", phase_train, smi)
    train_packed = timed("train_packed", phase_train_packed, smi)
    zoo = timed("train_zoo", phase_train_zoo, smi)
    # phase 4f before 4d and 4e: profile windows after 4e lose their first
    # device records
    packed_conv = timed("train_packed_conv", phase_train_packed_conv, smi)
    crosssilo = timed("train_crosssilo", phase_train_crosssilo, smi)
    conv_err, conv_cases, lanes_model_err = timed("check_conv", phase_check_conv)
    conv_timing = timed("time_conv", phase_time_conv)
    probe, probe_launches = timed("probe", phase_probe)
    train_lanes = timed("train_lanes", phase_train, smi, bn_impl="xla", conv_impl="lanes")
    lm_err, lm_cases, lm_model_err = timed("check_lm", phase_check_lm)
    lm_timing = timed("time_lm", phase_time_lm, sm_clock_mhz)
    train_lm = timed("train_lm_fedavg", phase_train_lm_fedavg, smi)
    lm_step = timed("train_lm_step", phase_train_lm_step, smi)
    # phase 4e runs last: run after phase 4d, it left every later
    # torch.profiler window without its first 17 device records on the card
    # (more than the sentinels absorb; short runs of the same rounds did
    # not), and phase 4e profiles nothing
    crossdevice = timed("train_crossdevice", phase_train_crossdevice, smi)
    loop = timed("train_loop", phase_train_loop, smi)
    robust = timed("train_robust", phase_train_robust, smi)
    zoo_gossip = timed("train_zoo_gossip", phase_train_zoo_gossip, smi)
    gkt_seg = timed("train_gkt_seg", phase_train_gkt_seg, smi)
    fednas = timed("train_fednas_split_vfl", phase_train_fednas_split_vfl, smi)
    zoo_bn = timed("train_zoo_bn", phase_train_zoo_bn, smi)
    mesh_axes = timed("train_mesh_axes", phase_train_mesh_axes, smi)
    edge = timed("train_edge", phase_train_edge, smi)
    for k, v in (*fednas["darts_bn"]["max_abs_err"].items(), *zoo_bn["wide_err"].items()):
        err[k] = max(err[k], v)
    err.update(conv_err)
    err.update(lm_err)

    def per_step(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(v * r["calls_per_step"] for v, r in zip(vals, rows))

    def bn_step(rows, name):
        """One step's calls of a BN kernel at these shapes: per-step sums
        and the step's bound."""
        rows = [r for r in rows if r["kernel"] == name]
        bounds = [bn_bound(r["rows"], r["C"], 2, r["relu"], name == "bn_bwd") for r in rows]
        b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                              sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)))
        return rows, b_ms, b_by

    kernels = []
    for name, replaces in (("bn_fwd", "fedml_tpu/ops/batchnorm.py:36 (_fwd_kernel, pallas_call at :189)"),
                           ("bn_bwd", "fedml_tpu/ops/batchnorm.py:86 (_bwd_kernel, pallas_call at :245)"),
                           ("conv_fwd", "fedml_tpu/ops/conv_lanes.py:121 (_fwd_kernel, pallas_call at :163)"),
                           ("conv_wgrad", "fedml_tpu/ops/conv_lanes.py:130 (_wgrad_kernel, pallas_call at :185)")):
        extra = {}
        if name.startswith("bn"):
            rows, b_ms, b_by = bn_step(timing, name)
            source = "batchnorm.cu"
            # the BN path's 2 rounds, the packed flagship's, the zoo's, the
            # lowering A/B's, the cross-silo arms' and the cross-device
            # flagship arms' timed rounds, phase 13's train() runs, the
            # arms of phases 14, 15, 16, 17, 18 and 19 (the data-parallel
            # streaming trainer) and phase 20's edge federations, each
            # counted from 0 just before it
            by_path = {"fedavg_bn": train["launches"][name],
                       "fedavg_packed": train_packed["launches"][name],
                       "zoo": zoo["launches"][name],
                       "packed_conv": packed_conv["launches"][name],
                       "crosssilo": crosssilo["launches"][name],
                       "crossdevice": crossdevice["launches"][name],
                       "train_loop": loop["launches"][name],
                       "robust_hier_silo": robust["launches"][name],
                       "zoo_gossip_stream_turbo": zoo_gossip["launches"][name],
                       "gkt_seg": gkt_seg["launches"][name],
                       "fednas_split_vfl": fednas["launches"][name],
                       "zoo_bn": zoo_bn["launches"][name],
                       "mesh_axes": mesh_axes["launches"][name],
                       "edge": edge["launches"][name]}
            launches = sum(by_path.values())
            packed = {}
            for L, t_rows in timing_packed_by_lanes.items():
                prows, pb_ms, pb_by = bn_step(t_rows, name)
                # one L-lane packed step's 57 calls at the folded shapes [rows, L*C]
                packed[L] = {
                    "ms": per_step(prows, "ms"), "device_ms": per_step(prows, "device_ms"),
                    "plain_ms": per_step(prows, "plain_ms"),
                    "library_ms": per_step(prows, "library_ms"),
                    "library_device_ms": per_step(prows, "library_device_ms"),
                    "bound_ms": pb_ms, "bound_by": pb_by,
                    "per_call": [{k: v for k, v in r.items() if k != "kernel"} for r in prows]}
            extra = {"launches_by_path": by_path, "packed": packed[PACK_LANES],
                     "packed_by_lanes": packed}
        else:
            rows = [r for r in conv_timing if r["kernel"] == name]
            bounds = [conv_bound(name, r["n"], r["ci"], r["co"], r["h"] * r["w"]) for r in rows]
            source, launches = "conv_lanes.cu", train_lanes["launches"][name]
            b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                                  sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                                  PEAK_BF16_FLOPS)
        kernels.append({
            "name": name, "route": "cuda", "source": f"fedml_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err[name],
            # one local step's calls at batch 64, bf16 (57 BNs; 72 K3, 36 K4)
            "ms": per_step(rows, "ms"), "plain_ms": per_step(rows, "plain_ms"), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": per_step(rows, "library_ms"),
            "device_ms": per_step(rows, "device_ms"),
            "plain_device_ms": per_step(rows, "plain_device_ms"),
            "library_device_ms": per_step(rows, "library_device_ms"),
            "per_call": [{k: v for k, v in r.items() if k != "kernel"} for r in rows],
            **extra,
        })
    # K7: one probe pass, a "patches" and a "copy" call at each probe shape;
    # no single library call computes that mix
    modes = [(r, m) for r in probe for m in ("patches", "copy")]
    devs = [r[f"{m}_device_ms"] for r, m in modes]
    kernels.append({
        "name": "conv_variant", "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/conv_lanes.cu",
        "replaces": "tools/lanes_probe.py:107 (_variant_kernel, pallas_call at :136)",
        "launches": probe_launches["conv_variant"], "max_abs_err": err["conv_variant"],
        "ms": sum(r[m] for r, m in modes), "plain_ms": sum(r[f"{m}_plain_ms"] for r, m in modes),
        "bound_ms": sum(r[f"{m}_bound_ms"] for r, m in modes), "bound_by": "bytes",
        "library_ms": None, "device_ms": None if None in devs else sum(devs),
        "per_call": probe,
    })
    # K6 and K5: one path (B) step's calls at its shapes (8 K6, 1 K5);
    # K6's launches count both transformer paths and phase 19's builders,
    # K5's path (B)'s and phase 19's builders'
    k6_launches = {"fedavg_transformer": train_lm["launches"]["attention"],
                   "lm_step": lm_step["launches"]["attention"],
                   "mesh_axes": mesh_axes["launches"]["attention"]}
    k5_launches = {"lm_step": lm_step["launches"]["xent"],
                   "mesh_axes": mesh_axes["launches"]["xent"]}
    for rec, replaces, by_path in (
            (lm_timing[0], "fedml_tpu/ops/attention.py:63 (_flash_kernel, pallas_call at :158)",
             k6_launches),
            (lm_timing[1], "fedml_tpu/ops/xent.py:31 (_xent_kernel, pallas_call at :81)",
             k5_launches)):
        launches = sum(by_path.values())
        name, calls = rec["kernel"], rec["calls_per_step"]

        def step_ms(key, rec=rec, calls=calls):
            return None if rec[key] is None else rec[key] * calls

        kernels.append({
            "name": name, "route": "cuda", "source": f"fedml_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err[name],
            "ms": step_ms("ms"), "plain_ms": step_ms("plain_ms"), "bound_ms": step_ms("bound_ms"),
            "bound_by": rec["bound_by"], "library_ms": step_ms("library_ms"),
            "device_ms": step_ms("device_ms"), "plain_device_ms": step_ms("plain_device_ms"),
            "library_device_ms": step_ms("library_device_ms"),
            # device time by CUDA events behind a primed queue (the profiler
            # misses device activity in some windows)
            "queued_ms": step_ms("queued_ms"), "plain_queued_ms": step_ms("plain_queued_ms"),
            "library_queued_ms": step_ms("library_queued_ms"),
            "per_call": {k: v for k, v in rec.items() if k != "kernel"},
            "launches_by_path": by_path,
        })
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sm_clock_max_mhz": sm_clock_mhz,
        "build": build_info,
        "phase_seconds": seconds,
        "check_cases": cases, "small_model_rel_err": model_err, "timing": timing,
        "timing_packed": timing_packed, "timing_packed_by_lanes": timing_packed_by_lanes,
        "train": train, "train_packed": train_packed,
        "train_zoo": zoo, "train_packed_conv": packed_conv, "train_crosssilo": crosssilo, "train_crossdevice": crossdevice,
        "train_loop": loop, "train_robust": robust, "train_zoo_gossip": zoo_gossip,
        "train_gkt_seg": gkt_seg, "train_fednas_split_vfl": fednas, "train_zoo_bn": zoo_bn,
        "train_mesh_axes": mesh_axes, "train_edge": edge,
        "conv_check_cases": conv_cases,
        "small_lanes_model_rel_err": lanes_model_err, "conv_timing": conv_timing,
        "probe": probe, "probe_launches": probe_launches, "train_lanes": train_lanes,
        "lm_check_cases": lm_cases, "small_lm_rel_err": lm_model_err, "lm_timing": lm_timing,
        "train_lm_fedavg": train_lm, "train_lm_step": lm_step,
        "profile_windows": PROFILE_TALLY, "kernels": kernels}, indent=1))
    log(f"[profile] {PROFILE_TALLY['windows']} profile windows; their sentinels lost "
        f"{PROFILE_TALLY['sentinel_records_lost']} device records (at most "
        f"{PROFILE_TALLY['most_sentinel_records_lost']} in one window); "
        f"{PROFILE_TALLY['profiled_again']} lost records of their work and were profiled "
        f"again; {smi}")
    log(smi)
    log(f"[wall] chip_smoke.py {time.perf_counter() - T0:.1f} s from start to the kernel line; "
        f"{smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
