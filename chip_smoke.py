#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. the card (nvidia-smi name and power limit) and the build of every CUDA
   kernel from the sources in this checkout (nvcc, sm_90a);
2. kernels: each kernel's wrapper on CUDA tensors at the main path's shape
   (N=20 clients, X=17,226: the paper-scale mlp) and past the 50 MB L2
   (N=20, X=4,194,304), checked against its plain PyTorch version (max abs
   error <= 1e-5, TF32 off) and timed with CUDA events; beside it the
   least time the card could take (bytes over 3.35 TB/s or FLOPs over
   67 TFLOP/s fp32, whichever is larger), the plain version's time, and
   for the flat mix one ``torch.matmul`` as a yardstick; first the launch
   floor (``launch_floor_ms``: a one-element ``zero_()`` replayed in a
   CUDA graph), timed again beside the flat, fused DP and sparse mixes at
   X = 17,226 (``floor_ms``). The fused DP mix (``gossip_mix_fused_dp``,
   sigma 0 and 0.5) also at N = 20 on both sides of its routes' widths
   (``kDpVecMinX`` − 2 and kDpVecMinX: the narrow and vector kernels;
   ``kNarrowMaxX`` − 1, + 1 and + 2: the narrow, one-column and vector
   kernels), every row equal bit for bit to the one-slab
   stack mix (``mix_kernel``) of the plane that torch sanitized, one op a
   step, and timed beside one ``torch.matmul`` of W by that plane
   (``sanitized_matmul_ms``, a yardstick) and its bound's share. The serving
   kernels (``gossip_mix_dequant``, int8; ``mixture_mix_dequant4``, int4)
   the same way at B = 20, 256 and 1,024 requests over S = 2 clusters of
   the mlp's plane (qblock 64), at one request (the stream kernel's
   latency-bound end) and at B = 1 and 4 past the 50 MB L2 (X =
   4,194,304), with the fp32 serving path's own
   ``torch.matmul(u, plane)`` and a store of the output alone
   (``fill_``) timed beside them; ``gossip_mix_dequant``
   also at the int8 exchange's shape (M = N = 20, qblock 256, with the
   launch floor beside it), and for correctness only at widths whose rows
   rule out 16- and 8-byte stores and on the square W at both sides of its
   route (N = 1 to 32 below Xp = 65,536: the narrow kernel; Xp = 65,538
   and N = 33: the serving template), each square W's first N − 1 rows
   checked bit for bit against the same call on those rows alone (the
   serving template);
   ``gossip_mix_stack`` (the FedEM exchange) the same way at (S, N, X) =
   (2, 20, 17,226), (2, 20, 4,194,304), (3, 37, 100,003) and (3, 64,
   100,003), with one ``torch.matmul`` broadcast over S as its yardstick;
3. agreement on a small input: one FedSPD round at full width on the card
   (CUDA kernels) against the same round on the CPU (plain versions), with
   the same injected draws, DP off and on; then one ``dfl_fedem`` round
   the same way (kernel 3 on the card);
4. the main path: ``run_method("fedspd", ...)`` for 5 rounds through the
   kernels, DP off (keeping its final state) and then on, with every
   launch counter set to 0 just before each run and read just after.
   Phases 4, 6 and 7 run the loop engine (``scan_rounds=False``), where
   a wrapper launches its kernel once a call; the card's default engine,
   the replay, is phase 8's;
5. serving, the second path: the DP-off run exported (``export_run``) as
   fp32, int8 and int4 artifacts, each loaded (``load_servable``) into a
   ``ClusterPlaneServer`` on the card that answers the 20 trained
   clients' own mixtures (one test input each) and then 20 batches of
   256 Dirichlet mixtures with Gaussian inputs; outputs checked against
   the same artifact served on the CPU (plain versions) and, for fp32,
   against the personalized models materialized in plain PyTorch; every
   launch counter set to 0 just before each codec and read just after;
6. the baselines, the third path: each of the paper's 11 baseline ids
   (``local``, ``dfl_``/``cfl_`` × fedavg, fedem, ifca, fedsoft, pfedme)
   runs ``run_method`` for 5 rounds on the card, every launch counter set
   to 0 just before each id and read just after: ``gossip_mix_stack``
   launches once per round in the FedEM ids and nowhere else,
   ``gossip_mix_flat`` once per round in the FedAvg, pFedMe and IFCA ids;
   accuracy finite in [0, 1] and comm bytes equal to the static formula;
   then the baselines' compressed exchange (``phase_baselines_comm``, its
   seconds printed): one compressed round of ``dfl_fedavg`` (int8 + error
   feedback: kernel 4) and ``dfl_fedem`` (top-k + error feedback: kernel
   3) on the card against the CPU with the same injected draws (1e-5,
   near-ties counted and left out as in phase 7), one FedSPD round driven
   by AdamW (eps 1e-3) and a cosine schedule and ``local_sgd`` with
   momentum the same way; then the 10 paired ids under int8 + error
   feedback and ``dfl_fedavg`` and ``dfl_fedem`` also under int4 and
   top-k + error feedback, 5 rounds each on the loop and on the replay
   (as in phase 8: bit for bit, the replays' kernels in the trace), each
   loop run's launches checked exactly (kernel 4 for FedAvg and pFedMe
   under int8/int4, kernel 1 for IFCA and under top-k, kernel 3 for
   FedEM, none for FedSoft), its ``wire_bytes`` equal to ``comm_bytes``
   times the channel's ratio and ``comm_bytes`` to the static formula;
   and a replayed ``run_method_batch`` of ``dfl_fedavg`` over seeds 0, 1
   under int8 + error feedback equal to each seed's ``run_method``;
7. the sparse and compressed exchange, the fourth path: the sparse mix
   (``gossip_mix_sparse``) and the masked dequant mix
   (``gossip_mix_dequant_masked``) against their plain versions (max abs
   error <= 1e-5, inactive columns exact zeros) and timed, at N = 20
   with density-0.2 masks and int8 at block 256: X = 17,226 (the mlp),
   random masks and every client's support in one shared 20 % band (80 %
   of the slabs dead), and X = 4,194,304 (past L2) both ways, beside
   their bounds, plain versions and one ``torch.matmul``, of W by C for
   the sparse mix and by the decoded masked plane for the masked dequant
   mix (the launch floor beside both at X = 17,226); the masked dequant
   mix also for correctness only at the edges of its three kernels (N = 1
   to 33, odd widths and qblocks, both sides of Xp = 65,536) with random,
   all-dead and band masks; one full-width sparse + int8 + error-feedback
   round on the card against the CPU with the same injected draws; then
   ``run_method("fedspd", ...)`` for 5 rounds with dense int8 + error
   feedback, dense topk + error feedback, sparse d0.2 (DisPFL, RigL at
   round 4) and sparse d0.2 + int8 + error feedback, every launch
   counter set to 0 just before each run and read just after, launches
   and ``wire_bytes`` checked exactly;
8. the round engines, the sixth path: ``run_method("fedspd", ...)`` for
   30 rounds (``ENGINE_ROUNDS``, half the paper's 60), DP off and on, on the loop engine
   (``scan_rounds=False``) and on the card's default engine, the replay
   (one round captured into a CUDA graph, replayed 30 times); then a
   cohort of 10 of the 20 clients, ``run_method_batch`` over seeds 0, 1,
   2 (one graph for all three; 12 rounds, phase 11's depth), sparse d0.2
   + int8 + error feedback (two graphs) and the 11 baseline ids, 5 rounds
   each, both ways; every
   launch counter set to 0 just before each run and read just after, the
   replayed run under torch.profiler. Each replayed run equals its loop
   run bit for bit (per-client accuracy, curve, u, bytes and every tensor
   of the final state, the plane among them); its counters (the warm-up's
   and the capture's launches) name the kernels the loop's name; its
   trace, cut into the runner's round spans, shows device work in every
   replayed round and as many exchange kernels as the loop's counters
   (one a round at 30 rounds). At 30 rounds the loop run and a second
   replayed run have rounds 16-18 profiled (``RunConfig.on_round``
   starts and stops the profiler): each engine's busy share is their
   device ms a round over the median ms of the same run's other rounds
   (``profile replay``). Printed: round ms medians of both engines, the busy shares,
   the capture's ms, ``n_captures`` and ``n_dispatches``;
9. the scenario engine, the seventh path: one full-width round of
   scenario B (link dropout 0.2 and a Markov client-system model with
   stragglers and stale-gossip decay) on the card against the CPU, DP off
   and on, with the same injected draws (plane within 1e-5, bytes equal),
   and kernels 1, 2, 4, 5 and 6 on that round's weighted W against their
   plain versions; then ``run_method("fedspd", ...)`` for 16 rounds
   (``SCENARIO_ROUNDS``, cut to pay for phases 10 and 18) under
   scenario A (a rewired ER schedule with dropout 0.2) and B, DP off and
   on, and B with a cohort of 10, with dense int8 + error feedback and
   with sparse d0.2 + int8 + error feedback, each on the loop and on the
   replay as in phase 8 (bit for bit, staleness included; one exchange
   kernel in every replayed round, two with sparse), beside the same
   run's replay without the scenario; one run of each kind (A and B, DP
   off: ``SCENARIO_TRACED``) has its replay traced (its kernels round by
   round, busy shares from rounds 9-11), every other run's exchange
   kernels a replay come from its loop's counters;
10. the main-path variants, the slice's path, on the main path's
   population for 12 rounds a run (``VARIANT_ROUNDS``), each loop against
   replay, bit for bit: the conv1d classifier
   (``PaperExpConfig(model="conv")``, X = 14,720), DP off (traced as in
   phase 8: one exchange kernel a replayed round, busy shares from rounds
   7-9) and on; ``fedspd_permute`` on "cuda", equal bit for bit to
   ``fedspd``; the permute wiring on "reference", one full-width round
   against the dense wiring with the same injected draws (1e-5);
   cosine alignment DP off and on at a threshold between two of round
   1's same-cluster neighbour cosines that drops a quarter of those
   links (printed), where kernel 2 must never launch; 12 rounds of the
   stream regime (``FedSPDConfig(regime="stream")``, mlp and conv, a
   fresh batch of 32 points a client a round) and one stream DP round on
   the card against the CPU with injected draws (1e-5); then kernels 1, 2
   and 4 at the conv plane's shape (20, 14,720) against their plain
   versions, timed beside their bounds and ``torch.matmul``;
11. the per-leaf pytree engine (``RunConfig(param_plane=False)``, the
   JAX package's default): ``run_method("fedspd", ...)``
   for 12 rounds (``PYTREE_ROUNDS``) at the main path's width (N = 20, S =
   2, the mlp's X = 17,226 in 6 leaves), DP off and on, and the conv
   classifier DP off, each on the loop and on the replay (bit for bit;
   the replay's rounds 7-9 traced by ``_windowed``: 6 exchange kernels in
   each, its kernels, device ms a round and busy share printed), the
   loop's counters read exactly
   (kernel 1 six times a round, kernel 2 never), each beside the plane's
   runs of the same configuration, which the earlier phases made: the
   mlp's seeds 0, 1 and 2 of phase 8's ``run_method_batch``, the conv's
   seed 0 of phase 10, and for the mlp DP seed 0 replayed here
   (``comm_bytes`` equal to seed 0's where the two engines draw alike,
   DP off; ``mean_acc`` above chance and within max(0.02, the plane
   seeds' std) of seed 0's; the plane's DP-off round ms of phase 8
   printed beside); one id per baseline class on the
   pytree engine for 5 rounds on the loop, launches a round checked
   (kernel 1 a leaf for FedAvg, IFCA and pFedMe, kernel 3 a leaf for
   FedEM, none for Local and FedSoft) and held against phase 8's plane
   loop run of that id; then kernel 1 at each mlp leaf width (N = 20; X = 8,192,
   640, 128, 64, 10) against its plain version, timed by graph replay
   beside its bound and ``torch.matmul``, and the six launches of a
   pytree round against the plane's one launch;
12. the telemetry layer (``RunConfig(telemetry=TelemetryConfig())``):
   FedSPD for 8 rounds (``TELEMETRY_ROUNDS``) on the main path's
   population with telemetry off and on, each on the loop and on the
   replay: the mlp DP off and on and the pytree engine, their replays
   traced over rounds 5-7 (round ms, kernels, device ms and busy share a
   round, with and without the collector), the fully composed run
   (scenario B's dropout and ClientSystemModel, a cohort of 10, int8 +
   error feedback) and sparse d0.2 + int8 + error feedback; every stream
   of the replay equal to the loop's bit for bit, and telemetry changing
   no accuracy, curve, byte, u, final tensor, ``n_captures``,
   ``n_compiles``, ``n_dispatches`` or loop launch; the streams' shapes,
   finite values, stale_hist rows summing to N, the logical bytes summing
   to ``comm_bytes``, inactive clients under scenario B, mask churn on the
   RigL rounds only; the collector alone at the main path's shape, stream
   by stream (kernels by torch.profiler, µs by graph replay); the mlp
   replay's JSONL event log written, read back exactly and rendered by
   ``summary_table``;
13. a torch.profiler window over 3 rounds of the main path, one over 3
   DP rounds (``dp``: the clip, the noise draw and kernel 2, which it must
   see), one over 3 rounds of the conv classifier (``conv``), one over 3
   pytree rounds (``pytree``, the mlp on ``param_plane=False``) and one of
   the sparse + int8 path: device time per round, the
   kernels that take it, and the device's busy share;
14. the LM kernels: ``flash_attention`` (kernel 8) at olmo-1b's prefill
   (B = 4 requests, L = 512, 16 heads, hd 128, bf16; also fp32), a
   danube-like GQA 32/8 hd-80 layer with a 256 window and a gemma3-like
   hd-256 layer over one kv head, zamba2-1.2b's shared block (MHA 32/32,
   hd 64) and olmoe-1b-7b's prefill (B = 1), then short query ranges whose
   keys split (``SPLIT_FLASH``: whisper's cross attention in fp32, 16 and
   1 queries over a 4,096 cache, windowed calls, one of them with rows
   that see no key of a chunk), each row naming its
   route (``flash_wgmma_kernel``, ``flash_mma_kernel`` or
   ``flash_tf32_kernel``, by ``route``) and split, held also against the
   plain split-and-merge where it splits, beside the counts of
   tensor-core instructions (``HMMA`` and ``HGMMA`` apart, by
   ``cuobjdump -sass`` of the built library) in the kernel it runs
   (checked right after the build: HGMMA in every wgmma-route
   instantiation, HMMA in every mma.sync and 3xTF32 one), and ``ssd_scan``
   (kernel 9) at mamba2-370m's prefill layer (B = 4, L = 512, H = 32, P =
   64, N = 128, chunk 128, bf16; also fp32 and with an initial state),
   zamba2-1.2b's Mamba2 layer (H = 64, N = 64, bf16) and mamba2-370m at
   one request and a 4,096-token prompt (32 chunks of the state walk),
   each row naming its route (``ssd_wgmma`` in bf16, ``ssd_tf32`` in fp32,
   by ``route``) with its two kernels' device ms from a torch.profiler pass
   (which must see exactly the route's kernels) and their tensor-core
   instruction counts (checked right after the build: HGMMA in both bf16
   kernels, HMMA or HGMMA in both fp32 ones), an fp32 row also its
   3xTF32 ceiling,
   each against its plain version (attention 2e-5 fp32 / 2e-2 of the
   largest |output|, at most 2e-2, bf16 (``flash_tol``), SSD
   2e-3 and one bf16 step, 2^-7 of the value, on a bf16 y) and timed by
   CUDA-graph replay beside its bound (bytes over 3.35 TB/s or FLOPs over
   989 TFLOP/s bf16 / 67 TFLOP/s fp32), its plain version and, for
   attention, ``scaled_dot_product_attention``;
15. LM generation, the fifth path: ``olmo-1b``, ``mamba2-370m`` and (the
   MoE and hybrid slice) ``zamba2-1.2b`` at full width in fp32, int8 and
   int4 with B = 4 requests, and ``olmoe-1b-7b`` in int8 and int4 with B
   = 1 (``LM_SERVE``: its fp32 plane, or a second request, does not fit
   in 80 GB), ``launch/serve``'s random S = 2 plane (``build_server``;
   int8/int4 drawn, packed and encoded one cluster at a time), each
   request with its own mixture, prompt 512, 16 greedy tokens, every
   launch counter set to 0 just before each ``generate`` and read just
   after (one ``flash_attention`` launch per olmo / olmoe layer and per
   invocation of zamba2's shared block, two ``ssd_scan`` launches
   (``LAUNCHES_PER_CALL``) per mamba2 / zamba2 Mamba2 layer, one dequant
   launch per int8/int4 call:
   the mix and the prefill stay eager, the decode tokens are replays of
   the server's captured CUDA graph); for olmoe, the (token, expert)
   pairs each MoE layer's capacity drops in the prefill;
   the captured generate's tokens and last logits against the eager
   decode's (``decode_eager``: the same steps launched one by one), bit
   for bit; ``n_compiles`` 2 after calls of two shape keys (gen 1 and
   16); decode ms a token of both engines (the card's clock between CUDA
   events around the 16 tokens of a call, median of 3 calls), prefill ms
   (a 1-token call less a token), tok/s, the capture's ms; the int8/int4 mix
   kernel at that shape against its plain version (over the whole width,
   in chunks of 2^26 columns) and its device time beside its bound and
   ``torch.matmul`` of u by the fp32-decoded plane (at olmoe, where that
   55 GB plane does not fit beside the server, over the width in chunks of
   2^26 columns, each decoded before its clock starts, the CUDA-event
   times summed); the tokens against the
   same card's tokens through the plain versions of kernels 8 and 9 (where
   a bf16 near-tie flips one, the logit gap at that step must be under
   5e-2 or two bf16 steps at the logits' magnitude, or else the fp32
   reference must pick the kernel run's token); plane bytes and peak memory;
   then per model (int8) one 16-token generate and one eager decode under
   torch.profiler, cut into their decode tokens (the server's
   ``DECODE_SPAN``): device ms and kernels a token, and each engine's busy
   share (device ms a token over its unprofiled decode ms a token); then
   ``python -m repro_torch.launch.serve`` once, with ``--telemetry-out``:
   its serve events read back and rendered by ``summary_table``;
16. training, the eighth path (phase "train"): ``python -m
   repro_torch.launch.train``'s ``main`` in this process, every launch
   counter set to 0 just before each run and read just after. First
   kernel 1 at the full-width exchange (N, X) = (4, 420,136,448) and
   kernel 4 at its int8 form (M = N = 4, block 256), each against its
   plain version (1e-5) and timed by CUDA events beside its bound, its
   plain version and (kernel 1) ``torch.matmul``. T1: FedSPD over
   mamba2-370m at full width (48 layers, d 1024; N = 4, S = 2, b = 4, L =
   64, ER degree 2) for 4 rounds on the loop (kernel 1 four times, kernels
   8 and 9 never: the training route), then ``--scan-rounds`` from the
   same seed (one captured round replayed) equal to the loop bit for bit
   (plane, u, bytes, final loss; the loop's copied to the host first),
   its last round traced (device ms, kernels, the top kernels), the round
   ms of both engines (median of rounds 2-4) and the peak memory. T2: the
   same with int8 + error feedback, 2 loop rounds (kernel 4 twice;
   wire = logical × (X + 4·X/256) / model bytes). T3: gemma3-1b (26
   layers, per-layer windows) at N = 2, 2 loop rounds. T4, at smoke
   size: olmo-1b, zamba2-1.2b, olmoe-1b-7b, sparse 0.2 + int8 + EF (two
   graphs), the pytree engine (kernel 1 a leaf) and the heterogeneity
   flags, each loop against its replay bit for bit; the first run's
   ``--telemetry-out`` rendered by ``summary_table``, its ``--save``
   manifest, and its int8 ``--export-servable`` answered by
   ``launch.serve --artifact``.
17. the mesh (phase "mesh"): a process group of one rank over NCCL on the
   card (a file store in a temporary directory; a missing NCCL fails),
   the (1, 1) ("data", "model") mesh. M1: the mlp plane at N = 1, S = 2,
   3 rounds of ``make_fedspd_train_step(mesh=...)`` on
   ``shard_plane_state`` equal to the one-device round bit for bit (plane,
   u, comm_bytes, the selections and consensus; the bytes' all-gather and
   the consensus's all-reduces run over NCCL); ``decode_attention`` over
   the mesh's "data" dim equal to ``axis_name=None`` on olmo-1b's smoke
   shapes; ``HBM_BYTES`` as read. M2: ``launch.train --mesh`` on
   mamba2-370m at full width (N = 1, S = 2, b = 4, L = 64, 2 loop rounds)
   equal to the same run on one device bit for bit, with each run's round
   ms and peak memory. The group is destroyed after, and a line says that
   the multi-rank NCCL exchange has not run on this card.
18. whisper (phase "whisper"), the audio family at published width and
   depth (whisper-base: 6 + 6 layers, d 512, 8 heads, 1,500 frames). First
   kernel 8 at ragged lengths (``RAGGED_FLASH``: the encoder layer
   ``(4, 1500, 8, 8, 64)`` not causal in bf16 and fp32, the cross
   attention at Lq = 64 over 1,500 frames, a causal 1,500, an odd length
   77 at hd 80 and 256), each against its plain version (``flash_tol``)
   and timed beside its bound and ``scaled_dot_product_attention``.
   W1: ``launch/steps.make_prefill_step`` then ``make_decode_step`` on
   ``build_model(cfg)``, B = 4, frames ``(4, 1500, 512)`` from a seed, 16
   greedy tokens, kernel 8's launches counted (6 a prefill, 18 an
   ``encdec_forward``), against the same steps with ``attn_mode="ref"``
   (log-softmax within 2e-2 up to the first flip, the tokens equal or the
   flip a bf16 near-tie or the fp32 reference's pick), 8 tokens
   teacher-forced through the cross prefill and the decode against
   ``encdec_forward``'s logits (2e-2); prefill ms and decode ms a token
   (CUDA events, medians of 3), peak memory, and beside them the
   dry-run's roofline terms of the same prefill (printed, not checked).
   W2: ``launch.train --arch whisper-base`` (N = 4, S = 2, b = 4, L = 64,
   ER degree 2), 2 loop rounds and the replay, bit for bit.

It then prints its seconds (``chip_smoke: … s``), one
``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Needs one card and no network; it
imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
SHAPES = [(20, 17226), (20, 4194304)]  # (N, X): the main path's, past L2
ROUNDS = 5
# the phases' depths, cut to pay for phase "whisper" (until then: engines 60,
# the paper's rounds; scenarios 30; telemetry 12; stream 20)
ENGINE_ROUNDS = 30     # the engines phase (half the paper's 60, configs/paper_cnn.py)
SCENARIO_ROUNDS = 16   # the scenarios phase
VARIANT_ROUNDS = 12    # the variants phase's runs (= PYTREE_ROUNDS: the pytree phase's conv
#                        runs are held to this phase's)
PYTREE_ROUNDS = 12     # the pytree phase's FedSPD runs (its accuracy check needs 12)
TELEMETRY_ROUNDS = 8   # the telemetry phase's runs
# the pytree phase's baselines, one id per class, and the mlp's leaf widths
PYTREE_BASELINES = {"local": None, "dfl_fedavg": "gossip_mix_flat",
                    "dfl_fedem": "gossip_mix_stack", "dfl_ifca": "gossip_mix_flat",
                    "dfl_fedsoft": None, "dfl_pfedme": "gossip_mix_flat"}
PYTREE_WIDTHS = (8192, 640, 128, 64, 10)
PYTREE_LEAVES = 6      # the mlp's and the conv's leaves: three layers' w and b
STREAM_ROUNDS, STREAM_B = 12, 32   # the stream regime's rounds and fresh batch a client
CONV_X = 14720   # the conv1d classifier's plane at the main path's dim 64 and 10 classes
DP_OPTIONS = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}   # the DP main path: sigma 0.5
DP_OPS = ("aten::square", "aten::sqrt", "aten::clamp", "aten::randn", "aten::normal_")
# serving kernels, (B requests, S clusters, X, qblock): a batch of the 20
# trained clients, the serving batch of benchmarks/perf_roundstep.py
# bench_mixture_qps, a batch whose 70.8 MB output is past the L2, one
# request, and one and four requests past the L2 (the LM mix's regime:
# olmoe-1b-7b serves one request, the dense LMs four)
SERVE_SHAPES = [(20, 2, 17226, 64), (256, 2, 17226, 64), (1024, 2, 17226, 64),
                (1, 2, 17226, 64), (1, 2, 4194304, 64), (4, 2, 4194304, 64)]
SERVE_B = 256
# gossip_mix_dequant also at the int8 exchange's shape (M = N = 20, timed),
# and for correctness only at widths padded to Xp = 1,010 (no 16-byte
# rows) and 999 (odd: no 8-byte rows); then on the square W at both sides
# of its route: N = 1, 7, 20, 32 below Xp = 65,536 (the narrow kernel), N =
# 20 at 65,538 and N = 33 (the serving template), odd qblocks
GOSSIP_DEQUANT = (20, 20, 17226, 256)
DEQUANT_CHECKS = [GOSSIP_DEQUANT, (37, 5, 1001, 10), (7, 3, 999, 3),
                  (1, 1, 1010, 10), (7, 7, 999, 3), (20, 20, 65535, 3), (20, 20, 65538, 3),
                  (32, 32, 1001, 7), (32, 32, 17408, 256), (33, 33, 1010, 10)]
SERVE_TOL = 1e-4
# gossip_mix_stack, (S, N, X): the FedEM exchange at the main path's
# width, past L2, N above 32 (one 40-row chunk) with an odd X, and N = 64
# (one 64-row chunk)
STACK_SHAPES = [(2, 20, 17226), (2, 20, 4194304), (3, 37, 100003), (3, 64, 100003)]
BASELINES = ("local", "dfl_fedavg", "cfl_fedavg", "dfl_fedem", "cfl_fedem",
             "dfl_ifca", "cfl_ifca", "dfl_fedsoft", "cfl_fedsoft",
             "dfl_pfedme", "cfl_pfedme")
# the sparse lane of benchmarks/perf_roundstep.py (fedspd/sparse_d20)
SPARSE = dict(density=0.2, prune_rate=0.2, regrow="rigl", update_every=4)
QBLOCK = 256   # CommConfig's default block
# kernels 5 and 6, (N, X, mask layout): the mlp's width with random
# density-0.2 masks and with every client's support in one shared 20 %
# band (80 % of the slabs dead), and the same past the 50 MB L2
SPARSE_SHAPES = [(20, 17226, "random"), (20, 17226, "band"),
                 (20, 4194304, "random"), (20, 4194304, "band")]
# kernel 6 for correctness only, (N, X, qblock) with random, all-dead and
# band masks: the narrow kernel (N = 1, 7, 20, 32 below Xp = 65,536; X
# that rules out 16- and 8-byte rows, odd qblocks), past it the one-column
# kernel (X % 4 = 2; N = 33) and the 4-column kernel (N = 20 and 32)
MASKED_CHECKS = [(n, x, qb, layout)
                 for n, x, qb in ((1, 1010, 10), (7, 999, 3), (20, 65535, 3), (32, 1001, 7),
                                  (20, 65538, 3), (33, 1010, 10), (20, 100000, 64),
                                  (32, 65536, 256))
                 for layout in ("random", "dead", "band")]
# wire bytes per message of the mlp (X = 17,226, 68,904 model bytes) on
# the four sparse/comm runs: dense int8, dense topk, sparse fp32, sparse int8
WIRE_PER_MSG = {"int8": 17498, "topk": 8608, "sparse": 15934, "sparse_int8": 5655}
# kernel 8, (B, L, Hq, Hkv, hd, window, dtype): olmo-1b's prefill layer
# (the main row) in bf16 and fp32, a danube-like GQA layer with a window
# shorter than L, a gemma3-like hd-256 layer over one kv head
FLASH_SHAPES = [(4, 512, 16, 16, 128, None, "bfloat16"), (4, 512, 16, 16, 128, None, "float32"),
                (4, 512, 32, 8, 80, 256, "bfloat16"), (4, 512, 4, 1, 256, None, "bfloat16"),
                # zamba2-1.2b's shared block (MHA 32/32, hd 64) and olmoe-1b-7b's
                # prefill layer (one request)
                (4, 512, 32, 32, 64, None, "bfloat16"), (1, 512, 16, 16, 128, None, "bfloat16")]
# kernel 9, (B, L, H, G, P, N, chunk, dtype, initial state): mamba2-370m's
# prefill layer (the main row), in fp32, and with an initial state
SSD_SHAPES = [(4, 512, 32, 1, 64, 128, 128, "bfloat16", False),
              (4, 512, 32, 1, 64, 128, 128, "float32", False),
              (4, 512, 32, 1, 64, 128, 128, "float32", True),
              # zamba2-1.2b's Mamba2 layer: 64 heads, state 64
              (4, 512, 64, 1, 64, 64, 128, "bfloat16", False),
              # mamba2-370m at one request and a 4,096-token prompt: the
              # state walk's carry over 32 chunks
              (1, 4096, 32, 1, 64, 128, 128, "bfloat16", False)]
# the scenarios phase (the slice's path on the main path's population):
# scenario A, examples/connectivity_sweep.py's rewired ER schedule with
# link dropout, and scenario B, a Markov client-system model with
# stragglers and stale-gossip decay, with the same dropout
SCENARIO_DROPOUT = 0.2
SCENARIO_TRACED = ("A", "B")   # the scenario runs whose replays are traced, one a kind
SCENARIO_REWIRE = dict(kind="er", n=20, avg_degree=5.0, p_rewire=0.3, seed=2)
SCENARIO_SYSTEM = dict(slow_fraction=0.34, slow_factor=4.0, time_budget=2.0, jitter=0.3,
                       markov=(0.3, 0.7), staleness_gamma=0.9, seed=5)
LM_ARCHS = {"olmo-1b": 1_280_311_296, "mamba2-370m": 420_136_448,   # X of each plane
            "zamba2-1.2b": 1_170_473_856, "olmoe-1b-7b": 6_919_620_608}
LM_B, LM_PROMPT, LM_GEN = 4, 512, 16
# (requests, codecs) each arch is served with. olmoe-1b-7b: B = 1 and no
# fp32 plane: its fp32 (2, X) plane (55.4 GB) beside the (B, X) fp32 mix
# (27.7 GB a request) and the bf16 leaves (13.8 GB a request) does not fit
# in 80 GB, nor does B >= 2 in any codec
LM_SERVE = {"olmo-1b": (LM_B, ("fp32", "int8", "int4")),
            "mamba2-370m": (LM_B, ("fp32", "int8", "int4")),
            "zamba2-1.2b": (LM_B, ("fp32", "int8", "int4")),
            "olmoe-1b-7b": (1, ("int8", "int4"))}
LM_NEW = ("zamba2-1.2b", "olmoe-1b-7b")   # the MoE and hybrid slice's archs
PLAIN_MIX_COLUMNS = 1 << 26   # the LM mixes' plain versions run in chunks this wide
# phase "train": launch/train.py, FedSPD over an LM in the stream regime
TRAIN_ARGS = ["--clients", "4", "--clusters", "2", "--tau", "1", "--batch", "4", "--seq",
              "64", "--graph", "er", "--avg-degree", "2", "--eval-every", "100"]
TRAIN_ARCH = "mamba2-370m"    # T1 / T2: full width, 48 layers, d 1024
TRAIN_X = 420_136_448          # its packed plane's X
TRAIN_ROUNDS = 4               # T1 on each engine (5 until the whole script
#                                passed 1,050 s, PR 31); T2 and T3 2 on the loop
TRAIN_SMOKE = ["--smoke", "--rounds", "4", "--mask-update-every", "2"]
LM_MIXTURE = [[0.7, 0.3], [0.5, 0.5], [0.1, 0.9], [1.0, 0.0]]
# phase "whisper": whisper-base at published width and depth
WHISPER_ARCH = "whisper-base"
WHISPER_B, WHISPER_GEN, WHISPER_FORCED = 4, 16, 8   # W1: requests, greedy, teacher-forced
WHISPER_ROUNDS = 2                                   # W2: loop rounds, then the replay
# kernel 8 at ragged lengths, (B, Lq, Lkv, Hq, Hkv, hd, causal, dtype, label)
RAGGED_FLASH = [(4, 1500, 1500, 8, 8, 64, False, "bfloat16", "encoder layer"),
                (4, 1500, 1500, 8, 8, 64, False, "float32", "encoder layer"),
                (4, 64, 1500, 8, 8, 64, False, "bfloat16", "cross attention, Lq 64"),
                (4, 1500, 1500, 8, 8, 64, True, "bfloat16", "causal 1500"),
                (4, 77, 77, 8, 8, 80, True, "bfloat16", "odd length 77, hd 80"),
                (4, 77, 77, 4, 4, 256, True, "bfloat16", "odd length 77, hd 256")]
# kernel 8 where a short query range splits its keys (split_plan), (B,
# Lq, Lkv, Hq, Hkv, hd, causal, window, dtype, label): whisper's cross
# attention in fp32 (its bf16 row is RAGGED_FLASH's), 16 and 1 queries
# over a 4,096 cache under GQA 32/8 (hd 128), a windowed GQA call whose
# window masks no key, and 512 queries under a window of 100, which leaves
# rows with no live key in the first chunk (a block with none at all)
SPLIT_FLASH = [(4, 64, 1500, 8, 8, 64, False, None, "float32", "cross attention, Lq 64, fp32"),
               (1, 16, 4096, 32, 8, 128, False, None, "bfloat16", "Lq 16 over 4,096, GQA 32/8"),
               (1, 1, 4096, 32, 8, 128, False, None, "bfloat16", "Lq 1 over 4,096, GQA 32/8"),
               (1, 64, 4096, 32, 8, 64, False, 2048, "bfloat16",
                "Lq 64 over 4,096, GQA 32/8, window 2,048"),
               (1, 512, 4096, 1, 1, 128, False, 100, "bfloat16",
                "Lq 512 over 4,096, window 100"),
               (1, 512, 4096, 1, 1, 128, False, 100, "float32",
                "Lq 512 over 4,096, window 100, fp32")]
PEAK_FLOPS_TF32 = 495e12   # FLOP/s, an H100 SXM's dense TF32 tensor-core peak
BF16_GAP = 5e-2   # a greedy flip between kernel and plain runs must be a near-tie:
# a logit gap under this, or under two bf16 steps at the logits' magnitude;
# past it, the fp32 reference must pick the kernel run's token


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, by
    CUDA events, after a warm-up. When a call takes less device time than
    the host needs to issue it, this is the host's issue time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 100, iters: int = 20) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed ``iters`` times, so no host work sits between the
    launches (for calls too short for ``time_ms`` to see the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(n: int, x: int, kernel: str, noise: bool = False, m: int = 0,
          qblock: int = 1, s: int = 1, live: int = 0, width: int = 0) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") of a mix kernel, by the one
    reckoning of kernel work (``roofline/analysis.kernel_bound``): each
    input read once, each output written once, fp32 arithmetic. For the
    dequant kernels ``x`` is the padded width Xp and ``m`` the output
    rows; ``s`` is the stack's slab count; ``live`` the sparse kernels'
    live columns (the work this run's masks need), ``width`` the masked
    dequant's logical width X."""
    from repro_torch.roofline.analysis import kernel_bound

    if kernel == "gossip_mix_stack":
        return kernel_bound(kernel, s=s, n=n, x=x)
    if kernel in ("gossip_mix_dequant", "mixture_mix_dequant4"):
        return kernel_bound(kernel, m=m, n=n, xp=x, qblock=qblock)
    if kernel == "gossip_mix_sparse":
        return kernel_bound(kernel, n=n, x=x, live=live)
    if kernel == "gossip_mix_dequant_masked":
        return kernel_bound(kernel, m=m, n=n, xp=x, qblock=qblock, live=live, width=width)
    if kernel == "gossip_mix_fused_dp":
        return kernel_bound(kernel, n=n, x=x, noise=noise)
    return kernel_bound(kernel, n=n, x=x)


def launch_floor(torch):
    """A ``zero_()`` of one element: the least device time a launch takes
    in a CUDA graph, timed beside the µs kernels."""
    z = torch.zeros(1, device="cuda")
    return lambda: z.zero_()


def mix_constant(name: str) -> int:
    """A width constant of the gossip mix, read from the kernel's source:
    kNarrowMaxX (below it a square W of N <= 32 rows takes the narrow
    kernel) or kDpVecMinX (from it the fused DP mix at an even X takes its
    vector kernel)."""
    src = pathlib.Path(ROOT, "src", "repro_torch", "kernels", "csrc", "gossip_mix.cu")
    return int(re.search(rf"constexpr int64_t {name} = (\d+);", src.read_text()).group(1))


def phase_kernels(torch, gm, timed_shapes=None) -> dict:
    """Kernels 1 and 2 at SHAPES, kernel 2 also at both sides of its
    routes' widths (the narrow kernel below kDpVecMinX, its vector kernel
    from it at an even X; past kNarrowMaxX mix_kernel at an odd X and the
    vector kernel at an even one), each kernel-2 row bit for
    bit against mix_kernel (the one-slab stack mix) of the plane that torch
    sanitized, one op a step. With ``timed_shapes``, both kernels at those
    shapes only (the launch floor beside the first)."""
    dev = torch.device("cuda")
    rows = {"gossip_mix_flat": [], "gossip_mix_fused_dp": []}
    floor = launch_floor(torch)
    if timed_shapes is None:
        print("launch_floor_ms " + json.dumps({"ms": graph_ms(floor)}), flush=True)
        cap, vec = mix_constant("kNarrowMaxX"), mix_constant("kDpVecMinX")
        edges = [(20, vec - 2), (20, vec), (20, cap - 1), (20, cap + 1), (20, cap + 2)]
        timed_shapes, shapes = SHAPES, SHAPES + edges
    else:
        shapes = timed_shapes
    for n, x in shapes:
        g = torch.Generator(device=dev).manual_seed(n * 7 + x)
        w = torch.rand((n, n), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c_old = torch.randn((n, x), generator=g, device=dev)
        c_new = c_old + 0.1 * torch.randn((n, x), generator=g, device=dev)
        scale = 0.2 + 0.8 * torch.rand((n, 1), generator=g, device=dev)
        noise = torch.randn((n, x), generator=g, device=dev)
        small = x < 10**6  # small: device time by graph replay; else events
        iters = 200 if small else 20

        def timed(fn):
            return graph_ms(fn) if small else time_ms(fn, iters)

        if (n, x) in timed_shapes:
            out = gm.gossip_mix_flat(w, c_old)
            torch.cuda.synchronize()
            err = float((out - gm.gossip_mix_flat_ref(w, c_old)).abs().max())
            check(err <= TOL, f"gossip_mix_flat N={n} X={x}: max abs err {err} > {TOL}")
            b_ms, b_by = bound(n, x, "gossip_mix_flat", False)
            rows["gossip_mix_flat"].append(dict(
                n=n, x=x, max_abs_err=err,
                ms=timed(lambda: gm.gossip_mix_flat(w, c_old)),
                plain_ms=timed(lambda: gm.gossip_mix_flat_ref(w, c_old)),
                library_ms=timed(lambda: torch.matmul(w, c_old)),
                bound_ms=b_ms, bound_by=b_by,
                call_ms=time_ms(lambda: gm.gossip_mix_flat(w, c_old), iters),
                **({"floor_ms": timed(floor)} if (n, x) == timed_shapes[0] else {})))

        for sigma in (0.0, 0.5):
            nz = noise if sigma > 0 else None
            out = gm.gossip_mix_fused_dp(w, c_old, c_new, scale, nz, sigma)
            # mix_kernel's bits: the plane sanitized by torch, then the
            # one-slab stack mix (which takes neither the narrow nor the
            # vector kernel)
            san = c_old + scale * (c_new - c_old)
            if sigma > 0:
                san = san + sigma * noise
            witness = gm.gossip_mix_stack(w, san[None])[0]
            torch.cuda.synchronize()
            want = gm.gossip_mix_fused_dp_ref(w, c_old, c_new, scale, nz, sigma)
            err = float((out - want).abs().max())
            tag = f"gossip_mix_fused_dp N={n} X={x} sigma={sigma}"
            check(err <= TOL, f"{tag}: max abs err {err} > {TOL}")
            check(bool(torch.equal(out, witness)), f"{tag}: not mix_kernel's bits")
            b_ms, b_by = bound(n, x, "gossip_mix_fused_dp", sigma > 0)
            ms = timed(lambda: gm.gossip_mix_fused_dp(w, c_old, c_new, scale, nz, sigma))
            rows["gossip_mix_fused_dp"].append(dict(
                n=n, x=x, sigma=sigma, max_abs_err=err, bits_as_mix_kernel=True, ms=ms,
                plain_ms=timed(lambda: gm.gossip_mix_fused_dp_ref(
                    w, c_old, c_new, scale, nz, sigma)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                # a yardstick, not the function: W times the plane sanitized beforehand
                sanitized_matmul_ms=timed(lambda: torch.matmul(w, san)),
                call_ms=time_ms(lambda: gm.gossip_mix_fused_dp(
                    w, c_old, c_new, scale, nz, sigma), iters),
                **({"floor_ms": timed(floor)} if (n, x) == timed_shapes[0] else {})))
            del san, witness
        del w, c_old, c_new, scale, noise, out
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            print(f"kernel {name} " + json.dumps(r), flush=True)
    return rows


def phase_stack_kernel(torch, gm) -> list:
    """``gossip_mix_stack`` against its plain version at STACK_SHAPES,
    timed beside its bound, its plain version and one ``torch.matmul``
    broadcast over the S slabs."""
    dev = torch.device("cuda")
    rows = []
    for s, n, x in STACK_SHAPES:
        g = torch.Generator(device=dev).manual_seed(s * 7 + n + x)
        w = torch.rand((n, n), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c = torch.randn((s, n, x), generator=g, device=dev)
        small = 4 * s * n * x < 32 * 2**20   # graph replay; else events
        iters = 200 if small else 20

        def timed(fn):
            return graph_ms(fn) if small else time_ms(fn, iters)

        out = gm.gossip_mix_stack(w, c)
        torch.cuda.synchronize()
        err = float((out - gm.gossip_mix_stack_ref(w, c)).abs().max())
        check(bool(torch.isfinite(out).all()) and out.shape == c.shape,
              f"gossip_mix_stack S={s} N={n} X={x}: output not finite (S, N, X)")
        check(err <= TOL, f"gossip_mix_stack S={s} N={n} X={x}: max abs err {err} > {TOL}")
        b_ms, b_by = bound(n, x, "gossip_mix_stack", s=s)
        rows.append(dict(
            s=s, n=n, x=x, max_abs_err=err,
            ms=timed(lambda: gm.gossip_mix_stack(w, c)),
            plain_ms=timed(lambda: gm.gossip_mix_stack_ref(w, c)),
            library_ms=timed(lambda: torch.matmul(w, c)),
            bound_ms=b_ms, bound_by=b_by,
            call_ms=time_ms(lambda: gm.gossip_mix_stack(w, c), iters)))
        del w, c, out
        torch.cuda.empty_cache()
    for r in rows:
        print("kernel gossip_mix_stack " + json.dumps(r), flush=True)
    return rows


def _serve_operands(torch, b: int, s: int, x: int, qblock: int, codec: str, seed: int):
    """(u (B, S), quantized plane in its kernel's form, scales): Dirichlet
    mixture rows and a Gaussian plane encoded as the artifacts encode it
    (nearest rounding, padded to whole blocks)."""
    import numpy as np

    from repro_torch.comm.codecs import Channel, CommConfig, int4_pack

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.dirichlet(np.ones(s), size=b).astype(np.float32)).cuda()
    plane = torch.as_tensor((0.05 * rng.standard_normal((s, x))).astype(np.float32)).cuda()
    enc = Channel(CommConfig(codec=codec, block=qblock), x).encode(plane, rounding="nearest")
    q = int4_pack(enc["q"]) if codec == "int4" else enc["q"]
    return u, q.contiguous(), enc["scale"].contiguous()


def phase_dequant_kernels(torch, gm, timed_shapes=None) -> dict:
    """The serving kernels against their plain versions, timed at the
    serving shapes; gossip_mix_dequant also checked at DEQUANT_CHECKS.
    With ``timed_shapes``, gossip_mix_dequant at those shapes only."""
    kinds = (("gossip_mix_dequant", "int8"), ("mixture_mix_dequant4", "int4"))
    if timed_shapes is not None:
        kinds = kinds[:1]
    rows = {name: [] for name, _ in kinds}
    floor = launch_floor(torch)
    for name, codec in kinds:
        kernel, plain = getattr(gm, name), getattr(gm, name + "_ref")
        if timed_shapes is not None:
            shapes = timed_set = timed_shapes
        else:
            shapes = SERVE_SHAPES + (DEQUANT_CHECKS if codec == "int8" else [])
            timed_set = SERVE_SHAPES + [GOSSIP_DEQUANT]
        for b, s, x, qblock in shapes:
            u, q, sc = _serve_operands(torch, b, s, x, qblock, codec, seed=b + x)
            xp = sc.shape[1] * qblock
            out = kernel(u, q, sc, qblock=qblock)
            torch.cuda.synchronize()
            err = float((out - plain(u, q, sc, qblock=qblock)).abs().max())
            check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (b, xp),
                  f"{name} B={b} S={s} X={x}: output {tuple(out.shape)} not finite (B, Xp)")
            check(err <= TOL, f"{name} B={b} S={s} X={x} qblock={qblock}: "
                              f"max abs err {err} > {TOL}")
            row = dict(m=b, n=s, x=x, xp=xp, qblock=qblock, max_abs_err=err)
            if codec == "int8" and b == s > 1:
                # the square W against its first N - 1 rows, which take the
                # serving template: the same bits whichever kernel runs
                part = kernel(u[:-1].contiguous(), q, sc, qblock=qblock)
                row["bits_as_serving_template"] = bool(torch.equal(out[:-1], part))
                check(row["bits_as_serving_template"],
                      f"{name} M=N={b} Xp={xp}: rows differ from the serving template's")
            if (b, s, x, qblock) in timed_set:
                small = 4 * b * xp < 32 * 2**20   # graph replay; else events
                iters = 200 if small else 20

                def timed(fn):
                    return graph_ms(fn) if small else time_ms(fn, iters)

                # the fp32 artifact's (S, X) plane: the decoded one, cropped
                plane = plain(torch.eye(s, device=u.device), q, sc, qblock=qblock)[:, :x]
                plane = plane.contiguous()
                b_ms, b_by = bound(s, xp, name, m=b, qblock=qblock)
                # a yardstick, not the function: storing the (B, Xp) output
                # alone, the write rate this card reaches
                sink = torch.empty_like(out)
                row.update(
                    ms=timed(lambda: kernel(u, q, sc, qblock=qblock)),
                    plain_ms=timed(lambda: plain(u, q, sc, qblock=qblock)),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    fp32_path_matmul_ms=timed(lambda: torch.matmul(u, plane)),
                    store_only_ms=timed(lambda: sink.fill_(0.0)),
                    call_ms=time_ms(lambda: kernel(u, q, sc, qblock=qblock), iters),
                    **({"floor_ms": timed(floor)} if b == s else {}))
                del plane, sink
            rows[name].append(row)
            del u, q, sc, out
            torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            print(f"kernel {name} " + json.dumps(r), flush=True)
    return rows


def _sparse_operands(torch, n: int, x: int, layout: str, seed: int, qblock: int = QBLOCK):
    """(w, mask, c, col_active, enc): a row-stochastic W, density-0.2 masks
    (``random``: every client its own k_active columns; ``band``: every
    client the same k_active-wide band in the middle of X; ``dead``: no
    column kept), C zero off the mask, and C encoded as the int8 exchange
    encodes it (block ``qblock``, stochastic rounding)."""
    from repro_torch.comm.codecs import Channel, CommConfig
    from repro_torch.core.sparse import SparseConfig, column_activity, init_masks

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((n, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    sp = SparseConfig(density=SPARSE["density"])
    if layout == "random":
        mask = init_masks(g, n, x, sp)
    else:
        k = sp.k_active(x) if layout == "band" else 0
        lo = (x - k) // 2
        mask = torch.zeros((n, x), device=dev)
        mask[:, lo:lo + k] = 1.0
    c = torch.randn((n, x), generator=g, device=dev) * mask
    enc = Channel(CommConfig(codec="int8", block=qblock), x).encode(c, g)
    return w, mask, c, column_activity(mask), enc


def phase_sparse_kernels(torch, gm) -> dict:
    """Kernels 5 and 6 against their plain versions at SPARSE_SHAPES, the
    inactive columns exact zeros, timed beside their bounds."""
    rows = {"gossip_mix_sparse": [], "gossip_mix_dequant_masked": []}
    floor = launch_floor(torch)
    for n, x, layout in SPARSE_SHAPES:
        w, mask, c, act, enc = _sparse_operands(torch, n, x, layout, seed=n + x)
        q, sc = enc["q"], enc["scale"]
        xp = q.shape[1]
        small = 4 * n * x < 32 * 2**20   # graph replay; else events
        iters = 200 if small else 20

        def timed(fn):
            return graph_ms(fn) if small else time_ms(fn, iters)

        live = int(act.sum())
        slabs = torch.nn.functional.pad(act, (0, -x % 128)).view(-1, 128).amax(dim=1)
        dead_share = 1.0 - float(slabs.mean())
        dead = act == 0
        out = gm.gossip_mix_sparse(w, c, act)
        torch.cuda.synchronize()
        err = float((out - gm.gossip_mix_sparse_ref(w, c, act)).abs().max())
        check(err <= TOL, f"gossip_mix_sparse N={n} X={x} {layout}: max abs err {err} > {TOL}")
        check(bool((out[:, dead] == 0).all()),
              f"gossip_mix_sparse N={n} X={x} {layout}: inactive columns not exact zeros")
        b_ms, b_by = bound(n, x, "gossip_mix_sparse", live=live)
        rows["gossip_mix_sparse"].append(dict(
            n=n, x=x, layout=layout, x_live=live, dead_slab_share=dead_share,
            max_abs_err=err, ms=timed(lambda: gm.gossip_mix_sparse(w, c, act)),
            plain_ms=timed(lambda: gm.gossip_mix_sparse_ref(w, c, act)),
            library_ms=timed(lambda: torch.matmul(w, c)), bound_ms=b_ms, bound_by=b_by,
            call_ms=time_ms(lambda: gm.gossip_mix_sparse(w, c, act), iters),
            **({"floor_ms": timed(floor)} if x == SPARSE_SHAPES[0][1] else {})))

        out = gm.gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=QBLOCK)
        torch.cuda.synchronize()
        want = gm.gossip_mix_dequant_masked_ref(w, q, sc, mask, act, qblock=QBLOCK)
        err = float((out - want).abs().max())
        check(err <= TOL, f"gossip_mix_dequant_masked N={n} X={x} {layout}: "
                          f"max abs err {err} > {TOL}")
        check(bool((out[:, :x][:, dead] == 0).all()) and bool((out[:, x:] == 0).all()),
              f"gossip_mix_dequant_masked N={n} X={x} {layout}: inactive columns not "
              "exact zeros")
        b_ms, b_by = bound(n, xp, "gossip_mix_dequant_masked", m=n, qblock=QBLOCK, live=live,
                           width=x)
        # a yardstick, not the function: W times the decoded masked plane
        decoded = (q.float() * sc.repeat_interleave(QBLOCK, dim=1))[:, :x] * mask
        rows["gossip_mix_dequant_masked"].append(dict(
            m=n, n=n, x=x, xp=xp, qblock=QBLOCK, layout=layout, x_live=live,
            dead_slab_share=dead_share, max_abs_err=err,
            ms=timed(lambda: gm.gossip_mix_dequant_masked(w, q, sc, mask, act,
                                                          qblock=QBLOCK)),
            plain_ms=timed(lambda: gm.gossip_mix_dequant_masked_ref(w, q, sc, mask, act,
                                                                    qblock=QBLOCK)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            decoded_matmul_ms=timed(lambda: torch.matmul(w, decoded)),
            call_ms=time_ms(lambda: gm.gossip_mix_dequant_masked(w, q, sc, mask, act,
                                                                 qblock=QBLOCK), iters),
            **({"floor_ms": timed(floor)} if x == SPARSE_SHAPES[0][1] else {})))
        del w, mask, c, act, enc, q, sc, out, want, decoded
        torch.cuda.empty_cache()
    for n, x, qb, layout in MASKED_CHECKS:
        w, mask, c, act, enc = _sparse_operands(torch, n, x, layout, seed=n + x, qblock=qb)
        q, sc = enc["q"], enc["scale"]
        out = gm.gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=qb)
        torch.cuda.synchronize()
        want = gm.gossip_mix_dequant_masked_ref(w, q, sc, mask, act, qblock=qb)
        err = float((out - want).abs().max())
        tag = f"gossip_mix_dequant_masked N={n} X={x} qblock={qb} {layout}"
        check(err <= TOL, f"{tag}: max abs err {err} > {TOL}")
        check(bool((out[:, :x][:, act == 0] == 0).all()) and bool((out[:, x:] == 0).all()),
              f"{tag}: inactive columns not exact zeros")
        rows["gossip_mix_dequant_masked"].append(dict(
            m=n, n=n, x=x, xp=q.shape[1], qblock=qb, layout=layout, x_live=int(act.sum()),
            max_abs_err=err))
        del w, mask, c, act, enc, q, sc, out, want
    for name, rs in rows.items():
        for r in rs:
            print(f"kernel {name} " + json.dumps(r), flush=True)
    return rows


def phase_sparse_agreement(torch) -> None:
    """One full-width sparse + int8 + error-feedback round on the card
    against the CPU, from one state with the same injected draws: the
    round after a first (CPU) round, so the residual is not zero; RigL
    does not fire in it (update_every = 4). Both sides round
    stochastically from their own fp32 inputs, which differ in the last
    bits: where an input sits within that distance of a rounding step,
    the two round one quantum apart (a near-tie, seen as a residual that
    differs by more than 1e-5). Those columns are counted and left out;
    every other column must agree within 1e-5."""
    from repro_torch.comm.codecs import CommConfig
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import FedSPDConfig, make_round_step, seeded_init
    from repro_torch.core.gossip import GossipSpec, make_mix_fn
    from repro_torch.core.sparse import SparseConfig, init_masks
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments.registry import build_context

    data, exp = make_mixture_classification(), PaperExpConfig()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    ctxs = {d: build_context(data, exp, d) for d in (cpu, gpu)}
    n, m, ps = ctxs[cpu].n_clients, data.x.shape[1], ctxs[cpu].pack_spec
    sp, comm = SparseConfig(**SPARSE), CommConfig(codec="int8", error_feedback=True)
    cfg = FedSPDConfig(n_clients=n, n_clusters=data.n_clusters, tau=exp.tau, batch=exp.batch)
    g = torch.Generator().manual_seed(3)
    st = seeded_init(torch.Generator().manual_seed(0), ctxs[cpu].model_init, cfg,
                     ctxs[cpu].loss_fn, ctxs[cpu].train, ps, epochs=2)
    st = st._replace(mask=init_masks(g, n, ps.size, sp),
                     ef=torch.zeros((n, ps.size)))
    steps = {}
    for d in (cpu, gpu):
        ctx = ctxs[d]
        spec = GossipSpec.from_graph(ctx.graph)
        steps[d] = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, cfg, pack_spec=ps,
                                   mix_fn=make_mix_fn(spec, "cuda", comm=comm),
                                   comm=comm, sparse=sp)
    st, _ = steps[cpu](st._replace(gen=torch.Generator().manual_seed(4)), ctxs[cpu].train)
    check(st.round == 1 and not sp.update_due(st.round), "agreement: round 1 must not fire RigL")
    s = torch.randint(0, data.n_clusters, (n,), generator=g)
    idx = torch.randint(0, m, (cfg.tau, n, cfg.batch), generator=g)
    u = torch.rand((n, -(-ps.size // QBLOCK), QBLOCK), generator=g)
    out = {}
    for d in (cpu, gpu):
        st_d = st._replace(centers=st.centers.to(d, copy=True), u=st.u.to(d), z=st.z.to(d),
                           comm_bytes=st.comm_bytes.to(d), ef=st.ef.to(d),
                           mask=st.mask.to(d), gen=torch.Generator(device=d))
        new, _ = steps[d](st_d, ctxs[d].train, s=s.to(d), idx=idx.to(d), comm_u=u.to(d))
        out[d.type] = [t.cpu() for t in (new.centers, new.ef, new.mask, new.u, new.z,
                                         new.comm_bytes)]
    (pc, ec, mc, uc, zc, bc), (pg, eg, mg, ug, zg, bg) = out["cpu"], out["cuda"]
    ties = (ec - eg).abs() > TOL
    clean = ~ties.any(dim=0)            # columns no near-tie touches
    n_active = int(st.mask.sum())
    plane_err = float((pc - pg)[..., clean].abs().max())
    ef_err = float((ec - eg)[..., clean].abs().max())
    agree = float((zc == zg).float().mean())
    print(f"agreement sparse+int8+ef: plane max abs err {plane_err:.3g}, ef max abs err "
          f"{ef_err:.3g} (near-ties {int(ties.sum())} of {n_active} active entries, "
          f"{int((~clean).sum())} of {ps.size} columns left out, max tie diff "
          f"{float((ec - eg).abs().max()):.3g}), masks equal {bool(torch.equal(mc, mg))}, "
          f"z agreement {agree:.6f}, u max abs err {float((uc - ug).abs().max()):.3g}, "
          f"comm_bytes {float(bc)} vs {float(bg)}", flush=True)
    check(bool(torch.isfinite(pg).all()) and bool(torch.isfinite(eg).all()),
          "sparse agreement: non-finite plane or residual on the card")
    check(int(ties.sum()) <= max(8, n_active // 10000),
          f"sparse agreement: {int(ties.sum())} near-ties, more than rounding noise explains")
    check(plane_err <= TOL and ef_err <= TOL,
          f"sparse agreement: plane err {plane_err}, ef err {ef_err} > {TOL}")
    check(torch.equal(mc, mg), "sparse agreement: masks differ")
    check(agree >= 0.99, f"sparse agreement: z agreement {agree} < 0.99")
    check(float(bc) == float(bg), "sparse agreement: comm_bytes differ")


def phase_sparse_comm_path(torch, gm) -> tuple[dict, float]:
    """The fourth path: FedSPD for ROUNDS rounds with a wire codec and with
    DisPFL masks. Returns the launches summed over its runs and the
    sparse + int8 run's median round ms."""
    from repro_torch.comm.codecs import CommConfig
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.sparse import SparseConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=ROUNDS)
    sp = SparseConfig(**SPARSE)
    int8, topk = (CommConfig(codec=c, error_feedback=True) for c in ("int8", "topk"))
    total, sparse_ms = {k.__name__: 0 for k in gm.KERNELS}, None
    for label, kw, wire, want in (
            ("dense int8+ef", dict(comm=int8), "int8", {"gossip_mix_dequant": ROUNDS}),
            ("dense topk+ef", dict(comm=topk), "topk", {"gossip_mix_flat": ROUNDS}),
            ("sparse d0.2", dict(sparse=sp), "sparse", {"gossip_mix_sparse": 2 * ROUNDS}),
            ("sparse d0.2 int8+ef", dict(sparse=sp, comm=int8), "sparse_int8",
             {"gossip_mix_dequant_masked": ROUNDS, "gossip_mix_sparse": ROUNDS})):
        gm.reset_launch_counts()
        r = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="cuda",
                                                          scan_rounds=False, **kw))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        for k, c in counts.items():
            total[k] += c
        ms = r.extras["round_ms"]
        med = statistics.median(ms[1:])
        if label == "sparse d0.2 int8+ef":
            sparse_ms = med
        print(f"sparse/comm {label}: mean_acc {r.mean_acc:.6f} std_acc {r.std_acc:.6f} "
              f"comm_bytes {r.comm_bytes:.0f} wire_bytes {r.wire_bytes:.1f} "
              f"wire/comm {r.wire_bytes / r.comm_bytes:.6f} launches {json.dumps(counts)} "
              f"round_ms median(rounds 2-{ROUNDS}) {med:.3f} first {ms[0]:.3f} "
              f"all {json.dumps([round(v, 3) for v in ms])} wall_s {r.wall_s:.2f}", flush=True)
        expect = {k: 0 for k in counts}
        expect.update(want)
        check(counts == expect, f"sparse/comm {label}: launches {counts}, expected {expect}")
        check(r.wire_bytes == r.comm_bytes * (WIRE_PER_MSG[wire] / 68904.0),
              f"sparse/comm {label}: wire_bytes {r.wire_bytes} != comm_bytes "
              f"{r.comm_bytes} x {WIRE_PER_MSG[wire]}/68904")
        check(math.isfinite(r.mean_acc) and 0.0 <= r.mean_acc <= 1.0,
              f"sparse/comm {label}: mean_acc {r.mean_acc} not finite in [0, 1]")
        check(r.comm_bytes > 0, f"sparse/comm {label}: no bytes accounted")
    return total, sparse_ms


def _state_to(torch, state, device):
    """A copy of a baseline state (a bare plane, ``WithEF`` or a state
    NamedTuple) on ``device``; fields that are None stay None."""
    if isinstance(state, torch.Tensor):
        return state.to(device, copy=True)
    return type(state)(*(None if t is None else t.to(device, copy=True) for t in state))


def _same_run(torch, a, b) -> list:
    """What differs between two runs that must be equal bit for bit: the
    per-client accuracies, the curve, u, the bytes, a heterogeneity
    scenario's staleness counters and, with keep_state, every tensor of
    the final state (the plane among them)."""
    import numpy as np

    diff = []
    if not np.array_equal(a.acc_per_client, b.acc_per_client):
        diff.append("acc_per_client")
    if a.curve != b.curve:
        diff.append("curve")
    if a.comm_bytes != b.comm_bytes or a.wire_bytes != b.wire_bytes:
        diff.append("comm_bytes")
    if ("staleness" in a.extras) != ("staleness" in b.extras) or (
            "staleness" in a.extras
            and not np.array_equal(a.extras["staleness"], b.extras["staleness"])):
        diff.append("staleness")
    if "u" in a.extras and not np.array_equal(a.extras["u"], b.extras["u"]):
        diff.append("u")
    if "state" in a.extras:
        from repro_torch.utils.pytree import state_tensors

        for i, (x, y) in enumerate(zip(state_tensors(a.extras["state"]),
                                       state_tensors(b.extras["state"]))):
            if not torch.equal(x, y):
                diff.append(f"state field {i}")
    return diff


class _Kernel:
    """A device event of a trace: its name and its time range (µs)."""

    __slots__ = ("name", "time_range")

    def __init__(self, event):
        from torch.autograd.profiler_util import Interval

        self.name = event.name()
        self.time_range = Interval(event.start_ns() / 1e3, event.end_ns() / 1e3)


def _round_kernels(prof, span: str | None = None) -> list:
    """Each round's device work in a profiled run, in round order: the
    device events whose launch (a CUDA runtime call on the host: a replay's
    ``cudaGraphLaunch``, a step's kernel launches and copies) falls inside
    one of the runner's ROUND_SPAN spans (or ``span``'s: the server's
    decode tokens), matched by the runtime's correlation id (both sides on
    their own clock). It reads the trace's raw events
    (``kineto_results``): ``prof.events()`` would build the whole event
    tree first, seconds for every 10^4 host ops of the run's eager parts."""
    import bisect

    from repro_torch.experiments.runner import ROUND_SPAN

    span = span or ROUND_SPAN

    def is_span(name):   # the launcher's spans carry the round: "repro/round#3"
        return name == span or name.startswith(span + "#")

    by_id: dict = {}
    spans, launches = [], []
    for e in prof.profiler.kineto_results.events():
        # torch's own parse skips hidden events, and reads the flag the same
        # way (torch builds without it have none)
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name, device = e.name(), e.device_type().name
        if is_span(name):
            if device == "CPU":
                spans.append((e.start_ns(), e.end_ns()))
        elif device == "CUDA":
            by_id.setdefault(e.correlation_id(), []).append(e)
        elif device == "CPU" and name.startswith("cu"):
            launches.append(e)
    spans.sort()
    starts = [a for a, _ in spans]
    windows = [[] for _ in spans]
    for e in sorted(launches, key=lambda e: e.start_ns()):
        kern = by_id.get(e.correlation_id())
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if kern and i >= 0 and e.start_ns() <= spans[i][1]:
            windows[i].extend(_Kernel(k) for k in kern)
    return windows


def _is_exchange(name: str) -> bool:
    """An exchange kernel of the port (kernels 1-6): every one of their
    symbols holds one of these names."""
    return "mix_kernel" in name or "mix_dequant_kernel" in name


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profiled(rounds: int) -> tuple[int, int]:
    """The rounds [first, end) of a run profiled for its busy share: three
    from its middle ([15, 18) of the engines phase's 30)."""
    return rounds // 2, rounds // 2 + 3


def _windowed(run, cfg, rounds: int):
    """``run`` with a profiler over the rounds ``profiled(rounds)`` only,
    started and stopped by the run's ``on_round`` hook. The profiler starts
    one round early and that round's kernels are dropped: the trace can miss
    the first launches after the profiler starts. Returns the result, the
    profiled rounds' kernels, and the device ms a round, the median round
    ms of the rounds not profiled (round 1 and the dropped round aside) and
    their ratio, the busy share, all of this one run."""
    prof, (first, end) = _profiler(), profiled(rounds)

    def on_round(r):
        if r == first - 2:
            prof.start()
        elif r == end - 1:
            prof.stop()

    res = run(dataclasses.replace(cfg, on_round=on_round))
    one = res[0] if isinstance(res, list) else res
    windows = _round_kernels(prof)
    check(len(windows) == end - first + 1,
          f"the profiled window holds {len(windows)} rounds, expected {end - first + 1}")
    windows = windows[1:]
    dev = statistics.median(sum(k.time_range.elapsed_us() for k in w) / 1e3 for w in windows)
    free = statistics.median(v for i, v in enumerate(one.extras["round_ms"])
                             if i and not first - 1 <= i < end)
    return res, windows, {"device_ms": dev, "round_ms": free, "busy": dev / free}


def _engine_pair(torch, gm, label, method, data, exp, cfg, seeds=None, busy=False,
                 trace=True):
    """The same run on the loop engine (``scan_rounds=False``) and on the
    card's default engine, the replay, each with every launch counter set
    to 0 just before it and read just after, the replayed run under
    torch.profiler (``trace``; without it the replay runs unprofiled and
    ``windows`` is None). Fails unless the two are equal bit for bit, the
    replay's counters (its warm-up's and capture's launches) name the
    kernels the loop's name and, traced, every replayed round ran kernels
    on the card and the replays launched as many exchange kernels as the
    loop's counters. With ``busy``, the loop run and a second replayed run
    are profiled over ``profiled(rounds)`` only (``_windowed``): each
    engine's device ms a round and busy share from one run. Returns a
    dict."""
    from repro_torch.experiments import run_method, run_method_batch

    def run(c):
        return (run_method(method, data, exp, cfg=c) if seeds is None
                else run_method_batch(method, data, exp, seeds=seeds, cfg=c))

    def same(a, b, what):
        for i, (x, y) in enumerate(zip(a, b) if seeds is not None else [(a, b)]):
            diff = _same_run(torch, x, y)
            check(not diff, f"engines {label}: {what} differs from the loop (seed index {i}) "
                            f"in {diff}")

    out = {}
    loop_cfg, scan_cfg = (dataclasses.replace(cfg, scan_rounds=v) for v in (False, None))
    gm.reset_launch_counts()
    if busy:
        loop, _, out["loop_busy"] = _windowed(run, loop_cfg, exp.rounds)
    else:
        loop = run(loop_cfg)
    loop_counts = {k.__name__: k.launches for k in gm.KERNELS}
    gm.reset_launch_counts()
    if trace:
        with _profiler() as prof:
            scan = run(scan_cfg)
    else:
        scan = run(scan_cfg)
    counts = {k.__name__: k.launches for k in gm.KERNELS}
    same(loop, scan, "the replay")
    check({k for k, c in counts.items() if c} == {k for k, c in loop_counts.items() if c},
          f"engines {label}: replay launches {counts}, loop launches {loop_counts}")
    first = scan[0] if seeds is not None else scan
    check(first.extras["n_dispatches"] == exp.rounds,
          f"engines {label}: {first.extras['n_dispatches']} dispatches in {exp.rounds} rounds")
    windows = None
    if trace:
        windows = _round_kernels(prof)
        check(len(windows) == exp.rounds,
              f"engines {label}: the trace holds {len(windows)} round spans, expected "
              f"{exp.rounds}")
        check(all(windows), f"engines {label}: a replayed round ran no kernel on the card")
        replayed = sum(_is_exchange(k.name) for w in windows for k in w)
        check(replayed == sum(loop_counts.values()),
              f"engines {label}: the replays launched {replayed} exchange kernels, the loop "
              f"{sum(loop_counts.values())}")
    if busy:
        scan_w, _, out["replay_busy"] = _windowed(run, scan_cfg, exp.rounds)
        first_r, end_r = profiled(exp.rounds)
        same(loop, scan_w, f"the replay profiled over rounds {first_r + 1}-{end_r}")
    out.update(loop=loop[0] if seeds is not None else loop, scan=first, counts=counts,
               loop_counts=loop_counts, windows=windows,
               runs=scan if seeds is not None else [scan])
    return out


def _engine_line(label, pair) -> None:
    """One line per pair: both engines' round ms (rounds 2 on), the fully
    profiled replayed run's kernels, and with ``busy`` each engine's
    device ms a round and busy share from its windowed run."""
    loop, scan, windows = pair["loop"], pair["scan"], pair["windows"]
    lm, sm = loop.extras["round_ms"], scan.extras["round_ms"]
    names: dict = {}
    for k in (windows or [[]])[-1]:
        if _is_exchange(k.name):
            sym = re.search(r"\w*mix_\w*kernel\w*(<.*?>(?=\())?", k.name)
            key = (sym.group(0) if sym else k.name[:80]).replace("(anonymous namespace)::", "")
            names[key] = names.get(key, 0) + 1
    busy = ""
    first, end = profiled(len(lm))
    for engine in ("loop", "replay"):
        if f"{engine}_busy" in pair:
            b = pair[f"{engine}_busy"]
            busy += (f" {engine} (rounds {first + 1}-{end} profiled):"
                     f" device_ms_per_round {b['device_ms']:.4f} round_ms median of the rest "
                     f"{b['round_ms']:.4f} device_busy_share {b['busy']:.4f}")
    print(f"engines {label}: loop round_ms median(rounds 2-{len(lm)}) "
          f"{statistics.median(lm[1:]):.4f} replay round_ms median "
          f"{statistics.median(sm[1:]):.4f} first {sm[0]:.4f} "
          + (f"(whole run profiled) kernels_per_round {len(windows[-1])}" if windows else
             "(not profiled) kernels_per_round not traced")
          + f"{busy} capture_ms "
          f"{json.dumps([round(v, 1) for v in scan.extras['capture_ms']])} n_captures "
          f"{scan.extras['n_captures']} n_dispatches {scan.extras['n_dispatches']} "
          f"(loop {loop.extras['n_dispatches']}) mean_acc {scan.mean_acc:.6f} comm_bytes "
          f"{scan.comm_bytes:.0f} replay counters (warm-up + capture) "
          f"{json.dumps(pair['counts'])} exchange kernels in the last replay "
          f"{json.dumps(names) if windows else 'not traced'} loop wall_s {loop.wall_s:.2f} "
          f"replay wall_s {scan.wall_s:.2f} replay vs loop: equal", flush=True)


def phase_engines(torch, gm) -> dict:
    """The sixth path, the round engines: FedSPD for ENGINE_ROUNDS (the
    paper's 60: half of them) rounds, DP off and on, on the loop engine and on the
    card's default engine, replayed from one captured round, each engine's
    busy share from one run of it; then a cohort of 10 of the 20 clients,
    ``run_method_batch`` over seeds 0, 1, 2 (one graph for the three),
    sparse d0.2 + int8 + error feedback (two graphs: the mask update
    rounds and the rest) and each of the 11 baseline ids for ROUNDS
    rounds. Every replay equals its loop run bit for bit and its trace
    shows the replays' kernels (``_engine_pair``). The batch runs for
    PYTREE_ROUNDS, the pytree phase's depth. Returns the plane runs that
    the pytree phase holds its own against: ``"fedspd"`` (the DP-off
    pair), ``"batch"`` (the replayed seeds 0-2) and each baseline's loop
    run under its id."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.comm.codecs import CommConfig
    from repro_torch.core.sparse import SparseConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig

    data = make_mixture_classification()
    long = PaperExpConfig(rounds=ENGINE_ROUNDS)
    planes: dict = {}
    for label, opts, kernel in (("fedspd", {}, gm.gossip_mix_flat),
                                ("fedspd dp", DP_OPTIONS, gm.gossip_mix_fused_dp)):
        cfg = RunConfig(eval_every=10, options=dict(opts, keep_state=True))
        pair = _engine_pair(torch, gm, label, "fedspd", data, long, cfg, busy=True)
        _engine_line(label, pair)
        planes.setdefault("fedspd", pair)
        scan = pair["scan"]
        check(scan.extras["n_captures"] == 1,
              f"engines {label}: {scan.extras['n_captures']} captures, expected 1")
        check(pair["counts"][kernel.__name__] > 0,
              f"engines {label}: {kernel.__name__} was not launched in the run")
        check(all(sum(_is_exchange(k.name) for k in w) == 1 for w in pair["windows"]),
              f"engines {label}: a replayed round did not launch one exchange kernel")
        check(math.isfinite(scan.mean_acc) and scan.mean_acc > 0.1,
              f"engines {label}: mean_acc {scan.mean_acc} not above chance 0.1")
    short = PaperExpConfig(rounds=ROUNDS)
    keep = {"keep_state": True}
    int8 = CommConfig(codec="int8", error_feedback=True)
    for label, method, cfg, seeds, captures in (
            ("fedspd cohort 10/20", "fedspd", RunConfig(cohort_size=10, options=keep),
             None, 1),
            ("fedspd batch seeds 0-2", "fedspd", RunConfig(options=keep), (0, 1, 2), 1),
            ("fedspd sparse d0.2 int8+ef", "fedspd",
             RunConfig(sparse=SparseConfig(**SPARSE), comm=int8, options=keep), None, 2),
            *((f"baseline {b}", b, RunConfig(eval_every=10**9, options=keep), None, 1)
              for b in BASELINES)):
        exp = short if seeds is None else PaperExpConfig(rounds=PYTREE_ROUNDS)
        pair = _engine_pair(torch, gm, label, method, data, exp, cfg, seeds)
        _engine_line(label, pair)
        if seeds is not None:
            planes["batch"] = pair["runs"]
        elif label.startswith("baseline "):
            planes[method] = pair["loop"]
        scan = pair["scan"]
        check(scan.extras["n_captures"] == captures,
              f"engines {label}: {scan.extras['n_captures']} captures, expected {captures}")
        check(math.isfinite(scan.mean_acc) and 0.0 <= scan.mean_acc <= 1.0,
              f"engines {label}: mean_acc {scan.mean_acc} not finite in [0, 1]")
    return planes


def _scenario(rounds: int, kind: str):
    """Scenario A (a rewired ER schedule) or B (a ClientSystemModel), each
    with link dropout, over ``rounds`` rounds of the main path's
    population."""
    from repro_torch.experiments.heterogeneity import ClientSystemModel
    from repro_torch.experiments.scenarios import Scenario
    from repro_torch.graphs.topology import rewire_schedule

    if kind == "A":
        kw = dict(SCENARIO_REWIRE)
        return Scenario(graph_schedule=rewire_schedule(
            kw.pop("kind"), kw.pop("n"), kw.pop("avg_degree"), rounds, **kw),
            dropout=SCENARIO_DROPOUT)
    return Scenario(dropout=SCENARIO_DROPOUT, system=ClientSystemModel(**SCENARIO_SYSTEM))


def phase_scenario_agreement(torch, gm) -> dict:
    """One full-width round of scenario B on the card (kernels) against the
    CPU (plain versions), DP off and on, from one state with the same
    injected draws: the selections, batches and DP noise, the dropout
    uniforms and the heterogeneity normals and uniforms, over a carry with
    stale and unavailable clients. The round's W (stale columns scaled,
    inactive rows e_i) then feeds kernels 1, 2, 4, 5 and 6 on the card,
    each against its plain version on the same tensors (these launches
    count nowhere). Returns each kernel's max abs error on that W."""
    from repro_torch.comm.codecs import Channel, CommConfig
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import FedSPDConfig, make_round_step, seeded_init
    from repro_torch.core.gossip import GossipSpec, fedspd_weight_matrix, make_mix_fn
    from repro_torch.core.sparse import SparseConfig, column_activity, init_masks
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments.heterogeneity import (
        ClientSystemModel, HetCarry, apply_client_weights, draw_het, het_round,
        masked_client_step)
    from repro_torch.experiments.registry import build_context, get_method
    from repro_torch.experiments.scenarios import bernoulli_drop, draw_drop

    data, exp = make_mixture_classification(), PaperExpConfig()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    ctxs = {d: build_context(data, exp, d) for d in (cpu, gpu)}
    n, m, ps = ctxs[cpu].n_clients, data.x.shape[1], ctxs[cpu].pack_spec
    model = ClientSystemModel(**SCENARIO_SYSTEM)
    g = torch.Generator().manual_seed(6)
    adj_u, (z, u) = draw_drop(g, n), draw_het(g, n)
    carry = HetCarry(stale=torch.randint(0, 4, (n,), generator=g, dtype=torch.int32),
                     avail=(torch.rand(n, generator=g) > 0.3).float())
    w_card = None
    for clip, mult in ((0.0, 0.0), (1.0, 0.5)):
        cfg = FedSPDConfig(n_clients=n, n_clusters=data.n_clusters, tau=exp.tau,
                           batch=exp.batch, dp_clip=clip, dp_noise_multiplier=mult)
        st = seeded_init(torch.Generator().manual_seed(0), ctxs[cpu].model_init, cfg,
                         ctxs[cpu].loss_fn, ctxs[cpu].train, ps, epochs=2)
        s = torch.randint(0, data.n_clusters, (n,), generator=g)
        draws = dict(s=s, idx=torch.randint(0, m, (cfg.tau, n, cfg.batch), generator=g),
                     noise=torch.randn((n, ps.size), generator=g))
        out = {}
        for d in (cpu, gpu):
            ctx = ctxs[d]
            spec = GossipSpec.from_graph(ctx.graph)
            core = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, cfg, pack_spec=ps,
                                   mix_fn=make_mix_fn(spec, "cuda"))
            dd = {k: v.to(d) for k, v in draws.items()}
            step = masked_client_step(lambda st_, tr, gen, lr, a: core(st_, tr, a, **dd),
                                      get_method("fedspd").cohort_axes(ctx, st))
            st_d = st._replace(centers=st.centers.to(d, copy=True), u=st.u.to(d), z=st.z.to(d),
                               comm_bytes=st.comm_bytes.to(d), gen=torch.Generator(device=d))
            adj = bernoulli_drop(torch.as_tensor(ctx.graph.adj, device=d), adj_u.to(d),
                                 SCENARIO_DROPOUT)
            speeds = torch.as_tensor(model.resolve_speeds(n), device=d)
            new_carry, aw = het_round(model, speeds, HetCarry(*(t.to(d) for t in carry)),
                                      z.to(d), u.to(d))
            new, _ = step(st_d, ctx.train, None, None, adj, aw)
            w = fedspd_weight_matrix(spec, dd["s"], adj=apply_client_weights(adj, aw))
            out[d.type] = [t.cpu() for t in (new.centers, new.u, new.comm_bytes, aw,
                                             *new_carry)] + [w]
        (pc, uc, bc, wc, sc, ac, _), (pg, ug, bg, wg, sg, ag, w_card) = out["cpu"], out["cuda"]
        err, w_err = float((pc - pg).abs().max()), float((wc - wg).abs().max())
        active = int((wg > 0).sum())
        print(f"scenario agreement B dp_clip={clip}: plane max abs err {err:.3g}, u max abs "
              f"err {float((uc - ug).abs().max()):.3g}, activity weights max abs err "
              f"{w_err:.3g} ({active} of {n} active, {int(((wg > 0) & (wg < 1)).sum())} "
              f"decayed), stale and avail equal {bool(torch.equal(sc, sg) and torch.equal(ac, ag))}, "
              f"comm_bytes {float(bc)} vs {float(bg)}", flush=True)
        check(bool(torch.isfinite(pg).all()), "scenario agreement: non-finite plane on the card")
        check(err <= TOL, f"scenario agreement: plane max abs err {err} > {TOL}")
        check(torch.equal(sc, sg) and torch.equal(ac, ag) and torch.equal(wc > 0, wg > 0),
              "scenario agreement: the heterogeneity carry or activity differs")
        check(w_err <= TOL, f"scenario agreement: activity weights differ by {w_err}")
        check(float(bc) == float(bg), "scenario agreement: comm_bytes differ")
        check(0 < active < n, f"scenario agreement: {active} of {n} clients active")

    # the exchange kernels on the round's W, each against its plain version
    x, xg = ps.size, torch.Generator(device=gpu).manual_seed(7)
    c_old = torch.randn((n, x), generator=xg, device=gpu)
    c_new = c_old + 0.3 * torch.randn((n, x), generator=xg, device=gpu)
    scale = 0.2 + 0.8 * torch.rand((n, 1), generator=xg, device=gpu)
    noise = torch.randn((n, x), generator=xg, device=gpu)
    mask = init_masks(xg, n, x, SparseConfig(density=SPARSE["density"]))
    act, cm = column_activity(mask), c_new * mask
    dense = Channel(CommConfig(codec="int8", block=QBLOCK), x).encode(c_new, xg)
    masked = Channel(CommConfig(codec="int8", block=QBLOCK), x).encode(cm, xg)
    w = w_card.to(gpu)
    calls = {
        "gossip_mix_flat": ((w, c_new), {}),
        "gossip_mix_fused_dp": ((w, c_old, c_new, scale, noise, 0.5), {}),
        "gossip_mix_dequant": ((w, dense["q"], dense["scale"]), {"qblock": QBLOCK}),
        "gossip_mix_sparse": ((w, cm, act), {}),
        "gossip_mix_dequant_masked": ((w, masked["q"], masked["scale"], mask, act),
                                      {"qblock": QBLOCK}),
    }
    errs = {}
    for name, (args, kw) in calls.items():
        got = getattr(gm, name)(*args, **kw)
        want = getattr(gm, name + "_ref")(*args, **kw)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        print(f"scenario kernel {name} on scenario B's W (DP round): max abs err "
              f"{errs[name]:.3g}", flush=True)
        check(bool(torch.isfinite(got).all()), f"scenario kernel {name}: non-finite output")
        check(errs[name] <= TOL, f"scenario kernel {name}: max abs err {errs[name]} > {TOL}")
    return errs


def phase_scenarios(torch, gm, card: str) -> dict:
    """The scenario path: FedSPD for SCENARIO_ROUNDS rounds under scenario A
    (rewired ER schedule + dropout) and B (Markov heterogeneity + dropout),
    DP off and on, and B also with a cohort of 10, with dense int8 + error
    feedback and with sparse d0.2 + int8 + error feedback, each on the loop
    engine and on the replay (``_engine_pair``): bit for bit equal
    (accuracies, bytes, staleness, the final plane), one exchange kernel
    in every replayed round (two with sparse), and beside each the same
    run's replay without the scenario. One run of each scenario kind (A
    and B, DP off) is traced (``SCENARIO_TRACED``): its replay's kernels
    counted round by round, busy shares from ``_windowed``; every other
    run's exchange kernels a replay come from its loop's counters, and its
    replay's counters name the loop's kernels. The runs evaluate once,
    after the last round. Returns the loop runs' launches."""
    from repro_torch.comm.codecs import CommConfig
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.sparse import SparseConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=SCENARIO_ROUNDS)
    int8 = CommConfig(codec="int8", error_feedback=True)
    first, end = profiled(SCENARIO_ROUNDS)
    launches: dict = {}
    for label, kind, kw, kernel, per_round in (
            ("A", "A", {}, gm.gossip_mix_flat, 1),
            ("A dp", "A", {"options": DP_OPTIONS}, gm.gossip_mix_fused_dp, 1),
            ("B", "B", {}, gm.gossip_mix_flat, 1),
            ("B dp", "B", {"options": DP_OPTIONS}, gm.gossip_mix_fused_dp, 1),
            ("B cohort 10/20", "B", {"cohort_size": 10}, gm.gossip_mix_flat, 1),
            ("B int8+ef", "B", {"comm": int8}, gm.gossip_mix_dequant, 1),
            ("B sparse d0.2 int8+ef", "B", {"sparse": SparseConfig(**SPARSE), "comm": int8},
             gm.gossip_mix_dequant_masked, 2)):
        kw = dict(kw, options=dict(kw.get("options", {}), keep_state=True))
        # one evaluation, after the last round: the traced runs stay short
        plain_cfg = RunConfig(eval_every=10**9, **kw)
        cfg = dataclasses.replace(plain_cfg, scenario=_scenario(SCENARIO_ROUNDS, kind))
        traced = label in SCENARIO_TRACED
        pair = _engine_pair(torch, gm, f"scenario {label}", "fedspd", data, exp, cfg,
                            busy=traced, trace=traced)
        _engine_line(f"scenario {label}", pair)
        for name, c in pair["loop_counts"].items():
            launches[name] = launches.get(name, 0) + c
        scan = pair["scan"]
        if traced:
            per = [sum(_is_exchange(k.name) for k in w) for w in pair["windows"]]
            per_what = "exchange kernels per replay (trace)"
            lb, rb = pair["loop_busy"], pair["replay_busy"]
            timing = (f"round_ms median(rounds 2-{SCENARIO_ROUNDS} less the profiled "
                      f"{first}-{end}) loop {lb['round_ms']:.4f} replay {rb['round_ms']:.4f} "
                      f"device_ms_per_round replay {rb['device_ms']:.4f} busy share replay "
                      f"{rb['busy']:.4f} loop {lb['busy']:.4f}")
        else:
            # the loop launches a wrapper's kernel once a call: its counters
            # over the rounds are the exchange kernels a round
            total = sum(pair["loop_counts"].values())
            per = [total // SCENARIO_ROUNDS] * (SCENARIO_ROUNDS - 1) + [
                total - (SCENARIO_ROUNDS - 1) * (total // SCENARIO_ROUNDS)]
            per_what = "exchange kernels per replay (the loop's counters)"
            timing = (f"round_ms median(rounds 2-{SCENARIO_ROUNDS}) loop "
                      f"{statistics.median(pair['loop'].extras['round_ms'][1:]):.4f} replay "
                      f"{statistics.median(scan.extras['round_ms'][1:]):.4f} (not traced)")
        plain = run_method("fedspd", data, exp, cfg=plain_cfg)
        stale = scan.extras.get("staleness")
        print(f"scenario {label} ({card}): {timing} "
              f"capture_ms {json.dumps([round(v, 1) for v in scan.extras['capture_ms']])} "
              f"n_captures {scan.extras['n_captures']} n_dispatches "
              f"{scan.extras['n_dispatches']} {per_what} "
              f"{json.dumps(sorted(set(per)))} mean_acc {scan.mean_acc:.6f} without the "
              f"scenario {plain.mean_acc:.6f} comm_bytes {scan.comm_bytes:.0f} without "
              f"{plain.comm_bytes:.0f} staleness "
              f"{json.dumps(None if stale is None else stale.tolist())} "
              f"loop launches {json.dumps({k: c for k, c in pair['loop_counts'].items() if c})}",
              flush=True)
        check(per == [per_round] * SCENARIO_ROUNDS,
              f"scenario {label}: exchange kernels per replay {sorted(set(per))}, "
              f"expected {per_round}")
        check(pair["loop_counts"][kernel.__name__] > 0,
              f"scenario {label}: {kernel.__name__} was not launched by the loop")
        check(math.isfinite(scan.mean_acc) and 0.0 <= scan.mean_acc <= 1.0,
              f"scenario {label}: mean_acc {scan.mean_acc} not finite in [0, 1]")
        check(scan.comm_bytes > 0.0, f"scenario {label}: no bytes accounted")
        check((stale is not None) == (kind == "B"),
              f"scenario {label}: staleness {stale} for scenario {kind}")
    return launches


def _recorded_round(torch, ctx, m, gen_seed: int = 0):
    """Round 1 of ``run_method``'s run on ``ctx`` (the same init and
    draws) with a mix that records what it is given: the rows the
    exchange mixes (sanitized with DP) and the selections."""
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.device import make_generator

    seen = []

    def record(c_sel, s, adj=None):
        seen.append((c_sel.clone(), s.clone()))
        return c_sel

    state = m.init(ctx, make_generator(ctx.device, gen_seed))
    step = make_round_step(ctx.loss_fn, ctx.pel_fn, m._spec(ctx), m._fcfg(ctx),
                           pack_spec=ctx.pack_spec, mix_fn=record)
    step(state, ctx.train)
    return seen[0]


def _align_threshold(torch, data, exp, opts) -> tuple[float, int, int]:
    """(threshold, links its mask drops in round 1, same-cluster links in
    round 1): a cosine threshold between two of round 1's same-cluster
    neighbour cosines, a quarter of the way up, so the mask drops links in
    the early rounds (read off round 1 of the same run without alignment:
    the local steps do not depend on the threshold)."""
    from repro_torch.core.gossip import _pairwise_cos
    from repro_torch.experiments.registry import build_context, get_method

    ctx = build_context(data, exp, torch.device("cuda"), options=opts)
    c, s = _recorded_round(torch, ctx, get_method("fedspd"))
    cos = _pairwise_cos(c).cpu()
    adj = torch.as_tensor(ctx.graph.adj) > 0
    same = torch.triu(adj & (s.cpu()[:, None] == s.cpu()[None, :]), 1)
    vals = torch.sort(cos[same]).values
    i = len(vals) // 4
    thr = float((vals[i - 1] + vals[i]) / 2)
    return thr, int((vals < thr).sum()), len(vals)


def _stream_run(torch, gm, model: str, dev, rounds: int):
    """``rounds`` rounds of the stream regime's step on the main path's
    population (``make_round_step(FedSPDConfig(regime="stream"))``: there
    is no run_method for it), each on a fresh uniform batch of STREAM_B
    points a client drawn on the device. Returns (round ms, the final
    state, the context, the launches)."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.data.pipeline import gather_batches, uniform_batch_indices
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.device import make_generator
    from repro_torch.experiments.registry import build_context, get_method

    data = make_mixture_classification()
    ctx = build_context(data, PaperExpConfig(model=model), dev)
    m = get_method("fedspd")
    state = m.init(ctx, make_generator(dev, 0))
    cfg = dataclasses.replace(m._fcfg(ctx), regime="stream")
    step = make_round_step(ctx.loss_fn, ctx.pel_fn, m._spec(ctx), cfg, pack_spec=ctx.pack_spec)
    g = make_generator(dev, 1)
    n, pts = data.x.shape[0], data.x.shape[1]
    ms = []
    gm.reset_launch_counts()
    for _ in range(rounds):
        b = gather_batches(ctx.train["inputs"], ctx.train["targets"],
                           uniform_batch_indices(g, n, pts, STREAM_B))
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, state, ctx, {k.__name__: k.launches for k in gm.KERNELS}


def phase_stream_agreement(torch) -> float:
    """One stream round, DP on (kernel 2 on the card), on the card against
    the CPU from one state with the same injected draws (selections, the
    batch, the DP noise). Returns the plane's max abs error."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import make_round_step, seeded_init
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments.registry import build_context, get_method

    data, exp = make_mixture_classification(), PaperExpConfig()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    opts = dict(DP_OPTIONS)
    ctxs = {d: build_context(data, exp, d, options=opts) for d in (cpu, gpu)}
    m, ps = get_method("fedspd"), ctxs[cpu].pack_spec
    cfg = dataclasses.replace(m._fcfg(ctxs[cpu]), regime="stream")
    st = seeded_init(torch.Generator().manual_seed(0), ctxs[cpu].model_init, cfg,
                     ctxs[cpu].loss_fn, ctxs[cpu].train, ps, epochs=2)
    g = torch.Generator().manual_seed(3)
    n, pts = data.x.shape[0], data.x.shape[1]
    idx = torch.randint(0, pts, (n, STREAM_B), generator=g)
    rows = torch.arange(n)[:, None]
    batch = {"x": ctxs[cpu].train["inputs"][rows, idx], "y": ctxs[cpu].train["targets"][rows, idx]}
    draws = dict(s=torch.randint(0, data.n_clusters, (n,), generator=g),
                 noise=torch.randn((n, ps.size), generator=g))
    out = {}
    for d in (cpu, gpu):
        ctx = ctxs[d]
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, m._spec(ctx), cfg, pack_spec=ps)
        st_d = st._replace(centers=st.centers.to(d, copy=True), u=st.u.to(d), z=st.z.to(d),
                           comm_bytes=st.comm_bytes.to(d), gen=torch.Generator(device=d))
        new, _ = step(st_d, {k: v.to(d) for k, v in batch.items()},
                      **{k: v.to(d) for k, v in draws.items()})
        out[d.type] = [t.cpu() for t in (new.centers, new.u, new.comm_bytes)]
    (pc, uc, bc), (pg, ug, bg) = out["cpu"], out["cuda"]
    err, u_err = float((pc - pg).abs().max()), float((uc - ug).abs().max())
    print(f"variant agreement stream dp: plane max abs err {err:.3g}, u max abs err "
          f"{u_err:.3g}, comm_bytes {float(bc)} vs {float(bg)}", flush=True)
    check(bool(torch.isfinite(pg).all()), "stream agreement: non-finite plane on the card")
    check(err <= TOL and u_err <= TOL, f"stream agreement: plane err {err}, u err {u_err} > {TOL}")
    check(float(bc) == float(bg), "stream agreement: comm_bytes differ")
    return err


def phase_permute_agreement(torch) -> float:
    """One full-width round of the permute wiring on "reference" (the
    colour classes' gathers) against the dense wiring on "cuda" (kernel 1),
    on the card from one state with the same injected draws. Returns the
    plane's max abs error."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.core.gossip import GossipSpec, make_mix_fn
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.device import make_generator
    from repro_torch.experiments.registry import build_context, get_method

    data, exp = make_mixture_classification(), PaperExpConfig()
    gpu = torch.device("cuda")
    ctx = build_context(data, exp, gpu)
    m = get_method("fedspd")
    st = m.init(ctx, make_generator(gpu, 0))
    g = make_generator(gpu, 4)
    n, pts = data.x.shape[0], data.x.shape[1]
    draws = dict(s=torch.randint(0, data.n_clusters, (n,), generator=g, device=gpu),
                 idx=torch.randint(0, pts, (exp.tau, n, exp.batch), generator=g, device=gpu))
    planes = []
    for mode, backend in (("permute", "reference"), ("dense", "cuda")):
        spec = GossipSpec.from_graph(ctx.graph, mode=mode)
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                               pack_spec=ctx.pack_spec, mix_fn=make_mix_fn(spec, backend))
        new, _ = step(st._replace(centers=st.centers.clone()), ctx.train, **draws)
        planes.append(new.centers)
    err = float((planes[0] - planes[1]).abs().max())
    print(f"variant agreement permute on reference vs dense on cuda: plane max abs err "
          f"{err:.3g} ({len(GossipSpec.from_graph(ctx.graph).perms)} colour classes)",
          flush=True)
    check(bool(torch.isfinite(planes[0]).all()), "permute agreement: non-finite plane")
    check(err <= TOL, f"permute agreement: plane max abs err {err} > {TOL}")
    return err


def _plain_pair(torch, gm, label, method, data, exp, cfg) -> dict:
    """The same run on the loop engine and on the replay, neither under
    the profiler (``_engine_pair`` less the traces: their processing costs
    more than the runs), each with every launch counter set to 0 just
    before it and read just after. Fails unless the two are equal bit for
    bit and the replay's counters (its warm-up's and capture's launches)
    name the kernels the loop's name."""
    from repro_torch.experiments import run_method

    out = {}
    for engine, flag in (("loop", False), ("scan", None)):
        gm.reset_launch_counts()
        out[engine] = run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=flag))
        out["loop_counts" if engine == "loop" else "counts"] = {
            k.__name__: k.launches for k in gm.KERNELS}
    diff = _same_run(torch, out["loop"], out["scan"])
    check(not diff, f"{label}: the replay differs from the loop in {diff}")
    check({k for k, c in out["counts"].items() if c}
          == {k for k, c in out["loop_counts"].items() if c},
          f"{label}: replay launches {out['counts']}, loop launches {out['loop_counts']}")
    check(out["scan"].extras["n_dispatches"] == exp.rounds,
          f"{label}: {out['scan'].extras['n_dispatches']} dispatches in {exp.rounds} rounds")
    return out


def phase_variants(torch, gm, card: str) -> tuple[dict, dict, float, dict]:
    """The slice's path, the main-path variants on the main path's
    population, VARIANT_ROUNDS rounds a run: the conv classifier (X =
    14,720) DP off (``_engine_pair``: one exchange kernel in every
    replayed round of its trace, busy shares from ``_windowed``) and on
    (``_plain_pair``), loop against replay;
    ``fedspd_permute`` on "cuda" equal bit for bit to ``fedspd`` (the
    kernels' backend builds the dense W whatever the wiring); the permute
    wiring on "reference", one round against the dense wiring; cosine
    alignment DP off and on at a threshold that drops a quarter of round
    1's same-cluster links, loop against replay (``_plain_pair``), kernel
    2 never launched; STREAM_ROUNDS rounds of the stream
    regime (mlp and conv, B = STREAM_B) and one stream round card against
    CPU; then kernels 1, 2 and 4 at the conv plane's shape. Returns (the
    loop and stream runs' launches, the kernel rows, the conv loop's round
    ms, the conv DP-off pair)."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method
    from repro_torch.experiments.registry import get_method

    data = make_mixture_classification()
    mlp, conv = (PaperExpConfig(rounds=VARIANT_ROUNDS, model=k) for k in ("mlp", "conv"))
    keep = {"keep_state": True}
    launches: dict = {}

    def add(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    first, end = profiled(VARIANT_ROUNDS)

    def line(label, pair, extra=""):
        scan = pair["scan"]
        if "replay_busy" in pair:
            lb, rb = pair["loop_busy"], pair["replay_busy"]
            ms = (f"round_ms median(rounds 2-{VARIANT_ROUNDS} less the profiled {first}-"
                  f"{end}) loop {lb['round_ms']:.4f} replay {rb['round_ms']:.4f} "
                  f"device_ms_per_round replay {rb['device_ms']:.4f} busy share replay "
                  f"{rb['busy']:.4f} loop {lb['busy']:.4f}")
        else:
            ms = (f"round_ms median(rounds 2-{VARIANT_ROUNDS}) loop "
                  f"{statistics.median(pair['loop'].extras['round_ms'][1:]):.4f} replay "
                  f"{statistics.median(scan.extras['round_ms'][1:]):.4f}")
        print(f"variant {label} ({card}): {ms} capture_ms "
              f"{json.dumps([round(v, 1) for v in scan.extras['capture_ms']])} mean_acc "
              f"{scan.mean_acc:.6f} comm_bytes {scan.comm_bytes:.0f} loop launches "
              f"{json.dumps({k: c for k, c in pair['loop_counts'].items() if c})}{extra}",
              flush=True)
        check(math.isfinite(scan.mean_acc) and 0.0 <= scan.mean_acc <= 1.0,
              f"variant {label}: mean_acc {scan.mean_acc} not finite in [0, 1]")
        check(scan.comm_bytes > 0.0, f"variant {label}: no bytes accounted")

    # the conv classifier on both engines, DP off (traced) and on
    cfg = RunConfig(eval_every=10**9, options=keep)
    pair = conv_pair = _engine_pair(torch, gm, "variant conv", "fedspd", data, conv, cfg,
                                    busy=True)
    _engine_line("variant conv", pair)
    per = [sum(_is_exchange(k.name) for k in w) for w in pair["windows"]]
    check(per == [1] * VARIANT_ROUNDS, f"variant conv: exchange kernels per replay {per}")
    conv_loop_ms = pair["loop_busy"]["round_ms"]
    dp_pair = _plain_pair(torch, gm, "variant conv dp", "fedspd", data, conv,
                          RunConfig(eval_every=10**9, options=dict(DP_OPTIONS, **keep)))
    for label, pair, kernel in (("conv", pair, gm.gossip_mix_flat),
                                ("conv dp", dp_pair, gm.gossip_mix_fused_dp)):
        line(label, pair)
        add(pair["loop_counts"])
        check(pair["loop_counts"][kernel.__name__] == VARIANT_ROUNDS,
              f"variant {label}: {kernel.__name__} launched "
              f"{pair['loop_counts'][kernel.__name__]} times in {VARIANT_ROUNDS} loop rounds")

    # fedspd_permute on "cuda": the pallas semantics ignore the mode
    cfg = RunConfig(eval_every=10, options=keep)
    perm, dense = (run_method(m_, data, mlp, cfg=cfg) for m_ in ("fedspd_permute", "fedspd"))
    diff = _same_run(torch, perm, dense)
    print(f"variant fedspd_permute on cuda ({card}): replay round_ms median "
          f"{statistics.median(perm.extras['round_ms'][1:]):.4f} mean_acc {perm.mean_acc:.6f} "
          f"comm_bytes {perm.comm_bytes:.0f} vs fedspd: "
          f"{'equal' if not diff else 'differs in ' + str(diff)}", flush=True)
    check(not diff, f"variant fedspd_permute on cuda differs from fedspd in {diff}")

    # the permute wiring on "reference": one round against the dense wiring
    phase_permute_agreement(torch)

    # cosine alignment, DP off and on: kernel 1 every round, never kernel 2
    for label, opts in (("aligned", {}), ("aligned dp", DP_OPTIONS)):
        thr, dropped, links = _align_threshold(torch, data, mlp, opts)
        cfg = RunConfig(eval_every=10**9, options=dict(opts, cos_align_threshold=thr, **keep))
        pair = _plain_pair(torch, gm, f"variant {label}", "fedspd", data, mlp, cfg)
        line(label, pair, f" threshold {thr:.6f} drops {dropped} of {links} same-cluster "
                          "links in round 1")
        add(pair["loop_counts"])
        check(dropped > 0, f"variant {label}: the threshold drops no link in round 1")
        check(pair["loop_counts"]["gossip_mix_fused_dp"] == 0
              and pair["counts"]["gossip_mix_fused_dp"] == 0,
              f"variant {label}: kernel 2 launched (loop {pair['loop_counts']}, replay "
              f"{pair['counts']})")
        check(pair["loop_counts"]["gossip_mix_flat"] == VARIANT_ROUNDS,
              f"variant {label}: kernel 1 launched {pair['loop_counts']['gossip_mix_flat']} "
              f"times in {VARIANT_ROUNDS} rounds")

    # the stream regime, mlp and conv, and one round card against CPU
    for model in ("mlp", "conv"):
        ms, state, ctx, counts = _stream_run(torch, gm, model, torch.device("cuda"),
                                             STREAM_ROUNDS)
        add(counts)
        acc = float(get_method("fedspd").evaluate(ctx, state, ctx.test).mean())
        print(f"variant stream {model} ({card}): {STREAM_ROUNDS} rounds, B={STREAM_B}, loop "
              f"round_ms median(rounds 2-{STREAM_ROUNDS}) {statistics.median(ms[1:]):.4f} "
              f"first {ms[0]:.4f} mean_acc {acc:.6f} comm_bytes {float(state.comm_bytes):.0f} "
              f"launches {json.dumps({k: c for k, c in counts.items() if c})}", flush=True)
        check(math.isfinite(acc) and 0.0 <= acc <= 1.0, f"stream {model}: mean_acc {acc}")
        check(counts["gossip_mix_flat"] == STREAM_ROUNDS,
              f"stream {model}: kernel 1 launched {counts['gossip_mix_flat']} times")
        u = state.u
        check(bool(torch.isfinite(state.centers).all())
              and bool(torch.allclose(u.sum(dim=1), torch.ones_like(u[:, 0]), atol=1e-5)),
              f"stream {model}: non-finite plane or u rows not summing to 1")
    phase_stream_agreement(torch)

    # kernels 1, 2 and 4 at the conv plane's shape
    rows = phase_kernels(torch, gm, [(20, CONV_X)])
    rows.update(phase_dequant_kernels(torch, gm, [(20, 20, CONV_X, QBLOCK)]))
    for rs in rows.values():
        for r in rs:
            r["variant"] = "conv plane"
    return launches, rows, conv_loop_ms, conv_pair


def _pytree_kernel_rows(torch, gm) -> tuple[list, dict]:
    """Kernel 1 at each mlp leaf width at N = 20 against its plain version,
    timed by graph replay beside its bound and ``torch.matmul``; then a
    pytree round's exchange (``gossip_mix_tree`` over the mlp's 6
    contiguous leaves: six launches) against the plane's one launch over
    the same (20, 17,226) values."""
    from repro_torch.core.packing import unpack
    from repro_torch.experiments.registry import build_context
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.utils.pytree import tree_leaves, tree_map

    dev = torch.device("cuda")
    rows = []
    for x in PYTREE_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(x)
        w = torch.rand((20, 20), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c = torch.randn((20, x), generator=g, device=dev)
        out = gm.gossip_mix_flat(w, c)
        err = float((out - gm.gossip_mix_flat_ref(w, c)).abs().max())
        check(err <= TOL, f"pytree leaf gossip_mix_flat N=20 X={x}: max abs err {err}")
        b_ms, b_by = bound(20, x, "gossip_mix_flat")
        rows.append(dict(n=20, x=x, variant="pytree leaf", max_abs_err=err,
                         ms=graph_ms(lambda: gm.gossip_mix_flat(w, c)),
                         plain_ms=graph_ms(lambda: gm.gossip_mix_flat_ref(w, c)),
                         library_ms=graph_ms(lambda: torch.matmul(w, c)),
                         bound_ms=b_ms, bound_by=b_by))
    spec = build_context(make_mixture_classification(), PaperExpConfig(), dev).pack_spec
    g = torch.Generator(device=dev).manual_seed(1)
    w = torch.rand((20, 20), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    plane = torch.randn((20, spec.size), generator=g, device=dev)
    tree = tree_map(lambda leaf: leaf.contiguous(), unpack(plane, spec))
    check(len(tree_leaves(tree)) == PYTREE_LEAVES, "the mlp's tree has not 6 leaves")
    gm.reset_launch_counts()
    mixed = gm.gossip_mix_tree(w, tree)
    check(gm.gossip_mix_flat.launches == PYTREE_LEAVES,
          f"gossip_mix_tree launched kernel 1 {gm.gossip_mix_flat.launches} times")
    whole = gm.gossip_mix_flat(w, plane)
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(mixed), tree_leaves(unpack(whole, spec))))
    check(err == 0.0, f"the pytree exchange differs from the plane's by {err}")
    b_ms, b_by = bound(20, spec.size, "gossip_mix_flat")
    round_row = dict(n=20, x=spec.size, leaves=PYTREE_LEAVES,
                     widths=[leaf[0].numel() for leaf in tree_leaves(tree)],
                     max_abs_err_vs_plane=err,
                     ms=graph_ms(lambda: gm.gossip_mix_tree(w, tree)),
                     plane_ms=graph_ms(lambda: gm.gossip_mix_flat(w, plane)),
                     bound_ms=b_ms, bound_by=b_by)
    for r in rows:
        print("kernel gossip_mix_flat " + json.dumps(r), flush=True)
    print("pytree round exchange (6 launches vs the plane's 1) " + json.dumps(round_row),
          flush=True)
    return rows, round_row


def phase_pytree(torch, gm, card: str, planes: dict,
                 conv_pair: dict) -> tuple[dict, list, dict, float]:
    """The per-leaf pytree engine's path (``param_plane=False``)
    on the main path's population: FedSPD for PYTREE_ROUNDS rounds, mlp DP
    off and on and conv DP off, loop against replay (bit for bit; the
    replay's busy share from ``_windowed``), each against the plane's
    runs of the same configuration: the engines phase's replayed seeds 0-2
    (``planes["batch"]``) for the mlp, the variants phase's conv pair for
    the conv, the plane's seed 0 replayed here for the mlp DP; one id per
    baseline class for ROUNDS rounds on the loop against the engines
    phase's plane loop run of that id; kernel 1 at the mlp's leaf widths.
    Returns (the pytree loop runs' launches, the kernel rows, the pytree
    round's exchange row, the mlp pytree loop's round ms)."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method
    from repro_torch.experiments.registry import build_context

    data = make_mixture_classification()
    keep = {"keep_state": True}
    launches: dict = {}
    loop_ms = 0.0
    for label, model, opts in (("mlp", "mlp", {}), ("mlp dp", "mlp", DP_OPTIONS),
                               ("conv", "conv", {})):
        exp = PaperExpConfig(rounds=PYTREE_ROUNDS, model=model)
        cfg = RunConfig(eval_every=10**9, param_plane=False, options=dict(opts, **keep))
        # the loop (its counters), then the replay with rounds
        # profiled(PYTREE_ROUNDS) traced (``_windowed``: its busy share)
        gm.reset_launch_counts()
        loop = run_method("fedspd", data, exp, cfg=dataclasses.replace(cfg, scan_rounds=False))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        gm.reset_launch_counts()
        scan, windows, busy = _windowed(lambda c: run_method("fedspd", data, exp, cfg=c),
                                        dataclasses.replace(cfg, scan_rounds=None),
                                        PYTREE_ROUNDS)
        replay_counts = {k.__name__: k.launches for k in gm.KERNELS}
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        diff = _same_run(torch, loop, scan)
        check(not diff, f"pytree {label}: the replay differs from the loop in {diff}")
        check(scan.extras["n_captures"] == 1 and scan.extras["n_dispatches"] == PYTREE_ROUNDS,
              f"pytree {label}: {scan.extras['n_captures']} captures, "
              f"{scan.extras['n_dispatches']} dispatches")
        check(isinstance(scan.extras["state"].centers, dict),
              f"pytree {label}: the run's centers are not a tree")
        check(counts == {k: (PYTREE_LEAVES * PYTREE_ROUNDS if k == "gossip_mix_flat" else 0)
                         for k in counts},
              f"pytree {label}: loop launches {counts}, expected kernel 1 "
              f"{PYTREE_LEAVES} times a round and nothing else")
        check(replay_counts["gossip_mix_fused_dp"] == 0,
              f"pytree {label}: the replay launched kernel 2")
        per = [sum(_is_exchange(k.name) for k in w) for w in windows]
        first, end = profiled(PYTREE_ROUNDS)
        check(per == [PYTREE_LEAVES] * (end - first),
              f"pytree {label}: exchange kernels per traced replay {per}")
        # the plane's runs of this configuration (seed 0 first): the
        # engines phase's seeds 0-2, the variants phase's conv, the mlp DP
        # seed 0 replayed here; max(0.02, pstdev) is 0.02 for one seed
        if label == "mlp":
            ref = planes["batch"]
        elif label == "conv":
            ref = [conv_pair["scan"]]
        else:
            ref = [run_method("fedspd", data, exp, cfg=RunConfig(eval_every=10**9,
                                                                 options=opts))]
        accs = [p.mean_acc for p in ref]
        tol = max(0.02, statistics.pstdev(accs))
        same_draws = not opts
        lm = statistics.median(loop.extras["round_ms"][1:])
        plane_ms = ""
        if label == "mlp":
            # the plane's DP-off pair of the engines phase, traced the same way
            pp = planes["fedspd"]
            lb, rb = pp["loop_busy"], pp["replay_busy"]
            pf, pe = profiled(ENGINE_ROUNDS)
            plane_ms = (f" plane (engines phase, {ENGINE_ROUNDS} rounds, {pf + 1}-{pe} "
                        f"profiled): loop {lb['round_ms']:.4f} replay {rb['round_ms']:.4f} "
                        f"kernels_per_round {len(pp['windows'][-1])} device_ms_per_round "
                        f"{rb['device_ms']:.4f} device_busy_share {rb['busy']:.4f};")
        print(f"pytree {label} ({card}): round_ms median(rounds 2-{PYTREE_ROUNDS}) loop "
              f"{lm:.4f} replay (less the profiled {first}-{end}) {busy['round_ms']:.4f} "
              f"replay (rounds {first + 1}-{end} profiled): kernels_per_round "
              f"{len(windows[-1])} device_ms_per_round {busy['device_ms']:.4f} "
              f"device_busy_share {busy['busy']:.4f};{plane_ms} capture_ms "
              f"{json.dumps([round(v, 1) for v in scan.extras['capture_ms']])} mean_acc "
              f"{scan.mean_acc:.6f} plane seeds {json.dumps([round(a, 6) for a in accs])} "
              f"tolerance {tol:.6f} comm_bytes {scan.comm_bytes:.0f} plane seed 0 "
              f"{ref[0].comm_bytes:.0f} loop launches "
              f"{json.dumps({k: c for k, c in counts.items() if c})} exchange kernels a "
              f"replay {per[-1]} replay vs loop: equal", flush=True)
        if label == "mlp":
            loop_ms = lm
        check(math.isfinite(scan.mean_acc) and scan.mean_acc > 0.1,
              f"pytree {label}: mean_acc {scan.mean_acc} not above chance 0.1")
        check(abs(scan.mean_acc - accs[0]) <= tol,
              f"pytree {label}: mean_acc {scan.mean_acc} vs the plane's {accs[0]} (tol {tol})")
        if same_draws:
            check(scan.comm_bytes == ref[0].comm_bytes,
                  f"pytree {label}: comm_bytes {scan.comm_bytes} != the plane's "
                  f"{ref[0].comm_bytes}")
        else:
            # the engines draw DP noise differently (per leaf, one plane):
            # the selections part, and the bytes are whole models
            model_b = build_context(data, exp, torch.device("cuda")).pack_spec.model_bytes
            check(scan.comm_bytes > 0 and scan.comm_bytes % model_b == 0,
                  f"pytree {label}: comm_bytes {scan.comm_bytes} not whole models")

    short = PaperExpConfig(rounds=ROUNDS)
    for method, kernel in PYTREE_BASELINES.items():
        gm.reset_launch_counts()
        r = run_method(method, data, short, cfg=RunConfig(
            eval_every=10**9, param_plane=False, scan_rounds=False))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        p = planes[method]
        print(f"pytree baseline {method} ({card}): mean_acc {r.mean_acc:.6f} plane "
              f"{p.mean_acc:.6f} comm_bytes {r.comm_bytes:.0f} plane {p.comm_bytes:.0f} "
              f"launches a round {json.dumps({k: c / ROUNDS for k, c in counts.items() if c})} "
              f"round_ms median(rounds 2-{ROUNDS}) loop "
              f"{statistics.median(r.extras['round_ms'][1:]):.4f} plane loop "
              f"{statistics.median(p.extras['round_ms'][1:]):.4f}", flush=True)
        check(counts == {k: (PYTREE_LEAVES * ROUNDS if k == kernel else 0) for k in counts},
              f"pytree baseline {method}: launches {counts}")
        check(r.comm_bytes == p.comm_bytes and abs(r.mean_acc - p.mean_acc) <= 0.02,
              f"pytree baseline {method}: {r.mean_acc} / {r.comm_bytes} bytes against the "
              f"plane's {p.mean_acc} / {p.comm_bytes}")
    rows, round_row = _pytree_kernel_rows(torch, gm)
    return launches, rows, round_row, loop_ms


def _telemetry_pair(torch, gm, label, method, data, exp, cfg, traced: bool) -> dict:
    """The same run with telemetry off and on, each on the loop engine and
    on the replay, every launch counter set to 0 just before each loop run
    and read just after. Fails unless telemetry changed nothing of the
    training (per-client accuracy, curve, bytes, u, every tensor of the
    final state, ``n_captures``, ``n_compiles``, ``n_dispatches`` and the
    loop's launches), the replay equals the loop bit for bit, and every
    stream of the replay equals the loop's bit for bit. With ``traced`` both
    replays run under ``_windowed``: kernels, device ms and busy share a
    round from rounds ``profiled(rounds)``. Returns {"off": …, "on": …}."""
    import numpy as np

    from repro_torch.experiments import run_method
    from repro_torch.telemetry import TelemetryConfig

    def run(c):
        return run_method(method, data, exp, cfg=c)

    out = {}
    for key, tel in (("off", None), ("on", TelemetryConfig())):
        c = dataclasses.replace(cfg, telemetry=tel)
        gm.reset_launch_counts()
        loop = run(dataclasses.replace(c, scan_rounds=False))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        scan_cfg = dataclasses.replace(c, scan_rounds=None)
        if traced:
            scan, windows, busy = _windowed(run, scan_cfg, exp.rounds)
        else:
            scan, windows, busy = run(scan_cfg), None, None
        diff = _same_run(torch, loop, scan)
        check(not diff, f"telemetry {label} ({key}): the replay differs from the loop in {diff}")
        out[key] = dict(loop=loop, scan=scan, counts=counts, windows=windows, busy=busy)
    off, on = out["off"], out["on"]
    for engine in ("loop", "scan"):
        a, b = off[engine], on[engine]
        diff = _same_run(torch, a, b)
        if "staleness" not in a.extras:
            # with telemetry, a run without a system model reports its
            # all-zero staleness counters
            check(not np.any(b.extras["staleness"]),
                  f"telemetry {label}: staleness {b.extras['staleness']} without a system model")
            diff = [d for d in diff if d != "staleness"]
        diff += [k for k in ("n_captures", "n_compiles", "n_dispatches")
                 if a.extras[k] != b.extras[k]]
        check(not diff, f"telemetry {label}: the {engine} with telemetry differs from the run "
                        f"without it in {diff}")
        check(a.telemetry is None and b.telemetry is not None,
              f"telemetry {label}: streams off {a.telemetry is not None}, on "
              f"{b.telemetry is not None}")
    check(off["counts"] == on["counts"],
          f"telemetry {label}: loop launches {on['counts']} with telemetry, "
          f"{off['counts']} without")
    ls, rs = on["loop"].telemetry["streams"], on["scan"].telemetry["streams"]
    differ = [k for k in ls if not np.array_equal(ls[k], rs[k], equal_nan=True)]
    check(not differ, f"telemetry {label}: the replay's streams {differ} differ from the loop's")
    if traced:
        per = {key: [sum(_is_exchange(k.name) for k in w) for w in out[key]["windows"]]
               for key in out}
        check(per["off"] == per["on"],
              f"telemetry {label}: exchange kernels a traced replay {per['on']} with "
              f"telemetry, {per['off']} without")
    return out


def _telemetry_breakdown(torch, card: str) -> None:
    """The collector alone at the main path's shape (N = 20, S = 2, the
    mlp's X = 17,226): each stream's ops and the runner's whole round of
    telemetry (the snapshot of the old u and bytes, the collector and the
    11 tape writes at a device round counter), each captured in a CUDA
    graph and timed by replay (``graph_ms``), its kernels counted in one
    torch.profiler trace from the second of two eager calls each (the
    trace can miss the first launches after the profiler starts)."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.device import make_generator
    from repro_torch.experiments.registry import build_context, get_method
    from repro_torch.experiments.runner import _Telemetry
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.telemetry import metrics as tm

    dev = torch.device("cuda")
    ctx = build_context(make_mixture_classification(), PaperExpConfig(), dev)
    m, cfg = get_method("fedspd"), TelemetryConfig()
    state = m.init(ctx, make_generator(dev, 0))
    tel = _Telemetry(m, ctx, state, cfg, TELEMETRY_ROUNDS)
    new = state._replace(u=torch.softmax(torch.randn_like(state.u), -1),
                         comm_bytes=state.comm_bytes + 68904.0)
    ctr = torch.zeros(1, dtype=torch.int64, device=dev)
    n = ctx.n_clients
    stale = torch.randint(0, 7, (n,), dtype=torch.int32, device=dev)
    fns = {
        "u_entropy": lambda: tm.mixture_entropy(new.u),
        "u_drift": lambda: tm.mixture_drift(state.u, new.u),
        "consensus": lambda: tm.consensus_residual(tm.flatten_centers(new.centers)),
        "degree": lambda: tm.effective_degree(tel.adj),
        "spectral_gap": lambda: tm.spectral_gap_proxy(tel.adj, cfg.power_iters),
        "stale_hist": lambda: tm.staleness_histogram(stale, cfg.staleness_bins),
        "collector": lambda: tel.collect(state, new, tel.adj),
        "round (snapshot, collector, tape writes)":
            lambda: tel.after(ctr, tel.before(state), new, None, None, None),
    }
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with _profiler() as prof:
        for _ in range(2):
            for name, fn in fns.items():
                with torch.profiler.record_function(f"telemetry.{name}"):
                    fn()
            torch.cuda.synchronize()
    row = {}
    for name, fn in fns.items():
        kernels = _round_kernels(prof, f"telemetry.{name}")
        check(len(kernels) == 2 and kernels[-1],
              f"telemetry collector: {name} ran no kernel in its second span "
              f"({[len(k) for k in kernels]} kernels in its spans)")
        row[name] = {"kernels": len(kernels[-1]),
                     "us": round(graph_ms(fn, reps=20) * 1e3, 2)}
    print(f"telemetry collector ({card}) at N={n}, S={ctx.n_clusters}, "
          f"X={ctx.pack_spec.size} (graph replay, kernels by torch.profiler): "
          f"{json.dumps(row)}", flush=True)


def phase_telemetry(torch, gm, card: str) -> dict:
    """The telemetry path: FedSPD with ``RunConfig(telemetry=...)`` on the
    main path's population for TELEMETRY_ROUNDS rounds, with telemetry off
    and on, each on the loop and on the replay (``_telemetry_pair``): the
    mlp DP off and on and the pytree engine (``param_plane=False``), their
    replays traced over rounds ``profiled(TELEMETRY_ROUNDS)``; the fully
    composed run (scenario B's dropout and ClientSystemModel, a cohort of
    10, int8 + error feedback) and sparse d0.2 + int8 + error feedback
    untraced. Then the collector alone (``_telemetry_breakdown``) and the
    JSONL event log of the mlp's replay written, read back exactly and
    rendered by ``summary_table``. Returns the loop runs' launches with
    telemetry on."""
    import numpy as np

    from repro_torch.comm.codecs import CommConfig
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.sparse import SparseConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig
    from repro_torch.telemetry import (STREAMS, read_events, streams_from_events,
                                       summary_table, write_run_jsonl)

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=TELEMETRY_ROUNDS)
    n, s_clusters = data.n_clients, data.n_clusters
    keep = {"keep_state": True}
    int8 = CommConfig(codec="int8", error_feedback=True)
    first, end = profiled(TELEMETRY_ROUNDS)
    launches: dict = {}
    jsonl_run = None
    for label, cfg, traced, kernel, sparse in (
            ("mlp", RunConfig(eval_every=10**9, options=keep), True,
             gm.gossip_mix_flat, False),
            ("mlp dp", RunConfig(eval_every=10**9, options=dict(DP_OPTIONS, **keep)), True,
             gm.gossip_mix_fused_dp, False),
            ("pytree mlp", RunConfig(eval_every=10**9, param_plane=False, options=keep),
             True, gm.gossip_mix_flat, False),
            ("composed B cohort 10/20 int8+ef", RunConfig(
                eval_every=10**9, cohort_size=10, comm=int8, options=keep,
                scenario=_scenario(TELEMETRY_ROUNDS, "B")), False, gm.gossip_mix_dequant, False),
            ("sparse d0.2 int8+ef", RunConfig(eval_every=10**9, comm=int8, options=keep,
                                              sparse=SparseConfig(**SPARSE)),
             False, gm.gossip_mix_dequant_masked, True)):
        pair = _telemetry_pair(torch, gm, label, "fedspd", data, exp, cfg, traced)
        off, on = pair["off"], pair["on"]
        for name, c in on["counts"].items():
            launches[name] = launches.get(name, 0) + c
        check(on["counts"][kernel.__name__] > 0,
              f"telemetry {label}: {kernel.__name__} was not launched by the loop")
        scan = on["scan"]
        st = scan.telemetry["streams"]
        check(scan.telemetry["rounds"] == TELEMETRY_ROUNDS
              and sorted(st) == sorted(STREAMS),
              f"telemetry {label}: streams {sorted(st)} over {scan.telemetry['rounds']} rounds")
        shapes = {k: v.shape for k, v in st.items()}
        check(all(shapes[k] == ((TELEMETRY_ROUNDS, s_clusters) if k == "consensus" else
                                (TELEMETRY_ROUNDS, 5) if k == "stale_hist" else
                                (TELEMETRY_ROUNDS,)) for k in STREAMS),
              f"telemetry {label}: stream shapes {shapes}")
        live = [k for k in STREAMS if k not in ("density", "mask_churn")] + (
            ["density", "mask_churn"] if sparse else [])
        check(all(np.isfinite(st[k]).all() for k in live),
              f"telemetry {label}: a stream of {live} is not finite")
        check(sparse or (np.isnan(st["density"]).all() and np.isnan(st["mask_churn"]).all()),
              f"telemetry {label}: mask streams without masks")
        check(bool((st["stale_hist"].sum(-1) == n).all()),
              f"telemetry {label}: a stale_hist row does not sum to N = {n}")
        logical = float(np.sum(st["logical_bytes"], dtype=np.float64))
        check(abs(logical - scan.comm_bytes) <= 1e-6 * scan.comm_bytes,
              f"telemetry {label}: the logical_bytes stream sums to {logical}, comm_bytes "
              f"{scan.comm_bytes}")
        moved = st["logical_bytes"] > 0
        if "int8" in label:
            check(bool(moved.any()) and bool((st["wire_bytes"][moved]
                                              < st["logical_bytes"][moved]).all()),
                  f"telemetry {label}: wire_bytes not below logical_bytes under int8")
        if label.startswith("composed"):
            check(float(st["n_inactive"].max()) > 0,
                  f"telemetry {label}: no client inactive in any round")
            check(np.array_equal(scan.extras["staleness"], on["loop"].extras["staleness"]),
                  f"telemetry {label}: staleness differs between the engines")
        if sparse:
            upd = [r for r in range(TELEMETRY_ROUNDS) if st["mask_churn"][r] > 0]
            check(upd and all(SparseConfig(**SPARSE).update_due(r) for r in upd),
                  f"telemetry {label}: mask churn in rounds {upd}")
        if traced:
            ms = {key: pair[key]["busy"]["round_ms"] for key in pair}
            k_off, k_on = (len(pair[key]["windows"][-1]) for key in ("off", "on"))
            d_off, d_on = (pair[key]["busy"]["device_ms"] for key in ("off", "on"))
            trace = (f"rounds {first + 1}-{end} traced: kernels_per_round off {k_off} on "
                     f"{k_on} (+{k_on - k_off}) device_ms_per_round off {d_off:.4f} on "
                     f"{d_on:.4f} (+{d_on - d_off:.4f}) device_busy_share off "
                     f"{pair['off']['busy']['busy']:.4f} on {pair['on']['busy']['busy']:.4f}; ")
            ms_what = f"median(rounds 2-{TELEMETRY_ROUNDS} less the profiled {first}-{end})"
        else:
            ms = {key: statistics.median(pair[key]["scan"].extras["round_ms"][1:])
                  for key in pair}
            trace, ms_what = "not traced; ", f"median(rounds 2-{TELEMETRY_ROUNDS})"
        lm = {key: statistics.median(pair[key]["loop"].extras["round_ms"][1:]) for key in pair}
        last = {k: (round(float(v[-1]), 6) if v.ndim == 1 else [round(float(x), 6) for x in v[-1]])
                for k, v in st.items()}
        print(f"telemetry {label} ({card}): replay round_ms {ms_what} off {ms['off']:.4f} on "
              f"{ms['on']:.4f} (+{ms['on'] - ms['off']:.4f}); {trace}loop round_ms off "
              f"{lm['off']:.4f} on {lm['on']:.4f}; n_captures {scan.extras['n_captures']} "
              f"n_compiles {scan.extras['n_compiles']} (loop "
              f"{on['loop'].extras['n_compiles']}) n_dispatches {scan.extras['n_dispatches']} "
              f"(loop {on['loop'].extras['n_dispatches']}) as without telemetry; mean_acc "
              f"{scan.mean_acc:.6f} comm_bytes {scan.comm_bytes:.0f} as without; loop launches "
              f"{json.dumps({k: c for k, c in on['counts'].items() if c})} as without; streams "
              f"replay vs loop: equal; last round {json.dumps(last)}", flush=True)
        if label == "mlp":
            jsonl_run = scan

    _telemetry_breakdown(torch, card)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "telemetry.jsonl")
        write_run_jsonl(path, jsonl_run, meta={"seed": 0, "n_clients": n})
        events = read_events(path)
        nbytes = os.path.getsize(path)
    parsed = streams_from_events(events)
    differ = [k for k, v in jsonl_run.telemetry["streams"].items()
              if not np.array_equal(parsed[k], np.asarray(v, np.float64), equal_nan=True)]
    check(not differ, f"telemetry jsonl: streams {differ} do not read back exactly")
    summ = events[-1]
    check(summ["event"] == "summary" and summ["n_compiles"] == 1
          and summ["n_dispatches"] == TELEMETRY_ROUNDS and summ["mean_acc"] == jsonl_run.mean_acc,
          f"telemetry jsonl: summary {summ}")
    table = summary_table(events)
    check(all(f"| {k} |" in table for k in STREAMS),
          "telemetry jsonl: the summary table lacks a stream's row")
    print(f"telemetry jsonl: {len(events)} events, {nbytes} bytes, read back exactly; "
          "summary_table:", flush=True)
    for line in table.strip().splitlines():
        print(f"telemetry table {line}", flush=True)
    return launches


def phase_agreement(torch) -> None:
    """One full-width round on the card (kernels) against the CPU (plain
    versions), from the same state with the same injected draws."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.core.fedspd import FedSPDConfig, make_round_step, seeded_init
    from repro_torch.core.gossip import GossipSpec, make_mix_fn
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments.registry import build_context

    data, exp = make_mixture_classification(), PaperExpConfig()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    ctxs = {d: build_context(data, exp, d) for d in (cpu, gpu)}
    n, m, ps = ctxs[cpu].n_clients, data.x.shape[1], ctxs[cpu].pack_spec
    g = torch.Generator().manual_seed(1)
    for clip, mult in ((0.0, 0.0), (1.0, 0.5)):
        cfg = FedSPDConfig(n_clients=n, n_clusters=data.n_clusters, tau=exp.tau,
                           batch=exp.batch, dp_clip=clip, dp_noise_multiplier=mult)
        st = seeded_init(torch.Generator().manual_seed(0), ctxs[cpu].model_init, cfg,
                         ctxs[cpu].loss_fn, ctxs[cpu].train, ps, epochs=2)
        s = torch.randint(0, data.n_clusters, (n,), generator=g)
        idx = torch.randint(0, m, (cfg.tau, n, cfg.batch), generator=g)
        noise = torch.randn((n, ps.size), generator=g)
        out = {}
        for d in (cpu, gpu):
            ctx = ctxs[d]
            spec = GossipSpec.from_graph(ctx.graph)
            step = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, cfg, pack_spec=ps,
                                   mix_fn=make_mix_fn(spec, "cuda"))
            st_d = st._replace(centers=st.centers.to(d, copy=True), u=st.u.to(d), z=st.z.to(d),
                               comm_bytes=st.comm_bytes.to(d),
                               gen=torch.Generator(device=d))
            new, _ = step(st_d, ctx.train, s=s.to(d), idx=idx.to(d), noise=noise.to(d))
            out[d.type] = [t.cpu() for t in (new.centers, new.u, new.z, new.comm_bytes)]
        (pc, uc, zc, bc), (pg, ug, zg, bg) = out["cpu"], out["cuda"]
        err = float((pc - pg).abs().max())
        agree = float((zc == zg).float().mean())
        print(f"agreement dp_clip={clip}: plane max abs err {err:.3g}, z agreement "
              f"{agree:.6f}, u max abs err {float((uc - ug).abs().max()):.3g}, "
              f"comm_bytes {float(bc)} vs {float(bg)}", flush=True)
        check(bool(torch.isfinite(pg).all()), "non-finite plane on the card")
        check(err <= 1e-4, f"card vs CPU round: plane max abs err {err} > 1e-4")
        check(agree >= 0.99, f"card vs CPU round: z agreement {agree} < 0.99")
        check(float(bc) == float(bg), "card vs CPU round: comm_bytes differ")

    # one dfl_fedem round, kernel 3 on the card, from one state and draws
    from repro_torch.experiments.registry import get_method

    fem = get_method("dfl_fedem")
    st = fem.init(ctxs[cpu], torch.Generator().manual_seed(2))
    idx = torch.randint(0, m, (data.n_clusters, exp.tau, n, exp.batch), generator=g)
    out = {}
    for d in (cpu, gpu):
        st_d = _state_to(torch, st, d)
        new, _ = fem.make_step(ctxs[d])(st_d, ctxs[d].train, None, exp.lr0, idx=idx.to(d))
        out[d.type] = [new.centers.cpu(), new.u.cpu()]
    (pc, uc), (pg, ug) = out["cpu"], out["cuda"]
    err, u_err = float((pc - pg).abs().max()), float((uc - ug).abs().max())
    print(f"agreement dfl_fedem: plane max abs err {err:.3g}, u max abs err {u_err:.3g}, "
          f"u[:4] {json.dumps(ug[:4].tolist())}", flush=True)
    check(bool(torch.isfinite(pg).all()), "dfl_fedem: non-finite plane on the card")
    check(err <= 1e-4 and u_err <= 1e-4,
          f"card vs CPU dfl_fedem round: plane err {err}, u err {u_err} > 1e-4")


def phase_profile(torch, round_ms: float, label: str = "main", model: str = "mlp",
                  **run) -> None:
    """Where a round's device time goes: 3 rounds of the main path (DP off,
    after 2 rounds of warm-up; ``run``: RunConfig fields of another path,
    such as the DP options; ``model``: the classifier) under
    torch.profiler: the 10 kernels that take
    the most device time and every gossip kernel. The busy share is the
    profiled device time per round over the unprofiled round time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.device import make_generator
    from repro_torch.experiments import RunConfig
    from repro_torch.experiments.registry import build_context, get_method

    dev, rounds = torch.device("cuda"), 3
    ctx = build_context(make_mixture_classification(), PaperExpConfig(model=model), dev,
                        options=RunConfig(gossip_backend="cuda", **run).resolve_options())
    m = get_method("fedspd")
    state = m.init(ctx, make_generator(dev, 0))
    step = m.make_step(ctx)
    # FedSPD's step draws from its own state.gen and runs its own lr
    # schedule: the driver's gen and lr are not used
    for _ in range(2):
        state, _ = step(state, ctx.train, None, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            state, _ = step(state, ctx.train, None, None)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kern = sorted((e for e in ka if e.device_type.name == "CUDA"),
                  key=lambda e: -e.self_device_time_total)
    check(bool(kern), "profile: the profiler recorded no device kernel")
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / rounds
    launches = sum(e.count for e in kern) / rounds
    gossip_ms = sum(e.self_device_time_total for e in kern
                    if "mix_kernel" in e.key or "mix_dequant_kernel" in e.key) / 1e3 / rounds
    prefix = "profile" if label == "main" else f"profile {label}"
    print(f"{prefix}: device_ms_per_round {dev_ms:.4f} kernels_per_round {launches:.0f} "
          f"gossip_ms_per_round {gossip_ms:.4f} unprofiled round_ms {round_ms:.3f} "
          f"device_busy_share {dev_ms / round_ms:.4f}", flush=True)
    gossip = [e for e in kern[10:] if "mix_kernel" in e.key or "mix_dequant_kernel" in e.key]
    for e in kern[:10] + gossip:
        print(f"{prefix} kernel {e.self_device_time_total / 1e3 / rounds:.4f} ms/round "
              f"x{e.count // rounds}/round {e.key[:90]}", flush=True)
    if label == "dp":
        check(any("FusedDP" in e.key for e in kern),
              "profile dp: the profiler saw no gossip_mix_fused_dp kernel")
        # the DP sanitization's own ops: the clip norm and the noise draw
        for e in ka:
            if e.device_type.name == "CPU" and e.key in DP_OPS:
                print(f"{prefix} sanitize op {e.device_time_total / 1e3 / rounds:.4f} device "
                      f"ms/round x{e.count // rounds}/round {e.key}", flush=True)
    ops = sorted((e for e in ka if e.device_type.name == "CPU" and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    for e in ops[:8]:
        print(f"{prefix} op {e.device_time_total / 1e3 / rounds:.4f} device ms/round "
              f"x{e.count // rounds}/round {e.key}", flush=True)


def phase_main_path(torch, gm):
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=ROUNDS)
    launches, medians, kept = {}, [], None
    for label, opts, kernel in (
            ("plain", {"keep_state": True}, gm.gossip_mix_flat),
            ("dp", DP_OPTIONS, gm.gossip_mix_fused_dp)):
        gm.reset_launch_counts()
        r = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="cuda",
                                                          scan_rounds=False, options=opts))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        launches[kernel.__name__] = kernel.launches
        ms = r.extras["round_ms"]
        # round 1 carries first-use costs: the metric is the median of the rest
        medians.append(statistics.median(ms[1:]))
        print(f"main path ({label}): mean_acc {r.mean_acc:.6f} std_acc {r.std_acc:.6f} "
              f"comm_bytes {r.comm_bytes:.0f} launches {json.dumps(counts)} "
              f"round_ms median(rounds 2-{ROUNDS}) {medians[-1]:.3f} first {ms[0]:.3f} "
              f"all {json.dumps([round(v, 3) for v in ms])} wall_s {r.wall_s:.2f}",
              flush=True)
        check(kernel.launches == ROUNDS,
              f"main path ({label}): {kernel.__name__} launched {kernel.launches} "
              f"times, expected {ROUNDS}")
        check(math.isfinite(r.mean_acc) and r.mean_acc > 0.1,
              f"main path ({label}): mean_acc {r.mean_acc} not above chance 0.1")
        check(r.comm_bytes > 0, f"main path ({label}): no bytes accounted")
        u = torch.as_tensor(r.extras["u"])
        check(bool(torch.allclose(u.sum(dim=1), torch.ones(u.shape[0]), atol=1e-5)),
              f"main path ({label}): u rows do not sum to 1")
        if kept is None:
            kept = r   # the DP-off run, with its final state
    return launches, medians, kept


def phase_serve(torch, gm, result) -> dict:
    """Serve the DP-off run's trained plane as fp32, int8 and int4."""
    import numpy as np

    from repro_torch.core.packing import unpack
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import export_run
    from repro_torch.models.smallnets import make_classifier
    from repro_torch.serve import ClusterPlaneServer, load_servable

    data = make_mixture_classification()   # phase 4's population
    spec = result.extras["pack_spec"]
    apply = make_classifier("mlp", torch.Generator(), data.x.shape[-1], data.n_classes)[1]
    x_a = data.x_test[:, 0]                 # one test input per trained client
    y_a = torch.as_tensor(data.y_test[:, 0])
    s = data.n_clusters
    rng = np.random.default_rng(0)          # bench_mixture_qps's draws
    batches = [(rng.dirichlet(np.ones(s), size=SERVE_B).astype(np.float32),
                rng.normal(size=(SERVE_B, data.x.shape[-1])).astype(np.float32))
               for _ in range(20)]
    kernel_of = {"fp32": None, "int8": gm.gossip_mix_dequant,
                 "int4": gm.mixture_mix_dequant4}
    launches = {k.__name__: 0 for k in gm.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for codec, kernel in kernel_of.items():
            path = os.path.join(tmp, f"plane_{codec}.npz")
            man = export_run(result, path, codec=codec, qblock=64)
            art = load_servable(path, spec)
            check(man.n_clients == data.n_clients and art.n_clusters == s,
                  f"serve {codec}: artifact holds {man.n_clients} clients, "
                  f"{art.n_clusters} clusters")
            clients = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply)
            stream = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply)
            gm.reset_launch_counts()
            out = clients.predict(art.u_table, x_a)
            for u, x in batches:
                got = stream.predict(u, x)
                check(bool(torch.isfinite(got).all())
                      and tuple(got.shape) == (SERVE_B, data.n_classes),
                      f"serve {codec}: batch output {tuple(got.shape)} not finite (B, C)")
            torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in gm.KERNELS}
            for name, c in counts.items():
                launches[name] += c
            want = {k.__name__: (21 if k is kernel else 0) for k in gm.KERNELS}
            check(counts == want, f"serve {codec}: launches {counts}, expected {want} "
                                  "(one per predict, 1 + 20 predicts)")
            check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (data.n_clients,
                                                                           data.n_classes),
                  f"serve {codec}: client output {tuple(out.shape)} not finite (N, C)")
            # the same artifact on the CPU (the kernels' plain versions);
            # fp32 also against the personalized models materialized leaf
            # by leaf in plain PyTorch. Sums run in other orders on the two
            # sides and pass through three fp32 layers: 1e-4 on logits of
            # magnitude ~1.
            cpu = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply, device="cpu")
            err_cpu = float((out.cpu() - cpu.predict(art.u_table.cpu(), x_a)).abs().max())
            u_b, x_b = batches[-1]
            err_cpu = max(err_cpu, float((got.cpu() - cpu.predict(u_b, x_b)).abs().max()))
            check(err_cpu <= SERVE_TOL, f"serve {codec}: card vs CPU max abs err "
                                        f"{err_cpu} > {SERVE_TOL}")
            if codec == "fp32":
                u = art.u_table
                mat = (u[:, :, None] * art.plane[None]).sum(dim=1)   # (N, X)
                ref = apply(unpack(mat, spec),
                            torch.as_tensor(x_a, device=u.device).unsqueeze(1))[:, 0]
                err_mat = float((out - ref).abs().max())
                check(err_mat <= SERVE_TOL, f"serve fp32: vs materialized u @ plane "
                                            f"max abs err {err_mat} > {SERVE_TOL}")
            acc = float((out.argmax(dim=-1).cpu() == y_a).float().mean())
            snap = stream.telemetry_snapshot()
            print(f"serve {codec}: p50_ms {snap['p50_ms']:.4f} p95_ms {snap['p95_ms']:.4f} "
                  f"qps {snap['qps']:.1f} (B={SERVE_B}, {snap['batches']} batches) "
                  f"plane_bytes {snap['plane_bytes']} clients_acc {acc:.6f} "
                  f"clients_ms {clients.latency.percentile(50) * 1e3:.4f} "
                  f"card_vs_cpu_err {err_cpu:.3g} launches {json.dumps(counts)}", flush=True)
    return launches


def phase_baselines(torch, gm) -> dict:
    """Each baseline id for ROUNDS rounds on the card, the launch counters
    set to 0 just before each id and read just after. Returns the launches
    summed over the ids."""
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method
    from repro_torch.experiments.registry import build_context, edges_bytes, star_bytes

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=ROUNDS)
    ctx = build_context(data, exp, torch.device("cpu"))
    mb, n, s = ctx.pack_spec.model_bytes, ctx.n_clients, ctx.n_clusters
    total = {k.__name__: 0 for k in gm.KERNELS}
    for method in BASELINES:
        models = s if method.endswith("fedem") else 1
        per_round = (0.0 if method == "local" else
                     star_bytes(n, mb, models) if method.startswith("cfl_")
                     else edges_bytes(ctx.graph, mb, models))
        stack = ROUNDS if method.endswith("fedem") else 0
        flat = ROUNDS if method.endswith(("fedavg", "pfedme", "ifca")) else 0
        gm.reset_launch_counts()
        r = run_method(method, data, exp, cfg=RunConfig(eval_every=10**9, scan_rounds=False))
        counts = {k.__name__: k.launches for k in gm.KERNELS}
        for k, c in counts.items():
            total[k] += c
        ms = r.extras["round_ms"]
        print(f"baseline {method}: mean_acc {r.mean_acc:.6f} std_acc {r.std_acc:.6f} "
              f"comm_bytes {r.comm_bytes:.0f} launches {json.dumps(counts)} "
              f"round_ms median(rounds 2-{ROUNDS}) {statistics.median(ms[1:]):.3f} "
              f"first {ms[0]:.3f} wall_s {r.wall_s:.2f}", flush=True)
        want = {k: 0 for k in counts}
        want.update(gossip_mix_stack=stack, gossip_mix_flat=flat)
        check(counts == want, f"baseline {method}: launches {counts}, expected {want}")
        check(math.isfinite(r.mean_acc) and 0.0 <= r.mean_acc <= 1.0,
              f"baseline {method}: mean_acc {r.mean_acc} not finite in [0, 1]")
        check(r.comm_bytes == per_round * ROUNDS,
              f"baseline {method}: comm_bytes {r.comm_bytes} != {per_round} x {ROUNDS}")
    return total


def _comm_expected(method: str, codec: str, rounds: int) -> dict:
    """The launches a compressed baseline run makes on the loop: FedAvg and
    pFedMe mix the int8/int4 payload in ``gossip_mix_dequant`` and a top-k
    decode in ``gossip_mix_flat``, IFCA mixes its decoded slab in
    ``gossip_mix_flat``, FedEM its decoded (S, N, X) stack in
    ``gossip_mix_stack``, once a round; FedSoft aggregates in torch."""
    family = method.split("_", 1)[1]
    kernel = {"fedavg": "gossip_mix_dequant" if codec != "topk" else "gossip_mix_flat",
              "pfedme": "gossip_mix_dequant" if codec != "topk" else "gossip_mix_flat",
              "ifca": "gossip_mix_flat", "fedem": "gossip_mix_stack"}.get(family)
    return {} if kernel is None else {kernel: rounds}


def _comm_agreement(torch, gm, ctxs, method: str, comm, g) -> None:
    """One compressed round of ``method`` on the card against the CPU, from
    one state (after a first CPU round, so the residual is not zero) with
    the same injected batch indices and rounding draw. As in
    ``phase_sparse_agreement``, a near-tie (an input within the two sides'
    last-bit difference of a rounding step, or of top-k's k-th magnitude)
    shows as a residual more than 1e-5 apart: those columns are counted
    and left out, and every other column must agree within 1e-5."""
    from repro_torch.experiments.registry import get_method

    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    opts = {"comm": comm}
    cctx = {d: dataclasses.replace(ctxs[d], options=opts) for d in (cpu, gpu)}
    m, exp = get_method(method), cctx[cpu].exp
    n, mm, x = cctx[cpu].n_clients, cctx[cpu].train["inputs"].shape[1], cctx[cpu].pack_spec.size
    st = m.init(cctx[cpu], torch.Generator().manual_seed(5))
    st, _ = m.make_step(cctx[cpu])(st, cctx[cpu].train, torch.Generator().manual_seed(6),
                                   exp.lr0)
    fedem = method.endswith("fedem")
    prefix = (cctx[cpu].n_clusters,) if fedem else ()
    idx = torch.randint(0, mm, prefix + (exp.tau, n, exp.batch), generator=g)
    u = (None if comm.codec == "topk" else
         torch.rand(prefix + (n, -(-x // QBLOCK), QBLOCK), generator=g))
    out = []   # the CPU's, then the card's
    for d in (cpu, gpu):
        gm.reset_launch_counts()
        new, _ = m.make_step(cctx[d])(_state_to(torch, st, d), cctx[d].train, None, exp.lr0,
                                      idx=idx.to(d), comm_u=None if u is None else u.to(d))
        out.append(tuple(t.cpu() for t in ((new.centers if fedem else new.x), new.ef)))
    launched = {k.__name__: k.launches for k in gm.KERNELS}   # the card's round
    (pc, ec), (pg, eg) = out
    ties = (ec - eg).abs() > TOL
    clean = ~ties.reshape(-1, x).any(dim=0)
    plane_err = float((pc - pg)[..., clean].abs().max())
    ef_err = float((ec - eg)[..., clean].abs().max())
    want = _comm_expected(method, comm.codec, 1)
    print(f"agreement {method} {comm.codec}+ef: plane max abs err {plane_err:.3g}, ef max abs "
          f"err {ef_err:.3g} (near-ties {int(ties.sum())} of {ec.numel()} entries, "
          f"{int((~clean).sum())} of {x} columns left out, max tie diff "
          f"{float((ec - eg).abs().max()):.3g}), card launches {json.dumps(launched)}",
          flush=True)
    check(bool(torch.isfinite(pg).all()) and bool(torch.isfinite(eg).all()),
          f"agreement {method}: non-finite plane or residual on the card")
    check(int(ties.sum()) <= max(8, ec.numel() // 10000),
          f"agreement {method}: {int(ties.sum())} near-ties, more than rounding noise explains")
    check(plane_err <= TOL and ef_err <= TOL,
          f"agreement {method}: plane err {plane_err}, ef err {ef_err} > {TOL}")
    check({k: c for k, c in launched.items() if c} == want,
          f"agreement {method}: card launches {launched}, expected {want}")


def _optimizer_agreement(torch, ctxs) -> None:
    """One FedSPD round driven by AdamW and a cosine schedule, and
    ``local_sgd`` with momentum, on the card against the CPU from one state
    with the same injected draws, within 1e-5. AdamW runs at eps 1e-3:
    its step m / (sqrt(v) + eps) magnifies the two sides' last-bit gradient
    differences by up to lr / (sqrt(v) + eps), past 1e-5 at the default
    eps on the coordinates with the smallest gradients (as in
    tests/test_torch_optim.py)."""
    from repro_torch.baselines.common import local_sgd
    from repro_torch.core.fedspd import FedSPDConfig, make_round_step, seeded_init
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.optim import adamw, cosine_with_warmup, momentum

    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    ctx, exp = ctxs[cpu], ctxs[cpu].exp
    n, mm, ps = ctx.n_clients, ctx.train["inputs"].shape[1], ctx.pack_spec
    g = torch.Generator().manual_seed(8)
    cfg = FedSPDConfig(n_clients=n, n_clusters=ctx.n_clusters, tau=exp.tau, batch=exp.batch)
    st = seeded_init(torch.Generator().manual_seed(0), ctx.model_init, cfg, ctx.loss_fn,
                     ctx.train, ps, epochs=2)._replace(round=3)
    s = torch.randint(0, ctx.n_clusters, (n,), generator=g)
    idx = torch.randint(0, mm, (cfg.tau, n, cfg.batch), generator=g)
    sched = cosine_with_warmup(exp.lr0, warmup=2, total=6)
    out = []   # the CPU's, then the card's
    for d in (cpu, gpu):
        spec = GossipSpec.from_graph(ctxs[d].graph)
        step = make_round_step(ctxs[d].loss_fn, ctxs[d].pel_fn, spec, cfg, pack_spec=ps,
                               optimizer=adamw(eps=1e-3), lr_schedule=sched)
        st_d = st._replace(centers=st.centers.to(d, copy=True), u=st.u.to(d), z=st.z.to(d),
                           comm_bytes=st.comm_bytes.to(d), gen=torch.Generator(device=d))
        new, met = step(st_d, ctxs[d].train, s=s.to(d), idx=idx.to(d))
        plane = local_sgd(ctxs[d].loss_fn, st.centers[0].to(d, copy=True), ctxs[d].train,
                          None, exp.tau, exp.batch, exp.lr0, pack_spec=ps,
                          optimizer=momentum(), idx=idx.to(d))
        out.append([t.cpu() for t in (new.centers, new.u, new.z, met["lr"], plane)])
    (pc, uc, zc, lc, qc), (pg, ug, zg, lg, qg) = out
    err, u_err = float((pc - pg).abs().max()), float((uc - ug).abs().max())
    sgd_err = float((qc - qg).abs().max())
    agree = float((zc == zg).float().mean())
    print(f"agreement fedspd adamw + cosine lr (round 3: lr {float(lc):.9g} cpu, "
          f"{float(lg):.9g} card): plane max abs err {err:.3g}, u max abs err {u_err:.3g}, "
          f"z agreement {agree:.6f}; local_sgd momentum: plane max abs err {sgd_err:.3g}",
          flush=True)
    check(bool(torch.isfinite(pg).all()) and bool(torch.isfinite(qg).all()),
          "optimizer agreement: non-finite plane on the card")
    check(err <= TOL and sgd_err <= TOL,
          f"optimizer agreement: fedspd err {err}, local_sgd err {sgd_err} > {TOL}")
    check(agree >= 0.99, f"optimizer agreement: z agreement {agree} < 0.99")


def phase_baselines_comm(torch, gm) -> dict:
    """The baselines' compressed exchange: one compressed round of
    ``dfl_fedavg`` (int8 + error feedback) and ``dfl_fedem`` (top-k + error
    feedback) on the card against the CPU, the optimizer-driven round
    likewise; then each paired baseline id for ROUNDS rounds under int8 +
    error feedback, and ``dfl_fedavg`` and ``dfl_fedem`` also under int4
    and top-k + error feedback, each on the loop and on the replay
    (``_engine_pair``: bit for bit, the trace's replays). The loop run's
    launches must be ``_comm_expected``'s, its ``wire_bytes`` the channel's
    static ratio of its ``comm_bytes``, and ``comm_bytes`` the static
    formula. Returns the loop runs' launches summed over the ids."""
    from repro_torch.comm.codecs import CommConfig, make_channel
    from repro_torch.configs.paper_cnn import PaperExpConfig
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments import RunConfig, run_method, run_method_batch
    from repro_torch.experiments.registry import build_context, edges_bytes, star_bytes
    from repro_torch.graphs.topology import make_graph

    data, exp = make_mixture_classification(), PaperExpConfig(rounds=ROUNDS)
    ctxs = {d: build_context(data, exp, torch.device(d)) for d in ("cpu", "cuda")}
    ctxs = {torch.device(d): c for d, c in ctxs.items()}
    g = torch.Generator().manual_seed(7)
    for method, codec in (("dfl_fedavg", "int8"), ("dfl_fedem", "topk")):
        _comm_agreement(torch, gm, ctxs, method, CommConfig(codec=codec, error_feedback=True), g)
    _optimizer_agreement(torch, ctxs)

    ctx = ctxs[torch.device("cpu")]
    mb, n, s, x = ctx.pack_spec.model_bytes, ctx.n_clients, ctx.n_clusters, ctx.pack_spec.size
    codecs = {"int8+ef": CommConfig(codec="int8", error_feedback=True),
              "int4": CommConfig(codec="int4"),
              "topk+ef": CommConfig(codec="topk", error_feedback=True)}
    runs = [(b, "int8+ef") for b in BASELINES if b != "local"]
    runs += [(b, c) for b in ("dfl_fedavg", "dfl_fedem") for c in ("int4", "topk+ef")]
    total = {k.__name__: 0 for k in gm.KERNELS}
    for method, label in runs:
        comm = codecs[label]
        models = s if method.endswith("fedem") else 1
        per_round = (star_bytes(n, mb, models) if method.startswith("cfl_")
                     else edges_bytes(ctx.graph, mb, models))
        cfg = RunConfig(eval_every=10**9, comm=comm, options={"keep_state": True})
        pair = _engine_pair(torch, gm, f"{method} {label}", method, data, exp, cfg)
        loop, scan, counts = pair["loop"], pair["scan"], pair["loop_counts"]
        for k, c in counts.items():
            total[k] += c
        ratio = make_channel(comm, x).wire_ratio(mb)
        lm, sm = loop.extras["round_ms"], scan.extras["round_ms"]
        print(f"baseline comm {method} {label}: mean_acc {loop.mean_acc:.6f} comm_bytes "
              f"{loop.comm_bytes:.0f} wire_bytes {loop.wire_bytes:.0f} (ratio {ratio:.6f}) "
              f"loop launches {json.dumps(counts)} replay counters (warm-up + capture) "
              f"{json.dumps(pair['counts'])} loop round_ms median(rounds 2-{ROUNDS}) "
              f"{statistics.median(lm[1:]):.4f} replay round_ms median "
              f"{statistics.median(sm[1:]):.4f} first {sm[0]:.4f} (profiled) capture_ms "
              f"{json.dumps([round(v, 1) for v in scan.extras['capture_ms']])} "
              "replay vs loop: equal", flush=True)
        want = {k: 0 for k in counts}
        want.update(_comm_expected(method, comm.codec, ROUNDS))
        check(counts == want, f"baseline comm {method} {label}: launches {counts}, "
                              f"expected {want}")
        check(scan.extras["n_captures"] == 1,
              f"baseline comm {method} {label}: {scan.extras['n_captures']} captures")
        check(loop.comm_bytes == per_round * ROUNDS,
              f"baseline comm {method} {label}: comm_bytes {loop.comm_bytes} != "
              f"{per_round} x {ROUNDS}")
        check(loop.wire_bytes == loop.comm_bytes * ratio,
              f"baseline comm {method} {label}: wire_bytes {loop.wire_bytes} != "
              f"{loop.comm_bytes} x {ratio}")
        check(math.isfinite(loop.mean_acc) and 0.0 <= loop.mean_acc <= 1.0,
              f"baseline comm {method} {label}: mean_acc {loop.mean_acc} not in [0, 1]")

    # run_method_batch under a codec: each seed of a replayed 2-seed batch
    # equals its own replayed run_method on the batch's graph
    graph = make_graph(exp.graph_kind, exp.n_clients, exp.avg_degree, seed=0)
    cfg = RunConfig(eval_every=10**9, comm=codecs["int8+ef"], options={"keep_state": True})
    batch = run_method_batch("dfl_fedavg", data, exp, seeds=(0, 1), graph=graph, cfg=cfg)
    for seed, got in zip((0, 1), batch):
        one = run_method("dfl_fedavg", data, exp, graph=graph, seed=seed, cfg=cfg)
        diff = _same_run(torch, got, one)
        check(not diff and got.extras["n_captures"] == 1,
              f"baseline comm dfl_fedavg int8+ef: run_method_batch seed {seed} differs from "
              f"its run_method in {diff} ({got.extras['n_captures']} captures)")
    print("baseline comm dfl_fedavg int8+ef: run_method_batch over seeds 0, 1 (replay) "
          "equals each seed's run_method: equal", flush=True)
    return total


def _ssd_bound(b, l, h, g, p, n, q, dtype, state) -> tuple[float, str]:
    """(least ms, bound_by) of a kernel-9 call, by
    ``roofline/analysis.kernel_bound``: x, B, C, dt, A (and s0) read once,
    y and the final state written once; the chunked dual form's products."""
    from repro_torch.roofline.analysis import kernel_bound

    return kernel_bound("ssd_scan", b=b, l=l, h=h, g=g, p=p, n=n, chunk=q, dtype=dtype,
                        state=state)


def _ssd_tc_kernels() -> dict:
    """Kernel 9's tensor-core kernels by route (``ROUTE_KERNELS`` of the
    ``ssd_wgmma`` and ``ssd_tf32`` routes) and the instruction each must
    hold: HGMMA (``wgmma``) in the bf16 ones, HMMA or HGMMA in the fp32."""
    from repro_torch.kernels.ssd_scan import ROUTE_KERNELS

    return {**{k: ("HGMMA",) for k in ROUTE_KERNELS["ssd_wgmma"]},
            **{k: ("HMMA", "HGMMA") for k in ROUTE_KERNELS["ssd_tf32"]}}


def tensor_core_counts(build, lib_path) -> dict:
    """Tensor-core instructions in the built library, from ``cuobjdump
    -sass`` (beside ``nvcc``): ``{key: {"HMMA": n, "HGMMA": n}}`` for each
    instantiation of kernel 8's kernels (key ``"flash_wgmma_kernel<64>"``
    and so on: ``wgmma`` assembles to HGMMA, ``mma.sync`` to HMMA) and for
    kernel 9's tensor-core kernels (key: the name, ``_ssd_tc_kernels``)."""
    ssd = tuple(_ssd_tc_kernels())
    cuobjdump = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    r = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                       text=True, timeout=300)
    check(r.returncode == 0, f"cuobjdump -sass failed: {r.stderr.strip()[-500:]}")
    counts, key = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:wgmma|mma|tf32)_kernel)ILi(\d+)E", line)
            key = f"{m.group(1)}<{m.group(2)}>" if m else next(
                (k for k in ssd if k in line), None)
            if key is not None:
                counts[key] = {"HMMA": 0, "HGMMA": 0}
        elif key is not None:
            m = re.search(r"\b(HG?MMA)\b", line)
            if m:
                counts[key][m.group(1)] += 1
    return counts


def check_tensor_cores(counts: dict) -> None:
    """Print and check ``tensor_core_counts``: every kernel-8 route of
    (head dim, dtype) holds its instructions (HGMMA in a ``wgmma``-route
    instantiation, HMMA in the ``mma.sync`` and 3xTF32 ones), and kernel
    9's bf16 kernels hold HGMMA, its fp32 ones HMMA or HGMMA."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS, route

    for dt in ("bfloat16", "float32"):
        got = {}
        for hd in HEAD_DIMS:
            key = f"{route(hd, dt)}<{hd}>"
            got[key] = counts.get(key, {"HMMA": 0, "HGMMA": 0})
            op = "HGMMA" if key.startswith("flash_wgmma") else "HMMA"
            check(got[key][op] > 0, f"kernel 8's {key} ({dt}) holds no {op} instruction")
        print(f"sass flash_attention ({dt}) tensor-core instructions: " + json.dumps(got),
              flush=True)
    need = _ssd_tc_kernels()
    print("sass ssd_scan HMMA/HGMMA per kernel: "
          + json.dumps({k: counts.get(k) for k in need}), flush=True)
    for k, ops in need.items():
        check(sum(counts.get(k, {}).get(op, 0) for op in ops) > 0,
              f"kernel 9's {k} holds no {' or '.join(ops)} instruction")


def _stage_ms(torch, fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel-9 kernel that ``fn`` launches
    (``{name: ms}``), from one torch.profiler pass over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"\b(ssd_\w+)", e.key)
        if e.device_type.name == "CUDA" and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def flash_tol(want, dt: str) -> float:
    """Kernel 8's limit against a reference output ``want``: 2e-5 in fp32;
    in bf16 2e-2 of the reference's largest |value|, at most 2e-2. A row
    that sees n keys of unit-normal inputs averages them to about N(0, e/n)
    (std 0.026 at 4,096 keys), and a kernel that dropped one of 16 chunks
    would move it by about 0.006 std, under a fixed 2e-2; 2e-2·max|want| is
    over two bf16 steps at the largest output, and a right kernel differs
    from its plain version by one step there."""
    if dt == "float32":
        return 2e-5
    return min(2e-2, 2e-2 * float(want.float().abs().max()))


def _flash_row(torch, q, k, v, *, causal, window, label, counts) -> dict:
    """One kernel-8 row: the kernel against its plain version (``flash_tol``)
    and, with a kv split, against the plain split-and-merge; then timed by
    CUDA-graph replay beside its bound (the one reckoning,
    ``roofline/analysis.kernel_bound``; an fp32 row also beside the 3xTF32
    route's own, three TF32 products at ``PEAK_FLOPS_TF32``), the plain
    version and one
    ``scaled_dot_product_attention`` ((B, H, L, hd), kv heads repeated for
    GQA, a window as a boolean mask made outside the timing). The row
    names its route, its split and its kernel's tensor-core counts."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_ref,
                                                     flash_attention_split_ref, route,
                                                     sm_count, split_plan)
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.roofline.analysis import kernel_bound, kernel_work, live_pairs

    dev = q.device
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, lq, hq, hd = q.shape
    lkv, hkv = k.shape[1], k.shape[2]
    dt = str(q.dtype).removeprefix("torch.")
    n_split, chunk = split_plan(b, lq, lkv, hq, hkv, hd, q.dtype, causal=causal,
                                num_sms=sm_count(dev))
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - want.float()).abs().max())
    tol = flash_tol(want, dt)
    where = f"flash_attention {label} ({dt}, {route(hd, dt)}, split {n_split})"
    check(bool(torch.isfinite(out).all()), f"{where}: not finite")
    check(err <= tol, f"{where}: max abs err {err} > {tol}")
    split_err = None
    if n_split > 1:
        split_want = flash_attention_split_ref(q, k, v, causal=causal, window=window)
        split_err = float((out.float() - split_want.float()).abs().max())
        split_tol = min(tol, flash_tol(split_want, dt))
        check(split_err <= split_tol, f"{where}: max abs err {split_err} > {split_tol} "
                                      "against the plain split-and-merge")
        del split_want
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    if window is None:
        def lib():
            return sdpa(qt, kt, vt, is_causal=causal)
    else:
        i, j = torch.arange(lq, device=dev), torch.arange(lkv, device=dev)
        mask = i[:, None] - j[None, :] < window
        if causal:
            mask &= i[:, None] >= j[None, :]

        def lib():
            return sdpa(qt, kt, vt, attn_mask=mask)
    shape = dict(b=b, lq=lq, lkv=lkv, hq=hq, hkv=hkv, hd=hd, causal=causal, window=window,
                 dtype=dt)
    b_ms, b_by = kernel_bound("flash_attention", **shape)
    flops, nbytes = kernel_work("flash_attention", **shape)
    tf32x3_ms = (max(nbytes / HBM_BW, 3 * flops / PEAK_FLOPS_TF32) * 1e3
                 if dt == "float32" else None)
    row = dict(
        b=b, l=lq, lkv=lkv, hq=hq, hkv=hkv, hd=hd, window=window, causal=causal, dtype=dt,
        variant=label, route=route(hd, dt), split=n_split, chunk=chunk if n_split > 1 else None,
        live_pairs=live_pairs(lq, lkv, causal, window),
        tensor_core_instructions=counts[f"{route(hd, dt)}<{hd}>"] if counts else None,
        tol=tol, max_abs_err=err, split_ref_max_abs_err=split_err,
        ms=graph_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 20, 10),
        plain_ms=graph_ms(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                      window=window), 3, 3),
        library_ms=graph_ms(lib, 20, 10), bound_ms=b_ms, bound_by=b_by,
        tf32x3_bound_ms=tf32x3_ms)
    print("kernel flash_attention " + json.dumps(row), flush=True)
    return row


def _qkv_on_card(torch, b, lq, lkv, hq, hkv, hd, dt, seed):
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, lq, hq, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, lkv, hkv, hd), generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v


def flash_shape_rows(torch, counts: dict) -> list:
    """Kernel 8 at the LM path's shapes (``FLASH_SHAPES``, causal) and at
    short query ranges whose keys split (``SPLIT_FLASH``)."""
    rows = []
    for b, l, hq, hkv, hd, window, dt in FLASH_SHAPES:
        q, k, v = _qkv_on_card(torch, b, l, l, hq, hkv, hd, dt, seed=l + hq + hd)
        rows.append(_flash_row(torch, q, k, v, causal=True, window=window,
                               label=f"B={b} L={l} {hq}/{hkv} hd {hd}", counts=counts))
        del q, k, v
        torch.cuda.empty_cache()
    for b, lq, lkv, hq, hkv, hd, causal, window, dt, label in SPLIT_FLASH:
        q, k, v = _qkv_on_card(torch, b, lq, lkv, hq, hkv, hd, dt, seed=lq + lkv + hd)
        rows.append(_flash_row(torch, q, k, v, causal=causal, window=window, label=label,
                               counts=counts))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def ssd_shape_rows(torch, tc_counts: dict) -> list:
    """Kernel 9 at ``SSD_SHAPES``: each row against its plain version, its
    route and two kernels' device ms (torch.profiler, which must see
    exactly the route's kernels), their tensor-core instruction counts, and
    its time by CUDA-graph replay beside its bound (an fp32 row also beside
    the 3xTF32 route's own: three TF32 products at ``PEAK_FLOPS_TF32``) and
    its plain version's."""
    from repro_torch.kernels.ssd_scan import (LAUNCHES_PER_CALL, ROUTE_KERNELS,
                                              heads_per_block, route, sm_count, ssd_chunked,
                                              ssd_scan, walk_cols)
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.roofline.analysis import kernel_work

    dev = torch.device("cuda")
    rows = []
    for b, l, h, gr, p, n, chunk, dt, state in SSD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(l + h + n + int(state))
        x = torch.randn((b, l, h, p), generator=g, device=dev).to(dtype)
        dts = torch.nn.functional.softplus(torch.randn((b, l, h), generator=g, device=dev)) * 0.1
        a = -torch.exp(torch.rand((h,), generator=g, device=dev))
        bm, cm = (torch.randn((b, l, gr, n), generator=g, device=dev).to(dtype)
                  for _ in range(2))
        s0 = torch.randn((b, h, p, n), generator=g, device=dev) if state else None
        y, s = ssd_scan(x, dts, a, bm, cm, chunk=chunk, initial_state=s0)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(x, dts, a, bm, cm, chunk, s0)
        # 2e-3 abs + rel; y in bf16 may also differ by one bf16 step (at
        # most 2^-7 of the value)
        rtol = 2e-3 if dt == "float32" else 2e-3 + 2.0 ** -7
        y_ok = bool(((y.float() - yr.float()).abs() <= 2e-3 + rtol * yr.float().abs()).all())
        s_ok = bool(((s - sr).abs() <= 2e-3 + 2e-3 * sr.abs()).all())
        err = max(float((y.float() - yr.float()).abs().max()), float((s - sr).abs().max()))
        rt = route(dt, p, n)
        where = f"ssd_scan {dt} B={b} L={l} H={h} P={p} N={n} state={state} ({rt})"
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all()),
              f"{where}: not finite")
        check(y_ok and s_ok, f"{where}: max abs err {err} outside 2e-3 (+ rtol {rtol})")
        b_ms, b_by = _ssd_bound(b, l, h, gr, p, n, chunk, dt, state)
        flops, nbytes = kernel_work("ssd_scan", b=b, l=l, h=h, g=gr, p=p, n=n, chunk=chunk,
                                    dtype=dt, state=state)
        stages = _stage_ms(torch, lambda: ssd_scan(x, dts, a, bm, cm, chunk=chunk,
                                                   initial_state=s0))
        want = ROUTE_KERNELS[rt]
        check(sorted(stages) == sorted(want),
              f"{where}: the profiler saw {sorted(stages)}, expected {sorted(want)}")
        rows.append(dict(
            b=b, l=l, h=h, g=gr, p=p, n=n, chunk=chunk, dtype=dt, initial_state=state,
            route=rt, heads_per_block=(heads_per_block(b, l, h, gr, chunk, sm_count(dev))
                                       if rt == "ssd_wgmma" else 1),
            walk_cols=walk_cols(b, h, n, sm_count(dev)) if rt == "ssd_wgmma" else 64,
            max_abs_err=err, launches_per_call=LAUNCHES_PER_CALL,
            stage_ms={k: stages[k] for k in want},
            tensor_core_instructions={k: tc_counts.get(k) for k in want},
            ms=graph_ms(lambda: ssd_scan(x, dts, a, bm, cm, chunk=chunk, initial_state=s0),
                        20, 10),
            plain_ms=graph_ms(lambda: ssd_chunked(x, dts, a, bm, cm, chunk, s0), 5, 5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            tf32x3_bound_ms=(max(nbytes / HBM_BW, 3 * flops / PEAK_FLOPS_TF32) * 1e3
                             if dt == "float32" else None)))
        print("kernel ssd_scan " + json.dumps(rows[-1]), flush=True)
        del x, dts, bm, cm, s0, y, s, yr, sr
        torch.cuda.empty_cache()
    return rows


def phase_lm_kernels(torch, tc_counts: dict) -> dict:
    """Kernels 8 and 9 against their plain versions at the LM path's
    shapes, timed by CUDA-graph replay beside bound, plain and library;
    each row names its route and carries its kernels' tensor-core
    instruction counts, and each kernel-9 row its two kernels' device ms
    (torch.profiler)."""
    return {"flash_attention": flash_shape_rows(torch, tc_counts),
            "ssd_scan": ssd_shape_rows(torch, tc_counts)}


class _PlainLMKernels:
    """Within the block the LM models run the plain versions of kernels 8
    and 9 on the card (the comparison side of the LM serve phase)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import flash_attention_ref
        from repro_torch.kernels.ssd_scan import ssd_chunked
        from repro_torch.models import attention, ssm

        self.saved = (attention.flash_attention, ssm.ssd_scan)
        attention.flash_attention = flash_attention_ref
        ssm.ssd_scan = lambda x, dt, A, B, C, *, chunk, initial_state=None: ssd_chunked(
            x, dt, A, B, C, chunk, initial_state)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention, ssm

        attention.flash_attention, ssm.ssd_scan = self.saved


def _replay_logits(torch, bundle, params, prompts, got, step: int):
    """The logits ``generate`` drew token ``step`` from, replayed through
    its own steps (prefill, re-score of the last prompt token, decode of
    ``got``'s tokens before ``step``)."""
    b, lp = prompts.shape
    with torch.no_grad():
        cache = bundle.init_cache(b, lp + LM_GEN + 1, device=prompts.device)
        cache = bundle.prefill(params, {"tokens": prompts}, cache)
        cache["pos"].fill_(lp - 1)
        logits, cache = bundle.decode_step(params, cache, prompts[:, -1:])
        for i in range(step):
            logits, cache = bundle.decode_step(params, cache, got[:, i:i + 1].long())
    return logits[:, -1, :bundle.cfg.vocab].float()


def _first_flip(torch, server, bundle, u, prompts, got, want) -> tuple[str, bool]:
    """Tokens of the kernel run (``got``) against the plain run
    (``want``): ("equal", True), or the first step where they differ with
    the kernel run's logit gap there between the two tokens (replayed
    through the server's own steps: mix, cast, prefill, re-score, decode
    ``got``'s tokens) and whether the flip is a bf16 near-tie: a gap under
    BF16_GAP or two bf16 steps at the logits' magnitude. A wider gap is
    judged by the fp32 reference (fp32 activations and weights, the plain
    versions of kernels 8 and 9, ``got``'s tokens): the flip passes only
    if its argmax is the kernel run's token, i.e. the plain bf16 run is
    the one rounded off the precise answer."""
    from repro_torch.models.layers import cast_params_for_compute
    from repro_torch.models.registry import build_model

    if torch.equal(got, want):
        return "equal", True
    step = int((got != want).any(dim=0).nonzero()[0])
    row = int((got[:, step] != want[:, step]).nonzero()[0])
    tk, tp = int(got[row, step]), int(want[row, step])
    params = cast_params_for_compute(server.personalized(u), bundle.cfg.compute_dtype_torch())
    logits = _replay_logits(torch, bundle, params, prompts, got, step)
    del params
    a, b_ = float(logits[row, tk]), float(logits[row, tp])
    gap = abs(a - b_)
    # two bf16 steps (8 significant bits) at the larger logit's magnitude
    steps = 2.0 ** (math.floor(math.log2(max(abs(a), abs(b_), 1e-30))) - 6)
    verdict = (f"first flip at step {step} (request {row}), logit gap {gap:.4g} (logits "
               f"{a:.4g}, {b_:.4g}; two bf16 steps {steps:.4g})")
    if gap <= max(BF16_GAP, steps):
        return verdict, True
    ref_bundle = build_model(bundle.cfg.with_overrides(compute_dtype="float32"),
                             attn_mode="cuda")
    with _PlainLMKernels():
        ref = _replay_logits(torch, ref_bundle, server.personalized(u), prompts, got, step)
    top = int(ref[row].argmax())
    verdict += (f"; past a bf16 near-tie, the fp32 reference's logits {float(ref[row, tk]):.4g}, "
                f"{float(ref[row, tp]):.4g} pick token {top} (kernel run {tk}, plain run {tp})")
    return verdict, top == tk


def _lm_server(torch, arch: str, codec: str, gen: int = LM_GEN):
    """(arch config, bundle, server, u, prompts): ``launch/serve``'s random
    S = 2 plane of ``arch`` at full width in ``codec``, the arch's B
    requests (``LM_SERVE``) with their own mixtures, prompts of LM_PROMPT
    tokens from seed 0."""
    import numpy as np

    from repro_torch.core.packing import make_pack_spec
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServeConfig

    b = LM_SERVE[arch][0]
    cfg = ServeConfig(arch=arch, smoke=False, batch=b, prompt_len=LM_PROMPT, gen=gen,
                      codec=codec, mixture=np.array(LM_MIXTURE[:b], np.float32)).resolve()
    arch_cfg = cfg.arch_config()
    bundle = build_model(arch_cfg, attn_mode="cuda")
    spec = make_pack_spec(bundle.init(None))
    check(spec.size == LM_ARCHS[arch], f"{arch}: X = {spec.size}, expected {LM_ARCHS[arch]}")
    dev = torch.device("cuda")
    server, u = launch_serve.build_server(cfg, bundle, spec, device=dev)
    prompts = torch.randint(0, arch_cfg.vocab, (b, LM_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    return arch_cfg, bundle, server, torch.as_tensor(u, device=dev), prompts


def _lm_launches(cfg) -> dict:
    """Kernel 8 / 9 launches of one generate (the eager prefill; the
    decode launches neither): one flash launch per attention layer (per
    invocation of zamba2's shared block), ``LAUNCHES_PER_CALL`` SSD-scan
    launches per Mamba2 layer."""
    from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL

    if cfg.family == "ssm":
        return {"ssd_scan": LAUNCHES_PER_CALL * cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "ssd_scan": LAUNCHES_PER_CALL * cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


class _CountDrops:
    """Within the block, every MoE routing records its dropped (token,
    expert) pairs: ``counts`` holds one ``(dropped, pairs, capacity)`` per
    MoE layer call, read on the host after the block."""

    def __enter__(self):
        from repro_torch.models import moe

        self.saved, self.calls = moe._slots, []

        def slots(flat_expert, e, capacity, dispatch):
            keep, slot = self.saved(flat_expert, e, capacity, dispatch)
            self.calls.append(((~keep).sum(), keep.numel(), capacity))
            return keep, slot

        moe._slots = slots
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._slots = self.saved

    @property
    def counts(self) -> list:
        return [(int(d), n, c) for d, n, c in self.calls]


def _prefill_drops(torch, server, bundle, u, prompts) -> list:
    """The dropped (token, expert) pairs of each MoE layer in the prefill
    of ``prompts``, as the server runs it (each request routed alone)."""
    params = _eager_params(torch, server, u)
    cache = bundle.init_cache(prompts.shape[0], prompts.shape[1] + LM_GEN + 1,
                              device=prompts.device)
    with torch.no_grad(), _CountDrops() as drops:
        bundle.prefill(params, {"tokens": prompts}, cache)
    del params, cache
    return drops.counts


def _eager_params(torch, server, u):
    """The compute-cast personalized leaves, as the server cast them per
    call before its decode was captured (the eager decode's weights)."""
    from repro_torch.models.layers import cast_params_for_compute

    return cast_params_for_compute(server.personalized(u),
                                   server.bundle.cfg.compute_dtype_torch())


def _median_ms(torch, fn, reps: int = 3) -> float:
    return statistics.median(_timed_call(torch, fn) for _ in range(reps))


class _TokenClock:
    """CUDA events on the card's timeline around the decode tokens of one
    call: one recorded before the first token, one after each."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def mark(self) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def ms_per_token(self) -> float:
        self.torch.cuda.synchronize()
        return self.events[0].elapsed_time(self.events[-1]) / (len(self.events) - 1)


def _captured_call(server, u, prompts):
    """``run(gen, clock)`` for the server's captured generate: with a
    clock, the replays of the LM_GEN-token key's graph are marked."""
    def run(gen, clock=None):
        if clock is None:
            return server.generate(u, prompts, gen=gen)
        engine = server.engines[(prompts.shape[0], LM_PROMPT, gen, 0.0)]
        graph = engine.graph

        class Marked:
            def replay(self):
                if not clock.events:
                    clock.mark()
                graph.replay()
                clock.mark()

        engine.graph = Marked()
        try:
            return server.generate(u, prompts, gen=gen)
        finally:
            engine.graph = graph

    return run


def _eager_call(bundle, params, prompts):
    """``run(gen, clock)`` for ``decode_eager``: with a clock, its decode
    steps are marked (the last token's argmax falls outside the marks)."""
    from repro_torch.serve.server import decode_eager

    def run(gen, clock=None):
        if clock is None:
            return decode_eager(bundle, params, prompts, gen=gen)

        def step(p, c, t):
            if not clock.events:
                clock.mark()
            out = bundle.decode_step(p, c, t)
            clock.mark()
            return out

        return decode_eager(dataclasses.replace(bundle, decode_step=step), params, prompts,
                            gen=gen)

    return run


def _decode_ms(torch, run) -> tuple[float, float, float]:
    """(prefill ms, decode ms a token, ms of the LM_GEN-token call) of an
    engine's ``run``, medians of 3: the decode ms a token by the card's
    clock between the marks around the tokens of an LM_GEN-token call (a
    host that falls behind shows as gaps), the call's ms by the host's to
    device completion, and the prefill ms that of a 1-token call (the mix,
    the prefill and the re-score of the last prompt token) less a token."""
    one = _median_ms(torch, lambda: run(1))
    fulls, tokens = [], []
    for _ in range(3):
        clock = _TokenClock(torch)
        fulls.append(_timed_call(torch, lambda: run(LM_GEN, clock)))
        tokens.append(clock.ms_per_token())
    decode = statistics.median(tokens)
    return one - decode, decode, statistics.median(fulls)


def _free(torch) -> None:
    """Return the freed servers' memory (their graphs' pools among it) to
    the card, so that the next server starts from an empty cache."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _decoded_plane(torch, server):
    """The server's int8 / int4 plane decoded to fp32 ``(S, Xp)`` (the
    library yardstick's operand)."""
    from repro_torch.comm.codecs import int4_unpack

    sc, qb = server.plane_scale, server.qblock
    xp = sc.shape[1] * qb
    plane = torch.empty((sc.shape[0], xp), dtype=torch.float32, device=sc.device)
    for s in range(sc.shape[0]):     # a row at a time: the int4 unpack is int32-wide
        q = server.plane_q[s] if server.codec == "int8" else int4_unpack(
            server.plane_packed[s], xp)
        plane[s].view(-1, qb).copy_(q.view(-1, qb)).mul_(sc[s, :, None])
    return plane


def _library_mix_ms_in_chunks(torch, gm, name: str, server, u) -> float:
    """Device ms of ``torch.matmul`` of u by the server's plane decoded to
    fp32, over the whole width in chunks of PLAIN_MIX_COLUMNS columns
    (where the whole decoded plane would not fit beside the server): each
    chunk is decoded (the plain version with W = I) before its clock
    starts; the chunks' CUDA-event times summed."""
    plain = getattr(gm, name + "_ref")
    sc, qb = server.plane_scale, server.qblock
    xp, step = sc.shape[1] * qb, PLAIN_MIX_COLUMNS // qb * qb
    eye = torch.eye(sc.shape[0], device=sc.device)
    ms = 0.0
    for c0 in range(0, xp, step):
        c1 = min(c0 + step, xp)
        payload = (server.plane_q[:, c0:c1] if name == "gossip_mix_dequant"
                   else server.plane_packed[:, c0 // 2:c1 // 2])
        decoded = plain(eye, payload, sc[:, c0 // qb:c1 // qb], qblock=qb)
        if c0 == 0:
            torch.matmul(u, decoded)   # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.matmul(u, decoded)
        end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
        del decoded
    return ms


def _mix_against_plain(torch, gm, name: str, server, u, out) -> tuple[float, float]:
    """(max abs error, device ms) of the plain version of the server's mix
    kernel ``name`` against its output ``out`` ``(B, Xp)``, over the whole
    width in chunks of PLAIN_MIX_COLUMNS columns (the plain version
    decodes its chunk of the plane to fp32: at full width that plane would
    not fit beside the server); the ms are the chunks' CUDA-event times
    summed."""
    plain = getattr(gm, name + "_ref")
    sc, qb = server.plane_scale, server.qblock
    xp, step = out.shape[1], PLAIN_MIX_COLUMNS // qb * qb
    err, ms = 0.0, 0.0
    for c0 in range(0, xp, step):
        c1 = min(c0 + step, xp)
        payload = (server.plane_q[:, c0:c1] if name == "gossip_mix_dequant"
                   else server.plane_packed[:, c0 // 2:c1 // 2])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(u, payload, sc[:, c0 // qb:c1 // qb], qblock=qb)
        end.record()
        err = max(err, float((out[:, c0:c1] - want).abs().max()))
        ms += start.elapsed_time(end)
    return err, ms


def phase_lm_serve(torch, gm) -> tuple[dict, dict]:
    """The fifth path: LM generation at full width, the server's captured
    decode beside the eager decode, for each arch of ``LM_SERVE`` in each
    of its codecs. Returns the launches summed over the counted generate
    calls (every kernel, kernels 8 and 9 included) and the int8 / int4
    mixes' kernel rows at each arch's shape."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve.server import decode_eager

    kernels = gm.KERNELS + (flash_attention, ssd_scan)
    total = {k.__name__: 0 for k in kernels}
    mix_rows = {"gossip_mix_dequant": [], "mixture_mix_dequant4": []}
    t_new = 0.0
    for arch, (lm_b, codecs) in LM_SERVE.items():
        t_arch = time.perf_counter()
        for codec in codecs:
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            arch_cfg, bundle, server, u, prompts = _lm_server(torch, arch, codec)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            server.generate(u, prompts, gen=1)                       # first use
            for k in kernels:
                k.launches = 0
            toks = server.generate(u, prompts, gen=LM_GEN)           # captures its key
            counts = {k.__name__: k.launches for k in kernels}
            for name, c in counts.items():
                total[name] += c
            peak = torch.cuda.max_memory_allocated()
            engine = server.engines[(lm_b, LM_PROMPT, LM_GEN, 0.0)]
            prefill_ms, decode_ms, gen_ms = _decode_ms(torch, _captured_call(server, u, prompts))
            check(server.n_compiles == 2,
                  f"lm serve {arch} {codec}: n_compiles {server.n_compiles} after calls "
                  "of two shape keys (gen 1 and 16), expected 2")
            mix_ms = _median_ms(torch, lambda: server.personalized(u))
            # the eager decode: the same steps launched one by one
            params = _eager_params(torch, server, u)
            eager, last = decode_eager(bundle, params, prompts, gen=LM_GEN)
            check(torch.equal(toks, eager),
                  f"lm serve {arch} {codec}: captured tokens {toks.tolist()} differ from the "
                  f"eager decode's {eager.tolist()}")
            check(torch.equal(engine.logits, last),
                  f"lm serve {arch} {codec}: the captured decode's last logits differ from "
                  "the eager decode's")
            _, e_decode_ms, e_gen_ms = _decode_ms(torch, _eager_call(bundle, params, prompts))
            del params, eager, last
            mix_dev = ""
            if codec != "fp32":
                # kernel 4 / 7 alone at the LM mix shape (device ms by CUDA
                # events, after the launches above were read), beside its
                # bound and torch.matmul of u by the fp32-decoded plane
                # where that (S, Xp) fp32 plane fits beside the server
                sc = server.plane_scale
                xp = sc.shape[1] * server.qblock
                if codec == "int8":
                    mix_name, mix = "gossip_mix_dequant", lambda: gm.gossip_mix_dequant(
                        u, server.plane_q, sc, qblock=server.qblock)
                else:
                    mix_name, mix = "mixture_mix_dequant4", lambda: gm.mixture_mix_dequant4(
                        u, server.plane_packed, sc, qblock=server.qblock)
                b_ms, b_by = bound(sc.shape[0], xp, mix_name, m=lm_b, qblock=server.qblock)
                out = mix()
                mix_err, mix_plain_ms = _mix_against_plain(torch, gm, mix_name, server, u, out)
                check(mix_err <= TOL, f"lm serve {arch} {codec}: {mix_name} max abs err "
                                      f"{mix_err} > {TOL} against its plain version")
                del out
                mix_ms_dev = time_ms(mix, 3)
                chunks = 4 * sc.shape[0] * xp >= 24e9   # the decoded plane does not fit
                if chunks:
                    lib_ms = _library_mix_ms_in_chunks(torch, gm, mix_name, server, u)
                else:
                    decoded = _decoded_plane(torch, server)
                    lib_ms = time_ms(lambda: torch.matmul(u, decoded), 3)
                    del decoded
                lib = f"{lib_ms:.3f} (torch.matmul of u by the fp32-decoded plane" + (
                    f", in chunks of {PLAIN_MIX_COLUMNS} columns)" if chunks else ")")
                mix_dev = (f"mix_device_ms {mix_ms_dev:.3f} mix_max_abs_err {mix_err} "
                           f"mix_plain_ms {mix_plain_ms:.3f} mix_bound_ms {b_ms:.3f} "
                           f"mix_library_ms {lib}; {b_by}, {mix_name}, B={lm_b} "
                           f"S={sc.shape[0]} Xp={xp}) ")
                mix_rows[mix_name].append(dict(
                    m=lm_b, n=sc.shape[0], x=LM_ARCHS[arch], xp=xp, qblock=server.qblock,
                    max_abs_err=mix_err, ms=mix_ms_dev, plain_ms=mix_plain_ms,
                    plain_in_chunks_of=PLAIN_MIX_COLUMNS, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, variant=f"lm mix {arch}",
                    **({"library_in_chunks_of": PLAIN_MIX_COLUMNS} if chunks else {})))
                del mix
            with _PlainLMKernels():
                plain = server.generate(u, prompts, gen=LM_GEN)
            verdict, flip_ok = _first_flip(torch, server, bundle, u, prompts, toks, plain)
            drops = ""
            if arch_cfg.n_experts > 0:
                per_layer = _prefill_drops(torch, server, bundle, u, prompts)
                check(len(per_layer) == arch_cfg.n_layers and all(
                    c == int(max(1, arch_cfg.capacity_factor * arch_cfg.top_k * LM_PROMPT
                                 / arch_cfg.n_experts)) for _, _, c in per_layer),
                      f"lm serve {arch} {codec}: MoE prefill routings {per_layer}")
                drops = (f"prefill capacity {per_layer[0][2]} slots an expert, dropped "
                         f"(token, expert) pairs per layer of {per_layer[0][1]}: "
                         f"{json.dumps([d for d, _, _ in per_layer])} ")
            want = {k.__name__: 0 for k in kernels}
            want.update(_lm_launches(arch_cfg))
            if codec == "int8":
                want["gossip_mix_dequant"] = 1
            if codec == "int4":
                want["mixture_mix_dequant4"] = 1
            print(f"lm serve {arch} {codec}: prefill_ms {prefill_ms:.3f} "
                  f"decode_ms_per_token {decode_ms:.4f} eager_decode_ms_per_token "
                  f"{e_decode_ms:.4f} decode_tok_s {lm_b / decode_ms * 1e3:.1f} eager_decode_tok_s "
                  f"{lm_b / e_decode_ms * 1e3:.1f} tok_s {lm_b * LM_GEN / gen_ms * 1e3:.1f} "
                  f"eager_tok_s {lm_b * LM_GEN / (mix_ms + e_gen_ms) * 1e3:.1f} "
                  f"generate_ms {gen_ms:.3f} "
                  f"(B={lm_b}, prompt {LM_PROMPT}, gen {LM_GEN}; medians of 3) capture_ms "
                  f"{engine.capture_ms:.1f} n_compiles {server.n_compiles} mix_ms {mix_ms:.3f} "
                  f"{mix_dev}plane_bytes {server.plane_bytes} max_memory_allocated {peak} "
                  f"build_s {build_s:.2f} {drops}captured vs eager: equal tokens and last "
                  f"logits; tokens vs plain: {verdict} launches {json.dumps(counts)} tokens[0] "
                  f"{json.dumps(toks[0].tolist())}", flush=True)
            check(tuple(toks.shape) == (lm_b, LM_GEN) and int(toks.min()) >= 0
                  and int(toks.max()) < arch_cfg.vocab,
                  f"lm serve {arch} {codec}: tokens {tuple(toks.shape)} out of range")
            check(counts == want, f"lm serve {arch} {codec}: launches {counts}, expected {want}")
            check(flip_ok, f"lm serve {arch} {codec}: kernel and plain tokens differ, "
                           f"{verdict}: not a bf16 near-tie")
            del server, engine, toks, plain, bundle
        if arch in LM_NEW:
            t_new += time.perf_counter() - t_arch
    _free(torch)
    print(f"lm serve phase, the MoE and hybrid archs ({', '.join(LM_NEW)}): {t_new:.1f} s",
          flush=True)
    return total, mix_rows


def _span_profile(torch, prof, wall_ms: float) -> dict:
    """The decode tokens of a profiled run (``DECODE_SPAN``): device ms and
    kernels a token (medians), the busy share against ``wall_ms``, the
    unprofiled decode ms a token, and the kernels of all tokens by time."""
    from repro_torch.serve.server import DECODE_SPAN

    windows = _round_kernels(prof, DECODE_SPAN)
    check(len(windows) == LM_GEN and all(windows),
          f"lm profile: {len(windows)} decode spans with device work, expected {LM_GEN}")
    dev = statistics.median(sum(k.time_range.elapsed_us() for k in w) / 1e3 for w in windows)
    by_name: dict = {}
    for w in windows:
        for k in w:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.time_range.elapsed_us() / 1e3
    return {"device_ms": dev, "kernels": statistics.median(len(w) for w in windows),
            "busy": dev / wall_ms,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def phase_lm_profile(torch) -> None:
    """Where a decode token's time goes: one LM_GEN-token int8 generate of
    each LM model under torch.profiler, captured (each token one replay)
    and eager, its tokens cut out by their ``DECODE_SPAN``; each engine's
    device ms a token over its unprofiled decode ms a token (medians of 3
    in the same phase) is its busy share."""
    from repro_torch.serve.server import decode_eager

    for arch in LM_ARCHS:
        _free(torch)
        _, bundle, server, u, prompts = _lm_server(torch, arch, "int8")
        for g in (1, LM_GEN):          # each key's first call captures its decode
            server.generate(u, prompts, gen=g)
        _, decode_ms, _ = _decode_ms(torch, _captured_call(server, u, prompts))
        with _profiler() as prof:
            server.generate(u, prompts, gen=LM_GEN)
        cap = _span_profile(torch, prof, decode_ms)
        params = _eager_params(torch, server, u)
        _, e_decode_ms, _ = _decode_ms(torch, _eager_call(bundle, params, prompts))
        with _profiler() as prof:
            decode_eager(bundle, params, prompts, gen=LM_GEN)
            torch.cuda.synchronize()
        eager = _span_profile(torch, prof, e_decode_ms)
        for label, p, ms in (("captured", cap, decode_ms), ("eager", eager, e_decode_ms)):
            print(f"lm profile {arch} int8 {label} decode (gen {LM_GEN}, B={prompts.shape[0]}): "
                  f"device_ms_per_token {p['device_ms']:.4f} kernels_per_token "
                  f"{p['kernels']} decode_ms_per_token {ms:.4f} (unprofiled, median of 3) "
                  f"device_busy_share {p['busy']:.4f}", flush=True)
        for name, ms in cap["top"]:
            print(f"lm profile {arch} captured kernel {ms / LM_GEN:.4f} ms a token "
                  f"{name[:100]}", flush=True)
        del server, bundle, params
    _free(torch)


def _timed_call(torch, fn) -> float:
    """Host milliseconds of one call to device completion."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_lm_cli() -> None:
    """``python -m repro_torch.launch.serve`` at full width, once, with
    ``--telemetry-out``: its serve events read back and rendered by the
    port's ``summary_table`` (the telemetry path's serve log)."""
    from repro_torch.telemetry import read_events, summary_table

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmo-1b",
               "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--codec", "int8",
               "--mixture", "0.7,0.3", "--telemetry-out", out]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        lines = r.stdout.strip().splitlines()
        print("lm cli: " + " | ".join(lines[:2]), flush=True)
        check(r.returncode == 0, f"launch.serve exited {r.returncode}: {r.stderr[-2000:]}")
        check(any(line.startswith("generated 16 tokens") for line in lines),
              "launch.serve printed no generation line")
        events = read_events(out)
    kinds = [e["event"] for e in events]
    check(kinds == ["serve_meta", "serve_batch", "serve_summary"],
          f"launch.serve --telemetry-out wrote events {kinds}")
    summ = events[-1]
    check(summ["codec"] == "int8" and summ["n_compiles"] == 1 and summ["dequant_calls"] == 1
          and summ["requests"] == LM_B and summ["p50_ms"] > 0,
          f"launch.serve --telemetry-out: serve_summary {summ}")
    table = summary_table(events)
    check("| int8 |" in table, "the serve log's summary table has no int8 row")
    print(f"telemetry serve (launch.serve --telemetry-out): {json.dumps(summ)}", flush=True)
    for line in table.strip().splitlines():
        print(f"telemetry serve table {line}", flush=True)


def _train(torch, gm, argv, on_round=None) -> tuple[dict, dict]:
    """``launch.train.main(argv)`` on the card with every launch counter
    (kernels 1-7, 8, 9) set to 0 just before and read just after: (the
    run's outcome, the launches)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.train import main as train_main

    _free(torch)
    counted = gm.KERNELS + (flash_attention, ssd_scan)
    gm.reset_launch_counts()
    flash_attention.launches = ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = train_main(argv, on_round=on_round)
    return res, {k.__name__: k.launches for k in counted}


def _median_rounds(ms: list, rounds=None) -> float:
    """The median round ms of rounds 2 on (indices in ``rounds`` only)."""
    return statistics.median(v for i, v in enumerate(ms) if i and (rounds is None or i in rounds))


def _train_kernel_rows(torch, gm) -> tuple[dict, dict]:
    """Kernel 1 at T1's exchange, (N, X) = (4, TRAIN_X), and kernel 4 at
    its int8 exchange (M = N = 4, Xp = TRAIN_X, block 256), each against
    its plain version, timed by CUDA events beside its bound, its plain
    version and (kernel 1) one ``torch.matmul``."""
    from repro_torch.comm.codecs import Channel, CommConfig

    _free(torch)
    g = torch.Generator(device="cuda").manual_seed(31)
    n, x = 4, TRAIN_X
    w = torch.rand((n, n), generator=g, device="cuda")
    w = w / w.sum(dim=1, keepdim=True)
    c = 0.05 * torch.randn((n, x), generator=g, device="cuda")
    out = gm.gossip_mix_flat(w, c)
    err = float((out - gm.gossip_mix_flat_ref(w, c)).abs().max())
    check(err <= TOL, f"gossip_mix_flat N={n} X={x}: max abs err {err} > {TOL}")
    del out
    b_ms, b_by = bound(n, x, "gossip_mix_flat")
    flat = dict(n=n, x=x, max_abs_err=err, variant="train lm (mamba2-370m)",
                ms=time_ms(lambda: gm.gossip_mix_flat(w, c), 20),
                plain_ms=time_ms(lambda: gm.gossip_mix_flat_ref(w, c), 5),
                library_ms=time_ms(lambda: torch.matmul(w, c), 20),
                bound_ms=b_ms, bound_by=b_by)
    enc = Channel(CommConfig(codec="int8", block=QBLOCK), x).encode(c, rounding="nearest")
    q, sc = enc["q"].contiguous(), enc["scale"].contiguous()
    del c, enc
    _free(torch)
    xp = sc.shape[1] * QBLOCK
    out = gm.gossip_mix_dequant(w, q, sc, qblock=QBLOCK)
    err = float((out - gm.gossip_mix_dequant_ref(w, q, sc, qblock=QBLOCK)).abs().max())
    check(err <= TOL, f"gossip_mix_dequant M=N={n} Xp={xp}: max abs err {err} > {TOL}")
    del out
    _free(torch)
    b_ms, b_by = bound(n, xp, "gossip_mix_dequant", m=n, qblock=QBLOCK)
    dequant = dict(m=n, n=n, x=x, xp=xp, qblock=QBLOCK, max_abs_err=err,
                   variant="train lm int8 (mamba2-370m)",
                   ms=time_ms(lambda: gm.gossip_mix_dequant(w, q, sc, qblock=QBLOCK), 20),
                   plain_ms=time_ms(lambda: gm.gossip_mix_dequant_ref(w, q, sc, qblock=QBLOCK),
                                    3),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del w, q, sc
    _free(torch)
    for name, r in (("gossip_mix_flat", flat), ("gossip_mix_dequant", dequant)):
        print(f"kernel {name} " + json.dumps(r), flush=True)
    return {"gossip_mix_flat": [flat]}, {"gossip_mix_dequant": [dequant]}


def _cpu_state(torch, res) -> dict:
    """The final plane, u and bytes on the host, and the final loss."""
    st = res["state"]
    return {"plane": st.centers.cpu(), "u": st.u.cpu(), "comm": st.comm_bytes.cpu(),
            "loss": res["final_loss"]}


def _same_train(torch, a: dict, b: dict) -> bool:
    return (bool(torch.equal(a["plane"], b["plane"])) and bool(torch.equal(a["u"], b["u"]))
            and bool(torch.equal(a["comm"], b["comm"])) and a["loss"] == b["loss"])


def _train_t1(torch, gm, card: str, launches: dict) -> None:
    """T1: FedSPD on mamba2-370m at full width, TRAIN_ROUNDS on the loop,
    then the same seed replayed (``--scan-rounds``): bit for bit the loop's
    final plane, u, bytes and loss. The replay's last round is traced (the
    ``_windowed`` pattern: the profiler starts a round early, that round
    is dropped)."""
    argv = ["--arch", TRAIN_ARCH, "--rounds", str(TRAIN_ROUNDS)] + TRAIN_ARGS
    loop, counts = _train(torch, gm, argv)
    check(counts["gossip_mix_flat"] == TRAIN_ROUNDS,
          f"train T1 loop: gossip_mix_flat launched {counts['gossip_mix_flat']} times, "
          f"expected {TRAIN_ROUNDS}")
    check(counts["flash_attention"] == counts["ssd_scan"] == 0,
          f"train T1: the training route launched kernel 8 or 9: {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    spec = loop["pack_spec"]
    check(spec.size == TRAIN_X, f"train T1: X {spec.size}, expected {TRAIN_X}")
    peak_loop = (loop["max_memory_allocated"], loop["max_memory_reserved"])
    want = _cpu_state(torch, loop)
    check(math.isfinite(want["loss"]), f"train T1: final loss {want['loss']} not finite")
    check(bool(torch.isfinite(want["plane"]).all()), "train T1: the final plane is not finite")
    loop_ms = loop["round_ms"]
    del loop

    prof = _profiler()   # on over the last two rounds; the first of them dropped

    def on_round(r):
        if r == TRAIN_ROUNDS - 3:
            prof.start()
        elif r == TRAIN_ROUNDS - 1:
            prof.stop()

    rep, rcounts = _train(torch, gm, argv + ["--scan-rounds"], on_round)
    windows = _round_kernels(prof, span="repro/round")
    check(len(windows) == 2, f"train T1: the traced window holds {len(windows)} rounds, expected 2")
    kern = windows[-1]
    dev_ms = sum(k.time_range.elapsed_us() for k in kern) / 1e3
    exch = sum(1 for k in kern if _is_exchange(k.name))
    check(exch == 1, f"train T1 replay: {exch} exchange kernels in the traced round, expected 1")
    got = _cpu_state(torch, rep)
    same = _same_train(torch, want, got)
    check(same, "train T1: the replay's final plane, u, bytes or loss differ from the loop's")
    rep_ms = rep["round_ms"]
    free = _median_rounds(rep_ms, range(1, TRAIN_ROUNDS - 2))
    print(f"train T1 {TRAIN_ARCH} (X {spec.size:,}, N 4, S 2, b 4, L 64; {card}): round_ms "
          f"loop median(rounds 2-{TRAIN_ROUNDS}) {_median_rounds(loop_ms):.2f} all "
          f"{json.dumps([round(v, 2) for v in loop_ms])}; replay median(rounds 2-"
          f"{TRAIN_ROUNDS}) {_median_rounds(rep_ms):.2f} (untraced rounds 2-{TRAIN_ROUNDS - 2}: "
          f"{free:.2f}) all {json.dumps([round(v, 2) for v in rep_ms])} (round 1: warm-up "
          f"on a copy, capture, replay); n_captures {rep['n_captures']}", flush=True)
    print(f"train T1 replayed round {TRAIN_ROUNDS} traced: device_ms {dev_ms:.2f} kernels "
          f"{len(kern)} busy {dev_ms / free:.4f} exchange kernels {exch}; peak GiB loop "
          f"{peak_loop[0] / 2**30:.2f} / {peak_loop[1] / 2**30:.2f}, replay "
          f"{rep['max_memory_allocated'] / 2**30:.2f} / "
          f"{rep['max_memory_reserved'] / 2**30:.2f} (allocated / reserved); final loss "
          f"{want['loss']:.6f}; launches loop {json.dumps(counts)} replay (warm-up and "
          f"capture) {json.dumps(rcounts)}; replay = loop (plane, u, bytes, loss): "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    top: dict = {}
    for k in kern:
        top[k.name] = top.get(k.name, 0.0) + k.time_range.elapsed_us() / 1e3
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        print(f"train T1 traced kernel {ms:.3f} ms {name[:100]}", flush=True)
    del rep, want, got
    _free(torch)


def _train_full(torch, gm, card: str, launches: dict) -> None:
    """T2: T1's arch with int8 + error feedback on the loop (kernel 4 a
    round; wire = logical × the static ratio); T3: gemma3-1b (26 layers,
    per-layer windows) at N = 2, S = 2 on the loop."""
    x = TRAIN_X
    wire_per_msg = x + 4 * (x // QBLOCK)      # int8 quanta and one fp32 scale a block
    for label, argv, kernel, n_rounds in (
            ("T2 int8+ef", ["--arch", TRAIN_ARCH, "--rounds", "2", "--codec", "int8",
                            "--error-feedback"] + TRAIN_ARGS, "gossip_mix_dequant", 2),
            ("T3 gemma3-1b", ["--arch", "gemma3-1b", "--rounds", "2"] + TRAIN_ARGS
             + ["--clients", "2"], "gossip_mix_flat", 2)):
        res, counts = _train(torch, gm, argv)
        check(counts[kernel] == n_rounds,
              f"train {label}: {kernel} launched {counts[kernel]} times, expected {n_rounds}")
        check(counts["flash_attention"] == counts["ssd_scan"] == 0,
              f"train {label}: the training route launched kernel 8 or 9: {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        spec, logical = res["pack_spec"], res["comm_bytes"]
        check(math.isfinite(res["final_loss"]), f"train {label}: final loss not finite")
        check(logical > 0 and logical % spec.model_bytes == 0,
              f"train {label}: logical bytes {logical} not whole models of "
              f"{spec.model_bytes}")
        if label.startswith("T2"):
            ratio = wire_per_msg / spec.model_bytes
            check(res["wire_ratio"] == ratio and res["wire_bytes"] == logical * ratio,
                  f"train {label}: wire {res['wire_bytes']} != logical {logical} x "
                  f"{ratio} (int8 quanta + scales over the model's bytes)")
        print(f"train {label} (X {spec.size:,}; {card}): round_ms (round 2) "
              f"{_median_rounds(res['round_ms']):.2f} all "
              f"{json.dumps([round(v, 2) for v in res['round_ms']])}; final loss "
              f"{res['final_loss']:.6f}; logical bytes {logical:.0f} wire "
              f"{res['wire_bytes']:.0f} (ratio {res['wire_ratio']:.6f}); peak GiB "
              f"{res['max_memory_allocated'] / 2**30:.2f} / "
              f"{res['max_memory_reserved'] / 2**30:.2f}; launches {json.dumps(counts)}",
              flush=True)
        del res
        _free(torch)


def _train_smoke(torch, gm, launches: dict) -> None:
    """T4: every flag at smoke size on the card: olmo-1b, zamba2-1.2b and
    olmoe-1b-7b, sparse 0.2 + int8 + EF (kernels 5 and 6), the pytree
    engine (kernel 1 a leaf) and the heterogeneity flags, each on the loop
    and replayed, bit for bit; the JSONL log rendered by the port's
    ``summary_table``; ``--save``'s manifest; the int8 servable artifact
    answered by ``launch.serve --artifact``."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.telemetry import read_events, summary_table
    from repro_torch.utils.pytree import state_tensors, tree_leaves

    het = ["--time-budget", "1.5", "--slow-fraction", "0.5", "--p-unavailable", "0.2",
           "--staleness-gamma", "0.5"]
    runs = (("olmo-1b", [], {"gossip_mix_flat": 4}),
            ("zamba2-1.2b", [], {"gossip_mix_flat": 4}),
            ("olmoe-1b-7b", [], {"gossip_mix_flat": 4}),
            ("olmo-1b", ["--sparse-density", "0.2", "--codec", "int8", "--error-feedback"],
             {"gossip_mix_sparse": 4, "gossip_mix_dequant_masked": 4}),
            ("olmo-1b", ["--pytree"], None),
            ("gemma3-1b", het, {"gossip_mix_flat": 4}))
    flags = ("--telemetry-out", "--save", "--export-servable")
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, n) for n in ("t.jsonl", "ckpt.npz", "art.npz")]
        for i, (arch, extra, want) in enumerate(runs):
            argv = ["--arch", arch] + TRAIN_SMOKE + TRAIN_ARGS + extra
            # the first run also writes its log, checkpoint and int8 artifact
            out = [v for f, p in zip(flags, files) for v in (f, p)] + [
                "--export-codec", "int8"] if i == 0 else []
            loop, counts = _train(torch, gm, argv + out)
            if want is None:   # the pytree engine: kernel 1 once a leaf
                want = {"gossip_mix_flat": 4 * len(tree_leaves(loop["state"].centers))}
            for k, v in want.items():
                check(counts[k] == v, f"train T4 {arch} {extra}: {k} launched {counts[k]} "
                                      f"times, expected {v}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            rep, _ = _train(torch, gm, argv + ["--scan-rounds"])
            same = (all(bool(torch.equal(a, b)) for a, b in zip(
                state_tensors(loop["state"]), state_tensors(rep["state"])))
                and loop["final_loss"] == rep["final_loss"])
            check(same, f"train T4 {arch} {extra}: the replay differs from the loop")
            print(f"train T4 {arch} {' '.join(extra) or 'plane'}: final loss "
                  f"{loop['final_loss']:.6f} launches "
                  f"{json.dumps({k: v for k, v in counts.items() if v})} n_captures "
                  f"{rep['n_captures']}; replay = loop: equal", flush=True)
            if i == 0:
                events = read_events(files[0])
                kinds = [e["event"] for e in events]
                check(kinds == ["run_meta"] + ["round"] * 4 + ["summary"],
                      f"train T4: --telemetry-out wrote events {kinds}")
                table = summary_table(events)
                check("| consensus |" in table, "train T4: the summary table has no consensus row")
                man = ckpt.read_manifest(files[1])
                check((man.kind, man.arch, man.n_clients, man.n_clusters, man.pack_digest)
                      == ("checkpoint", "olmo-1b", 4, 2, loop["pack_spec"].digest),
                      f"train T4: --save manifest {man}")
                toks = serve_main(["--arch", "olmo-1b", "--smoke", "--artifact", files[2],
                                   "--codec", "int8", "--client", "0", "--gen", "4"])
                check(tuple(toks.shape) == (4, 4), f"train T4: served tokens {tuple(toks.shape)}")
                print(f"train T4 files: {len(events)} events rendered "
                      f"({len(table.splitlines())} lines); manifest {man.to_json()}; "
                      f"artifact served {tuple(toks.shape)} tokens", flush=True)
            del loop, rep
    _free(torch)


def phase_train(torch, gm, card: str) -> tuple[dict, dict, dict]:
    """Phase "train": ``python -m repro_torch.launch.train``'s ``main`` (T1
    to T4) and kernels 1 and 4 at its full-width exchange. Returns (the
    loop runs' launches, kernel 1's new rows, kernel 4's)."""
    t = time.perf_counter()
    launches: dict = {}
    flat_rows, dequant_rows = _train_kernel_rows(torch, gm)
    _train_t1(torch, gm, card, launches)
    _train_full(torch, gm, card, launches)
    _train_smoke(torch, gm, launches)
    print(f"train phase: {time.perf_counter() - t:.1f} s", flush=True)
    return launches, flat_rows, dequant_rows


MESH_M1_ROUNDS = 3
MESH_M2_ARGS = ["--arch", "mamba2-370m", "--clients", "1", "--clusters", "2", "--batch", "4",
                "--seq", "64", "--rounds", "2"]


def _mesh_m1(torch, mesh, card: str) -> None:
    """M1: the mlp plane at N = 1, S = 2 (dim 64, 10 classes, 256 points),
    MESH_M1_ROUNDS full-regime rounds of ``make_fedspd_train_step(mesh=...)``
    on ``shard_plane_state`` against the one-device round on a copy of the
    same state (batch indices injected; each draws its own selections):
    plane, u and comm_bytes bit for bit. Then ``decode_attention`` over
    the mesh's "data" dim against ``axis_name=None`` on olmo-1b's smoke
    shapes, bit for bit."""
    import types

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.fedspd import FedSPDConfig, init_state, make_round_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.core.packing import make_pack_spec
    from repro_torch.data.synthetic import make_mixture_classification
    from repro_torch.experiments.runner import _copy_state
    from repro_torch.graphs.topology import make_graph
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import HBM_BYTES, use_mesh
    from repro_torch.launch.steps import make_fedspd_train_step
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.smallnets import make_classifier

    dev = torch.device("cuda")
    data = make_mixture_classification(n_clients=1, n_per_client=256)
    train = {"inputs": torch.as_tensor(data.x, device=dev),
             "targets": torch.as_tensor(data.y, device=dev)}
    _, _, loss, pel, _ = make_classifier("mlp", torch.Generator(device=dev), 64, 10)
    spec = make_pack_spec(make_classifier("mlp", torch.Generator(device=dev), 64, 10)[0])
    fcfg = FedSPDConfig(n_clients=1, n_clusters=2)
    gossip = GossipSpec.from_graph(make_graph("er", 1, 5.0, seed=0))
    state = init_state(torch.Generator(device=dev).manual_seed(0),
                       lambda g: make_classifier("mlp", g, 64, 10)[0], fcfg, data_m=256,
                       spec=spec)
    one = _copy_state(state)
    placed = shd.shard_plane_state(state, mesh)
    del state
    single = make_round_step(loss, pel, gossip, fcfg, pack_spec=spec)
    step = make_fedspd_train_step(types.SimpleNamespace(loss=loss, per_example_loss=pel),
                                  gossip, fcfg, pack_spec=spec, mesh=mesh)
    g_idx = torch.Generator(device=dev).manual_seed(1)
    ms = {"mesh": [], "one": []}
    for _ in range(MESH_M1_ROUNDS):
        idx = torch.randint(0, 256, (fcfg.tau, 1, fcfg.batch), generator=g_idx, device=dev)
        t = time.perf_counter()
        one, m_one = single(one, train, idx=idx)
        torch.cuda.synchronize()
        ms["one"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        placed, m_mesh = step(placed, train, idx=idx)
        torch.cuda.synchronize()
        ms["mesh"].append((time.perf_counter() - t) * 1e3)
        check(torch.equal(m_one["selected"], m_mesh["selected"]),
              "mesh M1: the mesh round drew other selections than the one-device round")
        check(torch.equal(m_one["consensus"], m_mesh["consensus"]),
              "mesh M1: the consensus differs from the one-device round's")
    loc = shd.local_state(placed)
    check(loc.centers.shape == one.centers.shape and loc.centers.is_cuda,
          f"mesh M1: local plane {tuple(loc.centers.shape)}")
    for f in ("centers", "u", "comm_bytes"):
        check(torch.equal(getattr(loc, f), getattr(one, f)),
              f"mesh M1: {f} differs from the one-device round's after {MESH_M1_ROUNDS} rounds")
    print(f"mesh M1 mlp N=1 S=2 X={spec.size} ({card}): {MESH_M1_ROUNDS} rounds on the (1, 1) "
          f"NCCL mesh equal the one-device rounds bit for bit (plane, u, comm_bytes "
          f"{float(loc.comm_bytes)}, selections, consensus); round ms mesh "
          f"{[round(v, 3) for v in ms['mesh']]} one-device {[round(v, 3) for v in ms['one']]}",
          flush=True)

    cfg = get_smoke_config("olmo-1b")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((4, 1, cfg.n_heads, cfg.head_dim), generator=g, device=dev)
    kc, vc = (torch.randn((4, 64, cfg.n_kv_heads, cfg.head_dim), generator=g, device=dev)
              for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        for w in (None, 16):
            args = (q.to(dtype), kc.to(dtype), vc.to(dtype), torch.tensor(40, device=dev))
            want = decode_attention(*args, window=w)
            with use_mesh(mesh):
                got = decode_attention(*args, window=w, axis_name="data")
            check(torch.equal(got, want),
                  f"mesh M1: decode_attention(axis_name='data') {dtype} window {w} differs")
    total = torch.cuda.get_device_properties(0).total_memory
    print("mesh M1 decode_attention(axis_name='data') on olmo-1b smoke shapes (B 4, Lc 64, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}; fp32, bf16; window None, "
          "16) equals axis_name=None bit for bit", flush=True)
    print(f"mesh HBM_BYTES read: torch.cuda.get_device_properties(0).total_memory {total} "
          f"({card}); launch/mesh.py HBM_BYTES {HBM_BYTES}", flush=True)


def _mesh_m2(torch, mesh, card: str) -> None:
    """M2: ``launch/train.py`` on mamba2-370m at full width (X =
    420,136,448), N = 1, S = 2, b = 4, L = 64, 2 loop rounds, with
    ``--mesh`` on the (1, 1) NCCL mesh against the same run on one
    device: final plane, u, bytes and loss bit for bit; round ms (the
    second round) and peak memory of both."""
    from repro_torch.launch.sharding import local_state
    from repro_torch.launch.train import main as train_main

    _free(torch)
    one = train_main(MESH_M2_ARGS)
    keep = {"plane": one["state"].centers, "u": one["state"].u,
            "comm": one["state"].comm_bytes, "loss": one["final_loss"],
            "ms": one["round_ms"], "alloc": one["max_memory_allocated"],
            "reserved": one["max_memory_reserved"]}
    del one
    _free(torch)
    res = train_main(MESH_M2_ARGS + ["--mesh", "pod"], mesh=mesh)
    loc = local_state(res["state"])
    check(loc.centers.shape == keep["plane"].shape == (2, 1, TRAIN_X),
          f"mesh M2: plane {tuple(loc.centers.shape)}")
    same = (bool(torch.equal(loc.centers, keep["plane"])) and bool(torch.equal(loc.u, keep["u"]))
            and bool(torch.equal(loc.comm_bytes, keep["comm"]))
            and res["final_loss"] == keep["loss"])
    check(same, "mesh M2: the mesh run differs from the one-device run")
    check(all(v > 0 for v in res["round_ms"]), f"mesh M2: round ms {res['round_ms']}")
    gib = 2 ** 30
    print(f"mesh M2 mamba2-370m X={TRAIN_X} N=1 S=2 b=4 L=64 ({card}): 2 loop rounds with "
          f"--mesh on the (1, 1) NCCL mesh equal the one-device run bit for bit (plane, u, "
          f"comm_bytes, final loss {res['final_loss']:.6f}); round ms (round 2) mesh "
          f"{res['round_ms'][1]:.2f} one-device {keep['ms'][1]:.2f} (round 1: "
          f"{res['round_ms'][0]:.2f} / {keep['ms'][0]:.2f}); max_memory_allocated GiB mesh "
          f"{res['max_memory_allocated'] / gib:.2f} one-device {keep['alloc'] / gib:.2f}; "
          f"max_memory_reserved GiB mesh {res['max_memory_reserved'] / gib:.2f} one-device "
          f"{keep['reserved'] / gib:.2f}", flush=True)
    del res, loc, keep
    _free(torch)


def phase_mesh(torch, card: str) -> None:
    """Phase "mesh": a process group of one rank over NCCL on the card (a
    ``FileStore`` in a temporary directory), the (1, 1) ("data", "model")
    mesh, M1 and M2, then the group is destroyed so later phases run as
    before. A missing NCCL fails the phase."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    t = time.perf_counter()
    check(dist.is_available() and dist.is_nccl_available(),
          "mesh phase: torch.distributed with NCCL is not available")
    store = tempfile.mkdtemp(prefix="mesh_store_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl", f"mesh phase: backend {dist.get_backend()}")
        mesh = make_test_mesh((1, 1), device_type="cuda")
        _mesh_m1(torch, mesh, card)
        _mesh_m2(torch, mesh, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print("mesh notice: the multi-rank NCCL exchange (send/recv between cards) has not run "
          "on this card (one device, a world of one rank); tests/test_torch_mesh.py holds "
          "it on the CPU over gloo (6 ranks)", flush=True)
    print(f"mesh phase: {time.perf_counter() - t:.1f} s", flush=True)


def _cuda_ms(torch, fn) -> float:
    """Device ms of one call by CUDA events (after a synchronize)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _ragged_flash_rows(torch, counts: dict | None = None) -> list:
    """Kernel 8 at whisper's ragged lengths (RAGGED_FLASH), each row as
    ``_flash_row`` makes it (not causal: SDPA with no mask)."""
    rows = []
    for b, lq, lkv, hq, hkv, hd, causal, dt, label in RAGGED_FLASH:
        q, k, v = _qkv_on_card(torch, b, lq, lkv, hq, hkv, hd, dt, seed=lq + lkv + hd)
        rows.append(_flash_row(torch, q, k, v, causal=causal, window=None,
                               label=f"whisper ragged: {label}", counts=counts))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _greedy(torch, bundle, params, frames, start, gen: int):
    """Prefill (the cross k/v) and ``gen`` greedy decode tokens through the
    launcher's steps: (tokens (B, gen), per-step log-softmax (B, V) list,
    per-step logits list)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = bundle.cfg
    cache = make_prefill_step(bundle)(params, {"frames": frames},
                                      bundle.init_cache(frames.shape[0], gen, device="cuda"))
    decode = make_decode_step(bundle)
    tok, toks, logps, logits = start, [], [], []
    for _ in range(gen):
        out, cache = decode(params, cache, tok)
        lg = out[:, 0, :cfg.vocab].float()
        logits.append(lg)
        logps.append(torch.log_softmax(lg, dim=-1))
        tok = lg.argmax(dim=-1, keepdim=True)
        toks.append(tok)
    return torch.cat(toks, dim=1), logps, logits


def _bf16_steps(torch, a, b) -> float:
    """The largest |a - b| of logit rows as a multiple of one bf16 step (8
    significant bits) at each row's largest magnitude: the resolution the
    bf16 logits are computed to."""
    mag = torch.maximum(a.abs().amax(dim=-1), b.abs().amax(dim=-1)).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs().amax(dim=-1) / step).max())


def _w1_compare(torch, cfg, params, frames, start, forced):
    """W1's checks at ``cfg``'s compute dtype: the kernel route's greedy
    tokens and logits against ``attn_mode="ref"``'s up to the first flip,
    and the teacher-forced decode against ``encdec_forward``'s logits.
    Returns (kernel route tokens, flip verdict, log-softmax errors (route,
    forced), bf16 steps (route, forced), kernel 8 launches (prefill and
    decode tokens, forward))."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import build_model

    bundle, ref_bundle = build_model(cfg), build_model(cfg, attn_mode="ref")
    b = frames.shape[0]
    # the driven run: counters at 0 just before, read just after
    flash_attention.launches = 0
    toks, logps, logits = _greedy(torch, bundle, params, frames, start, WHISPER_GEN)
    prefill_launches = flash_attention.launches
    flash_attention.launches = 0
    full, _ = bundle.forward(params, {"tokens": forced, "frames": frames})
    fwd_launches = flash_attention.launches
    check(all(bool(torch.isfinite(x).all()) for x in logits), "whisper W1: logits not finite")
    ref_toks, ref_logps, ref_logits = _greedy(torch, ref_bundle, params, frames, start,
                                              WHISPER_GEN)
    same = bool(torch.equal(toks, ref_toks))
    upto = WHISPER_GEN if same else int((toks != ref_toks).any(dim=0).nonzero()[0]) + 1
    route_err = max(float((x - y).abs().max()) for x, y in zip(logps[:upto], ref_logps[:upto]))
    route_steps = max(_bf16_steps(torch, x, y) for x, y in zip(logits[:upto], ref_logits[:upto]))
    verdict = "equal"
    if not same:
        step = upto - 1
        row = int((toks[:, step] != ref_toks[:, step]).nonzero()[0])
        tk, tp = int(toks[row, step]), int(ref_toks[row, step])
        a, c = float(logits[step][row, tk]), float(logits[step][row, tp])
        steps = 2.0 ** (math.floor(math.log2(max(abs(a), abs(c), 1e-30))) - 6)
        verdict = (f"first flip at step {step} (request {row}), logit gap {abs(a - c):.4g} "
                   f"(logits {a:.4g}, {c:.4g}; two bf16 steps {steps:.4g})")
        if abs(a - c) > max(BF16_GAP, steps):
            f32 = build_model(cfg.with_overrides(compute_dtype="float32"), attn_mode="ref")
            _, _, f_logits = _greedy(torch, f32, params, frames, start, step + 1)
            top = int(f_logits[step][row].argmax())
            verdict += f"; the fp32 reference picks {top} (kernel run {tk}, ref run {tp})"
            check(top == tk, f"whisper W1 ({cfg.compute_dtype}): kernel and ref tokens "
                             f"differ, {verdict}")
    cache = make_prefill_step(bundle)(params, {"frames": frames},
                                      bundle.init_cache(b, WHISPER_FORCED, device="cuda"))
    decode = make_decode_step(bundle)
    forced_err = forced_steps = 0.0
    for i in range(WHISPER_FORCED):
        out, cache = decode(params, cache, forced[:, i:i + 1])
        got, want = out[:, 0, :cfg.vocab].float(), full[:, i, :cfg.vocab].float()
        forced_err = max(forced_err, float((torch.log_softmax(got, dim=-1)
                                            - torch.log_softmax(want, dim=-1)).abs().max()))
        forced_steps = max(forced_steps, _bf16_steps(torch, got, want))
    return (toks, verdict, (route_err, forced_err), (route_steps, forced_steps),
            (prefill_launches, fwd_launches))


def _whisper_w1(torch, card: str, launches: dict) -> float:
    """W1: whisper-base's prefill and decode steps (``launch/steps``) at
    published width and depth on the card: B = WHISPER_B requests, frames
    ``(B, 1500, 512)`` from a seed, WHISPER_GEN greedy tokens, the kernel
    route against the same steps with ``attn_mode="ref"``; WHISPER_FORCED
    tokens teacher-forced through prefill_cross + decode_step against
    ``encdec_forward``'s logits (kernel 8 in the decoder, causal and
    cross). Both at the configured bf16 compute, where the logits carry 8
    significant bits (held to two bf16 steps at each row's magnitude, the
    tokens to equal or a near-tie flip), and at fp32 compute (kernel 8's
    fp32 kernel), held to 2e-2 in log-softmax. Returns the prefill ms."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import build_model
    from repro_torch.roofline import analysis as rl

    cfg = get_config(WHISPER_ARCH)
    g = torch.Generator(device="cuda").manual_seed(41)
    params = build_model(cfg).init(g)
    b, t, d = WHISPER_B, cfg.encoder_frames, cfg.encoder_d_model
    frames = torch.randn((b, t, d), generator=g, device="cuda")
    start = torch.randint(0, cfg.vocab, (b, 1), generator=g, device="cuda")
    forced = torch.randint(0, cfg.vocab, (b, WHISPER_FORCED), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    toks, verdict, errs, steps, (prefill_launches, fwd_launches) = _w1_compare(
        torch, cfg, params, frames, start, forced)
    peak = torch.cuda.max_memory_allocated()
    check(prefill_launches == cfg.encoder_layers,
          f"whisper W1: kernel 8 launched {prefill_launches} times in a prefill and "
          f"{WHISPER_GEN} decode tokens, expected {cfg.encoder_layers} (the encoder)")
    check(fwd_launches == cfg.encoder_layers + 2 * cfg.n_layers,
          f"whisper W1: kernel 8 launched {fwd_launches} times in encdec_forward, expected "
          f"{cfg.encoder_layers + 2 * cfg.n_layers}")
    launches["flash_attention"] = launches.get("flash_attention", 0) + prefill_launches \
        + fwd_launches
    check(tuple(toks.shape) == (b, WHISPER_GEN) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"whisper W1: tokens {tuple(toks.shape)}")
    check(max(steps) <= 2.0, f"whisper W1 (bf16): kernel vs ref / decode vs forward logits "
                             f"{steps[0]:.3g} / {steps[1]:.3g} bf16 steps apart, over 2")
    f32 = cfg.with_overrides(compute_dtype="float32")
    _, f_verdict, f_errs, _, f_launches = _w1_compare(torch, f32, params, frames, start, forced)
    check(max(f_errs) <= 2e-2, f"whisper W1 (fp32): kernel vs ref / decode vs forward "
                               f"log-softmax max abs err {f_errs[0]:.3g} / {f_errs[1]:.3g} "
                               "> 2e-2")
    launches["flash_attention"] += sum(f_launches)

    # prefill ms and decode ms a token of the configured (bf16) model, CUDA
    # events, medians of 3
    bundle = build_model(cfg)
    prefill_step, decode = make_prefill_step(bundle), make_decode_step(bundle)
    cache = bundle.init_cache(b, WHISPER_GEN, device="cuda")
    prefill_ms = statistics.median(
        _cuda_ms(torch, lambda: prefill_step(params, {"frames": frames}, cache))
        for _ in range(3))

    def tokens():
        cache["pos"].zero_()
        tok = start
        for _ in range(WHISPER_GEN):
            out, _ = decode(params, cache, tok)
            tok = out[:, 0, :cfg.vocab].argmax(dim=-1, keepdim=True)

    decode_ms = statistics.median(_cuda_ms(torch, tokens) for _ in range(3)) / WHISPER_GEN
    x = sum(p.numel() for p in torch.utils._pytree.tree_leaves(params))
    print(f"whisper W1 {WHISPER_ARCH} (X {x:,}; {card}): B={b}, frames ({b}, {t}, {d}), "
          f"{WHISPER_GEN} greedy tokens: prefill_ms {prefill_ms:.3f} decode_ms_per_token "
          f"{decode_ms:.4f} (CUDA events, medians of 3) max_memory_allocated {peak} "
          f"flash_attention launches: prefill {prefill_launches}, encdec_forward "
          f"{fwd_launches}; bf16: tokens vs attn_mode=ref {verdict}, logits "
          f"{steps[0]:.3g} bf16 steps apart (log-softmax max abs err {errs[0]:.4g}); "
          f"teacher-forced {WHISPER_FORCED} tokens vs encdec_forward {steps[1]:.3g} bf16 "
          f"steps (log-softmax {errs[1]:.4g}); fp32 compute: tokens vs ref {f_verdict}, "
          f"log-softmax max abs err {f_errs[0]:.4g}, teacher-forced {f_errs[1]:.4g}; "
          f"tokens[0] {json.dumps(toks[0].tolist())}", flush=True)
    del params, cache
    _free(torch)

    # the dry-run's roofline of the same prefill (meta device, the H100 constants)
    with rl.count_work() as w:
        prefill_step(bundle.init(None), {"frames": torch.empty((b, t, d), device="meta")},
                     bundle.init_cache(b, WHISPER_GEN, device="meta"))
    roof = rl.analyze(arch=WHISPER_ARCH, shape=f"W1 prefill B={b}", step_kind="prefill",
                      mesh_name="one card", chips=1, counts=w)
    print(f"whisper roofline W1 prefill (launch/dryrun's count on the meta device; not "
          f"checked): compute_ms {roof.compute_s * 1e3:.4f} memory_ms "
          f"{roof.memory_s * 1e3:.4f} collective_ms {roof.collective_s * 1e3:.4f} "
          f"({roof.bottleneck}; {roof.flops_per_chip:.4g} FLOPs, {roof.bytes_per_chip:.4g} "
          f"bytes, kernels {json.dumps(w.kernels)}) beside the measured prefill_ms "
          f"{prefill_ms:.3f}", flush=True)
    return prefill_ms


def _whisper_w2(torch, gm, card: str, launches: dict) -> None:
    """W2: ``launch/train.py --arch whisper-base`` (N = 4, S = 2, b = 4, L =
    64, ER degree 2) for WHISPER_ROUNDS loop rounds, then the same seed
    replayed: bit for bit the loop's plane, u, bytes and loss."""
    argv = ["--arch", WHISPER_ARCH, "--rounds", str(WHISPER_ROUNDS)] + TRAIN_ARGS
    loop, counts = _train(torch, gm, argv)
    check(counts["gossip_mix_flat"] == WHISPER_ROUNDS and counts["flash_attention"] == 0,
          f"whisper W2 loop: launches {counts}, expected kernel 1 {WHISPER_ROUNDS} times and "
          "kernel 8 never (the training route)")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    want = _cpu_state(torch, loop)
    check(math.isfinite(want["loss"]), f"whisper W2: final loss {want['loss']} not finite")
    peak = (loop["max_memory_allocated"], loop["max_memory_reserved"])
    loop_ms, x = loop["round_ms"], loop["pack_spec"].size
    del loop
    rep, rcounts = _train(torch, gm, argv + ["--scan-rounds"])
    got = _cpu_state(torch, rep)
    same = _same_train(torch, want, got)
    check(same, "whisper W2: the replay's final plane, u, bytes or loss differ from the loop's")
    print(f"whisper W2 {WHISPER_ARCH} train (X {x:,}, N 4, S 2, b 4, L 64; {card}): round_ms "
          f"loop {json.dumps([round(v, 2) for v in loop_ms])} replay "
          f"{json.dumps([round(v, 2) for v in rep['round_ms']])} (round 1: warm-up, capture, "
          f"replay); peak GiB loop {peak[0] / 2**30:.2f} / {peak[1] / 2**30:.2f}, replay "
          f"{rep['max_memory_allocated'] / 2**30:.2f} / {rep['max_memory_reserved'] / 2**30:.2f}"
          f" (allocated / reserved); final loss {want['loss']:.6f}; launches loop "
          f"{json.dumps(counts)} replay (warm-up and capture) {json.dumps(rcounts)}; replay = "
          f"loop (plane, u, bytes, loss): equal", flush=True)
    del rep, want, got
    _free(torch)


def phase_whisper(torch, gm, card: str, counts: dict | None = None) -> tuple[dict, list]:
    """Phase "whisper": kernel 8 at whisper's ragged lengths (each row with
    its kernel's tensor-core ``counts`` when given), W1 (serving steps)
    and W2 (training). Returns (the launches of W1's driven run and W2's
    loop, kernel 8's ragged rows)."""
    t = time.perf_counter()
    rows = _ragged_flash_rows(torch, counts)
    launches: dict = {}
    _whisper_w1(torch, card, launches)
    _whisper_w2(torch, gm, card, launches)
    print(f"whisper phase: {time.perf_counter() - t:.1f} s", flush=True)
    return launches, rows


def timed(name: str, phase, *args):
    """``phase(*args)``, its seconds printed as ``<name> phase: … s``."""
    t = time.perf_counter()
    out = phase(*args)
    print(f"{name} phase: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package src/repro_torch is not beside {__file__}")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind} (count {torch.cuda.device_count()}), python "
          f"{sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)

    from repro_torch.comm.codecs import CommConfig
    from repro_torch.core.sparse import SparseConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import gossip_mix as gm

    t = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"built {os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas " + line.strip(), flush=True)
    tc_counts = tensor_core_counts(build, lib_path)
    check_tensor_cores(tc_counts)

    rows = timed("kernels", phase_kernels, torch, gm)
    stack_rows = timed("stack kernel", phase_stack_kernel, torch, gm)
    serve_rows = timed("dequant kernels", phase_dequant_kernels, torch, gm)
    sparse_rows = timed("sparse kernels", phase_sparse_kernels, torch, gm)
    timed("agreement", phase_agreement, torch)
    timed("sparse agreement", phase_sparse_agreement, torch)
    launches, (round_ms, dp_round_ms), kept = timed("main path", phase_main_path, torch, gm)
    serve_launches = timed("serve", phase_serve, torch, gm, kept)
    baseline_launches = timed("baselines", phase_baselines, torch, gm)
    baseline_comm_launches = timed("baselines comm", phase_baselines_comm, torch, gm)
    sparse_launches, sparse_round_ms = timed("sparse/comm", phase_sparse_comm_path, torch, gm)
    planes = timed("engines", phase_engines, torch, gm)
    t = time.perf_counter()
    scenario_errs = phase_scenario_agreement(torch, gm)
    scenario_launches = phase_scenarios(torch, gm, card)
    print(f"scenarios phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    variant_launches, variant_rows, conv_round_ms, conv_pair = phase_variants(torch, gm, card)
    print(f"variants phase: {time.perf_counter() - t:.1f} s", flush=True)
    for name, rs in variant_rows.items():
        (serve_rows if name == "gossip_mix_dequant" else rows)[name].extend(rs)
    t = time.perf_counter()
    pytree_launches, pytree_rows, pytree_round, pytree_ms = phase_pytree(
        torch, gm, card, planes, conv_pair)
    print(f"pytree phase: {time.perf_counter() - t:.1f} s", flush=True)
    rows["gossip_mix_flat"].extend(pytree_rows)
    t = time.perf_counter()
    telemetry_launches = phase_telemetry(torch, gm, card)
    print(f"telemetry phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_profile(torch, round_ms)
    phase_profile(torch, dp_round_ms, label="dp", options=DP_OPTIONS)
    phase_profile(torch, conv_round_ms, label="conv", model="conv")
    phase_profile(torch, pytree_ms, label="pytree", param_plane=False)
    phase_profile(torch, sparse_round_ms, label="sparse+int8", sparse=SparseConfig(**SPARSE),
                  comm=CommConfig(codec="int8", error_feedback=True))
    print(f"profile phase: {time.perf_counter() - t:.1f} s", flush=True)
    lm_rows = timed("lm kernels", phase_lm_kernels, torch, tc_counts)
    t = time.perf_counter()
    lm_launches, lm_mix_rows = phase_lm_serve(torch, gm)
    for name, rs in lm_mix_rows.items():
        serve_rows[name].extend(rs)
    phase_lm_profile(torch)
    phase_lm_cli()
    print(f"lm phases: {time.perf_counter() - t:.1f} s", flush=True)
    train_launches, train_flat, train_dequant = phase_train(torch, gm, card)
    phase_mesh(torch, card)
    whisper_launches, whisper_rows = phase_whisper(torch, gm, card, tc_counts)
    lm_rows["flash_attention"].extend(whisper_rows)
    rows["gossip_mix_flat"].extend(train_flat["gossip_mix_flat"])
    serve_rows["gossip_mix_dequant"].extend(train_dequant["gossip_mix_dequant"])

    # every launch on the paths driven on the loop engine: the FedSPD main
    # path (DP off and on), serving, the baselines (uncompressed and
    # compressed), the sparse/comm runs, the scenario runs, the variants'
    # loop and stream runs, the pytree engine's loop runs, the telemetry
    # phase's loop runs with telemetry on and LM generation (the replays
    # launch through the graph, not the wrappers: the engines, scenarios,
    # variants, pytree and telemetry phases count them in their traces)
    for path in (serve_launches, baseline_launches, baseline_comm_launches, sparse_launches,
                 scenario_launches, variant_launches, pytree_launches, telemetry_launches,
                 lm_launches, train_launches, whisper_launches):
        for name, c in path.items():
            launches[name] = launches.get(name, 0) + c
    replaces = {"gossip_mix_flat": "src/repro/kernels/gossip_mix.py:63",
                "gossip_mix_stack": "src/repro/kernels/gossip_mix.py:94",
                "gossip_mix_fused_dp": "src/repro/kernels/gossip_mix.py:448",
                "gossip_mix_dequant": "src/repro/kernels/gossip_mix.py:215",
                "mixture_mix_dequant4": "src/repro/kernels/gossip_mix.py:362",
                "gossip_mix_sparse": "src/repro/kernels/gossip_mix.py:160",
                "gossip_mix_dequant_masked": "src/repro/kernels/gossip_mix.py:290",
                "flash_attention": "src/repro/kernels/flash_attention.py:100",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:94"}
    kernels = []
    for name, rs in rows.items():
        # the main path's own shape; the DP run draws noise (sigma > 0)
        main = next(r for r in rs if r["x"] == SHAPES[0][1] and r.get("sigma", 1) > 0)
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/gossip_mix.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            shape={"n": main["n"], "x": main["x"]}, card=card, shapes=rs,
            **({"pytree_launches": pytree_launches[name], "pytree_round": pytree_round}
               if name == "gossip_mix_flat" else {})))
    # the FedEM exchange's own shape; launches from the baselines path
    main = next(r for r in stack_rows if (r["s"], r["n"], r["x"]) == STACK_SHAPES[0])
    kernels.append(dict(
        name="gossip_mix_stack", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_mix.cu",
        replaces=replaces["gossip_mix_stack"],
        launches=launches["gossip_mix_stack"],
        max_abs_err=max(r["max_abs_err"] for r in stack_rows), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shape={"s": main["s"], "n": main["n"], "x": main["x"]},
        card=card, shapes=stack_rows))
    for name, rs in serve_rows.items():
        # the serving batch of bench_mixture_qps; launches from the serve path
        main = next(r for r in rs if r["m"] == SERVE_B)
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/gossip_mix_dequant.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
            shape={"b": main["m"], "s": main["n"], "x": main["x"], "qblock": main["qblock"]},
            card=card, shapes=rs))
    for name, rs in sparse_rows.items():
        # the sparse exchange's own shape: the mlp, random density-0.2 masks
        main = next(r for r in rs if r["x"] == SPARSE_SHAPES[0][1] and r["layout"] == "random")
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/gossip_mix.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            shape={"n": main["n"], "x": main["x"], "layout": main["layout"]},
            card=card, shapes=rs))
    for name, rs in lm_rows.items():
        # the LM path's own shape: olmo-1b's / mamba2-370m's prefill layer, bf16
        main = rs[0]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            shape={k: main[k] for k in main if k in ("b", "l", "hq", "hkv", "h", "p", "n",
                                                     "hd", "chunk", "dtype")},
            card=card, shapes=rs))
    for k in kernels:
        # the launches on the telemetry phase's loop runs with telemetry on,
        # and on the train phase's loop runs (launch/train.py)
        k["telemetry_launches"] = telemetry_launches.get(k["name"], 0)
        k["train_launches"] = train_launches.get(k["name"], 0)
        k["whisper_launches"] = whisper_launches.get(k["name"], 0)
        if k["name"] in scenario_errs:
            # the same kernel on scenario B's weighted W
            k["scenario_w_max_abs_err"] = scenario_errs[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], scenario_errs[k["name"]])
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
