"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and its seconds:
  0. card check: CUDA present, card name and power limit (nvidia-smi); TF32
     is switched off so the fp32 reference runs are true fp32; whether PIL
     and the libjpeg headers are present;
  1. build: nvcc compiles editor_tpu_torch/csrc/*.cu for sm_90a, one
     process per source, all started together;
  2. kernels: each hand-written kernel (K1-K3 and K6 forward, K4, K5 and K7
     backward, K8 LayerNorm -> matmul -> GELU) against its plain PyTorch
     version at the main paths' shapes in bf16, with kernel, plain and
     library-call times from CUDA events and the bound (the least time the
     card could take) worked out from this run's inputs. K1 is held against
     its plain version in the TPU kernel's form: every probs element within
     one bf16 ulp of the plain value and every row summing to 1, also at
     x30 and at shapes the model does not reach (N = 17, 200, 512; D = 96);
     its time with probs must be at most 2x SDPA's (no probs) in the same run.
     K4, K7 and K5 are also held by the share of their elements more than
     one bf16 ulp off the plain version (at most 0.5% over all of dqkv and
     over the cls rows' dk and dv), a check that must fail the unrounded form
     and, for K4 and K7, the cls-rounded (K5's) form, for K5 the cls-kept
     (K7's, tile 88) form in the same run. K4 also at N = 1, 8, 17,
     129, 200 and 512 (the chunked instance past 144), at D = 96 and D = 32,
     and at N = 512 with D = 96 and 128; its time must be at most 2x the
     SDPA backward's. K7 also at D = 32, an odd batch and a sequence masked but
     for its cls tokens; its time on the two model shapes must be at most 3x
     the SDPA backward's. K3 is held against its plain version in the TPU
     kernel's form (masked_attention_qkv_tpu_plain) by the same share test (at
     most 0.5% of its elements more than one bf16 ulp off), which must fail
     the unrounded form and the XLA form (masked_attention_qkv_plain) in the
     same run, at the two model shapes, x30, the batch-1 shapes and 12 more
     (N = 1-512, D = 32-128); masked query rows must be exact zeros. K5 at
     the same shapes (x30: the scaled error and finite values only); masked
     rows get zero gradient; its time on the two model shapes must be at
     most 2x the SDPA backward's. K6 is held against its plain version in
     the TPU kernel's form (masked_attention_tiled_plain) by the share test
     read twice, over all elements of a batch whose masks keep half the
     patches and over the valid query rows of a sparse batch (every cls
     token and a tenth of the patches kept), which must fail the unrounded
     form (the first reading) and K3's form (cls keys rounded too; the
     second) in the same run, at the uncompacted tail's shapes, x30 and 14
     more (N = 129-512, D = 32-128, tiles of 16, 64 and 128); masked query
     rows must be exact zeros; its time on the two model shapes must be at
     most 2x SDPA's with the key mask. K8 is held by the same share test
     against its plain version at both backbone shapes, which must fail the
     form that leaves the LayerNorm's output in fp32, and on wide inputs
     (pre-activations of ~1.9, biases comparable) the forms that round the
     product before the bias and apply the GELU to a rounded pre-activation;
     also a ragged row count without bias (LayerNorm parameters at a 4-byte
     offset), C = 1040 (a last k slice of 16)
     and C = 96 (one k slice); its time over both shapes must be at most 2x
     the three-call chain's;
  3. forward: the flagship tri-modal eval forward (ViT-B/16, 256x128,
     seeded random weights, B=128, bf16, compact tail) through
     build_eval_step; one forward launches K1 12, K2 1 and K3 2 times, and
     the features match the same model run with the plain ops in fp32
     (per-row cosine >= 0.99, rel-L2 <= 0.08);
  4. serving: FeatureExtractor (with the config's INPUT section) +
     GalleryIndex over 64 synthetic identities;
     queries of 1, 3 and 32 repeated gallery items must each retrieve
     themselves at rank 1; batch-1 p50 latency;
  5. train: the flagship train step (B=128 as 8 ids x 16, uint8 images
     through the augmentation, SGD with the RGBNT201 solver, bf16) through
     build_train_step; one step launches K1 12, K2 1, K3 2, K4 12 and K5 2
     times; over 3 steps the loss stays within 3% of the same model run with
     the plain ops in fp32 (same weights, batch and random draws) and the
     parameter norm within 2%; losses and gradients are finite, the BN stats
     and OCFR centers move; 20 steps on one fixed batch lower the loss; step
     time, img/s and peak memory;
  6. uncompacted: the same model with TPU.COMPACT_TAIL off (129 tokens per
     modality, 387 joint): (a) the eval forward launches K1 12, K2 1, K6 2
     and K3 0 times and matches the plain fp32 run as in phase 3; (b) the
     compact and uncompacted models with the same weights, both plain fp32,
     agree to rel-L2 <= 1e-4 (the compaction is exact); (c) the train step
     launches K1 12, K2 1, K4 12, K6 2, K7 2 and K3, K5 0 times and matches
     the plain fp32 run as in phase 5; (d) its time and memory;
  7. variants: the design-variant kernels T1-T6 of editor_tpu_torch/tools/
     (bench_attn, bench_attn2, bench_attn_layer, bench_rollout,
     bench_rollout2, bench_full_kernel), each at the flagship shape in one
     configuration, against its plain version, with kernel, plain and
     library-call times and the bound. They are on no model path: phases 3-6
     count 0 launches of each (the full sweeps are the tools' own). T1 and
     T2, the kSplit and kNoMax forms of K1's tensor-core body, are held by
     K3's share test on random-normal inputs and on inputs whose cls key
     carries most of each row's weight, which must fail the unrounded form
     (on the first) and the cls-rounded form (on the second) in the same
     run; T1 on separate q, k, v and on the column views of the packed qkv,
     1 and 2 heads and 1 and 2 sequences a block, x30 and B = 3 at N = 200;
     T2 at 1 and 2 sequences a block and B = 3 at N = 512; T1's probs as
     K1's (every element within one bf16 ulp, rows summing to 1); T1 (with
     probs) and T2 at most 2x SDPA's time. T3, whose output end to end is
     chaotic in the qkv product's summation order, is held stage by stage on
     its own workspaces (bench_attn_layer.stage_shares): qkv, attention and
     output each by the share test against the TPU form of the stage's own
     input, the attention equal to K1's on the same qkv, the forms that
     leave y, qkv or the attention in fp32 required to fail; its probs by the
     share test and the row sums, its output end to end by the scaled error;
     equal at g = 1, 2 and 4; B = 3 at N = 200 and D = 32 too; its time
     without probs at most 2x the four-call chain's (LN, linear, SDPA,
     linear). T6, K3 and K5 walking
     g sequences a block at the JAX package's groups (forward 8 and 2,
     backward 4 and 2 at [384, 88] and [128, 264]), must equal K3 and K5 at
     group 0 bit for bit; its forward is held by K3's share test against the
     TPU body's form (which must fail the unrounded and the XLA form in the
     same run), its backward by K5's check and wrong forms (the unrounded and
     the cls-kept form); forward + backward over both shapes at most 2x
     SDPA's forward + backward with the key mask;
  8. loop: the flagship through the training loop, ``cli.train`` ->
     ``do_train`` on in-memory data through a numpy decode_fn, logging,
     evaluating and checkpointing every epoch into a temporary directory
     that it deletes. The checked runs train on 16 ids x 32 items (3 steps
     of 8 ids x 16 an epoch) and evaluate as RGBNT201's test split in size
     (query = gallery = 836 items of 30 ids in 4 cameras: 1672 rows, 27
     batches of 64): (a) every step launches K1 12, K2 1, K3 2, K4 12 and K5
     2 times and every eval batch K1 12, K2 1 and K3 2 times, the run's
     totals these sums; (b) the log, metrics, config.yaml and checkpoints are
     written and the losses are finite; (d) a third epoch resumed from the
     epoch-2 checkpoint against three uninterrupted epochs: losses within
     1e-5 relative, the largest parameter difference and whether it is bit
     for bit printed (the first run saves with TPU.ASYNC_CHECKPOINT at its
     default, True, the resumed one with it off: the loop's stall per save
     both ways, each save call's wall ms); (e) cli.test on the best epoch's checkpoint (alone in
     a directory) gives the mAP the loop logged for that epoch (within
     1e-6); (c) over the features that do_inference handed the evaluator in
     (e), the card's distances within 1e-5 of the CPU evaluator's, and the
     card's CMC equal to and its mAP within 1e-6 of the CPU metric's on the
     card's distances (the CPU evaluator's end to end printed). Printed:
     eval images/s through ``evaluate`` (twice), the metric's ms, a
     checkpoint's save ms and bytes (synchronous; then the same payload saved
     asynchronously, the model and its optimizer slots changed as soon as
     the call returns, the file required equal to the synchronous one), and
     from a run of 2 epochs over 171 ids
     x 3951 items (21 steps an epoch, logging every 10, no evaluation) the
     loop's ms per step (CUDA events between step starts within an epoch,
     the run's first two steps left out: median, mean, p10, p90), the gap
     from a step's last launch to the next one's start (the next batch's
     copy and any idle), the idle share (gaps over intervals) and the loop
     step against phase 5's bare step;
  9. serve: (a) the native C++ re-ranking builds (g++) and matches the numpy
     copy within 1e-5 at 30 x 120; the device re-ranking's core on the card
     matches it within 1e-5 at 836 x 836 (RGBNT201's test split, k1 50, k2
     15) on the same distance matrix; both times, and the device version end
     to end (its own distances) against it, printed; (b) cli.export turns a
     checkpoint of the flagship into a .pth (equal to the checkpoint's
     state_dict), cli.serve.build_service on it indexes RGBNT201's test split
     in size from in-memory data (836 items, each its own random images), and
     a RetrievalServer on 127.0.0.1 answers /healthz, 32 batch-1 /query
     requests for gallery items (each retrieves itself at rank 1, its
     features bit for bit the in-process call's on the decoded images, the 32
     launching K1 12, K2 1 and K3 2 times each), a re-ranked /query (top pid
     its own), /gallery/add and a malformed request (400); HTTP batch-1 p50
     and p99 printed; (c) dump_eval_visualizations on 8 flagship images
     launches K1 12 and K2 1 per modality, and its rollouts (rel-L2 <= 0.05)
     and union token mask (agreement >= 0.9) match the plain fp32 run;
     (d) whether PIL and the libjpeg codec were available. Without PIL the
     requests carry .npy bytes through a swapped decoder and the
     visualisation's overlay arrays are held in place of its PNG files;
 10. dp: data parallelism on an NCCL group of one rank made in this process
     (a FileStore in a temporary directory; the collectives are called and
     counted): (a) the flagship's global-batch step through
     build_train_step(mesh=make_mesh()) for 3 steps equals the single-device
     step from the same weights, batch and generator bit for bit (losses,
     every parameter, BN stats, OCFR centers), each step launching K1 12,
     K2 1, K3 2, K4 12 and K5 2 times; (b) ZeRO-1 equals (a) bit for bit;
     (c) the local-batch step with each of the fp16, bf16, int8 and
     PowerSGD reducers for 3 steps: finite losses, the reducer's output on
     the flagship's first gradients equal to its formula applied without
     communication (fp16, bf16, int8 exactly; PowerSGD within 1e-6 of each
     leaf's largest value), each one's step ms; (d) do_inference(mesh=)
     over RGBNT201's test split in size (as phase 8) equals the
     single-device path (features, CMC, mAP), K1 12, K2 1 and K3 2 launches
     an eval batch, and sharded_cmc_map is within 1e-6 of the evaluator;
     (e) on every machine, two one-card steps (drop path 0, no augmentation,
     identity-like images) as the reference, a probe of bf16 reduction-order
     noise (each identity's instances reversed) whose error must stay under
     a quarter of the limit, and a planted 2x-gradient control that must
     exceed it (the error: | ||dW|| - ||dW_ref|| | / ||dW_ref|| per parameter
     tensor, limit 0.1; the direction ||dW - dW_ref|| / ||dW_ref|| printed);
     with two cards or more, two NCCL ranks (processes of this script,
     ``--dp-rank``) run the global-batch step, their losses within 1% and
     every tensor's error within the limit, and time it; with one card the
     phase says so; (f) the DP step's
     ms against the single-device step's (same call) and phase 5's, the
     gradient all-reduce's ms, peak memory.
 11. fsdp: FSDP (TPU.ZERO_STAGE 3) and the launcher. (a) On an NCCL group
     of one rank in this process, 3 flagship steps through
     build_train_step(state_shardings=fsdp_state_shardings(...),
     gather_params_compute=True) equal the single-device step bit for bit,
     each launching K1 12, K2 1, K3 2, K4 12, K5 2 and calling one
     all-gather and one reduce-scatter more than the global-batch step;
     do_inference(mesh=) inside gathered() equals the single-device model's
     features and mAP; (b) the FSDP step's ms against the global-batch and
     single-device steps', the parameter and slot bytes between steps
     against param_memory_bytes, its MB per device at W = 1, 2, 4, peak
     memory; (c) `python -m editor_tpu_torch.cli.launch --nproc_per_node 1
     --max_restarts 1 -- python chip_smoke.py --launch-worker <dir> 1`
     trains the flagship with FSDP through cli.train on phase 8's data for 2
     epochs; incarnation 0's data fails as epoch 2 starts, after the epoch-1
     checkpoint is committed; the launcher exits 0 with "restarts used: 1",
     incarnation 0's error file names the RuntimeError, and the resumed
     epoch's losses are within 1e-5 relative of an uninterrupted launch's
     run beside it; (d) with two cards or more, two NCCL ranks of this
     script (``--fsdp-rank``) through cli.launch --nproc_per_node 2: the
     FSDP step against the global-batch step tensor by tensor (bit for bit,
     else phase 10 (e)'s gate) and each rank's parameter storage between
     steps equal to param_memory_bytes at W = 2; with one card the phase
     says so.
 12. mp: model parallelism. (a) K1, K4 and K2 at a tensor-parallel rank's
     shapes (H = 6) equal to the 12-head launch's heads; (b) the flagship
     with MODEL.MOE_EXPERTS 8 (phases 3 and 5's checks, the plain fp32 run
     taking the bf16 run's routing); with two cards or more (c) TPU.MESH_MODEL
     2 through cli.launch against one card and (d) expert and sequence
     parallelism on the fusion block (``--tp-rank``, ``--mp-rank``); with
     four cards (e) data 2 x model 2 through cli.launch (``--zero-rank``):
     (c)'s TP step, ZeRO-1 equal to it bit for bit, FSDP within 10 (e)'s
     limit of it (its parameter bytes between steps param_memory_bytes of
     the cut model), PowerSGD on the TP mesh within TP_LOSS_TOL of the
     data-2 DDP step on two cards, every checkpoint canonical; each rank's
     launches, parameter and slot bytes, peak memory and step ms; with two
     cards or more (f) the MoE flagship beside a data axis (``--moe-rank``
     through cli.launch; B = 128 global, bf16, expert 2's router column x5
     so that it overflows): layout (i), the expert group the data group, on
     two ranks and, with four cards, layout (ii), data 2 x expert 2; each
     rank's step (training forward, loss, backward) launches K1-K5 as (b)'s,
     and the step holds to one card's with moe_shards 2 on the global batch
     (loss and mean gradients within MP_TOL, cls4t within phase 3's gates,
     the fp32 plain step within MP_F32_TOL), with each rank's ms, peak
     memory and dropped pairs; the mesh eval forward passes MOE_ROUTE_GATE
     (capacity one card's, drops in the rank's rows within MOE_DROP_TOL of
     one card's, phase 3's gates) and routing each rank's rows alone must
     fail it. ``--phase-12`` runs it alone after the build, ``--phase-12 e``
     only the cases named.
 13. pp: pipeline parallelism. (a) On an NCCL group of one rank (mesh 1 x
     stage 1 x 1), 3 flagship steps (phase 5's batch, augmentation, drop
     path 0.1) through build_train_step(backbone=make_pipeline_backbone(mesh,
     4)) with remat: losses within 3% and the parameter norm within 2% of
     the single-device step and of the plain fp32 pipelined run from the
     same weights, batch and generator; each step launches K1 2 x 12 x 4
     (forward and recompute), K4 12 x 4, K3 2, K5 2 and no K2; the pipelined
     eval forward launches K1 48, K3 2 and no K2, and its features meet
     phase 3's gates against build_eval_step's (the SFTS tokens the two
     rollouts select differently printed); the step's ms and peak memory
     beside the single-device step's. With two cards or more (b) 2 stages,
     and with four (c) 4 stages and 2 stages x 2 model ranks, ranks of this
     script (``--pp-rank``) through cli.launch on phase 10 (e)'s inputs:
     losses within 1% and every tensor's change within 10 (e)'s limit of
     one card's, each rank's launches for its blocks, the step's ms and the
     P2P bytes; with four cards (d) data 2 x stage 2 (``--zero-rank``): the
     dp x pp step against one card as (b), ZeRO-1 equal to it bit for bit
     and FSDP within 10 (e)'s limit, with bytes, peak memory and ms; with
     fewer cards the phase says so. ``--phase-13`` runs it alone after the
     build, ``--phase-13 d`` only the cases named.
 14. configs: the model configurations beyond the flagship's. (a) kernels
     at the stride-12 backbone's N = 211 (K1 with probs, K4, K2 at Z = 4608)
     against their plain versions with phase 2's checks, with times, library
     times and bounds; the flagship with MODEL.STRIDE_SIZE [12, 12] (21 x 10
     patches, N = 211, the tail still compacted to 88 / 264): the eval
     forward launches K1 12, K2 1 and K3 2 times and meets phase 3's gates,
     its frequency mask equals the CPU's on the same images bit for bit; ms,
     img/s, peak memory; (b) its train step at B = 128 launches K1 12, K2 1,
     K3 2, K4 12 and K5 2 times (ms, img/s, peak memory), and phase 5's
     comparison with the plain fp32 run at B = 64 with TPU.REMAT (block),
     which fits the card; (c) phase 5's step under TPU.REMAT with each
     policy (block, dots, names, attn_out; block with REMAT_SKIP_LAST 4)
     against the same step without remat (loss and every parameter's change
     within 1e-3 relative, bit for bit printed, the no-remat step run twice
     for the card's own spread), K1's launches (2 x 12 under block and dots,
     12 under names and attn_out, 20 with the last 4 blocks kept), ms, peak;
     (d) MODEL.ATT_DROP_RATE 0.1, MODEL.DROP_OUT 0.1 with TPU.REMAT: the step
     launches no K1 or K4 (the plain attention) and equals the step without
     remat from the same generator seed within 1e-3, the eval forward
     launches K1 12, the dropped share of the attention weights in a
     training forward within 4 sigma of 0.1, ms; (e) the frequency mask's
     general branch (Haar, J = 4) at 264 x 136, B = 128, on the card against
     the CPU with TF32 switched on around the call (the wavelet module turns
     it off itself): window counts, masks, a db4 / symmetric round trip
     within 1e-5, the mask's ms. ``--phase-14`` runs it alone after the
     build, ``--phase-14 ce`` only the cases named.
 15. library: the surface off the model path. (a) ops/dtcwt at the
     flagship's images ([384, 256, 128, 3] fp32): dtcwt2 at J = 3 in both
     modes and idtcwt2 (round trip within 1e-5 of the input's scale), card
     against CPU within 1e-5 with cuDNN's TF32 switched on around the call;
     scat_layer and scat_layer_j2 and one backward of each (gradients within
     1e-4); ms and peak memory; (b) one flagship train forward at B = 128 (16
     ids x 8; K1 12, K2 1, K3 2) and every auxiliary loss (center, cluster,
     range, hetero-center, multi-modal margin, weighted-regularized triplet,
     label-smoothing CE) on its feature, per-modality features and logits,
     each value and gradient within 1e-4 of f64 on the CPU, their ms; one
     backward of the summed losses (K4 12, K5 2), gradients finite by
     utils.debug; (c) utils.profiling: a trace of the eval forward naming
     K1's kernel, cost_analysis with the kernels = the plain path within 1%
     (beside bench.py's analytic count), benchmark's p50; (d) sharded
     tensors (DTensors) at [world x 8192, 2304] over NCCL, world 1 in this
     process and, with 2-4 cards, that many ranks (``--shard-rank``);
     sharded_rand equal to the world-1 tensor; (e) parallel/rpc in two
     spawned processes (``--rpc-role``): a RemoteModule whose [2304, 171]
     weight lives on the owner's card against the local product within
     1e-5, a DistributedOptimizer step, an RRef fetched through two injected
     drops, the profile's counts, the round trip's p50. ``--phase-15`` runs
     it alone after the build, ``--phase-15 ae`` only the cases named.
The model configs come from load_config(None, RGBNT201_PRESET + overrides)
through editor_config_from. Then one JSON line with each kernel's numbers
(K1-K8, T1-T6; launches by path: compact, uncompacted, loop, serve, dp,
fsdp, mp, pp, stride12, remat, dropout, library; K1, K2 and K4 at N = 211 under
``stride12``), and last the result line {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero without the result line; it does the
same without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

H, C = 12, 768
D = C // H
SCALE = D ** -0.5
FILL = -65504.0
B_EVAL = 128

KERNELS = {
    "attention_qkv": dict(source="editor_tpu_torch/csrc/attention_qkv.cu",
                          replaces="editor_tpu/ops/fused_attention.py:225"),
    "rollout_chain": dict(source="editor_tpu_torch/csrc/rollout_chain.cu",
                          replaces="editor_tpu/ops/rollout.py:88"),
    "masked_attention_qkv": dict(source="editor_tpu_torch/csrc/masked_attention.cu",
                                 replaces="editor_tpu/ops/masked_attention.py:163"),
    "attention_qkv_bwd": dict(source="editor_tpu_torch/csrc/attention_qkv_bwd.cu",
                              replaces="editor_tpu/ops/fused_attention.py:205"),
    "masked_attention_qkv_bwd": dict(source="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                                     replaces="editor_tpu/ops/masked_attention.py:183"),
    "masked_attention_tiled": dict(source="editor_tpu_torch/csrc/masked_attention.cu",
                                   replaces="editor_tpu/ops/masked_attention.py:264"),
    "masked_attention_tiled_bwd": dict(source="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                                       replaces="editor_tpu/ops/masked_attention.py:394"),
    "ln_matmul": dict(source="editor_tpu_torch/csrc/ln_matmul.cu",
                      replaces="editor_tpu/ops/fused_linear.py:75"),
}
# The design-variant kernels T1-T6 (phase 7), each counted where it launches:
# T1-T5 by the wrapper of the same name in their tool module, T6 by K3's and
# K5's launches at a group g >= 1, not the model paths' 0 (launch_counts)
VARIANTS = {
    "headgrid_attn": dict(tool="bench_attn",
                          source="editor_tpu_torch/csrc/attention_variants.cu",
                          replaces="tools/bench_attn.py:68"),
    "nomax_attn": dict(tool="bench_attn2", source="editor_tpu_torch/csrc/attention_variants.cu",
                       replaces="tools/bench_attn2.py:56"),
    "attn_layer": dict(tool="bench_attn_layer", source="editor_tpu_torch/csrc/attn_layer.cu",
                       replaces="tools/bench_attn_layer.py:77"),
    "chain": dict(tool="bench_rollout", source="editor_tpu_torch/csrc/rollout_chain.cu",
                  replaces="tools/bench_rollout.py:71"),
    "chain_multi": dict(tool="bench_rollout2", source="editor_tpu_torch/csrc/rollout_chain.cu",
                        replaces="tools/bench_rollout2.py:64"),
    "masked_full": dict(tool="bench_full_kernel",
                        source="editor_tpu_torch/csrc/masked_attention.cu",
                        source_bwd="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                        replaces="tools/bench_full_kernel.py:33"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_check() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi.splitlines()[0]
    print(card, flush=True)
    import importlib.util

    say("0 card", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off",
        pil=importlib.util.find_spec("PIL") is not None,
        jpeglib_h=os.path.exists("/usr/include/jpeglib.h"))
    return card


def build_phase() -> None:
    from editor_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    say("1 build", seconds=f"{time.perf_counter() - t0:.2f}", lib=_build.library_path().name)


def cuda_ms(fn, iters: int = 10) -> float:
    """ms per call from CUDA events over ``iters`` calls after 2 warm-ups."""
    from editor_tpu_torch.tools import _bench

    return _bench.cuda_ms(fn, iters, warmup=2)


def _max_err(got, ref, scale: float = 1.0) -> float:
    return float(((got.float() - ref.float()).abs() / scale).max())


def _require(name: str, err: float, tol: float) -> None:
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take (``_bench.bound``: bytes over the
    HBM rate or operations over the bf16 tensor-core peak, the larger), with
    the work it was worked out from."""
    from editor_tpu_torch.tools import _bench

    ms, by = _bench.bound(flops, nbytes)
    return dict(bound_ms=ms, bound_by=by, flops=flops, bytes=nbytes)


def _heads(qkv):
    """[B, N, 3C] -> q, k, v head views [B, H, N, D] (no copy)."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


def _sdpa_bwd_ms(qkv, g, key_mask=None) -> float:
    """The backward of one scaled_dot_product_attention call, timed as
    (forward + backward) - forward on contiguous head tensors."""
    F = torch.nn.functional
    q, k, v = (t.contiguous().requires_grad_() for t in _heads(qkv))
    gh = g.view(*g.shape[:2], H, D).transpose(1, 2).contiguous()
    mask = None if key_mask is None else key_mask[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=SCALE)

    both = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), gh))
    return both - cuda_ms(fwd)


def _bf16_ulps(got, ref) -> float:
    """The largest |got - ref| in units of (one bf16 ulp of |ref| at that
    element + 1e-6); at most 1 where every element is the plain value or
    one bf16 step from it."""
    from editor_tpu_torch.tools import _bench

    return float(((got.float() - ref.float()).abs() / (_bench.bf16_ulp(ref) + 1e-6)).max())


def _probs_errors(name: str, probs, ref_probs, own_qkv: bool = False) -> dict:
    """Probs against the plain version's (K1, T1, T3): every element within
    one bf16 ulp of the plain value at that element (the two round the same
    fp32 p and differ only in summation order), or with ``own_qkv`` (T3,
    which makes its qkv itself, where a qkv element rounded the other way
    moves a row's logits and its probs by up to 2 ulps) at most SHARE_TOL of
    the elements more than one bf16 ulp off (``_bench.bf16_off_share``);
    every row sums to 1 within 1e-2. A wrong or missing store of many small
    probabilities, or of a row, fails one of the two."""
    from editor_tpu_torch.tools import _bench

    ulps = _bf16_ulps(probs, ref_probs)
    out = dict(probs_err=_max_err(probs, ref_probs), probs_ulps=ulps)
    if own_qkv:
        out["probs_share"] = _bench.bf16_off_share(probs, ref_probs)
        _require(f"{name} probs share off the plain version", out["probs_share"], SHARE_TOL)
    else:
        _require(f"{name} probs in bf16 ulps", ulps, 1.0)
    out["row_sum_err"] = float((probs.float().sum(-1) - 1.0).abs().max())
    _require(f"{name} probs row sums", out["row_sum_err"], 1e-2)
    return out


def _at_most_2x_sdpa(name: str, ms: float, sdpa_ms: float) -> None:
    """An unmasked forward (K1, T1, T2) must take at most twice the time of
    one SDPA call on the same inputs, timed in the same run."""
    if not ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"{name}: {ms} ms, more than 2x SDPA's {sdpa_ms} ms")


def _k1_errors(name: str, out, probs, ref, scaled: bool = False) -> dict:
    """K1's output and probs against its plain version ``ref`` = (out,
    probs): out within 2e-2 (scaled by its largest magnitude: 1e-2); the
    probs by _probs_errors."""
    ref_out, ref_probs = ref
    e_out = _scaled(out, ref_out) if scaled else _max_err(out, ref_out)
    _require(f"{name} out" + (" (scaled)" if scaled else ""), e_out, 1e-2 if scaled else 2e-2)
    return dict(out_err=e_out, **_probs_errors(name, probs, ref_probs))


def kernel_phase(gen: torch.Generator) -> dict:
    """Each kernel against its plain version at the main path's shapes, with
    its time, its plain version's, one library call's where one computes the
    same function, and its bound."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    dev = "cuda"
    results = {}

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    # K1 at the backbone shape [3 x 128, 129, 3C], with and without probs,
    # and x30 (|logit| ~ 1e3), against its plain version in the TPU kernel's
    # rounding form; then the shapes the wrapper takes beyond the model's
    Bk, N = 3 * B_EVAL, 129
    qkv = randn(Bk, N, 3 * C)
    probs = torch.empty(Bk, H, N, N, dtype=torch.bfloat16, device=dev)
    out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    out_np, _ = ops.attention_qkv(qkv, H, SCALE)
    torch.cuda.synchronize()
    k1 = _k1_errors("attention_qkv", out, probs, ops.attention_qkv_tpu_plain(qkv, H, SCALE, True))
    e_out, e_probs = max(k1["out_err"], _max_err(out_np, out)), k1["probs_err"]
    _require("attention_qkv out without probs", e_out, 2e-2)
    qkv30 = randn(Bk, N, 3 * C, mul=30.0)
    out30, _ = ops.attention_qkv(qkv30, H, SCALE, probs_out=probs)
    torch.cuda.synchronize()
    if not torch.isfinite(out30.float()).all():
        raise AssertionError("attention_qkv: non-finite output at |logit| ~ 1e3")
    k1_30 = _k1_errors("attention_qkv x30", out30, probs,
                       ops.attention_qkv_tpu_plain(qkv30, H, SCALE, True), scaled=True)
    del out30
    # B = 3 (the batch-1 serving shape at N = 129) at the token counts and
    # head dims the wrapper takes: below, at and past one key chunk, the most
    # tokens, and D = 96 (vit_small_config). At N = 129 the probs start 2
    # bytes past a 16-byte boundary, as a layer slice of the serving path's
    # [L, 3, H, N, N] buffer does
    extra = {}
    for Bx, Nx, Hx, Dx in ((3, 17, H, D), (3, N, H, D), (3, 200, H, D), (3, 512, H, D),
                           (3, N, 8, 96)):
        qx = randn(Bx, Nx, 3 * Hx * Dx)
        shift = int(Nx == N and Dx == D)
        px = torch.empty(shift + Bx * Hx * Nx * Nx, dtype=torch.bfloat16,
                         device=dev)[shift:].view(Bx, Hx, Nx, Nx)
        ox, _ = ops.attention_qkv(qx, Hx, Dx ** -0.5, probs_out=px)
        torch.cuda.synchronize()
        e = _k1_errors(f"attention_qkv B={Bx} N={Nx} H={Hx} D={Dx}", ox, px,
                       ops.attention_qkv_tpu_plain(qx, Hx, Dx ** -0.5, True))
        extra[f"N{Nx}_H{Hx}_D{Dx}"] = e
    e_extra = max(max(e["out_err"], e["probs_err"]) for e in extra.values())
    ms = cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=probs))
    ms_np = cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE))
    plain_ms = cuda_ms(lambda: ops.attention_qkv_tpu_plain(qkv, H, SCALE, True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), scale=SCALE))
    # reads qkv, writes out and probs; q.k and p.v products
    b = bound(4.0 * Bk * H * N * N * D, 2.0 * (Bk * N * 3 * C + Bk * N * C + Bk * H * N * N))
    _at_most_2x_sdpa("attention_qkv", ms, lib_ms)
    results["attention_qkv"] = dict(max_abs_err=max(e_out, e_probs, e_extra), ms=ms,
                                    plain_ms=plain_ms, library_ms=lib_ms, ms_no_probs=ms_np,
                                    **b)
    say("2 kernel attention_qkv", shape=list(qkv.shape), out_err=e_out, probs_err=e_probs,
        probs_ulps=k1["probs_ulps"], row_sum_err=k1["row_sum_err"],
        x30_scaled_err=k1_30["out_err"], x30_probs_ulps=k1_30["probs_ulps"],
        extra=json.dumps(extra), ms=f"{ms:.4f}", ms_no_probs=f"{ms_np:.4f}",
        plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{lib_ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}")

    # K4, the VJP of K1, at the same shape: the scaled error, the share of
    # elements off the plain version (a check that must fail the two wrong
    # forms), |logit| ~ 1e3 with the x30 input, and the shapes the wrapper
    # takes beyond the model's
    g = randn(Bk, N, C)
    dq = ops.attention_qkv_bwd(qkv, g, H, SCALE)
    ref_dq = ops.attention_qkv_bwd_plain(qkv, g, H, SCALE)
    dq30 = ops.attention_qkv_bwd(qkv30, g, H, SCALE)
    ref_dq30 = ops.attention_qkv_bwd_plain(qkv30, g, H, SCALE)
    torch.cuda.synchronize()
    e4, e4_30 = _scaled(dq, ref_dq), _scaled(dq30, ref_dq30)
    _require("attention_qkv_bwd (scaled)", e4, 1e-2)
    if not torch.isfinite(dq30.float()).all():
        raise AssertionError("attention_qkv_bwd: non-finite at |logit| ~ 1e3")
    _require("attention_qkv_bwd x30 (scaled)", e4_30, 1e-2)
    del dq30, ref_dq30
    shares = _bwd_shares("attention_qkv_bwd", dq, ref_dq, N, C)
    caught = _wrong_forms(
        "attention_qkv_bwd",
        ops.attention_qkv_bwd_plain(qkv.float(), g.float(), H, SCALE).to(torch.bfloat16),
        ops.masked_attention_qkv_bwd_plain(qkv, torch.ones(Bk, N, device=dev), g, H, SCALE),
        ref_dq, N, C)
    del ref_dq
    extra4 = _k4_extra_shapes(randn)
    ms = cuda_ms(lambda: ops.attention_qkv_bwd(qkv, g, H, SCALE))
    plain_ms = cuda_ms(lambda: ops.attention_qkv_bwd_plain(qkv, g, H, SCALE))
    lib_ms = _sdpa_bwd_ms(qkv, g)
    # reads qkv and g, writes dqkv; logits recompute, dp, dq, dk, dv
    b = bound(10.0 * Bk * H * N * N * D, 2.0 * Bk * N * (3 * C + C + 3 * C))
    if not ms <= 2.0 * lib_ms:
        raise AssertionError(f"attention_qkv_bwd: {ms} ms, more than 2x the SDPA "
                             f"backward's {lib_ms} ms")
    results["attention_qkv_bwd"] = dict(max_abs_err=e4, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, **shares, wrong_forms=caught,
                                        extra_shapes=extra4, **b)
    say("2 kernel attention_qkv_bwd", shape=list(qkv.shape), scaled_err=e4,
        x30_scaled_err=e4_30, share=shares["share"], cls_share=shares["cls_share"],
        share_tol=SHARE_TOL, wrong_forms=json.dumps(caught), ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", sdpa_bwd_ms=f"{lib_ms:.4f}",
        factor=f"{ms / lib_ms:.3f}", bound_ms=f"{b['bound_ms']:.4f}")
    say("2 kernel attention_qkv_bwd extra shapes", checks=json.dumps(extra4))
    del qkv, probs, out, out_np, qkv30, g, dq

    # K2 at L = 12, Z = 3 x 128 x 12 = 4608, N = 129. Peaked maps (softmax of
    # 4 x randn), so the chain keeps the layer order visible in its output.
    # Kernel and plain version read the same bf16 maps and both sum in fp32,
    # so they differ only by summation order (~1e-8); the limit 1e-5 is far
    # tighter than the TPU test's 5e-3, which a constant output would pass.
    L, Bz = 12, 3 * B_EVAL
    tol_roll = 1e-5
    maps = torch.empty(L, Bz, H, N, N, dtype=torch.bfloat16, device=dev)
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bz, H, N, N, generator=gen, device=dev),
                                dim=-1).to(torch.bfloat16)
    roll = ops.rollout_chain(maps)
    ref_roll = ops.rollout_from_probs_plain(maps)
    torch.cuda.synchronize()
    e_roll = _max_err(roll, ref_roll)
    _require("rollout_chain", e_roll, tol_roll)
    # the limit must fail the bugs this kernel invites
    bug_errs = {
        "transposed": _max_err(ops.rollout_from_probs_plain(maps.transpose(-1, -2)), ref_roll),
        "reversed": _max_err(ops.rollout_from_probs_plain(maps.flip(0)), ref_roll),
        "constant": _max_err(torch.full_like(ref_roll, 1.0 / N), ref_roll),
    }
    for bug, err in bug_errs.items():
        if not err > 100 * tol_roll:
            raise AssertionError(f"rollout_chain check too loose: a {bug} chain is off "
                                 f"by only {err}")
    ms = cuda_ms(lambda: ops.rollout_chain(maps))
    plain_ms = cuda_ms(lambda: ops.rollout_from_probs_plain(maps))
    # reads every map once, writes the fp32 rows; L - 1 vector-matrix products
    b = bound(2.0 * (L - 1) * Bz * H * N * N, 2.0 * L * Bz * H * N * N + 4.0 * Bz * H * (N - 1))
    results["rollout_chain"] = dict(max_abs_err=e_roll, ms=ms, plain_ms=plain_ms,
                                    library_ms=None, **b)
    say("2 kernel rollout_chain", L=L, Z=Bz * H, N=N, err=e_roll, tol=tol_roll,
        spread=f"{float(ref_roll.std()):.6f}",
        bug_errs=json.dumps({k: round(v, 6) for k, v in bug_errs.items()}),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    del maps, roll, ref_roll

    # K3 and K5 at the per-modality [384, 88, 3C] and joint [128, 264, 3C]
    # shapes; the batch-1 serving shapes first. K3 is held to its plain
    # version in the TPU kernel's form by the share test (_fwd_check), which
    # must fail the unrounded and the XLA form in the same run; K5 by the
    # shares over all of dqkv and the rows m % 88 == 0 (_k5_check), which must
    # fail the unrounded and the cls-kept form
    k3_batch1, k5_batch1 = {}, {}
    for Bm, N in ((3, 88), (1, 264)):
        qkv = randn(Bm, N, 3 * C)
        m = (torch.rand(Bm, N, generator=gen, device=dev) < 0.5).float()
        m[:, 0] = 1.0
        k3_batch1[f"B{Bm}_N{N}"] = _fwd_check(
            f"masked_attention_qkv batch-1 N={N}", ops.masked_attention_qkv(qkv, m, H, SCALE, FILL),
            ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL), m)
        g = randn(Bm, N, C)
        k5_batch1[f"B{Bm}_N{N}"] = _k5_check(
            f"masked_attention_qkv_bwd batch-1 N={N}",
            ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL), m, C)
    say("2 kernel masked_attention_qkv batch-1", checks=json.dumps(k3_batch1))
    say("2 kernel masked_attention_qkv_bwd batch-1", checks=json.dumps(k5_batch1))
    fwd, bwd = [], []
    for Bm, N in ((3 * B_EVAL, 88), (B_EVAL, 264)):
        qkv = randn(Bm, N, 3 * C)
        m = torch.rand(Bm, N, generator=gen, device=dev) < 0.5
        m = (m | (torch.arange(N, device=dev) % 88 == 0)[None, :]).float()
        m[0, 1:] = 0.0  # one sequence with only its cls token
        got = ops.masked_attention_qkv(qkv, m, H, SCALE, FILL)
        ref = ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL)
        k3 = _fwd_check(f"masked_attention_qkv N={N}", got, ref, m)
        caught = _k3_wrong_forms(qkv, m, ref, H, D)
        del got, ref
        qkv30 = randn(Bm, N, 3 * C, mul=30.0)
        k3_30 = _fwd_check(f"masked_attention_qkv N={N} x30", ops.masked_attention_qkv(
            qkv30, m, H, SCALE, FILL), ops.masked_attention_qkv_tpu_plain(qkv30, m, H, SCALE, FILL),
            m, scaled=True)
        ms = cuda_ms(lambda: ops.masked_attention_qkv(qkv, m, H, SCALE, FILL))
        plain_ms = cuda_ms(lambda: ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL))
        # timed only: a key mask, as a fully masked query row differs there
        keys = m.bool()[:, None, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), attn_mask=keys,
                                                                scale=SCALE))
        # the work this mask needs: valid query rows x valid keys
        pairs = float((m.sum(1) ** 2).sum())
        nbytes = 2.0 * Bm * N * (3 * C + C) + 4.0 * Bm * N
        fwd.append(dict(err=k3["err"], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        flops=4.0 * H * D * pairs, bytes=nbytes, share=k3["share"],
                        wrong_forms=caught))
        say("2 kernel masked_attention_qkv", shape=list(qkv.shape), err=k3["err"],
            share=k3["share"], share_tol=SHARE_TOL, wrong_forms=json.dumps(caught),
            x30_scaled_err=k3_30["err"], x30_share=k3_30["share"], ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound(4.0 * H * D * pairs, nbytes)['bound_ms']:.4f}")

        g = randn(Bm, N, C)
        dq = ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL)
        ref_dq = ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL)
        k5 = _k5_check(f"masked_attention_qkv_bwd N={N}", dq, ref_dq, m, C)
        caught = _wrong_forms(
            "masked_attention_qkv_bwd",
            ops.masked_attention_qkv_bwd_plain(qkv.float(), m, g.float(), H, SCALE,
                                               FILL).to(torch.bfloat16),
            ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, K5_CLS_ROWS),
            ref_dq, K5_CLS_ROWS, C, "cls_kept")
        dq30 = ops.masked_attention_qkv_bwd(qkv30, m, g, H, SCALE, FILL)
        ref_dq30 = ops.masked_attention_qkv_bwd_plain(qkv30, m, g, H, SCALE, FILL)
        torch.cuda.synchronize()
        e5_30 = _scaled(dq30, ref_dq30)
        if not torch.isfinite(dq30.float()).all():
            raise AssertionError("masked_attention_qkv_bwd: non-finite at |logit| ~ 1e3")
        _require(f"masked_attention_qkv_bwd N={N} x30 (scaled)", e5_30, 1e-2)
        ms = cuda_ms(lambda: ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL))
        plain_ms = cuda_ms(lambda: ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE,
                                                                      FILL))
        lib_ms = _sdpa_bwd_ms(qkv, g, m.bool())
        nbytes = 2.0 * Bm * N * (3 * C + C + 3 * C) + 4.0 * Bm * N
        bwd.append(dict(err=k5["scaled_err"], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        flops=10.0 * H * D * pairs, bytes=nbytes, share=k5["share"],
                        cls_share=k5["cls_share"], wrong_forms=caught))
        say("2 kernel masked_attention_qkv_bwd", shape=list(qkv.shape),
            scaled_err=k5["scaled_err"], share=k5["share"], cls_share=k5["cls_share"],
            share_tol=SHARE_TOL, wrong_forms=json.dumps(caught), x30_scaled_err=e5_30,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", sdpa_bwd_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound(10.0 * H * D * pairs, nbytes)['bound_ms']:.4f}")
        del qkv, qkv30, g, dq, ref_dq, dq30, ref_dq30
    k3_extra, k5_extra = _k35_extra_shapes(randn, gen)
    # one forward (one train step) runs each shape once: report the sums
    _sum_rows(results, "masked_attention_qkv", fwd)
    results["masked_attention_qkv"].update(
        shares=[c["share"] for c in fwd], wrong_forms=[c["wrong_forms"] for c in fwd],
        batch1=k3_batch1, extra_shapes=k3_extra)
    say("2 kernel masked_attention_qkv extra shapes", checks=json.dumps(k3_extra))
    _sum_rows(results, "masked_attention_qkv_bwd", bwd)
    k5_ms, sdpa_ms = sum(r["ms"] for r in bwd), sum(r["library_ms"] for r in bwd)
    if not k5_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_qkv_bwd: {k5_ms} ms on the model shapes, "
                             f"more than 2x the SDPA backward's {sdpa_ms} ms")
    say("2 sum masked_attention_qkv_bwd vs sdpa_bwd", ms=f"{k5_ms:.4f}",
        sdpa_bwd_ms=f"{sdpa_ms:.4f}", factor=f"{k5_ms / sdpa_ms:.3f}", limit="2")
    results["masked_attention_qkv_bwd"].update(
        shares=[c["share"] for c in bwd], cls_shares=[c["cls_share"] for c in bwd],
        wrong_forms=[c["wrong_forms"] for c in bwd], batch1=k5_batch1, extra_shapes=k5_extra)
    say("2 kernel masked_attention_qkv_bwd extra shapes", checks=json.dumps(k5_extra))
    tiled_kernels(randn, gen, results)
    ln_matmul_kernel(randn, gen, results)
    return results


def _sum_rows(results: dict, name: str, calls: list, phase: str = "2") -> None:
    """One row of the kernels line from the shapes one forward (or one train
    step) runs once each: times and work summed, the largest error."""
    b = bound(sum(c["flops"] for c in calls), sum(c["bytes"] for c in calls))
    results[name] = dict(max_abs_err=max(c["err"] for c in calls),
                         ms=sum(c["ms"] for c in calls),
                         plain_ms=sum(c["plain_ms"] for c in calls),
                         library_ms=sum(c["library_ms"] for c in calls), **b)
    say(f"{phase} sum {name}", ms=f"{results[name]['ms']:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])


def _scaled(got, ref) -> float:
    return _max_err(got, ref, max(float(ref.float().abs().max()), 1e-6))


SHARE_TOL = 0.005  # share of elements more than one bf16 ulp off the plain version


def _bwd_shares(name: str, dq, ref, T: int, Cx: int) -> dict:
    """The rounding checks of K4, K7 and K5 (``_bench.bf16_off_share``, one
    bf16 ulp of the plain element + 1e-6 of the max): over all of dqkv, and
    over the cls rows' dk and dv (rows m % T == 0, columns Cx: onward; K4's
    only cls row is row 0: T = N; K5 has no cls key and reads the tail's cls
    tokens, T = 88, where K7's form would keep fp32), each at most SHARE_TOL
    of the elements off the plain version in the TPU form."""
    from editor_tpu_torch.tools import _bench

    share = _bench.bf16_off_share(dq, ref)
    cls = _bench.bf16_off_share(dq[:, ::T, Cx:], ref[:, ::T, Cx:])
    _require(f"{name} share off the plain version", share, SHARE_TOL)
    _require(f"{name} cls rows' dk, dv share off the plain version", cls, SHARE_TOL)
    return dict(share=share, cls_share=cls)


def _wrong_forms(name: str, unrounded, cls_form, ref, T: int, Cx: int,
                 cls_label: str = "cls_rounded") -> dict:
    """The share tests must fail the wrong forms they exist to catch: the
    unrounded form (the plain version on fp32 inputs, rounded once) over all
    elements, and ``cls_form`` over the cls rows' dk and dv (as in
    _bwd_shares): for K4 and K7 the cls-rounded form (K5's,
    masked_attention_qkv_bwd_plain: every key's weights rounded), for K5 the
    cls-kept form (K7's, masked_attention_tiled_bwd_plain with tile T: the
    keys m % T == 0 in fp32), which K7's launcher would take at K5's N."""
    from editor_tpu_torch.tools import _bench

    caught = {"unrounded_share": _bench.bf16_off_share(unrounded, ref),
              f"{cls_label}_cls_share": _bench.bf16_off_share(cls_form[:, ::T, Cx:],
                                                              ref[:, ::T, Cx:])}
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} is off in only "
                                 f"{share} of the elements")
    return caught


def _fwd_check(name: str, got, ref, m, scaled: bool = False, rows: bool = False) -> dict:
    """A masked forward (K3, K6, T6's; T1's and T2's with every key kept)
    against its plain version in the TPU kernel's form: finite; within 2e-2
    (scaled by the largest magnitude: 1e-2); query rows with mask 0 exact
    zeros; at most SHARE_TOL of the elements more than one bf16 ulp (+1e-6 of
    the max) off (``_bench.bf16_off_share``: the two round at the same points
    and differ only in the order of the fp32 sums), read over all elements,
    or with ``rows`` over the valid query rows only (K6's sparse batch, where
    the cls keys carry weight)."""
    from editor_tpu_torch.tools import _bench

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = _scaled(got, ref) if scaled else _max_err(got, ref)
    _require(name + (" (scaled)" if scaled else ""), err, 1e-2 if scaled else 2e-2)
    if torch.count_nonzero(got[m == 0]):
        raise AssertionError(f"{name}: masked query rows not 0")
    valid = m.bool()
    share = (_bench.bf16_off_share(got[valid], ref[valid]) if rows
             else _bench.bf16_off_share(got, ref))
    _require(f"{name} share off the plain version" + (" (valid rows)" if rows else ""),
             share, SHARE_TOL)
    return dict(err=err, share=share)


def _k3_wrong_forms(qkv, m, ref, Hx: int, Dx: int) -> dict:
    """K3's share test must fail the wrong forms it exists to catch: the
    unrounded form (the TPU-form plain version on fp32 inputs, rounded once)
    and the XLA form (masked_attention_qkv_plain: normalised, re-masked
    weights rounded), each more than SHARE_TOL of the elements off."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import _bench

    caught = dict(
        unrounded_share=_bench.bf16_off_share(ops.masked_attention_qkv_tpu_plain(
            qkv.float(), m, Hx, Dx ** -0.5, FILL).to(torch.bfloat16), ref),
        xla_share=_bench.bf16_off_share(ops.masked_attention_qkv_plain(
            qkv, m, Hx, Dx ** -0.5, FILL), ref))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"masked_attention_qkv share test too loose: the {form} is "
                                 f"off in only {share} of the elements")
    return caught


def _t12_wrong_forms(name: str, unrounded, ref, cls_rounded, ref_cls) -> dict:
    """T1's and T2's share test must fail the wrong forms it exists to catch:
    the unrounded form (the plain version on fp32 inputs, rounded once) on
    random-normal inputs (``ref``), and the cls-rounded form
    (attention_qkv_plain, the model path's XLA form: p_0 rounded to bf16
    too) on the cls-heavy inputs (``ref_cls``, bench_attn.cls_heavy), where
    p_0 v_0 weighs enough for its rounding to show; on random-normal inputs
    that form is only ~0.5% off."""
    from editor_tpu_torch.tools import _bench

    caught = dict(unrounded_share=_bench.bf16_off_share(unrounded, ref),
                  cls_rounded_share=_bench.bf16_off_share(cls_rounded, ref_cls))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} is off in only "
                                 f"{share} of the elements")
    return caught


K5_CLS_ROWS = 88  # the rows K5's cls-row share reads: m % 88 == 0, the tail's cls tokens


def _k5_check(name: str, dq, ref, m, Cx: int) -> dict:
    """K5 against its plain version (the TPU kernel's form): finite; within
    1e-2 scaled by the largest magnitude; masked rows get zero gradient (q,
    and as keys k and v); at most SHARE_TOL of all elements and of the dk
    and dv of the rows m % 88 == 0 more than one bf16 ulp off (_bwd_shares)."""
    torch.cuda.synchronize()
    if not torch.isfinite(dq.float()).all():
        raise AssertionError(f"{name}: non-finite dqkv")
    err = _scaled(dq, ref)
    _require(f"{name} (scaled)", err, 1e-2)
    if torch.count_nonzero(dq[m == 0]):
        raise AssertionError(f"{name}: masked rows get a gradient")
    return dict(scaled_err=err, **_bwd_shares(name, dq, ref, K5_CLS_ROWS, Cx))


def _k35_extra_shapes(randn, gen: torch.Generator) -> tuple:
    """K3 and K5 beyond the model's shapes, held as at them (_fwd_check,
    _k5_check), each with a sequence masked but for its cls token: B = 3 at
    N = 1, 15, 16, 17 (one 16-row tile and past it), 144 and 145 (the last
    resident N and the first chunked one at D <= 96), 200 and 512 (D = 64,
    H = 12); N = 264 at D = 32 (H = 12), 96 (H = 8) and 128 (H = 6; K3 in 4
    key chunks of 80; at both K5's half-staged instance); N = 512 at D = 128
    (H = 6), where K3's k and v no longer fit in shared memory whole and come
    a chunk at a time. Returns (K3's checks, K5's checks)."""
    from editor_tpu_torch import ops

    dev, k3, k5 = "cuda", {}, {}
    shapes = [(Nx, H, D) for Nx in (1, 15, 16, 17, 144, 145, 200, 512)]
    shapes += [(264, H, 32), (264, 8, 96), (264, 6, 128), (512, 6, 128)]
    for Nx, Hx, Dx in shapes:
        Cx = Hx * Dx
        qkv, g = randn(3, Nx, 3 * Cx), randn(3, Nx, Cx)
        m = (torch.rand(3, Nx, generator=gen, device=dev) < 0.5).float()
        m[:, 0] = 1.0
        m[1, 1:] = 0.0
        case = f"B=3 N={Nx} H={Hx} D={Dx}"
        k3[f"N{Nx}_H{Hx}_D{Dx}"] = _fwd_check(
            f"masked_attention_qkv {case}",
            ops.masked_attention_qkv(qkv, m, Hx, Dx ** -0.5, FILL),
            ops.masked_attention_qkv_tpu_plain(qkv, m, Hx, Dx ** -0.5, FILL), m)
        k5[f"N{Nx}_H{Hx}_D{Dx}"] = _k5_check(
            f"masked_attention_qkv_bwd {case}",
            ops.masked_attention_qkv_bwd(qkv, m, g, Hx, Dx ** -0.5, FILL),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, Hx, Dx ** -0.5, FILL), m, Cx)
    return k3, k5


def _k4_extra_shapes(randn) -> dict:
    """K4 beyond the model's shape, held to the same limits as at it (scaled
    error, shares with the cls row 0): B = 3 at N = 1 and 8 (less than one
    16-key tile), 17, 129, 200 and 512 (the chunked instance past 144
    tokens; D = 64), N = 129 at D = 96 (H = 8) and at D = 32 (H = 12), and
    N = 512 at D = 96 (H = 8) and D = 128 (H = 6), where only k and q of the
    chunked instance fit in shared memory."""
    from editor_tpu_torch import ops

    out = {}
    for Bx, Nx, Hx, Dx in ((3, 1, H, D), (3, 8, H, D), (3, 17, H, D), (3, 129, H, D),
                           (3, 200, H, D), (3, 512, H, D), (3, 129, 8, 96), (3, 129, H, 32),
                           (3, 512, 8, 96), (3, 512, 6, 128)):
        Cx = Hx * Dx
        qkv, g = randn(Bx, Nx, 3 * Cx), randn(Bx, Nx, Cx)
        name = f"attention_qkv_bwd B={Bx} N={Nx} H={Hx} D={Dx}"
        dq = ops.attention_qkv_bwd(qkv, g, Hx, Dx ** -0.5)
        ref = ops.attention_qkv_bwd_plain(qkv, g, Hx, Dx ** -0.5)
        torch.cuda.synchronize()
        e = _scaled(dq, ref)
        _require(f"{name} (scaled)", e, 1e-2)
        out[f"N{Nx}_H{Hx}_D{Dx}"] = dict(scaled_err=e, **_bwd_shares(name, dq, ref, Nx, Cx))
    return out


def _k7_extra_shapes(randn, gen: torch.Generator) -> dict:
    """K7 beyond the model's shapes, held to the same limits as phase 2's:
    D = 32 (H = 12, C = 384, deit_small's head) at [4, 387]; an odd B (3) at
    N = 387; a sequence whose mask is all zero but for its cls tokens."""
    from editor_tpu_torch import ops

    dev, T, out = "cuda", 129, {}
    for label, Bx, Dx, cls_only in (("D32", 4, 32, False), ("B3", 3, D, False),
                                    ("cls_only", 2, D, True)):
        Nx, Cx = 3 * T, H * Dx
        qkv, g = randn(Bx, Nx, 3 * Cx), randn(Bx, Nx, Cx)
        keep = torch.arange(Nx, device=dev) % T == 0
        m = ((torch.rand(Bx, Nx, generator=gen, device=dev) < 0.5) | keep[None, :]).float()
        if cls_only:
            m[1] = keep.float()
        name = f"masked_attention_tiled_bwd {label} [{Bx}, {Nx}] D={Dx}"
        dq = ops.masked_attention_tiled_bwd(qkv, m, g, H, Dx ** -0.5, FILL, T)
        ref = ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, Dx ** -0.5, FILL, T)
        torch.cuda.synchronize()
        e = _scaled(dq, ref)
        _require(f"{name} (scaled)", e, 1e-2)
        if dq[..., :Cx][m == 0].abs().max() != 0 or dq[..., Cx:][m == 0].abs().max() != 0:
            raise AssertionError(f"{name}: masked rows get a gradient")
        out[label] = dict(scaled_err=e, **_bwd_shares(name, dq, ref, T, Cx))
    return out


def _tiled_mask(gen: torch.Generator, B: int, N: int, T: int, keep: float):
    """[B, N] float: patches kept with probability ``keep``, every cls token
    (m % T == 0) kept."""
    m = torch.rand(B, N, generator=gen, device="cuda") < keep
    return (m | (torch.arange(N, device="cuda") % T == 0)[None, :]).float()


SPARSE_KEEP = 0.1  # the patches K6's second reading keeps: the cls keys carry weight


def _k6_wrong_forms(qkv, m, ref, ms, ref_s, Hx: int, Dx: int, T: int) -> dict:
    """K6's share test must fail the wrong forms it exists to catch, each in
    the reading that catches it: the unrounded form (the plain version on
    fp32 inputs, rounded once) over all elements of the half-kept batch
    (``m``, ``ref``), and K3's form (masked_attention_qkv_tpu_plain: the cls
    keys' exps rounded too) over the valid query rows of the sparse batch
    (``ms``, ``ref_s``); over all elements of the half-kept batch it sits
    about the limit, diluted by the masked rows' exact zeros."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import _bench

    valid = ms.bool()
    caught = dict(
        unrounded_share=_bench.bf16_off_share(ops.masked_attention_tiled_plain(
            qkv.float(), m, Hx, Dx ** -0.5, FILL, T).to(torch.bfloat16), ref),
        k3_form_sparse_share=_bench.bf16_off_share(ops.masked_attention_qkv_tpu_plain(
            qkv, ms, Hx, Dx ** -0.5, FILL)[valid], ref_s[valid]))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"masked_attention_tiled share test too loose: the {form} "
                                 f"is off in only {share} of the elements")
    return caught


def _k6_extra_shapes(randn, gen: torch.Generator) -> dict:
    """K6 beyond the model's shapes, held as at them (_fwd_check: over all
    elements of a half-kept batch whose sequence 1 is masked but for its cls
    tokens, and over the valid rows of a sparse batch): B = 3 at N = 129,
    258 and 387 with D = 32 (H = 12), 96 (H = 8) and 128 (H = 6; chunked at
    N = 129 already, 80 keys a chunk); tiles of 16 (N = 256 and 512: up to 9
    cls keys a key chunk), 64 (N = 192 and 512) and 128 (N = 512 at D = 128,
    where k and v come a chunk at a time)."""
    from editor_tpu_torch import ops

    out = {}
    shapes = [(Nx, 129, Hx, Dx) for Nx in (129, 258, 387)
              for Hx, Dx in ((H, 32), (8, 96), (6, 128))]
    shapes += [(256, 16, H, D), (512, 16, H, D), (192, 64, H, D), (512, 64, H, D),
               (512, 128, 6, 128)]
    for Nx, T, Hx, Dx in shapes:
        qkv = randn(3, Nx, 3 * Hx * Dx)
        m = _tiled_mask(gen, 3, Nx, T, 0.5)
        m[1] = (torch.arange(Nx, device="cuda") % T == 0).float()
        ms = _tiled_mask(gen, 3, Nx, T, SPARSE_KEEP)
        case = f"masked_attention_tiled B=3 N={Nx} tile={T} H={Hx} D={Dx}"
        k6 = _fwd_check(case, ops.masked_attention_tiled(qkv, m, Hx, Dx ** -0.5, FILL, T),
                       ops.masked_attention_tiled_plain(qkv, m, Hx, Dx ** -0.5, FILL, T), m)
        k6s = _fwd_check(f"{case} sparse",
                        ops.masked_attention_tiled(qkv, ms, Hx, Dx ** -0.5, FILL, T),
                        ops.masked_attention_tiled_plain(qkv, ms, Hx, Dx ** -0.5, FILL, T), ms,
                        rows=True)
        out[f"N{Nx}_T{T}_H{Hx}_D{Dx}"] = dict(err=max(k6["err"], k6s["err"]),
                                             share=k6["share"], sparse_share=k6s["share"])
    return out


def tiled_kernels(randn, gen: torch.Generator, results: dict) -> None:
    """K6 and K7 at the uncompacted tail's shapes: per modality [384, 129]
    (one tile) and joint [128, 387] (three tiles), both on the flagship path,
    and the two-modality joint [128, 258] (two tiles), checked and timed on
    its own. K6 is held to its plain version by _fwd_check twice, over all
    elements of a half-kept batch and over the valid rows of a sparse one,
    a check that must fail the unrounded and K3's form (_k6_wrong_forms), at
    shapes beyond the model's too (_k6_extra_shapes), and its time on the two
    model shapes to at most 2x SDPA's with the key mask. K7 is held to the
    tolerances of tests/test_pallas_tpu.py:92-111 and to the share of its
    elements off the plain version (_bwd_shares), which must fail the wrong
    rounding forms (_wrong_forms), at shapes beyond the model's too
    (_k7_extra_shapes), and its time on the two model shapes to at most 3x
    the SDPA backward's."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.ops.masked_attention import k7_scratch_stride

    F = torch.nn.functional
    dev, T = "cuda", 129
    fwd, bwd = [], []
    k6_rows = dict(shares={}, sparse_shares={}, wrong_forms={})  # the kernels line's, by shape
    for Bm, N in ((3 * B_EVAL, T), (B_EVAL, 3 * T), (B_EVAL, 2 * T)):
        qkv = randn(Bm, N, 3 * C)
        m = _tiled_mask(gen, Bm, N, T, 0.5)
        m[0, 1:T] = 0.0  # a first tile with only its cls token
        got = ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, T)
        ref = ops.masked_attention_tiled_plain(qkv, m, H, SCALE, FILL, T)
        k6 = _fwd_check(f"masked_attention_tiled N={N}", got, ref, m)
        e = k6["err"]
        # the second batch: every cls token and a tenth of the patches kept
        ms = _tiled_mask(gen, Bm, N, T, SPARSE_KEEP)
        ref_s = ops.masked_attention_tiled_plain(qkv, ms, H, SCALE, FILL, T)
        k6s = _fwd_check(f"masked_attention_tiled N={N} sparse",
                        ops.masked_attention_tiled(qkv, ms, H, SCALE, FILL, T), ref_s, ms,
                        rows=True)
        caught = _k6_wrong_forms(qkv, m, ref, ms, ref_s, H, D, T)
        del ref_s, ms
        qkv30 = randn(Bm, N, 3 * C, mul=30.0)
        k6_30 = _fwd_check(f"masked_attention_tiled N={N} x30",
                          ops.masked_attention_tiled(qkv30, m, H, SCALE, FILL, T),
                          ops.masked_attention_tiled_plain(qkv30, m, H, SCALE, FILL, T), m,
                          scaled=True)
        # the work this mask needs: valid query rows x valid keys
        pairs = float((m.sum(1) ** 2).sum())
        keys = m.bool()[:, None, None, :]
        row = dict(err=e, flops=4.0 * H * D * pairs,
                   bytes=2.0 * Bm * N * (3 * C + C) + 4.0 * Bm * N,
                   ms=cuda_ms(lambda: ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, T)),
                   plain_ms=cuda_ms(lambda: ops.masked_attention_tiled_plain(
                       qkv, m, H, SCALE, FILL, T)),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       *_heads(qkv), attn_mask=keys, scale=SCALE)))
        for key, value in zip(k6_rows, (k6["share"], k6s["share"], caught)):
            k6_rows[key][f"B{Bm}_N{N}"] = value
        say("2 kernel masked_attention_tiled", shape=list(qkv.shape), tiles=N // T, err=e,
            share=k6["share"], sparse_share=k6s["share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(caught), x30_scaled_err=k6_30["err"],
            x30_share=k6_30["share"], ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
            sdpa_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{bound(row['flops'], row['bytes'])['bound_ms']:.4f}")
        if N != 2 * T:
            fwd.append(row)

        g = randn(Bm, N, C)
        dq = ops.masked_attention_tiled_bwd(qkv, m, g, H, SCALE, FILL, T)
        ref_dq = ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, T)
        dq30 = ops.masked_attention_tiled_bwd(qkv30, m, g, H, SCALE, FILL, T)
        ref_dq30 = ops.masked_attention_tiled_bwd_plain(qkv30, m, g, H, SCALE, FILL, T)
        torch.cuda.synchronize()
        e7, e7_30 = _scaled(dq, ref_dq), _scaled(dq30, ref_dq30)
        _require(f"masked_attention_tiled_bwd N={N} (scaled)", e7, 1e-2)
        if not torch.isfinite(dq30.float()).all():
            raise AssertionError("masked_attention_tiled_bwd: non-finite at |logit| ~ 1e3")
        _require(f"masked_attention_tiled_bwd N={N} x30 (scaled)", e7_30, 1e-2)
        if dq[..., :C][m == 0].abs().max() != 0 or dq[..., C:][m == 0].abs().max() != 0:
            raise AssertionError("masked_attention_tiled_bwd: masked rows get a gradient")
        # every cls key of every tile: dv of every head written, and dk too
        # but in sequence 0, whose only valid key is its cls token (softmax
        # over one key has no gradient)
        cls_kv = dq[:, ::T, C:].reshape(Bm, N // T, 2, H, D).abs().amax(-1)
        if not ((cls_kv[:, :, 1] > 0).all() and (cls_kv[1:, :, 0] > 0).all()):
            raise AssertionError("masked_attention_tiled_bwd: a cls key's dk or dv is zero")
        shares = _bwd_shares(f"masked_attention_tiled_bwd N={N}", dq, ref_dq, T, C)
        caught = _wrong_forms(
            "masked_attention_tiled_bwd",
            ops.masked_attention_tiled_bwd_plain(qkv.float(), m, g.float(), H, SCALE, FILL,
                                                 T).to(torch.bfloat16),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL), ref_dq, T, C)
        del qkv30, dq30, ref_dq30, ref_dq
        row = dict(err=e7, flops=10.0 * H * D * pairs,
                   bytes=2.0 * Bm * N * (3 * C + C + 3 * C) + 4.0 * Bm * N,
                   ms=cuda_ms(lambda: ops.masked_attention_tiled_bwd(qkv, m, g, H, SCALE,
                                                                     FILL, T)),
                   plain_ms=cuda_ms(lambda: ops.masked_attention_tiled_bwd_plain(
                       qkv, m, g, H, SCALE, FILL, T)),
                   library_ms=_sdpa_bwd_ms(qkv, g, m.bool()))
        say("2 kernel masked_attention_tiled_bwd", shape=list(qkv.shape), tiles=N // T,
            scaled_err=e7, x30_scaled_err=e7_30, share=shares["share"],
            cls_share=shares["cls_share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(caught), ms=f"{row['ms']:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}", sdpa_bwd_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{bound(row['flops'], row['bytes'])['bound_ms']:.4f}",
            scratch_gb=f"{2 * 2.0 * Bm * H * k7_scratch_stride(N) ** 2 / 1e9:.3f}")
        if N != 2 * T:
            bwd.append(row)
        del qkv, got, ref, g, dq
        torch.cuda.empty_cache()
    extra6 = _k6_extra_shapes(randn, gen)
    say("2 kernel masked_attention_tiled extra shapes", checks=json.dumps(extra6))
    extra = _k7_extra_shapes(randn, gen)
    say("2 kernel masked_attention_tiled_bwd extra shapes", checks=json.dumps(extra))
    _sum_rows(results, "masked_attention_tiled", fwd)
    k6_ms, sdpa_ms = sum(r["ms"] for r in fwd), sum(r["library_ms"] for r in fwd)
    if not k6_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_tiled: {k6_ms} ms on the model shapes, more "
                             f"than 2x SDPA's with the key mask, {sdpa_ms} ms")
    say("2 sum masked_attention_tiled vs sdpa", ms=f"{k6_ms:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        factor=f"{k6_ms / sdpa_ms:.3f}", limit="2")
    results["masked_attention_tiled"].update(**k6_rows, extra_shapes=extra6)
    _sum_rows(results, "masked_attention_tiled_bwd", bwd)
    k7_ms, sdpa_ms = sum(r["ms"] for r in bwd), sum(r["library_ms"] for r in bwd)
    if not k7_ms <= 3.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_tiled_bwd: {k7_ms} ms on the model shapes, "
                             f"more than 3x the SDPA backward's {sdpa_ms} ms")
    results["masked_attention_tiled_bwd"].update(extra_shapes=extra)
    say("2 sum masked_attention_tiled_bwd vs sdpa_bwd", ms=f"{k7_ms:.4f}",
        sdpa_bwd_ms=f"{sdpa_ms:.4f}", factor=f"{k7_ms / sdpa_ms:.3f}", limit="3")


def _k8_forms(x, w, b, gm, bt, act: str) -> dict:
    """K8's wrong forms, composed from the plain version: the LayerNorm's
    output left in fp32 (the plain version on fp32 x), the product rounded
    before the bias (``_xla_ln_matmul``'s form), the GELU of the rounded
    pre-activation."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    bf = torch.bfloat16
    wb = w.to(bf).float()
    forms = {"y_fp32": ops.ln_matmul_plain(x.float(), wb, b, gm, bt, 1e-6, act).to(bf)}
    rounded = ops.ln_matmul_plain(x, w, None, gm, bt, 1e-6, "").float() + b
    forms["product_rounded"] = (F.gelu(rounded) if act else rounded).to(bf)
    if act:
        forms["gelu_on_bf16"] = F.gelu(ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, "").float()
                                       ).to(bf)
    return forms


def _k8_check(name: str, got, ref, forms: dict, need: tuple) -> dict:
    """K8 against its plain version: finite, scaled error <= 1e-2, at most
    SHARE_TOL of the elements more than one bf16 ulp off; each wrong form in
    ``need`` must exceed that share in the same run (the others are
    printed)."""
    from editor_tpu_torch.tools import _bench

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = _scaled(got, ref)
    _require(f"{name} (scaled)", err, 1e-2)
    share = _bench.bf16_off_share(got, ref)
    _require(f"{name} share off the plain version", share, SHARE_TOL)
    caught = {form: _bench.bf16_off_share(f, ref) for form, f in forms.items()}
    for form in need:
        if not caught[form] > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} form is off in "
                                 f"only {caught[form]} of the elements")
    return dict(err=err, share=share, wrong_forms=caught)


def ln_matmul_kernel(randn, gen: torch.Generator, results: dict) -> None:
    """K8 on the backbone's shapes (T = 384 x 129 tokens, C = 768): norm1 ->
    qkv (O = 2304) and norm2 -> fc1 + GELU (O = 3072), against its plain
    version by _k8_check (the share test, with the y-in-fp32 form required
    to fail it); the product-rounded and GELU-on-bf16 forms are under the
    limit on these inputs (weights x 0.02: pre-activations of ~0.7 and
    biases of 0.02), so they are read on wide inputs (weights x 0.05, biases
    x 0.3, T = 8192), where the kernel must pass too; a ragged row count with
    no bias and the LayerNorm parameters as fp32 views at a 4-byte offset
    (the wrapper realigns them for the kernel's 16-byte loads), a C whose
    last k slice is 16 deep and a C of one k slice checked too. K8 is on no
    model path (as in the JAX package), so its launches on the main path are
    0. Library
    time: the three-call chain F.layer_norm -> F.linear -> F.gelu in bf16,
    what the backbone runs; K8's time over both shapes must be at most 2x the
    chain's."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    dev, Tk = "cuda", 3 * B_EVAL * 129

    def params(O, Cx=C, ws=0.02, bs=0.02):
        return (torch.randn(O, Cx, generator=gen, device=dev) * ws,
                torch.randn(O, generator=gen, device=dev) * bs,
                1.0 + 0.1 * torch.randn(Cx, generator=gen, device=dev),
                0.1 * torch.randn(Cx, generator=gen, device=dev))

    extra = {}
    for label, (T, Cx, O) in {"ragged rows, no bias, LN params at a 4-byte offset":
                              (1000, C, 256),
                              "C = 1040 (a last k slice of 16)": (1000, 1040, 272),
                              "C = 96 (one k slice)": (300, 96, 128)}.items():
        xr = randn(T, Cx, mul=2.0)
        w, b, gm, bt = params(O, Cx)
        if label.startswith("ragged"):  # fp32 views the wrapper must realign
            b, gm, bt = None, *(torch.cat([t.new_zeros(1), t])[1:] for t in (gm, bt))
        got = ops.ln_matmul(xr, w, b, gm, bt, act="gelu")
        ref = ops.ln_matmul_plain(xr, w, b, gm, bt, act="gelu")
        extra[label] = _k8_check(f"ln_matmul {label}", got, ref, {}, ())
    wide = {}
    xw = randn(8192, C, mul=2.0)
    for O, act in ((3 * C, ""), (4 * C, "gelu")):
        w, b, gm, bt = params(O, ws=0.05, bs=0.3)
        wide[f"O={O} {act or 'linear'}"] = _k8_check(
            f"ln_matmul wide O={O} {act or 'linear'}", ops.ln_matmul(xw, w, b, gm, bt, 1e-6, act),
            ops.ln_matmul_plain(xw, w, b, gm, bt, 1e-6, act), _k8_forms(xw, w, b, gm, bt, act),
            ("y_fp32", "product_rounded") + (("gelu_on_bf16",) if act else ()))
    del xw
    rows, checks = [], {}
    x = randn(Tk, C, mul=2.0)
    for O, act in ((3 * C, ""), (4 * C, "gelu")):
        w, b, gm, bt = params(O)
        key = f"O={O} {act or 'linear'}"
        checks[key] = _k8_check(f"ln_matmul {key}", ops.ln_matmul(x, w, b, gm, bt, 1e-6, act),
                                ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, act),
                                _k8_forms(x, w, b, gm, bt, act), ("y_fp32",))
        torch.cuda.empty_cache()
        wb, bb, gb, btb = (t.to(torch.bfloat16) for t in (w, b, gm, bt))

        def chain():
            y = F.linear(F.layer_norm(x, (C,), gb, btb, 1e-6), wb, bb)
            return F.gelu(y) if act else y
        row = dict(err=checks[key]["err"], flops=2.0 * Tk * C * O,
                   bytes=2.0 * Tk * C + 4.0 * O * C + 4.0 * O + 8.0 * C + 2.0 * Tk * O,
                   ms=cuda_ms(lambda: ops.ln_matmul(x, w, b, gm, bt, 1e-6, act)),
                   plain_ms=cuda_ms(lambda: ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, act)),
                   library_ms=cuda_ms(chain))
        b_ = bound(row["flops"], row["bytes"])
        say("2 kernel ln_matmul", shape=[Tk, C, O], act=act or "none",
            scaled_err=checks[key]["err"], share=checks[key]["share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(checks[key]["wrong_forms"]), ms=f"{row['ms']:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}", chain3_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{b_['bound_ms']:.4f}", bound_by=b_["bound_by"],
            tflops=f"{row['flops'] / row['ms'] / 1e9:.1f}",
            l2_weight_gb=f"{-(-Tk // 128) * O * C * 2 / 1e9:.3f}")
        rows.append(row)
        torch.cuda.empty_cache()
    say("2 kernel ln_matmul checks", wide=json.dumps(wide), extra_shapes=json.dumps(extra))
    _sum_rows(results, "ln_matmul", rows)
    res = results["ln_matmul"]
    res.update(checks=checks, wide=wide, extra_shapes=extra)
    if not res["ms"] <= 2.0 * res["library_ms"]:
        raise AssertionError(f"ln_matmul: {res['ms']} ms over both shapes, more than 2x the "
                             f"three-call chain's {res['library_ms']} ms")


def _t3_stages(name: str, ins, Hx: int, scale: float, out, g: int = 1) -> dict:
    """T3 read stage by stage (``bench_attn_layer.stage_shares`` on the
    kernel's own workspaces, from a second launch that must give ``out``
    again): qkv, att and out each at most SHARE_TOL of the elements more
    than one bf16 ulp off the TPU form of the stage's own input; att equal
    to K1's output on the same qkv; the y-in-fp32, qkv-in-fp32 and
    att-in-fp32 forms above the limit (the cls-rounded form is printed: on
    these inputs it sits at the limit; K1's and T1's checks hold that
    rounding of the same body)."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import bench_attn_layer

    o, qkv, att = bench_attn_layer.attn_layer_stages(*ins, Hx, scale, 1e-6, g)
    if not torch.equal(o, out):
        raise AssertionError(f"{name}: a second launch gave another output")
    if not torch.equal(att, ops.attention_qkv(qkv, Hx, scale)[0]):
        raise AssertionError(f"{name}: the attention stage is not K1's output on its qkv")
    shares, wrong = bench_attn_layer.stage_shares(*ins, Hx, scale, 1e-6, qkv, att, o)
    for stage, share in shares.items():
        _require(f"{name} {stage} share off the plain stage", share, SHARE_TOL)
    for form in ("y_fp32", "qkv_fp32", "att_fp32"):
        if not wrong[form] > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} form is off in "
                                 f"only {wrong[form]} of the elements")
    return dict(shares=shares, wrong_forms=wrong)


def variant_phase(gen: torch.Generator) -> dict:
    """Phase 7: the design-variant kernels T1-T6 at the flagship shapes, one
    configuration each, against their plain versions with the phase 2
    limits (T4/T5's bf16 chain: one bf16 ulp of the output's largest
    magnitude, and at most 5% of the outputs more than 8 fp32 ulps off the
    plain bf16 chain; T6: bit-identical to K3 and K5, K3's and K5's checks),
    with kernel, plain and library-call times and the bound."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import (_bench, bench_attn, bench_attn2, bench_attn_layer,
                                        bench_full_kernel, bench_rollout, bench_rollout2)

    F = torch.nn.functional
    dev, Bk, N = "cuda", 3 * B_EVAL, 129
    bf = torch.bfloat16
    results = {}

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(bf)

    # T1 and T2 on K1's tensor-core body, held as K3 is: at most SHARE_TOL of
    # the elements more than one bf16 ulp off the plain version (_fwd_check,
    # every key kept), on random-normal inputs and on cls-heavy ones
    # (bench_attn.cls_heavy), a test that must fail the unrounded form (on
    # the first) and the cls-rounded form (on the second) in the same run;
    # T1's probs as K1's (each within one bf16 ulp, rows summing to 1)
    qkv = randn(Bk, N, 3 * C)
    qkv_cls = bench_attn.cls_heavy(torch.randn(Bk, N, 3 * C, generator=gen, device=dev),
                                   H).to(bf)
    every = torch.ones(Bk, N, device=dev)
    flops = 4.0 * Bk * H * N * N * D
    b = bound(flops, 2.0 * (Bk * N * 3 * C + Bk * N * C + Bk * H * N * N))
    b_np = bound(flops, 2.0 * (Bk * N * 3 * C + Bk * N * C))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), scale=SCALE))

    # T1 on separate q, k, v and on the column views of the packed qkv, at
    # 1 and 2 heads and 1 and 2 sequences a block, with probs
    probs = torch.empty(Bk, H, N, N, dtype=bf, device=dev)
    views = qkv.split(C, -1)
    q, k, v = (t.contiguous() for t in views)
    ref, ref_probs = bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)
    configs = {}
    for layout, qkv3 in (("separate", (q, k, v)), ("views", views)):
        for hps, g in ((2, 1), (1, 1), (1, 2), (2, 2)):
            case = f"headgrid_attn {layout} hps={hps} g={g}"
            out, _ = bench_attn.headgrid_attn(*qkv3, H, SCALE, g, hps, probs)
            configs[f"{layout} hps={hps} g={g}"] = dict(
                **_fwd_check(case, out, ref, every), **_probs_errors(case, probs, ref_probs))
    out_np, _ = bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2)
    t1 = _fwd_check("headgrid_attn without probs", out_np, ref, every)
    k1_out, _ = ops.attention_qkv(qkv, H, SCALE)
    torch.cuda.synchronize()
    vs_k1 = _bench.bf16_off_share(out_np, k1_out)
    del ref_probs, k1_out
    unrounded = bench_attn.headgrid_attn_plain(q.float(), k.float(), v.float(), H, SCALE,
                                               False).to(bf)
    q_c, k_c, v_c = (t.contiguous() for t in qkv_cls.split(C, -1))
    ref_c = bench_attn.headgrid_attn_plain(q_c, k_c, v_c, H, SCALE, False)
    t1_cls = _fwd_check("headgrid_attn cls-heavy", bench_attn.headgrid_attn(
        q_c, k_c, v_c, H, SCALE, 1, 2)[0], ref_c, every)
    caught = _t12_wrong_forms("headgrid_attn", unrounded, ref,
                              ops.attention_qkv_plain(qkv_cls, H, SCALE, False), ref_c)
    del unrounded, q_c, k_c, v_c, ref_c
    # x30 (|logit| ~ 1e3) and B = 3 past one key chunk (N = 200: the chunked
    # instance), as K1's
    q30, k30, v30 = (randn(Bk, N, C, mul=30.0) for _ in range(3))
    out30, _ = bench_attn.headgrid_attn(q30, k30, v30, H, SCALE, 1, 2, probs)
    torch.cuda.synchronize()
    if not torch.isfinite(out30.float()).all():
        raise AssertionError("headgrid_attn: non-finite output at |logit| ~ 1e3")
    t1_30 = _k1_errors("headgrid_attn x30", out30, probs, bench_attn.headgrid_attn_plain(
        q30, k30, v30, H, SCALE, True), scaled=True)
    del q30, k30, v30, out30
    qx, kx, vx = (randn(3, 200, C) for _ in range(3))
    px = torch.empty(3, H, 200, 200, dtype=bf, device=dev)
    ox, _ = bench_attn.headgrid_attn(qx, kx, vx, H, SCALE, 2, 2, px)
    ref_x = bench_attn.headgrid_attn_plain(qx, kx, vx, H, SCALE, True)
    t1_x = dict(**_fwd_check("headgrid_attn B=3 N=200", ox, ref_x[0], torch.ones(3, 200,
                                                                                 device=dev)),
                **_probs_errors("headgrid_attn B=3 N=200", px, ref_x[1]))
    del qx, kx, vx, px, ox, ref_x
    row = dict(max_abs_err=max(max(c["err"], c["probs_err"]) for c in configs.values()),
               ms=cuda_ms(lambda: bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2, probs)),
               plain_ms=cuda_ms(lambda: bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)),
               library_ms=sdpa_ms,
               ms_no_probs=cuda_ms(lambda: bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2)),
               bound_ms_no_probs=b_np["bound_ms"], config="hps=2 g=1, separate q, k, v",
               share=configs["separate hps=2 g=1"]["share"],
               probs_ulps=max(c["probs_ulps"] for c in configs.values()),
               row_sum_err=max(c["row_sum_err"] for c in configs.values()),
               cls_heavy_share=t1_cls["share"], wrong_forms=caught, share_off_k1=vs_k1,
               configs=configs, x30=t1_30, chunked_N200=t1_x, **b)
    _at_most_2x_sdpa("headgrid_attn", row["ms"], sdpa_ms)
    results["headgrid_attn"] = row
    say("7 variant headgrid_attn (T1)", shape=list(q.shape), config=repr(row["config"]),
        share=row["share"], share_tol=SHARE_TOL, no_probs_share=t1["share"],
        cls_heavy_share=t1_cls["share"], wrong_forms=json.dumps(caught),
        probs_ulps=row["probs_ulps"], row_sum_err=row["row_sum_err"], share_off_k1=vs_k1,
        configs=json.dumps(configs), x30=json.dumps(t1_30), chunked_N200=json.dumps(t1_x),
        ms=f"{row['ms']:.4f}", ms_no_probs=f"{row['ms_no_probs']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_ms_no_probs=f"{b_np['bound_ms']:.4f}")
    del q, k, v, views, out, out_np, ref

    # T2 on the packed qkv at 1 and 2 sequences a block. Without the row max
    # |logit| must stay < ~80: no x30 stress
    ref = bench_attn2.nomax_attn_plain(qkv, H, SCALE)
    t2 = {f"g={g}": _fwd_check(f"nomax_attn g={g}", bench_attn2.nomax_attn(qkv, H, SCALE, g),
                               ref, every) for g in (1, 2)}
    ref_c = bench_attn2.nomax_attn_plain(qkv_cls, H, SCALE)
    t2_cls = _fwd_check("nomax_attn cls-heavy", bench_attn2.nomax_attn(qkv_cls, H, SCALE, 1),
                        ref_c, every)
    caught = _t12_wrong_forms(
        "nomax_attn", bench_attn2.nomax_attn_plain(qkv.float(), H, SCALE).to(bf), ref,
        ops.attention_qkv_plain(qkv_cls, H, SCALE, False), ref_c)
    del ref_c, qkv_cls
    qx = randn(3, 512, 3 * C)  # B = 3 past one key chunk: the chunked instance
    t2_x = _fwd_check("nomax_attn B=3 N=512", bench_attn2.nomax_attn(qx, H, SCALE, 2),
                      bench_attn2.nomax_attn_plain(qx, H, SCALE), torch.ones(3, 512, device=dev))
    del qx
    row = dict(max_abs_err=max(c["err"] for c in t2.values()),
               ms=cuda_ms(lambda: bench_attn2.nomax_attn(qkv, H, SCALE, 1)),
               plain_ms=cuda_ms(lambda: bench_attn2.nomax_attn_plain(qkv, H, SCALE)),
               library_ms=sdpa_ms, config="g=1", share=t2["g=1"]["share"],
               cls_heavy_share=t2_cls["share"], wrong_forms=caught, configs=t2,
               chunked_N512=t2_x, **b_np)
    _at_most_2x_sdpa("nomax_attn", row["ms"], sdpa_ms)
    results["nomax_attn"] = row
    say("7 variant nomax_attn (T2)", shape=list(qkv.shape), config="'g=1'",
        share=row["share"], share_tol=SHARE_TOL, cls_heavy_share=t2_cls["share"],
        wrong_forms=json.dumps(caught), configs=json.dumps(t2), chunked_N512=json.dumps(t2_x),
        ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        bound_ms=f"{b_np['bound_ms']:.4f}")
    del qkv, ref, every

    # T3: the half-layer at the JAX tool's groups, with and without probs.
    # End to end its output is chaotic in the qkv product's summation order
    # (bench_attn_layer.stage_shares), so the share test reads each stage
    # against the TPU form of the kernel's own input to it, with the wrong
    # forms required to fail at the stage where each acts; the attention
    # stage must be K1's output on the kernel's qkv bit for bit
    ins = bench_attn_layer.layer_inputs(gen)
    out, _ = bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1, probs)
    ref, ref_probs = bench_attn_layer.attn_layer_plain(*ins, H, SCALE, 1e-6, True)
    torch.cuda.synchronize()
    e_out = _scaled(out, ref)
    _require("attn_layer out (scaled)", e_out, 1e-2)
    t3 = _probs_errors("attn_layer", probs, ref_probs, own_qkv=True)
    e_probs = t3["probs_err"]
    end_share = _bench.bf16_off_share(out, ref)
    del ref, ref_probs
    for g in (2, 4):  # the JAX tool's groups: each row computed as at g = 1
        if not torch.equal(bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, g)[0], out):
            raise AssertionError(f"attn_layer g={g}: output differs from g=1's")
    t3_stages = _t3_stages("attn_layer", ins, H, SCALE, out)
    extra = {}
    for Bx, Nx, Cx, Hx, g in ((3, 200, C, H, 2), (5, 17, 256, 8, 2)):
        xi = bench_attn_layer.layer_inputs(gen, Bx, Nx, Cx)
        case = f"attn_layer B={Bx} N={Nx} C={Cx} H={Hx} g={g}"
        o, _ = bench_attn_layer.attn_layer(*xi, Hx, (Cx // Hx) ** -0.5, 1e-6, g)
        e = _scaled(o, bench_attn_layer.attn_layer_plain(*xi, Hx, (Cx // Hx) ** -0.5, 1e-6,
                                                         False))
        _require(f"{case} (scaled)", e, 1e-2)
        extra[case] = dict(err=e, **_t3_stages(case, xi, Hx, (Cx // Hx) ** -0.5, o, g))
    b = dict(zip(("bound_ms", "bound_by"), bench_attn_layer.layer_bound(with_probs=True)))
    b_np = bench_attn_layer.layer_bound()[0]
    sdpa = lambda t: bench_attn_layer.sdpa_from_qkv(t, H, SCALE)
    row = dict(max_abs_err=max(e_out, e_probs),
               ms=cuda_ms(lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1, probs)),
               plain_ms=cuda_ms(lambda: bench_attn_layer.attn_layer_plain(*ins, H, SCALE, 1e-6,
                                                                          True)),
               library_ms=cuda_ms(lambda: bench_attn_layer.composed(*ins, H, SCALE,
                                                                    attention=sdpa)),
               composed_k1_ms=cuda_ms(lambda: bench_attn_layer.composed(*ins, H, SCALE,
                                                                        probs_out=probs)),
               ms_no_probs=cuda_ms(lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1)),
               bound_ms_no_probs=b_np, config="g=1", probs_ulps=t3["probs_ulps"],
               probs_share=t3["probs_share"], row_sum_err=t3["row_sum_err"],
               end_to_end_share=end_share, stages=t3_stages, extra_shapes=extra, **b)
    flops = bench_attn_layer.layer_flops()
    results["attn_layer"] = row
    say("7 variant attn_layer (T3)", shape=list(ins[0].shape), config="'g=1'",
        scaled_err=e_out, end_to_end_share=end_share, stages=json.dumps(t3_stages),
        probs_err=e_probs, probs_ulps=t3["probs_ulps"], probs_share=t3["probs_share"],
        share_tol=SHARE_TOL, row_sum_err=t3["row_sum_err"], equal_at_g="2 4",
        extra_shapes=json.dumps(extra), ms=f"{row['ms']:.4f}",
        ms_no_probs=f"{row['ms_no_probs']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
        chain4_sdpa_ms=f"{row['library_ms']:.4f}",
        composed_k1_ms=f"{row['composed_k1_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
        bound_ms_no_probs=f"{b_np:.4f}", bound_by=b["bound_by"],
        tflops=f"{flops / row['ms_no_probs'] / 1e9:.1f}",
        l2_weight_gb=f"{bench_attn_layer.weight_bytes(Bk, N, C, 1) / 1e9:.3f}")
    if not row["ms_no_probs"] <= 2.0 * row["library_ms"]:
        raise AssertionError(f"attn_layer: {row['ms_no_probs']} ms without probs, more than 2x "
                             f"the four-call chain's {row['library_ms']} ms")
    del ins, out, probs
    torch.cuda.empty_cache()

    # T4 and T5 on phase 2's peaked maps (L = 12, Z = 4608, N = 129). The bf16
    # chain rounds v[n >= 1] to bf16 before each patch product on both sides;
    # a different fp32 summation order moves a v[n] across a rounding boundary
    # now and then, which changes an output by at most one bf16 step of that
    # v[n] times weights that sum to 1: the max limit is one bf16 ulp of the
    # output's largest magnitude. That limit is wider than the whole gap
    # between the bf16 and the fp32 chain, so the rounding points are held by
    # the share of outputs more than 8 fp32 ulps off the plain bf16 chain: at
    # most 5% for the kernels (another summation order leaves well under 1%
    # off), at least 50% for the plain fp32 chain (the check tells the two
    # chains apart). `rows` is fp32 math in another order: K2's limit, 1e-5.
    L = 12
    maps = torch.empty(L, Bk, H, N, N, dtype=bf, device=dev)
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bk, H, N, N, generator=gen, device=dev),
                                dim=-1).to(bf)
    b = bound(2.0 * (L - 1) * Bk * H * N * N, 2.0 * L * Bk * H * N * N + 4.0 * Bk * H * (N - 1))
    ref_bf = bench_rollout.chain_plain(maps, "bf16")
    ref_f32 = bench_rollout.chain_plain(maps, "f32")
    tol_bf, share_tol = _bench.ulp_of_max(ref_bf), 0.05
    f32_share = _bench.mismatch_share(ref_f32, ref_bf)
    if not f32_share >= 0.5:
        raise AssertionError(f"plain fp32 vs bf16 chain: only {f32_share} of the outputs differ")

    def rounding_check(name, got):
        e, share = _max_err(got, ref_bf), _bench.mismatch_share(got, ref_bf)
        _require(f"{name} max", e, tol_bf)
        _require(f"{name} share off the plain bf16 chain", share, share_tol)
        return e, share

    got_bf = bench_rollout.chain(maps, "bf16", 1)
    got_rows = bench_rollout.chain(maps, "rows", 1)
    torch.cuda.synchronize()
    e_bf, share_bf = rounding_check("chain bf16", got_bf)
    e_rows = _max_err(got_rows, ref_f32)
    _require("chain rows", e_rows, 1e-5)
    row = dict(max_abs_err=e_bf, ms=cuda_ms(lambda: bench_rollout.chain(maps, "bf16", 1)),
               plain_ms=cuda_ms(lambda: bench_rollout.chain_plain(maps, "bf16")),
               library_ms=None, tol=tol_bf, mismatch_share=share_bf,
               f32_mismatch_share=f32_share, rows_err=e_rows,
               rows_ms=cuda_ms(lambda: bench_rollout.chain(maps, "rows", 1)),
               config="bf16 g=1; rows g=1", **b)
    results["chain"] = row
    say("7 variant chain (T4)", L=L, Z=Bk * H, N=N, bf16_err=e_bf, tol=tol_bf,
        mismatch_share=share_bf, share_tol=share_tol, f32_chain_mismatch_share=f32_share,
        bf16_vs_f32_err=_max_err(got_bf, ref_f32), rows_err=e_rows, rows_tol=1e-5,
        ms=f"{row['ms']:.4f}", rows_ms=f"{row['rows_ms']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    got = bench_rollout2.chain_multi(maps, 4, 1)
    torch.cuda.synchronize()
    e, share = rounding_check("chain_multi", got)
    row = dict(max_abs_err=e, ms=cuda_ms(lambda: bench_rollout2.chain_multi(maps, 4, 1)),
               plain_ms=cuda_ms(lambda: bench_rollout2.chain_multi_plain(maps)),
               library_ms=None, tol=tol_bf, mismatch_share=share, config="T=4 g=1", **b)
    results["chain_multi"] = row
    say("7 variant chain_multi (T5)", L=L, Z=Bk * H, N=N, config="'T=4 g=1'", err=e, tol=tol_bf,
        mismatch_share=share, share_tol=share_tol,
        equal_to_chain_bf16=bool(torch.equal(got, got_bf)), ms=f"{row['ms']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    del maps, ref_bf, ref_f32, got_bf, got_rows, got
    torch.cuda.empty_cache()

    # T6: K3 and K5 walking g sequences a block at the JAX package's groups
    # (bench_full_kernel.full_group: forward 8, backward 4 at [384, 88];
    # both 2 at [128, 264]), masks as phase 2's; one forward and one backward
    # of each shape. The counts sit at the launch: the walking pair counts as
    # T6 alone, the group-0 pair (K3 and K5) as K3 and K5 alone. Each pair is
    # computed as K3's and K5's blocks compute it, so T6 must equal them bit
    # for bit; and it is held by K3's and K5's share tests and wrong forms
    calls = []
    for Bm, Nm in ((3 * B_EVAL, 88), (B_EVAL, 264)):
        qkv = randn(Bm, Nm, 3 * C)
        m = torch.rand(Bm, Nm, generator=gen, device=dev) < 0.5
        m = (m | (torch.arange(Nm, device=dev) % 88 == 0)[None, :]).float()
        m[0, 1:] = 0.0  # one sequence with only its cls token
        g = randn(Bm, Nm, C)
        gf, gb = bench_full_kernel.full_group(Nm, Bm), bench_full_kernel.full_group(Nm, Bm, True)
        reset_counts()
        fwd = bench_full_kernel.masked_full(qkv, m, H, SCALE, gf)
        bwd = bench_full_kernel.masked_full_bwd(qkv, m, g, H, SCALE, gb)
        counts = [launch_counts()]
        fwd0 = ops.masked_attention_qkv(qkv, m, H, SCALE, FILL)
        bwd0 = ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL)
        counts.append(launch_counts())
        torch.cuda.synchronize()
        seen = [(c["masked_full"], c["masked_attention_qkv"], c["masked_attention_qkv_bwd"])
                for c in counts]
        if seen != [(2, 0, 0), (2, 1, 1)]:
            raise AssertionError(f"(T6, K3, K5) launches after the walking pair and then the "
                                 f"group-0 pair: {seen} != [(2, 0, 0), (2, 1, 1)]")
        if not (torch.equal(fwd, fwd0) and torch.equal(bwd, bwd0)):
            raise AssertionError(f"masked_full N={Nm}: g = {gf} (forward), {gb} (backward) "
                                 "not bit-identical to K3 and K5 at group 0")
        del fwd0, bwd0
        # the forward against the TPU body's form (masked_full_plain), by K3's
        # share test, which must fail the unrounded and the XLA form
        ref_f = bench_full_kernel.masked_full_plain(qkv, m, H, SCALE)
        t6 = _fwd_check(f"masked_full N={Nm}", fwd, ref_f, m)
        caught_f = _k3_wrong_forms(qkv, m, ref_f, H, D)
        e_f = t6["err"]
        del ref_f
        # the backward by K5's check and wrong forms (unrounded; cls-kept)
        ref_b = bench_full_kernel.masked_full_bwd_plain(qkv, m, g, H, SCALE)
        k5 = _k5_check(f"masked_full_bwd N={Nm}", bwd, ref_b, m, C)
        caught_b = _wrong_forms(
            "masked_full_bwd",
            ops.masked_attention_qkv_bwd_plain(qkv.float(), m, g.float(), H, SCALE,
                                               FILL).to(torch.bfloat16),
            ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, K5_CLS_ROWS),
            ref_b, K5_CLS_ROWS, C, "cls_kept")
        e_b = k5["scaled_err"]
        del ref_b
        pairs = float((m.sum(1) ** 2).sum())
        keys = m.bool()[:, None, None, :]
        c = dict(err=max(e_f, e_b), flops=14.0 * H * D * pairs,
                 bytes=2.0 * Bm * Nm * (4 * C + 7 * C) + 8.0 * Bm * Nm,
                 ms=cuda_ms(lambda: bench_full_kernel.masked_full(qkv, m, H, SCALE, gf))
                 + cuda_ms(lambda: bench_full_kernel.masked_full_bwd(qkv, m, g, H, SCALE, gb)),
                 plain_ms=cuda_ms(lambda: bench_full_kernel.masked_full_plain(qkv, m, H, SCALE))
                 + cuda_ms(lambda: bench_full_kernel.masked_full_bwd_plain(qkv, m, g, H, SCALE)),
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                     *_heads(qkv), attn_mask=keys, scale=SCALE)) + _sdpa_bwd_ms(qkv, g, m.bool()))
        c.update(fwd_share=t6["share"], fwd_wrong_forms=caught_f, bwd_share=k5["share"],
                 bwd_cls_share=k5["cls_share"], bwd_wrong_forms=caught_b)
        calls.append(c)
        say("7 variant masked_full (T6)", shape=list(qkv.shape), g_fwd=gf, g_bwd=gb,
            equal_to_group0=True, fwd_err=e_f, fwd_share=t6["share"], share_tol=SHARE_TOL,
            fwd_wrong_forms=json.dumps(caught_f), bwd_scaled_err=e_b, bwd_share=k5["share"],
            bwd_cls_share=k5["cls_share"], bwd_wrong_forms=json.dumps(caught_b),
            ms=f"{c['ms']:.4f}", plain_ms=f"{c['plain_ms']:.4f}",
            sdpa_fwd_bwd_ms=f"{c['library_ms']:.4f}",
            bound_ms=f"{bound(c['flops'], c['bytes'])['bound_ms']:.4f}")
        del qkv, g, fwd, bwd
    _sum_rows(results, "masked_full", calls, phase="7")
    t6_ms, sdpa_ms = results["masked_full"]["ms"], results["masked_full"]["library_ms"]
    if not t6_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_full: {t6_ms} ms forward + backward on the two shapes, "
                             f"more than 2x SDPA's forward + backward with the key mask, "
                             f"{sdpa_ms} ms")
    say("7 sum masked_full vs sdpa fwd + bwd", ms=f"{t6_ms:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        factor=f"{t6_ms / sdpa_ms:.3f}", limit="2")
    results["masked_full"].update(
        config="JAX `_full_group` groups, forward + backward", equal_to_group0=True,
        **{k: [c[k] for c in calls]
           for k in ("fwd_share", "fwd_wrong_forms", "bwd_share", "bwd_cls_share",
                     "bwd_wrong_forms")})
    return results


def _eval_batch(gen: torch.Generator, B: int) -> dict:
    images = {m: torch.randn(B, 256, 128, 3, generator=gen, device="cuda")
              for m in ("RGB", "NI", "TI")}
    images["camid"] = torch.arange(B, device="cuda") % 6
    return images


def flagship(opts=()):
    """(Config, EditorConfig): the RGBNT201 preset with ``opts`` on top,
    through editor_config_from, so one source sets the solver and the model."""
    from editor_tpu_torch.tools.profile_forward import flagship_from_opts

    return flagship_from_opts(opts)


def launch_counts() -> dict:
    """Launches of each kernel row since the last reset_counts(), counted
    where the kernel launches: K1-K8 by their wrappers (K3, K5 and K6 at the
    model paths' group 0), T1-T5 by the wrapper of the same name in their tool
    module, T6 (masked_full) by K3's and K5's launches at groups g >= 1, and
    K6's own at g >= 1 (the group sweep of bench_attn2) apart."""
    import importlib

    from editor_tpu_torch import ops

    counts = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    for name, spec in VARIANTS.items():
        if name != "masked_full":
            mod = importlib.import_module(f"editor_tpu_torch.tools.{spec['tool']}")
            counts[name] = getattr(mod, name).launches
    counts["masked_full"] = (ops.masked_attention_qkv.variant_launches
                             + ops.masked_attention_qkv_bwd.variant_launches)
    counts["masked_attention_tiled (group >= 1)"] = ops.masked_attention_tiled.variant_launches
    return counts


def reset_counts() -> None:
    """Every kernel's launch count to 0, the T-kernels' too."""
    import importlib

    from editor_tpu_torch import ops

    ops.reset_launch_counts()
    for name, spec in VARIANTS.items():
        if name != "masked_full":
            getattr(importlib.import_module(f"editor_tpu_torch.tools.{spec['tool']}"),
                    name).launches = 0


def expected(**counts) -> dict:
    """Launch counts of one call: every kernel 0 unless named."""
    return {name: counts.get(name, 0) for name in launch_counts()}


def _feature_agreement(got, ref):
    """(min per-row cosine, max per-row rel-L2) of two feature batches."""
    got, ref = got.double(), ref.double()
    cos = (torch.nn.functional.normalize(got, dim=1)
           * torch.nn.functional.normalize(ref, dim=1)).sum(1)
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-12)
    return float(cos.min()), float(rel.max())


def eval_check(ecfg, gen: torch.Generator, label: str, want: dict):
    """The eval forward of ``ecfg`` (seeded weights, B=128, bf16) through
    build_eval_step: the launch counts of one forward, the features against
    the same model run with the plain ops in fp32 (per-row cosine >= 0.99,
    rel-L2 <= 0.08), and the forward's time from CUDA events."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init

    t0 = time.perf_counter()
    model = editor_init(ecfg, seed=0)
    init_s = time.perf_counter() - t0
    ref_model = Editor(dataclasses.replace(ecfg, use_pallas=False))
    ref_model.load_state_dict(model.state_dict(), strict=True)
    batch = _eval_batch(gen, B_EVAL)
    step = build_eval_step(model, torch.bfloat16)

    step(batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    reset_counts()
    feats = step(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} in one forward")
    if feats.shape != (B_EVAL, 3 * C) or feats.dtype != torch.float32:
        raise AssertionError(f"features {tuple(feats.shape)} {feats.dtype}")
    if not torch.isfinite(feats).all():
        raise AssertionError("non-finite features")
    ref = build_eval_step(ref_model, torch.float32)(batch)
    torch.cuda.synchronize()
    min_cos, max_rel = _feature_agreement(feats, ref)
    if not (min_cos >= 0.99 and max_rel <= 0.08):
        raise AssertionError(f"bf16 kernels vs fp32 plain: min cos {min_cos}, "
                             f"max rel-L2 {max_rel}")
    fwd_ms = cuda_ms(lambda: step(batch), iters=5)
    say(label, B=B_EVAL, compact_tail=ecfg.compact_tail, shape=list(feats.shape),
        launches=json.dumps(launches), min_cos=f"{min_cos:.6f}", max_rel_l2=f"{max_rel:.6f}",
        fwd_ms=f"{fwd_ms:.2f}", img_s=f"{B_EVAL / fwd_ms * 1e3:.1f}", init_s=f"{init_s:.2f}")
    return model, ref_model, batch, ref, launches


def forward_phase(gen: torch.Generator):
    """Phase 3: the flagship eval forward (compact tail) through K1-K3."""
    _, ecfg = flagship()
    model, _, _, _, launches = eval_check(
        ecfg, gen, "3 forward",
        expected(attention_qkv=ecfg.vit.depth, rollout_chain=1, masked_attention_qkv=2))
    return model, launches


def serving_phase(model, gen: torch.Generator, card: str) -> None:
    from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

    n_ids = 64
    rng = np.random.RandomState(0)
    gallery = {m: rng.randint(0, 256, (n_ids, 256, 128, 3), dtype=np.uint8)
               for m in ("RGB", "NI", "TI")}
    cams = (np.arange(n_ids) % 6).astype(np.int32)
    cfg, _ = flagship()
    ex = FeatureExtractor(model, batch_size=32, compute_dtype=torch.bfloat16,
                          input_cfg=cfg.INPUT)
    if ex.size_hw != tuple(cfg.INPUT.SIZE_TEST):
        raise AssertionError(f"FeatureExtractor size_hw {ex.size_hw} != SIZE_TEST")
    gf = ex(gallery, cams)
    index = GalleryIndex(ex.feat_dim, feat_norm=True)
    index.add(gf, pids=list(range(n_ids)), camids=cams.tolist())
    for size in (1, 3, 32):
        pick = rng.choice(n_ids, size=size, replace=False)
        qf = ex({m: v[pick] for m, v in gallery.items()}, cams[pick])
        res = index.search(qf, topk=5)
        top1 = [r[0]["pid"] for r in res]
        if top1 != pick.tolist():
            raise AssertionError(f"query size {size}: rank-1 {top1} != {pick.tolist()}")
    lat = []
    for i in range(21):
        one = {m: v[i % n_ids:i % n_ids + 1] for m, v in gallery.items()}
        t0 = time.perf_counter()
        res = index.search(ex(one, cams[i % n_ids:i % n_ids + 1]), topk=5)
        lat.append((time.perf_counter() - t0) * 1e3)
        if res[0][0]["pid"] != i % n_ids:
            raise AssertionError("batch-1 query missed its gallery item")
    say("4 serving", gallery=n_ids, query_sizes="1,3,32", rank1="all",
        batch1_p50_ms=f"{float(np.median(lat[1:])):.2f}", card=repr(card))


def _param_norm(model) -> float:
    return float(torch.stack([p.detach().float().norm() for p in model.parameters()]).norm())


def _grads_finite(model) -> bool:
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(grads))).all())


def train_check(cfg, ecfg, gen: torch.Generator, label: str, want: dict,
                learn: bool, before_reference=None) -> dict:
    """The train step of ``ecfg`` with the solver of ``cfg`` (B=128 as 8 ids x
    16, uint8 images through the augmentation, bf16) through
    build_train_step: the launch counts of each of 3 steps; losses within 3%
    and the parameter norm within 2% of the same model run with the plain
    ops in fp32 (same weights, batch and random draws); finite losses and
    gradients; BN stats and OCFR centers move; step time, img/s and peak
    memory; with ``learn``, 20 steps on one fixed batch lower the loss.
    ``before_reference`` is called between the kernel steps and the plain
    fp32 steps (phase 12 (b): the MoE's routing replayed)."""
    from editor_tpu_torch.data.transforms import make_eval_transform, make_train_augment
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch import ops
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
    model = editor_init(ecfg, seed=0)
    ref_model = Editor(dataclasses.replace(ecfg, use_pallas=False))
    ref_model.load_state_dict(model.state_dict(), strict=True)

    def make_step(m, dtype, augment=True):
        return build_train_step(m, make_optimizer(cfg, m), make_loss(cfg, ecfg.num_classes),
                                make_scheduler(cfg), cfg.SOLVER.BASE_LR, dtype,
                                augment=make_train_augment(cfg.INPUT) if augment else None,
                                seed=1)

    h, w = ecfg.vit.img_size
    batch = {m: torch.randint(0, 256, (B, h, w, 3), generator=gen, device="cuda",
                              dtype=torch.uint8) for m in ("RGB", "NI", "TI")}
    batch["pid"] = torch.arange(B, device="cuda") // K  # 8 ids x 16 instances
    batch["camid"] = torch.arange(B, device="cuda") % 6
    states = lambda m: {n: b.clone() for n, b in m.named_buffers()
                        if "running" in n or "centers" in n}

    step = make_step(model, torch.bfloat16)
    before = states(model)
    start = [p.detach().clone() for p in model.parameters()]
    losses = []
    for epoch in (1, 2, 3):
        reset_counts()
        loss = float(step(batch, epoch)["loss"])
        launches = launch_counts()
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want} in one train step")
        if not (np.isfinite(loss) and _grads_finite(model)):
            raise AssertionError(f"non-finite loss {loss} or gradients at step {epoch}")
        losses.append(loss)
    still = [n for n, b in states(model).items() if torch.equal(b, before[n])]
    if still:
        raise AssertionError(f"train state did not move: {still}")
    norm = _param_norm(model)

    # the same weights, batch and random draws through the plain ops in fp32
    if before_reference is not None:
        before_reference()
    ref_step = make_step(ref_model, torch.float32)
    ref_losses = [float(ref_step(batch, epoch)["loss"]) for epoch in (1, 2, 3)]
    ref_norm = _param_norm(ref_model)
    # the three steps' change of every parameter, bf16 kernels vs fp32 plain
    upd = torch.cat([(p.detach() - p0).flatten() for p, p0 in zip(model.parameters(), start)])
    ref_upd = torch.cat([(p.detach() - p0).flatten()
                         for p, p0 in zip(ref_model.parameters(), start)])
    upd_cos = float(torch.nn.functional.cosine_similarity(upd, ref_upd, dim=0))
    upd_rel = float((upd - ref_upd).norm() / ref_upd.norm())
    del ref_step, ref_model, start, upd, ref_upd
    torch.cuda.empty_cache()
    dloss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    dnorm = abs(norm - ref_norm) / ref_norm
    if not (max(dloss) <= 0.03 and dnorm <= 0.02):
        raise AssertionError(f"bf16 kernels vs fp32 plain: losses {losses} vs {ref_losses}, "
                             f"param norm {norm} vs {ref_norm}")
    say(label, B=B, ids=B // K, compact_tail=ecfg.compact_tail, launches=json.dumps(launches),
        loss=json.dumps([round(x, 5) for x in losses]),
        ref_loss=json.dumps([round(x, 5) for x in ref_losses]),
        max_rel_dloss=f"{max(dloss):.5f}", rel_dnorm=f"{dnorm:.2e}",
        update_cos=f"{upd_cos:.5f}", update_rel_l2=f"{upd_rel:.5f}")

    # step time: CUDA events over 5 steps after 2 warm-ups
    epoch = cfg.SOLVER.WARMUP_ITERS + 1  # past the warmup: the full base lr
    for _ in range(2):
        step(batch, epoch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch, epoch), iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timing = dict(step_ms=f"{step_ms:.2f}", img_s=f"{B / step_ms * 1e3:.1f}",
                  peak_gb=f"{peak_gb:.2f}")
    if learn:  # 20 steps on one fixed batch (no augmentation) at that lr
        norm_img = make_eval_transform(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
        fixed = {m: norm_img(batch[m]) for m in ("RGB", "NI", "TI")}
        fixed.update(pid=batch["pid"], camid=batch["camid"])
        learner = make_step(model, torch.bfloat16, augment=False)
        curve = [float(learner(fixed, epoch)["loss"]) for _ in range(20)]
        if not np.mean(curve[-5:]) < np.mean(curve[:5]):
            raise AssertionError(f"the loss did not go down on a fixed batch: {curve}")
        timing.update(learn_first5=f"{np.mean(curve[:5]):.4f}",
                      learn_last5=f"{np.mean(curve[-5:]):.4f}")
    say(f"{label} timing", **timing)
    return launches, step_ms


def train_phase(gen: torch.Generator) -> tuple:
    """Phase 5: the flagship train step (compact tail): K1, K2, K3 forward,
    K4, K5 backward. Returns its launches and its ms per step."""
    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    return train_check(cfg, ecfg, gen, "5 train",
                       expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                                attention_qkv_bwd=L, masked_attention_qkv_bwd=2),
                       learn=True)


def uncompacted_phase(gen: torch.Generator):
    """Phase 6: the flagship model with TPU.COMPACT_TAIL off, through
    load_config -> editor_config_from: 129 tokens per modality and 387 joint,
    so the fusion block's attention runs K6 forward and K7 backward.
    (a) the eval forward against the plain fp32 run; (b) the compaction is
    exact on the card: the compact model with the same weights, both through
    the plain ops in fp32, gives the same features (rel-L2 <= 1e-4); (c) the
    train step against the plain fp32 run; (d) its time."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor

    cfg, ecfg = flagship(["TPU.COMPACT_TAIL", "False"])
    if ecfg.compact_tail:
        raise AssertionError("TPU.COMPACT_TAIL False did not reach the model config")
    L = ecfg.vit.depth
    model, ref_model, batch, ref, eval_launches = eval_check(
        ecfg, gen, "6a uncompacted forward",
        expected(attention_qkv=L, rollout_chain=1, masked_attention_tiled=2))
    compact = Editor(dataclasses.replace(ecfg, compact_tail=True, use_pallas=False))
    compact.load_state_dict(ref_model.state_dict(), strict=True)
    comp = build_eval_step(compact, torch.float32)(batch)
    torch.cuda.synchronize()
    _, rel = _feature_agreement(comp, ref)
    if not rel <= 1e-4:
        raise AssertionError(f"compact vs uncompacted tail (fp32 plain): rel-L2 {rel}")
    say("6b compaction exact", max_rel_l2=f"{rel:.3e}", limit="1e-4")
    del model, ref_model, compact, batch, ref, comp
    torch.cuda.empty_cache()
    train_launches, _ = train_check(
        cfg, ecfg, gen, "6c uncompacted train",
        expected(attention_qkv=L, rollout_chain=1, attention_qkv_bwd=L,
                 masked_attention_tiled=2, masked_attention_tiled_bwd=2),
        learn=False)
    return eval_launches, train_launches


# The training loop (phase 8). The checked runs train on 16 ids x 32 items
# (the P x K sampler makes 3 batches of 8 ids x 16 an epoch); the timed run on
# RGBNT201's train split in size (171 ids, 3951 items: 21 batches an epoch).
# Evaluation as RGBNT201's test split: 30 ids, 836 items in 4 cameras, query
# = gallery = the same items (each query has 20 or 21 matches in other cameras)
LOOP_IDS, LOOP_PER_ID = 16, 32
TRAIN_IDS, TRAIN_ITEMS, TEST_IDS, TEST_ITEMS, CAMS = 171, 3951, 30, 836, 4


def _spread(n_items: int, n_ids: int, first_pid: int = 0) -> list:
    """(index, pid, camid) of ``n_items`` over ``n_ids`` ids as evenly as
    they go, each id's items in turn over the cameras."""
    per, extra = divmod(n_items, n_ids)
    out = []
    for pid in range(n_ids):
        for j in range(per + (pid < extra)):
            out.append((len(out), first_pid + pid, j % CAMS))
    return out


def _loop_data(size_hw):
    """(checked splits, timed splits, decode_fn) of phase 8 at ``size_hw``:
    per-identity uint8 prototypes plus noise from the seed, four noisy
    variants an identity made once, so that the decode costs the host only
    the batch's copy (the loader's)."""
    from editor_tpu_torch.data.datasets import DatasetSplits

    checked = [(("train", i), i // LOOP_PER_ID, i % CAMS, -1)
               for i in range(LOOP_IDS * LOOP_PER_ID)]
    timed = [(("train", i), pid, cam, -1) for i, pid, cam in _spread(TRAIN_ITEMS, TRAIN_IDS)]
    test = [(("test", i), pid, cam, -1)
            for i, pid, cam in _spread(TEST_ITEMS, TEST_IDS, first_pid=1000)]
    rng = np.random.default_rng(0)
    bank = {}
    for pid in sorted({it[1] for it in timed + test}):
        proto = rng.integers(0, 256, (3, *size_hw, 3), dtype=np.int16)
        bank[pid] = [np.clip(proto + rng.integers(-25, 26, proto.shape, dtype=np.int16),
                             0, 255).astype(np.uint8) for _ in range(4)]

    def decode(item):
        return list(bank[item[1]][(item[0][1] // CAMS) % 4])

    return (DatasetSplits(checked, test, test, LOOP_IDS, CAMS),
            DatasetSplits(timed, test, test, TRAIN_IDS, CAMS), decode)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _event_pair() -> tuple:
    """Two timing events, the first recorded now."""
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev[0].record()
    return ev


class _LoopProbe:
    """Wraps the builders of the loop's train step and eval step (the loop
    and ``do_inference`` look them up at call time): per train step the
    launch counts it added, CUDA events recorded at its start and its end
    (after its last launch) and, with ``read_loss``, its loss (a host sync);
    per eval batch the launch counts and the same two events."""

    def __init__(self, read_loss: bool = True):
        self.read_loss = read_loss
        self.steps, self.events, self.losses, self.evals = [], [], [], []
        self.eval_events = []

    def __enter__(self):
        from editor_tpu_torch.engine import evaluate, loop

        self._saved = loop.build_train_step, evaluate.build_eval_step
        build_train, build_eval = self._saved

        def train_builder(*a, **k):
            inner = build_train(*a, **k)

            def step(batch, epoch):
                ev = _event_pair()
                before = launch_counts()
                m = inner(batch, epoch)
                ev[1].record()
                self.steps.append(_delta(launch_counts(), before))
                self.events.append((epoch, *ev))
                if self.read_loss:
                    self.losses.append(float(m["loss"]))
                return m

            step.generator = inner.generator
            return step

        def eval_builder(*a, **k):
            inner = build_eval(*a, **k)

            def extract(batch):
                ev = _event_pair()
                before = launch_counts()
                out = inner(batch)
                ev[1].record()
                self.evals.append(_delta(launch_counts(), before))
                self.eval_events.append(ev)
                return out

            return extract

        loop.build_train_step, evaluate.build_eval_step = train_builder, eval_builder
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.engine import evaluate, loop

        loop.build_train_step, evaluate.build_eval_step = self._saved

    def step_ms(self, skip: int) -> tuple:
        """Device ms between the starts of consecutive steps of one epoch (a
        step, its next batch's copy, any idle), the run's first ``skip``
        steps left out, and of each the ms from the step's last launch to
        the next one's start: the next batch's copy and the device's idle."""
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(self.events[skip:], self.events[skip + 1:])
                 if a[0] == b[0]]
        return ([a[1].elapsed_time(b[1]) for a, b in pairs],
                [a[2].elapsed_time(b[1]) for a, b in pairs])

    def eval_ms(self) -> tuple:
        """Per eval batch the device ms from its forward's start to its last
        launch's end, and between consecutive batches the ms from one's end
        to the next one's start (its copy, its transform and any idle)."""
        torch.cuda.synchronize()
        ev = self.eval_events
        return ([a.elapsed_time(b) for a, b in ev],
                [a[1].elapsed_time(b[0]) for a, b in zip(ev, ev[1:])])


class _ComputeProbe:
    """Wraps ``R1mAPEvaluator.compute``: keeps the last evaluator's features
    (as ``do_inference`` handed them over) and result."""

    def __enter__(self):
        from editor_tpu_torch.evals.metrics import R1mAPEvaluator

        self._saved = compute = R1mAPEvaluator.compute

        def probe(ev):
            self.feats, self.num_query = torch.cat(ev.feats), ev.num_query
            self.out = compute(ev)
            return self.out

        R1mAPEvaluator.compute = probe
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.evals.metrics import R1mAPEvaluator

        R1mAPEvaluator.compute = self._saved


class _SaveProbe:
    """Wraps ``CheckpointManager.save``: the wall ms of each call (what the
    loop waits for: with ``use_async`` the host copy, and any wait for the
    write before it) and whether it wrote."""

    def __enter__(self):
        from editor_tpu_torch.utils.checkpoint import CheckpointManager

        self.calls = []
        self._saved = save = CheckpointManager.save

        def probe(mgr, step, payload):
            t0 = time.perf_counter()
            wrote = save(mgr, step, payload)
            self.calls.append(((time.perf_counter() - t0) * 1e3, wrote, mgr.use_async))
            return wrote

        CheckpointManager.save = probe
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.utils.checkpoint import CheckpointManager

        CheckpointManager.save = self._saved

    def summary(self) -> str:
        """ms of the calls that wrote, then of those that found the step saved."""
        wrote = [round(ms, 1) for ms, w, _ in self.calls if w]
        found = [round(ms, 1) for ms, w, _ in self.calls if not w]
        return json.dumps({"wrote": wrote, "step_already_saved": found})


def _train_cli(opts, splits, decode, read_loss=True):
    """cli.train on the in-memory data; (result, probe)."""
    from editor_tpu_torch.cli import train

    with _LoopProbe(read_loss) as probe:
        result = train.main(opts, splits=splits, decode_fn=decode)
    return result, probe


def _metrics_records(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _payload_equal(a, b) -> bool:
    """Two loaded checkpoint payloads equal: tensors by torch.equal."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_payload_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_payload_equal(x, y) for x, y in zip(a, b))
    return a == b


def loop_phase(card: str, bare_step_ms: float) -> dict:
    """Phase 8: the flagship through the training loop (cli.train -> do_train)
    on in-memory data: (a) per-step and per-eval-batch launches, (b) the run's
    files and finite losses, (d) a resume against an uninterrupted run, (e)
    cli.test on the best epoch's checkpoint gives the loop's mAP of that
    epoch, (c) over the features do_inference handed the evaluator in (e),
    the card's distances within 1e-5 of the CPU evaluator's and the card's
    CMC and mAP equal to the CPU metric's on the card's distances; then eval
    images/s through ``evaluate``, metric ms, checkpoint save ms and bytes,
    and the loop's ms per step against phase 5's bare step and its idle
    share."""
    import shutil
    import tempfile

    from editor_tpu_torch.cli import test as cli_test
    from editor_tpu_torch.config import RGBNT201_PRESET, load_config
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.data.sampler import PKSampler
    from editor_tpu_torch.engine import loop
    from editor_tpu_torch.evals.metrics import R1mAPEvaluator, cmc_map
    from editor_tpu_torch.utils.checkpoint import CheckpointManager, train_state

    base = RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "SOLVER.LOG_PERIOD", "1",
                              "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "1"]
    cfg = load_config(None, base + ["OUTPUT_DIR", ""])
    splits, timed_splits, decode = _loop_data(cfg.INPUT.SIZE_TRAIN)
    L = 12
    want_step = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                         attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    n_val = len(splits.query) + len(splits.gallery)
    n_eval = -(-n_val // cfg.TEST.IMS_PER_BATCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        # (a), (b): two epochs with checkpoints, counted from zero
        x = os.path.join(tmp, "run")
        reset_counts()
        with _SaveProbe() as saves_a:  # TPU.ASYNC_CHECKPOINT at its default, True
            a, probe_a = _train_cli(base + ["SOLVER.MAX_EPOCHS", "2", "OUTPUT_DIR", x], splits,
                                    decode)
        run_launches = launch_counts()
        if not (cfg.TPU.ASYNC_CHECKPOINT and saves_a.calls
                and all(use_async for *_, use_async in saves_a.calls)):
            raise AssertionError(f"the loop's saves {saves_a.calls} were not asynchronous")
        sampler = PKSampler(splits.train, 128, 16, seed=cfg.SOLVER.SEED)
        ends = np.cumsum([len(sampler.epoch_indices(e)) // 128 for e in (1, 2, 3)])
        if len(probe_a.steps) != ends[1] or len(probe_a.evals) != 2 * n_eval:
            raise AssertionError(f"{len(probe_a.steps)} steps, {len(probe_a.evals)} eval batches")
        bad = [d for d in probe_a.steps if d != want_step] + [
            d for d in probe_a.evals if d != want_eval]
        if bad:
            raise AssertionError(f"loop launches {bad[0]} != {want_step} a step / "
                                 f"{want_eval} an eval batch")
        total = {k: len(probe_a.steps) * want_step[k] + len(probe_a.evals) * want_eval[k]
                 for k in want_step}
        if run_launches != total:
            raise AssertionError(f"run launches {run_launches} != {total}")
        files = sorted(os.listdir(x)) + sorted(os.listdir(os.path.join(x, "ckpt")))
        need = ["config.yaml", "metrics.jsonl", "train_log.txt", f"step_{ends[0]:09d}.pt",
                f"step_{ends[1]:09d}.pt"]
        losses_logged = [r["loss"] for r in _metrics_records(x) if "loss" in r]
        if not (set(need) <= set(files) and np.isfinite(probe_a.losses).all()
                and losses_logged == probe_a.losses):
            raise AssertionError(f"run files {files}, losses {probe_a.losses} {losses_logged}")
        say("8a loop launches", steps=len(probe_a.steps), eval_batches=len(probe_a.evals),
            eval_rows=n_val, per_step="as phase 5", per_eval_batch="as phase 3",
            run=json.dumps(run_launches))
        say("8b loop run", files=",".join(files), losses=json.dumps(probe_a.losses),
            best_map=f"{a['best']['mAP']:.6f}")
        del a
        torch.cuda.empty_cache()

        # (d): a third epoch resumed from the epoch-2 checkpoint, and three
        # uninterrupted epochs (no output directory: no checkpoints)
        # the resumed epoch saves synchronously: the loop's stall per save off
        with _SaveProbe() as saves_b:
            b, probe_b = _train_cli(base + ["SOLVER.MAX_EPOCHS", "3", "OUTPUT_DIR", x,
                                            "TPU.ASYNC_CHECKPOINT", "False"], splits, decode)
        if not saves_b.calls or any(use_async for *_, use_async in saves_b.calls):
            raise AssertionError(f"the resumed run's saves {saves_b.calls} were not synchronous")
        c, probe_c = _train_cli(base + ["SOLVER.MAX_EPOCHS", "3", "OUTPUT_DIR", ""], splits,
                                decode)
        with open(os.path.join(x, "train_log.txt")) as f:
            resumed = f"Resumed from checkpoint step {ends[1]} (epoch 2)" in f.read()
        got, ref = probe_a.losses + probe_b.losses, probe_c.losses
        rel = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
        sb, sc = b["model"].state_dict(), c["model"].state_dict()
        max_param = max(float((sb[k].double() - sc[k].double()).abs().max()) for k in sb)
        bitwise = all(torch.equal(sb[k], sc[k]) for k in sb)
        if not (resumed and len(got) == len(ref) == ends[2] and max(rel) <= 1e-5):
            raise AssertionError(f"resume: resumed={resumed}, losses {got} vs {ref}")
        say("8d resume", resumed_at_step=ends[1], epoch3_losses=json.dumps(probe_b.losses),
            uninterrupted=json.dumps(ref[ends[1]:]), max_rel_dloss=f"{max(rel):.3e}",
            limit="1e-5",
            max_abs_param_diff=f"{max_param:.3e}", bit_for_bit=bitwise,
            written_by="async saves (TPU.ASYNC_CHECKPOINT True)")
        say("8 save stall", async_on_ms=saves_a.summary(), async_off_ms=saves_b.summary(),
            card=repr(card))
        del c
        torch.cuda.empty_cache()

        # (e): cli.test on the best epoch's checkpoint, alone in a directory
        logged = [r["mAP"] for r in _metrics_records(x) if "mAP" in r]
        best_epoch = max(range(3), key=lambda e: (logged[e], e)) + 1
        best_dir = os.path.join(tmp, "best")
        os.makedirs(best_dir)
        os.link(os.path.join(x, "ckpt", f"step_{ends[best_epoch - 1]:09d}.pt"),
                os.path.join(best_dir, f"step_{ends[best_epoch - 1]:09d}.pt"))
        with _ComputeProbe() as computed:
            _, map_test = cli_test.main(base + ["TEST.WEIGHT", best_dir, "OUTPUT_DIR", ""],
                                        splits=splits, decode_fn=decode)
        if not abs(map_test - logged[best_epoch - 1]) <= 1e-6:
            raise AssertionError(f"cli.test mAP {map_test} != the loop's "
                                 f"{logged[best_epoch - 1]} (epoch {best_epoch})")
        say("8e cli.test", weight=f"the best checkpoint (epoch {best_epoch})",
            map=f"{map_test:.7f}", loop_maps=json.dumps(logged))

        # (c): over the features of (e), the card's distances against the CPU
        # evaluator's (fp32 both, summed in other orders), and the card's CMC
        # and mAP against the CPU metric's (stable sort, gathers, cumsums) on
        # the card's distances
        feats, nq = computed.feats, computed.num_query
        cmc_gpu, map_gpu, dist_gpu, pids, cams, *_ = computed.out
        cmc_cpu, map_cpu = cmc_map(dist_gpu, pids[:nq], pids[nq:], cams[:nq], cams[nq:])

        def score(f):
            ev = R1mAPEvaluator(nq)
            ev.update(f, pids, cams)
            return ev.compute()

        cmc_e2e, map_e2e, dist_cpu, *_ = score(feats.cpu())
        dist_diff = float(np.abs(dist_gpu - dist_cpu).max())
        if not (feats.is_cuda and dist_diff <= 1e-5 and np.array_equal(cmc_gpu, cmc_cpu)
                and abs(map_gpu - map_cpu) <= 1e-6):
            raise AssertionError(f"card vs CPU metric: distances {dist_diff} apart, "
                                 f"{cmc_gpu[:5]} {map_gpu} vs {cmc_cpu[:5]} {map_cpu}")
        score(feats)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            score(feats)
        metric_ms = (time.perf_counter() - t0) / 5 * 1e3
        say("8c metric", queries=nq, gallery=len(pids) - nq, max_dist_diff=f"{dist_diff:.3e}",
            dist_limit="1e-5", map_card=f"{map_gpu:.7f}", map_cpu_same_dist=f"{map_cpu:.7f}",
            rank1=f"{cmc_gpu[0]:.4f}", cmc_equal=True, map_cpu_end_to_end=f"{map_e2e:.7f}",
            cmc_end_to_end_equal=bool(np.array_equal(cmc_gpu, cmc_e2e)),
            metric_ms=f"{metric_ms:.2f}", card=repr(card))
        del feats, computed

        # eval images/s through evaluate (twice), the resumed model
        model = b["model"]
        dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode)
        eval_s, fwd, gaps, per_pass = [], [], [], []
        for _ in range(2):
            with _LoopProbe() as probe_e:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.evaluate(cfg, model, dm, torch.bfloat16)
                torch.cuda.synchronize()
                eval_s.append(time.perf_counter() - t0)
            f, g = probe_e.eval_ms()
            fwd, gaps = fwd + f[:-1], gaps + g  # the trimmed tail batch left out
            per_pass.append([round(v, 2) for v in g])
        say("8 eval timing", rows=n_val, batches=n_eval, batch=cfg.TEST.IMS_PER_BATCH,
            eval_s=json.dumps([round(v, 4) for v in eval_s]),
            eval_img_s=json.dumps([round(n_val / v, 1) for v in eval_s]),
            forward_ms_median=f"{np.median(fwd):.3f}",
            gap_ms_median=f"{np.median(gaps):.3f}", gap_ms_max=f"{max(gaps):.3f}",
            idle_share=f"{sum(gaps) / (sum(gaps) + sum(fwd)):.4f}",
            gaps_ms=json.dumps(per_pass), card=repr(card))

        # checkpoint save: time and bytes, synchronous; then the same payload
        # saved asynchronously, the model and its slots changed as soon as
        # save returns, and the file held against the synchronous one
        step_n, gen = int(ends[2]), b["step"].generator
        mgr = CheckpointManager(os.path.join(tmp, "save"), use_async=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(step_n, train_state(model, b["optimizer"], gen, 3))
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(mgr.path(step_n))
        amgr = CheckpointManager(os.path.join(tmp, "save_async"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amgr.save(step_n, train_state(model, b["optimizer"], gen, 3))
        async_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
            for st in b["optimizer"].state:
                for slots in st.values():
                    torch._foreach_add_(slots, 1.0)
        t0 = time.perf_counter()
        amgr.wait()
        write_ms = (time.perf_counter() - t0) * 1e3
        got = torch.load(amgr.path(step_n), map_location="cpu", weights_only=True)
        want = torch.load(mgr.path(step_n), map_location="cpu", weights_only=True)
        same = _payload_equal(got, want)
        if not same:
            raise AssertionError("the asynchronous checkpoint differs from the synchronous one")
        say("8 async save", sync_save_ms=f"{save_ms:.1f}", async_save_call_ms=f"{async_ms:.1f}",
            write_after_call_ms=f"{write_ms:.1f}", bytes=nbytes,
            equal_to_sync_after_mutation=same, card=repr(card))
        del b, model, got, want
        torch.cuda.empty_cache()

        # time: two epochs of RGBNT201's train split in size, logging every
        # 10 steps (a host sync), no evaluation and no checkpoints; the
        # run's first two steps left out
        t, probe_t = _train_cli(
            RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "SOLVER.MAX_EPOCHS", "2",
                               "SOLVER.EVAL_PERIOD", "100", "OUTPUT_DIR", ""],
            timed_splits, decode, read_loss=False)
        ms, gap = probe_t.step_ms(skip=2)
        if len(ms) < 20 or probe_t.steps[-1] != want_step:
            raise AssertionError(f"{len(ms)} timed steps, the last launching {probe_t.steps[-1]}")
        loop_ms = float(np.median(ms))
        say("8 loop timing", steps=len(probe_t.steps), timed=len(ms),
            loop_step_ms=f"{loop_ms:.2f}", mean=f"{np.mean(ms):.2f}",
            p10=f"{np.percentile(ms, 10):.2f}", p90=f"{np.percentile(ms, 90):.2f}",
            gap_ms_median=f"{np.median(gap):.3f}", gap_ms_max=f"{max(gap):.3f}",
            idle_share=f"{sum(gap) / sum(ms):.4f}", bare_step_ms=f"{bare_step_ms:.2f}",
            vs_bare=f"{1 - bare_step_ms / loop_ms:.4f}", img_s=f"{128 / loop_ms * 1e3:.1f}",
            ckpt_save_ms=f"{save_ms:.1f}", ckpt_bytes=nbytes, card=repr(card))
        del t
        torch.cuda.empty_cache()
        return {"run": run_launches, "train": want_step, "eval": want_eval}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The serving phase (phase 9): RGBNT201's test split in size (30 ids, 836
# items in 4 cameras; query = gallery), each item its own random images
SERVE_QUERIES = 32
VIS_IMAGES = 8


def _clustered(n: int, dim: int, n_ids: int, seed: int) -> np.ndarray:
    """[n, dim] float32 L2-normalised features around ``n_ids`` centres."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_ids, dim))
    f = centers[np.arange(n) % n_ids] + 0.5 * rng.standard_normal((n, dim))
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)


def _rerank_check(card: str) -> None:
    """(a) The C++ re-ranking loads and matches the numpy copy (30 x 120,
    the JAX package's test size); the device re-ranking's core on the card
    matches it at 836 x 836 on the same distance matrix (k1 50, k2 15,
    lambda 0.3: the evaluator's). End to end, the card computes the
    distances itself, in another summation order: a near tie at a k-th
    neighbour may flip a k-reciprocal set, so that reading is printed."""
    from editor_tpu_torch import native
    from editor_tpu_torch.evals.reranking import k_reciprocal_rerank
    from editor_tpu_torch.evals.reranking_device import _rerank_core, k_reciprocal_rerank_device

    if native.load_native() is None:
        raise AssertionError("the native re-ranking library did not build or load")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((10, 16)) * 5
    q = (centers[rng.integers(0, 10, 30)] + 0.5 * rng.standard_normal((30, 16))).astype(np.float32)
    g = (centers[rng.integers(0, 10, 120)] + 0.5 * rng.standard_normal((120, 16))).astype(
        np.float32)
    small = float(np.abs(native.k_reciprocal_rerank_native(q, g, 10, 4, 0.3)
                         - k_reciprocal_rerank(q, g, 10, 4, 0.3)).max())
    _require("native re-ranking vs numpy", small, 1e-5)

    qf = _clustered(TEST_ITEMS, 3 * C, TEST_IDS, seed=1)
    gf = _clustered(TEST_ITEMS, 3 * C, TEST_IDS, seed=2)
    t0 = time.perf_counter()
    ref = native.k_reciprocal_rerank_native(qf, gf, 50, 15, 0.3)
    native_ms = (time.perf_counter() - t0) * 1e3
    original = torch.from_numpy(native.original_dist(qf, gf)).cuda()
    with torch.inference_mode():
        _rerank_core(original, TEST_ITEMS, 50, 15, 0.3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core = _rerank_core(original, TEST_ITEMS, 50, 15, 0.3).cpu().numpy()
        core_ms = (time.perf_counter() - t0) * 1e3
    core_err = float(np.abs(core - ref).max())
    _require("device re-ranking core vs native, 836 x 836", core_err, 1e-5)
    qd, gd = torch.from_numpy(qf).cuda(), torch.from_numpy(gf).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2e = k_reciprocal_rerank_device(qd, gd, 50, 15, 0.3)
    e2e_ms = (time.perf_counter() - t0) * 1e3
    off = np.abs(e2e - ref)
    say("9a rerank", small_native_vs_numpy=f"{small:.3e}", n=f"{TEST_ITEMS}x{TEST_ITEMS}",
        native_ms=f"{native_ms:.1f}", device_core_ms=f"{core_ms:.1f}",
        device_core_vs_native=f"{core_err:.3e}", limit="1e-5",
        device_end_to_end_ms=f"{e2e_ms:.1f}", end_to_end_max_diff=f"{float(off.max()):.3e}",
        end_to_end_share_over_limit=f"{float((off > 1e-5).mean()):.6f}", card=repr(card))


def _serve_data(size_hw):
    """(splits, decode_fn, images [items, 3, H, W, 3] uint8) of phase 9: the
    timed run's train split (171 ids, for the class count) and RGBNT201's test
    split in size, each test item its own uniform random images (so each
    query has one right answer), made in bulk."""
    from editor_tpu_torch.data.datasets import DatasetSplits

    train = [(("train", i), pid, cam, -1) for i, pid, cam in _spread(TRAIN_ITEMS, TRAIN_IDS)]
    test = [(("test", i), pid, cam, -1)
            for i, pid, cam in _spread(TEST_ITEMS, TEST_IDS, first_pid=1000)]
    images = np.random.default_rng(3).integers(0, 256, (TEST_ITEMS, 3, *size_hw, 3),
                                               dtype=np.uint8)

    def decode(item):
        return list(images[item[0][1]]) if item[0][0] == "test" else list(images[0])

    return DatasetSplits(train, test, test, TRAIN_IDS, CAMS), decode, images


class _Recorder:
    """Stands in for the server's extractor: records each call's images,
    camids, features and wall ms."""

    def __init__(self, ex):
        self.ex, self.size_hw, self.calls = ex, ex.size_hw, []

    def __call__(self, images, camids=None):
        t0 = time.perf_counter()
        out = self.ex(images, camids)
        self.calls.append((images, camids, out, (time.perf_counter() - t0) * 1e3))
        return out


def _timed_calls(fn, log: list):
    """``fn`` wrapped to append each call's wall ms to ``log``."""
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def _http(addr, path, payload=None):
    """(status, body, ms) of a GET (no payload) or a POST to ``addr``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{addr[0]}:{addr[1]}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, (time.perf_counter() - t0) * 1e3


def serve_phase(card: str) -> dict:
    """Phase 9: (a) native and device re-ranking; (b) cli.export of a
    flagship checkpoint, cli.serve.build_service on the .pth over RGBNT201's
    test split in size, a RetrievalServer on 127.0.0.1 answering /healthz,
    SERVE_QUERIES batch-1 /query requests (each retrieving itself at rank 1,
    its features bit for bit the in-process call's, K1 12, K2 1 and K3 2
    launches each), a re-ranked /query, /gallery/add and a malformed request;
    (c) dump_eval_visualizations on VIS_IMAGES images, its launches, its
    rollouts and union mask against the plain fp32 run; (d) whether PIL and
    the JPEG codec were available. Without PIL the requests carry .npy bytes
    (the module's decoder swapped for this phase) and the visualisation's
    overlay arrays are held in place of its files."""
    import base64
    import importlib.util
    import io
    import logging
    import shutil
    import tempfile

    from editor_tpu_torch import native
    from editor_tpu_torch import serve as serve_mod
    from editor_tpu_torch.cli import export as cli_export
    from editor_tpu_torch.cli import serve as cli_serve
    from editor_tpu_torch.config import RGBNT201_PRESET, load_config
    from editor_tpu_torch.data.transforms import make_eval_transform
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils import visualize
    from editor_tpu_torch.utils.checkpoint import CheckpointManager

    _rerank_check(card)
    has_pil = importlib.util.find_spec("PIL") is not None
    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    logging.getLogger("editor_tpu_torch.native").addHandler(handler)
    try:
        codec = native.load_imagecodec() is not None
    finally:
        logging.getLogger("editor_tpu_torch.native").removeHandler(handler)
    codec_note = "available" if codec else "unavailable: " + next(
        (line for msg in warned for line in msg.splitlines() if "error" in line),
        warned[0].splitlines()[0] if warned else "no message")

    opts = RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "OUTPUT_DIR", ""]
    cfg = load_config(None, opts)
    splits, decode, images = _serve_data(tuple(cfg.INPUT.SIZE_TEST))
    ecfg = editor_config_from(cfg, splits.num_train_pids, splits.num_train_cams)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    saved_decoder, saved_save = serve_mod._decode_b64_image, visualize._save
    server = None
    try:
        # (b) a checkpoint of the flagship, exported, served
        model = editor_init(ecfg, seed=cfg.SOLVER.SEED)
        ckpt = os.path.join(tmp, "ckpt")
        mgr = CheckpointManager(ckpt)
        mgr.save(1, {"model": model.state_dict(), "epoch": 1})
        mgr.close()
        pth = os.path.join(tmp, "EDITOR.pth")
        exported = cli_export.main(["--out", pth] + opts + ["TEST.WEIGHT", ckpt], splits=splits)
        own = model.state_dict()
        if not (exported.keys() == own.keys()
                and all(torch.equal(exported[k], own[k].cpu()) for k in own)):
            raise AssertionError("cli.export's state_dict differs from the checkpoint's")
        del model, own, exported
        t0 = time.perf_counter()
        ex, index = cli_serve.build_service(cfg, weight=pth, batch_size=32, splits=splits,
                                            decode_fn=decode)
        index_s = time.perf_counter() - t0
        if len(index) != TEST_ITEMS or index.feat_dim != 3 * C:
            raise AssertionError(f"gallery of {len(index)} x {index.feat_dim}")

        if has_pil:
            from PIL import Image

            def encode(arr):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                return base64.b64encode(buf.getvalue()).decode()
        else:
            def encode(arr):
                buf = io.BytesIO()
                np.save(buf, arr)
                return base64.b64encode(buf.getvalue()).decode()

            def npy_decode(data, size_hw):
                arr = np.load(io.BytesIO(base64.b64decode(data)))
                if arr.shape[:2] != tuple(size_hw):
                    raise ValueError(f"image {arr.shape} is not {size_hw}")
                return arr

            serve_mod._decode_b64_image = npy_decode
        decode_ms, query_ms = [], []
        serve_mod._decode_b64_image = _timed_calls(serve_mod._decode_b64_image, decode_ms)
        rec = _Recorder(ex)
        server = serve_mod.RetrievalServer(rec, index, "127.0.0.1", 0)
        server._query = _timed_calls(server._query, query_ms)
        server.start()
        addr = server.address
        code, health, _ = _http(addr, "/healthz")
        if code != 200 or health != {"status": "ok", "gallery_size": TEST_ITEMS,
                                     "feat_dim": 3 * C}:
            raise AssertionError(f"/healthz {code} {health}")

        def request(i, **extra):
            item = splits.gallery[i]
            return item, {"images": {m: encode(images[i, k]) for k, m in
                                     enumerate(("RGB", "NI", "TI"))}, "topk": 5,
                          "camid": int(item[2]), **extra}

        for i in (0, 1):  # warm-up
            _http(addr, "/query", request(i)[1])
        picks = np.random.default_rng(4).choice(TEST_ITEMS, SERVE_QUERIES, replace=False)
        reqs = [request(int(i)) for i in picks]
        health_ms = [_http(addr, "/healthz")[2] for _ in range(8)]
        rec.calls.clear()
        del decode_ms[:], query_ms[:]
        torch.cuda.synchronize()
        reset_counts()
        lat = []
        for item, req in reqs:
            code, body, ms = _http(addr, "/query", req)
            lat.append(ms)
            if code != 200 or body["matches"][0]["path"] != str(item[0]):
                raise AssertionError(f"/query for {item}: {code} {body}")
        counts = launch_counts()
        want = expected(attention_qkv=12 * SERVE_QUERIES, rollout_chain=SERVE_QUERIES,
                        masked_attention_qkv=2 * SERVE_QUERIES)
        if counts != want:
            raise AssertionError(f"{SERVE_QUERIES} queries launched {counts} != {want}")
        per_query = {k: v // SERVE_QUERIES for k, v in counts.items()}
        # where a request's time goes: the handler's _query (three image
        # decodes, the extractor, the search) and the rest (HTTP, JSON, the
        # client); client and server threads share this process
        extract_ms = [c[3] for c in rec.calls]
        decodes = np.asarray(decode_ms).reshape(SERVE_QUERIES, 3).sum(1)
        parts = {"query_handler": query_ms, "decode_3_images": decodes, "extract": extract_ms,
                 "search_and_rest": np.subtract(query_ms, decodes) - extract_ms,
                 "http_json_client": np.subtract(lat, query_ms), "healthz": health_ms}
        breakdown = {k: round(float(np.median(v)), 2) for k, v in parts.items()}
        # the server's features against the in-process call, bit for bit
        for (item, _), i, (imgs, cams, feat, _) in zip(reqs, picks, rec.calls):
            if not all(np.array_equal(imgs[m][0], images[i, k])
                       for k, m in enumerate(("RGB", "NI", "TI"))):
                raise AssertionError(f"decoded images of {item} differ from the sent ones")
            if not np.array_equal(feat, ex(imgs, cams)):
                raise AssertionError(f"features of {item} over HTTP != in process")
        item, req = request(int(picks[0]), reranking=True)
        code, body, rr_ms = _http(addr, "/query", req)
        if code != 200 or body["matches"][0]["pid"] != item[1]:
            raise AssertionError(f"re-ranked /query: {code} {body}")
        code, added, _ = _http(addr, "/gallery/add", {**request(5)[1], "pid": 9999,
                                                      "path": "added"})
        if code != 200 or added != {"ok": True, "gallery_size": TEST_ITEMS + 1}:
            raise AssertionError(f"/gallery/add {code} {added}")
        code, bad, _ = _http(addr, "/query", {"images": {}})
        if code != 400 or "error" not in bad:
            raise AssertionError(f"malformed /query: {code} {bad}")
        server.shutdown()
        server = None
        say("9b serve", gallery=TEST_ITEMS, index_s=f"{index_s:.2f}", queries=SERVE_QUERIES,
            rank1="self", features="bit for bit",
            per_query=json.dumps({k: v for k, v in per_query.items() if v}),
            http_b1_p50_ms=f"{np.percentile(lat, 50):.2f}",
            http_b1_p99_ms=f"{np.percentile(lat, 99):.2f}",
            median_ms_parts=json.dumps(breakdown), rerank_query_ms=f"{rr_ms:.1f}",
            rerank_top1_pid="same", add="ok", malformed=400,
            decoder="PIL (PNG)" if has_pil else ".npy bytes (no PIL)", card=repr(card))

        # (c) the visualisation on VIS_IMAGES gallery images
        transform = make_eval_transform(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
        vis = {m: transform(torch.from_numpy(images[:VIS_IMAGES, k]).cuda())
               for k, m in enumerate(("RGB", "NI", "TI"))}
        cams = torch.tensor([it[2] for it in splits.gallery[:VIS_IMAGES]], device="cuda")
        held = {}
        if not has_pil:
            visualize._save = lambda path, arr: held.__setitem__(os.path.basename(path), arr)
        torch.cuda.synchronize()
        reset_counts()
        paths = visualize.dump_eval_visualizations(os.path.join(tmp, "vis"), ex.model, vis,
                                                   cam_ids=cams, compute_dtype=torch.bfloat16)
        vis_counts = launch_counts()
        want_vis = expected(attention_qkv=3 * 12, rollout_chain=3)
        if vis_counts != want_vis:
            raise AssertionError(f"visualisation launched {vis_counts} != {want_vis}")
        n_files = 3 * VIS_IMAGES * 2 + VIS_IMAGES
        shapes = {a.shape for a in held.values()}
        if len(held if not has_pil else paths) != n_files or (
                held and shapes != {(*cfg.INPUT.SIZE_TEST, 3)}):
            raise AssertionError(f"{len(paths)} files, {len(held)} arrays {shapes}")
        plain = Editor(dataclasses.replace(ecfg, use_pallas=False))
        plain.load_state_dict(ex.model.state_dict(), strict=True)
        rolls, union = visualize.eval_visualization_maps(ex.model, vis, cams, torch.bfloat16)
        rolls_p, union_p = visualize.eval_visualization_maps(plain, vis, cams, torch.float32)
        rel = {m: float((rolls[m] - rolls_p[m]).norm() / rolls_p[m].norm()) for m in rolls}
        agree = float((union == union_p).float().mean())
        if not (max(rel.values()) <= 0.05 and agree >= 0.9):
            raise AssertionError(f"visualisation vs plain fp32: rollout rel-L2 {rel}, "
                                 f"union mask agreement {agree}")
        say("9c visualize", images=VIS_IMAGES,
            launches=json.dumps({k: v for k, v in vis_counts.items() if v}),
            outputs=f"{n_files} {'PNG files' if has_pil else 'overlay arrays (no PIL)'}",
            rollout_rel_l2=json.dumps({m: round(v, 5) for m, v in rel.items()}),
            rel_l2_limit=0.05, union_agreement=f"{agree:.4f}", agreement_limit=0.9,
            union_kept=f"{float(union.float().mean()):.4f}")
        say("9d host", pil=has_pil, codec=repr(codec_note))
        return {"query": per_query, "visualize": vis_counts}
    finally:
        if server is not None:
            server.shutdown()
        serve_mod._decode_b64_image, visualize._save = saved_decoder, saved_save
        shutil.rmtree(tmp, ignore_errors=True)


# Data parallelism (phase 10): the flagship's train step and evaluation on a
# ('data', 'model') mesh over an NCCL group. One card: a group of one rank in
# this process (a FileStore in a temporary directory), which runs the DP code
# and calls the collectives; with two cards or more, also two ranks spawned as
# processes of this script (``--dp-rank``).
DP_REDUCERS = ("fp16", "bf16", "int8", "powersgd")


def _dp_batch(gen: torch.Generator, cfg, h: int, w: int) -> dict:
    B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
    batch = {m: torch.randint(0, 256, (B, h, w, 3), generator=gen, device="cuda",
                              dtype=torch.uint8) for m in ("RGB", "NI", "TI")}
    batch["pid"] = torch.arange(B, device="cuda") // K  # 8 ids x 16 instances
    batch["camid"] = torch.arange(B, device="cuda") % 6
    return batch


def _dp_id_batch(gen: torch.Generator, batch: dict) -> dict:
    """``batch``'s identities and cameras with images in [0, 1] that look
    like their identity: a uint8 prototype per identity and modality plus
    noise in [-25, 25]. On uniform noise images every row's feature is
    nearly the same, the BN necks scale rounding noise up, and the heads'
    gradients are rounding noise: (e) needs features that differ by
    identity."""
    pid = batch["pid"]
    out = {"pid": pid, "camid": batch["camid"]}
    for m in ("RGB", "NI", "TI"):
        shape = tuple(batch[m].shape)
        proto = torch.randint(0, 256, (int(pid.max()) + 1,) + shape[1:], generator=gen,
                              device="cuda", dtype=torch.int16)
        noise = torch.randint(-25, 26, shape, generator=gen, device="cuda",
                              dtype=torch.int16)
        out[m] = (proto[pid] + noise).clamp(0, 255).float() / 255.0
    return out


def _dp_step(kind: str, cfg, ecfg, sd, mesh, augment: bool = True, reducer=None,
             grad_scale: float = 1.0, backbone=None, dtype=torch.bfloat16):
    """(model, step) of ``kind``: 'single' (no mesh), 'global' (the
    global-batch step on ``mesh``, with ``backbone`` pipelined), 'zero1'
    (that with ZeRO-1), 'fsdp' (that with FSDP) or 'ddp' (the local-batch
    step with ``reducer``), from the weights ``sd``, computing in ``dtype``.
    ``grad_scale``: every gradient multiplied by it before the optimizer
    steps (a planted fault for (e)'s control)."""
    from editor_tpu_torch.data.transforms import make_train_augment
    from editor_tpu_torch.engine.train import build_train_step, fsdp_state_shardings
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.parallel.ddp import build_ddp_train_step
    from editor_tpu_torch.parallel.zero import zero1_state_shardings
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    model = Editor(ecfg)
    model.load_state_dict(sd, strict=True)
    if mesh is not None:
        from editor_tpu_torch.parallel.mesh import model_size
        from editor_tpu_torch.parallel.tp import shard_editor
        if model_size(mesh) > 1:  # tensor parallelism: this rank's shards
            shard_editor(model, mesh)
    opt = make_optimizer(cfg, model)
    if grad_scale != 1.0:
        inner = opt.step

        def scaled_step(lr):
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(grad_scale)
            inner(lr)

        opt.step = scaled_step
    args = (model, opt, make_loss(cfg, ecfg.num_classes), make_scheduler(cfg),
            cfg.SOLVER.BASE_LR)
    aug = make_train_augment(cfg.INPUT) if augment else None
    if kind == "ddp":
        step = build_ddp_train_step(*args, mesh, reducer=reducer, compute_dtype=torch.bfloat16,
                                    augment=aug, seed=1)
        step.optimizer = opt
        return model, step
    zero = (zero1_state_shardings(opt, mesh) if kind == "zero1" else
            fsdp_state_shardings(model, opt, mesh) if kind == "fsdp" else None)
    return model, build_train_step(*args, dtype, augment=aug, seed=1,
                                   mesh=None if kind == "single" else mesh,
                                   state_shardings=zero, gather_params_compute=kind == "fsdp",
                                   backbone=backbone)


def _dp_run(kind, cfg, ecfg, sd, mesh, batch, want: dict, reducer=None):
    """3 steps of ``kind``: (losses, state_dict, per-step launches, per-step
    collective calls, model, step)."""
    from editor_tpu_torch.parallel import collectives as C

    model, step = _dp_step(kind, cfg, ecfg, sd, mesh, reducer=reducer)
    losses, colls = [], []
    for epoch in (1, 2, 3):
        reset_counts()
        C.reset_collective_counts()
        losses.append(float(step(batch, epoch)["loss"]))
        launches = launch_counts()
        colls.append(C.collective_counts())
        if launches != want:
            raise AssertionError(f"{kind}: kernel launches {launches} != {want} in a step")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: non-finite losses {losses}")
    state = _model_state(model, step)
    return [losses, state, launches, colls, model, step]


def _model_state(model, step) -> dict:
    """The model's state_dict, cloned; under FSDP on the gathered
    parameters (a collective)."""
    import contextlib

    opt = getattr(step, "optimizer", None)
    with opt.gathered() if hasattr(opt, "gathered") else contextlib.nullcontext():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same_state(name: str, a: dict, b: dict) -> None:
    """Every entry of two state_dicts equal bit for bit."""
    diff = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a
            if not torch.equal(a[k], b[k])}
    if diff:
        worst = sorted(diff.items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"{name}: {len(diff)} of {len(a)} tensors differ, largest "
                             f"{worst}")


class _ReduceProbe:
    """Keeps the first call's gradients (the JAX-layout leaves), the
    reducer's state before it and its output."""

    def __init__(self, reducer):
        self.reducer, self.calls = reducer, []
        inner = reducer.reduce

        def reduce(grads, state, group):
            out, new = inner(grads, state, group)
            if not self.calls:
                keep = lambda t: {k: (v.clone() if isinstance(v, torch.Tensor) else keep(v))
                                  for k, v in t.items()}
                self.calls.append((keep(grads), keep(state) if state else {}, keep(out)))
            return out, new

        reducer.reduce = reduce


def _reducer_formula(name: str, grads: dict, state: dict, out: dict) -> float:
    """The largest difference between the reducer's output on one rank and
    its formula applied without communication (fp16/bf16: the cast there
    and back; int8: the dequantised values; PowerSGD: P Q^T from the warm
    Q and the error feedback), relative to the leaf's largest value."""
    from editor_tpu_torch.parallel.compression import _orthogonalize, int8_quantize

    worst = 0.0
    for k, g in grads.items():
        if name in ("fp16", "bf16"):
            want = g.to(torch.float16 if name == "fp16" else torch.bfloat16).to(g.dtype)
        elif name == "int8":
            q, s = int8_quantize(g)
            want = q.to(g.dtype) * s.to(g.dtype)
        elif k in state:
            last = g.shape[-1]
            mtx = g.float().reshape(-1, last) + state[k]["error"].reshape(-1, last)
            p = _orthogonalize(mtx @ state[k]["q"])
            want = (p @ (mtx.T @ p).T).reshape(g.shape).to(g.dtype)
        else:
            want = g
        d = float((out[k].double() - want.double()).abs().max())
        worst = max(worst, d / max(float(want.abs().max()), 1e-30))
    return worst


# (e): per parameter tensor, how far the size of W ranks' change from the
# weights strays from the one-card change's. A doubled W factor (a 2x
# gradient) or no update gives ~1 on the tensors the gradient moves, a
# halved one ~0.5; bf16 rounding in another order moves the sizes by far less
# (the reversed-instances probe measures it on every run). The direction of
# the change is printed too, not gated: the classifier heads' gradients at
# initialisation are ill-conditioned (the absent classes' rows cancel to
# rounding residue; a CPU float64 probe shows them the most sensitive
# tensors), and their direction moves by ~0.1 under bf16 rounding.
DP_W_LIMIT = 0.1


def _dp_deltas(model, sd0: dict) -> dict:
    """Each trainable parameter's change from ``sd0``, in float32."""
    return {n: p.detach().float() - sd0[n].float() for n, p in model.named_parameters()
            if p.requires_grad}


def _delta_err(got: dict, ref: dict, direction: bool = False) -> dict:
    """Per tensor, | ||got|| - ||ref|| | (``direction``: ||got - ref||) over
    max(||ref||, 1e-3 of the largest ||ref||): the floor keeps the tensors
    the gradient leaves still (rounding noise) from dividing by ~0."""
    floor = 1e-3 * max(float(d.norm()) for d in ref.values())
    out = {}
    for n, d in ref.items():
        g = got[n].to(d.device)
        num = float((g - d).norm()) if direction else abs(float(g.norm()) - float(d.norm()))
        out[n] = num / max(float(d.norm()), floor)
    return out


def _grad_err(got: dict, ref: dict) -> dict:
    """Per tensor, max |got - ref| over max(max |ref|, 1e-3 of the largest
    max |ref| of any tensor): :func:`_delta_err`'s floor, elementwise."""
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    return {k: float((got[k] - g).abs().max()) / max(float(g.abs().max()), floor)
            for k, g in ref.items()}


def _worst(err: dict, k: int = 3) -> str:
    return json.dumps(sorted(((round(v, 6), n) for n, v in err.items()), reverse=True)[:k])


def _dp_one_card(cfg, ecfg, sd0, batch, grad_scale: float = 1.0):
    """2 one-card steps (no augmentation) from ``sd0``: (losses, changes, step)."""
    model, step = _dp_step("single", cfg, ecfg, sd0, None, augment=False,
                           grad_scale=grad_scale)
    losses = [float(step(batch, e)["loss"]) for e in (1, 2)]
    return losses, _dp_deltas(model, sd0), step


def _dp_world_check(tmp: str, world: int, cfg, ecfg, sd0, batch, ref_losses,
                    ref_deltas) -> dict:
    """``world`` NCCL ranks (``--dp-rank``) run 2 global-batch steps on their
    rows of ``batch``; their losses must be the same on every rank and within
    1% of the one-card losses, and every tensor's change within
    ``DP_W_LIMIT`` of the one-card change (:func:`_delta_err`)."""
    torch.save({"cfg": cfg, "ecfg": ecfg, "sd": {k: v.cpu() for k, v in sd0.items()},
                "batch": {k: v.cpu() for k, v in batch.items()}},
               os.path.join(tmp, "inputs.pt"))
    _dp_children(tmp, world)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt")) for r in range(world)]
    sd = outs[0]["sd"]
    deltas = {n: sd[n].float() - sd0[n].float().cpu() for n in ref_deltas}
    err = _delta_err(deltas, ref_deltas)
    dl = max(abs(a - b) / abs(b) for a, b in zip(outs[0]["losses"], ref_losses))
    if not (all(o["losses"] == outs[0]["losses"] for o in outs) and dl <= 0.01
            and max(err.values()) <= DP_W_LIMIT):
        raise AssertionError(f"W = {world}: losses {[o['losses'] for o in outs]} vs "
                             f"{ref_losses}; worst tensors {_worst(err)} (limit {DP_W_LIMIT})")
    return {"losses": outs[0]["losses"], "max_rel_dloss": dl, "max_err": max(err.values()),
            "worst": _worst(err), "direction": _worst(_delta_err(deltas, ref_deltas, True)),
            "step_ms": outs[0]["step_ms"],
            "allreduce_ms": outs[0]["allreduce_ms"]}


def _dp_children(tmp: str, world: int) -> None:
    """Spawn ``world`` NCCL ranks of this script (``--dp-rank``) on cards
    0..world-1 over ``tmp``'s inputs; each writes its losses and rank 0 its
    state_dict."""
    import sys

    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                               str(r), str(world), tmp]) for r in range(world)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise AssertionError(f"the {world} DP ranks exited {codes}")


def dp_child(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 10 (e): the global-batch step on its rows of the
    saved batch for 2 steps, drop path 0 and no augmentation."""
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import make_mesh, shard_batch

    from editor_tpu_torch.engine.train import mean_all_reduce_grads, trainable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    multihost.initialize(init_method="file://" + os.path.join(tmp, f"store_{world}"),
                         world_size=world, rank=rank, local_rank=rank, timeout_s=240)
    mesh = make_mesh()
    cfg, ecfg = inp["cfg"], inp["ecfg"]
    sd = {k: v.cuda() for k, v in inp["sd"].items()}
    model, step = _dp_step("global", cfg, ecfg, sd, mesh, augment=False)
    batch = shard_batch(mesh, {k: v.cuda() for k, v in inp["batch"].items()})
    losses = [float(step(batch, e)["loss"]) for e in (1, 2)]
    out = {"losses": losses}
    if rank == 0:
        out["sd"] = {k: v.cpu() for k, v in model.state_dict().items()}
    params = trainable(model)
    out["step_ms"] = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=5)
    out["allreduce_ms"] = cuda_ms(lambda: mean_all_reduce_grads(params, mesh), iters=10)
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    multihost.shutdown()


def dp_phase(card: str, bare_step_ms: float) -> dict:
    """Phase 10: the flagship data-parallel on an NCCL group. (a) the
    global-batch step (build_train_step(mesh=make_mesh())) equals the
    single-device step from the same weights, batch and generator bit for
    bit over 3 steps (losses, every parameter, BN stats, OCFR centers), each
    step launching K1 12, K2 1, K3 2, K4 12, K5 2 and calling the
    collectives; (b) ZeRO-1 equals (a) bit for bit; (c) the local-batch step
    with each of fp16, bf16, int8 and PowerSGD: finite losses, the reducer's
    output on the flagship's gradients equal to its formula without
    communication (exactly for fp16, bf16 and int8; PowerSGD within 1e-6 of
    the leaf's largest value), its step time; (d) do_inference(mesh=) over
    RGBNT201's test split in size equals the single-device path (features,
    CMC, mAP) and sharded_cmc_map is within 1e-6 of the evaluator; (e) the
    one-card reference, the noise probe and the 2x-gradient control that
    show DP_W_LIMIT can fail, and with two cards or more two NCCL ranks'
    global-batch step held to it tensor by tensor; (f) the DP step's ms against the single-device step's
    and phase 5's, the gradient all-reduce's ms, peak memory."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.engine.evaluate import do_inference
    from editor_tpu_torch.engine.loop import eval_batches
    from editor_tpu_torch.engine.train import mean_all_reduce_grads, trainable
    from editor_tpu_torch.evals.metrics import sharded_cmc_map
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.parallel import collectives as C
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.compression import make_reducer
    from editor_tpu_torch.parallel.mesh import make_mesh
    from editor_tpu_torch.parallel.zero import state_memory_bytes

    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        if not multihost.initialize(init_method="file://" + os.path.join(tmp, "store"),
                                    world_size=1, rank=0,
                                    local_rank=torch.cuda.current_device()):
            raise AssertionError("no process group was made")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"{dist.get_backend()} group of {dist.get_world_size()}")
        mesh = make_mesh()
        gen = torch.Generator(device="cuda").manual_seed(10)
        h, w = ecfg.vit.img_size
        batch = _dp_batch(gen, cfg, h, w)
        sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}

        # (a) the global-batch step against the single-device step
        single = _dp_run("single", cfg, ecfg, sd0, None, batch, want)
        ref_ms = cuda_ms(lambda: single[5](batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=5)
        del single[4:]
        torch.cuda.empty_cache()
        glob = _dp_run("global", cfg, ecfg, sd0, mesh, batch, want)
        if glob[0] != single[0]:
            raise AssertionError(f"global-batch losses {glob[0]} != single {single[0]}")
        _same_state("global-batch step vs single-device step", glob[1], single[1])
        if not all(c.get("all_gather", 0) and c.get("reduce_scatter", 0)
                   and c.get("all_reduce", 0) for c in glob[3]):
            raise AssertionError(f"collectives not called: {glob[3]}")
        say("10a dp global step", world=1, backend="nccl", steps=3, bit_for_bit=True,
            losses=json.dumps(glob[0]), launches=json.dumps(glob[2]),
            collectives=json.dumps(glob[3][-1]))
        # (f) times: the DP step and the single one, the gradient all-reduce
        model, step = glob[4], glob[5]
        epoch = cfg.SOLVER.WARMUP_ITERS + 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dp_ms = cuda_ms(lambda: step(batch, epoch), iters=5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = trainable(model)
        ar_ms = cuda_ms(lambda: mean_all_reduce_grads(params, mesh), iters=10)
        grad_mb = sum(p.numel() * p.element_size() for p in params) / 1e6
        say("10f dp timing", dp_step_ms=f"{dp_ms:.2f}", single_step_ms=f"{ref_ms:.2f}",
            phase5_bare_step_ms=f"{bare_step_ms:.2f}", dp_over_single=f"{dp_ms / ref_ms:.4f}",
            grad_allreduce_ms=f"{ar_ms:.3f}", grad_mb=f"{grad_mb:.1f}",
            peak_gb=f"{peak_gb:.2f}", card=repr(card))
        del glob[4:], model, step, params
        torch.cuda.empty_cache()

        # (b) ZeRO-1 against (a)
        zero = _dp_run("zero1", cfg, ecfg, sd0, mesh, batch, want)
        if zero[0] != glob[0]:
            raise AssertionError(f"ZeRO-1 losses {zero[0]} != {glob[0]}")
        _same_state("ZeRO-1 vs the global-batch step", zero[1], glob[1])
        slots = state_memory_bytes(zero[5].optimizer)
        say("10b dp zero1", bit_for_bit=True, slot_bytes=slots,
            slot_bytes_total=state_memory_bytes(zero[5].optimizer, per_device=False))
        del zero, single
        torch.cuda.empty_cache()

        # (c) the local-batch step with each reducer
        for name in DP_REDUCERS:
            red = make_reducer(name, rank=cfg.TPU.POWERSGD_RANK)
            probe = _ReduceProbe(red)
            losses, _, _, colls, model, step = _dp_run("ddp", cfg, ecfg, sd0, mesh, batch,
                                                       want, reducer=red)
            grads, state, out = probe.calls[0]
            err = _reducer_formula(name, grads, state, out)
            if not (err <= (1e-6 if name == "powersgd" else 0.0)):
                raise AssertionError(f"{name}: reducer output {err} off its formula")
            ms = cuda_ms(lambda: step(batch, epoch), iters=3)
            say(f"10c dp reducer {name}", losses=json.dumps(losses), formula_err=f"{err:.3e}",
                leaves=len(grads), step_ms=f"{ms:.2f}", collectives=json.dumps(colls[-1]))
            del probe, model, step, grads, state, out
            torch.cuda.empty_cache()

        # (d) sharded evaluation against the single-device path
        splits, _, decode = _loop_data(cfg.INPUT.SIZE_TRAIN)
        dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode)
        model = editor_init(ecfg, seed=0)
        ref = do_inference(model, eval_batches(cfg, dm, torch.device("cuda")), dm.num_query)
        reset_counts()
        C.reset_collective_counts()
        got = do_inference(model, eval_batches(cfg, dm, torch.device("cuda")), dm.num_query,
                           mesh=mesh)
        n_batches = -(-len(dm.val_items) // cfg.TEST.IMS_PER_BATCH)
        eval_launches = {k: v // n_batches for k, v in launch_counts().items()}
        if {k: v * n_batches for k, v in eval_launches.items()} != launch_counts() \
                or eval_launches != want_eval:
            raise AssertionError(f"eval launches {launch_counts()} over {n_batches} batches")
        if not (torch.equal(got[5], ref[5]) and torch.equal(got[6], ref[6])
                and np.array_equal(got[0], ref[0]) and got[1] == ref[1]):
            raise AssertionError(f"do_inference(mesh=) != single device: mAP {got[1]} vs "
                                 f"{ref[1]}")
        q_pids = torch.as_tensor(got[3][:dm.num_query], device="cuda")
        g_pids = torch.as_tensor(got[3][dm.num_query:], device="cuda")
        q_cams = torch.as_tensor(got[4][:dm.num_query], device="cuda")
        g_cams = torch.as_tensor(got[4][dm.num_query:], device="cuda")
        remove = (g_pids[None] == q_pids[:, None]) & (g_cams[None] == q_cams[:, None])
        cmc_s, map_s = sharded_cmc_map(got[5], got[6], q_pids, g_pids, remove, mesh)
        d_cmc = float(np.abs(cmc_s - got[0]).max())
        if not (d_cmc <= 1e-6 and abs(map_s - got[1]) <= 1e-6):
            raise AssertionError(f"sharded_cmc_map {map_s} vs {got[1]} (cmc {d_cmc})")
        say("10d dp eval", rows=len(dm.val_items), batches=n_batches, map=f"{got[1]:.7f}",
            sharded_map=f"{map_s:.7f}", rank1=f"{got[0][0]:.6f}", equal_to_single=True,
            collectives=json.dumps(C.collective_counts()))
        del model, ref, got, dm
        torch.cuda.empty_cache()
        dist.destroy_process_group()

        # (e) more than one card: W NCCL ranks against the one-card step. On
        # every machine first the one-card reference, a probe of bf16
        # reduction-order noise (the same rows, each identity's instances in
        # reverse order) and a planted 2x-gradient control, which must fail
        # the limit that the W ranks must meet
        ecfg2 = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit,
                                                                  drop_path_rate=0.0))
        norm = _dp_id_batch(gen, batch)
        K = cfg.DATALOADER.NUM_INSTANCE
        perm = (torch.arange(len(batch["pid"]), device="cuda").view(-1, K).flip(1)
                .reshape(-1))
        ref_losses, ref_d, step = _dp_one_card(cfg, ecfg2, sd0, norm)
        ref_ms = cuda_ms(lambda: step(norm, cfg.SOLVER.WARMUP_ITERS + 1), iters=5)
        del step
        noise_d = _dp_one_card(cfg, ecfg2, sd0, {k: v[perm] for k, v in norm.items()})[1]
        noise = _delta_err(noise_d, ref_d)
        ctrl = _delta_err(_dp_one_card(cfg, ecfg2, sd0, norm, grad_scale=2.0)[1], ref_d)
        torch.cuda.empty_cache()
        if not (max(noise.values()) <= DP_W_LIMIT / 4 and max(ctrl.values()) > DP_W_LIMIT):
            raise AssertionError(f"(e) cannot tell: noise {_worst(noise)}, 2x-gradient "
                                 f"control {_worst(ctrl)}, limit {DP_W_LIMIT}")
        gate = dict(limit=DP_W_LIMIT, noise_max_err=f"{max(noise.values()):.3e}",
                    noise_worst=_worst(noise),
                    noise_direction=_worst(_delta_err(noise_d, ref_d, True)),
                    control_max_err=f"{max(ctrl.values()):.3e}",
                    control_over_limit=sum(v > DP_W_LIMIT for v in ctrl.values()),
                    tensors=len(ref_d))
        del noise_d
        n = torch.cuda.device_count()
        if n < 2:
            say("10e dp ranks", world_sizes="1", **gate,
                note="one card: the W = 2 check needs two")
        else:
            w2 = _dp_world_check(tmp, 2, cfg, ecfg2, sd0, norm, ref_losses, ref_d)
            say("10e dp ranks", world_sizes="1,2", **gate, losses=json.dumps(w2["losses"]),
                ref_losses=json.dumps(ref_losses), max_rel_dloss=f"{w2['max_rel_dloss']:.2e}",
                w2_max_err=f"{w2['max_err']:.3e}", w2_worst=w2["worst"],
                w2_direction=w2["direction"],
                w2_step_ms=f"{w2['step_ms']:.2f}", one_card_step_ms=f"{ref_ms:.2f}",
                w2_grad_allreduce_ms=f"{w2['allreduce_ms']:.3f}",
                note="W = 2: 64 rows a card; drop path 0, no augmentation")
        return {"train": glob[2], "eval": eval_launches}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# FSDP and the launcher (phase 11): the flagship's FSDP step on an NCCL group
# of one rank in this process (a FileStore in a temporary directory), the
# launcher cli.launch restarting a failed flagship trainer on the card, and
# with two cards or more two NCCL ranks of this script (``--fsdp-rank``)
# started through the launcher.
FSDP_LAUNCH_TIMEOUT_S = 420


def _fsdp_memory(ecfg) -> dict:
    """param_memory_bytes per device at W = 1, 2, 4 (MB) for ``ecfg`` and
    for the flagship at RGBNT201's 171 ids and 15 cameras (shapes only, on
    the meta device)."""
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes

    out = {}
    for name, cfg in (("run", ecfg), ("ids171", editor_config_from(Config(), 171, 15))):
        model = Editor(cfg, device="meta")
        out[name] = {W: param_memory_bytes(model, True, W) / 1e6 for W in (1, 2, 4)}
        out[name]["total"] = param_memory_bytes(model, False, 1) / 1e6
    return out


def _popen_launch(args: list, log_path: str) -> subprocess.Popen:
    """``python -m editor_tpu_torch.cli.launch <args>`` from this checkout, in
    a session of its own (so that a time-out stops its workers too)."""
    import sys

    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", "editor_tpu_torch.cli.launch", *args],
                                stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))


def _wait_launch(proc: subprocess.Popen, log_path: str, timeout: float) -> str:
    """The launcher's exit code checked to be 0 within ``timeout`` s; its
    log. A launcher still running is killed with its workers."""
    import signal

    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        code = "timeout"
    with open(log_path) as f:
        text = f.read()
    if code != 0:
        raise AssertionError(f"cli.launch exited {code}:\n{text[-4000:]}")
    return text


def _launch_argv(out: str) -> list:
    """cli.train's options for (c): the flagship with FSDP on phase 8's
    checked data (3 steps an epoch), 2 epochs, a checkpoint each, no
    evaluation."""
    from editor_tpu_torch.config import RGBNT201_PRESET

    return RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "SOLVER.LOG_PERIOD", "1",
                              "SOLVER.EVAL_PERIOD", "10", "SOLVER.CHECKPOINT_PERIOD", "1",
                              "SOLVER.MAX_EPOCHS", "2", "TPU.ZERO_STAGE", "3", "OUTPUT_DIR", out]


def launch_worker(d: str, fail: bool) -> None:
    """The worker of (c), under cli.launch: cli.train.main on phase 8's
    checked data with FSDP. With ``fail``, incarnation 0's data raises as
    epoch 2 starts, once the epoch-1 checkpoint is committed."""
    import re

    from editor_tpu_torch.cli import train
    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data import loader

    out = os.path.join(d, "run")
    argv = _launch_argv(out)
    splits, _, decode = _loop_data(load_config(None, argv).INPUT.SIZE_TRAIN)
    if fail and os.environ["EDITOR_TPU_RESTART_COUNT"] == "0":
        real = loader.ReIDDataModule.train_epoch

        def train_epoch(self, epoch, *a, **k):
            if epoch == 2:
                ckpt, end = os.path.join(out, "ckpt"), time.monotonic() + 120
                while not (os.path.isdir(ckpt) and any(re.match(r"step_\d+\.pt$", n)
                                                       for n in os.listdir(ckpt))):
                    if time.monotonic() > end:
                        raise TimeoutError("the epoch-1 checkpoint was never committed")
                    time.sleep(0.05)
                raise RuntimeError("planted data failure in epoch 2")
            return real(self, epoch, *a, **k)

        loader.ReIDDataModule.train_epoch = train_epoch
    train.main(argv, splits=splits, decode_fn=decode)


def _launcher_check(tmp: str) -> dict:
    """(c): a failing and an uninterrupted FSDP trainer, each under its own
    cli.launch on this card, side by side."""
    import glob
    import sys

    runs = {}
    for name, fail in (("failing", True), ("uninterrupted", False)):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        log = os.path.join(d, "launch.txt")
        runs[name] = (d, log, _popen_launch(
            ["--nproc_per_node", "1", "--max_restarts", "1" if fail else "0",
             "--master_port", "0", "--monitor_interval", "0.5",
             "--error_dir", os.path.join(d, "err"), "--", sys.executable,
             os.path.abspath(__file__), "--launch-worker", d, str(int(fail))], log))
    texts = {name: _wait_launch(proc, log, FSDP_LAUNCH_TIMEOUT_S)
             for name, (d, log, proc) in runs.items()}
    if "restarts used: 1" not in texts["failing"] or \
            "restarts used: 0" not in texts["uninterrupted"]:
        raise AssertionError(f"restarts: {texts['failing'][-2000:]}")
    errors = glob.glob(os.path.join(runs["failing"][0], "err", "agent_*", "error_0_0.json"))
    if not errors:
        raise AssertionError("incarnation 0 left no error file")
    with open(errors[0]) as f:
        error = json.load(f)
    if error["exc_type"] != "RuntimeError" or "planted" not in error["message"]:
        raise AssertionError(f"error file {error}")
    recs = {name: _metrics_records(os.path.join(d, "run")) for name, (d, _, _) in runs.items()}
    got = [r["loss"] for r in recs["failing"] if "loss" in r and r["epoch"] == 2]
    ref = [r["loss"] for r in recs["uninterrupted"] if "loss" in r and r["epoch"] == 2]
    first = [r["loss"] for r in recs["failing"] if "loss" in r and r["epoch"] == 1]
    with open(os.path.join(runs["failing"][0], "run", "train_log.txt")) as f:
        log = f.read()
    if not ("FSDP/ZeRO-3" in log and "Resumed from checkpoint" in log and got
            and len(got) == len(ref) and first):
        raise AssertionError(f"the restarted run: {len(first)} + {len(got)} logged steps")
    rel = max(abs(g - r) / abs(r) for g, r in zip(got, ref))
    if not rel <= 1e-5:
        raise AssertionError(f"resumed epoch-2 losses {got} vs {ref}: {rel}")
    return {"error_exc_type": error["exc_type"], "epoch2_losses": json.dumps(got),
            "uninterrupted": json.dumps(ref), "max_rel_dloss": f"{rel:.3e}",
            "bit_for_bit": got == ref, "restarts_used": 1}


def fsdp_rank(d: str) -> None:
    """One rank of (d) under cli.launch: the global-batch step and the FSDP
    step, 2 steps each from the saved weights on this rank's rows; the
    parameter storage between the FSDP steps."""
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes
    from editor_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from editor_tpu_torch.parallel.zero import state_memory_bytes

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank = multihost.process_index()
    mesh = make_mesh()
    cfg, ecfg = inp["cfg"], inp["ecfg"]
    sd = {k: v.cuda() for k, v in inp["sd"].items()}
    batch = shard_batch(mesh, {k: v.cuda() for k, v in inp["batch"].items()})
    out = {}
    for kind in ("global", "fsdp"):
        model, step = _dp_step(kind, cfg, ecfg, sd, mesh)
        out[kind] = {"losses": [float(step(batch, e)["loss"]) for e in (1, 2)],
                     "sd": {k: v.cpu() for k, v in _model_state(model, step).items()}}
        if kind == "fsdp":
            opt = step.optimizer
            out["param_bytes"] = opt.param_bytes()
            out["want_bytes"] = param_memory_bytes(model, True, mesh.size(0))
            out["slot_bytes"] = state_memory_bytes(opt)
        out[kind]["ms"] = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
        del model, step
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def fsdp_multi(card: str, cfg, ecfg, sd0: dict, batch: dict, world: int = 2) -> None:
    """(d) with two cards or more: ``world`` NCCL ranks through ``cli.launch
    --nproc_per_node world``, the FSDP step against the global-batch step
    tensor by tensor (bit for bit, or phase 10 (e)'s per-tensor gate), and
    each rank's parameter storage between steps against param_memory_bytes
    at that world size. ``world`` 1 runs the same path on one card (a dry
    run)."""
    import shutil
    import sys
    import tempfile

    if torch.cuda.device_count() < world:
        say("11d fsdp ranks", world_sizes="1", note="one card: the W = 2 check needs two")
        return
    d = tempfile.mkdtemp(prefix="chip_smoke_fsdp2_")
    try:
        torch.save({"cfg": cfg, "ecfg": ecfg, "sd": {k: v.cpu() for k, v in sd0.items()},
                    "batch": {k: v.cpu() for k, v in batch.items()}},
                   os.path.join(d, "inputs.pt"))
        log = os.path.join(d, "launch.txt")
        _wait_launch(_popen_launch(["--nproc_per_node", str(world), "--max_restarts", "0",
                                    "--master_port", "0", "--error_dir", os.path.join(d, "err"),
                                    "--", sys.executable, os.path.abspath(__file__),
                                    "--fsdp-rank", d],
                                   log), log, FSDP_LAUNCH_TIMEOUT_S)
        outs = [torch.load(os.path.join(d, f"out_{r}.pt")) for r in range(world)]
        g, f = outs[0]["global"], outs[0]["fsdp"]
        same = g["losses"] == f["losses"] and all(torch.equal(g["sd"][k], f["sd"][k])
                                                  for k in g["sd"])
        diff = max(float((g["sd"][k].double() - f["sd"][k].double()).abs().max())
                   for k in g["sd"] if g["sd"][k].is_floating_point())
        gate = {}
        if not same:
            sd0c = {k: v.cpu() for k, v in sd0.items()}
            names = [k for k in g["sd"] if g["sd"][k].is_floating_point()
                     and not k.endswith(("running_mean", "running_var", "_centers"))]
            err = _delta_err({k: f["sd"][k].float() - sd0c[k].float() for k in names},
                             {k: g["sd"][k].float() - sd0c[k].float() for k in names})
            if max(err.values()) > DP_W_LIMIT:
                raise AssertionError(f"FSDP vs global at W = 2: worst {_worst(err)}")
            gate = {"gate_max_err": f"{max(err.values()):.3e}", "gate_limit": DP_W_LIMIT}
        for r, o in enumerate(outs):
            if o["param_bytes"] != o["want_bytes"]:
                raise AssertionError(f"rank {r}: {o['param_bytes']} parameter bytes between "
                                     f"steps, param_memory_bytes {o['want_bytes']}")
        say("11d fsdp ranks", world_sizes=f"1,{world}", bit_for_bit=same,
            max_abs_diff=f"{diff:.3e}",
            **gate, losses=json.dumps(f["losses"]), global_losses=json.dumps(g["losses"]),
            param_mb_per_rank=json.dumps([o["param_bytes"] / 1e6 for o in outs]),
            slot_mb_per_rank=json.dumps([o["slot_bytes"] / 1e6 for o in outs]),
            fsdp_step_ms=f"{f['ms']:.2f}", global_step_ms=f"{g['ms']:.2f}", card=repr(card))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def fsdp_phase(card: str) -> dict:
    """Phase 11: FSDP (TPU.ZERO_STAGE 3) and the launcher. (a) on an NCCL
    group of one rank, 3 flagship FSDP steps equal the single-device step bit
    for bit (losses, every parameter, BN stats, OCFR centers), each step
    launching K1 12, K2 1, K3 2, K4 12, K5 2 and calling one all-gather and
    one reduce-scatter more than the global-batch step (the same
    all-reduces); do_inference(mesh=) inside gathered() equals the
    single-device model's; (b) the FSDP step's ms against the global-batch
    and single-device steps', the parameter and slot bytes between steps
    against param_memory_bytes, the per-device MB at W = 1, 2, 4, peak
    memory; (c) cli.launch restarts a flagship FSDP trainer whose data fails
    in epoch 2 after the epoch-1 checkpoint is committed: exit code 0,
    "restarts used: 1", the error file, the resumed epoch's losses within
    1e-5 relative of an uninterrupted run's; (d) with two cards or more
    (:func:`fsdp_multi`)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.engine.evaluate import do_inference
    from editor_tpu_torch.engine.loop import eval_batches
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes
    from editor_tpu_torch.parallel.mesh import make_mesh
    from editor_tpu_torch.parallel.zero import state_memory_bytes

    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        if not multihost.initialize(init_method="file://" + os.path.join(tmp, "store"),
                                    world_size=1, rank=0,
                                    local_rank=torch.cuda.current_device()):
            raise AssertionError("no process group was made")
        mesh = make_mesh()
        gen = torch.Generator(device="cuda").manual_seed(11)
        h, w = ecfg.vit.img_size
        batch = _dp_batch(gen, cfg, h, w)
        sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
        epoch = cfg.SOLVER.WARMUP_ITERS + 1

        # (a) the FSDP step against the single-device and global-batch steps
        single = _dp_run("single", cfg, ecfg, sd0, None, batch, want)
        single_ms = cuda_ms(lambda: single[5](batch, epoch), iters=5)
        del single[4:]
        glob = _dp_run("global", cfg, ecfg, sd0, mesh, batch, want)
        glob_ms = cuda_ms(lambda: glob[5](batch, epoch), iters=5)
        del glob[4:]
        torch.cuda.empty_cache()
        fs = _dp_run("fsdp", cfg, ecfg, sd0, mesh, batch, want)
        if fs[0] != single[0]:
            raise AssertionError(f"FSDP losses {fs[0]} != single {single[0]}")
        _same_state("FSDP step vs single-device step", fs[1], single[1])
        for f, g in zip(fs[3], glob[3]):
            if f != dict(g, all_gather=g["all_gather"] + 1,
                         reduce_scatter=g["reduce_scatter"] + 1):
                raise AssertionError(f"FSDP collectives {f}, global-batch step's {g}")
        model, step = fs[4], fs[5]
        opt = step.optimizer
        say("11a fsdp step", world=1, backend="nccl", steps=3, bit_for_bit=True,
            losses=json.dumps(fs[0]), launches=json.dumps(fs[2]),
            collectives=json.dumps(fs[3][-1]), global_collectives=json.dumps(glob[3][-1]),
            sharded_leaves=len(opt.leaves))

        # (a) evaluation on the gathered parameters against the single model
        splits, _, decode = _loop_data(cfg.INPUT.SIZE_TRAIN)
        dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode)
        ref_model = Editor(ecfg)
        ref_model.load_state_dict(single[1], strict=True)
        ref = do_inference(ref_model, eval_batches(cfg, dm, torch.device("cuda")), dm.num_query)
        del ref_model
        reset_counts()
        with opt.gathered():
            got = do_inference(model, eval_batches(cfg, dm, torch.device("cuda")),
                               dm.num_query, mesh=mesh)
        n_batches = -(-len(dm.val_items) // cfg.TEST.IMS_PER_BATCH)
        eval_launches = {k: v // n_batches for k, v in launch_counts().items()}
        if eval_launches != want_eval or {k: v * n_batches for k, v in eval_launches.items()} \
                != launch_counts():
            raise AssertionError(f"eval launches {launch_counts()} over {n_batches} batches")
        if not (torch.equal(got[5], ref[5]) and torch.equal(got[6], ref[6]) and got[1] == ref[1]):
            raise AssertionError(f"FSDP eval != single device: mAP {got[1]} vs {ref[1]}")
        say("11a fsdp eval", batches=n_batches, map=f"{got[1]:.7f}", equal_to_single=True)
        # (b) times and memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fsdp_ms = cuda_ms(lambda: step(batch, epoch), iters=5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        between_gb = torch.cuda.memory_allocated() / 1e9
        pbytes, sbytes = opt.param_bytes(), state_memory_bytes(opt)
        if pbytes != param_memory_bytes(model, True, 1) or sbytes != pbytes - sum(
                p.numel() * p.element_size() for p in model.parameters() if not p.requires_grad):
            raise AssertionError(f"between steps {pbytes} parameter and {sbytes} slot bytes, "
                                 f"param_memory_bytes {param_memory_bytes(model, True, 1)}")
        mem = _fsdp_memory(ecfg)
        say("11b fsdp timing", fsdp_step_ms=f"{fsdp_ms:.2f}", global_step_ms=f"{glob_ms:.2f}",
            single_step_ms=f"{single_ms:.2f}", fsdp_over_global=f"{fsdp_ms / glob_ms:.4f}",
            param_mb=f"{pbytes / 1e6:.1f}", slot_mb=f"{sbytes / 1e6:.1f}",
            per_device_mb=json.dumps({k: {str(w): round(v, 1) for w, v in m.items()}
                                      for k, m in mem.items()}),
            allocated_between_steps_gb=f"{between_gb:.2f}", peak_gb=f"{peak_gb:.2f}",
            card=repr(card))

        train_launches = fs[2]
        del fs, glob, single, model, step, opt, got, ref, dm
        torch.cuda.empty_cache()
        dist.destroy_process_group()

        # (c) the launcher restarting a failed trainer
        say("11c fsdp launcher", **_launcher_check(tmp),
            command="cli.launch --nproc_per_node 1 --max_restarts 1 -- python chip_smoke.py "
                    "--launch-worker")
        torch.cuda.empty_cache()

        # (d) two cards or more
        fsdp_multi(card, cfg, ecfg, sd0, batch)
        return {"train": train_launches, "eval": eval_launches}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# Model parallelism (phase 12): (a) K1, K4 and K2 on one card at the shapes a
# tensor-parallel rank gives them (H / 2 heads of the shard-major qkv), held
# to the full 12-head launch bit for bit; (b) the flagship with the MoE joint
# MLP (MODEL.MOE_EXPERTS 8) on one card; with two cards or more (c) the
# tensor-parallel train step and evaluation through cli.launch and (d) expert
# and sequence parallelism on the flagship fusion block, each rank a process
# of this script (``--tp-rank``, ``--mp-rank``).
MP_LAUNCH_TIMEOUT_S = 420
MP_TOL = 2e-2  # (d): scaled error of bf16 results against the one-card block
MP_F32_TOL = 1e-4  # (d): the ring's fp32 gradients against the plain block's
# (c): the TP step's losses against one card's, relative. bf16 rounds
# differently in the two (each rank's partial product rounds before the
# all-reduce, as JAX's); two-step readings of sound runs on H100s were
# 5.6e-4 to 1.09e-3 (PERF.md, §5)
TP_LOSS_TOL = 2e-3


def _tp_shard_kernels(gen: torch.Generator) -> dict:
    """(a): K1 with probs and K4 on each model rank's [384, 129, 1152] block
    of the shard-major qkv (tp 2, H = 6), and K2 on each rank's [12, 384, 6,
    129, 129] probs, against the same heads of the full 12-head launches:
    ``torch.equal`` (each head's rows read only that head's q, k and v), or,
    failing that, phase 2's checks against the plain versions (a finding).
    Their times at H = 6 and the bounds of those shapes."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.parallel.tp import qkv_tp_permutation

    tp, Hs, Cs = 2, H // 2, C // 2
    Bk, N, L = 3 * B_EVAL, 129, 12
    dev = "cuda"
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    qkv = randn(Bk, N, 3 * C)
    perm = torch.from_numpy(qkv_tp_permutation(H, D, tp)).to(dev)
    probs = torch.empty(Bk, H, N, N, dtype=torch.bfloat16, device=dev)
    out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    g = randn(Bk, N, C)
    dq = ops.attention_qkv_bwd(qkv, g, H, SCALE)[..., perm]  # shard-major columns
    sq = qkv[..., perm]
    equal, fallback, shards = {}, {}, []
    for s in range(tp):
        cols, heads = slice(s * 3 * Cs, (s + 1) * 3 * Cs), slice(s * Hs, (s + 1) * Hs)
        q_s, g_s = sq[..., cols].contiguous(), g[..., s * Cs:(s + 1) * Cs].contiguous()
        p_s = torch.empty(Bk, Hs, N, N, dtype=torch.bfloat16, device=dev)
        o_s, _ = ops.attention_qkv(q_s, Hs, SCALE, probs_out=p_s)
        d_s = ops.attention_qkv_bwd(q_s, g_s, Hs, SCALE)
        torch.cuda.synchronize()
        equal[f"attention_qkv{s}"] = bool(torch.equal(o_s, out[..., s * Cs:(s + 1) * Cs])
                                          and torch.equal(p_s, probs[:, heads]))
        equal[f"attention_qkv_bwd{s}"] = bool(torch.equal(d_s, dq[..., cols]))
        if not equal[f"attention_qkv{s}"]:
            fallback[f"attention_qkv{s}"] = _k1_errors(
                f"attention_qkv shard {s}", o_s, p_s,
                ops.attention_qkv_tpu_plain(q_s, Hs, SCALE, True))
        if not equal[f"attention_qkv_bwd{s}"]:
            fallback[f"attention_qkv_bwd{s}"] = _bwd_shares(
                f"attention_qkv_bwd shard {s}", d_s,
                ops.attention_qkv_bwd_plain(q_s, g_s, Hs, SCALE), N, Cs)
        shards.append((q_s, g_s, p_s))
    q_s, g_s, p_s = shards[0]
    res = {"attention_qkv": dict(
               ms=cuda_ms(lambda: ops.attention_qkv(q_s, Hs, SCALE, probs_out=p_s)),
               **bound(4.0 * Bk * Hs * N * N * D,
                       2.0 * (Bk * N * 3 * Cs + Bk * N * Cs + Bk * Hs * N * N))),
           "attention_qkv_bwd": dict(
               ms=cuda_ms(lambda: ops.attention_qkv_bwd(q_s, g_s, Hs, SCALE)),
               **bound(10.0 * Bk * Hs * N * N * D, 2.0 * Bk * N * (3 * Cs + Cs + 3 * Cs)))}
    del out, dq, sq, shards, q_s, g_s, p_s, probs, g
    torch.cuda.empty_cache()
    # K2 over 12 layers of peaked maps (phase 2's), the full and each rank's heads
    maps = torch.empty(L, Bk, H, N, N, dtype=torch.bfloat16, device=dev)
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bk, H, N, N, generator=gen, device=dev),
                                dim=-1).to(torch.bfloat16)
    roll = ops.rollout_chain(maps)
    for s in range(tp):
        m_s = maps[:, :, s * Hs:(s + 1) * Hs].contiguous()
        r_s = ops.rollout_chain(m_s)
        torch.cuda.synchronize()
        equal[f"rollout_chain{s}"] = bool(torch.equal(r_s, roll[:, s * Hs:(s + 1) * Hs]))
        if not equal[f"rollout_chain{s}"]:
            e = _max_err(r_s, ops.rollout_from_probs_plain(m_s))
            _require(f"rollout_chain shard {s}", e, 1e-5)
            fallback[f"rollout_chain{s}"] = {"err": e}
        if s == 0:
            Z = Bk * Hs
            res["rollout_chain"] = dict(
                ms=cuda_ms(lambda: ops.rollout_chain(m_s)),
                **bound(2.0 * (L - 1) * Z * N * N, 2.0 * L * Z * N * N + 4.0 * Z * (N - 1)))
        del m_s, r_s
    del maps, roll
    torch.cuda.empty_cache()
    for name, r in res.items():
        r.update(shape={"attention_qkv": [Bk, N, 3 * Cs, Hs],
                        "attention_qkv_bwd": [Bk, N, 3 * Cs, Hs],
                        "rollout_chain": [L, Bk * Hs, N]}[name],
                 equal=all(equal[f"{name}{s}"] for s in range(tp)))
    say("12a tp shard kernels", tp=tp, heads=Hs, equal=json.dumps(equal),
        fallback=json.dumps(fallback) if fallback else "none",
        times=json.dumps({k: {"ms": round(v["ms"], 4), "bound_ms": round(v["bound_ms"], 4),
                              "bound_by": v["bound_by"]} for k, v in res.items()}))
    return res


class _Routes:
    """Inside ``with``: every MoE routing (``parallel.moe.route``) keeps its
    top-k experts in ``log``; after ``replay(logged)`` each routing takes the
    next logged experts instead of its own (the gates renormalised from its
    own probabilities at them) until they run out, so that a second run
    dispatches every token where the first did. The aux losses of
    ``moe_ffn_dense`` go to ``aux``."""

    def __init__(self):
        from editor_tpu_torch.parallel import moe as moe_mod
        self.mod, self.log, self.aux, self.queue = moe_mod, [], [], None

    def replay(self, logged: list) -> "_Routes":
        self.queue = list(logged)
        return self

    def __enter__(self):
        mod, real_route, real_ffn = self.mod, self.mod.route, self.mod.moe_ffn_dense
        self.real = (real_route, real_ffn)

        def route(router, x, k):
            gates, idx, probs = real_route(router, x, k)
            if self.queue:
                idx = self.queue.pop(0)
                gates = probs.gather(1, idx)
                gates = gates / gates.sum(dim=-1, keepdim=True)
            self.log.append(idx)
            return gates, idx, probs

        def ffn(*a, **kw):
            y, aux = real_ffn(*a, **kw)
            self.aux.append(aux.detach())
            return y, aux

        mod.route, mod.moe_ffn_dense = route, ffn
        return self

    def __exit__(self, *exc):
        self.mod.route, self.mod.moe_ffn_dense = self.real


def _moe_eval(ecfg, gen: torch.Generator, want: dict) -> dict:
    """(b)'s eval forward (B = 128, bf16, build_eval_step): the launches of
    one forward; the features against the plain fp32 run dispatching every
    token to the experts the bf16 run chose, under phase 3's gates (the
    routing is discontinuous: bf16 rounding before the router flips the
    top-2 choice of tokens whose scores nearly tie, and a flipped token
    takes another expert's output whole); the plain fp32 run that routes
    for itself, its share of flipped choices and its agreement, printed;
    the forward's ms and peak memory."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init

    model = editor_init(ecfg, seed=0)
    ref_model = Editor(dataclasses.replace(ecfg, use_pallas=False))
    ref_model.load_state_dict(model.state_dict(), strict=True)
    batch = _eval_batch(gen, B_EVAL)
    step, ref_step = build_eval_step(model, torch.bfloat16), build_eval_step(ref_model,
                                                                            torch.float32)
    step(batch)
    torch.cuda.synchronize()
    with _Routes() as routes:
        reset_counts()
        feats = step(batch)
        torch.cuda.synchronize()
        launches = launch_counts()
    if launches != want:
        raise AssertionError(f"MoE forward launches {launches} != {want}")
    if feats.shape != (B_EVAL, 3 * C) or not torch.isfinite(feats).all():
        raise AssertionError(f"MoE features {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    with _Routes().replay(routes.log):
        same = ref_step(batch)
    with _Routes() as own:
        free = ref_step(batch)
    min_cos, max_rel = _feature_agreement(feats, same)
    if not (min_cos >= 0.99 and max_rel <= 0.08):
        raise AssertionError(f"MoE bf16 kernels vs fp32 plain (same routing): min cos "
                             f"{min_cos}, max rel-L2 {max_rel}")
    free_cos, free_rel = _feature_agreement(feats, free)
    flips = float((routes.log[0] != own.log[0]).any(dim=1).float().mean())
    first = float((routes.log[0][:, 0] != own.log[0][:, 0]).float().mean())
    del model, ref_model, same, free, routes, own, ref_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = cuda_ms(lambda: step(batch), iters=5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say("12b moe forward", B=B_EVAL, launches=json.dumps(launches),
        min_cos=f"{min_cos:.6f}", max_rel_l2=f"{max_rel:.6f}",
        own_routing_min_cos=f"{free_cos:.6f}", own_routing_max_rel_l2=f"{free_rel:.6f}",
        tokens_with_a_flipped_choice=f"{flips:.5f}", flipped_first_choice=f"{first:.5f}",
        fwd_ms=f"{fwd_ms:.2f}", peak_gb=f"{peak:.2f}")
    return launches


def _moe_check(gen: torch.Generator, card: str) -> dict:
    """(b): the flagship with MODEL.MOE_EXPERTS 8 (compact tail, B = 128,
    bf16): the eval forward (:func:`_moe_eval`) and phase 5's train check (3
    steps against the plain fp32 run with the kernel steps' routing, as the
    eval's), launches as phases 3 and 5; every aux
    loss the MoE returned finite and positive; the train step's peak memory,
    which a [T, K, E, C] one-hot (36 GB at T = 33,792) would exceed."""
    from editor_tpu_torch.parallel import moe as moe_mod

    cfg, ecfg = flagship(["MODEL.MOE_EXPERTS", "8"])
    L = ecfg.vit.depth
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    eval_launches = _moe_eval(ecfg, gen, want_eval)
    with _Routes() as routes:  # the plain fp32 steps take the kernel steps' routing
        launches, step_ms = train_check(
            cfg, ecfg, gen, "12b moe train", want, learn=False,
            before_reference=lambda: routes.replay(routes.log[:3]))
    aux = [float(a) for a in routes.aux]
    if not (aux and all(np.isfinite(a) and a > 0 for a in aux)):
        raise AssertionError(f"MoE aux losses {aux[:8]}")
    T = B_EVAL * 3 * 88
    cap = moe_mod.capacity_of(T, ecfg.moe_experts)
    say("12b moe", experts=ecfg.moe_experts, tokens=T, capacity=cap,
        one_hot_gb=f"{T * 2 * ecfg.moe_experts * cap * 4 / 1e9:.1f}", aux_calls=len(aux),
        aux_first=f"{aux[0]:.6f}", aux_range=f"{min(aux):.6f}-{max(aux):.6f}",
        step_ms=f"{step_ms:.2f}", card=repr(card))
    return {"train": launches, "eval": eval_launches, "step_ms": step_ms}


def _launch_ranks(world: int, flag: str, d: str) -> None:
    """``world`` ranks of this script (``flag d``) through ``cli.launch
    --nproc_per_node world``, one card each."""
    import sys

    log = os.path.join(d, "launch.txt")
    _wait_launch(_popen_launch(["--nproc_per_node", str(world), "--max_restarts", "0",
                                "--master_port", "0", "--error_dir", os.path.join(d, "err"),
                                "--", sys.executable, os.path.abspath(__file__), flag, d],
                               log), log, MP_LAUNCH_TIMEOUT_S)


def tp_rank(d: str) -> None:
    """One rank of (c) under cli.launch: the mesh from TPU.MESH_MODEL 2
    (``resolve_mesh``), the model cut by ``shard_editor``; the eval step's
    features of the saved eval batch from the saved weights, then 2 global
    batch steps on this rank's rows (each step's launches and collectives),
    the canonical checkpoint (rank 0 writes) and the gathered state, and the
    step's time."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.engine.loop import resolve_mesh
    from editor_tpu_torch.parallel import collectives as Coll
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import model_group, shard_batch
    from editor_tpu_torch.parallel.tp import gather_editor_state
    from editor_tpu_torch.utils.checkpoint import train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank = multihost.process_index()
    cfg, ecfg = inp["cfg"], inp["ecfg"]
    mesh = resolve_mesh(cfg, torch.device("cuda", torch.cuda.current_device()))
    sd = {k: v.cuda() for k, v in inp["sd"].items()}
    model, step = _dp_step("global", cfg, ecfg, sd, mesh, augment=False)
    reset_counts()
    feats = build_eval_step(model, torch.bfloat16, mesh)(
        {k: v.cuda() for k, v in inp["eval"].items()})
    out = {"feats": feats.cpu(), "eval_launches": launch_counts(), "mesh": list(mesh.shape)}
    batch = shard_batch(mesh, {k: v.cuda() for k, v in inp["batch"].items()})
    out.update(losses=[], launches=[], collectives=[])
    for e in (1, 2):
        reset_counts()
        Coll.reset_collective_counts()
        out["losses"].append(float(step(batch, e)["loss"]))
        out["launches"].append(launch_counts())
        out["collectives"].append(Coll.collective_counts())
    payload = train_state(model, step.optimizer, step.generator, 2, tp_mesh=mesh)
    state = {k: v.cpu() for k, v in gather_editor_state(model, model_group(mesh)).items()}
    if rank == 0:
        torch.save(payload, os.path.join(d, "ckpt.pt"))
        out["sd"] = state
    out["ms"] = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def _tp_multi(card: str, gen: torch.Generator) -> dict:
    """(c) with two cards or more: TPU.MESH_MODEL 2 through cli.launch on 2
    ranks (data 1 x model 2) and, with four cards, 4 (2 x 2), against one
    card from the same weights and batch (drop path 0, no augmentation,
    phase 10 (e)'s identity-like images): losses within TP_LOSS_TOL and
    every tensor's change within phase 10 (e)'s DP_W_LIMIT; the TP eval
    features against one card's under phase 3's gates; the canonical
    checkpoint loaded strictly into a one-card model equal to the gathered
    TP state bit for bit; K1 and K4 (at H = 6), K2, K3 and K5 counted a step
    on each rank; the TP step's ms against one card's."""
    import shutil
    import tempfile

    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init

    n = torch.cuda.device_count()
    if n < 2:
        say("12c tp ranks", world_sizes="1", note="one card: the TP check needs two")
        return {}
    cfg, ecfg = flagship(["TPU.MESH_MODEL", "2"])
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.0))
    L = ecfg.vit.depth
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    h, w = ecfg.vit.img_size
    sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    batch = _dp_id_batch(gen, _dp_batch(gen, cfg, h, w))
    eval_batch = _eval_batch(gen, 64)
    model = Editor(ecfg)
    model.load_state_dict(sd0, strict=True)
    ref_feats = build_eval_step(model, torch.bfloat16)(eval_batch)
    del model
    ref_losses, ref_d, step = _dp_one_card(cfg, ecfg, sd0, batch)
    one_ms = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
    del step
    torch.cuda.empty_cache()
    worlds = [2] + ([4] if n >= 4 else [])
    result = {}
    for world in worlds:
        d = tempfile.mkdtemp(prefix=f"chip_smoke_tp{world}_")
        try:
            torch.save({"cfg": cfg, "ecfg": ecfg, "sd": {k: v.cpu() for k, v in sd0.items()},
                        "batch": {k: v.cpu() for k, v in batch.items()},
                        "eval": {k: v.cpu() for k, v in eval_batch.items()}},
                       os.path.join(d, "inputs.pt"))
            _launch_ranks(world, "--tp-rank", d)
            outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
                    for r in range(world)]
            sd = outs[0]["sd"]
            deltas = {k: sd[k].float() - sd0[k].float().cpu() for k in ref_d}
            err = _delta_err(deltas, ref_d)
            dl = max(abs(a - b) / abs(b) for a, b in zip(outs[0]["losses"], ref_losses))
            if not (all(o["losses"] == outs[0]["losses"] for o in outs) and dl <= TP_LOSS_TOL
                    and max(err.values()) <= DP_W_LIMIT):
                raise AssertionError(f"TP W = {world}: losses {outs[0]['losses']} vs "
                                     f"{ref_losses}; worst {_worst(err)}")
            for r, o in enumerate(outs):
                if any(lc != want for lc in o["launches"]) or o["eval_launches"] != want_eval:
                    raise AssertionError(f"TP rank {r}: launches {o['launches']}, eval "
                                         f"{o['eval_launches']}")
                min_cos, max_rel = _feature_agreement(o["feats"].cuda(), ref_feats)
                if not (min_cos >= 0.99 and max_rel <= 0.08):
                    raise AssertionError(f"TP rank {r} eval: cos {min_cos}, rel {max_rel}")
            payload = torch.load(os.path.join(d, "ckpt.pt"), weights_only=False)
            one = Editor(ecfg)
            one.load_state_dict(payload["model"], strict=True)
            loaded = one.state_dict()
            if not all(torch.equal(loaded[k].cpu(), sd[k]) for k in sd):
                raise AssertionError("the canonical checkpoint != the gathered TP state")
            del one, loaded, payload
            colls = outs[0]["collectives"][-1]
            result[world] = outs[0]["ms"]
            say("12c tp ranks", world=world, mesh=outs[0]["mesh"],
                losses=json.dumps(outs[0]["losses"]), ref_losses=json.dumps(ref_losses),
                max_rel_dloss=f"{dl:.2e}", loss_limit=TP_LOSS_TOL,
                max_err=f"{max(err.values()):.3e}",
                worst=_worst(err), limit=DP_W_LIMIT, launches_per_step=json.dumps(want),
                eval_equal_gate=True, checkpoint_canonical=True,
                collectives_per_step=json.dumps(colls),
                tp_step_ms=f"{outs[0]['ms']:.2f}", one_card_step_ms=f"{one_ms:.2f}",
                card=repr(card))
            last = outs[0]["launches"][-1]
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return {"train": last, "step_ms": result}


def _canonical_state(model, opt, mesh) -> dict:
    """The model's state_dict on the host: under FSDP on the gathered
    parameters, under tensor parallelism gathered over the model group and
    un-permuted (collectives)."""
    import contextlib

    from editor_tpu_torch.parallel.mesh import model_group, model_size
    from editor_tpu_torch.parallel.tp import gather_editor_state

    with opt.gathered() if hasattr(opt, "gathered") else contextlib.nullcontext():
        sd = (gather_editor_state(model, model_group(mesh)) if model_size(mesh) > 1
              else model.state_dict())
        return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _checkpoint_canonical(payload, state: dict, cfg, ecfg, data: int) -> bool:
    """A ``train_state`` payload in the one-device format: its model equal
    to the gathered canonical ``state``, every slot shaped as a one-device
    optimizer's, the reducer's error feedback one a data rank."""
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.solver import make_optimizer

    one = make_optimizer(cfg, Editor(ecfg, device="meta")).state_dict()["state"]
    shapes = lambda st: [{k: [tuple(t.shape) for t in v] for k, v in g.items()} for g in st]
    return (payload["model"].keys() == state.keys()
            and all(torch.equal(payload["model"][k].cpu(), v) for k, v in state.items())
            and shapes(payload["optimizer"]["state"]) == shapes(one)
            and all(len(c["errors"]) == data for c in payload.get("comm", {}).values()))


def zero_rank(d: str) -> None:
    """One rank of 12 (e) and 13 (d) under cli.launch: on the mesh (data,
    [stage,] model) of the saved layout, with the pipelined backbone when it
    has stages, each saved kind ('global', 'zero1', 'fsdp', 'ddp' with
    PowerSGD) from the saved weights for 2 steps on this rank's rows (each
    step's launches), the canonical state and whether the checkpoint
    payload (``train_state``, collective) is canonical (rank 0 keeps
    both), the parameter and slot bytes between steps (and, under FSDP,
    param_memory_bytes of the cut model over the data axis), the step's ms
    and the peak memory."""
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.compression import make_reducer
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes
    from editor_tpu_torch.parallel.mesh import data_size, make_mesh, shard_batch
    from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone
    from editor_tpu_torch.parallel.zero import state_memory_bytes
    from editor_tpu_torch.utils.checkpoint import train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank = multihost.process_index()
    cfg, ecfg = inp["cfg"], inp["ecfg"]
    mesh = make_mesh(inp["data"], inp["tp"], stage=inp.get("stage"))
    tp_mesh = mesh if inp["tp"] > 1 else None
    bb = make_pipeline_backbone(mesh, PP_M) if inp.get("stage") else None
    sd = {k: v.cuda() for k, v in inp["sd"].items()}
    batch = shard_batch(mesh, {k: v.cuda() for k, v in inp["batch"].items()})
    out = {"mesh": list(mesh.shape)}
    for kind in inp["kinds"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reducer = make_reducer("powersgd", rank=4) if kind == "ddp" else None
        model, step = _dp_step(kind, cfg, ecfg, sd, mesh, augment=False, reducer=reducer,
                               backbone=bb)
        rec = {"losses": [], "launches": []}
        for e in (1, 2):
            reset_counts()
            rec["losses"].append(float(step(batch, e)["loss"]))
            rec["launches"].append(launch_counts())
        opt = step.optimizer
        rec["param_bytes"] = (opt.param_bytes() if hasattr(opt, "param_bytes") else
                              sum(p.untyped_storage().nbytes() for p in model.parameters()))
        rec["slot_bytes"] = state_memory_bytes(opt)
        if kind == "fsdp":
            rec["want_bytes"] = param_memory_bytes(model, True, data_size(mesh))
        state = _canonical_state(model, opt, mesh)
        if rank == 0:
            rec["sd"] = state
        rec["ms"] = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # the state after the timed steps, through the checkpoint's gathers
        payload = train_state(model, opt, step.generator, 2,
                              comm=getattr(step, "comm", None), tp_mesh=tp_mesh)
        state = _canonical_state(model, opt, mesh)
        if rank == 0:
            rec["checkpoint_canonical"] = _checkpoint_canonical(payload, state, cfg, ecfg,
                                                                inp["data"])
        del state, payload
        out[kind] = rec
        del model, step, opt
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def _zero_launch(world: int, inputs: dict, prefix: str) -> list:
    """``world`` ranks of :func:`zero_rank` on ``inputs``: each rank's
    output."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix=prefix)
    try:
        torch.save(inputs, os.path.join(d, "inputs.pt"))
        _launch_ranks(world, "--zero-rank", d)
        return [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _zero_gates(label: str, outs: list, ref: str, sd0: dict, want: dict) -> dict:
    """ZeRO-1 against the ``ref`` kind of the same launch bit for bit, FSDP
    bit for bit or within phase 10 (e)'s DP_W_LIMIT of it, tensor by
    tensor; every rank's losses the same and each step's launches ``want``;
    FSDP's parameter bytes between steps param_memory_bytes of the cut
    model; every kind's checkpoint canonical. Returns per kind whether it
    was bit for bit and its gate."""
    kinds = [k for k in ("zero1", "fsdp") if k in outs[0]]
    base = outs[0][ref]
    names = [k for k in base["sd"] if base["sd"][k].is_floating_point()
             and not k.endswith(("running_mean", "running_var", "_centers"))]
    sd0c = {k: v.cpu() for k, v in sd0.items()}
    result = {}
    for kind in [k for k in outs[0] if k != "mesh"]:
        if not outs[0][kind]["checkpoint_canonical"]:
            raise AssertionError(f"{label} {kind}: the checkpoint is not canonical")
    for kind in [ref] + kinds:
        for r, o in enumerate(outs):
            if o[kind]["losses"] != outs[0][kind]["losses"]:
                raise AssertionError(f"{label} {kind}: rank {r}'s losses {o[kind]['losses']}")
            if any(lc != want for lc in o[kind]["launches"]):
                raise AssertionError(f"{label} {kind} rank {r}: launches "
                                     f"{o[kind]['launches']} != {want}")
    for kind in kinds:
        got = outs[0][kind]
        same = got["losses"] == base["losses"] and all(
            torch.equal(got["sd"][k], base["sd"][k]) for k in base["sd"])
        err = _delta_err({k: got["sd"][k].float() - sd0c[k].float() for k in names},
                         {k: base["sd"][k].float() - sd0c[k].float() for k in names})
        if kind == "zero1" and not same:
            raise AssertionError(f"{label} ZeRO-1 != the {ref} step: losses {got['losses']} "
                                 f"vs {base['losses']}; worst {_worst(err)}")
        if kind == "fsdp":
            if not same and max(err.values()) > DP_W_LIMIT:
                raise AssertionError(f"{label} FSDP vs the {ref} step: worst {_worst(err)}")
            for r, o in enumerate(outs):
                if o["fsdp"]["param_bytes"] != o["fsdp"]["want_bytes"]:
                    raise AssertionError(f"{label} rank {r}: {o['fsdp']['param_bytes']} "
                                         "parameter bytes between steps, param_memory_bytes "
                                         f"{o['fsdp']['want_bytes']}")
        result[kind] = {"bit_for_bit": same, "max_err": f"{max(err.values()):.3e}",
                        "limit": DP_W_LIMIT}
    return result


def _zero_say(label: str, outs: list, kind: str, card: str, **extra) -> None:
    """One result line of a kind: losses, bytes, peak memory and ms."""
    o = outs[0][kind]
    say(label, kind=kind, mesh=outs[0]["mesh"], losses=json.dumps(o["losses"]), **extra,
        checkpoint_canonical=o["checkpoint_canonical"],
        param_mb_per_rank=json.dumps([round(x[kind]["param_bytes"] / 1e6, 2) for x in outs]),
        slot_mb_per_rank=json.dumps([round(x[kind]["slot_bytes"] / 1e6, 2) for x in outs]),
        peak_gb_per_rank=json.dumps([round(x[kind]["peak_gb"], 2) for x in outs]),
        step_ms=f"{o['ms']:.2f}", card=repr(card))


def _tp_zero_multi(card: str, gen: torch.Generator) -> dict:
    """(e) with four cards: data 2 x model 2 through cli.launch, the
    flagship (phase 12 (c)'s weights, batch and settings): ZeRO-1 equal to
    (c)'s TP step bit for bit, FSDP within phase 10 (e)'s DP_W_LIMIT of it,
    PowerSGD on the TP mesh within TP_LOSS_TOL of the data-2 DDP step on two
    cards (its loss and every tensor's change, printed); each rank's
    launches a step as (c)'s, its parameter and slot bytes between steps,
    its peak memory and the step's ms."""
    from editor_tpu_torch.models.init import editor_init

    n = torch.cuda.device_count()
    if n < 4:
        say("12e tp zero", world_sizes=str(n), note=f"{n} card(s): (e) needs four "
            "(data 2 x model 2); not run")
        return {}
    cfg, ecfg = flagship(["TPU.MESH_MODEL", "2"])
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.0))
    L = ecfg.vit.depth
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    h, w = ecfg.vit.img_size
    sd0 = {k: v.cpu() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    batch = {k: v.cpu() for k, v in _dp_id_batch(gen, _dp_batch(gen, cfg, h, w)).items()}
    inputs = {"cfg": cfg, "ecfg": ecfg, "sd": sd0, "batch": batch}
    outs = _zero_launch(4, dict(inputs, data=2, tp=2,
                                kinds=["global", "zero1", "fsdp", "ddp"]), "chip_smoke_tpz_")
    gates = _zero_gates("12e", outs, "global", sd0, want)
    ref = _zero_launch(2, dict(inputs, data=2, tp=1, kinds=["ddp"]), "chip_smoke_ddp2_")
    ps, ps_ref = outs[0]["ddp"], ref[0]["ddp"]
    for r, o in enumerate(outs):
        if any(lc != want for lc in o["ddp"]["launches"]) or o["ddp"]["losses"] != ps["losses"]:
            raise AssertionError(f"12e powersgd rank {r}: {o['ddp']}")
    dl = max(abs(a - b) / abs(b) for a, b in zip(ps["losses"], ps_ref["losses"]))
    names = [k for k in ps_ref["sd"] if ps_ref["sd"][k].is_floating_point()
             and not k.endswith(("running_mean", "running_var", "_centers"))]
    err = _delta_err({k: ps["sd"][k].float() - sd0[k].float() for k in names},
                     {k: ps_ref["sd"][k].float() - sd0[k].float() for k in names})
    if dl > TP_LOSS_TOL:
        raise AssertionError(f"12e powersgd on (2, 2): losses {ps['losses']} vs the data-2 "
                             f"DDP step's {ps_ref['losses']}")
    tp_ms = outs[0]["global"]["ms"]
    _zero_say("12e tp zero", outs, "global", card, role="phase 12 (c)'s TP step")
    for kind in ("zero1", "fsdp"):
        _zero_say("12e tp zero", outs, kind, card, tp_step_ms=f"{tp_ms:.2f}",
                  ref_losses=json.dumps(outs[0]["global"]["losses"]),
                  launches_per_step=json.dumps(want), **gates[kind])
    _zero_say("12e tp zero", outs, "ddp", card, reducer="powersgd4",
              ref_losses=json.dumps(ps_ref["losses"]), max_rel_dloss=f"{dl:.2e}",
              loss_limit=TP_LOSS_TOL, max_err=f"{max(err.values()):.3e}", worst=_worst(err),
              data2_ddp_step_ms=f"{ps_ref['ms']:.2f}", tp_step_ms=f"{tp_ms:.2f}")
    return {k: outs[0][k]["launches"][-1] for k in ("zero1", "fsdp", "ddp")}


def _pp_zero_multi(card: str, gen: torch.Generator) -> dict:
    """(d) with four cards: data 2 x stage 2 (M = 4) through cli.launch on
    phase 10 (e)'s inputs: the dp x pp step against one card as (b) is
    (losses within 1%, every tensor's change within DP_W_LIMIT), ZeRO-1
    equal to it bit for bit and FSDP within DP_W_LIMIT of it, each rank's
    launches for its blocks; bytes, peak memory and ms."""
    from editor_tpu_torch.models.init import editor_init

    n = torch.cuda.device_count()
    if n < 4:
        say("13d pp zero", world_sizes=str(n), note=f"{n} card(s): (d) needs four "
            "(data 2 x stage 2); not run")
        return {}
    cfg, ecfg = flagship()
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.0))
    h, w = ecfg.vit.img_size
    sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    batch = _dp_id_batch(gen, _dp_batch(gen, cfg, h, w))
    ref_losses, ref_d, step = _dp_one_card(cfg, ecfg, sd0, batch)
    one_ms = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
    del step
    torch.cuda.empty_cache()
    sd0 = {k: v.cpu() for k, v in sd0.items()}
    want = _pp_want(ecfg.vit.depth // 2, PP_M, train=True)
    outs = _zero_launch(4, {"cfg": cfg, "ecfg": ecfg, "sd": sd0, "data": 2, "tp": 1,
                            "stage": 2, "kinds": ["global", "zero1", "fsdp"],
                            "batch": {k: v.cpu() for k, v in batch.items()}},
                        "chip_smoke_ppz_")
    base = outs[0]["global"]
    err = _delta_err({k: base["sd"][k].float() - sd0[k].float() for k in ref_d}, ref_d)
    dl = max(abs(a - b) / abs(b) for a, b in zip(base["losses"], ref_losses))
    if not (dl <= 0.01 and max(err.values()) <= DP_W_LIMIT):
        raise AssertionError(f"13d dp x pp: losses {base['losses']} vs {ref_losses}; "
                             f"worst {_worst(err)}")
    gates = _zero_gates("13d", outs, "global", sd0, want)
    _zero_say("13d pp zero", outs, "global", card, stage=2, microbatches=PP_M,
              ref_losses=json.dumps(ref_losses), max_rel_dloss=f"{dl:.2e}",
              max_err=f"{max(err.values()):.3e}", limit=DP_W_LIMIT,
              one_card_step_ms=f"{one_ms:.2f}")
    for kind in ("zero1", "fsdp"):
        _zero_say("13d pp zero", outs, kind, card, stage=2, microbatches=PP_M,
                  dp_pp_step_ms=f"{base['ms']:.2f}", launches_per_step=json.dumps(want),
                  **gates[kind])
    return {f"dp2xpp2_{k}": {"train": outs[0][k]["launches"][-1], "ms": outs[0][k]["ms"]}
            for k in ("global", "zero1", "fsdp")}


def _mp_inputs(gen: torch.Generator) -> dict:
    """(d)'s inputs: the flagship fusion block's weights (dense and with 8
    experts; seeded), bf16 per-modality features [128, 88, 768] with a
    union mask keeping half the patches, labels, and the joint attention's
    bf16 qkv [128, 264, 2304], mask and output cotangent, and the fixed
    fp32 projection [128, 264, 768] of the fused tokens that the block's
    loss takes."""
    from editor_tpu_torch.models.fusion import BlockMask
    from editor_tpu_torch.parallel.moe import moe_init

    B, n, E = B_EVAL, 88, 8
    blocks = {}
    for name, experts in (("seq", 0), ("moe", E)):
        block = BlockMask(C, 171, num_heads=H, num_experts=experts, device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for pname, p in block.named_parameters():
                if pname.endswith("weight") and p.dim() == 2:
                    p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), std=0.02,
                                                        generator=g))
                elif pname.endswith("weight"):
                    p.fill_(1.0)
                elif pname.endswith("bias"):
                    p.zero_()
            if experts:
                for k, v in moe_init(C, 4 * C, E, g)._asdict().items():
                    getattr(block.moe_mlp, k).copy_(v)
        blocks[name] = {k: v.clone() for k, v in block.state_dict().items()}
    cuda = lambda t: t.to("cuda")
    feats = [cuda(torch.randn(B, n, C, generator=torch.Generator().manual_seed(10 + i))
                  .to(torch.bfloat16)) for i in range(3)]
    mask = cuda((torch.rand(B, n - 1, 1, generator=torch.Generator().manual_seed(20)) < 0.5)
                .float())
    qkv = torch.randn(B, 3 * n, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    jmask = (torch.rand(B, 3 * n, generator=gen, device="cuda") < 0.6).float()
    jmask[:, ::n] = 1.0  # the cls tokens
    return {"blocks": blocks, "feats": feats, "mask": mask,
            "labels": cuda(torch.arange(B) // 16),
            "qkv": qkv, "jmask": jmask,
            "proj": cuda(torch.randn(B, 3 * n, C, generator=torch.Generator().manual_seed(30))),
            "g": torch.randn(B, 3 * n, C, generator=gen, device="cuda").to(torch.bfloat16)}


def _mp_block_run(inp: dict, name: str, use_kernels: bool = True,
                  dtype: torch.dtype = torch.bfloat16, **kw) -> dict:
    """The fusion block ``name`` ('seq' dense, 'moe' with 8 experts) in
    training on the card, its features in ``dtype``: the loss mean(fused *
    proj) + OCFR (+ 0.01 aux), the fused tokens, every parameter's gradient
    and the launches. (Not mean(fused^2): the output LayerNorm makes that
    nearly constant, so the gradients before it would be rounding noise.)"""
    from editor_tpu_torch.models.fusion import BlockMask

    block = BlockMask(C, 171, num_heads=H, num_experts=8 if name == "moe" else 0,
                      device="cuda")
    block.load_state_dict({k: v.cuda() for k, v in inp["blocks"][name].items()}, strict=True)
    reset_counts()
    fused, ocfr, aux = block([f.to("cuda", dtype) for f in inp["feats"]], inp["mask"].cuda(),
                             use_kernels, labels=inp["labels"].cuda(), **kw)
    loss = (fused.float() * inp["proj"].cuda()).mean() + ocfr
    loss = loss + (0.0 if aux is None else 0.01 * aux)
    loss.backward()
    torch.cuda.synchronize()
    return {"loss": float(loss), "fused": fused.detach().float().cpu(),
            "grads": {k: p.grad.float().cpu() for k, p in block.named_parameters()},
            "launches": launch_counts()}


def _ulysses_run(inp: dict, mesh=None) -> dict:
    """Ulysses masked attention over ``mesh``'s 'seq' group (or K3 on the
    whole joint sequence without one): the output and dqkv."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.parallel.ring import ulysses_masked_attention

    qkv = inp["qkv"].detach().to("cuda", copy=True).requires_grad_(True)  # a leaf of its own
    reset_counts()
    if mesh is None:
        out = ops.masked_attention_qkv_fn(qkv, inp["jmask"].cuda(), H, SCALE, FILL)
    else:
        B, N, _ = qkv.shape
        q, k, v = (t.transpose(1, 2) for t in qkv.view(B, N, 3, H, D).unbind(2))
        out = ulysses_masked_attention(q, k, v, inp["jmask"].cuda(), mesh, SCALE, FILL)
        out = out.transpose(1, 2).reshape(B, N, C)
    out.backward(inp["g"].cuda())
    torch.cuda.synchronize()
    return {"out": out.detach().float().cpu(), "dqkv": qkv.grad.float().cpu(),
            "launches": launch_counts()}


def mp_rank(d: str) -> None:
    """One rank of (d) under cli.launch: the fusion block with ``moe_mesh``
    and with ``seq_mesh`` over every rank, and Ulysses at the joint block's
    attention."""
    from torch.distributed.device_mesh import init_device_mesh

    from editor_tpu_torch.parallel import multihost

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank, world = multihost.process_index(), multihost.process_count()
    meshes = {a: init_device_mesh("cuda", (world,), mesh_dim_names=(a,))
              for a in ("seq", "expert")}
    out = {"moe": _mp_block_run(inp, "moe", moe_mesh=meshes["expert"]),
           "seq": _mp_block_run(inp, "seq", seq_mesh=meshes["seq"]),
           "seq32": _mp_block_run(inp, "seq", dtype=torch.float32, seq_mesh=meshes["seq"]),
           "ulysses": _ulysses_run(inp, meshes["seq"])}
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def _mp_multi(card: str, gen: torch.Generator) -> dict:
    """(d) with two cards or more: 2 ranks (``--mp-rank`` through cli.launch)
    run the flagship fusion block with ``moe_mesh`` against the
    ``moe_shards`` = 2 block on one card, with ``seq_mesh`` (the masked
    ring) against the local block with the plain attention, and Ulysses at
    the joint block's attention against K3 on the whole sequence: losses,
    outputs and the mean of the ranks' gradients (each tensor on its own
    scale, floored at 1e-3 of the block's largest, :func:`_grad_err`)
    within MP_TOL; the ring's block and the plain one again in fp32, their
    gradients within MP_F32_TOL the same way; Ulysses' local attention
    counted as K3 (and K5 in its backward)."""
    import shutil
    import tempfile

    if torch.cuda.device_count() < 2:
        say("12d mp ranks", world_sizes="1", note="one card: expert and sequence "
            "parallelism need two")
        return {}
    inp = _mp_inputs(gen)
    # the masked ring is the plain (XLA-form) masked attention's math, spread
    # over the ranks: its one-card block is the plain one; the block with
    # K3/K5 ("seq_k3") is printed beside it, not gated
    ref = {"moe": _mp_block_run(inp, "moe", moe_shards=2),
           "seq": _mp_block_run(inp, "seq", use_kernels=False),
           "seq32": _mp_block_run(inp, "seq", use_kernels=False, dtype=torch.float32),
           "seq_k3": _mp_block_run(inp, "seq"),
           "ulysses": _ulysses_run(inp)}
    d = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    world = 2
    try:
        torch.save({k: ({n: {p: t.cpu() for p, t in b.items()} for n, b in v.items()}
                        if k == "blocks" else
                        [t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                    for k, v in inp.items()}, os.path.join(d, "inputs.pt"))
        _launch_ranks(world, "--mp-rank", d)
        outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
                for r in range(world)]
        errs, worst_tensors = {}, {}
        for name in ("moe", "seq", "seq32", "seq_k3"):
            r0, run = ref[name], "seq" if name == "seq_k3" else name
            grads = _grad_err({k: sum(o[run]["grads"][k] for o in outs) / world
                               for k in r0["grads"]}, r0["grads"])
            errs[name] = {
                "loss": max(abs(o[run]["loss"] - r0["loss"]) / abs(r0["loss"]) for o in outs),
                "fused": max(_scaled(o[run]["fused"], r0["fused"]) for o in outs),
                "grads": max(grads.values())}
            worst_tensors[name] = _worst(grads)
        errs["ulysses"] = {"out": max(_scaled(o["ulysses"]["out"], ref["ulysses"]["out"])
                                      for o in outs),
                           "dqkv": _scaled(sum(o["ulysses"]["dqkv"] for o in outs) / world,
                                           ref["ulysses"]["dqkv"])}
        worst = max(v for n, e in errs.items() if n in ("moe", "seq", "ulysses")
                    for v in e.values())
        if not (worst <= MP_TOL and max(errs["seq32"].values()) <= MP_F32_TOL):
            raise AssertionError(f"(d) against one card: {errs}, worst tensors "
                                 f"{worst_tensors} (limits {MP_TOL}, fp32 {MP_F32_TOL})")
        uly = outs[0]["ulysses"]["launches"]
        if uly["masked_attention_qkv"] != 1 or uly["masked_attention_qkv_bwd"] != 1:
            raise AssertionError(f"Ulysses launches {uly}")
        say("12d mp ranks", world=world, limit=MP_TOL, fp32_limit=MP_F32_TOL,
            errors=json.dumps({k: {n: f"{v:.3e}" for n, v in e.items()}
                               for k, e in errs.items()}),
            worst_tensors=json.dumps(worst_tensors),
            ulysses_launches=json.dumps({k: v for k, v in uly.items() if v}),
            seq_launches=json.dumps({k: v for k, v in outs[0]["seq"]["launches"].items()
                                     if v}), card=repr(card))
        return {"ulysses": uly, "seq": outs[0]["seq"]["launches"],
                "moe": outs[0]["moe"]["launches"]}
    finally:
        shutil.rmtree(d, ignore_errors=True)


# (f): the MoE beside a data axis. The gate on the mesh eval's routing
# (MOE_ROUTE_GATE): its capacity is one card's (the global batch's), each
# rank's dropped pairs in its rows within MOE_DROP_TOL of its pairs of one
# card's drops in those rows, and its features within phase 3's gates of one
# card's. Routing each rank's rows alone (the eval before it took the data
# group) must fail it in the same run.
MOE_ROUTE_GATE = "capacity = one card's, drops in the rank's rows within MOE_DROP_TOL, phase 3"
MOE_DROP_TOL = 0.01
MOE_BUSY = 2  # the expert whose router column (f) scales x5, so that it overflows


class _Drops:
    """Inside ``with``: each ``parallel.moe.dispatch`` call's capacity and
    the (token, choice) pairs it drops per token, in ``calls``."""

    def __enter__(self):
        from editor_tpu_torch.parallel import moe as moe_mod
        self.mod, self.real, self.calls = moe_mod, moe_mod.dispatch, []

        def dispatch(x, idx, pos, E, capacity):
            buf, row = self.real(x, idx, pos, E, capacity)
            self.calls.append((capacity, (row == E * capacity).sum(dim=1).cpu()))
            return buf, row

        moe_mod.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self.mod.dispatch = self.real

    def total(self) -> int:
        return sum(int(d.sum()) for _, d in self.calls)


def _moe_data_inputs(gen: torch.Generator) -> dict:
    """(f)'s inputs: the MoE flagship (MODEL.MOE_EXPERTS 8, drop path 0)
    from seeded weights with expert MOE_BUSY's router column x5, phase 10
    (e)'s identity-like train batch (B = 128) and an eval batch of 128."""
    from editor_tpu_torch.models.init import editor_init

    cfg, ecfg = flagship(["MODEL.MOE_EXPERTS", "8"])
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.0))
    sd = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    sd["FUSE_block.moe_mlp.router"][:, MOE_BUSY] *= 5.0
    h, w = ecfg.vit.img_size
    return {"cfg": cfg, "ecfg": ecfg, "sd": sd,
            "batch": _dp_id_batch(gen, _dp_batch(gen, cfg, h, w)),
            "eval": _eval_batch(gen, B_EVAL)}


def _moe_model(inp: dict, use_kernels: bool = True):
    from editor_tpu_torch.models.editor import Editor

    model = Editor(dataclasses.replace(inp["ecfg"], use_pallas=use_kernels))
    model.load_state_dict({k: v.cuda() for k, v in inp["sd"].items()}, strict=True)
    return model


def _moe_data_step(inp: dict, rows: slice, dtype: torch.dtype, timed: bool = False,
                   **kw) -> dict:
    """(f)'s step on this process: the EDITOR's training forward on the
    ``rows`` of the train batch in ``dtype`` (the kernels in bf16, the plain
    ops in fp32) with the global labels, the train step's loss (every (score,
    feat) pair through make_loss, plus the aux loss) and its backward (``kw``:
    ``batch_group=`` with ``moe_mesh=``, or ``moe_shards=`` on one card),
    counted from zero: the loss, the global cls4t, every parameter's
    gradient, the launches and the dropped pairs; with ``timed`` the ms of a
    forward + backward and the peak memory."""
    from editor_tpu_torch.losses import make_loss

    model = _moe_model(inp, use_kernels=dtype == torch.bfloat16)
    loss_func = make_loss(inp["cfg"], inp["ecfg"].num_classes)
    batch = {k: v.cuda() for k, v in inp["batch"].items()}
    labels = batch["pid"]
    images = {m: batch[m][rows].to(dtype) for m in ("RGB", "NI", "TI")}

    def run():
        model.zero_grad(set_to_none=True)
        out = model(images, cam_ids=batch["camid"][rows], training=True, labels=labels,
                    generator=torch.Generator(device="cuda").manual_seed(0), **kw)
        total = out.aux_loss
        for score, feat in out.pairs:
            total = total + loss_func(score, feat, labels)
        total.backward()
        return total, out.cls4t

    reset_counts()
    with _Drops() as drops:
        loss, cls4t = run()
        torch.cuda.synchronize()
    res = {"loss": float(loss), "cls4t": cls4t.detach().float().cpu(),
           "launches": launch_counts(), "drops": drops.total(),
           "capacity": [c for c, _ in drops.calls],
           "grads": {k: p.grad.detach().float() for k, p in model.named_parameters()
                     if p.grad is not None}}
    if timed:
        torch.cuda.reset_peak_memory_stats()
        res["ms"] = cuda_ms(run, iters=3)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def _moe_eval_run(inp: dict, mesh=None, rows: slice = slice(None)) -> dict:
    """The eval forward of (f)'s model (bf16) on the eval batch, counted
    from zero: through ``build_eval_step(mesh=)`` (every rank's features,
    the routing the global batch's), or, with ``rows`` and no mesh, the
    model on those rows alone (each rank routing its own rows, as the eval
    step did before it took the data group), with each routing's capacity
    and dropped pairs per token."""
    from editor_tpu_torch.engine.evaluate import build_eval_step

    model = _moe_model(inp)
    batch = {k: v.cuda()[rows] for k, v in inp["eval"].items()}
    step = build_eval_step(model, torch.bfloat16, mesh)
    reset_counts()
    with _Drops() as drops:
        feats = step(batch)
        torch.cuda.synchronize()
    launches = launch_counts()
    return {"feats": feats.cpu(), "launches": launches, "capacity": drops.calls[0][0],
            "drops": torch.cat([d for _, d in drops.calls])}


def moe_rank(d: str) -> None:
    """One rank of (f) under cli.launch. Two ranks: layout (i), the expert
    group is the data group (``moe_mesh`` = the data ranks); four: layout
    (ii), a ('data', 'expert') mesh of 2 x 2. The step on this data rank's
    rows in bf16 (launches, dropped pairs, ms, peak memory) and in fp32,
    the gradients mean-all-reduced over every rank (rank 0 writes them);
    the mesh eval forward and the per-rank routing of this rank's rows."""
    from torch.distributed.device_mesh import init_device_mesh

    from editor_tpu_torch.parallel import collectives as Coll
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank, world = multihost.process_index(), multihost.process_count()
    if world == 2:
        mesh = make_mesh(2, 1)
        moe_mesh = mesh.get_group("data")
    else:
        mesh = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "expert"))
        moe_mesh = mesh
    r = mesh.get_local_rank("data")
    n = B_EVAL // 2
    rows = slice(r * n, (r + 1) * n)
    out = {"mesh": list(mesh.shape), "data_rank": r}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        res = _moe_data_step(inp, rows, dtype, timed=dtype == torch.bfloat16,
                             batch_group=mesh, moe_mesh=moe_mesh)
        with torch.no_grad():
            mean = {k: Coll.all_reduce(g, None, "mean") for k, g in res.pop("grads").items()}
        if rank == 0:
            res["grads"] = {k: g.cpu() for k, g in mean.items()}
        out[name] = res
        del mean
        torch.cuda.empty_cache()
    out["eval"] = _moe_eval_run(inp, mesh)
    out["eval_per_rank"] = _moe_eval_run(inp, rows=rows)
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def _route_gate(run: dict, ref: dict, rows: slice, ref_feats, feats) -> dict:
    """MOE_ROUTE_GATE of one rank's eval routing ``run`` against one card's
    ``ref``: the capacities, the dropped pairs in ``rows`` (tokens of those
    batch rows) and the features' agreement."""
    n_tok = ref["drops"].numel() // B_EVAL
    ref_rows = int(ref["drops"][rows.start * n_tok:rows.stop * n_tok].sum())
    got_rows = int(run["drops"].sum())
    pairs = 2 * (rows.stop - rows.start) * n_tok
    min_cos, max_rel = _feature_agreement(feats, ref_feats)
    ok = (run["capacity"] == ref["capacity"]
          and abs(got_rows - ref_rows) <= MOE_DROP_TOL * pairs
          and min_cos >= 0.99 and max_rel <= 0.08)
    return {"ok": ok, "capacity": run["capacity"], "ref_capacity": ref["capacity"],
            "drops": got_rows, "ref_drops": ref_rows, "pairs": pairs,
            "min_cos": round(min_cos, 6), "max_rel_l2": round(max_rel, 6)}


def _moe_data_multi(card: str, gen: torch.Generator) -> dict:
    """(f) with two cards or more: the MoE flagship beside a data axis,
    ranks of this script (``--moe-rank``) through cli.launch: layout (i) on
    two cards and, with four, layout (ii) (data 2 x expert 2). Each held to
    one card's step on the global batch with ``moe_shards`` 2, the same
    function: the bf16 step's loss and the mean of the ranks' gradients
    (:func:`_grad_err`) within MP_TOL and its cls4t within phase 3's gates,
    the fp32 step's within MP_F32_TOL (bf16 rounding can flip a near-tied
    routing); each rank launches K1-K5 as (b)'s step; the mesh eval forward
    passes MOE_ROUTE_GATE against one card's eval, and routing each rank's
    rows alone must fail it."""
    import shutil
    import tempfile

    if torch.cuda.device_count() < 2:
        say("12f moe data ranks", world_sizes="1", note="one card: the MoE beside a data "
            "axis needs two")
        return {}
    inp = _moe_data_inputs(gen)
    L = inp["ecfg"].vit.depth
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                    attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    everything = slice(None)
    ref = {"bf16": _moe_data_step(inp, everything, torch.bfloat16, timed=True, moe_shards=2),
           "fp32": _moe_data_step(inp, everything, torch.float32, moe_shards=2)}
    for res in ref.values():
        res["grads"] = {k: g.cpu() for k, g in res["grads"].items()}
    torch.cuda.empty_cache()
    ref["eval"] = _moe_eval_run(inp)
    torch.cuda.empty_cache()
    cpu_inp = {"cfg": inp["cfg"], "ecfg": inp["ecfg"], "sd": inp["sd"],
               "batch": {k: v.cpu() for k, v in inp["batch"].items()},
               "eval": {k: v.cpu() for k, v in inp["eval"].items()}}
    worlds = [2] + ([4] if torch.cuda.device_count() >= 4 else [])
    result = {}
    for world in worlds:
        d = tempfile.mkdtemp(prefix=f"chip_smoke_moe{world}_")
        try:
            torch.save(cpu_inp, os.path.join(d, "inputs.pt"))
            _launch_ranks(world, "--moe-rank", d)
            outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
                    for r in range(world)]
            errs = {}
            for name, tol in (("bf16", MP_TOL), ("fp32", MP_F32_TOL)):
                r0, o0 = ref[name], outs[0][name]
                grads = _grad_err(o0["grads"], r0["grads"])
                errs[name] = {
                    "loss": max(abs(o[name]["loss"] - r0["loss"]) / abs(r0["loss"])
                                for o in outs),
                    "grads": max(grads.values()), "worst": _worst(grads)}
                if name == "fp32":
                    errs[name]["cls4t"] = _scaled(o0["cls4t"], r0["cls4t"])
                if max(v for k, v in errs[name].items() if k != "worst") > tol:
                    raise AssertionError(f"(f) W = {world} {name} against one card: "
                                         f"{errs[name]} (limit {tol})")
            min_cos, max_rel = _feature_agreement(outs[0]["bf16"]["cls4t"],
                                                  ref["bf16"]["cls4t"])
            if not (min_cos >= 0.99 and max_rel <= 0.08):
                raise AssertionError(f"(f) W = {world} cls4t: cos {min_cos}, rel {max_rel}")
            gates, parent = [], []
            for rk, o in enumerate(outs):
                if o["bf16"]["launches"] != want or o["eval"]["launches"] != want_eval:
                    raise AssertionError(f"(f) rank {rk}: launches {o['bf16']['launches']}, "
                                         f"eval {o['eval']['launches']}")
                n = B_EVAL // 2
                rows = slice(o["data_rank"] * n, (o["data_rank"] + 1) * n)
                gates.append(_route_gate(o["eval"], ref["eval"], rows, ref["eval"]["feats"],
                                         o["eval"]["feats"]))
                parent.append(_route_gate(o["eval_per_rank"], ref["eval"], rows,
                                          ref["eval"]["feats"][rows], o["eval_per_rank"]["feats"]))
            if not all(g["ok"] for g in gates):
                raise AssertionError(f"(f) W = {world} mesh eval fails {MOE_ROUTE_GATE}: {gates}")
            if any(g["ok"] for g in parent):
                raise AssertionError(f"(f) W = {world}: per-rank routing passes "
                                     f"{MOE_ROUTE_GATE}: {parent}")
            layout = "(i) expert group = data group" if world == 2 else "(ii) data 2 x expert 2"
            result[world] = {"train": outs[0]["bf16"]["launches"],
                             "eval": outs[0]["eval"]["launches"]}
            say("12f moe data ranks", world=world, layout=repr(layout), mesh=outs[0]["mesh"],
                limit=MP_TOL, fp32_limit=MP_F32_TOL,
                errors=json.dumps({k: {n: (f"{v:.3e}" if isinstance(v, float) else v)
                                       for n, v in e.items()} for k, e in errs.items()}),
                cls4t_min_cos=f"{min_cos:.6f}", cls4t_max_rel_l2=f"{max_rel:.6f}",
                launches_per_step=json.dumps({k: v for k, v in want.items() if v}),
                step_ms=json.dumps([round(o["bf16"]["ms"], 2) for o in outs]),
                one_card_step_ms=f"{ref['bf16']['ms']:.2f}",
                peak_gb=json.dumps([round(o["bf16"]["peak_gb"], 2) for o in outs]),
                one_card_peak_gb=f"{ref['bf16']['peak_gb']:.2f}",
                dropped_pairs=json.dumps([o["bf16"]["drops"] for o in outs]),
                one_card_dropped_pairs=ref["bf16"]["drops"],
                capacity=json.dumps(outs[0]["bf16"]["capacity"]),
                one_card_capacity=json.dumps(ref["bf16"]["capacity"]), card=repr(card))
            say("12f moe data eval", world=world, gate=repr(MOE_ROUTE_GATE),
                drop_tol=MOE_DROP_TOL, mesh_eval=json.dumps(gates),
                per_rank_routing_fails=json.dumps(parent))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return result


def mp_phase(card: str, gen: torch.Generator, cases: str = "abcdef") -> dict:
    """Phase 12: model parallelism. (a) TP shard shapes of K1, K4 and K2 on
    one card; (b) the MoE flagship on one card; (c) TP through cli.launch,
    (d) expert and sequence parallelism on the fusion block and (f) the MoE
    flagship beside a data axis, each with two cards or more, and (e)
    ZeRO-1, FSDP and PowerSGD on a data 2 x model 2 mesh with four (on
    fewer cards they say so). ``cases``: the letters of the cases to run
    (``--phase-12 e``)."""
    run = lambda case, fn, *args: fn(*args) if case in cases else {}  # noqa: E731
    shard = run("a", _tp_shard_kernels, gen)
    moe = run("b", _moe_check, gen, card)
    torch.cuda.empty_cache()
    tp = run("c", _tp_multi, card, gen)
    torch.cuda.empty_cache()
    mp = run("d", _mp_multi, card, gen)
    torch.cuda.empty_cache()
    tpz = run("e", _tp_zero_multi, card, gen)
    torch.cuda.empty_cache()
    moe_data = run("f", _moe_data_multi, card, gen)
    return {"shard": shard, "moe": moe, "tp": tp, "mp": mp, "tpz": tpz, "moe_data": moe_data}


# Pipeline parallelism (phase 13): (a) the flagship through the pipelined
# backbone on an NCCL group of one rank in this process (stage 1, M = 4,
# remat), against the single-device step and the plain fp32 pipelined run;
# with two cards or more (b) 2 stages and, with four, (c) 4 stages and 2
# stages x 2 model ranks, each rank a process of this script (``--pp-rank``)
# through cli.launch, against one card.
PP_M = 4


def _pp_want(L: int, M: int, train: bool) -> dict:
    """A pipelined step's (or eval forward's) launches on a rank running L
    blocks: K1 L*M in the forward (and L*M again in the backward's
    recompute), K4 L*M, no K2, K3 and K5 2 in the replicated tail."""
    if not train:
        return expected(attention_qkv=L * M, masked_attention_qkv=2)
    return expected(attention_qkv=2 * L * M, attention_qkv_bwd=L * M, masked_attention_qkv=2,
                    masked_attention_qkv_bwd=2)


def _pp_hop_bytes(ecfg, B: int, M: int, tp: int = 1) -> dict:
    """Bytes of one microbatch's stage-to-stage hop at bf16: forward the
    tokens, the fp32 rollout product on H/tp heads and (drop path) the draws;
    backward the tokens' gradient."""
    v = ecfg.vit
    mb, N = 3 * B // M, v.num_patches + 1
    tokens = mb * N * v.embed_dim * 2
    prod = mb * (v.num_heads // tp) * N * N * 4
    draws = mb * v.depth * 2 * 4 if v.drop_path_rate > 0 else 0
    return {"tokens": tokens, "prod": prod, "draws": draws, "grad": tokens}


def _pp_steps(cfg, ecfg, sd, batch, mesh=None, backbone=None, dtype=torch.bfloat16,
              augment: bool = True, steps: int = 3):
    """``steps`` train steps from ``sd`` (seed 1, as phase 5): (model, step,
    losses, per-step launches)."""
    model, step = _dp_step("single" if mesh is None else "global", cfg, ecfg, sd, mesh,
                           augment=augment, backbone=backbone, dtype=dtype)
    losses, launches = [], []
    for epoch in range(1, steps + 1):
        reset_counts()
        losses.append(float(step(batch, epoch)["loss"]))
        launches.append(launch_counts())
    if not (np.isfinite(losses).all() and _grads_finite(model)):
        raise AssertionError(f"non-finite losses {losses} or gradients")
    return model, step, losses, launches


def _pp_close(label: str, losses, norm, ref_losses, ref_norm) -> dict:
    """Losses within 3% and the parameter norm within 2% (phase 5's gates)."""
    dloss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    dnorm = abs(norm - ref_norm) / ref_norm
    if not (dloss <= 0.03 and dnorm <= 0.02):
        raise AssertionError(f"{label}: losses {losses} vs {ref_losses}, norm {norm} vs "
                             f"{ref_norm}")
    return {"max_rel_dloss": f"{dloss:.5f}", "rel_dnorm": f"{dnorm:.2e}"}


def _pp_eval(model, ecfg, bb, gen: torch.Generator) -> dict:
    """(a)'s eval: the pipelined forward's launches and features against
    build_eval_step's (phase 3's gates), and how many SFTS-selected tokens
    the two rollouts choose differently."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.frequency import frequency_token_select
    from editor_tpu_torch.models.sfts import sfts_select

    batch = _eval_batch(gen, B_EVAL)
    images = {m: batch[m].to(torch.bfloat16) for m in ("RGB", "NI", "TI")}
    cams = batch["camid"]

    def forward():
        with torch.inference_mode():
            return model(images, cam_ids=cams, training=False, backbone=bb).float()

    forward()
    torch.cuda.synchronize()
    reset_counts()
    feats = forward()
    torch.cuda.synchronize()
    launches = launch_counts()
    want = _pp_want(ecfg.vit.depth, PP_M, train=False)
    if launches != want:
        raise AssertionError(f"pipelined eval launches {launches} != {want}")
    ref = build_eval_step(model, torch.bfloat16)(batch)
    min_cos, max_rel = _feature_agreement(feats, ref)
    if not (feats.shape == ref.shape and torch.isfinite(feats).all()
            and min_cos >= 0.99 and max_rel <= 0.08):
        raise AssertionError(f"pipelined eval vs build_eval_step: cos {min_cos}, rel {max_rel}")
    with torch.inference_mode():
        mods = [images[m] for m in ("RGB", "NI", "TI")]
        v = ecfg.vit
        mask = frequency_token_select(mods, keep=ecfg.frequency_keep, stride=v.stride_size[0],
                                      window=v.patch_size)
        toks, rolls = bb(model, ecfg, mods, cams, None, False, None)
        tok_s, roll_s = model.BACKBONE.base(torch.cat(mods), cams.repeat(3), None, True, False)
        idx = sfts_select(toks, rolls, mask, ecfg.head_keep)[1]
        idx_s = sfts_select(list(tok_s.split(B_EVAL)), list(roll_s.split(B_EVAL)), mask,
                            ecfg.head_keep)[1]
        roll_err = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(rolls, roll_s.split(B_EVAL)))
    fwd_ms = cuda_ms(forward, iters=5)
    ref_ms = cuda_ms(lambda: build_eval_step(model, torch.bfloat16)(batch), iters=5)
    return {"launches": launches, "min_cos": f"{min_cos:.6f}", "max_rel_l2": f"{max_rel:.6f}",
            "selected_differ": int((idx != idx_s).sum()), "selected": int(idx_s.sum()),
            "rollout_max_abs_diff": f"{roll_err:.3e}", "fwd_ms": f"{fwd_ms:.2f}",
            "eval_step_ms": f"{ref_ms:.2f}"}


def _pp_one_card(card: str, gen: torch.Generator, bare_step_ms) -> dict:
    """(a): the flagship (B = 128 as 8 ids x 16, uint8 through the
    augmentation, bf16, drop path 0.1, compact tail) on an NCCL group of one
    rank, mesh (1, stage 1, 1): 3 steps through build_train_step(backbone=
    make_pipeline_backbone(mesh, 4)) against phase 5's single-device step
    and the plain fp32 pipelined run from the same weights, batch and
    generator (loss 3%, norm 2%); launches as :func:`_pp_want`; the eval
    forward (:func:`_pp_eval`); the step's ms and peak memory beside the
    single-device step's."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import make_mesh
    from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone

    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    want = _pp_want(L, PP_M, train=True)
    h, w = ecfg.vit.img_size
    batch = _dp_batch(gen, cfg, h, w)
    sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        if not multihost.initialize(init_method="file://" + os.path.join(tmp, "store"),
                                    world_size=1, rank=0,
                                    local_rank=torch.cuda.current_device()):
            raise AssertionError("no process group was made")
        mesh = make_mesh(1, 1, stage=1)
        bb = make_pipeline_backbone(mesh, PP_M, remat=True)
        model, step, losses, launches = _pp_steps(cfg, ecfg, sd0, batch, mesh, bb)
        if any(lc != want for lc in launches):
            raise AssertionError(f"pipelined step launches {launches} != {want}")
        norm = _param_norm(model)
        epoch = cfg.SOLVER.WARMUP_ITERS + 1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pp_ms = cuda_ms(lambda: step(batch, epoch), iters=5)
        pp_peak = torch.cuda.max_memory_allocated() / 1e9
        del step
        evaluated = _pp_eval(model, ecfg, bb, gen)
        del model
        torch.cuda.empty_cache()
        single, step1, s_losses, _ = _pp_steps(cfg, ecfg, sd0, batch)
        vs_single = _pp_close("pipelined vs single-device", losses, norm, s_losses,
                              _param_norm(single))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_ms = cuda_ms(lambda: step1(batch, epoch), iters=5)
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        del single, step1
        torch.cuda.empty_cache()
        plain_ecfg = dataclasses.replace(ecfg, use_pallas=False)
        plain, _, p_losses, p_launches = _pp_steps(cfg, plain_ecfg, sd0, batch, mesh, bb,
                                                   dtype=torch.float32)
        if any(lc != expected() for lc in p_launches):
            raise AssertionError(f"the plain fp32 run launched kernels: {p_launches}")
        vs_plain = _pp_close("pipelined vs plain fp32 pipelined", losses, norm, p_losses,
                             _param_norm(plain))
        del plain
        torch.cuda.empty_cache()
        hop = _pp_hop_bytes(ecfg, len(batch["pid"]), PP_M)
        say("13a pp one card", stage=1, microbatches=PP_M, remat=True,
            launches=json.dumps(launches[-1]), loss=json.dumps([round(x, 5) for x in losses]),
            single_loss=json.dumps([round(x, 5) for x in s_losses]),
            plain_fp32_loss=json.dumps([round(x, 5) for x in p_losses]),
            vs_single=json.dumps(vs_single), vs_plain=json.dumps(vs_plain))
        say("13a pp eval", **{k: (json.dumps(v) if isinstance(v, dict) else v)
                              for k, v in evaluated.items()})
        say("13a pp timing", pp_step_ms=f"{pp_ms:.2f}", single_step_ms=f"{one_ms:.2f}",
            phase5_bare_step_ms="not run" if bare_step_ms is None else f"{bare_step_ms:.2f}",
            pp_over_single=f"{pp_ms / one_ms:.4f}", pp_peak_gb=f"{pp_peak:.2f}",
            single_peak_gb=f"{one_peak:.2f}",
            hop_mb=json.dumps({k: round(v / 1e6, 2) for k, v in hop.items()}),
            p2p_bytes_per_step=0, card=repr(card))
        return {"train": launches[-1], "eval": evaluated["launches"], "step_ms": pp_ms}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def pp_rank(d: str) -> None:
    """One rank of (b)/(c) under cli.launch: the mesh (1, stage, tp) of the
    saved layout, the model from the saved weights (cut by shard_editor
    under tp), 2 pipelined steps on the saved batch (each step's launches
    and collective calls), the canonical state (rank 0 writes), the step's
    ms and peak memory."""
    from editor_tpu_torch.parallel import collectives as Coll
    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import make_mesh, model_group
    from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone
    from editor_tpu_torch.parallel.tp import gather_editor_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize(timeout_s=240)
    rank = multihost.process_index()
    S, tp = inp["stage"], inp["tp"]
    cfg, ecfg = inp["cfg"], inp["ecfg"]
    mesh = make_mesh(1, tp, stage=S)
    sd = {k: v.cuda() for k, v in inp["sd"].items()}
    batch = {k: v.cuda() for k, v in inp["batch"].items()}
    bb = make_pipeline_backbone(mesh, PP_M)
    model, step, losses, launches = _pp_steps(cfg, ecfg, sd, batch, mesh, bb, augment=False,
                                              steps=1)
    Coll.reset_collective_counts()
    reset_counts()
    losses.append(float(step(batch, 2)["loss"]))
    launches.append(launch_counts())
    out = {"losses": losses, "launches": launches, "collectives": Coll.collective_counts()}
    state = (gather_editor_state(model, model_group(mesh)) if tp > 1
             else model.state_dict())
    if rank == 0:
        out["sd"] = {k: v.detach().cpu() for k, v in state.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["ms"] = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    multihost.shutdown()


def _pp_multi(card: str, gen: torch.Generator) -> dict:
    """(b) and (c) with two cards or more: 2 stages on 2 cards and, with
    four, 4 stages and 2 stages x 2 model ranks, M = 4, phase 10 (e)'s
    inputs (drop path 0, no augmentation, identity-like images), each rank
    a process through cli.launch: losses the same on every rank and within
    1% of one card's, every tensor's change within phase 10 (e)'s
    DP_W_LIMIT, each rank's launches as :func:`_pp_want` for its blocks; the
    step's ms against one card's, the P2P calls and bytes a step."""
    import shutil
    import tempfile

    from editor_tpu_torch.models.init import editor_init

    n = torch.cuda.device_count()
    if n < 2:
        say("13b pp ranks", world_sizes="1", note="one card: (b) needs two cards, (c) four")
        return {}
    cfg, ecfg = flagship()
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.0))
    L = ecfg.vit.depth
    h, w = ecfg.vit.img_size
    sd0 = {k: v.clone() for k, v in editor_init(ecfg, seed=0).state_dict().items()}
    batch = _dp_id_batch(gen, _dp_batch(gen, cfg, h, w))
    ref_losses, ref_d, step = _dp_one_card(cfg, ecfg, sd0, batch)
    one_ms = cuda_ms(lambda: step(batch, cfg.SOLVER.WARMUP_ITERS + 1), iters=3)
    del step
    torch.cuda.empty_cache()
    layouts = [("13b", 2, 1)] + ([("13c", 4, 1), ("13c", 2, 2)] if n >= 4 else [])
    result = {}
    for label, S, tp in layouts:
        world = S * tp
        d = tempfile.mkdtemp(prefix=f"chip_smoke_pp{S}x{tp}_")
        try:
            torch.save({"cfg": cfg, "ecfg": ecfg, "stage": S, "tp": tp,
                        "sd": {k: v.cpu() for k, v in sd0.items()},
                        "batch": {k: v.cpu() for k, v in batch.items()}},
                       os.path.join(d, "inputs.pt"))
            _launch_ranks(world, "--pp-rank", d)
            outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
                    for r in range(world)]
            sd = outs[0]["sd"]
            err = _delta_err({k: sd[k].float() - sd0[k].float().cpu() for k in ref_d}, ref_d)
            dl = max(abs(a - b) / abs(b) for a, b in zip(outs[0]["losses"], ref_losses))
            if not (all(o["losses"] == outs[0]["losses"] for o in outs) and dl <= 0.01
                    and max(err.values()) <= DP_W_LIMIT):
                raise AssertionError(f"pp {S}x{tp}: losses {[o['losses'] for o in outs]} vs "
                                     f"{ref_losses}; worst {_worst(err)}")
            want = _pp_want(L // S, PP_M, train=True)
            for r, o in enumerate(outs):
                if any(lc != want for lc in o["launches"]):
                    raise AssertionError(f"pp {S}x{tp} rank {r}: launches {o['launches']} != "
                                         f"{want}")
            hop = _pp_hop_bytes(ecfg, len(batch["pid"]), PP_M, tp)
            fwd = hop["tokens"] + hop["prod"] + hop["draws"]
            p2p = (S - 1) * PP_M * (fwd + hop["grad"])  # every hop of a stage group
            result[f"{S}x{tp}"] = {"train": outs[0]["launches"][-1], "ms": outs[0]["ms"]}
            say(f"{label} pp ranks", stage=S, tp=tp, microbatches=PP_M,
                losses=json.dumps(outs[0]["losses"]), ref_losses=json.dumps(ref_losses),
                max_rel_dloss=f"{dl:.2e}", max_err=f"{max(err.values()):.3e}",
                worst=_worst(err), limit=DP_W_LIMIT, launches_per_step=json.dumps(want),
                collectives_rank0=json.dumps(outs[0]["collectives"]),
                collectives_last=json.dumps(outs[-1]["collectives"]),
                hop_mb=json.dumps({k: round(v / 1e6, 2) for k, v in hop.items()}),
                p2p_mb_per_step_per_stage_group=f"{p2p / 1e6:.1f}",
                pp_step_ms=f"{outs[0]['ms']:.2f}", one_card_step_ms=f"{one_ms:.2f}",
                peak_gb=json.dumps([round(o["peak_gb"], 2) for o in outs]), card=repr(card))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return result


def pp_phase(card: str, gen: torch.Generator, bare_step_ms=None, cases: str = "abcd") -> dict:
    """Phase 13: pipeline parallelism. (a) one card; (b) 2 stages and (c) 4
    stages and 2 x 2 (pp x tp), with two and four cards, and (d) dp 2 x pp
    2 with ZeRO-1 and FSDP with four (fewer: they say so). ``cases``: the
    letters of the cases to run (``--phase-13 d``; (b) and (c) are one)."""
    one = _pp_one_card(card, gen, bare_step_ms) if "a" in cases else {}
    torch.cuda.empty_cache()
    multi = _pp_multi(card, gen) if "b" in cases or "c" in cases else {}
    torch.cuda.empty_cache()
    zero = _pp_zero_multi(card, gen) if "d" in cases else {}
    return {**one, "multi": {**multi, **zero}}


# Phase 14: the model configurations the port runs beyond the flagship's:
# overlapping patches (MODEL.STRIDE_SIZE 12: a 21 x 10 grid, N = 211 tokens a
# modality, the tail still compacted to 88 / 264), the remat policies,
# dropout and attention dropout, and the general frequency branch (image
# sides 2^J does not divide). Remat and dropout run at the flagship's stride
STRIDE12 = ["MODEL.STRIDE_SIZE", "[12, 12]"]
N_STRIDE12 = 211
REMAT_TOL = 1e-3  # the remat steps' relative difference from the no-remat step
# (e): the card's frequency mask against the CPU's on the same fp32 images
FREQ_HW = (264, 136)
FREQ_COUNT_SHARE, FREQ_COUNT_DIFF, FREQ_ROW_SHARE = 1e-3, 2, 0.01


def _stride12_kernels(gen: torch.Generator) -> dict:
    """K1 (with probs), K4 and K2 at the stride-12 backbone's N = 211, past
    K1's 144-key resident instance and K4's on-chip attention, against their
    plain versions with phase 2's checks (K1: out within 2e-2, every probs
    element within one bf16 ulp; K4: scaled 1e-2, the shares and their wrong
    forms; K2: 1e-5), with times, library times and bounds."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    Bk, N = 3 * B_EVAL, N_STRIDE12
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    res = {}
    qkv = randn(Bk, N, 3 * C)
    probs = torch.empty(Bk, H, N, N, dtype=torch.bfloat16, device="cuda")
    out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    torch.cuda.synchronize()
    k1 = _k1_errors(f"attention_qkv N={N}", out, probs,
                    ops.attention_qkv_tpu_plain(qkv, H, SCALE, True))
    b = bound(4.0 * Bk * H * N * N * D, 2.0 * (Bk * N * 3 * C + Bk * N * C + Bk * H * N * N))
    res["attention_qkv"] = dict(
        shape=list(qkv.shape), max_abs_err=max(k1["out_err"], k1["probs_err"]),
        ms=cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=probs)),
        plain_ms=cuda_ms(lambda: ops.attention_qkv_tpu_plain(qkv, H, SCALE, True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), scale=SCALE)),
        probs_ulps=k1["probs_ulps"], **b)
    del probs, out
    g = randn(Bk, N, C)
    dq = ops.attention_qkv_bwd(qkv, g, H, SCALE)
    ref_dq = ops.attention_qkv_bwd_plain(qkv, g, H, SCALE)
    torch.cuda.synchronize()
    e4 = _scaled(dq, ref_dq)
    _require(f"attention_qkv_bwd N={N} (scaled)", e4, 1e-2)
    shares = _bwd_shares(f"attention_qkv_bwd N={N}", dq, ref_dq, N, C)
    caught = _wrong_forms(
        f"attention_qkv_bwd N={N}",
        ops.attention_qkv_bwd_plain(qkv.float(), g.float(), H, SCALE).to(torch.bfloat16),
        ops.masked_attention_qkv_bwd_plain(qkv, torch.ones(Bk, N, device="cuda"), g, H, SCALE),
        ref_dq, N, C)
    del dq, ref_dq
    b = bound(10.0 * Bk * H * N * N * D, 2.0 * Bk * N * (3 * C + C + 3 * C))
    res["attention_qkv_bwd"] = dict(
        shape=list(qkv.shape), max_abs_err=e4, **shares, wrong_forms=caught,
        ms=cuda_ms(lambda: ops.attention_qkv_bwd(qkv, g, H, SCALE)),
        plain_ms=cuda_ms(lambda: ops.attention_qkv_bwd_plain(qkv, g, H, SCALE)),
        library_ms=_sdpa_bwd_ms(qkv, g), **b)
    del qkv, g
    L = 12
    maps = torch.empty(L, Bk, H, N, N, dtype=torch.bfloat16, device="cuda")
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bk, H, N, N, generator=gen, device="cuda"),
                                dim=-1).to(torch.bfloat16)
    roll = ops.rollout_chain(maps)
    e2 = _max_err(roll, ops.rollout_from_probs_plain(maps))
    _require(f"rollout_chain N={N}", e2, 1e-5)
    b = bound(2.0 * (L - 1) * Bk * H * N * N, 2.0 * L * Bk * H * N * N + 4.0 * Bk * H * (N - 1))
    res["rollout_chain"] = dict(
        L=L, Z=Bk * H, N=N, max_abs_err=e2, ms=cuda_ms(lambda: ops.rollout_chain(maps)),
        plain_ms=cuda_ms(lambda: ops.rollout_from_probs_plain(maps)), library_ms=None, **b)
    del maps, roll
    for name, r in res.items():
        say(f"14a kernel {name} N={N}", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                           for k, v in r.items() if k not in ("flops",
                                                                              "bytes")})
    torch.cuda.empty_cache()
    return res


def _p14_batch(cfg, ecfg, gen: torch.Generator) -> dict:
    """Phase 5's batch: uint8 images, 8 ids x 16 at B = 128."""
    B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
    h, w = ecfg.vit.img_size
    batch = {m: torch.randint(0, 256, (B, h, w, 3), generator=gen, device="cuda",
                              dtype=torch.uint8) for m in ("RGB", "NI", "TI")}
    batch["pid"] = torch.arange(B, device="cuda") // K
    batch["camid"] = torch.arange(B, device="cuda") % 6
    return batch


def _p14_step(cfg, ecfg):
    """(model, step): seeded weights (editor_init seed 0) and phase 5's bf16
    step (SGD, the augmentation, generator seed 1)."""
    from editor_tpu_torch.data.transforms import make_train_augment
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    model = editor_init(ecfg, seed=0)
    step = build_train_step(model, make_optimizer(cfg, model), make_loss(cfg, ecfg.num_classes),
                            make_scheduler(cfg), cfg.SOLVER.BASE_LR, torch.bfloat16,
                            augment=make_train_augment(cfg.INPUT), seed=1)
    return model, step


def _one_step(label: str, opts, batch: dict, want: dict, gen=None, iters: int = 3) -> dict:
    """One step of the flagship with ``opts`` from seeded weights: its launch
    counts (required ``want``), loss, each parameter's change, then its ms
    (CUDA events over ``iters`` steps after one warm-up), img/s and peak
    memory."""
    cfg, ecfg = flagship(opts)
    model, step = _p14_step(cfg, ecfg)
    start = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    reset_counts()
    loss = float(step(batch, 1)["loss"])
    launches = launch_counts()
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} != {want} in one step")
    if not (np.isfinite(loss) and _grads_finite(model)):
        raise AssertionError(f"{label}: non-finite loss {loss} or gradients")
    delta = [p.detach() - p0 for p, p0 in zip(model.parameters(), start)]
    del start
    epoch = cfg.SOLVER.WARMUP_ITERS + 1
    step(batch, epoch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch, epoch), iters=iters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    B = batch["pid"].shape[0]
    del model, step
    torch.cuda.empty_cache()
    return dict(launches=launches, loss=loss, delta=delta, ms=ms, img_s=B / ms * 1e3,
                peak_gb=peak)


def _step_diff(got: dict, ref: dict) -> dict:
    """A step against a reference step from the same weights, batch and
    draws: the loss's relative difference, the largest relative difference
    of a parameter tensor's change (floored at 1e-3 of the largest change's
    norm) and whether every change is bit for bit the reference's."""
    norms = [float(d.float().norm()) for d in ref["delta"]]
    floor = 1e-3 * max(norms)
    rel = max(float((a.float() - b.float()).norm()) / max(n, floor)
              for a, b, n in zip(got["delta"], ref["delta"], norms))
    return dict(rel_dloss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), rel_dparam=rel,
                bit_for_bit=got["loss"] == ref["loss"]
                and all(torch.equal(a, b) for a, b in zip(got["delta"], ref["delta"])))


def _p14_stride12(gen: torch.Generator, cases: str) -> dict:
    """(a) the stride-12 eval forward: K1 12, K2 1, K3 2, phase 3's gates
    against the plain fp32 run, the frequency mask equal to the CPU's bit
    for bit, ms, img/s, peak memory; (b) its train step at B = 128: K1 12,
    K2 1, K3 2, K4 12, K5 2, ms, img/s, peak memory; and phase 5's
    comparison with the plain fp32 run at B = 64 with TPU.REMAT (block): the
    plain fp32 step at B = 128 and N = 211 would hold ~80 GB of activations
    (PERF.md), more than the card."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import _tail_keep_count
    from editor_tpu_torch.models.frequency import frequency_token_select

    out = {}
    cfg, ecfg = flagship(STRIDE12)
    L = ecfg.vit.depth
    if not (ecfg.vit.stride_size == (12, 12) and ecfg.num_patches == N_STRIDE12 - 1
            and _tail_keep_count(ecfg, 3) == 87):
        raise AssertionError(f"stride 12: {ecfg.vit.stride_size}, {ecfg.num_patches} patches, "
                             f"tail {_tail_keep_count(ecfg, 3)}")
    if "a" in cases:
        out["kernels"] = _stride12_kernels(gen)
        model, ref_model, batch, ref, launches = eval_check(
            ecfg, gen, "14a stride-12 forward",
            expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2))
        del ref_model, ref
        mods = [batch[m].to(torch.bfloat16) for m in ("RGB", "NI", "TI")]
        kw = dict(keep=ecfg.frequency_keep, stride=12, window=ecfg.vit.patch_size)
        mask = frequency_token_select(mods, **kw)
        cpu_mask = frequency_token_select([m.cpu() for m in mods], **kw)
        if not torch.equal(mask.cpu(), cpu_mask):
            raise AssertionError("stride-12 frequency mask: card != CPU in "
                                 f"{int((mask.cpu() != cpu_mask).sum())} tokens")
        del mods
        torch.cuda.empty_cache()
        step = build_eval_step(model, torch.bfloat16)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(batch), iters=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        out["eval"] = dict(launches=launches, ms=ms, img_s=B_EVAL / ms * 1e3, peak_gb=peak)
        say("14a stride-12 forward timing", B=B_EVAL, N=N_STRIDE12, mask_equal_cpu=True,
            ms=f"{ms:.3f}", img_s=f"{B_EVAL / ms * 1e3:.1f}", peak_gb=f"{peak:.3f}")
        del model, step, batch
        torch.cuda.empty_cache()
    if "b" in cases:
        want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                        attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
        run = _one_step("14b stride-12 train", STRIDE12, _p14_batch(cfg, ecfg, gen), want,
                        iters=5)
        out["train"] = {k: v for k, v in run.items() if k != "delta"}
        say("14b stride-12 train timing", B=cfg.SOLVER.IMS_PER_BATCH, N=N_STRIDE12,
            launches=json.dumps(run["launches"]), loss=f"{run['loss']:.5f}",
            ms=f"{run['ms']:.3f}", img_s=f"{run['img_s']:.1f}", peak_gb=f"{run['peak_gb']:.3f}")
        del run
        torch.cuda.empty_cache()
        cfg64, ecfg64 = flagship(STRIDE12 + ["SOLVER.IMS_PER_BATCH", "64", "TPU.REMAT", "True"])
        train_check(cfg64, ecfg64, gen, "14b stride-12 train vs plain fp32 (B=64, remat block)",
                    expected(attention_qkv=2 * L, rollout_chain=1, masked_attention_qkv=2,
                             attention_qkv_bwd=L, masked_attention_qkv_bwd=2), learn=False)
        torch.cuda.empty_cache()
    return out


def _p14_remat(gen: torch.Generator) -> dict:
    """(c) phase 5's step with TPU.REMAT under each policy (and block with
    REMAT_SKIP_LAST 4) against the same step without remat from the same
    weights, batch and draws: the loss and every parameter's change within
    REMAT_TOL relative (bit for bit printed); the no-remat step run twice
    shows the card's own run-to-run spread; K1's launches (recomputed under
    block and dots, skipped on the last 4 blocks with REMAT_SKIP_LAST 4), ms
    and peak memory of each."""
    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    batch = _p14_batch(cfg, ecfg, gen)
    base_want = dict(rollout_chain=1, masked_attention_qkv=2, attention_qkv_bwd=L,
                     masked_attention_qkv_bwd=2)
    ref = _one_step("14c no remat", [], batch, expected(attention_qkv=L, **base_want))
    again = _one_step("14c no remat, again", [], batch, expected(attention_qkv=L, **base_want))
    noise = _step_diff(again, ref)
    del again
    say("14c no remat", ms=f"{ref['ms']:.3f}", peak_gb=f"{ref['peak_gb']:.3f}",
        run_to_run=json.dumps(noise))
    out = {"none": dict(launches=ref["launches"], ms=ref["ms"], peak_gb=ref["peak_gb"],
                        run_to_run=noise)}
    for name, policy, skip, k1 in (("block", "block", 0, 2 * L), ("dots", "dots", 0, 2 * L),
                                   ("names", "names", 0, L), ("attn_out", "attn_out", 0, L),
                                   ("block_skip4", "block", 4, 2 * L - 4)):
        opts = ["TPU.REMAT", "True", "TPU.REMAT_POLICY", policy, "TPU.REMAT_SKIP_LAST", str(skip)]
        run = _one_step(f"14c remat {name}", opts, batch, expected(attention_qkv=k1, **base_want))
        diff = _step_diff(run, ref)
        if not (diff["rel_dloss"] <= REMAT_TOL and diff["rel_dparam"] <= REMAT_TOL):
            raise AssertionError(f"remat {name} vs no remat: {diff} (limit {REMAT_TOL})")
        out[name] = dict(launches=run["launches"], ms=run["ms"], peak_gb=run["peak_gb"], **diff)
        say(f"14c remat {name}", k1_launches=k1, ms=f"{run['ms']:.3f}",
            peak_gb=f"{run['peak_gb']:.3f}", limit=REMAT_TOL, **diff)
        del run
        torch.cuda.empty_cache()
    return out


def _p14_dropout(gen: torch.Generator) -> dict:
    """(d) MODEL.ATT_DROP_RATE 0.1, MODEL.DROP_OUT 0.1 and TPU.REMAT (block):
    the train step takes the plain attention (K1 and K4 0 launches, K2 1, K3
    2, K5 2) and equals the same step without remat from the same generator
    seed within REMAT_TOL (bit for bit printed); the eval forward launches K1
    12, K2 1, K3 2; in a training forward the share of dropped attention
    weights is within 4 sigma of 0.1; the step's ms."""
    from editor_tpu_torch.data.transforms import make_eval_transform
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models import vit as port_vit

    drop = ["MODEL.ATT_DROP_RATE", "0.1", "MODEL.DROP_OUT", "0.1"]
    cfg, ecfg = flagship(drop + ["TPU.REMAT", "True"])
    if not (ecfg.vit.attn_drop_rate == 0.1 and ecfg.vit.drop_rate == 0.1 and ecfg.vit.remat):
        raise AssertionError(f"dropout options did not reach the model: {ecfg.vit}")
    L, rate = ecfg.vit.depth, ecfg.vit.attn_drop_rate
    batch = _p14_batch(cfg, ecfg, gen)
    want = expected(rollout_chain=1, masked_attention_qkv=2, masked_attention_qkv_bwd=2)
    run = _one_step("14d dropout, remat", drop + ["TPU.REMAT", "True"], batch, want)
    ref = _one_step("14d dropout, no remat", drop, batch, want)
    diff = _step_diff(run, ref)
    if not (diff["rel_dloss"] <= REMAT_TOL and diff["rel_dparam"] <= REMAT_TOL):
        raise AssertionError(f"dropout: remat vs no remat {diff} (limit {REMAT_TOL})")

    model, _ = _p14_step(cfg, ecfg)
    zeros, total = [], []
    inner = port_vit._attention_dropped

    def probe(*args):
        out, probs = inner(*args)
        zeros.append((probs == 0).sum())
        total.append(probs.numel())
        return out, probs

    norm = make_eval_transform(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    images = {m: norm(batch[m]).to(torch.bfloat16) for m in ("RGB", "NI", "TI")}
    port_vit._attention_dropped = probe
    try:
        with torch.no_grad():  # the forward alone: each layer's weights once
            model(images, batch["camid"], training=True, labels=batch["pid"],
                  generator=torch.Generator(device="cuda").manual_seed(2))
    finally:
        port_vit._attention_dropped = inner
    n = sum(total)
    share = float(torch.stack(zeros).sum()) / n
    sigma = (rate * (1 - rate) / n) ** 0.5
    if len(total) != L or not abs(share - rate) <= 4 * sigma:
        raise AssertionError(f"attention dropout: {len(total)} layers, dropped share {share} "
                             f"vs {rate} (4 sigma {4 * sigma})")
    eval_batch = _eval_batch(gen, B_EVAL)
    step = build_eval_step(model, torch.bfloat16)
    reset_counts()
    step(eval_batch)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    eval_want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    if eval_launches != eval_want:
        raise AssertionError(f"dropout model eval: launches {eval_launches} != {eval_want}")
    del model, step, eval_batch
    torch.cuda.empty_cache()
    say("14d dropout", launches=json.dumps(run["launches"]), dropped_share=f"{share:.6f}",
        four_sigma=f"{4 * sigma:.2e}", eval_launches=json.dumps(eval_launches),
        ms=f"{run['ms']:.3f}", ms_no_remat=f"{ref['ms']:.3f}", peak_gb=f"{run['peak_gb']:.3f}",
        limit=REMAT_TOL, **diff)
    return dict(train=run["launches"], eval=eval_launches, ms=run["ms"], ms_no_remat=ref["ms"],
                dropped_share=share, **diff)


def _p14_frequency(gen: torch.Generator) -> dict:
    """(e) frequency_token_select's general branch (Haar, J = 4, zero mode)
    at 264 x 136, sides 16 does not divide, B = 128, on the card against the
    CPU on the same fp32 images, with cuDNN's TF32 switched on around the
    card's call (the wavelet module must turn it off itself): the window
    counts equal on all but FREQ_COUNT_SHARE of the windows and none off by
    more than FREQ_COUNT_DIFF, the masks equal on all but FREQ_ROW_SHARE of
    the rows; a db4 / symmetric wavedec2 -> waverec2 round trip within 1e-5;
    the mask's ms."""
    from editor_tpu_torch.models import frequency as fq
    from editor_tpu_torch.ops import wavelets

    mods = [torch.randn(B_EVAL, *FREQ_HW, 3, generator=gen, device="cuda") for _ in range(3)]
    counts = []
    inner = fq.window_positive_counts

    def record(*args):
        counts.append(inner(*args))
        return counts[-1]

    kw = dict(keep=10, stride=16, window=16)
    fq.window_positive_counts = record
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        mask = fq.frequency_token_select(mods, **kw)
        tf32_after = torch.backends.cudnn.allow_tf32
        cpu_mask = fq.frequency_token_select([m.cpu() for m in mods], **kw)
    finally:
        fq.window_positive_counts = inner
        torch.backends.cudnn.allow_tf32 = tf32
    if not tf32_after:
        raise AssertionError("the wavelet module left cuDNN's TF32 switched off")
    card, cpu = counts[0].cpu(), counts[1]
    grid = ((FREQ_HW[0] - 16) // 16 + 1, (FREQ_HW[1] - 16) // 16 + 1)
    if card.shape != cpu.shape or card.shape != (B_EVAL, *grid):
        raise AssertionError(f"frequency counts {tuple(card.shape)}, {tuple(cpu.shape)}")
    off = (card != cpu)
    count_share, count_diff = float(off.float().mean()), int((card - cpu).abs().max())
    row_share = float((mask.cpu() != cpu_mask).any(dim=1).float().mean())
    if not (count_share <= FREQ_COUNT_SHARE and count_diff <= FREQ_COUNT_DIFF
            and row_share <= FREQ_ROW_SHARE):
        raise AssertionError(f"frequency mask card vs CPU: counts off in {count_share} "
                             f"(max {count_diff}), masks in {row_share} of rows")
    x = torch.randn(8, *FREQ_HW, 3, generator=gen, device="cuda")
    low, highs = wavelets.wavedec2(x, "db4", J=4, mode="symmetric")
    rt = _max_err(wavelets.waverec2(low, highs, "db4", mode="symmetric"), x)
    _require("db4 symmetric wavedec2 -> waverec2", rt, 1e-5)
    ms = cuda_ms(lambda: fq.frequency_token_select(mods, **kw), iters=5)
    say("14e frequency general branch", B=B_EVAL, hw=list(FREQ_HW), grid=list(grid),
        counts_off_share=count_share, counts_max_diff=count_diff, mask_rows_off=row_share,
        limits=f"{FREQ_COUNT_SHARE}/{FREQ_COUNT_DIFF}/{FREQ_ROW_SHARE}",
        roundtrip_err=rt, ms=f"{ms:.3f}")
    return dict(count_share=count_share, count_diff=count_diff, row_share=row_share,
                roundtrip_err=rt, ms=ms)


def config_phase(gen: torch.Generator, cases: str = "abcde") -> dict:
    """Phase 14: the model configurations beyond the flagship's. ``cases``:
    the letters of the cases to run (``--phase-14 ce``)."""
    out = _p14_stride12(gen, cases)
    torch.cuda.empty_cache()
    if "c" in cases:
        out["remat"] = _p14_remat(gen)
        torch.cuda.empty_cache()
    if "d" in cases:
        out["dropout"] = _p14_dropout(gen)
        torch.cuda.empty_cache()
    if "e" in cases:
        out["frequency"] = _p14_frequency(gen)
    return out


LIB_DTCWT_TOL = 1e-5  # (a) round trip and card vs CPU, relative to the largest magnitude
LIB_GRAD_TOL = 1e-4  # (a) the scattering layers' gradients, card vs CPU
LIB_LOSS_TOL = 1e-4  # (b) each loss and gradient on the card against f64 on the CPU
LIB_COST_TOL = 0.01  # (c) cost_analysis with the kernels against the plain path
LIB_RPC_TOL = 1e-5  # (e) the owner's product on the card against the local one
LIB_CPU_ROWS = 8  # (a) the images the CPU reference transforms (the op is per image)
LIB_SHARD_ROWS = 8192  # (d) rows a rank of the sharded tensors


def _rel_err(got, ref) -> float:
    """max |got - ref| over the reference's largest magnitude."""
    ref = ref.detach().double().cpu()
    return float((got.detach().double().cpu() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def _p15_dtcwt(gen: torch.Generator) -> dict:
    """(a) dtcwt2 at J = 3 in both modes and idtcwt2 on [384, 256, 128, 3]
    fp32 (B = 128 x three modalities): the round trip within
    LIB_DTCWT_TOL of the input's scale, every output on the card against
    the CPU's on the first LIB_CPU_ROWS images (the transform is per image)
    with cuDNN's TF32 switched on around the card's call (the module turns
    it off itself); scat_layer [384,128,64,21] and scat_layer_j2
    [384,64,32,147] and one backward of each likewise (gradients within
    LIB_GRAD_TOL); ms from CUDA events and the peak memory."""
    from editor_tpu_torch.ops import dtcwt

    x = torch.randn(3 * B_EVAL, 256, 128, 3, generator=gen, device="cuda")
    x_cpu = x[:LIB_CPU_ROWS].cpu()
    tf32 = torch.backends.cudnn.allow_tf32
    out = {}

    def on_card(fn, *args):
        torch.backends.cudnn.allow_tf32 = True
        try:
            res = fn(*args)
            if not torch.backends.cudnn.allow_tf32:
                raise AssertionError("the wavelet module left cuDNN's TF32 switched off")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return res

    for mode in ("zero", "symmetric"):
        torch.cuda.reset_peak_memory_stats()
        lows, highs = on_card(dtcwt.dtcwt2, x, 3, mode)
        y = on_card(dtcwt.idtcwt2, lows, highs, mode)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rt = _rel_err(y, x)
        _require(f"dtcwt2/idtcwt2 {mode} round trip (relative)", rt, LIB_DTCWT_TOL)
        ref_lows, ref_highs = dtcwt.dtcwt2(x_cpu, 3, mode)
        vs_cpu = max(_rel_err(a[:LIB_CPU_ROWS], b) for a, b in
                     zip(lows + highs + [y], ref_lows + ref_highs
                         + [dtcwt.idtcwt2(ref_lows, ref_highs, mode)]))
        _require(f"dtcwt2/idtcwt2 {mode} card vs CPU (relative)", vs_cpu, LIB_DTCWT_TOL)
        fwd_ms = cuda_ms(lambda: dtcwt.dtcwt2(x, 3, mode), iters=5)
        inv_ms = cuda_ms(lambda: dtcwt.idtcwt2(lows, highs, mode), iters=5)
        say(f"15a dtcwt2 J=3 {mode}", x=list(x.shape),
            highs=[list(h.shape) for h in highs], roundtrip_rel=rt, card_vs_cpu_rel=vs_cpu,
            fwd_ms=f"{fwd_ms:.3f}", inv_ms=f"{inv_ms:.3f}", peak_gb=f"{peak:.3f}")
        out[mode] = dict(roundtrip=rt, vs_cpu=vs_cpu, fwd_ms=fwd_ms, inv_ms=inv_ms,
                         peak_gb=peak)
        del lows, highs, y
    for name, shape in (("scat_layer", [3 * B_EVAL, 128, 64, 21]),
                        ("scat_layer_j2", [3 * B_EVAL, 64, 32, 147])):
        fn = getattr(dtcwt, name)
        xg = x.clone().requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        s = on_card(fn, xg)
        if list(s.shape) != shape or not torch.isfinite(s).all():
            raise AssertionError(f"{name}: {tuple(s.shape)} != {shape} or non-finite")
        g = torch.randn(s.shape, generator=gen, device="cuda")
        torch.backends.cudnn.allow_tf32 = True
        try:
            s.backward(g)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not torch.isfinite(xg.grad).all():
            raise AssertionError(f"{name}: non-finite gradient")
        xc = x_cpu.clone().requires_grad_(True)
        sc = fn(xc)
        sc.backward(g[:LIB_CPU_ROWS].cpu())
        err = _rel_err(s[:LIB_CPU_ROWS], sc)
        grad_err = _rel_err(xg.grad[:LIB_CPU_ROWS], xc.grad)
        _require(f"{name} card vs CPU (relative)", err, LIB_DTCWT_TOL)
        _require(f"{name} gradient card vs CPU (relative)", grad_err, LIB_GRAD_TOL)
        fwd_ms = cuda_ms(lambda: fn(x), iters=5)
        both_ms = cuda_ms(lambda: torch.autograd.grad(fn(xg), xg, g), iters=3)
        say(f"15a {name}", out=list(s.shape), card_vs_cpu_rel=err, grad_rel=grad_err,
            fwd_ms=f"{fwd_ms:.3f}", fwd_bwd_ms=f"{both_ms:.3f}", peak_gb=f"{peak:.3f}")
        out[name] = dict(err=err, grad_err=grad_err, fwd_ms=fwd_ms, fwd_bwd_ms=both_ms,
                         peak_gb=peak)
        del xg, s, g, sc, xc
    return out


def _p15_losses(ecfg, gen: torch.Generator) -> dict:
    """(b) one flagship train forward at B = 128 (16 ids x 8, bf16; K1 12,
    K2 1, K3 2 launches), every auxiliary loss on its [128, 2304] feature,
    its three [128, 768] per-modality features and its logits, each loss
    and its gradients on the card within LIB_LOSS_TOL (relative) of the
    same inputs at f64 on the CPU, its ms; one backward of the summed
    losses through the model (K4 12, K5 2 launches), the gradients finite
    by utils.debug.assert_tree_finite."""
    from editor_tpu_torch.losses import center, extra, softmax, triplet
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils.debug import assert_tree_finite, nonfinite_leaves

    P, K = 16, 8
    L = ecfg.vit.depth
    model = editor_init(ecfg, seed=0)
    batch = _eval_batch(gen, P * K)
    pid = torch.arange(P * K, device="cuda") // K
    images = {m: batch[m].to(torch.bfloat16) for m in ("RGB", "NI", "TI")}
    fgen = torch.Generator(device="cuda").manual_seed(3)
    reset_counts()
    out = model(images, cam_ids=batch["camid"], training=True, labels=pid, generator=fgen)
    torch.cuda.synchronize()
    fwd = launch_counts()
    want = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    if fwd != want:
        raise AssertionError(f"train forward launches {fwd} != {want}")
    live = {"feat": out.cls4t, "logits": out.score,
            **{f"mod{i}": f for i, (_, f) in enumerate(out.pairs[1:4])}}
    centers = center.center_loss_init(torch.Generator(device="cuda").manual_seed(4),
                                      ecfg.num_classes, 3 * C)["centers"]
    # each loss of (feature tensors t, labels y, centers c)
    losses = {
        "center": lambda t, y, c: center.center_loss({"centers": c}, t["feat"], y),
        "cluster": lambda t, y, c: extra.cluster_loss(t["feat"], y, P, K)[0],
        "range": lambda t, y, c: extra.range_loss(t["feat"], y, P, K)[0],
        "hetero_center": lambda t, y, c: extra.hetero_center_loss(t["mod0"], t["mod1"], P, K),
        "multi_modal_margin": lambda t, y, c: extra.multi_modal_margin_loss(
            t["mod0"], t["mod1"], t["mod2"], y, P, K),
        "weighted_regularized_triplet": lambda t, y, c: triplet.weighted_regularized_triplet(
            t["feat"], y, normalize_feature=True),
        "label_smoothing_ce": lambda t, y, c: softmax.label_smoothing_ce(t["logits"], y),
    }
    errs, ms = {}, {}
    for name, fn in losses.items():
        card = {k: v.detach().float().requires_grad_(True) for k, v in live.items()}
        cpu = {k: v.detach().double().cpu().requires_grad_(True) for k, v in live.items()}
        vc = fn(card, pid, centers)
        vr = fn(cpu, pid.cpu(), centers.double().cpu())
        vc.backward()
        vr.backward()
        v_card, v_cpu = float(vc.detach()), float(vr.detach())
        err = abs(v_card - v_cpu) / max(abs(v_cpu), 1e-30)
        for k in card:
            if cpu[k].grad is not None:
                err = max(err, _rel_err(card[k].grad, cpu[k].grad))
            elif card[k].grad is not None:
                raise AssertionError(f"{name}: a gradient on the card only ({k})")
        _require(f"loss {name} card vs f64 CPU (relative)", err, LIB_LOSS_TOL)
        leaves = list(card.values())
        ms[name] = cuda_ms(lambda: torch.autograd.grad(fn(card, pid, centers), leaves,
                                                       allow_unused=True), iters=5)
        errs[name] = dict(value=v_card, rel_err=err)
    total = sum(fn({k: v.float() for k, v in live.items()}, pid, centers)
                for fn in losses.values())
    reset_counts()
    total.backward()
    torch.cuda.synchronize()
    bwd = launch_counts()
    want_bwd = expected(attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    if bwd != want_bwd:
        raise AssertionError(f"backward of the summed losses: launches {bwd} != {want_bwd}")
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert_tree_finite(grads, "gradients of the summed auxiliary losses")
    say("15b losses", B=P * K, P=P, K=K, forward_launches=json.dumps(fwd),
        backward_launches=json.dumps(bwd), grads=len(grads),
        nonfinite=len(nonfinite_leaves(grads)),
        values=json.dumps({k: round(v["value"], 6) for k, v in errs.items()}),
        errs=json.dumps({k: f"{v['rel_err']:.2e}" for k, v in errs.items()}),
        ms=json.dumps({k: round(v, 4) for k, v in ms.items()}), tol=LIB_LOSS_TOL)
    del model, out, live, total, grads
    return dict(forward=fwd, backward=bwd, errs=errs, ms=ms)


def _bench_tflop_per_image(ecfg) -> float:
    """``bench.py::model_tflop_per_image`` (bench.py:72-118; that script
    imports the JAX package): the analytic 2 m n k count of one tri-modal
    eval forward per image (the one-hot tail gather counted as a product and
    L rollout products, as there)."""
    from editor_tpu_torch.models.editor import _tail_keep_count

    v, M = ecfg.vit, 3
    Cv, Hm, P = v.embed_dim, int(v.embed_dim * v.mlp_ratio), v.num_patches
    N = P + 1
    fl = M * 2.0 * P * (v.patch_size * v.patch_size * v.in_chans) * Cv
    fl += M * v.depth * (2.0 * N * Cv * 3 * Cv + 4.0 * N * N * Cv + 2.0 * N * Cv * Cv
                         + 4.0 * N * Cv * Hm)
    fl += M * v.depth * 2.0 * v.num_heads * N * N
    keep = _tail_keep_count(ecfg, M) if ecfg.compact_tail else P
    fl += M * 2.0 * keep * P * Cv
    t = keep + 1

    def block(tokens):
        return (2.0 * tokens * Cv * 3 * Cv + 4.0 * tokens * tokens * Cv
                + 2.0 * tokens * Cv * Cv + 2.0 * tokens * Cv * 4 * Cv * 2)

    fl += M * block(t) + block(M * t) + M * 2.0 * 2 * Cv * Cv
    return fl / 1e12


def _p15_profiling(ecfg, gen: torch.Generator) -> dict:
    """(c) utils.profiling on the card: ``trace`` of one flagship eval
    forward (B = 128, bf16) writes a Chrome trace that names K1's CUDA
    kernel; ``cost_analysis`` of that forward with the kernels equals the
    plain path's (``use_pallas=False``, fp32) within LIB_COST_TOL, printed
    beside bench.py's analytic count; the eval forward's launches under the
    count; ``benchmark``'s p50."""
    import shutil
    import tempfile

    import re

    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.tools import profile_forward
    from editor_tpu_torch.utils import profiling

    model = editor_init(ecfg, seed=0)
    plain = Editor(dataclasses.replace(ecfg, use_pallas=False))
    plain.load_state_dict(model.state_dict(), strict=True)
    batch = _eval_batch(gen, B_EVAL)
    step, plain_step = build_eval_step(model, torch.bfloat16), build_eval_step(plain,
                                                                               torch.float32)
    step(batch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiling.trace(tmp):
            with profiling.annotate("chip_smoke eval forward"):
                step(batch)
        path = os.path.join(tmp, "trace.json")
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k1 = dict(profile_forward.CATEGORIES)["K1 attention_qkv"]
    k1_names = sorted(n for n in names if re.search(k1, n.lower()))
    if not k1_names or "chip_smoke eval forward" not in names:
        raise AssertionError("the trace names no K1 kernel (attention_fwd_mma_kernel, "
                             "form 0) or not the annotated range")
    reset_counts()
    flops = profiling.cost_analysis(step, batch)["flops"]
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    want = expected(attention_qkv=ecfg.vit.depth, rollout_chain=1, masked_attention_qkv=2)
    if eval_launches != want:
        raise AssertionError(f"eval forward under cost_analysis: {eval_launches} != {want}")
    plain_flops = profiling.cost_analysis(plain_step, batch)["flops"]
    rel = abs(flops - plain_flops) / plain_flops
    _require("cost_analysis kernels vs plain (relative)", rel, LIB_COST_TOL)
    analytic = _bench_tflop_per_image(ecfg) * B_EVAL * 1e12
    timing = profiling.benchmark(step, batch, iters=10)
    say("15c profiling", trace_k1=repr(k1_names[0][:60]), trace_mb=f"{trace_mb:.2f}",
        flops=f"{flops:.6e}", plain_flops=f"{plain_flops:.6e}", rel=rel,
        bench_model_tflop=f"{analytic:.6e}", ratio_to_bench=f"{flops / analytic:.4f}",
        p50_ms=f"{timing['p50_s'] * 1e3:.3f}", min_ms=f"{timing['min_s'] * 1e3:.3f}",
        tflops=f"{flops / timing['p50_s'] / 1e12:.1f}", launches=json.dumps(eval_launches))
    del model, plain
    return dict(flops=flops, plain_flops=plain_flops, rel=rel, analytic=analytic,
                p50_ms=timing["p50_s"] * 1e3, eval=eval_launches)


def _shard_case(world: int, rank: int) -> dict:
    """(d) on the group that exists: sharded_{zeros,ones,rand} and
    from_enumerable at [world x LIB_SHARD_ROWS, 2304] fp32 over a ('data',)
    mesh of every rank: every shard's metadata, this rank's block, the
    gathered values; sharded_rand's gathered tensor equals the one built at
    world 1 (the seeded CPU draw) bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from editor_tpu_torch.parallel import sharded_tensor as ST

    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    rows, shape = LIB_SHARD_ROWS, (world * LIB_SHARD_ROWS, 3 * C)
    spec0, spec1 = ST.ChunkShardingSpec(dim=0), ST.ChunkShardingSpec(dim=1)
    t0 = time.perf_counter()
    z = ST.sharded_zeros(spec0, shape, mesh)
    o = ST.sharded_ones(spec1, shape, mesh)
    r = ST.sharded_rand(spec0, shape, mesh, seed=5)
    # at least two shards: one shard at offset 0 is no layout by JAX's rule
    n_shards = max(world, 2)
    srows = world * rows // n_shards
    e = ST.from_enumerable(ST.EnumerableShardingSpec(tuple(
        ST.ShardMetadata((i * srows, 0), (srows, 3 * C), i) for i in range(n_shards))), shape,
        lambda m: np.full(m.shard_sizes, m.shard_offsets[0], np.float32), mesh)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    want0 = [((i * rows, 0), (rows, 3 * C), i) for i in range(world)]
    cols = 3 * C // world
    want1 = [((0, i * cols), (world * rows, cols), i) for i in range(world)]
    for name, arr, want in (("zeros", z, want0), ("ones", o, want1), ("rand", r, want0),
                            ("enumerable", e, want0)):
        got = [(m.shard_offsets, m.shard_sizes, m.device_index)
               for m in ST.shard_metadata_of(arr)]
        if got != want:
            raise AssertionError(f"sharded {name}: metadata {got} != {want}")
        if not arr.to_local().is_cuda:
            raise AssertionError(f"sharded {name}: the block is not on the card")
    if not (float(z.to_local().abs().sum()) == 0.0 and bool((o.to_local() == 1).all())):
        raise AssertionError("sharded zeros / ones: wrong values")
    full_rand = r.full_tensor().cpu()
    if not torch.equal(full_rand, torch.rand(shape, generator=torch.Generator().manual_seed(5))):
        raise AssertionError(f"sharded_rand at world {world} != the world-1 tensor")
    first = torch.arange(rank * rows, (rank + 1) * rows, device=e.to_local().device)
    if not torch.equal(e.to_local()[:, 0], (first // srows * srows).float()):
        raise AssertionError("from_enumerable: wrong block")
    return dict(world=world, shape=list(shape), make_s=make_s,
                block_mb=z.to_local().numel() * 4 / 1e6)


def shard_rank(d: str) -> None:
    """One rank of (d) under cli.launch (2-4 cards)."""
    from editor_tpu_torch.parallel import multihost

    multihost.initialize(timeout_s=240)
    import torch.distributed as dist
    res = _shard_case(dist.get_world_size(), dist.get_rank())
    torch.save(res, os.path.join(d, f"shard_{dist.get_rank()}.pt"))
    multihost.shutdown()


def _p15_sharded(card: str) -> dict:
    """(d) the world-1 case on an NCCL group of one rank in this process;
    with 2-4 cards the same on that many ranks (``--shard-rank``, through
    cli.launch), else a line saying it did not run."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from editor_tpu_torch.parallel import multihost

    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        if not multihost.initialize(init_method="file://" + os.path.join(tmp, "store"),
                                    world_size=1, rank=0,
                                    local_rank=torch.cuda.current_device()):
            raise AssertionError("no process group was made")
        one = _shard_case(1, 0)
        multihost.shutdown()
        say("15d sharded world 1", **one)
        world = min(torch.cuda.device_count(), 4)
        multi = None
        if world >= 2:
            _launch_ranks(world, "--shard-rank", tmp)
            multi = [torch.load(os.path.join(tmp, f"shard_{r}.pt")) for r in range(world)]
            say(f"15d sharded world {world}", **multi[0])
        else:
            say("15d sharded multi-card", ran=False, reason="one card: the 2-4 rank case "
                "did not run", card=repr(card))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(one=one, multi=multi)


# (e): the RPC processes' functions, sent by reference (``__main__.<name>``:
# both processes run this script)
RPC_IN, RPC_OUT = 3 * C, 171


def _rpc_weight():
    """The owner's [2304, 171] weight, on its card."""
    return torch.randn(RPC_IN, RPC_OUT, generator=torch.Generator().manual_seed(7)).cuda()


def _rpc_linear(w, x):
    """The owner's forward: a CPU batch in, the product on the card, CPU out."""
    return {"y": (x.to(w.device) @ w).cpu(), "device": str(w.device)}


def _rpc_decay(w, lr):
    return w * (1.0 - lr)


def _rpc_square(x):
    return x * x


def _rpc_counter():
    return 41


def rpc_role(role: str, port: int, d: str) -> None:
    """One process of (e): 'worker1' owns the module and serves until the
    master is done; 'master' runs the checks and writes rpc.json."""
    from editor_tpu_torch.parallel import rpc

    torch.backends.cuda.matmul.allow_tf32 = False
    done = os.path.join(d, "rpc.done")
    if role == "worker1":
        rpc.init_rpc("worker1", rank=1, world_size=2, master_port=port, timeout=120.0)
        deadline = time.time() + 240
        while not os.path.exists(done) and time.time() < deadline:
            time.sleep(0.02)
        rpc.shutdown()
        return
    try:
        rpc.init_rpc("master", rank=0, world_size=2, master_port=port, timeout=120.0)
        x = torch.randn(B_EVAL, RPC_IN, generator=torch.Generator().manual_seed(8))
        w = torch.randn(RPC_IN, RPC_OUT, generator=torch.Generator().manual_seed(7))
        module = rpc.RemoteModule("worker1", _rpc_weight, _rpc_linear)
        first = module(x)
        err = _rel_err(first["y"], x @ w)
        rpc.DistributedOptimizer(_rpc_decay, [module.params_rref]).step(0.5)
        err_step = _rel_err(module(x)["y"], x @ (w * 0.5))
        counter = rpc.remote("worker1", _rpc_counter)
        rpc.enable_fault_injection(messages_to_fail=("fetch",), num_fail_sends=2)
        fetched = counter.to_here()
        rpc.disable_fault_injection()
        with rpc.server_process_global_profile() as prof:
            rpc.rpc_sync("master", _rpc_square, (5,))
            rpc.rpc_sync("master", _rpc_square, (6,))
        stats = prof.key_averages()
        rtt = []
        for _ in range(200):
            t0 = time.perf_counter()
            rpc.rpc_sync("worker1", _rpc_square, (2,))
            rtt.append((time.perf_counter() - t0) * 1e3)
        fwd = []
        for _ in range(20):
            t0 = time.perf_counter()
            module(x)
            fwd.append((time.perf_counter() - t0) * 1e3)
        res = dict(device=first["device"], err=err, err_step=err_step, fetched=fetched,
                   profile_count=stats["_rpc_square"]["count"], events=len(prof.events()),
                   rtt_p50_ms=float(np.median(rtt[10:])), forward_p50_ms=float(np.median(fwd[2:])))
    finally:
        open(done, "w").close()
    rpc.shutdown()
    with open(os.path.join(d, "rpc.json"), "w") as f:
        json.dump(res, f)


def _p15_rpc(card: str) -> dict:
    """(e) two spawned processes (``--rpc-role``): the owner's RemoteModule
    holds a [2304, 171] weight on cuda:0; a CPU batch's forward is computed
    on the card and equals the local product within LIB_RPC_TOL; a
    DistributedOptimizer step (the next forward equals the decayed
    product); an RRef fetched through two injected drops; the profile's
    counts; the p50 of a trivial rpc_sync round trip and of the forward."""
    import shutil
    import socket
    import sys
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rpc_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rpc-role", role,
                               str(port), tmp]) for role in ("worker1", "master")]
    try:
        codes = [p.wait(timeout=300) for p in procs]
        if any(codes):
            raise AssertionError(f"the rpc processes exited {codes}")
        with open(os.path.join(tmp, "rpc.json")) as f:
            res = json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    _require("rpc RemoteModule forward on the card vs local (relative)", res["err"], LIB_RPC_TOL)
    _require("rpc forward after the DistributedOptimizer step (relative)", res["err_step"],
             LIB_RPC_TOL)
    if not (res["device"].startswith("cuda") and res["fetched"] == 41
            and res["profile_count"] == 2 and res["events"] == 2):
        raise AssertionError(f"rpc: {res}")
    say("15e rpc", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in res.items()},
        card=repr(card))
    return res


def library_phase(card: str, gen: torch.Generator, cases: str = "abcde") -> dict:
    """Phase 15: the library surface off the model path. ``cases``: the
    letters of the cases to run (``--phase-15 ae``)."""
    _, ecfg = flagship()
    out = {}
    if "a" in cases:
        out["dtcwt"] = _p15_dtcwt(gen)
        torch.cuda.empty_cache()
    if "b" in cases:
        out["losses"] = _p15_losses(ecfg, gen)
        torch.cuda.empty_cache()
    if "c" in cases:
        out["profiling"] = _p15_profiling(ecfg, gen)
        torch.cuda.empty_cache()
    if "d" in cases:
        out["sharded"] = _p15_sharded(card)
    if "e" in cases:
        out["rpc"] = _p15_rpc(card)
    return out


# The CNN zoo (phase 16)
ZOO_TOL = 1e-4  # (a) card vs CPU, fp32, relative to the CPU logits' largest magnitude
ZOO_COS = 0.99  # (b) per-row cosine of the bf16 logits against the fp32 logits
ZOO_CLASSES = 171  # RGBNT201's training identities
ZOO_B_SMALL, ZOO_B = 2, 128
ZOO_HW = (256, 128)  # (b): RGBNT201's input size
# (a): the CPU tests' sizes (the fixed- and minimum-size entries; 64 x 32 else)
ZOO_SMALL_HW = {
    "squeezenet1_0": (64, 64), "squeezenet1_0_fc512": (64, 64), "squeezenet1_1": (64, 64),
    "xception": (128, 64), "inceptionv4": (160, 96), "inceptionresnetv2": (160, 96),
    "nasnsetmobile": (96, 96), "mudeep": (256, 128), "hacnn": (160, 64), "pcb_p6": (96, 32),
    "cal": (128, 64),
}
# (b): the entries with a fixed input size (every other entry takes ZOO_HW)
ZOO_FULL_HW = {"hacnn": (160, 64), "mudeep": (256, 128)}
ZOO_IMPORT = ("resnet50", "cal")  # (c)


def zoo_full_hw(name: str) -> tuple:
    return ZOO_FULL_HW.get(name, ZOO_HW)


def _random_bn_stats(model, x, gen: torch.Generator) -> None:
    """Random BatchNorm statistics in the units of each BN's own input: one
    CPU forward over ``x`` reads each BN's input (upstream BNs already set),
    the mean m and the variance v of all its elements, and draws the running
    mean m + N(0, 0.5) sqrt(v) and the variance v U(0.5, 2) per channel
    (``tests/test_zoo_golden.py``'s N(0, 0.5) and U(0.5, 2), scaled). The
    unscaled draws leave the seeded nets' activations growing with depth
    (~1e3 in the last stages), where the SE gates make SE-ResNet-101 chaotic
    (fp32 against f64 on the CPU: 0.12 at 256x128); a variance within each
    channel instead of over all elements amplifies the rounding of channels
    that barely vary (CAL's bf16 logits at a cosine of 0.954 on the card)."""
    from editor_tpu_torch.models.zoo.common import BatchNorm

    def draw(m, args):
        t = args[0]
        mean, var = t.mean(), t.var(unbiased=False).clamp_min(1e-12)
        c = m.running_mean.shape[0]
        m.running_mean.copy_(mean + torch.randn(c, generator=gen) * 0.5 * var.sqrt())
        m.running_var.copy_(var * (torch.rand(c, generator=gen) * 1.5 + 0.5))

    hooks = [m.register_forward_pre_hook(draw) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()


def _renamed(state: dict) -> dict:
    """The checkpoint under other names: each module prefix becomes
    ``ckpt.m{i}``, leaf names kept (what the ordered importer reads)."""
    out, prefixes = {}, {}
    for key, value in state.items():
        prefix, _, leaf = key.rpartition(".")
        out[f"ckpt.m{prefixes.setdefault(prefix, len(prefixes))}.{leaf}"] = value
    return out


def _row_cosine(got, ref) -> float:
    g, r = got.double().flatten(1), ref.double().flatten(1)
    return float(torch.nn.functional.cosine_similarity(g, r, dim=1).min())


def _zoo_entry(name: str, gen: torch.Generator, cases: str) -> dict:
    """One entry: built on the CPU with seed 0 and random BN statistics
    (``_random_bn_stats``), (a) its CPU logits against the card's, then (b)
    at full size on the card."""
    from editor_tpu_torch.models.zoo import build_model

    model = build_model(name, ZOO_CLASSES, seed=0, device="cpu")
    h, w = ZOO_SMALL_HW.get(name, (64, 32))
    _random_bn_stats(model, torch.randn(8, 3, h, w, generator=gen), gen)
    x = torch.randn(ZOO_B_SMALL, 3, h, w, generator=gen)
    state = {k: v.clone() for k, v in model.state_dict().items()} if name in ZOO_IMPORT else None
    out = {}
    if "a" in cases or "c" in cases:
        with torch.no_grad():
            ref = model(x)
            model.cuda()
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                card = model(x.cuda())
        err = _rel_err(card, ref)
        say(f"16a {name}", hw=f"{h}x{w}", logits=list(ref.shape), card_vs_cpu=f"{err:.3e}")
        _require(f"16a {name} card vs CPU (relative)", err, ZOO_TOL)
        out.update(a_err=err, a_hw=(h, w), card=card, x=x)
    if state is not None:
        out["state"] = state
    if "b" in cases:
        model.cuda()
        fh, fw = zoo_full_hw(name)
        xf = torch.randn(ZOO_B, 3, fh, fw, generator=gen).cuda()
        logits = {}
        for dtype in (torch.float32, torch.bfloat16):
            xd = xf.to(dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                logits[dtype] = model(xd)
                ms = cuda_ms(lambda: model(xd), iters=10)
            tag = "fp32" if dtype == torch.float32 else "bf16"
            if logits[dtype].dtype != dtype or not torch.isfinite(logits[dtype]).all():
                raise AssertionError(f"16b {name} {tag}: {logits[dtype].dtype} or non-finite")
            out[tag] = dict(ms=ms, img_s=ZOO_B / ms * 1e3,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        cos = _row_cosine(logits[torch.bfloat16], logits[torch.float32])
        out.update(cos=cos, b_hw=(fh, fw))
        say(f"16b {name}", hw=f"{fh}x{fw}", B=ZOO_B, logits=list(logits[torch.float32].shape),
            **{f"{t}_{k}": f"{v:.3f}" for t in ("fp32", "bf16") for k, v in out[t].items()},
            bf16_cos_min=f"{cos:.6f}")
        _require(f"16b {name} bf16 vs fp32 (1 - min row cosine)", 1.0 - cos, 1.0 - ZOO_COS)
    del model
    torch.cuda.empty_cache()
    return out


def _zoo_import(name: str, entry: dict) -> dict:
    """(c) the entry's CPU state_dict under other names through
    load_torch_zoo_state into a module on the card (seed 1, so every slot
    must be written): its logits equal (a)'s card logits bit for bit."""
    from editor_tpu_torch.models.zoo import build_model
    from editor_tpu_torch.utils.zoo_import import frozen_bias_keys, load_torch_zoo_state

    model = build_model(name, ZOO_CLASSES, seed=1, device="cuda")
    frozen = frozen_bias_keys(model)
    renamed = _renamed(entry["state"])
    names = dict(zip(entry["state"], renamed))
    load_torch_zoo_state(model, renamed, skip_keys=[names[k] for k in frozen])
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                     deterministic=True, allow_tf32=False):
        got = model(entry["x"].cuda())
    equal = torch.equal(got, entry["card"])
    say(f"16c {name}", tensors=len(renamed), skipped=len(frozen), bit_for_bit=equal,
        max_abs=float((got - entry["card"]).abs().max()))
    if not equal:
        raise AssertionError(f"16c {name}: imported logits differ from (a)'s card logits")
    return dict(tensors=len(renamed), skipped=len(frozen), equal=equal)


def _zoo_count() -> dict:
    """(d) ``cli.params --cnn all``: 50 lines, each model_param_count."""
    import contextlib
    import io

    from editor_tpu_torch.cli import params as cli_params
    from editor_tpu_torch.models.zoo import MODEL_FACTORY, model_param_count

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = cli_params.main(["--cnn", "all"])
    lines = buf.getvalue().splitlines()
    counts = {name: model_param_count(name, 50) for name in sorted(MODEL_FACTORY)}
    want = [f"{name}: {n / 1e6:.3f} M" for name, n in counts.items()]
    say("16d cli.params --cnn all", lines=len(lines), total=total,
        equal=lines == want and total == sum(counts.values()))
    if lines != want or total != sum(counts.values()) or len(lines) != 50:
        raise AssertionError("16d: cli.params --cnn all differs from model_param_count")
    return dict(lines=len(lines), total=total)


def zoo_phase(card: str, cases: str = "abcd") -> dict:
    """Phase 16: the CNN zoo, every factory entry. ``cases``: the letters of
    the cases to run (``--phase-16 bd``). The weights, statistics and images
    come from a CPU generator, so the CPU reference and the card see the
    same values."""
    from editor_tpu_torch.models.zoo import MODEL_FACTORY

    cpu_gen = torch.Generator().manual_seed(16)
    reset_counts()
    out = {}
    if {"a", "b", "c"} & set(cases):
        out["entries"] = {name: _zoo_entry(name, cpu_gen, cases) for name in MODEL_FACTORY}
    if "b" in cases:
        say("16b card", card=card, sizes={n: f"{h}x{w}" for n, (h, w) in ZOO_FULL_HW.items()},
            others=f"{ZOO_HW[0]}x{ZOO_HW[1]}")
    if "c" in cases:
        out["import"] = {name: _zoo_import(name, out["entries"][name]) for name in ZOO_IMPORT}
    if "d" in cases:
        out["count"] = _zoo_count()
    launched = {k: v for k, v in launch_counts().items() if v}
    say("16 launches", kernels=launched or "none")
    if launched:
        raise AssertionError(f"16: the zoo launched kernels of the port: {launched}")
    for entry in out.get("entries", {}).values():
        for key in ("card", "x", "state"):
            entry.pop(key, None)
    return out


def timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"{name} time", seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def _mp_launches(mp: dict, name: str) -> dict:
    """Phase 12's launches of one kernel row: the MoE flagship's train step
    and eval forward (b) and, where two cards ran them, a TP rank's train
    step (c), a rank's Ulysses forward + backward and seq-sharded fusion
    block (d) and a MoE data rank's step and mesh eval forward (f, by world
    size), and where four did, a (2, 2) rank's ZeRO-1, FSDP and PowerSGD
    step (e)."""
    out = {"moe_train": mp["moe"]["train"][name], "moe_eval": mp["moe"]["eval"][name]}
    if mp["tp"]:
        out["tp_train"] = mp["tp"]["train"][name]
    if mp["mp"]:
        out.update(ulysses=mp["mp"]["ulysses"][name], seq_block=mp["mp"]["seq"][name])
    for kind, launches in mp["tpz"].items():
        out[f"tp_{kind}_train"] = launches[name]
    for world, launches in mp["moe_data"].items():
        out.update({f"moe_data{world}_train": launches["train"][name],
                    f"moe_data{world}_eval": launches["eval"][name]})
    return out


def main() -> None:
    card = card_check()
    timed("1 build", build_phase)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = timed("2 kernels", kernel_phase, gen)
    model, eval_launches = timed("3 forward", forward_phase, gen)
    timed("4 serving", serving_phase, model, gen, card)
    del model
    torch.cuda.empty_cache()
    launches, bare_step_ms = timed("5 train", train_phase, gen)
    torch.cuda.empty_cache()
    un_eval, un_train = timed("6 uncompacted", uncompacted_phase, gen)
    torch.cuda.empty_cache()
    kernels.update(timed("7 variants", variant_phase, gen))
    torch.cuda.empty_cache()
    looped = timed("8 loop", loop_phase, card, bare_step_ms)
    torch.cuda.empty_cache()
    served = timed("9 serve", serve_phase, card)
    torch.cuda.empty_cache()
    dp = timed("10 dp", dp_phase, card, bare_step_ms)
    torch.cuda.empty_cache()
    fsdp = timed("11 fsdp", fsdp_phase, card)
    torch.cuda.empty_cache()
    mp = timed("12 mp", mp_phase, card, gen)
    torch.cuda.empty_cache()
    pp = timed("13 pp", pp_phase, card, gen, bare_step_ms)
    torch.cuda.empty_cache()
    cf = timed("14 configs", config_phase, gen)
    torch.cuda.empty_cache()
    lib = timed("15 library", library_phase, card, gen)
    torch.cuda.empty_cache()
    timed("16 zoo", zoo_phase, card)
    # launches, launches_eval: per train step and per eval forward (loop: eval
    # batch), summed over the three paths (compact: phases 3 and 5;
    # uncompacted: phase 6; the loop: phase 8, with its run's total), each
    # path counted from zero just before it runs
    rows = []
    for name, spec in {**KERNELS, **VARIANTS}.items():
        by_path = {"compact": {"train": launches[name], "eval": eval_launches[name]},
                   "uncompacted": {"train": un_train[name], "eval": un_eval[name]},
                   "loop": {k: looped[k][name] for k in ("train", "eval", "run")},
                   "serve": {k: served[k][name] for k in ("query", "visualize")},
                   "dp": {k: dp[k][name] for k in ("train", "eval")},
                   "fsdp": {k: fsdp[k][name] for k in ("train", "eval")},
                   "mp": _mp_launches(mp, name),
                   "pp": {"train": pp["train"][name], "eval": pp["eval"][name],
                          **{f"ranks_{k}_train": v["train"][name]
                             for k, v in pp["multi"].items()}},
                   "stride12": {"train": cf["train"]["launches"][name],
                                "eval": cf["eval"]["launches"][name]},
                   "remat": {k: v["launches"][name] for k, v in cf["remat"].items()},
                   "dropout": {k: cf["dropout"][k][name] for k in ("train", "eval")},
                   "library": {"forward": lib["losses"]["forward"][name],
                               "backward": lib["losses"]["backward"][name],
                               "eval": lib["profiling"]["eval"][name]}}
        info = {k: v for k, v in spec.items() if k != "tool"}
        extra = {"tp_shard": mp["shard"][name]} if name in mp["shard"] else {}
        if name in cf["kernels"]:
            extra["stride12"] = cf["kernels"][name]
        rows.append(dict(name=name, route="cuda", **info,
                         launches=(launches[name] + un_train[name] + looped["train"][name]
                                   + dp["train"][name] + fsdp["train"][name]
                                   + mp["moe"]["train"][name] + pp["train"][name]
                                   + cf["train"]["launches"][name]
                                   + lib["losses"]["forward"][name]
                                   + lib["losses"]["backward"][name]),
                         launches_eval=(eval_launches[name] + un_eval[name]
                                        + looped["eval"][name] + dp["eval"][name]
                                        + fsdp["eval"][name] + mp["moe"]["eval"][name]
                                        + pp["eval"][name] + cf["eval"]["launches"][name]
                                        + lib["profiling"]["eval"][name]),
                         launches_by_path=by_path, **kernels[name], **extra))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 10 (e)
        dp_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--launch-worker"]:  # the trainer of phase 11 (c)
        launch_worker(sys.argv[2], sys.argv[3] == "1")
    elif sys.argv[1:2] == ["--fsdp-rank"]:  # one rank of phase 11 (d)
        fsdp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase 12 (c)
        tp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--mp-rank"]:  # one rank of phase 12 (d)
        mp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--moe-rank"]:  # one rank of phase 12 (f)
        moe_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--pp-rank"]:  # one rank of phase 13 (b), (c)
        pp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--zero-rank"]:  # one rank of phase 12 (e), 13 (d)
        zero_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--phase-12"]:  # phase 12 alone, after the build [cases]
        card = card_check()
        timed("1 build", build_phase)
        timed("12 mp", mp_phase, card, torch.Generator(device="cuda").manual_seed(0),
              *sys.argv[2:3])
    elif sys.argv[1:2] == ["--phase-13"]:  # phase 13 alone, after the build [cases]
        card = card_check()
        timed("1 build", build_phase)
        timed("13 pp", pp_phase, card, torch.Generator(device="cuda").manual_seed(0), None,
              *sys.argv[2:3])
    elif sys.argv[1:2] == ["--shard-rank"]:  # one rank of phase 15 (d)
        shard_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--rpc-role"]:  # one process of phase 15 (e)
        rpc_role(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--phase-15"]:  # phase 15 alone, after the build [cases]
        card = card_check()
        timed("1 build", build_phase)
        timed("15 library", library_phase, card, torch.Generator(device="cuda").manual_seed(0),
              *sys.argv[2:3])
    elif sys.argv[1:2] == ["--phase-16"]:  # phase 16 alone, after the build [cases]
        card = card_check()
        timed("1 build", build_phase)
        timed("16 zoo", zoo_phase, card, *sys.argv[2:3])
    elif sys.argv[1:2] == ["--phase-14"]:  # phase 14 alone, after the build [cases]
        card_check()
        timed("1 build", build_phase)
        timed("14 configs", config_phase, torch.Generator(device="cuda").manual_seed(0),
              *sys.argv[2:3])
    else:
        main()
