"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernels  # build + kernel-vs-plain checks

Phases, each fatal on failure:

1. device  — CUDA must be present; prints the card's name and power limit
             (nvidia-smi) and the software versions.
2. build   — compiles every CUDA kernel of the serving and training paths
             from src/repro_torch/csrc (one nvcc per source, all at once).
3. kernels — holds each of the sixteen kernels against its plain
             PyTorch version on the card at the serving and training
             paths' shapes (the MoE's expert GEMMs, head dim 128, the
             exact-stats path's tensors, serve-mamba's selective scan and
             the plain flash forward of ``kernels.ops`` included), with the
             tolerance
             stated beside each check, and times kernel, plain version
             and a library yardstick with CUDA events (the flash kernels
             and the payload GEMMs at large M also with their bound on
             TF32 tensor cores at three passes; the GEMMs at decode
             width as device time from torch.profiler; quantize-apply,
             truncate-apply, the stats kernels, the paged decode and the
             selective scan also by device time at a shape of their main
             path, the L2 flushed before each call; the scan at all three
             of serve-mamba's prefill buckets, beside its exps' time
             were they all on the SFUs; the payload flash forward and
             backward at train-long's 36 heads x 4096 tokens and the
             batched GEMM at serve-dense's decode attention, 288 groups
             of one query row, in rows of their own); two launches of each
             GEMM path, quantize-apply, truncate-apply, the fused
             truncate, the paged decode and the scan give the same bits,
             and truncate-apply equals
             dequant(quant_apply(x)) bit for bit; one call of the stats
             kernel, quantize-with-stats and the fused truncate launches
             one kernel each (torch.profiler).  First the code table
             that quantize-apply and both truncates encode by is swept
             against the direct map over every f32 t (0 mismatches in
             each format).
4. small   — the reduced models on the card through the kernels and
             through the plain versions: minicpm serving (same greedy
             tokens, close logits), and minicpm and deepseek_moe_16b
             (global and grouped routing) training with the bank at
             k = 2, where every kernel call, forward and backward, is held
             against its plain version on the same inputs (phase 3's
             tolerances), then 3 train steps (finite, close losses); then
             minicpm on the cuda_fused engine, exact stats in payload and
             in fig4 mode and the bank at k = 2, held the same way; and
             one counted step each: the cuda_fused exact step runs as
             many aten reductions as the fp32 step, the cuda one more; and
             reduced falcon_mamba_7b served by LMServer through the
             kernels and through the plain versions, in fp32 (every scan
             call held against its plain version, the same greedy tokens)
             and in s2fp8 on cuda_fused (every kernel call held, close
             logits); and reduced minicpm trained at batch 1 x 3072 tokens
             (above 2048: the long-sequence attention) with the bank at
             k = 2, attn_impl flash (the payload flash kernels) and naive
             (the chunked attention between truncate kernels), and in fig4
             with attn_impl flash on cuda_fused, every kernel call held;
             and "small-paper": transformer_tiny, ResNet-20 and NCF, 2
             steps each on cuda and on cuda_fused, every kernel call held;
             and "small-formats": reduced minicpm and reduced
             deepseek_moe_16b served in each of the five paged-cache
             formats through the kernels (every call held) and through
             the plain versions teacher-forced along the kernels' tokens,
             the f32_e5m2 / f32_e4m3 pools equal to the dequantized
             payload pools bit for bit.
5. serve   — full-width minicpm_2b (40 layers, d=2304, vocab 122,753) from
             a seeded generator: calibrate the frozen bank, then serve 16
             requests through PayloadLMServer (8 slots, max_len 1024,
             block 16, e5m2 pool).  Every serving kernel must have launched
             during this phase and no plain version may have run.
6. train   — full-width minicpm_2b trained 4 steps at batch 4 x seq 512
             with the StatsBank at k = 8 (make_train_step, AdamW, remat),
             from seeded params and seeded Markov batches.  Every training
             kernel must have launched during this phase, no plain version
             may have run, and every loss must be finite.
7. train-moe — full-width deepseek_moe_16b (d 2048, 16 heads of 128, 64
             routed experts top-6 of width 1408 + 2 shared, vocab
             102,400), depth cut to its first 4 layers (dense_first + 3
             moe), trained 4 steps at batch 4 x seq 512 with the bank at
             k = 8 (AdamW, remat).  The batched payload GEMM and every
             other training kernel must have launched, no plain version
             may have run, and every loss and aux loss must be finite.
8. train-exact — full-width minicpm_2b, 3 steps at batch 4 x seq 512 with
             exact per-call stats on the cuda_fused engine, payload GEMMs:
             the stats, quantize-with-stats and fused truncate kernels and
             every training kernel must have launched, no plain version
             may have run, every loss finite.  Then one more step on the
             cuda engine (stats from torch reductions), timed beside it.
9. train-fig4 — the same model and batch in fig4 mode on cuda_fused (the
             Fig. 4 chain: every operand, output and cotangent through the
             fused truncate kernel around f32 torch.matmul / einsum, TF32
             off), 3 steps: the fused truncate must have launched, no plain
             version may have run, every loss finite.
10. serve-mamba — full-width falcon_mamba_7b at full depth (64 mamba1
             layers, d 4096, di 8192, state 16, vocab 65,024, untied head;
             7.27 B f32 params) from a seeded generator, served through the
             dense-cache LMServer: 8 slots, 8 requests with prompts of
             64-512 tokens, 16 new tokens each, s2fp8 with exact per-call
             stats on the cuda_fused engine and payload GEMMs.  Every
             prefill must launch the selective-scan kernel once per layer,
             every kernel of the path must have launched and no plain
             version may have run.
11. ops      — each function of ``repro_torch.kernels.ops`` once on the
             card: each one's kernel must launch, and its result must agree
             with the same function's oracle (``use_kernel=False``).
12. train-modes — full-width minicpm_2b, 2 steps each in the baselines
             bf16 and fp8_ls (loss scale 100) at batch 4 x 512: every loss
             finite, no kernel launched (these modes are casts and f32
             products).
13. train-long — full-width minicpm_2b at batch 1 x 4096 tokens, s2fp8
             payload with the bank at k = 8: 2 steps with attn_impl flash
             (qflash_fwd and qflash_bwd at S 4096 and every training
             kernel must launch, no plain version run), then 1 step with
             attn_impl naive (the chunked attention); step ms and peak
             memory printed.
14. serve-dense — full-width minicpm_2b through the dense-cache LMServer
             (8 slots, 8 of phase 5's prompts, 16 new tokens), exact stats
             on cuda_fused: the prefill's payload flash and the decode's
             attention on the batched payload GEMM must launch, with every
             other kernel of the path, and no plain version may run.
15. train-encdec — full-width, full-depth whisper_medium (24 + 24
             layers, d 1024, vocab 51,865) trained 4 steps at batch 4 x
             1,500 audio-stub frames and 448 tokens with the bank at k = 8
             (AdamW, remat): every training kernel must launch, no plain
             version run, every loss finite.
16. serve-encdec — whisper_medium's serve_prefill and 16 greedy
             serve_decode ticks for 4 requests, exact stats on cuda_fused:
             the stats kernels, the decode path's GEMMs, the batched GEMM
             (self-attention) and the payload flash (encoder and
             cross-attention) must launch, no plain version run.
17. train-paper — ResNet-20 (batch 128), NCF at MovieLens-1M's sizes
             (batch 1,024) and transformer_tiny (batch 64 x 32) in s2fp8
             payload on cuda (every training kernel launched between them)
             and in fp32, fp8 and fp8_ls(100) (no kernel); losses finite.
18. train-loop — the resilient loop of ``launch/train.py`` (TrainLoop as
             ``main`` builds it) on full-width minicpm_2b cut to 2 layers,
             batch 4 x 512, bank k = 4 with telemetry, the guard and a
             snapshot ring of 2: the escalation ladder under
             nan_grad@5x3 (every rejected step bit-invisible), the same
             schedule under reject@5x3, a corrupted checkpoint quarantined
             by --resume auto, a compressed checkpoint through the
             quantize-with-stats and dequantize kernels held against the
             plain codec, finite telemetry and a watchdog trip.
19. serve-moe — full-width deepseek_moe_16b at full depth (28 layers,
             16.38 B f32 params) from a seeded generator: calibrate the
             frozen bank (prefill and decode probes), then serve phase 5's
             16 requests through PayloadLMServer (8 slots, max_len 1024,
             block 16, e5m2 pool, a JSONL metrics sink).  The batched
             payload GEMM, the paged decode and every other serving
             kernel must launch, no plain version may run, no payload
             pool may decode through ``decode_attention``, and the sink
             must hold one ``serving_tick`` event a tick.  It runs after
             phase 5.
20. train-gemma3 — full-width, full-depth gemma3_1b (26 layers: 22
             local with window 512, 4 dense; d 1152, 4 heads of 256 on 1
             K/V head, GELU-GLU, vocab 262,144 tied; 1.00 B params) trained
             2 steps at batch 1 x 4096 with attn_impl flash and the bank
             at k = 8: the flash kernels at head dim 256, windowed and
             causal, beside every training kernel.
21. serve-gemma3 — gemma3_1b through the dense-cache LMServer as
             serve-dense runs minicpm: its local layers' caches are rings
             of 512 positions, which the prompts above 512 tokens wrap.
22. serve-stablelm — full-width, full-depth stablelm_12b (40 layers, 32
             heads of 160 on 8 K/V heads; 12.1 B f32 params) served as
             serve-moe serves: 16 requests, 32 new tokens, frozen bank,
             e5m2 pool; the paged decode at head dim 160.
23. serve-nemotron — full-width nemotron_4_340b (d 18,432, 96 heads of
             192 on 8 K/V heads, squared ReLU, layer norm, vocab 256,000
             untied) cut to 1 of its 96 layers (51.6 GB of f32 params), 8
             requests, 16 new tokens; the paged decode at head dim 192.
24. train-zamba2 — full-width, full-depth zamba2_1p2b (38 layers: 32
             mamba2 of 64 heads x 64 channels with 64 states, 6 attn; 1.35 B
             params) trained 4 steps at batch 4 x 512 with the bank at k = 8
             (payload GEMMs on cuda, AdamW, remat): the per-head scan and
             its backward kernel at every mamba2 layer beside every
             training kernel.
25. train-mamba — full-width falcon_mamba_7b cut to 4 of its 64 layers
             (64 would be ~116 GB of f32 state; 4 are 0.95 B params), trained
             as train-zamba2: the per-channel scan and its backward.
26. serve-zamba2 — zamba2_1p2b at full width and depth through the
             dense-cache LMServer as serve-mamba runs falcon: every prefill
             launches the scan once per mamba2 layer (32).
27. train-mesh — the mesh-native train step on a 1-rank NCCL group
             (built in the process, destroyed at the phase's end):
             full-width minicpm_2b (40 layers, remat, batch 4 x 512, bank
             k = 8, payload GEMMs on cuda) through ``launch/train.py``'s
             ``build`` and ``TrainLoop``, 3 steps each: meshless, then
             ``--mesh 1x1`` with f32 sync under replicated, fsdp and
             fsdp_q params (losses and per-leaf digests of params and
             AdamW state bit for bit the meshless run's at every step),
             then s2fp8 sync (its compressed legs' encode on cuda_fused,
             each leg held against the plain quantize and dequantize;
             the loss within 2e-3 relative of the meshless run's); the
             collective records counted; and the exact toy under fsdp_q
             on the card, where the 1-byte payload handoff runs.
28. doctor — ``launch/doctor.py --smoke`` on cuda and cuda_fused; full-width
             minicpm_2b (40 layers) probed with a cold bank at batch 4 x
             512 on both engines (sites probed, unclean sites and seconds
             per engine printed; the probes' kernels must launch, no
             plain version run); a reduced checkpoint's restore round
             trip (params bit for bit, the bank used; a bank of another
             site structure falls back to a cold one).
29. dryrun — full-width minicpm_2b's s2fp8 train step at 4 x 512 (exact
             stats on cuda, remat) traced by ``roofline.trace_cost`` on
             fake tensors and again on the card: the dry per-kind kernel
             calls equal the launches ``kernels.counts()`` records, the
             FLOPs within 5% of the real trace's and the peak live bytes
             within 10% of ``torch.cuda.max_memory_allocated``; both
             costs, 6·N·T and the roofline printed.  Then the four
             production-mesh dry cells (``DRY_CELLS``: minicpm_2b
             train_4k, prefill_32k, decode_32k and kimi_k2_1t_a32b
             train_4k under fsdp_q, 16 x 16, attention on the flash
             route), CPU subprocesses of ``launch/dryrun.py`` started after
             phase 3, are read and their records printed; each must trace.
Phase 4 also runs "small-families": the five attention-family configs
reduced, served through the kernels (every call held) and through the
plain versions teacher-forced along the kernels' tokens; and "small-ssm":
reduced zamba2 served as reduced falcon_mamba_7b is, and reduced zamba2 and
falcon trained (bank k = 2), every scan forward and backward call held
against its plain version.  Phase 3 holds the per-head scan at
serve-zamba2's prefill buckets (8 x 128 / 256 / 512, 64 heads x 64, 64
states) and the scan's backward at train-mamba's and train-zamba2's shapes
(4 x 512), two launches giving the same bits.

Phase 3 also holds #7, #8, #10, #11 and #12 at the shapes these phases
give them (the convs' im2col GEMMs, N = 1 and 10, whisper's head and
attention; serve-moe's head, dense_first, shared-expert and attention
GEMMs, its routed experts at decode and at every prefill bucket, its
prefill attention and its decode at head dim 128), #9-#11 at head
dims 160, 192 and 256, #12 at 16, 160 and 192 and #8 at kimi's experts
(``wide_kernel_checks``), and #7 and #8 at every GEMM shape of phases
20-23: the projections, MLPs and heads of gemma3_1b, stablelm_12b and
nemotron_4_340b at decode, prefill and training, gemma3's decode
attention and the calibration's decode probes (``family_gemm_checks``).
A weight above 2^30 elements (nemotron's 4.72 G-element head) is made in
row chunks and its plain GEMM runs on slices of its columns.

Prints a ``kernels:`` JSON line and then, as the last line, the device
contract line.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's rates and the per-call bound: one copy, in roofline/analysis
from repro_torch.roofline.analysis import (SFU_PER_S, TC_PASSES,  # noqa: E402
                                           bound_ms)

# TPU kernel each port replaces (src/repro/... file:line of the Pallas entry)
REPLACES = {
    "quant_apply": "src/repro/kernels/s2fp8_quant.py:176",
    "truncate_apply": "src/repro/kernels/s2fp8_quant.py:229",
    "dequant": "src/repro/kernels/s2fp8_quant.py:209",
    "stats": "src/repro/kernels/s2fp8_quant.py:157",
    "quant": "src/repro/kernels/s2fp8_quant.py:197",
    "truncate_fused": "src/repro/kernels/s2fp8_quant.py:254",
    "qmatmul_nn": "src/repro/kernels/s2fp8_matmul.py:189",
    "qmatmul_nt": "src/repro/kernels/s2fp8_matmul.py:189",
    "qmatmul_tn": "src/repro/kernels/s2fp8_matmul.py:189",
    "qmatmul_batched": "src/repro/kernels/s2fp8_matmul.py:230",
    "qflash_fwd": "src/repro/kernels/flash_attention.py:287",
    "qflash_bwd": "src/repro/kernels/flash_attention.py:348",
    "paged_decode": "src/repro/kernels/paged_attention.py:89",
    "selective_scan": "src/repro/kernels/selective_scan.py:58",
    "flash_fwd": "src/repro/kernels/flash_attention.py:91",
    # no TPU kernel: the reference differentiates lax.scan (mamba1, mamba2)
    "selective_scan_bwd": "port only: src/repro/models/blocks.py:643 and "
                          ":734 differentiate lax.scan",
}
SOURCES = {
    "quant_apply": "src/repro_torch/csrc/s2fp8_quant.cu",
    "truncate_apply": "src/repro_torch/csrc/s2fp8_quant.cu",
    "dequant": "src/repro_torch/csrc/s2fp8_quant.cu",
    "stats": "src/repro_torch/csrc/s2fp8_quant.cu",
    "quant": "src/repro_torch/csrc/s2fp8_quant.cu",
    "truncate_fused": "src/repro_torch/csrc/s2fp8_quant.cu",
    "qmatmul_nn": "src/repro_torch/csrc/s2fp8_matmul.cu",
    "qmatmul_nt": "src/repro_torch/csrc/s2fp8_matmul.cu",
    "qmatmul_tn": "src/repro_torch/csrc/s2fp8_matmul.cu",
    "qmatmul_batched": "src/repro_torch/csrc/s2fp8_matmul.cu",
    "qflash_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "qflash_bwd": "src/repro_torch/csrc/flash_attention.cu",
    "paged_decode": "src/repro_torch/csrc/paged_attention.cu",
    "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
    "flash_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "selective_scan_bwd": "src/repro_torch/csrc/selective_scan.cu",
}
# the kernels each main path runs (phase 5 serves, phase 6 trains minicpm,
# phase 7 trains deepseek_moe_16b, phases 8 and 9 train minicpm with exact
# stats on the cuda_fused engine, payload and fig4, phase 10 serves
# falcon_mamba_7b with exact stats on cuda_fused, phase 11 calls the ops)
SERVE_KERNELS = ("quant_apply", "truncate_apply", "qmatmul_nn", "qmatmul_nt",
                 "qflash_fwd", "paged_decode")
TRAIN_KERNELS = ("quant_apply", "truncate_apply", "dequant", "qmatmul_nn",
                 "qmatmul_nt", "qmatmul_tn", "qflash_fwd", "qflash_bwd")
TRAIN_MOE_KERNELS = TRAIN_KERNELS + ("qmatmul_batched",)
STATS_KERNELS = ("stats", "quant", "truncate_fused")
TRAIN_EXACT_KERNELS = TRAIN_KERNELS + STATS_KERNELS
TRAIN_FIG4_KERNELS = ("truncate_fused",)
# payload GEMMs with the chunked attention between the bank's truncations
TRAIN_NAIVE_KERNELS = ("quant_apply", "truncate_apply", "qmatmul_nn",
                       "qmatmul_nt", "qmatmul_tn")
SERVE_DENSE_KERNELS = STATS_KERNELS + (
    "truncate_apply", "qmatmul_nn", "qmatmul_nt", "qmatmul_batched",
    "qflash_fwd", "qmatmul_nn/small", "qmatmul_nt/small")
SERVE_MAMBA_KERNELS = STATS_KERNELS + ("truncate_apply", "qmatmul_nn",
                                       "selective_scan")
OPS_KERNELS = ("quant", "dequant", "truncate_apply", "qmatmul_nn",
               "flash_fwd")
# the paper's workloads: whisper_medium trained with the bank on cuda (the
# training kernels) and served with exact stats on cuda_fused (the stats
# kernels, the decode's small-path GEMMs and batched self-attention GEMM,
# the payload flash at the encoder and the cross-attention); ResNet-20,
# NCF and transformer_tiny trained in s2fp8 payload on cuda
TRAIN_ENCDEC_KERNELS = TRAIN_KERNELS
SERVE_ENCDEC_KERNELS = ("stats", "quant", "truncate_apply", "qmatmul_nn",
                        "qmatmul_nn/small", "qmatmul_batched", "qflash_fwd")
TRAIN_PAPER_KERNELS = TRAIN_KERNELS
# the resilient loop on the cuda engine (health metrics through
# truncate-apply), its compressed checkpoint through cuda_fused's
# quantize-with-stats and the dequantize on restore
TRAIN_LOOP_KERNELS = TRAIN_KERNELS + ("quant",)
# deepseek_moe_16b served from a frozen bank on an e5m2 pool: the routed
# experts on the batched payload GEMM, the untied head and every other
# projection on the NN GEMM (its small path at decode), the paged decode
SERVE_MOE_KERNELS = ("quant_apply", "truncate_apply", "qmatmul_nn",
                     "qmatmul_nn/small", "qmatmul_batched", "qflash_fwd",
                     "paged_decode")
# the attention-family configs' untied-head payload serving (stablelm_12b,
# nemotron_4_340b): every projection and the head on the NN GEMM (its small
# path at decode), the prefill's payload flash, the paged decode
SERVE_UNTIED_KERNELS = ("quant_apply", "truncate_apply", "qmatmul_nn",
                        "qmatmul_nn/small", "qflash_fwd", "paged_decode")
# the SSM slice: the scan and its backward train falcon_mamba_7b's mamba1
# blocks (no attention) and zamba2_1p2b's mamba2 blocks beside its attn
# blocks; zamba2 serves on the dense-cache engine as minicpm does there
SCAN_KERNELS = frozenset(("selective_scan", "selective_scan_bwd"))
TRAIN_MAMBA_KERNELS = ("quant_apply", "truncate_apply", "qmatmul_nn",
                       "qmatmul_nt", "qmatmul_tn", "selective_scan",
                       "selective_scan_bwd")
TRAIN_ZAMBA2_KERNELS = TRAIN_KERNELS + ("selective_scan",
                                        "selective_scan_bwd")
SERVE_ZAMBA2_KERNELS = STATS_KERNELS + (
    "quant_apply", "truncate_apply", "qmatmul_nn", "qmatmul_batched",
    "qflash_fwd", "selective_scan")
PHASES = ("serve", "train", "train_moe", "train_exact", "train_fig4",
          "serve_mamba", "ops", "train_modes", "train_long_flash",
          "train_long_naive", "serve_dense", "train_encdec", "serve_encdec",
          "train_paper", "train_loop", "serve_moe", "train_gemma3",
          "serve_gemma3", "serve_stablelm", "serve_nemotron",
          "train_zamba2", "train_mamba", "serve_zamba2", "train_mesh",
          "doctor", "dryrun", "train_tp_1x1", "tp_rank0")

# payload GEMM shapes phase 3 holds and times, (M, K, N) of the logical
# GEMM: minicpm's NN at decode (8 slots) and prefill (8 rows x bucket
# 1024); NT / TN: a ragged shape, then the backward GEMMs of the tied head,
# the attention projections and the MLP; the tied head's NT at decode
GEMMS_NN = [(8, 2304, 5760), (8, 5760, 2304), (8 * 1024, 2304, 5760),
            (8 * 1024, 5760, 2304)]
GEMMS_NT_TN = {
    "nt": [(333, 130, 77), (2048, 2304, 122753), (2048, 2304, 2304),
           (2048, 5760, 2304)],
    "tn": [(333, 130, 77), (122753, 2048, 2304), (2304, 2048, 2304),
           (2304, 2048, 5760)],
}
GEMM_HEAD_DECODE = (8, 2304, 122753)
# (layout, Ga, Gb, out_batch, M, K, N) of the MoE's expert einsums
GEMMS_BATCHED = [("nn", 256, 64, None, 64, 2048, 1408),
                 ("nt", 256, 64, None, 64, 1408, 2048),
                 ("tn", 256, 256, 64, 2048, 64, 1408),
                 ("nn", 64, 64, None, 256, 1408, 2048),
                 ("nt", 64, 64, None, 256, 2048, 1408),
                 ("tn", 64, 64, None, 1408, 256, 2048),
                 ("nt", 64, 64, None, 256, 1408, 2048),
                 ("tn", 64, 64, None, 2048, 256, 1408),
                 ("nn", 64, 64, None, 256, 2048, 1408)]
# serve-dense's decode attention on the batched GEMM: 8 slots x 36 heads,
# one query row each, over 1024 cache positions of head dim 64
GEMMS_BATCHED_DECODE = [("nt", 288, 288, None, 1, 64, 1024),
                        ("nn", 288, 288, None, 1, 1024, 64)]
# serve-moe's payload GEMMs (deepseek_moe_16b, 8 slots), each list's last
# case the row's kept shape: the untied head (N 102,400; prefill takes it
# on each row's last position only, so M = 8 there too), the dense_first
# MLP (d_ff 10,944), the attention projections (16 heads of 128) and the
# two shared experts' fused MLP (d_ff 2 x 1408) on the small path at
# decode, and on the large path at prefill (8 rows x bucket 128 and 1024)
GEMMS_NN_MOE = [
    ("qmatmul_nn decode moe head", [(8, 2048, 102400)]),
    ("qmatmul_nn decode moe", [(8, 2048, 10944), (8, 10944, 2048),
                               (8, 2048, 2048), (8, 2816, 2048),
                               (8, 2048, 2816)]),
    ("qmatmul_nn moe prefill", [(8 * 128, 2048, 2816),
                                (8 * 1024, 2048, 10944),
                                (8 * 1024, 10944, 2048),
                                (8 * 1024, 2048, 2048),
                                (8 * 1024, 2816, 2048),
                                (8 * 1024, 2048, 2816)]),
]
# serve-moe's routed experts on the batched GEMM, G = 64 experts of width
# 1408, M = each expert's capacity: min(T, ceil(T * 6 / 64 * 1.25) rounded
# up to 128) of T tokens, 8 at decode, 128, 512 and 1,024 at the prefill
# buckets 128, 512 and 1,024 (256 is GEMMS_BATCHED's); the down einsum
# ecf,efd->ecd (K 1408, N 2048), then the gate / up ecd,edf->ecf (K 2048,
# N 1408), the row's kept shape
GEMMS_BATCHED_MOE = {
    "qmatmul_batched moe decode": [("nn", 64, 64, None, 8, 1408, 2048),
                                   ("nn", 64, 64, None, 8, 2048, 1408)],
    "qmatmul_batched moe prefill": [("nn", 64, 64, None, m, k, n)
                                    for m in (128, 512, 1024)
                                    for k, n in ((1408, 2048), (2048, 1408))],
}
FLASH_LONG_S = 4096      # train-long's sequence
# rows of the kernels line that report one path of a wrapper: row name
# prefix -> the count that path adds to (see path_counts)
SMALL_PATH = {"qmatmul_nn decode": "qmatmul_nn/small",
              "qmatmul_nt decode": "qmatmul_nt/small"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 128 << 20          # 2.5 x the H100's 50 MB L2


def device_ms(fn, iters: int = 20, warmup: int = 2,
              cold: bool = False) -> float:
    """Mean device milliseconds per call: the time the card spends in the
    call's kernels (torch.profiler), without the host's gaps between
    launches, which outlast a decode GEMM's few microseconds.  ``cold``:
    before each call a 128 MB f32 buffer is zeroed, so the call's inputs
    come from HBM as on the main path (a tensor under 50 MB would otherwise
    sit in the L2 from the call before); the zeroing kernel is left out of
    the sum.  The profiler can miss the first kernel of a window, so each
    window opens with a primer (an int16 fill, left out); a window whose
    counts are still not whole multiples of ``iters`` is measured again,
    up to three times.  The profiler can also drop a kernel inside a long
    window (a plain version of a few dozen launches a call lost one in
    three windows running); then the call is timed with CUDA events
    instead (``cuda_time``, host gaps included; under ``cold`` less the
    flush's own time), and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    primer = torch.empty(1, dtype=torch.int16, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer.fill_(0)
            torch.cuda.synchronize()
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us, launches, flushes = 0.0, 0, 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CPU
                    or "FillFunctor<short>" in e.key):
                continue
            if cold and "FillFunctor<float>" in e.key:
                flushes += e.count
                continue
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            launches += e.count
        if (us > 0 and launches % iters == 0
                and flushes == (iters if cold else 0)):
            return us / 1e3 / iters
    log(f"device_ms: the profiler saw {launches} launches and {flushes} "
        f"flushes in {iters} calls, three windows running; CUDA-event "
        f"time instead")
    if not cold:
        return cuda_time(fn, iters=iters, warmup=0)
    return cuda_time(lambda: (flush.zero_(), fn()), iters=iters,
                     warmup=0) - cuda_time(flush.zero_, iters=iters,
                                           warmup=0)


def kernels_per_call(fn, calls: int = 3) -> dict:
    """Kernel function -> launches per call of ``fn`` (torch.profiler over
    ``calls`` calls; the window opens with a primer, left out).  A window
    whose counts are not whole multiples of ``calls`` (the profiler dropped
    a kernel, see ``device_ms``) is measured again, up to three times; the
    last window's counts are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    primer = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer.fill_(0)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {kernel_function(e.key): e.count
                  for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU
                  and "FillFunctor<short>" not in e.key}
        if counts and all(c % calls == 0 for c in counts.values()):
            break
    return {k: c / calls for k, c in counts.items()}


def same_bits(fn, what: str) -> None:
    """Two launches on the same inputs give the same bits."""
    assert torch.equal(fn(), fn()), f"{what}: two launches differ"


def path_counts() -> dict:
    """kernels.counts(), plus the launches of the payload GEMM's small
    (decode) path under "qmatmul_nn/small" and "qmatmul_nt/small"."""
    from repro_torch import kernels
    from repro_torch.kernels import s2fp8_matmul
    counts = kernels.counts()
    for layout in ("nn", "nt"):
        counts[f"qmatmul_{layout}/small"] = {
            "launches": getattr(s2fp8_matmul,
                                f"qmatmul_{layout}").small_launches,
            "plain_calls": 0}
    return counts


def code_ordinal(payload: torch.Tensor) -> torch.Tensor:
    """Signed ordinal of 8-bit payload codes: neighbouring grid points
    differ by 1, so |ordinal difference| counts grid steps (flips)."""
    u = payload.view(torch.uint8).int()
    mag = u & 0x7F
    return torch.where(u >= 0x80, -mag, mag)


def ordinal(values: torch.Tensor, stats, fmt: str) -> torch.Tensor:
    """Ordinal of on-grid values (truncate / epilogue outputs), read back
    through the plain quantizer."""
    from repro_torch.core import s2fp8
    return code_ordinal(
        s2fp8.quantize(values.float(), stats=stats, fmt=fmt).payload)


def flips(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max_step": int(d.max().item()) if d.numel() else 0,
            "frac": float((d != 0).float().mean().item()) if d.numel() else 0.0,
            "count": int((d != 0).sum().item())}


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is False")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])         # name, power limit
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    # the plain versions' f32 products must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build(ptxas: bool) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.SOURCES, ptxas_verbose=ptxas)
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        if ptxas:
            lines = [l for l in text.splitlines()
                     if "registers" in l or "spill" in l or "smem" in l]
            log(f"ptxas {name}: " + " | ".join(l.strip() for l in lines))
            spilled = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
            assert not any(spilled), f"a kernel of {name} spills registers"
    for name in build.SOURCES:
        build.load(name)
    log(f"build: {len(build.SOURCES)} libraries in {dt:.1f} s")
    if ptxas:
        check_tensor_cores("flash_attention", "HMMA", (
            "qflash_fwd_kernel", "qflash_dq_kernel", "qflash_dkdv_kernel"))
        check_tensor_cores("s2fp8_matmul", "HGMMA", ("gemm_large_kernel",))


def check_tensor_cores(library: str, op: str, kernels) -> None:
    """Every instantiation of each of ``kernels`` in ``library`` holds
    tensor-core products (``op``: HMMA for mma.sync, HGMMA for wgmma) in
    its SASS."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(build.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    count, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            count[fn] = 0
        elif fn is not None and re.search(rf"\b{op}\b", line):
            count[fn] += 1
    for kernel in kernels:
        found = [n for f, n in count.items() if kernel in f]
        log(f"sass {kernel}: {op} instructions per instantiation {found}")
        assert found and all(found), f"{kernel}: no tensor-core products"


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def phase_kernels(dev) -> dict:
    """Returns name -> {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}; raises on any disagreement."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import flash_attention, s2fp8_matmul, s2fp8_quant
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def record(name, err, ms, plain_ms, lib_ms, nbytes, flops, shape,
               keep=True, tensor_cores=False, path_ms=None, on_path=False,
               **extra):
        """Keep the worst error over every shape checked, and the times and
        bound of the last shape recorded with ``keep`` (each list ends with
        a main-path shape, or marks it).  ``tensor_cores``: the kernel runs
        its f32 products as TC_PASSES TF32 tensor-core passes, so its
        operations bound is the smaller of the f32-core time and that.
        ``path_ms``: the call's device time with the L2 flushed
        (``device_ms(cold=True)``); with ``on_path`` (a shape its main
        path launches often) the row keeps it as ``path_device_ms`` beside
        ``path_shape`` and ``path_bound_ms``.  The bound is
        ``bound_ms``'s; no time may beat it."""
        bound, bound_by, kind = bound_ms(nbytes, flops, tensor_cores)
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], float(err))
        if keep or "ms" not in row:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by, shape=shape,
                       **extra)
        if on_path:
            row.update(path_shape=shape, path_device_ms=path_ms,
                       path_bound_ms=bound)
        if path_ms is not None:
            extra = dict(extra, device_ms_l2_flushed=path_ms)
        rate = (f", {flops / ms / 1e9:.1f} TFLOP/s (f32 work)" if flops
                else "")
        log(f"time {name} [{shape}]: kernel {ms:.4f} ms{rate}, plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms, bound {bound:.4f} ms ("
            + ("bytes" if bound_by == "bytes" else f"operations, {kind}")
            + ")" + "".join(f", {k} {v:.4f} ms" for k, v in extra.items()))
        assert ms >= bound, f"{name} [{shape}]: {ms} ms beats its bound"
        assert path_ms is None or path_ms >= bound, \
            f"{name} [{shape}]: device {path_ms} ms beats its bound"

    # -- the code table that quantize-apply and both truncates encode
    # by: its byte against the direct map's for every f32 t, both signs, in
    # each format.  Tolerance: 0 mismatches.
    for fmt in ("e4m3", "e5m2"):
        bad, first = s2fp8_quant.code_sweep(dev, fmt)
        log(f"code table {fmt}: {bad} mismatches against the direct map "
            f"over all 2^32 f32 t x 2 signs"
            + (f" (least at t bits {first:#010x})" if bad else "")
            + f"; quant_apply, truncate_apply and truncate_fused encode "
            f"{fmt} by the table")
        assert bad == 0, (fmt, bad, first)
    log("quantize-with-stats and the fused truncate keep, across their grid "
        "barrier, at most " + ", ".join(
            f"{s2fp8_quant.fused_capacity(dev, dt)} {str(dt)[6:]} elements"
            for dt in (torch.float32, torch.bfloat16))
        + f" ({s2fp8_quant.fused_capacity(dev, registers=True)} of them in "
        f"registers, the rest in shared memory)")

    # -- quant_apply / truncate_apply at the paths' operands: a prefill
    # activation, a decode tick's MLP weight (2304 x 5760 bf16, quantized
    # on every tick) and the tied head weight (bf16, quantized per call)
    # for quantize; the prefill K cache (bf16, the serve path's) and the
    # f32 embedding table (truncated per call) for truncate.  The row's
    # ms: CUDA events at its last shape (the table); beside it the device
    # time with the L2 flushed at the decode weight and the K cache.
    # Tolerance: payload codes of quantize-apply equal to the plain
    # version's (the same log2f and rounded multiply-add; the code table
    # equals exp2f + convert everywhere, swept above), and two launches
    # give the same bits; truncate-apply's codes at most one grid step
    # apart, in at most 1e-4 of the elements (the maps round each step
    # alike; the allowance is for the math library), its values bit for bit
    # dequant(quant_apply(x)) in x's dtype (the same encode; Eq. 5 as
    # lut[code]), and two launches give the same bits.
    decode_weight = (2304, 5760)
    kv_cache = (8 * 36 * 1024, 64)
    quant_shapes = [((8 * 1024, 2304), torch.bfloat16),
                    (decode_weight, torch.bfloat16),
                    ((122753, 2304), torch.bfloat16)]
    trunc_shapes = [(kv_cache, torch.bfloat16),
                    ((122753, 2304), torch.float32)]
    for fmt in ("e4m3", "e5m2"):
        for shape, dtype in quant_shapes:
            x = rnd(*shape, dtype=dtype, scale=0.05)
            ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
            pk = s2fp8_quant.quant_apply(x, ab, fmt)
            pp = s2fp8_quant.quant_apply_plain(x, ab, fmt)
            f = flips(code_ordinal(pk), code_ordinal(pp))
            log(f"quant_apply {fmt} {shape} {dtype}: flips {f}")
            assert f["max_step"] == 0, f
            same_bits(lambda: s2fp8_quant.quant_apply(x, ab, fmt).view(
                torch.uint8), f"quant_apply {fmt} {shape}")
            dq = s2fp8.dequantize(s2fp8.S2FP8Tensor(pk, ab, fmt))
            dp = s2fp8.dequantize(s2fp8.S2FP8Tensor(pp, ab, fmt))
            record("quant_apply", (dq - dp).abs().max().item(),
                   cuda_time(lambda: s2fp8_quant.quant_apply(x, ab, fmt)),
                   cuda_time(lambda: s2fp8_quant.quant_apply_plain(
                       x, ab, fmt), iters=3), None,
                   x.numel() * (x.element_size() + 1), 0,
                   f"{fmt} {tuple(shape)} {dtype}",
                   path_ms=device_ms(lambda: s2fp8_quant.quant_apply(
                       x, ab, fmt), cold=True),
                   on_path=shape == decode_weight)
            del x, pk, pp, dq, dp
        for shape, dtype in trunc_shapes:
            x = rnd(*shape, dtype=dtype, scale=0.05)
            ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
            tk = s2fp8_quant.truncate_apply(x, ab, fmt)
            tp = s2fp8_quant.truncate_apply_plain(x, ab, fmt)
            f = flips(ordinal(tk, ab, fmt), ordinal(tp, ab, fmt))
            ints = torch.int32 if dtype == torch.float32 else torch.int16
            dq = s2fp8_quant.dequant(s2fp8_quant.quant_apply(x, ab, fmt), ab)
            same = torch.equal(tk.view(ints), dq.to(dtype).view(ints))
            log(f"truncate_apply {fmt} {shape} {dtype}: flips {f}; "
                f"bit-equal to dequant(quant_apply(x)): {same}")
            assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
            assert same, "truncate_apply differs from dequant(quant_apply)"
            same_bits(lambda: s2fp8_quant.truncate_apply(x, ab, fmt).view(
                ints), f"truncate_apply {fmt} {shape}")
            del dq
            record("truncate_apply",
                   (tk.float() - tp.float()).abs().max().item(),
                   cuda_time(lambda: s2fp8_quant.truncate_apply(x, ab, fmt)),
                   cuda_time(lambda: s2fp8_quant.truncate_apply_plain(
                       x, ab, fmt), iters=3), None,
                   x.numel() * 2 * x.element_size(), 0,
                   f"{fmt} {tuple(shape)} {dtype}",
                   path_ms=device_ms(lambda: s2fp8_quant.truncate_apply(
                       x, ab, fmt), cold=True),
                   on_path=shape == kv_cache)
            del x, tk, tp

    # -- qmatmul_nn at decode (M = 8 slots) and prefill (M = 8 rows x
    # bucket 1024) widths, with minicpm's K/N.  Tolerance: without the
    # epilogue |kernel - plain| <= 1e-5 * (|A| @ |B|) + 1e-30 (f32
    # accumulation order); with it, output codes differ by at most one grid
    # step in at most 1e-3 of the elements.
    for m, k, n in GEMMS_NN:
        decode = s2fp8_matmul.plan_gemm(m, n, k).path == "small"
        gemm_case(rnd, record, f"qmatmul_nn decode K={k} N={n}" if decode
                  else "qmatmul_nn", "nn", m, k, n, torch.bfloat16)

    # -- qflash_fwd: prefill attention at buckets P = 128 and 512 (8 rows x
    # 36 heads, head dim 64, causal), plus head dims 32 and 80, the MoE's
    # training attention (4 rows x 16 heads of 128, 512 tokens: the
    # largest tiles in shared memory, 116 KB) and serve-moe's prefill at
    # bucket 1,024 (8 rows x 16 heads of 128); the times kept are the last
    # (serving's P = 512) shape's.  Tolerance:
    # output codes differ by at most one grid step in at most 1% of the
    # elements (online-softmax blocking differs: 64 here, 512 in the
    # plain version), |lse| error <= 1e-4.
    cases = [(64, 200, 32), (64, 130, 80), (4 * 16, 512, 128),
             (8 * 16, 1024, 128), (8 * 36, 128, 64), (8 * 36, 512, 64)]
    for bh, p, d in cases:
        qf, kf, vf = (rnd(bh, p, d) for _ in range(3))
        sts = [s2fp8.compute_stats(t) for t in (qf, kf, vf)]
        qq, qk, qv = (s2fp8_quant.quant_apply(t, s)
                      for t, s in zip((qf, kf, vf), sts))
        raw, _ = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1)
        oab = s2fp8.compute_stats(raw)
        ok, lk = flash_attention.qflash_fwd(qq, qk, qv, *sts, g=1,
                                            out_ab=oab)
        op, lp = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1,
                                                  out_ab=oab)
        f = flips(ordinal(ok, oab, "e5m2"), ordinal(op, oab, "e5m2"))
        lerr = (lk - lp).abs().max().item()
        log(f"qflash_fwd bh={bh} P={p} d={d}: flips {f}, lse err {lerr:.2e}")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-2 and lerr <= 1e-4, \
            (f, lerr)
        deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, s))
               for t, s in zip((qq, qk, qv), sts)]
        pairs = p * (p + 1) // 2
        record("qflash_fwd", (ok - op).abs().max().item(),
               cuda_time(lambda: flash_attention.qflash_fwd(
                   qq, qk, qv, *sts, g=1, out_ab=oab)),
               cuda_time(lambda: flash_attention.qflash_fwd_plain(
                   qq, qk, qv, *sts, g=1, out_ab=oab), iters=3),
               cuda_time(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             deq[0][None], deq[1][None], deq[2][None],
                             is_causal=True)),
               3 * bh * p * d + bh * p * d * 4 + bh * p * 4,
               4.0 * bh * pairs * d, f"BH={bh} P={p} d={d} causal",
               tensor_cores=True)

    # -- paged_decode: 8 slots, block 16, 64 blocks per slot, both formats:
    # minicpm's 36 KV heads of 64, the serve run's (phase 5) prompts, and
    # serve-moe's 16 KV heads of 128 (the kernel's other head-dim
    # instance), its prompts (``paged_decode_checks``).
    paged_decode_checks(dev, gen, rnd, record, "paged_decode", 36, 64,
                        serve_prompts(122753)[2])
    paged_decode_checks(dev, gen, rnd, record, "paged_decode hd128", 16,
                        128, serve_prompts(102400)[2])
    train_kernel_checks(dev, rnd, record)
    moe_kernel_checks(dev, rnd, record)
    stats_kernel_checks(dev, rnd, record)
    mamba_ops_kernel_checks(dev, gen, rnd, record)
    ssm_kernel_checks(dev, gen, record)
    long_kernel_checks(dev, rnd, record)
    paper_kernel_checks(dev, rnd, record)
    moe_serve_kernel_checks(dev, rnd, record)
    wide_kernel_checks(dev, gen, rnd, record)
    family_gemm_checks(dev, rnd, record)
    tp_kernel_checks(dev, rnd, record)
    return rows


def paged_decode_checks(dev, gen, rnd, record, row, kvh, hd,
                        serve_lens, g: int = 1) -> None:
    """The paged decode kernel at 8 slots x ``kvh`` KV heads of head dim
    ``hd`` (``g`` query heads a KV head), block 16, 64 blocks per slot, both
    formats, at three sets of positions: across the whole context; on
    both sides of the kernel's split boundaries; and a serve run's first
    8 prompts (``serve_lens``) at their 16th decode token, the row's
    main-path shape.  Tolerance: |kernel - plain| <= 1e-4 * |plain| +
    1e-5 (f32 softmax order; no truncation on this path), and two
    launches give the same bits.  Recorded into ``row``, timed at the
    spread positions."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import paged_attention, s2fp8_quant
    split = paged_attention.SPLIT
    position_sets = {
        "spread": [0, 15, 16, 100, 511, 700, 1000, 1023],
        "split edges": [0, split - 1, split, 2 * split - 1, 2 * split,
                        3 * split - 1, 3 * split, 1023],
        "serve": [int(n) + 15 for n in serve_lens[:8]],
    }
    for fmt in ("e4m3", "e5m2"):
        b, blk, max_b = 8, 16, 64
        nb = b * max_b + 1
        q = rnd(b, kvh, g, hd)
        kf, vf = rnd(nb, kvh, blk, hd), rnd(nb, kvh, blk, hd)
        kab = s2fp8.compute_stats(kf, s2fp8.FMT_TARGET_MAX[fmt])
        vab = s2fp8.compute_stats(vf, s2fp8.FMT_TARGET_MAX[fmt])
        kp = s2fp8_quant.quant_apply(kf, kab, fmt)
        vp = s2fp8_quant.quant_apply(vf, vab, fmt)
        perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        table = perm.reshape(b, max_b).to(torch.int32)
        for label, positions in position_sets.items():
            pos = torch.tensor(positions, dtype=torch.int32, device=dev)
            kernel = (lambda: paged_attention.paged_decode_attention(
                q, kp, vp, kab, vab, table, pos, fmt))
            ok = kernel()
            op = paged_attention.paged_decode_plain(q, kp, vp, kab, vab,
                                                    table, pos, fmt)
            err = (ok - op).abs()
            log(f"{row} {fmt} KV={kvh} G={g} hd={hd} {label} {positions}: "
                f"max err "
                f"{err.max().item():.3e}")
            assert bool((err <= 1e-4 * op.abs() + 1e-5).all()), \
                err.max().item()
            same_bits(kernel, f"{row} {fmt} {label}")
            live = int((pos.long() + 1).sum().item())
            record(row, err.max().item(), cuda_time(kernel),
                   cuda_time(lambda: paged_attention.paged_decode_plain(
                       q, kp, vp, kab, vab, table, pos, fmt), iters=3),
                   None,
                   2 * live * kvh * hd + 2 * b * kvh * g * hd * 4
                   + table.numel() * 4 + b * 4,
                   4.0 * live * kvh * g * hd,
                   f"{fmt} B={b} KV={kvh} G={g} hd={hd} block={blk} {label} "
                   f"live={live}",
                   keep=label == "spread",
                   path_ms=device_ms(kernel, cold=True),
                   on_path=label == "serve")


def moe_serve_kernel_checks(dev, rnd, record) -> None:
    """The payload GEMMs at serve-moe's shapes, in rows of their own:
    ``GEMMS_NN_MOE`` (``gemm_case``: bf16 operands, raw within 1e-5 *
    (|A| @ |B|) + 1e-30, epilogue codes at most one step apart in at most
    1e-3 of the outputs) and ``GEMMS_BATCHED_MOE`` (``batched_case``, the
    same tolerances)."""
    for row, shapes in GEMMS_NN_MOE:
        for i, (m, k, n) in enumerate(shapes):
            gemm_case(rnd, record, row, "nn", m, k, n, torch.bfloat16,
                      keep=i == len(shapes) - 1)
    for row, cases in GEMMS_BATCHED_MOE.items():
        for layout, ga, gb, ob, m, k, n in cases:
            batched_case(rnd, record, row, layout, ga, gb, ob, m, k, n)


def scan_inputs(dev, gen, b, s, di, n):
    """The selective scan's inputs as serve-mamba's prefill feeds them:
    x, dt [b, s, di] (dt through softplus), B, C [b, s, n], the model's
    A = -(1..n) per channel, D = 1; f32, from ``gen``."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    x = rnd(b, s, di, scale=0.5)
    dt = torch.nn.functional.softplus(rnd(b, s, di) - 1.0)
    bm, cm = rnd(b, s, n, scale=0.5), rnd(b, s, n, scale=0.5)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return x, dt, bm, cm, a, torch.ones(di, device=dev)


def scan_bound_ms(b, s, di, n, nh=0):
    """(bound ms, bound_by, bytes, f32 operations) of the selective scan,
    by ``bound_ms``: its bytes (x, dt and y once, B and C once, A, D and
    the final h once; per head dt, A and D a head) over HBM, and its f32
    operations over the f32 cores: per channel 7 a state and step (the
    exp counted as one) and 3 a channel and step; per head 5 a state and
    step, 3 a channel and step and 2 a head and step (its one exp).  The
    exps are no term of their own: an exp2 runs on the SFUs or as a
    polynomial on the FMA pipes, and the two together take them in less
    time than the bytes."""
    width, params = (nh, 2 * nh) if nh else (di, di * n + di)
    nbytes = 4 * (2 * b * s * di + b * s * width + 2 * b * s * n + params
                  + b * di * n)
    flops = float(b * s * di * (5 * n + 3) + (2 * b * s * nh if nh
                                              else 2 * b * s * di * n))
    bound, by, _ = bound_ms(nbytes, flops)
    return bound, by, nbytes, flops


def scan_bwd_bound_ms(b, s, di, n, nh=0):
    """(bound ms, bound_by, bytes, f32 operations) of the scan's backward,
    by ``bound_ms``.  Bytes: its inputs once (x, dt, B, C, A, D, dy and
    the forward's chunk states [b, ceil(s / 16), di, n]) and its outputs
    once (dx, ddt, dB, dC, dA, dD).  Operations, as the kernel does them
    (the replay of each chunk from its saved state is part of the work:
    no input holds the states between chunk starts): per channel 24 a
    state and step (the replay's 7, the walk's 14 with the exp again, the
    dC and dB sums' 3) and 9 a channel and step; per head 16 a state and
    step, 10 a channel and step and 2 a head and step."""
    width, params = (nh, 2 * nh) if nh else (di, di * n + di)
    chunks = -(-s // 16)
    nbytes = 4 * (3 * b * s * di + 2 * b * s * width + 4 * b * s * n
                  + 2 * params + b * chunks * di * n)
    flops = float(b * s * di * (16 * n + 10) + 2 * b * s * nh if nh
                  else b * s * di * (24 * n + 9))
    bound, by, _ = bound_ms(nbytes, flops)
    return bound, by, nbytes, flops


def scan_heads_inputs(dev, gen, b, s, nh, hd, n):
    """The per-head scan's inputs as a mamba2 prefill or training step
    feeds them: x [b, s, nh hd], dt [b, s, nh] (through softplus), B, C
    [b, s, n], the model's A = -linspace(1, 16, nh) and D = 1; f32, from
    ``gen``."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    x = rnd(b, s, nh * hd, scale=0.5)
    dt = torch.nn.functional.softplus(rnd(b, s, nh) - 1.0)
    bm, cm = rnd(b, s, n, scale=0.5), rnd(b, s, n, scale=0.5)
    a = -torch.linspace(1.0, 16.0, nh, device=dev)
    return x, dt, bm, cm, a, torch.ones(nh, device=dev)


def ssm_kernel_checks(dev, gen, record) -> None:
    """The widened scan per head at serve-zamba2's prefill buckets (8 rows
    x 128, 256 and 512 tokens, 64 heads of 64 channels, 64 states; the S
    512 times kept, device time with the L2 flushed at S 256), and the
    scan's backward at train-mamba's shape (4 x 512, di 8192, 16 states,
    per channel) and train-zamba2's (4 x 512, 64 heads of 64, 64 states).
    Tolerance: the forward's y and h within 1e-5 * max |plain| (h bit for
    bit but for the math library's exp), the backward's six gradients
    within 1e-4 * max |plain| (autograd through the plain version sums the
    same terms in another order), and two launches give the same bits.
    No single PyTorch call computes either: library none."""
    from repro_torch.kernels import selective_scan as ss

    for s in (128, 256, 512):
        b, nh, hd, n = 8, 64, 64, 64
        args = scan_heads_inputs(dev, gen, b, s, nh, hd, n)
        yk, hk = ss.selective_scan(*args)
        yp, hp = ss.selective_scan_plain(*args)
        ey, eh = (yk - yp).abs().max().item(), (hk - hp).abs().max().item()
        ty, th = yp.abs().max().item(), hp.abs().max().item()
        log(f"selective_scan zamba2 B={b} S={s} heads {nh}x{hd} n={n}: y "
            f"err {ey:.3e} (max {ty:.3e}), h err {eh:.3e} (max {th:.3e}), "
            f"h equal {bool(torch.equal(hk, hp))}")
        assert ey <= 1e-5 * ty and eh <= 1e-5 * th, (ey, ty, eh, th)
        same_bits(lambda: torch.cat([t.flatten() for t in
                                     ss.selective_scan(*args)]),
                  f"selective_scan zamba2 S={s}")
        _, _, nbytes, flops = scan_bound_ms(b, s, nh * hd, n, nh)
        record("selective_scan zamba2", max(ey, eh),
               cuda_time(lambda: ss.selective_scan(*args)),
               cuda_time(lambda: ss.selective_scan_plain(*args), iters=2,
                         warmup=1), None, nbytes, flops,
               f"B={b} S={s} heads={nh}x{hd} n={n} f32", keep=s == 512,
               path_ms=device_ms(lambda: ss.selective_scan(*args),
                                 cold=True), on_path=s == 256)
        del args, yk, hk, yp, hp

    for label, (b, s, di, n, nh) in (("falcon", (4, 512, 8192, 16, 0)),
                                     ("zamba2", (4, 512, 4096, 64, 64))):
        if nh:
            args = scan_heads_inputs(dev, gen, b, s, nh, di // nh, n)
        else:
            args = scan_inputs(dev, gen, b, s, di, n)
        dy = torch.randn(b, s, di, generator=gen, device=dev)
        _, _, chunks = ss.selective_scan(*args, chunk_states=True)
        gk = ss.selective_scan_bwd(*args, dy, chunks)
        t0 = time.perf_counter()
        gp = ss.selective_scan_bwd_plain(*args, dy)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = {}
        for name, k, p in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), gk, gp):
            errs[name] = ((k - p).abs().max() / p.abs().max()).item()
        log(f"selective_scan_bwd {label} B={b} S={s} di={di} n={n} nh={nh}: "
            "errors / max |plain| " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()))
        assert max(errs.values()) <= 1e-4, errs
        same_bits(lambda: torch.cat([t.flatten() for t in
                                     ss.selective_scan_bwd(*args, dy,
                                                           chunks)]),
                  f"selective_scan_bwd {label}")
        err = max((k - p).abs().max().item() for k, p in zip(gk, gp))
        del gp
        _, _, nbytes, flops = scan_bwd_bound_ms(b, s, di, n, nh)
        record(f"selective_scan_bwd {label}", err,
               cuda_time(lambda: ss.selective_scan_bwd(*args, dy, chunks)),
               plain_ms, None, nbytes, flops,
               f"B={b} S={s} di={di} n={n} "
               + (f"heads={nh}x{di // nh} " if nh else "") + "f32",
               path_ms=device_ms(lambda: ss.selective_scan_bwd(
                   *args, dy, chunks), cold=True), on_path=True)
        del args, dy, chunks, gk


def mamba_ops_kernel_checks(dev, gen, rnd, record) -> None:
    """The selective scan at serve-mamba's prefill buckets (8 rows x 128,
    256 and 512, di 8192, 16 states, f32, the model's A = -(1..16) per
    channel) and the plain flash forward of ``kernels.ops`` at 4 x 32 heads x 2048
    x d 128 causal (the time kept), 4 x 32 heads x 512 queries over 2048
    keys with a window of 1024, and a ragged bf16 non-causal case."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import selective_scan as ss

    # -- selective_scan at serve-mamba's three prefill buckets (8 slots x
    # S 128, 256, 512), S 512's times kept.  Tolerance: y and the final h
    # each within 1e-5 * max |plain| (the state update rounds the same ops
    # in the same order on both sides, so h should agree bit for bit but
    # for the math library's exp; y's 16-term sum over the states runs in
    # another order), and two launches give the same bits.  No single
    # PyTorch call computes the scan: library none.
    for b, s, di, n in ((8, 128, 8192, 16), (8, 256, 8192, 16),
                        (8, 512, 8192, 16)):
        args = scan_inputs(dev, gen, b, s, di, n)
        yk, hk = ss.selective_scan(*args)
        yp, hp = ss.selective_scan_plain(*args)
        ey, eh = (yk - yp).abs().max().item(), (hk - hp).abs().max().item()
        ty, th = yp.abs().max().item(), hp.abs().max().item()
        log(f"selective_scan B={b} S={s} di={di} n={n}: y err {ey:.3e} (max "
            f"{ty:.3e}), h err {eh:.3e} (max {th:.3e}), h equal "
            f"{bool(torch.equal(hk, hp))}")
        assert ey <= 1e-5 * ty and eh <= 1e-5 * th, (ey, ty, eh, th)
        same_bits(lambda: torch.cat([t.flatten() for t in
                                     ss.selective_scan(*args)]),
                  f"selective_scan S={s}")
        _, _, nbytes, flops = scan_bound_ms(b, s, di, n)
        # Not a bound: the exps' time were each one MUFU.EX2 on the SFUs.
        sfu_ms = b * s * di * n / SFU_PER_S * 1e3
        record("selective_scan", max(ey, eh),
               cuda_time(lambda: ss.selective_scan(*args)),
               cuda_time(lambda: ss.selective_scan_plain(*args), iters=2,
                         warmup=1), None, nbytes, flops,
               f"B={b} S={s} di={di} n={n} f32", keep=s == 512,
               exps_on_sfus_alone_ms=sfu_ms, path_ms=device_ms(lambda: ss.selective_scan(*args), cold=True),
               on_path=s == 256)
        del args, yk, hk, yp, hp

    # -- flash_fwd.  Tolerance: f32 allclose at rtol 2e-4, atol 2e-5, the
    # reference's own tolerance for its kernel against the oracle (the
    # online softmax runs in 64-key tiles here, 512 in the plain version);
    # bf16 outputs within rtol 1e-2, atol 1e-3 (one bf16 rounding of f32
    # values that differ in the last bits).  Library: SDPA on the same
    # tensors (f32, TF32 off), with a boolean mask for the window.
    cases = [(2, 4, 200, 333, 80, False, None, torch.bfloat16, False),
             (4, 32, 512, 2048, 128, True, 1024, torch.float32, False),
             (4, 32, 2048, 2048, 128, True, None, torch.float32, True)]
    for b, h, sq, sk, d, causal, window, dtype, keep in cases:
        q = rnd(b, h, sq, d, dtype=dtype)
        k, v = rnd(b, h, sk, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype)
        ok = flash_attention.flash_attention(q, k, v, causal=causal,
                                             window=window)
        op = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                   window=window)
        err = (ok.float() - op.float()).abs()
        rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                      else (1e-2, 1e-3))
        log(f"flash_fwd B={b} H={h} Sq={sq} Sk={sk} d={d} causal={causal} "
            f"window={window} {dtype}: max err {err.max().item():.3e}")
        assert ok.dtype == dtype
        assert bool((err <= atol + rtol * op.float().abs()).all()), \
            err.max().item()
        qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=dev)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        pairs = int(mask.sum().item())
        sdpa_mask = None if (window is None and (not causal or sq == sk)) \
            else mask

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask,
                is_causal=causal and sdpa_mask is None)
        es = q.element_size()
        record("flash_fwd", err.max().item(),
               cuda_time(lambda: flash_attention.flash_attention(
                   q, k, v, causal=causal, window=window)),
               cuda_time(lambda: flash_attention.flash_attention_plain(
                   q, k, v, causal=causal, window=window), iters=3),
               cuda_time(library), es * (2 * q.numel() + 2 * k.numel()),
               4.0 * b * h * pairs * d,
               f"B={b} H={h} Sq={sq} Sk={sk} d={d} causal={causal} "
               f"window={window} {str(dtype)[6:]}", keep=keep,
               tensor_cores=True)
        del q, k, v, ok, op, err


def train_kernel_checks(dev, rnd, record) -> None:
    """The training path's kernels at the train phase's shapes (batch 4 x
    seq 512 = 2,048 tokens, d 2304, d_ff 5760, 36 heads of 64, vocab
    122,753)."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import flash_attention, s2fp8_matmul, s2fp8_quant

    def payload(x, fmt="e5m2"):
        ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
        return s2fp8_quant.quant_apply(x, ab, fmt), ab

    # -- dequant: the flash backward's delta operands (the quantized output
    # and its cotangent, 4 x 36 heads x 512 x 64), both formats.
    # Tolerance: |kernel - plain| <= 1e-6 * |plain| (the same Eq. 4 map,
    # each step rounded alike: bit for bit but for the math library).
    for fmt in ("e4m3", "e5m2"):
        p, ab = payload(rnd(4 * 36 * 512, 64, scale=0.05), fmt)
        dk = s2fp8_quant.dequant(p, ab)
        dp = s2fp8_quant.dequant_plain(p, ab)
        err = (dk - dp).abs()
        log(f"dequant {fmt} {tuple(p.shape)}: max err {err.max().item():.3e}"
            f", {(err != 0).sum().item()} elements differ")
        assert bool((err <= 1e-6 * dp.abs()).all()), err.max().item()
        record("dequant", err.max().item(),
               cuda_time(lambda: s2fp8_quant.dequant(p, ab)),
               cuda_time(lambda: s2fp8_quant.dequant_plain(p, ab), iters=3),
               None, p.numel() * 5, 0, f"{fmt} {tuple(p.shape)}")

    # -- qmatmul_nt / qmatmul_tn: a ragged shape, then the backward GEMMs
    # of the MLP and attention projections (dA = g W^T is nt, dW = x^T g
    # is tn) and the tied head (x E^T forward is nt, dE = g^T x is tn); the
    # times kept are the last (MLP) shape's.  Tolerance as qmatmul_nn: raw
    # |kernel - plain| <= 1e-5 * (|A| @ |B|) + 1e-30 (f32 summation
    # order); with the epilogue, codes at most one grid step apart in at
    # most 1e-3 of the outputs.
    for layout, shapes in GEMMS_NT_TN.items():
        for m, k, n in shapes:
            gemm_case(rnd, record, f"qmatmul_{layout}", layout, m, k, n,
                      torch.bfloat16)

    # -- serving's tied head at decode (8 slots): x E^T as NT over the
    # stored table's payload (the small path, K unsplit), held and timed,
    # and against slice 1's route, NN over a u8 transpose of that payload
    # (the same values; the quantize is common to both).  Raw outputs held
    # as above, the epilogue as above.
    m, k, n = GEMM_HEAD_DECODE
    qx, xab = payload(rnd(m, k, dtype=torch.bfloat16))
    qe, eab = payload(rnd(n, k, dtype=torch.bfloat16, scale=0.05))
    qet = qe.view(torch.uint8).t().contiguous().view(qe.dtype)
    raw_nt = s2fp8_matmul.qmatmul_nt(qx, xab, qe, eab)
    raw_nn = s2fp8_matmul.qmatmul_nn(qx, xab, qet, eab)
    deq_x = s2fp8.dequantize(s2fp8.S2FP8Tensor(qx, xab))
    deq_e = s2fp8.dequantize(s2fp8.S2FP8Tensor(qe, eab))
    err = (raw_nt - raw_nn).abs()
    assert bool((err <= 1e-5 * (deq_x.abs() @ deq_e.abs().t())
                 + 1e-30).all()), f"head nt vs nn: {err.max().item()}"
    oab = s2fp8.compute_stats(raw_nt)
    ek = s2fp8_matmul.qmatmul_nt(qx, xab, qe, eab, oab)
    ep = s2fp8_matmul.qmatmul_nt_plain(qx, xab, qe, eab, oab)
    f = flips(ordinal(ek, oab, "e5m2"), ordinal(ep, oab, "e5m2"))
    log(f"qmatmul_nt head {m}x{k}x{n}: raw max err vs nn route "
        f"{err.max().item():.3e}, epilogue flips {f}")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-3, f
    same_bits(lambda: s2fp8_matmul.qmatmul_nt(qx, xab, qe, eab, oab),
              "qmatmul_nt head")
    nn_ms = cuda_time(lambda: s2fp8_matmul.qmatmul_nn(qx, xab, qet, eab, oab))
    tr_ms = cuda_time(lambda: qe.view(torch.uint8).t().contiguous())
    head = lambda: s2fp8_matmul.qmatmul_nt(qx, xab, qe, eab, oab)
    record("qmatmul_nt decode head", (ek - ep).abs().max().item(),
           device_ms(head),
           device_ms(lambda: s2fp8_matmul.qmatmul_nt_plain(
               qx, xab, qe, eab, oab), iters=3),
           device_ms(lambda: torch.matmul(deq_x, deq_e.t())),
           m * k + k * n + 4 * m * n, 2.0 * m * k * n,
           f"nt M={m} K={k} N={n} epilogue", call_ms=cuda_time(head))
    log(f"time decode head: slice 1's route: u8 transpose {tr_ms:.4f} ms + "
        f"nn {nn_ms:.4f} ms")
    del qx, qe, qet, raw_nt, raw_nn, deq_x, deq_e, err, ek, ep

    # -- qflash_bwd: GQA g = 2 with a window, a ragged head dim,
    # train-moe's attention (4 x 16 heads of 128: 177 KB of shared memory
    # for dq, 213 KB for dk/dv), then the train phase's (4 x 36 heads, 512
    # tokens, head dim 64, causal), whose times are kept.  Residuals as the
    # node makes them: payload q/k/v, the
    # quantized output and cotangent, lse from the forward and delta =
    # rowsum(deq(g) * deq(o)).  Tolerance: each of dq, dk, dv within
    # 1e-4 * max|plain| (f32 sums in another order, 64-row tiles here and
    # 512-row chunks in the plain version).
    cases = [(8, 2, 200, 32, 64), (6, 1, 130, 80, None),
             (4 * 16, 1, 512, 128, None), (4 * 36, 1, 512, 64, None)]
    for bh, g, sl, d, window in cases:
        qf, gf = rnd(bh, sl, d), rnd(bh, sl, d, scale=1e-3)
        kf, vf = rnd(bh // g, sl, d), rnd(bh // g, sl, d)
        (qq, qab), (qk, kab), (qv, vab), (qg, gab) = (
            payload(t) for t in (qf, kf, vf, gf))
        out, lse = flash_attention.qflash_fwd_plain(
            qq, qk, qv, qab, kab, vab, g=g, window=window)
        qo, oab = payload(out)
        delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))
                 * s2fp8.dequantize(s2fp8.S2FP8Tensor(qo, oab))).sum(-1)
        args = (qq, qk, qv, qg, qab, kab, vab, gab, lse, delta)
        got = flash_attention.qflash_bwd(*args, g=g, window=window)
        want = flash_attention.qflash_bwd_plain(*args, g=g, window=window)
        errs = []
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            e = (x - y).abs().max().item()
            errs.append(e)
            assert bool(torch.isfinite(x).all()), name
            assert e <= 1e-4 * y.abs().max().item(), (name, e)
        log(f"qflash_bwd bh={bh} g={g} S={sl} d={d} window={window}: max "
            f"err dq/dk/dv {errs[0]:.2e} {errs[1]:.2e} {errs[2]:.2e} of "
            f"max |plain| " + " ".join(f"{y.abs().max().item():.2e}"
                                       for y in want))
        deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, ab)).requires_grad_()
               for t, ab in ((qq, qab), (qk, kab), (qv, vab))]
        lib_ms = None
        if g == 1 and window is None:
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *(t[None] for t in deq), is_causal=True)
            dout = s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))[None]
            lib_ms = cuda_time(lambda: torch.autograd.grad(
                lib_out, deq, dout, retain_graph=True))
        pairs = sum(min(r + 1, window or sl) for r in range(sl))
        record("qflash_bwd", max(errs),
               cuda_time(lambda: flash_attention.qflash_bwd(
                   *args, g=g, window=window)),
               cuda_time(lambda: flash_attention.qflash_bwd_plain(
                   *args, g=g, window=window), iters=3),
               lib_ms,
               2 * bh * sl * d + 2 * (bh // g) * sl * d + 8 * bh * sl
               + 3 * 4 * bh * sl * d,
               10.0 * bh * pairs * d,
               f"BH={bh} g={g} S={sl} d={d} window={window} causal",
               tensor_cores=True)


def moe_kernel_checks(dev, rnd, record) -> None:
    """The batched payload GEMM at the train-moe phase's shapes (batch 4 x
    seq 512 = 2,048 tokens, d 2048, 64 experts top-6 of width 1408,
    capacity 256 per expert).  Flash at head dim 128 is checked with the
    other flash shapes."""
    # -- qmatmul_batched: each case is (layout, Ga, Gb, out_batch, M, K, N).
    # Global routing: the gate/up einsum ecd,edf->ecf (NN, G = 64, M =
    # cap 256, K 2048, N 1408) and the down einsum ecf,efd->ecd (NN, K 1408,
    # N 2048), each with its dA (NT) and dW (TN, K = 256).  Grouped
    # routing over 4 rows (capacity 64): becd,edf->becf with B broadcast
    # (Gb = 64 of G = 256), its dA, and its dW summing the 4 row groups
    # (out_batch 64).
    # The times kept are the last case's (the gate/up forward, 2 of the 3
    # forward einsums of every MoE layer).  Tolerance as the 2-D GEMM: raw
    # |kernel - plain| <= 1e-5 * (|A| @ |B|, summed like the output) +
    # 1e-30; with the epilogue, codes at most one grid step apart in at
    # most 1e-3 of the outputs.  Library: torch.bmm (f32, no TF32) on the
    # dequantized operands, B broadcast by torch.matmul, the group sum
    # after.
    for layout, ga, gb, ob, m, k, n in GEMMS_BATCHED:
        batched_case(rnd, record, "qmatmul_batched", layout, ga, gb, ob, m,
                     k, n)


def batched_case(rnd, record, row, layout, ga, gb, ob, m, k, n,
                 keep=True) -> None:
    """One batched payload GEMM case, (layout, Ga, Gb, out_batch, M, K, N)
    on bf16 operands, held against the plain version (raw within 1e-5 *
    (|A| @ |B|) + 1e-30, epilogue codes at most one step apart in at most
    1e-3 of the outputs, two launches the same bits) and timed beside its
    bound and the library's matmul into ``row``."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import s2fp8_matmul, s2fp8_quant

    def payload(x):
        ab = s2fp8.compute_stats(x)
        return s2fp8_quant.quant_apply(x, ab), ab

    a_shape = (ga,) + ((k, m) if layout == "tn" else (m, k))
    b_shape = (gb,) + ((n, k) if layout == "nt" else (k, n))
    qa, aab = payload(rnd(*a_shape, dtype=torch.bfloat16))
    qb, bab = payload(rnd(*b_shape, dtype=torch.bfloat16, scale=k ** -0.5))
    kw = dict(layout=layout, out_batch=ob)
    raw_k = s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, **kw)
    raw_p = s2fp8_matmul.qmatmul_batched_plain(qa, aab, qb, bab, **kw)
    scale = s2fp8_matmul.qmatmul_batched_plain(
        abs_payload(qa), aab, abs_payload(qb), bab, **kw)
    err = (raw_k - raw_p).abs()
    assert bool((err <= 1e-5 * scale + 1e-30).all()), \
        f"qmatmul_batched raw {layout} {a_shape} x {b_shape}: max err " \
        f"{err.max().item()}"
    oab = s2fp8.compute_stats(raw_p)
    ek = s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, oab, **kw)
    ep = s2fp8_matmul.qmatmul_batched_plain(qa, aab, qb, bab, oab, **kw)
    f = flips(ordinal(ek, oab, "e5m2"), ordinal(ep, oab, "e5m2"))
    label = (f"{layout} G={max(ga, gb)} Ga={ga} Gb={gb} Go="
             f"{ob or max(ga, gb)} M={m} K={k} N={n} epilogue")
    log(f"{row} {label}: raw max err {err.max().item():.3e}, "
        f"epilogue flips {f}")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-3, f
    same_bits(lambda: s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, oab,
                                                   **kw),
              f"qmatmul_batched {label}")
    del raw_k, raw_p, scale, err
    deq_a = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
    deq_b = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
    lhs = deq_a.transpose(1, 2) if layout == "tn" else deq_a
    rhs = deq_b.transpose(1, 2) if layout == "nt" else deq_b
    if gb < ga:          # B broadcast over the leading groups
        lhs = lhs.reshape(ga // gb, gb, *lhs.shape[1:])

    def library():
        y = torch.matmul(lhs, rhs)
        return y.reshape(-1, ob, m, n).sum(0) if ob else y

    g = max(ga, gb)
    record(row, (ek - ep).abs().max().item(),
           cuda_time(lambda: s2fp8_matmul.qmatmul_batched(
               qa, aab, qb, bab, oab, **kw)),
           cuda_time(lambda: s2fp8_matmul.qmatmul_batched_plain(
               qa, aab, qb, bab, oab, **kw), iters=3),
           cuda_time(library),
           ga * m * k + gb * k * n + 4 * (ob or g) * m * n,
           2.0 * g * m * k * n, label, keep=keep, tensor_cores=True)


def long_kernel_checks(dev, rnd, record) -> None:
    """The kernels at the new shapes of the train-long and serve-dense
    phases, in rows of their own (the older rows keep their shapes): the
    payload flash forward and backward at train-long's attention (batch 1
    x 36 heads x 4096 tokens, head dim 64, causal), and the batched
    payload GEMM at serve-dense's decode attention (8 slots x 36 heads =
    288 groups of one query row: the scores bkgqd,bksd->bkgqs, NT with
    K 64 over N 1024 cache positions, and the values bkgqs,bksd->bkgqd, NN
    with K 1024 and N 64).  Tolerances are phase 3's for each kernel:
    flash output codes at most one step apart in at most 1% of the
    elements and |lse| within 1e-4, dq, dk, dv within 1e-4 * max|plain|;
    the GEMM's as ``batched_case``.  Library: SDPA (forward, and its
    backward through autograd) on the dequantized f32 tensors, TF32 off;
    torch.matmul for the GEMM."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import flash_attention, s2fp8_quant

    def payload(x):
        ab = s2fp8.compute_stats(x)
        return s2fp8_quant.quant_apply(x, ab), ab

    bh, sl, d = 36, FLASH_LONG_S, 64
    (qq, qab), (qk, kab), (qv, vab) = (payload(rnd(bh, sl, d))
                                       for _ in range(3))
    qg, gab = payload(rnd(bh, sl, d, scale=1e-3))
    sts = (qab, kab, vab)
    raw, lse = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(qq, qk, qv, *sts, g=1, out_ab=oab)
    op, lp = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1,
                                              out_ab=oab)
    f = flips(ordinal(ok, oab, "e5m2"), ordinal(op, oab, "e5m2"))
    lerr = (lk - lp).abs().max().item()
    log(f"qflash_fwd bh={bh} S={sl} d={d}: flips {f}, lse err {lerr:.2e}")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-2 and lerr <= 1e-4, \
        (f, lerr)
    deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, ab)).requires_grad_()
           for t, ab in ((qq, qab), (qk, kab), (qv, vab))]
    pairs = sl * (sl + 1) // 2
    shape = f"BH={bh} S={sl} d={d} causal"
    record("qflash_fwd S4096", (ok - op).abs().max().item(),
           cuda_time(lambda: flash_attention.qflash_fwd(
               qq, qk, qv, *sts, g=1, out_ab=oab)),
           cuda_time(lambda: flash_attention.qflash_fwd_plain(
               qq, qk, qv, *sts, g=1, out_ab=oab), iters=3),
           cuda_time(lambda: torch.nn.functional.scaled_dot_product_attention(
               *(t.detach()[None] for t in deq), is_causal=True)),
           3 * bh * sl * d + bh * sl * d * 4 + bh * sl * 4,
           4.0 * bh * pairs * d, shape, tensor_cores=True)
    del ok, op, lk, lp

    qo, oab = payload(raw)
    delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))
             * s2fp8.dequantize(s2fp8.S2FP8Tensor(qo, oab))).sum(-1)
    args = (qq, qk, qv, qg, qab, kab, vab, gab, lse, delta)
    got = flash_attention.qflash_bwd(*args, g=1)
    want = flash_attention.qflash_bwd_plain(*args, g=1)
    errs = []
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        e = (x - y).abs().max().item()
        errs.append(e)
        assert bool(torch.isfinite(x).all()), name
        assert e <= 1e-4 * y.abs().max().item(), (name, e)
    log(f"qflash_bwd bh={bh} S={sl} d={d}: max err dq/dk/dv "
        + " ".join(f"{e:.2e}" for e in errs) + " of max |plain| "
        + " ".join(f"{y.abs().max().item():.2e}" for y in want))
    del got, want
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *(t[None] for t in deq), is_causal=True)
    dout = s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))[None]
    record("qflash_bwd S4096", max(errs),
           cuda_time(lambda: flash_attention.qflash_bwd(*args, g=1)),
           cuda_time(lambda: flash_attention.qflash_bwd_plain(*args, g=1),
                     iters=3),
           cuda_time(lambda: torch.autograd.grad(lib_out, deq, dout,
                                                 retain_graph=True)),
           2 * bh * sl * d + 2 * bh * sl * d + 8 * bh * sl
           + 3 * 4 * bh * sl * d,
           10.0 * bh * pairs * d, shape, tensor_cores=True)
    del args, deq, lib_out, dout, raw, lse, delta
    for layout, ga, gb, ob, m, k, n in GEMMS_BATCHED_DECODE:
        batched_case(rnd, record, f"qmatmul_batched decode {layout}", layout,
                     ga, gb, ob, m, k, n)


# (row, layout, M, K, N, operand dtype) of the paper workloads' payload
# GEMMs, each list's last case the row's kept shape: ResNet-20's convs at
# batch 128 (the im2col patches [B*OH*OW, KH*KW*C] f32; the stem K = 27,
# stage 1's 3x3 K = 144 at M = 131,072, stages 2 and 3), their dA (NT over
# the kernel) and dW (TN, K = M); NCF's tower at batch 1,024 (N = 8, and
# the output GEMM's N = 1 with its NT dA at K = 1 and TN dW); ResNet's
# head (N = 10); whisper's head in training (4 x 448 rows, N = 51,865) and
# at decode (M = 4 slots: the small path)
GEMMS_PAPER = [
    ("qmatmul_nn conv", "nn", [(131072, 27, 16), (32768, 288, 32),
                               (8192, 576, 64), (131072, 144, 16)],
     torch.float32),
    ("qmatmul_nt conv", "nt", [(131072, 16, 27), (131072, 16, 144)],
     torch.float32),
    ("qmatmul_tn conv", "tn", [(27, 131072, 16), (144, 131072, 16)],
     torch.float32),
    ("qmatmul_nn ncf", "nn", [(1024, 16, 8), (1024, 16, 1)], torch.float32),
    ("qmatmul_nt ncf", "nt", [(1024, 1, 16)], torch.float32),
    ("qmatmul_tn ncf", "tn", [(16, 1024, 1)], torch.float32),
    ("qmatmul_nn head N=10", "nn", [(128, 64, 10)], torch.float32),
    ("qmatmul_nt head N=10", "nt", [(128, 10, 64)], torch.float32),
    ("qmatmul_tn head N=10", "tn", [(64, 128, 10)], torch.float32),
    ("qmatmul_nn whisper head", "nn", [(4 * 448, 1024, 51865)],
     torch.bfloat16),
    ("qmatmul_nn decode whisper head", "nn", [(4, 1024, 51865)],
     torch.bfloat16),
]
# whisper's decode self-attention on the batched GEMM: 4 slots x 16 heads,
# one query row each, over the 448-position cache of head dim 64
GEMMS_BATCHED_WHISPER = [("nt", 64, 64, None, 1, 64, 448),
                         ("nn", 64, 64, None, 1, 448, 64)]
# (row, BH, Sq, Sk, causal) of whisper's attention at batch 4 x 16 heads
# of 64: the encoder (1,500 frames, non-causal), the decoder's causal 448,
# the cross-attention in training (448 x 1,500) and at decode (1 x 1,500)
FLASH_WHISPER = [("enc S1500", 64, 1500, 1500, False),
                 ("dec S448", 64, 448, 448, True),
                 ("cross 448x1500", 64, 448, 1500, False),
                 ("cross 1x1500", 64, 1, 1500, False)]


BIG_OPERAND = 1 << 30    # elements: a larger operand is made in row chunks,
                         # and the plain version runs on slices of B's columns
CHUNK = 1 << 26          # elements a chunk


def seeded_payload(rnd, shape, dtype, scale=1.0):
    """A seeded N(0, scale^2) 2-D operand in ``dtype`` and its e5m2 payload
    under the operand's exact stats.  Above ``BIG_OPERAND`` elements
    (nemotron_4_340b's 4.72 G-element head) the draw, the stats reduction
    and the encode go in row chunks, so no f32 temporary the size of the
    operand is made; the stats are then the chunks' partial reductions
    combined."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import s2fp8_quant
    rows, cols = shape
    if rows * cols <= BIG_OPERAND:
        x = rnd(rows, cols, dtype=dtype, scale=scale)
        ab = s2fp8.compute_stats(x)
        return s2fp8_quant.quant_apply(x, ab), ab
    step = max(1, CHUNK // cols)
    x, parts = None, []
    for r in range(0, rows, step):
        piece = rnd(min(step, rows - r), cols, dtype=dtype, scale=scale)
        if x is None:
            x = torch.empty(shape, dtype=dtype, device=piece.device)
        x[r:r + step] = piece
        parts.append(s2fp8.compute_stats_partials(piece))
    sums, maxes, counts = (torch.stack(t) for t in zip(*parts))
    ab = torch.stack(s2fp8.stats_from_reduction(sums.sum(), maxes.max(),
                                                counts.sum()))
    q = torch.empty(shape, dtype=torch.float8_e5m2, device=x.device)
    for r in range(0, rows, step):
        q[r:r + step] = s2fp8_quant.quant_apply(x[r:r + step], ab)
    return q, ab


def dequantized(q, ab) -> torch.Tensor:
    """The f32 values of a 2-D payload, in row chunks above
    ``BIG_OPERAND`` elements (the plain dequantize makes several f32
    temporaries of its input's size)."""
    from repro_torch.core import s2fp8
    if q.numel() <= BIG_OPERAND:
        return s2fp8.dequantize(s2fp8.S2FP8Tensor(q, ab))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    step = max(1, CHUNK // q.shape[1])
    for r in range(0, q.shape[0], step):
        out[r:r + step] = s2fp8.dequantize(s2fp8.S2FP8Tensor(q[r:r + step],
                                                             ab))
    return out


def gemm_case(rnd, record, row, layout, m, k, n, dtype, keep=True) -> None:
    """One 2-D payload GEMM (logical C[M,N] over K under ``layout``) held
    against its plain version: raw |kernel - plain| <= 1e-5 * (|A| @ |B|)
    + 1e-30 (f32 summation order; |A| @ |B| is the plain version on the
    payloads with their sign bits cleared), epilogue codes at most one grid
    step apart in at most 1e-3 of the outputs, two launches the same bits;
    timed (device time on the small path) beside its bound and the
    library's ``torch.matmul`` on the dequantized operands into ``row``.
    Where B holds more than ``BIG_OPERAND`` elements the plain version runs
    on slices of its output columns (each column is its own product) and
    its time is the slices' sum."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import s2fp8_matmul

    kernel = getattr(s2fp8_matmul, f"qmatmul_{layout}")
    plain_gemm = (s2fp8_matmul.qmatmul_plain if layout == "nn"
                  else getattr(s2fp8_matmul, f"qmatmul_{layout}_plain"))
    a_shape = (k, m) if layout == "tn" else (m, k)
    b_shape = (n, k) if layout == "nt" else (k, n)
    qa, aab = seeded_payload(rnd, a_shape, dtype)
    qb, bab = seeded_payload(rnd, b_shape, dtype, scale=k ** -0.5)
    width = -(-n // -(-k * n // BIG_OPERAND))      # B's columns a slice
    cols = [(c, min(n, c + width)) for c in range(0, n, width)]

    def plain(a, b, out_ab=None):
        if len(cols) == 1:
            return plain_gemm(a, aab, b, bab, out_ab)
        return torch.cat([plain_gemm(a, aab, b[c0:c1] if layout == "nt"
                                     else b[:, c0:c1], bab, out_ab)
                          for c0, c1 in cols], dim=1)

    raw_k = kernel(qa, aab, qb, bab)
    raw_p = plain(qa, qb)
    err = (raw_k - raw_p).abs()
    bad = ~(err <= 1e-5 * plain(abs_payload(qa), abs_payload(qb)) + 1e-30)
    assert not bool(bad.any()), \
        f"{row} raw {m}x{k}x{n}: max err {err.max().item()}"
    raw_err = err.max().item()
    oab = s2fp8.compute_stats(raw_p)
    del raw_k, raw_p, err, bad
    ek = kernel(qa, aab, qb, bab, oab)
    ep = plain(qa, qb, oab)
    f = flips(ordinal(ek, oab, "e5m2"), ordinal(ep, oab, "e5m2"))
    log(f"{row} {layout} {m}x{k}x{n} {str(dtype)[6:]}: raw max err "
        f"{raw_err:.3e}, epilogue flips {f}")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-3, f
    err = (ek - ep).abs().max().item()
    del ek, ep
    call = lambda: kernel(qa, aab, qb, bab, oab)
    same_bits(call, f"{row} {m}x{k}x{n}")
    small = layout != "tn" and s2fp8_matmul.plan_gemm(
        m, n, k, layout=layout).path == "small"
    timer = device_ms if small else cuda_time
    t_kernel = timer(call)
    t_plain = timer(lambda: plain(qa, qb, oab), iters=3)
    deq_a, deq_b = dequantized(qa, aab), dequantized(qb, bab)
    lhs = deq_a.t() if layout == "tn" else deq_a
    rhs = deq_b.t() if layout == "nt" else deq_b
    record(row, err, t_kernel, t_plain, timer(lambda: torch.matmul(lhs, rhs)),
           m * k + k * n + 4 * m * n, 2.0 * m * k * n,
           f"{layout} M={m} K={k} N={n} epilogue"
           + (f" (plain over {len(cols)} column slices)" if len(cols) > 1
              else ""), keep=keep, tensor_cores=not small,
           **({"call_ms": cuda_time(call)} if small else {}))


def paper_kernel_checks(dev, rnd, record) -> None:
    """The kernels at the shapes the paper workloads give them (whisper at
    batch 4 x 1,500 frames and 448 tokens, ResNet-20 at batch 128, NCF at
    batch 1,024), in rows of their own: the payload GEMMs of
    ``GEMMS_PAPER`` (``gemm_case``), whisper's decode self-attention on
    the batched GEMM (``batched_case``), and the payload flash forward and
    backward at whisper's four attention shapes, non-causal ones and Sq !=
    Sk included, the plain versions in chunks that divide the sequences
    (500 at 1,500 frames) (the tolerances of the other flash rows: output codes at
    most one step apart in at most 1% of the elements, |lse| within 1e-4,
    dq, dk, dv within 1e-4 * max|plain|; two launches the same bits;
    library SDPA on the dequantized f32 tensors, TF32 off).  Checked and
    logged without rows of their own: quantize-apply on the stem's im2col
    patches ([128*32*32, 27] f32: codes equal to the plain version's),
    truncate-apply on NCF's tables at ML-1M's sizes (one step in at most
    1e-4), and the stats and quantize-with-stats kernels on whisper's
    activations ([4*1500, 1024] bf16; max and count equal, sum within
    1e-6 relative, (alpha, beta) within 4 ulp, codes one step apart in at
    most 1e-4)."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import flash_attention, s2fp8_quant

    def payload(x):
        ab = s2fp8.compute_stats(x)
        return s2fp8_quant.quant_apply(x, ab), ab

    for row, layout, shapes, dtype in GEMMS_PAPER:
        for i, (m, k, n) in enumerate(shapes):
            gemm_case(rnd, record, row, layout, m, k, n, dtype,
                      keep=i == len(shapes) - 1)
    for layout, ga, gb, ob, m, k, n in GEMMS_BATCHED_WHISPER:
        batched_case(rnd, record, f"qmatmul_batched decode whisper {layout}",
                     layout, ga, gb, ob, m, k, n)

    def chunk(n):
        """The largest divisor of ``n`` up to 512: the plain flash loop
        takes gcd(512, n) otherwise, 4 at 1,500 (140,625 chunk pairs)."""
        return max(c for c in range(1, min(n, 512) + 1) if n % c == 0)

    d = 64
    for label, bh, sq, sk, causal in FLASH_WHISPER:
        ck = dict(q_chunk=chunk(sq), kv_chunk=chunk(sk))
        (qq, qab) = payload(rnd(bh, sq, d))
        (qk, kab), (qv, vab) = (payload(rnd(bh, sk, d)) for _ in range(2))
        sts = (qab, kab, vab)
        raw, lse = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1,
                                                    causal=causal, **ck)
        oab = s2fp8.compute_stats(raw)
        call = lambda: flash_attention.qflash_fwd(
            qq, qk, qv, *sts, g=1, causal=causal, out_ab=oab)
        ok, lk = call()
        op, lp = flash_attention.qflash_fwd_plain(
            qq, qk, qv, *sts, g=1, causal=causal, out_ab=oab, **ck)
        f = flips(ordinal(ok, oab, "e5m2"), ordinal(op, oab, "e5m2"))
        lerr = (lk - lp).abs().max().item()
        log(f"qflash_fwd whisper {label} (BH={bh}, causal {causal}): flips "
            f"{f}, lse err {lerr:.2e}")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-2 and lerr <= 1e-4, \
            (label, f, lerr)
        assert torch.equal(call()[0], ok), f"qflash_fwd {label}: two launches"
        deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, ab)).requires_grad_()
               for t, ab in ((qq, qab), (qk, kab), (qv, vab))]
        pairs = (sum(min(r + 1 + sk - sq, sk) for r in range(sq)) if causal
                 else sq * sk)
        shape = f"BH={bh} Sq={sq} Sk={sk} d={d} " + (
            "causal" if causal else "non-causal")
        record(f"qflash_fwd {label}", (ok - op).abs().max().item(),
               cuda_time(call),
               cuda_time(lambda: flash_attention.qflash_fwd_plain(
                   qq, qk, qv, *sts, g=1, causal=causal, out_ab=oab, **ck),
                   iters=3),
               cuda_time(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             *(t.detach()[None] for t in deq),
                             is_causal=causal)),
               bh * (sq + 2 * sk) * d + bh * sq * d * 4 + bh * sq * 4,
               4.0 * bh * pairs * d, shape, tensor_cores=True)
        if sq == 1:
            continue
        qg, gab = payload(rnd(bh, sq, d, scale=1e-3))
        qo, oab2 = payload(raw)
        delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))
                 * s2fp8.dequantize(s2fp8.S2FP8Tensor(qo, oab2))).sum(-1)
        args = (qq, qk, qv, qg, qab, kab, vab, gab, lse, delta)
        got = flash_attention.qflash_bwd(*args, g=1, causal=causal)
        want = flash_attention.qflash_bwd_plain(*args, g=1, causal=causal,
                                                **ck)
        errs = []
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            e = (x - y).abs().max().item()
            errs.append(e)
            assert bool(torch.isfinite(x).all()), (label, name)
            assert e <= 1e-4 * y.abs().max().item(), (label, name, e)
        again = flash_attention.qflash_bwd(*args, g=1, causal=causal)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), \
            f"qflash_bwd {label}: two launches differ"
        log(f"qflash_bwd whisper {label}: max err dq/dk/dv "
            + " ".join(f"{e:.2e}" for e in errs) + " of max |plain| "
            + " ".join(f"{y.abs().max().item():.2e}" for y in want))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *(t[None] for t in deq), is_causal=causal)
        dout = s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))[None]
        record(f"qflash_bwd {label}", max(errs),
               cuda_time(lambda: flash_attention.qflash_bwd(
                   *args, g=1, causal=causal)),
               cuda_time(lambda: flash_attention.qflash_bwd_plain(
                   *args, g=1, causal=causal, **ck), iters=3),
               cuda_time(lambda: torch.autograd.grad(lib_out, deq, dout,
                                                     retain_graph=True)),
               2 * bh * sq * d + 2 * bh * sk * d + 8 * bh * sq
               + 4 * bh * (sq + 2 * sk) * d,
               10.0 * bh * pairs * d, shape, tensor_cores=True)
        del got, want, again, lib_out, dout, args, deq

    # -- the element-wise kernels at the paper paths' new operands
    x = rnd(128 * 32 * 32, 27)
    ab = s2fp8.compute_stats(x)
    f = flips(code_ordinal(s2fp8_quant.quant_apply(x, ab)),
              code_ordinal(s2fp8_quant.quant_apply_plain(x, ab)))
    log(f"quant_apply im2col patches {tuple(x.shape)} f32: flips {f}")
    assert f["max_step"] == 0, f
    for shape in ((6040, 32), (3706, 8)):
        x = rnd(*shape, scale=0.01)
        ab = s2fp8.compute_stats(x)
        tk = s2fp8_quant.truncate_apply(x, ab)
        tp = s2fp8_quant.truncate_apply_plain(x, ab)
        f = flips(ordinal(tk, ab, "e5m2"), ordinal(tp, ab, "e5m2"))
        log(f"truncate_apply ncf table {shape} f32: flips {f}")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
    x = rnd(4 * 1500, 1024, dtype=torch.bfloat16)
    tk, abk = s2fp8_quant.stats_partials(x)
    tp, abp = s2fp8_quant.stats_partials_plain(x)
    rel = ((tk[0] - tp[0]).abs() / tp[0].abs()).item()
    u = ulps(abk, abp)
    log(f"stats whisper activation {tuple(x.shape)} bf16: max/count equal "
        f"{bool(torch.equal(tk[1:], tp[1:]))}, sum rel err {rel:.2e}, "
        f"(alpha, beta) {u} ulp apart")
    assert torch.equal(tk[1:], tp[1:]) and rel <= 1e-6 and u <= 4
    pk, qab = s2fp8_quant.quant(x)
    pp, qabp = s2fp8_quant.quant_plain(x)
    f = flips(code_ordinal(pk), code_ordinal(pp))
    log(f"quant whisper activation: flips {f}, (alpha, beta) "
        f"{ulps(qab, qabp)} ulp apart")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-4 and ulps(qab, qabp) <= 4


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two f32
    tensors of the same signs."""
    d = (a.float().view(torch.int32).long()
         - b.float().view(torch.int32).long()).abs()
    return int(d.max().item()) if d.numel() else 0


def stats_kernel_checks(dev, rnd, record) -> None:
    """The stats kernels at the exact-stats path's tensors (train-exact and
    train-fig4: batch 4 x seq 512 = 2,048 tokens of minicpm_2b): the tied
    embedding table (122,753 x 2,304 f32, truncated at the embed site), the
    fig4 head logits (2,048 x 122,753 f32), a bf16 activation (2,048 x
    2,304, a GEMM operand) and a GEMM output (2,048 x 5,760 f32).  Each
    kernel runs on every shape; the CUDA-event times kept are stats on the
    GEMM output, quantize-with-stats on the activation, the fused truncate
    on the embedding table, and beside them the device time with the L2
    flushed at each one's most frequent call on its path: the GEMM output,
    the activation, and (train-fig4) the activation.  Beside the stats
    kernel, the cuda engine's torch reduction of the same stats
    (``s2fp8.compute_stats``) is timed.

    Tolerances: the stats' max and nonzero count equal to the plain
    version's, the sum within 1e-6 relative (f64 sums in another order),
    alpha and beta within 4 ulp; payload and truncated codes at most one
    grid step apart in at most 1e-4 of the elements (the maps round each
    step alike; the allowance is for an ulp of the stats); the stats
    kernel gives the same bits twice; quantize-with-stats and the fused
    truncate equal quantize-apply and truncate-apply under the stats
    kernel's (alpha, beta), bit for bit; on the GEMM output one call of
    each launches one kernel (torch.profiler).  Then the all-zero, constant
    and NaN-bearing cases."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import s2fp8_quant as sq

    emb = ("embedding table", (122753, 2304), torch.float32, 0.05)
    logits = ("fig4 head logits", (2048, 122753), torch.float32, 3.0)
    act = ("bf16 activation", (2048, 2304), torch.bfloat16, 1.0)
    out = ("GEMM output", (2048, 5760), torch.float32, 0.3)
    main = {"stats": out, "quant": act, "truncate_fused": emb}
    path = {"stats": out, "quant": act, "truncate_fused": act}
    u8 = torch.uint8
    for case in (emb, logits, act, out):
        label, shape, dtype, scale = case
        x = rnd(*shape, dtype=dtype, scale=scale)
        n, elt = x.numel(), x.element_size()
        tag = f"{label} {shape} {str(dtype)[6:]}"
        tk, abk = sq.stats_partials(x)
        tp, abp = sq.stats_partials_plain(x)
        srel = ((tk[0] - tp[0]).abs() / tp[0].abs()).item()
        u = ulps(abk, abp)
        tk2, abk2 = sq.stats_partials(x)
        log(f"stats {tag}: kernel {tk.tolist()} {abk.tolist()}, plain "
            f"{tp.tolist()} {abp.tolist()}: sum rel err {srel:.2e}, "
            f"(alpha, beta) {u} ulp")
        assert torch.equal(tk[1:], tp[1:]), (tk, tp)
        assert srel <= 1e-6 and u <= 4, (srel, u)
        assert torch.equal(tk, tk2) and torch.equal(abk, abk2)
        record("stats", (abk - abp).abs().max().item(),
               cuda_time(lambda: sq.stats_partials(x)),
               cuda_time(lambda: sq.stats_partials_plain(x), iters=3), None,
               n * elt + 20, 0, tag, keep=case is main["stats"],
               path_ms=device_ms(lambda: sq.stats_partials(x), cold=True),
               on_path=case is path["stats"],
               torch_reduction_ms=cuda_time(lambda: s2fp8.compute_stats(x),
                                            iters=3))

        if case is path["stats"]:
            # one launch a call each: the stats kernel, and quantize-with-
            # stats and the fused truncate one cooperative kernel each
            for name, fn, want in (
                    ("stats", lambda: sq.stats_partials(x), "stats_kernel"),
                    ("quant", lambda: sq.quant(x), "quant_fused_kernel"),
                    ("truncate_fused", lambda: sq.truncate_fused(x),
                     "truncate_fused_kernel")):
                got = kernels_per_call(fn)
                log(f"{name} {tag}: kernels per call {got}")
                assert got == {want: 1.0}, (name, got)

        pk, qab = sq.quant(x)
        assert torch.equal(qab, abk)
        assert torch.equal(pk.view(u8), sq.quant_apply(x, abk).view(u8))
        pp, pab = sq.quant_plain(x)
        f = flips(code_ordinal(pk), code_ordinal(pp))
        log(f"quant {tag}: codes against the plain version {f}; equal to "
            f"quant_apply under the stats kernel's (alpha, beta)")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
        err = (s2fp8.dequantize(s2fp8.S2FP8Tensor(pk, qab))
               - s2fp8.dequantize(s2fp8.S2FP8Tensor(pp, pab))).abs().max()
        del pp
        record("quant", err.item(), cuda_time(lambda: sq.quant(x)),
               cuda_time(lambda: sq.quant_plain(x), iters=3), None,
               n * (elt + 1) + 8, 0, tag, keep=case is main["quant"],
               path_ms=device_ms(lambda: sq.quant(x), cold=True),
               on_path=case is path["quant"])
        del pk

        ok, oab = sq.truncate_fused(x)
        assert ok.dtype == dtype and torch.equal(oab, abk)
        assert torch.equal(ok, sq.truncate_apply(x, abk)), \
            "truncate_fused differs from truncate_apply(x, stats(x))"
        same_bits(lambda: torch.cat([t.flatten().view(torch.uint8) for t in
                                     sq.truncate_fused(x)]),
                  f"truncate_fused {tag}")
        op, _ = sq.truncate_fused_plain(x)
        f = flips(ordinal(ok, abk, "e5m2"), ordinal(op, abk, "e5m2"))
        log(f"truncate_fused {tag}: codes against the plain version {f}; "
            f"bit-equal to truncate_apply(x, stats(x))")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
        err = (ok.float() - op.float()).abs().max().item()
        del ok, op
        record("truncate_fused", err, cuda_time(lambda: sq.truncate_fused(x)),
               cuda_time(lambda: sq.truncate_fused_plain(x), iters=3), None,
               2 * n * elt + 8, 0, tag, keep=case is main["truncate_fused"],
               path_ms=device_ms(lambda: sq.truncate_fused(x), cold=True),
               on_path=case is path["truncate_fused"])
        del x

    z = torch.zeros(4096, 33, device=dev)
    tk, ab = sq.stats_partials(z)
    assert tk.tolist() == [0.0, -math.inf, 0.0] and ab.tolist() == [1, 0]
    zo, zab = sq.truncate_fused(z)
    zp, zpab = sq.quant(z)
    assert zab.tolist() == [1, 0] and zpab.tolist() == [1, 0]
    assert not zo.any() and not zp.view(u8).any()
    c = torch.full((300, 77), 2.75, device=dev)
    co, cab = sq.truncate_fused(c)
    assert torch.equal(cab, sq.truncate_fused_plain(c)[1])
    assert (co - 2.75).abs().max().item() <= 2.75e-2, co.unique()
    x = rnd(513, 129)
    x[::3, ::5] = math.nan
    tk, abk = sq.stats_partials(x)
    tz, abz = sq.stats_partials(torch.nan_to_num(x, nan=0.0))
    assert torch.equal(tk, tz) and torch.equal(abk, abz)
    xo, _ = sq.truncate_fused(x)
    f = flips(ordinal(xo, abk, "e5m2"),
              ordinal(sq.truncate_fused_plain(x)[0], abk, "e5m2"))
    assert not xo.isnan().any() and f["max_step"] <= 1 \
        and f["frac"] <= 1e-4, f
    log(f"stats kernels, degenerate inputs: zeros -> (1, 0) and zeros; "
        f"constant 2.75 -> {co.unique().tolist()}; NaNs left out of the "
        f"stats ({int(tk[2].item())} of {x.numel()} counted), truncated "
        f"to 0")


def abs_payload(p: torch.Tensor) -> torch.Tensor:
    """The payload of |x| (sign bit cleared): with the same stats it
    dequantizes to the absolute values."""
    return (p.view(torch.uint8) & 0x7F).view(p.dtype)


# ---------------------------------------------------------------------------
# phase 4: the same slice on the card, cuda engine vs plain engine (small)
# ---------------------------------------------------------------------------

def phase_small_reference(dev) -> None:
    """Reduced minicpm_2b (2 layers, d=128) served on the card twice, once
    through the kernels (cuda engine) and once through plain PyTorch
    (plain engine), from one seeded bank: the same greedy tokens, and at
    every prefill and decode step per-step logits of live rows within
    max |diff| <= 0.1, mean <= 0.02 (kernel and plain version differ only
    by f32 summation order, which flips a rare output code; the CPU tests
    bound the port against JAX the same way), and finite."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    params = tlm.init_lm(cfg, seed=1, device=dev)
    rng = np.random.default_rng(1)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)), device=dev)
    bank = calibrate_serving_bank(params, cfg,
                                  make_policy("s2fp8", "plain", "payload"),
                                  calib, passes=2)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 11, 30, 17)]
    runs = {}
    for engine in ("cuda", "plain"):
        srv = PayloadLMServer(cfg, params,
                              make_policy("s2fp8", engine, "payload"),
                              bank=bank, slots=4, max_len=64, block=8)
        steps = []
        prefill, decode = srv._prefill, srv._decode

        def p(params_, tokens, last, _s=steps, _f=prefill):
            out = _f(params_, tokens, last)
            live = (tokens != 0).any(dim=1)
            _s.append(out[0][live].float())
            return out

        def d(*args, _s=steps, _f=decode, _srv=srv):
            live = torch.tensor([r is not None for r in _srv.slot_req])
            out = _f(*args)
            _s.append(out[0][live.to(out[0].device)].float())
            return out

        srv._prefill, srv._decode = p, d
        reqs = [Request(prompt=x, max_new_tokens=6) for x in prompts]
        for r in reqs:
            srv.submit(r)
        srv.run_to_completion()
        runs[engine] = ([r.out for r in reqs], steps)
    (tk, sk), (tp, sp) = runs["cuda"], runs["plain"]
    same = sum(a == b for ra, rb in zip(tk, tp) for a, b in zip(ra, rb))
    log(f"small reference: tokens cuda {tk} plain {tp} "
        f"({same}/{sum(len(r) for r in tk)} equal)")
    assert tk == tp, "cuda and plain engines chose different tokens"
    assert len(sk) == len(sp), (len(sk), len(sp))
    for i in range(len(sk)):
        assert sk[i].shape == sp[i].shape, (i, sk[i].shape, sp[i].shape)
        dlt = (sk[i] - sp[i]).abs()
        assert bool(torch.isfinite(sk[i]).all())
        log(f"small reference step {i}: max {dlt.max().item():.4f} "
            f"mean {dlt.mean().item():.5f}")
        assert dlt.max().item() <= 0.1 and dlt.mean().item() <= 0.02


@contextlib.contextmanager
def counted_decode_attention():
    """Counts ``blocks.decode_attention`` calls while the block is open;
    yields a one-element list."""
    from repro_torch.models import blocks
    fn, n = blocks.decode_attention, [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return fn(*args, **kwargs)

    blocks.decode_attention = counting
    try:
        yield n
    finally:
        blocks.decode_attention = fn


def record_steps(server, store, kinds, choices=None):
    """Wrap a server's prefill / decode so each step keeps its live rows'
    f32 logits in ``store`` and its kind ("p" or "d") in ``kinds``; with
    ``choices`` (one tensor of live rows' tokens a step), each step then
    takes its next tokens from them instead of its own argmax, so two
    engines serve the same histories."""
    prefill, decode = server._prefill, server._decode
    it = None if choices is None else iter(choices)

    def keep(out, live, kind):
        store.append(out[0][live].float()[:, -1])
        kinds.append(kind)
        if it is None:
            return out
        forced = torch.zeros(out[0].shape, dtype=torch.float32,
                             device=out[0].device)
        forced[live.nonzero()[:, 0], -1, next(it)] = 1.0
        return forced, out[1]

    def p(params_, tokens, last):
        return keep(prefill(params_, tokens, last), (tokens != 0).any(dim=1),
                    "p")

    def d(*args):
        live = torch.tensor([r is not None for r in server.slot_req],
                            device=args[1].device)
        return keep(decode(*args), live, "d")

    server._prefill, server._decode = p, d


# (reduced arch, layers, per-step logit bound max / mean, near-tie margin)
FORMAT_MODELS = (("minicpm_2b", 2, 0.1, 0.02, 0.1),
                 ("deepseek_moe_16b", 3, 0.75, 0.15, 0.2))
FORMAT_SLOTS = 4         # small-formats' slots: 8 requests in two waves


def phase_small_formats(dev) -> None:
    """The five paged-cache formats on reduced minicpm_2b and reduced
    deepseek_moe_16b (dense_first + 2 moe), one bank calibrated by each
    model's decode-probing calibration.  (1) After one admission's pack
    on the cuda engine, the f32_e5m2 / f32_e4m3 pools hold the dequantize
    kernel's image of the e5m2 / e4m3 pools bit for bit (every block but
    the trash block).  (2) Each format
    serves 8 requests (prompts 3-30, 6 new tokens, 4 slots, block 8) on
    the checked engine, every kernel call held against its plain version
    (``checked_engine``'s tolerances), then on the plain engine teacher-forced along
    the checked run's tokens: every step's logits within the model's
    bound (dense 0.1 / 0.02 as the small reference; MoE 0.75 / 0.15, a
    token that changes experts), the plain engine's own choice the
    kernels' except at a near tie (top-2 margin at most 0.1, MoE 0.2); the
    payload pools decode through the paged-decode kernel and never through
    ``decode_attention``, the f32 pools through ``decode_attention``."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.policy import make_policy
    from repro_torch.launch import api
    from repro_torch.serving import paged_cache
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    for arch, layers, lim_max, lim_mean, near in FORMAT_MODELS:
        cfg = get_reduced_config(arch).replace(n_layers=layers)
        params = api.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(1)
        calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                device=dev)
        bank = calibrate_serving_bank(
            params, cfg, make_policy("s2fp8", "plain", "payload"), calib,
            passes=2)
        prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
                   for n in (5, 11, 30, 17, 9, 24, 3, 14)]

        def server(pol, fmt):
            srv = PayloadLMServer(cfg, params, pol, bank=bank,
                                  slots=FORMAT_SLOTS, max_len=64, block=8,
                                  cache_fmt=fmt)
            reqs = [Request(prompt=x, max_new_tokens=6) for x in prompts]
            for r in reqs:
                srv.submit(r)
            return srv, reqs

        cuda = make_policy("s2fp8")
        for fmt in ("e5m2", "e4m3"):
            pools = {}
            for cf in (fmt, f"f32_{fmt}"):
                srv, _ = server(cuda, cf)
                assert srv._admit() == FORMAT_SLOTS
                pools[cf] = srv.caches
            # block 0 is the trash block: dummy rows' duplicate writes land
            # there in no fixed order, and nothing reads it unmasked
            for sp, sf in zip(pools[fmt], pools[f"f32_{fmt}"]):
                for pool, ab in (("kp", "kab"), ("vp", "vab")):
                    for li in range(sp[pool].shape[0]):
                        want = paged_cache._decode(sp[pool][li, 1:],
                                                   sp[ab][li], fmt,
                                                   cuda.backend_obj)
                        assert torch.equal(sf[pool][li, 1:], want), (
                            arch, fmt, pool, li)
        log(f"small formats {arch}: f32_e5m2 / f32_e4m3 pools == dequant "
            f"kernel of the payload pools, bit for bit")

        for cf in paged_cache.CACHE_FMTS:
            with checked_engine() as tally, counted_decode_attention() as n:
                srv, reqs = server(make_policy("s2fp8", "checked",
                                               "payload"), cf)
                kern, kinds = [], []
                record_steps(srv, kern, kinds)
                srv.run_to_completion()
                toks = [r.out for r in reqs]
                n_attn = n[0]
            assert all(len(t) == 6 for t in toks), (arch, cf, toks)
            want = (0 if paged_cache.is_payload(cf)
                    else cfg.n_layers * kinds.count("d"))
            assert n_attn == want, (arch, cf, n_attn, want)
            srv, reqs = server(make_policy("s2fp8", "plain", "payload"), cf)
            plain = []
            record_steps(srv, plain, [], [k.argmax(dim=-1) for k in kern])
            srv.run_to_completion()
            assert [r.out for r in reqs] == toks
            assert len(plain) == len(kern)
            flips = 0
            for i, (a, b) in enumerate(zip(kern, plain)):
                dlt = (a - b).abs()
                assert bool(torch.isfinite(a).all())
                assert dlt.max().item() <= lim_max and \
                    dlt.mean().item() <= lim_mean, (arch, cf, i,
                                                    dlt.max().item())
                top2 = a.topk(2, dim=-1).values
                for r in range(a.shape[0]):
                    if a[r].argmax() != b[r].argmax():
                        flips += 1
                        assert (top2[r, 0] - top2[r, 1]).item() <= near, (
                            arch, cf, i, r)
            calls = sum(t["calls"] for t in tally.values())
            log(f"small formats {arch} {cf}: tokens {toks[0]}..., "
                f"{len(kern)} steps, {calls} kernel calls held, "
                f"decode_attention calls {n_attn}, plain choices that "
                f"differ {flips}")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int):
    """(rng, calibration tokens [2, 64], 16 prompt lengths in 64..700) of
    phase 5's serve run, from seed 0; the rng goes on to draw the
    prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    calib = rng.integers(0, vocab, (2, 64))
    return rng, calib, rng.integers(64, 701, 16)


def phase_serve(dev) -> dict:
    """Full-width minicpm_2b through the port's entry points: seeded
    params, calibrate_serving_bank, PayloadLMServer.  Returns the kernel
    launch counts of this phase and its metrics."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    cfg = get_config("minicpm_2b")
    pol = make_policy("s2fp8")
    t0 = time.perf_counter()
    params = tlm.init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve: minicpm_2b {cfg.n_layers} layers, d={cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.n_params() / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng, calib_tokens, prompt_lens = serve_prompts(cfg.vocab)
    calib = torch.as_tensor(calib_tokens, device=dev)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32), max_new_tokens=32)
            for n in prompt_lens]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    t0 = time.perf_counter()
    bank = calibrate_serving_bank(params, cfg, pol, calib, passes=2)
    torch.cuda.synchronize()
    t_calib = time.perf_counter() - t0
    server = PayloadLMServer(cfg, params, pol, bank=bank, slots=8,
                             max_len=1024, block=16, cache_fmt="e5m2")
    timing = {"prefill": [], "decode": []}
    prefill, decode = server._prefill, server._decode

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*args)
            assert bool(torch.isfinite(out[0].float()).all()), kind
            torch.cuda.synchronize()
            timing[kind].append((time.perf_counter() - ts) * 1e3)
            return out
        return run

    server._prefill = timed("prefill", prefill)
    server._decode = timed("decode", decode)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    pool_b, stats_b = server.cache_bytes()

    for r in reqs:
        assert len(r.out) == 32, ("request did not complete", len(r.out))
        assert all(0 <= t < cfg.vocab for t in r.out)
    check_counts(counts, SERVE_KERNELS + tuple(SMALL_PATH.values()))
    tokens = sum(len(r.out) for r in reqs)
    metrics = {
        "requests": len(reqs), "tokens": tokens, "ticks": ticks,
        "prompt_tokens": int(prompt_lens.sum()),
        "wall_s": wall, "tok_per_s": tokens / wall,
        "calibrate_s": t_calib,
        "prefill_calls": len(timing["prefill"]),
        "prefill_ms_mean": float(np.mean(timing["prefill"])),
        "prefill_ms_total": float(np.sum(timing["prefill"])),
        "decode_ticks": len(timing["decode"]),
        "decode_ms_median": float(np.median(timing["decode"])),
        "decode_ms_mean": float(np.mean(timing["decode"])),
        "prefill_shapes": sorted(server.prefill_shapes),
        "preemptions": server.preemptions,
        "max_memory_allocated_gb": peak / 1e9,
        "pool_bytes": pool_b, "pool_stats_bytes": stats_b,
    }
    log("serve metrics: " + json.dumps(metrics))
    log("serve launches: " + json.dumps(counts))
    for i, r in enumerate(reqs[:2]):
        log(f"  req{i} ({len(r.prompt)} prompt tokens): {r.out[:8]}...")
    return {"counts": counts, "metrics": metrics, "server": server}


SERVE_MOE_LAYERS = 28        # deepseek_moe_16b's full depth


def phase_serve_moe(dev, profile: bool = False) -> dict:
    """Full-width deepseek_moe_16b (d 2048, 16 heads of 128, 64 routed
    experts top-6 + 2 shared of width 1408, a dense_first layer of d_ff
    10,944, vocab 102,400) at ``SERVE_MOE_LAYERS`` layers from seed 0,
    served by ``serve_payload_run`` with 16 requests, 32 new tokens and a
    JSONL sink: the batched payload GEMM among the kernels that must
    launch.  With ``profile``, then profiles the server as
    ``phase_profile`` does."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    cfg = get_config("deepseek_moe_16b")
    if SERVE_MOE_LAYERS < cfg.n_layers:
        cfg = cut_depth(cfg, SERVE_MOE_LAYERS)
    return serve_payload_run(
        dev, "serve-moe", cfg, SERVE_MOE_KERNELS, requests=16,
        new_tokens=32, sink=True, profile=profile,
        detail=f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
               f"{cfg.moe.n_shared} shared")


def serve_payload_run(dev, label, cfg, expected, *, requests: int,
                      new_tokens: int, sink: bool = False,
                      profile: bool = False, detail: str = "",
                      backend: str = "cuda") -> dict:
    """``cfg`` from seed 0, s2fp8 on the ``backend`` engine, through the
    entry points a user calls:
    ``api.init_params``, ``calibrate_serving_bank`` (prefill and decode
    probes) on phase 5's calibration tokens, then ``PayloadLMServer``: 8
    slots, the first ``requests`` of phase 5's prompt lengths (64-700),
    ``new_tokens`` each, max_len 1024, block 16, an e5m2 pool (with
    ``sink``, a JSONL sink in a temporary directory, which must hold one
    ``serving_tick`` event a tick).  Every request completes with
    in-vocabulary tokens, every kernel of ``expected`` launches, no plain
    version runs, and the payload pool never decodes through
    ``decode_attention``.  Returns the launch counts and metrics (tok/s,
    prefill ms, decode ms a tick, calibration s, peak device memory)."""
    import tempfile

    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.policy import make_policy
    from repro_torch.launch import api
    from repro_torch.obs.sinks import JsonlSink
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    pol = make_policy("s2fp8", backend)
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name} {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim} on {cfg.kv_heads} "
        f"K/V heads, {cfg.activation}, {cfg.norm} norm, "
        + (f"{detail}, " if detail else "")
        + f"engine {pol.backend_obj.name}, "
        + f"vocab {cfg.vocab}, {cfg.n_params() / 1e9:.3f} B params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng, calib_tokens, prompt_lens = serve_prompts(cfg.vocab)
    prompt_lens = prompt_lens[:requests]
    calib = torch.as_tensor(calib_tokens, device=dev)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32),
                    max_new_tokens=new_tokens)
            for n in prompt_lens]

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ticks.jsonl"
        tick_sink = JsonlSink(str(path)) if sink else None
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()                    # the main path starts here
        t0 = time.perf_counter()
        bank = calibrate_serving_bank(params, cfg, pol, calib, passes=2)
        torch.cuda.synchronize()
        t_calib = time.perf_counter() - t0
        server = PayloadLMServer(cfg, params, pol, bank=bank, slots=8,
                                 max_len=1024, block=16, cache_fmt="e5m2",
                                 sink=tick_sink)
        timing = {"prefill": [], "decode": []}
        prefill, decode = server._prefill, server._decode

        def timed(kind, fn):
            def run(*args):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                out = fn(*args)
                assert bool(torch.isfinite(out[0].float()).all()), kind
                torch.cuda.synchronize()
                timing[kind].append((time.perf_counter() - ts) * 1e3)
                return out
            return run

        server._prefill = timed("prefill", prefill)
        server._decode = timed("decode", decode)
        for r in reqs:
            server.submit(r)
        with counted_decode_attention() as n_attn:
            t0 = time.perf_counter()
            ticks = server.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = path_counts()                    # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        events = []
        if sink:
            tick_sink.close()
            events = [json.loads(line)
                      for line in path.read_text().splitlines()]
    pool_b, stats_b = server.cache_bytes()

    for r in reqs:
        assert len(r.out) == new_tokens, ("request did not complete",
                                          len(r.out))
        assert all(0 <= t < cfg.vocab for t in r.out)
    if sink:
        assert len(events) == ticks and all(
            e["event"] == "serving_tick" for e in events), (len(events),
                                                            ticks)
        assert [e["tick"] for e in events] == list(range(1, ticks + 1))
    assert n_attn[0] == 0, "a payload pool decoded through decode_attention"
    check_counts(counts, expected)
    tokens = sum(len(r.out) for r in reqs)
    metrics = {
        "layers": cfg.n_layers, "params": cfg.n_params(),
        "requests": len(reqs), "tokens": tokens, "ticks": ticks,
        "prompt_tokens": int(prompt_lens.sum()),
        "wall_s": wall, "tok_per_s": tokens / wall,
        "calibrate_s": t_calib,
        "prefill_calls": len(timing["prefill"]),
        "prefill_ms_mean": float(np.mean(timing["prefill"])),
        "prefill_ms_total": float(np.sum(timing["prefill"])),
        "decode_ticks": len(timing["decode"]),
        "decode_ms_median": float(np.median(timing["decode"])),
        "decode_ms_mean": float(np.mean(timing["decode"])),
        "prefill_shapes": sorted(server.prefill_shapes),
        "preemptions": server.preemptions,
        "sink_events": len(events),
        "max_memory_allocated_gb": peak / 1e9,
        "pool_bytes": pool_b, "pool_stats_bytes": stats_b,
    }
    log(f"{label} metrics: " + json.dumps(metrics))
    log(f"{label} launches: " + json.dumps(counts))
    for i, r in enumerate(reqs[:2]):
        log(f"  req{i} ({len(r.prompt)} prompt tokens): {r.out[:8]}...")
    if profile:
        server.sink = None
        phase_profile(server)
    return {"counts": counts, "metrics": metrics}


def check_counts(counts: dict, launched) -> None:
    """Every kernel in ``launched`` ran, and no plain version did."""
    for name, c in counts.items():
        assert c["plain_calls"] == 0, f"plain {name} ran: {counts}"
    for name in launched:
        assert counts[name]["launches"] > 0, \
            f"kernel {name} never launched: {counts}"


def _lm_loss(cfg):
    from repro_torch.models import transformer as tlm

    def loss_fn(params, batch, policy):
        return tlm.loss_fn(params, batch["tokens"], batch["labels"], cfg,
                           policy)
    return loss_fn


def _bank_grads(loss_fn, params, batch, pol, bank, step, stats):
    """Gradients of every param leaf at ``step`` over ``bank``, as the train
    step takes them, and the bank that step would return."""
    from repro_torch.core import statsbank
    from repro_torch.optim.optimizers import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with statsbank.bind(bank, step, stats) as sess:
        loss, _ = loss_fn(params, batch, pol)
        grads = torch.autograd.grad(loss, leaves)
    return grads, statsbank.merge_updates(bank, sess.updates)


def raw_tol(k: int) -> float:
    """The checked engine's raw-GEMM tolerance at depth ``k``, in units of
    |A| @ |B|: 1e-5 (phase 3's, on random operands), or eight times the
    probabilistic rounding sqrt(k) 2^-24 of a k-term f32 sum where that is
    larger, capped at ``RAW_TOL_CAP``."""
    return max(1e-5, min(8.0 * math.sqrt(k) * 2.0 ** -24, RAW_TOL_CAP))


# about three times the worst a sound kernel reached in the full-width
# checked steps on the H100 (1.38e-5 at the tied head's K 122,753; 1.07e-5
# at a gemma3 dW's K 2,048, where the rounding term gives 2.16e-5)
RAW_TOL_CAP = 4e-5


def raw_close(y, ref, absref, k):
    """|y - ref| <= raw_tol(k) * (|A| @ |B|) + 1e-30 everywhere; (ok,
    (worst |y - ref| / (|A| @ |B|), the tolerance, k, max |y - ref|))."""
    tol = raw_tol(k)
    err = (y - ref).abs()
    worst = float((err / (absref + 1e-30)).max().item())
    return bool((err <= tol * absref + 1e-30).all()), (
        worst, tol, k, float(err.max().item()))


@contextlib.contextmanager
def checked_engine(stats_mode: str = "exact"):
    """The cuda engine (``stats_mode="fused"``: the cuda_fused engine),
    registered as "checked", with every kernel call held against the plain
    versions on the same inputs, with phase 3's tolerances: quantize and
    truncate codes at most one grid step apart in at most 1e-4 of the
    elements, dequantize within 1e-6 relative, a raw GEMM within
    ``raw_tol(K)`` = max(1e-5, min(8 sqrt(K) 2^-24, 4e-5)) * (|A| @ |B|)
    + 1e-30 elementwise
    (``gemm_case``'s bound, 1e-5 at the random operands of phase 3, or
    eight times the probabilistic rounding of a K-term f32 sum where that
    is larger: the kernel's three TF32 passes and the plain f32 product
    each round their own way, and a full-width step's millions of outputs
    of gradients that cancel reach past 1e-5 — 1.07e-5 at K 2,048, 1.38e-5
    at the tied head's K 122,753; the cap keeps a wrong output tile at
    that depth failing), epilogue GEMM codes at most one step apart in at most
    max(1, 1e-3 n) of the n outputs (one flip is 1/512 of a 4-slot decode
    GEMM's 512 outputs), the flash forward's codes (or raw output, within 1e-4
    * max|plain|) in at most 1e-2 and |lse| within 1e-4, and each of the
    flash backward's dq, dk, dv within 1e-4 * max|plain|; on the fused
    engine the stats kernel's max and count equal to the plain version's,
    its sum within 1e-6 relative and (alpha, beta) within 4 ulp, and the
    quantize-with-stats kernel's and the fused truncate's (alpha, beta)
    within 4 ulp with their codes held under the kernel's own stats (one
    step apart in at most 1e-4 of the elements): under the plain version's
    stats a 1-ulp alpha moves every copy of a bf16 value that sits on a
    code boundary at once (43 equal elements of a 32,768-element bf16
    weight gradient at S 3072; one of 8,192 cotangent elements of
    ResNet-20 at batch 4).  Yields
    the tally by kernel: calls checked, output elements that differ from
    the plain version's (codes or values), and for raw GEMMs the worst
    |kernel - plain| / (|A| @ |B|) (``raw_worst``) and its K.  A planted
    wrong tile at the tied head's K 122,753 fails ``raw_close``
    (``tests/test_torch_gemm_split.py``)."""
    from repro_torch.core import backend as nb
    from repro_torch.core import qdot, s2fp8
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import s2fp8_quant as sq
    plain = nb.get_backend("plain")
    tally = {}

    def held(kind, ok, detail, *pairs):
        t = tally.setdefault(kind, {"calls": 0, "differ": 0})
        t["calls"] += 1
        t["differ"] += sum(int((x != y).sum()) for x, y in pairs)
        assert ok, f"{kind} disagrees with its plain version: {detail}"

    def codes_close(a, b, ab, fmt, frac):
        f = flips(ordinal(a, ab, fmt), ordinal(b, ab, fmt))
        return f["max_step"] <= 1 and f["frac"] <= frac, f

    def epilogue_close(a, b, ab, fmt):
        """Epilogue codes at most one step apart, in at most max(1, 1e-3
        n) of the n outputs."""
        f = flips(ordinal(a, ab, fmt), ordinal(b, ab, fmt))
        return (f["max_step"] <= 1
                and f["count"] <= max(1, 1e-3 * a.numel())), f

    def held_raw(kind, y, ref, absref, k):
        """A raw GEMM held by ``raw_close``; the tally keeps the worst
        |y - ref| / (|A| @ |B|) and its K."""
        ok, detail = raw_close(y, ref, absref, k)
        held(kind, ok, detail, (y, ref))
        t = tally[kind]
        if detail[0] >= t.get("raw_worst", 0.0):
            t["raw_worst"], t["raw_worst_k"] = detail[0], k

    def _gemm_k(layout, a, b):
        from repro_torch.kernels import ref as kref
        return kref.gemm_dims(layout, a.payload.shape[-2:],
                              b.payload.shape[-2:])[1]

    def _abs(t):
        return s2fp8.S2FP8Tensor(abs_payload(t.payload), t.ab, t.fmt)

    def rel_err(a, b):
        return (a - b).abs().max().item(), b.abs().max().item()

    def stats_close(tk, tp):
        rel = ((tk[0] - tp[0]).abs() / tp[0].abs().clamp(min=1e-30)).item()
        return bool(torch.equal(tk[1:], tp[1:])) and rel <= 1e-6, (tk, tp)

    class Checked(nb.CudaBackend):
        name = "checked"
        fused = stats_mode == "fused"

        def compute_stats_partials(self, x):
            out = super().compute_stats_partials(x)
            if self.fused:
                tk, (tp, _) = torch.stack(out), sq.stats_partials_plain(x)
                held("stats", *stats_close(tk, tp), (tk, tp))
            return out

        def compute_stats(self, x, *, fmt="e5m2"):
            ab = super().compute_stats(x, fmt=fmt)
            if self.fused:
                _, abp = sq.stats_partials_plain(x, s2fp8.FMT_TARGET_MAX[fmt])
                u = ulps(ab, abp)
                held("stats", u <= 4, u, (ab, abp))
            return ab

        def quantize(self, x, *, stats=None, fmt="e5m2"):
            t = super().quantize(x, stats=stats, fmt=fmt)
            if stats is None and self.fused:
                # the kernel's stats, and its encode under them, each held
                # to its own tolerance, as the fused truncate's below
                _, abp = sq.quant_plain(x, fmt)
                ck = code_ordinal(t.payload)
                cp = code_ordinal(plain.quantize(x, stats=t.ab,
                                                 fmt=fmt).payload)
                f, u = flips(ck, cp), ulps(t.ab, abp)
                held("quant", f["max_step"] <= 1 and f["frac"] <= 1e-4
                     and u <= 4, (f, u), (ck, cp))
                return t
            ck, cp = code_ordinal(t.payload), code_ordinal(
                plain.quantize(x, stats=t.ab, fmt=fmt).payload)
            f = flips(ck, cp)
            held("quant_apply", f["max_step"] <= 1 and f["frac"] <= 1e-4, f,
                 (ck, cp))
            return t

        def dequantize(self, t, dtype=torch.float32):
            y = super().dequantize(t, dtype)
            ref = plain.dequantize(t, dtype)
            err = (y - ref).abs()
            held("dequant", bool((err <= 1e-6 * ref.abs()).all()),
                 err.max().item(), (y, ref))
            return y

        def truncate(self, x, *, stats=None, fmt="e5m2"):
            if stats is None and self.fused:
                # the fused kernel's stats and its encode, each held to its
                # own tolerance (the encode under the kernel's stats)
                xk = dispatch._kernel_input(x).contiguous()
                y, abk = sq.truncate_fused(xk, fmt)
                _, abp = sq.truncate_fused_plain(xk, fmt)
                ref = plain.truncate(xk, stats=abk, fmt=fmt)
                ok, f = codes_close(y, ref, abk, fmt, 1e-4)
                u = ulps(abk, abp)
                held("truncate_fused", ok and u <= 4, (f, u), (y, ref))
                return y.to(x.dtype)
            y = super().truncate(x, stats=stats, fmt=fmt)
            if stats is None:           # the exact engine's torch stats
                stats = self.compute_stats(x, fmt=fmt)
            ref = plain.truncate(x, stats=stats, fmt=fmt)
            held("truncate_apply", *codes_close(
                y, ref, s2fp8.as_stats(stats, x.device), fmt, 1e-4),
                (y, ref))
            return y

        def qmatmul(self, a, b, *, layout="nn", epilogue_stats=None,
                    fmt="e5m2"):
            kw = dict(layout=layout, epilogue_stats=epilogue_stats, fmt=fmt)
            y, ref = super().qmatmul(a, b, **kw), plain.qmatmul(a, b, **kw)
            if epilogue_stats is None:
                held_raw(f"qmatmul_{layout}", y, ref,
                         plain.qmatmul(_abs(a), _abs(b), **kw),
                         _gemm_k(layout, a, b))
            else:
                held(f"qmatmul_{layout}", *epilogue_close(
                    y, ref, s2fp8.as_stats(epilogue_stats, y.device), fmt),
                    (y, ref))
            return y

        def qmatmul_batched(self, a, b, *, layout="nn", out_batch=None,
                            epilogue_stats=None, fmt="e5m2"):
            kw = dict(layout=layout, out_batch=out_batch,
                      epilogue_stats=epilogue_stats, fmt=fmt)
            y = super().qmatmul_batched(a, b, **kw)
            ref = plain.qmatmul_batched(a, b, **kw)
            if epilogue_stats is None:
                held_raw("qmatmul_batched", y, ref,
                         plain.qmatmul_batched(_abs(a), _abs(b), **kw),
                         _gemm_k(layout, a, b))
            else:
                held("qmatmul_batched", *epilogue_close(
                    y, ref, s2fp8.as_stats(epilogue_stats, y.device), fmt),
                    (y, ref))
            return y

    fwd, bwd = qdot._payload_flash_fwd, qdot._payload_flash_bwd

    def flash_fwd(be, qq, qk, qv, causal, window, fmt, bq, bk, out_stats):
        out, lse = fwd(be, qq, qk, qv, causal, window, fmt, bq, bk,
                       out_stats)
        if isinstance(be, Checked):
            rout, rlse = fwd(plain, qq, qk, qv, causal, window, fmt, bq, bk,
                             out_stats)
            lerr, _ = rel_err(lse, rlse)
            if out_stats is None:
                err, top = rel_err(out, rout)
                ok, detail = err <= 1e-4 * top, (err, top)
            else:
                ok, detail = codes_close(out, rout, s2fp8.as_stats(
                    out_stats, out.device), fmt, 1e-2)
            held("qflash_fwd", ok and lerr <= 1e-4, (detail, lerr),
                 (out, rout))
        return out, lse

    def flash_bwd(be, qq, qk, qv, qg, lse, delta, causal, window, bq, bk):
        got = bwd(be, qq, qk, qv, qg, lse, delta, causal, window, bq, bk)
        if isinstance(be, Checked):
            want = bwd(plain, qq, qk, qv, qg, lse, delta, causal, window,
                       bq, bk)
            errs = [rel_err(x, y) for x, y in zip(got, want)]
            held("qflash_bwd", all(e <= 1e-4 * t for e, t in errs), errs,
                 *zip(got, want))
        return got

    nb.register_backend("checked", Checked(stats_mode=stats_mode),
                        overwrite=True)
    qdot._payload_flash_fwd, qdot._payload_flash_bwd = flash_fwd, flash_bwd
    try:
        yield tally
    finally:
        qdot._payload_flash_fwd, qdot._payload_flash_bwd = fwd, bwd
        del nb.BACKENDS["checked"]


@contextlib.contextmanager
def recorded_routes():
    """Records (idx, tok_idx) of every MoE ``route`` call, remat replays
    included, while the block is open; yields the list."""
    from repro_torch.models import blocks
    route, calls = blocks.route, []

    def recording(*args):
        out = route(*args)
        calls.append((out[1], out[3]))
        return out

    blocks.route = recording
    try:
        yield calls
    finally:
        blocks.route = route


def routes_moved(got, want) -> str:
    """Entries of two engines' route calls that differ, call by call:
    token -> expert choices (idx) and expert -> token picks (tok_idx), each
    as pairs that one engine chose and the other did not, and as positions
    that differ (tok_idx lists each expert's picks by affinity, so a pick
    that only moves within the list moves positions, not pairs)."""
    assert len(got) == len(want), (len(got), len(want))

    def member(ix, n):
        return torch.zeros(ix.shape[:-1] + (n,), dtype=torch.bool,
                           device=ix.device).scatter(-1, ix, True)

    out = []
    for k, name in enumerate(("idx", "tok_idx")):
        pairs = pos = total = 0
        for g, w in zip(got, want):
            n = int(max(g[k].max(), w[k].max())) + 1
            pairs += int((member(g[k], n) & ~member(w[k], n)).sum())
            pos += int((g[k] != w[k]).sum())
            total += w[k].numel()
        out.append(f"{name} {pairs} of {total} pairs moved ({pos} "
                   f"positions differ)")
    return ", ".join(out)


def phase_small_train(dev) -> None:
    """Reduced minicpm_2b (2 layers, d=128, vocab 512) at batch 2 x seq 64
    with the bank at k = 2, once through the kernels and once through plain
    PyTorch (plain engine), from the same seeded params and batches.  The
    kernels run as the ``checked_engine``: every kernel call of the
    training path, forward and backward, refresh and steady steps, is held
    against its plain version on the same inputs, and each of the eight
    training kernels must have been checked.

    First each engine's gradients from the same params and bank, at step 0
    (every site cold: the refresh branch) over the initial bank and at
    step 1 (steady: the epilogue-fused GEMMs) over the bank the plain
    engine's step 0 returns; the per-leaf ||g_kernels - g_plain|| /
    ||g_plain|| is printed, not bounded: a code that one GEMM's summation
    order moves by one grid step changes the inputs of every later GEMM,
    so the whole-model gradients of two sound engines differ by several
    percent (PERF.md, Findings), while the per-call checks see each kernel
    on its own inputs.  Then 3 train steps (steps 0 and 2 refresh): every
    step's loss finite and the two engines' within 0.01 of each other."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    _small_train(dev, cfg, TRAIN_KERNELS, 0.01)


def phase_small_train_moe(dev) -> None:
    """Reduced deepseek_moe_16b (3 layers: dense_first + 2 moe, d 128, 8
    experts top-2 of width 64, 2 shared, vocab 512) through the same
    checks as ``phase_small_train``, under global and under grouped
    routing: every batched GEMM call of the expert einsums, forward and
    backward (NN, NT, TN, the broadcast B and the out_batch group sum of
    grouped routing), is held against its plain version on its own
    inputs, and the nine training kernels must all have been checked.
    The losses of the two engines are held within 0.1 of each other, a
    smoke test as for minicpm but looser: at step 0 every site refreshes
    from raw outputs that differ in the last bits, the two engines'
    gradients then differ by up to 17% per leaf, and in an MoE a moved
    code can also send a token whose two best experts nearly tie to the
    other one; after two AdamW steps the losses differed by up to 0.044
    on the H100 (PERF.md, Findings)."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    base = get_reduced_config("deepseek_moe_16b")
    for routing in ("global", "grouped"):
        log(f"small train moe: routing {routing}")
        cfg = base.replace(moe=dataclasses.replace(base.moe, routing=routing))
        _small_train(dev, cfg, TRAIN_MOE_KERNELS, 0.1)


def _small_batches(cfg, dev):
    from repro_torch.data import synthetic
    chain = synthetic.markov_chain(1, cfg.vocab)
    gen = torch.Generator().manual_seed(1)
    return [synthetic.lm_batch(chain, gen, 2, 64, dev) for _ in range(3)]


def _small_train(dev, cfg, expected, loss_tol, stats_mode="exact") -> None:
    from repro_torch.core import statsbank

    batches = _small_batches(cfg, dev)
    loss_fn = _lm_loss(cfg)
    stats = statsbank.StatsConfig(refresh_every=2)
    with checked_engine(stats_mode) as tally:
        _small_train_checked(dev, cfg, batches, loss_fn, stats, tally,
                             loss_tol)
    missing = set(expected) - set(tally)
    assert not missing, f"never checked on the training path: {missing}"


def phase_small_fused(dev) -> None:
    """Reduced minicpm_2b (2 layers, d=128, vocab 512) at batch 2 x seq 64
    on the cuda_fused engine, run as the ``checked_engine`` (every kernel
    call held against its plain version on the same inputs, the stats
    kernels included) against the plain engine: 3 steps with exact
    per-call stats on the payload GEMMs, 3 in fig4 mode, and the bank at
    k = 2 (``phase_small_train``'s run, refreshes through the stats
    kernel); every loss finite and within 0.01 of the plain engine's.
    Then one counted train step each (``statsbank.count_reductions``),
    exact stats: the cuda_fused s2fp8 step runs as many whole-tensor aten
    reductions as the fp32 step (its stats run in kernels), the cuda s2fp8
    step more (three torch reductions per stats)."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    _small_train_exact(dev, cfg, "payload", TRAIN_EXACT_KERNELS)
    _small_train_exact(dev, cfg, "fig4", TRAIN_FIG4_KERNELS)
    log("small train cuda_fused: bank k = 2")
    _small_train(dev, cfg, TRAIN_KERNELS + ("stats",), 0.01,
                 stats_mode="fused")
    _counted_steps(dev, cfg)


def _small_train_exact(dev, cfg, gemm_mode, expected, batches=None,
                       loss_tol=0.01) -> None:
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    batches = batches or _small_batches(cfg, dev)
    loss_fn = _lm_loss(cfg)
    losses = {}
    with checked_engine("fused") as tally:
        for engine in ("checked", "plain"):
            pol = make_policy("s2fp8", engine, gemm_mode)
            params = tlm.init_lm(cfg, seed=1, device=dev)
            opt = optimizers.adamw()
            opt_state = opt.init(params)
            step = make_train_step(loss_fn, opt, schedules.constant(3e-3),
                                   pol)
            out = []
            for i, batch in enumerate(batches):
                params, opt_state, m = step(params, opt_state, batch, i)
                out.append(float(m["loss"]))
            losses[engine] = out
    log(f"small train cuda_fused exact {gemm_mode}: losses kernels "
        f"{losses['checked']} plain {losses['plain']}; kernel calls held "
        f"against their plain versions: {tally}")
    for a, b in zip(losses["checked"], losses["plain"]):
        assert math.isfinite(a) and math.isfinite(b), losses
        assert abs(a - b) <= loss_tol, losses
    missing = set(expected) - set(tally)
    assert not missing, f"never checked on the {gemm_mode} path: {missing}"


def _counted_steps(dev, cfg) -> None:
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    batch = _small_batches(cfg, dev)[0]
    loss_fn = _lm_loss(cfg)
    n = {}
    for label, mode, engine in (("fp32", "fp32", "cuda"),
                                ("cuda_fused", "s2fp8", "cuda_fused"),
                                ("cuda", "s2fp8", "cuda")):
        params = tlm.init_lm(cfg, seed=1, device=dev)
        opt = optimizers.adamw()
        step = make_train_step(loss_fn, opt, schedules.constant(3e-3),
                               make_policy(mode, engine))
        opt_state = opt.init(params)
        with statsbank.count_reductions() as c:
            step(params, opt_state, batch, 0)
            torch.cuda.synchronize()
        n[label] = c.n
        log(f"counted step {label}: {c.n} whole-tensor aten reductions; "
            f"every reduction by overload: {c.by_op}")
    assert n["cuda_fused"] == n["fp32"] < n["cuda"], n


def _small_train_checked(dev, cfg, batches, loss_fn, stats, tally,
                         loss_tol) -> None:
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    params = tlm.init_lm(cfg, seed=1, device=dev)
    pols = {e: make_policy("s2fp8", e, "payload")
            for e in ("checked", "plain")}
    bank0 = statsbank.init_bank(loss_fn, params, batches[0], pols["plain"],
                                stats)
    with recorded_routes() as rp0:
        gp0, bank1 = _bank_grads(loss_fn, params, batches[0], pols["plain"],
                                 bank0, 0, stats)
    assert not any(c.any() for e in statsbank.cold_sites(bank1).values()
                   for c in e.values()), "a site stayed cold after step 0"
    with recorded_routes() as rp1:
        gp1, _ = _bank_grads(loss_fn, params, batches[1], pols["plain"],
                             bank1, 1, stats)
    for step, bank, gp, rp in ((0, bank0, gp0, rp0), (1, bank1, gp1, rp1)):
        before = {k: dict(v) for k, v in tally.items()}
        with recorded_routes() as rc:
            gc, _ = _bank_grads(loss_fn, params, batches[step],
                                pols["checked"], bank, step, stats)
        assert all(bool(torch.isfinite(c).all()) for c in gc), step
        rel = [((c - p).norm() / p.norm()).item() for c, p in zip(gc, gp)]
        differ = {k: v["differ"] - before.get(k, {"differ": 0})["differ"]
                  for k, v in tally.items()}
        log(f"small train: step {step} gradients, ||kernels - plain|| / "
            f"||plain|| per leaf: max {max(rel):.3e}, median "
            f"{sorted(rel)[len(rel) // 2]:.3e} over {len(rel)} leaves; "
            f"output elements that differ from the plain version's, by "
            f"kernel: {differ}")
        if rp:
            log(f"small train: step {step} routing, entries that differ "
                f"from the plain engine's over {len(rp)} route calls: "
                + routes_moved(rc, rp))
    del params, bank0, bank1, gp0, gp1, gc

    losses = {}
    for engine, pol in pols.items():
        params = tlm.init_lm(cfg, seed=1, device=dev)
        opt = optimizers.adamw()
        opt_state = opt.init(params)
        bank = statsbank.init_bank(loss_fn, params, batches[0], pol, stats)
        step = make_train_step(loss_fn, opt, schedules.constant(3e-3), pol,
                               stats=stats)
        out = []
        for i, batch in enumerate(batches):
            params, opt_state, bank, m = step(params, opt_state, bank, batch,
                                              i)
            out.append(float(m["loss"]))
        losses[engine] = out
    log(f"small train: losses kernels {losses['checked']} plain "
        f"{losses['plain']}")
    for a, b in zip(losses["checked"], losses["plain"]):
        assert math.isfinite(a) and math.isfinite(b), losses
        assert abs(a - b) <= loss_tol, losses
    log(f"small train: kernel calls held against their plain versions: "
        f"{tally}")


@contextlib.contextmanager
def scan_route(check: bool):
    """Routes the SSM blocks' selective scan, forward and backward (the
    prefill's ``selective_scan`` and training's ``SelectiveScanFn``, as
    ``models/blocks.py`` reaches them through its ``scan`` module): with
    ``check``, through the kernels, each call held against its plain
    version on the same inputs (the forward's y and h within 1e-5 * max
    |plain|, the backward's six gradients within 1e-4 * max |plain|, phase
    3's tolerances); else through the plain versions.  Training runs an
    autograd Function of SelectiveScanFn's form over the routed calls.
    Yields the tally of calls checked."""
    import types
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import blocks
    tally = {"calls": 0, "differ": 0, "bwd_calls": 0, "bwd_differ": 0}

    def held(got, want, tol, what, key):
        for g, w in zip(got, want):
            err, top = (g - w).abs().max().item(), w.abs().max().item()
            assert err <= tol * top, (what, err, top)
            tally[key] += int((g != w).sum())

    def checked(*args, chunk_states=False):
        out = ss.selective_scan(*args, chunk_states=chunk_states)
        held(out[:2], ss.selective_scan_plain(*args), 1e-5,
             "selective_scan", "differ")
        tally["calls"] += 1
        return out

    def checked_bwd(*args):
        grads = ss.selective_scan_bwd(*args)
        held(grads, ss.selective_scan_bwd_plain(*args), 1e-4,
             "selective_scan_bwd", "bwd_differ")
        tally["bwd_calls"] += 1
        return grads

    def plain(*args, chunk_states=False):
        y, h = ss.selective_scan_plain(*args)
        return (y, h, None) if chunk_states else (y, h)

    fwd, bwd = (checked, checked_bwd) if check else (
        plain, ss.selective_scan_bwd_plain)

    class RoutedScanFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            args = [t.contiguous() for t in args]
            y, _, chunks = fwd(*args, chunk_states=True)
            ctx.save_for_backward(*args, chunks)
            return y

        @staticmethod
        def backward(ctx, dy):
            *args, chunks = ctx.saved_tensors
            return bwd(*args, dy.contiguous(), chunks)

    module = blocks.scan
    blocks.scan = types.SimpleNamespace(selective_scan=fwd,
                                        SelectiveScanFn=RoutedScanFn)
    try:
        yield tally
    finally:
        blocks.scan = module


def small_serve_ssm(dev, arch: str, expected) -> None:
    """Reduced ``arch`` served by LMServer on the card (4 slots, prompts of
    5, 8, 3 and 20 tokens: buckets 8, 8, 4 and 32, so three are padded),
    once through the kernels and once through the plain versions, from the
    same seeded params.  fp32: every scan call held against its plain
    version and the same greedy tokens.  s2fp8, exact stats, payload GEMMs:
    the cuda_fused engine run as the ``checked_engine`` (every kernel call
    held against its plain version on the same inputs, phase 3's
    tolerances) against the plain engine; logits finite, and at each step
    the rows whose tokens so far agree within max |diff| <= 0.5 and mean
    <= 0.1 (the two engines' exact stats differ in their last bits, f64
    against f32 sums, which moves payload codes across rounding boundaries
    and spreads through the recurrence; the CPU tests see the same between
    the port and the reference).  Every kernel of ``expected`` but the scan
    must have been checked by the engine, the scan by ``scan_route``."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.engine import LMServer, Request

    cfg = get_reduced_config(arch)
    params = tlm.init_lm(cfg, seed=1, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 8, 3, 20)]

    def serve(pol):
        """Greedy tokens per request and, per step, (logits of the rows it
        ran [rows, V], rows, tokens each row had emitted)."""
        srv = LMServer(cfg, params, pol, slots=len(prompts), max_len=64)
        steps = []
        prefill, decode = srv._prefill, srv._decode

        def p(params_, tokens, last):
            out = prefill(params_, tokens, last)
            rows = (tokens != 0).any(dim=1).nonzero()[:, 0].tolist()
            steps.append((out[0][rows, -1].float(), rows, 0))
            return out

        def d(*args):
            rows = [s for s, r in enumerate(srv.slot_req) if r is not None]
            n_out = len(srv.slot_req[rows[0]].out)
            out = decode(*args)
            steps.append((out[0][rows, -1].float(), rows, n_out))
            return out

        srv._prefill, srv._decode = p, d
        reqs = [Request(prompt=x, max_new_tokens=6) for x in prompts]
        for r in reqs:
            srv.submit(r)
        srv.run_to_completion()
        return [r.out for r in reqs], steps

    label = f"small {arch}"
    with scan_route(check=True) as scans:
        tk, _ = serve(make_policy("fp32"))
    with scan_route(check=False):
        tp, _ = serve(make_policy("fp32"))
    log(f"{label} fp32: tokens kernels {tk} plain {tp}; scan calls held "
        f"against the plain version: {scans}")
    assert tk == tp, "kernel and plain scans chose different tokens"

    with checked_engine("fused") as tally, scan_route(check=True) as scans:
        tk, sk = serve(make_policy("s2fp8", "checked", "payload"))
    with scan_route(check=False):
        tp, sp = serve(make_policy("s2fp8", "plain", "payload"))
    log(f"{label} s2fp8: tokens kernels {tk} plain {tp}; kernel calls "
        f"held against their plain versions: {tally}, scans {scans}")
    assert len(sk) == len(sp)
    for i, ((lk, rows, n_out), (lp, rows_p, _)) in enumerate(zip(sk, sp)):
        assert rows == rows_p and bool(torch.isfinite(lk).all()), i
        same = [j for j, r in enumerate(rows) if tk[r][:n_out] == tp[r][:n_out]]
        if not same:
            continue
        dlt = (lk[same] - lp[same]).abs()
        log(f"{label} s2fp8 step {i}: {len(same)} rows agree so far, "
            f"max {dlt.max().item():.4f} mean {dlt.mean().item():.5f}")
        assert dlt.max().item() <= 0.5 and dlt.mean().item() <= 0.1
    missing = set(expected) - set(tally) - {"selective_scan"}
    assert not missing and scans["calls"], f"never checked: {missing}"


def phase_small_mamba(dev) -> None:
    """Reduced falcon_mamba_7b (4 mamba1 layers, d 128, di 256, 8 states,
    vocab 512) served as ``small_serve_ssm`` serves."""
    small_serve_ssm(dev, "falcon_mamba_7b", SERVE_MAMBA_KERNELS)


def phase_small_ssm(dev) -> None:
    """"small-ssm": reduced zamba2_1p2b (mamba2, mamba2, attn, mamba2; d
    128, 8 heads of 32 channels, 8 states, vocab 512) served as
    ``small_serve_ssm`` serves (the attention block through the dense
    decode's batched GEMM), then reduced zamba2 and reduced falcon_mamba_7b
    trained as ``phase_small_train`` trains minicpm (batch 2 x 64, bank k
    = 2, the checked engine against the plain engine, the gradients of
    steps 0 and 1 and 3 train steps) with every scan forward and backward
    call, in both engines' runs, through the kernels and held against its
    plain version (``scan_route``).  Losses within 0.05 of each other, a
    smoke test as for the MoE: a recurrence carries a moved code through
    every later step."""
    from repro_torch.configs import get_reduced_config
    small_serve_ssm(dev, "zamba2_1p2b", SERVE_ZAMBA2_KERNELS)
    for arch, expected in (("zamba2_1p2b", TRAIN_ZAMBA2_KERNELS),
                           ("falcon_mamba_7b", TRAIN_MAMBA_KERNELS)):
        log(f"small train {arch}")
        with scan_route(check=True) as scans:
            _small_train(dev, get_reduced_config(arch),
                         set(expected) - SCAN_KERNELS, 0.05)
        log(f"small train {arch}: scan calls held against the plain "
            f"versions: {scans}")
        assert scans["calls"] and scans["bwd_calls"], scans


def phase_small_long(dev) -> None:
    """Reduced minicpm_2b (2 layers, d 128, 4 heads of 32, vocab 512) at
    batch 1 x 3072 tokens, above the 2048 at which a block leaves the full
    attention, through the kernels and through the plain versions from the
    same seeded params and batches.  Payload GEMMs with the bank at k = 2,
    2 steps each, with ``attn_impl`` flash (the payload flash node: its
    forward and backward kernels at S 3072) and naive (the chunked
    attention, plain torch, between the q/k/v/out sites' truncate
    kernels): every kernel call held against its plain version on the same
    inputs (``checked_engine``, phase 3's tolerances), each path's kernels
    all checked, every loss finite and the two engines' within 0.02 (a
    smoke bound: the per-call checks hold the kernels).  Then fig4 with
    ``attn_impl`` flash on the cuda_fused engine, exact stats, 2 steps:
    q, k, v and the output of ``models/flash.py`` truncated by the fused
    truncate kernel, every call held."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tlm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    base = get_reduced_config("minicpm_2b").replace(n_layers=2)
    chain = synthetic.markov_chain(1, base.vocab)
    gen = torch.Generator().manual_seed(1)
    batches = [synthetic.lm_batch(chain, gen, 1, 3 * 1024, dev)
               for _ in range(2)]
    stats = statsbank.StatsConfig(refresh_every=2)
    for impl, expected in (("flash", TRAIN_KERNELS),
                           ("naive", TRAIN_NAIVE_KERNELS)):
        cfg = base.replace(attn_impl=impl)
        loss_fn = _lm_loss(cfg)
        losses = {}
        with checked_engine() as tally:
            for engine in ("checked", "plain"):
                pol = make_policy("s2fp8", engine, "payload")
                params = tlm.init_lm(cfg, seed=1, device=dev)
                opt = optimizers.adamw()
                opt_state = opt.init(params)
                bank = statsbank.init_bank(loss_fn, params, batches[0], pol,
                                           stats)
                step = make_train_step(loss_fn, opt,
                                       schedules.constant(3e-3), pol,
                                       stats=stats)
                out = []
                for i, batch in enumerate(batches):
                    params, opt_state, bank, m = step(params, opt_state,
                                                      bank, batch, i)
                    out.append(float(m["loss"]))
                losses[engine] = out
        log(f"small long {impl}: S 3072, losses kernels {losses['checked']} "
            f"plain {losses['plain']}; kernel calls held against their "
            f"plain versions: {tally}")
        for a, b in zip(losses["checked"], losses["plain"]):
            assert math.isfinite(a) and math.isfinite(b), losses
            assert abs(a - b) <= 0.02, losses
        missing = set(expected) - set(tally)
        assert not missing, f"never checked on the {impl} path: {missing}"
    log("small long: fig4 + flash on cuda_fused")
    _small_train_exact(dev, base.replace(attn_impl="flash"), "fig4",
                       TRAIN_FIG4_KERNELS, batches, 0.02)


# ---------------------------------------------------------------------------
# the paper's workloads: the encoder-decoder, ResNet-20, NCF
# ---------------------------------------------------------------------------

def _paper_family(dev, family: str, mode: str = "s2fp8", batch_size=None):
    """(params, step(params, opt_state, batch, i) -> (params, opt_state,
    metrics), optimizer, batches(n), units a batch) of one paper workload
    through ``make_train_step``, as ``examples/train_*.py`` recipe it:
    ``tiny`` transformer_tiny (vocab 256 as the example) on seq2seq
    batches, AdamW on a cosine schedule; ``resnet`` ResNet-20 on CIFAR
    blobs, SGD momentum 0.9 with weight decay 1e-4 and the step decay, the
    batch-norm state carried beside the step; ``ncf`` NCF at ML-1M's
    sizes (6,040 users x 3,706 items, 8 factors), AdamW at a constant
    2e-3."""
    from repro_torch.configs import get_config, ncf_ml1m, resnet20_cifar
    from repro_torch.data import synthetic
    from repro_torch.models import encdec, ncf, resnet
    from repro_torch.optim import optimizers, schedules

    gen = torch.Generator().manual_seed(1)
    if family == "tiny":
        cfg = get_config("transformer_tiny").replace(vocab=256)
        b, s = batch_size or (64, 32)
        params = encdec.init_encdec(cfg, seed=1, device=dev)

        def loss_fn(p, batch, pol):
            return encdec.loss_fn(p, batch["enc_tokens"],
                                  batch["dec_tokens"], batch["dec_labels"],
                                  cfg, pol)

        def batches(n):
            return [synthetic.seq2seq_batch(gen, b, s, s, cfg.vocab, dev)
                    for _ in range(n)]
        return (params, loss_fn, optimizers.adamw(),
                schedules.cosine(2e-3, 1, 10), batches, b * s, None)
    if family == "resnet":
        b = batch_size or 128
        params, state = resnet.init_resnet(resnet20_cifar.DEPTH,
                                           resnet20_cifar.N_CLASSES, seed=1,
                                           device=dev)
        carry = {"bn": state}
        centers = synthetic.cifar_centers(1)

        def loss_fn(p, batch, pol):
            loss, (metrics, new_bn) = resnet.loss_fn(p, carry["bn"], batch,
                                                     pol)
            carry["new"] = new_bn
            return loss, metrics

        def batches(n):
            return [synthetic.cifar_batch(centers, gen, b, dev)
                    for _ in range(n)]
        return (params, loss_fn,
                optimizers.sgd_momentum(momentum=0.9, weight_decay=1e-4),
                schedules.step_decay(0.05, [48, 68]), batches, b, carry)
    b = batch_size or 1024
    params = ncf.init_ncf(ncf_ml1m.N_USERS, ncf_ml1m.N_ITEMS,
                          ncf_ml1m.FACTORS, seed=1, device=dev)
    prefs = synthetic.ncf_preferences(1, ncf_ml1m.N_USERS, ncf_ml1m.N_ITEMS)

    def batches(n):
        return [synthetic.ncf_batch(prefs, gen, b, dev) for _ in range(n)]
    return (params, ncf.loss_fn, optimizers.adamw(),
            schedules.constant(2e-3), batches, b, None)


def _paper_steps(dev, family, pol, steps, batch_size=None, timed=False):
    """``steps`` train steps of a paper workload under ``pol`` -> (losses,
    step ms, units a step)."""
    from repro_torch.training.trainer import make_train_step
    params, loss_fn, opt, sched, batches, units, carry = _paper_family(
        dev, family, batch_size=batch_size)
    step = make_train_step(loss_fn, opt, sched, pol)
    opt_state = opt.init(params)
    losses, ms = [], []
    for i, batch in enumerate(batches(steps)):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch, i)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if carry is not None:
            carry["bn"] = carry["new"]
    return losses, ms, units


def phase_small_paper(dev) -> None:
    """The paper's three workloads, small, on the card through the kernels
    and through the plain versions from the same seeded params and
    batches: transformer_tiny (vocab 256, batch 2 x 16), ResNet-20 at
    batch 4 and NCF at ML-1M's sizes at batch 64, 2 steps each in s2fp8
    payload with exact per-call stats, on the cuda engine and on the
    cuda_fused engine, each as the ``checked_engine``: every kernel call,
    forward and backward, held against its plain version on the same
    inputs (phase 3's tolerances; the stats kernels too on cuda_fused),
    every training kernel checked, every loss finite and the two engines'
    within 0.1 of each other (a smoke bound: the per-call checks hold the
    kernels)."""
    from repro_torch.core.policy import make_policy
    sizes = {"tiny": (2, 16), "resnet": 4, "ncf": 64}
    for stats_mode, expected in (("exact", TRAIN_KERNELS),
                                 ("fused", TRAIN_EXACT_KERNELS)):
        with checked_engine(stats_mode) as tally:
            for family, size in sizes.items():
                losses = {}
                for engine in ("checked", "plain"):
                    pol = make_policy("s2fp8", engine, "payload")
                    losses[engine], _, _ = _paper_steps(dev, family, pol, 2,
                                                        size)
                log(f"small paper {family} ({stats_mode} stats): losses "
                    f"kernels {losses['checked']} plain {losses['plain']}")
                for a, b in zip(losses["checked"], losses["plain"]):
                    assert math.isfinite(a) and math.isfinite(b), losses
                    assert abs(a - b) <= 0.1, (family, losses)
        log(f"small paper ({stats_mode} stats): kernel calls held against "
            f"their plain versions: {tally}")
        missing = set(expected) - set(tally)
        assert not missing, f"never checked on the paper paths: {missing}"


def _whisper_flop(cfg, frames: int, tokens: int) -> float:
    """Model FLOPs of one training step, 6 x (weights x the rows they
    multiply): the encoder's blocks and each decoder layer's cross K/V over
    the frames, the decoder's self-attention, cross Q/O, MLP and the head
    over the tokens.  Attention's score and value products, and the remat
    replay, are not counted."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    enc = cfg.n_enc_layers * (4 * d * d + 2 * d * ff)
    xkv = cfg.n_layers * 2 * d * d
    dec = cfg.n_layers * (6 * d * d + 2 * d * ff) + d * v
    return 6.0 * ((enc + xkv) * frames + dec * tokens)


def phase_train_encdec(dev, profile: bool = False, b: int = 4,
                       frames: int = 1500) -> dict:
    """Full-width, full-depth whisper_medium (24 + 24 layers, d 1024, 16
    heads of 64, d_ff 4096, vocab 51,865; remat) trained through
    ``encdec.loss_fn`` and ``make_train_step``: seeded params, batch 4 x
    1,500 audio-stub frames (seeded N(0, 1) frame embeddings) and 448
    decoder tokens of seeded seq2seq batches, s2fp8 payload on the cuda
    engine with the bank at k = 8 (``statsbank.init_bank``, then 4 steps:
    step 0 bootstraps every site), AdamW.  Every training kernel must
    launch, no plain version run, every loss finite.  Reports step ms,
    step 0 ms, frames/s, tokens/s, model TFLOP/s (``_whisper_flop``) and
    peak memory."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config, whisper_medium
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.data import synthetic
    from repro_torch.models import encdec
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    cfg = get_config("whisper_medium")
    tokens, steps = whisper_medium.DEC_LEN, 4
    t0 = time.perf_counter()
    params = encdec.init_encdec(cfg, seed=0, device=dev)
    opt = optimizers.adamw(weight_decay=0.01)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    tgen = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(steps + 1):
        s2s = synthetic.seq2seq_batch(tgen, b, tokens, tokens, cfg.vocab,
                                      dev)
        batches.append({"frames": torch.randn(
            (b, frames, cfg.d_model), generator=gen, device=dev),
            "dec": s2s["dec_tokens"], "lab": s2s["dec_labels"]})
    torch.cuda.synchronize()
    log(f"train-encdec: {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, d={cfg.d_model}, {cfg.n_params() / 1e9:.3f} B params, "
        f"batch {b} x {frames} frames / {tokens} tokens, remat {cfg.remat}, "
        f"set-up {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    def loss_fn(p, batch, pol):
        return encdec.loss_fn(p, batch["frames"], batch["dec"], batch["lab"],
                              cfg, pol)

    pol = make_policy("s2fp8", "cuda", "payload")
    stats = statsbank.StatsConfig(refresh_every=8)
    step_fn = make_train_step(loss_fn, opt, schedules.cosine(3e-4, 1, steps),
                              pol, stats=stats)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    bank = statsbank.init_bank(loss_fn, params, batches[0], pol, stats)
    losses, step_ms = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, opt_state, bank, m = step_fn(params, opt_state, bank,
                                             batches[i + 1], i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        log(f"train-encdec step {i}: loss {losses[-1]:.4f}, nll "
            f"{float(m['nll']):.4f}, grad_norm {float(m['grad_norm']):.3f}, "
            f"refreshed {m['stats_refreshed']:.0f}, {step_ms[-1]:.1f} ms")
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if profile:
        state = {"p": params, "o": opt_state, "b": bank}

        def one_step():
            state["p"], state["o"], state["b"], _ = step_fn(
                state["p"], state["o"], state["b"], batches[-1], steps)
        profile_window("train-encdec: 1 steady train step", one_step)
    assert all(math.isfinite(x) for x in losses), losses
    check_counts(counts, TRAIN_ENCDEC_KERNELS)
    steady = float(np.mean(step_ms[1:]))
    flop = _whisper_flop(cfg, b * frames, b * tokens)
    metrics = {
        "steps": steps, "losses": losses, "step_ms": step_ms,
        "step0_ms": step_ms[0], "steady_step_ms_mean": steady,
        "frames_per_s": b * frames / steady * 1e3,
        "tokens_per_s": b * tokens / steady * 1e3,
        "model_flop_per_step": flop,
        "model_tflop_per_s": flop / steady / 1e9,
        "bank_sites": len(bank), "max_memory_allocated_gb": peak / 1e9,
    }
    log("train-encdec metrics: " + json.dumps(metrics))
    log("train-encdec launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def phase_serve_encdec(dev, b: int = 4, frames: int = 1500) -> dict:
    """Full-width, full-depth whisper_medium served through the port's
    entry points: ``serve_prefill`` of 4 requests of 1,500 seeded audio-stub
    frames (encode, the cross K/V of every decoder layer, BOS through the
    decoder at index 0), then 16 greedy ``serve_decode`` ticks, s2fp8 with
    exact per-call stats on the cuda_fused engine and payload GEMMs.  The
    encoder attends through the payload flash forward (non-causal 1,500),
    each tick's self-attention runs ``decode_attention`` on the batched
    GEMM (64 groups of one query row over the 448-slot cache), its
    cross-attention the payload flash forward (1 x 1,500), and its GEMMs
    the small path.  Every kernel of the path must launch, no plain
    version run, every logit finite.  Reports prefill ms, decode ms per
    tick and peak memory."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config, whisper_medium
    from repro_torch.core.policy import make_policy
    from repro_torch.models import encdec

    cfg = get_config("whisper_medium")
    ticks = 16
    params = encdec.init_encdec(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames_in = torch.randn((b, frames, cfg.d_model), generator=gen,
                            device=dev)
    bos = torch.ones((b, 1), dtype=torch.long, device=dev)
    pol = make_policy("s2fp8", "cuda_fused", "payload")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = encdec.serve_prefill(params, frames_in, bos, cfg,
                                             pol,
                                             max_dec_len=whisper_medium.DEC_LEN)
        assert bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, tick_ms = [], []
        for i in range(1, ticks + 1):
            tok = logits.float().argmax(-1)
            toks.append(tok[:, 0].tolist())
            t0 = time.perf_counter()
            logits, state = encdec.serve_decode(params, tok, state, i, cfg,
                                                pol)
            assert bool(torch.isfinite(logits).all()), i
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    check_counts(counts, SERVE_ENCDEC_KERNELS)
    metrics = {"batch": b, "frames": frames, "ticks": ticks,
               "prefill_ms": prefill_ms, "decode_ms_per_tick": tick_ms,
               "decode_ms_per_tick_mean": float(np.mean(tick_ms[1:])),
               "tokens_per_s": b / float(np.mean(tick_ms[1:])) * 1e3,
               "max_memory_allocated_gb": peak / 1e9,
               "greedy_tokens_first_slot": [t[0] for t in toks]}
    log("serve-encdec metrics: " + json.dumps(metrics))
    log("serve-encdec launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def phase_train_paper(dev) -> dict:
    """The paper's three workloads at their recipes' sizes, trained
    through ``make_train_step``: ResNet-20 at batch 128, NCF at ML-1M's
    sizes at batch 1,024 and transformer_tiny at batch 64 x 32 tokens
    (``_paper_family``), each 3 steps in s2fp8 payload on the cuda engine
    (exact per-call stats) and 2 steps each in fp32, fp8 and fp8_ls (loss
    scale 100), as ``examples/train_*.py`` run them.  Every loss finite;
    the s2fp8 runs must launch every training kernel between them, the
    other modes (casts and f32 torch products) none, and no plain version
    may run.  Reports step ms (the mean after step 0) and images, samples
    or tokens per second."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.policy import make_policy

    unit = {"resnet": "images", "ncf": "samples", "tiny": "tokens"}
    metrics = {}
    kernels.reset_counts()                        # the main path starts here
    for family in ("resnet", "ncf", "tiny"):
        for mode in ("s2fp8", "fp32", "fp8", "fp8_ls"):
            before = kernels.counts()
            pol = make_policy(mode, "cuda",
                              "payload" if mode == "s2fp8" else None,
                              loss_scale=100.0)
            losses, ms, units = _paper_steps(dev, family, pol,
                                             3 if mode == "s2fp8" else 2,
                                             timed=True)
            launched = {k: c["launches"] - before[k]["launches"]
                        for k, c in kernels.counts().items()
                        if c["launches"] > before[k]["launches"]}
            steady = float(np.mean(ms[1:]))
            metrics[f"{family} {mode}"] = {
                "losses": losses, "step_ms": ms, "steady_step_ms": steady,
                f"{unit[family]}_per_s": units / steady * 1e3,
                "launches": launched}
            log(f"train-paper {family} {mode}: losses {losses}, step ms "
                f"{[round(x, 2) for x in ms]}, {units / steady * 1e3:.0f} "
                f"{unit[family]}/s, launches {launched}")
            assert all(math.isfinite(x) for x in losses), (family, mode)
            assert mode == "s2fp8" or not launched, (family, mode, launched)
    counts = path_counts()                        # ... and ends here
    check_counts(counts, TRAIN_PAPER_KERNELS)
    log("train-paper metrics: " + json.dumps(metrics))
    return {"counts": counts, "metrics": metrics}


TRAIN_LOOP_STEPS = 10
TRAIN_LOOP_ARGS = ["--arch", "minicpm_2b", "--n-layers", "2", "--batch", "4",
                   "--seq", "512", "--backend", "cuda",
                   "--stats-refresh-every", "4", "--telemetry", "--guard",
                   "--snapshot-every", "2", "--snapshot-ring", "2",
                   "--metrics-sink", "memory", "--mesh", "none",
                   "--steps", str(TRAIN_LOOP_STEPS)]
# the ladder's faults; the straggler sleeps well past 3 x the median step
TRAIN_LOOP_CHAOS = "nan_grad@5x3,corrupt_ckpt@8,slow_step@9:1.5"


def _timed(record: list, fn):
    """``fn`` wrapped to append its synchronized wall ms to ``record``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def _leaves_equal(a: list, b: list) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor)
        else np.array_equal(x, y) for x, y in zip(a, b))


def _events(loop, names) -> list:
    return [(r["event"], r["step"]) for r in loop.sink.by_kind("event")
            if r["event"] in names]


def phase_train_loop(dev) -> dict:
    """The resilient training loop of ``launch/train.py`` on full-width
    minicpm_2b cut to 2 layers (``cut_depth``; 405 M params, so params,
    AdamW m and v are 4.86 GB), batch 4 x 512, the cuda engine, the bank
    at k = 4 with telemetry, the guard armed, a snapshot ring of 2 every 2
    steps; each run is ``launch.train.build`` of its argv, as ``main``
    builds it, into a memory sink.

    * Ladder: ``--chaos nan_grad@5x3,corrupt_ckpt@8,slow_step@9:1.5`` with
      checkpoints every 4 steps: the events must be guard_tripped (5, 6,
      7), stats_refresh_forced (6) and rollback (7 -> 4), each rejected
      step must leave params, AdamW state, bank and guard carry bit for bit
      as they were (the step is wrapped to compare a copy), the slow step
      must trip the watchdog, and every site's telemetry must be finite.
    * Reject: the same schedule with ``reject@5x3``: whether the final
      state equals the ladder run's bit for bit, and the largest
      difference; if they differ, whether the embedding's backward
      (``table[tokens]``, an accumulating ``index_put_``) gives the same
      bits twice.
    * Resume: ``--resume auto`` past the corrupted step-8 checkpoint: a
      ``checkpoint_quarantined`` event, the restore from step 4, bit for
      bit the state that was saved there (a device copy taken at the
      save).
    * Compressed: one ``compress=True`` save and restore through the
      cuda_fused engine's codec (quantize-with-stats #3 on save,
      dequantize #4 on restore), then held against the two kernels'
      plain versions with phase 3's tolerances: codes at most one step
      apart in at most 1e-4 of the elements, (alpha, beta) within 4 ulp,
      decoded values within 1e-6 relative of the plain dequantize of the
      same payload, the small leaves bit for bit.  The main path ends
      here; the steady steps 5-7 of the resumed state are timed bare
      after it, by the guarded step and by one built without the guard,
      in the order guarded, unguarded, unguarded, guarded (means over
      steps 6 and 7: each step 5 reads a new bank's cold sites).

    Prints the steady step ms in TrainLoop against the bare train step
    with and without the guard, the checkpoint's blocking and write
    seconds, bytes raw and compressed, the snapshot push, rollback and
    restore ms and the phase's wall time.
    Checkpoints go to a temporary directory, removed at the end."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import convert, kernels
    from repro_torch.checkpoint import manager as ckpt_mod
    from repro_torch.kernels import s2fp8_quant as sq
    from repro_torch.launch import train as launch
    from repro_torch.obs import TELE_FIELDS

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="train_loop_")
    try:
        ck_dir = os.path.join(root, "ladder")
        kernels.reset_counts()                    # the main path starts here
        loop = launch.build(launch.parse_args(TRAIN_LOOP_ARGS + [
            "--ckpt-dir", ck_dir, "--ckpt-every", "4",
            "--chaos", TRAIN_LOOP_CHAOS]))
        n_params = sum(p.numel() for p in convert.jax_leaves(loop.params))
        state_bytes = sum(x.numel() * x.element_size()
                          for x in convert.jax_leaves(loop._state_tree())
                          if isinstance(x, torch.Tensor))
        log(f"train-loop: {n_params / 1e6:.1f} M params, state (params, "
            f"AdamW m and v, bank, guard) {state_bytes / 1e9:.3f} GB, "
            f"{len(loop.stats_bank)} bank sites")

        rejected, saved, pushes, rollbacks, saves = [], {}, [], [], []
        inner = loop.train_step

        def checked_step(*args):
            batch, step = args[-2], args[-1]
            fires = any(v == step for v in batch["_chaos"].values())
            before = ([x.clone() if isinstance(x, torch.Tensor) else x
                       for x in convert.jax_leaves(args[:-2])]
                      if fires else None)
            out = inner(*args)
            if fires:
                rejected.append((step, out[-1]["guard_ok"].item(),
                                 _leaves_equal(before, convert.jax_leaves(
                                     tuple(out[:-1])))))
            return out

        save = loop.ckpt.save

        def saving(step, tree, blocking=True):
            t0 = time.perf_counter()
            save(step, tree, blocking)
            saves.append((step, time.perf_counter() - t0))
            if step == 4:       # what restore must give back, on the card
                saved[4] = [x.clone() if isinstance(x, torch.Tensor) else x
                            for x in convert.jax_leaves(tree)]

        loop.train_step = checked_step
        loop.ckpt.save = saving
        loop.ring.push = _timed(pushes, loop.ring.push)
        loop.ring.latest = _timed(rollbacks, loop.ring.latest)
        t0 = time.perf_counter()
        history = loop.run(TRAIN_LOOP_STEPS)
        ladder_s = time.perf_counter() - t0
        write_s = loop.ckpt.last_write_seconds
        ladder = _events(loop, ("guard_tripped", "stats_refresh_forced",
                                "rollback"))
        log(f"train-loop ladder: {ladder_s:.1f} s for {len(history)} step "
            f"runs; events {ladder}; rejected steps (step, guard_ok, "
            f"state bit-equal) {rejected}")
        assert ladder == [("guard_tripped", 5), ("guard_tripped", 6),
                          ("stats_refresh_forced", 6), ("guard_tripped", 7),
                          ("rollback", 7)], ladder
        assert [r for r in loop.sink.by_kind("event")
                if r["event"] == "rollback"][0]["to_step"] == 4
        assert [(s, ok, eq) for s, ok, eq in rejected] == [
            (5, 0.0, True), (6, 0.0, True), (7, 0.0, True)], rejected
        watch = [r for r in loop.sink.by_kind("event")
                 if r["event"] == "watchdog"]
        trips = [(r["step"], round(r["dt_s"], 3), round(r["median_s"], 3))
                 for r in watch]
        log(f"train-loop watchdog trips (step, s, median s): {trips}")
        assert 9 in [r["step"] for r in watch], watch
        health = loop.sink.by_kind("site_health")
        assert {r["site"] for r in health} == set(loop.stats_bank)
        assert all(math.isfinite(r[f]) for r in health
                   for f in TELE_FIELDS + ("alpha", "beta", "staleness"))
        worst = max(health, key=lambda r: (r["sat_frac"], r["uflow_frac"]))
        log(f"train-loop telemetry: {len(health)} site-direction records "
            f"at steps {sorted({r['step'] for r in health})}, all finite; "
            f"largest sat_frac {worst['sat_frac']:.3g} at {worst['site']}."
            f"{worst['dir']}, its uflow_frac {worst['uflow_frac']:.3g}")
        steady = [r for r in loop.sink.by_kind("train_step")
                  if r["step"] % 4 and r["step"] != 9]
        loop_ms = float(np.mean([r["step_ms"] for r in steady]))
        data_ms = float(np.mean([r["data_ms"] for r in steady]))
        refresh_ms = [(r["step"], round(r["step_ms"], 1))
                      for r in loop.sink.by_kind("train_step")
                      if r["step"] % 4 == 0]
        assert all(math.isfinite(m["loss"]) for m in history)
        final = [x.clone() if isinstance(x, torch.Tensor) else x
                 for x in convert.jax_leaves(loop._state_tree())]
        del loop, inner, save, checked_step, saving
        free_device_memory()

        # the same schedule, rejected by force
        other = launch.build(launch.parse_args(
            TRAIN_LOOP_ARGS + ["--chaos", "reject@5x3"]))
        other.run(TRAIN_LOOP_STEPS)
        assert _events(other, ("guard_tripped", "stats_refresh_forced",
                               "rollback")) == ladder
        got = convert.jax_leaves(other._state_tree())
        equal = _leaves_equal(final, got)
        diff = max(((x.float() - y.float()).abs().max().item()
                    for x, y in zip(final, got)
                    if isinstance(x, torch.Tensor) and x.numel()),
                   default=0.0)
        log(f"train-loop nan_grad@5x3 vs reject@5x3: final states bitwise "
            f"equal {equal}, largest difference {diff:.3g}")
        if not equal:
            table = other.params["embed"]
            tokens = torch.randint(0, table.shape[0], (4, 512), device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(0))

            def embed_grad():
                t = table.detach().requires_grad_(True)
                return torch.autograd.grad(t[tokens].sum() * 1e-3, t)[0]
            log(f"train-loop: the embedding backward (index_put_ with "
                f"accumulate) gives the same bits twice: "
                f"{torch.equal(embed_grad(), embed_grad())}")
        del other, got, final
        free_device_memory()

        # resume past the corrupted newest checkpoint
        resumed = launch.build(launch.parse_args(
            TRAIN_LOOP_ARGS + ["--ckpt-dir", ck_dir, "--resume", "auto"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.maybe_resume()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        quarantined = _events(resumed, ("checkpoint_quarantined",))
        log(f"train-loop resume: {quarantined}, from step "
            f"{resumed.start_step}, {restore_ms:.0f} ms (validate, read, "
            f"copy to the card)")
        assert quarantined == [("checkpoint_quarantined", 8)], quarantined
        assert resumed.start_step == 4
        assert _leaves_equal(saved.pop(4),
                             convert.jax_leaves(resumed._state_tree()))
        log("train-loop resume: the restored state is bit for bit the one "
            "saved at step 4")

        # one compressed save through the cuda_fused codec
        tree = resumed._state_tree()
        cdir = os.path.join(root, "compressed")
        comp = ckpt_mod.CheckpointManager(cdir, compress=True,
                                          backend="cuda_fused")
        t0 = time.perf_counter()
        comp.save(4, tree)
        comp_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = comp.restore(tree)
        torch.cuda.synchronize()
        comp_restore_ms = (time.perf_counter() - t0) * 1e3

        def dir_bytes(d):
            return sum(os.path.getsize(os.path.join(d, n))
                       for n in os.listdir(d))
        raw_bytes = dir_bytes(os.path.join(ck_dir, "step_0000000004"))
        comp_bytes = dir_bytes(os.path.join(cdir, "step_0000000004"))
        counts = path_counts()                    # ... and ends here
        check_counts(counts, TRAIN_LOOP_KERNELS)

        # the compressed leaves against the plain versions of #3 and #4
        leaves, restored = convert.jax_leaves(tree), convert.jax_leaves(back)
        worst = {"max_step": 0, "frac": 0.0, "ulp": 0, "rel": 0.0}
        for i, (x, y) in enumerate(zip(leaves, restored)):
            if not ckpt_mod.compressible(x):
                assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                        else np.array_equal(x, y)), i
                continue
            d = os.path.join(cdir, "step_0000000004")
            pk = torch.from_numpy(np.load(os.path.join(
                d, f"leaf_{i:05d}.payload.npy"))).to(dev).view(
                    torch.float8_e5m2)
            ab = torch.from_numpy(np.load(os.path.join(
                d, f"leaf_{i:05d}.stats.npy"))).to(dev)
            pp, abp = sq.quant_plain(x, "e5m2")
            f = flips(code_ordinal(pk), code_ordinal(pp))
            ref = sq.dequant_plain(pk, ab)
            rel = ((y - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
            worst = {"max_step": max(worst["max_step"], f["max_step"]),
                     "frac": max(worst["frac"], f["frac"]),
                     "ulp": max(worst["ulp"], ulps(ab, abp)),
                     "rel": max(worst["rel"], rel)}
        log(f"train-loop compressed checkpoint against the plain codec: "
            f"{worst}")
        assert worst["max_step"] <= 1 and worst["frac"] <= 1e-4
        assert worst["ulp"] <= 4 and worst["rel"] <= 1e-6
        del back, leaves, restored
        free_device_memory()

        # the bare step beside TrainLoop's span, steady steps 5-7: the
        # guarded step as the loop ran it, and the same step built without
        # the guard (its verdict's host read is the sync between the
        # backward and the optimizer), in the order guarded, unguarded,
        # unguarded, guarded on the resumed state and the same batches;
        # step 5 of each run of three reads the cold sites of a bank the
        # other step built, so the means are over steps 6 and 7
        unguarded = launch.build(launch.parse_args(
            [a for a in TRAIN_LOOP_ARGS if a != "--guard"])).train_step
        free_device_memory()
        bare, bare_unguarded = [], []
        state = list(resumed._state_tree())
        for guarded in (True, False, False, True):
            for s in (5, 6, 7):
                batch = resumed.data_fn(s)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if guarded:
                    out = resumed.train_step(*state, batch, s)
                else:
                    out = unguarded(*state[:3], batch, s)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if guarded:
                    assert out[-1]["guard_ok"].item() == 1.0, s
                    bare.append((s, ms))
                    state = list(out[:-1])
                else:
                    bare_unguarded.append((s, ms))
                    state[:3] = out[:-1]
                assert math.isfinite(out[-1]["loss"].item())

        del tree, state, resumed, unguarded
        free_device_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    bare_ms = float(np.mean([ms for s, ms in bare if s != 5]))
    unguarded_ms = float(np.mean([ms for s, ms in bare_unguarded if s != 5]))
    blocking = [round(s, 3) for _, s in saves]
    phase_s = time.perf_counter() - t_phase
    metrics = {
        "params": n_params, "state_gb": state_bytes / 1e9,
        "loop_steady_step_ms": loop_ms, "bare_steady_step_ms": bare_ms,
        "unguarded_steady_step_ms": unguarded_ms,
        "bare_step_ms": bare, "unguarded_step_ms": bare_unguarded,
        "loop_data_ms": data_ms, "refresh_step_ms": refresh_ms,
        "ckpt_blocking_s": blocking, "ckpt_write_s": write_s,
        "ckpt_write_gb_per_s": raw_bytes / 1e9 / write_s,
        "raw_bytes": raw_bytes, "compressed_bytes": comp_bytes,
        "compressed_save_s": comp_save_s,
        "compressed_restore_ms": comp_restore_ms,
        "snapshot_push_ms": pushes, "rollback_ms": rollbacks,
        "restore_ms": restore_ms, "reject_vs_nan_bitwise": equal,
        "reject_vs_nan_max_diff": diff, "ladder_s": ladder_s,
        "phase_s": phase_s}
    log(f"train-loop: steady step {loop_ms:.1f} ms in TrainLoop (span, "
        f"data {data_ms:.2f} ms) against {bare_ms:.1f} ms bare "
        f"({unguarded_ms:.1f} ms bare without the guard; (step, ms) "
        f"{[(s, round(ms, 1)) for s, ms in bare]} guarded, "
        f"{[(s, round(ms, 1)) for s, ms in bare_unguarded]} not); refresh "
        f"steps (step, ms) {refresh_ms}; checkpoint blocking {blocking} "
        f"s, write {write_s:.2f} s ({raw_bytes / 1e9 / write_s:.2f} GB/s); "
        f"{raw_bytes / 1e9:.3f} GB raw, {comp_bytes / 1e9:.3f} GB "
        f"compressed (save {comp_save_s:.2f} s, restore "
        f"{comp_restore_ms:.0f} ms); snapshot push "
        f"{[round(x) for x in pushes]} ms, rollback "
        f"{[round(x) for x in rollbacks]} ms, restore {restore_ms:.0f} ms; "
        f"phase {phase_s:.1f} s")
    log("train-loop metrics: " + json.dumps(metrics))
    log("train-loop launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def phase_train(dev, profile: bool = False) -> dict:
    """Full-width minicpm_2b (40 layers, remat) trained through the port's
    entry points: seeded params, seeded Markov batches of 4 x 512 tokens,
    ``statsbank.init_bank`` (one probe pass), then 4 steps of
    ``make_train_step`` with the bank at k = 8 (step 0 bootstraps every
    site, steps 1-3 are steady), AdamW.  Returns the kernel launch counts
    of this phase and its metrics.  With ``profile``, one more steady step
    runs under torch.profiler afterwards.  Model FLOP/s count 6 * N * T
    with N every parameter (the tied embedding is the head's GEMM)."""
    from repro_torch.configs import get_config
    cfg = get_config("minicpm_2b")
    return _train_run(dev, cfg, "train", "wsd", cfg.n_params(),
                      TRAIN_KERNELS, profile)


def phase_train_moe(dev, profile: bool = False) -> dict:
    """Full-width deepseek_moe_16b cut to its first 4 layers (dense_first +
    3 moe; ``dataclasses.replace`` of n_layers and pattern only, printed by
    ``launch.train.cut_depth``), trained as ``phase_train`` trains minicpm:
    batch 4 x 512, bank k = 8, AdamW, remat, 4 steps, cosine schedule.
    Model FLOP/s count 6 * N_active * T with N_active the weights one
    token's GEMMs read: attention, router, its top-6 of 64 routed experts,
    the 2 shared experts, the dense first layer's MLP and the untied head —
    the embedding table (a lookup) is left out.  The capacity dispatch
    computes more than that (64 experts x capacity 256 = 16,384
    token-expert slots for 12,288 routed pairs), and the remat replay is
    not counted either."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    cfg = cut_depth(get_config("deepseek_moe_16b"), 4)
    n_active = cfg.n_active_params() - cfg.vocab * cfg.d_model
    log(f"train-moe: N_active {n_active / 1e9:.4f} B of "
        f"{cfg.n_params() / 1e9:.4f} B params")
    return _train_run(dev, cfg, "train-moe", "cosine", n_active,
                      TRAIN_MOE_KERNELS, profile)


def phase_train_exact(dev, profile: bool = False) -> dict:
    """Full-width minicpm_2b as ``phase_train`` trains it, but with exact
    per-call stats (no bank) on the cuda_fused engine and the payload
    GEMMs, 3 steps: every stats reduction in the stats kernel, every
    operand and cotangent quantized by the quantize-with-stats kernel, the
    embedding table truncated by the fused truncate.  Then one more step
    of the same model on the cuda engine (the same kernels, the stats from
    torch reductions), timed beside it and not counted."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    cfg = get_config("minicpm_2b")
    return _train_run(dev, cfg, "train-exact", "wsd", cfg.n_params(),
                      TRAIN_EXACT_KERNELS, profile,
                      pol=make_policy("s2fp8", "cuda_fused", "payload"),
                      refresh_every=0, steps=3,
                      compare=make_policy("s2fp8", "cuda", "payload"))


def phase_train_fig4(dev, profile: bool = False) -> dict:
    """Full-width minicpm_2b in fig4 mode on the cuda_fused engine, exact
    stats, 3 steps at batch 4 x 512: every GEMM the Fig. 4 chain (the
    operands, the output and, on the way back, the cotangent and both
    operand gradients through the fused truncate kernel, around an f32
    torch.matmul / einsum with TF32 off), attention the masked softmax
    with its two einsums through the chain (seq 512 <= 2048)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    cfg = get_config("minicpm_2b")
    log(f"train-fig4: f32 products, TF32 allowed: "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    return _train_run(dev, cfg, "train-fig4", "wsd", cfg.n_params(),
                      TRAIN_FIG4_KERNELS, profile,
                      pol=make_policy("s2fp8", "cuda_fused", "fig4"),
                      refresh_every=0, steps=3)


TRAIN_MAMBA_LAYERS = 4    # of falcon_mamba_7b's 64: 64 would need ~116 GB


def phase_train_zamba2(dev, profile: bool = False) -> dict:
    """Full-width, full-depth zamba2_1p2b (38 layers: 32 mamba2, 6 attn;
    1.35 B params, 21.6 GB of f32 params, gradients and AdamW state)
    trained as ``phase_train`` trains minicpm: batch 4 x 512, bank k = 8,
    payload GEMMs on the cuda engine, remat, 4 steps, its cosine schedule:
    the per-head scan and its backward kernel at every mamba2 layer (the
    remat replay reruns the scan's forward), the payload flash at the
    attention layers.  Model FLOP/s count 6 * N * T with N every
    parameter."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_1p2b")
    return _train_run(dev, cfg, "train-zamba2", cfg.schedule, cfg.n_params(),
                      TRAIN_ZAMBA2_KERNELS, profile)


def phase_train_mamba(dev, profile: bool = False) -> dict:
    """Full-width falcon_mamba_7b (d 4096, di 8192, 16 states, dt rank 256,
    vocab 65,024 untied) cut to its first TRAIN_MAMBA_LAYERS = 4 of 64
    layers (``launch.train.cut_depth``: 64 layers would be about 116 GB of
    f32 params, gradients and AdamW state; 4 are 0.96 B params, 15.3 GB),
    trained as ``phase_train_zamba2`` trains: the per-channel scan and its
    backward kernel at every layer, no attention.  Model FLOP/s count 6 *
    N * T with N every parameter."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    cfg = cut_depth(get_config("falcon_mamba_7b"), TRAIN_MAMBA_LAYERS)
    return _train_run(dev, cfg, "train-mamba", cfg.schedule, cfg.n_params(),
                      TRAIN_MAMBA_KERNELS, profile)


def _train_run(dev, cfg, label, schedule, n_flop, expected, profile, *,
               pol=None, refresh_every=8, steps=4, compare=None, batch=4,
               seq=512) -> dict:
    """``steps`` train steps of ``cfg`` at ``batch`` x ``seq`` under
    ``pol`` (default: s2fp8 on the cuda engine), with the bank at
    ``refresh_every`` or (0) exact per-call stats; ``compare``: one more
    step under that policy, timed and not counted."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tlm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    pol = pol or make_policy("s2fp8")
    t0 = time.perf_counter()
    params = tlm.init_lm(cfg, seed=0, device=dev)
    opt = optimizers.adamw(weight_decay=0.01)
    opt_state = opt.init(params)
    chain = synthetic.markov_chain(0, cfg.vocab)
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic.lm_batch(chain, gen, batch, seq, dev)
               for _ in range(steps + 1)]
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name} {cfg.n_layers} layers {cfg.resolved_pattern[:4]}"
        f"..., d={cfg.d_model}, remat {cfg.remat}, "
        f"{cfg.n_params() / 1e9:.3f} B params, batch {batch} x seq {seq}, "
        f"set-up {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    loss_fn = _lm_loss(cfg)
    stats = (statsbank.StatsConfig(refresh_every=refresh_every)
             if refresh_every else None)
    sched = schedules.make_schedule(schedule, 3e-4, total_steps=steps,
                                    warmup=1)
    step_fn = _stepper(make_train_step(loss_fn, opt, sched, pol,
                                       stats=stats))
    gemm = ("payload" if pol.uses_payload_gemm else "fig4"
            if pol.mode in ("s2fp8", "s2fp8_e4m3") else "-")
    log(f"{label}: policy {pol.mode}, loss scale "
        f"{pol.loss_scale if pol.mode == 'fp8_ls' else 1.0}, attention "
        f"{cfg.attn_impl}, engine {pol.backend_obj.name}, gemm {gemm}, "
        f"{f'bank k = {refresh_every}' if stats else 'exact stats'}")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    t0 = time.perf_counter()
    bank = (statsbank.init_bank(loss_fn, params, batches[0], pol, stats)
            if stats else None)
    torch.cuda.synchronize()
    t_probe = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, auxes, step_ms, step_peak, step_launches = [], [], [], [], []
    for i in range(steps):
        before = kernels.counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        params, opt_state, bank, m = step_fn(params, opt_state, bank,
                                             batches[i + 1], i)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        step_launches.append({k: c["launches"] - before[k]["launches"]
                              for k, c in kernels.counts().items()})
        step_peak.append(torch.cuda.max_memory_allocated() / 1e9)
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"{label} step {i}: loss {losses[-1]:.4f}, aux {auxes[-1]:.5f}, "
            f"grad_norm {float(m['grad_norm']):.3f}, refreshed "
            f"{m.get('stats_refreshed', 1.0):.0f}, {step_ms[-1]:.1f} ms, "
            f"peak {step_peak[-1]:.2f} GB")
    counts = path_counts()                        # ... and ends here
    compare_ms = None
    if compare is not None:
        cmp_fn = _stepper(make_train_step(loss_fn, opt, sched, compare))
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, opt_state, _, m = cmp_fn(params, opt_state, None,
                                         batches[-1], steps)
        loss_c = float(m["loss"])
        torch.cuda.synchronize()
        compare_ms = (time.perf_counter() - ts) * 1e3
        assert math.isfinite(loss_c), loss_c
        log(f"{label}: one more step on the {compare.backend_obj.name} "
            f"engine (torch-reduction stats): {compare_ms:.1f} ms, loss "
            f"{loss_c:.4f}; {pol.backend_obj.name} steps 1-{steps - 1} "
            f"{float(np.mean(step_ms[1:])):.1f} ms mean")
    if profile:
        state = {"p": params, "o": opt_state, "b": bank}

        def one_step():
            state["p"], state["o"], state["b"], _ = step_fn(
                state["p"], state["o"], state["b"], batches[-1], steps + 1)
        profile_window(f"{label}: 1 steady train step (step {steps + 1})",
                       one_step)
        memory_by_stage(loss_fn, opt, pol, stats, state, batches[-1],
                        steps + 2)

    assert all(math.isfinite(x) for x in losses + auxes), (losses, auxes)
    check_counts(counts, expected)
    tokens = batch * seq
    steady_ms = float(np.mean(step_ms[1:] or step_ms))
    metrics = {
        "steps": steps, "tokens_per_step": tokens, "losses": losses,
        "aux": auxes, "step_ms": step_ms, "step0_ms": step_ms[0],
        "steady_step_ms_mean": steady_ms,
        "tokens_per_s": tokens / steady_ms * 1e3,
        "flop_params": n_flop,
        "model_tflop_per_s_6NT": 6.0 * n_flop * tokens / steady_ms / 1e9,
        "probe_s": t_probe, "bank_sites": len(bank) if bank else 0,
        "step_peak_gb": step_peak, "max_memory_allocated_gb": peak / 1e9,
        "launches_step0": step_launches[0],
        "launches_steady_step": step_launches[-1],
        "compare_step_ms": compare_ms,
    }
    log(f"{label} metrics: " + json.dumps(metrics))
    log(f"{label} launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def phase_train_modes(dev, profile: bool = False) -> dict:
    """Full-width minicpm_2b trained 2 steps in each of the paper's
    baselines at batch 4 x 512 (AdamW, remat, WSD): ``bf16`` (bf16
    operands, f32 products of the exactly upcast operands, f32 results)
    and ``fp8_ls`` (raw e5m2 truncations around every GEMM, the loss
    scaled by 100 before the backward and the gradients unscaled after,
    Eq. 6).  These modes are casts and f32 torch products: no kernel of
    this repository may launch and no plain version run; every loss must
    be finite.  Returns the launch counts (all zero) and each mode's
    metrics."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    cfg = get_config("minicpm_2b")
    out = {"counts": None, "metrics": {}}
    for mode in ("bf16", "fp8_ls"):
        run = _train_run(dev, cfg, f"train-modes {mode}", "wsd",
                         cfg.n_params(), (), profile,
                         pol=make_policy(mode, "cuda", loss_scale=100.0),
                         refresh_every=0, steps=2)
        launched = {k: c["launches"] for k, c in run["counts"].items()
                    if c["launches"]}
        assert not launched, f"{mode} launched kernels: {launched}"
        out["counts"] = run["counts"]
        out["metrics"][mode] = run["metrics"]
        free_device_memory()
    return out


def phase_train_long(dev, profile: bool = False) -> dict:
    """Full-width minicpm_2b (40 layers, remat) at batch 1 x 4096 tokens,
    above the 2048 at which a block leaves the full attention, s2fp8
    payload on the cuda engine with the bank at k = 8: 2 steps with
    ``attn_impl="flash"`` (the payload flash node: ``qflash_fwd`` and
    ``qflash_bwd`` at S 4096 beside every training kernel, no plain
    version), then 1 step with ``attn_impl="naive"`` (the chunked
    attention, 1024 x 1024 chunks in f32 plain torch ops as the
    reference's pure-JAX scan, differentiated op by op in the remat
    replay: about 0.15 GB of f32 scores a chunk pair and head set, 16
    pairs a layer, beside the ~44 GB of params, AdamW state and
    gradients).  Step ms and peak memory are printed; every loss finite.
    Returns each run's launch counts and metrics."""
    from repro_torch.configs import get_config
    base = get_config("minicpm_2b")
    runs = {}
    for impl, steps, expected in (("flash", 2, TRAIN_KERNELS),
                                  ("naive", 1, TRAIN_NAIVE_KERNELS)):
        cfg = base.replace(attn_impl=impl)
        runs[impl] = _train_run(dev, cfg, f"train-long {impl}", "wsd",
                                cfg.n_params(), expected, profile,
                                steps=steps, batch=1, seq=FLASH_LONG_S)
        free_device_memory()
    return runs


def phase_serve_dense(dev) -> dict:
    """Full-width minicpm_2b (40 layers) through ``serve_dense_run``."""
    from repro_torch.configs import get_config
    return serve_dense_run(dev, "serve-dense", get_config("minicpm_2b"))


def serve_dense_run(dev, label, cfg) -> dict:
    """``cfg`` from seed 0 served through the dense-cache LMServer: 8
    slots, max_len 1024 (f32 K/V caches; a ``local`` layer's a ring of its
    window), the first 8 requests of phase 5's seeded prompts (64-700
    tokens), 16 new tokens each; s2fp8 with exact per-call stats on the
    cuda_fused engine and payload GEMMs (no bank).  Prefill attends
    through the payload flash forward; every decode step writes each
    slot's K/V at its position (a ring slot in a local layer) and runs
    ``decode_attention``, whose two einsums are the batched payload GEMM
    over (slot, head) groups of one query row.  Every kernel of the path
    must launch and no plain version may run; every logit row finite.
    Returns the launch counts and metrics (tok/s over
    ``run_to_completion``, prefill ms per call, decode ms per tick, peak
    device memory)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.engine import LMServer, Request

    pol = make_policy("s2fp8", "cuda_fused", "payload")
    t0 = time.perf_counter()
    params = tlm.init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name} {cfg.n_layers} layers "
        f"{cfg.resolved_pattern[:6]}..., d={cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, "
        f"{cfg.n_params() / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s; engine {pol.backend_obj.name}, "
        f"payload GEMMs, exact stats")
    rng, _, prompt_lens = serve_prompts(cfg.vocab)
    prompt_lens = prompt_lens[:8]
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32), max_new_tokens=16)
            for n in prompt_lens]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    server = LMServer(cfg, params, pol, slots=8, max_len=1024)
    timing = {"prefill": [], "decode": []}
    prefill, decode = server._prefill, server._decode

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*args)
            assert bool(torch.isfinite(out[0].float()).all()), kind
            torch.cuda.synchronize()
            timing[kind].append((time.perf_counter() - ts) * 1e3)
            return out
        return run

    server._prefill = timed("prefill", prefill)
    server._decode = timed("decode", decode)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        assert len(r.out) == 16, ("request did not complete", len(r.out))
        assert all(0 <= t < cfg.vocab for t in r.out)
    check_counts(counts, SERVE_DENSE_KERNELS)
    if cfg.window:
        # every local layer's cache is a ring of the window's positions
        for (btype, _), seg in zip(tlm.segments_of(cfg), server.caches):
            assert seg["k"].shape[3] == (min(1024, cfg.window)
                                         if btype == "local" else 1024)
    tokens = sum(len(r.out) for r in reqs)
    metrics = {
        "requests": len(reqs), "tokens": tokens, "ticks": ticks,
        "prompt_tokens": int(prompt_lens.sum()),
        "wall_s": wall, "tok_per_s": tokens / wall,
        "prefill_calls": len(timing["prefill"]),
        "prefill_ms": timing["prefill"],
        "decode_ticks": len(timing["decode"]),
        "decode_ms_median": float(np.median(timing["decode"])),
        "decode_ms_mean": float(np.mean(timing["decode"])),
        "prefill_shapes": sorted(server.prefill_shapes),
        "max_memory_allocated_gb": peak / 1e9,
        "cache_bytes": server.cache_bytes(),
    }
    log(f"{label} metrics: " + json.dumps(metrics))
    log(f"{label} launches: " + json.dumps(counts))
    for i, r in enumerate(reqs[:2]):
        log(f"  req{i} ({len(r.prompt)} prompt tokens): {r.out[:8]}...")
    return {"counts": counts, "metrics": metrics}


def phase_serve_mamba(dev, profile: bool = False) -> dict:
    """Full-width falcon_mamba_7b at full depth (64 mamba1 layers) through
    ``serve_ssm_run``."""
    from repro_torch.configs import get_config
    return serve_ssm_run(dev, "serve-mamba", get_config("falcon_mamba_7b"),
                         SERVE_MAMBA_KERNELS, profile)


def phase_serve_zamba2(dev) -> dict:
    """Full-width zamba2_1p2b at full depth (32 mamba2 layers of 64 heads
    x 64 channels with 64 states, 6 attention layers of 32 heads x 64,
    GELU-GLU, vocab 32,000 untied) through ``serve_ssm_run``: the prefill
    runs the per-head scan once a mamba2 layer and the payload flash at
    the attention layers, the decode the reference's recurrence step and
    the dense-cache attention on the batched payload GEMM."""
    from repro_torch.configs import get_config
    return serve_ssm_run(dev, "serve-zamba2", get_config("zamba2_1p2b"),
                         SERVE_ZAMBA2_KERNELS)


def serve_ssm_run(dev, label, cfg, expected, profile: bool = False) -> dict:
    """``cfg`` through the port's entry points: seeded params
    (``init_lm``), then LMServer with 8 slots serving 8 requests (prompts
    of 64-512 tokens from a seeded generator, 16 new tokens each), s2fp8
    with exact per-call stats on the cuda_fused engine and payload GEMMs
    (no bank).  Every prefill must run the selective-scan kernel once per
    mamba layer.  Returns the kernel launch counts of this phase and its
    metrics (tok/s over ``run_to_completion``, prefill ms per call,
    decode ms per tick, peak device memory).  With ``profile``, an
    admission tick and five decode ticks of 8 more requests run under
    torch.profiler afterwards."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.engine import LMServer, Request

    pol = make_policy("s2fp8", "cuda_fused", "payload")
    t0 = time.perf_counter()
    params = tlm.init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    ssm_layers = sum(b.startswith("mamba") for b in cfg.resolved_pattern)
    log(f"{label}: {cfg.name} {cfg.n_layers} layers ({ssm_layers} mamba), "
        f"d={cfg.d_model}, di {cfg.ssm.expand * cfg.d_model}, state "
        f"{cfg.ssm.state}, vocab {cfg.vocab}, {cfg.n_params() / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; engine "
        f"{pol.backend_obj.name}, payload GEMMs, exact stats")
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 513, 8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32), max_new_tokens=16)
            for n in prompt_lens]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    server = LMServer(cfg, params, pol, slots=8, max_len=1024)
    timing = {"prefill": [], "decode": []}
    scans_per_prefill = []
    prefill, decode = server._prefill, server._decode

    def timed(kind, fn):
        def run(*args):
            before = kernels.counts()["selective_scan"]["launches"]
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*args)
            assert bool(torch.isfinite(out[0].float()).all()), kind
            torch.cuda.synchronize()
            timing[kind].append((time.perf_counter() - ts) * 1e3)
            if kind == "prefill":
                scans_per_prefill.append(
                    kernels.counts()["selective_scan"]["launches"] - before)
            return out
        return run

    server._prefill = timed("prefill", prefill)
    server._decode = timed("decode", decode)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        assert len(r.out) == 16, ("request did not complete", len(r.out))
        assert all(0 <= t < cfg.vocab for t in r.out)
    check_counts(counts, expected + ("qmatmul_nn/small",))
    assert scans_per_prefill and all(
        n == ssm_layers for n in scans_per_prefill), scans_per_prefill
    tokens = sum(len(r.out) for r in reqs)
    metrics = {
        "requests": len(reqs), "tokens": tokens, "ticks": ticks,
        "prompt_tokens": int(prompt_lens.sum()),
        "wall_s": wall, "tok_per_s": tokens / wall,
        "prefill_calls": len(timing["prefill"]),
        "prefill_ms": timing["prefill"],
        "prefill_ms_mean": float(np.mean(timing["prefill"])),
        "decode_ticks": len(timing["decode"]),
        "decode_ms_median": float(np.median(timing["decode"])),
        "decode_ms_mean": float(np.mean(timing["decode"])),
        "prefill_shapes": sorted(server.prefill_shapes),
        "scans_per_prefill": scans_per_prefill,
        "max_memory_allocated_gb": peak / 1e9,
        "cache_bytes": server.cache_bytes(),
    }
    log(f"{label} metrics: " + json.dumps(metrics))
    log(f"{label} launches: " + json.dumps(counts))
    for i, r in enumerate(reqs[:2]):
        log(f"  req{i} ({len(r.prompt)} prompt tokens): {r.out[:8]}...")
    if profile:
        server._prefill, server._decode = prefill, decode
        phase_profile(server)
    return {"counts": counts, "metrics": metrics}


def phase_ops(dev) -> dict:
    """Each function of ``repro_torch.kernels.ops`` once on CUDA tensors
    (``use_kernel=None``): quantize and dequantize a 1024 x 2304 f32
    activation, truncate it, multiply its payload by a 2304 x 576 weight's,
    and flash attention over 2 x 8 heads x 256 x 64 (causal).  Every one's
    kernel must launch and no plain version may run.  Each result is then
    held against the oracle (``use_kernel=False``): quantize within 4 ulp
    on (alpha, beta) and codes one step apart in at most 1e-3 of the
    elements (kernel stats sum in f64, the oracle's in f32); dequantize
    within 1e-6 relative; truncate codes one step apart in at most 1e-4;
    the GEMM within 1e-5 * max |oracle|; attention allclose at rtol 2e-4,
    atol 2e-5."""
    from repro_torch import kernels
    from repro_torch.core import s2fp8
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1024, 2304, generator=gen, device=dev) * 0.05
    w = torch.randn(2304, 576, generator=gen, device=dev) / 48.0
    q, k, v = (torch.randn(2, 8, 256, 64, generator=gen, device=dev)
               for _ in range(3))
    kernels.reset_counts()                        # the ops start here
    px, ax, bx = ops.s2fp8_quant(x)
    pw, aw, bw = ops.s2fp8_quant(w)
    dx = ops.s2fp8_dequant(px, ax, bx)
    tx = ops.s2fp8_truncate(x)
    y = ops.s2fp8_matmul(px, ax, bx, pw, aw, bw)
    o = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = path_counts()                        # ... and end here
    check_counts(counts, OPS_KERNELS)

    po, ao, bo = ops.s2fp8_quant(x, use_kernel=False)
    u = ulps(torch.stack([ax, bx]), torch.stack([ao, bo]))
    fq = flips(code_ordinal(px), code_ordinal(po))
    ed = ((dx - ops.s2fp8_dequant(px, ax, bx, use_kernel=False)).abs()
          / dx.abs().clamp(min=1e-30)).max().item()
    to = ops.s2fp8_truncate(x, use_kernel=False)
    ab = s2fp8.compute_stats(x)         # the stats both truncations use
    ft = flips(ordinal(tx, ab, "e5m2"), ordinal(to, ab, "e5m2"))
    yo = ops.s2fp8_matmul(px, ax, bx, pw, aw, bw, use_kernel=False)
    ey, ty = (y - yo).abs().max().item(), yo.abs().max().item()
    oo = ops.flash_attention(q, k, v, causal=True, use_kernel=False)
    eo = (o - oo).abs()
    log(f"ops: quant stats {u} ulp, flips {fq}; dequant rel err {ed:.2e}; "
        f"truncate flips {ft}; matmul err {ey:.3e} of {ty:.3e}; attention "
        f"err {eo.max().item():.3e}")
    assert u <= 4 and fq["max_step"] <= 1 and fq["frac"] <= 1e-3, (u, fq)
    assert ed <= 1e-6 and ey <= 1e-5 * ty, (ed, ey, ty)
    assert ft["max_step"] <= 1 and ft["frac"] <= 1e-4, ft
    assert bool((eo <= 2e-5 + 2e-4 * oo.abs()).all()), eo.max().item()
    log("ops launches: " + json.dumps(counts))
    return {"counts": counts}


def _stepper(train_step):
    """``step(params, opt_state, bank, batch, i) -> (params, opt_state,
    bank, metrics)`` for a banked or a bank-less train step (bank None)."""
    def step(params, opt_state, bank, batch, i):
        if bank is None:
            params, opt_state, m = train_step(params, opt_state, batch, i)
            return params, opt_state, None, m
        return train_step(params, opt_state, bank, batch, i)
    return step


def memory_by_stage(loss_fn, opt, pol, stats, state, batch, step) -> None:
    """Peak and live device memory of one more steady train step, stage by
    stage: the loss function and the optimizer are wrapped, so the peaks
    split at the end of the forward and at the start of the update."""
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    gb = 1e9
    marks = []

    def mark(stage):
        torch.cuda.synchronize()
        marks.append((stage, torch.cuda.max_memory_allocated() / gb,
                      torch.cuda.memory_allocated() / gb))
        torch.cuda.reset_peak_memory_stats()

    def loss_marked(params, batch_, policy):
        out = loss_fn(params, batch_, policy)
        mark("forward")
        return out

    def update_marked(grads, opt_state, params, lr):
        mark("backward")
        out = opt.update(grads, opt_state, params, lr)
        mark("update")
        return out

    step_fn = _stepper(make_train_step(
        loss_marked, optimizers.Optimizer(opt.init, update_marked),
        schedules.constant(3e-4), pol, stats=stats))
    mark("before")
    state["p"], state["o"], state["b"], _ = step_fn(
        state["p"], state["o"], state["b"], batch, step)
    log("train memory by stage (peak GB during, live GB after): " + ", ".join(
        f"{stage} {peak:.2f} / {live:.2f}" for stage, peak, live in marks))


# device ms and launches by kernel function, summed over every
# profile_window of the run
PROFILED: dict = {}


def kernel_function(key: str) -> str:
    """The function name of a profiler kernel key ("void (anonymous
    namespace)::quant_apply_kernel<float, 1>(float const*, ...)" ->
    "quant_apply_kernel")."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split()[-1].split("::")[-1] if head else key


def log_profiled_totals() -> None:
    """The repo's own kernels (functions defined in src/repro_torch/csrc)
    by device ms summed over every profiled window of the run."""
    text = "".join(p.read_text() for p in
                   (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    ours = [(ms, n, fn) for fn, (ms, n) in PROFILED.items()
            if re.search(rf"\b{re.escape(fn)}\s*\(", text)]
    for ms, n, fn in sorted(ours, reverse=True):
        log(f"profiled total {fn}: {ms:.3f} device ms in {n} launches "
            f"over every profiled window")


def profile_window(label: str, fn) -> None:
    """Device time by kernel and the device's idle share while ``fn`` runs,
    with torch.profiler (CPU + CUDA activities); each kernel function's
    time and launches are added to PROFILED."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue        # host ops; their kernels are listed apart
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
            ms, n = PROFILED.get(kernel_function(e.key), (0.0, 0))
            PROFILED[kernel_function(e.key)] = (ms + dev_us / 1e3,
                                                n + e.count)
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, count, key in rows[:14]:
        log(f"  {ms:9.2f} ms  {count:7d}x  {key[:90]}")


def phase_profile(server) -> None:
    """Optional (--profile): two windows of the full-width server — one
    admission tick (8 prompts of 256 tokens: a prefill at bucket 256, then
    a decode) and five decode ticks."""
    import numpy as np
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    for _ in range(8):
        server.submit(Request(prompt=rng.integers(
            0, server.cfg.vocab, 256, dtype=np.int32), max_new_tokens=12))

    def ticks(n):
        return lambda: [server.step() for _ in range(n)]

    profile_window("admission tick (prefill bucket 256 x 8 rows + decode)",
                   ticks(1))
    profile_window("5 decode ticks", ticks(5))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the attention-family configs: phase 3's rows at the wide head dims, and
# the phases small-families, train-gemma3, serve-gemma3, serve-stablelm and
# serve-nemotron
# ---------------------------------------------------------------------------

# (shape label, query heads BH, tokens S, query heads a K/V head g, window)
# of the flash kernels above head dim 128: a 16-head causal shape at 2,048
# tokens, and gemma3_1b's training attention (4 query heads on 1 K/V head,
# 4,096 tokens) in its global layers (causal) and its local ones (window
# 512), the kept shape
WIDE_FLASH = [("16h S2048", 16, 2048, 1, None),
              ("gemma3 S4096 global", 4, 4096, 4, None),
              ("gemma3 S4096 window512", 4, 4096, 4, 512)]
WIDE_DIMS = (160, 192, 256)
# kimi_k2_1t_a32b's routed experts on the batched GEMM (gate / up
# ecd,edf->ecf: K 7,168, N 2,048) at decode (M 8) and at a prefill
# capacity (M 1,024), over 64 of its 384 experts (each expert's product is
# independent; 64 keep the f32 sources under 4 GB)
GEMMS_BATCHED_KIMI = [("nn", 64, 64, None, 8, 7168, 2048),
                      ("nn", 64, 64, None, 1024, 7168, 2048)]


# the payload GEMMs of the attention family's full-width phases, (row,
# [(M, K, N), ...]) per layout, each list's last case the row's kept
# shape.  gemma3_1b (d 1,152, Q 4 x 256, K/V 256, GELU-GLU 6,912, tied
# head 262,144): serve-gemma3's decode (8 slots: the small path) and its
# tied head's NT there, its prefill (8 rows x buckets 256 and 1,024);
# train-gemma3's forward NN, backward NT (dX) and TN (dW) at batch 1 x
# 4,096, the tied head's among them (NT forward, NN dX over K = 262,144,
# TN dW).  stablelm_12b (d 5,120 = Q, K/V 1,280, SiLU-GLU 13,824, untied
# head 100,352) and nemotron_4_340b (d 18,432 = Q, K/V 1,536, squared-ReLU
# 73,728, untied head 256,000): decode and the head at 8 slots, prefill at
# 8 rows x their smallest and largest buckets (stablelm 128 and 1,024;
# nemotron 256, where its 73,728-wide MLP is 5.6 TFLOP a GEMM)
GEMMS_FAMILY = {
    "nn": [("qmatmul_nn decode gemma3", [(8, 1152, 1024), (8, 1152, 256),
                                         (8, 1024, 1152), (8, 6912, 1152),
                                         (8, 1152, 6912)]),
           ("qmatmul_nn gemma3 prefill", [(8 * 256, 1152, 6912),
                                          (8 * 1024, 1152, 1024),
                                          (8 * 1024, 1152, 256),
                                          (8 * 1024, 1024, 1152),
                                          (8 * 1024, 6912, 1152),
                                          (8 * 1024, 1152, 6912)]),
           ("qmatmul_nn gemma3 train", [(4096, 1152, 1024), (4096, 1152, 256),
                                        (4096, 1024, 1152),
                                        (4096, 6912, 1152),
                                        (4096, 262144, 1152),
                                        (4096, 1152, 6912)]),
           ("qmatmul_nn decode stablelm", [(8, 5120, 5120), (8, 5120, 1280),
                                           (8, 13824, 5120),
                                           (8, 5120, 13824)]),
           ("qmatmul_nn decode stablelm head", [(8, 5120, 100352)]),
           ("qmatmul_nn stablelm prefill", [(8 * 128, 5120, 13824),
                                            (8 * 1024, 5120, 5120),
                                            (8 * 1024, 5120, 1280),
                                            (8 * 1024, 13824, 5120),
                                            (8 * 1024, 5120, 13824)]),
           ("qmatmul_nn decode nemotron", [(8, 18432, 18432),
                                           (8, 18432, 1536),
                                           (8, 73728, 18432),
                                           (8, 18432, 73728)]),
           ("qmatmul_nn decode nemotron head", [(8, 18432, 256000)]),
           ("qmatmul_nn nemotron prefill", [(8 * 256, 18432, 18432),
                                            (8 * 256, 18432, 1536),
                                            (8 * 256, 73728, 18432),
                                            (8 * 256, 18432, 73728)])],
    "nt": [("qmatmul_nt decode gemma3 head", [(8, 1152, 262144)]),
           ("qmatmul_nt gemma3 train", [(4096, 1024, 1152), (4096, 256, 1152),
                                        (4096, 1152, 1024),
                                        (4096, 6912, 1152),
                                        (4096, 1152, 6912),
                                        (4096, 1152, 262144)])],
    "tn": [("qmatmul_tn gemma3 train", [(1152, 4096, 1024), (1152, 4096, 256),
                                        (1024, 4096, 1152),
                                        (6912, 4096, 1152),
                                        (1152, 4096, 6912),
                                        (262144, 4096, 1152)])],
}
# (row, [(layout, Ga, Gb, out_batch, M, K, N), ...]) of the batched GEMM in
# the same phases: serve-gemma3's decode attention (8 slots x 1 K/V head,
# its 4 query heads the M rows; K / N 256 over a local ring of 512 and a
# global cache of 1,024), and the decode probes of serve-stablelm's and
# serve-nemotron's calibration (2 rows x 8 K/V heads, 4 or 12 query heads
# of 160 or 192 over 68 positions)
GEMMS_BATCHED_FAMILY = [
    ("qmatmul_batched decode gemma3", [("nt", 8, 8, None, 4, 256, 1024),
                                       ("nn", 8, 8, None, 4, 1024, 256),
                                       ("nn", 8, 8, None, 4, 512, 256),
                                       ("nt", 8, 8, None, 4, 256, 512)]),
    ("qmatmul_batched probe", [("nt", 16, 16, None, 4, 160, 68),
                               ("nn", 16, 16, None, 4, 68, 160),
                               ("nn", 16, 16, None, 12, 68, 192),
                               ("nt", 16, 16, None, 12, 192, 68)]),
]


def family_gemm_checks(dev, rnd, record) -> None:
    """The payload GEMMs at the shapes the attention family's full-width
    phases give them, in rows of their own: ``GEMMS_FAMILY``
    (``gemm_case``: bf16 operands, raw within 1e-5 * (|A| @ |B|) + 1e-30,
    epilogue codes at most one step apart in at most 1e-3 of the outputs)
    and ``GEMMS_BATCHED_FAMILY`` (``batched_case``, the same
    tolerances)."""
    for layout, rows in GEMMS_FAMILY.items():
        for row, shapes in rows:
            for i, (m, k, n) in enumerate(shapes):
                gemm_case(rnd, record, row, layout, m, k, n, torch.bfloat16,
                          keep=i == len(shapes) - 1)
    for row, cases in GEMMS_BATCHED_FAMILY:
        for i, (layout, ga, gb, ob, m, k, n) in enumerate(cases):
            batched_case(rnd, record, row, layout, ga, gb, ob, m, k, n,
                         keep=i == len(cases) - 1)


def _visible(s: int, window, dev) -> torch.Tensor:
    """[S, S] bool: query i sees key j (causal, within ``window``)."""
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    return mask


def flash_case(dev, rnd, record, suffix, d, label, bh, sl, g, window, *,
               keep: bool, f32: bool = True) -> None:
    """#10 / #11 (``qflash_fwd`` / ``qflash_bwd``) and, with ``f32``, #9
    (``flash_fwd``) at one shape (``bh`` query heads x ``sl`` positions of
    head dim ``d``, ``g`` query heads a K/V head, causal, within
    ``window``), held and timed as ``wide_kernel_checks`` says, into rows
    named ``<kernel> <suffix>``."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import flash_attention, s2fp8_quant
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def payload(x):
        ab = s2fp8.compute_stats(x)
        return s2fp8_quant.quant_apply(x, ab), ab

    kw = dict(g=g, window=window)
    (qq, qab) = payload(rnd(bh, sl, d))
    (qk, kab), (qv, vab) = (payload(rnd(bh // g, sl, d))
                            for _ in range(2))
    qg, gab = payload(rnd(bh, sl, d, scale=1e-3))
    sts = (qab, kab, vab)
    shape = (f"d={d} {label}: BH={bh} g={g} S={sl} causal"
             + (f" window {window}" if window else ""))
    mask = _visible(sl, window, dev)
    pairs = int(mask.sum().item())
    raw, lse = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts,
                                                **kw)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(qq, qk, qv, *sts, out_ab=oab,
                                        **kw)
    op, lp = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts,
                                              out_ab=oab, **kw)
    f = flips(ordinal(ok, oab, "e5m2"), ordinal(op, oab, "e5m2"))
    lerr = (lk - lp).abs().max().item()
    log(f"qflash_fwd {shape}: flips {f}, lse err {lerr:.2e}")
    assert f["max_step"] <= 1 and f["frac"] <= 1e-2 \
        and lerr <= 1e-4, (f, lerr)
    same_bits(lambda: flash_attention.qflash_fwd(
        qq, qk, qv, *sts, out_ab=oab, **kw)[0], f"qflash_fwd {shape}")
    deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, ab))
           for t, ab in ((qq, qab), (qk, kab), (qv, vab))]
    q4 = deq[0][None]
    k4, v4 = (t.repeat_interleave(g, 0)[None] for t in deq[1:])

    def library_fwd():
        return (sdpa(q4, k4, v4, attn_mask=mask) if window
                else sdpa(q4, k4, v4, is_causal=True))
    record(f"qflash_fwd {suffix}", (ok - op).abs().max().item(),
           cuda_time(lambda: flash_attention.qflash_fwd(
               qq, qk, qv, *sts, out_ab=oab, **kw)),
           cuda_time(lambda: flash_attention.qflash_fwd_plain(
               qq, qk, qv, *sts, out_ab=oab, **kw), iters=3),
           cuda_time(library_fwd),
           (bh + 2 * bh // g) * sl * d + bh * sl * d * 4
           + bh * sl * 4, 4.0 * bh * pairs * d, shape, keep=keep,
           tensor_cores=True)
    del ok, op, lk, lp

    qo, oab = payload(raw)
    delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))
             * s2fp8.dequantize(s2fp8.S2FP8Tensor(qo, oab))).sum(-1)
    args = (qq, qk, qv, qg, qab, kab, vab, gab, lse, delta)
    got = flash_attention.qflash_bwd(*args, **kw)
    want = flash_attention.qflash_bwd_plain(*args, **kw)
    errs = []
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        e = (x - y).abs().max().item()
        errs.append(e)
        assert bool(torch.isfinite(x).all()), name
        assert e <= 1e-4 * y.abs().max().item(), (name, e)
    log(f"qflash_bwd {shape}: max err dq/dk/dv "
        + " ".join(f"{e:.2e}" for e in errs) + " of max |plain| "
        + " ".join(f"{y.abs().max().item():.2e}" for y in want))
    same_bits(lambda: torch.cat([t.flatten() for t in
                                 flash_attention.qflash_bwd(
                                     *args, **kw)]),
              f"qflash_bwd {shape}")
    del got, want
    leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = (sdpa(*leaves, attn_mask=mask) if window
               else sdpa(*leaves, is_causal=True))
    dout = s2fp8.dequantize(s2fp8.S2FP8Tensor(qg, gab))[None]
    record(f"qflash_bwd {suffix}", max(errs),
           cuda_time(lambda: flash_attention.qflash_bwd(*args, **kw)),
           cuda_time(lambda: flash_attention.qflash_bwd_plain(
               *args, **kw), iters=3),
           cuda_time(lambda: torch.autograd.grad(
               lib_out, leaves, dout, retain_graph=True)),
           2 * bh * sl * d + 2 * (bh // g) * sl * d + 8 * bh * sl
           + 3 * 4 * bh * sl * d, 10.0 * bh * pairs * d, shape,
           keep=keep, tensor_cores=True)
    del args, leaves, lib_out, dout, raw, lse, delta

    if f32:
        # #9, the f32 forward over values (K/V heads broadcast)
        q32, k32, v32 = q4.contiguous(), k4.contiguous(), v4.contiguous()
        fk = flash_attention.flash_attention(q32, k32, v32,
                                             window=window)
        fp = flash_attention.flash_attention_plain(q32, k32, v32,
                                                   window=window)
        torch.testing.assert_close(fk, fp, rtol=2e-4, atol=2e-5)
        same_bits(lambda: flash_attention.flash_attention(
            q32, k32, v32, window=window), f"flash_fwd {shape}")
        record(f"flash_fwd {suffix}", (fk - fp).abs().max().item(),
               cuda_time(lambda: flash_attention.flash_attention(
                   q32, k32, v32, window=window)),
               cuda_time(lambda: flash_attention.flash_attention_plain(
                   q32, k32, v32, window=window), iters=3),
               cuda_time(library_fwd), 4 * 4 * bh * sl * d,
               4.0 * bh * pairs * d, shape + " f32", keep=keep,
               tensor_cores=True)
        del fk, fp, q32, k32, v32
    del q4, k4, v4, deq


def wide_kernel_checks(dev, gen, rnd, record) -> None:
    """The attention kernels at the head dims the widened kernels added
    (rows of their own, named by head dim): #10 / #11 (``qflash_fwd`` /
    ``qflash_bwd``) and #9 (``flash_fwd``, f32) at d 160, 192 and 256 over
    ``WIDE_FLASH`` (kept: gemma3's window-512 shape), held with phase 3's
    tolerances (forward codes at most one step apart in at most 1% of the
    elements, |lse| within 1e-4; dq, dk, dv within 1e-4 * max|plain|; the
    f32 forward allclose rtol 2e-4, atol 2e-5), two launches the same
    bits, and timed beside SDPA on the dequantized f32 tensors (K/V heads
    repeated; the window as a boolean mask; backward by autograd); #12 at
    hd 16 (the reduced configs), 160 (stablelm_12b: 8 K/V heads x 4) and
    192 (nemotron_4_340b: 8 x 12) at serve's positions
    (``paged_decode_checks``); #8 at kimi's expert shapes
    (``GEMMS_BATCHED_KIMI``, ``batched_case``)."""
    for d in WIDE_DIMS:
        for i, (label, bh, sl, g, window) in enumerate(WIDE_FLASH):
            flash_case(dev, rnd, record, f"d{d}", d, label, bh, sl, g,
                       window, keep=i == len(WIDE_FLASH) - 1)

    lens = serve_prompts(100352)[2]
    paged_decode_checks(dev, gen, rnd, record, "paged_decode hd16", 2, 16,
                        lens, g=4)
    paged_decode_checks(dev, gen, rnd, record, "paged_decode hd160", 8, 160,
                        lens, g=4)
    paged_decode_checks(dev, gen, rnd, record, "paged_decode hd192", 8, 192,
                        lens, g=12)
    for i, (layout, ga, gb, ob, m, k, n) in enumerate(GEMMS_BATCHED_KIMI):
        batched_case(rnd, record, "qmatmul_batched kimi", layout, ga, gb, ob,
                     m, k, n)


# (reduced arch, layers, engine, per-step logit bound max / mean, near-tie
# margin): small-reference's and small-formats' bounds, scaled for an
# untied head (logits ~0.8 in size against a tied head's ~0.18) and kept
# at deepseek's for the MoE
FAMILY_MODELS = (("gemma3_1b", 4, "dense", 0.1, 0.02, 0.1),
                 ("stablelm_12b", 2, "payload", 0.5, 0.1, 0.5),
                 ("nemotron_4_340b", 2, "payload", 0.5, 0.1, 0.5),
                 ("chameleon_34b", 2, "payload", 0.5, 0.1, 0.5),
                 ("kimi_k2_1t_a32b", 3, "payload", 0.75, 0.15, 0.2))


def phase_small_families(dev) -> None:
    """The five attention-family configs reduced (``FAMILY_MODELS``), served
    on the card through the kernels and through the plain versions, held
    as small-formats holds them: the paged ones (head dim 16 through the
    paged decode; nemotron's sq_relu and layer norm; kimi's routed experts
    on the batched GEMM) on ``PayloadLMServer`` from a bank calibrated on
    the plain engine, e5m2 pool, 8 requests (prompts 3-30, 6 new tokens,
    4 slots, block 8); gemma3 (local rings of 64 and a dense layer) on the
    dense-cache ``LMServer`` with exact stats, prompts of 5-100 tokens
    (buckets to 128) and 8 new tokens, so that rings wrap at prefill and
    in decode.  The checked engine holds every kernel call against its
    plain version (``checked_engine``'s tolerances); the plain engine is
    then teacher-forced along the checked run's tokens: every step's
    logits within the model's bound, the plain engine's own choice the
    kernels' except at a near tie."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.policy import make_policy
    from repro_torch.launch import api
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import LMServer, PayloadLMServer, Request

    for arch, layers, engine, lim_max, lim_mean, near in FAMILY_MODELS:
        cfg = get_reduced_config(arch).replace(n_layers=layers)
        params = api.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(1)
        dense = engine == "dense"
        if dense:
            lens, new, max_len, bank = (5, 100, 60, 17, 70, 9), 8, 128, None
        else:
            lens, new, max_len = (5, 11, 30, 17, 9, 24, 3, 14), 6, 64
            calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                    device=dev)
            bank = calibrate_serving_bank(
                params, cfg, make_policy("s2fp8", "plain", "payload"), calib,
                passes=2)
        prompts = [rng.integers(1, cfg.vocab, n, dtype=np.int32)
                   for n in lens]

        def server(pol):
            if dense:
                srv = LMServer(cfg, params, pol, slots=FORMAT_SLOTS,
                               max_len=max_len)
            else:
                srv = PayloadLMServer(cfg, params, pol, bank=bank,
                                      slots=FORMAT_SLOTS, max_len=max_len,
                                      block=8, cache_fmt="e5m2")
            reqs = [Request(prompt=x, max_new_tokens=new) for x in prompts]
            for r in reqs:
                srv.submit(r)
            return srv, reqs

        with checked_engine("fused" if dense else "exact") as tally:
            srv, reqs = server(make_policy("s2fp8", "checked", "payload"))
            kern, kinds = [], []
            record_steps(srv, kern, kinds)
            srv.run_to_completion()
            toks = [r.out for r in reqs]
        assert all(len(t) == new for t in toks), (arch, toks)
        srv, reqs = server(make_policy("s2fp8", "plain", "payload"))
        plain = []
        record_steps(srv, plain, [], [k.argmax(dim=-1) for k in kern])
        srv.run_to_completion()
        assert [r.out for r in reqs] == toks
        assert len(plain) == len(kern)
        ties, worst = 0, 0.0
        for i, (a, b) in enumerate(zip(kern, plain)):
            dlt = (a - b).abs()
            assert bool(torch.isfinite(a).all())
            worst = max(worst, dlt.max().item())
            assert dlt.max().item() <= lim_max and \
                dlt.mean().item() <= lim_mean, (arch, i, dlt.max().item(),
                                                dlt.mean().item())
            top2 = a.topk(2, dim=-1).values
            for r in range(a.shape[0]):
                if a[r].argmax() != b[r].argmax():
                    ties += 1
                    assert (top2[r, 0] - top2[r, 1]).item() <= near, (
                        arch, i, r)
        calls = sum(t["calls"] for t in tally.values())
        want = {"qflash_fwd", "qmatmul_nn"} | (
            {"qmatmul_batched"} if dense or cfg.moe else set())
        assert want <= set(tally), (arch, sorted(tally))
        log(f"small families {arch} ({engine} engine, head dim "
            f"{cfg.resolved_head_dim}): tokens {toks[0]}..., {len(kern)} "
            f"steps, {calls} kernel calls held ({sorted(tally)}), largest "
            f"|kernels - plain| logit {worst:.4f}, plain choices that differ "
            f"{ties}")


def phase_train_gemma3(dev, profile: bool = False) -> dict:
    """Full-width gemma3_1b at full depth (26 layers: 22 local with window
    512, 4 dense; d 1152, 4 heads of 256 on 1 K/V head, GELU-GLU of 6,912,
    vocab 262,144 tied; 1.00 B f32 params, about 16 GB with AdamW state
    and gradients) trained 2 steps at batch 1 x 4096 with
    ``attn_impl="flash"``, s2fp8 payload on the cuda engine, the bank at
    k = 8: ``qflash_fwd`` and ``qflash_bwd`` at head dim 256, windowed
    and causal, beside every training kernel; no plain version; every
    loss finite."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3_1b").replace(attn_impl="flash")
    return _train_run(dev, cfg, "train-gemma3", "cosine", cfg.n_params(),
                      TRAIN_KERNELS, profile, steps=2, batch=1,
                      seq=FLASH_LONG_S)


def phase_serve_gemma3(dev) -> dict:
    """Full-width gemma3_1b (26 layers) through ``serve_dense_run``: its
    local layers' caches are rings of 512 positions, and the five prompts
    above 512 tokens (bucket 1,024) wrap them at prefill; decode runs #8
    at K = 256 (scores) and N = 256 (values)."""
    from repro_torch.configs import get_config
    return serve_dense_run(dev, "serve-gemma3", get_config("gemma3_1b"))


def phase_serve_stablelm(dev) -> dict:
    """Full-width stablelm_12b at full depth (40 layers, d 5120, 32 heads
    of 160 on 8 K/V heads, vocab 100,352 untied; 12.1 B f32 params, 48.6
    GB) through ``serve_payload_run``: 16 requests, 32 new tokens, frozen
    bank calibrated on the card, e5m2 pool; the paged decode at head dim
    160 (padded lane groups of 16)."""
    from repro_torch.configs import get_config
    return serve_payload_run(dev, "serve-stablelm", get_config("stablelm_12b"),
                             SERVE_UNTIED_KERNELS, requests=16,
                             new_tokens=32)


SERVE_NEMOTRON_LAYERS = 1    # of 96: the embedding and head alone are 37.7 GB


def phase_serve_nemotron(dev) -> dict:
    """Full-width nemotron_4_340b (d 18,432, 96 heads of 192 on 8 K/V
    heads, squared-ReLU MLP of 73,728, layer norm, vocab 256,000 untied)
    cut to ``SERVE_NEMOTRON_LAYERS`` of its 96 layers (the untied
    embedding and head are 9.44 B f32 params, 37.7 GB, and a layer 3.45 B:
    51.6 GB in all) through ``serve_payload_run``: 8 requests, 16 new
    tokens; the paged decode at head dim 192 with 12 query heads a K/V
    head.  Its numerics run on the ``cuda_fused`` engine: every call
    truncates the whole 4.72 G-element embedding table, and the exact
    stats that calibration takes of it through torch reductions want 35
    GB of temporaries beside the params (out of memory on the 80 GB
    card), where the stats kernel reads the table once."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    cfg = cut_depth(get_config("nemotron_4_340b"), SERVE_NEMOTRON_LAYERS)
    return serve_payload_run(dev, "serve-nemotron", cfg,
                             SERVE_UNTIED_KERNELS, requests=8, new_tokens=16,
                             detail=f"depth cut to {cfg.n_layers} of 96 "
                                    f"layers", backend="cuda_fused")


# ---------------------------------------------------------------------------
# phase 27: train-mesh
# ---------------------------------------------------------------------------

TRAIN_MESH_STEPS = 3
TRAIN_MESH_ARGS = ["--arch", "minicpm_2b", "--batch", "4", "--seq", "512",
                   "--backend", "cuda", "--stats-refresh-every", "8",
                   "--metrics-sink", "memory",
                   "--steps", str(TRAIN_MESH_STEPS)]
# (label, --mesh, --grad-sync, --shard-params); the first is the reference
TRAIN_MESH_RUNS = [("meshless", "none", "f32", "replicated"),
                   ("1x1 f32 replicated", "1x1", "f32", "replicated"),
                   ("1x1 f32 fsdp", "1x1", "f32", "fsdp"),
                   ("1x1 f32 fsdp_q", "1x1", "f32", "fsdp_q"),
                   ("1x1 s2fp8 replicated", "1x1", "s2fp8", "replicated")]
# the training kernels, and the compressed legs' encode on cuda_fused: the
# quantize-with-stats kernel (#3); the decode is the dequantize (#4)
TRAIN_MESH_KERNELS = TRAIN_KERNELS + ("quant",)
# the s2fp8 sync run's loss against the meshless run's, relative: the
# budget tests/test_torch_mesh.py holds reduced minicpm to on 4 gloo ranks
# (measured there: 3.2e-4 replicated, 5.9e-4 under fsdp_q)
TRAIN_MESH_LOSS_RTOL = 2e-3


@contextlib.contextmanager
def uncounted():
    """Kernel launches and plain calls made inside do not count: checks
    that hold a main path's kernel against its plain version run here."""
    from repro_torch import kernels
    reg = kernels.registry()
    saved = {n: (w.launches, p.calls, getattr(w, "small_launches", None))
             for n, (w, p) in reg.items()}
    try:
        yield
    finally:
        for n, (w, p) in reg.items():
            w.launches, p.calls, small = saved[n]
            if small is not None:
                w.small_launches = small


def _xor_fold(v: torch.Tensor) -> int:
    """XOR of every element of an int32 tensor (halving on the card)."""
    v = v.reshape(-1)
    while v.numel() > 1:
        h = v.numel() // 2
        r = v[:h] ^ v[h:2 * h]
        if v.numel() % 2:
            r[0] ^= v[-1]
        v = r
    return int(v[0]) if v.numel() else 0


def _leaf_digests(tree, prefix: str) -> dict:
    """name -> (int64 sum, XOR) of each tensor leaf's int32 view (an int
    leaf as itself), names from the dict keys in JAX's leaf order."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{name}/{k}")
        elif isinstance(node, (list, tuple)):
            fields = getattr(node, "_fields", None)
            for i, v in enumerate(node):
                walk(v, f"{name}/{fields[i] if fields else i}")
        elif isinstance(node, torch.Tensor):
            v = node.detach().reshape(-1).view(torch.int32)
            out[name] = (int(v.sum(dtype=torch.int64)), _xor_fold(v))
        elif node is not None:
            out[name] = (int(node), 0)
    walk(tree, prefix)
    return out


def _toy_mesh(dev, mesh, mode: str, steps: int = 4):
    """The order-exact toy of the repo's mesh tests (8 one-hot rows of K 8,
    w [8, 16] of +-1/8, s2fp8_e4m3 payload GEMM on cuda, bank k = 64,
    AdamW) for ``steps`` steps; (losses, w, the steps' collective
    records)."""
    import numpy as np
    from repro_torch.core import collectives, statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.optim import optimizers, schedules
    from repro_torch.parallel import sharding
    from repro_torch.training.trainer import make_train_step

    def batch(step):
        rng = np.random.RandomState(1000 + step)
        x = np.zeros((8, 8), np.float32)
        for b in range(8):
            x[b, (b + step) % 8] = rng.choice([-1.0, 1.0])
        t = rng.choice([-1.0, 1.0], size=(8, 16)).astype(np.float32)
        return {"x": torch.from_numpy(x).to(dev),
                "t": torch.from_numpy(t).to(dev)}

    def loss_fn(params, b, pol):
        y = pol.dot(b["x"], params["w"])
        return torch.mean(torch.sum(y * b["t"], dim=-1)), {}

    w = np.zeros((8, 16), np.float32)
    rng = np.random.RandomState(0)
    for k in range(8):
        w[k, rng.randint(16)] = rng.choice([-1.0, 1.0]) * 0.125
    params = {"w": torch.from_numpy(w).to(dev)}
    pol = make_policy("s2fp8_e4m3", "cuda", gemm_mode="payload")
    opt = optimizers.adamw()
    cfg = statsbank.StatsConfig(refresh_every=64)
    bank = statsbank.init_bank(loss_fn, params, batch(0), pol, cfg)
    step = make_train_step(loss_fn, opt, schedules.constant(1e-3), pol,
                           stats=cfg, mesh=mesh, param_sharding=mode)
    if mesh is not None:
        params = sharding.shard_tree(params, mesh, mode)
    opt_state = sharding.mark_opt_state(opt.init(params), params)
    losses = []
    with collectives.recording() as rec:
        for s in range(steps):
            params, opt_state, bank, m = step(params, opt_state, bank,
                                              batch(s), s)
            losses.append(float(m["loss"]))
    return losses, params["w"].detach().clone(), list(rec)


def _mesh_run(dev, label, mesh_spec, sync, shard) -> dict:
    """One run of train-mesh: ``launch.build`` of its argv, the step
    wrapped to time it, record its collectives and digest params and AdamW
    state after it; under s2fp8 the step is rebuilt as the launcher builds
    it with the compressed legs on cuda_fused, every leg held against the
    plain quantize and dequantize (uncounted, and their time taken out of
    the step's and the sync's)."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import collectives, statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.kernels import s2fp8_quant as sq
    from repro_torch.launch import api
    from repro_torch.launch import train as launch
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step

    t0 = time.perf_counter()
    loop = launch.build(launch.parse_args(TRAIN_MESH_ARGS + [
        "--mesh", mesh_spec, "--grad-sync", sync, "--shard-params", shard]))
    leaf_shapes = [tuple(x.shape) for x in convert.jax_leaves(loop.params)]
    if sync == "s2fp8":
        cfg = get_config("minicpm_2b")
        loop.train_step = make_train_step(
            api.make_loss_fn(cfg), optimizers.adamw(weight_decay=0.01),
            schedules.make_schedule("wsd", 3e-3, total_steps=TRAIN_MESH_STEPS,
                                    warmup=1),
            make_policy("s2fp8", "cuda"),
            stats=statsbank.StatsConfig(refresh_every=8), mesh=loop.mesh,
            grad_sync_mode="s2fp8", grad_sync_backend="cuda_fused")
    build_s = time.perf_counter() - t0
    real_leg = collectives.compressed_allreduce_axis
    real_sync = collectives.grad_sync_axis
    legs = {"n": 0, "max_step": 0, "frac": 0.0, "ulp": 0, "rel": 0.0,
            "elements": 0}
    sync_ms, sync_bytes = [], []

    checks = []            # (start, end) CUDA events around each check

    def checked_leg(flat, axis_name, axis_size, backend=None, *, mesh=None):
        out = real_leg(flat, axis_name, axis_size, backend, mesh=mesh)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        with uncounted():
            # one rank: the reduce-scatter is the bf16 round trip
            red = flat.to(torch.bfloat16).float()
            pk, abk = sq.quant(red)
            pp, abp = sq.quant_plain(red)
            f = flips(code_ordinal(pk), code_ordinal(pp))
            dk = sq.dequant(pk, abk)
            dp = sq.dequant_plain(pk, abk)
            rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-30))
                        .max().item())
            assert torch.equal(out, dk), f"{label}: leg not reproduced"
        ev[1].record()
        checks.append(ev)
        legs.update(n=legs["n"] + 1,
                    max_step=max(legs["max_step"], f["max_step"]),
                    frac=max(legs["frac"], f["frac"]),
                    ulp=max(legs["ulp"], ulps(abk, abp)),
                    rel=max(legs["rel"], rel),
                    elements=legs["elements"] + red.numel())
        return out

    def check_ms(since: int) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in checks[since:])

    def timed_sync(*args, **kwargs):
        rec = collectives._RECORDS[-1]
        n0, c0 = len(rec), len(checks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_sync(*args, **kwargs)
        end.record()
        end.synchronize()
        # the legs' checks ran inside: their time is not the sync's
        sync_ms.append(start.elapsed_time(end) - check_ms(c0))
        nbytes = 0
        for r in rec[n0:]:
            size = {"float32": 4, "float64": 8, "bfloat16": 2,
                    "uint8": 1}[r["dtype"]]
            nbytes += size * (r["out_numel"] if r["op"] == "all_gather"
                              else r["numel"])
        sync_bytes.append(nbytes)
        return out

    records, digests, step_ms = [], [], []
    inner = loop.train_step

    def wrapped(*args):
        c0 = len(checks)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with collectives.recording() as rec:
            out = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3 - check_ms(c0))
        records.append(list(rec))
        d = _leaf_digests(out[0], "params")
        d.update(_leaf_digests(out[1], "opt"))
        digests.append(d)
        return out

    loop.train_step = wrapped
    collectives.compressed_allreduce_axis = checked_leg
    collectives.grad_sync_axis = timed_sync
    torch.cuda.reset_peak_memory_stats()
    try:
        loop.run(TRAIN_MESH_STEPS)
    finally:
        collectives.compressed_allreduce_axis = real_leg
        collectives.grad_sync_axis = real_sync
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in loop.history]
    tokens = 4 * 512
    steady = float(np.mean(step_ms[1:]))
    res = {"label": label, "losses": losses, "step_ms": step_ms,
           "steady_step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
           "peak_gb": peak, "build_s": build_s, "records": records,
           "digests": digests, "leaf_shapes": leaf_shapes,
           "sync_ms": sync_ms, "sync_bytes": sync_bytes, "legs": legs}
    log(f"train-mesh {label}: losses {losses}, step ms "
        f"{[round(x, 1) for x in step_ms]}, {res['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak:.2f} GB, build {build_s:.1f} s"
        + (f", sync ms {[round(x, 2) for x in sync_ms]}, sync logical "
           f"bytes a step {sync_bytes}" if sync_ms else ""))
    del loop
    return res


def _count(records, op, dtype, pred=lambda r: True) -> int:
    return sum(1 for r in records if r["op"] == op and r["dtype"] == dtype
               and pred(r))


def phase_train_mesh(dev) -> dict:
    """Phase 27 (module docstring).  The bit-equality claim is the
    reference's (``trainer.py``: a 1-device mesh reproduces the meshless
    step): every f32 run's loss and its params' and AdamW moments' per-leaf
    digests (int64 sum and XOR of the int32 view) equal the meshless
    run's after every step, or the phase fails naming the leaf.  Counts,
    from the collective recorder: f32 replicated, one f32 all-reduce per
    gradient leaf a step; s2fp8, one bf16 reduce-scatter and one uint8
    all-gather per compressible leaf (at least 65,536 elements) and no
    f32 all-reduce of such a leaf; fsdp_q, minicpm_2b's one
    payload-eligible leaf (the tied embedding; the [L]-stacked segment
    leaves are 3-D) is gathered once in f32 (the embed site's truncation)
    and once in bf16 (the tied head), the reference's fallbacks, and
    takes no uint8 gather — so the toy runs fsdp_q on the card too, where
    ``w`` crosses as its 1-byte payload four times in four steps and never
    wide.  Numbers printed per run: step ms, tokens/s, peak memory; the
    s2fp8 run's sync ms a step (CUDA events) and logical bytes a step
    against the f32 run's (the bytes handed to the collectives: one rank
    moves nothing over a wire)."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.launch import mesh as lmesh

    t_phase = time.perf_counter()
    lmesh.init_distributed("cuda")
    log(f"train-mesh: {dist.get_backend()} group of "
        f"{dist.get_world_size()} rank, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    runs = []
    try:
        kernels.reset_counts()                    # the main path starts here
        for label, mesh_spec, sync, shard in TRAIN_MESH_RUNS:
            runs.append(_mesh_run(dev, label, mesh_spec, sync, shard))
            free_device_memory()
        mesh = lmesh.make_mesh_from_spec("1x1")
        toy_ref = _toy_mesh(dev, None, "replicated")
        toy_q = _toy_mesh(dev, mesh, "fsdp_q")
        counts = path_counts()                    # ... and ends here
    finally:
        dist.destroy_process_group()
    check_counts(counts, TRAIN_MESH_KERNELS)

    ref = runs[0]
    for run in runs[1:4]:
        for i in range(TRAIN_MESH_STEPS):
            assert run["losses"][i] == ref["losses"][i], (
                f"{run['label']} step {i}: loss {run['losses'][i]} != "
                f"meshless {ref['losses'][i]}")
            bad = [k for k, v in ref["digests"][i].items()
                   if run["digests"][i].get(k) != v]
            assert not bad, (f"{run['label']} step {i}: leaves differ from "
                             f"the meshless run: {bad}")
    s2 = runs[4]
    assert s2["losses"][0] == ref["losses"][0], "s2fp8 step 0 loss"
    for a, b in zip(s2["losses"], ref["losses"]):
        assert math.isfinite(a) and abs(a - b) <= TRAIN_MESH_LOSS_RTOL * abs(b), \
            (s2["losses"], ref["losses"])
    legs = s2["legs"]
    log(f"train-mesh s2fp8 legs against the plain quantize / dequantize: "
        f"{legs}")
    assert legs["n"] > 0 and legs["max_step"] <= 1 and legs["frac"] <= 1e-4
    assert legs["ulp"] <= 4 and legs["rel"] <= 1e-6

    leaf_shapes = ref["leaf_shapes"]
    n_leaves = len(leaf_shapes)
    shapes = set(leaf_shapes)
    n_comp = sum(1 for sh in leaf_shapes if math.prod(sh) >= 1 << 16)
    summary = {}
    for run in runs[1:]:
        per_step = []
        for rec in run["records"]:
            per_step.append({
                "grad_allreduce_f32": _count(
                    rec, "all_reduce", "float32",
                    lambda r: r["out_shape"] in shapes),
                "big_allreduce_f32": _count(
                    rec, "all_reduce", "float32",
                    lambda r: r["numel"] >= 1 << 16),
                "reduce_scatter_bf16": _count(rec, "reduce_scatter",
                                              "bfloat16"),
                "all_gather_uint8": _count(rec, "all_gather", "uint8"),
                "embed_gathers": sorted(
                    r["dtype"] for r in rec if r["op"] == "all_gather"
                    and r["out_shape"] == leaf_shapes[0]),
                "collectives": len(rec)})
        summary[run["label"]] = per_step
    log("train-mesh collectives a step: " + json.dumps(summary))
    for st in summary["1x1 f32 replicated"]:
        assert st["grad_allreduce_f32"] == n_leaves, (st, n_leaves)
    for st in summary["1x1 s2fp8 replicated"]:
        assert st["reduce_scatter_bf16"] == st["all_gather_uint8"] == n_comp
        assert st["big_allreduce_f32"] == 0, st
    for st in summary["1x1 f32 fsdp_q"]:
        assert st["embed_gathers"] == ["bfloat16", "float32"], st
        assert st["all_gather_uint8"] == 0, st
    assert toy_q[0] == toy_ref[0] and torch.equal(toy_q[1], toy_ref[1]), \
        (toy_q[0], toy_ref[0])
    toy_gathers = [(r["dtype"], r["out_shape"]) for r in toy_q[2]
                   if r["op"] == "all_gather"]
    assert toy_gathers == [("uint8", (8, 16))] * 4, toy_gathers

    f32_run = runs[1]
    metrics = {
        "runs": {r["label"]: {k: r[k] for k in (
            "losses", "step_ms", "steady_step_ms", "tokens_per_s",
            "peak_gb", "build_s")} for r in runs},
        "s2fp8_sync_ms_per_step": s2["sync_ms"],
        "f32_sync_ms_per_step": f32_run["sync_ms"],
        "s2fp8_sync_logical_bytes_per_step": s2["sync_bytes"],
        "f32_sync_logical_bytes_per_step": f32_run["sync_bytes"],
        "compressed_leaves": n_comp, "param_leaves": n_leaves,
        "legs": legs, "toy_fsdp_q_losses": toy_q[0],
        "phase_s": time.perf_counter() - t_phase,
    }
    log("train-mesh metrics: " + json.dumps(metrics))
    log("train-mesh launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


# ---------------------------------------------------------------------------
# phases 30-31: the model axis (slice 14)
# ---------------------------------------------------------------------------

TP_BATCH, TP_SEQ, TP_STEPS = 4, 512, 3
TP_MESH = (1, 4)                        # tp-rank0's dry mesh: data x model
TP_DECODE_ROWS, TP_DECODE_LEN, TP_DECODE_AT = 8, 4096, 1000
# the meshless full-width minicpm_2b step at 4 x 512 (phase "dryrun", the
# cuda engine's payload GEMMs): rank 0's FLOPs are read as a share of it
TP_MESHLESS_FLOPS = 44_354_377_875_456
TP_FLOP_RTOL = 0.05                     # dry FLOPs against the real trace's
TP_PEAK_RTOL = 0.10                     # dry peak against the card's peak
# the 16 x 16 dry cells' values with the model axis replicated (the
# records before it split: per-rank GFLOP and peak GB)
DRY_CELLS_BEFORE = {"minicpm_2b|train_4k": (1_614_160, 207.3),
                    "kimi_k2_1t_a32b|train_4k": (None, 21_829.0)}
# the rank-local GEMMs of full-width minicpm_2b at model 4 (9 of 36 heads
# = 576 columns, 1,440 of 5,760 MLP columns): (M, K, N) per layout, the
# train step's 4 x 512 rows and the decode step's 8; the decode attention
# over a rank's 1,024 of 4,096 cache positions is GEMMS_BATCHED_DECODE's
GEMMS_TP = {
    "nn": [("qmatmul_nn tp4", [(2048, 2304, 576), (2048, 576, 2304),
                               (2048, 1440, 2304), (2048, 2304, 1440)]),
           # the tied head's dX at its whole K, which the checked engine
           # holds at raw_tol(122,753): here at phase 3's 1e-5
           ("qmatmul_nn head dx", [(2048, 122753, 2304)]),
           ("qmatmul_nn decode tp4", [(8, 1440, 2304), (8, 2304, 1440)])],
    "nt": [("qmatmul_nt tp4", [(2048, 576, 2304), (2048, 2304, 576),
                               (2048, 2304, 1440), (2048, 1440, 2304)])],
    "tn": [("qmatmul_tn tp4", [(2304, 2048, 576), (576, 2048, 2304),
                               (1440, 2048, 2304), (2304, 2048, 1440)])],
}
# the payload flash kernels at 9 of minicpm's 36 heads: (label, B x heads,
# S, g, window)
FLASH_TP = ("tp4", 4 * 9, 512, 1, None)


def tp_kernel_checks(dev, rnd, record) -> None:
    """The kernels at the rank-local shapes of the model axis (minicpm_2b
    at model 4), in rows of their own: ``GEMMS_TP`` (``gemm_case``, bf16
    operands; with the tied head's dX at K 122,753) and #10 / #11 at
    ``FLASH_TP`` (``flash_case``)."""
    for layout, rows in GEMMS_TP.items():
        for row, shapes in rows:
            for i, (m, k, n) in enumerate(shapes):
                gemm_case(rnd, record, row, layout, m, k, n, torch.bfloat16,
                          keep=i == len(shapes) - 1)
    label, bh, sl, g, window = FLASH_TP
    flash_case(dev, rnd, record, label, 64, label, bh, sl, g, window,
               keep=True, f32=False)


def _tp_batches(cfg, dev, steps, vocab=None):
    """Seeded 4 x 512 LM batches over the first ``vocab`` tokens (default
    the config's)."""
    from repro_torch.data import synthetic
    chain = synthetic.markov_chain(0, vocab or cfg.vocab)
    gen = torch.Generator().manual_seed(0)
    return [synthetic.lm_batch(chain, gen, TP_BATCH, TP_SEQ, dev)
            for _ in range(steps)]


def _tp_train(dev, cfg, pol, mesh, rules, steps, label):
    """``steps`` steps of ``api.make_train_step`` from seed-0 params,
    meshless (``mesh`` None) or with the params placed by ``param_pspecs``
    on ``mesh`` under ``rules``; (losses, step ms, per-step leaf digests
    of params and AdamW state)."""
    from repro_torch.launch import api
    from repro_torch.parallel import sharding as shd
    params = api.init_params(cfg, seed=0, device=dev)
    kw = {}
    if mesh is not None:
        where = api.placement(cfg, mesh, params)
        params = shd.place_params(params, mesh, specs=where.specs)
        kw = dict(mesh=mesh, placement=where)
    step, opt = api.make_train_step(cfg, pol, **kw)
    ostate = opt.init(params)
    losses, step_ms, digests = [], [], []
    for s_, batch in enumerate(_tp_batches(cfg, dev, steps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = (shd.use_rules(rules, dict(mesh.shape)) if mesh is not None
               else contextlib.nullcontext())
        with ctx:
            params, ostate, m = step(params, ostate, batch, s_)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        d = _leaf_digests(params, "params")
        d.update(_leaf_digests(ostate, "opt"))
        digests.append(d)
    log(f"{label}: losses {losses}, step ms "
        f"{[round(x, 1) for x in step_ms]}")
    del params, ostate
    return losses, step_ms, digests


def phase_train_tp_1x1(dev) -> dict:
    """Phase 30 "train-tp-1x1": full-width minicpm_2b (40 layers, not
    cut) at 4 x 512, exact stats on the cuda_fused engine's payload
    GEMMs, 3 steps of ``api.make_train_step``: meshless, then under
    ``TRAIN_RULES`` on a 1 x 1 mesh over a 1-rank NCCL group with the
    params placed by ``param_pspecs`` (the main path: counts set to 0
    just before it, read just after).  At ``model`` 1 the step adds no
    arithmetic: every loss and every leaf's digest (params, AdamW
    moments) equals the meshless run's after every step, or the phase
    fails naming the leaf.  Prints the steady step ms of both."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import sharding as shd

    t_phase = time.perf_counter()
    cfg = get_config("minicpm_2b")
    pol = make_policy("s2fp8", "cuda_fused", "payload")
    ref = _tp_train(dev, cfg, pol, None, None, TP_STEPS, "train-tp-1x1 "
                    "meshless")
    free_device_memory()
    lmesh.init_distributed("cuda")
    try:
        mesh = lmesh.make_mesh_from_spec("1x1")
        kernels.reset_counts()                    # the main path starts here
        got = _tp_train(dev, cfg, pol, mesh, shd.TRAIN_RULES, TP_STEPS,
                        "train-tp-1x1 1x1")
        counts = path_counts()                    # ... and ends here
    finally:
        dist.destroy_process_group()
    check_counts(counts, TRAIN_EXACT_KERNELS)
    for i in range(TP_STEPS):
        assert got[0][i] == ref[0][i], (i, got[0], ref[0])
        bad = [k for k, v in ref[2][i].items() if got[2][i].get(k) != v]
        assert not bad, f"train-tp-1x1 step {i}: leaves differ: {bad}"
    metrics = {"losses": got[0], "meshless_losses": ref[0],
               "step_ms": got[1], "meshless_step_ms": ref[1],
               "steady_step_ms": float(np.mean(got[1][1:])),
               "meshless_steady_step_ms": float(np.mean(ref[1][1:])),
               "leaves_equal": len(ref[2][-1]),
               "phase_s": time.perf_counter() - t_phase}
    log("train-tp-1x1 metrics: " + json.dumps(metrics))
    log("train-tp-1x1 launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def _tp_rank0_train(dev, arch, pol, batch, fake: bool):
    """One train step of full-width ``arch`` as rank 0 of a
    ``DryMesh(TP_MESH)`` under ``TRAIN_RULES`` (params placed by
    ``param_pspecs``; the collectives record and move nothing), on fake
    tensors or on the card; (its ``TraceCost``, loss)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import api
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.trace_cost import trace_cost
    cfg = get_config(arch)
    mesh = DryMesh(TP_MESH, ("data", "model"), device=dev)
    full = api.param_struct(cfg) if fake else api.init_params(cfg, seed=0,
                                                              device=dev)
    with api.fake_mode() if fake else contextlib.nullcontext():
        where = api.placement(cfg, mesh, full)
        params = shd.place_params(full, mesh, specs=where.specs)
        del full
        step, opt = api.make_train_step(cfg, pol, mesh=mesh,
                                        placement=where)
        ostate = opt.init(params)
        if fake:
            batch = {k: torch.empty(v.shape, dtype=v.dtype)
                     for k, v in batch.items()}
        else:
            _tp_peak_from_here()
        with shd.use_rules(shd.TRAIN_RULES, dict(mesh.shape)), \
                trace_cost((params, ostate, batch)) as cost:
            params, ostate, m = step(params, ostate, batch, 0)
            loss = None if fake else float(m["loss"])
    return cost, loss


def _tp_rank0_decode(dev, pol, fake: bool):
    """One decode step of full-width minicpm_2b (bf16 params) for
    ``TP_DECODE_ROWS`` rows as rank 0 of ``DryMesh(TP_MESH)`` under
    ``DECODE_RULES``: the rank's 1/4 of a ``TP_DECODE_LEN``-position
    cache (seeded values), position ``TP_DECODE_AT`` (in rank 0's
    slice); (its ``TraceCost``, logits)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import api
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.models import transformer as tlm
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.trace_cost import trace_cost
    cfg = get_config("minicpm_2b")
    mesh = DryMesh(TP_MESH, ("data", "model"), device=dev)
    full = (api.param_struct(cfg, dtype=torch.bfloat16) if fake else
            _bf16(api.init_params(cfg, seed=0, device=dev)))
    local_len = TP_DECODE_LEN // TP_MESH[1]
    with api.fake_mode() if fake else contextlib.nullcontext():
        where = api.placement(cfg, mesh, full)
        params = shd.place_params(full, mesh, specs=where.specs)
        del full
        caches = tlm.init_caches(cfg, TP_DECODE_ROWS, local_len,
                                 device="cpu" if fake else dev,
                                 dtype=torch.bfloat16)
        if not fake:
            gen = torch.Generator(device=dev).manual_seed(3)
            for c in caches:
                for v in c.values():
                    v.copy_(torch.randn(v.shape, generator=gen, device=dev)
                            * 0.5)
        tok = torch.zeros((TP_DECODE_ROWS, 1), dtype=torch.int64,
                          device="cpu" if fake else dev)
        step = api.make_decode_step(cfg, pol, placement=where)
        if not fake:
            _tp_peak_from_here()
        with shd.use_rules(shd.DECODE_RULES, dict(mesh.shape)), \
                torch.no_grad(), trace_cost((params, caches)) as cost:
            logits, _ = step(params, {"token": tok}, caches, TP_DECODE_AT)
    return cost, (None if fake else logits)


def _tp_peak_from_here() -> None:
    """Start the card's peak at what the traced step holds (its params,
    state and batch): the whole params made before placing are gone."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.to(torch.bfloat16)


def _wait_tp_dry(proc) -> dict:
    """tp_dry_traces' records, once its subprocess has ended."""
    rc = proc["proc"].wait(timeout=DRY_CELL_TIMEOUT_S)
    text = proc["log"].read_text()
    assert rc == 0, f"tp-rank0 dry traces exited {rc}:\n{text[-3000:]}"
    return json.loads(proc["out"].read_text())


def phase_tp_rank0(dev, tp_dry=None) -> dict:
    """Phase 31 "tp-rank0": rank 0 of ``DryMesh((1, 4))`` (data x model)
    on real card tensors at full width: the model axis split 4 ways as
    the reference's rules split it (minicpm_2b: 9 of 36 query and K/V
    heads, 1,440 of 5,760 MLP columns, its odd vocab whole; the
    collectives record and move nothing: a gather tiles rank 0's chunk,
    an all-reduce keeps its partial).

      * minicpm_2b's train step at 4 x 512 under ``TRAIN_RULES`` and one
        decode step for 8 rows over a 4,096-position cache (rank 0's
        1,024) under ``DECODE_RULES``, each first through the
        ``checked_engine`` (every kernel call held against its plain
        version on its own inputs), then on the cuda engine traced on the
        card (the main path: counts set to 0 just before, read just after)
        and on fake tensors: FLOPs within ``TP_FLOP_RTOL``, kernel calls
        equal kind for kind, the dry peak within ``TP_PEAK_RTOL`` of
        ``max_memory_allocated``.  Prints rank 0's FLOPs as a share of the
        meshless step's ``TP_MESHLESS_FLOPS``.
      * gemma3_1b's train step at 4 x 512 the same way (the vocab split:
        262,144 columns, 65,536 a rank, the vocab-parallel cross entropy;
        one K/V head whole beside 1 of 4 query heads a rank).  Its tokens
        are drawn from rank 0's 65,536: a dry rank's vocab-parallel
        embedding sums no other rank's rows, so another rank's token would
        embed as 0 and the norms' backward would overflow on it.

    The fake traces run in a CPU subprocess (``tp_dry``, started by
    ``start_dry_cells``; ``tp_dry_traces``), hidden behind the earlier
    phases."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy

    t_phase = time.perf_counter()
    pol = make_policy("s2fp8", "cuda", "payload")
    metrics, counts_all = {}, {}
    dry_all = json.loads(TP_DRY_FILE.read_text()) if tp_dry is None \
        else _wait_tp_dry(tp_dry)
    for arch in ("minicpm_2b", "gemma3_1b"):
        cfg = get_config(arch)
        # a dry rank sums no other rank's part: where the vocab splits, its
        # embedding rows of the other ranks' tokens would stay 0 (and the
        # norms' backward blow up on them), so the tokens are rank 0's
        batch = _tp_batches(cfg, dev, 1, cfg.vocab // TP_MESH[1]
                            if cfg.vocab % TP_MESH[1] == 0 else None)[0]
        with checked_engine() as tally:
            _, loss = _tp_rank0_train(dev, arch,
                                      make_policy("s2fp8", "checked"),
                                      batch, fake=False)
        log(f"tp-rank0 {arch} train, checked engine: loss {loss}, "
            f"tally {json.dumps(tally)}")
        assert math.isfinite(loss), loss
        assert {"qmatmul_nn", "qmatmul_nt", "qmatmul_tn", "qflash_fwd",
                "qflash_bwd"} <= set(tally), tally
        free_device_memory()
        dry = dry_all[f"{arch} train"]
        kernels.reset_counts()                    # the main path starts here
        real, loss = _tp_rank0_train(dev, arch, pol, batch, fake=False)
        torch.cuda.synchronize()
        counts = path_counts()                    # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        metrics[f"{arch} train"] = _tp_compare(dry, real, peak, counts,
                                               loss, arch)
        counts_all[f"{arch} train"] = counts
        free_device_memory()

    with checked_engine() as tally:
        _, logits = _tp_rank0_decode(dev, make_policy("s2fp8", "checked"),
                                     fake=False)
    log(f"tp-rank0 minicpm_2b decode, checked engine: tally "
        f"{json.dumps(tally)}")
    assert bool(torch.isfinite(logits).all())
    assert {"qmatmul_nn", "qmatmul_batched"} <= set(tally), tally
    del logits
    dry = dry_all["minicpm_2b decode"]
    kernels.reset_counts()                        # the main path starts here
    real, logits = _tp_rank0_decode(dev, pol, fake=False)
    torch.cuda.synchronize()
    counts = path_counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    metrics["minicpm_2b decode"] = _tp_compare(
        dry, real, peak, counts, float(logits.float().abs().mean()),
        "minicpm_2b decode")
    counts_all["minicpm_2b decode"] = counts
    del logits
    share = metrics["minicpm_2b train"]["real_flops"] / TP_MESHLESS_FLOPS
    metrics["minicpm_2b train"]["share_of_meshless_flops"] = share
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"tp-rank0 minicpm_2b train: rank 0's FLOPs are {share:.4f} of the "
        f"meshless step's {TP_MESHLESS_FLOPS} (predicted about 1/3)")
    log("tp-rank0 metrics: " + json.dumps(metrics))
    total = {}
    for counts in counts_all.values():
        for k, c in counts.items():
            t = total.setdefault(k, {"launches": 0, "plain_calls": 0})
            t["launches"] += c["launches"]
            t["plain_calls"] += c["plain_calls"]
    log("tp-rank0 launches: " + json.dumps(total))
    check_counts(total, TRAIN_KERNELS + ("qmatmul_batched",))
    return {"counts": total, "metrics": metrics}


def _tp_compare(dry, real, peak, counts, value, label) -> dict:
    """Hold a dry trace (``tp_dry_traces``' record) against the real one
    (FLOPs, calls kind for kind, peak) and the launches against the
    calls; the printed numbers."""
    from repro_torch import kernels
    launched = {k: c["launches"] for k, c in kernels.counts().items()
                if c["launches"]}
    flop_gap = abs(dry["flops"] - real.flops) / real.flops
    peak_gap = abs(dry["peak_bytes"] - peak) / peak
    out = {"dry_flops": dry["flops"], "real_flops": real.flops,
           "flop_gap": flop_gap, "dry_peak": dry["peak_bytes"],
           "max_memory_allocated": peak, "peak_gap": peak_gap,
           "dry_trace_s": dry["seconds"], "real_trace_s": real.seconds,
           "calls": dict(real.calls), "coll_axis": dict(real.coll_axis),
           "bytes": real.bytes, "value": value}
    log(f"tp-rank0 {label}: " + json.dumps(out))
    assert math.isfinite(value), value
    assert dry["calls"] == dict(real.calls) == launched, (
        dry["calls"], real.calls, launched)
    assert flop_gap <= TP_FLOP_RTOL, (dry["flops"], real.flops)
    assert peak_gap <= TP_PEAK_RTOL, (dry["peak_bytes"], peak)
    return out


TP_DRY_FILE = ROOT / "build" / "tp_rank0_dry.json"


def tp_dry_traces(path) -> None:
    """tp-rank0's steps traced on fake tensors (no card: a CPU subprocess
    started beside the dry cells, ``start_dry_cells``); their FLOPs, peak,
    calls and trace seconds to ``path`` as JSON."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    pol = make_policy("s2fp8", "cuda", "payload")
    cpu = torch.device("cpu")
    out = {}

    def keep(label, cost):
        out[label] = {"flops": cost.flops, "peak_bytes": cost.peak_bytes,
                      "calls": dict(cost.calls), "seconds": cost.seconds}

    for arch in ("minicpm_2b", "gemma3_1b"):
        batch = {k: torch.zeros((TP_BATCH, TP_SEQ), dtype=torch.int64)
                 for k in ("tokens", "labels")}
        keep(f"{arch} train",
             _tp_rank0_train(cpu, arch, pol, batch, fake=True)[0])
    keep("minicpm_2b decode", _tp_rank0_decode(cpu, pol, fake=True)[0])
    Path(path).write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# phases 28-29: the doctor and the dry run (slice 13)
# ---------------------------------------------------------------------------

DOCTOR_BATCH, DOCTOR_SEQ = 4, 512       # the train phase's shape
DOCTOR_ENGINES = "cuda,cuda_fused"
# kernels the full-width probes must launch (both engines together)
DOCTOR_KERNELS = ("quant_apply", "truncate_apply", "dequant", "qmatmul_nn",
                  "qmatmul_nt", "qmatmul_tn", "qflash_fwd", "qflash_bwd",
                  "stats", "quant")
DRYRUN_BATCH, DRYRUN_SEQ = 4, 512
DRYRUN_KERNELS = TRAIN_KERNELS
DRYRUN_FLOP_RTOL = 0.05                 # dry FLOPs against the real trace's
DRYRUN_PEAK_RTOL = 0.10                 # dry peak against the card's peak
# production-mesh dry cells (16 x 16), each a CPU subprocess of
# launch/dryrun.py started after phase 3 and read after phase 27: (arch,
# shape, --shard-params); attention above 2048 tokens on the flash route
# (the naive route's chunk loop traces 2.3 M ops at prefill_32k)
DRY_CELLS = (("minicpm_2b", "train_4k", "pspecs"),
             ("minicpm_2b", "prefill_32k", "pspecs"),
             ("minicpm_2b", "decode_32k", "pspecs"),
             ("kimi_k2_1t_a32b", "train_4k", "fsdp_q"))
DRY_CELL_TIMEOUT_S = 900
DRY_DIR = ROOT / "build" / "dryrun_cells"


def start_dry_cells() -> list:
    """Start every ``DRY_CELLS`` cell as a subprocess on the CPU (no card
    visible, one thread each): fake tensors, nothing allocated."""
    import os
    DRY_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, shard in DRY_CELLS:
        out = DRY_DIR / f"{arch}.{shape}.{shard}.json"
        log_path = DRY_DIR / f"{arch}.{shape}.{shard}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "single", "--attn-impl",
               "flash", "--shard-params", shard, "--force", "--results",
               str(out)]
        procs.append({"cell": (arch, shape, shard), "out": out,
                      "log": log_path, "t0": time.perf_counter(),
                      "proc": subprocess.Popen(
                          cmd, stdout=open(log_path, "w"),
                          stderr=subprocess.STDOUT, env=env, cwd=ROOT)})
    log(f"dry cells started: {[p['cell'] for p in procs]}")
    log_path = DRY_DIR / "tp_rank0_dry.log"
    procs.append({"cell": None, "out": TP_DRY_FILE, "log": log_path,
                  "t0": time.perf_counter(), "proc": subprocess.Popen(
                      [sys.executable, "-c", "import chip_smoke; "
                       f"chip_smoke.tp_dry_traces({str(TP_DRY_FILE)!r})"],
                      stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
                      env=env, cwd=ROOT)})
    return procs


def stop_dry_cells(procs) -> None:
    for p in procs or ():
        if p["proc"].poll() is None:
            p["proc"].kill()
            p["proc"].wait()


def phase_dry_cells(procs) -> dict:
    """The production-mesh dry cells: wait for each subprocess, print its
    record (trace seconds, memory, roofline terms, kernel calls) and fail
    unless each traced (status ok, finite terms, calls recorded)."""
    out = {}
    for p in procs:
        if p["cell"] is None:            # tp-rank0's traces, read there
            continue
        arch, shape, shard = p["cell"]
        rc = p["proc"].wait(timeout=DRY_CELL_TIMEOUT_S)
        wall = time.perf_counter() - p["t0"]
        text = p["log"].read_text()
        assert rc == 0, f"dry cell {p['cell']} exited {rc}:\n{text[-3000:]}"
        recs = json.loads(p["out"].read_text())
        (key, rec), = recs.items()
        assert rec["status"] == "ok", (key, rec)
        r = rec["roofline"]
        assert all(math.isfinite(r[k]) and r[k] >= 0 for k in (
            "hlo_gflops_per_dev", "hlo_gbytes_per_dev",
            "coll_gbytes_per_dev", "step_s", "mfu")), r
        assert sum(rec["kernel_calls"].values()) > 0, rec["kernel_calls"]
        show = {k: rec[k] for k in ("compile_s", "memory_analysis",
                                    "model_axis", "param_sharding",
                                    "param_placement", "coll_by_axis",
                                    "kernel_calls")}
        show["roofline"] = r
        show["aten_ops"] = rec["cost"]["aten_ops"]
        show["wall_s"] = wall
        log(f"dry cell {key}: " + json.dumps(show))
        before = DRY_CELLS_BEFORE.get(f"{arch}|{shape}")
        if before is not None:
            log(f"dry cell {key}: model_axis {rec['model_axis']}, "
                f"{r['hlo_gflops_per_dev']:.0f} GFLOP and "
                f"{r['hlo_gbytes_per_dev']:.1f} GB a rank, peak "
                f"{rec['memory_analysis']['peak_bytes'] / 1e9:.1f} GB; "
                f"before the model axis split: {before[0]} GFLOP, peak "
                f"{before[1]} GB")
        out[key] = show
    return out


def phase_doctor(dev) -> dict:
    """``launch/doctor.py --smoke`` on the cuda and cuda_fused engines;
    then full-width minicpm_2b (40 layers) probed with a cold bank at
    batch 4 x 512 on both engines (the main path: the counts are set to 0
    before the probes and read after), printing the sites probed, the
    unclean ones and each engine's seconds; then a restore round trip of a
    checkpoint the phase writes at reduced size: the doctor reads it back
    (params bit for bit, the bank used) and falls back to a cold bank for
    an engine routing of another site structure (fig4)."""
    import argparse as _ap
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.launch import api, doctor
    from repro_torch.obs import doctor as obs_doctor
    from repro_torch.optim import optimizers
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.perf_counter()
    rc = doctor.main(["--smoke", "--device", dev.type, "--backends",
                      DOCTOR_ENGINES])
    assert rc == 0, f"s2fp8-doctor --smoke failed ({rc})"
    smoke_s = time.perf_counter() - t_phase
    free_device_memory()

    args = doctor.build_parser().parse_args([
        "--arch", "minicpm_2b", "--device", dev.type, "--backends",
        DOCTOR_ENGINES, "--batch", str(DOCTOR_BATCH), "--seq",
        str(DOCTOR_SEQ)])
    kernels.reset_counts()                        # the main path starts here
    probes = doctor.probe(args)
    counts = path_counts()                        # ... and ends here
    engines = {}
    for r in probes:
        unclean = [f"{x['site']}[{x['layer']}].{x['dir']}"
                   if x["layer"] is not None else f"{x['site']}.{x['dir']}"
                   for x in r["rows"] if not obs_doctor.is_clean(x)]
        engines[r["backend"]] = {"sites": len(r["rows"]),
                                 "unclean": len(unclean),
                                 "unclean_sites": unclean[:10],
                                 "probe_loss": r["loss"],
                                 "seconds": r["seconds"]}
        log(f"doctor minicpm_2b {r['backend']}: {len(r['rows'])} sites "
            f"probed, {len(unclean)} unclean {unclean[:10]}, loss "
            f"{r['loss']:.4f}, {r['seconds']:.1f} s")
        assert r["rows"] and math.isfinite(r["loss"]), r["backend"]
    check_counts(counts, DOCTOR_KERNELS)
    del probes
    free_device_memory()

    # restore round trip at reduced size
    cfg = get_reduced_config("minicpm_2b")
    loss_fn = api.make_loss_fn(cfg)
    params = api.init_params(cfg, seed=0, device=dev)
    opt_state = optimizers.adamw(weight_decay=0.01).init(params)
    small = _ap.Namespace(seed=0, batch=2, seq=32)
    batch = doctor._data(cfg, small, dev)
    pol = make_policy("s2fp8", backend="cuda")
    bank = statsbank.init_bank(loss_fn, params, batch, pol,
                               statsbank.StatsConfig())
    bank, _ = obs_doctor.probe_bank(loss_fn, params, batch, pol, bank,
                                    statsbank.StatsConfig(), step=0)
    fig4 = statsbank.init_bank(loss_fn, params, batch,
                               make_policy("s2fp8", backend="cuda",
                                           gemm_mode="fig4"),
                               statsbank.StatsConfig())
    DRY_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DRY_DIR) as td:
        CheckpointManager(td).save(3, (params, opt_state, bank))
        p, _, got, step = doctor._restore(td, None, params, opt_state,
                                          statsbank.init_bank(
                                              loss_fn, params, batch, pol,
                                              statsbank.StatsConfig()))
        assert step == 3 and got is not None, (step, got is None)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                     tree_leaves(params)))
        assert same, "restored params differ from the saved ones"
        p2, _, cold, _ = doctor._restore(td, None, params, opt_state, fig4)
        assert cold is None and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(p2),
                                              tree_leaves(params)))
        rc = doctor.main(["--arch", "minicpm_2b", "--reduced", "--device",
                          dev.type, "--backends", DOCTOR_ENGINES,
                          "--ckpt-dir", td, "--batch", "2", "--seq", "32"])
        assert rc == 0
    metrics = {"smoke_s": smoke_s, "engines": engines,
               "round_trip": "ok", "phase_s": time.perf_counter() - t_phase}
    log("doctor metrics: " + json.dumps(metrics))
    log("doctor launches: " + json.dumps(counts))
    return {"counts": counts, "metrics": metrics}


def phase_dryrun(dev) -> dict:
    """Full-width minicpm_2b's s2fp8 train step at batch 4 x 512 (exact
    stats, the cuda engine's payload GEMMs, AdamW, remat; the train
    phase's shape), traced twice under ``roofline.trace_cost``: dry, on
    fake tensors (``launch.api`` structs; each kernel wrapper's call
    charged as its kernel, nothing allocated), and real, on the card (the
    main path: the counts are set to 0 just before the step and read just
    after).  Holds the dry trace's per-kind kernel calls equal to the
    launches ``kernels.counts()`` records, its FLOPs within
    ``DRYRUN_FLOP_RTOL`` of the real trace's and its peak live bytes within
    ``DRYRUN_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated``; prints
    both costs, 6·N·T and the roofline."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.data import synthetic
    from repro_torch.launch import api
    from repro_torch.roofline import analysis
    from repro_torch.roofline.trace_cost import trace_cost

    t_phase = time.perf_counter()
    cfg = get_config("minicpm_2b")
    pol = make_policy("s2fp8")
    b, s = DRYRUN_BATCH, DRYRUN_SEQ

    step, opt = api.make_train_step(cfg, pol)
    fparams = api.param_struct(cfg)
    with api.fake_mode():
        fopt = opt.init(fparams)
        fbatch = {k: torch.empty((b, s), dtype=torch.int64)
                  for k in ("tokens", "labels")}
        with trace_cost((fparams, fopt, fbatch)) as dry:
            step(fparams, fopt, fbatch, 0)
    del fparams, fopt, fbatch
    log(f"dryrun: dry trace {dry.seconds:.1f} s, {dry.aten_ops} aten ops")

    params = api.init_params(cfg, seed=0, device=dev)
    ostate = opt.init(params)
    chain = synthetic.markov_chain(0, cfg.vocab)
    batch = synthetic.lm_batch(chain, torch.Generator().manual_seed(0), b, s,
                               dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from repro_torch import kernels
    kernels.reset_counts()                        # the main path starts here
    with trace_cost((params, ostate, batch)) as real:
        params, ostate, m = step(params, ostate, batch, 0)
        torch.cuda.synchronize()
    counts = path_counts()                        # ... and ends here
    launched = {k: c["launches"] for k, c in kernels.counts().items()
                if c["launches"]}
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    del params, ostate, batch, m
    n_tok = b * s
    model_flops = 6.0 * cfg.n_active_params() * n_tok
    rl = analysis.analyze("minicpm_2b", f"train {b}x{s}", "1", 1, dry,
                          float(dry.peak_bytes), model_flops / 1e9)
    flop_gap = abs(dry.flops - real.flops) / real.flops
    peak_gap = abs(dry.peak_bytes - peak) / peak
    metrics = {
        "dry": {k: v for k, v in dry.to_dict().items()
                if k not in ("kernel_bytes",)},
        "real": {k: v for k, v in real.to_dict().items()
                 if k not in ("kernel_bytes",)},
        "model_flops_6NT": model_flops,
        "dry_flops_over_6NT": dry.flops / model_flops,
        "max_memory_allocated": peak, "flop_gap": flop_gap,
        "peak_gap": peak_gap, "loss": loss, "roofline": rl.to_dict(),
        "phase_s": time.perf_counter() - t_phase}
    log("dryrun metrics: " + json.dumps(metrics))
    log("dryrun launches: " + json.dumps(counts))
    assert math.isfinite(loss), loss
    check_counts(counts, DRYRUN_KERNELS)
    assert dry.calls == launched, (dry.calls, launched)
    assert dry.calls == real.calls, (dry.calls, real.calls)
    assert flop_gap <= DRYRUN_FLOP_RTOL, (dry.flops, real.flops)
    assert peak_gap <= DRYRUN_PEAK_RTOL, (dry.peak_bytes, peak)
    return {"counts": counts, "metrics": metrics}


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated between phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")


def _run_phases(dev, args, dry_procs) -> dict:
    """Phases 4-29 in order, then the dry cells; {phase: its result}."""
    phase_small_reference(dev)
    phase_small_formats(dev)
    phase_small_train(dev)
    phase_small_train_moe(dev)
    phase_small_fused(dev)
    phase_small_mamba(dev)
    phase_small_long(dev)
    phase_small_paper(dev)
    phase_small_families(dev)
    phase_small_ssm(dev)
    served = phase_serve(dev)
    if args.profile:
        phase_profile(served["server"])
    # the server's timing wrappers hold its own bound methods: a reference
    # cycle, which only the collector frees (params and pool, ~12 GB)
    del served["server"]
    free_device_memory()
    served_moe = phase_serve_moe(dev, args.profile)
    free_device_memory()
    trained = phase_train(dev, args.profile)
    free_device_memory()
    trained_moe = phase_train_moe(dev, args.profile)
    free_device_memory()
    trained_exact = phase_train_exact(dev, args.profile)
    free_device_memory()
    trained_fig4 = phase_train_fig4(dev, args.profile)
    free_device_memory()
    served_mamba = phase_serve_mamba(dev, args.profile)
    free_device_memory()
    ops = phase_ops(dev)
    free_device_memory()
    modes = phase_train_modes(dev)
    long_runs = phase_train_long(dev)
    served_dense = phase_serve_dense(dev)
    free_device_memory()
    trained_encdec = phase_train_encdec(dev, args.profile)
    free_device_memory()
    served_encdec = phase_serve_encdec(dev)
    free_device_memory()
    trained_paper = phase_train_paper(dev)
    free_device_memory()
    train_loop = phase_train_loop(dev)
    free_device_memory()
    trained_gemma3 = phase_train_gemma3(dev, args.profile)
    free_device_memory()
    served_gemma3 = phase_serve_gemma3(dev)
    free_device_memory()
    served_stablelm = phase_serve_stablelm(dev)
    free_device_memory()
    served_nemotron = phase_serve_nemotron(dev)
    free_device_memory()
    trained_zamba2 = phase_train_zamba2(dev, args.profile)
    free_device_memory()
    trained_mamba = phase_train_mamba(dev, args.profile)
    free_device_memory()
    served_zamba2 = phase_serve_zamba2(dev)
    free_device_memory()
    trained_mesh = phase_train_mesh(dev)
    free_device_memory()
    doctored = phase_doctor(dev)
    free_device_memory()
    dried = phase_dryrun(dev)
    free_device_memory()
    trained_tp = phase_train_tp_1x1(dev)
    free_device_memory()
    tp_rank0 = phase_tp_rank0(dev, next(p for p in dry_procs
                                        if p["cell"] is None))
    free_device_memory()
    phase_dry_cells(dry_procs)
    return dict(zip(PHASES, (served, trained, trained_moe, trained_exact,
                             trained_fig4, served_mamba, ops, modes,
                             long_runs["flash"], long_runs["naive"],
                             served_dense, trained_encdec, served_encdec,
                             trained_paper, train_loop, served_moe,
                             trained_gemma3, served_gemma3, served_stablelm,
                             served_nemotron, trained_zamba2, trained_mamba,
                             served_zamba2, trained_mesh, doctored, dried,
                             trained_tp, tp_rank0)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="build + phase 3 only (no kernels or contract "
                         "line)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v register/smem reports, fail "
                         "on a register spill, count the tensor-core "
                         "instructions of the flash kernels (HMMA) and the "
                         "large-M GEMM (HGMMA)")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler device time by kernel for "
                         "one admission and five decode ticks of each "
                         "server (serve, serve-moe) and one steady step of "
                         "each train phase")
    args = ap.parse_args()

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(args.ptxas)
    rows = phase_kernels(dev)
    if args.only == "kernels":
        return 0
    dry_procs = start_dry_cells()
    try:
        by_phase = _run_phases(dev, args, dry_procs)
    finally:
        stop_dry_cells(dry_procs)
    if args.profile:
        log_profiled_totals()
    out = []
    for name, row in rows.items():
        base = name.split()[0]
        key = next((v for k, v in SMALL_PATH.items() if name.startswith(k)),
                   base)
        launches = {f"launches_{ph}": r["counts"][key]["launches"]
                    for ph, r in by_phase.items()}
        out.append({"name": name, "route": "cuda", "source": SOURCES[base],
                    "replaces": REPLACES[base],
                    "launches": sum(launches.values()), **launches,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "shape": row["shape"],
                    **{k: row[k] for k in ("path_shape", "path_device_ms",
                                           "path_bound_ms") if k in row}})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
