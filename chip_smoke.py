#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build — compiles every kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all at once);
3. pair advance vs plain version — ``fused_advance_pair`` against
   ``pair_advance_ref`` on the card, on pairs packed by the port's
   ``ResidentPair`` from the main-path graph (one full block pair; lanes
   padded like a real bucket), for order {1,2} x alias {off,on} x record
   {off,on}, a deduped pair, an activated view, a single hop
   (``max_hops=1``), the oracle's layout (the whole graph as one
   contiguous slot, slot 1 aliasing it, 1,048,576 lanes), a gathered slot 1
   as SOGW builds it, and order-2 lanes whose prev is in neither slot; all
   six outputs must be bitwise equal; CUDA events time the kernel alone
   (launches queued behind a sleep kernel, so host work is hidden;
   cross-checked by ``torch.profiler``), the whole wrapper call and the
   plain version; each row also gives the lanes by hops taken and which
   slots the kernel's check found contiguous;
3b. bucket histogram vs plain version — ``bucket_hist_kernel`` against
   ``bucket_hist_ref``, bitwise, over 1,048,576 walks with 16, 4096 and
   65536 buckets, about 5% of ids out of range and 70% valid; timed like
   phase 3, beside ``torch.bincount`` as the library yardstick; each row
   records the host plan the kernel took (path, bin ranges, grid; no path
   launches a thread block cluster, so its cluster size is 1) and the host
   microseconds per wrapper call over 10,000 calls (at 16 buckets, with
   the functions that take them, by cProfile);
3c. kernel tier — ``node2vec_step`` through the kernel against the dense
   oracle (``use_kernel=False``), bitwise, on a pair of the phase-4 graph,
   for (p, q) in {(1, 1), (4, 0.25)}, plus an alias case and ``alias_step``;
4. whole runs — ``BiBlockEngine`` (unweighted, then weighted through the
   alias tables), then PB, SOGW, SGSC and ``InMemoryWalker``, each on the
   card (the kernel) against the same engine with ``device="cpu"`` (the
   plain version) on a 20k-vertex graph: endpoint counts, corpus, steps and
   deterministic I/O charges must be identical, and every engine must
   equal the oracle;
5. main paths — ``python -m repro_torch.launch.walk`` (in-process) with
   rwnv p=4 q=0.25 on a 1M-vertex, 16M-edge-entry graph in 16 blocks, 1M
   walks of length 20: ``--engine biblock --engine oracle`` (biblock's
   endpoint counts must equal the oracle's, bitwise), then ``sogw``, then
   ``pb`` and ``sgsc`` (each held to that oracle), then the disk backends
   while under 420 s; each run sets the launch
   counts to 0 before and reads them after, and must launch the kernel once
   per advance;
6. serving — ``repro_torch.serve.WalkQueryServer`` on the card: (6a) on the
   phase-4 graph, 256 skewed queries in batches of 64 with 2 hot blocks,
   on the card against ``device="cpu"``: equal answers and deterministic
   charges; (6b) on the main path's graph, 2,048 PPR queries
   (p=4, q=0.25, length 20, decay 0.85, 32 walks each; 85% from block 0)
   in two admission batches of 1,024 queries (32,768 walks), served with 2
   hot blocks and with pure LRU: equal answers, fewer block loads with
   pinned hits, each batch's endpoint CRC equal to a direct bi-block run's,
   every query's walks all retired; queries/s, seconds per batch and
   latency percentiles per server; (6c) ``python -m
   repro_torch.launch.serve`` (in-process) at its defaults.  Each served
   run sets the launch counts to 0 before and reads them after, and must
   launch the kernel once per advance;
7. LM serving — ``repro_torch.models`` with llama3.2-1b at its published
   widths: (7a) in float32 with TF32 off, all 16 layers, the teacher-forced
   forward's last-position logits against prefill of all but the last
   token plus one decode step (atol = rtol = 2e-3, the JAX package's own
   test), and the card's logits against the port's CPU run of the same
   weights cut to 2 layers (atol = rtol = 1e-3); (7b) in bfloat16, the
   config's dtype: 8 prompts of 512 tokens from ``default_rng(0)``,
   prefilled, then 63 greedy decode steps (64 new tokens) against a KV
   cache of 576 positions: prefill and per-step times beside their bounds,
   peak memory, the first sequence's tokens; logits must stay finite and
   tokens inside the vocabulary.  The phase launches neither kernel;
8. LM training — ``repro_torch.train.make_train_step`` (AdamW with a
   float32 master, the flash backward as a ``torch.autograd.Function``,
   remat, microbatches): (8a) the reduced llama config in float32 with TF32
   off, the loss, every leaf's gradient and one train step's parameters on
   the card against the CPU (atol = rtol = 1e-4), and the flash backward at
   a bfloat16 GQA shape (32 query and 8 KV heads of 64, 1,100 positions, so
   the chunks pad) against autograd through the plain chunked forward
   (largest gap within 2^-6 of the largest gradient); (8b) llama3.2-1b at
   its published widths in bfloat16 with the config's remat policy and
   microbatches: 8 sequences of 512 tokens from a seeded
   ``torch.Generator``, one warm-up step and 5 timed steps on the same
   batch, every loss finite and the last below the first; step time,
   tokens/s, the bound, peak memory, kernels per step and the card's idle
   share, and one microbatch's gradients and one optimiser update timed
   apart.  The phase launches neither kernel;
9. LM harness — ``repro_torch.data``, ``checkpoint``, ``runtime`` and
   ``launch.train``: (9a) tests/test_checkpoint_fault.py's crash -> resume
   on the card (the reduced llama, 12 steps, a checkpoint every 4, a crash
   at step 9, resumed from the newest committed step; the finished
   parameters within 1e-6 of an uninterrupted run's), and the
   uninterrupted run's checkpoint restored into a CPU tree, bitwise;
   (9b) ``python -m repro_torch.launch.train`` in process at llama3.2-1b's
   published widths (``--graph-vertices 50000 --batch 8 --seq 512
   --microbatches 2``): the launcher's corpus through the CUDA pair advance
   bitwise equal to the plain advance's; 4 steps on a corpus the kernel
   generates, a 17.30 GB checkpoint, then ``--steps 6`` resumed from step 4
   with the saved cursor; the step-4 checkpoint bitwise equal to the state
   the first run left; the resumed losses against steps 4-5 run in process
   from that state; the corpus seconds and launches, the step median,
   the snapshot, save and restore seconds, peak memory and losses.  The
   checkpoints go to ``.lm_harness_ckpt/`` in the checkout, which must hold
   two of them, and are deleted at the end of the phase.
10. distributed — ``repro_torch.core.distributed.DistributedWalkEngine``
   on ``torch.distributed``: (10a) NCCL, world size 1, a ``(1, 1)``
   ``DeviceMesh``, phase 5's graph and task in one block, through the
   kernel, against the same run with ``device="cpu"`` in a one-rank gloo
   group: the global arrays and
   sweeps bitwise equal, the endpoint counts equal to phase 5's oracle, and
   the kernel against its plain version on the advance's own inputs (the
   first round's pair and lanes, the unrouted rows dead at prev -1),
   bitwise; sweeps, rounds, launches, engine seconds, the ``exec_s``
   share and the collective seconds; (10b) DIST_RANKS gloo ranks, spawned
   processes sharing the card, a DIST_VERTICES-vertex graph in DIST_RANKS
   blocks on a ``(1, DIST_RANKS)`` mesh through the kernel: every rank's
   global arrays bitwise equal to a ``(1, 1)`` run of the same graph in one
   block through the plain version on the CPU.  Each child is bounded by
   DIST_TIMEOUT seconds, and a failed child fails the phase.
11. MoE / MLA serving — ``repro_torch.models.{moe,mla}`` in deepseek-v2-236b
   (MLA + MoE with 2 shared experts, 160 routed top-6) and mixtral-8x22b
   (sliding window + MoE, 8 experts top-2, each cut into 2 virtual
   experts) at their published widths: (11a) in float32 with TF32 off,
   deepseek cut to 1 dense + 1 MoE layer and mixtral to 1 layer, the
   capacity factor raised to the virtual expert count so nothing drops,
   the forward's last-position logits against prefill of 63 tokens plus
   one decode step (atol = rtol = 2e-3), and the reduced configs at the
   published capacity factor 1.25 on the card against the CPU (logits,
   aux, loss and every gradient within 1e-4; the top-k expert ids equal);
   (11b) in bfloat16 at the published capacity factor, deepseek cut to
   1 dense + 3 MoE layers, mixtral to 2: phase 7b's 8 prompts of 512
   tokens, prefill and 63 greedy decode steps against 576-position
   caches; prefill and per-step times beside their bounds, kernels per
   call and idle share, peak memory, the assignments dropped at prefill
   and at the first decode step, the cache bytes per token and layer;
   a second prefill bitwise equal to the first, logits finite, tokens
   inside the vocabulary.  The phase launches neither kernel.
12. SSD / RG-LRU / encoder-decoder serving — ``repro_torch.models.{ssm,
   rglru,encdec}`` in mamba2-2.7b, recurrentgemma-2b and whisper-tiny at
   their published widths: (12a) in float32 with TF32 off, mamba2 cut to 2
   layers, recurrentgemma to one (rglru, rglru, local) group and whisper at
   its full 4 + 4 layers, 2 prompts of 300 tokens (whisper over 1,500
   frames): prefill of 297 tokens (two SSD chunks, the second padded; a
   9-pass scan) and 3 chained decode steps against the forward's logits
   (atol = rtol = 2e-3), the card against the CPU on the same weights
   (1e-3), and the reduced configs on the card against the CPU (logits,
   aux, prefill caches, loss and every gradient within 1e-4); (12b) in
   bfloat16 at full depth: phase 7b's 8 prompts of 512 tokens (whisper: 8
   clips of 1,500 frames and 64-token prompts), prefilled twice (bitwise),
   then 63 greedy decode steps; prefill and per-step times beside their
   bounds, kernels per call and idle share, peak memory, the state and
   cache bytes per sequence; logits finite, tokens inside the vocabulary.
   The phase launches neither kernel.
13. expert-parallel MoE serving — ``models.moe``'s ``all_to_all`` dispatch
   under the rules of ``repro_torch.sharding.context``, in phase 11's two
   decoders: (13a) NCCL, world size 1, a ``(1, 1)`` ``DeviceMesh``, phase
   11b's cut, capacity factor, prompts and steps on the capacity path and
   on the expert-parallel path from the same weights: the prefill logits
   bitwise equal; the decode tokens compared (at 8 tokens the two
   capacity rules differ: the expert-parallel one keeps at least 4 rows an
   expert); 80 prompts of 16 tokens and 3 decode steps, where the two
   capacities agree, bitwise equal; times beside 11b's bounds, kernels per
   call, each ``all_to_all`` timed by CUDA events, and a cProfile of one
   decode step on each path; (13b) EP_RANKS gloo ranks, spawned processes
   sharing the card on a ``(1, EP_RANKS)`` mesh, each holding only its
   experts' rows (the ranks make the model in turn): (i) phase 11a's cut
   in float32 at capacity E_v (nothing dropped), rank 0's logits within
   LM_CPU_TOL of the world-1 capacity path's with equal top-k ids; (ii)
   phase 11b's cut: prefill and EP_DECODE_STEPS decode steps, each rank's
   times, ``all_to_all`` seconds and bytes, dropped assignments against
   13a's capacity path, peaks; logits finite, tokens inside the
   vocabulary.  Each rank fails if it loaded ``jax`` or ``repro``.  The
   phase launches neither kernel;
14. the multi-pod dry run — ``repro_torch.launch.dryrun``: (14a) NCCL,
   world size 1, a ``(1, 1)`` ``DeviceMesh``: the dry run's estimate
   (fake DTensors, nothing allocated) of llama3.2-1b's bf16 prefill of
   phase 7b's 8 x 512 prompts and of phase 8b's train step (8 x 512 tokens
   in the config's 2 microbatches), then the same steps for real on the
   card: the step's peak (``max_memory_allocated`` less what was allocated
   before it) within DRYRUN_PEAK_TOL of the estimate's ``temp``, and its
   FLOPs (``FlopCounterMode``) within DRYRUN_FLOPS_TOL of the estimate's;
   (14b) ``run_cell`` at full width on the fake (16, 16) mesh (256 fake
   ranks) for DRYRUN_CELLS, each record printed; a cell that fails fails
   the phase.  The phase launches neither kernel;
15. dense serving of the last four configs — qwen1.5-0.5b (QKV bias),
   internvl2-1b (256 patch embeddings from the stub frontend before the
   tokens), phi3-mini-3.8b (head_dim 96, 32 KV heads) and yi-34b (56 query
   heads over 8 KV heads) at their published widths: (15a) in float32 with
   TF32 off, each cut to 2 layers, 2 prompts of 128 tokens (internvl2-1b's
   after its patch embeddings): prefill of 125 tokens and 3 chained decode
   steps against the forward's logits (atol = rtol = 2e-3), and the reduced
   configs on the card against the CPU (logits, aux, prefill caches, loss
   and every gradient within 1e-4); (15b) in bfloat16 at full depth: phase
   7b's 8 prompts of 512 tokens prefilled twice (bitwise), then 63 greedy
   decode steps against caches of 576 positions (internvl2-1b's 832);
   prefill and per-step times beside 7b's bounds, kernels per call and idle
   share, peak memory, each with the card's name and power limit; logits
   finite, tokens inside the vocabulary.  The phase launches neither kernel.

There is no CPU fallback.

    python3 chip_smoke.py --kernels-only [--src DIR] [--out NAME]

runs phases 1-3b alone, on the port under ``DIR/src`` (default: this
checkout's; e.g. a parent commit unpacked with ``git archive``), and writes
the rows to ``chiprun_out/NAME.json``: the way to compare two versions of the
kernels within one call (parent, change, change, parent).

    python3 chip_smoke.py --hist-sweep [--out NAME]

times every bucket-histogram plan around the host plan's choice (each path,
block size, grid and bin ranges) at 1,048,576 walks over bucket counts on
both sides of each of the plan's limits, each bitwise against the plain
version: the measurements the plan's limits rest on.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

#: H100 SXM HBM3 rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12

#: the sleep that holds the stream while timed launches queue (about 25 ms)
SLEEP_CYCLES = 50_000_000

#: the main path's deployment: rwnv p=4 q=0.25 over an Erdos-Renyi graph
VERTICES, AVG_DEGREE, BLOCKS = 1_000_000, 16, 16
MAIN_LEN, MAIN_P, MAIN_Q = 20, 4.0, 0.25
#: the whole-run comparison's graph (phase 4)
WHOLE_VERTICES, WHOLE_BLOCKS = 20_000, 4
#: the serving mix (phase 6b): a burst of PPR queries, 85% of them from
#: block 0, admitted 1,024 at a time (two batches of 32,768 walks)
SERVE_QUERIES, SERVE_BATCH, SERVE_SKEW = 2048, 1024, 0.85
SERVE_CONFIG = dict(p=4.0, q=0.25, length=20, decay=0.85, samples=32)
#: ``IOStats.as_dict`` fields read off the wall clock or thread timing
TIMING_FIELDS = ("exec_time", "sim_wall_time", "writer_queue_peak")
#: the LM serving phase (7): llama3.2-1b at its published widths.  7a holds
#: decode against forward (float32, all layers) on LM_EQ_BATCH sequences of
#: LM_EQ_SEQ tokens, and the card against the CPU at LM_CPU_LAYERS layers;
#: 7b serves LM_BATCH prompts of LM_PROMPT tokens, LM_NEW new tokens each
LM_ARCH = "llama3.2-1b"
LM_EQ_BATCH, LM_EQ_SEQ, LM_CPU_LAYERS = 2, 128, 2
#: 7a's tolerances (atol = rtol): decode against forward is the JAX
#: package's tests/test_models.py::test_decode_matches_forward; card
#: against CPU, both float32 with TF32 off, differ by summation order only
LM_EQUIV_TOL, LM_CPU_TOL = 2e-3, 1e-3
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), for the FLOPs bound
BF16_FLOPS_PER_S = 989e12
#: the LM train phase (8).  8a: card against CPU, both float32 with TF32 off
#: (the tolerance of tests/test_torch_lm.py against the JAX package), and the
#: flash backward at a bf16 GQA shape against autograd through the plain
#: chunked forward: both take their products in float32, but the autograd
#: path rounds the probabilities' gradient to bf16 where the forward casts
#: them, and each side rounds dq, dk and dv to bf16, so the largest gap
#: may be a few bf16 steps (2^-8 relative) of the largest gradient
TRAIN_CPU_TOL = 1e-4
FLASH_B, FLASH_S, FLASH_H, FLASH_KVH, FLASH_D = 2, 1100, 32, 8, 64
FLASH_BF16_TOL = 2.0**-6
#: 8b: TRAIN_BATCH sequences of TRAIN_SEQ tokens, a warm-up step, then
#: TRAIN_STEPS timed steps on the same batch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
#: the LM harness phase (9).  9a is tests/test_checkpoint_fault.py's crash ->
#: resume on the card: the reduced llama, 64 walks of 17 vertices below 200
#: from default_rng(0), batches(4, 16, seed=7), a checkpoint every 4 steps,
#: 12 steps, a crash at step 9; the finished parameters within the JAX
#: test's atol of the uninterrupted run's (the card's scatter-adds in the
#: backward are not deterministic, so not bitwise)
HARNESS_WALKS, HARNESS_STEPS, HARNESS_CRASH, HARNESS_TOL = (64, 17), 12, 9, 1e-6
#: 9b: ``python -m repro_torch.launch.train`` at llama3.2-1b's published
#: widths, in process: a corpus of 2 walks of 32 steps per vertex of a
#: 50,000-vertex graph (generated on the card; cut from 100,000 when the
#: plain advance's corpus joined the phase), 8 x 512 tokens in 2
#: microbatches (phase 8b's shape), 4 steps, then 6 resumed from step 4;
#: the checkpoints go to HARNESS_DIR inside the checkout and are deleted
HARNESS_ARGV = ["--arch", LM_ARCH, "--graph-vertices", "50000", "--batch", "8", "--seq", "512",
                "--microbatches", "2"]  # fmt: skip
HARNESS_FIRST, HARNESS_SECOND = 4, 6
#: the resumed run's losses at steps 4 and 5 against steps 4 and 5 run in
#: process from the first run's state (no checkpoint between): relative
#: gap.  Step 4's loss comes from the same bits; step 5's from an update
#: whose backward has the card's scatter-adds, which are not deterministic,
#: rounded to bf16 parameters.  The first run's losses differ by ~3% from
#: batch to batch
HARNESS_LOSS_RTOL = 1e-3
HARNESS_DIR = ROOT / ".lm_harness_ckpt"
#: the distributed phase (10): 10a runs the main path's graph and task in
#: one block; 10b runs DIST_RANKS gloo ranks on one card, DIST_VERTICES
#: vertices in DIST_RANKS blocks; every child process and collective is
#: bounded by DIST_TIMEOUT seconds
DIST_VERTICES, DIST_RANKS, DIST_TIMEOUT = 250_000, 4, 300
#: the MoE / MLA serving phase (11), the two MoE decoders at their published
#: widths.  11a: decode against forward in float32 with TF32 off at the
#: depth MOE_EQ_SEGMENTS, capacity_factor = the virtual expert count (no
#: assignment drops), LM_EQ_BATCH sequences of MOE_EQ_SEQ tokens, within
#: LM_EQUIV_TOL; and the reduced configs at the published capacity factor
#: MOE_CF (assignments drop) on the card against the CPU within
#: MOE_CPU_TOL (tests/test_torch_lm.py's tolerance against the JAX
#: package), with equal top-k ids.  11b: bf16 at MOE_CF, the depth cut to
#: MOE_SERVE_SEGMENTS (deepseek 27.25 GB, mixtral 10.82 GB of weights),
#: phase 7b's LM_BATCH prompts of LM_PROMPT tokens and LM_NEW new tokens
MOE_ARCHS = ("deepseek-v2-236b", "mixtral-8x22b")
MOE_EQ_SEGMENTS = {
    "deepseek-v2-236b": ((("mla+mlp",), 1), (("mla+moe",), 1)),
    "mixtral-8x22b": ((("local+moe",), 1),),
}
MOE_SERVE_SEGMENTS = {
    "deepseek-v2-236b": ((("mla+mlp",), 1), (("mla+moe",), 3)),
    "mixtral-8x22b": ((("local+moe",), 2),),
}
MOE_EQ_SEQ, MOE_CF, MOE_CPU_TOL = 64, 1.25, 1e-4
#: the SSD / RG-LRU / encoder-decoder serving phase (12), the three models at
#: their published widths.  12a: float32 with TF32 off, mamba2 cut to 2
#: layers and recurrentgemma to one (rglru, rglru, local) group, whisper at
#: its full 4 + 4; LM_EQ_BATCH prompts of REC_EQ_SEQ tokens (whisper over
#: REC_FRAMES frames), prefill of all but REC_EQ_STEPS tokens (two SSD chunks
#: of 256, the second padded; a 9-pass scan), then REC_EQ_STEPS chained
#: decode steps against the forward within LM_EQUIV_TOL; the card against
#: the CPU on the same weights within LM_CPU_TOL; the reduced configs card
#: against CPU within REC_CPU_TOL (logits, caches, loss, every gradient).
#: 12b: bf16 at full depth, phase 7b's LM_BATCH prompts of LM_PROMPT tokens
#: (whisper: REC_WHISPER_PROMPT tokens over REC_FRAMES frames, its 30 s
#: window) and LM_NEW new tokens
REC_ARCHS = ("mamba2-2.7b", "recurrentgemma-2b", "whisper-tiny")
REC_EQ_SEGMENTS = {
    "mamba2-2.7b": ((("ssd",), 2),),
    "recurrentgemma-2b": ((("rglru+mlp", "rglru+mlp", "local+mlp"), 1),),
    "whisper-tiny": None,
}
REC_EQ_SEQ, REC_EQ_STEPS, REC_CPU_TOL = 300, 3, 1e-4
REC_FRAMES, REC_WHISPER_PROMPT = 1500, 64
#: the expert-parallel MoE phase (13), phase 11's two decoders.  13a: NCCL,
#: world 1, a (1, 1) mesh with the expert-parallel rules published, phase
#: 11b's cut, capacity factor, prompts and steps, against the capacity path
#: on the same weights; then EP_EQ_BATCH prompts of EP_EQ_PROMPT tokens and
#: EP_EQ_STEPS decode steps, a batch whose decode step's capacity reaches
#: the expert-parallel floor of 4, so the two paths' bins have one shape
#: (at LM_BATCH sequences the capacity path's is 1 for deepseek and 3 for
#: mixtral).  13b: EP_RANKS gloo ranks sharing the card on a (1, EP_RANKS)
#: mesh, each holding only its experts' rows: (i) phase 11a's cut in
#: float32 at capacity E_v against the world-1 capacity path within
#: LM_CPU_TOL, (ii) phase 11b's cut, prefill and EP_DECODE_STEPS decode
#: steps.  Children are bounded by EP_TIMEOUT seconds
EP_EQ_BATCH, EP_EQ_PROMPT, EP_EQ_STEPS = 80, 16, 3
EP_RANKS, EP_DECODE_STEPS, EP_TIMEOUT = 4, 15, 400
#: the dry-run phase (14): 14a's bounds on the estimate against the real
#: step (peak: |measured - estimate| / measured; FLOPs likewise), 14b's
#: full-width cells (one through the expert-parallel dispatch, one at
#: batch 1 over 524,288 positions)
DRYRUN_PEAK_TOL, DRYRUN_FLOPS_TOL, DRYRUN_TIMEOUT = 0.10, 0.01, 300
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"))  # fmt: skip
#: the dense serving phase (15), the four configs phases 7-14 left out, at
#: their published widths: qwen1.5-0.5b (QKV bias), internvl2-1b (its
#: num_prefix patch embeddings before the tokens), phi3-mini-3.8b (head_dim
#: 96, 32 KV heads), yi-34b (56 query heads over 8 KV heads).  15a: float32
#: with TF32 off, the depth cut to DENSE_EQ_LAYERS, LM_EQ_BATCH prompts of
#: LM_EQ_SEQ tokens, prefill of all but DENSE_EQ_STEPS tokens then that many
#: chained decode steps against the forward within LM_EQUIV_TOL; the reduced
#: configs card against CPU within DENSE_CPU_TOL (logits, aux, prefill
#: caches, loss, every gradient).  15b: bf16 at full depth, phase 7b's
#: LM_BATCH prompts of LM_PROMPT tokens and LM_NEW new tokens
DENSE_ARCHS = ("qwen1.5-0.5b", "internvl2-1b", "phi3-mini-3.8b", "yi-34b")
DENSE_EQ_LAYERS, DENSE_EQ_STEPS, DENSE_CPU_TOL = 2, 3, 1e-4
#: the bucket histogram's shapes (phase 3b): the main path's 1M walks,
#: padded to the tile, over its 16 blocks and two larger bucket counts
HIST_N, HIST_NBS = 1_048_576, (16, 4096, 65536)
#: the bucket counts of ``--hist-sweep``: both sides of each of the plan's
#: limits at HIST_N walks, and counts between them
HIST_SWEEP_NBS = (
    16, 32, 64, 128, 248, 249, 283, 284, 300, 512, 513, 682, 683, 1024, 1025, 2048, 2049, 4096,
    8192, 16384, 21845, 21846, 32768, 58112, 58113, 65536, 80659, 80660, 104857, 104858, 131072,
    232448,
)


def main_argv(engines=("biblock",)):
    argv = [
        "--task", "rwnv", "--vertices", str(VERTICES),
        "--avg-degree", str(AVG_DEGREE), "--blocks", str(BLOCKS), "--walks-per-vertex", "1",
        "--length", str(MAIN_LEN), "--p", str(MAIN_P), "--q", str(MAIN_Q),
    ]  # fmt: skip
    for e in engines:
        argv += ["--engine", e]
    return argv


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip


def cuda_ms(fn, reps: int) -> float:
    """Mean stream time of ``fn()``, host work between calls included."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def queued_ms(launch, reps: int) -> tuple[float, float]:
    """Mean device time of one ``launch()``: a sleep kernel holds the stream
    while ``reps`` launches queue behind it, so they run back to back and the
    host's work per launch is hidden.  Also returns the host seconds the
    queueing took, which must stay below the sleep for that to hold."""
    import torch

    launch()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, host_s


def profiled_ms(launch, reps: int, kernel: str):
    """Mean device duration of ``kernel`` over ``reps`` launches, as
    ``torch.profiler`` reads it (None when it sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            if us > 0:
                return us / ev.count / 1e3
    return None


def host_cost(call, *, profile: bool, calls: int = 10_000):
    """Host microseconds per ``call()``: the least of three loops of
    ``calls`` calls, each closed by one synchronize (the device work per
    call is shorter than the host's, so the loop is host-bound).  With
    ``profile``, also the functions that take the most time per call in
    one more loop under cProfile (which slows it): ``[name, us]`` rows."""
    import cProfile
    import pstats

    import torch

    def loop():
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    loop()  # warm up
    best = min(loop() for _ in range(3))
    if not profile:
        return best, None
    prof = cProfile.Profile()
    prof.runcall(loop)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return best, [[f"{Path(f).name}:{line}:{fn}", tt / calls * 1e6]
                  for (f, line, fn), (_, _, tt, _, _) in top]  # fmt: skip


def max_abs_err(want, got) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(want, got))


def phase_kernels(dev):
    """Phase 3: the kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from repro_torch.core import BlockedGraph, BlockView, CSRGraph, erdos_renyi
    from repro_torch.core import partition_into_n_blocks
    from repro_torch.engines.base import ResidentPair
    from repro_torch.engines.step import pair_advance_ref, pow2_pad, remap_search_iters
    from repro_torch.kernels import rng
    from repro_torch.kernels import pair_advance as pa

    fused_advance_pair = pa.fused_advance_pair
    t0 = time.perf_counter()
    # the main path's graph, as the launcher builds it
    g = erdos_renyi(VERTICES, VERTICES * AVG_DEGREE // 2, seed=0)
    bg = partition_into_n_blocks(g, BLOCKS)
    w = np.random.default_rng(1).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
    bgw = BlockedGraph(CSRGraph(g.indptr, g.indices, w), bg.block_starts, build_alias=True)
    log(f"[kernels] graph built in {time.perf_counter() - t0:.1f}s: {bg.describe()}")

    # lanes of a block-0 bucket: one walk per vertex, mid-walk hops, prev a
    # neighbour of cur (first hop: prev == cur), padded to a power of two
    r = np.random.default_rng(2)
    s0, e0 = int(bg.block_starts[0]), int(bg.block_starts[1])
    n = e0 - s0
    N = pow2_pad(n)
    cur = np.arange(s0, e0)
    deg = g.indptr[cur + 1] - g.indptr[cur]
    k = np.minimum((r.random(n) * deg).astype(np.int64), np.maximum(deg - 1, 0))
    prev = np.where(deg > 0, g.indices[g.indptr[cur] + k], cur)
    hop = r.integers(0, MAIN_LEN, n)
    prev = np.where(hop == 0, cur, prev)
    lanes = np.zeros((4, N), np.int32)
    lanes[0, :n], lanes[1, :n], lanes[2, :n], lanes[3, :n] = np.arange(n), prev, cur, hop
    alive = np.zeros(N, bool)
    alive[:n] = True
    lanes_dev = [t for t in torch.as_tensor(lanes, device=dev).unbind(0)]
    alive_dev = torch.as_tensor(alive, device=dev)

    s1, e1 = int(bg.block_starts[1]), int(bg.block_starts[2])
    in_b1 = prev[(prev >= s1) & (prev < e1)]
    act = np.union1d(in_b1[::2], np.arange(s1, e1, 7))  # misses half the block-1 prevs
    # SOGW's slot 1: the rows of the prevs outside the current block
    outside = ((prev < s0) | (prev >= e0)) & (hop > 0)
    gathered = np.unique(prev[outside])
    # prevmiss: every lane past hop 0, its prev outside both blocks of the pair
    miss = (prev >= s0) & (prev < e1)
    prev_miss = np.where(miss, r.integers(e1, VERTICES, n), prev)
    lanes_miss = lanes.copy()
    lanes_miss[1, :n], lanes_miss[3, :n] = prev_miss, np.maximum(hop, 1)
    lanes_miss_dev = list(torch.as_tensor(lanes_miss, device=dev).unbind(0))
    # the oracle: every vertex starts a walk (prev == cur, hop 0), whole graph
    n_all = VERTICES
    N_all = pow2_pad(n_all)
    lanes_all = np.zeros((4, N_all), np.int32)
    lanes_all[:3, :n_all] = np.arange(n_all)  # wid, prev, cur
    alive_all = np.zeros(N_all, bool)
    alive_all[:n_all] = True
    lanes_all_dev = list(torch.as_tensor(lanes_all, device=dev).unbind(0))
    alive_all_dev = torch.as_tensor(alive_all, device=dev)

    def views(graph, case):
        full = lambda b: BlockView.from_resident(graph.materialize_block(b))
        if case == "dedup":
            v = full(0)
            return v, v
        if case == "activated":
            return full(0), graph.partial_view(1, act)
        if case == "gathered":
            return full(0), graph.gather_view(gathered)
        return full(0), full(1)

    def oracle_args(graph):
        # the whole graph as one slot, slot 1 aliasing it (engines/inmemory.py)
        V = graph.num_vertices
        base0 = np.zeros(2, np.int32)
        pair_np = (
            np.arange(V, dtype=np.int32), np.array([V, V], np.int32), base0,
            graph.graph.indptr.astype(np.int32), base0, graph.graph.indices.astype(np.int32),
            base0, np.zeros(1, np.int32), np.ones(1, np.float32),
        )  # fmt: skip
        return tuple(torch.as_tensor(a, device=dev) for a in pair_np), remap_search_iters(V)

    variants = [("pair", o, a, rec) for o in (2, 1) for a in (False, True) for rec in (False, True)]
    variants += [("dedup", 2, False, True), ("activated", 2, False, True)]
    variants += [("single", 2, False, False)]  # one hop (max_hops=1), as ops.node2vec_step
    variants += [("oracle", 2, False, False), ("gathered", 2, False, True)]
    variants += [("prevmiss", 2, False, True)]
    n_iters = int(np.ceil(np.log2(max(bg.max_block_edges, 2)))) + 2
    key = rng.key_halves(0)
    rows = []
    for case, order, has_alias, record in variants:
        graph = bgw if has_alias else bg
        if case == "oracle":
            args, v_iters = oracle_args(graph)
            lanes_in, alive_in, n_real = lanes_all_dev, alive_all_dev, n_all
            n_it = int(np.ceil(np.log2(max(g.num_edges, 2)))) + 2
        else:
            pair = ResidentPair(graph, has_alias, device=dev)
            v0, v1 = views(graph, case)
            pair.set_slot(0, v0)
            pair.set_slot(1, v1)
            args, v_iters = pair.device_args()
            lanes_in = lanes_miss_dev if case == "prevmiss" else lanes_dev
            alive_in, n_real, n_it = alive_dev, n, n_iters
        statics = dict(
            order=order, k_max=16 if order == 2 else 1, n_iters=n_it, v_iters=v_iters,
            record=record, has_alias=has_alias, max_len=MAIN_LEN,
            max_hops=1 if case == "single" else None,
        )  # fmt: skip
        N = lanes_in[0].shape[0]
        call = (*args, *lanes_in, alive_in, key, MAIN_LEN, 1.0, MAIN_P, MAIN_Q)
        want = pair_advance_ref(*call, **statics)
        got = fused_advance_pair(*call, **statics)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{case} {statics}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = max_abs_err(want, got)
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        if not same:
            raise AssertionError(f"kernel != plain version on {case} {statics}: max|err|={err}")
        # the slots the kernel found contiguous (a tree from before the
        # slot check has no answer)
        contiguous = pa.contiguous_slots() if hasattr(pa, "contiguous_slots") else None
        # the kernel alone (outputs allocated once, launched outside the
        # wrapper, so these launches are not counted), cross-checked with the
        # profiler; then the whole wrapper call, as the engine pays it
        _, plan = pa._prepare(call[:9], call[9:14], *call[14:], **statics)
        kernel_ms, host_s = queued_ms(lambda: pa._launch(plan), 20)
        prof_ms = profiled_ms(lambda: pa._launch(plan), 20, "pair_advance_kernel")
        call_ms = cuda_ms(lambda: fused_advance_pair(*call, **statics), 20)
        plain_ms = cuda_ms(lambda: pair_advance_ref(*call, **statics), 2)
        nbytes = sum(t.numel() * t.element_size() for t in args)
        nbytes += N * (4 * 4 + 1)  # lanes in: wid, prev, cur, hop (i32) + alive (bool)
        nbytes += N * (3 * 4 + 1) + 4  # lanes out + steps
        if record:
            nbytes += got[5].numel() * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        steps = int(got[4])
        # lanes by hops taken in the launch
        taken = (got[2] - lanes_in[3])[:n_real].cpu().numpy()
        row = dict(
            case=case, order=order, has_alias=has_alias, record=record, lanes=N,
            pair_bytes=sum(t.numel() * t.element_size() for t in args), steps=steps,
            bitwise_equal=same, max_abs_err=err, kernel_ms=kernel_ms, profiler_ms=prof_ms,
            call_ms=call_ms, queue_host_s=host_s, plain_ms=plain_ms, bound_ms=bound_ms,
            bytes=nbytes, hops_hist=np.bincount(taken).tolist(),
            contiguous=contiguous,
        )  # fmt: skip
        rows.append(row)
        log(f"[kernels] {json.dumps(row)}")
    return rows


def _sig(res):
    s = res.stats
    return (
        res.endpoint_counts.tobytes(), res.corpus.tobytes(), s.steps_sampled, s.block_ios,
        s.block_bytes, s.ondemand_ios, s.ondemand_bytes, s.walk_bytes_written,
        s.peak_resident_bytes,
    )  # fmt: skip


def _whole_graph(weighted=False):
    import numpy as np

    from repro_torch.core import BlockedGraph, CSRGraph, erdos_renyi, partition_into_n_blocks

    g = erdos_renyi(WHOLE_VERTICES, WHOLE_VERTICES * 8, seed=5)
    bg = partition_into_n_blocks(g, WHOLE_BLOCKS)
    if not weighted:
        return bg
    g = bg.graph
    w = np.random.default_rng(5).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
    return BlockedGraph(CSRGraph(g.indptr, g.indices, w), bg.block_starts, build_alias=True)


def phase_whole_run(dev):
    """Phase 4: whole bi-block runs, the kernel on the card against the
    plain version on the CPU: the unweighted graph, then a weighted one
    (alias proposals)."""
    from repro_torch.core import rwnv_task
    from repro_torch.engines import BiBlockEngine
    from repro_torch.kernels.pair_advance import fused_advance_pair

    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=1, length=10, seed=5)
    legs = {}
    for leg, weighted in (("plain", False), ("weighted", True)):
        bg = _whole_graph(weighted)
        out = {}
        for name, on in (("cuda", dev), ("cpu", "cpu")):
            before = fused_advance_pair.launches
            t0 = time.perf_counter()
            res = BiBlockEngine(bg, task, record_walks=True, device=on).run()
            launched = fused_advance_pair.launches - before
            out[name] = (res, time.perf_counter() - t0, launched)
            log(f"[whole] {leg} {name}: {out[name][1]:.2f}s, steps {res.steps_sampled}, "
                f"advance calls {res.advance_calls}, kernel launches {launched}")  # fmt: skip
        (rc, _, lc), (rt, _, lt) = out["cuda"], out["cpu"]
        if _sig(rc) != _sig(rt):
            raise AssertionError(f"whole run ({leg}): cuda and cpu signatures differ")
        if lc != rc.advance_calls or lc == 0 or lt != 0:
            raise AssertionError(
                f"whole run ({leg}): launches {lc}/{lt} vs advance calls {rc.advance_calls}"
            )
        if rc.endpoint_counts.sum() != rc.num_walks or (rc.corpus[:, 0] < 0).any():
            raise AssertionError(f"whole run ({leg}): walks unaccounted for")
        legs[leg] = dict(seconds_cuda=out["cuda"][1], seconds_cpu=out["cpu"][1],
                         steps=rc.steps_sampled, advance_calls=rc.advance_calls)  # fmt: skip
    return legs


def _hist_data(r, nb):
    """1,048,576 walks over ``nb`` buckets: about 5% of ids out of range on
    both sides, 70% valid (numpy arrays)."""
    import numpy as np

    ids = r.integers(0, nb, HIST_N).astype(np.int32)
    out = r.random(HIST_N) < 0.05
    ids[out] = np.where(r.random(out.sum()) < 0.5, -1 - r.integers(0, nb, out.sum()),
                        nb + r.integers(0, nb, out.sum()))  # fmt: skip
    return ids, r.random(HIST_N) < 0.7


def phase_hist(dev):
    """Phase 3b: the bucket histogram against its plain version.  Both trees
    of an A/B are timed through ``bucket_hist._launch(ids, valid, out,
    ...)``, which adds into a zeroed ``out``: a tree with a host plan
    (``bucket_hist.plan``) launches the plan's choice, and its row records
    that plan; an older one takes ``shared=``, its wrapper's rule."""
    import numpy as np
    import torch

    from repro_torch.kernels import bucket_hist as bh

    planned = hasattr(bh, "plan")
    # the floor of any launch timed this way: a one-thread kernel
    floor_ms, _ = queued_ms(lambda: torch.cuda._sleep(1), 20)
    r = np.random.default_rng(3)
    rows = []
    for nb in HIST_NBS:
        ids, valid = _hist_data(r, nb)
        ids_d = torch.as_tensor(ids, device=dev)
        valid_d = torch.as_tensor(valid, device=dev)
        want = bh.bucket_hist_ref(ids_d, valid_d, num_buckets=nb)
        got = bh.bucket_hist_kernel(ids_d, valid_d, num_buckets=nb)
        torch.cuda.synchronize()
        err = int((want.long() - got.long()).abs().max())
        if not torch.equal(want, got):
            raise AssertionError(f"bucket_hist != plain version at NB={nb}: max|err|={err}")
        in_range = (ids >= 0) & (ids < nb)
        if int(got.sum()) != int((valid & in_range).sum()):
            raise AssertionError(f"bucket_hist at NB={nb} does not count the valid in-range ids")
        # no path of either tree launches a thread block cluster
        scratch = torch.zeros(nb, dtype=torch.int32, device=dev)
        if planned:
            taken = dict(cluster=1, **bh.plan(HIST_N, nb, bh.device_info(dev))._asdict())
            launch = lambda: bh._launch(ids_d, valid_d, scratch)
        else:
            shared = nb <= bh.SHARED_BINS_MAX
            taken = dict(path="shared" if shared else "global", cluster=1, grid=None)
            launch = lambda: bh._launch(ids_d, valid_d, scratch, shared=shared)
        kernel_ms, host_s = queued_ms(launch, 20)
        prof_ms = profiled_ms(launch, 20, "bucket_hist")
        # the whole wrapper call is host-bound: the least of five runs of 100
        call = lambda: bh.bucket_hist_kernel(ids_d, valid_d, num_buckets=nb)
        call_ms = min(cuda_ms(call, 100) for _ in range(5))
        host_us, host_profile = host_cost(call, profile=nb == HIST_NBS[0])
        plain_ms = cuda_ms(lambda: bh.bucket_hist_ref(ids_d, valid_d, num_buckets=nb), 2)
        # the library yardstick: one bincount over ids drawn in range, the
        # valid flags as float weights (it does no range filter, no int cast)
        lib_ids = torch.as_tensor(r.integers(0, nb, HIST_N), device=dev)
        lib_w = valid_d.float()
        library_ms = cuda_ms(lambda: torch.bincount(lib_ids, weights=lib_w, minlength=nb), 20)
        nbytes = HIST_N * 4 + HIST_N * 1 + nb * 4
        row = dict(
            num_buckets=nb, **taken, walks=HIST_N,
            counted=int(got.sum()), bitwise_equal=True, max_abs_err=err, kernel_ms=kernel_ms,
            profiler_ms=prof_ms, call_ms=call_ms, host_us=host_us, host_profile=host_profile,
            queue_host_s=host_s, plain_ms=plain_ms,
            library_ms=library_ms, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            launch_floor_ms=floor_ms,
        )  # fmt: skip
        rows.append(row)
        log(f"[hist] {json.dumps(row)}")
    return rows


def _sweep_plans(bh, nb, card):
    """The plans the sweep times at ``nb``: the plan's own, then each path
    over block sizes, copies and bin ranges around it, every block of a
    plan resident at once (``bucket_hist.blocks_per_sm``)."""
    n4, sms = HIST_N // 4, card.sms
    seen = {bh.plan(HIST_N, nb, card)}
    for threads in (256, 512, 1024):
        for per_sm in (1, 2, 4):
            grid = min(sms * per_sm, -(-n4 // threads))
            if per_sm <= bh.blocks_per_sm(card, threads, nb * 4):
                seen.add(bh.Plan("block", 1, grid, threads))
    for ranges in range(2, 7):
        smem = -(-nb // ranges) * 4
        for copies in {sms // ranges, 2 * sms // ranges}:
            if ranges <= nb and -(-copies * ranges // sms) <= bh.blocks_per_sm(card, 1024, smem):
                seen.add(bh.Plan("range", ranges, copies * ranges, 1024))
    for per_sm in (4, 8):
        seen.add(bh.Plan("global", 1, min(sms * per_sm, -(-n4 // 256)), 256))
    return sorted(seen)


def phase_hist_sweep(dev):
    """The measurements behind ``bucket_hist.plan``: every plan of
    :func:`_sweep_plans` at 1,048,576 walks, bitwise against the plain
    version, timed as phase 3b times the kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import bucket_hist as bh

    card = bh.device_info(dev)
    # the floor of any launch timed this way: a one-thread kernel
    floor_ms, _ = queued_ms(lambda: torch.cuda._sleep(1), 20)
    log(f"[sweep] floor_ms={floor_ms}")
    r = np.random.default_rng(3)
    rows = [dict(floor_ms=floor_ms)]
    for nb in HIST_SWEEP_NBS:
        ids, valid = _hist_data(r, nb)
        ids_d = torch.as_tensor(ids, device=dev)
        valid_d = torch.as_tensor(valid, device=dev)
        want = bh.bucket_hist_ref(ids_d, valid_d, num_buckets=nb)
        chosen = bh.plan(HIST_N, nb, card)
        for p in _sweep_plans(bh, nb, card):
            out = torch.zeros(nb, dtype=torch.int32, device=dev)
            bh._launch(ids_d, valid_d, out, forced=p)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"bucket_hist plan {p} != plain version at NB={nb}")
            kernel_ms, _ = queued_ms(lambda: bh._launch(ids_d, valid_d, out, forced=p), 20)
            row = dict(num_buckets=nb, **p._asdict(), chosen=p == chosen, kernel_ms=kernel_ms)
            rows.append(row)
            log(f"[sweep] {json.dumps(row)}")
    return rows


def phase_tier(dev):
    """Phase 3c: the single-hop kernel tier against the dense oracle."""
    import numpy as np
    import torch

    from repro_torch.core import BlockView
    from repro_torch.engines.base import ResidentPair
    from repro_torch.engines.step import pow2_pad
    from repro_torch.kernels import alias_step, node2vec_step, rng

    rows = []
    n = 2000
    for weighted, cases in ((False, [(1.0, 1.0), (4.0, 0.25)]), (True, [(0.5, 2.0)])):
        bg = _whole_graph(weighted)
        g = bg.graph
        pair = ResidentPair(bg, weighted, device=dev)
        pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
        # slot 1: an activated view over part of block 2, so some prevs miss
        s2, e2 = int(bg.block_starts[2]), int(bg.block_starts[3])
        pair.set_slot(1, bg.partial_view(2, np.arange(s2, e2, 2)))
        args, v_iters = pair.device_args()
        r = np.random.default_rng(7)
        cur = r.integers(0, int(bg.block_starts[1]), n)
        deg = g.indptr[cur + 1] - g.indptr[cur]
        k = np.minimum((r.random(n) * deg).astype(np.int64), np.maximum(deg - 1, 0))
        prev = np.where(r.random(n) < 0.6, g.indices[g.indptr[cur] + k], r.integers(s2, e2, n))
        hop = r.integers(0, MAIN_LEN, n)
        N = pow2_pad(n)
        lanes = np.zeros((4, N), np.int32)
        lanes[0, :n], lanes[1, :n], lanes[2, :n], lanes[3, :n] = np.arange(n), prev, cur, hop
        alive = np.zeros(N, bool)
        alive[:n] = r.random(n) < 0.9
        wid, prv, cu, hp = torch.as_tensor(lanes, device=dev).unbind(0)
        act = torch.as_tensor(alive, device=dev)
        key = rng.key_halves(13)
        for p, q in cases:
            kw = dict(p=p, q=q, k_max=4, n_iters=20, v_iters=v_iters, has_alias=weighted)
            zk, mk = node2vec_step(*args, wid, prv, cu, hp, act, key, **kw)
            zr, mr = node2vec_step(*args, wid, prv, cu, hp, act, key, use_kernel=False, **kw)
            torch.cuda.synchronize()
            same = torch.equal(zk, zr) and torch.equal(mk, mr)
            err = max_abs_err((zr, mr), (zk, mk))
            if not same or int(mk.sum()) == 0:
                raise AssertionError(f"node2vec_step kernel != oracle at {kw}: max|err|={err}")
            rows.append(dict(step="node2vec_step", p=p, q=q, has_alias=weighted, lanes=N,
                             moved=int(mk.sum()), bitwise_equal=same, max_abs_err=err))  # fmt: skip
        if weighted:
            ak = alias_step(*args, wid, cu, act, key, v_iters=v_iters)
            ar = alias_step(*args, wid, cu, act, key, v_iters=v_iters, use_kernel=False)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(ak, ar))
            if not same:
                raise AssertionError("alias_step kernel != dense oracle")
            rows.append(dict(step="alias_step", has_alias=True, lanes=N, moved=int(ak[1].sum()),
                             bitwise_equal=same, max_abs_err=max_abs_err(ar, ak)))  # fmt: skip
    for row in rows:
        log(f"[tier] {json.dumps(row)}")
    return rows


def phase_other_engines(dev):
    """Phase 4b: whole PB, SOGW, SGSC and oracle runs, the kernel on the
    card against the plain version on the CPU, and every engine against the
    oracle."""
    from repro_torch.core import rwnv_task
    from repro_torch.engines import InMemoryWalker, PlainBucketEngine, SOGWEngine
    from repro_torch.kernels.pair_advance import fused_advance_pair

    bg = _whole_graph()
    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=1, length=10, seed=5)
    makers = {
        "oracle": lambda kw: InMemoryWalker(bg, task, **kw),
        "pb": lambda kw: PlainBucketEngine(bg, task, record_walks=True, **kw),
        "sogw": lambda kw: SOGWEngine(bg, task, record_walks=True, **kw),
        "sgsc": lambda kw: SOGWEngine(bg, task, static_cache=True, record_walks=True, **kw),
    }
    out, oracle = {}, None
    for name, make in makers.items():
        runs = {}
        for leg, on in (("cuda", dev), ("cpu", "cpu")):
            before = fused_advance_pair.launches
            t0 = time.perf_counter()
            res = make(dict(device=on)).run()
            runs[leg] = (res, time.perf_counter() - t0, fused_advance_pair.launches - before)
        (rc, sc, lc), (rt, st, lt) = runs["cuda"], runs["cpu"]
        log(f"[engines] {name}: cuda {sc:.2f}s / cpu {st:.2f}s, steps {rc.steps_sampled}, "
            f"advance calls {rc.advance_calls}, kernel launches {lc}, vertex_ios "
            f"{rc.stats.vertex_ios}")  # fmt: skip
        if _sig(rc) != _sig(rt) or rc.stats.vertex_ios != rt.stats.vertex_ios:
            raise AssertionError(f"{name}: cuda and cpu signatures differ")
        if lc != rc.advance_calls or lc == 0 or lt != 0:
            raise AssertionError(f"{name}: launches {lc}/{lt} vs advance calls {rc.advance_calls}")
        oracle = rc if name == "oracle" else oracle
        same_counts = (rc.endpoint_counts == oracle.endpoint_counts).all()
        if not same_counts or (rc.corpus != oracle.corpus).any():
            raise AssertionError(f"{name}: walks differ from the oracle's")
        out[name] = dict(seconds_cuda=sc, seconds_cpu=st, steps=rc.steps_sampled,
                         advance_calls=rc.advance_calls, launches=lc,
                         vertex_ios=rc.stats.vertex_ios, block_ios=rc.stats.block_ios)  # fmt: skip
    return out


def phase_main(engines, extra=(), oracle_counts=None):
    """Phase 5: the launcher's own path, through the kernel.  Runs
    ``engines`` in one launcher call; returns ``(info per engine, the
    oracle's endpoint counts)``.  Every engine's endpoint counts must equal
    the oracle's (from this call, or ``oracle_counts`` at the same size)."""
    import torch

    from repro_torch.launch import walk
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    argv = [*main_argv(engines), *extra]
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    t0 = time.perf_counter()
    results = walk.main(argv)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fused_advance_pair.launches
    hist_launches = bucket_hist_kernel.launches
    infos = []
    # each engine's own time: from its IOStats' creation (engine set-up) to
    # the next engine's, or the end; the rest of the wall is graph generation
    starts = [res.stats.wall_start for _, res in results] + [t_end]
    for (name, res), t_a, t_b in zip(results, starts, starts[1:]):
        s = res.stats
        run_s = t_b - t_a
        infos.append(dict(
            engine=name, argv=" ".join(argv), run_s=run_s, exec_s=s.exec_time,
            exec_share=s.exec_time / run_s, steps=res.steps_sampled,
            steps_per_s=res.steps_sampled / run_s, num_walks=res.num_walks,
            advance_calls=res.advance_calls, block_ios=s.block_ios, vertex_ios=s.vertex_ios,
            ondemand_ios=s.ondemand_ios, peak_resident_bytes=s.peak_resident_bytes,
        ))  # fmt: skip
    calls = sum(res.advance_calls for _, res in results)
    for info in infos:
        info.update(wall_s=t_end - t0, launches=launches, bucket_hist_launches=hist_launches)
        log(f"[main] {json.dumps(info)}")
    for name, res in results:
        if res.endpoint_counts.sum() != res.num_walks:
            raise AssertionError(f"{name}: endpoint counts do not cover every walk")
    if launches == 0 or launches != calls:
        raise AssertionError(f"main path {engines}: {launches} launches for {calls} advances")
    by_name = dict(results)
    if "oracle" in by_name:
        oracle_counts = by_name["oracle"].endpoint_counts
    if oracle_counts is not None:
        for name, res in results:
            if not (res.endpoint_counts == oracle_counts).all():
                raise AssertionError(f"{name}: endpoint counts differ from the oracle's")
    return infos, oracle_counts


def _charges(stats):
    return {k: v for k, v in stats.as_dict().items() if k not in TIMING_FIELDS}


def _serve(bg, sources, config, **kw):
    """One server over ``bg``: submit ``sources``, then flush with the launch
    counts set to 0 just before and read just after.  Returns ``(server,
    answers, info)``."""
    import torch

    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.serve import WalkQueryServer

    with WalkQueryServer(bg, seed=0, **kw) as server:
        for s in sources:
            server.submit(s, config)
        torch.cuda.synchronize()
        fused_advance_pair.launches = 0
        bucket_hist_kernel.launches = 0
        t0 = time.perf_counter()
        answers = server.flush()
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
        launches, hist_launches = fused_advance_pair.launches, bucket_hist_kernel.launches
    s, lat = server.stats, server.latency_summary()
    info = dict(
        queries=len(answers), batches=server.batches_served, flush_s=flush_s,
        queries_per_s=len(answers) / flush_s, s_per_batch=flush_s / server.batches_served,
        p50_ms=lat["p50"] * 1e3, p95_ms=lat["p95"] * 1e3, p99_ms=lat["p99"] * 1e3,
        exec_s=s.exec_time, exec_share=s.exec_time / flush_s,
        advance_calls=server.advance_calls, launches=launches,
        bucket_hist_launches=hist_launches, block_ios=s.block_ios,
        hot_pinned_blocks=s.hot_pinned_blocks, pinned_block_hits=s.pinned_block_hits,
        pinned_bytes_saved=s.pinned_bytes_saved, ondemand_ios=s.ondemand_ios,
        steps=s.steps_sampled, hot_blocks=kw.get("hot_blocks"), device=str(server.device),
    )  # fmt: skip
    if server.device.type == "cuda":
        if launches == 0 or launches != server.advance_calls:
            raise AssertionError(f"server: {launches} launches for {server.advance_calls} advances")
    elif launches != 0:
        raise AssertionError(f"server on the CPU launched the kernel {launches} times")
    for a in answers:
        if int(a.counts.sum()) != a.num_walks:
            raise AssertionError(f"query {a.qid}: {int(a.counts.sum())} of {a.num_walks} walks")
    return server, answers, info


def _same_answers(xs, ys) -> bool:
    import numpy as np

    return len(xs) == len(ys) and all(
        (a.qid, a.source, a.num_walks) == (b.qid, b.source, b.num_walks)
        and np.array_equal(a.vertices, b.vertices) and np.array_equal(a.counts, b.counts)
        for a, b in zip(xs, ys)
    )  # fmt: skip


def phase_serve(dev):
    """Phase 6: the query server on the card (6a the card against the
    CPU, 6b the main path's graph, hot set against LRU and served
    against direct, 6c the launcher)."""
    import zlib

    import numpy as np
    import torch

    from repro_torch.core import erdos_renyi, partition_into_n_blocks
    from repro_torch.engines import BiBlockEngine
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serve import QueryConfig

    config = QueryConfig(**SERVE_CONFIG)
    mix = lambda bg, n: serve_launcher.skewed_sources(bg, n, SERVE_SKEW, np.random.default_rng(7))
    out = {}
    # 6a: the kernel on the card against the plain version on the CPU
    bg = _whole_graph()
    sources = mix(bg, 256)
    runs = {leg: _serve(bg, sources, config, max_batch=64, hot_blocks=2, device=on)
            for leg, on in (("cuda", dev), ("cpu", "cpu"))}  # fmt: skip
    (sc, ac, ic), (st, at, it) = runs["cuda"], runs["cpu"]
    log(f"[serve] 6a cuda {json.dumps(ic)}")
    log(f"[serve] 6a cpu {json.dumps(it)}")
    if not _same_answers(ac, at):
        raise AssertionError("6a: cuda and cpu servers answer differently")
    if _charges(sc.stats) != _charges(st.stats) or sc.advance_calls != st.advance_calls:
        raise AssertionError("6a: cuda and cpu servers charge differently")
    out["6a"] = dict(cuda=ic, cpu=it)

    # 6b: the main path's graph, hot set against pure LRU
    t0 = time.perf_counter()
    g = erdos_renyi(VERTICES, VERTICES * AVG_DEGREE // 2, seed=0)
    bg = partition_into_n_blocks(g, BLOCKS)
    log(f"[serve] 6b graph built in {time.perf_counter() - t0:.1f}s: {bg.describe()}")
    sources = mix(bg, SERVE_QUERIES)
    kw = dict(max_batch=SERVE_BATCH, device=dev)
    hot, hot_ans, hot_info = _serve(bg, sources, config, hot_blocks=2, **kw)
    log(f"[serve] 6b hot-set {json.dumps(hot_info)}")
    lru, lru_ans, lru_info = _serve(bg, sources, config, hot_blocks=0, **kw)
    log(f"[serve] 6b lru {json.dumps(lru_info)}")
    if not _same_answers(hot_ans, lru_ans):
        raise AssertionError("6b: pinning changed an answer")
    if hot.stats.pinned_block_hits == 0 or hot.stats.block_ios >= lru.stats.block_ios:
        raise AssertionError(f"6b: pinning saved no block loads ({hot.stats.block_ios} >= "
                             f"{lru.stats.block_ios}, {hot.stats.pinned_block_hits} hits)")  # fmt: skip
    crcs = []
    V = bg.num_vertices
    for k in range(hot.batches_served):
        batch = hot_ans[k * SERVE_BATCH : (k + 1) * SERVE_BATCH]
        served = np.zeros(V, np.int64)
        for a in batch:
            served[a.vertices] += a.counts
        before = fused_advance_pair.launches
        t1 = time.perf_counter()
        direct = BiBlockEngine(
            bg, config.task(hot.batch_seed(k)), device=dev,
            initial_walks=np.repeat([a.source for a in batch], config.samples),
            async_pipeline=True,
        ).run()  # fmt: skip
        direct_s = time.perf_counter() - t1
        if fused_advance_pair.launches - before != direct.advance_calls:
            raise AssertionError(f"6b direct run {k}: launches != advance calls")
        crc_s = zlib.crc32(np.ascontiguousarray(served).tobytes())
        crc_d = zlib.crc32(np.ascontiguousarray(direct.endpoint_counts).tobytes())
        crcs.append(dict(batch=k, seed=hot.batch_seed(k), walks=direct.num_walks,
                         crc_served=crc_s, crc_direct=crc_d, direct_s=direct_s,
                         direct_advance_calls=direct.advance_calls))  # fmt: skip
        log(f"[serve] 6b batch {json.dumps(crcs[-1])}")
        if crc_s != crc_d:
            raise AssertionError(f"6b: served batch {k} crc {crc_s:#010x} != direct {crc_d:#010x}")
    out["6b"] = dict(config=SERVE_CONFIG, queries=SERVE_QUERIES, max_batch=SERVE_BATCH,
                     skew=SERVE_SKEW, hot=hot_info, lru=lru_info, crc=crcs)  # fmt: skip

    # 6c: the launcher at its defaults
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    t0 = time.perf_counter()
    answers, server = serve_launcher.main([])
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    launches, hist_launches = fused_advance_pair.launches, bucket_hist_kernel.launches
    if launches == 0 or launches != server.advance_calls or len(answers) != 96:
        raise AssertionError(f"6c: {launches} launches for {server.advance_calls} advances, "
                             f"{len(answers)} answers")  # fmt: skip
    if any(int(a.counts.sum()) != a.num_walks for a in answers):
        raise AssertionError("6c: a query's walks were not all retired")
    out["6c"] = dict(run_s=launcher_s, batches=server.batches_served,
                     advance_calls=server.advance_calls, launches=launches,
                     bucket_hist_launches=hist_launches, block_ios=server.stats.block_ios)  # fmt: skip
    log(f"[serve] 6c launcher {json.dumps(out['6c'])}")
    return out


def _lm_logits_gap(got, want, tol: float) -> dict:
    """Whether ``got`` is within ``atol = rtol = tol`` of ``want``
    (``numpy.testing.assert_allclose``'s rule), in float32, with the largest
    gap, the largest logit, and the largest share of its allowance a gap
    takes (``tol_share``: 1 is the limit)."""
    got, want = got.float(), want.float().to(got.device)
    gap = (got - want).abs()
    allowed = tol + tol * want.abs()
    return dict(
        max_abs_err=float(gap.max()), max_abs_logit=float(want.abs().max()),
        tol=tol, tol_share=float((gap / allowed).max()), ok=bool((gap <= allowed).all()),
    )  # fmt: skip


def _device_busy(call, reps: int) -> dict:
    """What ``torch.profiler`` sees on the card over ``reps`` calls of
    ``call()``: device milliseconds and kernels per call (kernels, copies
    and fills), and the five kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    return dict(
        device_ms=sum(r[0] for r in rows) / reps / 1e3, kernels=sum(r[1] for r in rows) / reps,
        top=[[key[:80], us / reps / 1e3] for us, _, key in rows[:5]],
    )  # fmt: skip


def _lm_pad(got, tgt):
    """A prefill cache copied into the fixed decode buffer (zero beyond)."""
    tgt[tuple(slice(0, n) for n in got.shape)] = got
    return tgt


def phase_lm(dev):
    """Phase 7: the LM serving path at llama3.2-1b's published widths (7a
    equivalence in float32, 7b serving in bfloat16)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.models import model_caches, model_decode, model_forward, model_init
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    t_phase = time.perf_counter()

    # 7a: decode against forward, float32, all layers
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    log(f"[lm] 7a {cfg.name} float32 {cfg.n_layers} layers; float32 matmuls in full precision: "
        f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")  # fmt: skip
    params = model_init(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (LM_EQ_BATCH, LM_EQ_SEQ)).astype(np.int32), device=dev
    )
    want = model_forward(params, {"tokens": toks}, cfg)[0][:, -1]
    _, caches = make_prefill_step(cfg)(params, {"tokens": toks[:, :-1]})
    caches = tree_map(_lm_pad, caches, model_caches(cfg, LM_EQ_BATCH, LM_EQ_SEQ + 4, device=dev))
    got, _ = model_decode(params, toks[:, -1:], caches, LM_EQ_SEQ - 1, cfg)
    out["7a_decode_vs_forward"] = _lm_logits_gap(got, want, LM_EQUIV_TOL)
    log(f"[lm] 7a decode vs forward (batch {LM_EQ_BATCH}, {LM_EQ_SEQ} tokens): "
        f"{json.dumps(out['7a_decode_vs_forward'])}")  # fmt: skip
    del caches, got, want

    # the same weights cut to LM_CPU_LAYERS layers: the card against the CPU
    n = LM_CPU_LAYERS
    cut = dataclasses.replace(cfg, n_layers=n, segments=((("attn+mlp",), n),))
    cut_params = dict(params, segments=[tree_map(lambda a: a[:n], params["segments"][0])])
    card = model_forward(cut_params, {"tokens": toks}, cut)[0]
    t0 = time.perf_counter()
    host = model_forward(tree_map(lambda a: a.cpu(), cut_params), {"tokens": toks.cpu()}, cut)[0]
    out["7a_card_vs_cpu"] = dict(_lm_logits_gap(card, host, LM_CPU_TOL), layers=LM_CPU_LAYERS,
                                 cpu_s=time.perf_counter() - t0)  # fmt: skip
    log(f"[lm] 7a card vs CPU ({LM_CPU_LAYERS} layers, same weights, all {LM_EQ_SEQ} positions): "
        f"{json.dumps(out['7a_card_vs_cpu'])}")  # fmt: skip
    del params, cut_params, card, host
    torch.cuda.empty_cache()
    for key in ("7a_decode_vs_forward", "7a_card_vs_cpu"):
        if not out[key]["ok"]:
            raise AssertionError(f"phase 7a: {key} outside its tolerance: {out[key]}")

    # 7b: serving in the config's own dtype
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = model_init(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[lm] 7b {cfg.name} {cfg.dtype} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"GQA {cfg.n_heads}/{cfg.n_kv_heads} vocab {cfg.vocab_size}: {n_params:,} parameters, "
        f"{weight_bytes:,} bytes, made on the card in {init_s:.2f}s")  # fmt: skip
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32), device=dev
    )
    prefill = make_prefill_step(cfg)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    prefill_ms = []
    for _ in range(2):  # the first call also sets up cuBLAS
        start, stop = ev(), ev()
        torch.cuda.synchronize()
        start.record()
        logits, pcaches = prefill(params, {"tokens": prompts})
        stop.record()
        torch.cuda.synchronize()
        prefill_ms.append(start.elapsed_time(stop))
    max_len = LM_PROMPT + LM_NEW
    caches = tree_map(_lm_pad, pcaches, model_caches(cfg, LM_BATCH, max_len, device=dev))
    del pcaches
    prefill_finite = bool(torch.isfinite(logits).all())
    decode = make_decode_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    seq, marks = [tok], []
    t0 = time.perf_counter()
    for i in range(LM_NEW - 1):
        start, stop = ev(), ev()
        start.record()
        step = {"token": tok, "cache_len": LM_PROMPT + i}
        tok, step_logits, caches = decode(params, step, caches)
        stop.record()
        marks.append((start, stop))
        tok = tok[:, None]
        seq.append(tok)
    torch.cuda.synchronize()
    decode_wall_s = time.perf_counter() - t0
    step_ms = sorted(a.elapsed_time(b) for a, b in marks)
    seqs = torch.cat(seq, dim=1).cpu()
    peak = torch.cuda.max_memory_allocated()
    # the card's busy time: one more prefill, and decode steps at the
    # cache's last free position (the profiler slows the host, not the card)
    busy = dict(
        prefill=_device_busy(lambda: prefill(params, {"tokens": prompts}), 1),
        decode=_device_busy(
            lambda: decode(params, {"token": tok, "cache_len": max_len - 1}, caches), 5
        ),
    )  # fmt: skip
    launches, hist_launches = fused_advance_pair.launches, bucket_hist_kernel.launches

    tokens = LM_BATCH * LM_PROMPT
    flops = 2 * n_params * tokens
    # the cache a step reads: every layer's K and V at the positions filled
    # so far (the mean over the steps)
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize
    kv_bytes = LM_BATCH * kv_row * (LM_PROMPT + (LM_NEW - 1) / 2 + 1)
    median = step_ms[len(step_ms) // 2]
    lm = dict(
        arch=cfg.name, dtype=str(cfg.dtype), layers=cfg.n_layers, params=n_params,
        weight_bytes=weight_bytes, batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW,
        cache_len=max_len, init_s=init_s,
        prefill_first_ms=prefill_ms[0], prefill_ms=prefill_ms[1],
        prefill_tokens_per_s=tokens / (prefill_ms[1] / 1e3),
        prefill_flops=flops, prefill_bound_ms=flops / BF16_FLOPS_PER_S * 1e3,
        decode_steps=len(step_ms), decode_ms_median=median, decode_ms_min=step_ms[0],
        decode_ms_max=step_ms[-1], decode_tokens_per_s=LM_BATCH / (median / 1e3),
        decode_wall_s=decode_wall_s, decode_kv_bytes_mean=kv_bytes,
        decode_bound_ms=(weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
        max_memory_allocated=peak, launches=launches, bucket_hist_launches=hist_launches,
        seq0=seqs[0].tolist(), device_busy=busy,
        prefill_idle_share=1 - busy["prefill"]["device_ms"] / prefill_ms[1],
        decode_idle_share=1 - busy["decode"]["device_ms"] / median,
    )  # fmt: skip
    out["7b"] = lm
    log(f"[lm] 7b prefill {LM_BATCH} x {LM_PROMPT} tokens: {prefill_ms[1]:.3f} ms "
        f"(first call {prefill_ms[0]:.3f} ms), {lm['prefill_tokens_per_s']:,.0f} tokens/s; "
        f"bound {lm['prefill_bound_ms']:.3f} ms = 2 x {n_params:,} params x {tokens} tokens "
        f"/ {BF16_FLOPS_PER_S:.3g} FLOP/s (bf16 dense peak; attention's own FLOPs left out)")  # fmt: skip
    log(f"[lm] 7b decode {len(step_ms)} steps of {LM_BATCH} tokens (CUDA events per step): "
        f"median {median:.3f} ms (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}), "
        f"{lm['decode_tokens_per_s']:,.1f} tokens/s; {decode_wall_s:.3f} s on the host clock; "
        f"bound {lm['decode_bound_ms']:.4f} ms = ({weight_bytes:,} weight bytes + "
        f"{kv_bytes:,.0f} KV cache bytes, the mean step's) / {HBM_BYTES_PER_S:.3g} B/s")  # fmt: skip
    for name in ("prefill", "decode"):
        b = busy[name]
        log(f"[lm] 7b {name} on the card (torch.profiler): {b['device_ms']:.3f} ms busy and "
            f"{b['kernels']:.0f} kernels per call, idle share {lm[name + '_idle_share']:.3f} "
            f"of the timed call; top {json.dumps(b['top'])}")  # fmt: skip
    log(f"[lm] 7b torch.cuda.max_memory_allocated over prefill + decode: {peak:,} bytes")
    log(f"[lm] 7b seq 0: {lm['seq0']}")
    log(f"[lm] phase 7: {time.perf_counter() - t_phase:.1f}s; kernel launches: pair_advance "
        f"{launches}, bucket_hist {hist_launches}")  # fmt: skip
    if not (prefill_finite and bool(torch.isfinite(step_logits).all())):
        raise AssertionError("phase 7b: logits are not finite")
    if not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError("phase 7b: a token outside the vocabulary")
    if seqs.shape != (LM_BATCH, LM_NEW):
        raise AssertionError(f"phase 7b: {tuple(seqs.shape)} tokens")
    return out


def _train_batch(cfg, n: int, seq: int, dev):
    """``n`` sequences of ``seq`` tokens from a seeded generator on ``dev``;
    the labels are the next tokens, IGNORE on the last position."""
    import torch

    from repro_torch.train.loss import IGNORE

    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (n, seq), generator=gen, device=dev)
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], IGNORE)], dim=1)
    return {"tokens": toks, "labels": labels}


def _flash_backward_gap(dev) -> dict:
    """8a: the flash backward (``chunked_attention``'s autograd.Function)
    against autograd through the plain chunked forward, bf16 on the card."""
    import torch

    from repro_torch.models import attention

    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, KVH, D = FLASH_B, FLASH_S, FLASH_H, FLASH_KVH, FLASH_D
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v, dout = draw(B, S, H, D), draw(B, S, KVH, D), draw(B, S, KVH, D), draw(B, S, H, D)

    def plain(q, k, v):
        qp, kp, vp, grid = attention._pad(q, k, v, True, None, 0, 512, 1024)
        return attention._flash_forward(qp, kp, vp, grid)[0][:, :S]

    grads = []
    for fn in (attention.chunked_attention, plain):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ts), ts, dout))
    out = {}
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        gap = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        out[name] = dict(max_abs_err=gap, max_abs_grad=top, rel=gap / top,
                         ok=bool(gap <= FLASH_BF16_TOL * top))  # fmt: skip
    return dict(shape=dict(B=B, S=S, H=H, KVH=KVH, D=D, q_chunk=512, kv_chunk=1024),
                tol=FLASH_BF16_TOL, **out)  # fmt: skip


def phase_lm_train(dev):
    """Phase 8: the LM train step (8a the card against the CPU and the flash
    backward; 8b llama3.2-1b at its published widths)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.models import model_init
    from repro_torch.models.common import tree_leaves, tree_leaves_with_path, tree_map
    from repro_torch.optim import OptConfig, adamw_init, adamw_update
    from repro_torch.train import make_loss_fn, make_train_step
    from repro_torch.train.step import _value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    out = {}
    t_phase = time.perf_counter()

    # 8a: the reduced config, float32, card against CPU
    cfg = reduced_config(LM_ARCH)
    opt = OptConfig(warmup_steps=1)
    params = model_init(0, cfg, device=dev)
    batch = _train_batch(cfg, 2, 64, dev)
    host_params = tree_map(lambda a: a.cpu(), params)
    host_batch = {k: v.cpu() for k, v in batch.items()}
    loss_fn = make_loss_fn(cfg)
    (loss, _), grads = _value_and_grad(loss_fn, params, batch)
    (host_loss, _), host_grads = _value_and_grad(loss_fn, host_params, host_batch)
    checks = {"loss": _lm_logits_gap(loss, host_loss, TRAIN_CPU_TOL)}
    host_flat = dict(tree_leaves_with_path(host_grads))
    for path, g in tree_leaves_with_path(grads):
        checks["grad" + path] = _lm_logits_gap(g, host_flat[path], TRAIN_CPU_TOL)
    step = make_train_step(cfg, opt)
    params, _, _ = step(params, adamw_init(params), batch)
    host_params, _, _ = step(host_params, adamw_init(host_params), host_batch)
    host_flat = dict(tree_leaves_with_path(host_params))
    for path, p in tree_leaves_with_path(params):
        checks["step" + path] = _lm_logits_gap(p, host_flat[path], TRAIN_CPU_TOL)
    worst = max(checks, key=lambda key: checks[key]["tol_share"])
    out["8a_card_vs_cpu"] = dict(
        arch=cfg.name, leaves=len(tree_leaves(grads)), checks=len(checks), worst=worst,
        worst_gap=checks[worst], ok=all(c["ok"] for c in checks.values()),
        failed=[key for key, c in checks.items() if not c["ok"]],
    )  # fmt: skip
    log(f"[lm-train] 8a {cfg.name} float32, TF32 off, card vs CPU: loss, "
        f"{len(tree_leaves(grads))} gradients and one train step's parameters; "
        f"{json.dumps(out['8a_card_vs_cpu'])}")  # fmt: skip
    out["8a_flash_backward"] = _flash_backward_gap(dev)
    log(f"[lm-train] 8a flash backward vs autograd through the plain chunked forward, bf16: "
        f"{json.dumps(out['8a_flash_backward'])}")  # fmt: skip
    del params, host_params, grads, host_grads
    if not out["8a_card_vs_cpu"]["ok"]:
        raise AssertionError(f"phase 8a: outside {TRAIN_CPU_TOL}: {out['8a_card_vs_cpu']}")
    for name in ("dq", "dk", "dv"):
        if not out["8a_flash_backward"][name]["ok"]:
            raise AssertionError(f"phase 8a: flash {name}: {out['8a_flash_backward'][name]}")

    # 8b: llama3.2-1b at its published widths, in its own dtype, remat
    # policy and microbatches
    cfg = get_config(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    params = model_init(0, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    state = adamw_init(params)
    step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches)
    log(f"[lm-train] 8b {cfg.name} {cfg.dtype} {cfg.n_layers} layers, {n_params:,} parameters; "
        f"remat {cfg.remat_policy!r}, {cfg.train_microbatches} microbatches, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens; {dataclasses.asdict(opt)}")  # fmt: skip
    ev = lambda: torch.cuda.Event(enable_timing=True)
    step_ms, host_ms, metrics = [], [], []
    for _ in range(1 + TRAIN_STEPS):  # the first is the warm-up
        start, stop = ev(), ev()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, batch)
        stop.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(start.elapsed_time(stop))
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    launches, hist_launches = fused_advance_pair.launches, bucket_hist_kernel.launches
    busy = _device_busy(lambda: step(params, state, batch), 1)
    # where a step goes: one microbatch's forward, recompute and backward,
    # then one optimiser update of every parameter from float32 gradients
    half = {k: v[: TRAIN_BATCH // cfg.train_microbatches] for k, v in batch.items()}
    grads_ms = cuda_ms(lambda: _value_and_grad(make_loss_fn(cfg), params, half), 2)
    grads = tree_map(lambda p: p.float(), _value_and_grad(make_loss_fn(cfg), params, half)[1])
    adamw_ms = cuda_ms(lambda: adamw_update(grads, state, params, opt), 2)
    del grads
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    losses = [m["loss"] for m in metrics]
    lm = dict(
        arch=cfg.name, dtype=str(cfg.dtype), layers=cfg.n_layers, params=n_params,
        remat_policy=cfg.remat_policy, microbatches=cfg.train_microbatches, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, opt=dataclasses.asdict(opt), warmup_ms=step_ms[0], step_ms=step_ms[1:],
        host_ms=host_ms, step_ms_median=median, tokens_per_s=tokens / (median / 1e3),
        flops=flops, bound_ms=flops / BF16_FLOPS_PER_S * 1e3, max_memory_allocated=peak,
        device_busy=busy, idle_share=1 - busy["device_ms"] / median, losses=losses,
        microbatch_grads_ms=grads_ms, adamw_update_ms=adamw_ms,
        grad_norm=[m["grad_norm"] for m in metrics], lr=[m["lr"] for m in metrics],
        tokens=metrics[-1]["tokens"], launches=launches, bucket_hist_launches=hist_launches,
    )  # fmt: skip
    out["8b"] = lm
    log(f"[lm-train] 8b {TRAIN_STEPS} steps of {tokens} tokens (CUDA events, after a warm-up "
        f"step of {step_ms[0]:.3f} ms): median {median:.3f} ms (min {timed[0]:.3f}, max "
        f"{timed[-1]:.3f}), {lm['tokens_per_s']:,.0f} tokens/s; host clock "
        f"{json.dumps([round(x, 3) for x in host_ms])} ms")  # fmt: skip
    log(f"[lm-train] 8b bound {lm['bound_ms']:.3f} ms = 6 x {n_params:,} params x {tokens} "
        f"tokens / {BF16_FLOPS_PER_S:.3g} FLOP/s (bf16 dense peak; attention's own FLOPs and "
        f"remat's recompute left out); {median / lm['bound_ms']:.1f}x over it")  # fmt: skip
    log(f"[lm-train] 8b torch.cuda.max_memory_allocated: {peak:,} bytes")
    log(f"[lm-train] 8b on the card (torch.profiler, one step): {busy['device_ms']:.3f} ms busy, "
        f"{busy['kernels']:.0f} kernels per step, idle share {lm['idle_share']:.3f}; "
        f"top {json.dumps(busy['top'])}")  # fmt: skip
    log(f"[lm-train] 8b split (CUDA events, mean of 2): one microbatch's forward, recompute and "
        f"backward {grads_ms:.3f} ms (x {cfg.train_microbatches}), one adamw_update "
        f"{adamw_ms:.3f} ms; the rest of the median step (gradient sums, dispatch) "
        f"{median - cfg.train_microbatches * grads_ms - adamw_ms:.3f} ms")  # fmt: skip
    log(f"[lm-train] 8b loss {json.dumps(losses)}; grad_norm {json.dumps(lm['grad_norm'])}; "
        f"lr {json.dumps(lm['lr'])}; tokens {lm['tokens']:.0f}")  # fmt: skip
    log(f"[lm-train] card: {card_line()}")
    log(f"[lm-train] phase 8: {time.perf_counter() - t_phase:.1f}s; kernel launches: "
        f"pair_advance {launches}, bucket_hist {hist_launches}")  # fmt: skip
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 8b: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 8b: the loss did not fall: {losses}")
    return out


def _bits(t):
    """``t`` viewed as integers of its element's width, for bitwise equality."""
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same_bits(got: dict, want: dict) -> list:
    """The keys of two ``{key: tensor}`` maps whose dtype, shape or bits
    differ (or that one map lacks)."""
    bad = sorted(set(got) ^ set(want))
    for key in sorted(set(got) & set(want)):
        g, w = got[key], want[key].to(got[key].device)
        if g.dtype != w.dtype or g.shape != w.shape or not bool((_bits(g) == _bits(w)).all()):
            bad.append(key)
    return bad


class _Tee:
    """Standard output that is also kept, to read what a launcher printed."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_harness(dev):
    """Phase 9: the LM training harness (9a the reduced llama's crash and
    resume on the card; 9b the train launcher at llama3.2-1b's published
    widths: walks -> train -> checkpoint -> resume)."""
    import contextlib
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import BiBlockEngine, erdos_renyi, partition_into_n_blocks, rwnv_task
    from repro_torch.data import WalkCorpus
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_init
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWState, OptConfig, adamw_init
    from repro_torch.runtime import FailureInjector, ResilientTrainer, fault
    from repro_torch.train import make_train_step

    torch.cuda.empty_cache()
    out = {}
    t_phase = time.perf_counter()
    if HARNESS_DIR.exists():
        shutil.rmtree(HARNESS_DIR)
    HARNESS_DIR.mkdir()
    try:
        # 9a: crash -> resume of the reduced llama on the card
        cfg = reduced_config(LM_ARCH)
        walks = np.random.default_rng(0).integers(0, 200, HARNESS_WALKS).astype(np.int32)
        corpus = WalkCorpus.from_walks(walks, 200)
        batches = lambda cursor=0: corpus.batches(4, 16, cursor=cursor, epochs=None, seed=7)

        def trainer(name, fail_at=()):
            params = model_init(0, cfg, device=dev)  # each run its own copy
            step = make_train_step(cfg, OptConfig(lr=1e-3, total_steps=100))
            return params, adamw_init(params), ResilientTrainer(
                train_step=step, ckpt_dir=HARNESS_DIR / name, ckpt_every=4,
                injector=FailureInjector(fail_at),
            )  # fmt: skip

        p0, o0, tr = trainer("uninterrupted")
        p_ref, o_ref, _ = tr.run(p0, o0, batches(), num_steps=HARNESS_STEPS)
        p1, o1, tr2 = trainer("crashed", fail_at=(HARNESS_CRASH,))
        crashed = None
        try:
            tr2.run(p1, o1, batches(), num_steps=HARNESS_STEPS)
        except RuntimeError as e:  # the injected crash, and nothing else
            if "injected failure" not in str(e):
                raise
            crashed = str(e)
        if crashed is None:
            raise AssertionError("phase 9a: the injected failure did not fire")
        p_r, o_r, start, cursor = tr2.resume(p1, o1)
        tr2.injector = None
        p_done, o_done, _ = tr2.run(p_r, o_r, batches(cursor), num_steps=HARNESS_STEPS,
                                    start_step=start)  # fmt: skip
        flat_ref, flat_done = ckpt_mod._flatten(p_ref), ckpt_mod._flatten(p_done)
        gap = max(float((flat_done[k].float() - flat_ref[k].float()).abs().max()) for k in flat_ref)
        # the uninterrupted run's last checkpoint, restored into a CPU tree
        on_cpu = lambda t: tree_map(lambda a: torch.zeros_like(a, device="cpu"), t)
        cpu_like = {"params": on_cpu(p_ref), "opt_state": AdamWState(
            o_ref.step.cpu(), on_cpu(o_ref.master), on_cpu(o_ref.m), on_cpu(o_ref.v))}
        got, extra = fault.restore_checkpoint(HARNESS_DIR / "uninterrupted", cpu_like)
        got = ckpt_mod._flatten(got)
        want = ckpt_mod._flatten({"params": p_ref, "opt_state": o_ref})
        out["9a"] = dict(
            arch=cfg.name, dtype=str(cfg.dtype), steps=HARNESS_STEPS, crash=crashed,
            resumed_at=start, cursor=cursor, max_param_gap=gap, tol=HARNESS_TOL,
            cpu_restore=dict(step=extra["step"], leaves=len(want),
                             on_cpu=all(t.device.type == "cpu" for t in got.values()),
                             not_bitwise=_same_bits(got, want)),
        )  # fmt: skip
        log(f"[lm-harness] 9a {cfg.name} {cfg.dtype} on the card: {HARNESS_STEPS} steps "
            f"uninterrupted, then a crash at step {HARNESS_CRASH} ({crashed!r}), resumed at "
            f"step {start} (cursor {cursor}): largest parameter gap {gap:.3g} (atol "
            f"{HARNESS_TOL}); step {extra['step']}'s checkpoint restored into a CPU tree: "
            f"{len(want)} leaves, bitwise except "
            f"{out['9a']['cpu_restore']['not_bitwise']}")  # fmt: skip
        del p0, o0, p_ref, o_ref, p1, o1, p_r, o_r, p_done, o_done, got, want, flat_ref, flat_done
        if start not in (4, 8) or not gap <= HARNESS_TOL:
            raise AssertionError(f"phase 9a: resumed at {start}, gap {gap} > {HARNESS_TOL}")
        if out["9a"]["cpu_restore"]["not_bitwise"] or not out["9a"]["cpu_restore"]["on_cpu"]:
            raise AssertionError(f"phase 9a: CPU restore: {out['9a']['cpu_restore']}")

        # 9b: the launcher at full width
        full = get_config(LM_ARCH)
        state_bytes = full.param_count() * (full.dtype.itemsize + 3 * 4)
        disk = shutil.disk_usage(HARNESS_DIR)
        log(f"[lm-harness] 9b disk at {HARNESS_DIR}: {disk.free:,} bytes free of {disk.total:,}; "
            f"two checkpoints need {2 * state_bytes:,} ({full.param_count():,} parameters x "
            f"({full.dtype.itemsize} + 3 x 4) bytes each)")  # fmt: skip
        if disk.free < 2 * state_bytes * 1.05:
            raise AssertionError(f"phase 9b: {disk.free:,} bytes free at {HARNESS_DIR} cannot "
                                 f"hold two checkpoints of {state_bytes:,} bytes")  # fmt: skip
        ckpt_dir = HARNESS_DIR / "launcher"
        argv = [*HARNESS_ARGV, "--ckpt-dir", str(ckpt_dir), "--device", dev.type]
        args = launch_train.parse_args(argv)

        # the launcher's corpus (its graph, blocks and task) through the
        # kernel and through the plain advance on the CPU: equal, bit for bit
        def corpus_run(on):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = erdos_renyi(args.graph_vertices, args.graph_vertices * 8, seed=0)
            res = BiBlockEngine(
                partition_into_n_blocks(g, 6), rwnv_task(walks_per_vertex=2, length=32),
                record_walks=True, device=on,
            ).run()  # fmt: skip
            corpus = WalkCorpus.from_walks(res.corpus, g.num_vertices)
            torch.cuda.synchronize()
            return corpus, res.corpus, time.perf_counter() - t0

        before = fused_advance_pair.launches
        corpus, walks_cuda, corpus_s = corpus_run(dev)
        compare_launches = fused_advance_pair.launches - before
        _, walks_plain, plain_s = corpus_run("cpu")
        corpus_equal = walks_cuda.shape == walks_plain.shape and bool((walks_cuda == walks_plain).all())
        log(f"[lm-harness] 9b the launcher's corpus ({args.graph_vertices:,} vertices, 6 blocks, "
            f"2 walks of 32 steps per vertex): {walks_cuda.shape[0]:,} walks; the kernel "
            f"{corpus_s:.3f} s ({compare_launches} launches), the plain advance on the CPU "
            f"{plain_s:.3f} s; bitwise equal: {corpus_equal}")  # fmt: skip
        del walks_plain
        if not corpus_equal:
            raise AssertionError("phase 9b: the kernel's corpus differs from the plain advance's")

        def launch(steps):
            """One launcher run, as a user calls it, with its counts and the
            host clock at each step's metrics."""
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fused_advance_pair.launches = 0
            bucket_hist_kernel.launches = 0
            seen = []
            tee = _Tee(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                params, opt, info = launch_train.main(
                    [*argv, "--steps", str(steps)],
                    on_metrics=lambda s, m: seen.append((s, m, time.perf_counter())),
                )  # fmt: skip
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            run = dict(
                steps=steps, wall_s=t_end - t0, launches=fused_advance_pair.launches,
                bucket_hist_launches=bucket_hist_kernel.launches,
                start_step=seen[0][0], end_step=info["step"],
                step_s=[m["step_time"] for _, m, _ in seen], losses=[m["loss"] for _, m, _ in seen],
                # the final checkpoint's save_async + wait, from the last
                # step's metrics to the launcher's return
                final_save_s=t_end - seen[-1][2], stragglers=len(info["stragglers"]),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                printed="".join(tee.lines).splitlines(),
            )  # fmt: skip
            return run, params, opt

        first, params, opt = launch(HARNESS_FIRST)
        # the in-place step left the state holding step 4's values: the
        # committed checkpoint must be them, bit for bit
        saved = ckpt_dir / f"step_{HARNESS_FIRST:09d}"
        state = {"params": params, "opt_state": opt}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, extra = fault.restore_checkpoint(ckpt_dir, state, step=HARNESS_FIRST)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        flat = ckpt_mod._flatten(state)
        first.update(saved_extra=extra, not_bitwise=_same_bits(ckpt_mod._flatten(got), flat),
                     leaves=len(json.loads((saved / "manifest.json").read_text())["arrays"]),
                     checkpoint_bytes=sum(p.stat().st_size for p in saved.rglob("*")))  # fmt: skip
        del got
        # save_async's snapshot (a host copy of every leaf) of the same state
        t0 = time.perf_counter()
        snap = {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}
        snapshot_s = time.perf_counter() - t0
        del snap, flat, state
        # the uninterrupted continuation: steps 4 and 5 from this state on
        # the 5th and 6th batches of a stream that starts at cursor 0
        stream = corpus.batches(args.batch, args.seq, seed=1)
        for _ in range(HARNESS_FIRST):
            batch = next(stream)
        stream_cursor = batch["cursor"]
        step_fn = make_train_step(full, OptConfig(lr=1e-3, warmup_steps=10,
                                                  total_steps=HARNESS_SECOND),
                                  microbatches=args.microbatches)  # fmt: skip
        continued = []
        for _ in range(HARNESS_FIRST, HARNESS_SECOND):
            batch = next(stream)
            batch.pop("cursor"), batch.pop("epoch", None)
            params, opt, m = step_fn(params, opt, batch)
            continued.append(float(m["loss"].item()))
        del params, opt, m, batch, stream, corpus, step_fn
        second, params, opt = launch(HARNESS_SECOND)
        del params, opt
        torch.cuda.empty_cache()
        loss_gap = [abs(a - b) for a, b in zip(second["losses"], continued)]
        median = lambda xs: sorted(xs)[len(xs) // 2]
        gb = first["checkpoint_bytes"] / 1e9
        out["9b"] = dict(
            argv=argv, state_bytes=state_bytes, runs=[first, second],
            corpus=dict(walks=int(walks_cuda.shape[0]), kernel_s=corpus_s, plain_s=plain_s,
                        launches=compare_launches, bitwise_equal=corpus_equal),
            step_ms_median=median(first["step_s"][1:]) * 1e3,
            resumed_step_ms=[x * 1e3 for x in second["step_s"]],
            snapshot_s=snapshot_s, snapshot_gb_s=gb / snapshot_s,
            final_save_s=[r["final_save_s"] for r in (first, second)],
            final_save_gb_s=[gb / r["final_save_s"] for r in (first, second)],
            restore_s=restore_s, restore_gb_s=gb / restore_s,
            continued_losses=continued, loss_gap=loss_gap, loss_rtol=HARNESS_LOSS_RTOL,
            stream_cursor=stream_cursor,
            launches=first["launches"] + second["launches"],
            bucket_hist_launches=first["bucket_hist_launches"] + second["bucket_hist_launches"],
        )  # fmt: skip
        lm = out["9b"]
        log(f"[lm-harness] 9b launcher runs: {first['launches']} pair_advance launches (first "
            f"run), {second['launches']} (second), each generating its corpus on the card")
        log(f"[lm-harness] 9b step median over steps 1-{HARNESS_FIRST - 1} (host clock, the "
            f"trainer's step_time): {lm['step_ms_median']:.3f} ms; all "
            f"{json.dumps([round(x * 1e3, 3) for x in first['step_s']])} ms; resumed steps "
            f"{json.dumps([round(x, 3) for x in lm['resumed_step_ms']])} ms")  # fmt: skip
        log(f"[lm-harness] 9b checkpoint: {first['checkpoint_bytes']:,} bytes in {first['leaves']} "
            f"files; snapshot (host copy of every leaf) {snapshot_s:.3f} s "
            f"({lm['snapshot_gb_s']:.3f} GB/s); final save (save_async to wait) at steps "
            f"{HARNESS_FIRST} and {HARNESS_SECOND}: "
            f"{json.dumps([round(x, 3) for x in lm['final_save_s']])} s, "
            f"{json.dumps([round(x, 3) for x in lm['final_save_gb_s']])} GB/s; restore "
            f"{restore_s:.3f} s ({lm['restore_gb_s']:.3f} GB/s)")  # fmt: skip
        log(f"[lm-harness] 9b torch.cuda.max_memory_allocated: first run "
            f"{first['max_memory_allocated']:,} bytes, second {second['max_memory_allocated']:,}")
        log(f"[lm-harness] 9b losses: first run {json.dumps(first['losses'])}, resumed at step "
            f"{second['start_step']} (saved {first['saved_extra']}, the stream's cursor after "
            f"{HARNESS_FIRST} batches {stream_cursor}) {json.dumps(second['losses'])}, the "
            f"uninterrupted continuation {json.dumps(continued)}: gaps {json.dumps(loss_gap)} "
            f"(rtol {HARNESS_LOSS_RTOL}); step {HARNESS_FIRST}'s checkpoint against the "
            f"in-memory state: {first['leaves']} leaves, bitwise except {first['not_bitwise']}")
        log(f"[lm-harness] card: {card_line()}")
        log(f"[lm-harness] phase 9: {time.perf_counter() - t_phase:.1f}s; kernel launches: "
            f"pair_advance {lm['launches']}, bucket_hist {lm['bucket_hist_launches']}")  # fmt: skip
        losses = first["losses"] + second["losses"] + continued
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 9b: a loss is not finite: {losses}")
        if f"resumed at step {HARNESS_FIRST}" not in second["printed"]:
            raise AssertionError(f"phase 9b: the second run did not resume: {second['printed']}")
        if (second["start_step"], stream_cursor) != (HARNESS_FIRST, first["saved_extra"]["cursor"]):
            raise AssertionError(f"phase 9b: resumed at {second['start_step']}, saved "
                                 f"{first['saved_extra']}, stream cursor {stream_cursor}")
        if (first["end_step"], second["end_step"]) != (HARNESS_FIRST, HARNESS_SECOND):
            raise AssertionError(f"phase 9b: ended at {first['end_step']}, {second['end_step']}")
        if first["not_bitwise"]:
            raise AssertionError(f"phase 9b: checkpoint differs: {first['not_bitwise']}")
        if len(loss_gap) != HARNESS_SECOND - HARNESS_FIRST or not all(
            gap <= HARNESS_LOSS_RTOL * abs(c) for gap, c in zip(loss_gap, continued)
        ):
            raise AssertionError(f"phase 9b: resumed losses {second['losses']} against the "
                                 f"uninterrupted continuation {continued}")  # fmt: skip
        if lm["launches"] == 0:
            raise AssertionError("phase 9b: the launcher launched no pair_advance kernel")
    finally:
        shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    return out


def _dist_case(vertices: int, blocks: int):
    """The main path's graph (the launcher's generator and seed) at
    ``vertices`` in ``blocks`` blocks, and its task."""
    from repro_torch.core import erdos_renyi, partition_into_n_blocks, rwnv_task

    g = erdos_renyi(vertices, vertices * AVG_DEGREE // 2, seed=0)
    task = rwnv_task(p=MAIN_P, q=MAIN_Q, walks_per_vertex=1, length=MAIN_LEN, seed=0)
    return partition_into_n_blocks(g, blocks), task


def _dist_run(bg, task, mesh, dev, engine_cls=None):
    """One distributed engine run, the launch counts set to 0 just before
    and read just after.  Returns ``(result, info, engine)``."""
    import torch

    from repro_torch.core.distributed import DistributedWalkEngine
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    t0 = time.perf_counter()
    eng = (engine_cls or DistributedWalkEngine)(bg, task, mesh, device=dev)
    res = eng.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    exec_s = res["stats"].exec_time
    info = dict(
        backend=eng.backend, device=str(eng.device), rank=eng.rank, block=eng.block,
        walks=len(res["cur"]), sweeps=res["sweeps"], rounds=eng.rounds,
        advance_calls=eng.advance_calls,
        launches=fused_advance_pair.launches, bucket_hist_launches=bucket_hist_kernel.launches,
        engine_s=engine_s, exec_s=exec_s, exec_share=exec_s / engine_s,
        collective_s=eng.collective_time, walk_ios=res["stats"].walk_ios,
        steps_per_s=float(res["hop"].sum()) / engine_s,
    )  # fmt: skip
    return res, info, eng


def _same_walks(a: dict, b: dict) -> list:
    """The keys of the global walk arrays on which two runs differ."""
    return [k for k in ("prev", "cur", "hop", "alive") if not (a[k] == b[k]).all()]


def phase_distributed(dev, oracle_counts, src: str):
    """Phase 10: the distributed half-ring engine on the card (10a, NCCL,
    one rank) and across DIST_RANKS gloo ranks sharing it (10b)."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.distributed import DistributedWalkEngine
    from repro_torch.engines.step import remap_search_iters
    from repro_torch.kernels.pair_advance import fused_advance_pair, pair_advance_ref

    class Captured(DistributedWalkEngine):
        """Keeps the first advance's inputs."""

        def _advance_inputs(self, pair, recv):
            got = super()._advance_inputs(pair, recv)
            if not hasattr(self, "captured"):
                self.captured = got
            return got

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        tmp = Path(tmp)
        dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdzv'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            t0 = time.perf_counter()
            bg, task = _dist_case(VERTICES, 1)
            log(f"[dist] 10a graph built in {time.perf_counter() - t0:.1f}s: "
                f"{VERTICES:,} vertices in 1 block")  # fmt: skip
            res_c, info_c, eng_c = _dist_run(bg, task, mesh, dev, Captured)
            log(f"[dist] 10a {json.dumps(info_c)}")
            if res_c["alive"].any():
                raise AssertionError(f"phase 10a: {int(res_c['alive'].sum())} walks left alive")
            counts = np.bincount(res_c["cur"], minlength=VERTICES)
            if not (counts == oracle_counts).all():
                raise AssertionError("phase 10a: endpoint counts differ from phase 5's oracle")
            if info_c["launches"] == 0 or info_c["launches"] != info_c["advance_calls"]:
                raise AssertionError(f"phase 10a: {info_c['launches']} launches for "
                                     f"{info_c['advance_calls']} advances")  # fmt: skip
            # the kernel against its plain version on the engine's own
            # inputs (these launches are not counted)
            pair_args, lanes, rmask = eng_c.captured
            s = eng_c.settings
            args = (*pair_args, *lanes, s.key, s.length, s.decay, s.p, s.q)
            kwargs = dict(order=s.order, k_max=s.k_max, n_iters=s.n_iters, record=False,
                          v_iters=remap_search_iters(bg.max_block_verts),
                          has_alias=s.has_alias, max_len=s.length)  # fmt: skip
            saved = fused_advance_pair.launches
            got = fused_advance_pair(*args, **kwargs)
            want = pair_advance_ref(*args, **kwargs)
            err = max_abs_err(want, got)
            kernel_ms = cuda_ms(lambda: fused_advance_pair(*args, **kwargs), 3)
            plain_ms = cuda_ms(lambda: pair_advance_ref(*args, **kwargs), 1)
            fused_advance_pair.launches = saved
            lanes_alive, prev_lane = args[13], args[10]
            # phase 3's count at this path's shape: the pair and the lanes
            # in (wid, prev, cur, hop i32 + alive), the lanes out + steps
            nbytes = sum(t.numel() * t.element_size() for t in args[:14])
            nbytes += rmask.numel() * (3 * 4 + 1) + 4
            check = dict(
                lanes=int(rmask.numel()), routed=int(rmask.sum()),
                dead_at_prev_minus_1=int(((prev_lane == -1) & ~lanes_alive).sum()),
                max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                steps=int(got[4]), bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            )  # fmt: skip
            log(f"[dist] 10a kernel vs plain on the first advance's inputs: {json.dumps(check)}")
            if err != 0 or check["dead_at_prev_minus_1"] == 0:
                raise AssertionError(f"phase 10a: kernel vs plain version: {check}")
        finally:
            dist.destroy_process_group()
        # the same run on the CPU, through the plain version, in a one-rank
        # gloo group; and 10b's reference: its graph in one block, likewise
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'rdzv_cpu'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
        try:
            mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
            cpu = torch.device("cpu")
            res_t, info_t, _ = _dist_run(bg, task, mesh, cpu)
            log(f"[dist] 10a {json.dumps(info_t)}")
            differ = _same_walks(res_c, res_t)
            if differ or res_c["sweeps"] != res_t["sweeps"] or info_t["launches"] != 0:
                raise AssertionError(f"phase 10a: card and CPU runs differ on {differ}, "
                                     f"sweeps {res_c['sweeps']} / {res_t['sweeps']}, "
                                     f"CPU launches {info_t['launches']}")  # fmt: skip
            out["10a"] = dict(cuda=info_c, cpu=info_t, kernel_check=check)
            bgb, taskb = _dist_case(DIST_VERTICES, 1)
            ref_b, info_ref, _ = _dist_run(bgb, taskb, mesh, cpu)
            log(f"[dist] 10b reference (1, 1) {json.dumps(info_ref)}")
        finally:
            dist.destroy_process_group()

        # 10b: DIST_RANKS gloo ranks, each a process on this card
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(DIST_RANKS):
                with open(tmp / f"rank{r}.log", "w") as logf:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--src", src,
                         "--dist-child", str(r), str(tmp)],
                        stdout=logf, stderr=subprocess.STDOUT,
                    ))  # fmt: skip
            deadline = time.perf_counter() + DIST_TIMEOUT
            for p in procs:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 10b: a rank ran past {DIST_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = {r: (tmp / f"rank{r}.log").read_text()[-3000:] for r in failed}
            raise AssertionError(f"phase 10b: ranks {failed} failed: {tails}")
        ranks = []
        for r in range(DIST_RANKS):
            info = json.loads((tmp / f"rank{r}.json").read_text())
            res = dict(np.load(tmp / f"rank{r}.npz"))
            differ = _same_walks(res, ref_b)
            if differ:
                raise AssertionError(f"phase 10b: rank {r} differs from the (1, 1) run on {differ}")
            log(f"[dist] 10b rank {r} {json.dumps(info)}")
            ranks.append(info)
        if not all(i["launches"] > 0 for i in ranks):
            raise AssertionError(f"phase 10b: a rank launched no kernel: {ranks}")
        out["10b"] = dict(reference=info_ref, ranks=ranks, wall_s=time.perf_counter() - t0,
                          launches=sum(i["launches"] for i in ranks),
                          bucket_hist_launches=sum(i["bucket_hist_launches"] for i in ranks))
    log(f"[dist] card: {card_line()}")
    log(f"[dist] phase 10: {time.perf_counter() - t_phase:.1f}s; 10b {DIST_RANKS} ranks "
        f"{out['10b']['wall_s']:.1f}s, launches {out['10b']['launches']}")  # fmt: skip
    return out


class _Routes:
    """Records the top-k expert ids of every ``models.moe._route`` call
    inside the ``with`` block (one per MoE layer, in order)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe._route

        def recorded(params, xt, cfg):
            idx, gate, aux = self._route(params, xt, cfg)
            self.calls.append(idx)
            return idx, gate, aux

        moe._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._route


def _dropped(idx, cfg, floor: int = 0) -> int:
    """Assignments past their expert's capacity: ``models/moe.py``'s rule,
    ``int(T*K/E * cf) + 1`` over the virtual experts (at least ``floor``:
    4 on the expert-parallel path), on ``_route``'s ids."""
    import torch

    E = cfg.n_experts * cfg.moe_virtual_split
    T, K = idx.shape
    cap = max(int((T * K / E) * cfg.capacity_factor) + 1, floor)
    load = torch.bincount(idx.reshape(-1), minlength=E)
    return int((load - cap).clamp_min(0).sum())


def _cut(cfg, segments, **change):
    """``cfg`` at its published widths with the depth cut to ``segments``."""
    import dataclasses

    layers = sum(len(pattern) * n for pattern, n in segments)
    return dataclasses.replace(cfg, name=f"{cfg.name}-{layers}L", n_layers=layers,
                               segments=segments, **change)  # fmt: skip


def _prefix_len(cfg) -> int:
    """The positions a VLM's patch embeddings take before the tokens."""
    return cfg.num_prefix if cfg.frontend == "vision" else 0


def _lm_batch(cfg, n: int, seq: int, frames: int, dev) -> dict:
    """``n`` prompts of ``seq`` tokens from ``default_rng(0)`` (phase 7b's);
    drawn after them, for a VLM ``n`` x ``num_prefix`` patch embeddings
    (tests/test_torch_lm.py's order), for the encoder-decoder ``n`` clips of
    ``frames`` frame embeddings (``examples/serve_lm.py``'s order)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (n, seq)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if cfg.frontend == "vision":
        prefix = rng.standard_normal((n, cfg.num_prefix, cfg.d_model)).astype(np.float32)
        batch["prefix"] = torch.as_tensor(prefix, device=dev)
    if cfg.is_encoder_decoder:
        clips = rng.standard_normal((n, frames, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.as_tensor(clips, device=dev)
    return batch


def _decode_vs_forward(cfg, params, batch, steps: int, enc_len: int = 0) -> dict:
    """Prefill of all but the last ``steps`` tokens of ``batch``, then
    ``steps`` chained decode steps, each step's logits against the
    forward's at its position within LM_EQUIV_TOL (a VLM's token ``t`` sits
    at cache position ``t + num_prefix``); ``dropped`` counts the MoE
    assignments past capacity over all of it."""
    from repro_torch.models import model_caches, model_decode, model_forward, model_prefill
    from repro_torch.models.common import tree_map

    toks = batch["tokens"]
    n, seq = toks.shape
    first, prefix = seq - steps, _prefix_len(cfg)
    with _Routes() as routes:
        want = model_forward(params, batch, cfg)[0]
        _, caches = model_prefill(params, dict(batch, tokens=toks[:, :first]), cfg)
        target = model_caches(cfg, n, prefix + seq + 4, enc_len=enc_len, device=toks.device)
        caches = tree_map(_lm_pad, caches, target)
        gaps = []
        for t in range(first, seq):
            got, _ = model_decode(params, toks[:, t : t + 1], caches, prefix + t, cfg)
            gaps.append(dict(_lm_logits_gap(got, want[:, t], LM_EQUIV_TOL), position=t))
    return dict(
        layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers, prefix=prefix, prompt=first,
        steps=gaps,
        ok=all(g["ok"] for g in gaps), dropped=sum(_dropped(i, cfg) for i in routes.calls),
    )  # fmt: skip


def _card_vs_cpu(cfg, params, batch, tol: float, *, caches: bool = False) -> dict:
    """``params`` and ``batch`` on the card and copied to the CPU: the
    logits, the aux loss, with ``caches`` the prefill caches, the loss and
    every gradient, each within ``tol`` (float32 with TF32 off on both: the
    sums' order differs, nothing else), and the MoE layers' top-k ids."""
    from repro_torch.models import model_forward, model_prefill
    from repro_torch.models.common import tree_leaves_with_path, tree_map
    from repro_torch.train import make_loss_fn
    from repro_torch.train.step import _value_and_grad

    host = (tree_map(lambda a: a.cpu(), params), {k: v.cpu() for k, v in batch.items()})
    runs = []
    for p, b in ((params, batch), host):
        with _Routes() as routes:
            logits, aux = model_forward(p, b, cfg)
        tree = {"logits": logits, "aux": aux}
        if caches:
            tree["cache"] = model_prefill(p, b, cfg)[1]
        (tree["loss"], _), tree["grad"] = _value_and_grad(make_loss_fn(cfg), p, b)
        runs.append((tree, routes.calls))
    (card, idx), (cpu, h_idx) = runs
    cpu_flat = dict(tree_leaves_with_path(cpu))
    checks = {path[1:]: _lm_logits_gap(t, cpu_flat[path], tol)
              for path, t in tree_leaves_with_path(card)}  # fmt: skip
    worst = max(checks, key=lambda key: checks[key]["tol_share"])
    return dict(
        arch=cfg.name, checks=len(checks), worst=worst, worst_gap=checks[worst],
        ok=all(c["ok"] for c in checks.values()), aux=float(cpu["aux"]), moe_layers=len(idx),
        topk_differ=sum(int((a.cpu() != b).sum()) for a, b in zip(idx, h_idx)),
        dropped=[_dropped(i, cfg) for i in h_idx],
    )  # fmt: skip


def _moe_equivalence(arch, dev) -> dict:
    """11a for one arch: decode against forward at the published widths in
    float32 (nothing dropped), then the reduced config card against CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model_init

    base = get_config(arch)
    ev = base.n_experts * base.moe_virtual_split
    cfg = _cut(base, MOE_EQ_SEGMENTS[arch], dtype=torch.float32, capacity_factor=float(ev))
    params = model_init(0, cfg, device=dev)
    batch = _lm_batch(cfg, LM_EQ_BATCH, MOE_EQ_SEQ, 0, dev)
    out = {"decode_vs_forward": dict(_decode_vs_forward(cfg, params, batch, 1),
                                     capacity_factor=float(ev))}  # fmt: skip
    log(f"[lm-moe] 11a {cfg.name} float32, capacity_factor {ev} (no drops), decode vs forward "
        f"(batch {LM_EQ_BATCH}, {MOE_EQ_SEQ} tokens): "
        f"{json.dumps(out['decode_vs_forward'])}")  # fmt: skip
    del params
    torch.cuda.empty_cache()

    # the reduced config at the published capacity factor, so assignments
    # drop: the card against the CPU on the same weights
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=MOE_CF)
    params = model_init(0, cfg, device=dev)
    batch = _train_batch(cfg, LM_EQ_BATCH, MOE_EQ_SEQ, dev)
    out["card_vs_cpu"] = dict(_card_vs_cpu(cfg, params, batch, MOE_CPU_TOL),
                              capacity_factor=MOE_CF)  # fmt: skip
    log(f"[lm-moe] 11a {cfg.name} card vs CPU (float32, capacity_factor {MOE_CF}; logits, aux, "
        f"loss, every gradient): {json.dumps(out['card_vs_cpu'])}")  # fmt: skip
    return out


def _serve_lm(cfg, dev, *, tag: str, phase: str, prompt: int, bounds, describe: str = "",
              params=None, keep: bool = False) -> dict:
    """Phases 11b, 12b and 13a for one config: made on the card (or
    ``params``, made by the caller), LM_BATCH prompts
    of ``prompt`` tokens (``_lm_batch``; the encoder-decoder's over
    REC_FRAMES frames, a VLM's after its patch embeddings, which take the
    caches' first ``num_prefix`` positions) prefilled twice, then LM_NEW - 1
    greedy decode steps
    timed with CUDA events, and the card's busy time under torch.profiler.
    ``bounds(params, caches, prefill_ids, decode_ids)``, given the MoE
    layers' top-k ids of the first prefill and the first decode step,
    returns the prefill's FLOPs and the decode step's bytes (``flops``,
    ``decode_bytes``), a note on each for the log, the caller's own metrics
    (``extra``) and log ``lines``.  Fails unless the second prefill is
    bitwise equal to the first, the logits finite and the tokens inside the
    vocabulary.  With ``keep``, the result also holds the first prefill's
    logits and every sequence's tokens (``logits``, ``seqs``)."""
    import torch

    from repro_torch.models import model_caches, model_init
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import make_decode_step, make_prefill_step

    enc_len = REC_FRAMES if cfg.is_encoder_decoder else 0
    prefix = _prefix_len(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    given = params is not None
    if not given:
        params = model_init(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    made = ("the caller's" if given else f"made on the card in {init_s:.2f}s, "
            f"torch.cuda.max_memory_allocated while made {init_peak:,} bytes")  # fmt: skip
    log(f"[{tag}] {phase} {cfg.name} {cfg.dtype} {cfg.n_layers} layers {list(cfg.layer_kinds)} "
        f"d_model {cfg.d_model}{describe}: {n_params:,} parameters, {weight_bytes:,} bytes, "
        f"{made}")  # fmt: skip
    torch.cuda.reset_peak_memory_stats()
    batch = _lm_batch(cfg, LM_BATCH, prompt, REC_FRAMES, dev)
    prefill = make_prefill_step(cfg)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    prefill_ms, results = [], []
    for i in range(2):  # the first call also sets up cuBLAS and records the routes
        start, stop = ev(), ev()
        torch.cuda.synchronize()
        with _Routes() if i == 0 else contextlib.nullcontext() as routes:
            start.record()
            results.append(prefill(params, batch))
            stop.record()
        torch.cuda.synchronize()
        prefill_ms.append(start.elapsed_time(stop))
        if i == 0:
            prefill_ids = routes.calls
    (logits, pcaches), (logits2, pcaches2) = results
    bitwise = torch.equal(logits, logits2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(pcaches), tree_leaves(pcaches2))
    )
    del results, logits2, pcaches2
    first_pos = prefix + prompt
    max_len = first_pos + LM_NEW
    target = model_caches(cfg, LM_BATCH, max_len, enc_len=enc_len, device=dev)
    caches = tree_map(_lm_pad, pcaches, target)
    del pcaches, target
    prefill_finite = bool(torch.isfinite(logits).all())
    decode = make_decode_step(cfg)
    # the decode step's rule: the best id of the vocabulary, no padded one
    tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)[:, None]
    seq, marks = [tok], []
    t0 = time.perf_counter()
    for i in range(LM_NEW - 1):
        step = {"token": tok, "cache_len": first_pos + i}
        start, stop = ev(), ev()
        with _Routes() if i == 0 else contextlib.nullcontext() as routes:
            start.record()
            tok, step_logits, caches = decode(params, step, caches)
            stop.record()
        if i == 0:
            decode_ids = routes.calls
        marks.append((start, stop))
        tok = tok[:, None]
        seq.append(tok)
    torch.cuda.synchronize()
    decode_wall_s = time.perf_counter() - t0
    step_ms = sorted(a.elapsed_time(b) for a, b in marks)
    seqs = torch.cat(seq, dim=1).cpu()
    peak = torch.cuda.max_memory_allocated()
    busy = dict(
        prefill=_device_busy(lambda: prefill(params, batch), 1),
        decode=_device_busy(
            lambda: decode(params, {"token": tok, "cache_len": max_len - 1}, caches), 5
        ),
    )  # fmt: skip
    b = bounds(params, caches, prefill_ids, decode_ids)
    median = step_ms[len(step_ms) // 2]
    serve = dict(
        arch=cfg.name, dtype=str(cfg.dtype), layers=cfg.n_layers,
        encoder_layers=cfg.n_encoder_layers, params=n_params, weight_bytes=weight_bytes,
        batch=LM_BATCH, prompt=prompt, frames=enc_len, prefix=prefix,
        new_tokens=LM_NEW, cache_len=max_len,
        init_s=init_s, init_peak=init_peak, prefill_first_ms=prefill_ms[0],
        prefill_ms=prefill_ms[1], prefill_tokens_per_s=LM_BATCH * prompt / (prefill_ms[1] / 1e3),
        prefill_flops=b["flops"], prefill_bound_ms=b["flops"] / BF16_FLOPS_PER_S * 1e3,
        prefill_bitwise=bitwise, decode_steps=len(step_ms), decode_ms_median=median,
        decode_ms_min=step_ms[0], decode_ms_max=step_ms[-1],
        decode_tokens_per_s=LM_BATCH / (median / 1e3), decode_wall_s=decode_wall_s,
        decode_bytes=b["decode_bytes"], decode_bound_ms=b["decode_bytes"] / HBM_BYTES_PER_S * 1e3,
        max_memory_allocated=peak, seq0=seqs[0].tolist(), device_busy=busy,
        prefill_idle_share=1 - busy["prefill"]["device_ms"] / prefill_ms[1],
        decode_idle_share=1 - busy["decode"]["device_ms"] / median, **b["extra"],
    )  # fmt: skip
    log(f"[{tag}] {phase} {cfg.name} prefill {LM_BATCH} x {prompt} tokens"
        f"{f' over {enc_len} frames' if enc_len else ''}"
        f"{f' after {prefix} patch embeddings' if prefix else ''}: "
        f"{prefill_ms[1]:.3f} ms (first call "
        f"{prefill_ms[0]:.3f} ms), {serve['prefill_tokens_per_s']:,.0f} tokens/s; bound "
        f"{serve['prefill_bound_ms']:.3f} ms = {b['flops_note']} / {BF16_FLOPS_PER_S:.3g} "
        f"FLOP/s; second prefill bitwise equal: {bitwise}")  # fmt: skip
    log(f"[{tag}] {phase} {cfg.name} decode {len(step_ms)} steps of {LM_BATCH} tokens: median "
        f"{median:.3f} ms (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}), "
        f"{serve['decode_tokens_per_s']:,.1f} tokens/s; {decode_wall_s:.3f} s on the host clock; "
        f"bound {serve['decode_bound_ms']:.4f} ms = ({b['decode_note']}) / "
        f"{HBM_BYTES_PER_S:.3g} B/s")  # fmt: skip
    for name in ("prefill", "decode"):
        log(f"[{tag}] {phase} {cfg.name} {name} on the card (torch.profiler): "
            f"{busy[name]['device_ms']:.3f} ms busy and {busy[name]['kernels']:.0f} kernels per "
            f"call, idle share {serve[name + '_idle_share']:.3f} of the timed call; top "
            f"{json.dumps(busy[name]['top'])}")  # fmt: skip
    for line in b["lines"]:
        log(f"[{tag}] {phase} {cfg.name} {line}")
    log(f"[{tag}] {phase} {cfg.name} torch.cuda.max_memory_allocated over prefill + decode "
        f"{peak:,} bytes; seq 0: {serve['seq0']}")  # fmt: skip
    if not bitwise:
        raise AssertionError(f"phase {phase} {cfg.name}: two prefills of the same prompts differ")
    if not (prefill_finite and bool(torch.isfinite(step_logits).all())):
        raise AssertionError(f"phase {phase} {cfg.name}: logits are not finite")
    if not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError(f"phase {phase} {cfg.name}: a token outside the vocabulary")
    if seqs.shape != (LM_BATCH, LM_NEW):
        raise AssertionError(f"phase {phase} {cfg.name}: {tuple(seqs.shape)} tokens")
    if keep:
        serve.update(logits=logits, seqs=seqs)
    del params, caches
    torch.cuda.empty_cache()
    return serve


def _nbytes(tree) -> int:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _moe_bounds(cfg, floor: int = 0):
    """``_serve_lm``'s ``bounds`` for a MoE config (11b, 13a); drops are
    counted under the capacity rule with ``floor`` (``_dropped``)."""
    import torch

    from repro_torch.models.common import tree_leaves, tree_leaves_with_path

    active = cfg.active_param_count()

    def bounds(params, caches, prefill_ids, decode_ids):
        weight_bytes = _nbytes(params)
        # one virtual expert's weights in one layer (w_in [d, 2F_v], w_out
        # [F_v, d]), and the weights outside the routed experts
        fv = (cfg.moe_d_ff or cfg.d_ff) // cfg.moe_virtual_split
        expert_bytes = 3 * cfg.d_model * fv * cfg.dtype.itemsize
        dense_bytes = weight_bytes - sum(
            _nbytes(t) for path, t in tree_leaves_with_path(params) if "/moe/experts/" in path
        )
        tokens = LM_BATCH * LM_PROMPT
        # the cache a step reads: every layer's row at the positions filled
        # so far (the mean over the steps)
        cache_row = sum(_nbytes(t[:, 0, 0]) for t in tree_leaves(caches))
        cache_bytes = cache_row * LM_BATCH * (LM_PROMPT + (LM_NEW - 1) / 2 + 1)
        hit = [len(torch.unique(i)) for i in decode_ids]
        routed_bytes = dense_bytes + expert_bytes * sum(hit)
        extra = dict(
            active_params=active, capacity_factor=cfg.capacity_factor,
            decode_cache_bytes_mean=cache_bytes, decode_routed_bytes=routed_bytes,
            experts_hit_decode_step1=hit,
            decode_routed_bound_ms=(routed_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
            cache_bytes_per_token_layer=cache_row // cfg.n_layers,
            assignments_prefill=sum(i.numel() for i in prefill_ids),
            dropped_prefill=[_dropped(i, cfg, floor) for i in prefill_ids],
            assignments_decode_step1=sum(i.numel() for i in decode_ids),
            dropped_decode_step1=[_dropped(i, cfg, floor) for i in decode_ids],
        )  # fmt: skip
        lines = [
            f"decode bound, routed experts only: {extra['decode_routed_bound_ms']:.4f} ms "
            f"({routed_bytes:,} weight bytes: {hit} virtual experts hit per MoE layer at the "
            f"first step, + the cache bytes) / {HBM_BYTES_PER_S:.3g} B/s",
            f"dropped assignments per MoE layer: prefill {extra['dropped_prefill']} of "
            f"{extra['assignments_prefill']:,} in all, first decode step "
            f"{extra['dropped_decode_step1']} of {extra['assignments_decode_step1']} in all; "
            f"cache {extra['cache_bytes_per_token_layer']:,} bytes per token and layer",
        ]  # fmt: skip
        return dict(
            flops=2 * active * tokens, flops_note=f"2 x {active:,} active params x {tokens} tokens",
            decode_bytes=weight_bytes + cache_bytes,
            decode_note=f"{weight_bytes:,} weight bytes, every expert's, as the capacity path "
            f"multiplies them all, + {cache_bytes:,.0f} cache bytes, the mean step's",
            extra=extra, lines=lines,
        )  # fmt: skip

    return bounds


def _moe_describe(cfg) -> str:
    return (f", {cfg.n_experts} experts x split {cfg.moe_virtual_split}, top {cfg.top_k}, "
            f"capacity_factor {cfg.capacity_factor}, {cfg.active_param_count():,} active "
            f"parameters")  # fmt: skip


def _moe_serve(arch, dev) -> dict:
    """11b for one arch: bf16 at the published widths and capacity factor,
    the depth cut to MOE_SERVE_SEGMENTS; phase 7b's prompts and steps."""
    from repro_torch.configs import get_config

    cfg = _cut(get_config(arch), MOE_SERVE_SEGMENTS[arch])
    return _serve_lm(cfg, dev, tag="lm-moe", phase="11b", prompt=LM_PROMPT,
                     bounds=_moe_bounds(cfg), describe=_moe_describe(cfg))  # fmt: skip


def phase_lm_moe(dev):
    """Phase 11: serving the MoE and MLA decoders at their published widths
    (11a equivalence in float32, 11b serving in bfloat16)."""
    import torch

    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {"11a": {arch: _moe_equivalence(arch, dev) for arch in MOE_ARCHS}}
    for arch, eq in out["11a"].items():
        if not eq["decode_vs_forward"]["ok"] or eq["decode_vs_forward"]["dropped"]:
            raise AssertionError(f"phase 11a {arch}: decode vs forward {eq['decode_vs_forward']}")
        if not eq["card_vs_cpu"]["ok"] or eq["card_vs_cpu"]["topk_differ"]:
            raise AssertionError(f"phase 11a {arch}: card vs CPU {eq['card_vs_cpu']}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    out["11b"] = {arch: _moe_serve(arch, dev) for arch in MOE_ARCHS}
    out["11b"]["launches"] = fused_advance_pair.launches
    out["11b"]["bucket_hist_launches"] = bucket_hist_kernel.launches
    log(f"[lm-moe] phase 11: {time.perf_counter() - t_phase:.1f}s; kernel launches: pair_advance "
        f"{out['11b']['launches']}, bucket_hist {out['11b']['bucket_hist_launches']}")  # fmt: skip
    return out


def _rec_equivalence(arch, dev) -> dict:
    """12a for one arch: decode against forward at the published widths in
    float32 (the depth cut to REC_EQ_SEGMENTS), the card against the CPU on
    the same weights, then the reduced config card against CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model_forward, model_init
    from repro_torch.models.common import tree_map

    base = get_config(arch)
    segments = REC_EQ_SEGMENTS[arch]
    cfg = _cut(base, segments, dtype=torch.float32) if segments else dataclasses.replace(
        base, dtype=torch.float32
    )  # fmt: skip
    params = model_init(0, cfg, device=dev)
    batch = _lm_batch(cfg, LM_EQ_BATCH, REC_EQ_SEQ, REC_FRAMES, dev)
    enc_len = REC_FRAMES if cfg.is_encoder_decoder else 0
    out = {"decode_vs_forward": _decode_vs_forward(cfg, params, batch, REC_EQ_STEPS, enc_len)}
    log(f"[lm-rec] 12a {cfg.name} float32 {list(cfg.layer_kinds)}, decode vs forward (batch "
        f"{LM_EQ_BATCH}, prefill {REC_EQ_SEQ - REC_EQ_STEPS} tokens, {REC_EQ_STEPS} chained "
        f"steps): {json.dumps(out['decode_vs_forward'])}")  # fmt: skip

    # the same weights and batch on the CPU: every position's logits
    want = model_forward(params, batch, cfg)[0]
    t0 = time.perf_counter()
    host = model_forward(tree_map(lambda a: a.cpu(), params),
                         {k: v.cpu() for k, v in batch.items()}, cfg)[0]  # fmt: skip
    out["card_vs_cpu"] = dict(_lm_logits_gap(want, host, LM_CPU_TOL), layers=cfg.n_layers,
                              cpu_s=time.perf_counter() - t0)  # fmt: skip
    log(f"[lm-rec] 12a {cfg.name} card vs CPU (same weights, all {REC_EQ_SEQ} positions): "
        f"{json.dumps(out['card_vs_cpu'])}")  # fmt: skip
    del params, want, host, batch
    torch.cuda.empty_cache()

    # the reduced config: logits, prefill caches, loss and every gradient
    cfg = reduced_config(arch)
    params = model_init(0, cfg, device=dev)
    batch = _train_batch(cfg, LM_EQ_BATCH, REC_EQ_SEQ, dev)
    if cfg.is_encoder_decoder:
        batch["frames"] = _lm_batch(cfg, LM_EQ_BATCH, 1, REC_EQ_SEQ, dev)["frames"]
    out["reduced_card_vs_cpu"] = _card_vs_cpu(cfg, params, batch, REC_CPU_TOL, caches=True)
    log(f"[lm-rec] 12a {cfg.name} card vs CPU (float32; logits, aux, prefill caches, loss, every "
        f"gradient): {json.dumps(out['reduced_card_vs_cpu'])}")  # fmt: skip
    return out


def _rec_flops(cfg, params, batch: int, seq: int, frames: int) -> int:
    """A prefill's matrix products: 2 x each weight matrix x the rows it
    multiplies (the embedding lookup is none; a tied embedding is the
    head), the depthwise convs, and the attention score and value products
    (whisper's encoder, cross and causal self attention; recurrentgemma's
    causal local layers, whose window the prompt does not overrun).  The
    SSD's chunk products and the RG-LRU scan are left out."""
    from repro_torch.models.common import tree_leaves

    size = lambda tree: sum(t.numel() for t in tree_leaves(tree))
    hd_h = cfg.n_heads * cfg.head_dim
    if not cfg.is_encoder_decoder:
        weights = size(params) - (0 if cfg.tie_embeddings else params["embed"].numel())
        local = sum(kind.startswith(("attn", "local")) for kind in cfg.layer_kinds)
        return 2 * weights * batch * seq + local * 2 * batch * seq * seq * hd_h
    enc, dec = params["enc_layers"], params["dec_layers"]
    cross_kv = size(_cross_kv(dec))
    enc_rows, dec_rows = batch * frames, batch * seq
    linear = 2 * (size(enc) * enc_rows + (size(dec) - cross_kv) * dec_rows
                  + cross_kv * enc_rows + params["embed"].numel() * dec_rows)  # fmt: skip
    # encoder self attention over the frames; per decoder layer causal
    # self attention and cross attention to the frames
    attention = hd_h * (cfg.n_encoder_layers * 4 * enc_rows * frames
                        + cfg.n_layers * (2 * dec_rows * seq + 4 * dec_rows * frames))  # fmt: skip
    return linear + attention


def _cross_kv(dec_layers) -> list:
    """The decoder's cross-attention K and V projections (and biases): they
    act on the encoder's states once, at prefill, and no decode step reads
    them (the cross caches hold their products)."""
    cross = dec_layers["cross_attn"]
    return [cross[k] for k in ("wk", "wv", "bk", "bv") if k in cross]


def _rec_serve(arch, dev) -> dict:
    """12b for one arch: bf16 at the published widths and depth; phase 7b's
    prompts (whisper: 64-token prompts over 1,500-frame clips), prefill
    twice, then LM_NEW - 1 greedy decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves_with_path

    cfg = get_config(arch)
    prompt = REC_WHISPER_PROMPT if cfg.is_encoder_decoder else LM_PROMPT

    def bounds(params, caches, prefill_ids, decode_ids):
        flops = _rec_flops(cfg, params, LM_BATCH, prompt, REC_FRAMES)
        # the weights a step reads: all but an untied embedding table (B
        # rows are looked up) and, for the encoder-decoder, the encoder's,
        # the cross K/V projections and the position tables (one row)
        if cfg.is_encoder_decoder:
            dec = params["dec_layers"]
            read_bytes = (_nbytes(dec) - _nbytes(_cross_kv(dec)) + _nbytes(params["dec_ln"])
                          + _nbytes(params["embed"]))  # fmt: skip
        else:
            read_bytes = _nbytes(params) - (0 if cfg.tie_embeddings else _nbytes(params["embed"]))
        # the state a step reads and writes: the recurrent state (SSD,
        # RG-LRU and the conv tails) whole, read and written back; of the KV
        # caches the positions filled so far (the mean over the steps),
        # read, and the cross K/V whole
        state_bytes = cache_bytes = 0
        for path, t in tree_leaves_with_path(caches):
            if path.endswith(("/ssm", "/h", "/conv")):
                state_bytes += _nbytes(t)
            elif "/cross/" in path:
                cache_bytes += _nbytes(t)
            else:  # K/V [.., B, L, KVH, HD]: one row per filled position
                row = _nbytes(t) // t.shape[-3]
                cache_bytes += row * min(t.shape[-3], prompt + (LM_NEW - 1) / 2 + 1)
        per_seq = _nbytes(caches) / LM_BATCH
        extra = dict(
            decode_weight_bytes=read_bytes, decode_state_bytes=state_bytes,
            decode_cache_bytes_mean=cache_bytes, cache_bytes_per_sequence=per_seq,
        )  # fmt: skip
        return dict(
            flops=flops, flops_note=f"{flops:,} FLOPs (matrix products; see _rec_flops)",
            decode_bytes=read_bytes + 2 * state_bytes + cache_bytes,
            decode_note=f"{read_bytes:,} weight bytes read + 2 x {state_bytes:,} recurrent state "
            f"bytes, read and written + {cache_bytes:,.0f} KV cache bytes, the mean step's",
            extra=extra,
            lines=[f"state and caches {per_seq:,.0f} bytes per sequence at {prompt + LM_NEW} "
                   "positions"],
        )  # fmt: skip

    describe = f", {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else ""
    return _serve_lm(cfg, dev, tag="lm-rec", phase="12b", prompt=prompt, bounds=bounds,
                     describe=describe)  # fmt: skip


def phase_lm_recurrent(dev):
    """Phase 12: serving the SSD, RG-LRU and encoder-decoder models at their
    published widths (12a equivalence in float32, 12b serving in bfloat16)."""
    import torch

    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {"12a": {arch: _rec_equivalence(arch, dev) for arch in REC_ARCHS}}
    for arch, eq in out["12a"].items():
        for key in ("decode_vs_forward", "card_vs_cpu", "reduced_card_vs_cpu"):
            if not eq[key]["ok"]:
                raise AssertionError(f"phase 12a {arch}: {key} outside its tolerance: {eq[key]}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    out["12b"] = {arch: _rec_serve(arch, dev) for arch in REC_ARCHS}
    out["12b"]["launches"] = fused_advance_pair.launches
    out["12b"]["bucket_hist_launches"] = bucket_hist_kernel.launches
    log(f"[lm-rec] phase 12: {time.perf_counter() - t_phase:.1f}s; kernel launches: pair_advance "
        f"{out['12b']['launches']}, bucket_hist {out['12b']['bucket_hist_launches']}")  # fmt: skip
    return out


def _dense_equivalence(arch, dev) -> dict:
    """15a for one arch: decode against forward at the published widths in
    float32 (the depth cut to DENSE_EQ_LAYERS), then the reduced config
    card against CPU."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model_init

    cfg = _cut(get_config(arch), ((("attn+mlp",), DENSE_EQ_LAYERS),), dtype=torch.float32)
    params = model_init(0, cfg, device=dev)
    batch = _lm_batch(cfg, LM_EQ_BATCH, LM_EQ_SEQ, 0, dev)
    out = {"decode_vs_forward": _decode_vs_forward(cfg, params, batch, DENSE_EQ_STEPS)}
    log(f"[lm-dense] 15a {cfg.name} float32, decode vs forward (batch {LM_EQ_BATCH}, "
        f"{_prefix_len(cfg)} patch embeddings + {LM_EQ_SEQ} tokens, {DENSE_EQ_STEPS} chained "
        f"steps): {json.dumps(out['decode_vs_forward'])}")  # fmt: skip
    del params, batch
    torch.cuda.empty_cache()

    cfg = reduced_config(arch)
    params = model_init(0, cfg, device=dev)
    batch = _train_batch(cfg, LM_EQ_BATCH, LM_EQ_SEQ, dev)
    if cfg.frontend == "vision":
        batch["prefix"] = _lm_batch(cfg, LM_EQ_BATCH, 1, 0, dev)["prefix"]
    out["reduced_card_vs_cpu"] = _card_vs_cpu(cfg, params, batch, DENSE_CPU_TOL, caches=True)
    log(f"[lm-dense] 15a {cfg.name} card vs CPU (float32; logits, aux, prefill caches, loss, "
        f"every gradient): {json.dumps(out['reduced_card_vs_cpu'])}")  # fmt: skip
    return out


def _dense_serve(arch, dev, card: str) -> dict:
    """15b for one arch: bf16 at the published widths and depth; phase 7b's
    prompts (a VLM's after its patch embeddings) and steps.  Bounds as 7b's:
    the prefill 2 x params x the positions it runs, the decode step every
    weight and the mean step's KV cache."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    prefix = _prefix_len(cfg)

    def bounds(params, caches, prefill_ids, decode_ids):
        n_params, weight_bytes = cfg.param_count(), _nbytes(params)
        positions = LM_BATCH * (prefix + LM_PROMPT)
        kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize
        kv_bytes = LM_BATCH * kv_row * (prefix + LM_PROMPT + (LM_NEW - 1) / 2 + 1)
        return dict(
            flops=2 * n_params * positions,
            flops_note=f"2 x {n_params:,} params x {positions} positions (attention's own FLOPs "
            "left out)",
            decode_bytes=weight_bytes + kv_bytes,
            decode_note=f"{weight_bytes:,} weight bytes + {kv_bytes:,.0f} KV cache bytes, the "
            "mean step's",
            extra=dict(decode_kv_bytes_mean=kv_bytes, card=card), lines=[],
        )  # fmt: skip

    describe = (f", GQA {cfg.n_heads}/{cfg.n_kv_heads} of head_dim {cfg.head_dim}, vocab "
                f"{cfg.vocab_size}{', QKV bias' if cfg.qkv_bias else ''}"
                f"{f', {prefix} prefix patch embeddings' if prefix else ''}")  # fmt: skip
    out = _serve_lm(cfg, dev, tag="lm-dense", phase="15b", prompt=LM_PROMPT, bounds=bounds,
                    describe=describe)  # fmt: skip
    log(f"[lm-dense] 15b {cfg.name} {cfg.dtype} {cfg.n_layers} layers: prefill "
        f"{out['prefill_ms']:.3f} ms (bound {out['prefill_bound_ms']:.3f}), decode median "
        f"{out['decode_ms_median']:.3f} "
        f"ms (bound {out['decode_bound_ms']:.4f}), peak {out['max_memory_allocated']:,} bytes "
        f"| {card}")  # fmt: skip
    return out


def phase_lm_dense(dev):
    """Phase 15: serving qwen1.5-0.5b, internvl2-1b (the VLM prefix),
    phi3-mini-3.8b and yi-34b at their published widths (15a equivalence in
    float32, 15b serving in bfloat16 at full depth)."""
    import torch

    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    card = card_line()
    log(f"[lm-dense] phase 15 starts with {torch.cuda.memory_allocated():,} bytes allocated on "
        f"the card | {card}")  # fmt: skip
    out = {"15a": {arch: _dense_equivalence(arch, dev) for arch in DENSE_ARCHS}}
    for arch, eq in out["15a"].items():
        for key in ("decode_vs_forward", "reduced_card_vs_cpu"):
            if not eq[key]["ok"]:
                raise AssertionError(f"phase 15a {arch}: {key} outside its tolerance: {eq[key]}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    out["15b"] = {arch: _dense_serve(arch, dev, card) for arch in DENSE_ARCHS}
    out["15b"]["launches"] = fused_advance_pair.launches
    out["15b"]["bucket_hist_launches"] = bucket_hist_kernel.launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm-dense] phase 15: {out['phase_s']:.1f}s; kernel launches: pair_advance "
        f"{out['15b']['launches']}, bucket_hist {out['15b']['bucket_hist_launches']} "
        f"| {card}")  # fmt: skip
    return out


def _ep_rules(mesh) -> dict:
    """The rules that select ``models.moe``'s expert-parallel path (what
    ``sharding.context.default_rules`` publishes on a wider ``model`` axis)."""
    return {"moe_ep_axis": "model", "moe_dp_axes": ("data",), "mesh": mesh}


class _Exchanges:
    """Times every ``models.moe._exchange`` (one ``all_to_all_single``)
    inside the ``with`` block, with the bytes each sends: CUDA events on the
    card (NCCL), or the host clock around a synchronised call (gloo, whose
    exchange copies through host memory)."""

    def __init__(self, events: bool):
        self.events, self.calls = events, []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._fn = moe._exchange

        def timed(bins, group, xdev):
            nbytes = bins.numel() * bins.element_size()
            if self.events:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                got = self._fn(bins, group, xdev)
                stop.record()
                self.calls.append(((start, stop), nbytes))
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = self._fn(bins, group, xdev)
                torch.cuda.synchronize()
                self.calls.append(((time.perf_counter() - t0) * 1e3, nbytes))
            return got

        moe._exchange = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._exchange = self._fn

    def summary(self, n_moe: int) -> dict:
        """Each exchange's ms and bytes, and their sums per MoE layer."""
        import torch

        torch.cuda.synchronize()
        ms = [c[0].elapsed_time(c[1]) if self.events else c for c, _ in self.calls]
        nbytes = [b for _, b in self.calls]
        return dict(exchanges=len(ms), ms=ms, bytes=nbytes, ms_per_moe_layer=sum(ms) / n_moe,
                    bytes_per_moe_layer=sum(nbytes) / n_moe)  # fmt: skip


def _n_moe(cfg) -> int:
    return sum(k.endswith("+moe") for k in cfg.layer_kinds)


def _ep_decode_equal(cfg, params, rules, dev) -> dict:
    """13a's equal-capacity check: EP_EQ_BATCH prompts prefilled, then
    EP_EQ_STEPS greedy decode steps, on the capacity path and on the
    expert-parallel one; every logit and token must be bitwise equal."""
    import torch

    from repro_torch.models import model_caches
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.context import activation_rules
    from repro_torch.train import make_decode_step, make_prefill_step

    ev, kv = cfg.n_experts * cfg.moe_virtual_split, cfg.top_k * cfg.moe_virtual_split
    dense_cap = int(EP_EQ_BATCH * kv / ev * cfg.capacity_factor) + 1
    if dense_cap < 4:
        raise AssertionError(f"phase 13a {cfg.name}: a decode step's capacity {dense_cap} < 4")
    batch = _lm_batch(cfg, EP_EQ_BATCH, EP_EQ_PROMPT, 0, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    seen = {}
    for mode in ("dense", "ep"):
        with activation_rules(rules if mode == "ep" else None):
            logits, pcaches = prefill(params, batch)
            caches = model_caches(cfg, EP_EQ_BATCH, EP_EQ_PROMPT + EP_EQ_STEPS, device=dev)
            caches = tree_map(_lm_pad, pcaches, caches)
            out = [logits]
            tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)
            for i in range(EP_EQ_STEPS):
                step = {"token": tok[:, None], "cache_len": EP_EQ_PROMPT + i}
                tok, logits, caches = decode(params, step, caches)
                out += [logits, tok]
        seen[mode] = out
        del caches, pcaches
    bitwise = all(torch.equal(a, b) for a, b in zip(seen["dense"], seen["ep"]))
    return dict(batch=EP_EQ_BATCH, prompt=EP_EQ_PROMPT, steps=EP_EQ_STEPS,
                decode_capacity=dense_cap, bitwise=bitwise)  # fmt: skip


def _ep_world1(arch, dev, mesh) -> dict:
    """13a for one arch: phase 11b's serving on the capacity path and with
    the expert-parallel rules on a (1, 1) NCCL mesh, the same weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_caches, model_init
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.context import activation_rules
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = _cut(get_config(arch), MOE_SERVE_SEGMENTS[arch])
    rules = _ep_rules(mesh)
    params = model_init(0, cfg, device=dev)
    out = {}
    for mode, floor in (("dense", 0), ("ep", 4)):
        with activation_rules(rules if mode == "ep" else None):
            out[mode] = _serve_lm(cfg, dev, tag="lm-ep", phase=f"13a {mode}", prompt=LM_PROMPT,
                                  bounds=_moe_bounds(cfg, floor), describe=_moe_describe(cfg),
                                  params=params, keep=True)  # fmt: skip
    dense, ep = out["dense"], out["ep"]
    out["prefill_bitwise"] = torch.equal(dense.pop("logits"), ep.pop("logits"))
    same = (dense.pop("seqs") == ep.pop("seqs")).all(0).tolist()
    out["decode_tokens_equal"] = same
    out["first_step_differing"] = same.index(False) if False in same else None
    # the exchanges of one prefill call and one decode step (CUDA events)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    batch = _lm_batch(cfg, LM_BATCH, LM_PROMPT, 0, dev)
    with activation_rules(rules):
        with _Exchanges(events=True) as ex:
            logits, pcaches = prefill(params, batch)
        out["exchange_prefill"] = ex.summary(_n_moe(cfg))
        caches = tree_map(_lm_pad, pcaches, model_caches(cfg, LM_BATCH, LM_PROMPT + 1, device=dev))
        tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)[:, None]
        with _Exchanges(events=True) as ex:
            decode(params, {"token": tok, "cache_len": LM_PROMPT}, caches)
        out["exchange_decode"] = ex.summary(_n_moe(cfg))
    # where a decode step's host time goes on each path (cProfile)
    for mode in ("dense", "ep"):
        with activation_rules(rules if mode == "ep" else None):
            us, top = host_cost(lambda: decode(params, {"token": tok, "cache_len": LM_PROMPT},
                                               caches), profile=True, calls=3)  # fmt: skip
        out[f"host_decode_{mode}"] = dict(us=us, top=top[:8])
    del logits, pcaches, caches
    out["equal_capacity"] = _ep_decode_equal(cfg, params, rules, dev)
    del params
    torch.cuda.empty_cache()
    return out


def _keep_expert_rows(tree, lo: int, hi: int):
    """``tree`` with every stacked expert weight ([groups, E_v, ...]) cut to
    rows ``lo:hi`` (a copy, so the whole stack can be freed)."""
    if isinstance(tree, dict):
        return {k: ({n: w[:, lo:hi].clone() for n, w in v.items()} if k == "experts"
                    else _keep_expert_rows(v, lo, hi)) for k, v in tree.items()}  # fmt: skip
    if isinstance(tree, list):
        return [_keep_expert_rows(v, lo, hi) for v in tree]
    return tree


def _ep_load(cfg, rank: int, dev, reference=None):
    """13b: the ranks make the whole model in turn (``model_init`` draws
    whole expert stacks: deepseek's cut peaks at 42.9 GB), each keeping only
    its experts' rows and freeing the rest before the next starts; a rank
    parks its part in host memory while the others make theirs, then all
    bring theirs back.  ``reference(params)`` runs on the whole model
    first.  Returns (params, reference's result, peak bytes, free bytes
    on the card before this rank's turn)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import model_init
    from repro_torch.models.common import tree_map

    epr = cfg.n_experts * cfg.moe_virtual_split // EP_RANKS
    params = ref = None
    for turn in range(EP_RANKS):
        if turn == rank:
            free = torch.cuda.mem_get_info()[0]
            torch.cuda.reset_peak_memory_stats()
            whole = model_init(0, cfg, device=dev)
            ref = reference(whole) if reference else None
            params = _keep_expert_rows(whole, rank * epr, (rank + 1) * epr)
            del whole
            params = tree_map(lambda t: t.cpu(), params)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        dist.barrier()
    params = tree_map(lambda t: t.to(dev), params)
    torch.cuda.synchronize()
    dist.barrier()
    return params, ref, peak, free


def ep_child(rank: int, tmp: str) -> int:
    """One rank of phase 13b: joins the gloo group, then (i) the float32
    check and (ii) serving for each MoE arch; writes its figures."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.models import model_caches, model_forward
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.context import activation_rules
    from repro_torch.train import make_decode_step, make_prefill_step

    tmp = Path(tmp)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rdzv_ep'}", rank=rank,
                            world_size=EP_RANKS, timeout=datetime.timedelta(seconds=EP_TIMEOUT))
    out = {"rank": rank}
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    try:
        mesh = init_device_mesh("cpu", (1, EP_RANKS), mesh_dim_names=("data", "model"))
        rules = _ep_rules(mesh)
        for arch in MOE_ARCHS:
            res = out[arch] = {}
            base = get_config(arch)
            ev = base.n_experts * base.moe_virtual_split
            # (i) float32, nothing dropped: rank 0's logits against the
            # world-1 capacity path's on the whole model
            cfg = _cut(base, MOE_EQ_SEGMENTS[arch], dtype=torch.float32, capacity_factor=float(ev))
            batch = _lm_batch(cfg, LM_EQ_BATCH, MOE_EQ_SEQ, 0, dev)

            def dense(whole):
                with torch.no_grad(), _Routes() as routes:
                    return model_forward(whole, batch, cfg)[0], routes.calls

            t0 = time.perf_counter()
            params, ref, res["check_init_peak"], res["check_free_before_init"] = _ep_load(
                cfg, rank, dev, dense if rank == 0 else None)
            res["check_load_s"] = time.perf_counter() - t0
            with torch.no_grad(), activation_rules(rules), _Routes() as routes:
                logits = model_forward(params, batch, cfg)[0]
            if rank == 0:
                want, want_ids = ref
                sl = MOE_EQ_SEQ // EP_RANKS  # rank 0's positions: 0 .. sl-1 of each prompt
                mine = [i.reshape(LM_EQ_BATCH, MOE_EQ_SEQ, -1)[:, :sl].reshape(-1, i.shape[1])
                        for i in want_ids]  # fmt: skip
                res["check"] = dict(
                    _lm_logits_gap(logits, want, LM_CPU_TOL), capacity_factor=float(ev),
                    topk_differ=sum(int((a != b).any(-1).sum()) for a, b in zip(routes.calls, mine)),
                    routed_tokens=sum(int(i.shape[0]) for i in routes.calls),
                )  # fmt: skip
                del want, ref
            del params, logits
            torch.cuda.empty_cache()
            dist.barrier()

            # (ii) serving: bf16 at the published capacity factor
            cfg = _cut(base, MOE_SERVE_SEGMENTS[arch])
            t0 = time.perf_counter()
            params, _, res["init_peak"], res["free_before_init"] = _ep_load(cfg, rank, dev)
            res["load_s"] = time.perf_counter() - t0
            t_serve = time.perf_counter()
            res["weight_bytes"] = _nbytes(params)
            torch.cuda.reset_peak_memory_stats()
            batch = _lm_batch(cfg, LM_BATCH, LM_PROMPT, 0, dev)
            prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
            with activation_rules(rules):
                with _Routes() as routes:  # the first call also sets up cuBLAS
                    prefill(params, batch)
                res["dropped_prefill"] = [_dropped(ids, cfg, 4) for ids in routes.calls]
                res["assignments_prefill"] = sum(i.numel() for i in routes.calls)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _Exchanges(events=False) as ex:
                    logits, pcaches = prefill(params, batch)
                torch.cuda.synchronize()
                res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                res["exchange_prefill"] = ex.summary(_n_moe(cfg))
                caches = model_caches(cfg, LM_BATCH, LM_PROMPT + EP_DECODE_STEPS, device=dev)
                caches = tree_map(_lm_pad, pcaches, caches)
                del pcaches
                tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)
                step_ms = []
                for i in range(EP_DECODE_STEPS):
                    step = {"token": tok[:, None], "cache_len": LM_PROMPT + i}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with (_Exchanges(events=False) if i == 0 else contextlib.nullcontext()) as ex, \
                            (_Routes() if i == 0 else contextlib.nullcontext()) as routes:
                        tok, step_logits, caches = decode(params, step, caches)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    if i == 0:
                        res["exchange_decode"] = ex.summary(_n_moe(cfg))
                        res["dropped_decode_step1"] = [_dropped(ids, cfg, 4) for ids in routes.calls]
            later = sorted(step_ms[1:])
            res.update(serve_s=time.perf_counter() - t_serve, decode_ms_first=step_ms[0],
                       decode_ms_median=later[len(later) // 2],
                       decode_steps=EP_DECODE_STEPS, peak=torch.cuda.max_memory_allocated(),
                       finite=bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all()),
                       in_vocab=bool(((tok >= 0) & (tok < cfg.vocab_size)).all()))  # fmt: skip
            del params, caches, logits, step_logits
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    out.update(launches=fused_advance_pair.launches, bucket_hist_launches=bucket_hist_kernel.launches)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"rank {rank} loaded {leaked}")
    (tmp / f"ep_rank{rank}.json").write_text(json.dumps(out))
    return 0


def phase_lm_ep(dev, src: str):
    """Phase 13: the expert-parallel MoE dispatch (13a NCCL at world 1 on
    the card, 13b EP_RANKS gloo ranks sharing it)."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        tmp = Path(tmp)
        dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdzv'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=EP_TIMEOUT))
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            torch.cuda.synchronize()
            fused_advance_pair.launches = 0
            bucket_hist_kernel.launches = 0
            out["13a"] = {arch: _ep_world1(arch, dev, mesh) for arch in MOE_ARCHS}
            out["13a"]["launches"] = fused_advance_pair.launches
            out["13a"]["bucket_hist_launches"] = bucket_hist_kernel.launches
        finally:
            dist.destroy_process_group()
        for arch in MOE_ARCHS:
            a = out["13a"][arch]
            for mode in ("dense", "ep"):
                log(f"[lm-ep] 13a {arch} {mode}: prefill {a[mode]['prefill_ms']:.3f} ms (bound "
                    f"{a[mode]['prefill_bound_ms']:.3f}), decode median "
                    f"{a[mode]['decode_ms_median']:.3f} ms (bound {a[mode]['decode_bound_ms']:.4f}; "
                    f"routed only {a[mode]['decode_routed_bound_ms']:.4f}); kernels per call "
                    f"{a[mode]['device_busy']['prefill']['kernels']:.0f} / "
                    f"{a[mode]['device_busy']['decode']['kernels']:.0f}; dropped "
                    f"{a[mode]['dropped_prefill']} / {a[mode]['dropped_decode_step1']}")  # fmt: skip
            for mode in ("dense", "ep"):
                h = a[f"host_decode_{mode}"]
                log(f"[lm-ep] 13a {arch} {mode} decode step on the host: {h['us'] / 1e3:.3f} ms "
                    f"(least of three loops of 3); cProfile top by own time (us per step) "
                    f"{json.dumps([[n, round(t, 1)] for n, t in h['top']])}")  # fmt: skip
            for key in ("exchange_prefill", "exchange_decode"):
                e = a[key]
                log(f"[lm-ep] 13a {arch} {key}: {e['exchanges']} all_to_all, "
                    f"{e['ms_per_moe_layer']:.4f} ms and {e['bytes_per_moe_layer']:,.0f} "
                    f"send-buffer bytes per MoE layer (CUDA events); each "
                    f"{[round(m, 4) for m in e['ms']]} ms")  # fmt: skip
            log(f"[lm-ep] 13a {arch}: prefill logits bitwise {a['prefill_bitwise']}; decode "
                f"tokens equal at {sum(a['decode_tokens_equal'])} of {LM_NEW} steps (first "
                f"differing {a['first_step_differing']}); equal capacity "
                f"{json.dumps(a['equal_capacity'])}")  # fmt: skip
            if not a["prefill_bitwise"] or not a["equal_capacity"]["bitwise"]:
                raise AssertionError(f"phase 13a {arch}: the expert-parallel path at world 1 "
                                     f"differs from the capacity path")  # fmt: skip
        torch.cuda.empty_cache()
        log(f"[lm-ep] 13b: free on the card before the ranks start "
            f"{torch.cuda.mem_get_info()[0]:,} bytes (this process reserves "
            f"{torch.cuda.memory_reserved():,})")  # fmt: skip

        # 13b: EP_RANKS gloo ranks, each a process on this card
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(EP_RANKS):
                with open(tmp / f"ep_rank{r}.log", "w") as logf:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--src", src,
                         "--ep-child", str(r), str(tmp)],
                        stdout=logf, stderr=subprocess.STDOUT,
                        # four processes share the card: no segment is held half used
                        env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
                    ))  # fmt: skip
            deadline = time.perf_counter() + EP_TIMEOUT
            for p in procs:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 13b: a rank ran past {EP_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = {r: (tmp / f"ep_rank{r}.log").read_text()[-3000:] for r in failed}
            raise AssertionError(f"phase 13b: ranks {failed} failed: {tails}")
        ranks = [json.loads((tmp / f"ep_rank{r}.json").read_text()) for r in range(EP_RANKS)]
    out["13b"] = dict(ranks=ranks, wall_s=time.perf_counter() - t0,
                      launches=sum(r["launches"] for r in ranks),
                      bucket_hist_launches=sum(r["bucket_hist_launches"] for r in ranks))
    for arch in MOE_ARCHS:
        check = ranks[0][arch]["check"]
        log(f"[lm-ep] 13b(i) {arch} float32, capacity_factor {check['capacity_factor']}: rank 0 "
            f"vs the world-1 capacity path {json.dumps(check)}")  # fmt: skip
        if not check["ok"] or check["topk_differ"]:
            raise AssertionError(f"phase 13b(i) {arch}: {check}")
        dense = out["13a"][arch]["dense"]
        for r in ranks:
            a = r[arch]
            log(f"[lm-ep] 13b(ii) {arch} rank {r['rank']}: prefill {a['prefill_ms']:.1f} ms, "
                f"decode first {a['decode_ms_first']:.1f} ms, median {a['decode_ms_median']:.1f} "
                f"ms ({EP_DECODE_STEPS} steps); all_to_all per MoE layer (send buffers, "
                f"{EP_RANKS - 1}/{EP_RANKS} of them to other ranks): prefill "
                f"{a['exchange_prefill']['ms_per_moe_layer'] / 1e3:.4f} s and "
                f"{a['exchange_prefill']['bytes_per_moe_layer']:,.0f} bytes, decode "
                f"{a['exchange_decode']['ms_per_moe_layer'] / 1e3:.4f} s and "
                f"{a['exchange_decode']['bytes_per_moe_layer']:,.0f} bytes; dropped at prefill "
                f"{a['dropped_prefill']} of {a['assignments_prefill']:,}; peaks: check init "
                f"{a['check_init_peak']:,}, init {a['init_peak']:,}, serving {a['peak']:,} bytes "
                f"({a['weight_bytes']:,} weight bytes held; free on the card before its turns "
                f"{a['check_free_before_init']:,} and {a['free_before_init']:,}); seconds: "
                f"loads {a['check_load_s']:.1f} and {a['load_s']:.1f}, serving "
                f"{a['serve_s']:.1f}")  # fmt: skip
            if not (a["finite"] and a["in_vocab"]):
                raise AssertionError(f"phase 13b(ii) {arch} rank {r['rank']}: {a}")
        # prefill: each rank routes its quarter of the positions; decode
        # (one position): every rank routes the same LM_BATCH tokens
        drops = [sum(x) for x in zip(*(r[arch]["dropped_prefill"] for r in ranks))]
        drops1 = ranks[0][arch]["dropped_decode_step1"]
        log(f"[lm-ep] 13b(ii) {arch} dropped assignments per MoE layer: prefill, summed over "
            f"the ranks, {drops} (world-1 capacity path {dense['dropped_prefill']}); first "
            f"decode step, where every rank routes the same {LM_BATCH} tokens, {drops1} "
            f"(world-1 {dense['dropped_decode_step1']})")  # fmt: skip
        out["13b"][arch] = dict(dropped_prefill=drops, dropped_decode_step1=drops1)
    log(f"[lm-ep] card: {card_line()}")
    log(f"[lm-ep] phase 13: {time.perf_counter() - t_phase:.1f}s; 13b {EP_RANKS} ranks "
        f"{out['13b']['wall_s']:.1f}s; kernel launches: 13a {out['13a']['launches']} / "
        f"{out['13a']['bucket_hist_launches']}, 13b {out['13b']['launches']} / "
        f"{out['13b']['bucket_hist_launches']}")  # fmt: skip
    return out


def dist_child(rank: int, tmp: str) -> int:
    """One rank of phase 10b: joins the gloo group, runs its block of the
    DIST_VERTICES graph through the kernel and writes the global arrays."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rdzv_b'}", rank=rank,
                            world_size=DIST_RANKS, timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        mesh = init_device_mesh("cpu", (1, DIST_RANKS), mesh_dim_names=("data", "model"))
        bg, task = _dist_case(DIST_VERTICES, DIST_RANKS)
        res, info, _ = _dist_run(bg, task, mesh, torch.device("cuda"))
    finally:
        dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"rank {rank} loaded {leaked}")
    np.savez(tmp / f"rank{rank}.npz", **{k: res[k] for k in ("prev", "cur", "hop", "alive")})
    (tmp / f"rank{rank}.json").write_text(json.dumps(info))
    return 0


def _measured(run):
    """``run()`` on the card: its result, the peak of what it allocated
    beyond what was allocated before it, and its FLOPs (``FlopCounterMode``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        result = run()
    torch.cuda.synchronize()
    return result, torch.cuda.max_memory_allocated() - before, counter.get_total_flops()


def phase_dryrun(dev):
    """Phase 14: the multi-pod dry run (14a its estimate against the real
    step on the card; 14b full-width cells on the fake (16, 16) mesh)."""
    import dataclasses
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.bucket_hist import bucket_hist_kernel
    from repro_torch.kernels.pair_advance import fused_advance_pair
    from repro_torch.launch import dryrun
    from repro_torch.models import model_init
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import make_prefill_step, make_train_step

    t_phase = time.perf_counter()
    card = card_line()
    memory_total = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    log(f"[dryrun] the card's memory: {memory_total} | {card}")
    cfg = get_config(LM_ARCH)
    specs = {"prefill": ShapeSpec("7b prefill", LM_PROMPT, LM_BATCH, "prefill"),
             "train": ShapeSpec("8b train", TRAIN_SEQ, TRAIN_BATCH, "train")}  # fmt: skip
    out = {"14a": {}, "14b": {}, "memory_total": memory_total}
    # 14a: the estimate on a (1, 1) mesh, then the same steps for real
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{Path(tmp) / 'rdzv'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT))
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            estimates = {kind: dryrun._estimate(cfg, spec, mesh, device_type="cuda")
                         for kind, spec in specs.items()}  # fmt: skip
        finally:
            dist.destroy_process_group()
    fused_advance_pair.launches = 0
    bucket_hist_kernel.launches = 0
    params = model_init(0, cfg, device=dev)
    batch = {k: v.to(torch.int32) for k, v in _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev).items()}
    prompt = {"tokens": batch["tokens"][:LM_BATCH, :LM_PROMPT]}
    (logits, caches), peak, flops = _measured(lambda: make_prefill_step(cfg)(params, prompt))
    measured = {"prefill": (peak, flops, bool(torch.isfinite(logits.float()).all()))}
    del logits, caches
    state = adamw_init(params)
    step = make_train_step(cfg, OptConfig(), microbatches=cfg.train_microbatches)
    (params, state, metrics), peak, flops = _measured(lambda: step(params, state, batch))
    measured["train"] = (peak, flops, bool(torch.isfinite(metrics["loss"]).all()))
    out["14a"]["launches"] = fused_advance_pair.launches
    out["14a"]["bucket_hist_launches"] = bucket_hist_kernel.launches
    del params, state, metrics
    torch.cuda.empty_cache()
    for kind, est in estimates.items():
        peak, flops, finite = measured[kind]
        row = dict(
            shape=dataclasses.asdict(specs[kind]), microbatches=est.get("microbatches"),
            predicted_peak=est["bytes_per_device"]["temp"], measured_peak=peak,
            peak_gap=abs(peak - est["bytes_per_device"]["temp"]) / peak,
            predicted_flops=est["cost_analysis"]["flops"], counted_flops=flops,
            flops_gap=abs(flops - est["cost_analysis"]["flops"]) / flops,
            arguments=est["bytes_per_device"]["arguments"], trace_s=est["trace_s"],
            finite=finite, card=card,
        )  # fmt: skip
        out["14a"][kind] = row
        log(f"[dryrun] 14a {cfg.name} {kind} {LM_BATCH} x {LM_PROMPT}: peak predicted "
            f"{row['predicted_peak']:,} B, measured {peak:,} B (gap {row['peak_gap']:.4f}); "
            f"FLOPs predicted {row['predicted_flops']:,}, counted {flops:,} (gap "
            f"{row['flops_gap']:.6f}); estimate traced in {est['trace_s']} s | {card}")  # fmt: skip
        if row["peak_gap"] > DRYRUN_PEAK_TOL or row["flops_gap"] > DRYRUN_FLOPS_TOL or not finite:
            raise AssertionError(f"phase 14a {kind}: estimate off the card's step: {row}")
    # 14b: full-width cells on the fake (16, 16) mesh
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, device_type="cuda")
        out["14b"][f"{arch}|{shape}"] = rec
        log(f"[dryrun] 14b {json.dumps(rec)}")
        if not rec["ok"]:
            raise AssertionError(f"phase 14b: {arch} {shape} failed: {rec}")
    if dist.is_initialized():
        dist.destroy_process_group()
    ep = out["14b"]["deepseek-v2-236b|decode_32k"]["collectives"]["all-to-all"]
    if not ep:
        raise AssertionError("phase 14b: deepseek-v2-236b decode_32k counted no all-to-all")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 14 in {out['phase_s']:.1f}s")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="phases 1-3b only")
    ap.add_argument("--hist-sweep", action="store_true",
                    help="phases 1-2, then every bucket_hist plan of the sweep")  # fmt: skip
    ap.add_argument("--src", default=str(ROOT), help="checkout whose src/ holds the port")
    ap.add_argument("--out", default="kernels",
                    help="--kernels-only, --hist-sweep: the rows' file, OUT.json")  # fmt: skip
    ap.add_argument("--dist-child", nargs=2, metavar=("RANK", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument("--ep-child", nargs=2, metavar=("RANK", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU fallback", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    if args.dist_child:
        return dist_child(int(args.dist_child[0]), args.dist_child[1])
    if args.ep_child:
        return ep_child(int(args.ep_child[0]), args.ep_child[1])
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    elapsed = lambda: time.perf_counter() - t_start
    dev = torch.device("cuda")
    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")  # fmt: skip

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel libraries in {build_s:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    if args.hist_sweep:
        OUT.mkdir(exist_ok=True)
        (OUT / f"{args.out}.json").write_text(json.dumps(dict(
            card=card, src=args.src, build_s=build_s, sweep=phase_hist_sweep(dev),
            total_s=elapsed(),
        ), indent=1))  # fmt: skip
        log(f"[done] {elapsed():.1f}s")
        return 0
    rows = phase_kernels(dev)
    hist = phase_hist(dev)
    if args.kernels_only:
        OUT.mkdir(exist_ok=True)
        (OUT / f"{args.out}.json").write_text(json.dumps(dict(
            card=card, src=args.src, build_s=build_s, variants=rows, bucket_hist=hist,
            total_s=elapsed(),
        ), indent=1))  # fmt: skip
        log(f"[done] {elapsed():.1f}s")
        return 0
    tier = phase_tier(dev)
    whole = phase_whole_run(dev)
    engines = phase_other_engines(dev)
    phases = {}
    # the launcher's main path, held to the oracle, then its other default
    # engine, then PB and SGSC, all at full size and held to that oracle
    main_infos, oracle_counts = phase_main(["biblock", "oracle"])
    phases["biblock+oracle"] = main_infos
    phases["sogw"], _ = phase_main(["sogw"], oracle_counts=oracle_counts)
    phases["pb+sgsc"], _ = phase_main(["pb", "sgsc"], oracle_counts=oracle_counts)
    if elapsed() < 420:
        phases["biblock disk"], _ = phase_main(
            ["biblock"], extra=["--graph-backend", "disk", "--pool", "disk"]
        )
    serving = phase_serve(dev)
    lm = phase_lm(dev)
    lm_train = phase_lm_train(dev)
    harness = phase_harness(dev)
    distributed = phase_distributed(dev, oracle_counts, args.src)
    lm_moe = phase_lm_moe(dev)
    lm_rec = phase_lm_recurrent(dev)
    lm_ep = phase_lm_ep(dev, args.src)
    dryrun = phase_dryrun(dev)
    lm_dense = phase_lm_dense(dev)
    # ``launches`` counts the main paths only: the walk launcher, the
    # full-size hot-set server, LM serving and LM training (which run
    # neither kernel), the train launcher (its corpus's advances), the
    # distributed engine at full size (10a), MoE / MLA serving (11b), SSD /
    # RG-LRU / encoder-decoder serving (12b), expert-parallel MoE serving
    # (13a), the dry run's real steps (14a) and the last four dense configs
    # (15b), neither kernel; the LRU
    # server, the launcher at its small defaults and the 4-rank gloo runs
    # (10b, 13b) are listed beside them in ``launches_by_path``
    def by_path(key):
        main = {"walk biblock+oracle": main_infos[0][key], "serve hot-set": serving["6b"]["hot"][key],
                "lm serve": lm["7b"][key], "lm train": lm_train["8b"][key],
                "lm train launcher": harness["9b"][key],
                "distributed": distributed["10a"]["cuda"][key],
                "lm serve moe/mla": lm_moe["11b"][key],
                "lm serve ssm/rglru/encdec": lm_rec["12b"][key],
                "lm serve moe ep": lm_ep["13a"][key],
                "lm dry-run check": dryrun["14a"][key],
                "lm serve qwen/internvl/phi3/yi": lm_dense["15b"][key]}  # fmt: skip
        other = {"serve lru": serving["6b"]["lru"][key], "serve launcher": serving["6c"][key],
                 f"distributed {DIST_RANKS} ranks (gloo)": distributed["10b"][key],
                 f"moe ep {EP_RANKS} ranks (gloo)": lm_ep["13b"][key]}  # fmt: skip
        return sum(main.values()), {**main, **other}

    pair_launches, pair_by_path = by_path("launches")
    hist_launches, hist_by_path = by_path("bucket_hist_launches")

    head = next(r for r in rows if (r["case"], r["order"], r["has_alias"], r["record"])
                == ("pair", 2, False, False))  # fmt: skip
    hist16 = next(r for r in hist if r["num_buckets"] == 16)
    kernels = [dict(
        name="pair_advance", route="cuda", source="src/repro_torch/kernels/csrc/pair_advance.cu",
        replaces="src/repro/kernels/pair_advance.py:74",
        launches=pair_launches, launches_by_path=pair_by_path,
        max_abs_err=max([r["max_abs_err"] for r in rows]
                        + [distributed["10a"]["kernel_check"]["max_abs_err"]]),
        ms=head["kernel_ms"],
        kernel_ms=head["kernel_ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by="bytes", library_ms=None,
    ), dict(
        name="bucket_hist", route="cuda", source="src/repro_torch/kernels/csrc/bucket_hist.cu",
        replaces="src/repro/kernels/bucket_hist.py:26",
        launches=hist_launches, launches_by_path=hist_by_path,
        max_abs_err=max(r["max_abs_err"] for r in hist), ms=hist16["kernel_ms"],
        kernel_ms=hist16["kernel_ms"], plain_ms=hist16["plain_ms"], bound_ms=hist16["bound_ms"],
        bound_by="bytes", library_ms=hist16["library_ms"],
        library_call="torch.bincount(ids drawn in range, weights=valid.float(), minlength=NB): "
        "no range filter, no int cast",
    )]  # fmt: skip
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, variants=rows, bucket_hist=hist, kernel_tier=tier,
        whole_run=whole, other_engines=engines, main_runs=phases, serve=serving, lm=lm,
        lm_train=lm_train, lm_harness=harness, distributed=distributed, lm_moe=lm_moe,
        lm_recurrent=lm_rec, lm_ep=lm_ep, dryrun=dryrun, lm_dense=lm_dense, total_s=elapsed(),
    ), indent=1))  # fmt: skip
    log(f"[done] {elapsed():.1f}s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
