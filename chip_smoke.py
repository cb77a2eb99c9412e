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
   alias tables), then PB, SOGW, SGSC and ``InMemoryWalker``, each with
   ``advance_impl="cuda"`` against ``"torch"`` on a 20k-vertex graph:
   endpoint counts, corpus, steps and deterministic I/O charges must be
   identical, and every engine must equal the oracle;
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
   ``advance_impl="cuda"`` against ``"torch"``: equal answers and
   deterministic charges; (6b) on the main path's graph, 2,048 PPR queries
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

import json
import math
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
    """Phase 4: whole bi-block runs, kernel against plain version: the
    unweighted graph, then a weighted one (alias proposals)."""
    from repro_torch.core import rwnv_task
    from repro_torch.engines import BiBlockEngine
    from repro_torch.kernels.pair_advance import fused_advance_pair

    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=1, length=10, seed=5)
    legs = {}
    for leg, weighted in (("plain", False), ("weighted", True)):
        bg = _whole_graph(weighted)
        out = {}
        for impl in ("cuda", "torch"):
            before = fused_advance_pair.launches
            t0 = time.perf_counter()
            res = BiBlockEngine(bg, task, record_walks=True, advance_impl=impl, device=dev).run()
            launched = fused_advance_pair.launches - before
            out[impl] = (res, time.perf_counter() - t0, launched)
            log(f"[whole] {leg} {impl}: {out[impl][1]:.2f}s, steps {res.steps_sampled}, "
                f"advance calls {res.advance_calls}, kernel launches {launched}")  # fmt: skip
        (rc, _, lc), (rt, _, lt) = out["cuda"], out["torch"]
        if _sig(rc) != _sig(rt):
            raise AssertionError(f"whole run ({leg}): cuda and torch signatures differ")
        if lc != rc.advance_calls or lc == 0 or lt != 0:
            raise AssertionError(
                f"whole run ({leg}): launches {lc}/{lt} vs advance calls {rc.advance_calls}"
            )
        if rc.endpoint_counts.sum() != rc.num_walks or (rc.corpus[:, 0] < 0).any():
            raise AssertionError(f"whole run ({leg}): walks unaccounted for")
        legs[leg] = dict(seconds_cuda=out["cuda"][1], seconds_torch=out["torch"][1],
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
    """Phase 4b: whole PB, SOGW, SGSC and oracle runs, kernel against plain
    version, and every engine against the oracle."""
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
        for impl in ("cuda", "torch"):
            before = fused_advance_pair.launches
            t0 = time.perf_counter()
            res = make(dict(advance_impl=impl, device=dev)).run()
            runs[impl] = (res, time.perf_counter() - t0, fused_advance_pair.launches - before)
        (rc, sc, lc), (rt, st, lt) = runs["cuda"], runs["torch"]
        log(f"[engines] {name}: cuda {sc:.2f}s / torch {st:.2f}s, steps {rc.steps_sampled}, "
            f"advance calls {rc.advance_calls}, kernel launches {lc}, vertex_ios "
            f"{rc.stats.vertex_ios}")  # fmt: skip
        if _sig(rc) != _sig(rt) or rc.stats.vertex_ios != rt.stats.vertex_ios:
            raise AssertionError(f"{name}: cuda and torch signatures differ")
        if lc != rc.advance_calls or lc == 0 or lt != 0:
            raise AssertionError(f"{name}: launches {lc}/{lt} vs advance calls {rc.advance_calls}")
        oracle = rc if name == "oracle" else oracle
        same_counts = (rc.endpoint_counts == oracle.endpoint_counts).all()
        if not same_counts or (rc.corpus != oracle.corpus).any():
            raise AssertionError(f"{name}: walks differ from the oracle's")
        out[name] = dict(seconds_cuda=sc, seconds_torch=st, steps=rc.steps_sampled,
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
        steps=s.steps_sampled, **{k: kw[k] for k in ("hot_blocks", "advance_impl") if k in kw},
    )  # fmt: skip
    if kw.get("advance_impl", "cuda") == "cuda":
        if launches == 0 or launches != server.advance_calls:
            raise AssertionError(f"server: {launches} launches for {server.advance_calls} advances")
    elif launches != 0:
        raise AssertionError(f"server on the plain version launched the kernel {launches} times")
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
    """Phase 6: the query server on the card (6a kernel against plain
    version, 6b the main path's graph, hot set against LRU and served
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
    # 6a: kernel against plain version, both on the card
    bg = _whole_graph()
    sources = mix(bg, 256)
    runs = {impl: _serve(bg, sources, config, max_batch=64, hot_blocks=2, device=dev,
                         advance_impl=impl) for impl in ("cuda", "torch")}  # fmt: skip
    (sc, ac, ic), (st, at, it) = runs["cuda"], runs["torch"]
    log(f"[serve] 6a cuda {json.dumps(ic)}")
    log(f"[serve] 6a torch {json.dumps(it)}")
    if not _same_answers(ac, at):
        raise AssertionError("6a: cuda and torch servers answer differently")
    if _charges(sc.stats) != _charges(st.stats) or sc.advance_calls != st.advance_calls:
        raise AssertionError("6a: cuda and torch servers charge differently")
    out["6a"] = dict(cuda=ic, torch=it)

    # 6b: the main path's graph, hot set against pure LRU
    t0 = time.perf_counter()
    g = erdos_renyi(VERTICES, VERTICES * AVG_DEGREE // 2, seed=0)
    bg = partition_into_n_blocks(g, BLOCKS)
    log(f"[serve] 6b graph built in {time.perf_counter() - t0:.1f}s: {bg.describe()}")
    sources = mix(bg, SERVE_QUERIES)
    kw = dict(max_batch=SERVE_BATCH, device=dev, advance_impl="cuda")
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
            bg, config.task(hot.batch_seed(k)), device=dev, advance_impl="cuda",
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
        # kernel and through the plain advance: equal, bit for bit
        def corpus_run(impl):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = erdos_renyi(args.graph_vertices, args.graph_vertices * 8, seed=0)
            res = BiBlockEngine(
                partition_into_n_blocks(g, 6), rwnv_task(walks_per_vertex=2, length=32),
                record_walks=True, device=dev, advance_impl=impl,
            ).run()  # fmt: skip
            corpus = WalkCorpus.from_walks(res.corpus, g.num_vertices)
            torch.cuda.synchronize()
            return corpus, res.corpus, time.perf_counter() - t0

        before = fused_advance_pair.launches
        corpus, walks_cuda, corpus_s = corpus_run("cuda")
        compare_launches = fused_advance_pair.launches - before
        _, walks_plain, plain_s = corpus_run("torch")
        corpus_equal = walks_cuda.shape == walks_plain.shape and bool((walks_cuda == walks_plain).all())
        log(f"[lm-harness] 9b the launcher's corpus ({args.graph_vertices:,} vertices, 6 blocks, "
            f"2 walks of 32 steps per vertex): {walks_cuda.shape[0]:,} walks; the kernel "
            f"{corpus_s:.3f} s ({compare_launches} launches), the plain advance {plain_s:.3f} s; "
            f"bitwise equal: {corpus_equal}")  # fmt: skip
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU fallback", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
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
    # ``launches`` counts the main paths only: the walk launcher, the
    # full-size hot-set server, LM serving and LM training (which run
    # neither kernel), and the train launcher (its corpus's advances);
    # the LRU server and the launcher at its small defaults are listed
    # beside them in ``launches_by_path``
    def by_path(key):
        main = {"walk biblock+oracle": main_infos[0][key], "serve hot-set": serving["6b"]["hot"][key],
                "lm serve": lm["7b"][key], "lm train": lm_train["8b"][key],
                "lm train launcher": harness["9b"][key]}  # fmt: skip
        other = {"serve lru": serving["6b"]["lru"][key], "serve launcher": serving["6c"][key]}
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
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["kernel_ms"],
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
        lm_train=lm_train, lm_harness=harness, total_s=elapsed(),
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
