#!/usr/bin/env python3
"""Drives the PyTorch port (`src/repro_torch`) end to end on one CUDA card.

    python3 chip_smoke.py [--seed N] [--stream-mib MiB]

Phases, each of which must pass (any failure exits non-zero and prints no
result):

  1. card      the card's name and power limit, as nvidia-smi reports them;
     build     builds every kernel of csrc/ cold (eight sources), one nvcc
               per source, all started together, and prints the ptxas
               reports; then counts the HGMMA and HMMA instructions of each
               bf16 flash kernel, the decode kernel's split kernel and each
               wkv6 kernel in its SASS
               (cuobjdump) and fails unless the forward's hold wgmma and
               the backward's and both wkv6 kernels' (state and out, every
               head dim) tensor-core instructions, with their registers,
               spills and shared memory a CTA;
  2. kernels   holds rs_matmul bit-exact against its plain PyTorch version
               on the card (encode, decode, delta, ragged and unaligned
               shapes; L = 4, 8, 12 and 16k + 3 at m = s = 11 and at the
               encode, from views 0-3 bytes into a word), then times both
               at the shapes the main path gives the kernel, and the
               kernel's launch floor at L = 16;
  3. flash     holds flash_attention_fwd's out and lse against its plain
               version on the card, in bfloat16 and float32 (MHA, GQA,
               MQA, window, softcap, non-causal, ragged, head_dim 128 and
               256, padded keys, T and S below and around the bf16
               tiles, a group of 32, the serve shape, head_dim 128 in
               groups of 6 and 8), then times the kernel, its plain
               version and PyTorch's scaled_dot_product_attention (the
               library yardstick, used nowhere in the port) at the serve
               shape, at dbrx's and llama-3.2-vision's prefill shapes
               (head_dim 128, 48 and 64 heads over 8) and at phase 12(c)'s
               (2 x 4096 tokens, one head of 256), 12(d)'s (1 x 4096
               tokens, 4 heads over one of 128) and 12(e)'s (1 x 4096
               tokens, 3 heads over one of 128); holds
               flash_attention_bwd's dq, dk and dv against its plain
               version in both types (GQA, MQA, window, ragged,
               head_dim 128 and 256, padded keys, the tile edges, a
               group of 32, the train and serve shapes), then
               times it, its plain version and the backward of
               scaled_dot_product_attention at the serve and train shapes
               and at phase 12(c)'s, 12(d)'s and 12(e)'s;
     decode    holds flash_decode against its plain version (tile and
               split edges, MQA, a group of 16, ragged kv_len, a cache
               viewed through a slice of its kv heads, the benchmark
               cells' shapes and a dbrx-132b decode wave), then times it,
               its plain version and scaled_dot_product_attention with a
               mask at those three shapes beside its bytes bound;
     scans     holds rglru_scan against its plain version (the reference's
               shapes, T = 1, ragged R, the prefill shape (4, 1024, 2560),
               T = 63, 65 and 4096 at R = 2567, a near 1 over 4096 steps,
               ± h0, forward and reverse) to 1e-5 and its backward (the
               kernel reversed) against autograd through the plain version
               to 1e-4; wkv6 against its plain version (the reference's
               shapes, ragged T, head_dim 16 and 128, T = 1, the prefill
               shape (4, 1024, 32, 64), ± s0) to 3e-4 and under strong
               decay (w = 1e-9 everywhere at (1, 64, 1, 32); half the
               channels at w = 1e-12 and half near 1 over seven chunks at
               (1, 200, 2, 64)) against its sequential version to 1e-4;
               then times both scans and their plain versions beside their
               bounds at the prefill (and, for rglru_scan, the decode)
               shape and at a microbatch of the train step (rglru_scan
               forward and reversed at (4, 256, 2560), wkv6 at (4, 256,
               32, 64)) and at phase 12(d)'s local shapes (rglru_scan
               forward and reversed at (2, 4096, 160), wkv6 at (2, 32768,
               2, 64)), rglru_scan's launch floor at (1, 1, 32), wkv6's
               two kernels (state, out) apart and together;
     integrity holds stream_cipher and fletcher bit-exact against their
               plain versions (the reference's test shapes, key 0xC0FFEE
               and nonce 42, ragged u8, float32, bf16 and u8 of 333
               elements, u8 views that start 1, 2 and 3 bytes into a word,
               key and nonce >= 2^32, a 1 GiB buffer, and the cipher's
               involution there), then times both and their plain versions
               at a 1 MiB block, at 1 GiB and at their floor (16 bytes,
               one CTA) beside their bounds, every device operation of a
               call (fails unless a 1 MiB call is one); sweeps fletcher
               from 4 KiB to 16 MiB (fails unless every call is one device
               operation); and times the parts of the wrappers' host call;
  4. ec        the erasure-coded storage path: a 1 GiB stream written to an
               ec(4,2) container on 8 targets in four fault domains with
               inline encryption, read back, one cell overwritten (delta
               parity), a target failed and read degraded, 64 MiB written
               during the outage, the target recovered (rebuild) and the
               stripes parity-scrubbed — every read bit-exact; the card's
               idle share is traced over a 64 MiB window of the degraded
               read and of full-stripe writes;
  4(b). soak  the reference's seeded crash-recovery soak (its ec8 case,
               tests/test_fault_storage.py) on the card, async: a client as
               in phase 4 (n_devices 4) with io_depth 8 and a FaultInjector
               holding a copy of the reference's schedule (seeds 1234 and
               99, plus --seed), a 256 MiB file, 240 ops of 1 B to 2.5 MiB
               (writes, reads, vectored write+read pairs) issued through
               submit_pwritev and submit_preadv, up to 8 in flight over
               pairwise disjoint whole stripes (a partial write's parity
               read-modify-write would race a neighbour's on one stripe);
               the busiest data home failed at op 80 with its map push
               dropped, recovered at op 96; engine.crash, cap.expire and a
               dropped get_pool_map armed. Every read bit-exact against a
               shadow copy, then a sweep of the file, then the whole file
               placed on the card by DeviceDirectSink in 4 MiB tensors,
               each held against the shadow with torch.equal on the card;
               resync, an empty dirty ledger, a parity scrub with no
               mismatch; every recovery class of the reference soak fired;
               rs_matmul's encode, delta and decode launched, from more
               than one host thread; the CQ's in-flight peak at least 4
               and completed = submitted - cancelled; no leaked slot,
               lease, rkey grant or handle; ops/s, MB/s and one traced
               64 MiB async window's idle share printed;
  4(c). examples  examples/torch_smartnic_offload_demo.py and
               examples/torch_quickstart.py run as a user runs them, on
               the card (the demo's tensor placed there, the quickstart's
               loss falling);
  5. direct    the same stream placed into GPU memory by DeviceDirectSink
               as 256 float32 tensors of 4 MiB plus odd-sized tensors at
               misaligned offsets, compared byte for byte on the card; then
               the stream cipher's and the checksum's main path on the
               placed stream: each of its 1,024 blocks of 1 MiB checksummed
               on the card by fletcher and held against the engine's
               media.checksum of the host bytes, and 64 blocks plus one
               partial block (at a byte offset not a multiple of 4)
               ciphered on the card by stream_cipher and held against the
               inline crypto's InlineCrypto.apply at the engine's nonces
               (oid * 2^20 + block, past 2^32);
  6. dpu       the paper's offload configuration (dpu mode, rdma,
               replicated): 64 MiB written, read and placed on the card;
  7. serve     the serving path at full width: granite-3-2b (40 layers,
               d_model 2048, vocab 49155) with attn_impl="flash", params
               from a seed on the card, 8 prompts of 1024 tokens written to
               and read back from the store (dpu mode, rdma), batched
               prefill and decode in waves of 4, up to 32 new tokens each,
               through the engine's compiled steps: prefill and decode
               captured as CUDA graphs in a warm-up wave, then replayed
               (every serve phase below does the same, and times and
               traces one replay of each graph); the same requests then go
               through the engine's eager steps (greedy tokens compared),
               and one wave from the same state through both (logits and
               cache bit for bit, or else within the phase's tolerance);
               one wave's prefill is held against the plain attention path
               on the same params: every layer's attention on its own
               inputs (bf16, 2e-2), the whole model at full width in
               float32 through its first two layers (logits to 1e-3, every
               first greedy token equal), and a small float32 model's loss
               to 1e-4; the decode graph must launch flash_decode once a
               layer (two kernels), and no decode call asking for "flash"
               may take the plain path (the moe phase checks the same);
  8. recurrent the serving path of the sub-quadratic families at full
               width, each with attn_impl="flash" and the granite phase's
               traffic (8 prompts of 1024 tokens from a dpu/RDMA store,
               waves of 4, up to 32 new tokens each): recurrentgemma-2b (26
               layers = 8 x (R, R, A) + 2 R, d_model 2560, MQA 10 x 256,
               window 2048, vocab 256000) through rglru_scan, and
               rwkv6-1.6b (24 layers, d_model 2048, 32 heads of 64, vocab
               65536) through wkv6. The launch count must equal what the
               path implies (18 a prefill wave and 18 a decode step; 24 a
               prefill wave and none in decode), with no flash-attention
               launch; every kernel call of one wave's prefill and decode
               step holds against a plain version on its own inputs
               (rglru_scan's to 1e-5; wkv6 against the sequential
               recurrence to 3e-4, since the chunked plain version is the
               less exact one under the path's decays); the
               whole model at full width in float32 through one
               super-block, or 2 layers, holds against the plain path
               (logits to 1e-3, every first greedy token equal); one
               prefill and four decode steps are traced; then
               launch/serve.py main runs the tiny config through its
               command line;
  9. moe       the serving path of the moe family at full width, the
               depth cut to one card, attn_impl="flash", float32 params
               computing in bf16, the granite phase's traffic (8 prompts
               of 1024 tokens from a dpu/RDMA store, waves of 4, up to 32
               new tokens each): dbrx-132b (4 of 40 layers; 16 experts
               top-4, GQA 48 over 8 heads of 128) and deepseek-v2-236b (3
               of 60; MLA, 2 shared + 160 routed experts top-6). dbrx's
               prefill must launch flash_attention_fwd once a layer a wave
               (head_dim 128, groups of 6), deepseek-v2's MLA never; every
               flash call of a wave's prefill holds against exact (float64)
               attention on its own inputs (bf16, 2e-2); the memory a
               prefill wave takes above the params; each model in float32
               through its first layer (the dispatch in float32 too) holds
               against the plain path (logits to 1e-3, every first greedy
               token equal); one dbrx wave with the float8_e4m3fn dispatch
               (finite logits, loss within 10% of the bf16 dispatch) and
               the cast's NaN-above-464 rule on the card bit for bit the
               CPU's; one prefill and four decode steps traced; then
               launch/serve.py main on their tiny configs;
 10. vlm, encdec  llama-3.2-vision-90b (2 of 20 super-blocks: 8 self
               layers with H=64, KH=8, head_dim 128, and 2 gated cross
               layers; seeded nonzero gates) with 4,096 x 1,280 patch
               embeddings a request, and whisper-tiny whole (1,500 x 384
               frames a request, 384-token decoder prompts), both made on
               the card from the seed, through ModelAPI.prefill and decode
               in BatchedEngine's greedy waves (launch/serve.py serves
               neither family, as the reference's does not). The VLM's
               flash launches must equal 8 a wave, each held against exact
               attention (2e-2), and in float32 through its first self and
               cross layers it holds against the plain path at 1e-3 (its
               first super-block printed); whisper launches no kernel, and
               in float32 through its first encoder and decoder layers the
               card holds against the port's CPU run at 1e-3 (whole,
               printed); both traced;
 11. train     the training path at full width, as launch/train.py main
               walks it: dense-100m (12 layers, d_model 768, vocab 32000)
               with attn_impl="flash", float32 params computing in bf16
               from a seed, a synthetic corpus written to a dpu-mode RDMA
               store and streamed back by the loader (prefetch 2, hedged
               reads), 30 AdamW steps of 8 x 256 tokens in 2 microbatches
               through jit_train_step (the first step captures it, the
               others replay), a checkpoint every 10 steps, a storage
               device killed at step 15 once the checkpoint of step 10 has
               landed; every batch must equal its corpus slice and the
               step-30 checkpoint restore bit for bit; the captured step
               against the eager step from the same state (bit for bit, or
               else within the train tests' tolerances), both timed and
               traced; the step-10 checkpoint restored into the captured
               step's tensors (launch/train.py --resume) and steps 11-15
               held against the uninterrupted run;
               the same model cut to 2 layers in float32 takes one step on
               both attention paths (loss to 1e-4, gradients to atol 2e-4 /
               rtol 2e-3), and cut to 2 layers in bf16 it trains on the
               same 30 batches, where its loss must fall (at 12 layers the
               reference's init keeps the loss flat in 30 steps: printed);
               then launch/train.py main runs 5 steps through its own
               command line;
 12. mesh      the multi-device layer on a one-rank NCCL group (a
               HashStore, no port; no gloo, no fallback) and its (data 1,
               model 1) DeviceMesh: (a) dense-100m at the train phase's
               shape with zero1, params and moments as DTensors, through
               the mesh's jit_train_step, captured and replayed 10 times,
               held bit for bit against the one-device compiled step from
               the same state on the same batches (metrics every step, the
               whole state after the last), both replays timed, the
               capture timed, and a replay of each traced (device
               operations, device-to-device copies, NCCL kernels); (b)
               moe_ffn of one dbrx-132b layer at full width on random
               activations at the prefill wave's 4 x 1024 tokens, with the
               bf16 and the fp8 wire, eagerly and as a captured graph's
               replay, each bit for bit the meshless call, the collectives'
               copies counted in the traces (a one-rank NCCL collective is
               a device-to-device copy, not a kernel). GPipe needs two
               stages: the phase says so and has no check of it. Then
               13(b) below; (c) rank 0 of the production 16 x 16 mesh
               over torch's fake process group (whose collectives move
               nothing, so values are not the model's: gloo ranks hold
               them on the CPU) with real tensors on the card: gemma-7b's
               eager train step at train_4k, 8 microbatches of 2 x 4096
               tokens, params, moments and inputs made as this rank's
               shards (heads, mlp columns and vocab over 16 model ranks):
               max_memory_allocated (under 80 GB) beside the dry-run's
               peak for the cell (a process of its own, started before
               the serve phase), the step's seconds, its flash launches,
               every call at head_dim 256 with one head, and one forward
               and one backward call at that shape held against their
               plain versions; (d) the same for the other families, each
               computing on its local shards: recurrentgemma-2b's train
               step at train_4k whole (8 microbatches of 2 x 4096
               tokens; rglru_scan forward and reversed at its 160 local
               channels, no flash launch), rwkv6-1.6b's prefill at
               prefill_32k whole (2 x 32768 tokens; wkv6 at its 2 local
               heads, one call a layer) and llama-3.2-vision-90b's train
               step at train_4k cut to 10 layers (16 microbatches of 1 x
               4096 tokens and 4,096 patch embeddings; flash at 4 q heads
               over one kv head of 128): max_memory_allocated beside the
               dry-run's peak for the cell at that depth, the step's
               seconds, the launches and every call's shape, then each
               kernel at its local shape held against its plain version;
               (e) the same for the moe family's train step at train_4k,
               at the moe phase's depths (16 microbatches of 1 x 4096
               tokens): dbrx-132b at 4 of 40 layers (its expert a rank,
               flash at 3 q heads over one kv head of 128: 128 forward
               launches, the forward and remat's recompute, and 64
               backward, each kernel held against its plain version
               there) and deepseek-v2-236b at 3 of 60 (10 experts a
               rank; MLA, no flash launch); the loss printed, not held
               (the fake all-to-all leaves its receive buffers as they
               were); then 12(c)'s gemma-7b rank again with
               remat_policy="save_collectives", its peak and step beside
               the first run's and beside its dry-run variant save-coll
               (over fake collectives only the memory means anything);
     families  training the hybrid, ssm and encdec families, in the
               train phase's style and traffic: (a) recurrentgemma-2b and
               rwkv6-1.6b whole at full width (attn_impl="flash", float32
               params computing in bf16, a dpu/RDMA store and its loader,
               batch 8 of 256 tokens in 2 microbatches, remat): an eager
               step from the seed's state with every rglru_scan call
               (forward and reversed) or wkv6 call held against its
               plain version on its own inputs (1e-5, reversed of the
               same scan of |a| and |b|, since the gradients it scans
               cancel; 3e-4 against the sequential recurrence), the
               state after it kept on the host; the compiled
               step's first call (its eager warm-up and the capture) and,
               from the same state again, step 1 replayed, bit for bit
               the eager step (loss, grad norm, every param and moment);
               then 9 more replays from the store; the wrapper's launches
               in the warm-up and the graph's scan kernels (traced
               replays) equal what the path implies (each recurrent layer
               twice forward, the forward and remat's recompute, and for
               rglru_scan once reversed, a microbatch at a time: 72 + 36
               a step for the hybrid's 18 recurrent layers of 26, 96 wkv6
               calls for rwkv6's 24), peak memory, capture time, replay
               time, tokens/s, a traced replay's busy time, idle share
               and kernels, and rwkv6's wkv6_backward op's share of it;
               (b) both cut to 2 layers at full width: 30 compiled steps
               with a checkpoint every 10 and the storage drill at step
               15, the loss falling, the step-10 checkpoint restored into
               the step's tensors and steps 11-15 replayed bit for bit;
               (c) whisper-tiny whole (1,500 x 384 bf16 frames and 448
               decoder tokens a row) through jit_train_step: the compiled
               step bit for bit the eager step, the loss falling over 30
               steps, timed and traced; (d) launch/train.py main on
               tiny-recurrentgemma-2b and tiny-rwkv6-1.6b through its
               command line (5 steps, a checkpoint, the drill);
 13. dryrun    the dry-run (launch/dryrun.py) and the roofline
               (roofline/analytic.py) against the steps they model:
               (a) dense-100m's train step (8 x 256, 2 microbatches) and
               granite-3-2b's prefill wave (4 x 1024) and decode step
               (batch 4), each traced by the dry-run (FakeTensorMode, fake
               CUDA tensors, the kernels through their ops' fake
               implementations) and run once eagerly on the card under the
               same counters (roofline/collectives.py): the FLOPs and the
               collectives of each kind must be equal; the dry-run's peak
               bytes printed beside torch.cuda.max_memory_allocated() over
               the real step; (b) in the mesh phase, the one-rank NCCL
               mesh's train step recorded on the card against its dry-run
               on a one-rank fake mesh (a process of its own): collectives
               of each kind and FLOPs equal; (c) granite-3-2b x decode_32k
               and x prefill_32k on the 16 x 16 mesh of 256 fake ranks in a
               process of its own, started first, with their trace
               seconds; (d) every serve configuration's prefill wave and
               decode step and the compiled train steps (dense-100m's,
               and the families phase's): mfu =
               model_flops_per_step(cfg as run, shape as run) / (measured
               s x the bf16 peak), the analytic roofline at MeshPlan(1, 1),
               measured over it and its dominant term, with the card's name
               and power limit.

Each kernel's launch counts are zeroed just before the path that drives it
(rs_matmul: the ec phase, and again the soak's ops; stream_cipher and fletcher: the step on the
placed stream; flash_attention_fwd: each of the granite, dbrx and VLM
serve phases and the mesh phase's steps (a), (c) and (d), and its
launches are their sum; rglru_scan and wkv6: their serve phases, their
train paths in the families phase and the mesh phase's step (d);
flash_attention_bwd: the train phase and the mesh phase's steps;
flash_decode: the granite and moe serve phases, its wrapper counting a
captured call too) and read just after it. A wrapper counts the launches it makes itself; a call captured into a
CUDA graph launches nothing, and each replay of the graph launches what
the capture recorded, so on the compiled paths a kernel's launches are
the wrapper's count plus its kernels in each graph (from traced
replays) times the graph's replays in the run. The line before the last
is a JSON object of the kernels (launches, error, times, bound); the last
line is the result object.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
MiB = 1 << 20
DOMAINS = ["a", "a", "b", "b", "c", "c", "d", "d"]
TRACE_ATTEMPTS = 5              # timing windows traced before giving up


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def traced(fn) -> tuple:
    """torch.profiler's record of one call of `fn` on the card, and the
    call's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def kernel_device_ms(fn, iters: int, kernel: str, per_call: int = 1) -> float:
    """Mean device time per call of `fn` of the CUDA kernels whose names
    hold `kernel` (`per_call` launches a call), from a torch.profiler trace
    of `iters` calls that recorded every launch. The profiler loses a kernel's record now and then (on an H100:
    19 of 20 in most windows once other threads have launched kernels,
    whatever the idle time around the window), so a window that recorded
    fewer launches is traced again, up to TRACE_ATTEMPTS times."""
    def calls() -> None:
        for _ in range(iters):
            fn()
    fn()
    seen = []
    for _ in range(TRACE_ATTEMPTS):
        events, _ = traced(calls)
        us = n = 0
        for ev in events:
            if kernel in ev.key:
                us += ev.device_time_total
                n += ev.count
        if n == iters * per_call:
            return us / 1e3 / iters
        seen.append(n)
    raise AssertionError(f"profiler saw {seen} launches of {kernel} in "
                         f"windows of {iters} calls")


MEMSET = "Memset ("             # a memset's device record, as traced


def device_ops_ms(fn, iters: int, names: tuple) -> tuple:
    """(mean device time per call of `fn`, that time by operation, device
    operations a call) over the device operations (kernels, memsets) whose
    names hold one of `names`, from a torch.profiler trace of `iters`
    calls. A window whose count is not a whole number of operations a call
    lost a record and is traced again, up to TRACE_ATTEMPTS times."""
    def calls() -> None:
        for _ in range(iters):
            fn()
    fn()
    seen = []
    for _ in range(TRACE_ATTEMPTS):
        events, _ = traced(calls)
        by_op: dict = {}
        n = 0
        for ev in events:
            if ev.device_time_total > 0 and any(s in ev.key for s in names):
                by_op[ev.key] = (by_op.get(ev.key, 0.0)
                                 + ev.device_time_total / 1e3 / iters)
                n += ev.count
        if n and n % iters == 0:
            return sum(by_op.values()), by_op, n // iters
        seen.append((n, sorted(by_op)))
    raise AssertionError(f"profiler saw {seen} operations of {names} in "
                         f"windows of {iters} calls")


KERNEL_KINDS = (  # substring of a CUDA kernel's name -> what it does
    ("flash_decode_", "flash decode"), ("flash_fwd_kernel", "flash fwd"),
    ("flash_bwd_", "flash bwd"),
    ("rglru_scan_", "rglru scan"), ("wkv6_kernel", "wkv scan"),
    ("stream_cipher_kernel", "cipher"), ("fletcher_kernel", "checksum"),
    ("rs_matmul", "parity"), ("nvjet", "matmul"), ("gemm", "matmul"),
    ("gemv", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
    ("direct_copy", "cast/copy"), ("Memcpy", "cast/copy"),
    ("Memset", "fill"), ("elementwise", "optimizer/elementwise"))


def device_breakdown(fn) -> dict:
    """Host wall time of `fn`, the card's busy time in it and that busy
    time by kind of kernel (torch.profiler; one stream, no overlap)."""
    import torch
    events, wall = traced(fn)
    kinds: dict = {}
    counts: dict = {}
    for ev in events:
        us = ev.self_device_time_total
        if us <= 0:
            continue
        kind = next((k for s, k in KERNEL_KINDS if s in ev.key), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e6
        counts[kind] = counts.get(kind, 0) + ev.count
    busy = sum(kinds.values())
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "device_s_by_kind": kinds,
            "device_ops": sum(counts.values()), "device_ops_by_kind": counts}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def in_tolerance(got, want, tol: float) -> tuple:
    """(max abs error, whether |got - want| <= tol + tol * |want| holds
    everywhere: numpy's assert_allclose with atol = rtol = tol)."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), bool(torch.all(err <= tol + tol * want.abs()))


# -- build: every kernel of csrc/, one nvcc per source, all at once ----------
def build_phase() -> dict:
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import kernel_bwd as FKB
    from repro_torch.kernels.flash_attention import kernel_decode as FKD
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rs_parity import kernel as RK
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.fletcher import kernel as FLK
    from repro_torch.kernels.stream_cipher import kernel as SCK

    def timed(build) -> float:
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"rs_parity": RK.build, "flash_attention_fwd": FK.build,
              "flash_attention_bwd": FKB.build,
              "flash_decode": FKD.build, "rglru_scan": RGK.build,
              "wkv6": WK.build, "stream_cipher": SCK.build,
              "fletcher": FLK.build}
    with ThreadPoolExecutor(max_workers=len(builds),
                            thread_name_prefix="nvcc") as ex:
        futs = {name: ex.submit(timed, b) for name, b in builds.items()}
        secs = {name: fut.result() for name, fut in futs.items()}
    secs["all"] = time.perf_counter() - t0
    for name in builds:
        print(f"{name} built in {secs[name]:.3f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print("  ptxas:", line.strip())
    return secs


# -- build, continued: the bf16 flash kernels run on the tensor cores -------
TC_KERNELS = {  # library -> (name of its tensor-core kernels, SASS opcodes,
    #                count): bf16 flash kernels, the wkv6 kernels in 3xTF32
    "flash_attention_fwd": ("flash_fwd_kernel_tc", ("HGMMA",), 3),
    "flash_attention_bwd": ("_kernel_tc", ("HMMA", "HGMMA"), 6),
    "flash_decode": ("flash_decode_split_kernel", ("HMMA",), 2),
    "wkv6": ("wkv6_kernel", ("HMMA", "HGMMA"), 8)}


def tensor_core_phase() -> dict:
    """For each tensor-core kernel (the bf16 flash kernels, one per head
    dim, two for the backward; the decode kernel's split kernel (mma.sync),
    one per head dim; wkv6's state and out kernels, one per head
    dim): the count of HGMMA and HMMA instructions in its SASS (`cuobjdump
    -sass`), its registers and spill bytes (ptxas's report of the build
    phase) and its dynamic shared memory a CTA (the library's own query).
    Fails unless every such kernel holds a tensor-core instruction of its
    design (wgmma for the flash forward)."""
    import ctypes
    import os
    import re
    import shutil
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import kernel_bwd as FKB
    from repro_torch.kernels.flash_attention import kernel_decode as FKD
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    kernels: dict = {}
    for lib_name, mod in (("flash_attention_fwd", FK),
                          ("flash_attention_bwd", FKB),
                          ("flash_decode", FKD), ("wkv6", WK)):
        lib = mod._lib()
        res = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                             text=True, timeout=300, check=True)
        funcs: dict = {}
        name = None
        for line in res.stdout.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                name = found.group(1)
                funcs[name] = {"HGMMA": 0, "HMMA": 0}
            elif name is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        funcs[name][op] += 1
        name = None
        for line in _build.build_logs.get(lib_name, "").splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            elif name in funcs and "spill stores" in line:
                funcs[name]["spill_bytes"] = sum(
                    int(n) for n in re.findall(r"(\d+) bytes spill", line))
            elif name in funcs and "Used" in line:
                funcs[name]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
        tag, ops, want = TC_KERNELS[lib_name]
        query = getattr(lib, lib_name + "_smem")
        query.restype = ctypes.c_int
        tc = {f: c for f, c in funcs.items() if tag in f}
        for f, c in tc.items():
            d = int(re.search(r"ILi(\d+)E", f).group(1))    # head dim
            c["smem_bytes"] = (
                query(d) if lib_name in ("flash_attention_fwd",
                                         "flash_decode")
                else query(d, int("dkv" in f)) if lib_name ==
                "flash_attention_bwd" else query(d, int("_out" in f)))
            check(sum(c[op] for op in ops) > 0,
                  f"{lib_name}: tensor-core kernel {f} has no "
                  f"{'/'.join(ops)}")
        for f, c in sorted(funcs.items()):
            print(f"  sass {lib_name}: {f}: {json.dumps(c)}")
        check(len(tc) == want, f"{lib_name}: {len(tc)} tensor-core kernels, "
              f"not {want}")
        kernels[lib_name] = tc
    return kernels


# -- phase 2: the kernel against its plain version ----------------------------
def kernel_phase(seed: int) -> dict:
    import torch
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.kernels.rs_parity import kernel as K
    from repro_torch.kernels.rs_parity import ref

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    worst = 0
    n_checks = 0

    def rows(s: int, n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 256, (s, n), np.uint8)).to(dev)

    def hold(mat: np.ndarray, x: torch.Tensor, what: str,
             oracle: bool = False) -> torch.Tensor:
        nonlocal worst, n_checks
        got = K.rs_matmul(mat, x)
        want = ref.gf_matmul_torch(mat, x)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        n_checks += 1
        check(torch.equal(got, want), f"rs_matmul != plain version: {what}")
        if oracle:
            check(np.array_equal(got.cpu().numpy(), ref.gf_matmul_np(
                mat, x.cpu().numpy())), f"rs_matmul != numpy oracle: {what}")
        return got

    L = 262144                               # ec(4,2) cell of a 1 MiB stripe
    data = rows(4, L)
    parity = hold(ref.cauchy_matrix(4, 2), data, "ec(4,2) encode",
                  oracle=True)
    hold(ref.cauchy_matrix(8, 3), rows(8, 131072), "ec(8,3) encode",
         oracle=True)
    stripe = torch.cat([data, parity])
    for lost in itertools.combinations(range(6), 2):
        present = [i for i in range(6) if i not in lost][:4]
        missing = [i for i in lost if i < 4]
        if not missing:
            continue
        mat = ref.decode_matrix(4, 2, present, missing)
        dec = hold(mat, stripe[present].contiguous(), f"decode lost {lost}")
        check(torch.equal(dec, data[missing]), f"decode of {lost} is wrong")
    for idx in ([1], [0, 2], [1, 2, 3]):
        mat = np.ascontiguousarray(ref.cauchy_matrix(4, 2)[:, idx])
        hold(mat, rows(len(idx), L), f"delta over cells {idx}")
    for n in (1, 15, 4097):
        hold(ref.cauchy_matrix(4, 2), rows(4, n), f"ragged L={n}", oracle=True)
    flat = torch.empty(1 + 4 * 4097, dtype=torch.uint8, device=dev)
    flat.copy_(torch.from_numpy(rng.integers(0, 256, flat.numel(), np.uint8)))
    unaligned = flat[1:].view(4, 4097)
    check(unaligned.data_ptr() % 16 != 0, "unaligned view is aligned")
    hold(ref.cauchy_matrix(4, 2), unaligned, "unaligned start, L=4097",
         oracle=True)
    # the nibble-table kernel's edges: whole and ragged words (one word a
    # thread), 121 coefficients, views that start 1-3 bytes into a word
    big = rng.integers(0, 256, (11, 11), np.uint8)
    for n in (4, 8, 12, 16 * 64 + 3, 16 * 16384 + 3):
        for mat in (big, ref.cauchy_matrix(4, 2)):
            s = mat.shape[1]
            flat = rows(1, 3 + s * n)[0]
            for start in (0, 1, 2, 3):
                hold(mat, flat[start:start + s * n].view(s, n),
                     f"m={mat.shape[0]} s={s} L={n} at byte {start}",
                     oracle=True)
    print(f"rs_matmul bit-exact with its plain version in {n_checks} checks")

    # times at the main path's shapes: a 1 MiB stripe's encode (4 -> 2
    # rows), a one-cell overwrite's delta (1 -> 2), a degraded read's
    # decode of one lost data cell (4 -> 1); L2-warm, as on the path.
    # `ms` is the kernel's device time (profiler); `call_ms` the wrapper's
    # time per call back to back (CUDA events), launch overhead included
    legs = {}
    for leg, mat in (("encode", ref.cauchy_matrix(4, 2)),
                     ("delta", np.ascontiguousarray(
                         ref.cauchy_matrix(4, 2)[:, [1]])),
                     ("decode", ref.decode_matrix(4, 2, [0, 1, 3, 4], [2]))):
        m, s = mat.shape
        x = rows(s, L)
        ms = kernel_device_ms(lambda: K.rs_matmul(mat, x), 100,
                              K.KERNEL_NAME)
        call_ms = cuda_ms(lambda: K.rs_matmul(mat, x), 200)
        plain_ms = cuda_ms(lambda: ref.gf_matmul_torch(mat, x), 10)
        bound_ms = (s + m) * L / HBM_BW * 1e3
        legs[leg] = {"m": m, "s": s, "L": L, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms}
        print(f"rs_matmul {leg} (m={m}, s={s}, L={L}): kernel {ms:.6f} ms "
              f"on the device, {call_ms:.6f} ms a call, plain "
              f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms")
    # the launch floor: the encode at L = 16, one CTA of four live threads
    mat, x = ref.cauchy_matrix(4, 2), rows(4, 16)
    floor_ms = kernel_device_ms(lambda: K.rs_matmul(mat, x), 100,
                                K.KERNEL_NAME)
    floor_call_ms = cuda_ms(lambda: K.rs_matmul(mat, x), 200)
    print(f"rs_matmul launch floor (m=2, s=4, L=16): kernel {floor_ms:.6f} "
          f"ms on the device, {floor_call_ms:.6f} ms a call; the encode "
          f"leg is {legs['encode']['ms'] - floor_ms:.6f} ms above it, its "
          f"bound {legs['encode']['bound_ms']:.6f} ms")
    return {"max_abs_err": worst, "legs": legs, "floor_ms": floor_ms,
            "floor_call_ms": floor_call_ms}


# -- phase 4: the erasure-coded storage path ---------------------------------
def _dirty_cells(client, n_cells: int) -> int:
    """Cells marked in the fleet's dirty-cell ledgers (their union)."""
    from repro_torch.core.object_store import EC_DIRTY_AKEY
    union = {}
    for cont in client.ccontainer._per_target.values():
        for oid, obj in list(cont._objects.items()):
            for dk in obj.dkeys(EC_DIRTY_AKEY):
                marks = obj.fetch(dk, EC_DIRTY_AKEY, 0, n_cells)
                union.setdefault((oid, dk), set()).update(
                    i for i, b in enumerate(marks) if b)
    return sum(len(v) for v in union.values())


def _read_equal(client, fd: int, expect, chunk: int = 64 * MiB) -> bool:
    for off in range(0, len(expect), chunk):
        n = min(chunk, len(expect) - off)
        if client.pread(fd, n, off) != expect[off:off + n]:
            return False
    return True


def ec_phase(client, size: int, seed: int, times: dict) -> bytearray:
    k, p, cs = client.io._ec
    expect = bytearray(np.random.default_rng(seed).bytes(size))
    fd = client.open("/stream", create=True)
    t0 = time.perf_counter()
    for off in range(0, size, 16 * MiB):
        client.pwrite(fd, bytes(expect[off:off + 16 * MiB]), off)
    client.io.data_path_counters()              # joins parity stragglers
    times["ec_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "readback differs")
    times["ec_read_s"] = time.perf_counter() - t0

    off = 5 * MiB + cs                           # data cell 1 of block 5
    new = np.random.default_rng(seed + 1).bytes(cs)
    client.pwrite(fd, new, off)
    expect[off:off + cs] = new
    ec = client.io.data_path_counters()["ec"]
    check(ec["delta_writes"] >= 1, f"no delta write: {ec}")

    client.cluster.fail_target(2)
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "degraded read differs")
    times["ec_degraded_read_s"] = time.perf_counter() - t0
    ec = client.io.data_path_counters()["ec"]
    check(ec["reconstructions"] > 0, f"no reconstruction: {ec}")
    # the card's idle share over a 64 MiB window of the degraded read
    window = bytes(expect[:64 * MiB])
    trace = device_breakdown(lambda: check(
        client.pread(fd, len(window), 0) == window, "traced read differs"))
    times["trace_degraded_read_64MiB"] = trace
    print("degraded read, 64 MiB traced:", trace)

    t0 = time.perf_counter()
    outage = 64 * MiB
    out = np.random.default_rng(seed + 2).bytes(outage)
    base = size // 2
    for o in range(0, outage, 16 * MiB):
        client.pwrite(fd, out[o:o + 16 * MiB], base + o)
    expect[base:base + outage] = out
    client.io.data_path_counters()
    marked = _dirty_cells(client, k + p)
    times["ec_outage_write_s"] = time.perf_counter() - t0
    rebuilt0 = client.io.data_path_counters()["ec"]["rebuilt_cells"]
    t0 = time.perf_counter()
    client.cluster.recover_target(2)
    times["ec_rebuild_s"] = time.perf_counter() - t0
    rebuilt = client.io.data_path_counters()["ec"]["rebuilt_cells"] - rebuilt0
    print(f"outage write marked {marked} cells, rebuild regenerated {rebuilt}")
    check(marked > 0 and rebuilt == marked, "rebuilt != marked cells")
    check(_dirty_cells(client, k + p) == 0, "ledger not clean after rebuild")
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "post-rebuild read differs")
    times["ec_post_rebuild_read_s"] = time.perf_counter() - t0
    # and over a 64 MiB window of full-stripe writes (the same bytes again)
    window = bytes(expect[:64 * MiB])

    def rewrite() -> None:
        for o in range(0, len(window), 16 * MiB):
            client.pwrite(fd, window[o:o + 16 * MiB], o)
        client.io.data_path_counters()          # joins parity stragglers

    trace = device_breakdown(rewrite)
    times["trace_write_64MiB"] = trace
    print("write, 64 MiB traced:", trace)

    t0 = time.perf_counter()
    scrub = client.scrubber.scrub_parity((k + p) * cs * (size // MiB))
    times["ec_scrub_s"] = time.perf_counter() - t0
    print("scrub_parity:", scrub)
    check(scrub["parity_checks"] == size // MiB, f"scrub missed: {scrub}")
    check(scrub["parity_mismatches"] == 0, f"scrub mismatches: {scrub}")
    print("ec counters:", client.io.data_path_counters()["ec"])
    client.close_fd(fd)
    return expect


# -- phase 4(b): the async ec(4,2) soak ----------------------------------------
SOAK_SPAN = 256 * MiB       # the reference's ec8 soak (16 MiB) scaled up
SOAK_OPS = 240              # the reference's op count
SOAK_DEPTH = 8              # io_depth: handles in flight at once
SOAK_SEEDS = (1234, 99)     # the reference's injector and op seeds


def soak_schedule(Fault) -> list:
    """The reference soak's fault schedule (tests/test_fault_storage.py
    SOAK_SCHEDULE), copied: modulo rules whose retry never re-fires on the
    next match, at every layer boundary of the rdma path."""
    return [
        ("transport.write_sg", Fault("error"), lambda m: m % 23 == 5),
        ("transport.read_sg", Fault("error"), lambda m: m % 17 == 4),
        ("transport.read_sg", Fault("partial"), lambda m: m % 31 == 9),
        ("transport.place_sg", Fault("partial"), lambda m: m % 19 == 6),
        ("media.write", Fault("error",
                              exc=lambda: IOError("injected media write")),
         lambda m: m % 97 == 13),
        ("media.read", Fault("error",
                             exc=lambda: IOError("injected media read")),
         lambda m: m % 61 == 9),
    ]


def _assert_rings_whole(client) -> None:
    """Nothing leaked: once writebacks land every donated lease has
    dropped, every staging slot is back on its free list, no rkey grant
    outlived its op, and no completion handle is pending."""
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        for t in client.cluster.targets:
            for d in t.store.devices:
                if d.alive:
                    d.writeback()
        if all(not s.ring.donated_slots()
               for s in client.io.sessions.values()):
            break
        time.sleep(0.005)
    for s in client.io.sessions.values():
        check(not s.ring.donated_slots(), "donated slot leases leaked")
        with s.ring._cv:
            check(sorted(s.ring._free) == list(range(s.ring.n_slots)),
                  "staging ring free list not whole")
        check(not s._dst_rkeys, "dst rkey cache entries leaked")
        check(s.cq.inflight() == 0, "a session's handle is pending")
    check(not client.client_registry._rkeys, "client rkey grant leaked")
    check(client.io.cq.inflight() == 0, "a router handle is pending")


class _SoakWindow:
    """Up to `depth` async ops in flight, over pairwise disjoint ranges of
    whole 1 MiB stripes (a partial write read-modify-writes its stripe's
    parity, so two in flight on one stripe would race there, in the
    reference as in the port), so the shadow copy stays exact: a write
    updates the shadow when it is submitted, a read is checked against the
    shadow as it stood then. A vectored pair's read is submitted when its
    write is reaped, over the same still-reserved range."""

    def __init__(self, client, fd: int, shadow: bytearray, depth: int,
                 block: int):
        self.c, self.fd, self.shadow = client, fd, shadow
        self.depth, self.block = depth, block
        self.live: list = []        # (handle, kind, off, n, blocks, extra)
        self.reaped = {"write": 0, "read": 0, "pair": 0, "bytes": 0}

    def _blocks(self, off: int, n: int) -> range:
        return range(off // self.block, (off + n - 1) // self.block + 1)

    def _reap(self, entry) -> None:
        self.live.remove(entry)
        h, kind, off, n, blocks, extra = entry
        got = h.wait()
        self.reaped["bytes"] += n
        if kind == "read":
            check(b"".join(got) == extra, f"soak read at {off}+{n} differs")
            self.reaped["read"] += 1
            return
        check(got == n, f"soak write at {off}+{n} returned {got}")
        self.reaped["write"] += 1
        if kind == "pair":                  # the pair's read, same range
            cut, data = extra
            h2 = self.c.submit_preadv(self.fd, [cut, n - cut], off)
            self.live.append((h2, "read", off, n, blocks, data))
            self.reaped["pair"] += 1

    def _room(self, blocks: range) -> None:
        while True:          # a reaped pair's read reserves its range again
            near = [e for e in self.live if e[4].start < blocks.stop
                    and blocks.start < e[4].stop]
            if not near:
                break
            self._reap(near[0])
        while len(self.live) >= self.depth:
            self._reap(self.live[0])

    def write(self, off: int, data: bytes, cut: Optional[int] = None):
        blocks = self._blocks(off, len(data))
        self._room(blocks)
        bufs = [data] if cut is None else [data[:cut], data[cut:]]
        h = self.c.submit_pwritev(self.fd, bufs, off)
        self.shadow[off:off + len(data)] = data
        self.live.append((h, "write" if cut is None else "pair", off,
                          len(data), blocks, None if cut is None
                          else (cut, data)))

    def read(self, off: int, n: int) -> None:
        blocks = self._blocks(off, n)
        self._room(blocks)
        cut = max(1, n // 3)
        h = self.c.submit_preadv(self.fd, [cut, n - cut], off)
        self.live.append((h, "read", off, n, blocks,
                          bytes(self.shadow[off:off + n])))

    def drain(self) -> None:
        while self.live:
            self._reap(self.live[0])


def _soak_ops(win: _SoakWindow, rng, n_ops: int, span: int, block: int,
              outage: tuple) -> None:
    """The reference soak's op stream at `span` (lengths 1 B to 2.5
    blocks; writes, reads and vectored pairs), through the async window;
    the target `outage[2]` failed at op `outage[0]` with its map push
    dropped and recovered at op `outage[1]`."""
    fail_at, recover_at, vic, inj, Fault, cluster = outage
    for i in range(n_ops):
        if i == fail_at:
            win.drain()
            inj.arm("map.push", Fault("drop"), 1)
            cluster.fail_target(vic)
        elif i == recover_at:
            win.drain()
            cluster.recover_target(vic)
        off = int(rng.integers(0, span - 1))
        ln = int(rng.integers(1, min(int(2.5 * block), span - off) + 1))
        kind = int(rng.integers(0, 4))
        if kind == 2:
            win.read(off, ln)
        else:
            data = rng.bytes(ln)
            win.write(off, data, max(1, ln // 3) if kind == 3 else None)
    win.drain()


def soak_phase(seed: int, times: dict, device: str = "cuda",
               span: int = SOAK_SPAN, n_ops: int = SOAK_OPS) -> dict:
    """Phase 4(b): the reference's seeded crash-recovery soak (its ec8
    variant) at `span`, async, on a client whose parity kernel runs on
    `device`."""
    import torch
    from repro_torch.core import ROS2Client
    from repro_torch.core.device_direct import DeviceDirectSink
    from repro_torch.core.dfs import BLOCK
    from repro_torch.core.faults import Fault, FaultInjector
    from repro_torch.kernels.rs_parity import ops

    inj = FaultInjector(schedule=soak_schedule(Fault),
                        seed=SOAK_SEEDS[0] + seed)
    c = ROS2Client(mode="host", transport="rdma", n_targets=8,
                   domains=DOMAINS, ec=(4, 2), n_devices=4, replication=3,
                   write_quorum=2, inline_encryption=True,
                   io_depth=SOAK_DEPTH, scrub_interval_s=None,
                   fault_injector=inj, device=device)
    out: dict = {}
    try:
        k, p, cs = c.io._ec
        fd = c.open("/soak", create=True)
        shadow = bytearray(span)
        t0 = time.perf_counter()
        for off in range(0, span, 16 * MiB):
            c.pwrite(fd, bytes(16 * MiB), off)      # materialize the file
        out["materialize_s"] = time.perf_counter() - t0
        print(f"soak: {span // MiB} MiB materialized in "
              f"{out['materialize_s']:.3f} s")
        # the busiest data home: at 8 targets a fixed victim may home
        # only parity (the reference soak picks it the same way)
        oid = sorted({o for cont in c.ccontainer._per_target.values()
                      for o in cont._objects})[0]
        homes = {}
        for b in range(span // BLOCK):
            for tid in c.io._ec_order(oid, b)[:k]:
                homes[tid] = homes.get(tid, 0) + 1
        vic = max(sorted(homes), key=homes.get)
        # must-fire singles armed after bring-up, as the reference does
        inj.arm("engine.crash", Fault("crash"), 4)
        inj.arm("cap.expire", Fault("expire"), 3)
        inj.arm("control.rpc.get_pool_map", Fault("drop"), 1)
        ops.reset_launches()
        win = _SoakWindow(c, fd, shadow, SOAK_DEPTH, BLOCK)
        rng = np.random.default_rng(SOAK_SEEDS[1] + seed)
        t0 = time.perf_counter()
        _soak_ops(win, rng, n_ops, span, BLOCK,
                  (n_ops // 3, n_ops // 3 + 16, vic, inj, Fault, c.cluster))
        wall = time.perf_counter() - t0
        out["soak"] = {"ops": n_ops, "wall_s": wall, **win.reaped,
                       "ops_per_s": n_ops / wall,
                       "MB_per_s": win.reaped["bytes"] / wall / 1e6,
                       "victim": vic}
        print(f"soak: {n_ops} async ops over {span // MiB} MiB in "
              f"{wall:.3f} s: {n_ops / wall:.3f} ops/s, "
              f"{win.reaped['bytes'] / wall / 1e6:.3f} MB/s, "
              f"{win.reaped}; target {vic} failed at op {n_ops // 3}, "
              f"recovered at op {n_ops // 3 + 16}")
        t0 = time.perf_counter()
        check(_read_equal(c, fd, shadow), "soak sweep differs")
        out["sweep_s"] = time.perf_counter() - t0
        print(f"soak sweep: {span // MiB} MiB bit-exact against the shadow "
              f"in {out['sweep_s']:.3f} s")

        # the whole span placed into the card's memory, held there
        t0 = time.perf_counter()
        tb = 4 * MiB
        reqs = [(fd, i * tb, (tb,), np.uint8) for i in range(span // tb)]
        want = torch.frombuffer(shadow, dtype=torch.uint8).to(device)
        with DeviceDirectSink(c, slot_bytes=64 * MiB, n_slots=4) as sink:
            got = sink.read_tensors(reqs)
        same = [torch.equal(t, want[i * tb:(i + 1) * tb])
                for i, t in enumerate(got)]
        check(all(t.device.type == torch.device(device).type for t in got),
              "a placed tensor is off the card")
        check(all(same), f"placed tensors differ: {same.count(False)}")
        del got, want
        out["placed_s"] = time.perf_counter() - t0
        print(f"soak placed: {len(reqs)} tensors of 4 MiB, the whole "
              f"{span // MiB} MiB in the card's memory, equal on the card "
              f"(torch.equal), in {out['placed_s']:.3f} s")

        # a cell write that failed marks its cell dirty; resync rebuilds
        # every marked cell (the reference soak drains them the same way),
        # and the scrub skips no stripe after it
        t0 = time.perf_counter()
        marked = _dirty_cells(c, k + p)
        c.cluster.resync()
        dirty = _dirty_cells(c, k + p)
        check(dirty == 0, f"{dirty} dirty cells left after the soak")
        out["resync_s"] = time.perf_counter() - t0
        # the schedule keeps firing: a stripe whose cell read faults is
        # skipped for the next cycle, so cycle on (the cursor rotates)
        # until the checks cover the span's stripes
        t0 = time.perf_counter()
        scrub = {"parity_checks": 0, "parity_mismatches": 0, "cycles": 0}
        while scrub["parity_checks"] < span // BLOCK and scrub["cycles"] < 4:
            left = span // BLOCK - scrub["parity_checks"]
            one = c.scrubber.scrub_parity((k + p) * cs * left)
            scrub["parity_checks"] += one["parity_checks"]
            scrub["parity_mismatches"] += one["parity_mismatches"]
            scrub["cycles"] += 1
        check(scrub["parity_checks"] >= span // BLOCK,
              f"soak scrub missed stripes: {scrub}")
        check(scrub["parity_mismatches"] == 0, f"soak scrub: {scrub}")
        out["scrub_s"] = time.perf_counter() - t0
        out["marked_before_resync"] = marked
        print(f"soak scrub: {scrub['parity_mismatches']} mismatches in "
              f"{scrub['parity_checks']} stripe checks over "
              f"{scrub['cycles']} cycles in {out['scrub_s']:.3f} s; dirty "
              f"ledger {dirty} ({marked} cells marked before the resync, "
              f"{out['resync_s']:.3f} s)")

        f = inj.counters()
        rec = f["recovered"]
        ctr = c.io.data_path_counters()
        for op in ("transport.write_sg", "transport.place_sg", "media.write",
                   "media.read", "engine.crash", "cap.expire",
                   "control.rpc.get_pool_map", "map.push"):
            check(f["injected"].get(op, 0) >= 1, f"{op} never fired")
        for path in ("ec.degraded_read", "ec.rebuilt", "ec.delta_fallback",
                     "transport.retry", "cap.renewed", "control.rpc_retry"):
            check(rec.get(path, 0) >= 1, f"recovery {path} never fired")
        for key in ("degraded_reads", "reconstructions", "rebuilt_cells",
                    "delta_writes", "delta_fallbacks"):
            check(ctr["ec"][key] >= 1, f"ec.{key} is 0: {ctr['ec']}")
        check(ctr["faults"]["total_injected"] == f["total_injected"],
              "injections counted twice")
        print("soak recoveries:", json.dumps(rec, sort_keys=True))
        print("soak injected:", json.dumps(f["injected"], sort_keys=True))
        print("soak ec counters:", json.dumps(ctr["ec"], sort_keys=True))

        cq = c.io.cq.counters()
        check(cq["inflight_peak"] >= SOAK_DEPTH // 2,
              f"no overlap in the async window: {cq}")
        check(cq["completed"] == cq["submitted"] - cq["cancelled"],
              f"cq counters do not settle: {cq}")
        print("soak cq:", json.dumps(cq, sort_keys=True))
        launches, threads = ops.launches(), ops.launch_threads()
        for leg in ("encode", "delta", "decode"):
            check(launches[leg] > 0, f"no rs_matmul {leg} launch in the soak")
        names = set().union(*threads.values())
        check(len(names) > 1, f"rs_matmul launched from one thread: {names}")
        print("soak rs_matmul launches by leg:", launches)
        print(f"soak rs_matmul launch threads ({len(names)}):",
              json.dumps(threads))

        # one traced 64 MiB async window: the card's idle share
        def window() -> None:
            w = _SoakWindow(c, fd, shadow, SOAK_DEPTH, BLOCK)
            for i in range(32):
                off = (i * 2 * BLOCK) % span
                if i % 2:
                    w.read(off, 2 * BLOCK)
                else:
                    w.write(off, bytes(shadow[off:off + 2 * BLOCK]))
            w.drain()
        t0 = time.perf_counter()
        trace = device_breakdown(window)
        out["trace_async_64MiB"] = trace
        out["trace_s"] = time.perf_counter() - t0
        print("soak async window, 64 MiB traced:", trace)
        c.close_fd(fd)
        _assert_rings_whole(c)
        print("soak: no leaked slot, lease, rkey grant or handle")
        out.update(launches=launches, launch_threads=threads, cq=cq,
                   recovered=rec, injected=f["injected"], ec=ctr["ec"],
                   scrub=scrub)
        return out
    finally:
        c.close()


# -- phase 4(c): the port's examples on the card -------------------------------
def examples_phase(times: dict) -> dict:
    """examples/torch_smartnic_offload_demo.py and
    examples/torch_quickstart.py as a user runs them, on the card (their
    default device): the demo's six properties, its tensor placed on the
    card, and the quickstart's loss falling (both assert it)."""
    import contextlib
    import importlib.util
    import io

    out = {}
    for name in ("torch_smartnic_offload_demo", "torch_quickstart"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = mod.main([])
        out[name] = {"wall_s": time.perf_counter() - t0}
        text = buf.getvalue()
        if name == "torch_quickstart":
            out[name]["loss_first_last"] = [got[0], got[-1]]
            check(got[-1] < got[0], f"quickstart loss did not fall: {got}")
        else:
            check("All six properties demonstrated." in text,
                  "the demo did not finish")
            check("  placed on cuda:0" in text, "demo tensor not on the card")
        print(f"example {name}: {out[name]}; its last lines:")
        for line in text.strip().splitlines()[-3:]:
            print("   ", line)
    return out


# -- phase 5/6: device-direct placement ----------------------------------------
def direct_phase(client, path: str, expect, slot_bytes: int,
                 n_slots: int, tensor_bytes: int) -> tuple:
    """Places `path` into GPU memory as tensors of `tensor_bytes` plus
    odd-sized ones and checks every byte; returns (stats, the tensors)."""
    import torch
    from repro_torch.core.device_direct import DeviceDirectSink
    dev = client.device
    src = torch.frombuffer(expect, dtype=torch.uint8).to(dev)
    fd = client.open(path)
    reqs = [(fd, i * tensor_bytes, (tensor_bytes // 4,), np.float32)
            for i in range(len(expect) // tensor_bytes)]
    # odd sizes packed back to back into the last slot: the float32 and
    # int16 starts land at byte offsets (7, 67) that are not multiples of
    # their element size
    reqs += [(fd, 7, (7,), np.uint8), (fd, 3 * MiB + 1, (5, 3), np.float32),
             (fd, 11, (1000,), np.int16), (fd, 4093, (4093,), np.uint8)]
    with DeviceDirectSink(client, slot_bytes=slot_bytes,
                          n_slots=n_slots) as sink:
        t0 = time.perf_counter()
        got = sink.read_tensors(reqs)
        wall = time.perf_counter() - t0
        stats = sink.stats
    for (_fd, off, shape, dt), t in zip(reqs, got):
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        check(t.device.type == dev.type, f"tensor on {t.device}")
        check(tuple(t.shape) == tuple(shape), f"shape {t.shape} != {shape}")
        check(torch.equal(t.reshape(-1).view(torch.uint8),
                          src[off:off + nbytes]),
              f"placed tensor at {off} differs")
    client.close_fd(fd)
    print(f"device-direct {path}: {len(reqs)} tensors, {stats}, "
          f"{stats.bytes / wall / 1e9:.3f} GB/s")
    return {"stats": stats.__dict__, "wall_s": wall}, got


# -- phase 3: flash attention against its plain version -----------------------
FLASH_CASES = [  # B, T, S, H, KH, D, causal, window, softcap, seq_k
    (1, 128, 128, 4, 4, 64, True, None, None, None),      # MHA causal
    (2, 128, 128, 4, 2, 64, True, None, None, None),      # GQA
    (1, 256, 256, 4, 1, 64, True, None, None, None),      # MQA
    (1, 256, 256, 2, 2, 64, True, 64, None, None),        # local window
    (1, 128, 128, 2, 2, 64, True, None, 30.0, None),      # softcap
    (1, 128, 128, 2, 2, 64, False, None, None, None),     # full (non-causal)
    (1, 100, 100, 2, 2, 64, True, None, None, None),      # non-multiple T/S
    (1, 128, 128, 2, 2, 128, True, None, None, None),     # head_dim 128
    (2, 200, 200, 4, 2, 256, True, None, None, None),     # head_dim 256
    # the edges of the bf16 kernel's tiles (BQ = 128, BK = 128 or 64)
    (1, 17, 17, 2, 2, 64, True, None, None, None),        # below one tile
    (1, 17, 40, 2, 1, 128, False, None, None, None),      # T != S, both small
    (1, 127, 127, 4, 2, 64, True, None, None, None),
    (1, 129, 129, 4, 2, 128, True, None, None, None),
    (2, 200, 200, 4, 2, 64, True, None, None, None),
    (1, 200, 256, 4, 2, 64, True, 64, None, 230),         # seq_k < S, window
    (1, 150, 192, 2, 2, 128, True, 48, 30.0, 160),        # and softcap
    (1, 130, 130, 2, 2, 64, False, None, 20.0, 100),
    (1, 200, 200, 2, 1, 256, True, None, None, None),     # head_dim 256 ragged
    (1, 100, 100, 32, 1, 64, True, None, None, None),     # MQA, a group of 32
    (4, 1024, 1024, 32, 8, 64, True, None, None, None),   # the serve shape
    (2, 200, 200, 48, 8, 128, True, None, None, None),    # groups of 6 and 8
    (2, 200, 200, 64, 8, 128, True, None, None, None),    # at head_dim 128
    (4, 1024, 1024, 48, 8, 128, True, None, None, None),  # dbrx's prefill
    (4, 1024, 1024, 64, 8, 128, True, None, None, None),  # the VLM's
]
SERVE_SHAPE = (4, 1024, 32, 8, 64)                  # B, T=S, H, KH, D
# phase 12(c)'s attention: a microbatch of gemma-7b's train_4k step (2 x
# 4096 tokens) on one rank of the 16 x 16 mesh, its 16 heads over 16 model
# ranks: one head and one kv head of 256
RANK_SHAPE = (2, 4096, 1, 1, 256)
# phase 12(d)'s: a microbatch of llama-3.2-vision-90b's train_4k step (1 x
# 4096 tokens) on one rank: 4 of its 64 q heads, whose group of 8 reads one
# of the 8 kv heads (which do not divide the 16 model ranks), head_dim 128
VLM_RANK_SHAPE = (1, 4096, 4, 1, 128)
# phase 12(e)'s: a microbatch of dbrx-132b's train_4k step (1 x 4096
# tokens) on one rank: 3 of its 48 q heads, whose group of 6 reads one of
# the 8 kv heads (which do not divide the 16 model ranks), head_dim 128
DBRX_RANK_SHAPE = (1, 4096, 3, 1, 128)
D128_SHAPES = {  # arch -> its prefill wave's attention: B, T=S, H, KH, D
    "dbrx-132b": (4, 1024, 48, 8, 128),
    "llama-3.2-vision-90b": (4, 1024, 64, 8, 128),
}
# tests/test_kernels.py:56, the reference's own tolerances
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_FLOOR_T = 16              # one CTA of each flash kernel


def flash_bound(B: int, T: int, H: int, KH: int, D: int, elem: int) -> dict:
    """The least time an H100 SXM could take for causal attention at this
    shape: the larger of the products' operations (`attention_flops`, the
    kernel's FLOP formula) over the bf16 tensor-core peak and the bytes
    (q, k, v, out, lse, each once) over HBM's rate."""
    from repro_torch.kernels.flash_attention.ops import attention_flops
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    flops = attention_flops(B, T, T, H, D)           # 4 D an unmasked pair
    nbytes = (2 * B * T * H * D + 2 * B * T * KH * D) * elem + 4 * B * H * T
    ops_ms = flops / PEAK_FLOPS_BF16 * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def flash_phase(seed: int) -> dict:
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    at_prefill = {}      # out's error at D128_SHAPES, by dtype and H
    n_checks = 0
    for dname in ("bfloat16", "float32"):
        dt, tol = getattr(torch, dname), FLASH_TOL[dname]
        for B, T, S, H, KH, D, causal, window, softcap, seq_k in FLASH_CASES:
            q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, KH, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, KH, D, generator=gen, device="cuda").to(dt)
            kw = dict(causal=causal, window=window, softcap=softcap)
            if seq_k is None:
                out, lse = ops.flash_attention(q, k, v, block_q=64,
                                               block_k=64, return_lse=True,
                                               **kw)
            else:   # padded keys: the wrapper takes seq_k, ops does not
                out, lse = K.flash_attention_fwd(q, k, v, scale=D ** -0.5,
                                                 seq_k=seq_k, **kw)
            want, want_lse = ref.attention_ref(q, k, v, return_lse=True,
                                               seq_k=seq_k, **kw)
            torch.cuda.synchronize()
            what = (f"{dname} B={B} T={T} S={S} H={H} KH={KH} D={D} {kw} "
                    f"seq_k={seq_k}")
            for got, exp, name in ((out, want, "out"), (lse, want_lse, "lse")):
                err, ok = in_tolerance(got, exp, tol)
                check(torch.isfinite(got).all().item(), f"{name} not finite: "
                      f"{what}")
                check(ok, f"flash {name} off by {err} (tol {tol}): {what}")
                worst[dname] = max(worst[dname], err)
            n_checks += 1
            if (B, T, H, KH, D) in D128_SHAPES.values() and T == S:
                at_prefill[f"{dname} H={H}"] = in_tolerance(out, want, tol)[0]
    print(f"flash_attention_fwd within tolerance of its plain version in "
          f"{n_checks} checks; max abs error {worst}; at dbrx's and the "
          f"VLM's prefill shapes {at_prefill}")

    # times at the serve shape, and at head_dim 128 at the prefill shapes
    # of dbrx and llama-3.2-vision
    times = _flash_times(SERVE_SHAPE, gen)
    d128 = {arch: _flash_times(shape, gen)
            for arch, shape in D128_SHAPES.items()}
    d256 = _flash_times(RANK_SHAPE, gen)
    vlm_rank = _flash_times(VLM_RANK_SHAPE, gen)
    dbrx_rank = _flash_times(DBRX_RANK_SHAPE, gen)
    # the launch floor: one CTA (B = H = KH = 1, T = S = 16, bf16)
    q1, k1, v1 = (torch.randn(1, FLASH_FLOOR_T, 1, 64, generator=gen,
                              device="cuda").bfloat16() for _ in range(3))
    floor_ms = kernel_device_ms(lambda: K.flash_attention_fwd(
        q1, k1, v1, scale=0.125, causal=True), 100, K.KERNEL_NAME)
    floor_call_ms = cuda_ms(lambda: K.flash_attention_fwd(
        q1, k1, v1, scale=0.125, causal=True), 200)
    print(f"flash_attention_fwd launch floor (one CTA: B=H=KH=1, "
          f"T=S={FLASH_FLOOR_T}, D=64, bf16): kernel {floor_ms:.6f} ms on "
          f"the device, {floor_call_ms:.6f} ms a call")
    return {"max_abs_err": max(worst.values()), "max_abs_err_by_dtype": worst,
            "max_abs_err_at_d128_prefill": at_prefill, **times, "d128": d128,
            "d256": d256, "vlm_rank": vlm_rank, "dbrx_rank": dbrx_rank,
            "floor_ms": floor_ms, "floor_call_ms": floor_call_ms}


def _flash_times(shape: tuple, gen) -> dict:
    """At (B, T=S, H, KH, D), bf16, causal: `ms` the kernel's device time
    (profiler), `call_ms` the wrapper's call (CUDA events, launch overhead
    included), the plain version's time and PyTorch's
    scaled_dot_product_attention's (the library yardstick, used nowhere in
    the port), beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops, ref

    B, T, H, KH, D = shape
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, T, KH, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, T, KH, D, generator=gen, device="cuda").bfloat16()
    scale = 1.0 / D ** 0.5
    ms = kernel_device_ms(lambda: K.flash_attention_fwd(
        q, k, v, scale=scale, causal=True), 20, K.KERNEL_NAME)
    call_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    lib_out = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    err, ok = in_tolerance(ops.flash_attention(q, k, v), lib_out, 2e-2)
    check(ok, f"flash differs from the library call by {err} at {shape}")
    bound = flash_bound(B, T, H, KH, D, q.element_size())
    print(f"flash_attention_fwd at (B={B}, T=S={T}, H={H}, KH={KH}, D={D}, "
          f"bf16, causal): kernel {ms:.6f} ms on the device, "
          f"{call_ms:.6f} ms a call, plain {plain_ms:.6f} ms, "
          f"scaled_dot_product_attention {library_ms:.6f} ms; bound "
          f"{bound['bound_ms']:.6f} ms by {bound['bound_by']}: "
          f"{bound['flops']} FLOP / {PEAK_FLOPS_BF16:.3g} FLOP/s = "
          f"{bound['ops_ms']:.6f} ms, {bound['bytes']} B / "
          f"{HBM_BW:.3g} B/s = {bound['bytes_ms']:.6f} ms")
    return {"shape": dict(zip(("B", "T", "H", "KH", "D"), shape)), "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound}


# -- phase 3, continued: the flash backward against its plain version ---------
BWD_CASES = [  # B, T, S, H, KH, D, window, seq_k: the reference's
    # (tests/test_kernels.py:275-283), head_dim 256, the shapes the train and
    # serve paths give, and the edges of the bf16 kernels' tiles
    (1, 128, 128, 4, 2, 64, None, None),       # GQA
    (2, 64, 64, 4, 1, 64, None, None),         # MQA
    (1, 128, 128, 2, 2, 64, 32, None),         # local window
    (1, 100, 100, 2, 2, 64, None, None),       # ragged T
    (1, 128, 128, 2, 2, 128, None, None),      # head_dim 128
    (2, 200, 200, 4, 2, 256, None, None),      # head_dim 256, ragged
    (1, 17, 17, 2, 2, 64, None, None),         # below one tile
    (1, 127, 127, 4, 2, 64, None, None),
    (1, 129, 129, 4, 2, 128, None, None),
    (1, 200, 256, 4, 2, 64, 64, 230),          # seq_k < S, window, T != S
    (1, 150, 192, 2, 2, 128, 48, 160),
    (1, 200, 200, 2, 1, 256, None, None),      # head_dim 256 ragged, MQA
    (1, 100, 100, 32, 1, 64, None, None),      # MQA, a group of 32
    (4, 256, 256, 12, 4, 64, None, None),      # the train shape
    (4, 1024, 1024, 32, 8, 64, None, None),    # the serve shape
]
TRAIN_SHAPE = (4, 256, 12, 4, 64)   # one microbatch of dense-100m's step
# tests/test_kernels.py:303, the reference's backward tolerances
BWD_TOL = {"bfloat16": 5e-2, "float32": 2e-4}


def flash_bwd_bound(B: int, T: int, H: int, KH: int, D: int,
                    elem: int) -> dict:
    """The least time an H100 SXM could take for the causal backward at
    this shape: the larger of the five products' operations (10 D FLOP
    per unmasked (q, k) pair, `attention_flops`, the kernel's FLOP
    formula) over the bf16 tensor-core peak and the bytes
    (q, k, v, out, dout, dq, dk, dv in the input type and lse, delta in
    float32, each once) over HBM's rate."""
    from repro_torch.kernels.flash_attention.ops import attention_flops
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    flops = attention_flops(B, T, T, H, D, backward=True)
    nbytes = (4 * B * T * H * D + 4 * B * T * KH * D) * elem + 8 * B * H * T
    ops_ms = flops / PEAK_FLOPS_BF16 * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def flash_bwd_phase(seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import kernel_bwd as KB
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def inputs(B, T, H, KH, D, dt, S=None):
        S = T if S is None else S
        return [torch.randn(B, n, h, D, generator=gen, device="cuda").to(dt)
                for n, h in ((T, H), (S, KH), (S, KH), (T, H))]

    worst = {"bfloat16": 0.0, "float32": 0.0}
    n_checks = 0
    for dname in ("bfloat16", "float32"):
        dt, tol = getattr(torch, dname), BWD_TOL[dname]
        for B, T, S, H, KH, D, window, seq_k in BWD_CASES:
            q, k, v, dout = inputs(B, T, H, KH, D, dt, S)
            scale = D ** -0.5
            out, lse = FK.flash_attention_fwd(q, k, v, scale=scale,
                                              window=window, seq_k=seq_k)
            if seq_k is None:
                got = ops.flash_attention_backward(q, k, v, out, lse, dout,
                                                   scale=scale,
                                                   window=window)
            else:   # padded keys: the wrapper takes seq_k, ops does not
                delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
                got = KB.flash_attention_bwd(q, k, v, dout, lse,
                                             delta.contiguous(), scale=scale,
                                             window=window, seq_k=seq_k)
            want = ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, scale=scale, causal=True,
                window=window, seq_k=S if seq_k is None else seq_k)
            torch.cuda.synchronize()
            what = (f"{dname} B={B} T={T} S={S} H={H} KH={KH} D={D} "
                    f"window={window} seq_k={seq_k}")
            for g, w, name in zip(got, want, ("dq", "dk", "dv")):
                check(g.dtype == dt, f"{name} is {g.dtype}: {what}")
                check(torch.isfinite(g).all().item(),
                      f"{name} not finite: {what}")
                err, ok = in_tolerance(g, w, tol)
                check(ok, f"flash bwd {name} off by {err} (tol {tol}): "
                      f"{what}")
                worst[dname] = max(worst[dname], err)
            n_checks += 1
            del q, k, v, dout, out, lse, got, want
    print(f"flash_attention_bwd within tolerance of its plain version in "
          f"{n_checks} checks of dq, dk and dv; max abs error {worst}")

    # times at the train and serve shapes and phase 12(c)'s, 12(d)'s and
    # 12(e)'s:
    # `ms` the two kernels' device
    # time a call (profiler), `call_ms` the backward as autograd runs it
    # (delta, then both kernels; CUDA events), `library_ms` the backward of
    # scaled_dot_product_attention alone, given dout
    shapes = {}
    for shape_name, (B, T, H, KH, D) in (("train", TRAIN_SHAPE),
                                         ("serve", SERVE_SHAPE),
                                         ("rank", RANK_SHAPE),
                                         ("vlm_rank", VLM_RANK_SHAPE),
                                         ("dbrx_rank", DBRX_RANK_SHAPE)):
        q, k, v, dout = inputs(B, T, H, KH, D, torch.bfloat16)
        scale = D ** -0.5
        out, lse = ops.flash_attention(q, k, v, return_lse=True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        ms = kernel_device_ms(lambda: KB.flash_attention_bwd(
            q, k, v, dout, lse, delta, scale=scale), 20, KB.KERNEL_NAME,
            per_call=KB.KERNELS_PER_CALL)
        call_ms = cuda_ms(lambda: ops.flash_attention_backward(
            q, k, v, out, lse, dout, scale=scale), 20)
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, scale=scale, causal=True, window=None,
            seq_k=T), 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        dot = dout.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), 20)
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot)
        mine = ops.flash_attention_backward(q, k, v, out, lse, dout,
                                            scale=scale)
        for g, w, name in zip(mine, lib, ("dq", "dk", "dv")):
            err, ok = in_tolerance(g, w.transpose(1, 2), BWD_TOL["bfloat16"])
            check(ok, f"flash bwd {name} differs from the library's by {err}"
                  f" at the {shape_name} shape")
        bound = flash_bwd_bound(B, T, H, KH, D, q.element_size())
        shapes[shape_name] = {
            "shape": dict(zip(("B", "T", "H", "KH", "D"), (B, T, H, KH, D))),
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound}
        print(f"flash_attention_bwd at the {shape_name} shape (B={B}, T=S={T}"
              f", H={H}, KH={KH}, D={D}, bf16, causal): kernels {ms:.6f} ms "
              f"on the device, {call_ms:.6f} ms a call, plain "
              f"{plain_ms:.6f} ms, scaled_dot_product_attention backward "
              f"{library_ms:.6f} ms; bound {bound['bound_ms']:.6f} ms by "
              f"{bound['bound_by']}: {bound['flops']} FLOP / "
              f"{PEAK_FLOPS_BF16:.3g} FLOP/s = {bound['ops_ms']:.6f} ms, "
              f"{bound['bytes']} B / {HBM_BW:.3g} B/s = "
              f"{bound['bytes_ms']:.6f} ms")
        del q, k, v, dout, out, lse, delta, qt, kt, vt, lib_out, lib, mine
    # the launch floor: one CTA of each of the two kernels
    q, k, v, dout = inputs(1, FLASH_FLOOR_T, 1, 1, 64, torch.bfloat16)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    floor_ms = kernel_device_ms(lambda: KB.flash_attention_bwd(
        q, k, v, dout, lse, delta, scale=0.125), 100, KB.KERNEL_NAME,
        per_call=KB.KERNELS_PER_CALL)
    floor_call_ms = cuda_ms(lambda: KB.flash_attention_bwd(
        q, k, v, dout, lse, delta, scale=0.125), 200)
    print(f"flash_attention_bwd launch floor (one CTA a kernel: B=H=KH=1, "
          f"T=S={FLASH_FLOOR_T}, D=64, bf16): both kernels {floor_ms:.6f} ms "
          f"on the device, {floor_call_ms:.6f} ms a call")
    return {"max_abs_err": max(worst.values()),
            "max_abs_err_by_dtype": worst, "shapes": shapes,
            "floor_ms": floor_ms, "floor_call_ms": floor_call_ms}


# -- phase 3, continued: the decode kernel against its plain version ---------
DECODE_CELLS = {  # B, S, KH, G, D and the live positions a row timed: the
    # benchmark's cells (portbench/cells), mid-wave (prompt + half the reply
    # cap + 1), and a dbrx-132b decode wave at the chat cell's cache
    "granite-3-2b.chat": (96, 1288, 8, 4, 64, 1024 + 128 + 1),
    "granite-3-2b.rag": (32, 3912, 8, 4, 64, 3840 + 32 + 1),
    "dbrx-132b": (8, 1288, 8, 6, 128, 1024 + 128 + 1)}
DECODE_CASES = [  # B, S, KH, G, D: the split and tile edges (S below a
    # tile, not a multiple of 64, one split and many), MQA, a group of 16,
    # every row of a ragged kv_len (1 and S among them)
    (3, 17, 2, 4, 64), (2, 200, 1, 16, 64), (5, 1000, 2, 4, 128),
    (4, 4097, 1, 6, 128), (2, 3912, 8, 4, 64)]
DECODE_TOL = 2e-2               # the reference's bf16 tolerance


def decode_bound(B: int, S: int, KH: int, G: int, D: int, live: int) -> dict:
    """The least time an H100 SXM could take for one decode call: the
    larger of the products' operations (`attention_flops` over the live
    positions) over the bf16 tensor-core peak and the bytes (q, out, kv_len
    and the live positions' k and v, each once) over HBM's rate."""
    from repro_torch.kernels.flash_attention.ops import attention_flops
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    H = KH * G
    flops = attention_flops(B, 1, S, H, D, causal=False, seq_k=live)
    nbytes = 2 * (2 * B * H * D + 2 * B * live * KH * D) + 4 * B
    ops_ms = flops / PEAK_FLOPS_BF16 * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _decode_inputs(shape: tuple, gen, kv_len=None):
    import torch
    B, S, KH, G, D = shape
    q = torch.randn(B, 1, KH * G, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, KH, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, KH, D, generator=gen, device="cuda").bfloat16()
    if kv_len is None:      # every row its own length, 1 and S among them
        kv_len = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
        kv_len[0], kv_len[-1] = 1, S
    else:
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len


def decode_phase(seed: int) -> dict:
    """flash_decode held against its plain version (`ref.decode_ref`, the
    plain path's arithmetic on the card) at the tile and split edges, a
    cache viewed through a slice of its heads, and the cells' shapes; at
    the cells' shapes timed beside its bound, the plain path and
    scaled_dot_product_attention (the library yardstick, used nowhere in
    the port)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel_decode as KD
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    cases = [(c, None) for c in DECODE_CASES] + [
        (c[:5], c[5]) for c in DECODE_CELLS.values()]
    for shape, live in cases:
        q, k, v, kv_len = _decode_inputs(shape, gen, live)
        for kk, vv, what in ((k, v, "whole"),
                             (k[:, :, 1:], v[:, :, 1:], "heads 1..")):
            if what != "whole" and shape[2] == 1:
                continue
            qq = q[:, :, :kk.shape[2] * shape[3]]
            got = ops.flash_decode(qq, kk, vv, kv_len)
            want = ref.decode_ref(qq, kk, vv, kv_len, shape[4] ** -0.5)
            err, ok = in_tolerance(got, want, DECODE_TOL)
            check(ok, f"flash_decode off its plain version by {err} at "
                  f"{shape} ({what}), kv_len {kv_len.tolist()[:8]}")
            worst = max(worst, err)
    print(f"flash_decode within {DECODE_TOL} of its plain version in "
          f"{len(cases)} shapes; max abs error {worst:.6f}")

    cells = {}
    for cell, (B, S, KH, G, D, live) in DECODE_CELLS.items():
        q, k, v, kv_len = _decode_inputs((B, S, KH, G, D), gen, live)
        ms = kernel_device_ms(lambda: ops.flash_decode(q, k, v, kv_len), 20,
                              KD.KERNEL_NAME, KD.KERNELS_PER_CALL)
        call_ms = cuda_ms(lambda: ops.flash_decode(q, k, v, kv_len), 20)
        plain_ms = cuda_ms(lambda: ref.decode_ref(q, k, v, kv_len, D ** -0.5),
                           3)
        mask = (torch.arange(S, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        bound = decode_bound(B, S, KH, G, D, live)
        splits, per = KD.plan(B, KH, S, KD.card_slots(q.device.index, D))
        print(f"flash_decode at {cell} (B={B}, S={S}, KH={KH}, G={G}, D={D},"
              f" {live} live positions a row, {splits} splits of {per} "
              f"tiles): kernels {ms:.6f} ms on the device, {call_ms:.6f} ms "
              f"a call, plain {plain_ms:.6f} ms, "
              f"scaled_dot_product_attention {library_ms:.6f} ms; bound "
              f"{bound['bound_ms']:.6f} ms by {bound['bound_by']} "
              f"({bound['bytes']} B), {100 * bound['bound_ms'] / ms:.2f}% "
              f"of it")
        cells[cell] = {"shape": dict(zip(("B", "S", "KH", "G", "D", "live"),
                                         (B, S, KH, G, D, live))),
                       "splits": splits, "tiles_per_split": per, "ms": ms,
                       "call_ms": call_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms,
                       "roofline_pct": 100 * bound["bound_ms"] / ms, **bound}
    return {"max_abs_err": worst, "cells": cells}


# -- phase 3, continued: the RG-LRU and RWKV6 scans against their plain versions
FP32_FLOPS = 67e12              # H100 SXM float32 FMA peak (CUDA cores)
RGLRU_CASES = [  # B, T, R: the reference's (tests/test_kernels.py:103-104),
    # T = 1 at the decode shape, ragged R, and the prefill shape
    (1, 64, 128), (2, 128, 256), (1, 100, 96), (3, 32, 512),
    (4, 1, 2560), (2, 77, 1000), (4, 1024, 2560),
    # the chunked kernel's edges: T around one window of a CTA's warps and
    # 4096 steps, B * R not a multiple of a CTA's 32 channels
    (2, 63, 2567), (2, 65, 2567), (2, 4096, 2567)]
RGLRU_FLOOR = (1, 1, 32)            # one CTA of one warp, one step
RGLRU_PREFILL = (4, 1024, 2560)     # recurrentgemma-2b: B, T, d_rnn
RGLRU_DECODE = (4, 1, 2560)
RGLRU_TRAIN = (4, 256, 2560)        # a microbatch of its train step
RGLRU_RANK = (2, 4096, 160)         # phase 12(d): a train_4k microbatch on
#                                     one rank, 2560 channels over 16
WKV_CASES = [  # B, T, H, hd: the reference's (tests/test_kernels.py:152-154),
    # ragged T, head_dim 16 and 128, T = 1 and the prefill shape
    (1, 64, 2, 32), (2, 96, 2, 64), (1, 33, 1, 64), (1, 128, 4, 64),
    (1, 37, 3, 16), (1, 70, 2, 128), (2, 1, 2, 64), (4, 1024, 32, 64)]
WKV_STRONG_CASES = [  # B, T, H, hd, decay: held against the sequential
    # version to 1e-4 (tests/test_kernels.py:203): w = 1e-9 everywhere (the
    # reference's :190-203), and seven chunks with half the channels at w =
    # 1e-12 and half near 1, which reach the factored sub-block's underflow
    (1, 64, 1, 32, "all"), (1, 200, 2, 64, "half")]
WKV_PREFILL = (4, 1024, 32, 64)     # rwkv6-1.6b: B, T, H, hd
WKV_TRAIN = (4, 256, 32, 64)        # a microbatch of its train step
WKV_RANK = (2, 32768, 2, 64)        # phase 12(d): prefill_32k on one rank,
#                                     32 heads over 16


def rglru_bound(B: int, T: int, R: int, h0: bool) -> dict:
    """The least time an H100 SXM could take for the scan: a and b read
    and h written once, and h0 read once where one is given (bytes); and
    one FMA an element over the float32 FMA peak."""
    from repro_torch.kernels.rglru_scan.ops import rglru_flops
    from repro_torch.launch.mesh import HBM_BW
    nbytes = (3 * B * T * R + (B * R if h0 else 0)) * 4
    flops = rglru_flops(B, T, R)
    ops_ms = flops / FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def wkv_bound(B: int, T: int, H: int, hd: int, s0: bool,
              chunk: int = 32) -> dict:
    """The least time an H100 SXM could take for the chunked WKV: r, k,
    v, w read and y written once, the state written once, s0 read once
    where one is given, u read (bytes); and the operations of the four
    stages over the rows this T holds over the float32 FMA peak
    (`wkv6_flops`, the kernel's FLOP formula)."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_flops
    from repro_torch.launch.mesh import HBM_BW
    nbytes = (5 * B * T * H * hd + (2 if s0 else 1) * B * H * hd * hd
              + H * hd) * 4
    flops = wkv6_flops(B, T, H, hd, chunk)
    ops_ms = flops / FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def scan_phase(seed: int) -> dict:
    import torch
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rglru_scan import ref as rref
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan import ref as wref

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def scan_inputs(B, T, R):
        return torch.sigmoid(2 * randn(B, T, R)), randn(B, T, R), randn(B, R)

    # rglru_scan, forward and reverse, ± h0, to 1e-5 (tests/test_kernels.py
    # :116); its backward (the kernel reversed) against autograd through the
    # plain version to 1e-4 (:140)
    worst = {"fwd": 0.0, "bwd": 0.0}
    n_checks = 0
    for B, T, R in RGLRU_CASES:
        a, b, h0 = scan_inputs(B, T, R)
        for h in (None, h0):
            for reverse in (False, True):
                got = RGK.rglru_scan(a, b, h, reverse=reverse)
                want = rref.rglru_scan_ref(a, b, h, reverse=reverse)
                torch.cuda.synchronize()
                err, ok = in_tolerance(got, want, 1e-5)
                check(ok, f"rglru_scan off its plain version by {err}: "
                      f"B={B} T={T} R={R} h0={h is not None} "
                      f"reverse={reverse}")
                worst["fwd"] = max(worst["fwd"], err)
                n_checks += 1
    # a near 1 over 4096 steps, b scaled by sqrt(1 - a^2) as the model
    # feeds the scan: carries cross all 64 windows
    B, T, R = RGLRU_CASES[-1]
    a = 1 - 1e-3 * torch.rand(B, T, R, generator=gen, device="cuda")
    b = randn(B, T, R) * torch.sqrt(1 - a * a)
    h0 = randn(B, R)
    for reverse in (False, True):
        got = RGK.rglru_scan(a, b, h0, reverse=reverse)
        want = rref.rglru_scan_ref(a, b, h0, reverse=reverse)
        torch.cuda.synchronize()
        err, ok = in_tolerance(got, want, 1e-5)
        check(ok, f"rglru_scan off its plain version by {err} with a near "
              f"1: B={B} T={T} R={R} reverse={reverse}")
        worst["fwd"] = max(worst["fwd"], err)
        n_checks += 1
    del a, b, h0
    for B, T, R in ((2, 96, 200), RGLRU_PREFILL):
        ins = [x.requires_grad_() for x in scan_inputs(B, T, R)]
        ref_ins = [x.detach().clone().requires_grad_() for x in ins]
        torch.sin(rops.rglru_scan(*ins)).sum().backward()
        torch.sin(rref.rglru_scan_ref(*ref_ins)).sum().backward()
        torch.cuda.synchronize()
        for x, y, name in zip(ins, ref_ins, ("da", "db", "dh0")):
            err, ok = in_tolerance(x.grad, y.grad, 1e-4)
            check(ok, f"rglru_scan backward {name} off autograd through the"
                  f" plain version by {err}: B={B} T={T} R={R}")
            worst["bwd"] = max(worst["bwd"], err)
        del ins, ref_ins
    print(f"rglru_scan within 1e-5 of its plain version in {n_checks} checks "
          f"(max abs error {worst['fwd']:.3e}); its backward within 1e-4 of "
          f"autograd through the plain version (max abs error "
          f"{worst['bwd']:.3e})")

    # wkv6 against its plain version (the reference's chunk choice, then
    # the chunked form) to 3e-4 (tests/test_kernels.py:166), strong decay
    # to 1e-4 (:203)
    wkv_worst = 0.0
    for B, T, H, hd in WKV_CASES:
        xs = (randn(B, T, H, hd), 0.5 * randn(B, T, H, hd), randn(B, T, H, hd),
              torch.exp(-torch.exp(randn(B, T, H, hd))), 0.5 * randn(H, hd),
              0.1 * randn(B, H, hd, hd))
        for s0 in (None, xs[5]):
            got = WK.wkv6(*xs[:5], s0)
            want = wref.wkv_plain(*xs[:5], s0)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("y", "state")):
                check(bool(torch.isfinite(g).all()), f"wkv6 {name} not "
                      f"finite: B={B} T={T} H={H} hd={hd}")
                err, ok = in_tolerance(g, w, 3e-4)
                check(ok, f"wkv6 {name} off its plain version by {err}: "
                      f"B={B} T={T} H={H} hd={hd} s0={s0 is not None}")
                wkv_worst = max(wkv_worst, err)
        del xs
    strong = 0.0
    for B, T, H, hd, decay in WKV_STRONG_CASES:
        r, k, v = (randn(B, T, H, hd) for _ in range(3))
        if decay == "all":
            w = torch.full_like(r, 1e-9)
            u = torch.zeros(H, hd, device="cuda")
        else:
            near = 0.9 + 0.1 * torch.rand(B, T, H, hd, generator=gen,
                                          device="cuda")
            w = torch.where(torch.arange(hd, device="cuda") < hd // 2,
                            torch.full_like(near, 1e-12), near)
            u = 0.5 * randn(H, hd)
        for g, x, name in zip(WK.wkv6(r, k, v, w, u),
                              wref.wkv_ref(r, k, v, w, u), ("y", "state")):
            check(bool(torch.isfinite(g).all()), f"wkv6 {name} not finite "
                  f"under strong decay: B={B} T={T} H={H} hd={hd} {decay}")
            err, ok = in_tolerance(g, x, 1e-4)
            check(ok, f"wkv6 {name} under strong decay off its sequential "
                  f"version by {err}: B={B} T={T} H={H} hd={hd} {decay}")
            strong = max(strong, err)
    print(f"wkv6 within 3e-4 of its plain version in {2 * len(WKV_CASES)} "
          f"checks (max abs error {wkv_worst:.3e}); strong decay finite and "
          f"within 1e-4 of the sequential version in "
          f"{len(WKV_STRONG_CASES)} cases (max abs error {strong:.3e})")

    # times at the main path's shapes and as the path calls the kernels
    # (prefill with no initial state, decode with h0): `ms` the kernel's
    # device time (profiler), `call_ms` the wrapper's call (CUDA events,
    # launch overhead included), `plain_ms` the plain version
    # and at a microbatch of the train step, forward and reversed (the
    # backward's adjoint scan, called through the op as the backward calls
    # it)
    shapes = {}
    for leg, (B, T, R), with_h0, rev in (
            ("prefill", RGLRU_PREFILL, False, False),
            ("decode", RGLRU_DECODE, True, False),
            ("train", RGLRU_TRAIN, False, False),
            ("train_reverse", RGLRU_TRAIN, False, True),
            ("rank", RGLRU_RANK, False, False),
            ("rank_reverse", RGLRU_RANK, False, True)):
        a, b, h0 = scan_inputs(B, T, R)
        h0 = h0 if with_h0 else None
        ms = kernel_device_ms(lambda: RGK.rglru_scan(a, b, h0, reverse=rev),
                              50, RGK.KERNEL_NAME)
        call_ms = cuda_ms(lambda: rops._scan(a, b, h0, rev), 50)
        plain_ms = cuda_ms(lambda: rref.rglru_scan_ref(a, b, h0,
                                                       reverse=rev), 10)
        bound = rglru_bound(B, T, R, with_h0)
        shapes[leg] = {"shape": {"B": B, "T": T, "R": R, "h0": with_h0,
                                 "reverse": rev},
                       "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                       **bound}
        print(f"rglru_scan at the {leg} shape (B={B}, T={T}, R={R}, "
              f"h0={with_h0}, reverse={rev}): kernel "
              f"{ms:.6f} ms on the device, {call_ms:.6f} ms a call, plain "
              f"{plain_ms:.6f} ms; bound {bound['bound_ms']:.6f} ms by "
              f"{bound['bound_by']}: {bound['bytes']} B / "
              f"{HBM_BW:.3g} B/s, {bound['flops']} FLOP / "
              f"{FP32_FLOPS:.3g} FLOP/s = {bound['ops_ms']:.6f} ms")
    # the launch floor: one CTA of one warp and one step, with h0
    a, b, h0 = scan_inputs(*RGLRU_FLOOR)
    floor_ms = kernel_device_ms(lambda: RGK.rglru_scan(a, b, h0), 50,
                                RGK.KERNEL_NAME)
    floor_call_ms = cuda_ms(lambda: rops.rglru_scan(a, b, h0), 50)
    print(f"rglru_scan launch floor (B, T, R = {RGLRU_FLOOR}, h0): kernel "
          f"{floor_ms:.6f} ms on the device, {floor_call_ms:.6f} ms a call; "
          f"prefill {shapes['prefill']['ms'] - floor_ms:.6f} ms above it "
          f"(bound {shapes['prefill']['bound_ms']:.6f} ms), decode "
          f"{shapes['decode']['ms'] - floor_ms:.6f} ms (bound "
          f"{shapes['decode']['bound_ms']:.7f} ms)")
    from repro_torch.kernels.rwkv6_scan import ops as wops
    B, T, H, hd = WKV_PREFILL
    xs = (randn(B, T, H, hd), 0.5 * randn(B, T, H, hd), randn(B, T, H, hd),
          torch.exp(-torch.exp(randn(B, T, H, hd))), 0.5 * randn(H, hd))
    # `ms` both kernels' device time a call; `kernel_ms` each kernel's
    ms = kernel_device_ms(lambda: WK.wkv6(*xs), 20, WK.KERNEL_NAME,
                          per_call=WK.KERNELS_PER_CALL)
    kernel_ms = {name: kernel_device_ms(lambda: WK.wkv6(*xs), 20, name)
                 for name in WK.KERNELS}
    call_ms = cuda_ms(lambda: wops.wkv6(*xs), 20)
    plain_ms = cuda_ms(lambda: wref.wkv_plain(*xs), 5)
    bound = wkv_bound(B, T, H, hd, s0=False)
    # the launch floor: one CTA of each kernel (one 16-row strip of one
    # head, one chunk)
    f1 = (randn(1, 1, 1, 16), randn(1, 1, 1, 16), randn(1, 1, 1, 16),
          torch.exp(-torch.exp(randn(1, 1, 1, 16))), randn(1, 16))
    wkv_floor_ms = kernel_device_ms(lambda: WK.wkv6(*f1), 100,
                                    WK.KERNEL_NAME,
                                    per_call=WK.KERNELS_PER_CALL)
    wkv_floor_call_ms = cuda_ms(lambda: WK.wkv6(*f1), 200)
    print(f"wkv6 launch floor (one CTA a kernel: B=T=H=1, hd=16): both "
          f"kernels {wkv_floor_ms:.6f} ms on the device, "
          f"{wkv_floor_call_ms:.6f} ms a call")
    wkv = {"shape": {"B": B, "T": T, "H": H, "hd": hd}, "ms": ms,
           "kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "floor_ms": wkv_floor_ms, "floor_call_ms": wkv_floor_call_ms,
           **bound}
    print(f"wkv6 at the prefill shape (B={B}, T={T}, H={H}, hd={hd}): "
          + ", ".join(f"{name} {t:.6f} ms" for name, t in kernel_ms.items())
          + f"; both kernels {ms:.6f} ms on the device "
          f"({ms / bound['bound_ms']:.2f}x the bound), "
          f"{call_ms:.6f} ms a call, plain "
          f"{plain_ms:.6f} ms; bound {bound['bound_ms']:.6f} ms by "
          f"{bound['bound_by']}: {bound['bytes']} B / {HBM_BW:.3g} "
          f"B/s = {bound['bytes_ms']:.6f} ms, {bound['flops']} FLOP / "
          f"{FP32_FLOPS:.3g} FLOP/s = {bound['ops_ms']:.6f} ms")
    # at a microbatch of the train step, as the path calls it (no s0)
    B, T, H, hd = WKV_TRAIN
    xs = (randn(B, T, H, hd), 0.5 * randn(B, T, H, hd), randn(B, T, H, hd),
          torch.exp(-torch.exp(randn(B, T, H, hd))), 0.5 * randn(H, hd))
    tbound = wkv_bound(B, T, H, hd, s0=False)
    wkv["train"] = {
        "shape": {"B": B, "T": T, "H": H, "hd": hd},
        "ms": kernel_device_ms(lambda: WK.wkv6(*xs), 20, WK.KERNEL_NAME,
                               per_call=WK.KERNELS_PER_CALL),
        "call_ms": cuda_ms(lambda: wops.wkv6(*xs), 20),
        "plain_ms": cuda_ms(lambda: wref.wkv_plain(*xs), 5), **tbound}
    print(f"wkv6 at the train shape (B={B}, T={T}, H={H}, hd={hd}): both "
          f"kernels {wkv['train']['ms']:.6f} ms on the device, "
          f"{wkv['train']['call_ms']:.6f} ms a call, plain "
          f"{wkv['train']['plain_ms']:.6f} ms; bound "
          f"{tbound['bound_ms']:.6f} ms by {tbound['bound_by']}")
    # at phase 12(d)'s prefill on one rank (its 2 local heads, no s0)
    B, T, H, hd = WKV_RANK
    xs = (randn(B, T, H, hd), 0.5 * randn(B, T, H, hd), randn(B, T, H, hd),
          torch.exp(-torch.exp(randn(B, T, H, hd))), 0.5 * randn(H, hd))
    rbound = wkv_bound(B, T, H, hd, s0=False)
    wkv["rank"] = {
        "shape": {"B": B, "T": T, "H": H, "hd": hd},
        "ms": kernel_device_ms(lambda: WK.wkv6(*xs), 10, WK.KERNEL_NAME,
                               per_call=WK.KERNELS_PER_CALL),
        "call_ms": cuda_ms(lambda: wops.wkv6(*xs), 10),
        "plain_ms": cuda_ms(lambda: wref.wkv_plain(*xs), 2), **rbound}
    print(f"wkv6 at phase 12(d)'s rank shape (B={B}, T={T}, H={H}, "
          f"hd={hd}): both kernels {wkv['rank']['ms']:.6f} ms on the "
          f"device ({wkv['rank']['ms'] / rbound['bound_ms']:.2f}x the "
          f"bound), {wkv['rank']['call_ms']:.6f} ms a call, plain "
          f"{wkv['rank']['plain_ms']:.6f} ms; bound "
          f"{rbound['bound_ms']:.6f} ms by {rbound['bound_by']}")
    del xs
    return {"rglru": {"max_abs_err": max(worst.values()),
                      "max_abs_err_fwd": worst["fwd"],
                      "max_abs_err_bwd": worst["bwd"], "legs": shapes,
                      "floor_ms": floor_ms, "floor_call_ms": floor_call_ms},
            "wkv": {"max_abs_err": max(wkv_worst, strong),
                    "strong_decay_max_abs_err": strong, **wkv}}


# -- phase 3, continued: the storage path's stream cipher and checksum --------
INT32_OPS = 64 * 132 * 1.98e9   # H100 SXM: 64 INT32 lanes an SM, 132 SMs,
#                                 1.98 GHz (NVIDIA's Hopper white paper)
CIPHER_OPS_A_WORD = 11          # add, mul-add, 3 x (shift, xor), 2 mul, xor
FLETCHER_OPS_A_WORD = 3         # add to s1, weight, mul-add to s2
CIPHER_KEYS = [(0xC0FFEE, 42),  # the reference's (tests/test_kernels.py:257)
               ((1 << 32) + 0xC0FFEE, (1 << 33) + 42)]   # both >= 2^32
INTEGRITY_BLOCK = MiB           # the engine checksums and crypto pages 1 MiB


def integrity_bound(kernel: str, n_bytes: int) -> dict:
    """The least time an H100 SXM could take: the cipher reads and writes
    every byte, the checksum reads every byte and writes 8 (bytes); the
    integer operations a word over the INT32 rate (operations)."""
    from repro_torch.launch.mesh import HBM_BW
    words = (n_bytes + 3) // 4
    if kernel == "stream_cipher":
        nbytes, ops = 2 * n_bytes, CIPHER_OPS_A_WORD * words
    else:
        nbytes, ops = n_bytes + 8, FLETCHER_OPS_A_WORD * words
    ops_ms = ops / INT32_OPS * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return {"bytes": nbytes, "int_ops": ops, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def _int64(t):
    """A u8 or u32 tensor's values as int64 (torch has few uint32 ops)."""
    import torch
    from repro_torch.kernels.stream_cipher import ref as scref
    flat = t.reshape(-1)
    if flat.dtype == torch.uint32:
        return scref.u32_to_int64(flat)
    return flat.to(torch.int64)


def _bit_err(got, want) -> int:
    """Largest absolute difference of two u8 or u32 results' elements."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{got.dtype} {tuple(got.shape)} != {want.dtype} "
          f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((_int64(got) - _int64(want)).abs().max())


def integrity_phase(seed: int, size: int) -> dict:
    """stream_cipher and fletcher bit-exact against their plain versions on
    the card: the reference's test shapes, ragged u8, float32, bf16 and u8
    of 333 elements, u8 views starting 1, 2 and 3 bytes into a word, key
    and nonce >= 2^32 and a buffer of `size` bytes (the involution there
    too); then both timed at a 1 MiB block and at `size`."""
    import torch
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.kernels.fletcher import kernel as FLK
    from repro_torch.kernels.fletcher import ops as flops
    from repro_torch.kernels.fletcher import ref as flref
    from repro_torch.kernels.stream_cipher import kernel as SCK
    from repro_torch.kernels.stream_cipher import ops as scops
    from repro_torch.kernels.stream_cipher import ref as scref

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)

    def u8(n: int):
        return torch.randint(0, 256, (n,), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def u32(n: int):
        return torch.randint(-2**31, 2**31, (n,), generator=gen,
                             device="cuda", dtype=torch.int32).view(
                                 torch.uint32)

    big = u8(size)
    buf = u8(10003)
    shifted = [(f"u8 from byte {k}", buf[k:k + 9001]) for k in (1, 2, 3)]
    check(all(t.data_ptr() % 4 for _, t in shifted), "views are aligned")
    f32 = torch.randn(333, generator=gen, device="cuda")
    common = ([(f"u8 n={n}", u8(n)) for n in (999, 1013)] + shifted
              + [(f"{size} B", big)])
    cipher_in = [(f"u32 n={n}", u32(n)) for n in (4, 100, 4096, 8193)] \
        + common + [("u8 n=333", u8(333))]
    fletcher_in = [(f"u32 n={n}", u32(n))
                   for n in (1, 7, 256, 2048, 2049, 10000)] + common + [
        ("float32 n=333", f32), ("bfloat16 n=333", f32.bfloat16()),
        ("u8 n=333", u8(333))]

    worst = {"stream_cipher": 0, "fletcher": 0}
    n_checks = 0
    for key, nonce in CIPHER_KEYS:
        for what, x in cipher_in:
            got = scops.stream_cipher(x, key, nonce)
            want = scref.stream_cipher_torch(x, key, nonce)
            torch.cuda.synchronize()
            err = _bit_err(got, want)
            worst["stream_cipher"] = max(worst["stream_cipher"], err)
            n_checks += 1
            check(err == 0, f"stream_cipher != plain version: {what}, "
                  f"key {key:#x}, nonce {nonce:#x}")
            del got, want
    back = scops.stream_cipher(scops.stream_cipher(big, *CIPHER_KEYS[1]),
                               *CIPHER_KEYS[1])
    check(torch.equal(back, big), f"stream_cipher twice != input at {size} B")
    del back
    for what, x in fletcher_in:
        got = flops.fletcher_checksum(x)
        want = flref.fletcher_checksum_torch(x)
        torch.cuda.synchronize()
        err = _bit_err(got, want)
        worst["fletcher"] = max(worst["fletcher"], err)
        n_checks += 1
        check(err == 0, f"fletcher != plain version: {what}")
    print(f"stream_cipher and fletcher bit-exact with their plain versions "
          f"in {n_checks} checks; stream_cipher twice restores {size} B")

    # times at a 1 MiB block (the 128 blocks taken in turn span 128 MiB,
    # more than the 50 MB L2, so each launch finds its block in HBM, as on
    # the path), at `size` and at the floor (16 bytes: one CTA): `ms` the
    # device time of every operation of a kernel call (profiler;
    # `ops_per_call` of them, memsets included), `call_ms` the wrapper's
    # call (CUDA events, launch overhead included), `plain_ms` the plain
    # version
    blocks = [big[i:i + INTEGRITY_BLOCK]
              for i in range(0, 128 * INTEGRITY_BLOCK, INTEGRITY_BLOCK)]
    key, nonce = CIPHER_KEYS[0]
    out = {}
    for name, kern, wrap, plain, kname in (
            ("stream_cipher", lambda x: SCK.cipher(x, key, nonce),
             lambda x: scops.stream_cipher(x, key, nonce),
             lambda x: scref.stream_cipher_torch(x, key, nonce),
             SCK.KERNEL_NAME),
            ("fletcher", FLK.fletcher, flops.fletcher_checksum,
             flref.fletcher_checksum_torch, FLK.KERNEL_NAME)):
        legs = {}
        for leg, xs, iters, plain_iters in (
                ("1MiB", blocks, 100, 20), (f"{size >> 20}MiB", [big], 10, 3),
                ("floor", [big[:16]], 100, 20)):
            turn = itertools.cycle(xs)
            ms, by_op, ops = device_ops_ms(lambda: kern(next(turn)), iters,
                                           (kname, MEMSET))
            call_ms = cuda_ms(lambda: wrap(next(turn)), iters)
            plain_ms = cuda_ms(lambda: plain(next(turn)), plain_iters)
            bound = integrity_bound(name, xs[0].numel())
            legs[leg] = {"n_bytes": xs[0].numel(), "ms": ms,
                         "ops_per_call": ops, "ms_by_op": by_op,
                         "call_ms": call_ms, "plain_ms": plain_ms, **bound}
            print(f"{name} at {leg}: {ops} device operation(s) a call, "
                  f"{ms:.6f} ms on the device ({by_op}), {call_ms:.6f} ms a "
                  f"call, plain {plain_ms:.6f} ms; bound "
                  f"{bound['bound_ms']:.6f} ms by {bound['bound_by']}: "
                  f"{bound['bytes']} B / {HBM_BW:.3g} B/s, "
                  f"{bound['int_ops']} integer ops / {INT32_OPS:.3g} op/s = "
                  f"{bound['ops_ms']:.6f} ms")
        check(legs["1MiB"]["ops_per_call"] == 1,
              f"{name} at 1 MiB is {legs['1MiB']['ops_per_call']} device "
              "operations a call, not one")
        out[name] = {"max_abs_err": worst[name], "legs": legs}
    out["fletcher"]["sweep"] = fletcher_sweep(big)
    out["host_parts_us"] = host_call_parts(blocks[0])
    return out


SWEEP_BYTES = (4 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
HOST_LOOP = 1000                # calls a host part is timed over


def fletcher_sweep(big) -> dict:
    """fletcher's kernel call at every size of SWEEP_BYTES, bit-exact with
    the plain version, then the device time of every operation of a call
    beside the bound, blocks taken in turn from `big` (HBM-cold from 1 MiB
    up, where the blocks in turn span more than the 50 MB L2; warm below).
    A call is one kernel at every size: there is no second path and so no
    threshold between paths."""
    import torch
    from repro_torch.kernels.fletcher import kernel as FLK
    from repro_torch.kernels.fletcher import ref as flref
    rows = {}
    for n in SWEEP_BYTES:
        xs = [big[i * n:(i + 1) * n]
              for i in range(min(128, big.numel() // n))]
        check(torch.equal(FLK.fletcher(xs[0]).view(torch.int32),
                          flref.fletcher_checksum_torch(xs[0]).view(
                              torch.int32)),
              f"fletcher != plain version at {n} B")
        turn = itertools.cycle(xs)
        ms, _, ops = device_ops_ms(lambda: FLK.fletcher(next(turn)), 100,
                                   (FLK.KERNEL_NAME, MEMSET))
        bound_ms = integrity_bound("fletcher", n)["bound_ms"]
        rows[str(n)] = {"ms": ms, "ops_per_call": ops, "bound_ms": bound_ms}
        print(f"fletcher at {n} B: {ops} device operation(s) a call, "
              f"{ms:.6f} ms, bound {bound_ms:.6f} ms")
        check(ops == 1, f"fletcher at {n} B is {ops} device operations")
    return rows


def host_call_parts(x) -> dict:
    """The host time of each part of a wrapper's call on `x` (a 1 MiB u8
    block on the card), us a call, each part alone over HOST_LOOP calls,
    beside the whole call's host time; and the parts an earlier wrapper
    ran that these no longer run on a tensor already on the current card
    (`old_*`)."""
    import threading
    import torch
    from repro_torch.kernels import _launch
    from repro_torch.kernels.fletcher import kernel as FLK
    from repro_torch.kernels.fletcher import ops as flops
    from repro_torch.kernels.fletcher import ref as flref
    from repro_torch.kernels.stream_cipher import kernel as SCK
    from repro_torch.kernels.stream_cipher import ops as scops
    dev, n = x.device, x.numel()
    f_lib, c_lib = FLK._lib(), SCK._lib()
    sums, ciphered = torch.empty(2, dtype=torch.uint32, device=dev), \
        torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lock, counts = threading.Lock(), {"checksum": 0}

    def count() -> None:
        with lock:
            counts["checksum"] += 1

    def device_context() -> None:
        with torch.cuda.device(dev):
            pass
    parts = {
        "as_tensor": lambda: scops.as_tensor(x, None),
        "as_bytes": lambda: flref.as_bytes(x),
        "checks": lambda: _launch.check_bytes(x, "fletcher"),
        "zeroed pair": lambda: FLK._zeroed_pair(dev.index, stream),
        "torch.empty_like": lambda: torch.empty_like(x),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes fletcher": lambda: f_lib.fletcher(
            x.data_ptr(), n, sums.data_ptr(), stream),
        "ctypes stream_cipher": lambda: c_lib.stream_cipher(
            x.data_ptr(), ciphered.data_ptr(), n, 1, 2, stream),
        "launch count": count,
        "old_empty(2)": lambda: torch.empty(2, dtype=torch.uint32,
                                            device=dev),
        "old_to": lambda: x.to(dev),
        "old_reshape": lambda: x.reshape(-1),
        "old_contiguous": x.contiguous,
        "old_device_context": device_context,
        "old_current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "fletcher_checksum": lambda: flops.fletcher_checksum(x),
        "stream_cipher": lambda: scops.stream_cipher(x, 1, 2),
    }
    us = {}
    for part, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_LOOP):
            fn()
        us[part] = (time.perf_counter() - t0) / HOST_LOOP * 1e6
        torch.cuda.synchronize()
    print("host parts of a 1 MiB call (us a call, each alone over "
          f"{HOST_LOOP} calls):", json.dumps(us))
    return us


def integrity_stream_phase(placed: list, expect, seed: int) -> dict:
    """The main path of the two kernels: the stream direct_phase placed
    into HBM, cut into 1 MiB blocks, held against the storage path's own
    numpy twins on the host bytes. Every block's fletcher checksum against
    media.checksum, and every 16th block's stream_cipher against
    InlineCrypto.apply at the engine's nonce oid * 2^20 + block, with an
    oid >= 4096 so that the nonce's high half is folded into the key
    (`_prf_words`); and one partial block at a byte offset that is not a
    multiple of 4, through the word-offset nonce of the keystream."""
    import torch
    from repro_torch.core import media
    from repro_torch.core.smartnic import InlineCrypto
    from repro_torch.kernels.fletcher import ops as flops
    from repro_torch.kernels.stream_cipher import ops as scops

    blocks = []
    for t in placed:
        raw = t.reshape(-1).view(torch.uint8)
        blocks += [raw[i:i + INTEGRITY_BLOCK]
                   for i in range(0, raw.numel(), INTEGRITY_BLOCK)]
    check(len(blocks) * INTEGRITY_BLOCK == len(expect),
          f"{len(blocks)} blocks of {INTEGRITY_BLOCK} B for {len(expect)} B")
    host = memoryview(expect)
    crypto = InlineCrypto((0xC0FFEE << 32) + seed, cache_bytes=0)
    oid = 4096 + 7

    def engine_nonce(b: int, offset: int = 0) -> tuple:
        nonce = oid * (1 << 20) + b
        key = int(crypto.key) ^ crypto._fmix32(nonce >> 32)
        return key, (nonce + offset // 4) & 0xFFFFFFFF

    flops.reset_launches()
    scops.reset_launches()
    t0 = time.perf_counter()
    sums = [flops.fletcher_checksum(blk).view(torch.int32) for blk in blocks]
    card = [(s1 & 0xFFFFFFFF) | ((s2 & 0xFFFFFFFF) << 32)
            for s1, s2 in torch.stack(sums).cpu().tolist()]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [media.checksum(host[b * INTEGRITY_BLOCK:(b + 1) * INTEGRITY_BLOCK])
            for b in range(len(blocks))]
    host_s = time.perf_counter() - t0
    bad = [b for b in range(len(blocks)) if card[b] != want[b]]
    check(not bad, f"fletcher != media.checksum on blocks {bad[:8]}")

    ciphered = list(range(0, len(blocks), 16))
    for b in ciphered:
        got = scops.stream_cipher(blocks[b], *engine_nonce(b))
        ref_bytes = crypto.apply(
            host[b * INTEGRITY_BLOCK:(b + 1) * INTEGRITY_BLOCK],
            nonce=oid * (1 << 20) + b)
        check(np.array_equal(got.cpu().numpy(), ref_bytes),
              f"stream_cipher != InlineCrypto.apply on block {b}")
    b, offset, n = 5, 4099, 300001          # offset % 4 == 3
    head = offset % 4
    got = scops.stream_cipher(blocks[b][offset - head:offset + n],
                              *engine_nonce(b, offset))[head:]
    base = b * INTEGRITY_BLOCK + offset
    check(np.array_equal(got.cpu().numpy(), crypto.apply(
        host[base:base + n], nonce=oid * (1 << 20) + b, offset=offset)),
        f"stream_cipher != InlineCrypto.apply at block {b} byte {offset}")
    torch.cuda.synchronize()
    launches = {"stream_cipher": scops.launches()["cipher"],
                "fletcher": flops.launches()["checksum"]}
    print(f"integrity on the placed stream: {len(blocks)} blocks' fletcher "
          f"equal to media.checksum (card {card_s:.3f} s with the copy back, "
          f"host {host_s:.3f} s), {len(ciphered)} blocks and a partial one "
          f"at byte {offset} ciphered equal to InlineCrypto.apply; "
          f"launches {launches}")
    check(launches == {"stream_cipher": len(ciphered) + 1,
                       "fletcher": len(blocks)},
          f"launches {launches} != what the step makes")
    return {"blocks": len(blocks), "ciphered_blocks": len(ciphered) + 1,
            "launches": launches, "card_checksum_s": card_s,
            "host_checksum_s": host_s}


# -- phase 7: serving granite-3-2b at full width from the store ---------------
SERVE_REQUESTS, SERVE_BATCH, SERVE_PLEN, SERVE_MAX_NEW = 8, 4, 1024, 32
SHALLOW_LAYERS = 2          # depth of the float32 whole-model check


def first_layers(tree: dict, n: int) -> dict:
    """The stacked layer params cut to their first n layers (views)."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


COMPILED = ("prefill", "decode")   # the engine's captured steps
KERNEL_KIND = {  # a path kernel -> its kind in KERNEL_KINDS, kernels a call
    "flash_attention_fwd": ("flash fwd", 1), "rglru_scan": ("rglru scan", 1),
    "wkv6": ("wkv scan", 2), "flash_attention_bwd": ("flash bwd", 2),
    "flash_decode": ("flash decode", 2)}


def graph_kernels(replay) -> tuple:
    """(one traced call of `replay`, a captured graph's replay: wall time,
    busy time, idle share and device operations by kind; the kernels of
    each kind in the graph, the most TRACE_ATTEMPTS traces of it showed,
    since the profiler only ever loses records)."""
    first, most = None, {}
    for _ in range(TRACE_ATTEMPTS):
        trace = device_breakdown(replay)
        first = first or trace
        for kind, n in trace["device_ops_by_kind"].items():
            most[kind] = max(most.get(kind, 0), n)
    return first, most


def _zero_stats(eng) -> None:
    """An engine's counts and times back to 0 after its warm-up wave."""
    eng.steps = eng.slot_steps = eng.active_slot_steps = 0
    eng.prefill_s = eng.decode_s = 0.0
    eng.prefill_step.calls = eng.decode_step.calls = 0


def _run_waves(eng, reqs) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(reqs), SERVE_BATCH):
        eng.run_wave(reqs[i:i + SERVE_BATCH])
    return time.perf_counter() - t0


def _one_wave(eng, wave: list) -> list:
    """A wave of a prefill and one decode step of `wave`'s prompts through
    `eng`: copies of the prefill's and the decode step's logits and of the
    decode cache after it, as (name, tensor) pairs."""
    import torch
    from repro_torch.launch.serve import Request
    from repro_torch.train.trainer import map_tree
    eng.run_wave([Request(r.rid, r.prompt, 2) for r in wave])
    out = [("prefill logits", eng.logits["prefill"].clone()),
           ("decode logits", eng.logits["decode"].clone())]
    map_tree(lambda t: out.append(("cache", t.clone())), eng.cache)
    torch.cuda.synchronize()
    return out


def _same_state(captured: list, eager: list, tol: float, label: str) -> dict:
    """`_one_wave` through the engine's captured steps against its eager
    steps from the same params and prompts: bit for bit, or else within
    `tol` (the difference printed)."""
    import torch
    out, identical = {}, True
    for (name, a), (_, b) in zip(captured, eager, strict=True):
        err, ok = in_tolerance(a, b, tol)
        check(ok, f"{label}: captured {name} off the eager step's by {err}")
        identical &= bool(torch.equal(a, b))
        out[name] = max(out.get(name, 0.0), err)
    print(f"{label}: captured prefill and decode vs the eager steps from the "
          f"same state: {'bit for bit' if identical else 'not bit for bit'}"
          f"; max abs difference {out} (held at {tol})")
    return {"captured_vs_eager_identical": identical,
            "captured_vs_eager_max_abs_diff": out}


def _serve_from_store(api, params, mctx, vocab: int, seed: int, label: str,
                      reset, counts, plen: int = SERVE_PLEN,
                      engine=None, tol: float = 2e-2) -> tuple:
    """The serve phases' traffic: SERVE_REQUESTS prompts of `plen` tokens
    written to a dpu-mode RDMA store and read back, then served in waves of
    SERVE_BATCH, up to SERVE_MAX_NEW new tokens each, through BatchedEngine
    (or `engine(max_seq, compiled)`, an engine like it) with its prefill
    and decode captured as CUDA graphs, after a warm-up wave that captures
    them. `reset()` sets the kernel counts to 0 just before the timed run
    and `counts()` reads them (name -> wrapper launches) just after; a
    kernel's launches are those plus its kernels in each captured graph
    (traced replays) times the graph's replays in the run. The same
    requests then go through the engine's eager steps (their greedy
    tokens compared, printed), and one wave from the same state through
    both (held at `tol`, `_same_state`), the captured engine freed before
    the eager one runs. Returns (requests, eager engine, stats,
    launches)."""
    import torch
    from repro_torch.core import ROS2Client
    from repro_torch.launch.serve import (BatchedEngine, Request,
                                          read_prompt, write_prompts)

    if engine is None:
        def engine(max_seq, compiled):
            return BatchedEngine(api, params, mctx, SERVE_BATCH, plen,
                                 max_seq, compiled=compiled)
    client = ROS2Client(mode="dpu", transport="rdma", scrub_interval_s=None)
    try:
        t0 = time.perf_counter()
        write_prompts(client, SERVE_REQUESTS, plen, vocab, seed)
        rng = np.random.default_rng(seed)         # write_prompts' draws
        written = [rng.integers(0, vocab, plen, dtype=np.int32)
                   for _ in range(SERVE_REQUESTS)]
        rng = np.random.default_rng(seed)         # launch/serve.py main's draw
        reqs = [Request(i, read_prompt(client, i, plen),
                        int(rng.integers(SERVE_MAX_NEW // 2,
                                         SERVE_MAX_NEW + 1)))
                for i in range(SERVE_REQUESTS)]
        prompts_s = time.perf_counter() - t0
        for r, w in zip(reqs, written):
            check(np.array_equal(r.prompt, w), f"prompt {r.rid} read back "
                  "from the store differs from what was written")
        dpu_ops = client.dpu.ops_processed
    finally:
        client.close()

    max_seq = plen + SERVE_MAX_NEW + 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(max_seq, COMPILED)
    # the warm-up wave outside the counted run captures both steps
    eng.run_wave([Request(-1, reqs[0].prompt, 2)])
    capture = {"prefill_s": eng.prefill_step.capture_s,
               "decode_s": eng.decode_step.capture_s,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    _zero_stats(eng)
    torch.cuda.synchronize()
    reset()
    wall = _run_waves(eng, reqs)
    wrapper = counts()
    replays = {"prefill": eng.prefill_step.calls,
               "decode": eng.decode_step.calls}
    peak = torch.cuda.max_memory_allocated()
    new_tokens = sum(len(r.out) for r in reqs)
    check(all(r.done for r in reqs), "a request did not finish")
    check(all(0 <= t < vocab for r in reqs for t in r.out),
          "a token outside the vocabulary")
    check(replays == {"prefill": len(reqs) // SERVE_BATCH,
                      "decode": eng.steps},
          f"{label}: {replays} replays for {eng.steps} decode steps")
    waves = replays["prefill"]
    # what each graph holds, and one traced replay of each
    with torch.inference_mode():
        pre_trace, pre_kernels = graph_kernels(
            lambda: eng.prefill_step(params, eng.prefill_step.buffers[
                "inputs"]))
        dec_trace, dec_kernels = graph_kernels(
            lambda: eng.decode_step(params))
    launched, by_graph = {}, {}
    for name, n in wrapper.items():
        kind, per_call = KERNEL_KIND[name]
        in_graphs = (pre_kernels.get(kind, 0) * replays["prefill"]
                     + dec_kernels.get(kind, 0) * replays["decode"])
        check(in_graphs % per_call == 0, f"{name}: {in_graphs} kernels")
        launched[name] = n + in_graphs // per_call
        by_graph[name] = {"wrapper_launches": n,
                          "prefill_graph_kernels": pre_kernels.get(kind, 0),
                          "decode_graph_kernels": dec_kernels.get(kind, 0),
                          "replays": replays}
    occ = eng.active_slot_steps / max(eng.slot_steps, 1)
    stats = {"requests": len(reqs), "waves": waves,
             "prompt_tokens": plen * len(reqs),
             "new_tokens": new_tokens, "prompts_s": prompts_s,
             "wall_s": wall, "tokens_per_s": new_tokens / wall,
             "slot_occupancy": occ, "prefill_s": eng.prefill_s,
             "decode_s": eng.decode_s, "decode_steps": eng.steps,
             "prefill_s_per_wave": eng.prefill_s / waves,
             "decode_ms_per_step": 1e3 * eng.decode_s / eng.steps,
             "dpu_ops": dpu_ops, "capture": capture,
             "trace_prefill_replay": pre_trace,
             "trace_decode_replay": dec_trace,
             "launches_by_graph": by_graph,
             "peak_mem_gb": peak / 1e9}
    print(f"[{label}] {len(reqs)} requests of {plen} prompt tokens in "
          f"{waves} waves, captured steps: {new_tokens} new tokens, "
          f"{new_tokens / wall:.3f} tok/s, slot occupancy {100 * occ:.1f}%, "
          f"prefill {eng.prefill_s / waves:.6f} s a wave, decode "
          f"{stats['decode_ms_per_step']:.6f} ms a step over {eng.steps} "
          f"steps; capture {capture['prefill_s']:.3f} s (prefill) + "
          f"{capture['decode_s']:.3f} s (decode), peak "
          f"{peak / 1e9:.3f} GB; " + ", ".join(
              f"{k} launches {v} ({wrapper[k]} by the wrapper, "
              f"{by_graph[k]['prefill_graph_kernels']} kernels in the "
              f"prefill graph x {replays['prefill']} replays + "
              f"{by_graph[k]['decode_graph_kernels']} in the decode graph "
              f"x {replays['decode']})" for k, v in launched.items()))
    print(f"[{label}] a traced prefill replay: wall "
          f"{pre_trace['wall_s']:.6f} s, busy "
          f"{pre_trace['device_busy_s']:.6f} s, idle "
          f"{pre_trace['idle_share']:.4f}; a traced decode replay: wall "
          f"{1e3 * dec_trace['wall_s']:.6f} ms, busy "
          f"{1e3 * dec_trace['device_busy_s']:.6f} ms, idle "
          f"{dec_trace['idle_share']:.4f}, {dec_trace['device_ops']} device "
          "operations")

    # one wave from a state the eager steps will start from too; then the
    # graphs' pool goes back to the card before the eager steps run (dbrx's
    # would not fit beside an eager prefill)
    captured = _one_wave(eng, reqs[:SERVE_BATCH])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the same requests through the eager steps: their times and tokens
    eager = engine(max_seq, ())
    eager.run_wave([Request(-1, reqs[0].prompt, 2)])
    _zero_stats(eager)
    ereqs = [Request(r.rid, r.prompt, r.max_new) for r in reqs]
    ewall = _run_waves(eager, ereqs)
    same = sum(a == b for r, e in zip(reqs, ereqs)
               for a, b in zip(r.out, e.out))
    stats.update({"eager_wall_s": ewall,
                  "eager_tokens_per_s": new_tokens / ewall,
                  "eager_prefill_s_per_wave": eager.prefill_s / waves,
                  "eager_decode_ms_per_step": 1e3 * eager.decode_s
                  / eager.steps,
                  "greedy_tokens_as_eager": same})
    print(f"[{label}] eager steps: {new_tokens / ewall:.3f} tok/s, prefill "
          f"{eager.prefill_s / waves:.6f} s a wave, decode "
          f"{stats['eager_decode_ms_per_step']:.6f} ms a step; greedy tokens "
          f"of the captured run equal the eager run's in {same} of "
          f"{new_tokens}")
    stats.update(_same_state(captured, _one_wave(eager, reqs[:SERVE_BATCH]),
                             tol, label))
    return reqs, eager, stats, launched


def _recorded_flash(fn) -> tuple:
    """(fn(), every flash_attention call it made as (q, k, v, kw, out))."""
    from repro_torch.kernels.flash_attention import ops
    calls = []
    kernel_path = ops.flash_attention

    def recording(q, k, v, **kw):
        out = kernel_path(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    ops.flash_attention = recording          # layers.attention looks it up
    try:
        return fn(), calls
    finally:
        ops.flash_attention = kernel_path


def attention_f64(q, k, v, scale: float):
    """Causal GQA attention computed in float64 from q, k and v (B, T, H,
    D) as they are, a batch row at a time: the exact answer on the inputs
    a flash call was given."""
    import torch
    B, T, H, D = q.shape
    KH = k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    hidden = ~torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        s = torch.einsum("tkgd,skd->kgts",
                         q[b].double().reshape(T, KH, H // KH, D),
                         k[b].double()) * scale
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
        out[b] = torch.einsum("kgts,skd->tkgd", p,
                              v[b].double()).reshape(T, H, D)
    return out


def _flash_calls_err(calls: list, tol: float, label: str) -> dict:
    """Every recorded (causal, unwindowed) flash call of a prefill held
    against exact attention on its own inputs (`attention_f64`) at `tol`;
    the kernel against the plain version at these shapes is flash_phase's
    (FLASH_CASES, random inputs). Not against the plain version here: at
    D = 128 the random-weight models' scaled scores spread to a std of
    313-363 and |v| to 177, where the plain version's float32 scores put
    it up to 0.036 off exact, more than this tolerance where the answer
    is near 0: rounded to bf16 it reaches 1.14 times the tolerance off
    exact, and the kernel falls outside the tolerance of it at one of the
    VLM's calls, before that rounding and after, while the kernel stays
    within 0.31 of the tolerance off exact at every call
    (scripts/flash_d128_accuracy_witness.py). The kernel's distance to
    the plain version, before and after its bf16 rounding, is printed."""
    from repro_torch.kernels.flash_attention import ref as fref
    worst = {"exact": 0.0, "plain": 0.0, "rounded plain": 0.0}
    for i, (q, k, v, kw, out) in enumerate(calls):
        check(kw["causal"] and kw["window"] is None and kw["softcap"] is None,
              f"{label}: flash call {i} is not plain causal attention")
        scale = kw["scale"] or q.shape[-1] ** -0.5
        err, ok = in_tolerance(out, attention_f64(q, k, v, scale), tol)
        check(ok, f"{label}: flash call {i} off exact attention by {err} "
              "on the path's inputs")
        worst["exact"] = max(worst["exact"], err)
        for name, plain in (
                ("plain", lambda: fref.attention_ref(
                    q.float(), k.float(), v.float(), scale=scale)),
                ("rounded plain", lambda: fref.attention_ref(
                    q, k, v, scale=scale))):
            worst[name] = max(worst[name], in_tolerance(out, plain(), tol)[0])
    print(f"{label}: every one of {len(calls)} flash calls of a prefill "
          f"wave within {tol} of exact (float64) attention on its own "
          f"inputs: max abs error {worst['exact']:.6f}; against the plain "
          f"version {worst['plain']:.6f} (float32), "
          f"{worst['rounded plain']:.6f} (rounded to bf16)")
    return {"flash_call_max_abs_err": worst["exact"],
            "flash_call_vs_plain_max_abs_err": worst["plain"],
            "flash_call_vs_rounded_plain_max_abs_err":
                worst["rounded plain"]}


def _f32_paths(cut, cut_params, inputs, mctx) -> tuple:
    """`cut` in float32 through "flash" and "jnp" on the same inputs:
    (max abs difference of the last-token logits, whether it is within
    1e-3, rows whose first greedy token agrees, logit scale)."""
    import torch
    from repro_torch.models.api import ModelAPI
    with torch.inference_mode():
        f32 = [ModelAPI(cut.replace(attn_impl=impl)).prefill(
            cut_params, inputs, mctx)[0] for impl in ("flash", "jnp")]
    diff, ok = in_tolerance(f32[0], f32[1], 1e-3)
    agree = int((f32[0].argmax(-1) == f32[1].argmax(-1)).sum())
    return diff, ok, agree, float(f32[1].abs().max())


def _paths_agree(api, params, cut, cut_params, inputs, mctx,
                 label: str) -> dict:
    """The bf16 model at its depth through "flash" and "jnp", then `cut`
    in float32 through both: last-token logits within 1e-3 and every
    first greedy token the same. The bf16 comparison is printed, not
    held: the reference's fan-in rule (over w_q's head axis) makes the
    random-weight models chaotic at these widths, so the two paths' bf16
    roundings drift apart over the layers, as the reference's own flash
    and plain paths do on the CPU (scripts/attention_paths_witness.py);
    the per-call kernel checks and the shallow float32 check are what
    hold the path."""
    import torch
    from repro_torch.models.api import ModelAPI
    with torch.inference_mode():
        fl = api.prefill(params, inputs, mctx)[0].float()
        pl = ModelAPI(api.cfg.replace(attn_impl="jnp")).prefill(
            params, inputs, mctx)[0].float()
        check(bool(torch.isfinite(fl).all()), f"{label}: logits not finite")
        diff = float((fl - pl).abs().max())
        logit_scale = float(pl.abs().max())
        agree = int((fl.argmax(-1) == pl.argmax(-1)).sum())
        print(f"{label}: prefill logits, flash vs plain path (bf16, "
              f"{api.cfg.n_layers} layers): max abs difference {diff:.6f} at "
              f"logit scale {logit_scale:.6f}; first greedy token agrees in "
              f"{agree} of {len(fl)} rows")
        rows = len(fl)
        del fl, pl
    f32_diff, ok, f32_agree, scale = _f32_paths(cut, cut_params, inputs,
                                                mctx)
    print(f"{label}: prefill logits, flash vs plain path (float32, "
          f"{cut.n_layers} layers, full width): max abs difference "
          f"{f32_diff:.3e} at logit scale {scale:.6f}; first greedy token "
          f"agrees in {f32_agree} of {rows} rows")
    check(ok, f"{label}: float32 prefill logits of the two paths differ by "
          f"{f32_diff}")
    check(f32_agree == rows, f"{label}: float32 first greedy tokens "
          f"differ: {f32_agree} of {rows} rows agree")
    return {"prefill_logit_max_abs_diff": diff,
            "prefill_logit_scale": logit_scale, "first_token_agree": agree,
            "f32_shallow_layers": cut.n_layers,
            "f32_shallow_logit_max_abs_diff": f32_diff,
            "f32_shallow_first_token_agree": f32_agree}


def _trace_wave(api, params, mctx, inputs, grow, label: str) -> dict:
    """One traced prefill of `inputs` and four traced decode steps on its
    cache, grown by `grow` (the engine's _pad_cache)."""
    import torch
    with torch.inference_mode():
        prefill = device_breakdown(lambda: api.prefill(params, inputs, mctx))
        logits, cache = api.prefill(params, inputs, mctx)
        cache = grow(cache)
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full(tok.shape, inputs["tokens"].shape[1],
                         dtype=torch.int32, device="cuda")

        def steps() -> None:
            for i in range(4):
                api.decode(params, {"token": tok, "pos": pos + i}, cache,
                           mctx)
        decode = device_breakdown(steps)
    decode["device_ops_per_step"] = decode["device_ops"] / 4
    print(f"traced prefill of one wave ({label}):", prefill)
    print(f"traced 4 decode steps ({label}):", decode)
    return {"trace_prefill": prefill, "trace_decode_4_steps": decode}


def _init_on_card(api, seed: int, times: dict, label: str) -> dict:
    """The model's float32 params made on the card from the seed (the
    memory the previous phases cached handed back first), timed into
    times[f"{label}_init_params_s"]."""
    import torch
    from repro_torch.models.params import count_params, init_params
    torch.cuda.empty_cache()
    cfg = api.cfg
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype))
    torch.cuda.synchronize()
    times[f"{label}_init_params_s"] = time.perf_counter() - t0
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {count_params(api.param_defs())} params "
          f"({cfg.param_dtype}, computing in {cfg.compute_dtype}) on the card "
          f"in {times[f'{label}_init_params_s']:.3f} s: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return params


def _flash_counts() -> dict:
    """The flash kernels' wrapper launches, as `_serve_from_store` reads
    them."""
    from repro_torch.kernels.flash_attention import ops
    got = ops.launches()
    return {"flash_attention_fwd": got["fwd"], "flash_decode": got["decode"]}


def _decode_launches(label: str, stats: dict, launched: dict,
                     per_step: int) -> int:
    """Checks that the decode graph launches flash_decode `per_step` times
    a replay and that no decode call asking for "flash" took the plain
    path (eager steps included); returns the run's flash_decode calls."""
    from repro_torch.kernels.flash_attention import kernel_decode as KD
    from repro_torch.kernels.flash_attention import ops
    in_graph = stats["launches_by_graph"]["flash_decode"][
        "decode_graph_kernels"]
    check(in_graph == KD.KERNELS_PER_CALL * per_step,
          f"{label}: {in_graph} flash_decode kernels in the decode graph, "
          f"not {KD.KERNELS_PER_CALL} x {per_step} layers")
    plain = ops.launches()["decode_plain"]
    check(plain == 0, f"{label}: {plain} decode calls on the plain path")
    print(f"[{label}] flash_decode: {per_step} calls a decode replay, "
          f"{launched['flash_decode']} in the run, none on the plain path")
    return launched["flash_decode"]


def serve_phase(seed: int, times: dict) -> dict:
    import torch
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import init_params

    cfg = get_config("granite-3-2b").replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = _init_on_card(api, seed, times, "serve")

    reqs, eng, stats, launched = _serve_from_store(
        api, params, mctx, cfg.vocab, seed, "serve", ops.reset_launches,
        _flash_counts, tol=FLASH_TOL[cfg.compute_dtype])
    launches = launched["flash_attention_fwd"]
    times["serve_prompts_s"] = stats["prompts_s"]
    times["serve_s"] = stats["wall_s"]
    check(launches >= cfg.n_layers * stats["waves"],
          f"flash_attention_fwd launched {launches} times, fewer than "
          f"{cfg.n_layers} layers x {stats['waves']} waves")
    stats["flash_launches"] = launches
    stats["decode_launches"] = _decode_launches("granite-3-2b", stats,
                                                launched, cfg.n_layers)

    # one wave's prefill through the flash kernel, every layer's attention
    # held against the plain version on the very inputs the serve path gave
    # it
    wave = torch.from_numpy(np.stack([r.prompt for r in reqs[:SERVE_BATCH]]))
    with torch.inference_mode():
        _, calls = _recorded_flash(
            lambda: api.prefill(params, {"tokens": wave}, mctx))
    check(len(calls) == cfg.n_layers, f"{len(calls)} flash calls in a "
          f"prefill of {cfg.n_layers} layers")
    layer_err = 0.0
    for i, (q, k, v, kw, out) in enumerate(calls):
        want = fref.attention_ref(q, k, v, scale=kw["scale"],
                                  causal=kw["causal"], window=kw["window"],
                                  softcap=kw["softcap"])
        err, ok = in_tolerance(out, want, FLASH_TOL[cfg.compute_dtype])
        check(ok, f"layer {i}: flash attention off its plain version by "
              f"{err} on the serve path's inputs")
        layer_err = max(layer_err, err)
    q_std = float(calls[0][0].float().std())
    calls.clear()
    print(f"every layer's flash attention on the serve path's inputs within "
          f"{FLASH_TOL[cfg.compute_dtype]} of its plain version: max abs "
          f"error {layer_err:.6f} over {cfg.n_layers} layers (layer 0 q std "
          f"{q_std:.3f})")
    stats.update({"layer_attention_max_abs_err": layer_err,
                  "layer0_q_std": q_std})
    # the whole prefill against the plain attention path, and the same
    # wave at full width in float32 through the first SHALLOW_LAYERS
    # layers of the same params, before the drift sets in
    shallow = cfg.replace(n_layers=SHALLOW_LAYERS, compute_dtype="float32")
    stats.update(_paths_agree(
        api, params, shallow,
        dict(params, blocks=first_layers(params["blocks"], SHALLOW_LAYERS)),
        {"tokens": wave}, mctx, "granite-3-2b"))
    # where a wave's time goes: one traced prefill and four decode steps
    stats.update(_trace_wave(api, params, mctx, {"tokens": wave},
                             eng._pad_cache, "granite-3-2b"))

    # a small float32 model, flash against plain, to the reference's 1e-4
    small = tiny_config("granite-3-2b").replace(head_dim=64)
    sapi, splain = (ModelAPI(small.replace(attn_impl=i))
                    for i in ("flash", "jnp"))
    sparams = init_params(sapi.param_defs(),
                          torch.Generator(device="cuda").manual_seed(seed))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, small.vocab, (2, 64), dtype=np.int32))
    batch = {"tokens": toks, "labels": toks}
    with torch.inference_mode():
        lf = float(sapi.loss(sparams, batch, mctx))
        lj = float(splain.loss(sparams, batch, mctx))
    check(abs(lf - lj) <= 1e-4 + 1e-4 * abs(lj),
          f"float32 loss flash {lf} vs plain {lj}")
    print(f"tiny granite (head_dim 64, float32) loss: flash {lf:.7f}, plain "
          f"{lj:.7f}")
    stats["tiny_f32_loss"] = {"flash": lf, "plain": lj}
    return stats


# -- phase 8: serving recurrentgemma-2b and rwkv6-1.6b at full width -----------
REC_SERVE = {  # arch -> its scan kernel
    "recurrentgemma-2b": "rglru_scan",
    "rwkv6-1.6b": "wkv6",
}
REC_MAIN_ARGS = ["--requests", "4", "--batch", "2", "--prompt-len", "32",
                 "--max-new", "8"]


def _kernel_ops(kernel: str):
    """(ops module, the name the model looks up in it, the plain version a
    call is held against on its own inputs, that version's name,
    tolerance) of a scan kernel. wkv6 is held against the sequential
    recurrence (the reference's oracle, tests/test_kernels.py:163-167), not
    the chunked plain version: under the serve path's decays (w down to
    1e-21) the chunked form's cum - lw exponents depart from a float64
    recurrence by up to 1.8e-3, past 3e-4 in 8 of 24 layers, the
    sequential float32 version by 3.2e-5 and the kernel by 7.1e-5 on an
    H100 (scripts/wkv6_serve_accuracy_witness.py)."""
    if kernel == "rglru_scan":
        from repro_torch.kernels.rglru_scan import ops, ref
        return ops, "rglru_scan", ref.rglru_scan_ref, "plain version", 1e-5
    from repro_torch.kernels.rwkv6_scan import ops, ref
    return ops, "wkv6", ref.wkv_ref, "sequential version", 3e-4


def _cut_params(params: dict, cfg) -> tuple:
    """The config and params cut to the float32 check's depth (views)."""
    if cfg.family == "hybrid":
        cut = cfg.replace(n_layers=cfg.hybrid.rnn_per_attn + 1)
        return cut, {"embed": params["embed"], "ln_f": params["ln_f"],
                     "super": first_layers(params["super"], 1)}
    cut = cfg.replace(n_layers=SHALLOW_LAYERS)
    return cut, dict(params, blocks=first_layers(params["blocks"],
                                                 SHALLOW_LAYERS))


def serve_recurrent_phase(arch: str, seed: int, times: dict) -> dict:
    """Serves `arch` (hybrid or ssm) at full width from the store, as the
    granite phase does, and holds its scan kernel on the path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models import recurrent
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import count_params

    kernel = REC_SERVE[arch]
    kops, attr, plain_fn, plain_name, tol = _kernel_ops(kernel)
    cfg = get_config(arch).replace(attn_impl="flash")
    if cfg.family == "hybrid":
        n_super, n_tail = recurrent.pattern(cfg)
        per_prefill = per_step = n_super * cfg.hybrid.rnn_per_attn + n_tail
    else:
        per_prefill, per_step = cfg.n_layers, 0
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = _init_on_card(api, seed, times, arch)
    n_params = count_params(api.param_defs())

    def counts() -> dict:
        return {kernel: kops.launches()["fwd"],
                "flash_attention_fwd": flash_ops.launches()["fwd"]}

    def reset() -> None:
        kops.reset_launches()
        flash_ops.reset_launches()

    reqs, eng, stats, launched = _serve_from_store(
        api, params, mctx, cfg.vocab, seed, f"serve {arch}", reset, counts,
        tol=tol)
    launches, flash_launches = launched[kernel], launched["flash_attention_fwd"]
    times[f"{arch}_serve_s"] = stats["wall_s"]
    waves = stats["waves"]
    steps = stats["decode_steps"]
    expect = per_prefill * waves + per_step * steps
    check(launches == expect, f"{kernel} launched {launches} times; the path "
          f"implies {per_prefill} x {waves} waves + {per_step} x {steps} "
          f"decode steps = {expect}")
    check(flash_launches == 0, f"flash_attention_fwd launched "
          f"{flash_launches} times on the {arch} path")
    stats.update({"kernel_launches": launches,
                  "launches_per_prefill": per_prefill,
                  "launches_per_decode_step": per_step, "n_params": n_params})

    # one wave's prefill and one decode step, every kernel call held
    # against the plain version on the very inputs the path gave it (bf16
    # model, float32 scan inputs)
    wave = torch.from_numpy(np.stack([r.prompt for r in reqs[:SERVE_BATCH]]))
    calls = []
    kernel_path = getattr(kops, attr)

    def recording(*args):
        # copies: a decode step writes the state its h0 views in place
        kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)
        out = kernel_path(*args)
        calls.append((kept, out))
        return out

    setattr(kops, attr, recording)         # the model looks it up per call
    try:
        with torch.inference_mode():
            logits, state = api.prefill(params, {"tokens": wave}, mctx)
            n_prefill = len(calls)
            tok = logits.argmax(-1).to(torch.int32)
            pos = torch.full((SERVE_BATCH,), SERVE_PLEN, dtype=torch.int32,
                             device="cuda")
            api.decode(params, {"token": tok, "pos": pos}, state, mctx)
    finally:
        setattr(kops, attr, kernel_path)
    check((n_prefill, len(calls) - n_prefill) == (per_prefill, per_step),
          f"{n_prefill} prefill and {len(calls) - n_prefill} decode calls of "
          f"{kernel}, not {per_prefill} and {per_step}")
    mixer_err = 0.0
    for i, (args, out) in enumerate(calls):
        want = plain_fn(*args)
        for got, w in zip(out if isinstance(out, tuple) else (out,),
                          want if isinstance(want, tuple) else (want,)):
            err, ok = in_tolerance(got, w, tol)
            check(ok, f"call {i}: {kernel} off its {plain_name} by {err} "
                  "on the serve path's inputs")
            mixer_err = max(mixer_err, err)
    calls.clear()
    print(f"every {kernel} call of one wave's prefill and decode step on the "
          f"path's own inputs within {tol} of its {plain_name}: max abs "
          f"error {mixer_err:.3e} over {n_prefill} + {per_step} calls")
    stats["mixer_max_abs_err"] = mixer_err
    # the whole prefill against the plain path, and the model at full width
    # in float32 through its first layers (one super-block, or 2 layers)
    cut, cut_params = _cut_params(params, cfg.replace(compute_dtype="float32"))
    stats.update(_paths_agree(api, params, cut, cut_params, {"tokens": wave},
                              mctx, arch))
    # where a wave's time goes: one traced prefill and four decode steps
    stats.update(_trace_wave(api, params, mctx, {"tokens": wave},
                             eng._pad_cache, arch))
    del params, state, eng, logits, cut_params

    # launch/serve.py main, through its own command line, on the tiny config
    t0 = time.perf_counter()
    tok_s = launch_serve.main(["--arch", f"tiny-{arch}", *REC_MAIN_ARGS])
    times[f"{arch}_main_s"] = time.perf_counter() - t0
    check(tok_s > 0, f"launch/serve.py main --arch tiny-{arch}: {tok_s}")
    stats["main_tokens_per_s"] = tok_s
    return stats


# -- phase 9: serving the moe family at full width, the depth cut ------------
MOE_SERVE = {  # arch -> layers kept of its 40 / 60 (full width, one card)
    "dbrx-132b": 4,             # 13.0 GB a layer + 4.9 GB embed and unembed
    "deepseek-v2-236b": 3,      # 15.9 GB a layer + 4.2 GB
}
FP8_ARCH = "dbrx-132b"          # the reference's fp8 dispatch config
FP8_EDGES = (448.0, -448.0, 463.99, 464.0, -464.0, 464.01, -466.0, 480.0,
             1e4, float("inf"), float("-inf"), float("nan"), 0.0, -0.0,
             2.0 ** -9, 2.0 ** -10, 1e-30)


def _fp8_dispatch_check(api, params, mctx, wave, seed: int) -> dict:
    """One prefill wave with the float8_e4m3fn dispatch: finite logits and
    a loss within 10% of the bf16 dispatch's (tests/test_perf_variants.py);
    then the cast rule (NaN above 464 and for ±inf) on the card, bit for
    bit the CPU's, which the CPU tests hold against JAX."""
    import dataclasses
    import torch
    from repro_torch.models import moe
    from repro_torch.models.api import ModelAPI
    cfg = api.cfg
    api8 = ModelAPI(cfg.replace(moe=dataclasses.replace(
        cfg.moe, dispatch_dtype="float8_e4m3fn")))
    batch = {"tokens": wave, "labels": torch.roll(wave, -1, dims=1)}
    with torch.inference_mode():
        logits8, _ = api8.prefill(params, {"tokens": wave}, mctx)
        check(bool(torch.isfinite(logits8).all()),
              "fp8 dispatch: prefill logits not finite")
        loss8 = float(api8.loss(params, batch, mctx))
        loss = float(api.loss(params, batch, mctx))
    check(np.isfinite(loss8) and abs(loss8 - loss) < 0.1 * max(abs(loss), 1.0),
          f"fp8 dispatch loss {loss8} vs bf16 dispatch {loss}")
    gen = torch.Generator().manual_seed(seed)
    x = torch.cat([torch.tensor(FP8_EDGES),
                   300 * torch.randn(1 << 20, generator=gen)])
    for src in (x, x.bfloat16()):
        want = moe.to_dispatch(src, torch.float8_e4m3fn)
        got = moe.to_dispatch(src.cuda(), torch.float8_e4m3fn)
        check(torch.equal(got.view(torch.uint8).cpu(), want.view(torch.uint8)),
              f"fp8 dispatch cast from {src.dtype}: card bits differ")
        check(bool(torch.isnan(got[6:12].float()).all()),
              "fp8 dispatch cast: no NaN above 464")
    print(f"fp8 dispatch ({cfg.name}): logits finite, loss {loss8:.6f} vs "
          f"bf16 dispatch {loss:.6f}; the cast's NaN-above-464 rule on the "
          f"card bit for bit the CPU's on {x.numel()} values, from float32 "
          "and bfloat16")
    return {"fp8_loss": loss8, "bf16_dispatch_loss": loss}


def serve_moe_phase(arch: str, seed: int, times: dict) -> dict:
    """Serves `arch` (the moe family) with attn_impl="flash" at full width,
    cut to MOE_SERVE[arch] layers, from the store as the granite phase
    does: dbrx's GQA prefill reaches the flash kernel once a layer,
    deepseek-v2's MLA never."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI

    full = get_config(arch)
    cfg = full.replace(n_layers=MOE_SERVE[arch], attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = _init_on_card(api, seed, times, arch)
    per_wave = cfg.n_layers if cfg.mla is None else 0

    reqs, eng, stats, launched = _serve_from_store(
        api, params, mctx, cfg.vocab, seed, f"serve {arch}",
        ops.reset_launches, _flash_counts, tol=FLASH_TOL[cfg.compute_dtype])
    launches = launched["flash_attention_fwd"]
    times[f"{arch}_serve_s"] = stats["wall_s"]
    check(launches == per_wave * stats["waves"],
          f"flash_attention_fwd launched {launches} times on the {arch} "
          f"path, not {per_wave} x {stats['waves']} waves")
    stats.update({"flash_launches": launches, "layers": cfg.n_layers,
                  "of_layers": full.n_layers,
                  "decode_launches": _decode_launches(arch, stats, launched,
                                                      per_wave)})

    wave = torch.from_numpy(np.stack([r.prompt for r in reqs[:SERVE_BATCH]]))
    # the memory a prefill wave takes above the params (the experts'
    # weights are cast to bf16 a layer a call, as the reference casts them)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        api.prefill(params, {"tokens": wave}, mctx)
    torch.cuda.synchronize()
    stats["prefill_transient_gb"] = (torch.cuda.max_memory_allocated()
                                     - base) / 1e9
    print(f"{arch}: a prefill wave takes {stats['prefill_transient_gb']:.3f} "
          f"GB above the {base / 1e9:.3f} GB of params")
    with torch.inference_mode():
        _, calls = _recorded_flash(
            lambda: api.prefill(params, {"tokens": wave}, mctx))
    check(len(calls) == per_wave, f"{len(calls)} flash calls in a prefill "
          f"of {arch}, not {per_wave}")
    if calls:
        stats.update(_flash_calls_err(calls, FLASH_TOL[cfg.compute_dtype],
                                      arch))
    del calls

    # full width in float32 through the first layer, the dispatch in
    # float32 too: the wire that rounds nothing, as bf16 does at bf16
    cut = cfg.replace(n_layers=1, compute_dtype="float32",
                      moe=dataclasses.replace(cfg.moe,
                                              dispatch_dtype="float32"))
    stats.update(_paths_agree(
        api, params, cut, dict(params, blocks=first_layers(params["blocks"],
                                                           1)),
        {"tokens": wave}, mctx, arch))
    if arch == FP8_ARCH:
        stats.update(_fp8_dispatch_check(api, params, mctx, wave, seed))
    stats.update(_trace_wave(api, params, mctx, {"tokens": wave},
                             eng._pad_cache, arch))
    del params, eng

    # launch/serve.py main, through its own command line, on the tiny config
    t0 = time.perf_counter()
    tok_s = launch_serve.main(["--arch", f"tiny-{arch}", *REC_MAIN_ARGS])
    times[f"{arch}_main_s"] = time.perf_counter() - t0
    check(tok_s > 0, f"launch/serve.py main --arch tiny-{arch}: {tok_s}")
    stats["main_tokens_per_s"] = tok_s
    return stats


# -- phase 10: the vlm and encdec families at full width ----------------------
VLM = "llama-3.2-vision-90b"
VLM_SUPER_BLOCKS = 2        # of its 20: 10 of 100 layers, 3.4 GB a layer
WHISPER = "whisper-tiny"
WHISPER_PLEN = 384          # + 32 new + 8 stays within DEC_PRIME = 448


def _inputs_engine(api, params, mctx, plen: int, max_seq: int, extra,
                   compiled):
    """BatchedEngine for the vlm and encdec families, which launch/serve.py
    does not serve (nor does the reference's: their prefill takes inputs
    besides the tokens). Each wave's prefill inputs add `extra(rids)`,
    the other inputs of the wave's requests (a partial wave repeats its
    last request, as run_wave pads it), which the captured prefill copies
    into its buffers like the tokens."""
    from repro_torch.launch.serve import BatchedEngine

    class InputsEngine(BatchedEngine):
        def wave_inputs(self, padded, toks):
            return {"tokens": toks, **extra([r.rid for r in padded])}

    return InputsEngine(api, params, mctx, SERVE_BATCH, plen, max_seq,
                        compiled=compiled)


def serve_vlm_phase(seed: int, times: dict) -> dict:
    """llama-3.2-vision-90b at full width, VLM_SUPER_BLOCKS super-blocks,
    attn_impl="flash", with seeded nonzero gates (at zero they remove the
    cross path): prompts from the store and 4,096 x 1,280 patch embeddings
    a request made on the card from the seed, through ModelAPI.prefill and
    decode in BatchedEngine's greedy waves. The self layers' prefill
    reaches the flash kernel, the cross layers the plain attention."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models import vlm
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import tree_map

    full = get_config(VLM)
    cfg = full.replace(n_layers=VLM_SUPER_BLOCKS * full.vlm.cross_every,
                       attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = _init_on_card(api, seed, times, VLM)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cross = params["super"]["cross"]
    for key in ("gate_attn", "gate_mlp"):    # |g| in [0.5, 1.5), either sign
        mag = 0.5 + torch.rand(cross[key].shape, generator=gen, device="cuda")
        sign = torch.rand(cross[key].shape, generator=gen, device="cuda")
        cross[key].copy_(torch.where(sign < 0.5, -mag, mag))
    embeds = torch.randn((SERVE_REQUESTS, cfg.vlm.n_vision_tokens,
                          cfg.vlm.d_vision), generator=gen, device="cuda")

    def extra(rids) -> dict:
        return {"vision_embeds": embeds[[r % SERVE_REQUESTS for r in rids]]}

    per_wave = vlm.n_super(cfg) * (cfg.vlm.cross_every - 1)
    reqs, eng, stats, launched = _serve_from_store(
        api, params, mctx, cfg.vocab, seed, f"serve {VLM}",
        ops.reset_launches,
        lambda: {"flash_attention_fwd": ops.launches()["fwd"]},
        engine=lambda max_seq, compiled: _inputs_engine(
            api, params, mctx, SERVE_PLEN, max_seq, extra, compiled),
        tol=FLASH_TOL[cfg.compute_dtype])
    launches = launched["flash_attention_fwd"]
    times[f"{VLM}_serve_s"] = stats["wall_s"]
    check(launches == per_wave * stats["waves"],
          f"flash_attention_fwd launched {launches} times on the {VLM} path, "
          f"not {per_wave} self layers x {stats['waves']} waves")
    stats.update({"flash_launches": launches, "layers": cfg.n_layers,
                  "of_layers": full.n_layers,
                  "gates": {k: cross[k].tolist()
                            for k in ("gate_attn", "gate_mlp")}})

    wave = torch.from_numpy(np.stack([r.prompt for r in reqs[:SERVE_BATCH]]))
    inputs = {"tokens": wave, **extra(range(SERVE_BATCH))}
    with torch.inference_mode():
        _, calls = _recorded_flash(lambda: api.prefill(params, inputs, mctx))
    check(len(calls) == per_wave, f"{len(calls)} flash calls in a prefill "
          f"of {VLM}, not {per_wave}")
    stats.update(_flash_calls_err(calls, FLASH_TOL[cfg.compute_dtype], VLM))
    del calls
    # full width in float32 through the first self layer and the first
    # cross layer (a super-block of cross_every = 2). The whole first
    # super-block (4 self layers) is printed, not held: the random-weight
    # model's attention scores spread to a std of 360 (|v| to 177), where
    # float32 attention is itself up to 0.037 off exact at every call, the
    # float32 kernel and the plain version alike (within 3.1e-5 of each
    # other), and 4 such layers grow that into logits 0.27-0.29 off those
    # of exact attention on both paths, 2e-2 off each other
    # (scripts/flash_d128_accuracy_witness.py)
    one = cfg.replace(n_layers=2, compute_dtype="float32",
                      vlm=dataclasses.replace(cfg.vlm, cross_every=2))
    one_params = dict(params, super={
        "self": tree_map(lambda v: v[:1, :1], params["super"]["self"]),
        "cross": first_layers(params["super"]["cross"], 1)})
    stats.update(_paths_agree(api, params, one, one_params, inputs, mctx,
                              VLM))
    block = cfg.replace(n_layers=cfg.vlm.cross_every, compute_dtype="float32")
    diff, ok, agree, scale = _f32_paths(
        block, dict(params, super=first_layers(params["super"], 1)), inputs,
        mctx)
    print(f"{VLM}: prefill logits, flash vs plain path (float32, the first "
          f"super-block of {block.n_layers} layers, printed): max abs "
          f"difference {diff:.3e} at logit scale {scale:.6f}; first greedy "
          f"token agrees in {agree} of {SERVE_BATCH} rows")
    stats.update({"f32_super_block_logit_max_abs_diff": diff,
                  "f32_super_block_first_token_agree": agree})
    stats.update(_trace_wave(api, params, mctx, inputs, eng._pad_cache, VLM))
    return stats


def serve_whisper_phase(seed: int, times: dict) -> dict:
    """whisper-tiny whole, attn_impl="flash" (which its plain attention
    ignores): WHISPER_PLEN-token decoder prompts from the store and 1,500 x
    384 encoder frames a request made on the card from the seed, through
    ModelAPI.prefill and decode in BatchedEngine's greedy waves. It makes
    no kernel launch; its float32 prefill on the card is held against the
    port's own run on the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import tree_map

    cfg = get_config(WHISPER).replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = _init_on_card(api, seed, times, WHISPER)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randn((SERVE_REQUESTS, cfg.encdec.n_frames, cfg.d_model),
                         generator=gen, device="cuda")

    def extra(rids) -> dict:
        return {"frames": frames[[r % SERVE_REQUESTS for r in rids]]}

    reqs, eng, stats, launched = _serve_from_store(
        api, params, mctx, cfg.vocab, seed, f"serve {WHISPER}",
        ops.reset_launches,
        lambda: {"flash_attention_fwd": ops.launches()["fwd"]},
        plen=WHISPER_PLEN,
        engine=lambda max_seq, compiled: _inputs_engine(
            api, params, mctx, WHISPER_PLEN, max_seq, extra, compiled),
        tol=1e-3)
    times[f"{WHISPER}_serve_s"] = stats["wall_s"]
    check(launched["flash_attention_fwd"] == 0,
          f"flash_attention_fwd launched {launched['flash_attention_fwd']} "
          f"times on the {WHISPER} path")
    stats["flash_launches"] = 0

    wave = torch.from_numpy(np.stack([r.prompt for r in reqs[:SERVE_BATCH]]))
    inputs = {"tokens": wave, **extra(range(SERVE_BATCH))}
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}

    def card_vs_cpu(cut, cut_params, cut_cpu_params) -> tuple:
        with torch.inference_mode():
            card = ModelAPI(cut).prefill(cut_params, inputs, mctx)[0].cpu()
            cpu = ModelAPI(cut, device="cpu").prefill(
                cut_cpu_params, cpu_inputs,
                single_device_ctx(cut, device="cpu"))[0]
        diff, ok = in_tolerance(card, cpu, 1e-3)
        return (diff, ok, int((card.argmax(-1) == cpu.argmax(-1)).sum()),
                float(cpu.abs().max()))

    # float32, full width, through the first encoder and decoder layers:
    # held. The whole model is printed, not held: the random-weight
    # encoder's attention outputs reach |100|, and its layers multiply a
    # difference between the two devices' float32 roundings some 10x a
    # layer, so that the 4-layer encoder's outputs part by more than the
    # logits' scale
    f32 = cfg.replace(compute_dtype="float32")
    one = f32.replace(n_layers=1, encdec=dataclasses.replace(
        cfg.encdec, n_enc_layers=1))

    def first(tree):
        return dict(tree, enc=first_layers(tree["enc"], 1),
                    dec=first_layers(tree["dec"], 1))
    diff, ok, agree, scale = card_vs_cpu(one, first(params),
                                         first(cpu_params))
    print(f"{WHISPER}: float32 prefill logits on the card vs the port on the "
          f"CPU (1 encoder and 1 decoder layer, full width): max abs "
          f"difference {diff:.3e} at logit scale {scale:.6f}; first greedy "
          f"token agrees in {agree} of {SERVE_BATCH} rows")
    check(ok, f"{WHISPER}: card and CPU float32 logits differ by {diff}")
    check(agree == SERVE_BATCH, f"{WHISPER}: first greedy tokens differ")
    whole, _, whole_agree, whole_scale = card_vs_cpu(f32, params, cpu_params)
    print(f"{WHISPER}: the same, whole (4 + 4 layers, printed): max abs "
          f"difference {whole:.3e} at logit scale {whole_scale:.6f}; first "
          f"greedy token agrees in {whole_agree} of {SERVE_BATCH} rows")
    del cpu_params
    stats.update({"f32_card_vs_cpu_logit_max_abs_diff": diff,
                  "f32_card_vs_cpu_first_token_agree": agree,
                  "f32_card_vs_cpu_whole_logit_max_abs_diff": whole,
                  "f32_card_vs_cpu_whole_first_token_agree": whole_agree})
    stats.update(_trace_wave(api, params, mctx, inputs, eng._pad_cache,
                             WHISPER))
    return stats


# -- phase 11: training dense-100m at full width from the store ---------------
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 30, 8, 256, 2
TRAIN_CKPT_EVERY, TRAIN_DRILL_AT = 10, 15
TRAIN_RESUME_FROM, TRAIN_RESUME_TO = 10, 15  # --resume: steps 11-15 again
TRAIN_MAIN_ARGS = ["--arch", "dense-100m", "--steps", "5", "--global-batch",
                   "8", "--seq", "256", "--microbatches", "2",
                   "--ckpt-every", "5", "--inject-failure-at", "3"]


def _host_bytes(t) -> np.ndarray:
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def _state_leaves(params, opt) -> list:
    """The leaves of a train state (params and AdamState) in one order."""
    from repro_torch.models.params import tree_leaves
    return [opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v),
            *tree_leaves(params)]


def _train_compiled_checks(api, tcfg, mctx, step_fn, params, opt, host,
                           step_s: list, launches: dict, replays: int
                           ) -> dict:
    """The captured train step against the eager step (make_train_step)
    from the same state and batch: loss, grad norm, params, m and v bit
    for bit, or else within the train tests' tolerances (loss 1e-6
    relative, the rest 2 lr); both steps timed and traced; the kernels of
    the captured graph from traced replays; the run's launches as the
    wrapper counted them (the first step, which runs eagerly before the
    capture) plus the graph's kernels times its replays."""
    import torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import make_train_step, map_tree
    eager_step = make_train_step(api, tcfg, mctx)
    batch = {k: torch.from_numpy(v).to(mctx.device) for k, v in host.items()}
    p_e = map_tree(lambda t: t.detach().clone(), params)
    s_e = map_tree(lambda t: t.detach().clone(), opt)
    p_e, s_e, m_e = eager_step(p_e, s_e, batch)
    _, _, m_c = step_fn(params, opt, host)
    torch.cuda.synchronize()
    lr = float(m_e["lr"])
    got = tree_leaves(params) + tree_leaves(opt.m) + tree_leaves(opt.v)
    want = tree_leaves(p_e) + tree_leaves(s_e.m) + tree_leaves(s_e.v)
    identical = all(bool(torch.equal(m_c[k], m_e[k]))
                    for k in ("loss", "grad_norm", "lr"))
    identical &= all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    loss_rel = abs(float(m_c["loss"]) - float(m_e["loss"])) / abs(
        float(m_e["loss"]))
    state_err = max(float((a.detach() - b).abs().max())
                    for a, b in zip(got, want))
    check(loss_rel <= 1e-6 and state_err <= 2 * lr, f"captured train step "
          f"off the eager step: loss {loss_rel}, state {state_err}")
    eager_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        p_e, s_e, _ = eager_step(p_e, s_e, batch)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    eager_trace = device_breakdown(lambda: eager_step(p_e, s_e, batch))
    del p_e, s_e
    trace, kernels = graph_kernels(lambda: step_fn(params, opt, host))
    fwd, bwd = kernels.get("flash fwd", 0), kernels.get("flash bwd", 0)
    check(bwd % 2 == 0, f"{bwd} backward kernels in the graph")
    total = {"fwd": launches["fwd"] + fwd * replays,
             "bwd": launches["bwd"] + bwd // 2 * replays,
             "bwd_softcap": launches["bwd_softcap"]}
    med = float(np.median(step_s[1:]))
    print(f"[train] captured step vs the eager step from the same state: "
          f"{'bit for bit' if identical else 'not bit for bit'}, loss "
          f"{loss_rel:.3e} relative, params and moments {state_err:.3e} "
          f"(held at 1e-6 and 2 lr = {2 * lr:.3e}); step "
          f"{med:.6f} s median over replays (capture {step_fn.capture_s:.3f}"
          f" s in step 1), eager {float(np.median(eager_s)):.6f} s; traced "
          f"replay: wall {trace['wall_s']:.6f} s, busy "
          f"{trace['device_busy_s']:.6f} s, idle {trace['idle_share']:.4f}, "
          f"{trace['device_ops']} device operations; traced eager step: "
          f"wall {eager_trace['wall_s']:.6f} s, idle "
          f"{eager_trace['idle_share']:.4f}, {eager_trace['device_ops']}; "
          f"flash launches {total} ({launches} by the wrappers in step 1, "
          f"{fwd} forward and {bwd} backward kernels in the graph x "
          f"{replays} replays)")
    print("traced train step (a replay):", trace)
    print("traced train step (eager):", eager_trace)
    return {"launches": total, "captured_vs_eager_identical": identical,
            "captured_vs_eager_loss_rel": loss_rel,
            "captured_vs_eager_state_max_abs_diff": state_err,
            "step_s_median_replays": med, "capture_s": step_fn.capture_s,
            "eager_step_s": eager_s,
            "eager_step_s_median": float(np.median(eager_s)),
            "trace_step": trace, "trace_eager_step": eager_trace,
            "graph_kernels": kernels, "replays": replays}


def _train_resume(ckpt, step_fn, params, opt, batches: list, losses: list,
                  at_resume_to: list, tcfg) -> dict:
    """launch/train.py's --resume on the card: the step-TRAIN_RESUME_FROM
    checkpoint restored into the captured step's own tensors
    (`restore_into`), then steps TRAIN_RESUME_FROM + 1 .. TRAIN_RESUME_TO
    replayed on the run's batches, their losses and the params after them
    held against the uninterrupted run's (bit for bit, or else loss within
    1e-6 relative and params within 2 lr)."""
    import torch
    from repro_torch.launch.train import restore_into
    from repro_torch.models.params import tree_leaves
    t0 = time.perf_counter()
    got, state = ckpt.restore({"params": params, "opt": opt},
                              step=TRAIN_RESUME_FROM)
    check(got == TRAIN_RESUME_FROM, f"restored step {got}")
    ids = [id(t) for t in tree_leaves(params)]
    restore_into(params, opt, state)
    del state
    restore_s = time.perf_counter() - t0
    check([id(t) for t in tree_leaves(params)] == ids
          and int(opt.step) == TRAIN_RESUME_FROM,
          "the restore rebound the step's tensors")
    again = []
    for host in batches[TRAIN_RESUME_FROM:TRAIN_RESUME_TO]:
        _, _, metrics = step_fn(params, opt, host)
        again.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    want = losses[TRAIN_RESUME_FROM:TRAIN_RESUME_TO]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(again, want))
    # (a leaf of 0 layers, a 2-layer hybrid's super-block stacks, has no
    # element to differ)
    errs = [float((a.detach().cpu() - b).abs().max()) if b.numel() else 0.0
            for a, b in zip(tree_leaves(params), at_resume_to)]
    identical = again == want and max(errs) == 0.0
    check(loss_rel <= 1e-6 and max(errs) <= 2 * tcfg.lr,
          f"resumed steps off the uninterrupted run: loss {loss_rel}, "
          f"params {max(errs)}")
    print(f"[train] --resume: step {TRAIN_RESUME_FROM} restored into the "
          f"captured step's tensors in {restore_s:.3f} s, steps "
          f"{TRAIN_RESUME_FROM + 1}-{TRAIN_RESUME_TO} replayed: "
          f"{'bit for bit' if identical else 'not bit for bit'} the "
          f"uninterrupted run's (losses {again}, {loss_rel:.3e} relative; "
          f"params {max(errs):.3e})")
    return {"resume_losses": again, "resume_loss_rel": loss_rel,
            "resume_params_max_abs_diff": max(errs),
            "resume_identical": identical, "resume_restore_s": restore_s}


def _steps_from_store(step_fn, params, opt, loader, ckpt, client) -> tuple:
    """TRAIN_STEPS calls of the compiled train step on the loader's
    batches (the first runs eagerly and captures; the rest replay), a
    checkpoint every TRAIN_CKPT_EVERY steps (its snapshot timed), a
    storage device killed before step TRAIN_DRILL_AT + 1, and the params
    after step TRAIN_RESUME_TO kept on the host. Returns (params, opt,
    the run: losses, grad norms, step times, batches, snapshot times, the
    kept params, the last checkpoint write's wait and the wall time)."""
    import torch
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.models.params import tree_leaves
    run = {"losses": [], "grad_norms": [], "step_s": [], "batches": [],
           "snapshot_s": []}
    t_run = time.perf_counter()
    for step in range(TRAIN_STEPS):
        if step == TRAIN_DRILL_AT:
            # the checkpoint of step 10 lands first: a write in flight
            # when one of its devices dies misses its quorum and the
            # manager retries nothing, in the reference as in the port
            # (ROADMAP Queue 3; tests/test_torch_checkpoint.py)
            ckpt.wait()
            victim = client.devices[0].name
            FailureInjector(client.store).kill(victim)
            print(f"[drill] killed storage device {victim} before step "
                  f"{step + 1}")
        t0 = time.perf_counter()
        host = loader.next_batch()
        params, opt, metrics = step_fn(params, opt, host)
        torch.cuda.synchronize()
        run["step_s"].append(time.perf_counter() - t0)
        run["losses"].append(float(metrics["loss"]))
        run["grad_norms"].append(float(metrics["grad_norm"]))
        run["batches"].append(host)
        if (step + 1) % TRAIN_CKPT_EVERY == 0:
            t0 = time.perf_counter()
            ckpt.save(step + 1, {"params": params, "opt": opt})
            run["snapshot_s"].append(time.perf_counter() - t0)
        if step + 1 == TRAIN_RESUME_TO:
            run["at_resume_to"] = [t.detach().cpu().clone()
                                   for t in tree_leaves(params)]
    t0 = time.perf_counter()
    ckpt.wait()
    run["last_write_s"] = time.perf_counter() - t0
    run["wall_s"] = time.perf_counter() - t_run
    return params, opt, run


def train_phase(seed: int, times: dict) -> dict:
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import ROS2Client
    from repro_torch.data.pipeline import (Assignment, ROS2TokenLoader,
                                           write_token_shards)
    from repro_torch.distributed.checkpoint import ROS2CheckpointManager
    from repro_torch.distributed.fault import StragglerMonitor
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import (count_params, init_params,
                                           tree_leaves, tree_map)
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import (jit_train_step, make_train_step,
                                           value_and_grad)

    cfg = get_config("dense-100m").replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    dev = mctx.device
    need = TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1) + TRAIN_SEQ + 1
    t0 = time.perf_counter()
    tokens = launch_train.synth_tokens(cfg.vocab, need, seed)
    times["train_corpus_s"] = time.perf_counter() - t0
    client = ROS2Client(mode="dpu", transport="rdma", n_devices=4)
    loader = None
    stats: dict = {}
    try:
        t0 = time.perf_counter()
        write_token_shards(client, "/data", tokens)
        times["train_shards_s"] = time.perf_counter() - t0
        loader = ROS2TokenLoader(client, "/data", global_batch=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, prefetch=2,
                                 hedge_timeout_s=0.5)
        tcfg = TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS,
                           warmup_steps=max(1, TRAIN_STEPS // 10),
                           num_microbatches=TRAIN_MICROBATCHES)
        step_fn = jit_train_step(api, tcfg, mctx, ShapeConfig(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"))
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(api.param_defs(), gen,
                             getattr(torch, cfg.param_dtype), dev)
        opt = init_adam(params)
        torch.cuda.synchronize()
        times["train_init_s"] = time.perf_counter() - t0
        n_params = count_params(api.param_defs())
        print(f"dense-100m: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab}, {n_params} params ({cfg.param_dtype}, "
              f"computing in {cfg.compute_dtype}) on the card")
        # keep 3: the step-10 checkpoint stays for the resume below
        ckpt = ROS2CheckpointManager(client, "/ckpt", keep=3)
        mon = StragglerMonitor()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        params, opt, run = _steps_from_store(step_fn, params, opt, loader,
                                             ckpt, client)
        losses, gnorms, step_s, batches, snapshot_s, at_resume_to = (
            run[k] for k in ("losses", "grad_norms", "step_s", "batches",
                             "snapshot_s", "at_resume_to"))
        last_write_s, wall = run["last_write_s"], run["wall_s"]
        for dt in step_s:
            mon.record(0, dt)
        launches = ops.launches()
        replays = step_fn.calls - 1      # the first call captures
        peak = torch.cuda.max_memory_allocated()
        lm = loader.metrics()
        dpu_ops = client.dpu.ops_processed

        for i, (loss, gn) in enumerate(zip(losses, gnorms)):
            check(np.isfinite(loss) and np.isfinite(gn),
                  f"step {i + 1}: loss {loss}, grad norm {gn}")
        # not checked at full depth: with the reference's fan-in init the
        # 12-layer model's gradient norm explodes with depth and neither
        # package's loss moves beyond noise in 30 steps of these flags
        # (tools/train_loss_witness.py); the cut model below is checked
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        check(launches["bwd_softcap"] == 0, "the softcap backward ran")
        n_samples = need // (TRAIN_SEQ + 1)
        asg = Assignment(n_samples, TRAIN_BATCH, 0, 1, 0, 0)
        check(asg.steps_per_epoch() >= TRAIN_STEPS, "corpus under an epoch")
        for i, b in enumerate(batches):
            rows = np.stack([tokens[j * (TRAIN_SEQ + 1):(j + 1) * (
                TRAIN_SEQ + 1)] for j in asg.samples_for_step(i)])
            check(np.array_equal(b["tokens"], rows[:, :-1])
                  and np.array_equal(b["labels"], rows[:, 1:]),
                  f"batch {i} differs from its corpus slice")
        # prefetch holds at most 2 batches and one in hand: every batch
        # from step TRAIN_DRILL_AT + 3 on was read after the kill
        after_drill = TRAIN_STEPS - (TRAIN_DRILL_AT + 3)

        t0 = time.perf_counter()
        got_step, state = ckpt.restore({"params": params, "opt": opt})
        restore_s = time.perf_counter() - t0
        check(got_step == TRAIN_STEPS, f"restored step {got_step}")
        saved = _state_leaves(params, opt)
        restored = _state_leaves(state["params"], state["opt"])
        check(len(saved) == len(restored), "restored tree differs")
        restored_bytes = 0
        for a, b in zip(restored, saved):
            a = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            check(np.array_equal(a, _host_bytes(b)),
                  "restored checkpoint differs from the saved state")
            restored_bytes += a.size
        del state, restored
        compiled = _train_compiled_checks(
            api, tcfg, mctx, step_fn, params, opt, loader.next_batch(),
            step_s, launches, replays)
        launches = compiled.pop("launches")
        want_bwd = cfg.n_layers * TRAIN_MICROBATCHES * TRAIN_STEPS
        check(launches["bwd"] == want_bwd, f"flash_attention_bwd launched "
              f"{launches['bwd']} times, not {want_bwd}")
        stats.update(compiled)
        stats.update(_train_resume(ckpt, step_fn, params, opt,
                                   batches, losses, at_resume_to, tcfg))
        stats.update({
            "steps": TRAIN_STEPS, "tokens": TRAIN_STEPS * TRAIN_BATCH
            * TRAIN_SEQ, "wall_s": wall,
            "tokens_per_s": TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall,
            "step_s_median": float(np.median(step_s)),
            "step_s_min": min(step_s), "step_s_max": max(step_s),
            "step_s": step_s, "losses": losses, "grad_norms": gnorms,
            "loss_first5": first, "loss_last5": last,
            "loader_stall_s": lm["stall_s"],
            "loader_stall_share": lm["stall_s"] / wall,
            "loader_read_s": lm["read_s"],
            "hedges_issued": lm["hedges_issued"],
            "hedges_won": lm["hedges_won"], "dpu_ops": dpu_ops,
            "stragglers": mon.stragglers(),
            "ckpt_snapshot_s": snapshot_s, "ckpt_last_write_s": last_write_s,
            "ckpt_bytes_written": ckpt.bytes_written,
            "ckpt_saves": ckpt.saves, "ckpt_restore_s": restore_s,
            "ckpt_restore_bytes": restored_bytes,
            "peak_mem_gb": peak / 1e9, "flash_launches": launches,
            "batches_checked_after_drill": after_drill})
        print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens: {stats['tokens_per_s']:.3f} tok/s, step "
              f"{stats['step_s_median']:.6f} s median ({min(step_s):.6f}-"
              f"{max(step_s):.6f}), loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(first 5 {first:.4f}, last 5 {last:.4f}), loader stall "
              f"{lm['stall_s']:.3f} s ({100 * lm['stall_s'] / wall:.2f}%), "
              f"hedges {int(lm['hedges_issued'])}, DPU ops {dpu_ops}, "
              f"flash launches {launches}, peak {peak / 1e9:.3f} GB")
        print(f"[train] checkpoints: {ckpt.saves} saves, "
              f"{ckpt.bytes_written} B written, snapshots {snapshot_s} s, "
              f"last write {last_write_s:.3f} s; restore of step "
              f"{got_step}: {restored_bytes} B in {restore_s:.3f} s, bit "
              f"for bit; every batch equals its corpus slice ({after_drill} "
              f"read after the drill)")

    finally:
        if loader is not None:
            loader.close()
        client.close()

    # the first two layers in float32, one step on each attention path
    shallow = cfg.replace(n_layers=SHALLOW_LAYERS, compute_dtype="float32")
    toks = torch.from_numpy(batches[0]["tokens"][:TRAIN_BATCH
                                                 // TRAIN_MICROBATCHES])
    labels = torch.from_numpy(batches[0]["labels"][:TRAIN_BATCH
                                                   // TRAIN_MICROBATCHES])
    one = {"tokens": toks.to(dev), "labels": labels.to(dev)}

    def shallow_params():
        cut = dict(params, blocks=first_layers(params["blocks"],
                                               SHALLOW_LAYERS))
        return tree_map(lambda t: t.detach().clone(), cut)

    f32 = {}
    for impl in ("flash", "jnp"):
        sapi = ModelAPI(shallow.replace(attn_impl=impl))
        loss, grads = value_and_grad(sapi, shallow_params(), one, mctx)
        sp = shallow_params()
        _, sopt, smetrics = make_train_step(sapi, TrainConfig(), mctx)(
            sp, init_adam(sp), one)
        check(abs(float(smetrics["loss"]) - float(loss))
              <= 1e-6 * (1 + abs(float(loss))),
              f"{impl}: the step's loss differs from its gradient's")
        f32[impl] = (float(loss), grads)
    lf, lj = f32["flash"][0], f32["jnp"][0]
    check(abs(lf - lj) <= 1e-4 + 1e-4 * abs(lj),
          f"float32 loss flash {lf} vs plain {lj}")
    grad_err = 0.0
    for a, b in zip(tree_leaves(f32["flash"][1]), tree_leaves(f32["jnp"][1])):
        err = (a - b).abs()
        check(bool(torch.all(err <= 2e-4 + 2e-3 * b.abs())),
              f"float32 gradient off by {float(err.max())}")
        grad_err = max(grad_err, float(err.max()))
    print(f"dense-100m at full width through {SHALLOW_LAYERS} layers in "
          f"float32, one step: loss flash {lf:.7f}, plain {lj:.7f}; every "
          f"gradient within atol 2e-4 / rtol 2e-3, max abs difference "
          f"{grad_err:.3e}")
    with torch.no_grad():
        bf16 = {impl: float(ModelAPI(cfg.replace(attn_impl=impl)).loss(
            params, one, mctx)) for impl in ("flash", "jnp")}
    # printed, not checked: the reference's fan-in init makes the random
    # model chaotic in bf16 at full depth (ROADMAP Queue 3)
    print(f"dense-100m bf16 loss after {TRAIN_STEPS} steps, all "
          f"{cfg.n_layers} layers: flash {bf16['flash']:.6f}, plain "
          f"{bf16['jnp']:.6f}")
    stats.update({"f32_shallow_loss": {"flash": lf, "plain": lj},
                  "f32_shallow_grad_max_abs_diff": grad_err,
                  "bf16_loss": bf16})

    # the loss falls: the same widths, flags and batches from the store,
    # cut to SHALLOW_LAYERS layers, where the reference's init still
    # trains in 30 steps (tools/train_loss_witness.py)
    cut = cfg.replace(n_layers=SHALLOW_LAYERS)
    capi = ModelAPI(cut)
    cparams = init_params(capi.param_defs(),
                          torch.Generator(device=dev).manual_seed(seed),
                          getattr(torch, cut.param_dtype), dev)
    cstep = make_train_step(capi, tcfg, mctx)
    copt = init_adam(cparams)
    closses = []
    for host in batches:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        cparams, copt, metrics = cstep(cparams, copt, batch)
        closses.append(float(metrics["loss"]))
    cfirst, clast = float(np.mean(closses[:5])), float(np.mean(closses[-5:]))
    print(f"dense-100m cut to {SHALLOW_LAYERS} layers, the same 30 batches: "
          f"loss {closses[0]:.5f} -> {closses[-1]:.5f}, first 5 {cfirst:.5f}"
          f", last 5 {clast:.5f}; at {cfg.n_layers} layers first 5 "
          f"{stats['loss_first5']:.5f}, last 5 {stats['loss_last5']:.5f}")
    check(all(np.isfinite(closses)), f"cut model's losses {closses}")
    check(clast < cfirst, f"the cut model's loss did not fall: first 5 "
          f"steps {cfirst}, last 5 {clast}")
    stats.update({"cut_losses": closses, "cut_loss_first5": cfirst,
                  "cut_loss_last5": clast})

    # launch/train.py main, through its own command line
    t0 = time.perf_counter()
    main_loss = launch_train.main(TRAIN_MAIN_ARGS)
    times["train_main_s"] = time.perf_counter() - t0
    check(np.isfinite(main_loss), f"launch/train.py main: loss {main_loss}")
    stats["main_loss"] = main_loss
    return stats


# -- phase 11, continued: training the hybrid, ssm and encdec families --------
FAMILY_TRAIN = {  # arch -> its scan kernel (and its ops module's name)
    "recurrentgemma-2b": "rglru_scan",
    "rwkv6-1.6b": "wkv6",
}
FAMILY_STEPS = 10           # (a): compiled steps at full width
FAMILY_LAYERS = 2           # (b): learning, checkpoints and --resume
FAMILY_MAIN_ARGS = ["--steps", "5", "--global-batch", "8", "--seq", "256",
                    "--microbatches", "2", "--ckpt-every", "5",
                    "--inject-failure-at", "3"]
WHISPER_TRAIN_STEPS = 30    # (c): whisper-tiny whole
# (c)'s learning rate: at the other phases' 1e-3 the loss of whisper's 30
# steps (random frames, the synthetic corpus's decoder tokens) moves less
# than its spread from step to step; at 1e-2 it climbs
WHISPER_TRAIN_LR = 3e-3


def _scan_calls_implied(cfg, nmb: int) -> tuple:
    """(the scan kernel's wrapper calls in one eager train step by
    direction, the kind of its kernels, its kernels in the step's graph):
    each scan layer's kernel runs once forward in the forward pass and
    again in remat's recompute of its layer inside the backward (cfg.remat),
    and rglru_scan once more reversed, for the backward's adjoint scan; a
    microbatch at a time. wkv6 is two kernels a call."""
    from repro_torch.models import recurrent
    check(cfg.remat, f"{cfg.name} without remat")
    if cfg.family == "hybrid":
        n_super, n_tail = recurrent.pattern(cfg)
        n = n_super * cfg.hybrid.rnn_per_attn + n_tail
        return {"fwd": 2 * n * nmb, "bwd": n * nmb}, "rglru scan", 3 * n * nmb
    kind, per_call = KERNEL_KIND["wkv6"]
    return ({"fwd": 2 * cfg.n_layers * nmb}, kind,
            2 * cfg.n_layers * nmb * per_call)


def _held_scan_calls(kernel: str, calls: dict):
    """A context in which every call of the scan kernel's path (the
    function of its ops module that launches it: rglru_scan's `_scan`,
    forward and reversed; wkv6's `_forward`) is held against its plain
    version on the call's own inputs as it happens, counted in `calls` by
    direction, its largest error kept in calls["max_abs_err"]. The
    tolerances are the recurrent serve phase's (`_kernel_ops`): rglru_scan
    1e-5, wkv6 3e-4 against the sequential recurrence, each atol = rtol.
    The reversed rglru_scan scans the loss's gradient, whose partial sums
    cancel (the model's decays hold a_t near 1): its rtol is taken of the
    same scan of |a| and |b| (the float32 rounding of a linear recurrence
    grows with the sum of its terms' magnitudes, not with what is left
    of it), and calls["bwd_scale"] keeps that scan's largest value."""
    import contextlib
    import torch
    kops, _, _, plain_name, tol = _kernel_ops(kernel)
    if kernel == "rglru_scan":
        from repro_torch.kernels.rglru_scan import ref
        name = "_scan"

        def plain(a, b, h0, reverse):
            return ref.rglru_scan_ref(a, b, h0, reverse=reverse)

        def direction(args):
            return "bwd" if args[3] else "fwd"
    else:
        from repro_torch.kernels.rwkv6_scan import ref
        name = "_forward"

        def plain(r, k, v, w, u, s0, chunk):
            return ref.wkv_ref(r, k, v, w, u, s0)

        def direction(args):
            return "fwd"
    real = getattr(kops, name)

    def held(*args):
        out = real(*args)
        with torch.no_grad():
            want = plain(*args)
            scale, top = None, 0.0
            if direction(args) == "bwd":
                a, b, h0, reverse = args
                scale = ref.rglru_scan_ref(a.abs(), b.abs(), None, reverse)
                top = float(scale.max())
                calls["bwd_scale"] = max(calls.get("bwd_scale", 0.0), top)
            for got, w in zip(out if isinstance(out, tuple) else (out,),
                              want if isinstance(want, tuple) else (want,)):
                err = float((got - w).abs().max())
                bound = tol + tol * (w.abs() if scale is None else scale)
                ok = bool(torch.all((got - w).abs() <= bound))
                check(ok, f"{kernel} off its {plain_name} by {err} on the "
                      f"train path's inputs ({direction(args)}; largest "
                      f"|value| {float(w.abs().max())}, largest of the "
                      f"scan of magnitudes {top})")
                key = f"max_abs_err_{direction(args)}"
                calls[key] = max(calls.get(key, 0.0), err)
                calls["max_abs_err"] = max(calls["max_abs_err"], err)
        calls[direction(args)] += 1
        return out

    @contextlib.contextmanager
    def holding():
        setattr(kops, name, held)       # looked up at each call
        try:
            yield
        finally:
            setattr(kops, name, real)
    return holding()


def _reset_train_state(params, opt, start: list) -> None:
    """The train state back to step 0 in place (the compiled step's own
    tensors): the params copied from their host copy `start`, the moments
    and the step zeroed."""
    import torch
    from repro_torch.models.params import tree_leaves
    with torch.no_grad():
        for leaf, host in zip(tree_leaves(params), start, strict=True):
            leaf.copy_(host)
        for t in tree_leaves(opt.m) + tree_leaves(opt.v):
            t.zero_()
        opt.step.zero_()


HELD_CHUNK = 1 << 26            # elements a piece of a leaf held on the card


def _held_to_host(got: list, want: list, metrics, want_metrics: dict,
                  lr: float, label: str) -> dict:
    """The compiled step's state leaves and metrics on the card against an
    eager step's kept on the host, each leaf copied back to the card a
    piece of HELD_CHUNK elements at a time (a full-width recurrentgemma-2b
    state and its graph's pool leave no room for a whole embedding): bit
    for bit, or else within the train tests' tolerances (loss 1e-6
    relative, the rest 2 lr)."""
    import torch
    identical = all(float(metrics[k]) == want_metrics[k]
                    for k in ("loss", "grad_norm", "lr"))
    state_err = 0.0
    with torch.no_grad():
        for a, host in zip(got, want, strict=True):
            a, host = a.reshape(-1), host.reshape(-1)
            for i in range(0, a.numel(), HELD_CHUNK):
                x = a[i:i + HELD_CHUNK]
                y = host[i:i + HELD_CHUNK].to(x.device)
                identical &= bool(torch.equal(x, y))
                state_err = max(state_err,
                                float((x.float() - y.float()).abs().max()))
    loss_rel = abs(float(metrics["loss"]) - want_metrics["loss"]) / abs(
        want_metrics["loss"])
    check(loss_rel <= 1e-6 and state_err <= 2 * lr, f"{label}: the compiled "
          f"step off the eager step: loss {loss_rel}, state {state_err}")
    return {"identical": identical, "loss_rel": loss_rel,
            "state_max_abs_diff": state_err}


def _family_full(arch: str, client, seed: int, times: dict) -> dict:
    """(a) `arch` at full width and depth: an eager step from the seed's
    state, every scan call held against its plain version, its state kept
    on the host; the state reset (the params from their host copy), the
    compiled step's first call (a warm-up that runs the body eagerly and
    is timed as the eager step, then the capture), the state reset again
    and step 1 replayed, bit for bit the eager step; steps 2 to
    FAMILY_STEPS replayed on the loader's batches; the launches against
    the path's; a traced replay."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ROS2TokenLoader
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import jit_train_step, make_train_step

    kernel = FAMILY_TRAIN[arch]
    kops = _kernel_ops(kernel)[0]
    cfg = get_config(arch).replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    per_step, kind, per_replay = _scan_calls_implied(cfg, TRAIN_MICROBATCHES)
    want = {"bwd": 0, **per_step}
    tcfg = TrainConfig(lr=1e-3, total_steps=FAMILY_STEPS,
                       warmup_steps=max(1, FAMILY_STEPS // 10),
                       num_microbatches=TRAIN_MICROBATCHES)
    params = _init_on_card(api, seed, times, f"train {arch}")
    opt = init_adam(params)
    start = [t.detach().cpu() for t in tree_leaves(params)]
    loader = ROS2TokenLoader(client, "/data", global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, prefetch=2,
                             hedge_timeout_s=0.5)
    try:
        first = loader.next_batch()
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in first.items()}
        calls = {"fwd": 0, "bwd": 0, "max_abs_err": 0.0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _held_scan_calls(kernel, calls):
            # the params and moments are updated in place; the step count
            # comes back as a new tensor
            params, opt, m_e = make_train_step(api, tcfg, mctx)(
                params, opt, batch)
        torch.cuda.synchronize()
        held_s = time.perf_counter() - t0
        del batch
        got = {k: calls[k] for k in ("fwd", "bwd")}
        check(got == want, f"{arch}: {got} {kernel} calls in an eager step, "
              f"the path implies {want}")
        lr = float(m_e["lr"])
        m_e = {k: float(v) for k, v in m_e.items()}
        t0 = time.perf_counter()
        host = [t.detach().cpu() for t in _state_leaves(params, opt)]
        host_s = time.perf_counter() - t0

        # the main path: counts from 0, the compiled step's first call (the
        # warm-up, the eager body on a side stream, then the capture)
        step_fn = jit_train_step(api, tcfg, mctx, ShapeConfig(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"))
        _reset_train_state(params, opt, start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()
        step_s = []
        t_run = time.perf_counter()
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, first)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        wrapper = kops.launches()
        # step 1 again, replayed from the same state
        _reset_train_state(params, opt, start)
        del start
        t0 = time.perf_counter()
        params, opt, m_c = step_fn(params, opt, first)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        held = _held_to_host(_state_leaves(params, opt), host, m_c, m_e, lr,
                             f"{arch} replay")
        compare_s = time.perf_counter() - t0
        del host
        check(held["identical"], f"{arch}: step 1 replayed is not bit for "
              f"bit the eager step: {held}")
        losses = [float(m_c["loss"])]
        for _ in range(FAMILY_STEPS - 1):
            t0 = time.perf_counter()
            hb = loader.next_batch()
            params, opt, metrics = step_fn(params, opt, hb)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        wall = time.perf_counter() - t_run
        replays = step_fn.calls - 1
        check(kops.launches() == wrapper, f"{arch}: a replay launched "
              f"through the wrapper: {kops.launches()} after {wrapper}")
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"{arch}: losses {losses}")
        check({d: wrapper.get(d, 0) for d in want} == want,
              f"{arch}: {wrapper} {kernel} launches in the compiled step's "
              f"first call (its eager warm-up), the path implies {want}")

        # the graph's kernels, from traced replays until one trace shows
        # the path's scan kernels (the profiler only ever loses records)
        seen = []
        t0 = time.perf_counter()
        for _ in range(TRACE_ATTEMPTS):
            trace = device_breakdown(lambda: step_fn(params, opt, first))
            seen.append(trace["device_ops_by_kind"].get(kind, 0))
            if seen[-1] == per_replay:
                break
        trace_s = time.perf_counter() - t0
        check(max(seen) == per_replay, f"{arch}: {seen} {kind} kernels in "
              f"traced replays, the path implies {per_replay}")
        # each replay launches the graph's scan kernels: a call's worth each
        launches = {d: want[d] * (1 + replays) for d in want}
    finally:
        loader.close()
    med = float(np.median(step_s[2:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {
        "n_layers": cfg.n_layers, "n_params": count_params(api.param_defs()),
        "steps": FAMILY_STEPS, "step_s": step_s, "losses": losses,
        "step_s_median_replays": med, "tokens_per_s": tokens / med,
        "wall_s": wall, "capture_s": step_fn.capture_s,
        "eager_step_s": step_fn.warmup_s, "held_eager_step_s": held_s,
        "host_copy_s": host_s, "compare_s": compare_s, "trace_s": trace_s,
        "replay_vs_eager": held,
        "captured_vs_eager_identical": held["identical"],
        "scan_calls_per_eager_step": got,
        "scan_max_abs_err": calls["max_abs_err"], "scan_calls": calls,
        "scan_kernels_per_replay": per_replay, "replays": replays,
        "launches": launches, "launches_by_wrapper": wrapper,
        "trace_replay": trace, "peak_mem_gb": peak / 1e9}
    print(f"[train {arch}] {cfg.name}, {cfg.n_layers} layers at full width: "
          f"eager step {step_fn.warmup_s:.3f} s (the compiled step's "
          f"warm-up; {held_s:.3f} s with every {kernel} call held against "
          f"its plain version: {got} calls, {calls}); first call "
          f"{step_s[0]:.3f} s (capture and warm-up {step_fn.capture_s:.3f} "
          f"s); step 1 replayed from the same state "
          f"{'bit for bit' if held['identical'] else 'not bit for bit'} the "
          f"eager step (loss {held['loss_rel']:.3e} relative, state "
          f"{held['state_max_abs_diff']:.3e}); replay {med:.6f} s median, "
          f"{tokens / med:.3f} tok/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak {peak / 1e9:.3f} GB; traced replay "
          f"({trace_s:.1f} s to trace): wall {trace['wall_s']:.6f} s, busy "
          f"{trace['device_busy_s']:.6f} s, idle {trace['idle_share']:.4f}, "
          f"{trace['device_ops']} device operations, {max(seen)} {kind} "
          f"kernels (the path: {per_replay}); {kernel} launches {launches} = "
          f"{wrapper} by the wrapper in the warm-up + the graph's x "
          f"{replays} replays; host copy {host_s:.1f} s, compare "
          f"{compare_s:.1f} s")
    if kernel == "wkv6":
        out.update(_wkv_backward_share(cfg, seed, trace))
    del step_fn, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _wkv_backward_share(cfg, seed: int, replay: dict) -> dict:
    """The `repro_torch::wkv6_backward` op's share of a replayed train
    step: one call at the step's shape (a microbatch, no s0) traced for its
    device busy time and kernels, and captured alone and its replay timed;
    times the calls a step makes (a layer and microbatch)."""
    import torch
    B = TRAIN_BATCH // TRAIN_MICROBATCHES
    H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)

    def n(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    shape = (B, TRAIN_SEQ, H, hd)
    args = (n(*shape), 0.5 * n(*shape), n(*shape),
            torch.exp(-torch.exp(n(*shape))), 0.5 * n(H, hd), None, n(*shape),
            n(B, H, hd, hd))

    def call():
        return torch.ops.repro_torch.wkv6_backward(*args)
    call()
    one = device_breakdown(call)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        call()
    replay_ms = cuda_ms(graph.replay, 5)
    del graph
    calls = cfg.n_layers * TRAIN_MICROBATCHES
    busy_share = calls * one["device_busy_s"] / replay["device_busy_s"]
    wall_share = calls * replay_ms / 1e3 / replay["wall_s"]
    print(f"[train {cfg.name}] wkv6_backward at {shape}: one call "
          f"{one['device_busy_s'] * 1e3:.3f} ms busy in {one['device_ops']} "
          f"device operations ({one['wall_s'] * 1e3:.3f} ms eager), "
          f"{replay_ms:.3f} ms as a graph replay; {calls} calls a step: "
          f"{busy_share:.4f} of a replayed step's busy time, "
          f"{wall_share:.4f} of its wall time")
    return {"wkv6_backward": {"shape": list(shape), "trace": one,
                              "graph_replay_ms": replay_ms,
                              "calls_per_step": calls,
                              "busy_share": busy_share,
                              "wall_share": wall_share}}


def _family_cut(arch: str, client, seed: int, times: dict) -> dict:
    """(b) `arch` cut to FAMILY_LAYERS layers at full width, as the dense
    phase trains: TRAIN_STEPS compiled steps from the store, a checkpoint
    every TRAIN_CKPT_EVERY, a storage device killed at TRAIN_DRILL_AT once
    the checkpoint of step 10 has landed; the loss must fall, and the
    step-10 checkpoint restore into the step's tensors and steps 11-15
    replay bit for bit (`_train_resume`)."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ROS2TokenLoader
    from repro_torch.distributed.checkpoint import ROS2CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import jit_train_step

    cfg = get_config(arch).replace(attn_impl="flash", n_layers=FAMILY_LAYERS)
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    tcfg = TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS,
                       warmup_steps=max(1, TRAIN_STEPS // 10),
                       num_microbatches=TRAIN_MICROBATCHES)
    params = _init_on_card(api, seed, times, f"train {arch} cut")
    opt = init_adam(params)
    step_fn = jit_train_step(api, tcfg, mctx, ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    ckpt = ROS2CheckpointManager(client, f"/ckpt-{arch}", keep=3)
    loader = ROS2TokenLoader(client, "/data", global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, prefetch=2,
                             hedge_timeout_s=0.5)
    try:
        params, opt, run = _steps_from_store(step_fn, params, opt, loader,
                                             ckpt, client)
    finally:
        loader.close()
    losses, step_s, snapshot_s, wall, last_write_s = (
        run[k] for k in ("losses", "step_s", "snapshot_s", "wall_s",
                         "last_write_s"))
    check(all(np.isfinite(losses)), f"{arch} cut: losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"{arch} cut to {FAMILY_LAYERS} layers: the loss did "
          f"not fall: first 5 steps {first}, last 5 {last}")
    out = {"n_layers": FAMILY_LAYERS, "losses": losses, "loss_first5": first,
           "loss_last5": last, "step_s": step_s,
           "step_s_median": float(np.median(step_s[1:])), "wall_s": wall,
           "ckpt_saves": ckpt.saves, "ckpt_bytes_written": ckpt.bytes_written,
           "ckpt_snapshot_s": snapshot_s, "ckpt_last_write_s": last_write_s}
    out.update(_train_resume(ckpt, step_fn, params, opt, run["batches"],
                             losses, run["at_resume_to"], tcfg))
    check(out["resume_identical"], f"{arch} cut: the resumed steps are not "
          "bit for bit the uninterrupted run's")
    print(f"[train {arch}] cut to {FAMILY_LAYERS} layers: {TRAIN_STEPS} "
          f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 "
          f"{first:.4f}, last 5 {last:.4f}); step {out['step_s_median']:.6f}"
          f" s median; {ckpt.saves} checkpoints, {ckpt.bytes_written} B, "
          f"snapshots {snapshot_s} s, last write {last_write_s:.3f} s; the "
          f"drill at step {TRAIN_DRILL_AT + 1}; wall {wall:.3f} s")
    del step_fn, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_family_phase(arch: str, seed: int, times: dict) -> dict:
    """(a) and (b) for `arch` from one dpu/RDMA store holding the dense
    phase's corpus size of the arch's vocabulary, then (d)
    launch/train.py main on its tiny config through the command line."""
    from repro_torch.core import ROS2Client
    from repro_torch.data.pipeline import write_token_shards
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    need = TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1) + TRAIN_SEQ + 1
    client = ROS2Client(mode="dpu", transport="rdma", n_devices=4)
    try:
        write_token_shards(client, "/data", launch_train.synth_tokens(
            get_config(arch).vocab, need, seed))
        t0 = time.perf_counter()
        stats = {"full": _family_full(arch, client, seed, times)}
        times[f"train_{arch}_full_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats["cut"] = _family_cut(arch, client, seed, times)
        times[f"train_{arch}_cut_s"] = time.perf_counter() - t0
        stats["dpu_ops"] = client.dpu.ops_processed
    finally:
        client.close()
    t0 = time.perf_counter()
    loss = launch_train.main(["--arch", f"tiny-{arch}", *FAMILY_MAIN_ARGS])
    times[f"train_{arch}_main_s"] = time.perf_counter() - t0
    check(np.isfinite(loss), f"launch/train.py main --arch tiny-{arch}: "
          f"loss {loss}")
    stats["main_loss"] = loss
    return stats


def train_whisper_phase(seed: int, times: dict) -> dict:
    """(c) whisper-tiny whole through jit_train_step: 1,500 x 384 bf16
    frames a row made on the card from the seed and DEC_PRIME decoder
    tokens from the synthetic corpus (the reference's train input_specs),
    8 rows in 2 microbatches, WHISPER_TRAIN_STEPS steps; the compiled step
    against the eager step from the same state, bit for bit; the loss must
    fall."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import DEC_PRIME, ModelAPI
    from repro_torch.models.params import count_params
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import (jit_train_step, make_train_step,
                                           map_tree)

    cfg = get_config(WHISPER).replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    n_frames = cfg.encdec.n_frames
    shape = ShapeConfig("train", n_frames, TRAIN_BATCH, "train")
    tcfg = TrainConfig(lr=WHISPER_TRAIN_LR,
                       total_steps=WHISPER_TRAIN_STEPS,
                       warmup_steps=max(1, WHISPER_TRAIN_STEPS // 10),
                       num_microbatches=TRAIN_MICROBATCHES)
    params = _init_on_card(api, seed, times, f"train {WHISPER}")
    opt = init_adam(params)
    rows = launch_train.synth_tokens(
        cfg.vocab, WHISPER_TRAIN_STEPS * TRAIN_BATCH * (DEC_PRIME + 1),
        seed).reshape(WHISPER_TRAIN_STEPS, TRAIN_BATCH, DEC_PRIME + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def batch(i: int) -> dict:
        return {"frames": torch.randn(
                    (TRAIN_BATCH, n_frames, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16),
                "tokens": torch.from_numpy(rows[i, :, :-1]).to("cuda"),
                "labels": torch.from_numpy(rows[i, :, 1:]).to("cuda")}
    step_fn = jit_train_step(api, tcfg, mctx, shape)
    eager_step = make_train_step(api, tcfg, mctx)
    # step 1 from the same state, eager and compiled (its first call: the
    # warm-up, then the capture); then a replay from the same state
    b0 = batch(0)
    p_e = map_tree(lambda t: t.detach().clone(), params)
    s_e = map_tree(lambda t: t.detach().clone(), opt)
    start = (map_tree(lambda t: t.detach().clone(), params),
             map_tree(lambda t: t.detach().clone(), opt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_e, s_e, m_e = eager_step(p_e, s_e, b0)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    ops.reset_launches()
    step_s = []
    for _ in range(2):
        with torch.no_grad():
            map_tree(lambda d, s: d.copy_(s), (params, opt), start)
        t0 = time.perf_counter()
        params, opt, m_c = step_fn(params, opt, b0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    got = _state_leaves(params, opt)
    want = _state_leaves(p_e, s_e)
    identical = all(bool(torch.equal(m_c[k], m_e[k]))
                    for k in ("loss", "grad_norm", "lr"))
    identical &= all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    state_err = max(float((a.detach().float() - b.detach().float()).abs()
                          .max()) for a, b in zip(got, want))
    loss_rel = abs(float(m_c["loss"]) - float(m_e["loss"])) / float(
        m_e["loss"])
    check(loss_rel <= 1e-6 and state_err <= 2 * float(m_e["lr"]),
          f"{WHISPER}: the compiled step off the eager step: loss "
          f"{loss_rel}, state {state_err}")
    del p_e, s_e, start, got, want
    losses = [float(m_c["loss"])]
    t_run = time.perf_counter()
    for i in range(1, WHISPER_TRAIN_STEPS):
        b = batch(i)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    wall = time.perf_counter() - t_run
    check(ops.launches()["fwd"] == 0 and ops.launches()["bwd"] == 0,
          f"{WHISPER}: a flash launch on the train path: {ops.launches()}")
    trace, _ = graph_kernels(lambda: step_fn(params, opt, b0))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(all(np.isfinite(losses)) and last < first,
          f"{WHISPER}: the loss did not fall: first 5 {first}, last 5 {last}")
    med = float(np.median(step_s[2:]))
    tokens = TRAIN_BATCH * DEC_PRIME
    print(f"[train {WHISPER}] whole, frames ({TRAIN_BATCH}, {n_frames}, "
          f"{cfg.d_model}) bf16, {DEC_PRIME} decoder tokens a row: compiled "
          f"step {'bit for bit' if identical else 'not bit for bit'} the "
          f"eager step (loss {loss_rel:.3e} relative, state {state_err:.3e})"
          f"; eager {eager_s:.3f} s, first call {step_s[0]:.3f} s (capture "
          f"{step_fn.capture_s:.3f} s), replay {med:.6f} s median, "
          f"{tokens / med:.3f} decoder tok/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first 5 {first:.4f}, last 5 {last:.4f}); "
          f"traced replay: wall {trace['wall_s']:.6f} s, busy "
          f"{trace['device_busy_s']:.6f} s, idle {trace['idle_share']:.4f}, "
          f"{trace['device_ops']} device operations")
    out = {"captured_vs_eager_identical": identical,
           "captured_vs_eager_loss_rel": loss_rel,
           "captured_vs_eager_state_max_abs_diff": state_err,
           "eager_step_s": eager_s, "step_s": step_s,
           "step_s_median_replays": med, "tokens_per_s": tokens / med,
           "capture_s": step_fn.capture_s, "wall_s": wall, "losses": losses,
           "loss_first5": first, "loss_last5": last, "trace_replay": trace,
           "n_params": count_params(api.param_defs())}
    del step_fn, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 12: the multi-device layer on a one-rank NCCL group -----------------
MESH_REPLAYS = 10           # replays of phase (a)'s captured steps
MOE_WAVE = (SERVE_BATCH, SERVE_PLEN)   # the serve phases' prefill wave
DTOD = "Memcpy DtoD"        # a device-to-device copy's record, as traced


def _nccl_mesh():
    """A one-rank NCCL process group (from a HashStore: no port) and its
    (data 1, model 1) mesh's context. No gloo, no fallback: a missing
    NCCL raises."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh_ctx
    check(dist.is_nccl_available(), "torch.distributed has no NCCL")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    mctx = make_host_mesh_ctx(get_config("dense-100m"), 1, 1)
    check(mctx.device_mesh is not None and mctx.device.type == "cuda"
          and dist.get_backend() == "nccl", f"no NCCL mesh: {mctx}")
    return mctx


def _copies_and_nccl(events) -> tuple:
    """(device-to-device copies, NCCL kernels by name) in a trace."""
    copies, nccl = 0, {}
    for ev in events:
        if DTOD in ev.key:
            copies += ev.count
        elif "nccl" in ev.key.lower() and ev.device_time_total > 0:
            nccl[ev.key] = ev.count
    return copies, nccl


def mesh_train_check(seed: int, mctx) -> dict:
    """(a) dense-100m at full width at the train phase's shape (batch 8,
    seq 256, 2 microbatches, flash, zero1), from one state through the
    one-device jit_train_step and through the mesh's (params and moments
    DTensors placed by param_pspecs and zero1_pspecs, the batch by
    input_pspecs), each captured in its first call and replayed
    MESH_REPLAYS times on the same batches: metrics (loss, grad norm, lr)
    every step and the state after the last bit for bit; both steps
    timed; a replay of each traced."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import mesh_ctx, single_device_ctx
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import init_adam, local
    from repro_torch.train.trainer import jit_train_step

    cfg = get_config("dense-100m").replace(attn_impl="flash")
    check(cfg.zero1, "dense-100m without zero1")
    api = ModelAPI(cfg)
    ctxs = {"one device": single_device_ctx(cfg),
            "mesh": mesh_ctx(cfg, mctx.device_mesh)}
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS,
                       warmup_steps=max(1, TRAIN_STEPS // 10),
                       num_microbatches=TRAIN_MICROBATCHES)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(api.param_defs(), gen)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(MESH_REPLAYS + 1):
        toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                            dtype=np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    runs = {}
    for name, ctx in ctxs.items():
        p = tree_map(lambda t: t.clone(), params)
        a = init_adam(p)
        step = jit_train_step(api, tcfg, ctx, shape)
        ops.reset_launches()
        metrics, step_s = [], []
        for b in batches:
            t0 = time.perf_counter()
            p, a, m = step(p, a, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])))
        launched = ops.launches()
        static = getattr(step, "step", step)
        check(static.graph is not None, f"{name}: the step was not captured")
        runs[name] = {"step": step, "params": p, "opt": a,
                      "metrics": metrics, "step_s": step_s,
                      "launched": launched, "capture_s": static.capture_s}
    one, mesh = runs["one device"], runs["mesh"]
    placed = tree_leaves(mesh["params"]) + tree_leaves(mesh["opt"].m)
    check(all(hasattr(t, "device_mesh") for t in placed),
          "the mesh step's params and moments are not DTensors")
    got = [local(t) for t in tree_leaves(mesh["params"])
           + tree_leaves(mesh["opt"].m) + tree_leaves(mesh["opt"].v)]
    want = (tree_leaves(one["params"]) + tree_leaves(one["opt"].m)
            + tree_leaves(one["opt"].v))
    identical = (mesh["metrics"] == one["metrics"]
                 and all(bool(torch.equal(x, y)) for x, y in zip(got, want)))
    loss_rel, norm_rel = (max(abs(g[i] - w[i]) / abs(w[i]) for g, w in
                              zip(mesh["metrics"], one["metrics"]))
                          for i in (0, 1))
    state_err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    check(identical, f"mesh step not bit for bit the one-device step: loss "
          f"{loss_rel} and grad norm {norm_rel} relative, state {state_err}")
    traces = {}
    for name, run in runs.items():
        trace, kernels = graph_kernels(
            lambda: run["step"](run["params"], run["opt"], batches[0]))
        events, _ = traced(
            lambda: run["step"](run["params"], run["opt"], batches[0]))
        copies, nccl = _copies_and_nccl(events)
        traces[name] = {"trace": trace, "kernels": kernels,
                        "dtod_copies": copies, "nccl_kernels": nccl}
    replay = {name: float(np.median(run["step_s"][1:]))
              for name, run in runs.items()}
    fwd, bwd = (traces["mesh"]["kernels"].get(k, 0)
                for k in ("flash fwd", "flash bwd"))
    launches = {"fwd": mesh["launched"]["fwd"] + fwd * MESH_REPLAYS,
                "bwd": mesh["launched"]["bwd"] + bwd // 2 * MESH_REPLAYS}
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          f"the mesh step launched no flash kernel: {launches}")
    mt = traces["mesh"]
    print(f"[mesh] (a) dense-100m, zero1, a one-rank NCCL (data 1, model 1) "
          f"mesh vs one device, {MESH_REPLAYS + 1} steps from one state: "
          f"bit for bit (metrics and state, every step); replay "
          f"{replay['mesh']:.6f} s median vs one device "
          f"{replay['one device']:.6f} s; first step (eager + capture) "
          f"{mesh['step_s'][0]:.3f} s vs {one['step_s'][0]:.3f} s, capture "
          f"{mesh['capture_s']:.3f} s vs {one['capture_s']:.3f} s; a traced "
          f"replay: {mt['trace']['device_ops']} device operations (one "
          f"device {traces['one device']['trace']['device_ops']}), "
          f"{mt['dtod_copies']} device-to-device copies (one device "
          f"{traces['one device']['dtod_copies']}), NCCL kernels "
          f"{mt['nccl_kernels'] or 'none'}; flash launches {launches}")
    return {"identical": identical, "replay_s": replay,
            "first_step_s": {n: r["step_s"][0] for n, r in runs.items()},
            "capture_s": {n: r["capture_s"] for n, r in runs.items()},
            "traces": traces, "flash_launches": launches,
            "metrics": mesh["metrics"]}


def mesh_moe_check(seed: int, mctx) -> dict:
    """(b) moe_ffn of one dbrx-132b layer at full width (float32 params,
    bf16 compute, the serve moe phase's layer), on random activations at
    the serve phases' prefill wave (4 x 1024 tokens), with the bf16 and
    the fp8 wire: on the one-rank NCCL mesh eagerly and as a captured
    graph's replay, each bit for bit the meshless call; the traces' device
    copies and NCCL kernels counted, and the three timed."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import mesh_ctx, single_device_ctx
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.train.trainer import BIND, StaticStep

    full = get_config("dbrx-132b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    defs = ModelAPI(full.replace(n_layers=1)).param_defs()
    layer = tree_map(lambda t: t[0], init_params(defs["blocks"]["mlp"], gen))
    x = torch.randn(*MOE_WAVE, full.d_model, generator=gen, device="cuda",
                    dtype=torch.float32).to(getattr(torch,
                                                    full.compute_dtype))
    out = {}
    for wire in ("bfloat16", "float8_e4m3fn"):
        cfg = full.replace(n_layers=1, moe=dataclasses.replace(
            full.moe, dispatch_dtype=wire))
        one, mesh = single_device_ctx(cfg), mesh_ctx(cfg, mctx.device_mesh)
        with torch.inference_mode():
            want = M.moe_ffn(x, layer, cfg, one)
            got = M.moe_ffn(x, layer, cfg, mesh)
        eager_equal = bool(torch.equal(got, want))
        step = StaticStep(lambda p, h: M.moe_ffn(h, p, cfg, mesh),
                          mctx.device, {"p": BIND, "x": BIND})
        with torch.inference_mode():
            step(layer, x)
            replayed = step(layer, x).clone()
        check(step.graph is not None, f"{wire}: moe_ffn was not captured")
        replay_equal = bool(torch.equal(replayed, want))
        check(eager_equal and replay_equal, f"moe_ffn on the {wire} wire: "
              f"mesh eager {eager_equal}, replay {replay_equal} vs meshless")
        counts = {}
        with torch.inference_mode():
            for name, fn in (("meshless", lambda: M.moe_ffn(x, layer, cfg,
                                                            one)),
                             ("mesh", lambda: M.moe_ffn(x, layer, cfg, mesh)),
                             ("replay", lambda: step(layer, x))):
                events, _ = traced(fn)
                counts[name] = _copies_and_nccl(events)
            ms = {"meshless": cuda_ms(lambda: M.moe_ffn(x, layer, cfg, one),
                                      5),
                  "mesh": cuda_ms(lambda: M.moe_ffn(x, layer, cfg, mesh), 5),
                  "replay": cuda_ms(lambda: step(layer, x), 5)}
        exchanges = counts["mesh"][0] - counts["meshless"][0]
        check(exchanges > 0 and counts["replay"][0] >= exchanges,
              f"{wire}: no collective in the traces: {counts}")
        print(f"[mesh] (b) dbrx-132b moe_ffn, {MOE_WAVE[0]} x {MOE_WAVE[1]} "
              f"tokens, {wire} wire: mesh eager and replay bit for bit the "
              f"meshless call; device-to-device copies a call: meshless "
              f"{counts['meshless'][0]}, mesh {counts['mesh'][0]} (the "
              f"one-rank group's all_to_all_single x 3), "
              f"replay {counts['replay'][0]}; NCCL kernels: "
              f"{counts['mesh'][1] or 'none (a one-rank NCCL collective is a device copy)'}"
              f"; ms a call: meshless {ms['meshless']:.3f}, mesh "
              f"{ms['mesh']:.3f}, replay {ms['replay']:.3f}, capture "
              f"{step.capture_s:.3f} s")
        out[wire] = {"eager_equal": eager_equal, "replay_equal": replay_equal,
                     "dtod_copies": {k: v[0] for k, v in counts.items()},
                     "nccl_kernels": {k: v[1] for k, v in counts.items()},
                     "collective_copies": exchanges, "ms": ms,
                     "capture_s": step.capture_s}
        del step, want, got, replayed
        gc.collect()
        torch.cuda.empty_cache()
    return out


MESH_DRYRUN = f"""
import json
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.params import MeshShape
cfg = get_config("dense-100m").replace(attn_impl="flash")
print(json.dumps(dryrun.trace_cell(
    cfg, ShapeConfig("train", {TRAIN_SEQ}, {TRAIN_BATCH}, "train"),
    MeshShape(("data", "model"), (1, 1)), {TRAIN_MICROBATCHES})))
"""


def _dryrun_process(code: str, *args: str):
    """`code` started in a Python process of its own from the checkout's
    src (a dry-run's fake process group is global); its last line of
    output is read by `_dryrun_result`."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-W", "ignore", "-c", code,
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


def _dryrun_result(proc, timeout: float = 600):
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"dry-run process failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _held(label: str, fake: dict, real: dict) -> dict:
    """A dry-run's record against the same step's counts on the card: the
    FLOPs and the collectives of each kind must be equal."""
    check(fake["flops_per_device"] == real["flops_per_device"],
          f"{label}: dry-run FLOPs {fake['flops_per_device']} != "
          f"{real['flops_per_device']} on the card")
    check(fake["collective_counts"] == real["collective_counts"],
          f"{label}: dry-run collectives {fake['collective_counts']} != "
          f"{real['collective_counts']} on the card")
    return {"flops": real["flops_per_device"],
            "flops_by_op_equal": fake["flops_by_op"] == real["flops_by_op"],
            "collective_counts": real["collective_counts"],
            "collective_bytes": real["collective_bytes_per_device"],
            "dryrun_bytes": fake["bytes_per_device"],
            "card_bytes": real["bytes_per_device"],
            "dryrun_memory": fake["memory"], "trace_s": fake["trace_s"]}


def mesh_dryrun_check(seed: int, mctx, fake_mesh) -> dict:
    """13(b): the mesh train step of (a) (dense-100m, zero1, the one-rank
    NCCL mesh), its body run once eagerly on the card under the dry-run's
    counters, against the dry-run of the same step on a one-rank fake
    mesh: FLOPs and the collectives of each kind equal."""
    import torch
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import mesh_ctx
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import init_adam

    cfg = get_config("dense-100m").replace(attn_impl="flash")
    api = ModelAPI(cfg)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    step = dryrun.make_step(api, mesh_ctx(cfg, mctx.device_mesh), shape,
                            TRAIN_MICROBATCHES)
    params = init_params(api.param_defs(),
                         torch.Generator(device="cuda").manual_seed(seed))
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    real = dryrun.record_step(step, (params, init_adam(params), batch))
    torch.cuda.synchronize()
    held = _held("mesh train step", _dryrun_result(fake_mesh), real)
    print(f"[dryrun] (b) the mesh train step on the one-rank NCCL mesh vs "
          f"its dry-run on a one-rank fake mesh: {held['flops']:.6e} FLOP "
          f"and collectives {held['collective_counts']} in both (by op "
          f"{'equal' if held['flops_by_op_equal'] else 'not equal'}); "
          f"traced in {held['trace_s']} s")
    return held


def mesh_phase(seed: int, times: dict) -> dict:
    """The multi-device layer driven on the card through a one-rank NCCL
    group: (a) the DTensor/ZeRO-1 train step, (b) expert parallelism's
    collectives in moe_ffn. GPipe needs two stages and has no card
    check."""
    import torch
    import torch.distributed as dist
    torch.cuda.empty_cache()
    # 13(b)'s dry-run, on a one-rank fake mesh, in a process of its own
    # (the process group is global), beside the mesh phase
    fake_mesh = _dryrun_process(MESH_DRYRUN)
    t0 = time.perf_counter()
    mctx = _nccl_mesh()
    try:
        train = mesh_train_check(seed, mctx)
        times["mesh_train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe = mesh_moe_check(seed, mctx)
        times["mesh_moe_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train["dryrun"] = mesh_dryrun_check(seed, mctx, fake_mesh)
        times["mesh_dryrun_s"] = time.perf_counter() - t0
    finally:
        fake_mesh.kill()
        dist.destroy_process_group()
    print("[mesh] GPipe (distributed/pipeline.py) needs two stages, so one "
          "card has no check of it: tests/test_torch_multidevice.py holds it "
          "against the sequential forward on gloo ranks")
    return {"train": train, "moe": moe}


# -- phase 12(c), 12(d): one rank of the production 16 x 16 mesh at full width --
RANK_ARCH, RANK_CELL = "gemma-7b", "train_4k"
RANK_DRYRUN = """
import json, sys
from repro_torch.launch import dryrun
print(json.dumps(dryrun.run_cell(sys.argv[1], sys.argv[2])))
"""
FAMILY_RANKS = {  # 12(d): arch -> (cell, layers kept; None: whole)
    "recurrentgemma-2b": ("train_4k", None),
    # a prefill, not a train step: on the card the plain wkv6_backward at
    # T = 4096 is a sequential autograd recurrence of about 16 x the
    # ~8,900 operations a call it takes at T = 256, past the time limit
    "rwkv6-1.6b": ("prefill_32k", None),
    # 2 of its 20 super-blocks (10 of 100 layers), as the vlm serve phase
    # cuts it
    VLM: ("train_4k", VLM_SUPER_BLOCKS * 5),
}
# 12(e): arch -> (cell, layers kept), the moe serve phase's depths
MOE_RANKS = {arch: ("train_4k", layers) for arch, layers in MOE_SERVE.items()}
SAVE_COLL = "save_collectives"  # 12(c)'s second run; the dry-run's "save-coll"
# the dry-runs of a rank of the production mesh: a JSON object of key ->
# (arch, cell, layers kept or None, dry-run variant), traced in turn
RANKS_DRYRUN = """
import json, sys
from repro_torch.common.config import SHAPE_BY_NAME
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
out = {}
for key, (arch, cell, layers, variant) in json.loads(sys.argv[1]).items():
    cfg, nmb = dryrun.apply_variant(
        get_config(arch).replace(attn_impl=dryrun.ATTN_IMPL), variant)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    out[key] = dryrun.trace_cell(cfg, SHAPE_BY_NAME[cell],
                                 production_mesh_shape(), nmb)
print(json.dumps(out))
"""
FAMILY_RANK_DRYRUN = {arch: (arch, cell, layers, "")
                      for arch, (cell, layers) in FAMILY_RANKS.items()}
MOE_RANK_DRYRUN = {**{arch: (arch, cell, layers, "")
                      for arch, (cell, layers) in MOE_RANKS.items()},
                   SAVE_COLL: (RANK_ARCH, RANK_CELL, None, "save-coll")}


def _kernel_calls():
    """A context in which each model kernel's wrapper counts its launches
    from 0 and every call's shape is kept: flash_attention's (q, k),
    rglru_scan's (a, reversed) and wkv6's r. Yields a dict whose "calls"
    fill as the path runs and whose "launches" are read on leaving."""
    import contextlib
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    real = (fops.flash_attention, rops._scan, wops._forward)
    out = {"calls": {"flash_attention": set(), "rglru_scan": set(),
                     "wkv6": set()}}
    calls = out["calls"]

    def flash(q, k, v, **kw):
        calls["flash_attention"].add((tuple(q.shape), tuple(k.shape)))
        return real[0](q, k, v, **kw)

    def scan(a, b, h0, reverse):
        calls["rglru_scan"].add((tuple(a.shape), bool(reverse)))
        return real[1](a, b, h0, reverse)

    def wkv(r, *rest):
        calls["wkv6"].add(tuple(r.shape))
        return real[2](r, *rest)

    @contextlib.contextmanager
    def counting():
        for m in (fops, rops, wops):
            m.reset_launches()
        # each is looked up at its call
        fops.flash_attention, rops._scan, wops._forward = flash, scan, wkv
        try:
            yield out
        finally:
            fops.flash_attention, rops._scan, wops._forward = real
            out["launches"] = {"flash_attention": fops.launches(),
                               "rglru_scan": rops.launches(),
                               "wkv6": wops.launches()}
    return counting()


def _rank_step(arch: str, cell: str, layers, seed: int,
               remat_policy: str = "nothing") -> dict:
    """Rank 0 of the production 16 x 16 mesh over torch's fake process
    group (the dry-run's "fake" backend: its collectives move nothing, so
    the values are not the model's, and this measures memory and time
    only; tests/test_torch_tensor_parallel*.py hold the values on gloo
    ranks), with real tensors on the card: `arch` (cut to `layers` where
    given, under `remat_policy`) at `cell`, its step's body run once
    eagerly on params (and
    AdamW moments) and inputs made as this rank's shards. Returns the
    step's seconds, max_memory_allocated over it, the state's GB, each
    model kernel's launches and call shapes (`_kernel_calls`), and the
    loss (train) or whether the last logits are finite (prefill)."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import SHAPE_BY_NAME, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models.api import ModelAPI, shardings_for
    from repro_torch.models.context import MeshCtx, make_rules
    from repro_torch.models.params import (init_params, sharded_zeros,
                                           tree_map, zero1_pspecs)
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.trainer import (jit_prefill_step, jit_train_step,
                                           map_tree, placed)

    cfg = get_config(arch).replace(attn_impl="flash",
                                   remat_policy=remat_policy)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    shape = SHAPE_BY_NAME[cell]
    ms = production_mesh_shape()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    mesh = dryrun.fake_mesh(ms.shape, ms.axis_names)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        mctx = MeshCtx(device=dev, mesh=mesh, rules=make_rules(cfg))
        api = ModelAPI(cfg)
        defs = api.param_defs()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(defs, gen, getattr(torch, cfg.param_dtype),
                             mesh=mesh, rules=mctx.rules)
        specs = api.input_specs(shape)
        fitted = shardings_for(mesh, specs, api.input_pspecs(mctx, shape))
        inputs = map_tree(lambda c, s: sharded_zeros(c.shape, c.dtype, dev,
                                                     mesh, s), specs, fitted)
        for t in inputs.values():
            if t.dtype.is_floating_point:
                t.to_local().normal_(generator=gen)
            else:
                t.to_local().random_(0, cfg.vocab, generator=gen)
        nmb = 1
        if shape.kind == "train":
            z = zero1_pspecs(defs, mesh, mctx.rules)
            moments = [tree_map(lambda d, s: sharded_zeros(
                d.shape, torch.float32, dev, mesh, s), defs, z)
                for _ in "mv"]
            opt = AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                            *moments)
            nmb = dryrun.TRAIN_MICROBATCHES[arch]
            step = jit_train_step(api, TrainConfig(num_microbatches=nmb),
                                  mctx, shape)
            args = placed(step, params, opt, inputs)
            del moments, opt
        else:
            step = jit_prefill_step(api, mctx, shape)
            args = placed(step, params, inputs)
        del params, inputs
        state_gb = (torch.cuda.memory_allocated() - before) / 1e9
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _kernel_calls() as kernels:
            t0 = time.perf_counter()
            out = step.step.trace(*args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        if shape.kind == "train":
            result = {"loss": float(out[2]["loss"])}
        else:
            result = {"logits_finite": bool(
                torch.isfinite(out[0].to_local()).all())}
        del out, args, step
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "cell": cell, "layers": cfg.n_layers,
            "remat_policy": remat_policy, "microbatches": nmb,
            "rows": shape.global_batch // ms.shape[0] // nmb,
            "seq_len": shape.seq_len, "step_s": step_s,
            "max_memory_allocated_gb": peak / 1e9, "state_gb": state_gb,
            "launches": kernels["launches"],
            "calls": {k: sorted(v) for k, v in kernels["calls"].items()},
            **result}


def _flash_held(label: str, shape: tuple, gen) -> tuple:
    """One flash forward and one backward call at (B, T=S, H, KH, D),
    bf16, causal, held against their plain versions; their largest
    errors."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    B, T, H, KH, D = shape
    q, k, v, dout = (torch.randn(B, T, h, D, generator=gen, device="cuda"
                                 ).bfloat16() for h in (H, KH, KH, H))
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    fwd_err, ok = in_tolerance(o, ref.attention_ref(q, k, v),
                               FLASH_TOL["bfloat16"])
    check(ok, f"{label}: flash forward at {shape} off its plain version "
          f"by {fwd_err}")
    got = ops.flash_attention_backward(q, k, v, o, lse, dout, scale=D ** -0.5)
    want_g = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                         scale=D ** -0.5, causal=True,
                                         window=None, seq_k=T)
    bwd_err = 0.0
    for g, w, name in zip(got, want_g, ("dq", "dk", "dv")):
        err, ok = in_tolerance(g, w, BWD_TOL["bfloat16"])
        check(ok, f"{label}: flash backward {name} at {shape} off its "
              f"plain version by {err}")
        bwd_err = max(bwd_err, err)
    return fwd_err, bwd_err


def _rank_line(label: str, got: dict, dry: dict, ms) -> float:
    """Prints one rank's step beside its dry-run; returns the dry-run's
    peak in GB."""
    dry_gb = dry["memory"]["peak_memory_in_bytes"] / 1e9
    peak_gb = got["max_memory_allocated_gb"]
    check(peak_gb < 80, f"{label}: {peak_gb} GB past one card")
    launched = {k: v for k, v in got["launches"].items() if any(v.values())}
    print(f"[rank] {label} {got['arch']} x {got['cell']} ({got['layers']} "
          f"layers), rank 0 of the {ms.shape[0]} x {ms.shape[1]} mesh over "
          f"the fake process group, {got['microbatches']} microbatch(es) of "
          f"{got['rows']} x {got['seq_len']} tokens, eager: step "
          f"{got['step_s']:.3f} s; max_memory_allocated {peak_gb:.3f} GB "
          f"(params, moments and inputs {got['state_gb']:.3f} GB) vs the "
          f"dry-run's peak {dry_gb:.3f} GB (ratio {dry_gb / peak_gb:.4f}, "
          f"traced in {dry['trace_s']} s); launches {launched} at "
          f"{ {k: v for k, v in got['calls'].items() if v} }; "
          + ", ".join(f"{k} {v}" for k, v in got.items()
                      if k in ("loss", "logits_finite"))
          + " (fake collectives: not the model's)")
    return dry_gb


def rank_phase(seed: int, fake_dryrun, save_coll_dry: dict) -> dict:
    """12(c): `_rank_step` of gemma-7b's train step at train_4k (8
    microbatches of 2 x 4096 tokens): max_memory_allocated beside the
    dry-run's peak for the cell, the step's seconds, the flash launches
    (every call at RANK_SHAPE, head_dim 256), and one forward and one
    backward call at that shape held against their plain versions. Then
    the same step with remat_policy="save_collectives" beside the first
    and beside `save_coll_dry`, its dry-run (variant "save-coll")."""
    import torch
    from repro_torch.launch.mesh import production_mesh_shape
    got = _rank_step(RANK_ARCH, RANK_CELL, None, seed)
    launched = got["launches"]["flash_attention"]
    B, T, H, KH, D = RANK_SHAPE
    want = [((B, T, H, D), (B, T, KH, D))]
    check(got["calls"]["flash_attention"] == want,
          f"12(c): flash calls at {got['calls']['flash_attention']}, not "
          f"{want}")
    check(launched["fwd"] > 0 and launched["bwd"] > 0,
          f"12(c): the step launched no flash kernel: {launched}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fwd_err, bwd_err = _flash_held("12(c)", RANK_SHAPE, gen)
    fake = _dryrun_result(fake_dryrun)
    dry_gb = _rank_line("(c)", got, fake, production_mesh_shape())
    print(f"[rank] (c) one flash forward and one backward call at "
          f"{RANK_SHAPE} (B, T=S, H, KH, D) vs their plain versions: "
          f"{fwd_err:.6f}, {bwd_err:.6f}")
    peak_gb = got["max_memory_allocated_gb"]
    save = _rank_step(RANK_ARCH, RANK_CELL, None, seed, SAVE_COLL)
    check(save["calls"]["flash_attention"] == want
          and save["launches"]["flash_attention"] == launched,
          f"12(c) {SAVE_COLL}: flash {save['launches']} at "
          f"{save['calls']}, not {launched} at {want}")
    save_dry_gb = _rank_line(f"(c) {SAVE_COLL}", save, save_coll_dry,
                             production_mesh_shape())
    print(f"[rank] (c) remat_policy {SAVE_COLL} vs nothing: "
          f"max_memory_allocated {save['max_memory_allocated_gb']:.3f} vs "
          f"{peak_gb:.3f} GB (dry-run {save_dry_gb:.3f} vs {dry_gb:.3f}; "
          f"all-reduces {save_coll_dry['collective_counts']['all-reduce']} "
          f"vs {fake['collective_counts']['all-reduce']}, FLOPs "
          f"{save_coll_dry['flops_per_device']:.6e} vs "
          f"{fake['flops_per_device']:.6e}); step {save['step_s']:.3f} vs "
          f"{got['step_s']:.3f} s (over the fake group's collectives, which "
          f"move nothing, only the memory means anything)")
    return {"arch": RANK_ARCH, "cell": RANK_CELL, "step_s": got["step_s"],
            "max_memory_allocated_gb": peak_gb, "state_gb": got["state_gb"],
            "dryrun_peak_gb": dry_gb, "dryrun_trace_s": fake["trace_s"],
            "dryrun_over_card": dry_gb / peak_gb,
            "dryrun_collectives": fake["collective_counts"],
            "dryrun_flops": fake["flops_per_device"],
            "flash_launches": launched, "flash_fwd_err": fwd_err,
            "flash_bwd_err": bwd_err, "microbatches": got["microbatches"],
            SAVE_COLL: {
                "step_s": save["step_s"],
                "max_memory_allocated_gb": save["max_memory_allocated_gb"],
                "state_gb": save["state_gb"], "dryrun_peak_gb": save_dry_gb,
                "dryrun_trace_s": save_coll_dry["trace_s"],
                "dryrun_over_card": save_dry_gb
                / save["max_memory_allocated_gb"],
                "dryrun_collectives": save_coll_dry["collective_counts"],
                "dryrun_flops": save_coll_dry["flops_per_device"],
                "flash_launches": save["launches"]["flash_attention"]}}


def family_rank_phase(seed: int, fake_dryrun) -> dict:
    """12(d): `_rank_step` of the hybrid, ssm and vlm families
    (FAMILY_RANKS): recurrentgemma-2b's train step at train_4k (8
    microbatches of 2 x 4096 tokens; every rglru_scan call, forward and
    reversed, at its 160 local channels, RGLRU_RANK; its local attention
    takes the plain path, as the reference passes it no impl: no flash
    launch), rwkv6-1.6b's prefill at prefill_32k (2 x 32768 tokens; every
    wkv6 call at its 2 local heads, WKV_RANK, one a layer) and
    llama-3.2-vision-90b's train step at train_4k cut to 10 layers (16
    microbatches of 1 x 4096 tokens and 4,096 patch embeddings; every
    flash call at VLM_RANK_SHAPE). Each: max_memory_allocated beside the
    dry-run's peak for the cell at that depth (a process of its own,
    started before the serve phase), the step's seconds, the launches and
    call shapes; then each kernel at its local shape held against its
    plain version: rglru_scan forward and reversed (1e-5), wkv6 (3e-4),
    the flash forward and backward (2e-2, 5e-2)."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as rref
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan import ref as wref
    from repro_torch.launch.mesh import production_mesh_shape
    ms = production_mesh_shape()
    runs = {arch: _rank_step(arch, cell, layers, seed)
            for arch, (cell, layers) in FAMILY_RANKS.items()}
    hybrid, ssm, vlm = (runs[a] for a in FAMILY_RANKS)
    want = {"recurrentgemma-2b": ("rglru_scan", [(RGLRU_RANK, False),
                                                 (RGLRU_RANK, True)]),
            "rwkv6-1.6b": ("wkv6", [WKV_RANK]),
            VLM: ("flash_attention", [(
                VLM_RANK_SHAPE[:3] + VLM_RANK_SHAPE[4:],
                VLM_RANK_SHAPE[:2] + VLM_RANK_SHAPE[3:])])}
    for arch, (kernel, calls) in want.items():
        got = runs[arch]
        check(got["calls"][kernel] == calls, f"12(d) {arch}: {kernel} "
              f"calls at {got['calls'][kernel]}, not {calls}")
        for other, shapes in got["calls"].items():
            check(other == kernel or not shapes, f"12(d) {arch}: {other} "
                  f"called at {shapes}")
    check(hybrid["launches"]["rglru_scan"]["fwd"] > 0
          and hybrid["launches"]["rglru_scan"]["bwd"] > 0,
          f"12(d): the hybrid's step launched {hybrid['launches']}")
    n_wkv = ssm["launches"]["wkv6"]["fwd"]
    from repro_torch.configs import get_config
    check(n_wkv == get_config("rwkv6-1.6b").n_layers,
          f"12(d): the ssm's prefill launched wkv6 {n_wkv} times")
    vf = vlm["launches"]["flash_attention"]
    check(vf["fwd"] > 0 and vf["bwd"] > 0,
          f"12(d): the vlm's step launched flash {vf}")
    check(all(v.get("loss") is None or np.isfinite(v["loss"])
              for v in runs.values()) and ssm["logits_finite"],
          f"12(d): a value not finite: {runs}")

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    B, T, R = RGLRU_RANK
    a = torch.sigmoid(2 * torch.randn(B, T, R, generator=gen, device="cuda"))
    b = torch.randn(B, T, R, generator=gen, device="cuda")
    rg_err = 0.0
    for reverse in (False, True):
        err, ok = in_tolerance(RGK.rglru_scan(a, b, None, reverse=reverse),
                               rref.rglru_scan_ref(a, b, None,
                                                   reverse=reverse), 1e-5)
        check(ok, f"12(d): rglru_scan at {RGLRU_RANK} (reverse={reverse}) "
              f"off its plain version by {err}")
        rg_err = max(rg_err, err)
    del a, b
    B, T, H, hd = WKV_RANK
    xs = [torch.randn(B, T, H, hd, generator=gen, device="cuda")
          for _ in range(4)]
    xs[1] *= 0.5
    xs[3] = torch.exp(-torch.exp(xs[3]))
    u = 0.5 * torch.randn(H, hd, generator=gen, device="cuda")
    wkv_err = 0.0
    for g, w, name in zip(WK.wkv6(*xs, u), wref.wkv_plain(*xs, u),
                          ("y", "state")):
        err, ok = in_tolerance(g, w, 3e-4)
        check(ok, f"12(d): wkv6 {name} at {WKV_RANK} off its plain version "
              f"by {err}")
        wkv_err = max(wkv_err, err)
    del xs, u
    fwd_err, bwd_err = _flash_held("12(d)", VLM_RANK_SHAPE, gen)

    fake = _dryrun_result(fake_dryrun)
    for arch, got in runs.items():
        got["dryrun_peak_gb"] = _rank_line("(d)", got, fake[arch], ms)
        got["dryrun_trace_s"] = fake[arch]["trace_s"]
        got["dryrun_flops"] = fake[arch]["flops_per_device"]
    print(f"[rank] (d) at the local shapes vs the plain versions: "
          f"rglru_scan forward and reversed at {RGLRU_RANK} (B, T, R) "
          f"{rg_err:.3e}; wkv6 at {WKV_RANK} (B, T, H, hd) {wkv_err:.3e}; "
          f"flash forward and backward at {VLM_RANK_SHAPE} (B, T=S, H, KH, "
          f"D) {fwd_err:.6f}, {bwd_err:.6f}")
    return {"runs": runs, "rglru_err": rg_err, "wkv_err": wkv_err,
            "flash_fwd_err": fwd_err, "flash_bwd_err": bwd_err}


def moe_rank_phase(seed: int, dry: dict) -> dict:
    """12(e): `_rank_step` of the moe family's train step at train_4k at
    the moe serve phase's depths (MOE_RANKS; 16 microbatches of 1 x 4096
    tokens): dbrx-132b, every flash call at DBRX_RANK_SHAPE, twice a layer
    a microbatch forward (remat's recompute) and once backward, both
    kernels held against their plain versions there; deepseek-v2-236b,
    whose MLA takes the plain attention: no flash call. Each:
    max_memory_allocated beside the dry-run's peak for the cell at that
    depth (`dry`, from a process started before the serve phase), the
    step's seconds, the state's GB, the launches and call shapes. The
    loss is printed, not held: the fake group's all-to-all writes nothing
    into its receive buffer."""
    import torch
    from repro_torch.launch.mesh import production_mesh_shape
    ms = production_mesh_shape()
    runs = {arch: _rank_step(arch, cell, layers, seed)
            for arch, (cell, layers) in MOE_RANKS.items()}
    dbrx, deepseek = runs["dbrx-132b"], runs["deepseek-v2-236b"]
    B, T, H, KH, D = DBRX_RANK_SHAPE
    want = [((B, T, H, D), (B, T, KH, D))]
    per = dbrx["layers"] * dbrx["microbatches"]
    check(dbrx["calls"]["flash_attention"] == want,
          f"12(e) dbrx-132b: flash calls at "
          f"{dbrx['calls']['flash_attention']}, not {want}")
    launched = dbrx["launches"]["flash_attention"]
    check(launched["fwd"] == 2 * per and launched["bwd"] == per
          and not launched["bwd_softcap"],
          f"12(e) dbrx-132b: flash launches {dbrx['launches']}, not "
          f"{2 * per} forward and {per} backward")
    check(not any(any(v.values()) for v in deepseek["launches"].values())
          and not any(deepseek["calls"].values()),
          f"12(e) deepseek-v2-236b: a kernel launched: "
          f"{deepseek['launches']} at {deepseek['calls']}")
    for arch, got in runs.items():
        for other, shapes in got["calls"].items():
            check(other == "flash_attention" or not shapes,
                  f"12(e) {arch}: {other} called at {shapes}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    fwd_err, bwd_err = _flash_held("12(e)", DBRX_RANK_SHAPE, gen)
    for arch, got in runs.items():
        got["dryrun_peak_gb"] = _rank_line("(e)", got, dry[arch], ms)
        got["dryrun_trace_s"] = dry[arch]["trace_s"]
        got["dryrun_flops"] = dry[arch]["flops_per_device"]
        got["dryrun_collectives"] = dry[arch]["collective_counts"]
    print(f"[rank] (e) flash forward and backward at {DBRX_RANK_SHAPE} (B, "
          f"T=S, H, KH, D) vs their plain versions: {fwd_err:.6f}, "
          f"{bwd_err:.6f}; deepseek-v2-236b's MLA: no flash launch")
    return {"runs": runs, "flash_fwd_err": fwd_err,
            "flash_bwd_err": bwd_err}


# -- phase 13: the dry-run and the roofline -----------------------------------
PROD_ARCH = "granite-3-2b"                    # 13(c): on 16 x 16 fake ranks
PROD_SHAPES = ("decode_32k", "prefill_32k")
PROD_DRYRUN = """
import json, sys, time
from repro_torch.launch import dryrun
t0 = time.perf_counter()
recs = {s: dryrun.run_cell(sys.argv[1], s) for s in sys.argv[2:]}
print(json.dumps({"records": recs, "wall_s": time.perf_counter() - t0}))
"""


def _step_vs_dryrun(label: str, api, shape, args, nmb: int = 1) -> dict:
    """13(a): `api`'s step at `shape` traced by the dry-run, then run once
    eagerly on the card on `args` under the same counters: FLOPs and the
    collectives of each kind equal; the dry-run's peak bytes beside
    torch.cuda.max_memory_allocated() over the real step."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models.context import single_device_ctx
    fake = dryrun.trace_cell(api.cfg, shape, nmb=nmb)
    step = dryrun.make_step(api, single_device_ctx(api.cfg), shape, nmb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    real = dryrun.record_step(step, args)
    torch.cuda.synchronize()
    held = _held(label, fake, real)
    peak = torch.cuda.max_memory_allocated()
    dry = fake["memory"]["peak_memory_in_bytes"]
    held.update({"dryrun_peak_bytes": dry, "max_memory_allocated": peak,
                 "allocated_before": before, "peak_ratio": dry / peak})
    print(f"[dryrun] (a) {label}: {held['flops']:.6e} FLOP in both (by op "
          f"{'equal' if held['flops_by_op_equal'] else 'not equal'}), "
          f"collectives {held['collective_counts'] or 'none'}; peak: dry-run "
          f"{dry / 1e9:.3f} GB, max_memory_allocated {peak / 1e9:.3f} GB "
          f"({before / 1e9:.3f} GB allocated before the step), ratio "
          f"{dry / peak:.4f}; traced in {fake['trace_s']} s")
    return held


def dryrun_card_checks(seed: int) -> dict:
    """13(a) for dense-100m's train step (the train phase's shape) and
    granite-3-2b's prefill wave and decode step (the serve phase's), at
    full width."""
    import torch
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import init_adam

    out = {}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    api = ModelAPI(get_config("dense-100m").replace(attn_impl="flash"))
    params = init_params(api.param_defs(), gen)
    toks = torch.from_numpy(rng.integers(
        0, api.cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)).cuda()
    out["dense-100m train"] = _step_vs_dryrun(
        "dense-100m train step", api,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        (params, init_adam(params), {"tokens": toks[:, :-1].contiguous(),
                                     "labels": toks[:, 1:].contiguous()}),
        TRAIN_MICROBATCHES)
    del params
    torch.cuda.empty_cache()
    api = ModelAPI(get_config(PROD_ARCH).replace(attn_impl="flash"))
    params = init_params(api.param_defs(), gen)
    cfg = api.cfg
    max_seq = SERVE_PLEN + SERVE_MAX_NEW + 8
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PLEN), dtype=np.int32)).cuda()
    out[f"{PROD_ARCH} prefill"] = _step_vs_dryrun(
        f"{PROD_ARCH} prefill wave", api,
        ShapeConfig("prefill", SERVE_PLEN, SERVE_BATCH, "prefill"),
        (params, {"tokens": toks}))
    cache = {k: torch.zeros(c.shape, dtype=c.dtype, device="cuda")
             for k, c in api.cache_specs(SERVE_BATCH, max_seq).items()}
    pos = torch.full((SERVE_BATCH,), SERVE_PLEN, dtype=torch.int32,
                     device="cuda")
    out[f"{PROD_ARCH} decode"] = _step_vs_dryrun(
        f"{PROD_ARCH} decode step", api,
        ShapeConfig("decode", max_seq, SERVE_BATCH, "decode"),
        (params, toks[:, -1].contiguous(), pos, cache))
    return out


def roofline_shares(card: str, serve: dict, train: dict,
                    families: dict) -> dict:
    """13(d): each path's model-FLOP share and roofline share from the
    times the earlier phases measured (compiled steps): mfu =
    model_flops_per_step(cfg as run, shape as run) / (measured s x the
    bf16 peak), and the analytic roofline at MeshPlan(1, 1), measured s
    over its bound and the dominant term."""
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.roofline.analytic import (MeshPlan, model_flops_per_step,
                                               terms_for)

    def as_run(arch: str):
        full = get_config(arch)
        if arch in MOE_SERVE:
            return full.replace(n_layers=MOE_SERVE[arch])
        if arch == VLM:
            return full.replace(n_layers=VLM_SUPER_BLOCKS
                                * full.vlm.cross_every)
        return full

    rows = {}

    def row(name: str, cfg, shape, seconds: float, nmb: int = 1) -> None:
        t = terms_for(cfg, shape, MeshPlan(dp=1, tp=1), nmb)
        sec = t.seconds()
        bound = max(sec["compute_s"], sec["memory_s"], sec["collective_s"])
        mfu = model_flops_per_step(cfg, shape) / (seconds * PEAK_FLOPS_BF16)
        rows[name] = {"measured_s": seconds, "mfu": mfu, "roofline_s": bound,
                      "measured_over_roofline": seconds / bound,
                      "dominant": sec["dominant"], "layers": cfg.n_layers,
                      "seq_len": shape.seq_len, "batch": shape.global_batch}
        print(f"[roofline] {name} ({cfg.n_layers} layers; {card}): mfu "
              f"{mfu:.6f}, roofline {bound:.6e} s ({sec['dominant']}), "
              f"measured {seconds:.6e} s = {seconds / bound:.4f}x the "
              f"roofline")

    for arch, stats in serve.items():
        cfg = as_run(arch)
        plen = WHISPER_PLEN if arch == WHISPER else SERVE_PLEN
        max_seq = plen + SERVE_MAX_NEW + 8
        row(f"{arch} prefill wave", cfg,
            ShapeConfig("prefill", plen, SERVE_BATCH, "prefill"),
            stats["prefill_s_per_wave"])
        row(f"{arch} decode step", cfg,
            ShapeConfig("decode", max_seq, SERVE_BATCH, "decode"),
            stats["decode_ms_per_step"] / 1e3)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    row("dense-100m train step", get_config("dense-100m"), shape,
        train["step_s_median_replays"], TRAIN_MICROBATCHES)
    for arch in FAMILY_TRAIN:
        full = families[arch]["full"]
        row(f"{arch} train step", get_config(arch).replace(
            n_layers=full["n_layers"]), shape, full["step_s_median_replays"],
            TRAIN_MICROBATCHES)
    whisper = get_config(WHISPER)
    row(f"{WHISPER} train step", whisper, ShapeConfig(
        "train", whisper.encdec.n_frames, TRAIN_BATCH, "train"),
        families[WHISPER]["step_s_median_replays"], TRAIN_MICROBATCHES)
    return rows


def dryrun_phase(seed: int, card: str, serve: dict, train: dict,
                 families: dict, times: dict) -> dict:
    """Phase 13: (c) started first, in a process of its own; (a) the
    dry-run against the steps it models, on the card; (d) the roofline
    shares of every serve and train path; then (c)'s records."""
    t0 = time.perf_counter()
    prod = _dryrun_process(PROD_DRYRUN, PROD_ARCH, *PROD_SHAPES)
    try:
        steps = dryrun_card_checks(seed)
        times["dryrun_card_s"] = time.perf_counter() - t0
        shares = roofline_shares(card, serve, train, families)
        out = _dryrun_result(prod)
    finally:
        prod.kill()
    cells = {}
    for shape, rec in out["records"].items():
        check(rec["ok"] and rec["n_devices"] == 256,
              f"{PROD_ARCH} x {shape}: {rec}")
        cells[shape] = {k: rec[k] for k in (
            "trace_s", "flops_per_device", "collective_bytes_per_device",
            "collective_counts", "memory", "trace_device")}
        print(f"[dryrun] (c) {PROD_ARCH} x {shape} on the 16 x 16 mesh of 256 "
              f"fake ranks ({rec['trace_device']}): traced in "
              f"{rec['trace_s']} s, {rec['flops_per_device']:.4e} FLOP, "
              f"{rec['collective_bytes_per_device']:.4e} collective B, peak "
              f"{rec['memory']['peak_memory_in_bytes'] / 1e9:.3f} GB a rank")
    times["dryrun_phase_s"] = time.perf_counter() - t0
    return {"steps": steps, "production": cells,
            "production_wall_s": out["wall_s"], "roofline": shares,
            "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-mib", type=int, default=1024,
                    help="size of the ec phase's stream (at least 256)")
    args = ap.parse_args(argv)
    if args.stream_mib < 256 or args.stream_mib % 64:
        print("--stream-mib must be a multiple of 64, at least 256",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ROS2Client
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import kernel_bwd as FKB
    from repro_torch.kernels.flash_attention import kernel_decode as FKD
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rs_parity import kernel as K
    from repro_torch.kernels.rs_parity import ops
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.fletcher import kernel as FLK
    from repro_torch.kernels.stream_cipher import kernel as SCK

    size = args.stream_mib * MiB
    if args.stream_mib != 1024:
        print(f"stream cut to {args.stream_mib} MiB from 1024 MiB")
    times: dict = {}
    rank_dryrun = family_dryrun = moe_dryrun = None
    try:
        t0 = time.perf_counter()
        card = card_line()
        print(card)
        times["card_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        builds = build_phase()
        times["build_s"] = builds
        tensor_cores = tensor_core_phase()

        t0 = time.perf_counter()
        kern = kernel_phase(args.seed)
        times["kernels_s"] = time.perf_counter() - t0

        # the flash kernel's checks and times come before the storage
        # phases, whose worker threads make the profiler lose more records
        t0 = time.perf_counter()
        flash = flash_phase(args.seed)
        flash_bwd = flash_bwd_phase(args.seed)
        times["flash_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode = decode_phase(args.seed)
        times["decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scans = scan_phase(args.seed)
        times["scans_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        integrity = integrity_phase(args.seed, size)
        times["integrity_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        client = ROS2Client(mode="host", transport="rdma", n_targets=8,
                            domains=DOMAINS, ec=(4, 2),
                            inline_encryption=True, scrub_interval_s=None)
        try:
            ops.reset_launches()
            expect = ec_phase(client, size, args.seed, times)
            launches = ops.launches()
            times["ec_s"] = time.perf_counter() - t0
            print("rs_matmul launches by leg:", launches)
            for leg in ("encode", "delta", "decode"):
                check(launches[leg] > 0, f"no {leg} launch on the main path")

            t0 = time.perf_counter()
            direct, placed = direct_phase(client, "/stream", expect,
                                          64 * MiB, 4, 4 * MiB)
            times["direct_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            stream = integrity_stream_phase(
                placed[:size // (4 * MiB)], expect, args.seed)
            del placed
            times["integrity_stream_s"] = time.perf_counter() - t0
        finally:
            client.close()

        t0 = time.perf_counter()
        soak = soak_phase(args.seed, times)
        soak_launches = soak["launches"]
        times["soak_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        examples = examples_phase(times)
        times["examples_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dpu = ROS2Client(mode="dpu", transport="rdma", scrub_interval_s=None)
        try:
            small = bytearray(np.random.default_rng(args.seed + 3).bytes(
                64 * MiB))
            fd = dpu.open("/dpu", create=True)
            for off in range(0, len(small), 16 * MiB):
                dpu.pwrite(fd, bytes(small[off:off + 16 * MiB]), off)
            check(_read_equal(dpu, fd, small), "dpu readback differs")
            dpu.close_fd(fd)
            direct_phase(dpu, "/dpu", small, 16 * MiB, 4, 1 * MiB)
        finally:
            dpu.close()
        times["dpu_s"] = time.perf_counter() - t0

        # 12(c)'s dry-run (minutes of one CPU core), in a process of its
        # own from here on, after the storage phases it would slow
        rank_dryrun = _dryrun_process(RANK_DRYRUN, RANK_ARCH, RANK_CELL)
        family_dryrun = _dryrun_process(RANKS_DRYRUN,
                                        json.dumps(FAMILY_RANK_DRYRUN))
        moe_dryrun = _dryrun_process(RANKS_DRYRUN,
                                     json.dumps(MOE_RANK_DRYRUN))
        t0 = time.perf_counter()
        serve = serve_phase(args.seed, times)
        times["serve_phase_s"] = time.perf_counter() - t0

        rec_serve = {}
        for arch in REC_SERVE:
            t0 = time.perf_counter()
            rec_serve[arch] = serve_recurrent_phase(arch, args.seed, times)
            times[f"{arch}_phase_s"] = time.perf_counter() - t0

        moe_serve = {}
        for arch in MOE_SERVE:
            t0 = time.perf_counter()
            moe_serve[arch] = serve_moe_phase(arch, args.seed, times)
            times[f"{arch}_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vlm_serve = serve_vlm_phase(args.seed, times)
        times[f"{VLM}_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        whisper_serve = serve_whisper_phase(args.seed, times)
        times[f"{WHISPER}_phase_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        train = train_phase(args.seed, times)
        times["train_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = mesh_phase(args.seed, times)
        times["mesh_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_dry = _dryrun_result(moe_dryrun)
        times["moe_rank_dryrun_wait_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rank = rank_phase(args.seed, rank_dryrun, moe_dry[SAVE_COLL])
        times["rank_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        family_rank = family_rank_phase(args.seed, family_dryrun)
        times["family_rank_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_rank = moe_rank_phase(args.seed, moe_dry)
        times["moe_rank_phase_s"] = time.perf_counter() - t0

        # after the mesh phase: run before it, they left the profiler
        # losing records in the mesh phase's single traces (on an NVIDIA
        # H100 80GB HBM3 at 700 W, 1 and 3 device copies traced where the
        # same calls show 3 and 9 otherwise); the families' traces retry
        families = {}
        for arch in FAMILY_TRAIN:
            t0 = time.perf_counter()
            families[arch] = train_family_phase(arch, args.seed, times)
            times[f"train_{arch}_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        families[WHISPER] = train_whisper_phase(args.seed, times)
        times[f"train_{WHISPER}_phase_s"] = time.perf_counter() - t0

        dry = dryrun_phase(args.seed, card, {
            "granite-3-2b": serve, **rec_serve, **moe_serve,
            VLM: vlm_serve, WHISPER: whisper_serve}, train, families,
            times)
        torch.cuda.synchronize()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        for proc in (rank_dryrun, family_dryrun, moe_dryrun):
            if proc is not None:
                proc.kill()
                proc.wait()

    enc = kern["legs"]["encode"]
    rs_paths = {path: sum(counts[leg] for leg in ("encode", "delta",
                                                  "decode"))
                for path, counts in (("ec", launches),
                                     ("soak", soak_launches))}
    total = sum(rs_paths.values())
    print("phase wall times (s):", json.dumps(times))
    print("direct placement:", json.dumps(direct))
    print("soak:", json.dumps({k: v for k, v in soak.items()
                               if k != "launch_threads"}))
    print("examples:", json.dumps(examples))
    print("integrity on the placed stream:", json.dumps(stream))
    print("serve:", json.dumps(serve))
    for arch, stats in (*rec_serve.items(), *moe_serve.items(),
                        (VLM, vlm_serve), (WHISPER, whisper_serve)):
        print(f"serve {arch}:", json.dumps(stats))
    print("train:", json.dumps(train))
    for arch, stats in families.items():
        print(f"train {arch}:", json.dumps(stats))
    print("mesh:", json.dumps(mesh))
    print("rank:", json.dumps(rank))
    print("family rank:", json.dumps(family_rank))
    print("moe rank:", json.dumps(moe_rank))
    print("dryrun:", json.dumps(dry))
    # flash_attention_fwd's serve paths, each counted from 0 just before it
    flash_paths = {"granite-3-2b": serve["flash_launches"],
                   "dbrx-132b": moe_serve["dbrx-132b"]["flash_launches"],
                   VLM: vlm_serve["flash_launches"],
                   "dense-100m mesh train": mesh["train"]["flash_launches"][
                       "fwd"],
                   f"{RANK_ARCH} rank train": rank["flash_launches"]["fwd"]}
    vlm_rank = family_rank["runs"][VLM]["launches"]["flash_attention"]
    flash_paths[f"{VLM} rank train"] = vlm_rank["fwd"]
    dbrx_rank = moe_rank["runs"]["dbrx-132b"]["launches"]["flash_attention"]
    flash_paths["dbrx-132b rank train"] = dbrx_rank["fwd"]
    save_rank = rank[SAVE_COLL]["flash_launches"]
    flash_paths[f"{RANK_ARCH} rank train {SAVE_COLL}"] = save_rank["fwd"]
    for arch, leg in flash["d128"].items():
        leg["launches"] = flash_paths[arch]
    flash["d256"]["launches"] = (rank["flash_launches"]["fwd"]
                                 + save_rank["fwd"])
    flash["vlm_rank"]["launches"] = vlm_rank["fwd"]
    flash["dbrx_rank"]["launches"] = dbrx_rank["fwd"]
    flash_bwd["shapes"]["rank"]["launches"] = (rank["flash_launches"]["bwd"]
                                               + save_rank["bwd"])
    flash_bwd["shapes"]["vlm_rank"]["launches"] = vlm_rank["bwd"]
    flash_bwd["shapes"]["dbrx_rank"]["launches"] = dbrx_rank["bwd"]
    bwd = flash_bwd["shapes"]["train"]
    chat = decode["cells"]["granite-3-2b.chat"]
    decode_paths = {"granite-3-2b": serve["decode_launches"],
                    **{arch: moe_serve[arch]["decode_launches"]
                       for arch in MOE_SERVE}}
    rgp, wkv = scans["rglru"]["legs"]["prefill"], scans["wkv"]
    # the scans' serve and train paths, each counted from 0 just before it
    scan_paths = {kernel: {
        "serve": rec_serve[arch]["kernel_launches"],
        "train": sum(families[arch]["full"]["launches"].values())}
        for arch, kernel in FAMILY_TRAIN.items()}
    # 12(d)'s rank paths
    rank_runs = family_rank["runs"]
    scan_paths["rglru_scan"]["rank train"] = sum(
        rank_runs["recurrentgemma-2b"]["launches"]["rglru_scan"].values())
    scan_paths["wkv6"]["rank prefill"] = rank_runs["rwkv6-1.6b"][
        "launches"]["wkv6"]["fwd"]
    wkv["rank"]["launches"] = scan_paths["wkv6"]["rank prefill"]
    for leg in ("rank", "rank_reverse"):
        scans["rglru"]["legs"][leg]["launches"] = rank_runs[
            "recurrentgemma-2b"]["launches"]["rglru_scan"][
            "bwd" if leg == "rank_reverse" else "fwd"]
    print(json.dumps({"kernels": [{
        "name": "rs_matmul", "route": "cuda", "source": K.SOURCE,
        "replaces": K.REPLACES, "launches": total,
        "max_abs_err": kern["max_abs_err"], "ms": enc["ms"],
        "call_ms": enc["call_ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "launches_by_path": rs_paths,
        "launches_by_leg": launches, "soak_launches_by_leg": soak_launches,
        "soak_launch_threads": soak["launch_threads"],
        "legs": kern["legs"], "floor_ms": kern["floor_ms"],
        "floor_call_ms": kern["floor_call_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda", "source": FK.SOURCE,
        "replaces": FK.REPLACES, "launches": sum(flash_paths.values()),
        "launches_by_path": flash_paths, "d128": flash["d128"],
        "d256": flash["d256"], "vlm_rank": flash["vlm_rank"],
        "dbrx_rank": flash["dbrx_rank"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "call_ms": flash["call_ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "max_abs_err_by_dtype": flash["max_abs_err_by_dtype"],
        "shape": dict(zip(("B", "T", "H", "KH", "D"), SERVE_SHAPE)),
        "floor_ms": flash["floor_ms"], "floor_call_ms": flash["floor_call_ms"],
        "bf16_kernels": tensor_cores["flash_attention_fwd"]}, {
        "name": "flash_attention_bwd", "route": "cuda", "source": FKB.SOURCE,
        "replaces": FKB.REPLACES,
        "launches": (train["flash_launches"]["bwd"]
                     + mesh["train"]["flash_launches"]["bwd"]
                     + rank["flash_launches"]["bwd"] + save_rank["bwd"]
                     + vlm_rank["bwd"] + dbrx_rank["bwd"]),
        "launches_by_path": {
            "train": train["flash_launches"]["bwd"],
            "mesh train": mesh["train"]["flash_launches"]["bwd"],
            f"{RANK_ARCH} rank train": rank["flash_launches"]["bwd"],
            f"{RANK_ARCH} rank train {SAVE_COLL}": save_rank["bwd"],
            f"{VLM} rank train": vlm_rank["bwd"],
            "dbrx-132b rank train": dbrx_rank["bwd"]},
        "max_abs_err": flash_bwd["max_abs_err"], "ms": bwd["ms"],
        "call_ms": bwd["call_ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "max_abs_err_by_dtype": flash_bwd["max_abs_err_by_dtype"],
        "shape": bwd["shape"], "shapes": flash_bwd["shapes"],
        "floor_ms": flash_bwd["floor_ms"],
        "floor_call_ms": flash_bwd["floor_call_ms"],
        "bf16_kernels": tensor_cores["flash_attention_bwd"]}, {
        "name": "flash_decode", "route": "cuda", "source": FKD.SOURCE,
        "replaces": None,
        "launches": sum(decode_paths.values()),
        "launches_by_path": decode_paths,
        "max_abs_err": decode["max_abs_err"], "ms": chat["ms"],
        "call_ms": chat["call_ms"], "plain_ms": chat["plain_ms"],
        "bound_ms": chat["bound_ms"], "bound_by": chat["bound_by"],
        "library_ms": chat["library_ms"], "shape": chat["shape"],
        "cells": decode["cells"],
        "mma_kernels": tensor_cores["flash_decode"]}, {
        "name": "rglru_scan", "route": "cuda", "source": RGK.SOURCE,
        "replaces": RGK.REPLACES,
        "launches": sum(scan_paths["rglru_scan"].values()),
        "launches_by_path": scan_paths["rglru_scan"],
        "train_launches_by_direction": families["recurrentgemma-2b"]["full"][
            "launches"],
        "max_abs_err": scans["rglru"]["max_abs_err"], "ms": rgp["ms"],
        "call_ms": rgp["call_ms"], "plain_ms": rgp["plain_ms"],
        "bound_ms": rgp["bound_ms"], "bound_by": rgp["bound_by"],
        "library_ms": None, "shape": rgp["shape"],
        "rank_max_abs_err": family_rank["rglru_err"],
        "legs": scans["rglru"]["legs"], "floor_ms": scans["rglru"]["floor_ms"],
        "floor_call_ms": scans["rglru"]["floor_call_ms"]}, {
        "name": "wkv6", "route": "cuda", "source": WK.SOURCE,
        "replaces": WK.REPLACES,
        "launches": sum(scan_paths["wkv6"].values()),
        "launches_by_path": scan_paths["wkv6"],
        "train": wkv["train"], "rank": wkv["rank"],
        "rank_max_abs_err": family_rank["wkv_err"],
        "train_backward": families["rwkv6-1.6b"]["full"]["wkv6_backward"],
        "max_abs_err": wkv["max_abs_err"], "ms": wkv["ms"],
        "call_ms": wkv["call_ms"], "plain_ms": wkv["plain_ms"],
        "bound_ms": wkv["bound_ms"], "bound_by": wkv["bound_by"],
        "library_ms": None, "shape": wkv["shape"], "flops": wkv["flops"],
        "bytes": wkv["bytes"], "kernel_ms": wkv["kernel_ms"],
        "floor_ms": wkv["floor_ms"], "floor_call_ms": wkv["floor_call_ms"],
        "tc_kernels": tensor_cores["wkv6"]}] + [{
        "name": name, "route": "cuda", "source": kern.SOURCE,
        "replaces": kern.REPLACES, "launches": stream["launches"][name],
        "max_abs_err": integrity[name]["max_abs_err"],
        "ms": integrity[name]["legs"]["1MiB"]["ms"],
        "call_ms": integrity[name]["legs"]["1MiB"]["call_ms"],
        "plain_ms": integrity[name]["legs"]["1MiB"]["plain_ms"],
        "bound_ms": integrity[name]["legs"]["1MiB"]["bound_ms"],
        "bound_by": integrity[name]["legs"]["1MiB"]["bound_by"],
        "library_ms": None, "shape": {"n_bytes": INTEGRITY_BLOCK},
        "ops_per_call": integrity[name]["legs"]["1MiB"]["ops_per_call"],
        "floor_ms": integrity[name]["legs"]["floor"]["ms"],
        "floor_call_ms": integrity[name]["legs"]["floor"]["call_ms"],
        "legs": integrity[name]["legs"],
        "host_parts_us": integrity["host_parts_us"],
        **({"sweep": integrity["fletcher"]["sweep"]}
           if name == "fletcher" else {})}
        for name, kern in (("stream_cipher", SCK), ("fletcher", FLK))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
