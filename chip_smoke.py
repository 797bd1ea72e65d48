"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one line (and failing the run with a traceback):
  1. device  -- the card's name and power limit (exits non-zero without CUDA);
  2. build   -- nvcc builds the kernels from the nine src/repro_torch/csrc/*.cu;
  3. kernels -- each of the twelve kernels against its plain PyTorch version on
                the card, K1-K5 at the full-width llama3_2_3b shapes and the
                grouped GEMM K6 at the full-width dbrx_132b expert banks, with
                times, and the bit-identities the serving invariants rest on:
                K1's rows across batch sizes, K4 == K3 on a contiguous page
                table, K5's query t == K4 at cur_len + t + 1, K6's expert e ==
                K1 on bank entry e, K6's rows across batch sizes; K3, K4 and
                K5 also at B 16 x 4096 (one sequence at 4001) and B 1 x
                32768 with llama heads: plain versions, K4 == K3, K5 == K4
                and a sequence's output alone == inside the batch; K1 and
                K2 rows across M up to 1024 (prefill's 8 x 128 rows); the
                W4A4 path with x fake-quantized in K1/K7's own load == K2
                then K1/K7 bit for bit, timed both ways at M 4 and 128; the
                prefill attention kernel K9 against its plain version with
                K/V random f32, bf16 and from the KV wire format, a prompt
                alone at its bucket == inside a batch at the 128-token
                bucket, timed at B 8 x 128, B 1 x 4096 and B 4 x 4096
                beside SDPA, each of its kernels profiled by name; the
                RMSNorm kernel K10 against its plain version, its rows
                alone == in a batch; then at the shapes of the paper's
                dense models: K1 (with K2 and the fused path) at
                llama3_1_8b's seven linears timed at M 4 and 128, K1/K7
                at every new (K, N) (plain, rows across M, fused ==
                K2 then K1, K7 == K1 permuted), K1 rows across M on the
                25600- and 19200-deep down-projections beside
                torch.matmul, K2 at K 5120 and 7168, K9 and K3-K5 at G 4,
                8, 7 and 1 with hd 128 (K5 at T 6: two launches at G 7
                and 8), K10 at d 4096, 5120, 7168 and on hd-128 qk-norm
                rows; and K9 at the zoo's shapes: MLA's hd 192 with V at
                128 (128 heads, q bf16 and f32) against its plain version,
                rows alone == in a batch, timed at B 4 x 32 and B 1 x 4096
                beside SDPA on V padded to 192; whisper's attention
                without the causal mask (the encoder's 1500 frames, 1-32
                queries against them) against its plain version, a query
                alone == among 32, timed beside SDPA; then the other shapes
                phase 10 gives the kernels: K1/K7 (with K2 and the fused
                path) at every new (K, N) of the three models' packed
                linears, K1 at M 4, 128 and 1500; K6 at DeepSeek-V2's banks
                (16 of its 160 experts); K3 at whisper's 8 heads of 64; K9
                at Qwen2-VL's exact-length prefill and whisper's decoder
                prefill; K10 at d 3584 and 512 and on MLA's q_norm and
                kv_norm rows; and at the recurrent archs' shapes (phase
                11): K9 at RecurrentGemma's attention (hd 256, 10 heads on
                one KV head, window 2048), q, K and V bf16 and f32, against
                its plain version, rows alone == in a batch and a
                continuation at q_offset 1000 bit for bit, timed at B 4 x
                3072 beside SDPA with the band as a boolean mask; K1/K7
                (with K2 and the fused path) at the two models' new (K,
                N), Mamba's in_proj N 4384 (a ragged last column block)
                among them, at M 4, 128 and 4096; K10 at d 2560, 2048
                (Mamba's gated norm) and 1024;
  4. e2e     -- full-width llama3_2_3b (random weights, packed on the card;
                cut to 4 of its 28 layers, LLAMA_CUT_LAYERS, as 4b, 4c,
                4e, 4f and 6: the room went to phase 12 (f))
                through Engine.generate under the packed W4 + RaZeR-KV policy
                and the W4A4 + KV policy, with each kernel's launch count
                checked against the path's expected count, and a
                torch.profiler breakdown of one generate; one W4A4 decode
                forward launches no K2 and 7 K1 a layer that quantize x in
                their load;
  4b. paged  -- teacher-forced decode over the paged pool against the
                contiguous cache on the same bytes: logits bit-identical;
  4c. serve  -- full-width Engine.serve at 4 layers (continuous batching, prefix cache
                on, 8 requests over 4 slots) under both policies, vanilla and
                with speculate_k=2 and a bf16 draft, with exact launch counts,
                tokens/s, TTFT, decode ms per step, the pool and cache stats,
                the accept rate, the share of requests whose tokens equal
                generate's (and vanilla serve's), asserted at 1.0, and the
                device idle share;
  4f. disagg -- phase 4c's 8 requests under both policies through
                serve_disagg on 2 prefill + 2 decode replicas on the one
                card, at chunk_tokens 64 and 16, and phase 4e's 8 long
                requests (W4 + KV) at chunk_tokens 512, llama3_2_3b at full
                width cut to 4 of its 28 layers (LLAMA_CUT_LAYERS, the
                script's time limit): outputs == the same engine's
                single-engine serve's, the transfer ratio 0.28125 and each
                shipment's bytes == its pages', asserted; per-stage
                tokens/s, TTFT, the makespan and one shipment's device ->
                host -> device ms (run right after 4c and 4e);
  4e. long   -- the llama W4 + KV engine cut to 4 layers (as 4f) at
                max_len 4096: generate of 4
                prompts of 1024-3968 random tokens and serve of 8 such
                requests over 4 slots, 32 new tokens each, exact launch
                counts, decode ms per step, per-step device ms, idle share
                and decode-attention share, the serve == generate share,
                each request's TTFT and the device and wall ms of
                generate's prefill and of one long serve prefill;
  4d. dbrx   -- dbrx_132b at full width (d_model 6144, 48/8 heads, 16
                experts top-4, expert d_ff 10752, capacity factor 1.25, vocab
                100352; the one cut: 2 of 40 layers), random weights packed on
                the card under both policies, through Engine.generate and
                vanilla Engine.serve, and under W4 + KV serve with
                speculate_k=2 and a bf16 draft and the default nvfp4 draft,
                with exact launch counts (K6 3 per MoE layer per target
                forward), tokens/s, prefill and decode times, TTFT, peak
                memory per run, the serve == generate share (reported, not
                asserted) and the device idle share of one generate; then a
                control at capacity factor n_experts / topk, where no slot can
                be dropped, through generate, vanilla serve and serve with
                speculate_k=2 and a bf16 draft: its serve == generate and
                speculative == vanilla shares say whether capacity drops are
                what moves them;
  5. parity  -- the reduced llama3_2_3b and dbrx_132b on the card (kernels)
                against the CPU (plain versions) from the same weights;
  6. mesh    -- serving on a torch.distributed mesh: (a) a world of one rank
                over NCCL, Engine(mesh=(1, 1)) on phase 4's 4-layer weights,
                equal to the meshless engine bit for bit; (b) full-width llama3_2_3b cut to 4 of its 28
                layers (as 4f) on the (1, 2) mesh,
                two ranks sharing the card over gloo (NCCL takes one rank
                per card), through generate, vanilla serve under both
                policies and serve(speculate_k=2) with a bf16 draft, every
                linear K-sharded (K7): tokens identical on both ranks,
                exact launch counts, logit differences and token shares
                against the meshless engine; (c) full-width dbrx_132b cut to
                1 layer on the (1, 2) mesh (K7, K8) and the (2, 1) mesh (K6
                on E/2, all-to-all and replicated tokens), W4 + KV, against
                the meshless engine at capacity factor 1.25 (reported) and
                at the no-drop n_experts / topk (logits asserted);
  7. paper   -- the paper's dense models at full width, random weights
                with the qkv biases and qk-norm gains drawn nonzero:
                llama3_1_8b cut to 8 of its 32 layers (LLAMA8B_W4_LAYERS:
                the room went to phase 12 (d), (e) and (f)) through generate and
                serve under W4 + KV, vanilla, and speculate_k=2 with a bf16
                draft, and under W4A4 + KV vanilla on its first 4 layers
                (LLAMA8B_W4A4_LAYERS: the room went to phases 11 and 12; its W4A4
                speculative serve was cut for phase 10 and runs in phase
                4c on llama3_2_3b), each part on the phase clock;
                llama2_7b, qwen3_8b, qwen3_32b,
                codeqwen1_5_7b and deepseek_coder_33b cut to 2 layers
                through generate and vanilla serve; exact launch counts,
                serve == generate (and speculative == vanilla) asserted for
                every request, times, idle share and peak memory;
  8. obs     -- observability on llama3_1_8b at full width, 8 layers (run
                inside phase 7, on its engines): (a) Engine.quant_audit of
                the W4 + KV engine on the card (schema valid, the layers and
                quantized parameters the config gives, drift exactly 0), one
                layer's wq and down re-audited on the CPU from the same
                tensors (integers equal, floats within 1e-7 relative), its
                seconds, SV block rate, SQNR and per-pair select histogram;
                (b) phase 4c's 8 requests, vanilla and speculate_k=2, with a
                MetricsRegistry, a Tracer and a KVAuditor(sample_every=1):
                tokens == the same engine's vanilla serve with observability
                off (run before and after the observed vanilla runs),
                the histogram and counter counts == the report's, no page
                held by a sequence at the end, KV pages sampled, the trace
                valid by tools/check_trace.py, exact launch counts; decode
                ms a step and tokens/s off, with metrics and trace, and
                with the KV audit; (c) one short serve under profile_dir,
                whose Chrome trace names K1's, K4's, K9's and K10's
                kernels; and in phase 4f serve_disagg(metrics=): the
                shipment and byte counters == the report's, outputs == the
                run without metrics;
  9. toolkit -- the paper's quantization toolkit on llama3_1_8b's raw
                weights at full width (inside phase 7, after phase 8): (a)
                the Fig. 3 sweep, the second-pair sweep and
                select_weight_sv_pairs on layer 0's wq and down, wq's
                sweeps also on the CPU, which must choose the same pair;
                (b) calibrate_activation_sv on the inputs of layer 0's
                linears in a prefill of phase 4's prompts; (c)
                gptq_quantize of wq and up (RaZeR groups of 16, block 128)
                on those inputs, its output MSE below round-to-nearest's,
                and of wq's 512 x 256 corner on the card == on the CPU bit
                for bit; (d) awq_search of wq
                under razer, nvfp4 and int4, no worse than alpha 0; (e)
                two_pass_matmul of wq: W_main + W_comp == dequantize() bit
                for bit, the two passes == one within rtol 1e-5, B_comp's
                density; (f) phase 4c's 8 requests under W4 + KV, the
                engine cut to 8 of its 32 layers (TOOLKIT_F_LAYERS; the
                room went to phase 10), vanilla as its own reference, then
                with speculate_k=2 and a fakequant mxfp4 draft: exact
                launch counts, tokens == the vanilla serve, the accept rate
                and tokens/s; and the four baselines' q and scales of layer
                0's down on the card == on the CPU; each part's seconds;
 10. zoo     -- the rest of the zoo through Engine.generate, random weights
                (seed 0) packed on the card under W4 + KV and W4A4 + KV,
                phase 4's warm-up and timed generate with exact launch
                counts, prefill ms, decode ms a step, peak memory, the
                device idle share of a short W4 + KV generate, and serve's
                refusal (the pool takes GQA stacks only): (a)
                deepseek_v2_236b at full width (MLA: kv_lora 512, q_lora
                1536, hd 192 with V 128; 160 routed experts top-6 + 2
                shared) cut to 2 of its 60 layers (the dense layer and one
                MoE layer) on phase 4's 4 prompts; (b) qwen2_vl_7b at full
                width cut to 2 of 28 layers, 4 prompts of 320 tokens whose
                leading 256 positions take random patch embeddings, the
                output without them differing; (c) whisper_base at full
                size (6 + 6 layers), 1500 random frames, one prompt of 8
                tokens; (d) each narrow in bf16 (MLA at its real head
                widths), card against CPU from the same weights: logits
                within ZOO_CARD_CPU_TOL, generate's tokens equal (a
                difference only where the CPU's top-2 gap is at most the
                largest logit difference measured);
 11. recurrent -- the recurrent archs through Engine.generate at full
                width and depth, random weights (seed 0) packed on the card
                under W4 + KV and W4A4 + KV, as phase 10 runs its models:
                (a) recurrentgemma_2b (26 layers, RG-LRU and windowed
                attention in the pattern r, r, a; window 2048, hd 256) from
                4 prompts of 3072 random tokens, max_len 4096; (b)
                mamba2_370m (48 Mamba-2 layers) from 4 prompts of 1024;
                exact launch counts (K1 8 an RG-LRU layer, 7 an attention
                layer, 2 a Mamba layer; K9 once an attention layer a
                prefill; no K3: the windowed decode is plain, as in the
                reference), prefill ms, decode ms a step, peak memory, the
                device idle share of a short W4 + KV generate and serve's
                refusal; (c) each narrow in bf16, card against CPU, as
                phase 10 (d), prompts of one length, within
                RECURRENT_CARD_CPU_TOL.
Phase 3 also checks the K-shard kernels K7 (llama linears, tp 2) and K8
(dbrx banks on (1, 2) and (2, 2) tiles): chunked output == K1/K6 on the same
shard, permuted, bit for bit; rows bit-identical across M.  Each kernel's
timing row also carries its own device time per launch from a torch.profiler
pass over the same loop (L2 flushed before each attention launch), beside
the CUDA-event time, which at decode sizes is the host's issue rate; a
row whose kernel the profiler does not record in three tries keeps its
event time and says its device time is missing (a fault of the profiler,
not of the kernel: every correctness check stays a hard failure).
Phase 3 also holds the training path's backward kernels against autograd
through their plain versions (BWD_TOL of max |want|; a repeat's bits
equal), timed beside the plain backward and the library's (each a
backward alone): K9's backward at llama3_2_3b's heads, bf16, causal, B 1 x
4096 and B 4 x 512, a window and no mask (beside
F.scaled_dot_product_attention's backward), and at the wide heads phase 12
(d) trains: MLA's 128 heads at hd 192 with V 128 (bf16 checked at B 1 x
2048, timed at B 1 x 4096 beside SDPA's on V padded to 192) and
RecurrentGemma's 10 / 1 at hd 256 with window 2048 (bf16 checked and timed
at B 1 x 4096 beside SDPA's with the band as a bool mask), the f32 body
checked once at each; K10's at d 3072, M 4 and 4096 (beside F.rms_norm's
with the f32 gain).
 12. training -- (a) llama3_2_3b at full width and depth, random weights
                (seed 0), f32 parameters and AdamW moments, bf16 compute,
                remat "full", 1 x 4096 tokens of the synthetic Markov data:
                3 steps of make_train_step under bf16, 3 under
                fakequant(ste=True) and 1 under W4A4 fakequant(ste=True);
                losses and gradient norms finite, the parameters moved,
                exact launches a step (K9 2 a layer and K10 2 a norm but
                the final one: the step's forward and the backward's
                recompute of each layer; K9's backward 1 a layer, K10's 1 a
                norm; K2 14 a layer under W4A4), step seconds, tokens/s,
                6 N D over step time against 989 TFLOP/s, peak memory; (b)
                reduced llama3_2_3b in f32, 3 steps on the card and on the
                CPU from the same init: losses within 1e-5 relative,
                parameters within the sign-flip bound; (c) launch.train
                --steps 4 --ckpt-every 2 then launch.serve --ckpt from its
                checkpoint, and a ResilientLoop with a NodeFailure at step
                3 ending with the uninterrupted run's state, bit for bit;
                (d) the archs whose attention runs K9's backward at its
                wide heads, at published widths, as (a) under bf16 then
                fakequant(ste=True), 2 steps each: deepseek_v2_236b cut to
                its first layer, the dense one (MLA, hd 192 with V 128, q
                and kv norms), and recurrentgemma_2b at full depth (26
                layers: K9 and its backward on the 8 windowed attention
                layers at hd 256, the RG-LRU scan and conv through
                autograd), exact launches a step; (e) each narrow at its
                real head widths in f32, 3 steps card against CPU, held as
                (b); (f) training on a mesh: (a') llama3_2_3b at full width
                cut to 7 of 28 layers (MESH_TRAIN_LAYERS), 2 bf16 steps and
                1 weight-QAT step through bind_train_step on a (1, 1) mesh,
                a world of one rank over NCCL, bit for bit the meshless
                steps, exact launches; (b') cut to 2 layers in f32, on the
                (1, 2) and then the (2, 1) mesh, two ranks sharing the card
                over gloo: 2 bf16, 1 weight-QAT and 1 W4A4-QAT steps, every
                rank's loss and gradient norm the same bits, each within
                the step bounds of (b) against rank 0's meshless run, the
                gathered parameters too (the W4A4 step within
                MESH_TRAIN_W4A4_RTOL and MESH_TRAIN_W4A4_SHARE, set from
                tools/mesh_w4a4_flips.py), each rank's parameter and moment
                bytes those of the reference's shards, exact launches,
                per-rank peak memory, step seconds and collectives (gloo
                on one card: no measure of NCCL).
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, data sheet


def _ptxas_report(log: str):
    """nvcc -Xptxas -v output -> {kernel: "registers ..., spill ..."}, one
    entry per compiled kernel (static shared memory is in the register
    line when a kernel has any)."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out[name] = f"{line.split(':', 1)[-1].strip()}; {spill}"
            name, spill = None, ""
    return out


def _require_cuda() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()


def _cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_L2_FLUSH = []  # a buffer larger than the 50 MB L2, written between profiled runs


def _flush_l2():
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.uint8, device="cuda"))
    _L2_FLUSH[0].zero_()


PROFILER_MISSES = []  # tags whose device time the profiler did not record (a fault of the profiler)


def _device_ms(run, tag: str, reps: int = 3, cold: bool = False):
    """Device time of the kernels whose profiler name holds ``tag`` (a
    packed GEMM's instantiation, e.g. ``gemm_kernel<K1,``) over ``reps``
    runs of ``run()`` after a warm-up, from torch.profiler: (total ms,
    launches) per run.  CUDA events around a loop of small launches measure
    the host's issue rate as much as the kernel; this is the kernels' own
    time.  ``cold``: overwrite a 128 MB buffer before each run, so that the
    run finds its inputs in device memory, not in L2, as a decode step's
    layer does.

    A profiler that records no such kernel in three tries is a fault of the
    profiler, not of the kernel (it happened on an H100 with every check
    passing): the device time is then missing, (None, 0), the tag goes to
    ``PROFILER_MISSES`` and a line says so; the caller keeps its CUDA-event
    time.  No correctness check depends on this."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(3):  # a profiler run can come back without device events: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    _flush_l2()
                run()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        events = [e for e in device if tag in e.key]
        launches = sum(e.count for e in events)
        if launches:
            return sum(e.self_device_time_total for e in events) / 1e3 / reps, launches / reps
        seen.update(e.key[:60] for e in device)
    PROFILER_MISSES.append(tag)
    print(f"profiler: no device event named like {tag!r} in three tries (it saw {sorted(seen)[:8]}); its device "
          "time is recorded as missing, its CUDA-event time kept")
    return None, 0


def _sum_or_none(values):
    """The sum of device times, None where the profiler missed one."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def _with_device_time(row, run, tag, launches_per_unit: int, cold: bool = False):
    """Adds the profiler's device time to a timing row: ``device_ms_per_launch``
    and ``device_ms`` per timed unit (``launches_per_unit`` launches: the
    per-launch time times that count, so an event the profiler drops does
    not shrink it); ``profiled_launches_per_run`` says how many it kept.
    The tag sums every kernel of one call whose name holds it."""
    total, launches = _device_ms(run, tag, cold=cold)
    per_launch = None if total is None else total / launches
    row.update({"device_ms": None if total is None else per_launch * launches_per_unit,
                "device_ms_per_launch": per_launch, "profiled_launches_per_run": launches})
    if total is None:
        row["device_ms_missing"] = "the profiler recorded no event of this kernel; ms is the CUDA-event time"
    return row


def _bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _counters():
    """name -> (wrapper, counter attribute): each wrapper adds one to its
    count where it launches its kernel; K1 and K7 also count the launches
    that fake-quantized x in their load (the fused W4A4 path)."""
    from repro_torch.kernels.paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.kernels.razer_grouped_matmul import razer_grouped_matmul_cuda, razer_grouped_matmul_kshard_cuda
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda
    from repro_torch.kernels.rms_norm import rms_norm_cuda

    return {"razer_matmul": (razer_matmul_cuda, "launches"), "razer_act_qdq": (razer_act_qdq_cuda, "launches"),
            "razer_kv_attention": (razer_kv_attention_cuda, "launches"),
            "paged_kv_attention": (paged_kv_attention_cuda, "launches"),
            "paged_kv_attention_verify": (paged_kv_attention_verify_cuda, "launches"),
            "razer_grouped_matmul": (razer_grouped_matmul_cuda, "launches"),
            "razer_matmul_kshard": (razer_matmul_kshard_cuda, "launches"),
            "razer_grouped_matmul_kshard": (razer_grouped_matmul_kshard_cuda, "launches"),
            "razer_matmul_fused_act": (razer_matmul_cuda, "fused_act_launches"),
            "razer_matmul_kshard_fused_act": (razer_matmul_kshard_cuda, "fused_act_launches"),
            "prefill_attention": (prefill_attention_cuda, "launches"), "rms_norm": (rms_norm_cuda, "launches")}


def _train_counters():
    """name -> (wrapper, counter attribute) of the backward kernels, which
    only a training step launches (kept apart from ``_counters``, whose
    counts the serving phases compare whole)."""
    from repro_torch.kernels.prefill_attention_bwd import prefill_attention_bwd_cuda
    from repro_torch.kernels.rms_norm_bwd import rms_norm_bwd_cuda

    return {"prefill_attention_bwd": (prefill_attention_bwd_cuda, "launches"),
            "rms_norm_bwd": (rms_norm_bwd_cuda, "launches")}


def _reset_counts():
    for fn, attr in list(_counters().values()) + list(_train_counters().values()):
        setattr(fn, attr, 0)


def _read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _main_path_train_counts():
    """The backward kernels' counts of a main-path run (reset just before
    it), added to the totals the kernels line reports."""
    counts = {name: getattr(fn, attr) for name, (fn, attr) in _train_counters().items()}
    for name, n in counts.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    return counts


MAIN_PATH_LAUNCHES = {}  # kernel -> launches summed over every main-path run


def _main_path_counts(counts=None):
    """Counts of a main-path run (reset just before it), added to the
    totals the kernels line reports; ``counts`` are a rank's of phase 6."""
    counts = _read_counts() if counts is None else counts
    for name, n in counts.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    return counts


def _per_forward(cfg, tp: int = 1):
    """Packed-GEMM launches of one forward pass, meshless (tp 1) or on a
    (*, tp) mesh: {kernel: count} for K7 (linears that K-shard: K % (tp *
    16) == 0 and N % tp == 0), K1 (the rest: the 4 attention linears of
    every layer, the 3 MLP linears of a dense layer, the shared experts' 3
    of an MoE layer), K8 (an MoE layer's 3 banks when the trio K-shards: d
    and f % (tp * 16) == 0) and K6 (a trio that does not).  Under W4A4 every
    K1 and K7 fake-quantizes x: in its own load at decode-sized M, else
    after a K2 launch."""
    from repro_torch.models.transformer import layer_groups

    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    attn = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd), (d, cfg.num_kv_heads * hd), (cfg.num_heads * hd, d)]
    mlp = [(d, f), (d, f), (f, d)]
    split = lambda k, n: tp > 1 and k % (tp * 16) == 0 and n % tp == 0  # noqa: E731
    out = dict.fromkeys(("razer_matmul_kshard", "razer_matmul", "razer_grouped_matmul_kshard",
                         "razer_grouped_matmul"), 0)
    for ltype, count in layer_groups(cfg):
        shared = [(d, cfg.n_shared_experts * cfg.moe_d_ff)] * 2 + [(cfg.n_shared_experts * cfg.moe_d_ff, d)]
        linears = attn + (mlp if ltype == "a" else (shared if cfg.n_shared_experts else []))
        for k, n in linears:
            out["razer_matmul_kshard" if split(k, n) else "razer_matmul"] += count
        if ltype == "m":
            trio = tp > 1 and d % (tp * 16) == 0 and cfg.moe_d_ff % (tp * 16) == 0
            out["razer_grouped_matmul_kshard" if trio else "razer_grouped_matmul"] += 3 * count
    return out


def _want_counts(cfg, tp, policy, prefill_m, decode_m=0, decode_passes=0, decode_steps=0, paged=0, verify=0,
                 draft_passes=0):
    """Exact launch counts of a run of target forwards: prefills of
    ``prefill_m`` rows each (K9 once per layer each) and ``decode_passes``
    decode or verify passes of ``decode_m`` rows.  Under W4A4 a pass of M <=
    ``FUSE_ACT_MAX_M`` rows quantizes x inside K1/K7, a larger one launches
    K2 before each; ``decode_steps``, ``paged`` and ``verify`` count K3, K4
    and K5 passes; every forward, a speculative draft's ``draft_passes``
    too, runs K10 for each norm."""
    from repro_torch.kernels.razer_matmul import FUSE_ACT_MAX_M

    per = _per_forward(cfg, tp)
    ms = list(prefill_m) + [decode_m] * decode_passes
    want = {name: n * len(ms) for name, n in per.items()}
    act = policy.act is not None
    fused = sum(m <= FUSE_ACT_MAX_M for m in ms) if act else 0
    unfused = len(ms) - fused if act else 0
    want.update(razer_act_qdq=(per["razer_matmul"] + per["razer_matmul_kshard"]) * unfused,
                razer_matmul_fused_act=per["razer_matmul"] * fused,
                razer_matmul_kshard_fused_act=per["razer_matmul_kshard"] * fused,
                prefill_attention=cfg.num_layers * len(prefill_m),
                rms_norm=(cfg.num_layers * (4 if cfg.qk_norm else 2) + 1) * (len(ms) + draft_passes),
                razer_kv_attention=cfg.num_layers * decode_steps, paged_kv_attention=cfg.num_layers * paged,
                paged_kv_attention_verify=cfg.num_layers * verify)
    return want


def _generate_want(cfg, tp, policy, stats):
    """``_want_counts`` of one generate from its ``Engine.stats``: a prefill
    of batch x bucket rows, then decode steps of batch rows over K3."""
    steps = stats["decode_steps"]
    return _want_counts(cfg, tp, policy, [stats["batch"] * stats["bucket"]], stats["batch"], steps,
                        decode_steps=steps)


def _serve_prefill_m(eng, requests):
    """The rows of each prefill a serve ran: each request not deduplicated
    prefills its uncached suffix, padded to its bucket."""
    return [eng._bucket(len(r.prompt) - r.cached_tokens) for r in requests if r.dedup_of is None]


def _serve_want(cfg, tp, policy, prefill_m, decode_steps, k=0, draft_steps=0, slots=4):
    """``_want_counts`` of one serve over ``slots`` slots: its prefills, then
    decode steps (K4) of ``slots`` rows, or with ``k`` drafts verify passes
    (K5) of slots x (k + 1) rows and the draft's K4 steps."""
    return _want_counts(cfg, tp, policy, prefill_m, slots * (k + 1), decode_steps,
                        paged=(0 if k else decode_steps) + draft_steps, verify=decode_steps if k else 0,
                        draft_passes=draft_steps)


MESHLESS = {}  # (arch, policy, what) -> a meshless run's output, for phase 6


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _linear_shapes(cfg):
    d, hd = cfg.d_model, cfg.hd
    return [("wq", d, cfg.num_heads * hd), ("wk", d, cfg.num_kv_heads * hd),
            ("wv", d, cfg.num_kv_heads * hd), ("wo", cfg.num_heads * hd, d),
            ("gate", d, cfg.d_ff), ("up", d, cfg.d_ff), ("down", cfg.d_ff, d)]


def _packed_linears(cfg):
    """(name, K, N) of every packed linear of a full-width config: GQA's
    four (MLA's q_a or wq, kv_a and wo: q_b and kv_b stay dense), whisper's
    cross-attention, the dense layers' MLP (SwiGLU or GELU) and the shared
    experts; Mamba-2's in_proj and out_proj, the RG-LRU block's w_in,
    w_gate, wa, wx and out_proj; a dense GQA model's are
    ``_linear_shapes``'."""
    d = cfg.d_model
    if cfg.ssm:
        d_inner = cfg.ssm_expand * d
        return [("in_proj", d, 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_head_dim),
                ("out_proj", d_inner, d)]
    if cfg.block_pattern:
        w = cfg.lru_width or d
        return _linear_shapes(cfg) + [("w_in", d, w), ("w_gate", d, w), ("wa", w, w), ("wx", w, w),
                                      ("out_proj", w, d)]
    if cfg.mla:
        q = [("q_a", d, cfg.q_lora_rank)] if cfg.q_lora_rank else \
            [("wq", d, cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim))]
        att = q + [("kv_a", d, cfg.kv_lora_rank + cfg.qk_rope_dim), ("wo", cfg.num_heads * cfg.v_head_dim, d)]
    else:
        att = _linear_shapes(cfg)[:4]
    if cfg.encoder_decoder:
        att += [(f"xattn_{n}", k, nn) for n, k, nn in att]
    if not cfg.n_experts or cfg.first_dense_layers:
        att += [("up", d, cfg.d_ff), ("down", cfg.d_ff, d)] if cfg.act_fn == "gelu" else _linear_shapes(cfg)[4:]
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        att += [("shared_gate", d, fs), ("shared_up", d, fs), ("shared_down", fs, d)]
    return att


ROW_INVARIANT_M = [1, 4, 8, 24, 128, 1024]  # 1024: prefill's 8 prompts at the 128-token bucket


def _check_matmul(cfg, dev, gen, detail, tag=""):
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda

    shapes = _linear_shapes(cfg)
    # four layers' worth of distinct weights (~228 MB packed) so that timing
    # cycles through more than the 50 MB L2, as a decode step does
    layers = [{name: pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
               for name, k, n in shapes} for _ in range(4)]
    max_err = 0.0
    for name, k, n in shapes[:1] + shapes[1:2] + shapes[4:5] + shapes[6:]:  # (K, N) kinds
        pw = layers[0][name]
        for m in (4, 4 * 32):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            got = razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                    m1=pw.sv_magnitudes[1]) * pw.tensor_scale
            want = ref.razer_matmul_ref(x, pw)
            bound = 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6
            err = (got - want).abs()
            assert bool((err <= bound).all()), f"razer_matmul K={k} N={n} M={m}: {float(err.max())}"
            max_err = max(max_err, float(err.max()))
        # split-K boundaries depend on (N, K) only: a row's bits do not move
        # with M, up to prefill's 8 x 128 rows; nor with the activation
        # fake-quant, fused into the load or as K2 then K1
        x = (torch.randn((1024, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
        for act in ({}, {"act_svs": (5.0, -5.0), "fused": True}, {"act_svs": (5.0, -5.0), "fused": False}):
            rows = [razer_matmul_cuda(x[:m].contiguous(), pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                      m1=pw.sv_magnitudes[1], **act)[:1] for m in ROW_INVARIANT_M]
            assert all(torch.equal(r, rows[0]) for r in rows[1:]), f"razer_matmul K={k} N={n} {act}: row 0 moves"
    detail["razer_matmul_row_invariant_M"] = ROW_INVARIANT_M
    dense = [{name: layer[name].dequantize().to(torch.bfloat16) for name, _, _ in shapes} for layer in layers]
    out = {}
    for m in (4, 4 * 32):
        xs = {k: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16) for _, k, _ in shapes}

        def kernel_all():
            for layer in layers:
                for name, k, _ in shapes:
                    pw = layer[name]
                    razer_matmul_cuda(xs[k], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                      m1=pw.sv_magnitudes[1])

        def plain_layer():
            for name, k, _ in shapes:
                ref.razer_matmul_ref(xs[k], layers[0][name])

        def library_all():
            for layer in dense:
                for name, k, _ in shapes:
                    torch.matmul(xs[k], layer[name])

        nbytes = sum(m * k * 2 + k * n // 2 + k * n // 16 + m * n * 4 for _, k, n in shapes)
        flops = sum(2 * m * k * n for _, k, n in shapes)
        bound, by = _bound_ms(nbytes, flops)
        out[m] = _with_device_time(
            {"ms": _cuda_ms(kernel_all, reps=10) / 4, "plain_ms": _cuda_ms(plain_layer, reps=3),
             "library_ms": _cuda_ms(library_all, reps=10) / 4, "bound_ms": bound, "bound_by": by},
            kernel_all, "gemm_kernel<K1,", 7)
        detail[f"razer_matmul_layer_M{m}{tag}"] = out[m]
    return max_err, out[4]


def _split_k_cost(cfg, dev, gen, detail, m: int = 128):
    """What choosing K1's split-K from (N, K) alone costs at prefill: one
    layer's 7 linears at M = 128 with the (N, K) splits (a cluster of blocks
    summing its partial tiles through distributed shared memory) against one
    split each (what a choice from M gives at this size), through the same C
    entry point and token tile, same inputs, timed in turns (new, old, old,
    new) within this call."""
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import build
    from repro_torch.kernels.razer_matmul import _ARGTYPES, launch_plan

    fn = build.function("razer_matmul", "razer_matmul_launch", _ARGTYPES)
    calls = []
    for _, k, n in _linear_shapes(cfg):
        pw = pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        calls.append((x, pw, out, launch_plan(1, m, n, k), k, n))
    stream = torch.cuda.current_stream().cuda_stream

    def layer(new: bool):
        for x, pw, out, plan, k, n in calls:
            sp, pr = (plan.splits, plan.k_tiles_per_split) if new else (1, k // 64)
            build.check(fn(x.data_ptr(), 1, pw.codes.data_ptr(), pw.scale_meta.data_ptr(), out.data_ptr(), m, k, n,
                           plan.nt, sp, pr, pw.sv_magnitudes[0], pw.sv_magnitudes[1], None, 0, stream),
                        "razer_matmul")

    times = {"nk_splits": [], "one_split": []}
    for new in (True, False, False, True):
        times["nk_splits" if new else "one_split"].append(_cuda_ms(lambda: layer(new), reps=10))
    # the partial tiles the split sums read through distributed shared memory
    dsmem = sum(c[3].splits * m * c[5] * 4 for c in calls if c[3].splits > 1)
    out = {"M": m, "ms_nk_splits": times["nk_splits"], "ms_one_split": times["one_split"],
           "splits": {f"{c[4]}x{c[5]}": c[3].splits for c in calls}, "dsmem_partial_bytes": dsmem}
    detail["razer_matmul_split_k_cost_M128"] = out
    return out


def _check_act_qdq(cfg, dev, gen, detail, tag=""):
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    ks = [k for _, k, _ in _linear_shapes(cfg)]
    # a row's bits do not move with M (each 16-value block on its own), up
    # to prefill's 8 x 128 rows; a four-value special set as well
    x = (torch.randn((1024, ks[0]), generator=gen, device=dev) * 3).to(torch.bfloat16)
    whole = razer_act_qdq_cuda(x)
    for m in ROW_INVARIANT_M[:-1]:
        assert torch.equal(razer_act_qdq_cuda(x[:m].contiguous()).view(torch.int16), whole[:m].view(torch.int16)), m
    svs4 = (5.0, -5.0, 8.0, -8.0)
    assert torch.equal(razer_act_qdq_cuda(x, svs4).view(torch.int16),
                       ref.razer_act_qdq_ref(x, svs=svs4).view(torch.int16)), "razer_act_qdq, four special values"
    detail["razer_act_qdq_row_invariant_M"] = ROW_INVARIANT_M
    out = {}
    for m in (4, 4 * 32):
        xs = {k: (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16) for k in set(ks)}
        for k, x in xs.items():
            got, want = razer_act_qdq_cuda(x), ref.razer_act_qdq_ref(x)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), f"razer_act_qdq ({m}, {k}) not bit-exact"
        nbytes = sum(2 * 2 * m * k for k in ks)
        bound, by = _bound_ms(nbytes, 0.0)
        out[m] = _with_device_time(
            {"ms": _cuda_ms(lambda: [razer_act_qdq_cuda(xs[k]) for k in ks]),
             "plain_ms": _cuda_ms(lambda: [ref.razer_act_qdq_ref(xs[k]) for k in ks], reps=3),
             "library_ms": None, "bound_ms": bound, "bound_by": by},
            lambda: [razer_act_qdq_cuda(xs[k]) for k in ks], "razer_act_qdq_kernel", len(ks))
        detail[f"razer_act_qdq_layer_M{m}{tag}"] = out[m]
    return 0.0, out[4]


def _check_fused_act(cfg, dev, gen, detail, tag=""):
    """K1 and K7 fake-quantizing x in their own load (the W4A4 path at
    decode-sized M) against K2 followed by K1 / K7: bit for bit at M 1, 4,
    12, 128 and 1024, bf16 and f32 x, the activation set (5, -5) and a set
    of four; then one llama layer's 7 linears timed both ways at M = 4 and
    M = 128 (device time from the profiler, K1 plus K2 for the two-launch
    path), beside the plain qdq + matmul and the bound of the fused
    function (x, the wire bytes and y once; 2 M K N operations)."""
    from repro_torch.core.packing import pack_weight, take_shard
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    shapes = _linear_shapes(cfg)
    layers = [{name: pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
               for name, k, n in shapes} for _ in range(4)]
    svs = (5.0, -5.0)
    for name, k, n in shapes[:1] + shapes[4:5] + shapes[6:]:  # (K, N) kinds
        pw = layers[0][name]
        mm = dict(m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1])
        shard = take_shard(pw, tp=2, tp_index=1)
        for m in (1, 4, 12, 128, 1024):
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dtype)
                for sv in (svs, (5.0, -5.0, 8.0, -8.0)):
                    two = razer_matmul_cuda(razer_act_qdq_cuda(x, sv), pw.codes, pw.scale_meta, **mm)
                    got = razer_matmul_cuda(x, pw.codes, pw.scale_meta, act_svs=sv, fused=True, **mm)
                    assert torch.equal(got, two), ("fused K1 != K2 then K1", name, m, dtype, sv)
                xs = x[:, k // 2:].contiguous()
                two = razer_matmul_kshard_cuda(razer_act_qdq_cuda(xs, svs), shard.codes, shard.scale_meta,
                                               out_chunks=2, **mm)
                got = razer_matmul_kshard_cuda(xs, shard.codes, shard.scale_meta, out_chunks=2, act_svs=svs,
                                               fused=True, **mm)
                assert torch.equal(got, two), ("fused K7 != K2 then K7", name, m, dtype)
    detail["razer_matmul_fused_act_bit_identical"] = {"M": [1, 4, 12, 128, 1024], "x": ["bf16", "f32"],
                                                      "svs": [list(svs), [5.0, -5.0, 8.0, -8.0]]}
    out = {}
    for m in (4, 128):
        xs = {k: (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16) for _, k, _ in shapes}

        def run(fused):
            def go():
                for layer in layers:
                    for name, k, _ in shapes:
                        pw = layer[name]
                        razer_matmul_cuda(xs[k], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                          m1=pw.sv_magnitudes[1], act_svs=svs, fused=fused)
            return go

        def plain_layer():
            for name, k, _ in shapes:
                ref.razer_matmul_ref(ref.razer_act_qdq_ref(xs[k], svs=svs), layers[0][name])

        nbytes = sum(m * k * 2 + k * n // 2 + k * n // 16 + m * n * 4 for _, k, n in shapes)
        bound, by = _bound_ms(nbytes, sum(2 * m * k * n for _, k, n in shapes))
        row = _with_device_time({"ms": _cuda_ms(run(True), reps=10) / 4, "plain_ms": _cuda_ms(plain_layer, reps=3),
                                 "library_ms": None, "bound_ms": bound, "bound_by": by},
                                run(True), "gemm_kernel<K1,", 7)
        k1_ms, k2_ms = (None if t is None else t / 4 for t in (_device_ms(run(False), "gemm_kernel<K1,")[0],
                                                                 _device_ms(run(False), "razer_act_qdq_kernel")[0]))
        row.update(two_launch_ms=_cuda_ms(run(False), reps=10) / 4, two_launch_device_ms=_sum_or_none((k1_ms, k2_ms)),
                   two_launch_k1_device_ms=k1_ms, two_launch_k2_device_ms=k2_ms, k2_launches_per_layer_fused=0,
                   k2_launches_per_layer_two_launch=7)
        out[m] = row
        detail[f"razer_matmul_fused_act_layer_M{m}{tag}"] = row
    return 0.0, out[4]


# The prefill kernel (K9) against its plain version: q bf16 with K/V f32
# (as prefill(qdq_kv=True) gives them: P stays f32) within one bf16 ulp of
# the output, where the f32 values before the cast may fall on the two
# sides of a rounding edge; with bf16 V also within 2^-9, since P is
# rounded to bf16 in both and an f32 ulp of p can move that rounding.
PREFILL_TOL = {torch.float32: dict(rtol=2**-7, atol=1e-6), torch.bfloat16: dict(rtol=2**-7, atol=2**-9)}
PREFILL_FLIPS_MAX = 8  # bf16-V rows (query, head) of one check that may leave PREFILL_TOL by one flip of P's rounding
PREFILL_FLIPS = []  # each such row: the check, its index, |error|, what one flip allows


def _key_weights(q, k, b, i, h, **mask):
    """p_j / l over the keys of K9's (query, head) row (b, i, h), in f32:
    the plain version of that one query over a one-hot V (a value dim per
    key)."""
    from repro_torch.kernels import ref

    skv, kvh = k.shape[1], k.shape[2]
    onehot = torch.eye(skv, device=q.device).reshape(1, skv, 1, skv).expand(1, skv, kvh, skv)
    mask = dict(mask, q_offset=mask.get("q_offset", 0) + i)
    return ref.chunked_attention_ref(q[b:b + 1, i:i + 1].float(), k[b:b + 1], onehot, **mask)[0, 0, h]


def _assert_prefill_close(got, want, q, k, v, what="", **mask):
    """K9's output ``got`` against its plain version ``want`` =
    ``ref.chunked_attention_ref(q, k, v, **mask)`` within PREFILL_TOL.

    With bf16 V both round P to bf16 before the P V product, and the
    kernel's f32 p can differ from the plain version's by an ulp (its
    scores sum in another order, its exponent is base 2), which can flip
    that rounding: one bf16 ulp of p_j, at most 2^-7 p_j, moves the
    outputs of its (query, head) row by up to 2^-7 p_j |v_j| / l, and l by
    as much.  At a row with few keys one flip can leave PREFILL_TOL
    (ROADMAP C.4: 1 of 13,312,000 outputs at hd 256, row 11, 0.0027
    against 0.0020).  So the outputs of at most PREFILL_FLIPS_MAX rows of a
    bf16-V check may leave it, each within 2^-9 + 2^-7 |want| + 2 * 2^-7
    max_j p_j |v_j| / l (one flip's largest move, counted for the sum and
    for l); each such row is listed in PREFILL_FLIPS and printed.  Returns
    the largest |error|."""
    err = (got.float() - want.float()).abs()
    tol = PREFILL_TOL[v.dtype]
    outside = (err > tol["atol"] + tol["rtol"] * want.float().abs()).nonzero().tolist()
    rows = sorted({(b, i, h) for b, i, h, _ in outside})
    if rows and (v.dtype != torch.bfloat16 or len(rows) > PREFILL_FLIPS_MAX):
        torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{what}: {len(rows)} rows: {m}")
    for b, i, h in rows:
        dims = [d for bb, ii, hh, d in outside if (bb, ii, hh) == (b, i, h)]
        pv = _key_weights(q, k, b, i, h, **mask)[:, None] * v[b, :, h // (q.shape[2] // k.shape[2]), dims].float().abs()
        terms = pv.amax(dim=0).tolist()  # max_j p_j |v_j| / l at each of the row's dims
        allowed = [2**-9 + 2**-7 * abs(float(want[b, i, h, d])) + 2 * 2**-7 * t for d, t in zip(dims, terms)]
        errs = [float(err[b, i, h, d]) for d in dims]
        flip = {"check": what, "row": [b, i, h], "dims": dims, "abs_err": errs, "largest_key_term": terms,
                "one_flip_allows": allowed}
        PREFILL_FLIPS.append(flip)
        print("K9 row beyond PREFILL_TOL, within one flip of P's rounding: " + json.dumps(flip), flush=True)
        assert all(e <= a for e, a in zip(errs, allowed)), (f"{what}: beyond what one flip of P's rounding moves", flip)
    return float(err.max())


def _wire_kv(shape, gen, dev):
    """Random K or V through the KV wire format and back, as prefill's
    ``_qdq_kv`` gives them to K9: f32 values exact in bf16."""
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    return kv_dequantize(*kv_quantize(torch.randn(shape, generator=gen, device=dev)), shape[-1])


PREFILL_TIMED = ((8, 128, "f32"), (8, 128, "wire"), (1, 4096, "f32"), (1, 4096, "wire"), (4, 4096, "f32"),
                 (4, 4096, "wire"))


def _check_prefill_attention(cfg, dev, gen, detail, tag="", timed=PREFILL_TIMED, kinds=("f32", "bf16", "wire")):
    """K9 at llama3_2_3b heads: against its plain version at B 8 x 128 (the
    8 serve prompts at generate's bucket) with K/V random f32, bf16 and
    from the KV wire format (f32, exact in bf16: the serving path's, whose
    low-part MMAs the kernel skips); each prompt's rows alone at its own
    bucket == inside the batch bit for bit; a prefix-cached continuation's
    rows (q_offset 40) == the same rows of the whole prompt; timed at B 8 x
    128, B 1 x 4096 and B 4 x 4096 (phase 4e's generate prefill), with K/V
    random f32 and from the wire format, against the plain version and
    F.scaled_dot_product_attention (bf16, causal, heads grouped); at each
    timed shape also held against the plain version within PREFILL_TOL, its
    largest |error| kept in the row.  ``timed`` picks the (B, S, K/V) shapes
    timed and ``kinds`` the K/V of the B 8 x 128 checks; the heads are
    ``cfg``'s."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref

    attend = pa.prefill_attention_cuda
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lens = (8, 15, 23, 32, 40, 57, 64, 100)
    bucket = lambda n: max(8, 1 << (n - 1).bit_length())  # noqa: E731  Engine._bucket
    max_err = 0.0
    q = torch.randn((8, 128, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    for kind in kinds:
        if kind == "wire":
            k, v = (_wire_kv((8, 128, kvh, hd), gen, dev) for _ in range(2))
        else:
            dt = torch.float32 if kind == "f32" else torch.bfloat16
            k, v = (torch.randn((8, 128, kvh, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        got = attend(q, k, v)
        want = ref.chunked_attention_ref(q, k, v)
        _assert_prefill_close(got, want, q, k, v, f"K9 B 8 x 128 {kind}")
        if kind == "f32":
            max_err = float((got.float() - want.float()).abs().max())
        for r, n in enumerate(lens):
            s = bucket(n)
            alone = attend(q[r:r + 1, :s].contiguous(), k[r:r + 1, :s].contiguous(), v[r:r + 1, :s].contiguous())
            assert torch.equal(alone[0, :n], got[r, :n]), ("prefill attention alone != in batch", n, kind)
        c, n = 40, lens[6]
        s = bucket(n - c)
        kv = [torch.zeros((1, 64 + s, kvh, hd), dtype=k.dtype, device=dev) for _ in range(2)]
        for buf, src in zip(kv, (k, v)):
            buf[0, :n] = src[6, :n]
        sfx = attend(q[6:7, c:c + s].contiguous(), *kv, q_offset=c)
        assert torch.equal(sfx[0, :n - c], got[6, c:n]), ("continuation rows != whole prompt's", kind)
    detail["prefill_attention_batch_invariant" + tag] = {"prompt_lens": list(lens), "bucket": 128, "continuation_at": 40,
                                                   "kv": list(kinds)}
    out = {}
    names = pa.kernel_names(torch.bfloat16)
    for b, s, kind in timed:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        if kind == "wire":
            k, v = (_wire_kv((b, s, kvh, hd), gen, dev) for _ in range(2))
        else:
            k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=dev) for _ in range(2))
        qb, kb, vb = (t.to(torch.bfloat16).transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = b * s * (s + 1) // 2  # (query, key) pairs a causal prefill needs
        nbytes = q.numel() * 2 * 2 + (k.numel() + v.numel()) * 4
        bound, by = _bound_ms(nbytes, 4 * hd * h * pairs)
        reps = 20 if s <= 128 else 3
        got, want = attend(q, k, v), ref.chunked_attention_ref(q, k, v)
        err = _assert_prefill_close(got, want, q, k, v, f"K9 B {b} x {s}")
        del got, want
        row = {"max_abs_err": err, "ms": _cuda_ms(lambda: attend(q, k, v), reps=reps),
               "plain_ms": _cuda_ms(lambda: ref.chunked_attention_ref(q, k, v), reps=reps),
               "library_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True,
                                                                             enable_gqa=True), reps=reps),
               "bound_ms": bound, "bound_by": by, "shape": [b, s, h, kvh, hd], "kv": kind}
        # a call's kernels, each profiled under its own name; the launch counter adds one a call, so
        # device_ms_per_launch is per call: the sum over the call's launches_per_call kernels
        row["device_ms_by_kernel"] = {n: _device_ms(lambda: attend(q, k, v), n)[0] for n in names}
        row["device_ms"] = row["device_ms_per_launch"] = _sum_or_none(row["device_ms_by_kernel"].values())
        row["launches_per_call"] = len(names)
        out[(b, s, kind)] = row
        detail[f"prefill_attention_B{b}_S{s}" + ("_wire" if kind == "wire" else "") + tag] = row
    return max([max_err] + [r["max_abs_err"] for r in out.values()]), out[timed[0]]


def _timed_attention(attend, library, q, k, v, bound, detail_key, detail, reps, **mask):
    """One K9 timing row: held against the plain version with ``mask``
    (``_assert_prefill_close``), its |error|, event ms beside it and
    ``library`` (SDPA), and
    for a bf16 q (the serving path) each of its kernels' device ms from
    the profiler, as ``_check_prefill_attention``'s rows (which time a bf16
    q only); an f32-q row has event ms only."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref

    plain = lambda: ref.chunked_attention_ref(q, k, v, **mask)  # noqa: E731
    got, want = attend(), plain()
    err = _assert_prefill_close(got, want, q, k, v, detail_key, **mask)
    del got, want
    row = {"max_abs_err": err, "ms": _cuda_ms(attend, reps=reps), "plain_ms": _cuda_ms(plain, reps=2, warmup=1),
           "library_ms": _cuda_ms(library, reps=reps), "bound_ms": bound[0], "bound_by": bound[1],
           "q": str(q.dtype).split(".")[-1], "shape_q_k_v": [list(q.shape), list(k.shape), list(v.shape)]}
    row["device_ms_by_kernel"] = row["device_ms"] = None
    if q.dtype == torch.bfloat16:
        names = pa.kernel_names(q.dtype, q.shape[-1], k.dtype == v.dtype == torch.bfloat16)
        row["device_ms_by_kernel"] = {n: _device_ms(attend, n)[0] for n in names}
        row["device_ms"] = _sum_or_none(row["device_ms_by_kernel"].values())
    detail[detail_key] = row
    return row


def _check_prefill_attention_zoo(dev, gen, detail, mla_heads=128, mla_timed=((4, 32), (1, 4096)), frames=1500):
    """Phase 3, K9 at the zoo's shapes.  (a) MLA: deepseek_v2_236b's 128
    heads at hd 192 (nope 128 + rope 64) with V at 128, causal, bf16 K/V (MLA
    attends its in-pass K/V), q bf16 (the serving path: the tensor-core
    body) and f32 (the f32 body): against the plain version within
    PREFILL_TOL; each prompt's rows alone at its bucket == inside B 4 x 32
    (generate's bucket), bit for bit; timed at B 4 x 32 and B 1 x 4096
    beside SDPA on the same bf16 tensors with V zero-padded to 192 (SDPA
    takes one head width), the bound from operations.  (b) whisper: no
    causal mask, 8 heads of 64, bf16 K/V: the encoder's 1500 frames
    attending each other, and 1, 8 and 32 decoder queries against 1500
    frames (cross-attention), against the plain version, one query alone ==
    its row among 32, timed beside SDPA.  The keywords shrink the shapes
    for a rehearsal on the CPU.  Returns (largest |error|, rows)."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref

    attend = pa.prefill_attention_cuda
    rows, max_err = {}, 0.0
    h, hd, dv = mla_heads, 192, 128
    for q_dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 32, h, hd), generator=gen, device=dev).to(q_dtype)
        k = torch.randn((4, 32, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((4, 32, h, dv), generator=gen, device=dev).to(torch.bfloat16)
        got, want = attend(q, k, v), ref.chunked_attention_ref(q, k, v)
        max_err = max(max_err, _assert_prefill_close(got, want, q, k, v, "K9 MLA B 4 x 32"))
        for r, n in enumerate((8, 15, 23, 32)):
            s = max(8, 1 << (n - 1).bit_length())
            alone = attend(*(t[r:r + 1, :s].contiguous() for t in (q, k, v)))
            assert torch.equal(alone[0, :n], got[r, :n]), ("K9 hd 192 rows alone != in batch", n, q_dtype)
    for b, s in mla_timed:
        k = torch.randn((b, s, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, s, h, dv), generator=gen, device=dev).to(torch.bfloat16)
        kb, vb = k.transpose(1, 2).contiguous(), F.pad(v, (0, hd - dv)).transpose(1, 2).contiguous()
        pairs = b * s * (s + 1) // 2
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(q_dtype)
            qb = q.to(torch.bfloat16).transpose(1, 2).contiguous()
            nbytes = q.numel() * q.element_size() + k.numel() * 2 + v.numel() * 2 + b * s * h * dv * q.element_size()
            row = _timed_attention(lambda: attend(q, k, v),
                                   lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True),
                                   q, k, v, _bound_ms(nbytes, 2 * (hd + dv) * h * pairs),
                                   f"prefill_attention_mla_hd192_B{b}_S{s}_q_{_dtype_tag(q_dtype)}", detail,
                                   reps=20 if s <= 128 else 3)
            max_err = max(max_err, row["max_abs_err"])
            rows[f"mla_hd192_B{b}_S{s}_q_{_dtype_tag(q_dtype)}"] = row
        del q, k, v, qb, kb, vb
        torch.cuda.empty_cache()
    h, hd = 8, 64
    k = torch.randn((1, frames, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, frames, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    kb, vb = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    for sq in (frames, 1, 8, 32):
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((1, sq, h, hd), generator=gen, device=dev).to(q_dtype)
            qb = q.to(torch.bfloat16).transpose(1, 2).contiguous()
            if sq == 32:
                got = attend(q, k, v, causal=False)
                for i in (0, 7, 31):
                    alone = attend(q[:, i:i + 1].contiguous(), k, v, causal=False)
                    assert torch.equal(alone[:, 0], got[:, i]), ("K9 non-causal query alone != among 32", i)
            nbytes = (q.numel() * 2) * q.element_size() + (k.numel() + v.numel()) * 2
            what = "encoder" if sq == frames else f"cross_Sq{sq}"
            row = _timed_attention(lambda: attend(q, k, v, causal=False),
                                   lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=False),
                                   q, k, v, _bound_ms(nbytes, 4 * hd * h * sq * frames),
                                   f"prefill_attention_whisper_{what}_q_{_dtype_tag(q_dtype)}", detail, reps=20,
                                   causal=False)
            max_err = max(max_err, row["max_abs_err"])
            rows[f"whisper_{what}_q_{_dtype_tag(q_dtype)}"] = row
    return max_err, rows


RG_HEADS = (10, 1, 256, 2048)  # recurrentgemma_2b's query heads, KV heads, head width and window


def _check_prefill_attention_window(dev, gen, detail, check_s=2600, timed=(4, 3072)):
    """Phase 3, K9 at RecurrentGemma's attention: hd 256, 10 query heads on
    one KV head, window 2048, causal.  Against the plain version within
    PREFILL_TOL at B 2 x ``check_s`` (longer than the window) with q, K and
    V bf16 (the exact-length prefill's: the tensor-core body) and f32 (the
    f32 body); each prompt's rows alone == inside the batch, and a
    continuation at q_offset 1000 (not a multiple of the 64-key chunk,
    its first rows' windows reaching before it) == the same rows of the
    whole prompt, bit for bit; timed at B 4 x 3072 (phase 11's prefill)
    beside F.scaled_dot_product_attention with the band as a boolean mask,
    on the same bf16 tensors, the bound from the operations inside the band
    (4 hd a (query, key) pair).  ``check_s`` and ``timed`` shrink the shapes
    for a rehearsal on the CPU.  Returns (largest |error|, rows)."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref

    attend = pa.prefill_attention_cuda
    h, kvh, hd, w = RG_HEADS
    rows, max_err = {}, 0.0
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((2, check_s, h, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((2, check_s, kvh, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        got, want = attend(q, k, v, window=w), ref.chunked_attention_ref(q, k, v, window=w)
        err = _assert_prefill_close(got, want, q, k, v, f"K9 hd 256 window B 2 x {check_s} {_dtype_tag(dt)}",
                                    window=w)
        max_err = max(max_err, err)
        for r, n in ((0, check_s - 37), (1, check_s)):
            alone = attend(*(t[r:r + 1, :n].contiguous() for t in (q, k, v)), window=w)
            assert torch.equal(alone[0], got[r, :n]), ("K9 hd 256 window rows alone != in batch", n, dt)
        c = min(1000, check_s // 2 + 5)
        sfx = attend(q[1:, c:].contiguous(), k[1:].contiguous(), v[1:].contiguous(), window=w, q_offset=c)
        assert torch.equal(sfx[0], got[1, c:]), ("K9 hd 256 window continuation != whole prompt's rows", dt)
        rows[f"check_B2_S{check_s}_{_dtype_tag(dt)}"] = {"max_abs_err": err, "body": pa.kernel_body(dt, hd),
                                                         "continuation_at": c}
        del q, k, v, got, want
    b, s_len = timed
    q = torch.randn((b, s_len, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s_len, kvh, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(s_len, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    pairs = b * sum(min(j + 1, w) for j in range(s_len))  # (query, key) pairs inside the band
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
    row = _timed_attention(lambda: attend(q, k, v, window=w),
                           lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=band, enable_gqa=True),
                           q, k, v, _bound_ms(nbytes, 4 * hd * h * pairs),
                           f"prefill_attention_hd256_window{w}_B{b}_S{s_len}", detail, reps=5, window=w)
    row.update(window=w, pairs_in_band=pairs, launches_per_call=len(pa.kernel_names(torch.bfloat16, hd)))
    rows[f"timed_B{b}_S{s_len}"] = row
    max_err = max(max_err, row["max_abs_err"])
    return max_err, rows


def _dtype_tag(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _check_rms_norm(cfg, dev, gen, detail, tag=""):
    """K10 at llama3_2_3b's d_model: against its plain version (one bf16 ulp
    of the output: rsqrt and the sum's order differ), each prompt's rows
    alone == inside a batch of 8 x 128 and decode's 4 rows == the same rows
    of 8, bit for bit; timed at M 4 and 1024 (bytes: x and y once, gamma)
    beside F.rms_norm with the gain 1 + gamma (f32, made once: the same
    function) and, as ``library_bf16_gain_ms``, with the gain in bf16,
    which PyTorch's fused kernel needs (not the same bits)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rms_norm import rms_norm_cuda

    d = cfg.d_model
    gamma = torch.randn(d, generator=gen, device=dev) * 0.1
    x = (torch.randn((8, 128, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
    got, want = rms_norm_cuda(x, gamma, cfg.norm_eps), ref.rms_norm_ref(x, gamma, cfg.norm_eps)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6)
    err = float((got.float() - want.float()).abs().max())
    for r, n in enumerate((8, 15, 23, 32, 40, 57, 64, 100)):
        s = max(8, 1 << (n - 1).bit_length())
        assert torch.equal(rms_norm_cuda(x[r:r + 1, :s], gamma, cfg.norm_eps)[0, :n], got[r, :n]), ("K10 rows", n)
    xd = x[:, -1:].contiguous()
    assert torch.equal(rms_norm_cuda(xd[:4], gamma, cfg.norm_eps), rms_norm_cuda(xd, gamma, cfg.norm_eps)[:4])
    gain = 1.0 + gamma
    lib = F.rms_norm(x, (d,), weight=gain, eps=cfg.norm_eps)
    torch.testing.assert_close(lib.float(), want.float(), rtol=2**-7, atol=1e-6)
    gain_bf16 = gain.to(torch.bfloat16)
    out = {}
    for m in (4, 1024):
        xm = x.reshape(-1, d)[:m].contiguous()
        bound, by = _bound_ms(2 * m * d * 2 + d * 4, 0.0)
        out[m] = _with_device_time(
            {"ms": _cuda_ms(lambda: rms_norm_cuda(xm, gamma, cfg.norm_eps), reps=50),
             "plain_ms": _cuda_ms(lambda: ref.rms_norm_ref(xm, gamma, cfg.norm_eps), reps=50),
             "library_ms": _cuda_ms(lambda: F.rms_norm(xm, (d,), weight=gain, eps=cfg.norm_eps), reps=50),
             "library_bf16_gain_ms": _cuda_ms(lambda: F.rms_norm(xm, (d,), weight=gain_bf16, eps=cfg.norm_eps),
                                              reps=50),
             "bound_ms": bound, "bound_by": by},
            lambda: rms_norm_cuda(xm, gamma, cfg.norm_eps), "rms_norm_kernel", 1)
        detail[f"rms_norm_M{m}{tag}"] = out[m]
    return err, out[4]


def _decode_forward_counts(cfg, eng, detail):
    """One W4A4 decode forward of llama3_2_3b (batch 4): every K1 launch
    fake-quantizes x in its own load, and no K2 is launched."""
    from repro_torch.models import transformer as tf

    prompts = _generate_prompts(cfg)
    toks = np.zeros((len(prompts), 32), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = np.array([len(p) for p in prompts])
    last, caches = eng._bucketed_prefill(toks, lens, max_len=eng.scfg.max_len, qdq_kv=True)
    caches = eng._quantize_caches(caches)
    torch.cuda.synchronize()
    _reset_counts()
    with torch.no_grad():
        tf.decode_step(eng.params, torch.argmax(last, -1), caches, torch.as_tensor(lens, device=eng.device), cfg,
                       eng.policy)
    counts = _read_counts()
    per = 7 * cfg.num_layers
    assert counts["razer_act_qdq"] == 0 and counts["razer_matmul"] == counts["razer_matmul_fused_act"] == per, counts
    out = {"batch": len(prompts), "razer_act_qdq": counts["razer_act_qdq"], "razer_matmul": counts["razer_matmul"],
           "razer_matmul_fused_act": counts["razer_matmul_fused_act"]}
    detail["w4a4_decode_forward_launches"] = out
    return out


def _check_kv_attention(cfg, dev, gen, detail, tag=""):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    b, s, h, kvh, hd = 4, 128, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    kc, km = kv_quantize(torch.randn((b, s, kvh, hd), generator=gen, device=dev))
    vc, vm = kv_quantize(torch.randn((b, s, kvh, hd), generator=gen, device=dev))
    cur = torch.tensor([9, 40, 97, 128], dtype=torch.int32, device=dev)
    got = razer_kv_attention_cuda(q, kc, km, vc, vm, cur)
    want = ref.razer_kv_attention_ref(q, kc, km, vc, vm, cur)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)  # f32 softmax, other sum order
    err = float((got - want).abs().max())

    k, v = kv_dequantize(kc, km, hd), kv_dequantize(vc, vm, hd)
    qs = q[:, :, None, :]
    ks = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1)  # (B, H, S, hd)
    vs = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
    mask = torch.arange(s, device=dev)[None, None, None, :] < cur[:, None, None, None]

    def library():
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    qb, kb, vb = qs.to(torch.bfloat16), ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    valid = int(cur.sum())
    nbytes = q.numel() * 4 * 2 + valid * kvh * (hd // 2 + hd // 16) * 2 + b * 4
    flops = 4 * valid * h * hd
    bound, by = _bound_ms(nbytes, flops)
    out = _with_device_time(
        {"ms": _cuda_ms(lambda: razer_kv_attention_cuda(q, kc, km, vc, vm, cur), reps=50),
         "plain_ms": _cuda_ms(lambda: ref.razer_kv_attention_ref(q, kc, km, vc, vm, cur), reps=10),
         "library_ms": _cuda_ms(library, reps=50),
         "library_bf16_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask), reps=50),
         "bound_ms": bound, "bound_by": by},
        lambda: razer_kv_attention_cuda(q, kc, km, vc, vm, cur), "kv_attention_kernel", 1, cold=True)
    detail["razer_kv_attention_B4_S128" + tag] = out
    return err, out


def _check_paged_attention(cfg, dev, gen, detail):
    """K4 and K5 against their plain versions (1e-4) on a scattered page
    table at the llama3_2_3b head widths, the bit-identities K4 == K3 and
    K5[t] == K4 at cur_len + t + 1, and the times of K4 and of K5 at T = 3
    (speculate_k = 2)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    b, h, kvh, hd, ps, npg = 4, cfg.num_heads, cfg.num_kv_heads, cfg.hd, 16, 8
    n_pages = b * npg + 1
    pool = (*kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)),
            *kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)))
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    table = perm.reshape(b, npg).to(torch.int32).to(dev)  # scattered, disjoint rows
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    cur = torch.tensor([9, 40, 97, 128], dtype=torch.int32, device=dev)
    got = paged_kv_attention_cuda(q, *pool, table, cur, check_pages=True)
    want = ref.paged_kv_attention_ref(q, *pool, table, cur)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)  # f32 softmax, other sum order
    err4 = float((got - want).abs().max())
    # bit-identity with K3 when each sequence's pages are contiguous
    flat = (1 + torch.arange(b * npg, dtype=torch.int32, device=dev)).reshape(b, npg)
    contiguous = [x[1:].reshape(b, npg * ps, kvh, x.shape[-1]).contiguous() for x in pool]
    assert torch.equal(paged_kv_attention_cuda(q, *pool, flat, cur), razer_kv_attention_cuda(q, *contiguous, cur)), \
        "K4 on a contiguous table differs from K3 on the same bytes"

    err5 = 0.0
    committed = torch.tensor([9, 40, 97, 125], dtype=torch.int32, device=dev)
    qts = {}
    for t in (1, 3):
        qt = torch.randn((b, t, h, hd), generator=gen, device=dev)
        got = paged_kv_attention_verify_cuda(qt, *pool, table, committed, check_pages=True)
        want = ref.paged_kv_attention_verify_ref(qt, *pool, table, committed)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        err5 = max(err5, float((got - want).abs().max()))
        for i in range(t):  # query i == a decode step at committed + i + 1, bit for bit
            one = paged_kv_attention_cuda(qt[:, i].contiguous(), *pool, table, committed + i + 1)
            assert torch.equal(got[:, i], one), f"K5 query {i} of T={t} differs from K4"
        qts[t] = qt

    def dequant_heads(lens):  # (B, H, S, hd) f32 K/V for SDPA, gathered through the table
        kv = [kv_dequantize(ref._gathered(pool[i], table), ref._gathered(pool[i + 1], table), hd)
              for i in (0, 2)]
        return [x.transpose(1, 2).repeat_interleave(h // kvh, dim=1) for x in kv]

    ks, vs = dequant_heads(cur)
    s_max = npg * ps
    pos = torch.arange(s_max, device=dev)
    mask4 = pos[None, None, None, :] < cur[:, None, None, None]
    qt = qts[3]
    lim = committed[:, None] + torch.arange(3, device=dev)[None, :] + 1  # (B, T)
    mask5 = pos[None, None, None, :] < lim[:, None, :, None]  # (B, 1, T, S)
    q5 = qt.transpose(1, 2)  # (B, H, T, hd)
    kv_row = kvh * (hd // 2 + hd // 16) * 2  # K and V bytes of one position
    out = {}
    valid4 = int(cur.sum())
    bound, by = _bound_ms(2 * q.numel() * 4 + valid4 * kv_row + table.numel() * 4 + b * 4, 4 * valid4 * h * hd)
    kb, vb = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    out["paged_kv_attention"] = (err4, _with_device_time({
        "ms": _cuda_ms(lambda: paged_kv_attention_cuda(q, *pool, table, cur), reps=50),
        "plain_ms": _cuda_ms(lambda: ref.paged_kv_attention_ref(q, *pool, table, cur), reps=10),
        "library_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], ks, vs, attn_mask=mask4),
                               reps=50),
        "library_bf16_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None].to(torch.bfloat16), kb, vb, attn_mask=mask4), reps=50),
        "bound_ms": bound, "bound_by": by},
        lambda: paged_kv_attention_cuda(q, *pool, table, cur), "kv_attention_kernel", 1, cold=True))
    valid5 = int((committed + 3).sum())  # each input position read once
    ops5 = 4 * int(lim.sum()) * h * hd
    bound, by = _bound_ms(2 * qt.numel() * 4 + valid5 * kv_row + table.numel() * 4 + b * 4, ops5)
    out["paged_kv_attention_verify"] = (err5, _with_device_time({
        "ms": _cuda_ms(lambda: paged_kv_attention_verify_cuda(qt, *pool, table, committed), reps=50),
        "plain_ms": _cuda_ms(lambda: ref.paged_kv_attention_verify_ref(qt, *pool, table, committed), reps=10),
        "library_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(q5, ks, vs, attn_mask=mask5), reps=50),
        "library_bf16_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(
            q5.to(torch.bfloat16), kb, vb, attn_mask=mask5), reps=50),
        "bound_ms": bound, "bound_by": by},
        lambda: paged_kv_attention_verify_cuda(qt, *pool, table, committed), "kv_attention_kernel", 1, cold=True))
    detail["paged_kv_attention_B4_ps16"] = out["paged_kv_attention"][1]
    detail["paged_kv_attention_verify_B4_T3_ps16"] = out["paged_kv_attention_verify"][1]
    return out


# Long decode shapes with llama3_2_3b heads and pages of 16: 16 sequences
# at 4096 positions (one at 4001, off a page edge) and one at 32768.
LONG_ATTENTION = {"B16_L4096": [4001] + [4096] * 15, "B1_L32768": [32768]}
# The body's largest |error| against the plain versions at the long shapes,
# beside the 1e-4 of every kernel check: set between the kernel's own (at
# most 1.15e-6, K5 at B 16 x 4096) and that of the body with q and P
# rounded to one bf16 part each (7.1e-5 at B 1 x 32768, 2.6e-4 at B 16 x
# 4096; ``tools/attention_attribution.py no_lo_parts``), so that a body
# without the low parts fails.
LONG_ATTENTION_ATOL = 1e-5


def _attention_case(cfg, dev, gen, lengths, ps=16):
    """A pool holding each sequence on scattered pages (+ the null page), its
    table, the same bytes gathered into a contiguous cache, q and cur_len."""
    from repro_torch.kernels import ref
    from repro_torch.serving.kvcache import kv_quantize

    b, h, kvh, hd = len(lengths), cfg.num_heads, cfg.num_kv_heads, cfg.hd
    npg = -(-max(lengths) // ps)
    n_pages = b * npg + 1
    pool = []
    for _ in range(2):
        x = torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)
        pool += kv_quantize(x)
        del x
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(len(lengths))) + 1
    table = perm.reshape(b, npg).to(torch.int32).to(dev)
    caches = [ref._gathered(x, table).contiguous() for x in pool]
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    return pool, table, caches, q, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _check_attention_long(cfg, dev, gen, detail, shapes=LONG_ATTENTION, t_verify: int = 3, tag=""):
    """K3, K4 and K5 (T = 3) at the long shapes: each within 1e-4 of its
    plain version; K4 == K3 on the gathered bytes, K5's query t == K4 at
    cur_len + t + 1, and the first sequence's output alone == inside the
    batch, bit for bit; each also within LONG_ATTENTION_ATOL of its plain
    version; per kernel the CUDA-event time, the device time per launch
    (profiler, L2 flushed before each launch), the plain version's time,
    F.scaled_dot_product_attention on the dequantized K/V in f32 and in
    bf16 expanded to H heads, and in bf16 with the heads grouped
    (enable_gqa, and G query rows per kv head), masked to each length, and
    the bound (cache bytes up to each length plus q and out, or 4 flop per
    (position, head, dim) at the bf16 peak).  Returns {shape: {kernel: row}}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.serving.kvcache import kv_dequantize

    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kv_row = kvh * (hd // 2 + hd // 16) * 2  # K and V bytes of one position
    out = {}
    for name, lengths in shapes.items():
        pool, table, caches, q, cur = _attention_case(cfg, dev, gen, lengths)
        b, s_max = len(lengths), caches[0].shape[1]
        committed = cur - t_verify
        qt = torch.randn((b, t_verify, h, hd), generator=gen, device=dev)
        calls = {"razer_kv_attention": lambda: razer_kv_attention_cuda(q, *caches, cur),
                 "paged_kv_attention": lambda: paged_kv_attention_cuda(q, *pool, table, cur),
                 "paged_kv_attention_verify": lambda: paged_kv_attention_verify_cuda(qt, *pool, table, committed)}
        plains = {"razer_kv_attention": lambda: ref.razer_kv_attention_ref(q, *caches, cur),
                  "paged_kv_attention": lambda: ref.paged_kv_attention_ref(q, *pool, table, cur),
                  "paged_kv_attention_verify": lambda: ref.paged_kv_attention_verify_ref(qt, *pool, table, committed)}
        got = {k: fn() for k, fn in calls.items()}
        errs = {}
        for k, fn in plains.items():
            want = fn()
            torch.testing.assert_close(got[k], want, rtol=1e-4, atol=1e-4)
            errs[k] = float((got[k] - want).abs().max())
            assert errs[k] <= LONG_ATTENTION_ATOL, f"{name}: {k} |err| {errs[k]} > {LONG_ATTENTION_ATOL}"
            del want
        assert torch.equal(got["paged_kv_attention"], got["razer_kv_attention"]), f"{name}: K4 != K3"
        for t in range(t_verify):
            one = paged_kv_attention_cuda(qt[:, t].contiguous(), *pool, table, committed + t + 1)
            assert torch.equal(got["paged_kv_attention_verify"][:, t], one), f"{name}: K5 query {t} != K4"
        if b > 1:  # the first sequence alone, on a table of its own pages only
            own = table[:1, :-(-lengths[0] // 16)].contiguous()
            alone = paged_kv_attention_cuda(q[:1].contiguous(), *pool, own, cur[:1])
            assert torch.equal(alone, got["paged_kv_attention"][:1]), f"{name}: batch moves sequence 0 (K4)"
            alone = paged_kv_attention_verify_cuda(qt[:1].contiguous(), *pool, own, committed[:1])
            assert torch.equal(alone, got["paged_kv_attention_verify"][:1]), f"{name}: batch moves sequence 0 (K5)"
            alone = razer_kv_attention_cuda(q[:1].contiguous(), *(c[:1, :own.shape[1] * 16].contiguous()
                                                                   for c in caches), cur[:1])
            assert torch.equal(alone, got["razer_kv_attention"][:1]), f"{name}: batch moves sequence 0 (K3)"
        del got
        # the library calls on the dequantized K/V, masked to each length:
        # expanded to the H query heads (B, H, S, hd) in f32 and bf16, and
        # in bf16 with the heads left grouped (B, KVH, S, hd), each K/V row
        # read once: through enable_gqa, and with a kv head's G query rows
        # (and T queries) as the query positions of one attention
        g = h // kvh
        kg = kv_dequantize(caches[0], caches[1], hd).transpose(1, 2).contiguous()  # (B, KVH, S, hd)
        vg = kv_dequantize(caches[2], caches[3], hd).transpose(1, 2).contiguous()
        kd, vd = kg.repeat_interleave(g, dim=1), vg.repeat_interleave(g, dim=1)
        pos = torch.arange(s_max, device=dev)
        lim = committed[:, None] + torch.arange(t_verify, device=dev)[None, :] + 1
        masks = {"one": pos[None, None, None, :] < cur[:, None, None, None],
                 "verify": pos[None, None, None, :] < lim[:, None, :, None]}
        queries = {"one": q[:, :, None], "verify": qt.transpose(1, 2).contiguous()}
        lib = {}
        for kind in ("one", "verify"):
            for dt in (torch.float32, torch.bfloat16):
                kk, vv, qq = kd.to(dt), vd.to(dt), queries[kind].to(dt)
                lib[(kind, dt)] = _cuda_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=masks[kind]),
                                           reps=10)
                del kk, vv
        del kd, vd
        kb, vb = kg.to(torch.bfloat16), vg.to(torch.bfloat16)
        del kg, vg
        for kind in ("one", "verify"):
            qq = queries[kind].to(torch.bfloat16)  # (B, H, T, hd)
            tq = qq.shape[2]
            lib[(kind, "gqa")] = _cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, kb, vb, attn_mask=masks[kind], enable_gqa=True), reps=10)
            qf = qq.reshape(b, kvh, g * tq, hd)  # rows (g, t) of each kv head
            mf = masks[kind].expand(b, 1, tq, s_max).repeat(1, 1, g, 1).contiguous()  # (B, 1, G T, S)
            lib[(kind, "grouped")] = _cuda_ms(lambda: F.scaled_dot_product_attention(qf, kb, vb, attn_mask=mf),
                                              reps=10)
        del kb, vb
        bf16_grouped_bytes = 2 * b * kvh * s_max * hd * 2  # the bf16 K and V the grouped calls read
        valid = int(cur.sum())
        rows = {}
        for k, fn in calls.items():
            verify = k == "paged_kv_attention_verify"
            read = int((committed + t_verify).sum()) if verify else valid
            attended = int(lim.sum()) if verify else valid
            qbytes = 2 * (qt if verify else q).numel() * 4
            bound, by = _bound_ms(qbytes + read * kv_row + (0 if k == "razer_kv_attention" else table.numel() * 4),
                                  4 * attended * h * hd)
            kind = "verify" if verify else "one"
            rows[k] = _with_device_time(
                {"max_abs_err": errs[k], "ms": _cuda_ms(fn, reps=10), "plain_ms": _cuda_ms(plains[k], reps=2, warmup=1),
                 "library_ms": lib[(kind, torch.float32)], "library_bf16_ms": lib[(kind, torch.bfloat16)],
                 "library_bf16_gqa_ms": lib[(kind, "gqa")], "library_bf16_grouped_ms": lib[(kind, "grouped")],
                 "library_bf16_grouped_bytes": bf16_grouped_bytes, "bound_ms": bound, "bound_by": by,
                 "lengths": sorted(set(lengths))},
                fn, "kv_attention_kernel", 1, cold=True)
        out[name] = rows
        detail[f"attention_{name}{tag}"] = rows
        del pool, caches, q, qt
        torch.cuda.empty_cache()
    return out


def _expert_banks(dev, gen, detail, arch="dbrx_132b", experts=None, tag=""):
    """The full-width expert banks of one of ``arch``'s MoE layers (the
    first ``experts`` of them), packed on the card: dbrx_132b E 16,
    gate/up K 6144 N 10752, down K 10752 N 6144."""
    from repro_torch.configs import get_config
    from repro_torch.core.packing import pack_stacked_weights

    cfg = get_config(arch)
    e, d, f = experts or cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    t0 = time.perf_counter()
    banks = {}
    for name, k, n in (("gate", d, f), ("up", d, f), ("down", f, d)):
        w = torch.randn((e, k, n), generator=gen, device=dev).mul_(k**-0.5)
        banks[name] = pack_stacked_weights(w)
        del w
    torch.cuda.synchronize()
    detail["razer_grouped_matmul_pack_s_3_banks" + tag] = time.perf_counter() - t0
    return banks


def _check_grouped_matmul(dev, gen, detail, banks, tag=""):
    """K6 at one MoE layer's full-width expert banks (dbrx_132b: E 16;
    gate/up K 6144 N 10752, down K 10752 N 6144) against its plain version
    at M = 4 (a batch-4 decode: 4 dispatch groups x capacity 1) and 48 (a
    4 x 32 prefill: 16 groups x capacity 3), tolerance K1's; bit-identity
    (a) K6's expert e == K1 on bank entry e for experts 0, 7, 15, and (b)
    each expert's row 0 across M in {1, 4, 8, 24, 48}; times of one MoE
    layer's 3 calls at M = 4 and 48."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_grouped_matmul import razer_grouped_matmul_cuda
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda

    e = banks["gate"].shape[0]
    d, f = banks["gate"].shape[1], banks["gate"].shape[2]
    shapes = [("gate", d, f), ("up", d, f), ("down", f, d)]

    def k6(x, pst):
        return razer_grouped_matmul_cuda(x, pst.codes, pst.scale_meta, m0=pst.sv_magnitudes[0],
                                         m1=pst.sv_magnitudes[1])

    max_err = 0.0
    for name in ("gate", "down"):  # the two (K, N) kinds
        pst = banks[name]
        k = pst.shape[1]
        dense_abs = pst.dequantize().abs_()
        for m in (4, 48):
            x = torch.randn((e, m, k), generator=gen, device=dev).to(torch.bfloat16)
            raw = k6(x, pst)
            got = raw * pst.tensor_scale[:, None, None]
            want = ref.razer_grouped_matmul_ref(x, pst)
            bound = 1e-5 * torch.einsum("emk,ekn->emn", x.float().abs(), dense_abs) + 1e-6
            err = (got - want).abs()
            assert bool((err <= bound).all()), f"razer_grouped_matmul {name} M={m}: {float(err.max())}"
            max_err = max(max_err, float(err.max()))
            for ex in (0, 7, 15):  # (a) one tile body, K1's (N, K) splits, the same split sum
                pw = pst[ex]
                one = razer_matmul_cuda(x[ex], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                        m1=pw.sv_magnitudes[1])
                assert torch.equal(raw[ex], one), f"K6 expert {ex} differs from K1 ({name}, M={m})"
        del dense_abs
        x = torch.randn((e, 48, k), generator=gen, device=dev).to(torch.bfloat16)
        rows = [k6(x[:, :m].contiguous(), pst)[:, :1] for m in (1, 4, 8, 24, 48)]  # (b)
        assert all(torch.equal(r, rows[0]) for r in rows[1:]), f"razer_grouped_matmul {name}: row 0 moves with M"
    detail["razer_grouped_matmul_expert_equals_K1" + tag] = [0, 7, 15]
    detail["razer_grouped_matmul_row_invariant_M" + tag] = [1, 4, 8, 24, 48]

    out = {}
    for m in (4, 48):
        xs = {k: torch.randn((e, m, k), generator=gen, device=dev).to(torch.bfloat16) for k in (d, f)}

        def kernel_layer():
            for name, k, _ in shapes:
                k6(xs[k], banks[name])

        def plain_layer():
            for name, k, _ in shapes:
                ref.razer_grouped_matmul_ref(xs[k], banks[name])

        nbytes = sum(e * (m * k * 2 + k * n // 2 + k * n // 16 + m * n * 4) for _, k, n in shapes)
        flops = sum(2 * e * m * k * n for _, k, n in shapes)
        bound, by = _bound_ms(nbytes, flops)
        row = {"ms": _cuda_ms(kernel_layer, reps=10), "plain_ms": _cuda_ms(plain_layer, reps=2, warmup=1)}
        # the library yardstick: torch.bmm on the dequantized bf16 banks,
        # one bank at a time (three at once would not fit beside the rest)
        lib = 0.0
        for name, k, _ in shapes:
            dense = banks[name].dequantize().to(torch.bfloat16)
            lib += _cuda_ms(lambda: torch.bmm(xs[k], dense), reps=10)
            del dense
        row.update({"library_ms": lib, "bound_ms": bound, "bound_by": by})
        out[m] = _with_device_time(row, kernel_layer, "gemm_kernel<K6,", 3)
        detail[f"razer_grouped_matmul_moe_layer_M{m}{tag}"] = row
    return max_err, out[4]


def _unchunk(y):
    """A K-shard kernel's (c, ..., N/c) chunk-major output -> (..., N)."""
    return y.movedim(0, -2).reshape(*y.shape[1:-1], -1)


def _check_kshard_matmul(cfg, dev, gen, detail, tp: int = 2):
    """K7 at the full-width llama3_2_3b linears split over tp = 2 (local K
    1536 and 4096), on both ranks' shards, at M = 4 and 128: within K1's
    tolerance of its plain version; its chunked output is K1's output on the
    same local shard, permuted, bit for bit, and at out_chunks = 1 it is K1's
    output; row 0 bit-identical across M in {1, 4, 8, 24}.  Times (rank 0's
    shards of one layer's 7 linears, over 4 layers' distinct weights as in
    K1's check): K7, the plain version, torch.matmul on the dequantized bf16
    local shard, and the bound: the local wire bytes, the bf16 activations
    in and the f32 full-N partial out over 3.35 TB/s (the per-device terms
    of docs/parallelism.md's cost table that the kernel moves)."""
    from repro_torch.core.packing import pack_weight, take_shard
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda

    shapes = _linear_shapes(cfg)
    wholes = [{name: pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
               for name, k, n in shapes} for _ in range(4)]

    def k7(x, pw, chunks=tp):
        return razer_matmul_kshard_cuda(x, pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                        m1=pw.sv_magnitudes[1], out_chunks=chunks)

    max_err = 0.0
    for name, k, n in shapes[:1] + shapes[1:2] + shapes[4:5] + shapes[6:]:  # (K, N) kinds
        for j in range(tp):
            pw = take_shard(wholes[0][name], tp=tp, tp_index=j)
            for m in (4, 128):
                x = torch.randn((m, k // tp), generator=gen, device=dev).to(torch.bfloat16)
                got = k7(x, pw)
                one = razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1])
                assert torch.equal(_unchunk(got), one), f"K7 {name} rank {j} M={m}: not K1 permuted"
                assert torch.equal(k7(x, pw, 1)[0], one), f"K7 {name} rank {j} M={m}: out_chunks=1 is not K1"
                want = ref.razer_matmul_ref(x, pw)
                bound = 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6
                err = (_unchunk(got) * pw.tensor_scale - want).abs()
                assert bool((err <= bound).all()), f"razer_matmul_kshard {name} rank {j} M={m}: {float(err.max())}"
                max_err = max(max_err, float(err.max()))
            x = torch.randn((24, k // tp), generator=gen, device=dev).to(torch.bfloat16)
            rows = [k7(x[:m].contiguous(), pw)[:, :1] for m in (1, 4, 8, 24)]
            assert all(torch.equal(r, rows[0]) for r in rows[1:]), f"K7 {name} rank {j}: row 0 moves with M"
    detail["razer_matmul_kshard_row_invariant_M"] = [1, 4, 8, 24]
    layers = [{name: take_shard(w[name], tp=tp, tp_index=0) for name, _, _ in shapes} for w in wholes]
    del wholes
    dense = [{name: layer[name].dequantize().to(torch.bfloat16) for name, _, _ in shapes} for layer in layers]
    out = {}
    for m in (4, 4 * 32):
        xs = {k: torch.randn((m, k // tp), generator=gen, device=dev).to(torch.bfloat16) for _, k, _ in shapes}

        def kernel_all():
            for layer in layers:
                for name, k, _ in shapes:
                    k7(xs[k], layer[name])

        def plain_layer():
            for name, k, _ in shapes:
                ref.razer_matmul_ref(xs[k], layers[0][name])

        def library_all():
            for layer in dense:
                for name, k, _ in shapes:
                    torch.matmul(xs[k], layer[name])

        kls = [(k // tp, n) for _, k, n in shapes]
        nbytes = sum(m * kl * 2 + kl * n // 2 + kl * n // 16 + m * n * 4 for kl, n in kls)
        flops = sum(2 * m * kl * n for kl, n in kls)
        bound, by = _bound_ms(nbytes, flops)
        out[m] = _with_device_time(
            {"ms": _cuda_ms(kernel_all, reps=10) / 4, "plain_ms": _cuda_ms(plain_layer, reps=3),
             "library_ms": _cuda_ms(library_all, reps=10) / 4, "bound_ms": bound, "bound_by": by, "tp": tp},
            kernel_all, "gemm_kernel<K7,", 7)
        detail[f"razer_matmul_kshard_layer_tp{tp}_M{m}"] = out[m]
    return max_err, out[4]


def _check_kshard_grouped(dev, gen, detail, banks):
    """K8 at one full-width dbrx_132b MoE layer's banks, on the tiles of a
    (1, 2) mesh (E 16, local K 3072 for gate/up, 5376 for down) and of a
    (2, 2) mesh (E 8), at M = 4 and 48: within K6's tolerance of its plain
    version; its chunked output is K6's on the same tile, permuted, bit for
    bit, and at out_chunks = 1 it is K6's; row 0 bit-identical across M in
    {1, 4, 8, 24}.  Times of one layer's 3 calls on rank (0, 0)'s tiles:
    K8, the plain version, torch.bmm on the dequantized bf16 tiles, and the
    bound (local wire bytes + bf16 activations in + the f32 full-N partial
    out over 3.35 TB/s)."""
    from repro_torch.core.packing import take_shard
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_grouped_matmul import razer_grouped_matmul_cuda, razer_grouped_matmul_kshard_cuda

    tp = 2

    def k8(x, pst, chunks=tp):
        return razer_grouped_matmul_kshard_cuda(x, pst.codes, pst.scale_meta, m0=pst.sv_magnitudes[0],
                                                m1=pst.sv_magnitudes[1], out_chunks=chunks)

    max_err = 0.0
    for ep in (1, 2):
        for i, j in ((0, 0), (ep - 1, 1)):
            for name in ("gate", "down"):
                tile = take_shard(banks[name], ep=ep, ep_index=i, tp=tp, tp_index=j)
                le, kl, n = tile.shape
                dense_abs = tile.dequantize().abs_()
                for m in (4, 48):
                    x = torch.randn((le, m, kl), generator=gen, device=dev).to(torch.bfloat16)
                    got = k8(x, tile)
                    six = razer_grouped_matmul_cuda(x, tile.codes, tile.scale_meta, m0=tile.sv_magnitudes[0],
                                                    m1=tile.sv_magnitudes[1])
                    assert torch.equal(_unchunk(got), six), f"K8 {name} ({ep}, {tp}) rank ({i}, {j}): not K6 permuted"
                    assert torch.equal(k8(x, tile, 1)[0], six), f"K8 {name}: out_chunks=1 is not K6"
                    want = ref.razer_grouped_matmul_ref(x, tile)
                    bound = 1e-5 * torch.einsum("emk,ekn->emn", x.float().abs(), dense_abs) + 1e-6
                    err = (_unchunk(got) * tile.tensor_scale[:, None, None] - want).abs()
                    assert bool((err <= bound).all()), f"razer_grouped_matmul_kshard {name}: {float(err.max())}"
                    max_err = max(max_err, float(err.max()))
                del dense_abs, want
                x = torch.randn((le, 24, kl), generator=gen, device=dev).to(torch.bfloat16)
                rows = [k8(x[:, :m].contiguous(), tile)[:, :, :1] for m in (1, 4, 8, 24)]
                assert all(torch.equal(r, rows[0]) for r in rows[1:]), f"K8 {name}: row 0 moves with M"
    detail["razer_grouped_matmul_kshard_row_invariant_M"] = [1, 4, 8, 24]

    out = {}
    for ep, m in ((1, 4), (1, 48), (2, 4)):
        tiles = {name: take_shard(banks[name], ep=ep, ep_index=0, tp=tp, tp_index=0) for name in banks}
        le, kd, _ = tiles["gate"].shape
        kf = tiles["down"].shape[1]
        xs = {kd: torch.randn((le, m, kd), generator=gen, device=dev).to(torch.bfloat16),
              kf: torch.randn((le, m, kf), generator=gen, device=dev).to(torch.bfloat16)}
        calls = [(xs[t.shape[1]], t) for t in (tiles["gate"], tiles["up"], tiles["down"])]
        row = {"ms": _cuda_ms(lambda: [k8(x, t) for x, t in calls], reps=10),
               "plain_ms": _cuda_ms(lambda: [ref.razer_grouped_matmul_ref(x, t) for x, t in calls], reps=2, warmup=1)}
        lib = 0.0
        for x, t in calls:  # one dequantized bank tile at a time
            dense = t.dequantize().to(torch.bfloat16)
            lib += _cuda_ms(lambda: torch.bmm(x, dense), reps=10)
            del dense
        nbytes = sum(le * (m * t.shape[1] * 2 + t.shape[1] * t.shape[2] // 2 + t.shape[1] * t.shape[2] // 16
                           + m * t.shape[2] * 4) for _, t in calls)
        flops = sum(2 * le * m * t.shape[1] * t.shape[2] for _, t in calls)
        bound, by = _bound_ms(nbytes, flops)
        row.update({"library_ms": lib, "bound_ms": bound, "bound_by": by, "mesh": [ep, tp], "local_experts": le})
        out[(ep, m)] = _with_device_time(row, lambda: [k8(x, t) for x, t in calls], "gemm_kernel<K8,", 3)
        detail[f"razer_grouped_matmul_kshard_moe_layer_ep{ep}_tp{tp}_M{m}"] = row
    return max_err, out[(1, 4)]


# ---------------------------------------------------------------------------
# phase 3 at the shapes of the paper's dense models
# ---------------------------------------------------------------------------
PAPER_DENSE = ("llama3_1_8b", "llama2_7b", "qwen3_8b", "qwen3_32b", "codeqwen1_5_7b", "deepseek_coder_33b")
ZOO = ("deepseek_v2_236b", "qwen2_vl_7b", "whisper_base")


def _gemm_shapes_new(archs=PAPER_DENSE, checked=("llama3_2_3b",)):
    """{(K, N): [models]} of ``archs``' packed linears that the models in
    ``checked`` do not have."""
    from repro_torch.configs import get_config

    seen = {(k, n) for arch in checked for _, k, n in _packed_linears(get_config(arch))}
    out = {}
    for arch in archs:
        for _, k, n in _packed_linears(get_config(arch)):
            if (k, n) not in seen and arch not in out.get((k, n), []):
                out.setdefault((k, n), []).append(arch)
    return out


def _check_gemm_shapes(dev, gen, detail, archs=PAPER_DENSE, checked=("llama3_2_3b",),
                       key="razer_matmul_paper_shapes", ms=(4, 128)):
    """K1 and K7 at every (K, N) of ``archs``' packed linears that the
    models in ``checked`` lack: K1 within its bound of the plain version at
    each M of ``ms``; K2 at M 128 == its plain version bit for bit; row 0
    bit-identical across M up to 1024, plain and with x fake-quantized
    (fused, and K2 then K1); the fused W4A4 load == K2 then K1 bit for bit
    at M 1, 4, 12 and 16, x bf16 and f32; K7 on both tp 2 shards (local K =
    K / 2) at M 4 == K1 on the same shard, permuted, plain and fused.
    Returns (largest |error| of K1, rows)."""
    from repro_torch.core.packing import pack_weight, take_shard
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    svs = (5.0, -5.0)
    max_err, rows = 0.0, {}
    for (k, n), models in _gemm_shapes_new(archs, checked).items():
        pw = pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
        mm = dict(m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1])
        err_kn = 0.0
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            got = razer_matmul_cuda(x, pw.codes, pw.scale_meta, **mm) * pw.tensor_scale
            want = ref.razer_matmul_ref(x, pw)
            err = (got - want).abs()
            assert bool((err <= 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6).all()), \
                f"razer_matmul K={k} N={n} M={m}: {float(err.max())}"
            err_kn = max(err_kn, float(err.max()))
        x = (torch.randn((1024, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
        xq = x[:128].contiguous()
        assert torch.equal(razer_act_qdq_cuda(xq, svs).view(torch.int16),
                           ref.razer_act_qdq_ref(xq, svs=svs).view(torch.int16)), f"razer_act_qdq K={k}: not bit-exact"
        for act in ({}, {"act_svs": svs, "fused": True}, {"act_svs": svs, "fused": False}):
            r = [razer_matmul_cuda(x[:m].contiguous(), pw.codes, pw.scale_meta, **mm, **act)[:1] for m in ROW_INVARIANT_M]
            assert all(torch.equal(a, r[0]) for a in r[1:]), f"razer_matmul K={k} N={n} {act}: row 0 moves with M"
        for m in (1, 4, 12, 16):
            for dtype in (torch.bfloat16, torch.float32):
                xm = x[:m].to(dtype)
                two = razer_matmul_cuda(razer_act_qdq_cuda(xm, svs), pw.codes, pw.scale_meta, **mm)
                got = razer_matmul_cuda(xm, pw.codes, pw.scale_meta, act_svs=svs, fused=True, **mm)
                assert torch.equal(got, two), ("fused K1 != K2 then K1", k, n, m, dtype)
        for j in range(2):
            shard = take_shard(pw, tp=2, tp_index=j)
            xs = x[:4, j * k // 2:(j + 1) * k // 2].contiguous()
            for act in ({}, {"act_svs": svs, "fused": True}):
                got = razer_matmul_kshard_cuda(xs, shard.codes, shard.scale_meta, out_chunks=2, **mm, **act)
                one = razer_matmul_cuda(xs, shard.codes, shard.scale_meta, **mm, **act)
                assert torch.equal(_unchunk(got), one), f"K7 K={k} N={n} rank {j} {act}: not K1 permuted"
        rows[f"{k}x{n}"] = {"models": models, "max_abs_err": err_kn}
        max_err = max(max_err, err_kn)
        del pw, x
    torch.cuda.empty_cache()
    detail[key] = rows
    return max_err, rows


def _time_down_rows(dev, gen, detail):
    """K1 on qwen3_32b's and deepseek_coder_33b's down-projections (K 25600
    and 19200) at M 4, 16, 128 and 1024 beside torch.matmul on the
    dequantized bf16 weight and the bound (x, the wire bytes and the f32
    output once; 2 M K N operations): a row across M on the card's widest
    K.  Device time per launch from the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda

    out = {}
    for arch in ("qwen3_32b", "deepseek_coder_33b"):
        cfg = get_config(arch)
        k, n = cfg.d_ff, cfg.d_model
        pw = pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
        dense = pw.dequantize().to(torch.bfloat16)
        mm = dict(m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1])
        for m in (4, 16, 128, 1024):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            bound, by = _bound_ms(m * k * 2 + k * n // 2 + k * n // 16 + m * n * 4, 2 * m * k * n)
            out[f"{arch}_down_{k}x{n}_M{m}"] = _with_device_time(
                {"ms": _cuda_ms(lambda: razer_matmul_cuda(x, pw.codes, pw.scale_meta, **mm)),
                 "library_ms": _cuda_ms(lambda: torch.matmul(x, dense)), "bound_ms": bound, "bound_by": by},
                lambda: razer_matmul_cuda(x, pw.codes, pw.scale_meta, **mm), "gemm_kernel<K1,", 1)
        del pw, dense
    torch.cuda.empty_cache()
    detail["razer_matmul_down_rows"] = out
    return out


def _paper_shapes(dev, gen, detail):
    """Phase 3 at the shapes of the paper's dense models: K1 (with K2 and
    the fused path) at llama3_1_8b's seven linears, timed at M 4 and 128;
    K1/K7 at every new (K, N); K1 rows across M on the 25600- and
    19200-deep down-projections; K2 at K 5120, 7168, 8192, 19200 and 25600;
    K9 and K3-K5 at G 4, 8, 7 and 1 (hd 128); K10 at d 4096, 5120, 7168 and
    on the qk-norm's hd-128 rows.  Returns {check: result}."""
    from repro_torch.configs import get_config

    c8 = get_config("llama3_1_8b")
    out = {"llama3_1_8b_linears": _check_matmul(c8, dev, gen, detail, tag="_llama3_1_8b"),
           "llama3_1_8b_fused_act": _check_fused_act(c8, dev, gen, detail, tag="_llama3_1_8b")}
    torch.cuda.empty_cache()
    out["new_gemm_shapes"] = _check_gemm_shapes(dev, gen, detail)
    out["down_rows_across_M"] = _time_down_rows(dev, gen, detail)
    for arch in ("qwen3_32b", "deepseek_coder_33b"):
        out[f"act_qdq_{arch}"] = _check_act_qdq(get_config(arch), dev, gen, detail, tag=f"_{arch}")
    for arch in ("llama3_1_8b", "qwen3_32b", "deepseek_coder_33b", "llama2_7b"):  # G 4, 8, 7, 1
        cfg = get_config(arch)
        g = f"G{cfg.num_heads // cfg.num_kv_heads}"
        # the serving path's K/V (wire format) and random f32 K/V
        out[f"prefill_attention_{g}"] = _check_prefill_attention(
            cfg, dev, gen, detail, tag=f"_{arch}", timed=((1, 4096, "wire"), (1, 4096, "f32")), kinds=("f32", "wire"))
        # K5 at T = 6: 32 // G queries a launch, so two launches at G 7 and 8
        out[f"decode_attention_{g}"] = _check_attention_long(
            cfg, dev, gen, detail, shapes={"B4_mixed": [4001, 97, 1000, 4096]}, t_verify=6, tag=f"_{arch}")
        torch.cuda.empty_cache()
    for arch in ("llama3_1_8b", "qwen3_32b", "deepseek_coder_33b"):
        out[f"rms_norm_d{get_config(arch).d_model}"] = _check_rms_norm(get_config(arch), dev, gen, detail,
                                                                       tag=f"_{arch}")
    qk = dataclasses.replace(get_config("qwen3_8b"), d_model=get_config("qwen3_8b").hd)
    out["rms_norm_qk_norm_hd128"] = _check_rms_norm(qk, dev, gen, detail, tag="_qk_norm_hd128")
    return out


ZOO_BANK_EXPERTS = 16  # of deepseek_v2_236b's 160: K6's shape is the banks' (K, N), its grid runs E


def _zoo_shapes(dev, gen, detail):
    """Phase 3 at the shapes phase 10 gives the kernels (K9 at MLA's hd 192
    and without the causal mask: ``_check_prefill_attention_zoo``): K1/K7
    (with K2 and the fused W4A4 load) at every (K, N) of the three models'
    packed linears that llama3_2_3b and the paper's dense models lack (MLA's
    q_a, kv_a and wo, the dense first layer's MLP, the shared experts,
    Qwen2-VL's linears, whisper's attention, cross-attention and GELU MLP),
    K1 against its plain version at M 4, 128 and 1500;
    K6 at DeepSeek-V2's expert banks (gate/up K 5120 N 1536, down K 1536 N
    5120; ZOO_BANK_EXPERTS of them); K3 at whisper's heads (8 of hd 64, G
    1); K9 at Qwen2-VL's exact-length prefill (B 4 x 320, 28 / 4 heads, bf16
    K/V) and at whisper's causal decoder prefill (B 1 x 8, hd 64), against
    the plain version within PREFILL_TOL; K10 at d 3584 and 512 and on MLA's
    q_norm (1536) and kv_norm (512) rows.  Returns {check: result}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda

    # M: decode's 4, DeepSeek-V2's prefill (4 x 32) and whisper's encoder (1500 frames)
    out = {"new_gemm_shapes": _check_gemm_shapes(dev, gen, detail, archs=ZOO, checked=("llama3_2_3b",) + PAPER_DENSE,
                                                 key="razer_matmul_zoo_shapes", ms=(4, 128, 1500))}
    torch.cuda.empty_cache()
    banks = _expert_banks(dev, gen, detail, arch="deepseek_v2_236b", experts=ZOO_BANK_EXPERTS,
                          tag="_deepseek_v2_236b")
    out["grouped_matmul_deepseek_v2_236b"] = _check_grouped_matmul(dev, gen, detail, banks, tag="_deepseek_v2_236b")
    del banks
    torch.cuda.empty_cache()
    whisper = get_config("whisper_base")
    out["kv_attention_whisper_base"] = _check_kv_attention(whisper, dev, gen, detail, tag="_whisper_base")
    errs = {}
    for what, (b, s, h, kvh, hd) in {"qwen2_vl_7b_B4_S320": (4, 320, 28, 4, 128),
                                     "whisper_base_decoder_B1_S8": (1, 8, 8, 8, 64)}.items():
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev).to(torch.bfloat16) for n in (h, kvh, kvh))
        got, want = prefill_attention_cuda(q, k, v), ref.chunked_attention_ref(q, k, v)
        errs[what] = _assert_prefill_close(got, want, q, k, v, what)
    out["prefill_attention_causal"] = errs
    detail["prefill_attention_zoo_causal_max_abs_err"] = errs
    ds = get_config("deepseek_v2_236b")
    for tag, cfg in (("_qwen2_vl_7b", get_config("qwen2_vl_7b")), ("_whisper_base", whisper),
                     ("_mla_q_norm", dataclasses.replace(ds, d_model=ds.q_lora_rank)),
                     ("_mla_kv_norm", dataclasses.replace(ds, d_model=ds.kv_lora_rank))):
        out[f"rms_norm_d{cfg.d_model}{tag}"] = _check_rms_norm(cfg, dev, gen, detail, tag=tag)
    return out


RECURRENT = ("recurrentgemma_2b", "mamba2_370m")


def _recurrent_shapes(dev, gen, detail):
    """Phase 3 at the shapes phase 11 gives the kernels (K9 with the window
    at hd 256: ``_check_prefill_attention_window``): K1/K7 (with K2 and the
    fused W4A4 load) at every (K, N) of the two models' packed linears that
    the earlier models lack -- Mamba's in_proj (N 4384, whose last
    128-column block is ragged) and out_proj, RecurrentGemma's MLP and
    RG-LRU projections -- K1 against its plain version at M 4, 128 and 4096
    (Mamba's prefill rows); K10 at d 2560, Mamba's gated norm over d_inner
    2048 and d 1024.  Returns {check: result}."""
    from repro_torch.configs import get_config

    out = {"new_gemm_shapes": _check_gemm_shapes(dev, gen, detail, archs=RECURRENT,
                                                 checked=("llama3_2_3b",) + PAPER_DENSE + ZOO,
                                                 key="razer_matmul_recurrent_shapes", ms=(4, 128, 4096))}
    torch.cuda.empty_cache()
    rg, mamba = get_config("recurrentgemma_2b"), get_config("mamba2_370m")
    for tag, cfg in (("_recurrentgemma_2b", rg), ("_mamba2_gated_norm", dataclasses.replace(
            mamba, d_model=mamba.ssm_expand * mamba.d_model)), ("_mamba2_370m", mamba)):
        out[f"rms_norm_d{cfg.d_model}{tag}"] = _check_rms_norm(cfg, dev, gen, detail, tag=tag)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------
def _policies():
    from repro_torch.core.policy import QuantPolicy, TensorSpec

    w4 = QuantPolicy.packed(kv_quant=True)
    w4a4 = QuantPolicy(weight=w4.weight, act=TensorSpec.act("razer"), kv=w4.kv, rules=w4.rules)
    return {"w4_kv": w4, "w4a4_kv": w4a4}


def _draw_qk_extras(raw, cfg, seed: int = 7):
    """Draw the qkv biases and the qk-norm gains nonzero from a seeded
    torch.Generator on the card, in place: ``init_params`` leaves them zero,
    which would not exercise the bias add or the qk-norm's gain.  A model
    with neither keeps its weights."""
    from repro_torch.models.transformer import layer_groups

    if not (cfg.qkv_bias or cfg.qk_norm):
        return
    dev = raw["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for gi in range(len(layer_groups(cfg))):
        for lp in raw[f"layers_{gi}"]:
            mixer = lp["mixer"]
            for name, std in (("bq", 0.5), ("bk", 0.5), ("bv", 0.5), ("q_norm", 0.2), ("k_norm", 0.2)):
                if name in mixer:
                    mixer[name] = torch.randn(mixer[name].shape, generator=gen, device=dev) * std


def _engines(cfg, dev, max_len: int = 128, policies=None):
    """Random full-width weights (seed 0; nonzero qkv biases and qk-norm
    gains where the model has them) on the card and one Engine per policy
    (``policies``: their names, by default all of ``_policies``), each
    packing them; the engines keep the dense tree for the speculative bf16
    draft.  Returns (engines, seconds spent packing)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    torch.cuda.reset_peak_memory_stats()
    raw = init_params(cfg, seed=0, device=dev)
    _draw_qk_extras(raw, cfg)
    t0 = time.perf_counter()
    engines = {name: Engine(raw, cfg, ServeConfig(max_len=max_len, max_new_tokens=16, quant=policy), device=dev)
               for name, policy in _policies().items() if policies is None or name in policies}
    torch.cuda.synchronize()
    return engines, time.perf_counter() - t0


def _full_width(cfg, engines, detail, pack_s, key="e2e"):
    """Engine.generate at full width under each policy: 4 prompts of 8, 15,
    23 and 32 tokens (seed 0), max_len 128, 16 new tokens, a warm-up run and
    a timed one, with exact launch counts; then a profile of one short
    W4A4 generate."""
    max_len, n_new = 128, 16
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]
    results = {"pack_s_two_engines" if len(engines) == 2 else "pack_s_one_engine": pack_s}
    for name, eng in engines.items():
        policy = eng.policy
        toks = np.zeros((len(prompts), 32), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        last, _ = eng._bucketed_prefill(toks, np.array([len(p) for p in prompts]), max_len=max_len, qdq_kv=True)
        assert last.shape == (len(prompts), cfg.vocab_size) and bool(torch.isfinite(last.float()).all())
        MESHLESS[(cfg.name, name, "prefill_logits")] = last.float().cpu()
        for rep in range(2):  # the first run warms up, the second is timed
            _reset_counts()
            out = eng.generate(prompts)
            counts = _main_path_counts() if rep else _read_counts()
            steps = eng.stats["decode_steps"]
            want = _generate_want(cfg, 1, policy, eng.stats)
            assert counts == want, (name, counts, want)
            assert steps == n_new - 1 and all(len(o) == len(p) + n_new for o, p in zip(out, prompts))
            MESHLESS[(cfg.name, name, "generate")] = out
            assert all(0 <= t < cfg.vocab_size for o in out for t in o)
        st = eng.stats
        results[name] = {
            "prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / steps,
            "tokens_per_s": len(prompts) * n_new / (st["prefill_s"] + st["decode_s"]),
            "launches": counts, "batch": len(prompts), "bucket": st["bucket"], "new_tokens": n_new}
    results["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if "w4a4_kv" in engines:
        eng = engines["w4a4_kv"]
        results["profile_w4a4_kv"] = _profile(lambda: eng.generate(prompts, max_new_tokens=4))
    detail[key] = results
    return results


def _paged_vs_contiguous(cfg, eng, detail, steps: int = 5):
    """Teacher-forced decode at full width, batch 4: one generate prefill's
    K/V written into a paged pool row by row (``write_prefill``, pages
    interleaved across the rows) and into the contiguous packed cache; then
    ``decode_step(pages=...)`` and the contiguous ``decode_step`` fed the
    same tokens.  The logits must be bit-identical: the same ops at the same
    batch, with K4 returning K3's bits."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig

    max_len = 128
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), 32), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    last, caches = eng._bucketed_prefill(toks, lens, max_len=max_len, qdq_kv=True)
    pool = KVPagePool(cfg, PagePoolConfig(num_pages=4 * (max_len // 16), page_size=16, max_len=max_len),
                      device=eng.device)
    for i in range(len(prompts)):
        pool.allocate(i, 1)
    for n in range(2, max_len // 16 + 1):  # grow the rows in turn: pages interleave
        for i in range(len(prompts)):
            pool.append(i, 16 * n)
    for i, n in enumerate(lens):
        pool.write_prefill(i, [{"k": c["k"][i:i + 1], "v": c["v"][i:i + 1]} for c in caches], int(n))
    contiguous = eng._quantize_caches(caches)
    table = pool.page_table(list(range(len(prompts))))
    cur = torch.as_tensor(lens, device=eng.device)
    tok = torch.argmax(last, dim=-1)
    _reset_counts()
    with torch.no_grad():
        for step in range(steps):
            want, contiguous = tf.decode_step(eng.params, tok, contiguous, cur, cfg, eng.policy)
            got, _ = tf.decode_step(eng.params, tok, pool.layers, cur, cfg, eng.policy, pages=table)
            assert torch.equal(got, want), f"paged decode logits differ from contiguous at step {step}"
            tok = torch.argmax(want, dim=-1)
            cur = cur + 1
    counts = _read_counts()
    assert counts["paged_kv_attention"] == counts["razer_kv_attention"] == cfg.num_layers * steps, counts
    out = {"steps": steps, "batch": len(prompts), "logits_bit_identical": True, "launches": counts}
    detail["paged_vs_contiguous"] = out
    return out


def _span_ms(tracer, name):
    """Mean milliseconds of a tracer's ``name`` spans (B/E pairs)."""
    starts, total, n = [], 0.0, 0
    for ph, ev, ts, *_ in tracer.events:
        if ev != name:
            continue
        if ph == "B":
            starts.append(ts)
        elif ph == "E":
            total += ts - starts.pop()
            n += 1
    return total * 1e3 / n if n else 0.0


def _serve_requests(cfg, n_new):
    """8 requests of 8..100 tokens (seed 0); request 6 shares its first 40
    tokens with request 5, so the prefix cache hits mid-page (COW fork)."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32, 40, 57, 64, 100)]
    prompts[6][:40] = prompts[5][:40]
    return [Request(rid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]


def _gap_at(eng, prompt, ref_tokens, step):
    """Top-2 logit gap of a reference continuation at ``step``, replayed
    teacher-forced for this prompt alone through the contiguous path."""
    from repro_torch.models import transformer as tf

    s = len(prompt)
    toks = np.zeros((1, eng._bucket(s)), np.int64)
    toks[0, :s] = prompt
    logits, caches = eng._bucketed_prefill(toks, np.array([s]), max_len=eng.scfg.max_len, qdq_kv=True)
    caches = eng._quantize_caches(caches)
    cur = torch.tensor([s], device=eng.device)
    with torch.no_grad():
        for t in range(step):
            logits, caches = tf.decode_step(eng.params, torch.tensor([ref_tokens[t]], device=eng.device), caches,
                                            cur, eng.cfg, eng.policy)
            cur = cur + 1
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def _agreement(eng, reqs, ref_outputs):
    """Share of requests whose new tokens equal the reference's; for each
    that differs, the first differing step and the reference's top-2 gap."""
    diffs = []
    for r, ref_out in zip(reqs, ref_outputs):
        ref_new = ref_out[len(r.prompt):]
        if list(r.out_tokens) != list(ref_new):
            step = next(i for i, (a, b) in enumerate(zip(r.out_tokens, ref_new)) if a != b)
            diffs.append({"rid": r.rid, "step": step, "ref_top2_gap": _gap_at(eng, r.prompt, ref_new, step)})
    return (len(reqs) - len(diffs)) / len(reqs), diffs


def _serve_full_width(cfg, engines, detail, key="serve", runs=None, equal_to_generate=True):
    """Engine.serve at full width: 8 requests over 4 slots, max_len 256,
    pages of 16, 16 new tokens, prefix cache on.  ``runs`` maps an engine's
    name to its (speculate_k, draft_policy) runs, by default vanilla, then
    speculate_k=2 with a bf16 draft (draft None: the default nvfp4
    fakequant draft).  Launch counts are checked exactly: K4 = layers x
    (decode + draft steps), K5 = layers x verify steps, K3 = 0, K1 (and K2
    under W4A4) and K6 = their per-forward counts x (prefill passes + target
    decode/verify passes).  Each run records its peak device memory.

    ``equal_to_generate`` asserts serve == generate (and speculative ==
    vanilla) for every request, where the port's row-invariant prefill (K9,
    K10) and decode make it hold on the card: the dense models under both
    policies, vanilla and speculative.  dbrx's shares are reported: at
    capacity factor 1.25 capacity drops depend on the dispatch groups."""
    from repro_torch.obs import Tracer
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    n_new, slots, max_len, ps = 16, 4, 256, 16
    pool_cfg = PagePoolConfig(num_pages=slots * (max_len // ps), page_size=ps, max_len=max_len)
    sched_cfg = SchedulerConfig(max_slots=slots)
    out = {}
    peak = torch.cuda.max_memory_allocated()  # since the caller's reset: engines and generate
    for name, eng in engines.items():
        eng.serve(_serve_requests(cfg, 2)[:2], sched_cfg=sched_cfg, pool_cfg=pool_cfg)  # warm-up
        ref = eng.generate([r.prompt for r in _serve_requests(cfg, n_new)], max_new_tokens=n_new)
        MESHLESS[(cfg.name, name, "generate_serve_prompts")] = ref
        vanilla = None
        for k, draft in (runs or {}).get(name, ((0, None), (2, "bf16"))):
            reqs = _serve_requests(cfg, n_new)
            tracer = Tracer()
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            rep = eng.serve(reqs, sched_cfg=sched_cfg, pool_cfg=pool_cfg, speculate_k=k,
                            draft_policy=draft, trace=tracer)
            torch.cuda.synchronize()
            counts = _main_path_counts()
            assert all(r.state == "finished" and len(r.out_tokens) == n_new for r in rep.requests)
            assert all(0 <= t < cfg.vocab_size for o in rep.outputs for t in o)
            want = _serve_want(cfg, 1, eng.policy, _serve_prefill_m(eng, rep.requests), rep.decode_steps, k,
                               rep.draft_steps, slots)
            assert counts == want, (name, k, counts, want)
            assert rep.cache_hits >= 1 and rep.requests[6].cached_tokens == 40, \
                (rep.cache_hits, rep.requests[6].cached_tokens)
            same_gen, gen_diffs = _agreement(eng, rep.requests, ref)
            if equal_to_generate:
                assert same_gen == 1.0, ("serve != generate", cfg.name, name, k, gen_diffs)
            row = {"tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_time,
                   "ttft_p50_s": rep.ttft_p50, "ttft_p95_s": rep.ttft_p95,
                   "decode_steps": rep.decode_steps, "prefill_tokens": rep.prefill_tokens,
                   "cached_tokens": rep.cached_tokens, "peak_pages": rep.peak_pages, "peak_slots": rep.peak_slots,
                   "cache_hit_rate": rep.cache_hit_rate, "accept_rate": rep.accept_rate,
                   "share_equal_to_generate": same_gen, "differs_from_generate": gen_diffs,
                   "launches": counts, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if k:
                row["draft_ms_per_iteration"] = _span_ms(tracer, "draft")
                row["verify_ms_per_iteration"] = _span_ms(tracer, "verify")
                row["draft_steps"] = rep.draft_steps
                share, diffs = _agreement(eng, rep.requests, vanilla)
                row["share_equal_to_vanilla_serve"], row["differs_from_vanilla_serve"] = share, diffs
                if equal_to_generate:
                    assert share == 1.0, ("speculative != vanilla serve", cfg.name, name, k, diffs)
            else:
                row["decode_ms_per_step"] = _span_ms(tracer, "decode_step")
                vanilla = rep.outputs
                MESHLESS[(cfg.name, name, "serve")] = rep.outputs
            out[f"{name}_k{k}" + ("_nvfp4_draft" if k and draft is None else "")] = row
            eng._spec_cache.clear()  # free the draft tree before the next run
    out["max_memory_allocated_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    if "w4a4_kv" in engines:
        eng = engines["w4a4_kv"]
        out["profile_w4a4_kv_serve"] = _profile(lambda: eng.serve(
            _serve_requests(cfg, 4)[:4], sched_cfg=sched_cfg, pool_cfg=pool_cfg))
    detail[key] = out
    return out


def _profile(run):
    """Device time by kernel over one ``run()`` (a generate of prefill + 3
    decode steps, or a short serve), from torch.profiler, the share of the
    wall time the device was idle and the decode-attention kernels' (K3,
    K4, K5) share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]  # kernels, not ops
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    attention_ms = sum(e.self_device_time_total for e in events if "kv_attention_kernel" in e.key) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "attention_ms": attention_ms, "attention_share_of_device": attention_ms / device_ms if device_ms else 0.0,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in top]}


def _long_prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(k)).tolist() for k in rng.integers(lo, hi + 1, size=n)]


def _long_context(cfg, eng, lo=1024, hi=3968, n_new=32, ps=16):
    """Phase 4e: long-context decode at full width.  ``eng``: an engine whose
    ServeConfig.max_len holds hi + n_new (4096 here).  generate: B 4 prompts
    of lo..hi random tokens (seed 2), n_new new tokens; serve: 8 requests of
    lo..hi tokens (seed 3) over 4 slots, pages of 16, prefix cache on.  Exact
    launch counts; decode ms per step; torch.profiler's device ms, idle share
    and decode-attention share per decode step (a generate of the same
    prompts, and a serve of 4 of the requests, with 5 new tokens less one
    with 1); the share of requests whose serve tokens equal a batch-8
    generate's, with the first differing step and the generate's top-2
    logit gap there for each that differs; torch.profiler's wall ms, device
    ms and idle share of generate's prefill (a generate of 1 new token) and
    of serve's prefill of its longest prompt alone, and each request's TTFT
    with the mean prefill span of serve."""
    from repro_torch.obs import Tracer
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import Request, SchedulerConfig

    gen_prompts, serve_prompts = _long_prompts(cfg, 4, lo, hi, 2), _long_prompts(cfg, 8, lo, hi, 3)
    out = {"generate_prompt_lens": [len(p) for p in gen_prompts],
           "serve_prompt_lens": [len(p) for p in serve_prompts], "new_tokens": n_new,
           "max_len": eng.scfg.max_len}
    eng.generate(gen_prompts[:1], max_new_tokens=2)  # warm-up
    _reset_counts()
    toks = eng.generate(gen_prompts, max_new_tokens=n_new)
    counts = _main_path_counts()
    steps = eng.stats["decode_steps"]
    assert counts == _generate_want(cfg, 1, eng.policy, eng.stats), counts
    assert all(len(o) == len(p) + n_new for o, p in zip(toks, gen_prompts))
    st = eng.stats
    out["generate"] = {"prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / steps,
                       "decode_steps": steps, "launches": counts,
                       "profile_decode_per_step": _decode_profile(lambda n: eng.generate(gen_prompts, max_new_tokens=n)),
                       "profile_prefill": _profile(lambda: eng.generate(gen_prompts, max_new_tokens=1))}
    ref = eng.generate(serve_prompts, max_new_tokens=n_new)
    sched_cfg = SchedulerConfig(max_slots=4)
    pool_cfg = PagePoolConfig(num_pages=4 * (eng.scfg.max_len // ps), page_size=ps, max_len=eng.scfg.max_len)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(serve_prompts)]
    tracer = Tracer()
    torch.cuda.synchronize()
    _reset_counts()
    rep = eng.serve(reqs, sched_cfg=sched_cfg, pool_cfg=pool_cfg, trace=tracer)
    torch.cuda.synchronize()
    counts = _main_path_counts()
    assert all(r.state == "finished" and len(r.out_tokens) == n_new for r in rep.requests)
    want = _serve_want(cfg, 1, eng.policy, _serve_prefill_m(eng, rep.requests), rep.decode_steps)
    assert counts == want, (counts, want)
    longest = max(serve_prompts, key=len)
    out["serve"] = {"tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_time, "ttft_p50_s": rep.ttft_p50,
                    "ttft_p95_s": rep.ttft_p95, "ttft_s": rep.ttft_values(), "decode_steps": rep.decode_steps,
                    "prefill_ms_per_request": _span_ms(tracer, "prefill"),
                    "profile_prefill_longest": dict(_profile(lambda: eng._serve_prefill(longest)),
                                                    prompt_len=len(longest)),
                    "decode_ms_per_step": _span_ms(tracer, "decode_step"), "launches": counts,
                    "profile_decode_per_step": _decode_profile(lambda n: eng.serve(
                        [Request(rid=i, prompt=p, max_new_tokens=n) for i, p in enumerate(serve_prompts[:4])],
                        sched_cfg=sched_cfg, pool_cfg=pool_cfg))}
    share, diffs = _agreement(eng, rep.requests, ref)
    out["serve"].update(share_equal_to_generate=share, differs_from_generate=diffs)
    MESHLESS[(cfg.name, "serve_long")] = rep.outputs
    return out


def _decode_profile(run, n: int = 5):
    """Per decode step of ``run(k)`` (k new tokens): the difference between
    a profile of run(n) and one of run(1), over n - 1 steps -- so the
    prefill drops out: wall ms, device ms, idle share, decode-attention ms
    and its share of the device time."""
    one, many = _profile(lambda: run(1)), _profile(lambda: run(n))
    per = {k: (many[k] - one[k]) / (n - 1) for k in ("wall_ms", "device_ms", "attention_ms")}
    per["idle_share"] = 1.0 - per["device_ms"] / per["wall_ms"]
    per["attention_share_of_device"] = per["attention_ms"] / per["device_ms"]
    return per


def _dbrx_full_width(dev, detail):
    """Phase 4d: dbrx_132b at its published widths, cut to 2 of its 40
    layers (the dense f32 tree the engines keep for the draft is 13 GB per
    MoE layer), through generate and vanilla serve under both policies, and
    under W4 + KV serve with speculate_k=2 and a bf16 draft and the default
    nvfp4 fakequant draft (which re-quantizes every expert bank at every
    draft forward).  Then a control: the same weights at capacity factor
    n_experts / topk, where an expert's capacity is its whole dispatch
    group, so no slot is dropped, through generate, vanilla serve and serve
    with speculate_k=2 and a bf16 draft."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("dbrx_132b"), num_layers=2)
    engines, pack_s = _engines(cfg, dev)
    cut = {"num_layers": [40, 2]}
    e2e = _full_width(cfg, engines, detail, pack_s, key="e2e_dbrx")
    e2e["cut"] = cut
    print("e2e dbrx_132b full width, cut num_layers 40 -> 2: " + json.dumps(e2e))
    serve = _serve_full_width(cfg, engines, detail, key="serve_dbrx", runs={
        "w4_kv": ((0, None), (2, "bf16"), (2, None)), "w4a4_kv": ((0, None),)}, equal_to_generate=False)
    serve["cut"] = cut
    print("serve dbrx_132b full width, cut num_layers 40 -> 2: " + json.dumps(serve))

    raw = engines["w4_kv"]._raw_params
    del engines
    torch.cuda.empty_cache()
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.topk)
    eng = Engine(raw, no_drop, ServeConfig(max_len=128, max_new_tokens=16, quant=_policies()["w4_kv"]), device=dev)
    control = _serve_full_width(no_drop, {"w4_kv": eng}, detail, key="serve_dbrx_no_drop",
                                runs={"w4_kv": ((0, None), (2, "bf16"))}, equal_to_generate=False)
    control["cut"], control["capacity_factor"] = cut, no_drop.capacity_factor
    print("serve dbrx_132b full width, no capacity drops (capacity factor "
          f"{no_drop.capacity_factor}), cut num_layers 40 -> 2: " + json.dumps(control))


def _llama_phase4(cfg, engines, detail, pack_s):
    """Phases 4, 4b and 4c on llama3_2_3b's engines (``cfg``: the full
    width at the depth the script runs, ``LLAMA_CUT_LAYERS``):
    generate with exact launch counts and a profile, paged vs contiguous
    decode, the W4A4 decode forward's launches, then serve."""
    e2e = _full_width(cfg, engines, detail, pack_s)
    print(f"e2e llama3_2_3b full width, {cfg.num_layers} layers: " + json.dumps(e2e))
    paged = _paged_vs_contiguous(cfg, engines["w4_kv"], detail)
    print("paged vs contiguous decode (full width, teacher-forced): " + json.dumps(paged))
    print("W4A4 decode forward, llama3_2_3b full width, launches: "
          + json.dumps(_decode_forward_counts(cfg, engines["w4a4_kv"], detail)))
    serve = _serve_full_width(cfg, engines, detail)
    print(f"serve llama3_2_3b full width, {cfg.num_layers} layers: " + json.dumps(serve))


# ---------------------------------------------------------------------------
# phase 4f: disaggregated serving
# ---------------------------------------------------------------------------
DISAGG_FLEET = dict(n_prefill=2, n_decode=2, max_slots=4, page_size=16)

# phases 4e, 4f and 6b run llama3_2_3b at full width cut to this many of its
# 28 layers, from the same seed-0 weights: at full depth the script took
# 1212 s of its 1200 s limit on a slow host once phase 8 was added (PR 20);
# the three are host-bound and scale with depth.  Phases 4, 4b, 4c and 6a
# run at this depth too, their room given to phase 12 (f), and 7 -> 4 paid
# for phase 9's weight SV sweeps and GPTQ: on an NVIDIA H100 80GB HBM3 at
# 700 W phases 4, 4b and 4c took 205.0 s at 28 layers, 50.0 s at 7 and
# 21.2 s at 4 (tools/phase_depth_cost.py --part llama4)
LLAMA_CUT_LAYERS = 4


def _llama_cut_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3_2_3b"), num_layers=LLAMA_CUT_LAYERS)


def _serve_outputs(cfg, eng):
    """Outputs of phase 4c's serve (8 requests, 4 slots, 16 new tokens) on
    ``eng``: the single-engine reference of phase 4f at its depth."""
    sched_cfg, pool_cfg = _serve_cfgs()
    return eng.serve(_serve_requests(cfg, 16), sched_cfg=sched_cfg, pool_cfg=pool_cfg).outputs


def _run_disagg(cfg, eng, reqs, want, chunk_tokens):
    """serve_disagg of ``reqs`` on the fleet with a Tracer: outputs ==
    ``want`` (single-engine serve's), the shipped bytes 0.28125 of bf16 and
    each shipment's bytes == its prompt's pages x the pool's page bytes (the
    prefill and decode pools share the arch and the page size).  Returns
    the report's row."""
    from repro_torch.obs import Tracer
    from repro_torch.serving.disagg import serve_disagg

    tracer = Tracer()
    torch.cuda.synchronize()
    _reset_counts()
    rep = serve_disagg(eng, reqs, chunk_tokens=chunk_tokens, trace=tracer, **DISAGG_FLEET)
    torch.cuda.synchronize()
    counts = _main_path_counts()
    share = _share_equal(rep.outputs, want)
    assert share == 1.0, ("disagg != serve", cfg.name, eng.policy.act is not None, chunk_tokens, share)
    assert rep.transfer_ratio == 0.28125, rep.transfer_ratio
    ps = DISAGG_FLEET["page_size"]
    lens = {r.rid: len(r.prompt) for r in rep.requests}
    ships = [attrs for ph, name, ts, pid, tid, attrs in tracer.events if name == "ship"]
    assert len(ships) == len(reqs) == rep.shipments
    assert all(a["nbytes"] == -(-lens[a["rid"]] // ps) * rep.page_bytes for a in ships), ships
    MESHLESS[(cfg.name, "disagg", eng.policy.act is not None, chunk_tokens)] = rep.outputs
    return {"chunk_tokens": chunk_tokens, "share_equal_to_serve": share, "transfer_ratio": rep.transfer_ratio,
            "shipment_bytes": [a["nbytes"] for a in ships], "transfer_bytes": rep.transfer_bytes,
            "transfer_bf16_bytes": rep.transfer_bf16_bytes, "page_bytes": rep.page_bytes,
            "prefill_tokens_per_s": rep.prefill_tokens_per_s, "decode_tokens_per_s": rep.decode_tokens_per_s,
            "ttft_p50_s": rep.ttft_p50, "ttft_p95_s": rep.ttft_p95, "makespan_s": rep.wall_time,
            "decode_stage_p50_s": rep.decode_stage_percentile(50), "prefill_busy_s": rep.prefill_busy,
            "decode_busy_s": rep.decode_busy, "decode_steps": rep.decode_steps, "cached_tokens": rep.cached_tokens,
            "router_hit_rate": rep.router_hit_rate, "launches": counts}


def _disagg_metrics(cfg, eng, plain, chunk_tokens):
    """Phase 8 (d): ``serve_disagg(metrics=)`` of phase 4c's 8 requests on
    the fleet: outputs == the run without metrics (``plain``'s, just
    before), the shipment and transfer-byte counters == the report's, and
    one pool series per replica and state.  Returns the registry's numbers
    beside the run's makespan and decode-stage rate."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.disagg import serve_disagg

    reg = MetricsRegistry()
    torch.cuda.synchronize()
    _reset_counts()
    rep = serve_disagg(eng, _serve_requests(cfg, 16), chunk_tokens=chunk_tokens, metrics=reg, **DISAGG_FLEET)
    torch.cuda.synchronize()
    _main_path_counts()
    assert rep.outputs == MESHLESS[(cfg.name, "disagg", eng.policy.act is not None, chunk_tokens)], \
        "disagg outputs moved with metrics on"
    snap = reg.snapshot()
    value = lambda name: snap[name]["series"][0]["value"]  # noqa: E731
    assert value("disagg_shipments_total") == rep.shipments == 8, (value("disagg_shipments_total"), rep.shipments)
    assert value("disagg_transfer_bytes_total") == rep.transfer_bytes, value("disagg_transfer_bytes_total")
    assert snap["serve_tokens_total"]["series"][0]["value"] == rep.new_tokens
    assert len(snap["pool_pages"]["series"]) == 3 * (DISAGG_FLEET["n_prefill"] + DISAGG_FLEET["n_decode"])
    busy = {s["labels"]["stage"]: s["value"] for s in snap["stage_busy_seconds"]["series"]}
    return {"outputs_equal_without_metrics": True, "disagg_shipments_total": value("disagg_shipments_total"),
            "disagg_transfer_bytes_total": value("disagg_transfer_bytes_total"), "stage_busy_seconds": busy,
            "ttft_p50_s": snap["serve_ttft_seconds"]["series"][0]["p50"], "makespan_s": rep.wall_time,
            "decode_tokens_per_s": rep.decode_tokens_per_s,
            "plain_makespan_s": plain["makespan_s"], "plain_decode_tokens_per_s": plain["decode_tokens_per_s"]}


def _shipment_round_trip(cfg, eng, prompt, reps: int = 5):
    """Device -> host -> device ms of one shipment: ``prompt`` prefilled
    into one pool, its pages exported to the host and imported into another
    pool (a device sync ends each), the bytes landing equal."""
    from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig

    ps = DISAGG_FLEET["page_size"]
    pool_cfg = PagePoolConfig(num_pages=2 * (eng.scfg.max_len // ps), page_size=ps, max_len=eng.scfg.max_len)
    src, dst = (KVPagePool(cfg, pool_cfg, device=eng.device) for _ in range(2))
    pages = src.allocate(0, len(prompt))
    _, caches = eng._serve_prefill(prompt)
    src.write_prefill(0, caches, len(prompt))
    d2h, h2d = [], []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ship = src.export_pages(0)
        t1 = time.perf_counter()
        got = dst.import_pages(ship, seq_id=i)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d2h.append((t1 - t0) * 1e3)
        h2d.append((t2 - t1) * 1e3)
        for a, b in zip(src.caches, dst.caches):
            for name in a:
                assert torch.equal(a[name][:, pages], b[name][:, got[:len(pages)]]), "shipment bytes moved"
        dst.release(i)
    return {"prompt_len": len(prompt), "pages": len(pages), "nbytes": ship.nbytes, "bf16_bytes": ship.bf16_bytes,
            "device_to_host_ms": d2h, "host_to_device_ms": h2d}


def _disagg(cfg, engines, detail):
    """Phase 4f: phase 4c's 8 requests (16 new tokens) under both policies
    through serve_disagg on 2 prefill + 2 decode replicas of 4 slots on the
    one card, at chunk_tokens 64 and 16: outputs == the same engine's
    single-engine serve of them, the transfer ratio 0.28125 and each shipment's
    bytes its pages'; prefill and decode-stage tokens/s, TTFT p50/p95, the
    makespan and the shipments; and one shipment's device -> host -> device
    ms (the 100-token prompt)."""
    out = {"num_layers": cfg.num_layers}
    for name, eng in engines.items():
        want = _serve_outputs(cfg, eng)
        for chunk in (64, 16):
            out[f"{name}_chunk{chunk}"] = _run_disagg(cfg, eng, _serve_requests(cfg, 16), want, chunk)
    out["w4_kv_chunk64_metrics"] = _disagg_metrics(cfg, engines["w4_kv"], out["w4_kv_chunk64"], 64)
    out["shipment_round_trip"] = _shipment_round_trip(cfg, engines["w4_kv"], _serve_requests(cfg, 1)[7].prompt)
    out["fleet"] = DISAGG_FLEET
    detail["disagg"] = out
    return out


def _disagg_long(cfg, eng, detail, long_context, chunk_tokens=512, n_new=32):
    """Phase 4f on phase 4e's 8 long requests (W4 + KV, max_len 4096, 32 new
    tokens) at chunk_tokens 512: outputs == phase 4e's single-engine serve,
    and the decode stage's tokens/s beside the single-engine serve's."""
    from repro_torch.serving.scheduler import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(_long_prompts(cfg, 8, 1024, 3968, 3))]
    row = _run_disagg(cfg, eng, reqs, MESHLESS[(cfg.name, "serve_long")], chunk_tokens)
    single = long_context["serve"]
    row.update(single_serve_tokens_per_s=single["tokens_per_s"],
               single_serve_decode_ms_per_step=single["decode_ms_per_step"],
               single_serve_ttft_p50_s=single["ttft_p50_s"], single_serve_ttft_p95_s=single["ttft_p95_s"])
    detail["disagg_long"] = row
    return row


# ---------------------------------------------------------------------------
# phase 7: the paper's dense models at full width
# ---------------------------------------------------------------------------
PAPER_CUT = ("llama2_7b", "qwen3_8b", "qwen3_32b", "codeqwen1_5_7b", "deepseek_coder_33b")
# llama3_1_8b's W4 + KV generate and serve, and phases 8 and 9 on its
# engines, run its first 8 of 32 layers: the room went to phase 12 (d)
# and (e), phase 3's wide backward rows and their nvcc build (32 -> 16),
# and to phase 12 (f) (16 -> 8; tools/phase_depth_cost.py --part w4); its W4A4 + KV ones
# run the first 4 (the room went to phase 11 (32 ->
# 16) and to phase 12 and phase 3's backward checks (16 -> 4,
# tools/phase_depth_cost.py --depths 16 4)); phase 7's clock keeps what
# each part takes
LLAMA8B_W4_LAYERS = 8
LLAMA8B_W4A4_LAYERS = 4


def _llama8b_w4_part(cfg, n, dev, detail):
    """Phase 7's llama3_1_8b W4 + KV part on the first ``n`` layers: random
    full-width weights (``_engines``) packed, ``_full_width`` (generate with
    exact launch counts), ``_serve_full_width`` (vanilla and speculate_k=2
    with a bf16 draft, serve == generate asserted), then phase 8
    (``_observability``) and phase 9 (``_toolkit``) on those engines.  ->
    (generate row, serve row, engines, host-clock seconds: generate and
    serve part, phase 8, phase 9, total)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=n)
    engines, pack_s = _engines(cfg, dev, policies=("w4_kv",))
    e2e = _full_width(cfg, engines, detail, pack_s, key="paper_llama3_1_8b_generate")
    serve = _serve_full_width(cfg, engines, detail, key="paper_llama3_1_8b_serve",
                              runs={"w4_kv": ((0, None), (2, "bf16"))})
    t1 = time.perf_counter()
    obs = _observability(cfg, engines, detail)
    print(f"observability, llama3_1_8b full width, {n} layers: " + json.dumps(obs))
    t2 = time.perf_counter()
    toolkit = _toolkit(cfg, engines, detail, dev)
    print(f"quantization toolkit, llama3_1_8b full width ({n} layers), layer 0: " + json.dumps(toolkit))
    t3 = time.perf_counter()
    return e2e, serve, engines, {"generate_serve_s": t1 - t0, "observability_s": t2 - t1, "toolkit_s": t3 - t2,
                                 "total_s": t3 - t0}


def _llama8b_w4a4_part(raw, cfg, n, dev, detail):
    """Phase 7's llama3_1_8b W4A4 + KV part on the first ``n`` layers of the
    dense tree ``raw``: pack them, ``_full_width`` (a warm-up and a timed
    generate with exact launch counts, a profiled short generate) and
    ``_serve_full_width`` (vanilla serve, serve == generate asserted).
    -> (generate row, serve row, host-clock seconds: packing, generate
    part, serve part, total)."""
    from repro_torch.serving.engine import Engine, ServeConfig

    t0 = time.perf_counter()
    cut_cfg = dataclasses.replace(cfg, num_layers=n)
    eng = {"w4a4_kv": Engine({**raw, "layers_0": raw["layers_0"][:n]}, cut_cfg,
                             ServeConfig(max_len=128, max_new_tokens=16, quant=_policies()["w4a4_kv"]), device=dev)}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e2e = _full_width(cut_cfg, eng, detail, t1 - t0, key="paper_llama3_1_8b_w4a4_cut_generate")
    t2 = time.perf_counter()
    serve = _serve_full_width(cut_cfg, eng, detail, key="paper_llama3_1_8b_w4a4_cut_serve",
                              runs={"w4a4_kv": ((0, None),)})
    t3 = time.perf_counter()
    e2e["num_layers"] = [cfg.num_layers, n]
    del eng
    torch.cuda.empty_cache()
    return e2e, serve, {"pack_s": t1 - t0, "generate_s": t2 - t1, "serve_s": t3 - t2, "total_s": t3 - t0}


def _paper_models(dev, detail):
    """Phase 7: llama3_1_8b at full width cut to ``LLAMA8B_W4_LAYERS`` of
    its 32 layers (``_llama8b_w4_part``, phases 8 and 9 inside it), then
    the other five dense models of the paper's evaluation at full width cut
    to 2 layers, random weights (seed 0) with the qkv biases and qk-norm
    gains drawn nonzero, each under W4 + KV and W4A4 + KV: generate of
    phase 4's prompts and serve of phase 4c's 8 requests over 4 slots
    (llama3_1_8b also with speculate_k=2 and a bf16 draft under W4 + KV),
    exact launch counts, serve == generate asserted for every request,
    times, the device idle share and peak memory.  Each model's engines are
    freed before the next."""
    from repro_torch.configs import get_config

    out = {}
    for arch in ("llama3_1_8b",) + PAPER_CUT:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if arch in PAPER_CUT:
            cut = {"num_layers": [cfg.num_layers, 2]}
            cfg = dataclasses.replace(cfg, num_layers=2)
            engines, pack_s = _engines(cfg, dev)
            e2e = _full_width(cfg, engines, detail, pack_s, key=f"paper_{arch}_generate")
            serve = _serve_full_width(cfg, engines, detail, key=f"paper_{arch}_serve",
                                      runs={name: ((0, None),) for name in engines})
        else:
            # llama3_1_8b: vanilla and speculative under W4 + KV on its first
            # LLAMA8B_W4_LAYERS layers, phases 8 and 9 on those engines; vanilla
            # W4A4 + KV on its first LLAMA8B_W4A4_LAYERS layers, from the same
            # weights (W4A4 speculation runs in phase 4c on llama3_2_3b)
            cut = {"num_layers": [cfg.num_layers, LLAMA8B_W4_LAYERS]}
            e2e, serve, engines, secs = _llama8b_w4_part(cfg, LLAMA8B_W4_LAYERS, dev, detail)
            detail["phase_s"]["8 observability (inside 7)"] = secs["observability_s"]
            detail["phase_s"]["9 quantization toolkit (inside 7)"] = secs["toolkit_s"]
            e2e["w4a4_kv_cut"], serve["w4a4_kv_cut"], secs = _llama8b_w4a4_part(
                engines["w4_kv"]._raw_params, cfg, LLAMA8B_W4A4_LAYERS, dev, detail)
            detail["phase_s"][f"7 llama3_1_8b W4A4 + KV at {LLAMA8B_W4A4_LAYERS} layers (inside 7)"] = secs["total_s"]
        row = {"generate": e2e, "serve": serve, "cut": cut}
        print(f"paper model {arch} full width, cut num_layers {cut['num_layers'][0]} -> {cut['num_layers'][1]}: "
              + json.dumps(row))
        detail["phase_s"][f"7 {arch} (inside 7)"] = time.perf_counter() - t_arch
        out[arch] = row
        del engines, e2e, serve
        torch.cuda.empty_cache()
    detail["paper_models"] = {arch: {"cut": row["cut"]} for arch, row in out.items()}
    return out


# ---------------------------------------------------------------------------
# phase 8: observability (inside phase 7, on llama3_1_8b's engines)
# ---------------------------------------------------------------------------
def _check_trace_tool():
    """``tools/check_trace.py`` of this checkout (it imports no JAX)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "tools" / "check_trace.py"
    spec = importlib.util.spec_from_file_location("check_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quantized_params(cfg):
    """The weights the packed policy quantizes: every layer's 4 attention
    and 3 MLP linears (a dense model: one layer group)."""
    d, hd = cfg.d_model, cfg.hd
    per_layer = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + 3 * d * cfg.d_ff
    return 7, cfg.num_layers * per_layer


def _audit_full_width(cfg, eng):
    """Phase 8 (a): ``Engine.quant_audit`` of the W4 + KV engine on the card,
    with metrics and trace sinks; then layer 0's wq and down audited again
    on the CPU from the same raw and packed tensors."""
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.obs.numerics import razer_audit, validate_report

    reg, tracer = MetricsRegistry(), Tracer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.quant_audit(model=cfg.name, metrics=reg, trace=tracer)
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    roll = rep["rollups"]
    assert validate_report(rep) == [], validate_report(rep)
    n_paths, n_params = _quantized_params(cfg)
    assert (roll["layers_audited"], roll["params_quantized"]) == (n_paths, n_params), roll
    assert roll["max_drift"] == 0.0, roll["max_drift"]
    assert all(l["entries"] == cfg.num_layers and l["container"] == "PackedRazerWeight" for l in rep["layers"])
    assert len([e for e in tracer.events if e[1] == "quant_audit"]) == n_paths
    select = [sum(l["sv"]["select_hist"][i] for l in rep["layers"]) for i in range(4)]
    spec = eng.policy.weight
    layer_raw, layer_packed = eng._raw_params["layers_0"][0], eng.params["layers_0"][0]
    card_vs_cpu = {}
    for group, name in (("mixer", "wq"), ("mlp", "down")):
        raw, packed = layer_raw[group][name], layer_packed[group][name]
        t1 = time.perf_counter()
        card = razer_audit(packed, raw, spec)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu = razer_audit(packed.to("cpu"), raw.cpu(), spec)
        cpu_s = time.perf_counter() - t1
        assert card["drift_max_abs"] == cpu["drift_max_abs"] == 0.0
        for key, want in cpu.items():
            got = card[key]
            floats = {k for k, v in (want.items() if isinstance(want, dict) else ()) if isinstance(v, float)}
            if isinstance(want, float):
                assert abs(got - want) <= 1e-7 * abs(want), (name, key, got, want)
            elif floats:
                assert {k: v for k, v in got.items() if k not in floats} == \
                    {k: v for k, v in want.items() if k not in floats}, (name, key)
                assert all(abs(got[k] - want[k]) <= 1e-7 * abs(want[k]) for k in floats), (name, key, got, want)
            else:
                assert got == want, (name, key, got, want)
        card_vs_cpu[f"layers_0/{group}/{name}"] = {"shape": list(raw.shape), "card_s": card_s, "cpu_s": cpu_s,
                                                  "sqnr_db": card["sqnr_db"], "cpu_sqnr_db": cpu["sqnr_db"]}
    return {"audit_s": audit_s, "layers_audited": roll["layers_audited"],
            "params_quantized": roll["params_quantized"], "wire_bytes": roll["wire_bytes"],
            "sv_block_rate": roll["sv_block_rate"], "min_sqnr_db": roll["min_sqnr_db"],
            "mean_sqnr_db": roll["mean_sqnr_db"], "worst_layer": roll["worst_layer"], "max_drift": roll["max_drift"],
            "clipped_blocks": roll["clipped_blocks"], "underflow_blocks": roll["underflow_blocks"],
            "select_hist_pm_m0_pm_m1": select,
            "per_layer": {l["path"]: {"sqnr_db": l["sqnr_db"], "sv_block_rate": l["sv"]["block_rate"],
                                      "select_hist": l["sv"]["select_hist"]} for l in rep["layers"]},
            "metrics_series": sum(len(m.series_keys()) for m in reg), "card_vs_cpu": card_vs_cpu}


def _timed_kv_auditor():
    """A ``KVAuditor(sample_every=1)`` that also sums the seconds its hook
    takes, the device synchronized on both sides: the KV audit's own cost
    per prefill."""
    from repro_torch.obs import KVAuditor

    class TimedKVAuditor(KVAuditor):
        seconds = 0.0

        def observe_prefill(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().observe_prefill(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0

    return TimedKVAuditor(sample_every=1)


def _observed_serve(cfg, eng, k, obs):
    """One phase 4c serve (8 requests, 4 slots, 16 new tokens) of ``eng``
    with ``obs`` in {"off", "metrics_trace", "kv_audit"} (the last adds the
    KV audit to metrics and trace), launch counts exact.  Returns (report,
    row, registry, tracer, auditor)."""
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    n_new, slots, max_len, ps = 16, 4, 256, 16
    reg = tracer = auditor = None
    if obs != "off":
        reg, tracer = MetricsRegistry(), Tracer()
    if obs == "kv_audit":
        auditor = _timed_kv_auditor()
    torch.cuda.synchronize()
    _reset_counts()
    rep = eng.serve(_serve_requests(cfg, n_new), sched_cfg=SchedulerConfig(max_slots=slots),
                    pool_cfg=PagePoolConfig(num_pages=slots * (max_len // ps), page_size=ps, max_len=max_len),
                    speculate_k=k, draft_policy="bf16" if k else None, metrics=reg, trace=tracer, kv_audit=auditor)
    torch.cuda.synchronize()
    counts = _main_path_counts()
    want = _serve_want(cfg, 1, eng.policy, _serve_prefill_m(eng, rep.requests), rep.decode_steps, k,
                       rep.draft_steps, slots)
    assert counts == want, (obs, k, counts, want)
    row = {"tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_time, "decode_steps": rep.decode_steps,
           "wall_ms_per_decode_step": rep.wall_time * 1e3 / rep.decode_steps}
    return rep, row, reg, tracer, auditor


def _observed_checks(rep, reg, tracer, auditor, trace_path):
    """Phase 8 (b)'s assertions on an observed serve; returns its numbers."""
    snap = reg.snapshot()
    one = lambda name, key="value": snap[name]["series"][0][key]  # noqa: E731
    assert one("serve_ttft_seconds", "count") == len(rep.requests) == 8
    assert one("serve_tokens_total") == rep.new_tokens
    assert one("serve_decode_step_seconds", "count") == rep.decode_steps
    live = {s["labels"]["state"]: s["value"] for s in snap["pool_pages"]["series"]}["live"]
    assert live == one("cache_radix_nodes"), (live, one("cache_radix_nodes"))  # no sequence holds a page
    tracer.export(trace_path)
    bad, _ = _check_trace_tool().check_trace(pathlib.Path(trace_path))
    assert bad == [], bad
    row = {"decode_step_p50_ms": one("serve_decode_step_seconds", "p50") * 1e3,
           "decode_step_mean_ms": one("serve_decode_step_seconds", "sum") * 1e3 / rep.decode_steps,
           "prefill_p50_ms": one("serve_prefill_seconds", "p50") * 1e3,
           "ttft_p50_s": one("serve_ttft_seconds", "p50"), "trace_events": len(tracer.events),
           "trace_prefill_span_ms": _span_ms(tracer, "prefill"), "trace_valid": True,
           **{f"trace_{name}_span_ms": _span_ms(tracer, name) for name in ("decode_step", "draft", "verify")}}
    if auditor is not None:
        kv = auditor.snapshot()
        assert kv["pages_sampled"] > 0 and kv["prefills_seen"] == one("serve_prefill_seconds", "count"), kv
        row.update(kv_sqnr_db=kv["sqnr_db"], kv_max_abs_err=kv["max_abs_err"], kv_pages_sampled=kv["pages_sampled"],
                   kv_tokens_sampled=kv["tokens_sampled"], kv_prefills=kv["prefills_seen"],
                   kv_audit_ms_per_prefill=auditor.seconds * 1e3 / kv["prefills_seen"])
    return row


def _profiled_serve(cfg, eng):
    """Phase 8 (c): a short serve (2 requests, 2 new tokens: prefills and
    one decode step) under ``profile_dir``; its Chrome trace must name K1's,
    K4's, K9's and K10's kernels."""
    import shutil
    import tempfile

    from repro_torch.kernels.prefill_attention import kernel_names

    out = tempfile.mkdtemp(prefix="serve_profile_")
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rep = eng.serve(_serve_requests(cfg, 2)[:2], profile_dir=out)
        wall_s = time.perf_counter() - t0
        _main_path_counts()
        path = pathlib.Path(out) / "serve_trace.json"
        names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
        want = {"K1": "gemm_kernel<K1", "K4": "paged_kv_attention_kernel", "K10": "rms_norm_kernel",
                "K9": kernel_names(cfg.cdtype)[-1]}
        found = {k: sorted(n for n in names if tag in n)[:2] for k, tag in want.items()}
        assert all(found.values()), found
        return {"trace_bytes": path.stat().st_size, "events": len(names), "kernels_named": found,
                "wall_s": wall_s, "new_tokens": rep.new_tokens}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _observability(cfg, engines, detail):
    """Phase 8 on llama3_1_8b at full width (phase 7's engines, its first
    ``LLAMA8B_W4_LAYERS`` layers):
    (a) the audit, (b) observed serves against the same engine's serve with
    observability off, vanilla and speculate_k=2, (c) a profiled serve."""
    eng = engines["w4_kv"]
    out = {"audit": _audit_full_width(cfg, eng)}
    trace_path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "phase8_serve_trace.json")
    # vanilla: off, on, on, off, so that a drift of the host's speed over
    # the runs shows; speculative once, with everything on, against the
    # vanilla tokens (speculative == vanilla is asserted in phase 7)
    base = None
    for k, modes in ((0, ("off", "metrics_trace", "kv_audit", "off")), (2, ("kv_audit",))):
        rows = {}
        for obs in modes:
            rep, row, reg, tracer, auditor = _observed_serve(cfg, eng, k, obs)
            if base is None:
                base = rep.outputs
            assert rep.outputs == base, ("tokens moved with observability on", k, obs)
            if obs != "off":
                row.update(_observed_checks(rep, reg, tracer, auditor, trace_path))
            rows.setdefault(obs, []).append(row)
        out[f"serve_k{k}"] = {obs: {"wall_ms_per_decode_step": [r["wall_ms_per_decode_step"] for r in rs],
                                    "tokens_per_s": [r["tokens_per_s"] for r in rs], "runs": rs}
                              for obs, rs in rows.items()}
    eng._spec_cache.clear()  # free the draft tree
    if os.path.exists(trace_path):
        os.remove(trace_path)
    out["profile"] = _profiled_serve(cfg, eng)
    detail["observability"] = out
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper's quantization toolkit (inside phase 7, after phase 8)
# ---------------------------------------------------------------------------
BASELINE_QUANTIZERS = ("mxfp4_quantize", "int4_quantize", "nf4_quantize", "fouroversix_quantize")


def _timed(fn):
    """(fn(), seconds), the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _layer0_inputs(cfg, eng):
    """The inputs of layer 0's linears in ``eng``'s prefill of phase 4's 4
    prompts (8, 15, 23 and 32 tokens, seed 0), the padding rows dropped, as
    float32 (78, d_in) tensors by the linear that reads them: wq (wk and wv
    read the same), wo, up (gate reads the same) and down."""
    from repro_torch.models import attention, layers
    from repro_torch.models import transformer as tf

    lp = eng.params["layers_0"][0]
    names = {id(lp[group][name]): name for group, name in (("mixer", "wq"), ("mixer", "wo"), ("mlp", "up"),
                                                            ("mlp", "down"))}
    seen = {}
    real = attention.qlinear

    def recording(x, w, *args, **kwargs):
        if id(w) in names:
            seen.setdefault(names[id(w)], x.detach())
        return real(x, w, *args, **kwargs)

    prompts = _generate_prompts(cfg)
    lens = [len(p) for p in prompts]
    toks = np.zeros((len(prompts), 32), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    attention.qlinear = layers.qlinear = tf.qlinear = recording
    try:
        eng._bucketed_prefill(toks, np.array(lens), max_len=eng.scfg.max_len, qdq_kv=True)
    finally:
        attention.qlinear = layers.qlinear = tf.qlinear = real
    assert set(seen) == set(names.values()), sorted(seen)
    return {n: torch.cat([x.reshape(len(lens), 32, -1)[i, :n_tok] for i, n_tok in enumerate(lens)]).float()
            for n, x in seen.items()}


def _gap(errors):
    """(best, second best) of a {magnitude: error} dict and their gap, also
    relative to the best."""
    (m0, e0), (m1, e1) = sorted(errors.items(), key=lambda kv: kv[1])[:2]
    return {"best": m0, "second": m1, "gap": e1 - e0, "gap_relative": (e1 - e0) / e0}


def _sweeps(w):
    """The Fig. 3 sweep of one SV pair over the default magnitudes and the
    second-pair sweep on top of the best: (first, second, their seconds)."""
    from repro_torch.core.calibration import DEFAULT_SV_MAGNITUDES, sv_pair_sweep

    first, first_s = _timed(lambda: sv_pair_sweep(w))
    m0 = min(first, key=first.get)
    second, second_s = _timed(lambda: sv_pair_sweep(w, [m for m in DEFAULT_SV_MAGNITUDES if m != m0],
                                                    base_pairs=(m0,)))
    return first, second, first_s, second_s


def _sv_calibration(w, on_cpu_too=False):
    """Phase 9 (a): the two sweeps and ``select_weight_sv_pairs``, which
    must choose their minima; with ``on_cpu_too`` the CPU sweeps the same
    weight and must choose the same pair."""
    from repro_torch.core.calibration import select_weight_sv_pairs

    first, second, first_s, second_s = _sweeps(w)
    pair, select_s = _timed(lambda: select_weight_sv_pairs(w))
    assert pair == (min(first, key=first.get), min(second, key=second.get)), (pair, first, second)
    assert all(v <= 1.0 + 1e-6 for v in list(first.values()) + list(second.values())), (first, second)  # vs NVFP4
    out = {"shape": list(w.shape), "pair": list(pair), "sweep": first, "second_sweep": second,
           "first_gap": _gap(first), "second_gap": _gap(second), "sweep_s": first_s, "second_sweep_s": second_s,
           "select_s": select_s}
    if on_cpu_too:
        t0 = time.perf_counter()
        cpu_first, cpu_second, _, _ = _sweeps(w.cpu())
        cpu_pair = (min(cpu_first, key=cpu_first.get), min(cpu_second, key=cpu_second.get))
        assert cpu_pair == pair, ("the card and the CPU choose different SV pairs", pair, cpu_first, cpu_second)
        rel = [abs(a[m] - b[m]) / b[m] for a, b in ((first, cpu_first), (second, cpu_second)) for m in b]
        out["cpu"] = {"pair": list(cpu_pair), "max_rel_diff_vs_card": max(rel), "seconds": time.perf_counter() - t0}
    return out


def _activation_calibration(samples):
    """Phase 9 (b): ``calibrate_activation_sv`` on layer 0's linear inputs,
    and each magnitude's summed float32 error computed alike, whose minimum
    must be the chosen pair."""
    from repro_torch.core.calibration import DEFAULT_SV_MAGNITUDES, _err, calibrate_activation_sv
    from repro_torch.core.razer import razer_qdq, sv_pairs_to_set

    best, seconds = _timed(lambda: calibrate_activation_sv(samples))
    totals = {m: sum(_err(x, razer_qdq(x, special_values=sv_pairs_to_set(m), scale_fmt="e4m3")) for x in samples)
              for m in DEFAULT_SV_MAGNITUDES}
    assert best == min(totals, key=totals.get), (best, totals)
    return {"pair": best, "errors": totals, "gap": _gap(totals), "seconds": seconds,
            "rows": [list(x.shape) for x in samples]}


def _out_mse(x, w_hat, ref):
    return float(((x @ w_hat - ref) ** 2).mean())


GPTQ_CARD_VS_CPU = (512, 256)  # the (d_in, d_out) corner of wq that GPTQ quantizes on both


def _gptq(w, x, dev, on_cpu_too=False):
    """Phase 9 (c): GPTQ of one weight under the RaZeR group quantizer
    (groups of 16, block 128) on layer 0's inputs; its output MSE there must
    be below round-to-nearest's (``tests/test_calibration.py``).  With
    ``on_cpu_too`` the card and the CPU also quantize the weight's
    ``GPTQ_CARD_VS_CPU`` corner on the same inputs, and must give the same
    weight bit for bit (``tests/test_torch_cuda_obs.py`` checks random
    weights)."""
    from repro_torch.core.gptq import gptq_quantize, make_group_quantizer
    from repro_torch.core.razer import razer_qdq, razer_quantize

    factory = make_group_quantizer(lambda g: razer_quantize(g, axis=0, scale_fmt="e3m3"))
    q, seconds = _timed(lambda: gptq_quantize(w, x, factory, group_size=16, block_size=128, device=dev))
    ref = x @ w
    gptq_mse, rtn_mse = _out_mse(x, q, ref), _out_mse(x, razer_qdq(w, axis=0), ref)
    assert gptq_mse < rtn_mse, (gptq_mse, rtn_mse)
    out = {"shape": list(w.shape), "calibration_rows": x.shape[0], "seconds": seconds, "gptq_mse": gptq_mse,
           "rtn_mse": rtn_mse, "gptq_over_rtn": gptq_mse / rtn_mse}
    if on_cpu_too:
        d_in, d_out = GPTQ_CARD_VS_CPU
        w_c, x_c = w[:d_in, :d_out], x[:, :d_in]
        card, card_s = _timed(lambda: gptq_quantize(w_c, x_c, factory, group_size=16, block_size=128, device=dev))
        t0 = time.perf_counter()
        cpu = gptq_quantize(w_c.cpu(), x_c.cpu(), factory, group_size=16, block_size=128, device="cpu")
        cpu_s = time.perf_counter() - t0
        n_diff = int((card.cpu() != cpu).sum())
        assert n_diff == 0, ("GPTQ on the card != GPTQ on the CPU", n_diff)
        out["card_vs_cpu"] = {"shape": [d_in, d_out], "elements_differing": n_diff, "card_s": card_s,
                              "cpu_s": cpu_s}
    return out


def _awq(w, x):
    """Phase 9 (d): ``awq_search`` of one weight under razer, nvfp4 and int4
    (blocked along d_in); ``apply_awq``'s output MSE must not exceed alpha
    0's, the plain quantizer's."""
    from repro_torch.core.awq import apply_awq, awq_search
    from repro_torch.core.baselines import int4_quantize
    from repro_torch.core.nvfp4 import nvfp4_qdq
    from repro_torch.core.razer import razer_qdq

    fns = {"razer": lambda v: razer_qdq(v, axis=0), "nvfp4": lambda v: nvfp4_qdq(v, axis=0),
           "int4": lambda v: int4_quantize(v, axis=0).dequantize()}
    ref = x @ w
    out = {}
    for fmt, fn in fns.items():
        res, seconds = _timed(lambda: awq_search(w, x, fn))
        plain, awq = _out_mse(x, fn(w), ref), _out_mse(x, apply_awq(w, res, fn), ref)
        assert awq <= plain, (fmt, awq, plain)
        out[fmt] = {"alpha": res.alpha, "awq_mse": awq, "alpha0_mse": plain, "awq_over_alpha0": awq / plain,
                    "seconds": seconds}
    return out


def _two_pass(w, x):
    """Phase 9 (e): the App. D.3 two-pass split of one weight: W_main +
    W_comp == dequantize() bit for bit, the two passes == the single pass
    within the reference test's rtol 1e-5 (atol 1e-5), B_comp's density."""
    from repro_torch.core.razer import razer_quantize
    from repro_torch.core.twopass import two_pass_matmul, two_pass_weights

    (y, density), seconds = _timed(lambda: two_pass_matmul(x, w))
    bq = razer_quantize(w, axis=0)
    w_main, w_comp = two_pass_weights(bq)
    deq = bq.dequantize()
    assert torch.equal(w_main + w_comp, deq)
    y1 = x @ deq
    assert torch.allclose(y, y1, rtol=1e-5, atol=1e-5), float((y - y1).abs().max())
    return {"shape": list(w.shape), "comp_density": float(density), "max_abs_diff_vs_single_pass":
            float((y - y1).abs().max()), "seconds": seconds}


def _baselines_card_vs_cpu(w):
    """The four §5.1 baselines of one float32 weight blocked along d_in on
    the card and on the CPU: q, block scales and tensor scale bit-equal
    (``tests/test_torch_cuda_obs.py`` checks seeds 0-2 of a random weight)."""
    from repro_torch.core import baselines

    out = {}
    w_cpu = w.cpu()
    for name in BASELINE_QUANTIZERS:
        fn = getattr(baselines, name)
        card, card_s = _timed(lambda: fn(w, axis=0))
        t0 = time.perf_counter()
        cpu = fn(w_cpu, axis=0)
        cpu_s = time.perf_counter() - t0
        for field in ("q", "block_scale", "tensor_scale"):
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, field)
        out[name] = {"equal": True, "card_s": card_s, "cpu_s": cpu_s}
    return out


# phase 9 (f) runs llama3_1_8b cut to this many of its 32 layers, from the
# same weights, with its own vanilla serve as the reference: the mxfp4
# draft re-quantizes every weight every draft step, the part of phase 9
# that grows with depth, and the room went to phase 10
TOOLKIT_F_LAYERS = 8


def _mxfp4_draft_serve(cfg, eng):
    """Phase 9 (f): phase 4c's 8 requests (4 slots, 16 new tokens) through
    the W4 + KV engine cut to its first ``TOOLKIT_F_LAYERS`` layers: a
    vanilla serve at that depth (serve == generate asserted: the
    reference), then speculate_k=2 with a fakequant mxfp4 draft: exact
    launch counts, tokens == the vanilla serve."""
    from repro_torch.obs import Tracer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    raw = dict(eng._raw_params, layers_0=eng._raw_params["layers_0"][:TOOLKIT_F_LAYERS])
    full = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=TOOLKIT_F_LAYERS, name=f"{cfg.name}-{TOOLKIT_F_LAYERS}L")
    eng = Engine(raw, cfg, eng.scfg, device=eng.device)
    vanilla = _serve_full_width(cfg, {"w4_kv": eng}, {}, runs={"w4_kv": ((0, None),)})["w4_kv_k0"]
    n_new, slots, max_len, ps, k = 16, 4, 256, 16, 2
    tracer = Tracer()
    torch.cuda.synchronize()
    _reset_counts()
    rep = eng.serve(_serve_requests(cfg, n_new), sched_cfg=SchedulerConfig(max_slots=slots),
                    pool_cfg=PagePoolConfig(num_pages=slots * (max_len // ps), page_size=ps, max_len=max_len),
                    speculate_k=k, draft_policy="mxfp4", trace=tracer)
    torch.cuda.synchronize()
    counts = _main_path_counts()
    want = _serve_want(cfg, 1, eng.policy, _serve_prefill_m(eng, rep.requests), rep.decode_steps, k,
                       rep.draft_steps, slots)
    assert counts == want, (counts, want)
    share, diffs = _agreement(eng, rep.requests, MESHLESS[(cfg.name, "w4_kv", "serve")])
    assert share == 1.0, ("speculative (mxfp4 draft) != vanilla serve", diffs)
    del eng  # the cut engine and its draft
    torch.cuda.empty_cache()
    return {"num_layers": [full, TOOLKIT_F_LAYERS], "accept_rate": rep.accept_rate, "tokens_per_s": rep.tokens_per_s,
            "wall_s": rep.wall_time, "decode_steps": rep.decode_steps, "draft_steps": rep.draft_steps,
            "draft_ms_per_iteration": _span_ms(tracer, "draft"), "verify_ms_per_iteration": _span_ms(tracer, "verify"),
            "share_equal_to_vanilla_serve": share, "launches": counts,
            "vanilla_tokens_per_s": vanilla["tokens_per_s"], "vanilla_wall_s": vanilla["wall_s"]}


def _toolkit(cfg, engines, detail, dev):
    """Phase 9 on llama3_1_8b's raw weights at full width (phase 7's
    engines): (a)-(f) as the module docstring says, each part's seconds."""
    eng = engines["w4_kv"]
    raw = eng._raw_params["layers_0"][0]
    wq, up, down = raw["mixer"]["wq"], raw["mlp"]["up"], raw["mlp"]["down"]
    assert wq.dtype == up.dtype == down.dtype == torch.float32
    out, part_s = {}, {}
    t_part = [time.perf_counter()]

    def part(name, value):
        now = time.perf_counter()
        out[name], part_s[name] = value, now - t_part[0]
        t_part[0] = now

    part("a_weight_sv_pairs", {"wq": _sv_calibration(wq, on_cpu_too=True), "down": _sv_calibration(down)})
    inputs = _layer0_inputs(cfg, eng)
    part("b_activation_sv", _activation_calibration([inputs[n] for n in ("wq", "wo", "up", "down")]))
    part("c_gptq", {"wq": _gptq(wq, inputs["wq"], dev, on_cpu_too=True), "up": _gptq(up, inputs["up"], dev)})
    part("d_awq_wq", _awq(wq, inputs["wq"]))
    part("e_two_pass_wq", _two_pass(wq, inputs["wq"]))
    part("f_mxfp4_draft_serve", _mxfp4_draft_serve(cfg, eng))
    part("baselines_card_vs_cpu_down", _baselines_card_vs_cpu(down))
    out["seconds_by_part"] = part_s
    detail["toolkit"] = out
    return out


def _card_vs_cpu(dev, detail):
    """The reduced llama3_2_3b (KVH 2) and dbrx_132b in bf16, on the card
    with the kernels and on the CPU with the plain versions, from the same
    weights: prefill and 5 teacher-forced decode steps fed the CPU run's
    greedy tokens."""
    out = {}
    for arch, kw in (("llama3_2_3b", dict(num_kv_heads=2)), ("dbrx_132b", {})):
        out[arch] = _card_vs_cpu_one(dev, arch, kw)
    detail["card_vs_cpu"] = out
    return out


def _card_vs_cpu_one(dev, arch, kw):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    # llama: the logit tolerances of the bf16 slice tests
    # (tests/test_torch_engine_bf16.py); dbrx: set from its readings on the
    # H100 (0.0068 under W4 + KV, 0.0020 under W4A4 + KV), with room
    tolerances = {"llama3_2_3b": {"w4_kv": 0.06, "w4a4_kv": 0.25},
                  "dbrx_132b": {"w4_kv": 0.03, "w4a4_kv": 0.02}}[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    params = init_params(cfg, seed=1, device="cpu")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]]
    lens = np.array([len(p) for p in prompts])
    toks = np.zeros((3, 16), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    out = {}
    for name, policy in _policies().items():
        scfg = ServeConfig(max_len=32, max_new_tokens=6, quant=policy)
        card, cpu = Engine(params, cfg, scfg, device=dev), Engine(params, cfg, scfg, device="cpu")
        fed = []  # the CPU run's greedy tokens, fed to both runs
        results = []
        for eng in (cpu, card):
            _reset_counts()
            last, caches = eng._bucketed_prefill(toks, lens, max_len=32, qdq_kv=True)
            caches = eng._quantize_caches(caches)
            logits, cur = [last.float().cpu()], torch.as_tensor(lens, device=eng.device)
            for step in range(5):
                if eng is cpu:
                    fed.append(torch.argmax(logits[-1], -1))
                lg, caches = eng._decode_step(fed[step].to(eng.device), caches, cur)
                logits.append(lg.float().cpu())
                cur = cur + 1
            results.append(logits)
            counts = _read_counts()
            assert (eng is card) == (counts["razer_matmul"] > 0 and counts["razer_kv_attention"] > 0), counts
            assert (eng is card and policy.act is not None) == (
                counts["razer_act_qdq"] + counts["razer_matmul_fused_act"] > 0), counts
            assert (eng is card) == (counts["prefill_attention"] > 0 and counts["rms_norm"] > 0), counts
            assert (eng is card and cfg.moe) == (counts["razer_grouped_matmul"] > 0), counts
        diffs = [float((a - b).abs().max()) for a, b in zip(*results)]
        assert max(diffs) <= tolerances[name], (arch, name, diffs)
        out[name] = {"max_abs_logit_diff": max(diffs), "per_step": diffs, "tolerance": tolerances[name]}
    return out


# ---------------------------------------------------------------------------
# phase 10: the rest of the zoo through Engine.generate
# ---------------------------------------------------------------------------
ZOO_CUT = {"deepseek_v2_236b": 2, "qwen2_vl_7b": 2}  # layers kept (the dense layer and one MoE layer)
QWEN2_VL_PATCHES = 256  # the vision stub's patch embeddings per prompt (the reference's N_IMG_PATCHES)


def _zoo_want(cfg, policy, stats, enc_frames: int = 0):
    """Exact launch counts of one generate of a zoo model from its
    ``Engine.stats``: a prefill of batch x bucket rows (whisper's encoder on
    batch x ``enc_frames``), then decode steps of batch rows.  K1 per packed
    linear (MLA: q_a or wq, kv_a and wo, its q_b and kv_b dense; whisper's
    cross-attention: wq and wo on the decoder rows, wk and wv on the frames,
    every step; the dense layers' MLP; the shared experts; Mamba-2's
    in_proj and out_proj; the RG-LRU block's five), K6 3 per MoE layer per
    forward, K9 per attention layer per prefill and per cross-attention per
    forward, K3 per GQA layer per decode step (none for a windowed layer:
    its decode attends the dequantized cache through the plain version, as
    the reference's does), K10 per norm (MLA's q_norm and kv_norm, Mamba's
    gated norm too).  Under W4A4 a K1 over M <= ``FUSE_ACT_MAX_M`` rows
    quantizes x in its load, else after a K2."""
    from repro_torch.kernels.razer_matmul import FUSE_ACT_MAX_M
    from repro_torch.models.transformer import layer_groups

    b, steps = stats["batch"], stats["decode_steps"]
    ms, n = [], dict.fromkeys(("razer_grouped_matmul", "prefill_attention", "razer_kv_attention", "rms_norm"), 0)
    enc_m = b * enc_frames

    def forward(m, prefill):
        if prefill and cfg.encoder_decoder:
            ms.extend([enc_m] * 6 * cfg.enc_layers)  # wq, wk, wv, wo, up, down
            n["prefill_attention"] += cfg.enc_layers
            n["rms_norm"] += 2 * cfg.enc_layers + 1
        for ltype, count in layer_groups(cfg):
            for _ in range(count):
                if ltype == "s":  # in_proj, out_proj; ln1 and the gated norm; no MLP
                    ms.extend([m] * 2)
                    n["rms_norm"] += 2
                    continue
                if ltype == "r":  # w_gate, w_in, wa, wx, out_proj; ln1
                    ms.extend([m] * 5)
                    n["rms_norm"] += 1
                elif cfg.mla:
                    ms.extend([m] * 3)
                    n["rms_norm"] += 2 + (1 if cfg.q_lora_rank else 0)  # ln1, kv_norm, q_norm
                else:
                    ms.extend([m] * 4)
                    n["rms_norm"] += 3 if cfg.qk_norm else 1
                    n["razer_kv_attention"] += 0 if prefill or cfg.block_pattern else 1
                n["prefill_attention"] += 1 if prefill and ltype != "r" else 0
                if ltype == "c":
                    ms.extend([m, enc_m, enc_m, m])
                    n["prefill_attention"] += 1
                    n["rms_norm"] += 1
                if ltype == "m":
                    n["razer_grouped_matmul"] += 3
                    ms.extend([m] * (3 if cfg.n_shared_experts else 0))
                else:
                    ms.extend([m] * (2 if cfg.act_fn == "gelu" else 3))
                n["rms_norm"] += 1
        n["rms_norm"] += 1

    forward(b * stats["bucket"], True)
    for _ in range(steps):
        forward(b, False)
    want = dict.fromkeys(_counters(), 0)
    want.update(n, razer_matmul=len(ms))
    if policy.act is not None:
        want["razer_matmul_fused_act"] = sum(m <= FUSE_ACT_MAX_M for m in ms)
        want["razer_act_qdq"] = len(ms) - want["razer_matmul_fused_act"]
    if policy.kv is None:
        want["razer_kv_attention"] = 0
    return want


def _zoo_generate(cfg, eng, prompts, extras, n_new: int = 16):
    """A warm-up generate, then a timed one with exact launch counts, and
    its prefill ms, decode ms a step and peak memory."""
    eng.generate(prompts, extras=extras, max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = eng.generate(prompts, extras=extras, max_new_tokens=n_new)
    torch.cuda.synchronize()
    counts = _main_path_counts()
    st = eng.stats
    want = _zoo_want(cfg, eng.policy, st, cfg.enc_frames if cfg.encoder_decoder else 0)
    assert counts == want, (cfg.name, counts, want)
    assert all(len(o) == len(p) + n_new for o, p in zip(out, prompts))
    assert all(0 <= t < cfg.vocab_size for o in out for t in o)
    return out, {"prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
                 "tokens_per_s": len(prompts) * n_new / (st["prefill_s"] + st["decode_s"]),
                 "batch": st["batch"], "prefill_rows_per_sequence": st["bucket"], "launches": counts,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _serve_refusal(eng):
    """``serve`` on an arch the paged pool refuses raises the reference's
    words (``serving/pagepool.py::_check_paged_arch``)."""
    try:
        eng.serve([[1, 2, 3]], max_new_tokens=2)
    except ValueError as err:
        assert "paged KV serving supports pure GQA-attention stacks" in str(err), err
        return str(err)
    raise AssertionError(f"serve of {eng.cfg.name} did not raise")


def _zoo_model(arch, dev, detail, prompts, extras_of, max_len=128):
    """One zoo model at full width (cut to ``ZOO_CUT`` layers where listed),
    random weights from seed 0 packed on the card under both policies:
    ``_zoo_generate`` under each, a profile of a short W4 + KV generate
    (the device idle share) and the serve refusal."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cut = None
    if arch in ZOO_CUT:
        cut = {"num_layers": [cfg.num_layers, ZOO_CUT[arch]]}
        cfg = dataclasses.replace(cfg, num_layers=ZOO_CUT[arch])
    engines, pack_s = _engines(cfg, dev, max_len=max_len)
    extras = extras_of(cfg)
    row = {"cut": cut, "pack_s_two_engines": pack_s, "prompt_lens": [len(p) for p in prompts]}
    outputs = {}
    for name, eng in engines.items():
        outputs[name], row[name] = _zoo_generate(cfg, eng, prompts, extras)
    eng = engines["w4_kv"]
    row["profile_w4_kv"] = _profile(lambda: eng.generate(prompts, extras=extras, max_new_tokens=4))
    row["serve_refusal"] = _serve_refusal(eng)
    return cfg, engines, extras, outputs, row


def _zoo(dev, detail):
    """Phase 10: deepseek_v2_236b (MLA + MoE, cut to its dense layer and one
    MoE layer), qwen2_vl_7b (M-RoPE with the vision stub's patch
    embeddings, cut to 2 layers) and whisper_base (6 + 6 layers, 1500
    frames) at full width through Engine.generate, then each narrow on the
    card against the CPU (``_zoo_card_vs_cpu``)."""
    from repro_torch.configs import get_config

    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompts = _generate_prompts(get_config("deepseek_v2_236b"))
    _, engines, _, _, out["deepseek_v2_236b"] = _zoo_model("deepseek_v2_236b", dev, detail, prompts, lambda c: {})
    del engines
    torch.cuda.empty_cache()
    print("zoo deepseek_v2_236b full width, cut num_layers 60 -> 2: " + json.dumps(out["deepseek_v2_236b"]))

    cfg = get_config("qwen2_vl_7b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=320).tolist() for _ in range(4)]
    patches = lambda c: {"frontend_embeds": torch.randn(  # noqa: E731
        (len(prompts), QWEN2_VL_PATCHES, c.d_model), generator=gen, device=dev).to(torch.bfloat16)}
    cfg, engines, extras, outputs, row = _zoo_model("qwen2_vl_7b", dev, detail, prompts, patches, max_len=512)
    plain = engines["w4_kv"].generate(prompts, max_new_tokens=16)
    row["share_differing_without_patches"] = sum(a != b for a, b in zip(plain, outputs["w4_kv"])) / len(prompts)
    assert row["share_differing_without_patches"] > 0, "the patch embeddings did not reach the model"
    out["qwen2_vl_7b"] = row
    del engines, extras
    torch.cuda.empty_cache()
    print("zoo qwen2_vl_7b full width, cut num_layers 28 -> 2, 256 patch embeddings a prompt: " + json.dumps(row))

    cfg = get_config("whisper_base")
    prompts = [np.random.default_rng(5).integers(1, cfg.vocab_size, size=8).tolist()]
    frames = lambda c: {"enc_frames": torch.randn(  # noqa: E731
        (1, c.enc_frames, c.d_model), generator=gen, device=dev).to(torch.bfloat16)}
    _, engines, _, _, out["whisper_base"] = _zoo_model("whisper_base", dev, detail, prompts, frames)
    del engines
    torch.cuda.empty_cache()
    print("zoo whisper_base full size, 1500 frames: " + json.dumps(out["whisper_base"]))
    out["card_vs_cpu"] = _zoo_card_vs_cpu(dev)
    print("zoo card vs cpu (narrow, bf16): " + json.dumps(out["card_vs_cpu"]))
    detail["zoo"] = out
    return out


# the card against the CPU at a narrow width: the largest |logit| difference
# over a prefill and 5 teacher-forced decode steps, set from the readings on
# the H100 over phase 10's three models: 0.0020-0.0051 under W4 + KV (K9 and
# K3 sum in another order than the plain versions), exactly 0 under W4A4 + KV
ZOO_CARD_CPU_TOL = {"w4_kv": 0.02, "w4a4_kv": 1e-3}
# the recurrent archs' (phase 11 (c)), from their own readings
# (tools/card_cpu_probe.py, weight seeds 1-5): K1 sums a packed linear in
# another order than the plain matmul, and one bf16 rounding of its output
# flips at the prefill; no activation code moves under W4A4, and the
# difference reaches the logits through the unquantized conv, scans, gates
# and residual stream: W4 + KV 0-0.0107, W4A4 + KV 0-2^-10.  W4 keeps 0.02;
# W4A4 takes 2^-8, four times its largest reading
RECURRENT_CARD_CPU_TOL = {"w4_kv": 0.02, "w4a4_kv": 2**-8}


def _zoo_narrow_cfg(arch):
    """The reduced config in bf16; MLA keeps its real head widths (nope 128,
    rope 64, V 128: the prefill kernel is built for hd 192 with V at 128,
    not the reduced 16 + 8) and the query's low-rank path."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if cfg.mla:
        cfg = dataclasses.replace(cfg, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, q_lora_rank=32)
    return cfg


def _narrow_inputs(cfg):
    """The prompts and extras of ``_zoo_card_vs_cpu`` for ``cfg``: the
    recurrent archs take three prompts of 11 tokens (one length; past the
    narrow RecurrentGemma's window of 8)."""
    g = torch.Generator().manual_seed(1)
    if cfg.encoder_decoder:
        return [[7, 8, 9, 10, 11, 12]], {"enc_frames": torch.randn((1, cfg.enc_frames, cfg.d_model), generator=g)}
    if cfg.ssm or cfg.block_pattern:
        return [list(range(1, 12)), list(range(20, 31)), [40, 3, 41, 7, 42, 9, 43, 11, 44, 13, 45]], {}
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]]
    return prompts, {"frontend_embeds": torch.randn((3, 2, cfg.d_model), generator=g)} if cfg.frontend != "none" else {}


def _zoo_card_vs_cpu(dev, archs=ZOO):
    """Phase 10 (d) and 11 (c): each model of ``archs`` narrow, in bf16,
    from the same weights (seed 1) on the card (the kernels) and on the CPU
    (the plain versions), under both policies: the logits of the prefill
    and of 5 decode steps fed the CPU run's greedy tokens within
    ``ZOO_CARD_CPU_TOL`` (``RECURRENT_CARD_CPU_TOL`` for the recurrent
    archs), and ``generate``'s tokens equal, except where the
    CPU's top-2 gap at the first differing step is at most the largest
    logit difference measured (a near tie the difference can flip); the
    prompts of ``_narrow_inputs``."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    out = {}
    for arch in archs:
        cfg = _zoo_narrow_cfg(arch)
        params = init_params(cfg, seed=1, device="cpu")
        prompts, extras = _narrow_inputs(cfg)
        row = {}
        for name, policy in _policies().items():
            scfg = ServeConfig(max_len=32, max_new_tokens=6, quant=policy)
            engines = (Engine(params, cfg, scfg, device="cpu"), Engine(params, cfg, scfg, device=dev))
            cpu_logits = _teacher_forced(engines[0], prompts, extras)
            card_logits = _teacher_forced(engines[1], prompts, extras, fed=cpu_logits)
            diffs = [float((a - b).abs().max()) for a, b in zip(cpu_logits, card_logits)]
            tol = (RECURRENT_CARD_CPU_TOL if cfg.ssm or cfg.block_pattern else ZOO_CARD_CPU_TOL)[name]
            assert max(diffs) <= tol, (arch, name, diffs)
            toks = [eng.generate(prompts, extras=extras, max_new_tokens=6) for eng in engines]
            near_ties = []
            for j, (a, b) in enumerate(zip(*toks)):
                if a != b:
                    step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y) - len(prompts[j])
                    top = torch.topk(cpu_logits[step][j], 2).values
                    near_ties.append({"sequence": j, "step": step, "cpu_top2_gap": float(top[0] - top[1])})
                    assert near_ties[-1]["cpu_top2_gap"] <= max(diffs), (arch, name, near_ties[-1], diffs)
            row[name] = {"max_abs_logit_diff": max(diffs), "per_step": diffs, "tolerance": tol,
                         "tokens_equal": toks[0] == toks[1], "near_ties": near_ties}
            del engines
        out[arch] = row
    return out


# ---------------------------------------------------------------------------
# phase 11: the recurrent archs through Engine.generate
# ---------------------------------------------------------------------------
RG_PROMPT_LEN, MAMBA_PROMPT_LEN = 3072, 1024  # four prompts each; RecurrentGemma's outrun its window of 2048


def _recurrent(dev, detail):
    """Phase 11: recurrentgemma_2b (RG-LRU blocks and windowed attention in
    the pattern r, r, a; all 26 layers) from 4 prompts of 3072 random
    tokens (longer than the window: the prefill's K9 and the decode mask
    both cut), max_len 4096, and mamba2_370m (all 48 Mamba-2 layers) from 4
    prompts of 1024, at full width through Engine.generate, random weights
    (seed 0) packed on the card under W4 + KV and W4A4 + KV: a warm-up and
    a timed generate of 16 new tokens with exact launch counts
    (``_zoo_want``: K1 8 an RG-LRU layer, 7 an attention layer, 2 a Mamba
    layer; K9 once an attention layer a prefill; no K3), prefill ms, decode
    ms a step, peak memory, the device idle share of a short W4 + KV
    generate, and serve's refusal; then each narrow on the card against the
    CPU (``_zoo_card_vs_cpu``)."""
    from repro_torch.configs import get_config

    out = {}
    for arch, n, max_len in (("recurrentgemma_2b", RG_PROMPT_LEN, 4096), ("mamba2_370m", MAMBA_PROMPT_LEN, 128)):
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, get_config(arch).vocab_size, size=n).tolist() for _ in range(4)]
        _, engines, _, _, row = _zoo_model(arch, dev, detail, prompts, lambda c: {}, max_len=max_len)
        del engines
        torch.cuda.empty_cache()
        out[arch] = row
        print(f"recurrent {arch} full width and depth, 4 prompts of {n} tokens: " + json.dumps(row))
    out["card_vs_cpu"] = _zoo_card_vs_cpu(dev, archs=RECURRENT)
    print("recurrent card vs cpu (narrow, bf16): " + json.dumps(out["card_vs_cpu"]))
    detail["recurrent"] = out
    return out


def _teacher_forced(eng, prompts, extras, fed=None, steps: int = 5):
    """The last logits of ``eng``'s prefill (as ``generate`` runs it) and of ``steps`` decode steps, fed the greedy tokens of
    ``fed`` (a list of earlier logits: the CPU run's) or its own; as f32 on
    the CPU."""
    toks, lens, _ = eng._prefill_input(prompts, extras)
    with torch.no_grad():
        last, caches, enc = eng._prefill_batch(toks, lens, extras)
        logits, cur = [last.float().cpu()], torch.as_tensor(lens, device=eng.device)
        for step in range(steps):
            tok = torch.argmax((fed if fed is not None else logits)[step], -1).to(eng.device)
            lg, caches = eng._decode_step(tok, caches, cur, enc)
            logits.append(lg.float().cpu())
            cur = cur + 1
    return logits


# ---------------------------------------------------------------------------
# phase 6: serving on a mesh (two ranks share the one card over gloo)
# ---------------------------------------------------------------------------
RANK_TIMEOUT_S = 480  # per spawned world, joined by the parent


def _generate_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]


def _prefill_logits(eng, prompts):
    toks = np.zeros((len(prompts), 32), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    last, _ = eng._bucketed_prefill(toks, np.array([len(p) for p in prompts]), max_len=eng.scfg.max_len,
                                    qdq_kv=eng.kv_quant)
    return last.float().cpu()


# The float32 checks of phase 6: the same weights and packed bytes under W4
# (no KV quantization, whose codes an ulp can flip) in float32 compute, on
# the mesh and meshless.  One linear differs only in the order of its f32
# partial sums: held to K1's bound.  A whole model also rounds x to bf16
# inside every kernel, where a sum-order ulp can cross a rounding boundary,
# and the model carries such steps forward: its logits are held to 1 % of
# their largest magnitude, which a wrong shard, slice or layout exceeds by
# far.  In bf16 the reference's semantics sum bf16-rounded partials, which
# moves logits more and flips MoE routing: those differences are reported.
F32_LOGIT_RTOL = 1e-2


def _f32_prefill_logits(raw, cfg, prompts, **engine_kw):
    """Prefill logits of ``prompts`` under W4 in float32 compute."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng = Engine(raw, cfg32, ServeConfig(max_len=128, max_new_tokens=16, quant=QuantPolicy.packed()), **engine_kw)
    logits = _prefill_logits(eng, prompts)
    del eng
    torch.cuda.empty_cache()
    return logits


def _run_generate(eng, prompts):
    """A warm-up generate, then a timed one with counts, collective time and
    peak memory."""
    from repro_torch.parallel import collectives

    eng.generate(prompts, max_new_tokens=2)
    torch.cuda.synchronize()
    _reset_counts()
    collectives.stats.update(calls=0, seconds=0.0)
    torch.cuda.reset_peak_memory_stats()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    st = eng.stats
    return {"outputs": out, "counts": _read_counts(), "collectives": dict(collectives.stats),
            "prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
            "decode_steps": st["decode_steps"], "stats": dict(st),
            "tokens_per_s": len(prompts) * 16 / (st["prefill_s"] + st["decode_s"]),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _serve_cfgs():
    """Phase 4c's scheduler and pool: 4 slots, pages of 16, max_len 256."""
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    return SchedulerConfig(max_slots=4), PagePoolConfig(num_pages=4 * (256 // 16), page_size=16, max_len=256)


def _run_serve(eng, cfg, k=0, draft=None):
    """Phase 4c's traffic (8 requests, 4 slots, pages of 16, 16 new tokens)
    with counts, collective time and peak memory."""
    from repro_torch.obs import Tracer
    from repro_torch.parallel import collectives

    sched_cfg, pool_cfg = _serve_cfgs()
    tracer = Tracer()
    torch.cuda.synchronize()
    _reset_counts()
    collectives.stats.update(calls=0, seconds=0.0)
    torch.cuda.reset_peak_memory_stats()
    rep = eng.serve(_serve_requests(cfg, 16), sched_cfg=sched_cfg, pool_cfg=pool_cfg, speculate_k=k,
                    draft_policy=draft, trace=tracer)
    torch.cuda.synchronize()
    row = {"outputs": rep.outputs, "counts": _read_counts(), "collectives": dict(collectives.stats),
           "decode_steps": rep.decode_steps, "draft_steps": rep.draft_steps,
           "prefill_m": _serve_prefill_m(eng, rep.requests),
           "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_time, "ttft_p50_s": rep.ttft_p50,
           "ttft_p95_s": rep.ttft_p95, "accept_rate": rep.accept_rate,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if k:
        row["draft_ms_per_iteration"] = _span_ms(tracer, "draft")
        row["verify_ms_per_iteration"] = _span_ms(tracer, "verify")
    else:
        row["decode_ms_per_step"] = _span_ms(tracer, "decode_step")
    eng._spec_cache.clear()
    return row


def _meshless_llama_refs(cfg, engines, dev):
    """6b's meshless references from the cut-depth engines of phases 4e and
    4f (the same seed-0 weights the ranks draw): each policy's prefill
    logits, generate of phase 4's prompts and of phase 4c's serve prompts,
    and the W4 float32 prefill logits."""
    prompts = _generate_prompts(cfg)
    refs = {"f32_prefill_logits": _f32_prefill_logits(engines["w4_kv"]._raw_params, cfg, prompts, device=dev)}
    for name, eng in engines.items():
        refs[name] = {"prefill_logits": _prefill_logits(eng, prompts), "generate": eng.generate(prompts),
                      "generate_serve_prompts": eng.generate([r.prompt for r in _serve_requests(cfg, 16)],
                                                             max_new_tokens=16)}
    return refs


def _rank_llama(mesh):
    """Rank side of 6b: llama3_2_3b at full width cut to LLAMA_CUT_LAYERS
    on the (1, 2) mesh under both policies: prefill logits, generate,
    vanilla serve, and under W4 + KV serve(speculate_k=2) with the bf16
    draft."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = _llama_cut_cfg()
    raw = init_params(cfg, seed=0, device=mesh.device)
    out = {}
    for name, policy in _policies().items():
        eng = Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=policy), mesh=mesh)
        prompts = _generate_prompts(cfg)
        res = {"prefill_logits": _prefill_logits(eng, prompts), "generate": _run_generate(eng, prompts)}
        sched_cfg, pool_cfg = _serve_cfgs()
        eng.serve(_serve_requests(cfg, 2)[:2], sched_cfg=sched_cfg, pool_cfg=pool_cfg)  # warm-up
        for k, draft in ((0, None), (2, "bf16")) if name == "w4_kv" else ((0, None),):
            res[f"serve_k{k}"] = _run_serve(eng, cfg, k, draft)
        out[name] = res
        del eng
        torch.cuda.empty_cache()
    out["f32_prefill_logits"] = _f32_prefill_logits(raw, cfg, _generate_prompts(cfg), mesh=mesh)
    out["linear_check"] = _mesh_linear_check(mesh, cfg)
    return out


def _mesh_linear_check(mesh, cfg):
    """Each of the model's 7 packed linear kinds at full width, K-sharded on
    ``mesh`` (K7, the reduce-scatter and the gather over gloo), on float32
    x at M = 4 and 128, against K1 on the whole weight: the largest
    |difference| / (1e-5 (|x| @ |W|) + 1e-6), K1's bound against its plain
    version (only the order of the f32 sums differs)."""
    from repro_torch.core.packing import pack_weight
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.qlinear import qlinear
    from repro_torch.parallel.sharding import shard_params, sharding_ctx

    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(7)  # the same weights and inputs on every rank
    policy, worst = QuantPolicy.packed(), 0.0
    for _, k, n in _linear_shapes(cfg):
        whole = pack_weight(torch.randn((k, n), generator=gen, device=mesh.device) / k**0.5)
        local = shard_params({"w": whole}, mesh)["w"]
        assert local.k_shards == mesh.tp
        w_abs = whole.dequantize().abs_()
        for m in (4, 128):
            x = torch.randn((m, k), generator=gen, device=mesh.device)
            with sharding_ctx(mesh):
                got = qlinear(x, local, policy)
            want = qlinear(x, whole, policy)
            worst = max(worst, float(((got - want).abs() / (1e-5 * (x.abs() @ w_abs) + 1e-6)).max()))
    return {"worst_err_over_bound": worst, "M": [4, 128]}


def _dbrx_one_layer(capacity_factor):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("dbrx_132b"), num_layers=1, capacity_factor=capacity_factor)


def _rank_dbrx(mesh_of):
    """Rank side of 6c: full-width dbrx_132b cut to 1 layer, W4 + KV, on
    the (1, 2) and the (2, 1) mesh, at capacity factor 1.25 and at the
    no-drop n_experts / topk: prefill logits, generate, vanilla serve."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    out = {}
    raw = None
    for layout in ((1, 2), (2, 1)):
        mesh = mesh_of(*layout)
        if raw is None:
            raw = init_params(_dbrx_one_layer(1.25), seed=0, device=mesh.device)
        for cf in (1.25, 4.0):
            cfg = _dbrx_one_layer(cf)
            eng = Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=_policies()["w4_kv"]),
                         mesh=mesh)
            prompts = _generate_prompts(cfg)
            out[(layout, cf)] = {"prefill_logits": _prefill_logits(eng, prompts),
                                 "generate": _run_generate(eng, prompts), "serve_k0": _run_serve(eng, cfg)}
            del eng
            torch.cuda.empty_cache()
            if cf == 4.0:
                out[(layout, cf)]["f32_prefill_logits"] = _f32_prefill_logits(raw, cfg, prompts, mesh=mesh)
    return out


def _rank_entry(rank, world, init, out_dir, kind):
    """One spawned rank of phase 6 (or of phase 12 (f), ``kind`` "train"):
    joins the gloo group, runs its part on cuda:0 (shared with the other
    rank) and pickles what it measured."""
    import pickle
    import traceback

    try:
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_serving_mesh

        def mesh_of(ep, tp):
            return make_serving_mesh(ep=ep, tp=tp, backend="gloo", device="cuda", init_method=f"file://{init}",
                                     rank=rank, world_size=world)

        if kind == "train":
            result = _rank_train(rank, world, init)
        else:
            with torch.no_grad():
                result = _rank_llama(mesh_of(1, 2)) if kind == "llama" else _rank_dbrx(mesh_of)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn_ranks(kind, world: int = 2):
    """Start ``world`` ranks of ``kind`` with the spawn method, join each
    within RANK_TIMEOUT_S (terminating any still running), fail with a
    rank's traceback if one failed; returns each rank's results."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    init = os.path.join(out_dir, "pg_init")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, init, out_dir, kind)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    errs = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(world)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if alive or errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"phase 6 / 12 (f) {kind}: ranks {'timed out' if alive else 'failed'} "
                           f"(exit codes {[p.exitcode for p in procs]})\n" + "\n".join(errs))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _share_equal(outputs, ref_outputs):
    return sum(list(a) == list(b) for a, b in zip(outputs, ref_outputs)) / len(ref_outputs)


def _summary(run):
    return {k: v for k, v in run.items() if k != "outputs"}


def _world1_nccl(cfg, engines, detail):
    """6a: a world of one rank over NCCL, Engine(mesh=(1, 1)) on the dense
    tree of phase 4's W4 + KV engine: prefill logits, generate tokens and
    vanilla serve outputs equal the meshless engine's bit for bit (tp = 1
    takes the unsharded launches)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import Engine, ServeConfig

    init = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"), "pg_init")
    mesh = make_serving_mesh(ep=1, tp=1, backend="nccl", device="cuda", init_method=f"file://{init}", rank=0,
                             world_size=1)
    base = engines["w4_kv"]
    eng = Engine(base._raw_params, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=base.policy), mesh=mesh)
    prompts = _generate_prompts(cfg)
    logits = _prefill_logits(eng, prompts)
    assert torch.equal(logits, MESHLESS[(cfg.name, "w4_kv", "prefill_logits")]), "world-1 prefill logits differ"
    gen = _run_generate(eng, prompts)
    assert gen["outputs"] == MESHLESS[(cfg.name, "w4_kv", "generate")], "world-1 generate tokens differ"
    assert gen["counts"] == _generate_want(cfg, 1, eng.policy, gen["stats"]), gen["counts"]
    _main_path_counts(gen["counts"])
    serve = _run_serve(eng, cfg)
    assert serve["outputs"] == MESHLESS[(cfg.name, "w4_kv", "serve")], "world-1 serve outputs differ"
    _main_path_counts(serve["counts"])
    dist.destroy_process_group()
    out = {"backend": "nccl", "mesh": [1, 1], "prefill_logits_bit_identical": True,
           "generate_tokens_identical": True, "serve_outputs_identical": True,
           "generate": _summary(gen), "serve": _summary(serve)}
    detail["parallel_world1_nccl"] = out
    return out


def _check_ranks_agree(ranks, key):
    for r in ranks[1:]:
        assert r[key]["outputs"] == ranks[0][key]["outputs"], f"{key}: ranks disagree on tokens"


def _parallel_llama(cfg, detail, refs):
    """6b: llama3_2_3b at full width cut to LLAMA_CUT_LAYERS (``cfg``) on
    the (1, 2) mesh, two ranks on one card over gloo, every packed linear
    K-sharded (K7); each rank's K-sharded linears are held to K1's bound
    (``_mesh_linear_check``).  ``refs``: the meshless engine's outputs at
    the same depth (``_meshless_llama_refs``), against which the mesh's
    logits and tokens are reported."""
    f32_ref = refs["f32_prefill_logits"]
    ranks = _spawn_ranks("llama")
    for r in ranks:
        assert r["linear_check"]["worst_err_over_bound"] <= 1.0, ("tp2 linear vs K1", r["linear_check"])
    f32_diff = float((ranks[0]["f32_prefill_logits"] - f32_ref).abs().max())
    out = {"mesh": [1, 2], "backend": "gloo, both ranks on cuda:0; collectives staged through host memory "
                                      "(their times are no measure of NCCL)",
           "cut": {"num_layers": [28, cfg.num_layers]},
           "linear_check": [r["linear_check"] for r in ranks],
           "w4_f32_max_abs_logit_diff_vs_meshless": f32_diff,
           "w4_f32_max_abs_logit_meshless": float(f32_ref.abs().max())}
    for name, policy in _policies().items():
        res = {"max_abs_logit_diff_vs_meshless": float((ranks[0][name]["prefill_logits"]
                                                        - refs[name]["prefill_logits"]).abs().max())}
        for r in ranks[1:]:
            assert torch.equal(r[name]["prefill_logits"], ranks[0][name]["prefill_logits"]), "ranks' logits differ"
        _check_ranks_agree([r[name] for r in ranks], "generate")
        for rank, r in enumerate(ranks):
            gen = r[name]["generate"]
            want = _generate_want(cfg, 2, policy, gen["stats"])
            assert gen["counts"] == want, (name, rank, gen["counts"], want)
            assert want["razer_matmul"] == 0  # every llama linear is eligible: no K1 launch
            _main_path_counts(gen["counts"])
        gen = ranks[0][name]["generate"]
        res["generate"] = {**_summary(gen), "share_equal_to_meshless_generate":
                           _share_equal(gen["outputs"], refs[name]["generate"]),
                           "per_rank_peak_memory_bytes": [r[name]["generate"]["peak_memory_bytes"] for r in ranks],
                           "per_rank_collective_s": [r[name]["generate"]["collectives"]["seconds"] for r in ranks]}
        for key in [k for k in ranks[0][name] if k.startswith("serve_k")]:
            k = int(key[len("serve_k"):])
            _check_ranks_agree([r[name] for r in ranks], key)
            for rank, r in enumerate(ranks):
                run = r[name][key]
                want = _serve_want(cfg, 2, policy, run["prefill_m"], run["decode_steps"], k, run["draft_steps"])
                assert run["counts"] == want, (name, key, rank, run["counts"], want)
                _main_path_counts(run["counts"])
            run = ranks[0][name][key]
            res[key] = {**_summary(run),
                        "share_equal_to_meshless_generate": _share_equal(
                            run["outputs"], refs[name]["generate_serve_prompts"]),
                        "per_rank_peak_memory_bytes": [r[name][key]["peak_memory_bytes"] for r in ranks],
                        "per_rank_collective_s": [r[name][key]["collectives"]["seconds"] for r in ranks]}
        out[name] = res
    detail["parallel_llama_tp2"] = out
    return out


def _parallel_dbrx(dev, detail):
    """6c: full-width dbrx_132b cut to 1 of 40 layers (each rank keeps the
    ~18 GB f32 tree for the draft; two ranks share the card), W4 + KV,
    two ranks over gloo on the (1, 2) mesh (K7 and K8) and the (2, 1) mesh
    (K6 on E/2 experts, all-to-all at prefill and replicated tokens at
    decode), against the meshless engine on the same weights: at the
    no-drop capacity factor n_experts / topk the float32 W4 prefill logits
    must agree within F32_LOGIT_RTOL of their largest magnitude; the bf16
    logits and tokens there, and
    everything at the published 1.25 (the mesh's dispatch groups change
    which slots drop), are reported."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    policy = _policies()["w4_kv"]
    raw = init_params(_dbrx_one_layer(1.25), seed=0, device=dev)
    ref = {}
    for cf in (1.25, 4.0):
        cfg = _dbrx_one_layer(cf)
        eng = Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=policy), device=dev)
        prompts = _generate_prompts(cfg)
        ref[cf] = {"prefill_logits": _prefill_logits(eng, prompts), "generate": eng.generate(prompts),
                   "serve": _run_serve(eng, cfg)["outputs"]}
        del eng
        if cf == 4.0:
            ref[cf]["f32_prefill_logits"] = _f32_prefill_logits(raw, cfg, prompts, device=dev)
    del raw
    torch.cuda.empty_cache()
    ranks = _spawn_ranks("dbrx")
    out = {"cut": {"num_layers": [40, 1]}, "backend": "gloo, both ranks on cuda:0; collectives staged through "
                                                      "host memory (their times are no measure of NCCL)"}
    for (layout, cf), res0 in ranks[0].items():
        cfg = _dbrx_one_layer(cf)
        for r in ranks[1:]:
            assert torch.equal(r[(layout, cf)]["prefill_logits"], res0["prefill_logits"]), "ranks' logits differ"
            for key in ("generate", "serve_k0"):
                assert r[(layout, cf)][key]["outputs"] == res0[key]["outputs"], f"{layout} {cf} {key}: ranks disagree"
        for rank, r in enumerate(ranks):
            gen, serve = r[(layout, cf)]["generate"], r[(layout, cf)]["serve_k0"]
            want = _generate_want(cfg, layout[1], policy, gen["stats"])
            assert gen["counts"] == want, (layout, cf, rank, gen["counts"], want)
            want = _serve_want(cfg, layout[1], policy, serve["prefill_m"], serve["decode_steps"])
            assert serve["counts"] == want, (layout, cf, rank, serve["counts"], want)
            _main_path_counts(gen["counts"])
            _main_path_counts(serve["counts"])
        diff = float((res0["prefill_logits"] - ref[cf]["prefill_logits"]).abs().max())
        row = {}
        if cf == 4.0:
            f32_ref = ref[cf]["f32_prefill_logits"]
            f32_diff = float((res0["f32_prefill_logits"] - f32_ref).abs().max())
            tol = F32_LOGIT_RTOL * float(f32_ref.abs().max())
            assert f32_diff <= tol, (layout, "f32 prefill logits", f32_diff, tol)
            row = {"w4_f32_max_abs_logit_diff_vs_meshless": f32_diff, "f32_logit_tolerance": tol}
        out[f"mesh_{layout[0]}x{layout[1]}_cf{cf}"] = {
            **row, "max_abs_logit_diff_vs_meshless": diff,
            "share_generate_equal_to_meshless": _share_equal(res0["generate"]["outputs"], ref[cf]["generate"]),
            "share_serve_equal_to_meshless_serve": _share_equal(res0["serve_k0"]["outputs"], ref[cf]["serve"]),
            "generate": _summary(res0["generate"]), "serve": _summary(res0["serve_k0"]),
            "per_rank_peak_memory_bytes": [max(r[(layout, cf)]["generate"]["peak_memory_bytes"],
                                               r[(layout, cf)]["serve_k0"]["peak_memory_bytes"]) for r in ranks]}
    detail["parallel_dbrx"] = out
    return out


# ---------------------------------------------------------------------------
# phase 3 (training): the backward kernels against autograd through the plain versions
# ---------------------------------------------------------------------------
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}  # of max |want|, as tests/test_torch_cuda_train.py


def _bwd_close(got, want, dtype, what):
    """max |got - want| within BWD_TOL[dtype] of max |want| (f32 inputs: f32
    sums in another order; bf16: bf16 outputs, and autograd through the
    plain version rounds P and dP to bf16 where the kernel keeps f32) ->
    the error relative to max |want|."""
    err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    assert err <= BWD_TOL[dtype] * scale, (what, err, scale)
    return err / scale


def _backward_ms(out, inputs, grad, reps):
    """Event ms of a backward alone: autograd.grad over a graph kept for
    repeats (the forward runs once, outside the timing)."""
    return _cuda_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), reps=reps, warmup=1)


ATTENTION_BWD_CASES = (  # (B, Sq, Skv, mask): phase 12's step, a batch of short rows, two masked cases
    (1, 4096, 4096, {}), (4, 512, 512, {}), (1, 2048, 2560, dict(window=1024, q_offset=512)),
    (1, 2048, 2048, dict(causal=False)))
# the wide heads of phase 12 (d): (name, (H, KVH, hd, dv), mask, B x S checked against the plain backward, B x S
# timed without it, B x S of the f32 body's check).  The plain backward keeps (H, S, kv_chunk) f32 scores a
# chunk, so MLA's 128 heads are checked at 2048 and timed at phase 12's 4096
ATTENTION_BWD_WIDE = (
    ("mla", (128, 128, 192, 128), {}, (1, 2048), (1, 4096), (1, 512)),
    ("recurrentgemma", (10, 1, 256, 256), dict(window=2048), (1, 4096), None, (1, 2600)),
)


def _kept_mask(sq, skv, dev, causal=True, window=0, q_offset=0):
    """(sq, skv) bool, True where K9's mask keeps the pair: query i at
    q_offset + i keeps keys j with j <= q_offset + i (causal) and j >
    q_offset + i - window."""
    qp = q_offset + torch.arange(sq, device=dev)[:, None]
    j = torch.arange(skv, device=dev)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= j <= qp
    if window:
        keep &= j > qp - window
    return keep


def _attention_bwd_case(dev, gen, b, sq, skv, heads, mask, dtype=torch.bfloat16, check=True):
    """K9's backward at B x Sq (queries) x Skv (keys), heads (H, KVH, hd,
    dv), q, K, V and dO in ``dtype`` (bf16: the tensor-core body; f32: the
    CUDA-core body): the bits of a repeat equal; with ``check`` dq, dk, dv
    against autograd through the plain version (``BWD_TOL``) and the plain
    backward timed; timed (event and profiler device ms of each of the
    call's kernels, ``pab.kernel_names``) beside the backward of
    F.scaled_dot_product_attention(enable_gqa=True) through autograd, each
    a backward alone: is_causal=True for a causal mask from 0, no mask for
    a non-causal one, else the kept pairs (``_kept_mask``) as a bool
    attn_mask; V and dO padded to hd where dv is narrower (MLA, as the
    forward's SDPA row).  Bound: the bytes of q, k, v, o, dO in and dq, dk,
    dv out, or 2 (3 hd + 2 dv) operations a kept (query, key) pair and head
    (S, dQ, dK at hd; dP, dV at dv) at the dtype's peak (bf16 tensor cores;
    f32 CUDA cores).  -> (errors relative to max |want| or None, row)."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention_bwd as pab
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda

    h, kvh, hd, dv = heads
    tag = f"{dtype} B{b}_S{sq}"
    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, skv, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, skv, kvh, dv), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, sq, h, dv), generator=gen, device=dev).to(dtype)
    o = prefill_attention_cuda(q, k, v, **mask)
    run = lambda: pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask)  # noqa: E731
    got = run()
    assert all(torch.equal(x, y) for x, y in zip(got, run())), f"K9's backward bits do not repeat ({tag} {heads})"
    reps = 5 if sq >= 2048 else 20
    errs = plain_ms = None
    if check:
        qp, kp, vp = (t.detach().requires_grad_(True) for t in (q, k, v))
        plain_out = ref.chunked_attention_ref(qp, kp, vp, **mask)
        want = torch.autograd.grad(plain_out, (qp, kp, vp), dout, retain_graph=True)
        errs = {n: _bwd_close(x, y, dtype, f"K9 bwd {n} {tag} {heads}") for n, x, y in
                zip(("dq", "dk", "dv"), got, want)}
        del want
        plain_ms = _backward_ms(plain_out, (qp, kp, vp), dout, reps=2)
        del plain_out, qp, kp, vp
    del got
    keep = _kept_mask(sq, skv, dev, **mask)
    pairs = b * int(keep.sum())
    causal_from_0 = mask.get("causal", True) and not mask.get("window") and not mask.get("q_offset")
    sdpa_mask = dict(is_causal=True) if causal_from_0 else {} if bool(keep.all()) else dict(attn_mask=keep)
    pad = lambda t: F.pad(t, (0, hd - dv))  # noqa: E731
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, pad(v)))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True, **sdpa_mask)
    library_ms = _backward_ms(lib_out, (ql, kl, vl), pad(dout).transpose(1, 2).contiguous(), reps=reps)
    del lib_out, keep, ql, kl, vl
    ops = 2 * (3 * hd + 2 * dv) * h * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + dout.numel()) * q.element_size()
    bound, by = _bound_ms(nbytes, ops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    row = {"relative_err": errs, "ms": _cuda_ms(run, reps=reps), "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound, "bound_by": by, "shape": [b, sq, skv, h, kvh, hd, dv], "mask": mask,
           "dtype": str(dtype).replace("torch.", ""), "kept_pairs": pairs, "operations": ops,
           "library_mask": "is_causal" if "is_causal" in sdpa_mask else "attn_mask" if sdpa_mask else "none"}
    names = pab.kernel_names(dtype)
    row["device_ms_by_kernel"] = {n: _device_ms(run, n)[0] for n in names}
    row["device_ms"] = row["device_ms_per_launch"] = _sum_or_none(row["device_ms_by_kernel"].values())
    row["launches_per_call"] = len(names)
    return errs, row


def _check_attention_bwd(cfg, dev, gen, detail, cases=ATTENTION_BWD_CASES):
    """K9's backward at llama3_2_3b's heads (24 / 8, hd 128), bf16 (its
    tensor-core body): causal at B 1 x 4096 (phase 12's step) and B 4 x
    512, then a window of 1024 at q_offset 512 and no causal mask; then at
    the wide heads phase 12 (d) trains (``ATTENTION_BWD_WIDE``): MLA's 128
    / 128 at hd 192 with V 128, causal, and RecurrentGemma's 10 / 1 at hd
    256 with its window of 2048, bf16 checked and timed, and the f32 body
    checked once at each width (``_attention_bwd_case``).  -> (the largest
    relative error, the first row, every row by tag)."""
    out, worst = {}, 0.0
    for b, sq, skv, mask in cases:
        tag = f"B{b}_S{sq}" + (f"_Skv{skv}" if skv != sq else "") + "".join(f"_{k}{int(v)}" for k, v in mask.items())
        errs, out[tag] = _attention_bwd_case(dev, gen, b, sq, skv, (cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.hd),
                                             mask)
        worst = max([worst, *errs.values()])
    for name, heads, mask, checked, timed, f32_checked in ATTENTION_BWD_WIDE:
        runs = [(checked, torch.bfloat16, True), (timed, torch.bfloat16, False), (f32_checked, torch.float32, True)]
        for (b, s), dtype, check in (r for r in runs if r[0] is not None):
            tag = f"{name}_B{b}_S{s}" + ("_f32" if dtype == torch.float32 else "")
            errs, out[tag] = _attention_bwd_case(dev, gen, b, s, s, heads, mask, dtype=dtype, check=check)
            worst = max([worst, *(errs or {}).values()])
            torch.cuda.empty_cache()
    for tag, row in out.items():
        detail[f"prefill_attention_bwd_{tag}"] = row
    return worst, out[next(iter(out))], out


def _check_rms_norm_bwd(cfg, dev, gen, detail, ms=(4, 4096)):
    """K10's backward at d_model 3072, bf16 x and dy, f32 gamma, M 4 and 4096
    (phase 12's rows): dx and dgamma against autograd through the plain
    version (``BWD_TOL``), a repeat's bits equal; timed beside the plain
    version's backward and F.rms_norm's (gain 1 + gamma in f32, the same
    function), each a backward alone.  Bound: x and dy read, dx written
    (bf16), gamma read and dgamma written (f32)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rms_norm_bwd as rnb

    d = cfg.d_model
    gamma = torch.randn(d, generator=gen, device=dev) * 0.1
    out, worst = {}, 0.0
    for m in ms:
        x = (torch.randn((m, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
        dy = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        run = lambda: rnb.rms_norm_bwd_cuda(x, gamma, dy, cfg.norm_eps)  # noqa: E731
        got = run()
        again = run()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), "K10's backward bits do not repeat"
        xp, gp = x.detach().requires_grad_(True), gamma.detach().requires_grad_(True)
        plain_out = ref.rms_norm_ref(xp, gp, cfg.norm_eps)
        want = torch.autograd.grad(plain_out, (xp, gp), dy, retain_graph=True)
        errs = {n: _bwd_close(a, w, torch.bfloat16, f"K10 bwd {n} M {m}") for n, a, w in
                zip(("dx", "dgamma"), got, want)}
        worst = max(worst, *errs.values())
        xl, gl = x.detach().requires_grad_(True), (1.0 + gamma).detach().requires_grad_(True)
        lib_out = F.rms_norm(xl, (d,), weight=gl, eps=cfg.norm_eps)
        bound, by = _bound_ms(3 * m * d * 2 + 2 * d * 4, 0.0)
        row = {"relative_err": errs, "ms": _cuda_ms(run, reps=50),
               "plain_ms": _backward_ms(plain_out, (xp, gp), dy, 20), "library_ms": _backward_ms(lib_out, (xl, gl), dy, 50), "bound_ms": bound, "bound_by": by,
               "shape": [m, d]}
        row["device_ms_by_kernel"] = {n: _device_ms(run, n)[0] for n in rnb.kernel_names()}
        row["device_ms"] = row["device_ms_per_launch"] = _sum_or_none(row["device_ms_by_kernel"].values())
        row["launches_per_call"] = len(rnb.kernel_names())
        out[m] = row
        detail[f"rms_norm_bwd_M{m}"] = row
    return worst, out[ms[0]], out


# ---------------------------------------------------------------------------
# phase 12: training
# ---------------------------------------------------------------------------
TRAIN_TOKENS = (1, 4096)  # (batch, sequence) of a full-width step
TRAIN_STEPS = 3
TRAIN_LR = 1e-4


def _train_want(cfg, policy, steps: int = 1):
    """Exact launches of ``steps`` train steps under remat "full": each
    layer's forward runs twice (the step's forward, then the backward's
    recompute of the layer from its input), so K9 runs 2 an attention layer
    (every layer of a GQA or MLA stack; a hybrid's "a" layers, none on its
    RG-LRU "r" layers), K10 2 per layer norm (ln1 and ln2; MLA's kv_norm
    and, with a low-rank query, q_norm too) plus the final norm once
    (outside the checkpointed layers); the backward runs K9's backward
    kernel once an attention layer and K10's once a norm; under W4A4 K2
    runs before each of a GQA layer's 7 linears in both forwards (a
    gradient never reaches it: the straight-through estimator), counted for
    a plain GQA stack only."""
    from repro_torch.models.transformer import layer_groups

    types = [t for t, count in layer_groups(cfg) for _ in range(count)]
    assert set(types) <= {"a", "r"}, f"launches a train step are counted for 'a' and 'r' layers, not {set(types)}"
    assert policy.act is None or (set(types) == {"a"} and not cfg.mla), \
        f"K2's launches a train step are counted for a GQA stack's 7 linears a layer, not {cfg.name}'s"
    attention = sum(t != "r" for t in types)
    norms = len(types) * (2 + (1 + int(bool(cfg.q_lora_rank)) if cfg.mla else 0)) + 1
    want = dict.fromkeys(_read_counts(), 0)
    want.update(prefill_attention=2 * attention * steps, rms_norm=(2 * norms - 1) * steps,
                razer_act_qdq=(2 * 7 * len(types) * steps if policy.act is not None else 0))
    return want, {"prefill_attention_bwd": attention * steps, "rms_norm_bwd": norms * steps}


def _train_batches(cfg, steps, b, s):
    from repro_torch.train.data import DataConfig, SyntheticLM

    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
    return [ds.batch(i) for i in range(steps)]


def _train_at_width(cfg, policies, dev):
    """``cfg`` (published widths) trained on the card from random weights
    (seed 0): f32 params and AdamW moments, bf16 compute, remat "full", B x
    S = ``TRAIN_TOKENS`` of the synthetic Markov data a step, ``policies``
    ((name, QuantPolicy, steps), ...) in turn; each step's loss and
    gradient norm finite, exact launches a step (``_train_want``), step
    seconds (host clock to a synchronize), tokens/s, model FLOPs (6 N D)
    over step time against 989 TFLOP/s; a parameter of the first layer
    moved; the peak memory."""
    from repro_torch.launch.costmodel import PEAK_FLOPS, model_flops
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.train.tree import tree_leaves

    b, s = TRAIN_TOKENS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    probe_leaf = next(t for t in tree_leaves(params["layers_0"][0]) if t.dim() == 2)
    probe = probe_leaf[:4, :4].clone()
    flops = model_flops(cfg, s, b, "train")
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=sum(n for _, _, n in policies))
    batches = _train_batches(cfg, sum(n for _, _, n in policies), b, s)
    out = {"arch": cfg.name, "num_layers": cfg.num_layers, "tokens_per_step": b * s, "batch_seq": [b, s],
           "model_flops_per_step": flops, "init_s": init_s, "lr": TRAIN_LR, "remat": "full"}
    i = 0
    for name, policy, n_steps in policies:
        step = make_train_step(cfg, None, ocfg, policy)
        rows = []
        for _ in range(n_steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}
            i += 1
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts, train_counts = _main_path_counts(), _main_path_train_counts()
            want, train_want = _train_want(cfg, policy)
            assert counts == want and train_counts == train_want, (cfg.name, name, counts, want, train_counts,
                                                                   train_want)
            assert np.isfinite(loss) and np.isfinite(gnorm), (cfg.name, name, loss, gnorm)
            rows.append({"loss": loss, "grad_norm": gnorm, "lr": float(m["lr"]), "step_s": dt,
                         "tokens_per_s": b * s / dt, "model_flop_share": flops / dt / PEAK_FLOPS})
        steady = sorted(r["step_s"] for r in rows[1:] or rows)[len(rows[1:] or rows) // 2]
        out[name] = {"steps": rows, "median_step_s_after_first": steady, "tokens_per_s": b * s / steady,
                     "model_flop_share": flops / steady / PEAK_FLOPS,
                     "launches_per_step": {**want, **train_want}}
        print(f"train {cfg.name} full width ({cfg.num_layers} layers), {name}: " + json.dumps(out[name]), flush=True)
    moved = float((probe_leaf[:4, :4] - probe).abs().max())
    assert moved > 0, f"the parameters of {cfg.name} did not move"
    out["param_moved_max_abs"] = moved
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, probe_leaf
    torch.cuda.empty_cache()
    return out


def _train_full_width(dev, detail):
    """Phase 12 (a): llama3_2_3b at full width and depth (``_train_at_width``):
    3 steps under bf16, 3 under fakequant(ste=True) (RaZeR weight QAT) and
    1 under W4A4 QAT (K2 on the path)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy

    policies = (("bf16", QuantPolicy.bf16(), TRAIN_STEPS), ("qat_w4", QuantPolicy.fakequant(ste=True), TRAIN_STEPS),
                ("qat_w4a4", QuantPolicy.fakequant(act_format="razer", ste=True), 1))
    out = _train_at_width(get_config("llama3_2_3b"), policies, dev)
    detail["train_full_width"] = out
    return out


# phase 12 (d): (arch, layers trained): DeepSeek-V2 keeps its first layer,
# the dense one (an MoE layer's 3.78 B expert parameters alone need 60 GB of
# f32 parameters, gradients and moments); RecurrentGemma all 26
TRAIN_WIDE = (("deepseek_v2_236b", 1), ("recurrentgemma_2b", None))
TRAIN_WIDE_STEPS = 2


def _train_wide(dev, detail):
    """Phase 12 (d): the archs whose attention K9's backward runs at its wide
    heads, at their published widths (``_train_at_width``): MLA's hd 192
    with V 128 (``deepseek_v2_236b``, cut as ``TRAIN_WIDE`` says) and hd 256
    with a window of 2048 on RecurrentGemma's attention layers, with its
    RG-LRU scan and conv through autograd; ``TRAIN_WIDE_STEPS`` steps under
    bf16, then as many under fakequant(ste=True)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy

    policies = (("bf16", QuantPolicy.bf16(), TRAIN_WIDE_STEPS),
                ("qat_w4", QuantPolicy.fakequant(ste=True), TRAIN_WIDE_STEPS))
    out = {}
    for arch, layers in TRAIN_WIDE:
        cfg = get_config(arch)
        cut = None
        if layers is not None:
            cut = {"num_layers": [cfg.num_layers, layers]}
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out[arch] = {**_train_at_width(cfg, policies, dev), "cut": cut}
    detail["train_wide"] = out
    return out


def _train_steps(cfg, dev, params, steps, policy=None):
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step

    step = make_train_step(cfg, None, AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps),
                           policy or QuantPolicy.bf16())
    opt, losses = init_opt_state(params), []
    for batch in _train_batches(cfg, steps, 2, 64):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return params, losses


def _train_card_vs_cpu(dev, cfg=None):
    """Phase 12 (b) and (e): ``cfg`` (reduced llama3_2_3b) in f32, 3 steps of
    2 x 64 tokens on the card and on the CPU from the same init: losses
    within 1e-5 relative; parameters within 4 x the summed learning rate
    (an element whose gradient is near 0 can flip its Adam update's sign,
    about 2 lr a step), and all but 0.1 % within 1e-6; the card's launches
    (K9's backward among them where the model has attention)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg or get_config("llama3_2_3b").reduced(), compute_dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    _reset_counts()
    card, card_losses = _train_steps(cfg, dev, tree_map(lambda t: t.to(dev, copy=True), cpu), TRAIN_STEPS)
    launches = {**_read_counts(), **{n: getattr(f, a) for n, (f, a) in _train_counters().items()}}
    assert launches["prefill_attention_bwd"] > 0, (cfg.name, launches)
    cpu, cpu_losses = _train_steps(cfg, torch.device("cpu"), cpu, TRAIN_STEPS)
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(card_losses, cpu_losses))
    diffs = torch.cat([(a.cpu() - c).abs().flatten() for a, c in zip(tree_leaves(card), tree_leaves(cpu))])
    row = {"arch": cfg.name, "card_losses": card_losses, "cpu_losses": cpu_losses, "loss_max_rel_diff": loss_rel,
           "param_max_abs_diff": float(diffs.max()), "param_share_beyond_1e-6": float((diffs > 1e-6).float().mean()),
           "param_bound": 4 * TRAIN_STEPS * TRAIN_LR, "card_launches": {k: n for k, n in launches.items() if n}}
    assert loss_rel <= 1e-5, row
    assert row["param_max_abs_diff"] <= row["param_bound"] and row["param_share_beyond_1e-6"] <= 1e-3, row
    return row


def _train_wide_card_vs_cpu(dev):
    """Phase 12 (e): each arch of phase 12 (d) narrow at its real head
    widths, card against CPU as (b): deepseek_v2_236b reduced at MLA's hd
    192 with V 128 and a low-rank query (``_zoo_narrow_cfg``), and
    recurrentgemma_2b reduced at head_dim 256 with a window of 24 (the
    64-token rows outrun it)."""
    from repro_torch.configs import get_config

    cfgs = {"deepseek_v2_236b": _zoo_narrow_cfg("deepseek_v2_236b"),
            "recurrentgemma_2b": dataclasses.replace(get_config("recurrentgemma_2b").reduced(), head_dim=256,
                                                     window=24)}
    return {arch: _train_card_vs_cpu(dev, cfg) for arch, cfg in cfgs.items()}


def _train_launcher_and_restart(dev):
    """Phase 12 (c), reduced llama3_2_3b on the card: ``launch.train --steps
    4 --ckpt-every 2`` writes checkpoints at steps 2 and 4, ``launch.serve
    --ckpt`` serves from the newest; a ``ResilientLoop`` of 4 steps
    (checkpoint every 2) with a ``NodeFailure`` injected at step 3 restarts
    from step 2 and ends with the parameters of an uninterrupted run, bit
    for bit (no kernel of the step sums with atomics)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import FailureInjector, ResilientLoop
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.train.tree import tree_leaves

    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "launcher")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            train.main(["--arch", "llama3_2_3b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "64",
                        "--ckpt-every", "2", "--ckpt-dir", d, "--device", dev.type])
            serve.main(["--arch", "llama3_2_3b", "--reduced", "--ckpt", d, "--requests", "2", "--max-new", "4",
                        "--device", dev.type])
        text = log.getvalue()
        assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"], os.listdir(d)
        assert "step     0 loss" in text and "restored params from step 4" in text and "prompt[" in text, text
        row["launcher_output"] = text.splitlines()

        cfg = get_config("llama3_2_3b").reduced()
        step = make_train_step(cfg, None, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
        batches = _train_batches(cfg, 4, 2, 64)

        def step_fn(state, i):
            p, o, _ = step(state["params"], state["opt"],
                           {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()})
            return {"params": p, "opt": o}

        def run(directory, injector):
            params = init_params(cfg, seed=0, device=dev)
            loop = ResilientLoop(CheckpointManager(directory, every=2), injector=injector)
            state, end = loop.run({"params": params, "opt": init_opt_state(params)}, step_fn, start_step=0,
                                  num_steps=4)
            return state, end, loop.restarts

        clean, end_clean, _ = run(os.path.join(tmp, "clean"), None)
        failed, end_failed, restarts = run(os.path.join(tmp, "failed"), FailureInjector(fail_at_steps=(3,)))
        assert end_clean == end_failed == 4 and restarts == 1
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(clean), tree_leaves(failed))), \
            "the restarted run's state differs from the uninterrupted run's"
        row["resilient_loop"] = {"restarts": restarts, "failed_at": 3, "end_step": end_failed, "state_equal": True}
    return row


# ---------------------------------------------------------------------------
# phase 12 (f): training on a mesh
# ---------------------------------------------------------------------------
MESH_TRAIN_LAYERS = 7  # (a): llama3_2_3b's first 7 of 28 layers, on one NCCL rank
MESH_TRAIN_RANK_LAYERS = 2  # (b): its first 2, on two ranks sharing the card
MESH_TRAIN_RANK_TOKENS = (2, 1024)  # (b)'s global batch: 2 rows, so the (2, 1) mesh splits it
# (b)'s W4A4 step against the meshless one.  The mesh sums in another
# order, and a K2 block whose absmax sits on a boundary of the E4M3 scale
# grid, or one of whose elements sits on a boundary of the FP4 grid, moves
# a whole quantization step (ROADMAP C.1), which the next layers carry into
# more blocks.  tools/mesh_w4a4_flips.py on an NVIDIA H100 80GB HBM3 at
# 700 W: pinning the 3.4-6.9 k blocks of the step's 6.8-10.7 M a rank whose
# output differs (0.3-0.7 k of them by their scale) brings the loss within
# 4.6e-7 and the gradient norm within 8.7e-6 of the meshless step;
# unpinned, on this batch and three more on both meshes, the loss reads
# 1.8-5.9e-4 and the gradient norm 5.5e-4-3.5e-3 apart (relative), and
# 0.196-0.233 % of the parameters lie beyond 1e-6 of the meshless run's
# after the step.  The bounds are 2.5x, 2x and 2.1x the largest reading;
# the largest parameter difference keeps the other steps' bound.
MESH_TRAIN_W4A4_RTOL = (1.5e-3, 7e-3)  # (loss, gradient norm), relative
MESH_TRAIN_W4A4_SHARE = 5e-3  # of the parameters beyond 1e-6 after the W4A4 step


def _mesh_train_policies(w4a4: bool):
    from repro_torch.core.policy import QuantPolicy

    pols = [("bf16", QuantPolicy.bf16(), 2), ("qat_w4", QuantPolicy.fakequant(ste=True), 1)]
    if w4a4:
        pols.append(("qat_w4a4", QuantPolicy.fakequant(act_format="razer", ste=True), 1))
    return pols


def _mesh_train_run(cfg, mesh, params, opt, batches, w4a4, dev, counted=True, first=0):
    """The steps ``first`` ... ``len(batches) - 1`` of the policies of
    ``_mesh_train_policies`` in turn (one batch a step), one AdamW state
    (``opt``, a new one if None) whose schedule runs over all of
    ``batches``: meshless (``mesh`` None) or through ``bind_train_step``;
    each step's loss, gradient norm, seconds (host clock to a synchronize)
    and launches (``counted``: exact, as ``_train_want`` says)."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import bind_train_step, make_train_step

    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=sum(n for *_, n in _mesh_train_policies(True)))
    opt = init_opt_state(params) if opt is None else opt
    rows, i = [], 0
    for name, policy, n in _mesh_train_policies(w4a4):
        step = (make_train_step(cfg, None, ocfg, policy) if mesh is None else
                bind_train_step(cfg, mesh, None, ocfg, policy)[0])
        for _ in range(n):
            i += 1
            if i <= first:
                continue
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[i - 1].items()}
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            row = {"policy": name, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "loss_bits": np.float32(m["loss"].cpu()).tobytes().hex(),
                   "grad_norm_bits": np.float32(m["grad_norm"].cpu()).tobytes().hex(),
                   "step_s": time.perf_counter() - t0}
            if counted:
                counts, train_counts = _read_counts(), {n_: getattr(f, a) for n_, (f, a) in _train_counters().items()}
                want, train_want = _train_want(cfg, policy)
                assert counts == want and train_counts == train_want, (name, counts, want, train_counts, train_want)
                row["launches"] = {**counts, **train_counts}
            rows.append(row)
    return params, opt, rows


def _train_world1_nccl(dev, detail):
    """12 (f) (a): llama3_2_3b at full width cut to ``MESH_TRAIN_LAYERS``,
    1 x 4096 tokens a step, bf16 compute: 2 bf16 steps and 1 weight-QAT
    step meshless, then the same through ``bind_train_step`` on a (1, 1)
    mesh, a world of one rank over NCCL: every loss and gradient norm, and
    every parameter and moment at the end, bit for bit; exact launches a
    step on both."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.train.trainstep import bind_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    full = get_config("llama3_2_3b")
    cfg = dataclasses.replace(full, num_layers=MESH_TRAIN_LAYERS)
    init = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_train_nccl_"), "pg_init")
    mesh = make_test_mesh((1, 1), backend="nccl", device="cuda", init_method=f"file://{init}", rank=0, world_size=1)
    b, s = TRAIN_TOKENS
    batches = _train_batches(cfg, 3, b, s)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    ref, ref_opt, ref_rows = _mesh_train_run(cfg, None, tree_map(torch.clone, params), None, batches, False, dev)
    for r in ref_rows:
        _main_path_counts(r["launches"])
    p_shard = bind_train_step(cfg, mesh, None)[1]
    local = local_tree(params, p_shard, mesh)
    del params
    got, got_opt, rows = _mesh_train_run(cfg, mesh, local, None, batches, False, dev)
    for r in rows:
        _main_path_counts(r["launches"])
    identical = all(torch.equal(x, y) for x, y in zip(tree_leaves((got, got_opt)), tree_leaves((ref, ref_opt))))
    dist.destroy_process_group()
    out = {"backend": "nccl", "mesh": [1, 1], "cut": {"num_layers": [full.num_layers, cfg.num_layers]},
           "batch_seq": [b, s], "params_and_moments_bit_identical": identical, "steps": rows,
           "meshless_steps": ref_rows, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train on a mesh, (a) world of one over NCCL, llama3_2_3b full width cut to "
          f"{MESH_TRAIN_LAYERS} layers, against meshless: " + json.dumps(out), flush=True)
    for a, r in zip(rows, ref_rows):
        assert (a["loss_bits"], a["grad_norm_bits"]) == (r["loss_bits"], r["grad_norm_bits"]), (a, r)
    assert identical, "the (1, 1) mesh's parameters or moments differ from the meshless step's"
    del got, got_opt, ref, ref_opt, local
    torch.cuda.empty_cache()
    return out


def _expected_shard_elems(cfg, data, model):
    """Each rank's parameter elements on a (data, model) mesh, from the
    reference's rules restated (``parallel/sharding.py::_PARAM_RULES``):
    the embedding (vocab on model, d on data), every linear (d_in on data,
    d_out on model), norms whole; an axis that does not divide a dim
    leaves it whole."""
    def split(n, k):
        return n // k if n % k == 0 else n

    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    linears = [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)]
    layer = 2 * d + sum(split(i, data) * split(o, model) for i, o in linears)
    return split(cfg.vocab_size, model) * split(d, data) + d + cfg.num_layers * layer


def _rank_train(rank, world, init, device: str = "cuda"):
    """Rank side of 12 (f) (b): llama3_2_3b at full width cut to
    ``MESH_TRAIN_RANK_LAYERS`` in f32 compute on the (1, 2) mesh, then the
    (2, 1) mesh, over gloo on the shared card: 2 bf16 steps, 1 weight-QAT
    step and 1 W4A4-QAT step from the seed-0 weights, each rank holding its
    shards; exact launches a step; the local parameter and moment bytes;
    the parameters gathered whole against rank 0's meshless run of the same
    steps (held there); peak memory, step seconds, collectives."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import bind_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    full = get_config("llama3_2_3b")
    cfg = dataclasses.replace(full, num_layers=MESH_TRAIN_RANK_LAYERS, compute_dtype="float32")
    b, s = MESH_TRAIN_RANK_TOKENS
    batches = _train_batches(cfg, 4, b, s)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out, ref = {}, None
    for layout in ((1, 2), (2, 1)):
        mesh = make_test_mesh(layout, backend="gloo", device=device, init_method=f"file://{init}", rank=rank,
                              world_size=world)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        whole = init_params(cfg, seed=0, device=dev)
        if rank == 0 and ref is None:  # the meshless run, its parameters before and after the W4A4 step
            p, o, rows = _mesh_train_run(cfg, None, tree_map(torch.clone, whole), None, batches[:3], False, dev,
                                         counted=False)
            before = tree_map(lambda t: t.to("cpu", copy=True), p)
            p, _, last = _mesh_train_run(cfg, None, p, o, batches, True, dev, counted=False, first=3)
            ref = (before, tree_map(lambda t: t.to("cpu", copy=True), p), rows + last)
            del p, o
        p_shard = bind_train_step(cfg, mesh, None)[1]
        params = local_tree(whole, p_shard, mesh)
        del whole
        opt = init_opt_state(params)
        nbytes = {"params": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
                  "m": sum(t.numel() * t.element_size() for t in tree_leaves(opt.m)),
                  "v": sum(t.numel() * t.element_size() for t in tree_leaves(opt.v))}
        want = 4 * _expected_shard_elems(cfg, *layout)
        assert nbytes == {"params": want, "m": want, "v": want}, (layout, nbytes, want)
        collectives.stats.update(calls=0, seconds=0.0)
        params, opt, rows = _mesh_train_run(cfg, mesh, params, opt, batches[:3], False, dev)
        res = {"param_diff": {}}
        res["param_diff"]["before_w4a4"] = _gathered_diff(params, p_shard, mesh, ref and ref[0])
        params, opt, last = _mesh_train_run(cfg, mesh, params, opt, batches, True, dev, first=3)
        res["param_diff"]["after_w4a4"] = _gathered_diff(params, p_shard, mesh, ref and ref[1])
        res.update(rows=rows + last, local_bytes=nbytes, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   collectives=dict(collectives.stats), meshless_rows=ref and ref[2])
        out[layout] = res
        del params, opt
        torch.cuda.empty_cache()
    return out


def _gathered_diff(params, p_shard, mesh, want):
    """|the mesh's parameters gathered whole - ``want``| (rank 0 holds
    ``want``, the meshless run's, on the host): the largest, and the share
    above 1e-6; None on the other ranks."""
    from repro_torch.bridge import gather_tree
    from repro_torch.train.tree import tree_leaves

    whole = gather_tree(params, p_shard, mesh)
    if want is None:
        return None
    diffs = torch.cat([(a.cpu() - c).abs().flatten() for a, c in zip(tree_leaves(whole), tree_leaves(want))])
    return {"max_abs": float(diffs.max()), "share_beyond_1e-6": float((diffs > 1e-6).float().mean())}


def _train_two_ranks(detail):
    """12 (f) (b), the parent's side, printed before it asserts: every
    rank's loss and gradient norm the same bits; each within the step
    bounds of the meshless run (losses 1e-5 relative, gradient norms 1e-4;
    the W4A4 step within ``MESH_TRAIN_W4A4_RTOL``); the parameters gathered
    after the third step within 4 x the summed learning rate and all but
    0.1 % within 1e-6, after the W4A4 step within 4 x the summed learning
    rate and all but ``MESH_TRAIN_W4A4_SHARE`` within 1e-6; each rank's
    launches added to the kernels line's totals."""
    ranks = _spawn_ranks("train")
    out = {"backend": "gloo, both ranks on cuda:0; collectives staged through host memory (their times are no "
                      "measure of NCCL)", "cut": {"num_layers": [28, MESH_TRAIN_RANK_LAYERS]},
           "batch_seq": list(MESH_TRAIN_RANK_TOKENS), "compute_dtype": "float32"}
    for layout in ((1, 2), (2, 1)):
        res = [r[layout] for r in ranks]
        out[f"mesh_{layout[0]}x{layout[1]}"] = {
            "steps": res[0]["rows"], "meshless_steps": res[0]["meshless_rows"], "param_diff": res[0]["param_diff"],
            "per_rank_local_bytes": [r["local_bytes"] for r in res],
            "per_rank_peak_memory_gb": [r["peak_memory_gb"] for r in res],
            "per_rank_step_s": [[x["step_s"] for x in r["rows"]] for r in res],
            "per_rank_collectives": [r["collectives"] for r in res]}
    print(f"train on a mesh, (b) llama3_2_3b full width cut to {MESH_TRAIN_RANK_LAYERS} layers, f32, on (1, 2) "
          "and (2, 1), two ranks sharing one card over gloo: " + json.dumps(out), flush=True)
    for layout in ((1, 2), (2, 1)):
        res = [r[layout] for r in ranks]
        for r in res:
            assert [(x["loss_bits"], x["grad_norm_bits"]) for x in r["rows"]] == \
                [(x["loss_bits"], x["grad_norm_bits"]) for x in res[0]["rows"]], f"{layout}: ranks disagree"
            for x in r["rows"]:
                _main_path_counts(x["launches"])
        for x, w in zip(res[0]["rows"], res[0]["meshless_rows"]):
            rtol = MESH_TRAIN_W4A4_RTOL if x["policy"] == "qat_w4a4" else (1e-5, 1e-4)
            assert abs(x["loss"] - w["loss"]) <= rtol[0] * abs(w["loss"]), (layout, x, w)
            assert abs(x["grad_norm"] - w["grad_norm"]) <= rtol[1] * w["grad_norm"], (layout, x, w)
        before, after = res[0]["param_diff"]["before_w4a4"], res[0]["param_diff"]["after_w4a4"]
        assert before["max_abs"] <= 4 * 3 * TRAIN_LR and before["share_beyond_1e-6"] <= 1e-3, (layout, before)
        assert after["max_abs"] <= 4 * 4 * TRAIN_LR and after["share_beyond_1e-6"] <= MESH_TRAIN_W4A4_SHARE, \
            (layout, after)
    return out


def _train_mesh(dev, detail):
    """Phase 12 (f): training on a mesh, (a) then (b); each prints its line
    before it asserts."""
    out = {"world1_nccl": _train_world1_nccl(dev, detail)}
    out["two_ranks"] = _train_two_ranks(detail)
    detail["train_mesh"] = out
    return out


def _training(dev, detail):
    """Phase 12: (a) full-width training steps, (b) narrow card vs CPU, (c)
    the launchers and a restart from a checkpoint, (d) MLA and
    RecurrentGemma at their published widths, (e) both narrow card vs
    CPU, (f) training on a mesh."""
    out = {"full_width": _train_full_width(dev, detail)}
    out["card_vs_cpu"] = _train_card_vs_cpu(dev)
    print("train card vs cpu (reduced llama3_2_3b, f32, 3 steps): " + json.dumps(out["card_vs_cpu"]), flush=True)
    out["launcher"] = _train_launcher_and_restart(dev)
    print("train launcher -> serve --ckpt, resilient loop (reduced llama3_2_3b): " + json.dumps(out["launcher"]),
          flush=True)
    t0 = time.perf_counter()
    out["wide"] = _train_wide(dev, detail)
    detail["phase_s"]["12 (d) MLA and RecurrentGemma at published widths (inside 12)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["wide_card_vs_cpu"] = _train_wide_card_vs_cpu(dev)
    detail["phase_s"]["12 (e) narrow card vs cpu (inside 12)"] = time.perf_counter() - t0
    print("train card vs cpu (narrow deepseek_v2_236b at hd 192 / V 128, recurrentgemma_2b at hd 256, f32, 3 "
          "steps): " + json.dumps(out["wide_card_vs_cpu"]), flush=True)
    t0 = time.perf_counter()
    out["mesh"] = _train_mesh(dev, detail)
    detail["phase_s"]["12 (f) training on a mesh (inside 12)"] = time.perf_counter() - t0
    detail["training"] = {k: v for k, v in out.items() if k not in ("full_width", "wide", "mesh")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write every measured number to this JSON file")
    args = ap.parse_args()

    smi = _require_cuda()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build  # fails outside a checkout of the repo

    print(smi)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    detail = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    phase_s, last = {}, [time.perf_counter()]

    def mark(phase):  # seconds since the previous mark, by phase
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now

    detail["phase_s"] = phase_s
    build_s = build.build_all()
    mark("1-2 device, build")
    ptxas = {n: _ptxas_report(log) for n, log in build.build_log.items()}
    detail["build_s"], detail["ptxas"] = build_s, ptxas
    print(f"build: {build_s:.1f} s for {sorted(ptxas)}; ptxas: {json.dumps(ptxas)}")
    tile_smem = build.function("razer_matmul", "razer_matmul_tile_smem", [ctypes.c_int])
    from repro_torch.kernels.razer_matmul import TOKEN_TILES

    detail["gemm_tile_dynamic_smem_bytes"] = {nt: tile_smem(nt) for nt in TOKEN_TILES}
    print("packed GEMM tile (K1/K6/K7/K8), dynamic shared memory by token tile: "
          + json.dumps(detail["gemm_tile_dynamic_smem_bytes"]))

    from repro_torch.configs import get_config

    cfg = get_config("llama3_2_3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = {"razer_matmul": _check_matmul(cfg, dev, gen, detail),
              "razer_act_qdq": _check_act_qdq(cfg, dev, gen, detail),
              "razer_matmul_fused_act": _check_fused_act(cfg, dev, gen, detail),
              "prefill_attention": _check_prefill_attention(cfg, dev, gen, detail),
              "rms_norm": _check_rms_norm(cfg, dev, gen, detail),
              "razer_kv_attention": _check_kv_attention(cfg, dev, gen, detail),
              **_check_paged_attention(cfg, dev, gen, detail)}
    print("decode attention at long lengths (K3, K4, K5; llama3_2_3b heads): "
          + json.dumps(_check_attention_long(cfg, dev, gen, detail)))
    banks = _expert_banks(dev, gen, detail)
    checks["razer_grouped_matmul"] = _check_grouped_matmul(dev, gen, detail, banks)
    checks["razer_grouped_matmul_kshard"] = _check_kshard_grouped(dev, gen, detail, banks)
    del banks
    torch.cuda.empty_cache()
    checks["razer_matmul_kshard"] = _check_kshard_matmul(cfg, dev, gen, detail)
    torch.cuda.empty_cache()
    k9_err, k9_zoo = _check_prefill_attention_zoo(dev, gen, detail)
    checks["prefill_attention"] = (max(checks["prefill_attention"][0], k9_err), checks["prefill_attention"][1])
    print("prefill attention (K9) at the zoo's shapes, MLA hd 192 with V 128 and whisper without the causal mask: "
          + json.dumps(k9_zoo))
    torch.cuda.empty_cache()
    k9_err, k9_window = _check_prefill_attention_window(dev, gen, detail)
    checks["prefill_attention"] = (max(checks["prefill_attention"][0], k9_err), checks["prefill_attention"][1])
    print("prefill attention (K9) at RecurrentGemma's attention, hd 256 with window 2048: " + json.dumps(k9_window))
    torch.cuda.empty_cache()
    print("kernels vs plain: " + json.dumps({k: {"max_abs_err": v[0], **v[1]} for k, v in checks.items()}))
    print("K1 split-K from (N, K) vs one split at M=128: " + json.dumps(_split_k_cost(cfg, dev, gen, detail)))
    mark("3 kernels")
    bwd_err, bwd_row, bwd_rows = _check_attention_bwd(cfg, dev, gen, detail)
    checks["prefill_attention_bwd"] = (bwd_err, bwd_row)
    print("prefill attention backward (K9 bwd) at llama3_2_3b heads, bf16 (tensor-core body), causal and masked; "
          "at MLA's hd 192 / V 128 and RecurrentGemma's hd 256 with window 2048, bf16 and f32: "
          + json.dumps(bwd_rows))
    bwd_err, bwd_row, bwd_rows = _check_rms_norm_bwd(cfg, dev, gen, detail)
    checks["rms_norm_bwd"] = (bwd_err, bwd_row)
    print("RMSNorm backward (K10 bwd) at d 3072, bf16: " + json.dumps({f"M{m}": r for m, r in bwd_rows.items()}))
    torch.cuda.empty_cache()
    mark("3 backward kernels (K9 bwd, K10 bwd)")
    print("kernels at the paper models' shapes: " + json.dumps(_paper_shapes(dev, gen, detail)))
    torch.cuda.empty_cache()
    mark("3 kernels at the paper models' shapes")
    print("kernels at the zoo's shapes: " + json.dumps(_zoo_shapes(dev, gen, detail)))
    torch.cuda.empty_cache()
    mark("3 kernels at the zoo's shapes")
    print("kernels at the recurrent archs' shapes: " + json.dumps(_recurrent_shapes(dev, gen, detail)))
    torch.cuda.empty_cache()
    mark("3 kernels at the recurrent archs' shapes")

    cut_cfg = _llama_cut_cfg()
    cut_engines, pack_s = _engines(cut_cfg, dev)
    _llama_phase4(cut_cfg, cut_engines, detail, pack_s)
    mark("4, 4b, 4c llama3_2_3b generate, paged, serve")
    print(f"disaggregated serve llama3_2_3b full width cut to {cut_cfg.num_layers} layers, 2 prefill + 2 decode "
          "replicas: " + json.dumps(_disagg(cut_cfg, cut_engines, detail)))
    mark("4f disagg")
    eng = cut_engines["w4_kv"]
    short_cfg = eng.scfg
    eng.scfg = dataclasses.replace(short_cfg, max_len=4096)
    detail["long_context"] = _long_context(cut_cfg, eng)
    long_serve = detail["long_context"]["serve"]
    assert long_serve["share_equal_to_generate"] == 1.0, ("long-context serve != generate",
                                                          long_serve["differs_from_generate"])
    print(f"long context llama3_2_3b full width cut to {cut_cfg.num_layers} layers, W4 + KV, max_len 4096: "
          + json.dumps(detail["long_context"]))
    mark("4e long context")
    print("disaggregated serve of the long requests, W4 + KV, chunk_tokens 512: "
          + json.dumps(_disagg_long(cut_cfg, eng, detail, detail["long_context"])))
    eng.scfg = short_cfg
    mesh_refs = _meshless_llama_refs(cut_cfg, cut_engines, dev)
    mark("4f disagg, long requests")
    print(f"parallel, world 1 over NCCL, mesh (1, 1), llama3_2_3b full width cut to {cut_cfg.num_layers} layers: "
          + json.dumps(_world1_nccl(cut_cfg, cut_engines, detail)))
    del eng, cut_engines  # the mesh ranks share the card
    torch.cuda.empty_cache()
    print(f"parallel, llama3_2_3b full width cut to {cut_cfg.num_layers} layers on the (1, 2) mesh, two ranks on "
          "one card over gloo: " + json.dumps(_parallel_llama(cut_cfg, detail, mesh_refs)))
    mark("6a, 6b mesh llama3_2_3b")
    _dbrx_full_width(dev, detail)
    mark("4d dbrx_132b")
    torch.cuda.empty_cache()
    print("parallel, dbrx_132b full width cut to 1 layer on the (1, 2) and (2, 1) meshes, two ranks on one "
          "card over gloo: " + json.dumps(_parallel_dbrx(dev, detail)))
    torch.cuda.empty_cache()
    parity = _card_vs_cpu(dev, detail)
    print("card vs cpu (reduced llama3_2_3b and dbrx_132b): " + json.dumps(parity))
    mark("6c mesh dbrx_132b, 5 parity")
    _paper_models(dev, detail)
    mark("7 paper models")
    _zoo(dev, detail)
    mark("10 zoo")
    _recurrent(dev, detail)
    mark("11 recurrent")
    torch.cuda.empty_cache()
    _training(dev, detail)
    mark("12 training")
    detail["profiler_misses"] = PROFILER_MISSES
    detail["prefill_flips"] = PREFILL_FLIPS
    print("seconds by phase: " + json.dumps(phase_s))

    meta = {
        "razer_matmul": ("src/repro_torch/csrc/razer_matmul.cu", "src/repro/kernels/razer_matmul.py:112",
                         "one layer's 7 packed linears at decode M=4"),
        "razer_matmul_fused_act": ("src/repro_torch/csrc/razer_matmul_tile.cuh",
                                   "src/repro/kernels/razer_quantize.py:103",
                                   "K2 fused into K1/K7's x load (launches: K1 and K7 launches that fake-quantized "
                                   "x); one layer's 7 packed linears at decode M=4 under W4A4, bf16 x"),
        "rms_norm": ("src/repro_torch/csrc/rms_norm.cu", "src/repro/models/layers.py:29 (rms_norm, jnp: no Pallas "
                     "kernel)", "K10, one llama3_2_3b norm at decode M=4 (d_model 3072, bf16)"),
        "prefill_attention": ("src/repro_torch/csrc/prefill_attention.cu",
                              "src/repro/models/attention.py:54 (chunked_attention, jnp: no Pallas kernel)",
                              "K9, causal GQA prefill, B=8 S=128 H=24 KVH=8 hd=128, q bf16, K/V f32 (max_abs_err: "
                              "the largest over every shape held against the plain version, MLA's hd 192, "
                              "whisper's non-causal shapes and RecurrentGemma's hd 256 with window 2048 "
                              "included)"),
        "prefill_attention_bwd": ("src/repro_torch/csrc/prefill_attention_bwd.cu",
                                  "src/repro/models/attention.py:54 (chunked_attention, jnp, differentiated by "
                                  "XLA: no Pallas kernel)",
                                  "K9's backward, causal GQA, B=1 S=4096 H=24 KVH=8 hd=128, bf16: the tensor-core "
                                  "body (two kernels a call; max_abs_err: the largest error relative to max |want| "
                                  "of dq, dk, dv at B 1 x 4096, B 4 x 512, window 1024 at q_offset 512, no causal "
                                  "mask, MLA's 128 heads at hd 192 / V 128 (bf16 B 1 x 2048, f32 B 1 x 512) and "
                                  "RecurrentGemma's 10 / 1 at hd 256, window 2048 (bf16 B 1 x 4096, f32 B 1 x "
                                  "2600))"),
        "rms_norm_bwd": ("src/repro_torch/csrc/rms_norm_bwd.cu", "src/repro/models/layers.py:29 (rms_norm, jnp, "
                         "differentiated by XLA: no Pallas kernel)",
                         "K10's backward, M=4 d=3072, bf16 x and dy, f32 gamma (two kernels a call; max_abs_err: "
                         "the largest error relative to max |want| of dx and dgamma at M 4 and 4096)"),
        "razer_act_qdq": ("src/repro_torch/csrc/razer_quantize.cu", "src/repro/kernels/razer_quantize.py:103",
                          "one layer's 7 activation fake-quants at decode M=4, bf16"),
        "razer_kv_attention": ("src/repro_torch/csrc/razer_kv_attention.cu",
                               "src/repro/kernels/razer_kv_attention.py:101",
                               "B=4 H=24 KVH=8 hd=128 S=128, cur_len 9/40/97/128"),
        "paged_kv_attention": ("src/repro_torch/csrc/paged_kv_attention.cu",
                               "src/repro/kernels/paged_kv_attention.py:71",
                               "B=4 H=24 KVH=8 hd=128 ps=16, scattered table, cur_len 9/40/97/128"),
        "paged_kv_attention_verify": ("src/repro_torch/csrc/paged_kv_attention.cu",
                                      "src/repro/kernels/paged_kv_attention.py:170",
                                      "B=4 T=3 H=24 KVH=8 hd=128 ps=16, committed 9/40/97/125"),
        "razer_grouped_matmul": ("src/repro_torch/csrc/razer_grouped_matmul.cu",
                                 "src/repro/kernels/razer_grouped_matmul.py:62",
                                 "one dbrx_132b MoE layer's 3 expert banks (E=16, 6144 x 10752) at decode M=4"),
        "razer_matmul_kshard": ("src/repro_torch/csrc/razer_matmul.cu", "src/repro/kernels/razer_matmul.py:158",
                                "rank 0's K/2 shards of one llama3_2_3b layer's 7 packed linears (tp=2) at "
                                "decode M=4, kernel only (no exchange)"),
        "razer_grouped_matmul_kshard": ("src/repro_torch/csrc/razer_grouped_matmul.cu",
                                        "src/repro/kernels/razer_grouped_matmul.py:109",
                                        "rank 0's (E=16, K/2) tiles of one dbrx_132b MoE layer's 3 banks (tp=2) "
                                        "at decode M=4, kernel only (no exchange)"),
    }
    MAIN_PATH_LAUNCHES["razer_matmul_fused_act"] += MAIN_PATH_LAUNCHES.pop("razer_matmul_kshard_fused_act")
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": MAIN_PATH_LAUNCHES[name], "max_abs_err": checks[name][0],
                "ms": checks[name][1]["ms"], "plain_ms": checks[name][1]["plain_ms"],
                "bound_ms": checks[name][1]["bound_ms"], "bound_by": checks[name][1]["bound_by"],
                "library_ms": checks[name][1]["library_ms"],
                "device_ms_per_launch": checks[name][1].get("device_ms_per_launch"), "work": meta[name][2],
                # K9 (bf16 q) is two kernels a call and counts one launch a call
                **{key: checks[name][1][key] for key in ("launches_per_call",) if key in checks[name][1]}}
               for name in meta]
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"kernels": kernels, **detail}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
