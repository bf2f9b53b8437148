#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --profile DIR    # and torch.profiler passes
                                           # (Mixtral in DIR, Zamba2 in
                                           # DIR/hybrid, the dense models
                                           # in DIR/gemma2, DIR/danube,
                                           # DIR/qwen2; Chrome traces
                                           # for Mixtral and Zamba2
                                           # only)
    python3 chip_smoke.py --phase overlap  # phase 21 alone, after the
                                           # build, with its expert-FFN
                                           # and flash shapes checked;
                                           # no JSON lines

Phases, each of which raises on failure (exit code != 0):
  1. card     — ``nvidia-smi`` name and power limit, then the kernel build
                (one nvcc per CUDA source, all started together; each
                source's nvcc time, ptxas's registers, static shared
                memory and spills of every tensor-core kernel and of every
                split decode kernel (with its dynamic shared memory), and
                the HGMMA (wgmma) instructions in the built flash and
                expert-FFN libraries, which must not be 0).
  2. kernels  — each hand-written kernel at the shapes the serving paths
                give it (bfloat16) and in float32, held to its plain
                PyTorch version on the card (bf16 2e-2, fp32 2e-5, atol
                and rtol; the SSD scan 2e-4 in float32, as the Pallas
                kernel is held; at the serving shapes bf16 results are also
                held to the float32 plain version on the same inputs
                within half a bf16 ulp plus 1e-4); the paged decode
                attention also bitwise to the fused kernel on the gathered
                pages; decode and flash attention also at Zamba2's head dim
                112 and at the dense family's shapes (Gemma2-2B: Dh 256,
                G 2, softcap 50, a wrapped 4096-token ring with window 4096
                and a global cache; Danube: Dh 80, G 4, window 4096;
                Qwen2: Dh 128, G 6, contiguous and paged decode; flash
                for each on a 128-token prompt) and at phase 17's families'
                (fused decode at B 8 over a 256-slot cache: Qwen1.5-MoE
                Dh 128 G 1, Kimi-K2 Dh 112 G 8 at H 64, Chameleon Dh 128
                G 8, Granite Dh 128 G 48 on one KV head; paged decode at
                Qwen1.5-MoE's and Granite's; flash on each 128-token
                prompt; the G-48 fused and paged calls bitwise six G-8
                calls on the head slices, float32 and bf16) and at phase
                18's Whisper (fused decode at Dh 64 G 1; flash on its
                32-token prompt and, without the causal mask, on a
                200-token input); the partial decode
                kernel at Mixtral's and both Gemma2 decode shapes (m and
                l, and acc / l, to the float32 bar; combined, against the
                fused kernel; timed also in a CUDA graph from HBM);
                the expert FFN at every (P, C, D, F, path) a later phase
                gives it (MOE_SHAPES; phases 8, 9, 15 and 16 check their
                own new shapes, phase 17 its shapes after its runs), the
                SSD scan at every (B, S) (SCAN_SHAPES)
                and each attention kernel at every (Dh, G) (CHECKED),
                all checked after the runs; kernel, plain-version and
                library-call times by CUDA events (median of 20 after
                warm-up, L2 flushed before each run), and for decode
                attention, the expert FFN and the SSD scan also the
                kernel's (and SDPA's or the bmm chain's) time in a CUDA
                graph (device time, no host time; the decode-attention and
                scan calls take copies of their inputs in turn, so they
                read them from HBM, not L2; the FFN's 2.8 GB bank never
                fits L2). The flash kernel's records
                come from phase 14.
  3. reference — a reduced float32 Mixtral, a reduced float32 Zamba2 with
                a trailing block, reduced float32 Gemma2, Danube and
                Qwen2 (24-token prompts past their 16-token windows), and
                reduced float32 Qwen1.5-MoE, Kimi-K2, Chameleon and
                Granite, on the card against the same model's plain path
                on the CPU (logits to 1e-3).
  4. serve    — Mixtral-8x7B widths at 8 layers in bfloat16 with seeded
                random weights, contiguous KV, whole-prompt prefill: 8
                requests of 128 prompt tokens and 32 greedy new tokens
                through ``engine.client.submit`` and ``engine.step()``;
                every kernel of the path must be launched. Launches are
                read per phase (the prefills run inside ``client.submit``,
                the decode steps inside ``step()``), the flash kernel's and
                the expert FFN's also per kernel path; every run fails if
                a (bf16) flash call took the CUDA-core path. Every step
                checkpoints its KV. The partial kernel on the final caches
                of the first layer, as in phase 11.
  5. failover — the same requests with ``engine.fail_ew(0)`` after 8
                decode steps; every stream must equal the failure-free one
                bit for bit. Then decode segments and step graphs: the
                same requests on an engine at ``decode_segment_len`` 8
                (same weights), failure-free and under ``fail_ew(0)``,
                and 4 stochastic ones at seg 8 and 1, bitwise equal to the
                seg-1 streams; each step graph (seg 1 and seg 8) replayed
                against the plane's eager segment from the same state
                (token ring, slot loads and cache bit for bit), healthy,
                after ``fail_ew(0)`` and after ``repoint_protect=1`` and
                ``fail_ew(1)`` (the eager step reads the engine's
                RouteState, the graph the plane's copy); and per decode
                step, eager against graph at seg 1 and seg 8, wall time
                and device busy (the union of the profiler's device
                spans).
  6. kv plane — the same model at capacity factor 4.0 (no token dropped,
                so slots and chunking cannot change a stream) in three
                engines sharing the weights: whole-prompt contiguous,
                chunked contiguous and chunked paged (16-token pages),
                chunk budget CHUNK_BUDGET tokens. Paged streams must equal
                contiguous ones, and chunked streams whole-prompt ones, bit
                for bit; the row-count probe holds every row count and
                capacity the prefill and chunk calls used to the largest
                call's rows, bit for bit. The paged run must launch the
                paged decode attention and never the fused one.
  7. AW failover — the paged engine again with ``fail_aw(0)`` once every
                request has 8 tokens, then ``recover_aw_requests()`` (AW1
                is full: nothing is admitted), ``provision_aw(0)``, and
                steps to the end: every stream must equal the paged
                failure-free run bit for bit; restored requests and bytes,
                the recovery time and the largest token gap are printed.
                Then a paged engine at ``decode_segment_len`` 4 under
                ``fail_aw(0)`` with AW0's writes of the last segment still
                pending (its requests rewind into it): streams bitwise
                equal to the contiguous engine's.
  8. orchestrated serving — the same weights at capacity factor 4.0,
                served by ``run_serving`` with an ``Orchestrator``
                (``worker_init_time=1.0``, the launcher's) over the
                port's ``make_workload`` (ORCH_WORKLOAD: ShareGPT-like,
                8 requests/s for 2 s, prompts up to 384 tokens, up to 32
                new), the virtual clock advancing by each step's wall time
                on the card: (a) failure-free, after a warm-up pass whose
                streams must equal it; (b) EW0 at 0.2 s and EW1 at 2.1 s,
                EW1 served from the shadows re-pointed to protect it when
                EW0 was provisioned; (c) AW0 at the middle of run (a)'s
                longest stretch with two decoding requests on AW0 (a
                request with tokens must be restored); (d) the baseline
                engine (``tarragon=False, checkpoint=False``) under EW0's
                failure. Every request of (a)-(c) finishes and the streams
                of (b) and (c) equal (a)'s bit for bit; (d) must finish and
                prints how many of its streams differ. Per run: TTFT and
                TBT p50/p99, max stall, throughput, queue delay p50/p99,
                the orchestrator's events, bytes restored, the largest
                token gap of the requests the failure touched, what ran
                inside the run's largest token gap (steps, prefill groups
                and their prompt tokens, orchestrator events), and the
                launches per phase (each run must launch decode attention,
                the FFN's tensor-core path in prefill and its decode path
                in decode, and flash). Then the failover demo twin at the
                same widths (its EW and AW sections must equal its
                reference section), and the expert FFN at every (P, C, D, F, path)
                of this phase's runs and the demo's that MOE_SHAPES lacks
                (earlier phases' shapes stay with MOE_SHAPES), held to its
                plain
                versions (run (a)'s largest prefill C also timed:
                ``moe_gemm[orchestrated]``). The telemetry plane is on (the
                default): every stall record of (b) and (c) sums to its
                gap within 1e-9 s, and (c)'s Chrome trace, written to
                ``build/``, parses back with one root span per request;
                (b) prints EW0's margin before EW1's failure.
  9. elastic and preemption — the same weights (num_ew 2, max_ew 3):
                first, on one engine with 8 requests decoding, a replay of
                the seg-1 step graph against the eager step after a
                scale-out, a rebalance with split replicas and a shadow
                promotion (no new capture). Then ``run_serving`` with an
                Orchestrator (T_w 1.0 s, T_push 0.25 s) over the port's
                ``make_workload``: ELASTIC_WORKLOAD (Zipf-skewed) failure-
                free; (e) with ``auto_rebalance`` and ELASTIC_SCALES (EW2
                joins 1.25 s after its request at 0.2 s, drains from
                2.2 s); (f)
                ``ew_policy="promote"`` under EW0's failure at 0.5 s;
                SLO_WORKLOAD (a batch wave that fills every slot and
                interactive arrivals) with a token cap, without
                preemption, (g) with it, and (g) bulk with it and no
                per-token checkpointing (each victim's whole resident
                state goes through the bulk range path at its commit).
                Every stream of (e) and (f) equals the failure-free run's
                and every stream of both (g) runs the run without
                preemption's, bit for bit; each (g) run preempts at
                least once and every victim resumes; one host sync a
                decode step and no capture after warm-up in every run.
                Prints the plan generations with the per-EW load EMAs at
                each install and at the end, the preemptions, the
                victims' commit and resume host times with the tokens
                each commit held and moved through the bulk path and the
                bytes each resume restored, TTFT and TBT
                p50/p99 per class, EW2's margin before its drain, and the
                phase's wall time; the expert FFN at any new (P, C, D,
                F, path) is held to its plain versions.
 15. prefix cache and telemetry (runs after phase 9, on its weights) —
                8 chat sessions of 3 turns (a shared 256-token system
                prefix, seeded turns of 48-160 tokens, 16 greedy tokens a
                turn) at max_seq 1024, chunk budget CHUNK_BUDGET: (h0) the
                cache off, contiguous; (h) contiguous with the prefix
                cache; (i) paged with the global index, migration and a
                page budget that trims cached tails; (j) as (i) with
                ``fail_aw(0)`` between turns 1 and 2. Every stream of
                (h)-(j) equals (h0)'s bit for bit; (h) and (i) hit; (i)
                decodes with a page of refcount > 1 mapped in two
                decoding rows on the paged kernel only, and trims a tail
                page; (j) restores a cached prefix and hits after the
                failure; ``PagePool.check()`` after each run. Then (k):
                ``run_serving`` over ``multi_turn_chat`` at the
                launcher's prefix settings, cache off and cache on with
                telemetry on and off, bitwise equal. No capture after
                warm-up, one host sync a decode step. Prints prefill
                tokens computed, cold and warm TTFT, adoption, boundary
                copy and re-checkpoint host ms, ``restore_orphans`` host ms
                and bytes, pinned bytes at the end and after every entry
                was evicted, and the telemetry hooks' host ms a step.
 16. control plane and flight recorder (runs after phase 15, on its
                weights; max_ew 3, paged KV, chunk budget CTL_BUDGET and
                a token cap of 8x it) — the reference incident
                (CTL_WORKLOAD: a batch wave of 8 x 40 tokens, then
                interactive arrivals with 0.3 s first-token deadlines;
                ``fail_aw(0)`` at 0.4 s; detection 0.05 s x 2, T_w 0.5
                s) through ``run_serving`` on a fixed virtual clock
                (CTL_CLOCK: a replay refuses host step times): (l) the
                controller on (every policy, ``victim_policy=
                "controller"``), the recorder and watchdogs on, autodump
                at detection; (m) (l)'s bundle in script mode (the tool
                refuses controller victims, as the reference's does, so
                the decisions run with remaining-work victims); (n) the
                bundle read back from its JSON file, exact mode, with the
                weights as ``params``; (o) (l) with the recorder and
                watchdogs off. Every stream of (m)-(o) equals (l)'s bit
                for bit; (n) reports BIT-IDENTICAL with its config hash;
                (l) makes a budget and a preempt decision and trips no
                watchdog; ``PagePool.check()`` after each run; no capture
                after warm-up, one host sync a decode step. Prints the
                decisions by kind, the bundle's bytes, records and
                fingerprints, the dump's host ms, the replay reports, the
                controller's and recorder's host ms a serving-loop tick;
                the expert FFN at any new (P, C, D, F, path) is held to
                its plain versions, the flash kernel's new shapes in
                phase 14.
 10. hybrid   — Zamba2-7B widths at 13 layers in bfloat16 (2 units of 6
                Mamba2 blocks + the shared attention block, 1 trailing
                block), 8 requests of 128 prompt tokens and 16 greedy new
                tokens, each prefilled alone: every Mamba2 block of every
                prefill launches the SSD scan, the shared block the flash
                and decode kernels at head dim 112; the per-step checkpoint
                copy (every row's K/V and whole recurrent state) is timed.
                Then ``fail_aw(0)`` once every request has 8 tokens,
                recover, provision: every stream must equal the
                failure-free one bit for bit.
                The per-step checkpoint copy's designs (pageable,
                pinned staging, pinned blocks) are timed.
 11. gemma2   — Gemma2-2B whole (26 layers, alternating 4096-token local
                and global attention, softcaps) in bf16, 2 AWs, max_batch
                8, max_seq 4608: 8 requests (4 of 128 prompt tokens, 2 of
                4,088 whose rings wrap during decode, 2 of 4,160 whose
                rings wrap inside prefill), 32 greedy new tokens; TTFT,
                TBT, the per-step and install checkpoint copies. The
                partial kernel on the final caches of one local and one
                global layer: against the plain partials, each row bit for
                bit the call on that row alone, combined against the fused
                kernel, and two Sc halves merged in log-sum-exp form and
                combined against the fused kernel. Then
                ``fail_aw(0)`` once every request has 16 tokens, recover,
                provision: streams bitwise equal, and AW0 must have held a
                request of each long kind, its ring wrapped. Then the
                install copy's designs, the same requests at
                ``decode_segment_len`` 8 (the 4,088-token prompts' rings
                wrap inside a segment) under ``fail_aw(0)`` with the last
                segment's writes pending, bitwise equal to seg 1's, and
                the step times as in phase 5.
 12. danube   — H2O-Danube-1.8B whole (24 layers, every one a 4096-token
                window, head dim 80) in bf16, max_batch 4: prompts of
                4,088, 128, 4,160 and 128 tokens, the same failover check.
 13. qwen2    — Qwen2-1.5B whole (28 layers, QKV bias, G 6) in bf16,
                max_seq 1024: 8 seeded prompts of 96-700 tokens through
                whole-prompt, chunked contiguous and chunked paged engines
                (paged == contiguous and chunked == whole-prompt, bit for
                bit; the paged run launches the paged kernel at G 6 and
                never the fused one), then the paged engine under
                ``fail_aw(0)`` after 8 tokens, bitwise equal.
 17. MoE and dense families (after the dense phases, with the earlier
                engines and weights dropped) — FAMILIES in bf16 with seeded
                weights (each tensor cast as it is drawn: Kimi's init
                peaks near 61 GB), 2 AWs, 8 requests of 128 prompt tokens
                and 16 greedy new tokens, step graphs on: Qwen1.5-MoE-A2.7B
                whole (24 layers, 8 EWs: 60 experts in 64 stored rows and
                80 slots), Kimi-K2 at 2 of 61 layers (the dense first
                layer and one MoE layer; 2 EWs: 768 slots), the two at
                capacity factor E / top-k (no call drops a token),
                Chameleon-34B at 16 of 48 layers and Granite-34B at 16 of
                88 (MQA, G 48). Each run launches flash and the
                fused decode kernel at its (Dh, G), the MoE pair the expert
                FFN's tensor-core path in every prefill call and its
                decode path in every decode step; the MoE pair's streams
                under ``fail_ew(0)`` after 8 steps equal the failure-free
                ones bit for bit; ``fail_aw(0)`` once every request has 8
                tokens, recover, provision: bitwise (on the paged engine
                for Qwen1.5-MoE and Granite, which also run chunked and
                paged: paged == contiguous, chunked == whole-prompt, the
                paged kernel only, at G 1 and G 48); the seg-1 step graph
                against the eager step; TTFT, TBT, the decode step's wall
                time and device busy; eager MoE steps make no tensor map
                again (the decode path keeps every bank's). Then the
                expert FFN at every (P, C, D, F, path) of these runs on
                the model's whole bank (a row a primary slot), the checked
                slots on its last 8 rows (Kimi's 376-383: their offsets pass 2^31
                elements; shadow slots bitwise their primaries), and one
                timed record per MoE model and path, which replays the
                slot experts and counts of a call the run made (its most
                launched decode shape, its largest prefill or chunk C).
 18. recurrent and encoder-decoder families (after phase 17, with its
                engines dropped) — RECURRENT_FAMILIES whole in bf16 with
                seeded weights, 2 AWs, 1 EW, step graphs on, each after
                its reduced float32 model on the card against the CPU
                plain path (phase 3's check): xLSTM-350m (24 layers of
                mLSTM/sLSTM pairs; no kernel on its path, as in the
                reference) with 8 requests of 128 prompt tokens and 16
                greedy new tokens, and Whisper-small (12 encoder and 12
                decoder layers) with 8 requests, each with its own
                seeded 1,500-frame input and a 32-token decoder prompt,
                and 8 greedy new tokens: every prefill call launches
                flash once per encoder layer without the causal mask
                (B 1, 1,500 frames) and once per decoder layer, every
                decode step the fused decode kernel at (Dh 64, G 1) once
                per decoder layer. ``fail_aw(0)`` once every request has
                8 (xLSTM) or 4 (Whisper) tokens, recover, provision:
                bitwise; after that run's first step, outside its clock
                and counts, the seg-1 step graph against the eager step
                and the step times (the cache put back); no capture
                after the warm-up of one request. Prints TTFT, TBT, the decode
                step's wall time and device busy, the per-step
                checkpoint's bytes and gather + copy ms, the store's peak
                pinned bytes and the restores' host ms.
 19. training (after phase 18, with its engines dropped) — (1) each
                TRAIN_MODELS arch reduced, in float32: the loss and every
                gradient leaf on the card (flash, the expert FFN and the
                SSD scan in the forward pass) against the CPU's plain path
                (the loss to 1e-3, each leaf to 1e-3 of its largest
                magnitude + 1e-4); (2) each kernel's autograd Function
                (flash causal at S 200, bf16 and float32; the expert FFN
                on a bank with shadow slots; the SSD scan at Zamba2's
                heads): the output and every input's gradient against the
                plain version differentiated directly, one launch in the
                forward pass; (3) TRAIN_MODELS in bf16 with seeded
                weights, a few AdamW steps on one fixed batch of
                ``lm_batches``: Qwen2-1.5B whole, Mixtral-8x7B widths at 2
                of 32 layers (2 EWs), Zamba2-7B widths at 13 layers,
                xLSTM-350m and Whisper-small whole; the loss finite every
                step and lower at the last, every param leaf with a
                gradient and moved, each model's kernels launched in
                every forward pass and none in a backward pass (the
                backward recomputes the plain versions), ``save_params``
                and ``load_params`` on the card bitwise (leaves and
                ``forward_train``'s logits); prints each step's forward,
                backward and optimizer times (CUDA events), the peak
                memory and the launches per step; (4) ``python -m
                repro_torch.launch.train`` with its defaults, in a process
                of its own, its loss improved. Then the expert FFN and the
                SSD scan at the training shapes against their plain
                versions, timed (``moe_gemm[train]``, ``ssm_scan[train]``,
                with the training launches); flash's in phase 14
                (``flash_attention[train ...]``).
 20. launch plane (after phase 19) — (a) Mixtral-8x7B widths at 8
                layers in bf16, 2 AWs x 2 EWs, 16 slots: the unsharded
                engine, then an engine on params the ``Sharder`` placed on
                a 1x1 ("data", "model") ``DeviceMesh`` over a 1-rank NCCL
                group (``launch/mesh.py``), served from their local
                shards: 8 requests of 128 + 32 tokens, failure-free and
                under ``fail_ew(0)``, bitwise the unsharded engine's
                streams, no capture after warm-up; the launches of the
                sharded run and the peak memory; the group destroyed at
                the end; (b) ``roofline/op_count.py``'s count of one
                prefill call (8 x 128) and one eager decode step of the
                unsharded engine (the kernels report their launches'
                work) against ``roofline/analysis.py``'s, flops and
                bytes, each ratio held to OP_COUNT_BANDS; (c) ``python -m
                repro_torch.launch.dryrun --all --include-paper-model`` at
                16 x 16 and 2 x 16 x 16 in processes of their own beside
                (a): 37 ok, 7 skipped and 0 errors each, one line per
                case with its dominant term and its bytes per device.
 21. overlapping failures (after phase 20) — Mixtral-8x7B widths at 8
                layers in bf16 with seeded weights for 3 EWs (the bank's
                9 rows: 8 experts and a pad; P 15 slots), 2 AWs,
                capacity factor 4.0, an Orchestrator with T_w 1.0 s on a
                virtual clock each sub-run drives between its steps
                (``Script``); every stream bitwise the same engine's
                failure-free run, no capture after warm-up: (a) on the
                dual-protected layout (every shadow slot on EW2, holding
                a replica of each expert of EW0 and EW1), 8 requests of
                128 + 32 tokens, EW0 fails, EW1 0.3 s later while EW0's
                replacement provisions, EW0 back with the shadows
                re-pointed (EW1's replicas pinned: no expert without a
                healthy replica), then EW1, 0 outstanding; (b) 6 requests,
                AW0 and EW0 in one detection window: one victim restored
                onto AW1 at once, two queued until AW0's provisioning,
                the bytes restored and the host ms from fail_aw to each
                victim's next token; (c) the same during chunked prefill:
                2 prompts of 512 tokens at chunk budget CHUNK_BUDGET on
                AW1 (session affinity), which fails with EW0 after the
                first chunk tick, each prompt resumed from its committed
                cursor; (d) (b) with the victim restored at once
                cancelled inside the recovery window: the survivors
                bitwise, every slot free, no store log or queue entry
                left; (e) ``run_serving`` with 24 requests arriving at
                once against 16 slots and AW0 failed while 8 wait: none
                lost, every stream bitwise the failure-free run's, TTFT,
                TBT and max stall. Each sub-run prints its wall time and
                its launches of decode attention, flash and the expert
                FFN; the peak memory; the expert FFN at every new (P, C,
                D, F, path) held to its plain versions (the decode and
                prefill shapes at P 15 are in MOE_SHAPES).
 14. flash at the served shapes — every (B, Sq, Sk, heads, window,
                softcap, causal) the runs gave the flash kernel, on the positions
                of that shape's first call (pad tails, rows outside a
                chunk) with seeded bf16 q/k/v, against the bf16 plain
                version and the float32 one; then one record per path,
                timed at the largest shape its run gave the kernel, with
                the run's launches at that shape (and, beside the CUDA-event
                time of one call, the time of one call of the kernel and of
                SDPA replayed back to back from a CUDA graph: at the small
                shapes a call's host time outweighs its kernel). main()
                fails on a shape not checked.
Each phase prints its wall time. Every engine runs its decode steps as
replays of captured CUDA graphs (serving/decode_loop.py): each Run after
an engine's warm-up must capture nothing new, and the kernel observers
and launch counts are added on each replay (``build.count``).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# a bfloat16 result against the float32 plain version on the same inputs:
# rounding once at the output costs at most half an ulp (2^-8 relative);
# 1e-4 absolute covers float32 summation order
ROUND_ATOL, ROUND_RTOL = 1e-4, 2.0 ** -8
CHUNK_BUDGET = 256                 # prefill tokens per step, KV-plane phase
PAGE_TOKENS = 16
# the expert FFN's capacities C on the serving paths, each with the kind
# of call (decode step or not) and the kernel path it must take: serve
# decode and whole-prompt prefill at capacity factor 1.25; the KV-plane
# decode, whole-prompt prefill, chunk calls (C 256 and 8) and chunk tails
# at 4.0 (C 128 and 256 span two and four 64-row M tiles). Only decode
# steps take the decode path ("skinny", C <= 8): prefill and chunk calls
# take the tensor-core path at every C, chunk calls at C 8 and tails at C
# 2 and 4 included, so a token rounds one way whatever its call's C.
# main() fails if a run gives the kernel a (P, C, D, F, path) that no
# check held to its plain version.


def mixtral_ffn(c, path, p=16):
    """The key of an expert FFN call at Mixtral-8x7B's widths, (P, C, D, F,
    path): P 16 is 8 primary and 8 shadow slots on 2 EWs, P 15 (phase 21)
    9 primary slots (8 experts and a pad) and 6 shadow slots on 3 EWs."""
    return p, c, 4096, 14336, path


MOE_SHAPES = [("decode", mixtral_ffn(2, "skinny")),
              ("prefill", mixtral_ffn(64, "tensor_core")),
              ("decode-kv", mixtral_ffn(8, "skinny")),
              ("prefill-kv", mixtral_ffn(128, "tensor_core")),
              ("chunk-8", mixtral_ffn(8, "tensor_core")),
              ("chunk-tail", mixtral_ffn(4, "tensor_core")),
              ("chunk-tail-2", mixtral_ffn(2, "tensor_core")),
              ("chunk", mixtral_ffn(256, "tensor_core")),
              ("decode-3ew", mixtral_ffn(8, "skinny", p=15)),
              ("prefill-3ew", mixtral_ffn(128, "tensor_core", p=15))]
# Zamba2-7B as the hybrid phases serve it: 13 of 81 layers (two units of 6
# Mamba2 blocks + the shared block, then one trailing block)
HYBRID_LAYERS = 13
HYBRID_MAX_SEQ = 256
# the SSD scan's (B, S) on the hybrid serving path (one 128-token prompt
# per prefill call); main() fails if a run gives the kernel another
SCAN_SHAPES = [(1, 128)]
# the dense family at full width and depth: Gemma2-2B and H2O-Danube-1.8B
# with 4096-token ring caches (prompts of 4088 tokens wrap during decode,
# of 4160 inside prefill), Qwen2-1.5B with full attention
RING_MAX_SEQ = 4608
GEMMA2_LENS = (4088, 128, 4160, 128, 128, 4088, 128, 4160)
DANUBE_LENS = (4088, 128, 4160, 128)
QWEN2_MAX_SEQ = 1024
QWEN2_LENS = (96, 700)             # seeded prompt lengths, inclusive
# the rest of the transformer family (phase 17), each in bf16 with seeded
# weights, 2 AWs, 8 requests of FAMILY_PROMPT tokens and FAMILY_NEW greedy
# new tokens: (label, arch, layers served, EWs, chunked and paged runs?).
# Qwen1.5-MoE-A2.7B whole (60 experts in 64 stored rows and 80 slots on 8
# EWs, G 1, QKV bias); Kimi-K2 at 2 of 61 layers (the dense
# first layer and one MoE layer of 384 experts: 768 slots on 2 EWs; Dh
# 112, G 8); Chameleon-34B at 16 of 48 layers (qk-norm, G 8); Granite-34B
# at 16 of 88 layers (MQA, G 48; ungated tanh-GeLU). The MoE pair runs at
# capacity factor E / top-k (15 and 48; family_phase)
FAMILIES = (("qwen-moe", "qwen2_moe_a2_7b", 24, 8, True),
            ("kimi", "kimi_k2_1t_a32b", 2, 2, False),
            ("chameleon", "chameleon_34b", 16, 1, False),
            ("granite", "granite_34b", 16, 1, True))
FAMILY_MAX_SEQ = 256
FAMILY_PROMPT = 128
FAMILY_NEW = 16
# the recurrent and encoder-decoder families (phase 18), whole, in bf16
# with seeded weights, 2 AWs, 8 requests: (label, arch, prompt tokens, new
# tokens, tokens every request has at fail_aw(0), max_seq). xLSTM-350m:
# 24 layers of mLSTM/sLSTM pairs, constant-size state only; Whisper-small:
# 12 encoder and 12 decoder layers, each request with its own seeded
# 1,500-frame input (its cross K/V, 55.3 MB, rides every token's
# checkpoint segment)
RECURRENT_FAMILIES = (("xlstm", "xlstm_350m", 128, 16, 8, 256),
                      ("whisper", "whisper_small", 32, 8, 4, 256))
# the training phase (19), each in bf16 with seeded weights, a few AdamW
# steps at lr TRAIN_LR on one fixed batch of lm_batches: (label, arch,
# layers trained (0: all), EWs, batch, sequence, steps). A first step
# moves a weight of 1 (a norm scale) down by 1.1 lr with the weight
# decay, more than half the bfloat16 spacing below 1 (2^-9) at 2e-3, so
# every leaf moves. Qwen2-1.5B whole (the launcher's default arch);
# Mixtral-8x7B widths at 2 of 32 layers (P 16: 8 primary and 8 shadow
# slots on 2 EWs); Zamba2-7B widths at the hybrid phases' 13 layers;
# xLSTM-350m whole at S 64 (its sLSTM runs one step at a time: 12 layers
# x S small ops, eagerly, each way); Whisper-small whole on seeded
# 1,500-frame inputs and a 32-token decoder sequence, 2 steps (on an
# NVIDIA H100 at lr 3e-3, a third step overshot: loss 10.98, 8.83, 16.36)
TRAIN_MODELS = (("qwen2", "qwen2_1_5b", 0, 1, 4, 512, 4),
                ("mixtral", "mixtral_8x7b", 2, 2, 4, 512, 3),
                ("zamba2", "zamba2_7b", HYBRID_LAYERS, 1, 4, 512, 3),
                ("xlstm", "xlstm_350m", 0, 1, 4, 64, 3),
                ("whisper", "whisper_small", 0, 1, 2, 32, 2))
# the kernels each model's forward pass must launch
TRAIN_KERNELS = {"qwen2": ("flash_attention",),
                 "mixtral": ("flash_attention", "moe_ffn"),
                 "zamba2": ("flash_attention", "ssm_scan"),
                 "xlstm": (), "whisper": ("flash_attention",)}
TRAIN_LR = 2e-3
TRAIN_AUX = 0.01                   # the reference's aux_coef


def h100():
    """The card's published figures, one definition with the roofline
    (``repro_torch.roofline.h100``)."""
    from repro_torch.roofline import h100 as spec
    return spec


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median CUDA-event time of one call of ``fn`` (20 after 3 warm-up
    calls, a 64 MiB L2 flush before each, outside the timed span): the
    kernels' timer, ``repro_torch.kernels.bits.time_ms``."""
    from repro_torch.kernels import bits
    return bits.time_ms(fn)


def graph_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """The device time of one call of ``fn`` without the host's launch
    time: ``calls`` calls captured in one CUDA graph, replayed back to
    back (median of ``reps`` CUDA-event timings, divided by ``calls``).
    At the small shapes a call's host time outweighs its kernels, and the
    CUDA-event window of ``time_ms`` includes it. The calls share their
    inputs, so an input that fits in L2 is read from L2 after the first
    call: ``cold_graph_ms`` keeps it in HBM."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cold_graph_ms(torch, fn, tensors, calls: int = 20) -> float:
    """``graph_ms`` of ``fn(*tensors)`` with its inputs read from HBM: the
    captured calls take copies of ``tensors`` in turn, enough of them
    (at most ``calls``) that the other copies read between two calls on
    one copy hold at least twice the L2 (four times, counting every
    allocated byte as read). What a decode step sees: each layer's call
    reads another layer's cache."""
    import itertools
    per = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(calls, -(-4 * h100().L2_BYTES // per)))
    turn = itertools.cycle([tuple(tensors)] + [
        tuple(t.clone() for t in tensors) for _ in range(n - 1)])
    return graph_ms(torch, lambda: fn(*next(turn)), calls)


def bound(nbytes: float, flops: float, peak: float = None):
    """The least time for the work: bytes at the HBM rate or flops at
    ``peak`` (bf16 tensor cores unless the kernel computes in float32 on
    the CUDA cores), the larger."""
    spec = h100()
    t_bytes = nbytes / spec.HBM_BYTES_PER_S * 1e3
    t_ops = flops / (spec.BF16_FLOPS_PER_S if peak is None else peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, dtype_name=None, *, atol=None, rtol=None):
    """Hold ``got`` to ``want`` within atol + rtol * |want| (both the
    dtype's tolerance unless given); raise if not. Returns the max abs
    error."""
    atol = TOL[dtype_name] if atol is None else atol
    rtol = TOL[dtype_name] if rtol is None else rtol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all().item())
    print(f"  {name}: max_abs_err {err:.3e} (tol {atol:g} abs + {rtol:g} "
          f"rel) {'ok' if ok else 'FAIL'}")
    if not ok or not bool(got.float().isfinite().all().item()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def decode_inputs(torch, g, b, h, hkv, dh, sc, dtype, min_len):
    q = torch.randn((b, h, dh), generator=g, device="cuda").to(dtype)
    ck = torch.randn((b, sc, hkv, dh), generator=g, device="cuda").to(dtype)
    cv = torch.randn((b, sc, hkv, dh), generator=g, device="cuda").to(dtype)
    k1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    v1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    pos = torch.randint(min_len, sc - 1, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    ar = torch.arange(sc, device="cuda", dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    return q, ck, cv, cpos, k1, v1, pos


def kernel_decode_attention(torch, g, records):
    from repro_torch.kernels import decode_attention as da
    print("decode_attention (fused GQA decode, csrc/decode_attention.cu)")
    # fp32 at a small shape, with a window and a softcap
    q, ck, cv, cpos, k1, v1, pos = decode_inputs(
        torch, g, 3, 8, 2, 64, 96, torch.float32, 10)
    for window, cap in ((0, 0.0), (16, 0.0), (0, 30.0)):
        check(f"fp32 B3 H8 Hkv2 Dh64 Sc96 window={window} softcap={cap}",
              da.decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos,
                                       window=window, softcap=cap),
              da.decode_attention_plain(q, ck, cv, cpos, k1, v1, pos,
                                        window=window, softcap=cap),
              "float32")
    # the serving shape: 8 rows, Mixtral heads, a 512-token cache
    decode_attention_at(torch, g, records, "decode_attention_fused",
                        8, 32, 8, 128, 512)
    print("decode_attention_partial at Mixtral's decode shape")
    partial_at(torch, g, records, "decode_attention_partial[mixtral]", 8, 32,
               8, 128, 512)


def ring_decode_inputs(torch, g, b, h, hkv, dh, sc, dtype, lo, hi):
    """Decode inputs over a ring cache of Sc slots that every row has
    passed: row b's next position lies in [lo, hi) (lo > Sc) and slot j
    holds the latest earlier position congruent to j mod Sc, as a sliding
    window layer's cache does."""
    q, ck, cv, _, k1, v1, _ = decode_inputs(torch, g, b, h, hkv, dh, sc,
                                            dtype, 1)
    pos = torch.randint(lo, hi, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    last = (pos - 1)[:, None]
    ar = torch.arange(sc, device="cuda", dtype=torch.int32)[None]
    cpos = (last - torch.remainder(last - ar, sc)).to(torch.int32)
    return q, ck, cv, cpos, k1, v1, pos


def decode_attention_at(torch, g, records, name, b, h, hkv, dh, sc, *,
                        window=0, softcap=0.0, ring=None):
    """The fused decode kernel at a serving shape: in float32 first, so
    the instantiation the main path uses is held to the float32 bar, then
    in bf16 against the bf16 and the float32 plain versions; times.
    ``ring`` = (lo, hi) draws a wrapped ring cache (positions in [lo,
    hi)) instead of a contiguous one."""
    from repro_torch.kernels import decode_attention as da
    import torch.nn.functional as F

    def inputs(dtype):
        if ring is not None:
            return ring_decode_inputs(torch, g, b, h, hkv, dh, sc, dtype,
                                      *ring)
        return decode_inputs(torch, g, b, h, hkv, dh, sc, dtype, 128)
    kw = dict(window=window, softcap=softcap)
    tag = (f"B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc}"
           + (f" ring pos [{ring[0]}, {ring[1]})" if ring else "")
           + (f" window={window}" if window else "")
           + (f" softcap={softcap:g}" if softcap else ""))
    args32 = inputs(torch.float32)
    check(f"fp32 {tag}", da.decode_attention_cuda(*args32, **kw),
          da.decode_attention_plain(*args32, **kw), "float32")
    del args32
    args = inputs(torch.bfloat16)
    q, ck, cv, cpos, k1, v1, pos = args
    got = da.decode_attention_cuda(*args, **kw)
    err = check(f"bf16 {tag}", got, da.decode_attention_plain(*args, **kw),
                "bfloat16")
    check(f"bf16 {tag} vs float32 plain", got,
          da.decode_attention_plain(*(t.float() if t.is_floating_point()
                                      else t for t in args), **kw),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    CHECKED.add(("decode_attention_fused", dh, h // hkv))

    def kern():
        return da.decode_attention_cuda(*args, **kw)
    ms = time_ms(torch, kern)
    dev_ms = cold_graph_ms(
        torch, lambda *a: da.decode_attention_cuda(*a, **kw), args)
    plain_ms = time_ms(torch, lambda: da.decode_attention_plain(*args,
                                                                **kw))
    ok = da.valid_keys(cpos, pos, window)
    grp = h // hkv
    lib_ms, lib_dev_ms = None, None
    library = "none: SDPA has no tanh softcap"
    if not softcap:
        # library yardstick: SDPA over cache + current token, heads
        # expanded, the window in the mask
        kk = torch.cat([ck, k1[:, None]], 1).transpose(1, 2)
        vv = torch.cat([cv, v1[:, None]], 1).transpose(1, 2)
        kk = kk.repeat_interleave(grp, 1).contiguous()
        vv = vv.repeat_interleave(grp, 1).contiguous()
        mask = torch.cat([ok, torch.ones((b, 1), dtype=torch.bool,
                                         device="cuda")], 1)
        mask = mask[:, None, None, :]
        qq = q[:, :, None, :]

        def sdpa(qq=qq, kk=kk, vv=vv, mask=mask):
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        lib_ms = time_ms(torch, sdpa)
        lib_dev_ms = cold_graph_ms(torch, sdpa, (qq, kk, vv, mask))
        library = "SDPA"
    flops, nbytes = da.fused_work(q, k1, cpos, int(ok.sum().item()))
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library=library, graph_ms=dev_ms,
        library_graph_ms=lib_dev_ms, shape=f"{tag} bf16"))
    print(f"  time {ms:.4f} ms (in a CUDA graph, L2 cold {dev_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, "
          + (f"SDPA {lib_ms:.4f} ms (in a CUDA graph, L2 cold "
             f"{lib_dev_ms:.4f})" if lib_ms is not None else library)
          + f", bound {b_ms:.4f} ms ({b_by})")


def check_partials(name, got, want):
    """The partial kernel's (m, l, acc) against the plain version's at the
    float32 bar: m and l directly, acc as acc / l (the softmax-weighted
    mean of V, whose scale does not grow with l)."""
    m, l, acc = got
    wm, wl, wacc = want
    check(f"{name} m", m, wm, "float32")
    check(f"{name} l", l, wl, "float32")
    return check(f"{name} acc / l", acc / l[..., None],
                 wacc / wl[..., None], "float32")


def partial_at(torch, g, records, name, b, h, hkv, dh, sc, *, window=0,
               softcap=0.0, ring=None):
    """The partial kernel at a serving shape: against the plain partials
    in float32 and on bf16 inputs (its outputs are float32 either way),
    and combined against the fused kernel; times, also in a CUDA graph
    with its inputs read from HBM. No single PyTorch call returns softmax
    partials."""
    from repro_torch.kernels import decode_attention as da
    kw = dict(window=window, softcap=softcap)
    tag = (f"B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc}"
           + (f" ring pos [{ring[0]}, {ring[1]})" if ring else "")
           + (f" window={window}" if window else "")
           + (f" softcap={softcap:g}" if softcap else ""))
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        if ring is not None:
            args = ring_decode_inputs(torch, g, b, h, hkv, dh, sc, dtype,
                                      *ring)
        else:
            args = decode_inputs(torch, g, b, h, hkv, dh, sc, dtype, 128)
        q, ck, cv, cpos, k1, v1, pos = args
        dn = "fp32" if dtype == torch.float32 else "bf16"
        got = da.decode_attention_partial_cuda(q, ck, cv, cpos, pos, **kw)
        errs.append(check_partials(f"{dn} {tag}", got,
                                   da.decode_attention_partial_plain(
                                       q, ck, cv, cpos, pos, **kw)))
        check(f"{dn} {tag} combined vs the fused kernel",
              da.combine_decode_partials(q, *got, k1, v1, softcap=softcap),
              da.decode_attention_cuda(*args, **kw),
              "float32" if dtype == torch.float32 else "bfloat16")
    CHECKED.add(("decode_attention_partial", dh, h // hkv))
    ms = time_ms(torch, lambda: da.decode_attention_partial_cuda(
        q, ck, cv, cpos, pos, **kw))
    dev_ms = cold_graph_ms(
        torch, lambda *a: da.decode_attention_partial_cuda(*a, **kw),
        (q, ck, cv, cpos, pos))
    plain_ms = time_ms(torch, lambda: da.decode_attention_partial_plain(
        q, ck, cv, cpos, pos, **kw))
    flops, nbytes = da.partial_work(
        q, cpos, hkv, int(da.valid_keys(cpos, pos, window).sum().item()))
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.PARTIAL_KERNEL.replaces, max_abs_err=errs[-1], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call returns softmax partials",
        graph_ms=dev_ms, shape=f"{tag} bf16 in, float32 partials out"))
    print(f"  time {ms:.4f} ms (in a CUDA graph, L2 cold {dev_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, no library call, bound {b_ms:.4f} ms "
          f"({b_by})")


def paged_inputs(torch, g, b, h, hkv, dh, nblk, pt, dtype, min_len):
    """Page pools with a null page 0, a page that rows 0 and 1 share, and
    unmapped (null) tail blocks; every row's gathered positions causal.
    Returns the kernel's arguments and the host block table and
    positions."""
    import numpy as np
    npages = 1 + b * nblk
    pk = torch.randn((npages, pt, hkv, dh), generator=g,
                     device="cuda").to(dtype)
    pv = torch.randn((npages, pt, hkv, dh), generator=g,
                     device="cuda").to(dtype)
    q = torch.randn((b, h, dh), generator=g, device="cuda").to(dtype)
    k1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    v1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    pos = torch.randint(min_len, nblk * pt - 1, (b,), generator=g,
                        device="cuda", dtype=torch.int32)
    ids = (torch.randperm(npages - 1, generator=g, device="cuda") + 1)
    ids, pos_h = ids.cpu().numpy(), pos.cpu().numpy()
    bt = np.zeros((b, nblk), np.int32)
    for i in range(b):
        used = -(-int(pos_h[i]) // pt)
        bt[i, :used] = ids[i * nblk:i * nblk + used]
    bt[1, 0] = bt[0, 0]
    ppos = np.full((npages, pt), -1, np.int32)
    for i in range(b):
        for j in range(nblk):
            if bt[i, j]:
                ppos[bt[i, j]] = np.arange(j * pt, (j + 1) * pt)
    args = (q, pk, pv, torch.from_numpy(ppos).cuda(),
            torch.from_numpy(bt).cuda(), k1, v1, pos)
    return args, bt, ppos, pos_h


def kernel_decode_attention_paged(torch, g, records, name, b, h, hkv, dh,
                                  nblk, pt=PAGE_TOKENS):
    from repro_torch.kernels import decode_attention as da
    import torch.nn.functional as F
    print(f"decode_attention_paged (block-table GQA decode, "
          f"csrc/decode_attention.cu), G {h // hkv}")
    sc = nblk * pt
    args32, _, _, _ = paged_inputs(torch, g, b, h, hkv, dh, nblk, pt,
                                   torch.float32, 128)
    shape = f"B{b} H{h} Hkv{hkv} Dh{dh} pt{pt} nblk{nblk} P{1 + b * nblk}"
    for cap in (0.0, 30.0):
        got = da.decode_attention_paged_cuda(*args32, softcap=cap)
        check(f"fp32 {shape} softcap={cap}", got,
              da.decode_attention_paged_plain(*args32, softcap=cap),
              "float32")
        q, pk, pv, ppos, bt, k1, v1, pos = args32
        fused = da.decode_attention_cuda(
            q, *da.gather_pages(pk, pv, ppos, bt), k1, v1, pos, softcap=cap)
        if not torch.equal(got, fused):
            raise AssertionError(f"paged kernel differs from the fused "
                                 f"kernel on the gathered pages (fp32, "
                                 f"softcap {cap})")
        print(f"  fp32 softcap={cap}: bitwise equal to the fused kernel on "
              f"the gathered pages")
    args = tuple(t.bfloat16() if t.is_floating_point() else t
                 for t in args32)
    del args32
    q, pk, pv, ppos, bt, k1, v1, pos = args
    got = da.decode_attention_paged_cuda(*args)
    err = check(f"bf16 {shape}", got, da.decode_attention_paged_plain(*args),
                "bfloat16")
    check(f"bf16 {shape} vs float32 plain", got,
          da.decode_attention_paged_plain(*(t.float() if t.is_floating_point()
                                            else t for t in args)),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    ck, cv, cpos = da.gather_pages(pk, pv, ppos, bt)
    if not torch.equal(got, da.decode_attention_cuda(q, ck, cv, cpos, k1, v1,
                                                     pos)):
        raise AssertionError("paged kernel differs from the fused kernel "
                             "on the gathered pages (bf16)")
    print("  bf16: bitwise equal to the fused kernel on the gathered pages")
    CHECKED.add(("decode_attention_paged", dh, h // hkv))

    def kern():
        return da.decode_attention_paged_cuda(*args)
    ms = time_ms(torch, kern)
    dev_ms = cold_graph_ms(torch, da.decode_attention_paged_cuda, args)
    plain_ms = time_ms(torch, lambda: da.decode_attention_paged_plain(*args))
    # library yardstick: SDPA over the pre-gathered view + current token
    # (the gather itself excluded: no single PyTorch call walks a block
    # table)
    grp = h // hkv
    kk = torch.cat([ck, k1[:, None]], 1).transpose(1, 2)
    vv = torch.cat([cv, v1[:, None]], 1).transpose(1, 2)
    kk = kk.repeat_interleave(grp, 1).contiguous()
    vv = vv.repeat_interleave(grp, 1).contiguous()
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    mask = torch.cat([valid, torch.ones((b, 1), dtype=torch.bool,
                                        device="cuda")], 1)[:, None, None]
    qq = q[:, :, None, :]

    def sdpa(qq=qq, kk=kk, vv=vv, mask=mask):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
    lib_ms = time_ms(torch, sdpa)
    lib_dev_ms = cold_graph_ms(torch, sdpa, (qq, kk, vv, mask))
    # bytes of the valid pages: every (page, offset) some row attends to,
    # once, with the positions of the pages read and the block table
    flops, nbytes = da.paged_work(q, k1, bt, pt, int(valid.sum().item()),
                                  *da.paged_reads(bt, valid, pt))
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.PAGED_KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="SDPA on the pre-gathered view, gather excluded",
        graph_ms=dev_ms, library_graph_ms=lib_dev_ms,
        shape=f"{shape} bf16, {int(cpos.shape[1])}-token view"))
    print(f"  time {ms:.4f} ms (in a CUDA graph, L2 cold {dev_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, SDPA on the pre-gathered view "
          f"{lib_ms:.4f} ms (in a CUDA graph, L2 cold {lib_dev_ms:.4f}), "
          f"bound {b_ms:.4f} ms "
          f"({b_by})")


def kernel_flash_chunk(torch, g, b, sk, h, hkv, dh, c_big):
    """The flash kernel at a chunked-prefill shape: max_batch rows of C
    queries against the gathered Sk-key view; rows outside the chunk
    carry q_pos -1 (their keys are live decode state), pads -1. Float32
    at C 8, bf16 at ``c_big`` (also against the float32 plain version).
    The served chunk shapes are checked on their own positions after the
    runs (served_flash_phase)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    print(f"flash_attention at a chunk shape, G {h // hkv} "
          f"(csrc/flash_attention.cu)")
    for c, dtype in ((8, torch.float32), (c_big, torch.bfloat16)):
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        q = torch.randn((b, c, h, dh), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, sk, hkv, dh), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, sk, hkv, dh), generator=g, device="cuda").to(dtype)
        ar = torch.arange(sk, device="cuda", dtype=torch.int32)
        kp = torch.where(ar < 100, ar, torch.full_like(ar, -1)).repeat(b, 1)
        qp = torch.full((b, c), -1, device="cuda", dtype=torch.int32)
        # row 0: the chunk [0, c - 1) of a fresh prompt (one pad);
        # row 1: the chunk [200, 200 + c) after a 200-token prefix
        take = c - 1
        qp[0, :take] = torch.arange(take, device="cuda", dtype=torch.int32)
        kp[0] = torch.where(ar < take, ar, torch.full_like(ar, -1))
        qp[1] = torch.arange(200, 200 + c, device="cuda", dtype=torch.int32)
        kp[1] = torch.where(ar < 200 + c, ar, torch.full_like(ar, -1))
        label = (f"{'fp32' if c == 8 else 'bf16'} B{b} C{c} Sk{sk} H{h} "
                 f"Hkv{hkv} Dh{dh}, rows outside the chunk")
        got = fa.flash_attention_cuda(q, k, v, qp, kp)
        check(label, got, blockwise_attention(q, k, v, qp, kp, block_k=16),
              dname)
        if dtype == torch.bfloat16:
            check(f"{label}, vs float32 plain", got, blockwise_attention(
                q.float(), k.float(), v.float(), qp, kp, block_k=16),
                atol=ROUND_ATOL, rtol=ROUND_RTOL)
    CHECKED.add(("flash_attention", dh, h // hkv))


def kernel_dense_family(torch, g, records):
    """The attention kernels at the shapes the dense family's runs give
    them: Gemma2-2B (Dh 256, G 2, softcap 50; local layers a wrapped
    4096-token ring with window 4096, global layers RING_MAX_SEQ slots),
    H2O-Danube-1.8B (Dh 80, G 4, window 4096) and Qwen2-1.5B (Dh 128,
    G 6: contiguous and paged decode), and the partial kernel at both
    Gemma2 decode shapes; flash at each (Dh, G, window, softcap) on a
    128-token prompt in float32 and bf16 (the served prompt and chunk
    shapes are checked and timed after the runs)."""
    ring = (4100, 4200)
    print("Gemma2-2B decode attention (Dh 256, G 2, softcap 50)")
    decode_attention_at(torch, g, records,
                        "decode_attention_fused[gemma2 local]", 8, 8, 4,
                        256, 4096, window=4096, softcap=50.0, ring=ring)
    decode_attention_at(torch, g, records,
                        "decode_attention_fused[gemma2 global]", 8, 8, 4,
                        256, RING_MAX_SEQ, softcap=50.0)
    print("decode_attention_partial at Gemma2-2B's decode shapes")
    partial_at(torch, g, records, "decode_attention_partial[gemma2 local]",
               8, 8, 4, 256, 4096, window=4096, softcap=50.0, ring=ring)
    partial_at(torch, g, records, "decode_attention_partial[gemma2 global]",
               8, 8, 4, 256, RING_MAX_SEQ, softcap=50.0)
    print("Gemma2-2B flash attention")
    for window in (4096, 0):
        flash_attention_at(torch, g, 1, 128, 8, 4, 256, window=window,
                           softcap=50.0)
    print("H2O-Danube-1.8B attention (Dh 80, G 4, window 4096)")
    decode_attention_at(torch, g, records, "decode_attention_fused[danube]",
                        4, 32, 8, 80, 4096, window=4096, ring=ring)
    flash_attention_at(torch, g, 1, 128, 32, 8, 80, window=4096)
    print("Qwen2-1.5B attention (Dh 128, G 6)")
    decode_attention_at(torch, g, records, "decode_attention_fused[qwen2]",
                        8, 12, 2, 128, QWEN2_MAX_SEQ)
    kernel_decode_attention_paged(torch, g, records,
                                  "decode_attention_paged[qwen2]", 8, 12, 2,
                                  128, QWEN2_MAX_SEQ // PAGE_TOKENS)
    flash_attention_at(torch, g, 1, 128, 12, 2, 128)


def kernel_families(torch, g, records):
    """The attention kernels at the shapes phase 17's runs give them: the
    fused decode kernel for each family (8 rows, a FAMILY_MAX_SEQ cache),
    the paged one for the two families served paged (Qwen1.5-MoE at G 1,
    Granite at G 48), and flash on each family's FAMILY_PROMPT-token
    prompt, in float32 and bf16 (bf16 also against the float32 plain
    version); then G 48 bitwise six G-8 calls on the head slices. The
    expert FFN's shapes are checked after the runs (family_ffn_checks)."""
    from repro_torch.configs import get_config
    for label, arch, _, _, paged in FAMILIES:
        cfg = get_config(arch)
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        print(f"{cfg.name} attention (Dh {dh}, G {h // hkv})")
        decode_attention_at(torch, g, records,
                            f"decode_attention_fused[{label}]", 8, h, hkv,
                            dh, FAMILY_MAX_SEQ)
        if paged:
            kernel_decode_attention_paged(
                torch, g, records, f"decode_attention_paged[{label}]", 8, h,
                hkv, dh, FAMILY_MAX_SEQ // PAGE_TOKENS)
        flash_attention_at(torch, g, 1, FAMILY_PROMPT, h, hkv, dh)
    g48_is_six_g8_calls(torch, g)


def kernel_whisper(torch, g, records):
    """The attention kernels at the shapes phase 18's Whisper run gives
    them: the fused decode kernel at (Dh 64, G 1) over 8 rows of its
    max_seq cache, and flash on the decoder's prompt (causal) and, without
    the causal mask, on an encoder's input, in float32 and bf16 (bf16 also
    against the float32 plain version). The served shapes, the encoder's
    1,500 frames among them, are held and timed after the runs."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper_small")
    _, _, prompt_len, _, _, max_seq = RECURRENT_FAMILIES[1]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    print(f"{cfg.name} attention (Dh {dh}, G {h // hkv})")
    decode_attention_at(torch, g, records, "decode_attention_fused[whisper]",
                        8, h, hkv, dh, max_seq)
    flash_attention_at(torch, g, 1, prompt_len, h, hkv, dh)
    flash_attention_at(torch, g, 2, 200, h, hkv, dh, causal=False)


def g48_is_six_g8_calls(torch, g):
    """Granite's decode shape (B 8, H 48 on one KV head, Dh 128): the G-48
    call of the fused and of the paged kernel, in float32 and bf16, is
    bitwise the six G-8 calls on the six head slices over the same cache
    (a head's running max, sums and order of sums depend on its q only)."""
    from repro_torch.kernels import decode_attention as da
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("fused", "paged"):
            if kind == "fused":
                args = list(decode_inputs(torch, g, 8, 48, 1, 128,
                                          FAMILY_MAX_SEQ, dtype, 128))
                fn = da.decode_attention_cuda
            else:
                args = list(paged_inputs(
                    torch, g, 8, 48, 1, 128, FAMILY_MAX_SEQ // PAGE_TOKENS,
                    PAGE_TOKENS, dtype, 128)[0])
                fn = da.decode_attention_paged_cuda
            whole = fn(*args)
            bad = [i for i in range(6) if not torch.equal(
                whole[:, 8 * i:8 * i + 8],
                fn(args[0][:, 8 * i:8 * i + 8].contiguous(), *args[1:]))]
            if bad:
                raise AssertionError(f"{kind} decode at G 48 ({dtype}) "
                                     f"differs from the G-8 calls on head "
                                     f"slices {bad}")
            print(f"  {kind} decode at G 48, {dtype}: bitwise the six G-8 "
                  f"calls on the head slices")


def kernel_flash_attention(torch, g):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    print("flash_attention (prefill GQA, csrc/flash_attention.cu)")
    # fp32 small: GQA, -1 positions (a fully masked row), window, softcap
    bs, s, h, hkv, dh = 2, 40, 6, 2, 32
    q = torch.randn((bs, s, h, dh), generator=g, device="cuda")
    k = torch.randn((bs, s, hkv, dh), generator=g, device="cuda")
    v = torch.randn((bs, s, hkv, dh), generator=g, device="cuda")
    p = torch.arange(s, device="cuda", dtype=torch.int32).repeat(bs, 1)
    p[1, 30:] = -1
    for window, cap in ((0, 0.0), (8, 0.0), (0, 30.0)):
        check(f"fp32 B{bs} S{s} H{h} Hkv{hkv} Dh{dh} window={window} "
              f"softcap={cap}",
              fa.flash_attention_cuda(q, k, v, p, p, window=window,
                                      softcap=cap),
              blockwise_attention(q, k, v, p, p, window=window, softcap=cap,
                                  block_k=16), "float32")
    # Mixtral's heads on one 128-token prompt
    flash_attention_at(torch, g, 1, 128, 32, 8, 128)


def flash_attention_at(torch, g, b, s, h, hkv, dh, *, window=0,
                       softcap=0.0, causal=True):
    """The flash kernel on a prompt of s tokens (causal, or not: an
    encoder's) in float32 and bf16 (the latter also against the float32
    plain version). The plain version runs one query block (block_q = S):
    every row's online softmax is the same, and a long prompt then takes
    S / 16 steps instead of (S / 64) * (S / 16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    kw = dict(window=window, softcap=softcap, causal=causal)
    tag = (f"B{b} S{s} H{h} Hkv{hkv} Dh{dh} "
           + ("causal" if causal else "not causal")
           + (f" window={window}" if window else "")
           + (f" softcap={softcap:g}" if softcap else ""))
    p = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    qkv = [torch.randn((b, s, n, dh), generator=g, device="cuda")
           for n in (h, hkv, hkv)]

    def plain(q, k, v):
        return blockwise_attention(q, k, v, p, p, block_q=s, block_k=16,
                                   **kw)
    check(f"fp32 {tag}", fa.flash_attention_cuda(*qkv, p, p, **kw),
          plain(*qkv), "float32")
    q, k, v = (t.bfloat16() for t in qkv)
    got = fa.flash_attention_cuda(q, k, v, p, p, **kw)
    check(f"bf16 {tag}", got, plain(q, k, v), "bfloat16")
    check(f"bf16 {tag} vs float32 plain", got,
          plain(q.float(), k.float(), v.float()),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    CHECKED.add(("flash_attention", dh, h // hkv))


def flash_case(torch, g, shape):
    """bf16 q, k, v of a served flash shape (seeded) with the positions of
    its first call, and the kernel and plain calls on them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    qp, kp = SEEN["flash"][shape]
    q, k, v = (torch.randn((shape.b, n, hh, shape.dh), generator=g,
                           device="cuda").bfloat16()
               for n, hh in ((shape.sq, shape.h), (shape.sk, shape.hkv),
                             (shape.sk, shape.hkv)))
    kw = dict(window=shape.window, softcap=shape.softcap,
              causal=shape.causal)

    def kern():
        return fa.flash_attention_cuda(q, k, v, qp, kp, **kw)

    def plain(q=q, k=k, v=v):
        return blockwise_attention(q, k, v, qp, kp, block_q=shape.sq,
                                   block_k=16, **kw)
    return q, k, v, qp, kp, kern, plain


def served_flash_phase(torch, g):
    """Every flash shape the runs gave the kernel, on the positions of its
    first call (pad tails and rows outside a chunk included) with seeded
    bf16 q/k/v: against the bf16 plain version (2e-2) and the float32
    plain version (half a bf16 ulp + 1e-4). Returns each shape's max abs
    error."""
    print(f"flash_attention at the {len(SEEN['flash'])} shapes the runs "
          f"gave it, on their recorded positions")
    errs = {}
    for shape in sorted(SEEN["flash"]):
        q, k, v, qp, kp, kern, plain = flash_case(torch, g, shape)
        got = kern()
        tag = (f"bf16 {shape.tag()}, {int((qp >= 0).sum())} query rows "
               f"with a position")
        errs[shape] = check(tag, got, plain(), "bfloat16")
        check(f"{tag} vs float32 plain", got,
              plain(q.float(), k.float(), v.float()),
              atol=ROUND_ATOL, rtol=ROUND_RTOL)
        FLASH_CHECKED.add(shape)
        del q, k, v, got
    return errs


def flash_record(torch, g, records, name, run, phase, errs, *, window=None,
                 causal=None):
    """A record of the flash kernel at the largest shape (Sq x Sk) that
    ``run`` gave it in ``phase`` (with a window or not, if ``window`` is
    given; causal or not, if ``causal`` is given), timed on that shape's
    recorded positions; its launches are the run's launches at that
    shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    shapes = {sh: n for (ph, sh), n in run.flash.items() if ph == phase and
              (window is None or bool(sh.window) == window) and
              (causal is None or sh.causal == causal)}
    if not shapes:
        raise AssertionError(f"{name}: the run gave the flash kernel no "
                             f"shape in its {phase} phase")
    shape = max(shapes, key=lambda sh: (sh.sq * sh.sk, sh.b))
    q, k, v, qp, kp, kern, plain = flash_case(torch, g, shape)
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    dev_ms, lib_dev_ms = graph_ms(torch, kern), None
    lib_ms, library = None, "none: SDPA has no tanh softcap"
    mask = fa.pair_mask(qp, kp, causal=shape.causal, window=shape.window)
    if not shape.softcap:
        grp = shape.h // shape.hkv
        qq = q.transpose(1, 2).contiguous()
        kk = k.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
        vv = v.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
        ar = torch.arange(shape.sq, device="cuda", dtype=torch.int32)
        if shape.sq == shape.sk and shape.causal and not shape.window and \
                bool((qp == ar).all()) and bool((kp == ar).all()):
            def sdpa():
                return F.scaled_dot_product_attention(qq, kk, vv,
                                                      is_causal=True)
        elif not shape.causal and bool(mask.all()):
            # an encoder's full attention: every pair, no mask
            def sdpa():
                return F.scaled_dot_product_attention(qq, kk, vv,
                                                      is_causal=False)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask[:, None])
        lib_ms, lib_dev_ms = time_ms(torch, sdpa), graph_ms(torch, sdpa)
        library = "SDPA"
    flops, nbytes = fa.work(qp, kp, shape.h, shape.hkv, shape.dh,
                            causal=shape.causal, window=shape.window)
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces=fa.KERNEL.replaces, max_abs_err=errs[shape], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library=library, launches=shapes[shape], graph_ms=dev_ms,
        library_graph_ms=lib_dev_ms,
        shape=f"{shape.tag()} bf16, {int((qp >= 0).sum())} query rows with "
              f"a position (served; {sum(shapes.values())} launches over "
              f"{len(shapes)} shapes in this phase)"))
    print(f"  {name}: {shape.tag()}, {shapes[shape]} launches: time "
          f"{ms:.4f} ms (in a CUDA graph {dev_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, "
          + (f"SDPA {lib_ms:.4f} ms (in a CUDA graph {lib_dev_ms:.4f})"
             if lib_ms is not None else library)
          + f", bound {b_ms:.4f} ms ({b_by})")


def scan_inputs(torch, g, bs, s, h, p, n, dtype):
    x = torch.randn((bs, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bs, s, h), generator=g, device="cuda"))
    a = -torch.exp(torch.randn((h,), generator=g, device="cuda") * 0.5)
    b = torch.randn((bs, s, n), generator=g, device="cuda") * 0.3
    c = torch.randn((bs, s, n), generator=g, device="cuda") * 0.3
    return x, dt, a, b, c


def kernel_ssm_scan(torch, g, records, shapes, name="ssm_scan"):
    """The SSD scan at Zamba2-7B's widths (112 heads, P = N = 64, chunk
    64) for every (B, S) in ``shapes`` (added to SCAN_CHECKED; checked
    against what the runs give it, after them), plus one step and an odd
    length that halves the chunk to 1: float32 within 2e-4 of the plain
    chunked scan (the Pallas kernel's bar), bf16 within half an ulp +
    1e-4 of the float32 plain version. Each shape's record is ``name``."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssm_scan as ss
    print("ssm_scan (Mamba2/SSD chunked scan, csrc/ssm_scan.cu)")
    h, p, n, chunk = 112, 64, 64, 64
    for bs, s_ in ((1, 1), (1, 127), (2, 96), (1, 192)):
        args = scan_inputs(torch, g, bs, s_, 8, p, n, torch.float32)
        y, hf = ss.ssm_scan_cuda(*args, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(*args, chunk=chunk)
        tag = f"fp32 B{bs} S{s_} H8 P{p} N{n} (chunk " \
              f"{kref.scan_chunk(s_, chunk)})"
        check(f"{tag} y", y, wy, atol=2e-4, rtol=2e-4)
        check(f"{tag} h_final", hf, wh, atol=2e-4, rtol=2e-4)
    for bs, s_ in shapes:
        args32 = scan_inputs(torch, g, bs, s_, h, p, n, torch.float32)
        y, hf = ss.ssm_scan_cuda(*args32, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(*args32, chunk=chunk)
        tag = f"B{bs} S{s_} H{h} P{p} N{n}"
        check(f"fp32 {tag} y", y, wy, atol=2e-4, rtol=2e-4)
        check(f"fp32 {tag} h_final", hf, wh, atol=2e-4, rtol=2e-4)
        args = (args32[0].bfloat16(),) + args32[1:]
        y, hf = ss.ssm_scan_cuda(*args, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(args[0].float(), *args[1:],
                                           chunk=chunk)
        err = check(f"bf16 {tag} y vs float32 plain", y, wy,
                    atol=ROUND_ATOL, rtol=ROUND_RTOL)
        check(f"bf16 {tag} h_final vs float32 plain", hf, wh, atol=2e-4,
              rtol=2e-4)
        ms = time_ms(torch, lambda: ss.ssm_scan_cuda(*args, chunk=chunk))
        # in a CUDA graph, the calls taking copies of the inputs in turn
        # (they fit in L2): device time read from HBM, no host time
        dev_ms = cold_graph_ms(
            torch, lambda *t: ss.ssm_scan_cuda(*t, chunk=chunk), args)
        plain_ms = time_ms(torch, lambda: kref.ssm_scan_chunked_ref(
            *args, chunk=chunk))
        t = kref.scan_chunk(s_, chunk)
        flops, nbytes = ss.work(bs, s_, h, p, n, chunk)
        b_ms, b_by = bound(nbytes, flops, h100().FP32_FLOPS_PER_S)
        SCAN_CHECKED.add((bs, s_))
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/ssm_scan.cu",
            replaces=ss.KERNEL.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            library="none: no single PyTorch call computes the SSD scan",
            cold_graph_ms=dev_ms,
            shape=f"{tag} chunk {t} bf16 x, float32 math (bound at the "
                  f"67 TFLOP/s float32 peak)"))
        print(f"  time {ms:.4f} ms (in a CUDA graph, inputs from HBM, "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, no library call, "
              f"bound {b_ms:.4f} ms ({b_by}, float32 peak)")
        del args, args32


def kernel_moe_gemm(torch, g, records, shapes, *, timed=None, small=True):
    """``shapes``: (label, (P, C, D, F, path)), calls at Mixtral-8x7B's
    widths on P slots at capacity C that take the kernel path ``path`` (a
    decode step takes "skinny"). Each is held to the plain versions and
    its key added to FFN_CHECKED; those whose label is in ``timed`` (None
    = all) are also timed and recorded. ``small`` adds the float32 cases
    at small widths."""
    from repro_torch.kernels import moe_gemm as mg
    print("moe_gemm (grouped expert FFN, csrc/moe_gemm.cu)")
    # fp32 small, both paths (C <= 4 streams split-K; larger C tiles):
    # gated silu and ungated gelu, empty slots, a -1 slot
    p_, d_, f_, e_ = 6, 96, 160, 4
    w = [torch.randn((e_, d_, f_), generator=g, device="cuda") * 0.1
         for _ in range(2)]
    wd = torch.randn((e_, f_, d_), generator=g, device="cuda") * 0.1
    se = torch.tensor([0, 1, 2, 3, 1, -1], dtype=torch.int32, device="cuda")
    for c_ in (3, 24) if small else ():
        x = torch.randn((p_, c_, d_), generator=g, device="cuda")
        cnt = torch.tensor([c_, 0, 1, c_, 2, 0], dtype=torch.int32,
                           device="cuda")
        for act, wg in (("silu", w[0]), ("gelu", None)):
            check(f"fp32 P{p_} C{c_} D{d_} F{f_} {act} "
                  f"{'gated' if wg is not None else 'ungated'}",
                  mg.expert_ffn_cuda(x, wg, w[1], wd, se, cnt, decode=True,
                                     act=act),
                  mg.expert_ffn_plain(x, wg, w[1], wd, se, cnt, act=act),
                  "float32")
    # the serving shapes: Mixtral's 8-expert bank
    d, f, n_exp = 4096, 14336, 8
    std = 1.0 / d ** 0.5
    bank = [(torch.randn((n_exp, d, f), generator=g, device="cuda") *
             std).bfloat16() for _ in range(2)]
    wdn = (torch.randn((n_exp, f, d), generator=g, device="cuda") *
           f ** -0.5).bfloat16()
    for label, (n_slot, c, d_, f_, path) in shapes:
        if (d_, f_) != (d, f):
            raise AssertionError(f"moe_gemm[{label}]: D {d_} F {f_} are "
                                 f"not Mixtral-8x7B's widths")
        decode = path == "skinny"
        # primaries 0..7, shadows replicate EW 0's experts (the initial
        # plan)
        se = torch.tensor(list(range(8)) + [i % 4 for i in range(n_slot - 8)],
                          dtype=torch.int32, device="cuda")
        cnt = torch.tensor([c] * 8 + [0] * (n_slot - 8), dtype=torch.int32,
                           device="cuda")
        x = torch.randn((n_slot, c, d), generator=g,
                        device="cuda").bfloat16()
        x[8:] = 0

        def kern():
            return mg.expert_ffn_cuda(x, bank[0], bank[1], wdn, se, cnt,
                                      decode=decode)

        def plain():
            return mg.expert_ffn_plain(x, bank[0], bank[1], wdn, se, cnt)

        before = dict(mg.path_launches)
        got = kern()
        taken = [k for k, v in mg.path_launches.items() if v != before[k]]
        if taken != [path]:
            raise AssertionError(f"moe_gemm at C {c} took path {taken}, "
                                 f"expected {path}")
        err = check(f"bf16 P{n_slot} C{c} D{d} F{f} ({label}, {path} "
                    f"path)", got, plain(), "bfloat16")
        # the 8 active slots (slot p < 8 runs expert p), upcast: the
        # float32 bank is 11 GiB, its 16-slot gather would be 22 more
        check(f"bf16 P{n_slot} C{c} D{d} F{f} ({label}) active slots vs "
              f"float32 plain", got[:8],
              mg.expert_ffn_plain(x[:8].float(), bank[0].float(),
                                  bank[1].float(), wdn.float(), se[:8],
                                  cnt[:8]),
              atol=ROUND_ATOL, rtol=ROUND_RTOL)
        FFN_CHECKED.add((n_slot, c, d, f, path))
        del got
        torch.cuda.empty_cache()
        if timed is not None and label not in timed:
            del x, cnt, se
            continue
        plain_ms = time_ms(torch, plain)
        # library yardstick: the per-slot matmul chain over active slots
        xa = x[:8]
        wg8, wu8, wd8 = bank[0][:8], bank[1][:8], wdn[:8]

        def chain():
            return torch.bmm(torch.nn.functional.silu(torch.bmm(xa, wg8)) *
                             torch.bmm(xa, wu8), wd8)
        # in turns (kernel, chain, chain, kernel), each the mean of its
        # two medians: the card's first timings after the plain version's
        # float32 work can run slow for a while
        t = [time_ms(torch, fn) for fn in (kern, chain, chain, kern)]
        ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        # in a CUDA graph: no host time; the 2.8 GB bank never fits L2
        dev_ms, lib_dev_ms = graph_ms(torch, kern), graph_ms(torch, chain)
        active = int((cnt > 0).sum().item())  # the kernel skips the rest
        flops, nbytes = mg.work(n_slot, c, d, f, active, active)
        b_ms, b_by = bound(nbytes, flops)
        records.append(dict(
            name=f"moe_gemm[{label}]", route="cuda",
            source="src/repro_torch/csrc/moe_gemm.cu",
            replaces=mg.KERNEL.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library="bmm chain", graph_ms=dev_ms,
            library_graph_ms=lib_dev_ms,
            shape=f"P{n_slot} (8 active) C{c} D{d} F{f} bf16, "
                  f"{'decode step' if decode else 'prefill/chunk call'}, "
                  f"{path} path"))
        print(f"  time {ms:.4f} ms ({t[0]:.4f} / {t[3]:.4f}; in a CUDA "
              f"graph {dev_ms:.4f}), plain {plain_ms:.4f} ms, bmm chain "
              f"{lib_ms:.4f} ms ({t[1]:.4f} / {t[2]:.4f}; in a CUDA graph "
              f"{lib_dev_ms:.4f}), bound {b_ms:.4f} ms ({b_by})")
        del x, cnt, se
    del bank, wdn
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# reference and serve phases
# --------------------------------------------------------------------------

def reference_phase(torch, cfg):
    """A reduced float32 model through the kernels on the card against
    the same model's plain path on the CPU (logits to 1e-3)."""
    from repro_torch.models import get_model
    gpu = get_model(cfg, num_aw=2, num_ew=2, device="cuda")
    cpu = get_model(cfg, num_aw=2, num_ew=2, device="cpu")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
    cparams = tree_to(params, "cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen,
                         dtype=torch.int32)
    mask = torch.ones((4, 24), dtype=torch.bool)
    mask[3, 17:] = False
    kw = {}
    if cfg.is_encdec:
        kw["frames"] = torch.randn((4, cfg.encoder_seq, cfg.d_model),
                                   generator=gen)
    lg, cg, _ = gpu.prefill(params, toks.cuda(), gpu.init_route_state(), 48,
                            capacity=32, mask=mask.cuda(),
                            **{k: v.cuda() for k, v in kw.items()})
    lc, cc, _ = cpu.prefill(cparams, toks, cpu.init_route_state(), 48,
                            capacity=32, mask=mask, **kw)
    pos = torch.tensor([24, 24, -1, 24], dtype=torch.int32)
    nt = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                       dtype=torch.int32)
    dg, _, _ = gpu.decode(params, nt.cuda(), pos.cuda(), cg,
                          gpu.init_route_state())
    dc, _, _ = cpu.decode(cparams, nt, pos, cc, cpu.init_route_state())
    for name, a, b in (("prefill", lg, lc), ("decode", dg, dc)):
        err = (a.cpu() - b).abs().max().item()
        print(f"  {cfg.name} ({cfg.num_layers} layers) fp32 {name} logits, "
              f"card vs CPU: "
              f"max_abs_err {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{name} logits disagree with the CPU "
                                 f"plain path: {err:.3e}")


def all_kernels():
    from repro_torch.kernels import decode_attention, flash_attention, \
        moe_gemm, ssm_scan
    return (decode_attention.KERNEL, decode_attention.PAGED_KERNEL,
            decode_attention.PARTIAL_KERNEL, flash_attention.KERNEL,
            moe_gemm.KERNEL, ssm_scan.KERNEL)


def launch_counts():
    """Every kernel's launch count, and the flash kernel's and the expert
    FFN's per path."""
    from repro_torch.kernels import flash_attention, moe_gemm
    counts = {k.symbol: k.launches for k in all_kernels()}
    counts.update({f"flash_attention/{k}": v
                   for k, v in flash_attention.path_launches.items()})
    counts.update({f"moe_ffn/{k}": v
                   for k, v in moe_gemm.path_launches.items()})
    return counts


# what each Run gives the kernels, observed around the wrappers (the launch
# counts stay the wrappers' own): per phase of the current Run, a Counter of
# the expert FFN's (P, C, D, F, path); over all runs, those keys, the
# slot experts and counts of the first call at each key made outside a
# step graph's capture (``ffn_calls``), the C of
# prefill and chunk calls, the SSD scan's (B, S), the row counts of the
# row-blocked projections and norms (prefill and chunk calls only), the
# attention kernels' (kernel, Dh, G, window?, softcap?) and every flash
# call's whole shape (FlashShape) with the positions of its first call
SEEN = {"phase": None, "run": None, "ffn": Counter(), "ffn_calls": {},
        "ffn_prefill_c": set(),
        "scan": set(), "rows": set(), "attn": Counter(),
        "attn_run": Counter(), "flash": {}, "flash_run": Counter()}
# the (kernel, Dh, G) each attention kernel was held to its plain version
# at in the kernel phase; main() fails if a run gives a kernel another
CHECKED = set()
# the flash shapes held to the plain version on their recorded positions
# (served_flash_phase); main() fails if a run gave the kernel another
FLASH_CHECKED = set()
# the expert FFN's (P, C, D, F, path) held to the plain versions
# (kernel_moe_gemm, family_ffn_checks); main() fails if a run gave the
# kernel another
FFN_CHECKED = set()
# the SSD scan's (B, S) held to the plain version (kernel_ssm_scan);
# main() fails if a run gave the kernel another
SCAN_CHECKED = set()


def observe_kernel_shapes():
    """Wrap the kernel wrappers to record what each run gives them. An
    observation is added through ``build.count``, as a launch count is: a
    call captured in a step graph is observed on each replay of the graph,
    under the phase and run of the replay."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    ffn, scan, blocked = ops.expert_ffn_cuda, ops.ssm_scan_cuda, \
        layers.row_blocked

    def ffn_seen(key):
        if SEEN["run"] is not None:
            SEEN["run"].setdefault(SEEN["phase"], Counter())[key] += 1
            SEEN["ffn"][key] += 1
            if SEEN["phase"] in ("prefill", "chunks"):
                SEEN["ffn_prefill_c"].add(key[1])

    def ffn_observed(x, *args, **kw):
        y = ffn(x, *args, **kw)
        p, c, d = x.shape
        key = (p, c, d, args[1].shape[2], mg.last_path)   # w_up [E, D, F]
        if key not in SEEN["ffn_calls"] and \
                not torch.cuda.is_current_stream_capturing():
            SEEN["ffn_calls"][key] = (args[3].clone(), args[4].clone())
        build.count(functools.partial(ffn_seen, key))
        return y

    def scan_observed(x, *args, **kw):
        if SEEN["run"] is not None:
            SEEN["scan"].add(tuple(x.shape[:2]))
        return scan(x, *args, **kw)

    def rows_observed(fn, x):
        if SEEN["run"] is not None:
            SEEN["rows"].add(x.numel() // x.shape[-1])
        return blocked(fn, x)

    def attn_seen(key, shape, positions):
        if SEEN["run"] is not None:
            SEEN["attn"][key] += 1
            SEEN["attn_run"][key] += 1
            if shape is not None:
                if shape not in SEEN["flash"]:
                    SEEN["flash"][shape] = positions
                SEEN["flash_run"][(SEEN["phase"], shape)] += 1

    def attn_observed(kernel, fn):
        # q [..., H, Dh]; the cache, page pool or keys [., ., Hkv, Dh]
        def observed(q, kv, *args, **kw):
            key = (kernel, q.shape[-1], q.shape[-2] // kv.shape[2],
                   bool(kw.get("window")), bool(kw.get("softcap")))
            shape = positions = None
            if kernel == "flash_attention":   # args: v, q_pos, k_pos
                shape = FlashShape(
                    q.shape[0], q.shape[1], kv.shape[1], q.shape[2],
                    kv.shape[2], q.shape[3], int(kw.get("window", 0)),
                    float(kw.get("softcap", 0.0)),
                    bool(kw.get("causal", True)))
                if SEEN["run"] is not None and shape not in SEEN["flash"]:
                    positions = (args[1].clone(), args[2].clone())
            out = fn(q, kv, *args, **kw)
            build.count(functools.partial(attn_seen, key, shape, positions))
            return out
        return observed
    ops.expert_ffn_cuda = ffn_observed
    ops.ssm_scan_cuda = scan_observed
    layers.row_blocked = rows_observed
    ops.decode_attention_cuda = attn_observed("decode_attention_fused",
                                              ops.decode_attention_cuda)
    ops.decode_attention_paged_cuda = attn_observed(
        "decode_attention_paged", ops.decode_attention_paged_cuda)
    ops.flash_attention_cuda = attn_observed("flash_attention",
                                             ops.flash_attention_cuda)


def reset_counts():
    from repro_torch.kernels import flash_attention, moe_gemm
    for k in all_kernels():
        k.launches = 0
    for paths in (flash_attention.path_launches, moe_gemm.path_launches):
        for k in paths:
            paths[k] = 0


def delta(a, b):
    return {k: b[k] - a[k] for k in a}


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set ``attrs`` on ``obj`` for the block, then put back what was
    there (a method patched on an instance is deleted again)."""
    own = {k: vars(obj)[k] for k in attrs if k in vars(obj)}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k in attrs:
            if k in own:
                setattr(obj, k, own[k])
            else:
                delattr(obj, k)


@contextlib.contextmanager
def observed(torch, phase):
    """Observe one run through SEEN, starting in ``phase``: yields an
    object with the launch counts at the start (``c0``) and, after the
    block, at the end (``c_end``) and their difference (``ran``), and what
    the run gave the kernels (``ffn_c``: per phase, a Counter of the
    expert FFN's (P, C, D, F, path); ``attn``; ``flash``: (phase,
    FlashShape)).
    Fails if a bf16 flash call took the CUDA-core path or an expert FFN
    launch bypassed the observer."""
    torch.cuda.synchronize()
    obs = SimpleNamespace(c0=launch_counts(), ffn_c={}, attn=Counter(),
                          flash=Counter())
    SEEN["run"], SEEN["attn_run"], SEEN["flash_run"] = \
        obs.ffn_c, obs.attn, obs.flash
    SEEN["phase"] = phase
    try:
        yield obs
    finally:
        SEEN["run"] = None
    obs.c_end = launch_counts()
    ran = obs.ran = delta(obs.c0, obs.c_end)
    if ran["flash_attention/cuda_core"]:
        raise AssertionError(f"{ran['flash_attention/cuda_core']} bf16 "
                             f"serving flash calls took the CUDA-core path")
    if ran["moe_ffn"] != sum(sum(c.values()) for c in obs.ffn_c.values()):
        raise AssertionError(f"{ran['moe_ffn']} expert FFN launches, not "
                             f"all seen through ops.expert_ffn_cuda: "
                             f"{obs.ffn_c}")


class FlashShape(NamedTuple):
    """One flash call's shape: q [B, Sq, H, Dh], keys [B, Sk, Hkv, Dh]."""
    b: int
    sq: int
    sk: int
    h: int
    hkv: int
    dh: int
    window: int
    softcap: float
    causal: bool

    def tag(self):
        return (f"B{self.b} Sq{self.sq} Sk{self.sk} H{self.h} Hkv{self.hkv} "
                f"Dh{self.dh}" + (f" window={self.window}" if self.window
                                  else "")
                + (f" softcap={self.softcap:g}" if self.softcap else "")
                + ("" if self.causal else " not causal"))


class Run:
    """One pass of requests through an engine: streams, per-request token
    times, and launch counts per phase: "prefill" (inside
    ``client.submit``, which admits and, without the chunked plane,
    prefills), "chunks" (the chunked plane's ticks inside ``step()``) and
    "decode" (the rest of ``step()``)."""

    def __init__(self, torch, engine, prompts, max_new, fail=None,
                 at_end=None, warm_up=False, sampling=None, frames=None,
                 after_step=None):
        """``frames``: each prompt's frames (an encoder-decoder's);
        ``after_step(engine, steps)`` runs after each step, outside the
        run's clock and launch counts."""
        from repro_torch.serving.api import RequestSpec
        captures0 = engine.decode_plane.captures()
        chunk_counts = {k: 0 for k in launch_counts()}
        self.tick_s = []       # host time of each chunk tick that ran work
        hooks = contextlib.nullcontext()
        if engine.chunked is not None:
            tick = engine.chunked.tick

            def counted_tick(now):
                c0 = launch_counts()
                t0 = time.perf_counter()
                SEEN["phase"] = "chunks"
                out = tick(now)   # ends in the chunk checkpoint's host copy
                SEEN["phase"] = "decode"
                if out:
                    self.tick_s.append(time.perf_counter() - t0)
                for k, v in delta(c0, launch_counts()).items():
                    chunk_counts[k] += v
                return out
            hooks = patched(engine.chunked, tick=counted_tick)
        with hooks, observed(torch, "prefill") as obs:
            t_submit, handles = {}, []
            self.first, last, self.tbt = {}, {}, []
            for i, p in enumerate(prompts):
                rid = f"r{i}"
                t_submit[rid] = time.perf_counter()
                handles.append(engine.client.submit(RequestSpec(
                    rid=rid, prompt=p, max_new=max_new, sampling=sampling,
                    frames=None if frames is None else frames[i])))
                if handles[-1].tokens():
                    # the exact whole-prompt scheme samples the first token
                    # from the prefill's logits (a host sync) inside submit
                    last[rid] = time.perf_counter()
                    self.first[rid] = last[rid] - t_submit[rid]
            c1 = launch_counts()
            SEEN["phase"] = "decode"
            self.steps = 0
            self.t_fail, self.victims, self.recovery_s = None, [], None
            t_dec0 = None
            # the host time and launches of ``after_step`` are left out of
            # the run's clock and counts
            hook_s, hook_counts = 0.0, Counter()
            while not all(h.done() for h in handles):
                if fail is not None and self.t_fail is None:
                    t = time.perf_counter() - hook_s
                    victims = fail(engine, handles, self.steps)
                    if victims is not None:
                        self.t_fail, self.victims = t, victims
                out = engine.step()
                # step() ends in a host sync
                now = time.perf_counter() - hook_s
                self.steps += 1
                if t_dec0 is None:
                    t_dec0 = now
                for rid in out:
                    if rid not in self.first:
                        self.first[rid] = now - t_submit[rid]
                    else:
                        self.tbt.append(now - last[rid])
                    last[rid] = now
                if self.t_fail is not None and self.recovery_s is None and \
                        all(last.get(r, 0) > self.t_fail
                            for r in self.victims):
                    self.recovery_s = now - self.t_fail
                if after_step is not None:
                    c_h, t_h = launch_counts(), time.perf_counter()
                    after_step(engine, self.steps)
                    hook_s += time.perf_counter() - t_h
                    hook_counts.update(delta(c_h, launch_counts()))
            t_end = time.perf_counter() - hook_s
        if at_end is not None:          # the engine's final caches
            at_end(engine)
        self.ffn_c, self.attn, self.flash = obs.ffn_c, obs.attn, obs.flash
        self.launches = {"prefill": delta(obs.c0, c1), "chunks": chunk_counts,
                         "decode": {k: v - chunk_counts[k] - hook_counts[k]
                                    for k, v in
                                    delta(c1, obs.c_end).items()}}
        self.streams = [h.tokens() for h in handles]
        # release in reverse, so the slot free lists are back in their
        # initial order and a rerun lands every request in the same slot
        # (expert capacity ranks tokens by slot, so placement is part of
        # the input at the model's capacity factor)
        for h in reversed(handles):
            engine.release_request(h.rid)
        self.n_dec = sum(len(s) - 1 for s in self.streams)
        self.dec_s = t_end - t_dec0
        # after an engine's warm-up, failures, restores, sampling changes
        # and segment tails replay the step graphs it has: no new capture
        self.captures = engine.decode_plane.captures()
        if not warm_up and self.captures != captures0:
            raise AssertionError(f"{self.captures - captures0} step graphs "
                                 f"captured after the engine's warm-up")

    def report(self, label):
        ttfts = sorted(self.first.values())
        tbt = self.tbt
        print(f"  {label}: TTFT p50 {pct(ttfts, .5) * 1e3:.2f} ms p99 "
              f"{pct(ttfts, .99) * 1e3:.2f} ms; TBT p50 "
              f"{pct(tbt, .5) * 1e3:.2f} ms p99 {pct(tbt, .99) * 1e3:.2f} "
              f"ms max {max(tbt) * 1e3:.2f} ms; decode "
              f"{self.n_dec / self.dec_s:.1f} tok/s ({self.n_dec} tokens "
              f"in {self.dec_s:.3f} s, {self.steps} steps; step graphs "
              f"{self.captures}, none new)")
        if self.tick_s:
            print(f"    {len(self.tick_s)} chunk ticks: "
                  f"{', '.join(f'{t * 1e3:.1f}' for t in self.tick_s)} ms")
        for phase, counts in self.launches.items():
            print(f"    {phase}: { {k: v for k, v in counts.items() if v} }"
                  + (f", expert FFN (P, C, D, F, path): "
                     f"{dict(sorted(self.ffn_c[phase].items()))}"
                     if phase in self.ffn_c else ""))


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


def mixtral_8_layers(capacity_factor=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=8,
                              dtype="bfloat16")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def cache_copy(cache):
    """A copy of every tensor of an engine's cache."""
    return {k: [{n: t.clone() for n, t in layer.items()} for layer in v]
            if k == "layers" else v.clone() for k, v in cache.items()}


def cache_leaves(cache):
    """(name, tensor) of every leaf of an engine's cache, in order."""
    for k, v in cache.items():
        if k == "layers":
            for i, layer in enumerate(v):
                for n, t in layer.items():
                    yield f"layers.{i}.{n}", t
        else:
            yield k, v


def cache_put(cache, copy):
    """Write a ``cache_copy`` back into the engine's cache, in place."""
    for (_, t), (_, c) in zip(cache_leaves(cache), cache_leaves(copy)):
        t.copy_(c)


def graph_equals_eager(torch, engine, seg_len, what):
    """Hold a replay of the step graph of ``seg_len`` steps bit for bit
    against the same step run eagerly from the same state: the plane's
    eager segment, given the engine's current RouteState (the graph reads
    the plane's copy of it, refilled before each dispatch; a graph that
    read stale routing tensors would send tokens to other slots), gives
    the token ring, the slot loads and the cache a replay must give. The
    cache is put back afterwards."""
    plane = engine.decode_plane
    key = plane.load(engine.active_requests(), seg_len)
    before = cache_copy(engine.cache)
    ring, loads = (t.clone() for t in plane.segment(key[0], key[1],
                                                    engine.route_state))
    eager = cache_copy(engine.cache)
    cache_put(engine.cache, before)
    if plane.graphs.get(key) is None:
        plane.graphs[key] = plane.capture(key)
    g_ring, g_loads = plane.graphs[key].replay()
    bad = [n for (n, a), (_, b) in zip(cache_leaves(engine.cache),
                                       cache_leaves(eager))
           if not torch.equal(a, b)]
    if not torch.equal(ring, g_ring):
        bad.append("token ring")
    if not torch.equal(loads, g_loads):
        bad.append("slot loads")
    cache_put(engine.cache, before)
    if bad:
        raise AssertionError(f"{what}: the seg-{seg_len} graph replay "
                             f"differs from the eager step in {bad}")
    print(f"  {what}: seg {seg_len} graph replay bitwise the eager step "
          f"from the same state (token ring {ring.shape[0]} x "
          f"{ring.shape[1]}, slot loads {loads.sum(0).int().tolist()}, "
          f"{sum(1 for _ in cache_leaves(eager))} cache leaves)")


def device_busy_ms(torch, fn, calls):
    """The union of the device spans of ``calls`` calls of ``fn`` under
    torch.profiler (CUDA activity only), per call, and the device ops per
    call; (None, 0) when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    # the trace's events hold reference cycles: free them here, not in a
    # later phase's collection
    del prof
    gc.collect()
    if not spans:
        return None, 0
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3 / calls, len(spans) / calls


def step_times(torch, engine, prompts, label, reps=6, segs=(1, 8)):
    """Per decode step, at the batch of ``prompts`` two steps into decode:
    ``decode_step_times``. The repeated steps rewrite the same KV; the
    requests then run to their end and are released."""
    from repro_torch.serving.api import RequestSpec
    t0 = time.perf_counter()
    handles = [engine.client.submit(RequestSpec(
        rid=f"t{i}", prompt=p, max_new=40)) for i, p in enumerate(prompts)]
    for _ in range(2):
        engine.step()
    out = decode_step_times(torch, engine, label, reps=reps, segs=segs)
    for h in reversed(handles):
        while not h.done():
            engine.step()
        engine.release_request(h.rid)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def decode_step_times(torch, engine, label, reps=6, segs=(1, 8),
                      light=False, restore=False):
    """Per decode step of the engine's active requests: the eager step
    (the plane's segment function, launched op by op) against its graph
    replay, at each seg of ``segs`` (a segment's times over its length).
    Wall: host clock from the dispatch through the token drain, median of
    ``reps`` (the eager step's 3 for a segment of 8); device busy: the
    union of the device spans under torch.profiler. ``light``, for a step
    of tens of thousands of device ops (Whisper's), the eager step run
    just before: one eager sample, no eager profile, one profiled replay.
    With ``restore`` the cache is put back afterwards, so a recurrent
    state the steps advanced is as it was."""
    plane = engine.decode_plane
    act = engine.active_requests()
    before = cache_copy(engine.cache) if restore else None
    out = {}
    for seg in segs:
        key = plane.load(act, seg)

        def eager():
            plane.segment(key[0], key[1], plane.route_state)[0].cpu()
        if not light or plane.graphs.get(key) is None:
            eager()
        if plane.graphs.get(key) is None:
            plane.graphs[key] = plane.capture(key)
        graph = plane.graphs[key]

        def replay():
            graph.replay()[0].cpu()
        for mode, fn in (("eager", eager), ("graph", replay)):
            heavy = light and mode == "eager"
            if not heavy:
                fn()
            walls = []
            # an eager segment of 8 steps takes 8 eager steps' time
            n = 1 if heavy else 3 if (mode, seg) == ("eager", 8) else reps
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls) * 1e3 / seg
            busy, ops = (None, 0) if heavy else device_busy_ms(
                torch, fn, 1 if seg > 1 or light else 2)
            out[(mode, seg)] = (wall, busy)
            print(f"  {label} decode step, {mode}, seg {seg} ({len(act)} "
                  f"rows): wall {wall:.3f} ms a step, device busy "
                  + (f"{busy / seg:.3f} ms a step ({ops / seg:.0f} device "
                     f"ops a step; busy {100 * busy / seg / wall:.1f}% of "
                     f"the wall)" if busy is not None else
                     "not measured" + ("" if heavy else " (the profiler "
                                       "saw no device event)"))
                  + f"; on {card_line()}")
    if restore:
        cache_put(engine.cache, before)
    return out


def segment_streams(torch, engine, prompts, max_new, want):
    """The serve phase's requests on an engine at ``decode_segment_len`` 8
    on the same weights: failure-free and with ``fail_ew(0)`` after the
    first segment, each stream bitwise equal to the seg-1 run's
    (``want``); then stochastic streams (temperature 0.8, top-k 40) of
    four requests at seg 8 and at seg 1, which must be equal. Every run
    after the warm-up captures nothing."""
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import InferenceEngine
    t0 = time.perf_counter()
    eight = InferenceEngine(engine.cfg, dataclasses.replace(
        engine.ecfg, decode_segment_len=8), params=engine.params,
        device="cuda")
    Run(torch, eight, prompts, 2, warm_up=True)
    run = Run(torch, eight, prompts, max_new)
    same_streams("seg-8 streams (against seg-1 ones)", run, want)
    run.report("serve at seg 8")

    def fail_ew(eng, handles, steps):
        if steps == 1:
            eng.fail_ew(0)
            return []
        return None
    failed = Run(torch, eight, prompts, max_new, fail=fail_ew)
    same_streams("seg-8 streams under fail_ew(0) (against seg-1 ones)",
                 failed, want)
    eight.provision_ew(0)
    samp = SamplingParams(greedy=False, temperature=0.8, top_k=40)
    sampled = [Run(torch, eng, prompts[:4], 16, sampling=samp).streams
               for eng in (engine, eight)]
    if sampled[0] != sampled[1]:
        raise AssertionError("stochastic streams at seg 8 differ from "
                             "seg 1's")
    print(f"  seg 8: {len(want.streams)} streams bitwise equal to seg 1's, "
          f"failure-free and under fail_ew(0) after the first segment "
          f"({failed.steps} dispatches); 4 stochastic streams equal to "
          f"seg 1's; step graphs {eight.decode_plane.captures()} "
          f"({sorted(eight.decode_plane.graphs)}), none captured after the "
          f"warm-up ({time.perf_counter() - t0:.1f} s)")
    return run


def serve_phase(torch, profile_dir=None):
    import numpy as np
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = mixtral_8_layers()
    ecfg = EngineConfig(max_batch=8, max_seq=512, num_aw=2, num_ew=2)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name} at {cfg.num_layers} layers bf16, "
          f"{cfg.param_count / 1e9:.2f}B params, seeded init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    max_new = 32

    # warm-up: the first pass at new shapes pays allocator growth and
    # library setup that a serving process pays once, and captures the
    # step graph
    t0 = time.perf_counter()
    Run(torch, engine, prompts, 2, warm_up=True)
    print(f"  warm-up pass: {time.perf_counter() - t0:.1f} s")
    reset_counts()
    steps0, calls0 = engine.steps, engine.scheduler.stats.calls
    part = {}
    run = Run(torch, engine, prompts, max_new,
              at_end=lambda eng: served_partials(torch, eng, part,
                                                 ((0, "mixtral"),)))
    # the run's own launches (the partial checks on its final caches come
    # after them)
    launches = {k: sum(ph[k] for ph in run.launches.values())
                for k in run.launches["decode"]}
    print(f"  main path launches: {launches} "
          f"({engine.scheduler.stats.calls - calls0} prefill calls, "
          f"{engine.steps - steps0} decode steps)")
    for k in ("decode_attention_fused", "flash_attention", "moe_ffn"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    if launches["decode_attention_paged"]:
        raise AssertionError("the contiguous engine launched the paged "
                             "kernel")
    for phase, path in (("prefill", "tensor_core"), ("decode", "skinny")):
        n = run.launches[phase]["moe_ffn"]
        if n <= 0 or run.launches[phase][f"moe_ffn/{path}"] != n:
            raise AssertionError(f"the expert FFN's {phase} launches did "
                                 f"not all take the {path} path: "
                                 f"{run.launches[phase]}")
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"bad stream {st}")
    run.report("serve")
    print(f"  stream r0: {run.streams[0][:12]}...")
    # what the per-step checkpoint adds: one batched gather of every row's
    # new KV and one device-to-host copy
    slots = list(range(8))
    toks = [150] * 8
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks))
    print(f"  per-step checkpoint gather + device-to-host copy (8 rows, "
          f"{cfg.num_layers} layers): {ck_ms:.3f} ms")

    print("failover: fail_ew(0) after 8 decode steps")
    steps0 = engine.steps
    t0 = time.perf_counter()

    def fail_ew(eng, handles, steps):
        if steps == 8:
            eng.fail_ew(0)
            return []
        return None
    failed = Run(torch, engine, prompts, max_new, fail=fail_ew).streams
    if failed != run.streams:
        bad = [i for i, (a, b) in enumerate(zip(failed, run.streams))
               if a != b]
        raise AssertionError(f"streams under fail_ew(0) differ from the "
                             f"failure-free run for requests {bad}")
    print(f"  {len(run.streams)} streams bitwise equal to the failure-free "
          f"run ({engine.steps - steps0} decode steps, EW0 failed: "
          f"{sorted(engine.failed_ews)}; {time.perf_counter() - t0:.1f} s)")
    engine.provision_ew(0)
    print("segments: the same requests at decode_segment_len 8")
    segment_streams(torch, engine, prompts, max_new, run)
    print("graph == eager: each step graph against the eager step from the "
          "same state, at seg 1 and seg 8")
    t0 = time.perf_counter()
    from repro_torch.serving.api import RequestSpec
    handles = [engine.client.submit(RequestSpec(
        rid=f"g{i}", prompt=p, max_new=max_new)) for i, p in
        enumerate(prompts)]
    for _ in range(3):
        engine.step()
    for what, change in (
            ("healthy", None),
            ("after fail_ew(0)", lambda: engine.fail_ew(0)),
            ("after provision_ew(0, repoint_protect=1), fail_ew(1)",
             lambda: (engine.provision_ew(0, repoint_protect=1),
                      engine.fail_ew(1)))):
        if change is not None:
            change()
        for seg in (1, 8):
            graph_equals_eager(torch, engine, seg, what)
    engine.provision_ew(1)
    for h in reversed(handles):
        while not h.done():
            engine.step()
        engine.release_request(h.rid)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    print("step times: Mixtral, eager against graph, seg 1 against seg 8")
    step_times(torch, engine, prompts, "mixtral")
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir)
    return engine, prompts, run, part


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of ``fn`` through a device sync (for work that
    ends on the host, such as a device-to-host copy)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def row_count_probe(torch, params):
    """Whether a token's bits depend on how many rows share its call, at
    every row count the runs' prefill and chunk calls gave the row-blocked
    projections and norms (``SEEN["rows"]``) and every capacity C they
    gave the expert FFN (``SEEN["ffn_prefill_c"]``): each result is
    compared bit for bit with the same rows of the largest call, the rows
    taken at two offsets (a token need not sit at the same row, or the
    same position in its row block, in both calls). Raises on any
    mismatch. Also times the blocked projections against one plain
    matmul: the repair's cost per call."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    g = torch.Generator(device="cuda").manual_seed(3)
    lp = params["layers"][0]
    weights = {n: lp["attn"][n] for n in ("wq", "wk", "wv", "wo")}
    weights["router"] = lp["moe"]["router"]
    rows = sorted(SEEN["rows"])
    if not rows or not SEEN["ffn_prefill_c"]:
        raise AssertionError("no prefill or chunk call shapes were seen")
    big = max(rows + [1024]) + 64
    d = weights["wq"].shape[0]
    bad = []

    def same(name, fn, x, ref, m):
        for off in (0, 37):
            if not torch.equal(fn(x[off:off + m]), ref[off:off + m]):
                bad.append((name, m, off))
    for name, w in weights.items():
        x = torch.randn((big, w.shape[0]), generator=g, device="cuda").to(
            w.dtype)

        def proj(v, w=w):
            return layers.matmul(v, w, True)
        ref = proj(x)
        for m in rows:
            same(f"x @ {name}", proj, x, ref, m)
    x = torch.randn((big, d), generator=g, device="cuda").to(
        weights["wq"].dtype)

    def ln(v):
        return layers.norm(lp["ln1"], v, 1e-6, True)
    ref = ln(x)
    for m in rows:
        same("rmsnorm", ln, x, ref, m)
    print(f"  row-count probe: projections (wq, wk, wv, wo, router) and "
          f"rmsnorm at M {rows}, each at 2 offsets, against the M={big} "
          f"call")
    # why the norm is row-blocked too: plain rmsnorm (one call) at these
    # row counts and at a one-token and a smallest-chunk call's
    from repro_torch.serving.chunked import CHUNK_MIN
    small = sorted({1, CHUNK_MIN} | set(rows))
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        want = layers.rmsnorm(lp["ln1"], xd, 1e-6)
        differ = [m for m in small if not all(
            torch.equal(layers.rmsnorm(lp["ln1"], xd[o:o + m], 1e-6),
                        want[o:o + m]) for o in (0, 37))]
        print(f"  row-count probe, plain rmsnorm (one call, {dt} input) at "
              f"M {small}: rows differ from the M={big} call's at M "
              f"{differ}")
    ex = lp["moe"]["experts"]
    se = torch.zeros((1,), dtype=torch.int32, device="cuda")
    cs = sorted(SEEN["ffn_prefill_c"])
    xs = torch.randn((1, max(cs) + 64, d), generator=g, device="cuda").to(
        weights["wq"].dtype)

    def ffn(v):
        cnt = torch.full((1,), v.shape[1], dtype=torch.int32, device="cuda")
        return ops.expert_ffn(v.contiguous(), ex["wg"], ex["wu"], ex["wd"],
                              se, cnt, decode=False)
    ref = ffn(xs)
    for c in cs:
        for off in (0, 37):
            if not torch.equal(ffn(xs[:, off:off + c]), ref[:, off:off + c]):
                bad.append(("expert FFN", c, off))
    print(f"  row-count probe: expert FFN prefill/chunk path at C {cs}, "
          f"each at 2 offsets, against the C={xs.shape[1]} call")
    if bad:
        raise AssertionError(f"rows whose bits depend on the call's row "
                             f"count: {bad}")
    print("  row-count probe: every row bitwise equal to the largest "
          "call's")
    for name in ("wq", "wk"):
        w = weights[name]
        for m in (64, 128, 1024):
            xm = torch.randn((m, d), generator=g, device="cuda").to(w.dtype)
            tb = time_ms(torch, lambda: layers.matmul(xm, w, True))
            tp = time_ms(torch, lambda: xm @ w)
            print(f"  repair cost, x @ {name} {tuple(w.shape)} at M={m}: "
                  f"row-blocked {tb:.4f} ms, one matmul {tp:.4f} ms")
    xm = torch.randn((1024, d), generator=g, device="cuda").to(
        weights["wq"].dtype)
    tb = time_ms(torch, lambda: layers.norm(lp["ln1"], xm, 1e-6, True))
    tp = time_ms(torch, lambda: layers.rmsnorm(lp["ln1"], xm, 1e-6))
    print(f"  repair cost, rmsnorm at M=1024: row-blocked {tb:.4f} ms, "
          f"one call {tp:.4f} ms")


def same_streams(what, got, want):
    """Raise unless two Runs' streams are equal, naming the requests that
    differ."""
    if got.streams != want.streams:
        bad = [i for i, (x, y) in enumerate(zip(got.streams, want.streams))
               if x != y]
        raise AssertionError(f"{what} differ for requests {bad}")


def aw_failover(torch, label, engine, prompts, max_new, want, fail_tokens,
                uncommitted=False, frames=None, after_step=None):
    """``fail_aw(0)`` once every request has ``fail_tokens`` tokens, then
    ``recover_aw_requests()`` (the other AW is full: nothing is restored
    there), ``provision_aw(0)``, and steps to the end. Every stream must
    equal ``want``'s bit for bit, and AW0's requests must all be restored
    at the step after provisioning. With ``uncommitted``, AW0's checkpoint
    writes of the dispatch before the failure are still pending when it
    comes (the crash lands inside that dispatch's commit), so its requests
    rewind past it. Returns the Run and (rid, prompt tokens, position) of
    each request AW0 held."""
    print(f"{label} AW failover: fail_aw(0) once every request has "
          f"{fail_tokens} tokens"
          + (", AW0's writes of the last dispatch not yet delivered"
             if uncommitted else ""))
    restores0 = engine.store.stats.restores
    bytes0 = engine.store.stats.bytes_restored
    recovered_now, held, hold, rewound = [], [], [], []

    def fail_aw(eng, handles, steps):
        if min(len(h.tokens()) for h in handles) < fail_tokens:
            return None
        if uncommitted and not hold:
            hold.append(patched(eng.aws[0].checkpointer,
                                flush=lambda: None,
                                reorder_window=1 << 30))
            hold[0].__enter__()
            return None
        victims = [r for r in eng.requests.values()
                   if r.aw == 0 and not r.done]
        held.extend((r.rid, len(r.prompt), r.pos) for r in victims)
        eng.fail_aw(0)
        if hold:
            hold[0].__exit__(None, None, None)
            rewound.extend(r.pos - 1 - eng.store.committed_token(r.rid)
                           for r in victims)
        recovered_now.extend(eng.recover_aw_requests())
        eng.provision_aw(0)
        return [r.rid for r in victims]
    install = engine.scheduler._install_recovery
    install_s = []

    def timed_install(q, aw, slot, now):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        install(q, aw, slot, now)
        torch.cuda.synchronize()
        install_s.append(time.perf_counter() - t0)
    with patched(engine.scheduler, _install_recovery=timed_install):
        fo = Run(torch, engine, prompts, max_new, fail=fail_aw,
                 frames=frames, after_step=after_step)
    if fo.t_fail is None:
        raise AssertionError(f"{label}: the AW failure was never injected")
    same_streams(f"{label} streams under fail_aw(0)", fo, want)
    restored = engine.store.stats.restores - restores0
    if restored != len(fo.victims) or recovered_now or not fo.victims:
        raise AssertionError(f"{label}: expected the {len(fo.victims)} "
                             f"requests of AW0 restored at the step after "
                             f"provision_aw(0); {restored} restored, "
                             f"{recovered_now} at recover_aw_requests")
    if uncommitted and not (rewound and min(rewound) > 0):
        raise AssertionError(f"{label}: AW0's requests did not lose their "
                             f"last dispatch's writes: {rewound}")
    if rewound:
        print(f"  AW0's requests rewound {rewound} positions past their "
              f"committed watermarks")
    print(f"  {len(fo.streams)} streams bitwise equal to the failure-free "
          f"run; restored the {restored} requests of AW0 (rid, prompt "
          f"tokens, position at the failure: {held}) at the step after "
          f"provision_aw(0), none by recover_aw_requests (AW1 full), "
          f"{engine.store.stats.bytes_restored - bytes0} bytes (installs "
          f"{', '.join(f'{t * 1e3:.1f}' for t in install_s)} ms); fail_aw "
          f"to the restored requests' next token {fo.recovery_s * 1e3:.2f} "
          f"ms (host clock); largest gap between tokens "
          f"{max(fo.tbt) * 1e3:.2f} ms; on {card_line()}")
    fo.report(f"{label} AW failover")
    fo.install_s = install_s
    return fo, held


def kv_plane_phase(torch, label, cfg, prompts, *, params=None, max_batch=8,
                   max_seq=512, num_ew=2, max_new=32, fail_tokens=8):
    """Whole-prompt contiguous, chunked contiguous and chunked paged
    engines (CHUNK_BUDGET chunk tokens a step, PAGE_TOKENS-token pages) on
    one set of weights (``params``, else the whole-prompt engine's seeded
    init): paged streams must equal contiguous ones, and chunked streams
    whole-prompt ones, bit for bit; the paged run must launch the paged
    decode kernel and never the fused one. Then the AW failover on the
    paged engine (``aw_failover``). Returns the failure-free Runs and the
    engines, by engine."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    base = dict(max_batch=max_batch, max_seq=max_seq, num_aw=2,
                num_ew=num_ew)
    t0 = time.perf_counter()
    whole = InferenceEngine(cfg, EngineConfig(**base), params=params,
                            seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name}, {cfg.num_layers} layers bf16, "
          f"{cfg.param_count / 1e9:.2f}B params, "
          + ("shared weights" if params is not None else
             f"seeded init {time.perf_counter() - t0:.1f} s")
          + f", {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    engines = {
        "whole": whole,
        "contiguous": InferenceEngine(
            cfg, EngineConfig(**base, chunk_token_budget=CHUNK_BUDGET),
            params=whole.params, device="cuda"),
        "paged": InferenceEngine(
            cfg, EngineConfig(**base, chunk_token_budget=CHUNK_BUDGET,
                              kv_page_tokens=PAGE_TOKENS),
            params=whole.params, device="cuda"),
    }
    runs = {}
    for name, eng in engines.items():
        Run(torch, eng, prompts, 2, warm_up=True)
        reset_counts()
        runs[name] = Run(torch, eng, prompts, max_new)
        runs[name].report(f"{label} {name}")
    same_streams(f"{label} paged streams (against contiguous ones)",
                 runs["paged"], runs["contiguous"])
    print(f"  paged (page {PAGE_TOKENS} tokens) streams bitwise equal to "
          f"contiguous ones, both chunked at {CHUNK_BUDGET} tokens/step")
    same_streams(f"{label} chunked streams (against whole-prompt ones)",
                 runs["contiguous"], runs["whole"])
    print("  chunked streams bitwise equal to whole-prompt streams")
    lp = {k: sum(ph[k] for ph in runs["paged"].launches.values())
          for k in runs["paged"].launches["decode"]}
    if lp["decode_attention_paged"] <= 0 or lp["decode_attention_fused"] \
            or lp["flash_attention"] <= 0:
        raise AssertionError(f"{label}: the paged engine's decode steps did "
                             f"not all launch the paged kernel, or flash "
                             f"was not launched: {lp}")
    print(f"  paged path launches: {lp}; attention (kernel, Dh, G, window, "
          f"softcap): {dict(runs['paged'].attn)}")
    paged = engines["paged"]
    print(f"  chunk calls: paged {paged.chunked.stats.calls}, shapes "
          f"{sorted(paged.chunked.stats.shapes)}")
    paged.pages.check()
    print(f"  PagePool.check() passed: {paged.pages.stats()}")
    aw_failover(torch, label, paged, prompts, max_new, runs["paged"],
                fail_tokens)
    paged.pages.check()
    return runs, engines


def mixtral_kv_plane(torch, engine, prompts):
    """The KV plane on the serve phase's weights at capacity factor 4.0
    (capacity >= tokens in every call: no token is ever dropped, so a
    stream does not depend on its slot or on how its prompt is chunked):
    in every engine each expert FFN launch of a decode step on the decode
    path ("skinny", C 8) and each of a prefill or chunk call on the
    tensor-core path; then the row-count probe. Returns the failure-free
    Runs."""
    runs, engines = kv_plane_phase(torch, "kv plane",
                                   mixtral_8_layers(capacity_factor=4.0),
                                   prompts, params=engine.params)
    for name, run in runs.items():
        for phase, n in run.launches.items():
            path = "skinny" if phase == "decode" else "tensor_core"
            if n["moe_ffn"] and n[f"moe_ffn/{path}"] != n["moe_ffn"]:
                raise AssertionError(f"the {name} engine's {phase} expert "
                                     f"FFN launches did not all take the "
                                     f"{path} path: {n}")
    if runs["paged"].launches["decode"]["moe_ffn"] <= 0:
        raise AssertionError("the paged decode steps launched no expert FFN")
    from repro_torch.serving.engine import InferenceEngine
    paged4 = InferenceEngine(
        mixtral_8_layers(capacity_factor=4.0), dataclasses.replace(
            engines["paged"].ecfg, decode_segment_len=4),
        params=engine.params, device="cuda")
    Run(torch, paged4, prompts, 2, warm_up=True)
    aw_failover(torch, "kv plane paged, seg 4", paged4, prompts, 32,
                runs["contiguous"], 10, uncommitted=True)
    paged4.pages.check()
    print(f"  paged at seg 4 under fail_aw(0): streams bitwise equal to the "
          f"contiguous engine's; step graphs "
          f"{sorted(paged4.decode_plane.graphs)}")
    row_count_probe(torch, engine.params)
    return runs


# the orchestrated serving phase's workload: the port's
# make_workload("sharegpt") at 8 requests/s over 2 s (log-normal prompts
# up to 384 tokens, median near 150; up to 32 new tokens), and its two EW
# failures: EW0 at 0.2 s (provisioned T_w = 1.0 s after its detection,
# its shadows then re-pointed to protect EW1) and EW1 at 2.1 s (served from
# those shadows). A failure lands at the first step that starts at or after
# its time, and the clock runs on the host's step times: the 0.9 s beyond
# T_w are room for the step in progress at 0.2 s and the detection together
# (at 0.5 s and 1.8 s, a host whose step spanning 0.5 s took 250 ms and
# whose detection 78 ms provisioned EW0 in the tick that failed EW1; with
# 16 CPU-bound processes beside the smoke on 8 host cores, a detection took
# 527 ms)
ORCH_WORKLOAD = dict(kind="sharegpt", rate_rps=8.0, duration=2.0, seed=0,
                     max_prompt=384, max_new=32)
ORCH_EW_FAILURES = ((0.2, "ew", 0), (2.1, "ew", 1))
ORCH_PROTECT_EW1 = [0, 1, 2, 3, 4, 5, 6, 7, 4, -1, 5, -1, 6, -1, 7, -1]


class ServeRun:
    """One ``run_serving`` pass (``step_time=None``: the virtual clock
    advances by each step's measured wall time on the card) on a fresh
    engine over ``params``, with an Orchestrator as the launcher builds it
    (``worker_init_time=1.0``). Keeps the ServeMetrics, the orchestrator's
    events, the launches per phase ("prefill": the scheduler's prefill
    groups; "decode": the rest of each step), what the run gave the
    kernels (``observed``), each prefill group's virtual time and
    (rid, AW, prompt tokens), and what the failures touched. Inside a
    step's timed interval the only additions are the launch-count reads
    around each prefill group, the record of the group, the record (and
    host time) of each restored request and of each preemption's commit,
    and the kernel observers of every phase; the rest is read from the
    ServeMetrics after the run. ``orch_kw`` adds (or overrides)
    Orchestrator options and ``scales`` the run's ScalePlans; each plan
    install records the manager's per-EW load EMAs at that moment.
    ``clock`` (``step_time``, ``prefill_token_time``) puts the run on a
    fixed virtual clock instead. ``setup(engine)`` runs on the new engine
    first. The engine's telemetry plane (on unless ``telemetry=False``)
    stays readable as ``m.telemetry``."""

    def __init__(self, torch, cfg, params, wl, failures=(), *, orch_kw=None,
                 scales=(), setup=None, clock=None, **ecfg_kw):
        from repro_torch.core.orchestrator import Orchestrator
        from repro_torch.serving.engine import EngineConfig, InferenceEngine
        from repro_torch.serving.scheduler import (FailurePlan, ScalePlan,
                                                   run_serving)
        eng = InferenceEngine(cfg, EngineConfig(**{
            "max_batch": 8, "max_seq": 512, "num_aw": 2, "num_ew": 2,
            **ecfg_kw}), params=params, device="cuda")
        if setup is not None:
            setup(eng)
        orch = Orchestrator(eng, **{"worker_init_time": 1.0,
                                    **(orch_kw or {})})
        sched = eng.scheduler
        prefill_group, install = sched._prefill_group, sched._install_recovery
        fail_aw, fail_ew = eng.fail_aw, eng.fail_ew
        commit, install_plan = eng._commit_resident_kv, eng.install_plan
        bulk_group = eng._bulk_checkpoint_group
        pre = {k: 0 for k in launch_counts()}
        self.groups = []
        self.victims, self.restored, self.slot_expert_at_fail = [], [], {}
        self.commit_s, self.resume_s, self.plans = {}, {}, []
        # per victim, per commit: (resident tokens, tokens the bulk range
        # path moved); per resume: bytes restored
        self.commit_tokens, self.resume_bytes, bulk = {}, {}, []

        def counted_prefill(group, now):
            c0 = launch_counts()
            SEEN["phase"] = "prefill"
            prefill_group(group, now)
            SEEN["phase"] = "decode"
            for k, v in delta(c0, launch_counts()).items():
                pre[k] += v
            self.groups.append((now, [(q.rid, aw, len(q.prompt))
                                      for q, aw, _ in group[1]]))

        def installed(q, aw, slot, now):
            self.restored.append(q.rid)
            b0 = eng.store.stats.bytes_restored
            t0 = time.perf_counter()
            install(q, aw, slot, now)
            if q.rid in self.commit_s:      # a preemption victim resumes
                self.resume_s.setdefault(q.rid, []).append(
                    time.perf_counter() - t0)
                self.resume_bytes.setdefault(q.rid, []).append(
                    eng.store.stats.bytes_restored - b0)

        def bulk_counted(items):
            if bulk:                        # inside a preemption's commit
                bulk[0] += sum(n for _, _, n in items)
            bulk_group(items)

        def committed(r):
            resident = r.prefill_cursor if r.prefilling else r.pos
            bulk[:] = [0]
            t0 = time.perf_counter()
            out = commit(r)
            self.commit_s.setdefault(r.rid, []).append(
                time.perf_counter() - t0)
            self.commit_tokens.setdefault(r.rid, []).append(
                (resident, bulk.pop()))
            return out

        def plan_installed(plan, now=0.0, detail=""):
            mgr = eng.placement_mgr
            self.plans.append((round(now, 4), plan.generation, plan.reason,
                               {m: round(v, 3) for m, v in
                                mgr.per_ew_load().items()},
                               int((plan.split_slot >= 0).sum())))
            install_plan(plan, now=now, detail=detail)

        # the orchestrator's tick calls these, outside the timed step
        def failed_aw(aw):
            self.victims += [(r.rid, len(r.tokens))
                             for r in eng.requests.values()
                             if r.aw == aw and not r.done]
            fail_aw(aw)

        def failed_ew(ew):
            self.slot_expert_at_fail[ew] = \
                eng.route_state.slot_expert.tolist()
            fail_ew(ew)
        # the step graph is captured before the clock starts, as a serving
        # process does at start-up
        warm_step_graph(eng)
        captures = eng.decode_plane.captures()
        with patched(sched, _prefill_group=counted_prefill,
                     _install_recovery=installed), \
                patched(eng, fail_aw=failed_aw, fail_ew=failed_ew,
                        _commit_resident_kv=committed,
                        _bulk_checkpoint_group=bulk_counted,
                        install_plan=plan_installed), \
                observed(torch, "decode") as obs:
            t0 = time.perf_counter()
            self.m = run_serving(eng, wl, 600.0, orchestrator=orch,
                                 failures=[FailurePlan(*f)
                                           for f in failures],
                                 scale_events=[ScalePlan(*sc)
                                               for sc in scales],
                                 **(clock or {}))
            self.wall_s = time.perf_counter() - t0
        if eng.decode_plane.captures() != captures:
            raise AssertionError("run_serving captured a step graph after "
                                 "the engine's warm-up")
        self.ffn_c, self.attn, self.flash = obs.ffn_c, obs.attn, obs.flash
        self.launches = {"prefill": pre,
                         "decode": {k: v - pre[k]
                                    for k, v in obs.ran.items()}}
        self.events = [(e.t, e.kind, e.worker, e.detail)
                       for e in orch.events]
        self.n = len(wl)
        self.bytes_restored = eng.store.stats.bytes_restored
        self.placement = eng.api.placement
        self.generation = eng.placement_generation
        self.ema_end = {} if eng.placement_mgr is None else {
            m: round(v, 3) for m, v in
            eng.placement_mgr.per_ew_load().items()}
        self.live_ews = sorted(eng.live_ews)
        self.host_syncs = eng.gateway.stats.host_syncs
        self.steps = eng.steps

    def step_ends(self):
        """The virtual end time of every step that emitted tokens."""
        return sorted({rec.t for rec in self.m.token_log})

    def spans(self):
        """rid -> (time of its first token, time of its last)."""
        first, last = {}, {}
        for rec in self.m.token_log:
            first.setdefault(rec.rid, rec.t)
            last[rec.rid] = rec.t
        return {r: (first[r], last[r]) for r in first}

    def worst_gap(self, rids=None):
        """The largest token gap of ``rids`` (None: of every request):
        (gap, rid, its start, its end)."""
        by = {}
        for rec in self.m.token_log:
            if rids is None or rec.rid in rids:
                by.setdefault(rec.rid, []).append(rec.t)
        return max(((b - a, rid, a, b) for rid, ts in by.items()
                    for a, b in zip(ts, ts[1:])), default=(0.0, "", 0, 0))

    def in_gap(self, a, b):
        """What ran inside the gap (a, b]: the steps that emitted tokens,
        the prefill groups (virtual time, prompt tokens) and the
        orchestrator's events."""
        steps = [t for t in self.step_ends() if a < t <= b]
        groups = [(round(t, 4), [n for _, _, n in g])
                  for t, g in self.groups if a <= t < b]
        events = [(round(t, 4), kind, w) for t, kind, w, _ in self.events
                  if a <= t < b]
        return steps, groups, events

    def check_paths(self, label):
        """The run launched decode attention and both FFN paths (decode
        steps on the decode path, prefill groups on the tensor-core path)
        and flash."""
        pre, dec = self.launches["prefill"], self.launches["decode"]
        if dec["decode_attention_fused"] <= 0 or pre["flash_attention"] <= 0 \
                or dec["decode_attention_paged"]:
            raise AssertionError(f"{label}: decode attention or flash was "
                                 f"not launched: {self.launches}")
        for ph, n, path in (("prefill", pre, "tensor_core"),
                            ("decode", dec, "skinny")):
            if n["moe_ffn"] <= 0 or n[f"moe_ffn/{path}"] != n["moe_ffn"]:
                raise AssertionError(f"{label}: the expert FFN's {ph} "
                                     f"launches did not all take the {path} "
                                     f"path: {n}")

    def touched_at(self, t):
        """Requests with a token at or before ``t`` and one after it."""
        return {r for r, (a, b) in self.spans().items() if a <= t < b}

    def report(self, label, touched=()):
        from repro_torch.serving.telemetry import pct
        m = self.m
        ttft, tbt, qd = m.ttft_values(), m.tbt_values(), \
            m.queue_delay_values()
        print(f"  {label}: {len(m.finished)}/{self.n} requests finished, "
              f"{len(m.token_log)} tokens in {m.duration:.4f} s of virtual "
              f"time ({self.wall_s:.2f} s wall); TTFT p50 "
              f"{pct(ttft, 50) * 1e3:.2f} ms p99 {pct(ttft, 99) * 1e3:.2f} "
              f"ms; TBT p50 {pct(tbt, 50) * 1e3:.2f} ms p99 "
              f"{pct(tbt, 99) * 1e3:.2f} ms; max stall "
              f"{m.max_stall() * 1e3:.2f} ms; throughput "
              f"{m.throughput():.1f} tok/s; queue delay p50 "
              f"{pct(qd, 50) * 1e3:.2f} ms p99 {pct(qd, 99) * 1e3:.2f} ms; "
              f"prefill {m.prefill}; bytes restored {self.bytes_restored}"
              + (f"; largest token gap of the {len(touched)} requests the "
                 f"failure touched "
                 f"{self.worst_gap(set(touched))[0] * 1e3:.2f} ms"
                 if touched else "") + f"; on {card_line()}")
        gap, rid, a, b = self.worst_gap()
        steps, groups, events = self.in_gap(a, b)
        print(f"    max stall: {rid} from {a:.4f} to {b:.4f} s, "
              f"{len(steps)} step(s) ending in it; prefill groups in it "
              f"(virtual time, prompt tokens) {groups}; orchestrator "
              f"events in it {events}")
        for t, kind, worker, detail in self.events:
            print(f"    [orch t={t:.4f}] {kind} {worker} {detail}")
        for phase, counts in self.launches.items():
            print(f"    {phase}: { {k: v for k, v in counts.items() if v} }"
                  + (f", expert FFN (P, C, D, F, path): "
                     f"{dict(sorted(self.ffn_c[phase].items()))}"
                     if phase in self.ffn_c else ""))


def warm_step_graph(engine):
    """Capture the engine's step graph with every row idle (pos -1: no KV
    write, no expert capacity claimed), after one eager step of the same
    key has done the lazy set-up a capture must not do."""
    plane = engine.decode_plane
    key = plane.load([], plane.seg_len)
    plane.segment(key[0], key[1], plane.route_state)
    plane.graphs[key] = plane.capture(key)


def aw_failure_time(run):
    """The middle of the longest stretch of ``run``'s steps after which
    AW0 held at least two decoding requests (a first token and more to
    come; ``run`` has no failure, so a request stays on the AW of its
    prefill group): the step's end time, when the next step starts."""
    aw0 = {rid for _, group in run.groups for rid, aw, _ in group
           if aw == 0}
    spans = [s for r, s in run.spans().items() if r in aw0]
    best, cur = [], []
    for t in run.step_ends():
        n = sum(1 for a, b in spans if a <= t < b)
        cur = cur + [t] if n >= 2 else []
        if len(cur) > len(best):
            best = cur
    if not best:
        raise AssertionError("AW0 never held two decoding requests in the "
                             "failure-free run")
    return best[len(best) // 2]


def orchestrated_phase(torch, g, records, params):
    """Mixtral-8x7B widths at 8 layers in bf16 at capacity factor 4.0 (no
    token dropped, so slots and batch makeup cannot change a stream) on
    ``params``, served by ``run_serving`` with an Orchestrator over
    ORCH_WORKLOAD: (a) failure-free (after a warm-up pass, whose streams
    must equal it too); (b) EW0 at 0.2 s and EW1 at 2.1 s, the second
    served from the shadows re-pointed to protect EW1 when EW0 was
    provisioned; (c) AW0 at a time run (a) says AW0 holds two decoding
    requests, at least one request with tokens restored; (d) the
    MegaScale-style baseline (``tarragon=False, checkpoint=False``) under
    EW0's failure. Every request of (a)-(c) finishes, the streams of (b)
    and (c) equal (a)'s bit for bit, (d) finishes and prints how many of
    its streams differ. Each run launches decode attention, both FFN
    paths and flash. Then the failover demo twin at the same widths (its
    EW and AW sections equal its reference section), and the expert FFN
    at every prefill C these runs gave it against the plain versions (the
    largest C of run (a) timed). Returns run (a)."""
    from repro_torch.data.workloads import make_workload
    from repro_torch.examples import failover_demo
    cfg = mixtral_8_layers(capacity_factor=4.0)
    wl = make_workload(**ORCH_WORKLOAD)
    print(f"  workload: {len(wl)} requests, prompts "
          f"{sorted(r.prompt_len for r in wl)} tokens, "
          f"{sum(r.max_new_tokens for r in wl)} new tokens in all, "
          f"arrivals {wl[0].arrival:.3f}-{wl[-1].arrival:.3f} s")
    warm = ServeRun(torch, cfg, params, wl)
    base = ServeRun(torch, cfg, params, wl)
    base.report("(a) failure-free")

    def same_outputs(label, run):
        if len(run.m.finished) != run.n:
            raise AssertionError(f"{label}: {len(run.m.finished)} of "
                                 f"{run.n} requests finished")
        bad = sorted(r for r in base.m.outputs
                     if run.m.outputs.get(r) != base.m.outputs[r])
        if bad:
            raise AssertionError(f"{label}: streams differ from the "
                                 f"failure-free run for {bad}")
        print(f"  {label}: {run.n} streams bitwise equal to the "
              f"failure-free run's")
    for label, run in (("warm-up", warm), ("(a) failure-free", base)):
        run.check_paths(label)
    same_outputs("(a) against the warm-up pass", warm)

    # (b) and (c) attribute every token gap above 50 ms (the default 0.25 s
    # leaves a seamless EW failover nothing to attribute)
    ew = ServeRun(torch, cfg, params, wl, ORCH_EW_FAILURES,
                  stall_threshold=0.05)
    ew.report(f"(b) EW0 at {ORCH_EW_FAILURES[0][0]} s, EW1 at "
              f"{ORCH_EW_FAILURES[1][0]} s",
              ew.touched_at(ORCH_EW_FAILURES[0][0]) |
              ew.touched_at(ORCH_EW_FAILURES[1][0]))
    ew.check_paths("(b)")
    same_outputs("(b) two EW failures", ew)
    prov = [e for e in ew.events if e[1:3] == ("provisioned", "ew0")]
    if not prov or prov[0][0] >= ORCH_EW_FAILURES[1][0] or \
            prov[0][3] != "shadows protect ew1":
        raise AssertionError(f"(b): EW0 was not provisioned with its "
                             f"shadows re-pointed to EW1 before EW1 "
                             f"failed: {ew.events}")
    # the table that protects EW1: primaries 0..7 (EW0 owns slots 0-3 and
    # the even shadow slots, EW1 slots 4-7 and the odd ones), EW1's experts
    # 4-7 on EW0's shadow slots, EW1's own shadow slots empty
    want = ORCH_PROTECT_EW1
    if ew.slot_expert_at_fail.get(1) != want:
        raise AssertionError(f"(b): slot_expert when EW1 failed "
                             f"{ew.slot_expert_at_fail.get(1)}, not the "
                             f"table that protects EW1 {want}")
    # steps that emitted tokens from EW1's detection (its ERT remap) to
    # its provisioning
    down = [t for t, kind, w, _ in ew.events
            if w == "ew1" and kind in ("detected", "provisioned")]
    served = sum(1 for t in ew.step_ends() if down and down[0] < t and
                 (len(down) < 2 or t <= down[1]))
    if not served:
        raise AssertionError("(b): no step emitted tokens while EW1 was "
                             "failed")
    print(f"  (b): EW1's experts served from the re-pointed shadow slots "
          f"(slot_expert {want}) for {served} steps; EW0 provisioned at "
          f"{prov[0][0]:.4f} s, {ORCH_EW_FAILURES[1][0] - prov[0][0]:.4f} s "
          f"before EW1's failure (the timed plan leaves 0.9 s beyond T_w)")

    t_aw = aw_failure_time(base)
    aw = ServeRun(torch, cfg, params, wl, ((t_aw, "aw", 0),),
                  stall_threshold=0.05)
    aw.report(f"(c) AW0 at {t_aw:.4f} s", [r for r, _ in aw.victims])
    aw.check_paths("(c)")
    same_outputs("(c) AW failure", aw)
    with_tokens = {r for r, n in aw.victims if n >= 1}
    if not with_tokens & set(aw.restored):
        raise AssertionError(f"(c): no request with tokens restored "
                             f"(victims {aw.victims}, restored "
                             f"{aw.restored})")
    print(f"  (c): AW0 held {aw.victims} (rid, tokens) at the failure; "
          f"restored {aw.restored}")
    # the telemetry plane (on by default): every attributed stall's
    # components sum to its gap, and run (c)'s Chrome trace parses back
    # with one root span per request
    for label, run in (("(b)", ew), ("(c)", aw)):
        rep = run.m.telemetry.stall_report()
        bad = [st for st in rep
               if abs(sum(st["components"].values()) - st["gap"]) > 1e-9]
        if bad:
            raise AssertionError(f"{label}: stall components do not sum to "
                                 f"the gap: {bad}")
        causes = Counter(c for st in rep for c, v in st["components"].items()
                         if v > 1e-12)
        print(f"  {label}: {len(rep)} stall records (gap > "
              f"{run.m.telemetry.stall_threshold} s), components summing to "
              f"each gap within 1e-9 s; records by cause {dict(causes)}")
    out = Path(__file__).resolve().parent / "build" / "orchestrated_c.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    aw.m.telemetry.export_chrome(str(out))
    trace = json.loads(out.read_text())
    roots = Counter(e["name"] for e in trace["traceEvents"]
                    if e["ph"] == "X" and e.get("cat") == "request")
    if roots != Counter({r.request_id: 1 for r in wl}):
        raise AssertionError(f"(c): the Chrome trace's root spans {roots} "
                             f"are not one per request")
    print(f"  (c): Chrome trace {out.name} ({out.stat().st_size} bytes, "
          f"{len(trace['traceEvents'])} events) parses back with one root "
          f"span for each of the {len(roots)} requests")

    mega = ServeRun(torch, cfg, params, wl, ORCH_EW_FAILURES[:1],
                    tarragon=False, checkpoint=False)
    mega.report(f"(d) baseline (tarragon=False, checkpoint=False), EW0 at "
                f"{ORCH_EW_FAILURES[0][0]} s",
                mega.touched_at(ORCH_EW_FAILURES[0][0]))
    mega.check_paths("(d)")
    if len(mega.m.finished) != mega.n:
        raise AssertionError(f"(d): {len(mega.m.finished)} of {mega.n} "
                             f"requests finished")
    differ = sum(1 for r in base.m.outputs
                 if mega.m.outputs.get(r) != base.m.outputs[r])
    print(f"  (d): {differ} of {mega.n} streams differ from the failure-free "
          f"Tarragon run's (no shadow slots: EW0's experts unreachable "
          f"until it is provisioned)")

    print("  failover demo twin at the same widths (max_seq 512)")
    with observed(torch, "decode") as demo_obs:
        demo = failover_demo.main(cfg, "cuda", params, max_seq=512,
                                  log=lambda *a: None)
    for sec in ("ew", "aw"):
        if demo[sec] != demo["reference"]:
            raise AssertionError(f"demo twin: the {sec} section's streams "
                                 f"differ from the reference section's")
    print(f"  demo twin: EW and AW sections equal the reference section "
          f"({ {k: v[:4] for k, v in sorted(demo['reference'].items())} }"
          f"...); AW section events {demo['events']}; session placements "
          f"{demo['session']}")

    # the expert FFN at every (P, C, D, F, path) this phase's runs gave it
    # that the kernel phase did not check (a prefill group's C follows
    # from its prompts), held to the plain versions; the largest prefill
    # call of run (a) timed. Earlier phases' shapes stay with main()'s
    # MOE_SHAPES gate
    base_key = max(base.ffn_c["prefill"], key=lambda k: k[1])
    seen = {key for obs in (warm, base, ew, aw, mega, demo_obs)
            for per_phase in obs.ffn_c.values() for key in per_phase}
    todo = (seen - FFN_CHECKED) | {base_key}
    shapes = [("orchestrated" if key == base_key else
               f"orchestrated-C{key[1]}-{key[4]}", key)
              for key in sorted(todo)]
    print(f"  expert FFN at the {len(shapes)} (P, C, D, F, path) of these "
          f"runs the kernel phase did not hold to the plain versions (and "
          f"run (a)'s largest prefill call): {sorted(todo)}")
    kernel_moe_gemm(torch, g, records, shapes, timed={"orchestrated"},
                    small=False)
    records[-1]["launches"] = base.ffn_c["prefill"][base_key]
    return base


# the elastic and preemption phase: a Zipf-skewed decode-heavy workload
# (runs e, f) and the SLO-class mix (g), on the orchestrated phase's
# weights; EW2 joins (T_w + T_push = 1.25 s after the request, made at the
# first step that starts at or after 0.2 s) before the drain is requested
# at 2.2 s, with 0.75 s to spare for a long step in progress at 0.2 s (a
# drain of an EW that has not joined is refused). mixed_slo's prompt lengths are the workload's own
# (interactive 4-9 tokens, batch 6-13): max_prompt does not bound them
ELASTIC_WORKLOAD = dict(kind="skewed_expert_load", rate_rps=8.0,
                        duration=2.5, seed=0, max_prompt=16, max_new=32)
ELASTIC_SCALES = ((0.2, "add_ew"), (2.2, "drain_ew", 2))
ELASTIC_EW_FAILURE = ((0.5, "ew", 0),)
SLO_WORKLOAD = dict(kind="mixed_slo", rate_rps=8.0, duration=1.0, seed=0,
                    max_prompt=16, max_new=96)
SLO_TOKEN_CAP = 64


def plan_graphs_equal_eager(torch, cfg, params):
    """On one engine (max_ew 3) with requests decoding: a replay of the
    seg-1 step graph equals the eager step after a scale-out, a rebalance
    with split replicas and a shadow promotion, with no new capture."""
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    eng = InferenceEngine(cfg, EngineConfig(
        max_batch=8, max_seq=512, num_aw=2, num_ew=2, max_ew=3),
        params=params, device="cuda")
    g = torch.Generator().manual_seed(5)
    for i in range(8):
        eng.client.submit(RequestSpec(rid=f"p{i}", max_new=16, prompt=(
            torch.randint(0, cfg.vocab_size, (24,), generator=g)
            .numpy().astype("int32"))))
    for _ in range(3):
        eng.step()
    base = eng.decode_plane.captures()
    mgr = eng.placement_mgr
    eng.add_ew(now=1.0)
    graph_equals_eager(torch, eng, 1, "plan: scale-out to EW2")
    eng.step()
    plan = eng.rebalance(now=2.0)
    if (plan.split_slot < 0).all():
        # the recorded loads gave no split: replicate expert 0 into an
        # empty slot of another EW and split its traffic there
        owner, se = plan.slot_owner, plan.slot_expert.copy()
        s = int(((se < 0) & (owner >= 0) &
                 (owner != owner[plan.primary[0]])).nonzero()[0][0])
        se[s] = 0
        split = plan.split_slot.copy()
        split[0] = s
        eng.install_plan(mgr.adopt(se, split_slot=split, reason="split"),
                         now=2.0)
    graph_equals_eager(torch, eng, 1, f"plan: rebalance with "
                       f"{int((eng.route_state.split_slot >= 0).sum())} "
                       f"split replicas")
    eng.step()
    eng.fail_ew(0)
    eng.promote_shadows(0, now=3.0)
    graph_equals_eager(torch, eng, 1, "plan: EW0's shadows promoted")
    if eng.decode_plane.captures() != base:
        raise AssertionError("a plan install captured a step graph")
    print(f"  plans: generation {eng.placement_generation}, pool "
          f"{sorted(eng.live_ews)}, step graphs {base} (none new)")


def elastic_phase(torch, g, records, params):
    """The placement plane and the request plane on the orchestrated
    phase's weights (Mixtral-8x7B widths at 8 layers, bf16, capacity
    factor 4.0, num_ew 2, max_ew 3), each run through ``run_serving`` with
    an Orchestrator (T_w 1.0 s, T_push 0.25 s) on the card's step times:
    the failure-free run of ELASTIC_WORKLOAD; (e) the same with
    ``auto_rebalance`` and ELASTIC_SCALES (EW2 joins, then drains); (f)
    ``ew_policy="promote"`` under EW0's failure; then SLO_WORKLOAD without
    preemption, (g) with it and a token cap, and (g) bulk as (g) without
    per-token checkpointing, so each commit moves the victim's whole
    resident state through the bulk range path. Every stream of (e) and
    (f) equals the failure-free run's bit for bit; every request of both
    (g) runs finishes, at least one is preempted, and each victim's
    stream equals its stream without preemption. No run captures a step graph after its
    warm-up, and the host syncs are one a decode step. Before the runs,
    graph == eager after each kind of plan install."""
    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.telemetry import pct
    t_phase = time.perf_counter()
    cfg = mixtral_8_layers(capacity_factor=4.0)
    plan_graphs_equal_eager(torch, cfg, params)
    push = dict(weight_push_time=0.25)
    wl = make_workload(**ELASTIC_WORKLOAD)
    print(f"  skewed workload: {len(wl)} requests, prompts "
          f"{sorted(r.prompt_len for r in wl)} tokens, "
          f"{sum(r.max_new_tokens for r in wl)} new tokens in all")
    base = ServeRun(torch, cfg, params, wl, orch_kw=push, max_ew=3)
    runs = {"failure-free": base}
    runs["(e)"] = ServeRun(torch, cfg, params, wl, orch_kw=dict(
        push, auto_rebalance=True), scales=ELASTIC_SCALES, max_ew=3)
    runs["(f)"] = ServeRun(torch, cfg, params, wl, ELASTIC_EW_FAILURE,
                           orch_kw=dict(push, ew_policy="promote"),
                           max_ew=3)
    slo = make_workload(**SLO_WORKLOAD)
    print(f"  mixed_slo workload: {len(slo)} requests "
          f"({sum(r.slo_class == 'batch' for r in slo)} batch, "
          f"{sum(r.slo_class == 'interactive' for r in slo)} interactive "
          f"at {sorted(round(r.arrival, 3) for r in slo if r.slo_class == 'interactive')} s)")
    runs["no preemption"] = ServeRun(torch, cfg, params, slo, orch_kw=push,
                                     max_ew=3, preempt=False,
                                     prefill_token_cap=SLO_TOKEN_CAP)
    runs["(g)"] = ServeRun(torch, cfg, params, slo, orch_kw=push, max_ew=3,
                           prefill_token_cap=SLO_TOKEN_CAP)
    runs["(g) bulk"] = ServeRun(torch, cfg, params, slo, orch_kw=push,
                                max_ew=3, prefill_token_cap=SLO_TOKEN_CAP,
                                checkpoint=False)
    for label, run in runs.items():
        run.report(label)
        run.check_paths(label)
        if len(run.m.finished) != run.n:
            raise AssertionError(f"{label}: {len(run.m.finished)} of "
                                 f"{run.n} requests finished")
        if run.host_syncs != run.steps:
            raise AssertionError(f"{label}: {run.host_syncs} host syncs in "
                                 f"{run.steps} decode steps")
        print(f"    plans (virtual time, generation, reason, per-EW load "
              f"EMA at the install, split replicas): {run.plans}; final "
              f"generation {run.generation}, pool {run.live_ews}, per-EW "
              f"load EMA at the end {run.ema_end}; {run.host_syncs} host "
              f"syncs in {run.steps} decode steps")
        for cls in ("interactive", "batch", "standard"):
            ttft, tbt = run.m.ttft_values(cls), run.m.tbt_values(cls)
            if ttft.size:
                print(f"    {cls}: TTFT p50 {pct(ttft, 50) * 1e3:.2f} ms "
                      f"p99 {pct(ttft, 99) * 1e3:.2f} ms; TBT p50 "
                      f"{pct(tbt, 50) * 1e3:.2f} ms p99 "
                      f"{pct(tbt, 99) * 1e3:.2f} ms; "
                      f"{run.m.gateway['by_class'].get(cls)}")

    def same(label, run, want, rids=None):
        rids = sorted(want.m.outputs) if rids is None else rids
        bad = [r for r in rids if run.m.outputs.get(r) != want.m.outputs[r]]
        if bad:
            raise AssertionError(f"{label}: streams differ for {bad}")
        print(f"  {label}: {len(rids)} streams bitwise equal")
    e, f = runs["(e)"], runs["(f)"]
    kinds = [k for _, k, _, _ in e.events]
    for k in ("scaled_out", "scaled_in"):
        if k not in kinds:
            raise AssertionError(f"(e): no {k} event: {e.events}")
    joined = [t for t, kind, _, _ in e.events if kind == "scaled_out"]
    print(f"  (e): {kinds.count('rebalanced')} automatic rebalance(s); EW2 "
          f"joined at {joined[0]:.4f} s, "
          f"{ELASTIC_SCALES[1][0] - joined[0]:.4f} s before its drain")
    if not any(n_split for *_, n_split in e.plans):
        raise AssertionError(f"(e): no plan split an expert: {e.plans}")
    same("(e) scale-out, auto-rebalance and drain against the "
         "failure-free run", e, base)
    if not any(k == "detected" and "promoted" in d
               for _, k, _, d in f.events) or f.live_ews != [1]:
        raise AssertionError(f"(f): EW0's shadows were not promoted: "
                             f"{f.events}")
    same("(f) EW0 promoted away against the failure-free run", f, base)
    for label in ("(g)", "(g) bulk"):
        run = runs[label]
        victims = sorted(run.commit_s)
        if not victims or run.m.gateway["preemptions"] < 1:
            raise AssertionError(f"{label}: nothing was preempted: "
                                 f"{run.events}")
        if any(r not in run.resume_s for r in victims):
            raise AssertionError(f"{label}: a victim did not resume: "
                                 f"{run.commit_s} {run.resume_s}")
        same(f"{label} the {len(victims)} preemption victims against the "
             f"run without preemption", run, runs["no preemption"], victims)
        same(f"{label} every request against the run without preemption",
             run, runs["no preemption"])
        print(f"  {label}: {run.m.gateway['preemptions']} preemptions; "
              f"victims' commit host ms "
              f"{({r: [round(t * 1e3, 3) for t in v] for r, v in run.commit_s.items()})} "
              f"(resident tokens, tokens through the bulk range path) "
              f"{run.commit_tokens}; resume host ms "
              f"{({r: [round(t * 1e3, 3) for t in v] for r, v in run.resume_s.items()})} "
              f"(bytes restored {run.resume_bytes})")
    # without per-token checkpointing a victim's resident state goes
    # through the bulk range path at its commit: all of it at the first,
    # the tokens decoded since its last resume at a later one
    bad = {r: v for r, v in runs["(g) bulk"].commit_tokens.items()
           if v[0][1] < 1 or any(sum(b for _, b in v[:k + 1]) != n
                                 for k, (n, _) in enumerate(v))}
    if bad:
        raise AssertionError(f"(g) bulk: a commit did not move the whole "
                             f"resident state through the bulk path: {bad}")
    # the expert FFN at the (P, C, D, F, path) these runs gave it that no
    # earlier check held to the plain versions
    seen = {key for run in runs.values() for per in run.ffn_c.values()
            for key in per}
    todo = sorted(seen - FFN_CHECKED)
    if todo:
        print(f"  expert FFN at the new (P, C, D, F, path) of these runs: "
              f"{todo}")
        kernel_moe_gemm(torch, g, records,
                        [(f"elastic-C{key[1]}-{key[4]}", key) for key in todo],
                        timed=set(), small=False)
    launches = {k: sum(run.launches[ph][k] for run in runs.values()
                       for ph in run.launches)
                for k in ("decode_attention_fused", "flash_attention",
                          "moe_ffn", "moe_ffn/skinny",
                          "moe_ffn/tensor_core")}
    print(f"  elastic phase launches over its {len(runs)} runs: {launches}; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return runs


# the prefix-cache and telemetry phase: PREFIX_SESSIONS chat sessions of
# PREFIX_TURNS turns on the orchestrated phase's weights. Turn 0 is a
# shared seeded system prefix of PREFIX_SYSTEM tokens and a seeded session
# part; each later turn appends seeded tokens to the previous prompt (far
# longer turns than chat_history_tokens' 4-10 tokens, so 16-token pages
# are really shared); every turn asks for PREFIX_MAX_NEW greedy tokens.
# Session names hash 4 to each AW. PREFIX_KV_PAGES is the paged runs' page
# budget per AW (parity is 4 slots x 64 blocks = 256): low enough that
# admissions trim cached tails, high enough that the live requests always
# fit (a host-side replay of these lengths fails at 96 pages)
PREFIX_SESSIONS = 8
PREFIX_TURNS = 3
PREFIX_SYSTEM = 256
PREFIX_SESSION_TOKENS = (64, 160)
PREFIX_TURN_TOKENS = (48, 112)
PREFIX_MAX_NEW = 16
PREFIX_MAX_SEQ = 1024
PREFIX_KV_PAGES = 104
# (k): the launcher's prefix settings (--prefix-slots 3: chunk budget 16,
# token cap 128, session affinity) over its multi_turn_chat workload
PREFIX_WORKLOAD = dict(kind="multi_turn_chat", rate_rps=8.0, duration=1.5,
                       seed=0, max_prompt=16, max_new=24)
PREFIX_LAUNCHER = dict(chunk_token_budget=16, prefill_token_cap=128,
                       prefix_cache_slots=3, placement="session_affinity")


def chat_sessions(vocab: int, seed: int = 0):
    """[(session name, [prompt of each turn])], seeded."""
    import zlib
    import numpy as np
    rng = np.random.default_rng(seed)
    names, per, i = [], Counter(), 0
    while len(names) < PREFIX_SESSIONS:
        name = f"chat{i}"
        aw = zlib.crc32(name.encode()) % 2
        if per[aw] < PREFIX_SESSIONS // 2:
            names.append(name)
            per[aw] += 1
        i += 1
    system = rng.integers(1, vocab, PREFIX_SYSTEM).astype(np.int32)
    out = []
    for name in names:
        p = np.concatenate([system, rng.integers(
            1, vocab, int(rng.integers(PREFIX_SESSION_TOKENS[0],
                                       PREFIX_SESSION_TOKENS[1] + 1)))
            .astype(np.int32)])
        turns = [p]
        for _ in range(PREFIX_TURNS - 1):
            p = np.concatenate([p, rng.integers(
                1, vocab, int(rng.integers(PREFIX_TURN_TOKENS[0],
                                           PREFIX_TURN_TOKENS[1] + 1)))
                .astype(np.int32)])
            turns.append(p)
        out.append((name, turns))
    return out


def pinned_bytes(store) -> int:
    """Bytes of the distinct host blocks the store's logs hold views of."""
    blocks = {}
    for log in store._logs.values():
        for seg in log.segments.values():
            for t in seg:
                st = t.untyped_storage()
                blocks[st.data_ptr()] = st.nbytes()
    return sum(blocks.values())


class SessionRun:
    """The chat sessions through one engine in rounds: session 0's turn 0
    alone (it caches the system prefix), the other sessions' turn 0, then
    every session's turn 1 and turn 2. A session's turn is submitted after
    its previous turn was released; finished requests are released after
    every step (highest rid first). ``between(engine, round)`` runs before
    a round's submissions, ``before_dispatch(engine, act)`` before every
    decode dispatch. Keeps the streams by rid, each request's host-clock
    TTFT (submit to first token) by turn, the launches per phase
    ("prefill": admissions inside ``client.submit``; "chunks": the chunk
    ticks; "decode": the rest of ``step()``), what the run gave the
    kernels, the prefill tokens computed and the Gateway's prefix
    counters; fails on a capture after the engine's warm-up, on other than
    one host sync a decode step, and (paged) on ``PagePool.check()``."""

    def __init__(self, torch, engine, sessions, between=None,
                 before_dispatch=None):
        from repro_torch.serving.api import RequestSpec
        captures0 = engine.decode_plane.captures()
        syncs0, steps0 = engine.gateway.stats.host_syncs, engine.steps
        pf0 = engine.prefill_tokens_done()
        pre = {k: 0 for k in launch_counts()}
        chunk_counts = dict(pre)
        tick, run = engine.chunked.tick, engine.decode_plane.run

        def counted_tick(now):
            c0 = launch_counts()
            SEEN["phase"] = "chunks"
            out = tick(now)
            SEEN["phase"] = "decode"
            for k, v in delta(c0, launch_counts()).items():
                chunk_counts[k] += v
            return out

        def observed_run(act, seg_len):
            before_dispatch(engine, act)
            return run(act, seg_len)
        rounds = [[(sessions[0], 0)], [(s, 0) for s in sessions[1:]]] + \
            [[(s, t) for s in sessions] for t in range(1, PREFIX_TURNS)]
        self.streams, self.ttft = {}, [[] for _ in range(PREFIX_TURNS)]
        self.hits = []                 # the Gateway's prefix_hits by round
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(engine.chunked, tick=counted_tick))
            if before_dispatch is not None:
                stack.enter_context(patched(engine.decode_plane,
                                            run=observed_run))
            obs = stack.enter_context(observed(torch, "decode"))
            for i, batch in enumerate(rounds):
                if between is not None:
                    between(engine, i)
                hits0 = engine.gateway.stats.prefix_hits
                SEEN["phase"] = "prefill"
                c0 = launch_counts()
                t_submit, handles = {}, {}
                for (name, prompts), turn in batch:
                    rid = f"{name}-t{turn}"
                    t_submit[rid] = (time.perf_counter(), turn)
                    handles[rid] = engine.client.submit(RequestSpec(
                        rid=rid, prompt=prompts[turn],
                        max_new=PREFIX_MAX_NEW, session=name))
                for k, v in delta(c0, launch_counts()).items():
                    pre[k] += v
                SEEN["phase"] = "decode"
                while not all(h.done() for h in handles.values()):
                    out = engine.step()
                    now = time.perf_counter()  # step() ends in a host sync
                    for rid in out:
                        if rid in t_submit and rid not in self.streams:
                            self.streams[rid] = None
                            t, turn = t_submit[rid]
                            self.ttft[turn].append(now - t)
                    for rid in sorted((r.rid for r in
                                       engine.requests.values() if r.done),
                                      reverse=True):
                        engine.release_request(rid)
                for rid, h in handles.items():
                    self.streams[rid] = h.tokens()
                self.hits.append(engine.gateway.stats.prefix_hits - hits0)
        self.wall_s = time.perf_counter() - t0
        self.ffn_c, self.attn, self.flash = obs.ffn_c, obs.attn, obs.flash
        self.launches = {"prefill": pre, "chunks": chunk_counts,
                         "decode": {k: v - pre[k] - chunk_counts[k]
                                    for k, v in obs.ran.items()}}
        self.prefill_tokens = engine.prefill_tokens_done() - pf0
        st = engine.gateway.stats
        self.prefix = {k: getattr(st, f"prefix_{k}") for k in (
            "hits", "misses", "hit_tokens", "evictions", "restored",
            "global_hits", "migrated")}
        self.prefix["repins"] = st.session_repins
        self.steps = engine.steps - steps0
        if engine.decode_plane.captures() != captures0:
            raise AssertionError("a chat run captured a step graph after "
                                 "the engine's warm-up")
        if st.host_syncs - syncs0 != self.steps:
            raise AssertionError(f"{st.host_syncs - syncs0} host syncs in "
                                 f"{self.steps} decode steps")
        if engine.pages is not None:
            engine.pages.check()

    def total(self, k):
        return sum(ph[k] for ph in self.launches.values())

    def report(self, label):
        cold, warm = self.ttft[0], self.ttft[1] + self.ttft[2]
        print(f"  {label}: {len(self.streams)} requests in {self.steps} "
              f"decode steps, {self.wall_s:.2f} s wall; prefill tokens "
              f"computed {self.prefill_tokens}; host-clock TTFT p50 turn 0 "
              f"{pct(cold, .5) * 1e3:.2f} ms, turns 1-2 "
              f"{pct(warm, .5) * 1e3:.2f} ms (p99 {pct(cold, .99) * 1e3:.2f}"
              f" / {pct(warm, .99) * 1e3:.2f} ms); prefix {self.prefix}; "
              f"hits by round {self.hits}")
        for phase, counts in self.launches.items():
            print(f"    {phase}: { {k: v for k, v in counts.items() if v} }"
                  + (f", expert FFN (P, C, D, F, path): "
                     f"{dict(sorted(self.ffn_c[phase].items()))}"
                     if phase in self.ffn_c else ""))


def hooks_timed(times, pick):
    """An engine set-up that times, on the host clock, the hooks that
    ``pick(engine)`` names as (object, label, method names), summed into
    ``times`` by "label.name" (or the name alone when the label is None)
    as [seconds, calls]; a hook called from another one is counted in the
    outer one only."""
    depth = [0]

    def setup(eng):
        for obj, label, names in pick(eng):
            for name in names:
                key = name if label is None else f"{label}.{name}"

                def timed(*a, _fn=getattr(obj, name), _key=key, **kw):
                    depth[0] += 1
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **kw)
                    finally:
                        depth[0] -= 1
                        if not depth[0]:
                            acc = times.setdefault(_key, [0.0, 0])
                            acc[0] += time.perf_counter() - t0
                            acc[1] += 1
                setattr(obj, name, timed)
    return setup


def telemetry_timed(times):
    """Times every TelemetryPlane hook the serving path calls."""
    return hooks_timed(times, lambda eng: [(eng.telemetry, None, [
        n for n in dir(eng.telemetry)
        if n.startswith(("on_", "observe_"))])])


def prefix_phase(torch, g, records, params):
    """The prefix-cache and telemetry planes on the orchestrated phase's
    weights (Mixtral-8x7B widths at 8 layers, bf16, capacity factor 4.0:
    no token dropped, so a stream depends on neither its slot, its
    chunking nor an adopted prefix), 2 AWs x 2 EWs, max_batch 8, max_seq
    PREFIX_MAX_SEQ, chunk budget CHUNK_BUDGET, ``session_affinity``, the
    chat sessions of ``chat_sessions``: (h0) the cache off, contiguous;
    (h) contiguous, ``prefix_cache_slots`` 2; (i) paged (PAGE_TOKENS-token
    pages) with ``prefix_global_index``, ``prefix_migrate`` and
    ``kv_pages`` PREFIX_KV_PAGES; (j) as (i) with ``fail_aw(0)`` and
    ``recover_aw_requests`` between turns 1 and 2 while AW0 holds cached
    entries (AW0 provisioned after the run). Every stream of (h)-(j)
    equals (h0)'s bit for bit; (h) and (i) hit and adopt tokens; (i)
    decodes at least one step with a page of refcount > 1 mapped in two
    decoding rows, launches the paged decode kernel and never the fused
    one, and trims at least one cached tail page; (j) restores a cached
    prefix and hits after the failure. Then (k): ``run_serving`` with an
    Orchestrator over PREFIX_WORKLOAD at the launcher's prefix settings,
    cache off, and cache on with telemetry on and off: equal streams, one
    host sync a decode step, no capture after warm-up; the hooks' host
    time per decode step is printed. The expert FFN at every new (C,
    path) is held to its plain versions."""
    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    t_phase = time.perf_counter()
    cfg = mixtral_8_layers(capacity_factor=4.0)
    sessions = chat_sessions(cfg.vocab_size)
    print(f"  {len(sessions)} sessions, prompt tokens by turn "
          f"{[[len(p) for p in turns] for _, turns in sessions]} "
          f"({PREFIX_SYSTEM}-token shared system prefix), "
          f"{PREFIX_MAX_NEW} greedy tokens a turn")
    base = dict(max_batch=8, max_seq=PREFIX_MAX_SEQ, num_aw=2, num_ew=2,
                chunk_token_budget=CHUNK_BUDGET, placement="session_affinity")
    paged_kw = dict(prefix_cache_slots=2, kv_page_tokens=PAGE_TOKENS,
                    kv_pages=PREFIX_KV_PAGES, prefix_global_index=True,
                    prefix_migrate=True)

    def engine(**kw):
        eng = InferenceEngine(cfg, EngineConfig(**base, **kw),
                              params=params, device="cuda")
        warm_step_graph(eng)
        return eng
    runs = {}
    eng = engine()
    runs["(h0)"] = SessionRun(torch, eng, sessions)
    del eng
    eng = engine(prefix_cache_slots=2)
    runs["(h)"] = SessionRun(torch, eng, sessions)
    del eng

    # (i): shared pages in decoding rows, tail trims, adoption costs
    eng = engine(**paged_kw)
    shared, trims = [], []
    adopt_s, copy_s, ckpt_s, in_start = [], [], [], []

    def shared_pages(e, act):
        rows = {}
        for r in act:
            for p in e.pages.slot_pages(r.slot):
                rows.setdefault(p, set()).add(r.slot)
        multi = [p for p, s in rows.items()
                 if len(s) >= 2 and e.pages.ref[p] > 1]
        if multi:
            shared.append((len(multi), max(len(rows[p]) for p in multi)))
    adopt, copy_page = eng._kv_adopt, eng.layout.copy_page
    bulk, start = eng._bulk_checkpoint_group, eng.chunked.start

    def timed_adopt(slot, pages, hit):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = adopt(slot, pages, hit)
        torch.cuda.synchronize()
        adopt_s.append(time.perf_counter() - t0)
        return out

    def timed_copy(cache, src, dst):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = copy_page(cache, src, dst)
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t0)
        return out

    def timed_bulk(items):
        if not in_start:
            return bulk(items)
        t0 = time.perf_counter()
        out = bulk(items)           # ends in its host copy's wait
        ckpt_s.append((time.perf_counter() - t0,
                       sum(n for _, _, n in items)))
        return out

    def flagged_start(q, aw, slot, now):
        in_start.append(1)
        try:
            return start(q, aw, slot, now)
        finally:
            in_start.pop()
    with contextlib.ExitStack() as stack:
        for w in eng.aws:
            trim = w.prefix_cache._trim_tail

            def counted_trim(e, _trim=trim):
                trims.append(len(e.pages))
                return _trim(e)
            stack.enter_context(patched(w.prefix_cache,
                                        _trim_tail=counted_trim))
        stack.enter_context(patched(eng, _kv_adopt=timed_adopt,
                                    _bulk_checkpoint_group=timed_bulk))
        stack.enter_context(patched(eng.layout, copy_page=timed_copy))
        stack.enter_context(patched(eng.chunked, start=flagged_start))
        runs["(i)"] = SessionRun(torch, eng, sessions,
                                 before_dispatch=shared_pages)
    pool = eng.pages
    pin_end = pinned_bytes(eng.store)
    n_entries = sum(len(w.prefix_cache.entries) for w in eng.aws)
    for w in eng.aws:
        for eid in list(w.prefix_cache.entries):
            eng._kv_free_pages(w.prefix_cache.remove_entry(eid))
    pool.check()
    pin_evicted = pinned_bytes(eng.store)
    if pool.stats()["pages_used"] or pin_evicted or eng.store._logs:
        raise AssertionError(f"(i): after every entry was evicted, "
                             f"{pool.stats()} pages, {pin_evicted} pinned "
                             f"bytes, logs {sorted(eng.store._logs)} remain")
    del eng

    # (j): AW0 fails between turns 1 and 2, holding cached entries
    eng = engine(**paged_kw)
    failed, restore_s = {}, []

    def fail_between(e, rnd):
        if rnd != PREFIX_TURNS:          # before the last turn's round
            return
        failed["entries"] = len(e.aws[0].prefix_cache.entries)
        if not failed["entries"]:
            raise AssertionError("(j): AW0 held no cached entry")
        restored0 = e.gateway.stats.prefix_restored
        bytes0 = e.store.stats.bytes_restored
        orphans = e.prefix_plane.restore_orphans

        def timed_restore(now=0.0):
            t0 = time.perf_counter()
            out = orphans(now)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            return out
        e.fail_aw(0)
        with patched(e.prefix_plane, restore_orphans=timed_restore):
            failed["requests"] = e.recover_aw_requests(now=float(e.steps))
        failed["restored"] = e.gateway.stats.prefix_restored - restored0
        failed["bytes"] = e.store.stats.bytes_restored - bytes0
        e.pages.check()
    runs["(j)"] = SessionRun(torch, eng, sessions, between=fail_between)
    eng.provision_aw(0)
    eng.pages.check()
    del eng

    for label, run in runs.items():
        run.report(label)
    want = runs["(h0)"].streams
    for label in ("(h)", "(i)", "(j)"):
        bad = sorted(r for r in want if runs[label].streams.get(r) != want[r])
        if bad:
            raise AssertionError(f"{label}: streams differ from (h0)'s for "
                                 f"{bad}")
        print(f"  {label}: {len(want)} streams bitwise equal to (h0)'s")
    for label in ("(h)", "(i)"):
        pf = runs[label].prefix
        if pf["hits"] <= 0 or pf["hit_tokens"] <= 0:
            raise AssertionError(f"{label}: no prefix hit: {pf}")
    h, i, j = runs["(h)"], runs["(i)"], runs["(j)"]
    if not shared:
        raise AssertionError("(i): no decode step had a shared page mapped "
                             "in two decoding rows")
    if i.total("decode_attention_paged") <= 0 or \
            i.total("decode_attention_fused") or \
            h.total("decode_attention_paged"):
        raise AssertionError(f"(i) launched the fused decode kernel, or no "
                             f"paged one: {i.launches['decode']}")
    if not trims:
        raise AssertionError("(i): no cached tail page was trimmed")
    if failed.get("restored", 0) < 1 or j.hits[-1] < 1:
        raise AssertionError(f"(j): restored {failed.get('restored')} "
                             f"prefixes, {j.hits[-1]} hits after the "
                             f"failure")
    for label, run in runs.items():
        for phase, n in run.launches.items():
            path = "skinny" if phase == "decode" else "tensor_core"
            if n["moe_ffn"] and n[f"moe_ffn/{path}"] != n["moe_ffn"]:
                raise AssertionError(f"{label}: the {phase} expert FFN "
                                     f"launches did not all take the {path} "
                                     f"path: {n}")
    print(f"  prefill tokens computed: (h0) {runs['(h0)'].prefill_tokens}, "
          f"(h) {h.prefill_tokens}, (i) {i.prefill_tokens}, (j) "
          f"{j.prefill_tokens}")
    print(f"  (i): {len(shared)} decode steps with pages of refcount > 1 "
          f"mapped in two or more decoding rows (shared pages, most rows on "
          f"one page): {shared[:4]}...; {len(trims)} tail pages trimmed; "
          f"the paged kernel only ({i.total('decode_attention_paged')} "
          f"launches, fused 0)")
    def ms(xs):
        return (f"p50 {pct(xs, .5) * 1e3:.3f} max {max(xs) * 1e3:.3f}"
                if xs else "none")
    # an adoption's time less its boundary copy's: the page mapping and the
    # block table's upload
    print(f"  (i) adoption host ms: {len(adopt_s)} adoptions, page mapping "
          f"{ms([a - sum(copy_s) / max(len(copy_s), 1) for a in adopt_s])}"
          f" (adoption less the mean boundary copy); copy_page "
          f"({len(copy_s)} boundary copies) {ms(copy_s)}; the bulk "
          f"re-checkpoint of the adopted prefix ({len(ckpt_s)}, tokens "
          f"{[n for _, n in ckpt_s]}) {ms([t for t, _ in ckpt_s])}")
    print(f"  (i) pinned host bytes the store holds: {pin_end} at the end "
          f"({n_entries} cached entries, no live request), {pin_evicted} "
          f"after every entry was evicted")
    print(f"  (j): AW0 held {failed['entries']} cached entries; "
          f"restore_orphans {restore_s[0] * 1e3:.3f} ms host, "
          f"{failed['restored']} prefixes, {failed['bytes']} bytes "
          f"restored; {j.hits[-1]} hits after the failure")

    # (k): the launcher's prefix settings through run_serving
    wl = make_workload(**PREFIX_WORKLOAD)
    hooks = {}
    k = {"(k0) cache off": ServeRun(torch, cfg, params, wl,
                                    **{**PREFIX_LAUNCHER,
                                       "prefix_cache_slots": 0}),
         "(k) telemetry on": ServeRun(torch, cfg, params, wl,
                                      setup=telemetry_timed(hooks),
                                      **PREFIX_LAUNCHER),
         "(k) telemetry off": ServeRun(torch, cfg, params, wl,
                                       telemetry=False, **PREFIX_LAUNCHER)}
    k0 = k["(k0) cache off"].m.outputs
    for label, run in k.items():
        run.report(label)
        if len(run.m.finished) != run.n:
            raise AssertionError(f"{label}: {len(run.m.finished)} of "
                                 f"{run.n} requests finished")
        if run.host_syncs != run.steps:
            raise AssertionError(f"{label}: {run.host_syncs} host syncs in "
                                 f"{run.steps} decode steps")
        if run.m.outputs != k0:
            raise AssertionError(f"{label}: streams differ from the cache-"
                                 f"off run's")
    on, off = k["(k) telemetry on"], k["(k) telemetry off"]
    if on.m.gateway["prefix"]["hits"] <= 0:
        raise AssertionError(f"(k): no prefix hit: {on.m.gateway['prefix']}")
    hook_s = sum(t for t, _ in hooks.values())
    ticks = hooks["on_step"][1]       # one a serving-loop tick, idle or not
    print(f"  (k): {len(k0)} streams bitwise equal across cache off, "
          f"telemetry on and telemetry off; prefix {on.m.gateway['prefix']};"
          f" one host sync a decode step in each ({on.steps} steps)")
    print(f"  (k) telemetry hooks: {hook_s * 1e3:.3f} ms host in all, "
          f"{hook_s / ticks * 1e3:.4f} ms a serving-loop tick ({ticks} "
          f"ticks, {on.steps} of them decode steps); by hook (ms, calls) "
          f"{ {n: (round(t * 1e3, 3), c) for n, (t, c) in sorted(hooks.items())} }; "
          f"0 off; run wall {on.wall_s * 1e3:.2f} ms on, "
          f"{off.wall_s * 1e3:.2f} ms off; "
          f"{len(on.m.telemetry.stall_report())} stall records")

    seen = {key for run in list(runs.values()) + list(k.values())
            for per in run.ffn_c.values() for key in per}
    todo = sorted(seen - FFN_CHECKED)
    if todo:
        print(f"  expert FFN at the new (P, C, D, F, path) of these runs: "
              f"{todo}")
        kernel_moe_gemm(torch, g, records,
                        [(f"prefix-C{key[1]}-{key[4]}", key) for key in todo],
                        timed=set(), small=False)
    print(f"  prefix phase wall {time.perf_counter() - t_phase:.1f} s; on "
          f"{card_line()}")
    return runs


# the control-plane and forensics phase, on the orchestrated phase's
# weights, in the reference incident's shape (tests/test_flightrec.py):
# CTL_WORKLOAD (a batch wave that fills every slot, then interactive
# arrivals with 0.3 s first-token deadlines), AW0 failed at 0.4 s,
# detection 0.05 s x 2, T_w 0.5 s; a fixed virtual clock (a replay refuses
# host step times), chunked prefill at CTL_BUDGET tokens a tick with the
# token cap at 8x it, paged KV, max_ew 3
CTL_WORKLOAD = dict(kind="mixed_slo", rate_rps=3.0, duration=2.0, seed=7,
                    max_new=40, interactive_deadline=0.3, batch_wave=8,
                    batch_every=3.0)
CTL_FAILURES = ((0.4, "aw", 0),)
CTL_CLOCK = dict(step_time=0.02, prefill_token_time=0.002)
CTL_BUDGET = 64
CTL_ENGINE = dict(max_ew=3, chunk_token_budget=CTL_BUDGET,
                  prefill_token_cap=8 * CTL_BUDGET,
                  kv_page_tokens=PAGE_TOKENS)


def planes_timed(times, keep):
    """Keeps the engine in ``keep`` and times the control plane's and the
    flight recorder's hooks (``hooks_timed``)."""
    timed = hooks_timed(times, lambda eng: [
        (eng.controller, "controller", ("tick", "choose_victim")),
        (eng.flightrec, "flightrec",
         [n for n in dir(eng.flightrec) if n.startswith(("on_", "note_"))]
         + ["tick"])])

    def setup(eng):
        keep.append(eng)
        timed(eng)
    return setup


def control_phase(torch, g, records, params):
    """The control plane and the flight recorder on the orchestrated
    phase's weights (Mixtral-8x7B widths at 8 layers, bf16, capacity
    factor 4.0: no token dropped, so neither a victim's eviction nor a
    plan or budget change can change a stream), ``run_serving`` on the
    fixed virtual clock CTL_CLOCK over CTL_WORKLOAD with AW0 failed at
    0.4 s: (l) the controller on (every policy, controller-chosen
    victims), the recorder and watchdogs on, autodump at detection; (m)
    (l)'s bundle replayed in script mode (controller off, its decisions as
    ScalePlans and a budget timeline); (n) the bundle read back from its
    JSON file and replayed in exact mode; (o) (l) with the recorder and
    watchdogs off. Every stream of (m)-(o) equals (l)'s bit for bit; (l)
    makes at least one budget and one preempt decision and trips no
    watchdog; ``PagePool.check()`` after each run; no capture after the
    warm-up and one host sync a decode step in each."""
    import copy

    from repro_torch.core.costmodel import TarragonProfile
    from repro_torch.data.workloads import make_workload
    from repro_torch.launch import replay
    t_phase = time.perf_counter()
    cfg = mixtral_8_layers(capacity_factor=4.0)
    wl = make_workload(**CTL_WORKLOAD)
    out_dir = Path(__file__).resolve().parent / "build" / "control_phase"
    bundle_path = out_dir / "incident.postmortem.json"
    auto_path = out_dir / "autodump.postmortem.json"
    for p in (bundle_path, auto_path):
        p.unlink(missing_ok=True)
    print(f"  mixed_slo workload: {len(wl)} requests "
          f"({sum(r.slo_class == 'batch' for r in wl)} batch at 0 s, "
          f"{sum(r.slo_class == 'interactive' for r in wl)} interactive at "
          f"{sorted(round(r.arrival, 3) for r in wl if r.slo_class == 'interactive')} s); "
          f"AW0 fails at {CTL_FAILURES[0][0]} s; virtual clock {CTL_CLOCK}")
    orch_kw = dict(profile=TarragonProfile(detect=0.05, detect_retries=2),
                   worker_init_time=0.5)
    kw = dict(orch_kw=orch_kw, clock=CTL_CLOCK, **CTL_ENGINE)
    hooks, held = {}, []
    runs = {"(l)": ServeRun(torch, cfg, params, wl, CTL_FAILURES,
                            setup=planes_timed(hooks, held),
                            controller="on", victim_policy="controller",
                            watchdogs=True, flight_autodump=str(auto_path),
                            **kw)}
    eng = held[0]
    held.clear()
    runs["(o)"] = ServeRun(torch, cfg, params, wl, CTL_FAILURES,
                           setup=held.append, controller="on",
                           victim_policy="controller",
                           flight_recorder=False, **kw)
    engines = {"(l)": eng, "(o)": held[0]}
    held.clear()
    fr, ctl = eng.flightrec, eng.controller
    t0 = time.perf_counter()
    bundle = fr.dump(str(bundle_path), reason="control phase, end of (l)")
    dump_s = time.perf_counter() - t0
    auto = json.loads(auto_path.read_text())
    if not auto["reason"].startswith("failure detected"):
        raise AssertionError(f"(l): the autodump's reason is "
                             f"{auto['reason']!r}")

    # the replays build their own engines: warm each one's step graph
    # before its run, as ServeRun does, and observe what it gives the
    # kernels
    replay_engine = replay.InferenceEngine

    def replayed(label, b, mode):
        made = []

        def warm_engine(*a, **k):
            e = replay_engine(*a, **k)
            warm_step_graph(e)
            made.append((e, e.decode_plane.captures()))
            return e
        with patched(replay, InferenceEngine=warm_engine), \
                observed(torch, "decode") as obs:
            t0 = time.perf_counter()
            report = replay.replay_bundle(b, mode, params=params,
                                          device="cuda")
            wall = time.perf_counter() - t0
        e, captures = made[0]
        if e.decode_plane.captures() != captures:
            raise AssertionError(f"{label}: the replay captured a step "
                                 f"graph after its engine's warm-up")
        engines[label] = e
        runs[label] = SimpleNamespace(
            ffn_c=obs.ffn_c, ran=obs.ran, host_syncs=e.gateway.stats
            .host_syncs, steps=e.steps, report=report, wall_s=wall)
        return report
    # script mode cannot re-run controller-chosen victims (not recorded as
    # decisions); the tool refuses (l)'s bundle as the reference's does,
    # so (m) runs the decisions with remaining-work victims: at capacity
    # factor 4.0 a victim's choice changes no stream
    try:
        replay.replay_bundle(copy.deepcopy(bundle), "script", params=params,
                             device="cuda")
        raise AssertionError("(m): script mode took controller victims")
    except replay.BundleError as e:
        refusal = str(e)
    script = copy.deepcopy(bundle)
    script["config"]["engine"]["victim_policy"] = "remaining_work"
    rm = replayed("(m)", script, "script")
    rn = replayed("(n)", replay.load_bundle(str(bundle_path)), "exact")

    l_out = runs["(l)"].m.outputs
    for label, run in runs.items():
        if label in ("(l)", "(o)"):
            run.report(label)
            if len(run.m.finished) != run.n:
                raise AssertionError(f"{label}: {len(run.m.finished)} of "
                                     f"{run.n} requests finished")
            if run.m.outputs != l_out:
                raise AssertionError(f"{label}: streams differ from (l)'s")
        else:
            rep = run.report
            if not rep["ok"] or rep["extra_finished"] or \
                    rep["requests_replayed"] != len(l_out) or \
                    rep["matched"] != len(l_out):
                raise AssertionError(f"{label}: the replay diverged: {rep}")
        if run.host_syncs != run.steps:
            raise AssertionError(f"{label}: {run.host_syncs} host syncs in "
                                 f"{run.steps} decode steps")
        engines[label].pages.check()
    if not rn["config_hash_ok"]:
        raise AssertionError(f"(n): config hash mismatch: {rn}")
    counts = ctl.counts
    if counts["budget"] < 1 or counts["preempt"] < 1:
        raise AssertionError(f"(l): no budget or no preempt decision: "
                             f"{counts}")
    wd = fr.watchdogs
    if wd.trips:
        raise AssertionError(f"(l): watchdog trips {wd.trips}")
    by_kind = {}
    for d in ctl.decisions:
        by_kind.setdefault(d["kind"], []).append(
            f"t={d['t']:.3f} {d['detail']}")
    print(f"  (l) decisions {counts}; preemptions "
          f"{runs['(l)'].m.gateway['preemptions']}; final chunk budget "
          f"{ctl.stats()['chunk_budget']}, pool {runs['(l)'].live_ews}")
    for kind, details in by_kind.items():
        print(f"    {kind}: {details[:3]}"
              + (f" (+{len(details) - 3} more)" if len(details) > 3 else ""))
    print(f"  (l) watchdogs: 0 trips over {wd.intervals} intervals; "
          f"autodump at detection: {auto['reason']!r}, "
          f"{len(auto['records'])} records")
    print(f"  (l) bundle: {bundle_path.stat().st_size} bytes, "
          f"{len(bundle['records'])} records ({fr.records_dropped} dropped), "
          f"{fr.fingerprints} fingerprints, {len(bundle['submissions'])} "
          f"submissions, {len(bundle['outputs'])} outputs; dump "
          f"{dump_s * 1e3:.3f} ms host")
    print(f"  (m) script mode: (l)'s bundle refused as recorded "
          f"({refusal!r}); with remaining-work victims: {rm}; "
          f"{runs['(m)'].wall_s:.2f} s wall")
    print(f"  (n) exact mode from {bundle_path.name}: {rn}; verdict "
          f"{'BIT-IDENTICAL' if rn['ok'] else 'DIVERGED'}; "
          f"{runs['(n)'].wall_s:.2f} s wall")
    print(f"  (l), (m), (n), (o): {len(l_out)} streams bitwise equal to "
          f"(l)'s; PagePool.check() after each; one host sync a decode step "
          f"in each ({', '.join(f'{k} {r.steps}' for k, r in runs.items())} "
          f"steps); no capture after warm-up")
    ticks = hooks["flightrec.tick"][1]
    per_tick = {n: t / ticks for n, (t, _) in hooks.items()}
    print(f"  (l) hook host ms a serving-loop tick ({ticks} ticks, "
          f"{runs['(l)'].steps} decode steps): controller "
          f"{sum(v for n, v in per_tick.items() if n.startswith('controller')) * 1e3:.4f}, "
          f"flight recorder "
          f"{sum(v for n, v in per_tick.items() if n.startswith('flightrec')) * 1e3:.4f}; "
          f"by hook (ms in all, calls) "
          f"{ {n: (round(t * 1e3, 3), c) for n, (t, c) in sorted(hooks.items())} }; "
          f"run wall (l) {runs['(l)'].wall_s * 1e3:.2f} ms, (o) "
          f"{runs['(o)'].wall_s * 1e3:.2f} ms")

    seen = {key for run in runs.values() for per in run.ffn_c.values()
            for key in per}
    todo = sorted(seen - FFN_CHECKED)
    if todo:
        print(f"  expert FFN at the new (P, C, D, F, path) of these runs: "
              f"{todo}")
        kernel_moe_gemm(torch, g, records,
                        [(f"control-C{key[1]}-{key[4]}", key) for key in todo],
                        timed=set(), small=False)
    launches = Counter()
    for label, run in runs.items():
        ran = run.ran if hasattr(run, "ran") else {
            k: sum(run.launches[ph][k] for ph in run.launches)
            for k in run.launches["decode"]}
        launches.update({k: v for k, v in ran.items() if v})
    print(f"  control phase launches over its {len(runs)} runs: "
          f"{dict(sorted(launches.items()))}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; on {card_line()}")
    return runs


def zamba2_13_layers():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2_7b"),
                               num_layers=HYBRID_LAYERS, dtype="bfloat16")


def copy_designs(torch, label, gather, keep=3):
    """The device-to-host copy of one checkpoint gather in three designs,
    on the bytes ``gather`` hands to the copy: pageable memory
    (``.cpu()``, the port's copy before the pinned one), a reused pinned
    staging buffer followed by a host copy into store-owned pageable
    memory, and store-owned pinned blocks from PyTorch's pinned-memory
    cache (what ``kvcache._to_host`` does). Each is timed with
    ``keep`` copies kept alive, as the store keeps a run's checkpoints
    (pinned blocks newly allocated unless PyTorch's cache holds freed
    ones of the size), and with each copy freed before the next (median
    of 3: the steady state of a server whose released requests hand
    their blocks back). Host clock through the copy's end."""
    from repro_torch.serving import kvcache
    start = time.perf_counter()
    got = []
    real = kvcache._to_host

    def spy(packed):
        got.append(packed)
        return real(packed)
    with patched(kvcache, _to_host=spy):
        gather()
    src = got[0]
    n = src.numel()
    stream = kvcache._copy_stream(src.device)
    staging = torch.empty(n, dtype=torch.uint8, pin_memory=True)

    def pageable():
        return src.cpu()

    def to_pinned(dst):
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
        stream.synchronize()
        return dst

    def staged():
        return torch.empty(n, dtype=torch.uint8).copy_(to_pinned(staging))

    def pinned():
        return to_pinned(torch.empty(n, dtype=torch.uint8,
                                     pin_memory=True))
    times, want = {}, None
    for name, fn in (("pageable", pageable), ("staging", staged),
                     ("pinned", pinned)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = [fn() for _ in range(keep)]
        kept_ms = (time.perf_counter() - t0) * 1e3 / keep
        want = kept[-1] if want is None else want
        if not torch.equal(kept[-1], want):
            raise AssertionError(f"{label}: the {name} copy differs")
        del kept
        times[name] = (kept_ms, host_ms(torch, fn, reps=3))
    print(f"  {label} copy, {n} bytes: " + "; ".join(
        f"{k} {a:.2f} ms kept, {b:.2f} ms freed"
        for k, (a, b) in times.items()) + f" (host clock; on {card_line()}; "
        f"{time.perf_counter() - start:.1f} s)")
    return times


def hybrid_phase(torch, profile_dir=None):
    """Zamba2-7B at full width, 13 layers, bf16 (2 units of 6 Mamba2
    blocks + the shared attention block, then 1 trailing block): 8
    requests of 128 prompt tokens and 16 greedy new tokens, each
    prefilled alone through ``client.submit`` (the exact whole-prompt
    scheme: a recurrent state never sees a pad); then the same requests
    with ``fail_aw(0)`` once every request has 8 tokens, recover,
    provision: every stream must equal the failure-free one bit for bit.
    Returns the failure-free Run."""
    import numpy as np
    from repro_torch.models.hybrid import _geometry
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = zamba2_13_layers()
    every, units, trailing = _geometry(cfg)
    ecfg = EngineConfig(max_batch=8, max_seq=HYBRID_MAX_SEQ, num_aw=2,
                        num_ew=1)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name} at {cfg.num_layers} layers ({units} units "
          f"of {every} Mamba2 blocks + the shared block, {trailing} "
          f"trailing) bf16, {cfg.param_count / 1e9:.2f}B params, seeded "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    max_new = 16
    Run(torch, engine, prompts, 2, warm_up=True)
    reset_counts()
    calls0, steps0 = engine.scheduler.stats.calls, engine.steps
    run = Run(torch, engine, prompts, max_new)
    calls = engine.scheduler.stats.calls - calls0
    steps = engine.steps - steps0
    pre, dec = run.launches["prefill"], run.launches["decode"]
    want = {"prefill": {"ssm_scan": cfg.num_layers * calls,
                        "flash_attention": units * calls},
            "decode": {"ssm_scan": 0, "decode_attention_fused":
                       units * steps}}
    for phase, kernels in want.items():
        for k, n in kernels.items():
            if run.launches[phase][k] != n:
                raise AssertionError(
                    f"hybrid {phase}: {k} launched "
                    f"{run.launches[phase][k]} times, expected {n} "
                    f"({calls} prefill calls, {steps} decode steps)")
    if calls != len(prompts) or pre["moe_ffn"] or dec["moe_ffn"] or \
            dec["decode_attention_paged"]:
        raise AssertionError(f"hybrid launches off the path: {run.launches}")
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"bad stream {st}")
    print(f"  main path: {calls} prefill calls (each one 128-token prompt: "
          f"{cfg.num_layers} ssm_scan + {units} flash launches), {steps} "
          f"decode steps ({units} decode attention launches each)")
    run.report("hybrid serve")
    print(f"  stream r0: {run.streams[0][:12]}...")
    # what the per-step checkpoint copies: every row's new K/V plus its
    # whole recurrent state (h and conv of every Mamba2 block)
    slots, toks = list(range(8)), [150] * 8
    leaves = engine.layout.extract_tokens(engine.cache, slots, toks)
    # a state leaf is a list of per-row views, one host copy per slot
    nbytes = sum(sum(v.nbytes for v in t) if isinstance(t, list)
                 else t.nbytes for t in leaves)
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks), reps=10)
    print(f"  per-step checkpoint gather + device-to-host copy (8 rows): "
          f"{ck_ms:.3f} ms, {nbytes} bytes ({nbytes // 8} per token)")
    copy_designs(torch, "hybrid per-step checkpoint", lambda:
                 engine.layout.extract_tokens(engine.cache, slots, toks))

    aw_failover(torch, "hybrid", engine, prompts, max_new, run, 8)
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir / "hybrid")
    return run


def served_partials(torch, engine, out, layers):
    """The partial kernel on a served engine's final caches, at each
    (layer index, label) of ``layers`` (Gemma2: one local (ring) and one
    global layer; Mixtral: its first layer), with seeded q/k1/v1 of the
    model's shapes: the partials against the plain partials; each row of
    the batched call bit for bit the call on that row alone (B 1); the
    partials combined against the fused kernel; the cache split in two
    halves along Sc, each half's partials merged in log-sum-exp form, then
    combined, against the fused kernel. Adds each layer's partial-kernel
    launches (all of them: the batched call, the row calls and the
    halves) to ``out`` under its label."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.transformer import layer_windows
    cfg = engine.cfg
    b = engine.ecfg.max_batch
    pos = torch.full((b,), -1, dtype=torch.int32)
    for r in engine.requests.values():
        pos[r.slot] = r.pos
    pos = pos.cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    dh, h, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    q = torch.randn((b, h, dh), generator=g, device="cuda").bfloat16()
    k1, v1 = (torch.randn((b, hkv, dh), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    windows = layer_windows(cfg)
    for li, kind in layers:
        layer = engine.cache["layers"][li]
        ck, cv, cpos = layer["k"], layer["v"], layer["pos"]
        sc = ck.shape[1]
        kw = dict(window=windows[li], softcap=cfg.attn_softcap)
        tag = (f"served {kind} layer {li} (Sc {sc}, window {windows[li]}, "
               f"positions up to {int(pos.max())})")
        n0 = da.PARTIAL_KERNEL.launches
        got = da.decode_attention_partial_cuda(q, ck, cv, cpos, pos, **kw)
        check_partials(f"{tag} partials vs plain", got,
                       da.decode_attention_partial_plain(q, ck, cv, cpos,
                                                         pos, **kw))
        alone = [da.decode_attention_partial_cuda(
            q[i:i + 1], ck[i:i + 1], cv[i:i + 1], cpos[i:i + 1],
            pos[i:i + 1], **kw) for i in range(b)]
        differ = [i for i in range(b) if not all(
            torch.equal(t[i], a[0]) for t, a in zip(got, alone[i]))]
        print(f"  {tag} each of the {b} rows bitwise the call on that row "
              f"alone (B 1): {'ok' if not differ else 'FAIL'}")
        if differ:
            raise AssertionError(f"{tag}: partials of rows {differ} differ "
                                 f"from the same rows called alone")
        fused = da.decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos, **kw)
        check(f"{tag} partials combined vs the fused kernel",
              da.combine_decode_partials(q, *got, k1, v1,
                                         softcap=cfg.attn_softcap),
              fused, "bfloat16")
        half = sc // 2
        parts = [da.decode_attention_partial_cuda(
            q, ck[:, a:z], cv[:, a:z], cpos[:, a:z], pos, **kw)
            for a, z in ((0, half), (half, sc))]
        check(f"{tag} two Sc halves merged, combined vs the fused kernel",
              da.combine_decode_partials(q, *da.merge_split_partials(parts),
                                         k1, v1, softcap=cfg.attn_softcap),
              fused, "bfloat16")
        out[kind] = out.get(kind, 0) + da.PARTIAL_KERNEL.launches - n0


def ring_segments(torch, label, engine, ecfg, prompts, max_new, want,
                  fail_tokens, window):
    """The requests at ``decode_segment_len`` 8 on the same weights, with
    ``fail_aw(0)`` once every request has ``fail_tokens`` tokens and AW0's
    writes of the last segment not yet delivered: every stream bitwise
    equal to the seg-1 run's (``want``). Requests whose prompts end short
    of the window wrap their rings inside a segment (a range of 8
    positions that crosses a multiple of the window)."""
    from repro_torch.serving.engine import InferenceEngine
    t0 = time.perf_counter()
    eight = InferenceEngine(engine.cfg, dataclasses.replace(
        ecfg, decode_segment_len=8), params=engine.params, device="cuda")
    Run(torch, eight, [p for p in prompts if len(p) <= 128], 2,
        warm_up=True)
    crossing = [f"r{i}" for i, p in enumerate(prompts)
                if len(p) - 1 < window < len(p) - 1 + max_new]
    if not crossing:
        raise AssertionError(f"{label}: no request's ring wraps in decode")
    aw_failover(torch, f"{label} seg 8", eight, prompts, max_new, want,
                fail_tokens, uncommitted=True)
    print(f"  seg 8: streams bitwise equal to seg 1's; rings wrapped "
          f"inside a segment: {crossing}; step graphs "
          f"{sorted(eight.decode_plane.graphs)} "
          f"({time.perf_counter() - t0:.1f} s)")


def dense_ring_phase(torch, label, cfg, ecfg, lens, *, max_new=32,
                     fail_tokens=16, partials=False, seg8=False,
                     profile_dir=None):
    """A sliding-window model at full width and depth in bf16: the
    requests of ``lens`` prompt tokens (each prefilled alone through
    ``client.submit``: ring caches take the exact whole-prompt scheme) to
    the end once, then again with ``fail_aw(0)`` once every request has
    ``fail_tokens`` tokens, recover, provision: every stream must equal
    the failure-free one bit for bit, and AW0 must have held a request
    whose ring wrapped inside prefill and one whose ring wrapped during
    decode. With ``partials``, the partial kernel is checked on the
    failure-free run's final caches. With ``seg8``, the install copy's
    designs (``copy_designs``), the same requests at
    ``decode_segment_len`` 8 (``ring_segments``) and the step times
    (``step_times``). With ``profile_dir``, a torch.profiler pass over
    decode steps and one prefill of the first prompt. Returns (Run,
    partial launches)."""
    import numpy as np
    from repro_torch.models.transformer import layer_windows
    from repro_torch.serving.engine import InferenceEngine
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    window = cfg.sliding_window
    n_ring = sum(1 for w in layer_windows(cfg) if w)
    print(f"  engine: {cfg.name}, {cfg.num_layers} layers ({n_ring} with a "
          f"{window}-token window) bf16, {cfg.param_count / 1e9:.2f}B "
          f"params, seeded init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    # warm-up on the short prompts only
    Run(torch, engine, [p for p in prompts if len(p) <= 128], 2,
        warm_up=True)
    reset_counts()
    calls0, steps0 = engine.scheduler.stats.calls, engine.steps
    part = {}
    run = Run(torch, engine, prompts, max_new,
              at_end=(lambda eng: served_partials(
                  torch, eng, part, ((0, "local"), (1, "global"))))
              if partials else None)
    calls = engine.scheduler.stats.calls - calls0
    steps = engine.steps - steps0
    tot = {k: sum(ph[k] for ph in run.launches.values())
           for k in run.launches["decode"]}
    want = {"flash_attention": cfg.num_layers * calls,
            "decode_attention_fused": cfg.num_layers * steps,
            "decode_attention_paged": 0, "moe_ffn": 0, "ssm_scan": 0}
    if any(tot[k] != n for k, n in want.items()) or calls != len(prompts):
        raise AssertionError(f"{label} launches {tot}, expected {want} "
                             f"({calls} prefill calls, {steps} steps)")
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"bad stream {st}")
    print(f"  main path: {calls} prefill calls of one prompt each "
          f"({cfg.num_layers} flash launches each), {steps} decode steps "
          f"({cfg.num_layers} decode attention launches each); attention "
          f"(kernel, Dh, G, window, softcap): {dict(run.attn)}")
    run.report(label)
    by_len = {}
    for i, n in enumerate(lens):
        by_len.setdefault(n, []).append(run.first[f"r{i}"] * 1e3)
    print("  TTFT by prompt length, ms (each prompt prefilled alone, in "
          "submission order): " + "; ".join(
              f"{n}: {', '.join(f'{t:.1f}' for t in ts)}"
              for n, ts in sorted(by_len.items())))
    print(f"  stream r0: {run.streams[0][:12]}...")
    slots = list(range(ecfg.max_batch))
    toks = [max(lens)] * len(slots)
    leaves = engine.layout.extract_tokens(engine.cache, slots, toks)
    nbytes = sum(t.nbytes for t in leaves)
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks))
    print(f"  per-step checkpoint gather + device-to-host copy "
          f"({len(slots)} rows): {ck_ms:.3f} ms, {nbytes} bytes "
          f"({nbytes // len(slots)} per token)")
    n = max(lens)
    leaves = engine.layout.extract_range(engine.cache, 0, 0, n)
    nbytes = sum(t.nbytes for t in leaves)
    del leaves
    inst_ms = host_ms(torch, lambda: engine.layout.extract_range(
        engine.cache, 0, 0, n), reps=3)
    print(f"  install checkpoint of a {n}-token prompt (gather + one "
          f"device-to-host copy): {inst_ms:.1f} ms, {nbytes} bytes")
    if seg8:
        copy_designs(torch, f"{label} install checkpoint", lambda:
                     engine.layout.extract_range(engine.cache, 0, 0, n))

    _, held = aw_failover(torch, label, engine, prompts, max_new, run,
                          fail_tokens)
    in_prefill = [v[0] for v in held if v[1] > window]
    in_decode = [v[0] for v in held if v[1] <= window < v[2]]
    if not in_prefill or not in_decode:
        raise AssertionError(f"AW0 held no request whose ring wrapped "
                             f"inside prefill or none whose ring wrapped "
                             f"during decode: (rid, prompt, pos) {held}")
    print(f"  restored requests whose rings wrapped inside prefill: "
          f"{in_prefill}, during decode: {in_decode}")
    if seg8:
        ring_segments(torch, label, engine, ecfg, prompts, max_new, run,
                      fail_tokens, window)
        print(f"step times: {label}, eager against graph, seg 1 against "
              f"seg 8")
        step_times(torch, engine, prompts, label)
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir / label,
                       chrome=False)
    del engine
    return run, part


def qwen2_phase(torch, profile_dir=None):
    """Qwen2-1.5B at full width and depth in bf16 (QKV bias, G 6): 8
    requests of seeded prompt lengths in QWEN2_LENS and 32 greedy new
    tokens through the KV plane's three engines (``kv_plane_phase``,
    failure after 8 tokens); the paged run must launch the paged kernel at
    G 6. Returns the failure-free Runs."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), dtype="bfloat16")
    rng = np.random.default_rng(3)
    lens = rng.integers(QWEN2_LENS[0], QWEN2_LENS[1] + 1, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(
        np.int32) for n in lens]
    print(f"  prompt lengths {lens.tolist()}")
    runs, engines = kv_plane_phase(torch, "qwen2", cfg, prompts,
                                   max_seq=QWEN2_MAX_SEQ, num_ew=1)
    if not any(k[0] == "decode_attention_paged" and k[2] == 6
               for k in runs["paged"].attn):
        raise AssertionError(f"the qwen2 paged run did not launch the paged "
                             f"kernel at G 6: {dict(runs['paged'].attn)}")
    if profile_dir is not None:
        profile_decode(torch, engines["whole"], prompts,
                       profile_dir / "qwen2", chrome=False)
    return runs


def graph_check(torch, engine, prompts, label):
    """The seg-1 step graph replayed against the eager step from the same
    state, three steps into decode of ``prompts``; the requests then run
    to their end and are released."""
    from repro_torch.serving.api import RequestSpec
    handles = [engine.client.submit(RequestSpec(
        rid=f"g{i}", prompt=p, max_new=FAMILY_NEW)) for i, p in
        enumerate(prompts)]
    for _ in range(3):
        engine.step()
    graph_equals_eager(torch, engine, 1, label)
    for h in reversed(handles):
        while not h.done():
            engine.step()
        engine.release_request(h.rid)


def family_phase(torch, label, arch, layers, num_ew, kv_plane):
    """One family of phase 17 in bf16 with seeded weights, 2 AWs, 8
    requests of FAMILY_PROMPT tokens and FAMILY_NEW greedy new tokens,
    step graphs on: the failure-free run (every kernel of the path
    launched: flash, the fused decode kernel at the family's (Dh, G), and
    for a MoE model the expert FFN's tensor-core path in prefill and its
    decode path in every decode step); for a MoE model ``fail_ew(0)``
    after 8 steps, bitwise the failure-free streams; ``fail_aw(0)`` once
    every request has 8 tokens, bitwise; with ``kv_plane`` the chunked
    and paged engines (``kv_plane_phase``: paged == contiguous, chunked ==
    whole-prompt, the paged kernel only, its AW failover) instead of the
    whole engine's failover; the seg-1 step graph against the eager step;
    the decode step's wall time and device busy. Returns the failure-free
    Runs by engine."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    t_fam = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="bfloat16")
    if cfg.moe.enabled:
        # capacity factor E / top-k: a slot's capacity is at least its
        # call's token count, so no call drops a token whatever its size
        # (Mixtral's 4.0 in the KV plane). At 4.0 Qwen's chunk tails of a
        # few tokens got capacity 1-2 and dropped tokens, so chunked
        # streams parted from whole-prompt ones; a drop also depends on
        # the batch row, which an AW failover changes.
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    dh, grp = cfg.head_dim_, cfg.num_heads // cfg.num_kv_heads
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=(FAMILY_PROMPT,)).astype(
        np.int32) for _ in range(8)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if kv_plane:
        runs, engines = kv_plane_phase(
            torch, label, cfg, prompts, max_seq=FAMILY_MAX_SEQ,
            num_ew=num_ew, max_new=FAMILY_NEW, fail_tokens=8)
        engine, run = engines["whole"], runs["whole"]
        if not any(k[0] == "decode_attention_paged" and k[1:3] == (dh, grp)
                   for k in runs["paged"].attn):
            raise AssertionError(f"{label}: the paged run did not launch the "
                                 f"paged kernel at (Dh {dh}, G {grp}): "
                                 f"{dict(runs['paged'].attn)}")
    else:
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, EngineConfig(
            max_batch=8, max_seq=FAMILY_MAX_SEQ, num_aw=2, num_ew=num_ew),
            seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"  engine: {cfg.name}, {cfg.num_layers} layers bf16, "
              f"{cfg.param_count / 1e9:.2f}B params, seeded init "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        Run(torch, engine, prompts, 2, warm_up=True)
        reset_counts()
        run = Run(torch, engine, prompts, FAMILY_NEW)
        run.report(label)
        runs = {"whole": run}
    print(f"  peak device memory (init and runs): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for st in run.streams:
        if len(st) != FAMILY_NEW or not all(0 <= t < cfg.vocab_size
                                            for t in st):
            raise AssertionError(f"{label}: bad stream {st}")
    launches = {k: sum(ph[k] for ph in run.launches.values())
                for k in run.launches["decode"]}
    for k in ("decode_attention_fused", "flash_attention"):
        if launches[k] <= 0:
            raise AssertionError(f"{label}: {k} was not launched")
    if not any(k[0] == "decode_attention_fused" and k[1:3] == (dh, grp)
               for k in run.attn):
        raise AssertionError(f"{label}: the fused decode kernel did not run "
                             f"at (Dh {dh}, G {grp}): {dict(run.attn)}")
    if cfg.moe.enabled:
        for name, r in runs.items():
            for phase, n in r.launches.items():
                path = "skinny" if phase == "decode" else "tensor_core"
                if n["moe_ffn"] != n[f"moe_ffn/{path}"]:
                    raise AssertionError(f"{label} {name}: the expert FFN's "
                                         f"{phase} launches did not all take "
                                         f"the {path} path: {n}")
        dec = run.launches["decode"]
        if dec["moe_ffn"] <= 0 or run.launches["prefill"]["moe_ffn"] <= 0:
            raise AssertionError(f"{label}: the expert FFN was not launched "
                                 f"in prefill and decode: {run.launches}")
        print(f"  {label}: every decode step on the expert FFN's decode path "
              f"({dec['moe_ffn/skinny']} launches of {dec['moe_ffn']}, "
              f"{run.steps} steps x {layers - cfg.moe.first_k_dense} MoE "
              f"layers), every prefill call on the tensor-core path "
              f"({run.launches['prefill']['moe_ffn/tensor_core']} launches)")
        print(f"{label} EW failover: fail_ew(0) after 8 decode steps")

        def fail_ew(eng, handles, steps):
            if steps == 8:
                eng.fail_ew(0)
                return []
            return None
        failed = Run(torch, engine, prompts, FAMILY_NEW, fail=fail_ew)
        same_streams(f"{label} streams under fail_ew(0)", failed, run)
        print(f"  {len(run.streams)} streams bitwise equal to the "
              f"failure-free run (EW0 failed: {sorted(engine.failed_ews)}; "
              f"{engine.api.placement.num_slots} slots, "
              f"{engine.api.placement.primary_slots} primary)")
        engine.provision_ew(0)
    if not kv_plane:
        aw_failover(torch, label, engine, prompts, FAMILY_NEW, run, 8)
    print(f"{label} graph == eager: the seg-1 step graph against the eager "
          f"step from the same state")
    graph_check(torch, engine, prompts, label)
    maps = mg.tensor_maps_encoded() if cfg.moe.enabled else None
    step_times(torch, engine, prompts, label, segs=(1,))
    if maps is not None:
        if mg.tensor_maps_encoded() != maps:
            raise AssertionError(f"{label}: eager decode steps made "
                                 f"{mg.tensor_maps_encoded() - maps} tensor "
                                 f"maps again (the cache thrashes)")
        print(f"  {label}: eager decode steps made no tensor map "
              f"({maps} made in the process: every bank's maps kept)")
    print(f"  [{label}: {time.perf_counter() - t_fam:.1f} s]")
    return runs

def recurrent_family_phase(torch, label, arch, prompt_len, max_new,
                           fail_tokens, max_seq):
    """One family of phase 18, whole, in bf16 with seeded weights, 2 AWs,
    1 EW, 8 requests (Whisper's each with its own seeded frames), step
    graphs on. A warm-up of one request captures the seg-1 step graph
    (its key does not depend on the rows). The failure-free run: Whisper's
    every prefill call launches flash once per encoder layer, without the
    causal mask, and once per decoder layer, every decode step the fused
    decode kernel once per decoder layer; the xLSTM launches no kernel,
    as the reference runs its cells in plain jnp; the store's peak pinned
    bytes are sampled after every step. Then the per-step checkpoint
    gather and copy, and ``fail_aw(0)`` once every request has
    ``fail_tokens`` tokens, recover, provision: bitwise. After that run's
    first step (outside its clock and counts), with 8 rows decoding: the
    seg-1 step graph against the eager step from the same state, and the
    decode step's wall time and device busy, eager and graph, the cache
    put back after them (each prefill runs eagerly: separate runs for
    these would prefill 8 prompts again). Returns the failure-free Run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    t_fam = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    print(f"reference: reduced {arch}, card kernels vs CPU plain path")
    reference_phase(torch, get_config(arch).reduced())
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, EngineConfig(
        max_batch=8, max_seq=max_seq, num_aw=2, num_ew=1), seed=0,
        device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name}, {cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec
             else f" ({' / '.join(cfg.xlstm_pattern)})")
          + f" bf16, {cfg.param_count / 1e9:.3f}B params, seeded init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab_size, size=(prompt_len,)).astype(
        np.int32) for _ in range(8)]
    frames = [rng.standard_normal((cfg.encoder_seq, cfg.d_model),
                                  dtype=np.float32)
              for _ in range(8)] if cfg.is_encdec else None
    t0 = time.perf_counter()
    Run(torch, engine, prompts[:1], 2, warm_up=True,
        frames=None if frames is None else frames[:1])
    print(f"  warm-up (one request: its prefill, an eager decode step and "
          f"the seg-1 step graph's capture): "
          f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    peak = [0]

    def note_pinned(eng, steps):
        peak[0] = max(peak[0], pinned_bytes(eng.store))
    calls0, steps0 = engine.scheduler.stats.calls, engine.steps
    run = Run(torch, engine, prompts, max_new, frames=frames,
              after_step=note_pinned)
    calls = engine.scheduler.stats.calls - calls0
    steps = engine.steps - steps0
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"{label}: bad stream {st}")
    if calls != len(prompts):
        raise AssertionError(f"{label}: {calls} prefill calls, expected one "
                             f"per request")
    if cfg.is_encdec:
        want = {"prefill": {"flash_attention": (cfg.encoder_layers +
                                                cfg.num_layers) * calls,
                            "decode_attention_fused": 0},
                "decode": {"flash_attention": 0, "decode_attention_fused":
                           cfg.num_layers * steps}}
        for phase, kernels in want.items():
            for k, n in kernels.items():
                if run.launches[phase][k] != n:
                    raise AssertionError(
                        f"{label} {phase}: {k} launched "
                        f"{run.launches[phase][k]} times, expected {n}")
        enc = [sh for (ph, sh) in run.flash if not sh.causal]
        if [(sh.b, sh.sq, sh.sk) for sh in enc] != \
                [(1, cfg.encoder_seq, cfg.encoder_seq)]:
            raise AssertionError(f"{label}: the encoder's flash calls ran at "
                                 f"{enc}, not one non-causal shape over "
                                 f"{cfg.encoder_seq} frames")
        print(f"  main path: {calls} prefill calls (each {cfg.encoder_layers}"
              f" flash launches without the causal mask over "
              f"{cfg.encoder_seq} frames + {cfg.num_layers} causal over the "
              f"{prompt_len}-token prompt; the cross attention the plain "
              f"blockwise path, as the reference's), {steps} decode steps "
              f"({cfg.num_layers} decode attention launches each)")
    else:
        ran = {k: v for ph in run.launches.values() for k, v in ph.items()
               if v}
        if ran:
            raise AssertionError(f"{label}: kernels launched on a path that "
                                 f"has none: {ran}")
        print(f"  main path: {calls} prefill calls and {steps} decode steps "
              f"in plain PyTorch (the reference's cells are plain jnp on "
              f"every backend: no kernel on this path)")
    run.report(label)
    print(f"  stream r0: {run.streams[0]}")
    slots, toks = list(range(8)), [prompt_len + 1] * 8
    leaves = engine.layout.extract_tokens(engine.cache, slots, toks)
    nbytes = sum(sum(v.nbytes for v in t) if isinstance(t, list)
                 else t.nbytes for t in leaves)
    del leaves
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks), reps=5)
    print(f"  per-step checkpoint gather + device-to-host copy (8 rows): "
          f"{ck_ms:.3f} ms, {nbytes} bytes ({nbytes // 8} per token); the "
          f"store's peak pinned bytes over the run {peak[0]} (after the "
          f"last of its {run.steps} steps, before the releases); on "
          f"{card_line()}")

    def probe(eng, steps):
        if steps != 1:
            return
        print(f"{label} graph == eager: the seg-1 step graph against the "
              f"eager step from the same state, {len(eng.active_requests())}"
              f" rows decoding")
        graph_equals_eager(torch, eng, 1, label)
        decode_step_times(torch, eng, label, reps=3, segs=(1,),
                          light=cfg.is_encdec, restore=True)
    fo, _ = aw_failover(torch, label, engine, prompts, max_new, run,
                        fail_tokens, frames=frames, after_step=probe)
    run.ck = SimpleNamespace(bytes=nbytes, ms=ck_ms, peak_pinned=peak[0],
                             install_ms=[t * 1e3 for t in fo.install_s])
    print(f"  [{label}: {time.perf_counter() - t_fam:.1f} s]")
    return run


def draw_bank(torch, g, e, rows, cols):
    """A bf16 expert bank [e, rows, cols] of N(0, 1 / rows) draws, 16
    experts at a time (Kimi-K2's whole bank in float32 would be 22.5 GB)."""
    w = torch.empty((e, rows, cols), dtype=torch.bfloat16, device="cuda")
    for i in range(0, e, 16):
        w[i:i + 16] = torch.randn((min(16, e - i), rows, cols), generator=g,
                                  device="cuda").mul_(rows ** -0.5)
    return w


def family_ffn_checks(torch, g, records, runs_by_label):
    """The expert FFN at every (P, C, D, F, path) phase 17's runs gave it,
    held to its plain versions on the model's whole bank (its placement's
    primary slots: Qwen1.5-MoE's 60 experts in 64 stored rows, Kimi-K2's
    384 rows of 5.6 G elements a tensor): slots 0-7 run the last 8 rows (Kimi's 376-383, whose offsets pass 2^31 elements) and the
    last 8 slots are their shadows with the same token rows (bitwise
    their primaries' outputs), every other slot empty (exact zeros); the
    live slots against the bf16 plain version and slots 0-7 against the
    float32 one (half a bf16 ulp + 1e-4). Then per model and path one
    record, timed at the most launched decode shape and the largest
    prefill or chunk C, on the slot experts and counts of the first call
    at that shape (``SEEN["ffn_calls"]``): a live slot computes its C
    rows, so the bound counts the live slots' rows and their distinct
    experts' weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import ert
    from repro_torch.kernels import moe_gemm as mg
    print(f"expert FFN at phase 17's (P, C, D, F, path); "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held on the "
          f"card before its banks")
    for label, arch, _, num_ew, _ in FAMILIES:
        cfg = get_config(arch)
        if not cfg.moe.enabled:
            continue
        d, f = cfg.d_model, cfg.moe.d_ff
        e = ert.default_placement(cfg.moe.num_experts, num_ew).primary_slots
        mine = sorted(k for k in SEEN["ffn"] if k[2:4] == (d, f))
        if not mine:
            raise AssertionError(f"{label}: phase 17 gave the expert FFN no "
                                 f"shape")
        bank = [draw_bank(torch, g, e, d, f) for _ in range(2)]
        wdn = draw_bank(torch, g, e, f, d)
        last = torch.arange(e - 8, e, device="cuda", dtype=torch.int32)
        for p, c, _, _, path in mine:
            se = torch.arange(p, device="cuda", dtype=torch.int32) % e
            se[:8] = se[p - 8:] = last
            live = torch.zeros(p, dtype=torch.bool, device="cuda")
            live[:8] = live[p - 8:] = True
            cnt = torch.where(live, c, 0).to(torch.int32)
            x = torch.randn((p, c, d), generator=g, device="cuda").bfloat16()
            x[p - 8:] = x[:8]
            got = mg.expert_ffn_cuda(x, bank[0], bank[1], wdn, se, cnt,
                                     decode=path == "skinny")
            if mg.last_path != path:
                raise AssertionError(f"moe_gemm at P{p} C{c} D{d} F{f} took "
                                     f"{mg.last_path}, expected {path}")
            tag = f"bf16 P{p} C{c} D{d} F{f} ({label}, {path} path)"
            idx = live.nonzero().flatten()
            check(tag, got[idx], mg.expert_ffn_plain(
                x[idx], bank[0], bank[1], wdn, se[idx], cnt[idx]),
                "bfloat16")
            check(f"{tag} slots 0-7 (rows {e - 8}-{e - 1}) vs float32 "
                  f"plain", got[:8],
                  mg.expert_ffn_plain(x[:8].float(), bank[0][e - 8:].float(),
                                      bank[1][e - 8:].float(),
                                      wdn[e - 8:].float(), se[:8] - (e - 8),
                                      cnt[:8]),
                  atol=ROUND_ATOL, rtol=ROUND_RTOL)
            if not torch.equal(got[p - 8:], got[:8]) or \
                    got[~live].float().abs().max().item():
                raise AssertionError(f"{tag}: a shadow slot differs from "
                                     f"its primary, or an empty slot is not "
                                     f"zero")
            FFN_CHECKED.add((p, c, d, f, path))
            del x, got
        print(f"  {label}: on rows {e - 8}-{e - 1} of {e}, shadow slots "
              f"bitwise their primaries, empty slots zero, at every shape")
        run = runs_by_label[label]
        timed = []
        dec = run["whole"].ffn_c.get("decode", Counter())
        if dec:
            timed.append(("decode", dec.most_common(1)[0][0]))
        pre = [k for r in run.values() for ph in ("prefill", "chunks")
               for k in r.ffn_c.get(ph, {})]
        if pre:
            timed.append(("prefill", max(pre, key=lambda k: k[1])))
        for kind, key in timed:
            p, c, _, _, path = key
            if key not in SEEN["ffn_calls"]:
                raise AssertionError(f"{label}: no call at {key} was made "
                                     f"outside a step graph's capture")
            se, cnt = SEEN["ffn_calls"][key]
            live = (cnt > 0).nonzero().flatten()
            n_live, n_exp = live.numel(), se[live].unique().numel()
            x = torch.randn((p, c, d), generator=g, device="cuda").bfloat16()

            def kern():
                return mg.expert_ffn_cuda(x, bank[0], bank[1], wdn, se, cnt,
                                          decode=path == "skinny")

            def plain():
                return mg.expert_ffn_plain(x[live], bank[0], bank[1], wdn,
                                           se[live], cnt[live])
            tag = (f"bf16 P{p} C{c} D{d} F{f} ({label} {kind}, the run's "
                   f"{n_live} live slots on {n_exp} experts)")
            err = check(tag, kern()[live], plain(), "bfloat16")
            if not kern()[cnt <= 0].eq(0).all():
                raise AssertionError(f"{tag}: an empty slot is not zero")
            plain_ms = time_ms(torch, plain)
            # in turns (kernel, chain, chain, kernel); the chain's weights,
            # the live slots' experts gathered (up to 31 GB for Kimi), are
            # made after the plain version's timing, which gathers them too
            t0 = time_ms(torch, kern)
            xa = x[live]
            wg_, wu_, wd_ = (w[se[live].long()] for w in (bank[0], bank[1],
                                                          wdn))

            def chain():
                return torch.bmm(torch.nn.functional.silu(
                    torch.bmm(xa, wg_)) * torch.bmm(xa, wu_), wd_)
            t = [t0, time_ms(torch, chain), time_ms(torch, chain),
                 time_ms(torch, kern)]
            ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            dev_ms, lib_dev_ms = graph_ms(torch, kern), graph_ms(torch, chain)
            del xa, wg_, wu_, wd_
            # each live slot's C rows read and the whole output written
            # once, each distinct expert's three matrices read once
            flops, nbytes = mg.work(p, c, d, f, n_live, n_exp)
            b_ms, b_by = bound(nbytes, flops)
            name = f"moe_gemm[{label} {kind}]"
            records.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/moe_gemm.cu",
                replaces=mg.KERNEL.replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library="bmm chain", graph_ms=dev_ms,
                library_graph_ms=lib_dev_ms,
                launches=sum(per[key] for r in run.values()
                             for per in r.ffn_c.values()),
                shape=f"P{p} ({n_live} live on {n_exp} experts, a served "
                      f"call's) C{c} D{d} F{f} bf16, "
                      f"{'decode step' if kind == 'decode' else 'prefill/chunk call'}"
                      f", {path} path"))
            print(f"  {name}: {n_live} live slots on {n_exp} experts "
                  f"({int(cnt.sum())} token rows routed); time {ms:.4f} ms "
                  f"({t[0]:.4f} / {t[3]:.4f}; in a CUDA graph {dev_ms:.4f}),"
                  f" plain {plain_ms:.4f} ms, bmm chain {lib_ms:.4f} ms (in "
                  f"a CUDA graph {lib_dev_ms:.4f}), bound {b_ms:.4f} ms "
                  f"({b_by}); {records[-1]['launches']} launches; on "
                  f"{card_line()}")
            del x
        del bank, wdn
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 19: training
# --------------------------------------------------------------------------

def tree_to(tree, device):
    """A nested dict/list of tensors, each moved to ``device``."""
    from repro_torch.convert import tree_map
    return tree_map(tree, lambda t: t.to(device))


def train_batch(torch, cfg, b, s, seed):
    """One fixed batch of ``lm_batches`` on the card; an encoder-decoder
    also gets seeded frames [B, T_enc, D]."""
    from repro_torch.data.workloads import lm_batches
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(lm_batches(cfg.vocab_size, b, s, 1, seed=seed)).items()}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model),
            generator=torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
    return batch


def train_reference_checks(torch):
    """Phase 19 (1): each reduced float32 model of TRAIN_MODELS, its loss
    and every gradient leaf on the card (its kernels in the forward pass)
    against the same model's plain path on the CPU: the loss to 1e-3
    (phase 3's bar), each leaf to 1e-3 of its largest magnitude plus
    1e-4, every leaf present on both."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training.train import leaf_paths, loss_and_grads
    for label, arch, *_ in TRAIN_MODELS:
        cfg = get_config(arch).reduced()
        gpu = get_model(cfg, num_aw=1, num_ew=2, device="cuda")
        cpu = get_model(cfg, num_aw=1, num_ew=2, device="cpu")
        params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
        batch = train_batch(torch, cfg, 2, 24, 2)
        c0 = launch_counts()
        lg, gg = loss_and_grads(gpu, params, batch, gpu.init_route_state(),
                                aux_coef=TRAIN_AUX)
        ran = delta(c0, launch_counts())
        lc, gcpu = loss_and_grads(cpu, tree_to(params, "cpu"),
                                  tree_to(batch, "cpu"),
                                  cpu.init_route_state(), aux_coef=TRAIN_AUX)
        worst, where = 0.0, None
        want = leaf_paths(gcpu)
        for k, g in leaf_paths(gg).items():
            if g is None or want[k] is None:
                raise AssertionError(f"{arch}: no gradient for {k}")
            # the floor: a leaf whose exact gradient is 0 (the key bias,
            # under softmax's shift invariance) keeps rounding noise
            scale = want[k].abs().max().item() + 1e-4
            rel = (g.cpu() - want[k]).abs().max().item() / scale
            if rel > worst:
                worst, where = rel, k
        err = abs(lg.item() - lc.item())
        need = [k for k in TRAIN_KERNELS[label] if not ran[k]]
        print(f"  {cfg.name} fp32 loss card {lg.item():.6f} CPU "
              f"{lc.item():.6f} (|diff| {err:.2e}, tol 1e-3); {len(want)} "
              f"gradient leaves, worst {worst:.2e} of the leaf's largest "
              f"magnitude + 1e-4 ({where}; tol 1e-3); forward launches "
              f"{ {k: ran[k] for k in TRAIN_KERNELS[label]} }")
        if not (err <= 1e-3 and worst <= 1e-3) or need:
            raise AssertionError(f"{arch}: training on the card disagrees "
                                 f"with the CPU (or {need} not launched)")


def grads_through(torch, fn, inputs, douts):
    """(outputs, the gradient of every floating input) of sum(out * dout)
    over ``fn(*inputs)``."""
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point()
              else t for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.float() * d).sum() for o, d in zip(outs, douts)).backward()
    return outs, [t.grad for t in leaves if t.is_floating_point()]


def function_check(torch, name, kernel, fn, plain, inputs, douts, tol):
    """``fn`` (a kernel entry point through KernelWithPlainGrad) against
    ``plain`` differentiated directly in float32 on the same inputs
    upcast: the outputs and every input's gradient within rtol ``tol``
    and atol ``tol`` times the float32 tensor's RMS (its typical
    magnitude). ``douts`` must be exact in the outputs' dtype, so that
    both sides see one cotangent. Each tensor's line gives the reading
    the bar is set from: the least atol, in units of that RMS, that would
    pass at rtol ``tol``. ``kernel`` must launch once, in the forward
    pass."""
    n = kernel.launches
    got = grads_through(torch, fn, inputs, douts)
    if kernel.launches != n + 1:
        raise AssertionError(f"{name}: {kernel.launches - n} launches")
    want = grads_through(torch, plain, [
        t.float() if t.is_floating_point() else t for t in inputs], douts)
    names = [f"out{i}" for i in range(len(got[0]))] + \
        [f"d{i}" for i in range(len(got[1]))]
    errs, bad = [], []
    for tag, a, b in zip(names, got[0] + tuple(got[1]),
                         want[0] + tuple(want[1])):
        a, b = a.detach(), b.detach()
        rms = b.square().mean().sqrt().item()
        need = ((a.float() - b).abs() - tol * b.abs()).max().item()
        try:
            errs.append(check(f"{name} {tag} (rms {rms:.3e}, atol needed "
                              f"{max(need, 0.0) / max(rms, 1e-30):.3e} rms)",
                              a, b, atol=tol * rms, rtol=tol))
        except AssertionError as e:
            bad.append(str(e))
    if bad:
        raise AssertionError("; ".join(bad))
    return max(errs)


def train_function_checks(torch, g):
    """Phase 19 (2): flash (causal, S 200: not a multiple of its tile, a
    padded tail), the expert FFN (8 slots on 4 stored experts, three of
    them shadows, one empty) and the SSD scan at Zamba2's head widths,
    each through its autograd Function: the output and every input's
    gradient against the plain version differentiated directly in
    float32 (``function_check``'s bar at bf16 2e-2, fp32 1e-4, the scan
    2e-4; the cotangents exact in the outputs' dtype), one launch each,
    in the forward pass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models.attention import blockwise_attention
    b, s, h, hkv, dh = 2, 200, 12, 2, 128
    pos = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    pos[1, s - 9:] = -1
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q = torch.randn((b, s, h, dh), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((b, s, hkv, dh), generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        dout = [torch.randn((b, s, h, dh), generator=g,
                            device="cuda").to(dtype).float()]
        function_check(
            torch, f"flash grad {str(dtype)[6:]} B{b} S{s} H{h} Hkv{hkv} "
            f"Dh{dh} causal", fa.KERNEL,
            lambda q, k, v: ops.full_attention(q, k, v, pos, pos),
            lambda q, k, v: blockwise_attention(q, k, v, pos, pos),
            [q, k, v], dout, tol)
    p, c, d, f, e = 8, 64, 256, 512, 4
    se = torch.tensor([0, 1, 2, 3, 0, 1, 0, -1], dtype=torch.int32,
                      device="cuda")
    cnt = torch.tensor([c, 9, 0, c, 5, 1, c, 0], dtype=torch.int32,
                       device="cuda")
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        x = torch.randn((p, c, d), generator=g, device="cuda").to(dtype)
        wg, wu = ((torch.randn((e, d, f), generator=g, device="cuda") *
                   d ** -0.5).to(dtype) for _ in range(2))
        wd = (torch.randn((e, f, d), generator=g, device="cuda") *
              f ** -0.5).to(dtype)
        dout = [torch.randn((p, c, d), generator=g,
                            device="cuda").to(dtype).float()]
        function_check(
            torch, f"expert FFN grad {str(dtype)[6:]} P{p} C{c} D{d} F{f}, "
            f"shadow slots", mg.KERNEL,
            lambda *w: ops.expert_ffn(*w, se, cnt, decode=False),
            lambda *w: mg.expert_ffn_plain(*w, se, cnt), [x, wg, wu, wd],
            dout, tol)
    args = scan_inputs(torch, g, 1, 128, 112, 64, 64, torch.float32)
    douts = [torch.randn((1, 128, 112, 64), generator=g, device="cuda"),
             torch.randn((1, 112, 64, 64), generator=g, device="cuda")]
    function_check(
        torch, "ssm_scan grad fp32 B1 S128 H112 P64 N64", ss.KERNEL,
        lambda *t: ops.ssm_scan(*t, chunk=64),
        lambda *t: kref.ssm_scan_chunked_ref(*t, chunk=64), args, douts,
        2e-4)


def train_model(torch, label, arch, layers, num_ew, b, s, steps):
    """Phase 19 (3): one model in bf16 with seeded weights, ``steps``
    AdamW steps (lr TRAIN_LR) on one fixed batch of ``lm_batches``, the
    steps observed as a run in phase "train": per step the forward,
    backward and optimizer times (CUDA events) and the kernels' launches
    in the forward and backward passes. Fails unless the loss is finite
    every step and lower at the last than at the first, every param leaf
    got a gradient and moved, each kernel in TRAIN_KERNELS launched in
    every forward pass and none in a backward pass (the backward is the
    plain versions), and, after ``save_params`` and ``load_params`` on
    the card, every leaf and ``forward_train``'s logits are bitwise
    equal. Returns the run's observation (its flash shapes and expert FFN
    keys) and its numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training import init_opt_state
    from repro_torch.training.checkpoint_io import load_params, save_params
    from repro_torch.training.train import (adamw_update, forward_loss,
                                            tree_leaves)
    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              num_layers=layers or get_config(arch).num_layers)
    torch.cuda.reset_peak_memory_stats()
    api = get_model(cfg, num_aw=1, num_ew=num_ew, device="cuda")
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    rs = api.init_route_state()
    batch = train_batch(torch, cfg, b, s, 1)
    opt = init_opt_state(params)
    moved = torch.zeros(len(tree_leaves(params)), dtype=torch.bool)
    losses, times, fwd, bwd = [], [], [], []
    with observed(torch, "train") as obs:
        for _ in range(steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            c0 = launch_counts()
            ev[0].record()
            with torch.enable_grad():
                loss, leaves = forward_loss(api, params, batch, rs,
                                            aux_coef=TRAIN_AUX)
                ev[1].record()
                c1 = launch_counts()
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            ev[2].record()
            c2 = launch_counts()
            if any(gr is None for gr in grads):
                raise AssertionError(f"{label}: a param leaf got no "
                                     f"gradient")
            new, opt = adamw_update(params, list(grads), opt, lr=TRAIN_LR,
                                    beta1=0.9, beta2=0.95, eps=1e-8,
                                    weight_decay=0.1, clip=1.0)
            ev[3].record()
            torch.cuda.synchronize()
            losses.append(loss.item())
            times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
            fwd.append(delta(c0, c1))
            bwd.append(delta(c1, c2))
            moved |= torch.stack([(x != y).any() for x, y in zip(
                tree_leaves(params), tree_leaves(new))]).cpu()
            params = new
            del loss, leaves, grads, new
    peak = torch.cuda.max_memory_allocated()
    for i, (loss, (tf, tb, to)) in enumerate(zip(losses, times)):
        print(f"    step {i + 1}: loss {loss:.4f}; forward {tf:.2f} ms, "
              f"backward {tb:.2f} ms, optimizer {to:.2f} ms "
              f"(step {tf + tb + to:.2f} ms)")
    kernels = TRAIN_KERNELS[label]
    print(f"    launches per step, forward: "
          f"{[{k: f[k] for k in kernels} for f in fwd]}; backward: "
          f"{[{k: bb[k] for k in kernels} for bb in bwd]}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    if not bool(moved.all()):
        raise AssertionError(f"{label}: {int((~moved).sum())} param leaves "
                             f"did not move")
    if any(not f[k] for f in fwd for k in kernels) or \
            any(bb[k] for bb in bwd for k in kernels):
        raise AssertionError(f"{label}: kernel launches forward {fwd}, "
                             f"backward {bwd}")
    # the weight checkpoint, on the card
    path = Path(__file__).resolve().parent / "build" / "train_ckpt" / \
        f"{label}.npz"
    t0 = time.perf_counter()
    save_params(str(path), params, step=steps)
    t_save = time.perf_counter() - t0
    nbytes = path.stat().st_size
    t0 = time.perf_counter()
    loaded, step = load_params(str(path), params)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    path.unlink()
    same = step == steps and all(
        torch.equal(x.view(torch.int16), y.view(torch.int16))
        for x, y in zip(tree_leaves(params), tree_leaves(loaded)))
    with torch.no_grad():
        l0 = api.forward_train(params, batch, rs)[0]
        l1 = api.forward_train(loaded, batch, rs)[0]
    if not (same and torch.equal(l0.view(torch.int16), l1.view(torch.int16))):
        raise AssertionError(f"{label}: the reloaded weights or their "
                             f"logits are not bitwise the trained ones")
    med = [statistics.median(t[i] for t in times[1:] or times)
           for i in range(3)]
    print(f"  {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{steps} steps, every one of {len(moved)} param leaves moved; "
          f"step (median of steps 2-{steps}) forward {med[0]:.2f} ms, "
          f"backward {med[1]:.2f} ms, optimizer {med[2]:.2f} ms; "
          f"peak memory {peak / 2 ** 30:.2f} GiB "
          f"({n_params / 1e9:.3f} B params); checkpoint "
          f"{nbytes / 1e9:.2f} GB saved in {t_save:.1f} s, loaded in "
          f"{t_load:.1f} s, every leaf and the logits bitwise equal; "
          f"{time.perf_counter() - t_model:.1f} s")
    del params, opt, loaded, l0, l1
    return SimpleNamespace(flash=obs.flash, ffn_c=obs.ffn_c, losses=losses,
                           times=times, fwd=fwd, peak=peak)


def train_launcher_run():
    """Phase 19 (4): ``python -m repro_torch.launch.train`` with its
    defaults (the reduced Qwen2, 50 steps, on the card), in a process of
    its own; fails unless it exits 0 with its loss improved."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"],
                         capture_output=True, text=True, timeout=600,
                         cwd=root, env=dict(os.environ,
                                            PYTHONPATH=str(root / "src")))
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print(f"    {line}")
    if out.returncode or not lines or "(improved)" not in lines[-1]:
        raise AssertionError(f"launch.train exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    print(f"  python -m repro_torch.launch.train: exit 0, "
          f"{time.perf_counter() - t0:.1f} s")


def training_phase(torch, g):
    """Phase 19. Returns each TRAIN_MODELS run by label."""
    print("training (1): reduced float32 models, loss and gradients, card "
          "kernels vs CPU plain path")
    train_reference_checks(torch)
    print("training (2): each kernel's autograd Function against its plain "
          "version differentiated directly")
    train_function_checks(torch, g)
    runs = {}
    for label, arch, layers, num_ew, b, s, steps in TRAIN_MODELS:
        print(f"training (3): {arch} at "
              f"{layers or 'all its'} layers, bf16, {num_ew} EW(s), B{b} "
              f"S{s}, {steps} AdamW steps at lr {TRAIN_LR} on one batch")
        runs[label] = train_model(torch, label, arch, layers, num_ew, b, s,
                                  steps)
        gc.collect()
        torch.cuda.empty_cache()
    print("training (4): the launcher with its defaults")
    train_launcher_run()
    return runs


def train_kernel_shapes(torch, g, records, runs):
    """The expert FFN and the SSD scan at the shapes the training runs
    gave them, held to their plain versions and timed (``moe_gemm[train]``
    and ``ssm_scan[train]``, with the training forward passes' launches);
    flash's shapes are held in the last phase."""
    ffn = runs["mixtral"].ffn_c["train"]
    (key,) = ffn
    kernel_moe_gemm(torch, g, records, [("train", key)], small=False)
    records[-1]["launches"] = ffn[key]
    (scan,) = SEEN["scan"] - SCAN_CHECKED
    kernel_ssm_scan(torch, g, records, [scan], name="ssm_scan[train]")
    records[-1]["launches"] = sum(f["ssm_scan"] for f in runs["zamba2"].fwd)


# ---------------------------------------------------------------------------
# phase 20: the launch plane
# ---------------------------------------------------------------------------
# the op count's tolerances (counted / analytic, ``roofline/analysis.py``
# against ``roofline/op_count.py`` on the same call): a decode step's
# expert FFN runs only the slots that got a token (the analytic count
# takes the 8 primaries at capacity), so its flops and bytes may come out
# below; a prefill call's projections and norms run in fixed 128-row
# blocks that each read the weights again, and its norms and activations
# are unfused, so its bytes come out above the analytic floor
OP_COUNT_BANDS = {("decode", "flops"): (0.80, 1.10),
                  ("decode", "bytes"): (0.80, 1.25),
                  ("prefill", "flops"): (0.95, 1.10),
                  ("prefill", "bytes"): (1.00, 2.50)}


def start_dryruns(root):
    """Start ``python -m repro_torch.launch.dryrun --all
    --include-paper-model`` at 16 x 16 and 2 x 16 x 16, each in a process
    of its own, side by side (host only: the fake process group needs no
    card); returns {mesh: (process, start time, log, json)}."""
    out_dir = root / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = {}
    for mesh, extra in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        log, out = out_dir / f"{mesh}.log", out_dir / f"{mesh}.json"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--include-paper-model", "--json", str(out)] + extra,
                env=env, cwd=root, stdout=f, stderr=subprocess.STDOUT)
        runs[mesh] = (proc, time.perf_counter(), log, out)
    return runs


def finish_dryruns(runs):
    """Wait for the dry runs; each must exit 0 with 37 ok, 7 skipped and
    0 errors. Returns {mesh: (results, seconds)}."""
    got = {}
    for mesh, (proc, t0, log, out) in runs.items():
        proc.wait(timeout=600)
        secs = time.perf_counter() - t0
        text = log.read_text()
        summary = [line for line in text.splitlines()
                   if line.startswith("dry-run:")]
        if proc.returncode != 0 or summary != [
                "dry-run: 37 ok, 7 skipped (documented), 0 errors"]:
            print(text[-4000:])
            raise AssertionError(f"dry run at {mesh}: exit "
                                 f"{proc.returncode}, {summary}")
        got[mesh] = (json.loads(out.read_text()), secs)
    return got


def op_count_check(torch, engine, prompts):
    """The op count of one prefill call (8 rows of 128 tokens) and one
    eager decode step of ``engine`` against ``roofline/analysis.py``'s
    count for the same config and batch: flops and bytes, each ratio held
    to OP_COUNT_BANDS. Kernel launches report their work to the counter
    (``kernels/ops.py``); the calls run inside ``observed`` so their
    kernel shapes are held to the plain versions like a run's."""
    import numpy as np
    from repro_torch.roofline.analysis import served_work
    from repro_torch.roofline.op_count import OpCounter
    api = engine.api
    toks = torch.as_tensor(np.stack(prompts), device=engine.device)
    rows, seq = toks.shape
    cap = engine.prefill_capacity(toks.numel())
    with observed(torch, "prefill") as obs:
        torch.cuda.synchronize()
        with OpCounter() as pre:
            _, cache, _ = api.prefill(engine.params, toks,
                                      engine.route_state,
                                      engine.ecfg.max_seq, capacity=cap)
        torch.cuda.synchronize()
        SEEN["phase"] = "decode"
        pos = torch.full((rows,), seq, dtype=torch.int32,
                         device=engine.device)
        nxt = toks[:, -1].contiguous()
        with OpCounter() as dec:
            api.decode(engine.params, nxt, pos, cache, engine.route_state)
        torch.cuda.synchronize()
    del cache
    want = {"prefill": served_work(engine, "prefill", rows=rows, seq=seq,
                                   capacity=cap),
            "decode": served_work(engine, "decode", rows=rows,
                                  ctx=[seq + 1] * rows)}
    for kind, c in (("prefill", pre), ("decode", dec)):
        w = want[kind]
        for what, got, ana in (("flops", c.flops, w.flops),
                               ("bytes", c.bytes, w.hbm_bytes)):
            lo, hi = OP_COUNT_BANDS[(kind, what)]
            r = got / ana
            print(f"  op count, {kind} ({rows} rows x "
                  f"{seq if kind == 'prefill' else 1}): {what} counted "
                  f"{got:.4e}, analytic {ana:.4e}, ratio {r:.4f} (band "
                  f"{lo}-{hi})")
            if not lo <= r <= hi:
                raise AssertionError(f"op count {kind} {what}: ratio {r:.4f}"
                                     f" outside [{lo}, {hi}]")
        kern = {k: [v[0], f"{v[1]:.3e}", f"{v[2]:.3e}"]
                for k, v in c.kernels.items()}
        print(f"    {kind} kernels (launches, flops, bytes): {kern}")
        print(f"    {kind} analytic by part (flops): "
              f"{ {k: f'{v:.3e}' for k, v in w.by().items() if v} }")
    return obs


def launch_phase(torch, g, records):
    """Phase 20: (a) Mixtral-8x7B widths at 8 of 32 layers, 2 AWs x 2
    EWs, 16 slots, served from params the Sharder placed on a 1x1
    ("data", "model") mesh over a 1-rank NCCL group, from their local
    shards: 8 requests of 128 + 32 tokens, failure-free and under
    fail_ew(0), bitwise the unsharded engine's streams; zero captures
    after warm-up; the launches and the peak memory; (b) the op count of
    a prefill call and an eager decode step against the analytic count;
    (c) the dry run at both production meshes in processes of their own,
    one line per case."""
    t_phase = time.perf_counter()
    # (c) runs on the host while (a) and (b) use the card
    dry = start_dryruns(Path(__file__).resolve().parent)
    try:
        served_sharded(torch, g, records)
    except BaseException:
        for proc, *_ in dry.values():
            proc.kill()
        raise
    dry = finish_dryruns(dry)
    for mesh, (results, secs) in dry.items():
        print(f"  dry run {mesh}: 37 ok, 7 skipped, 0 errors ({secs:.1f} s "
              f"in its own process); per case: dominant term, bytes per "
              f"device (H100 SXM spec figures, not measured)")
        for r in results:
            if r["status"] != "ok":
                print(f"    {r['name']}: skipped ({r['reason']})")
                continue
            print(f"    {r['name']}: {r['dominant']} (compute "
                  f"{r['compute_s'] * 1e3:.3f} ms, memory "
                  f"{r['memory_s'] * 1e3:.3f} ms, collective "
                  f"{r['collective_s'] * 1e3:.3f} ms); "
                  f"{r['mem_per_device_bytes'] / 2**30:.2f} GiB a device"
                  f"{'' if r['fits'] else ' OVER 80 GB'}")
    print(f"  launch phase wall {time.perf_counter() - t_phase:.1f} s; on "
          f"{card_line()}")


def served_sharded(torch, g, records):
    """Phase 20 (a) and (b) (``launch_phase``)."""
    import numpy as np
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.sharding import Sharder, local_shards
    from repro_torch.models import get_model
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.training.train import leaf_paths
    cfg = mixtral_8_layers()
    ecfg = EngineConfig(max_batch=8, max_seq=512, num_aw=2, num_ew=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    max_new = 32

    def fail_ew(eng, handles, steps):
        if steps == 8:
            eng.fail_ew(0)
            return []
        return None
    torch.cuda.reset_peak_memory_stats()
    plain = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    Run(torch, plain, prompts, 2, warm_up=True)
    want = Run(torch, plain, prompts, max_new)
    obs = op_count_check(torch, plain, prompts)
    want_failed = Run(torch, plain, prompts, max_new, fail=fail_ew)
    same_streams("unsharded engine under fail_ew(0)", want_failed, want)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    with lmesh.single_rank_group("cuda"):
        mesh = lmesh.make_debug_mesh((1, 1), ("data", "model"))
        sharder = Sharder(cfg, mesh)
        t0 = time.perf_counter()
        # the engine's own seeded draw, placed leaf by leaf (on a 1x1
        # mesh each DTensor wraps its leaf: no copy)
        api = get_model(cfg, num_aw=2, num_ew=2, device="cuda")
        params = sharder.shard_params(api.init_params(
            torch.Generator(device="cuda").manual_seed(0)))
        kinds = Counter(type(t).__name__ for t in
                        leaf_paths(params).values())
        engine = InferenceEngine(cfg, ecfg, params=local_shards(params),
                                 device="cuda")
        print(f"  sharded engine: {dict(kinds)} leaves placed on "
              f"{mesh}, served from their local shards "
              f"({time.perf_counter() - t0:.1f} s)")
        Run(torch, engine, prompts, 2, warm_up=True)
        reset_counts()
        run = Run(torch, engine, prompts, max_new)
        launches = {k: sum(ph[k] for ph in run.launches.values())
                    for k in ("decode_attention_fused", "flash_attention",
                              "moe_ffn")}
        failed = Run(torch, engine, prompts, max_new, fail=fail_ew)
        same_streams("sharded engine (against the unsharded one)", run,
                     want)
        same_streams("sharded engine under fail_ew(0) (against the "
                     "unsharded one)", failed, want_failed)
        print(f"  {len(run.streams)} streams of the sharded engine bitwise "
              f"the unsharded engine's, failure-free and under fail_ew(0)")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{k} was not launched by the sharded "
                                     f"engine")
        run.report("sharded")
        print(f"  sharded run launches: {launches}; step graphs "
              f"{engine.decode_plane.captures()}, none after warm-up; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del engine, params, api
        gc.collect()
    if torch.distributed.is_initialized():
        raise AssertionError("the 1-rank group outlived its phase")
    # the expert FFN at any (P, C, D, F, path) of the op-count calls that
    # no earlier check held to the plain versions
    todo = sorted({key for per_phase in obs.ffn_c.values()
                   for key in per_phase} - FFN_CHECKED)
    if todo:
        kernel_moe_gemm(torch, g, records,
                        [(f"launch-C{k[1]}-{k[4]}", k) for k in todo],
                        timed=set(), small=False)


# --------------------------------------------------------------------------
# phase 21: overlapping failures
# --------------------------------------------------------------------------

# Mixtral-8x7B widths at 8 layers, bf16, seeded weights, 2 AWs and 3 EWs
# at capacity factor 4.0 (no call drops a token); the orchestrator's T_w
# 1.0 s on a virtual clock that each sub-run drives between steps
OVERLAP_EWS = 3
OVERLAP_PROMPT, OVERLAP_NEW = 128, 32
OVERLAP_LONG = 512                 # (c): two prompts at CHUNK_BUDGET
OVERLAP_QUEUE = 24                 # (e): requests against 16 slots
# (e): AW0 fails at 0.05 s of virtual time, while 8 requests wait: no
# request can finish before it (31 decode steps after its prefill)
OVERLAP_AW_FAIL = 0.05
OVERLAP_TITLE = (
    f"overlapping failures: Mixtral-8x7B widths, 8 layers, bf16, 2 AWs x "
    f"{OVERLAP_EWS} EWs, capacity factor 4.0, T_w 1.0 s: (a) EW1 while "
    f"EW0 provisions, (b) AW0 + EW0 in one detection window, (c) the same "
    f"mid chunked prefill, (d) a cancel inside the recovery window, (e) "
    f"run_serving with {OVERLAP_QUEUE} requests against 16 slots")


class Script:
    """Timed actions between the steps of a ``Run`` (its ``after_step``,
    outside the run's clock and launch counts), and the wall time from
    an action to the next token of each request it names. Each action
    ``fn(engine, steps)`` returns None while it waits for its moment,
    else those rids. ``step`` wraps the engine's ``step()`` (patch it on
    the engine for the run): the end of the step whose output holds a
    watched rid's token (a host sync) ends its ``next_token_ms``."""

    def __init__(self, engine, *actions):
        self._step = engine.step
        self.pending = list(actions)
        self.watch, self.next_token_ms, self.at = {}, {}, []

    def step(self, now=None):
        out = self._step(now)
        t = time.perf_counter()
        for rid in [r for r in self.watch if r in out]:
            self.next_token_ms[rid] = (t - self.watch.pop(rid)) * 1e3
        return out

    def __call__(self, engine, steps):
        if not self.pending:
            return
        t0 = time.perf_counter()
        out = self.pending[0](engine, steps)
        if out is None:
            return
        self.pending.pop(0)
        self.at.append(steps)
        self.watch.update({rid: t0 for rid in out})

    def run(self, torch, engine, prompts, label):
        """The Run under this script: (Run, its wall time)."""
        t0 = time.perf_counter()
        with patched(engine, step=self.step):
            run = Run(torch, engine, prompts, OVERLAP_NEW, after_step=self)
        wall = time.perf_counter() - t0
        if self.pending:
            raise AssertionError(f"{label}: {len(self.pending)} scripted "
                                 f"action(s) never ran")
        return run, wall


def overlap_engine(cfg, params, **kw):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    return InferenceEngine(cfg, EngineConfig(**{
        "max_batch": 8, "max_seq": 256, "num_aw": 2,
        "num_ew": OVERLAP_EWS, **kw}), params=params, device="cuda")


def dual_protect(engine):
    """The layout of the reference's tests/test_compound_failures.py at 8
    experts: every shadow slot moves to EW2, which then holds a replica
    of each expert of EW0 and EW1 (in its pad slot and shadow slots), so
    EW0 and EW1 may be down at once."""
    import numpy as np
    mgr, p = engine.placement_mgr, engine.api.placement
    owner = p.slot_owner().copy()
    owner[p.primary_slots:] = 2
    guarded = [e for e in range(p.num_experts) if owner[e] in (0, 1)]
    free = [s for s in range(p.num_experts, p.num_slots) if owner[s] == 2]
    slot_expert = np.full((p.num_slots,), -1, np.int32)
    slot_expert[:p.num_experts] = np.arange(p.num_experts)
    for ex, s in zip(guarded, free):
        slot_expert[s] = ex
    plan = mgr.adopt(slot_expert, slot_owner=owner,
                     reason="dual protect ew0+ew1")
    engine.install_plan(plan)
    cand = plan.candidates()
    if not all(cand[e, 1] >= 0 and owner[cand[e, 1]] == 2
               for e in guarded):
        raise AssertionError(f"dual protection: candidates {cand.tolist()}")
    return guarded


def sub_run_line(label, launches, wall_s):
    """A sub-run's wall time and its launches of decode attention, flash
    and the expert FFN (``launches``: per phase), each of which it must
    have made on the card."""
    ran = {k: sum(ph[k] for ph in launches.values())
           for k in ("decode_attention_fused", "flash_attention",
                     "moe_ffn")}
    for k, n in ran.items():
        if n <= 0:
            raise AssertionError(f"{label}: {k} was not launched")
    print(f"  {label}: {wall_s:.2f} s wall; launches {ran}")


def overlap_phase(torch, g, records):
    """Phase 21: overlapping failures on one seeded Mixtral-8x7B (8 of 32
    layers, bf16, 2 AWs, 3 EWs, capacity factor 4.0, T_w 1.0 s), each
    sub-run's streams bitwise the same engine's failure-free run, every
    run on its step graphs with no capture after warm-up: (a) EW0 fails,
    EW1 0.3 s later while EW0's replacement provisions, on the
    dual-protected layout; (b) AW0 and EW0 in one detection window; (c)
    (b) during chunked prefill; (d) a cancel inside (b)'s recovery window;
    (e) ``run_serving`` with 24 requests against 16 slots, AW0 failed
    while the queue waits. Then the expert FFN at every new (P, C, D, F,
    path) of these runs against its plain versions. Returns (a)'s
    failure-free run, whose launches of the expert FFN by phase and
    shape (``ffn_c``) are those of the MOE_SHAPES records at P 15."""
    import numpy as np
    from repro_torch.core import selfheal
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.data.workloads import make_workload
    from repro_torch.models import get_model
    t_phase = time.perf_counter()
    cfg = mixtral_8_layers(capacity_factor=4.0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(cfg, num_aw=2, num_ew=OVERLAP_EWS,
                       device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"  seeded weights for {OVERLAP_EWS} EWs: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=(OVERLAP_PROMPT,))
               .astype(np.int32) for _ in range(8)]
    ffn_c = {}

    def keep(run):
        for ph, cnt in run.ffn_c.items():
            ffn_c.setdefault(ph, Counter()).update(cnt)

    def events(orch):
        return [(round(e.t, 4), e.kind, e.worker, e.detail)
                for e in orch.events]

    # (a) EW0, then EW1 while EW0's replacement provisions
    eng = overlap_engine(cfg, params)
    guarded = dual_protect(eng)
    keep(Run(torch, eng, prompts, 2, warm_up=True))
    want = measured = Run(torch, eng, prompts, OVERLAP_NEW)
    want.report("(a) failure-free")
    orch = Orchestrator(eng, worker_init_time=1.0, weight_push_time=0.2)
    dl = orch.detection_latency()

    def ew0(e, steps):
        if steps < 4:
            return None
        orch.inject_failure("ew", 0, now=10.0)
        orch.tick(10.0 + dl + 1e-6)
        if e.failed_ews != {0}:
            raise AssertionError(f"(a): failed EWs {e.failed_ews}")
        return []

    def ew1(e, steps):
        if steps < 8:
            return None
        orch.inject_failure("ew", 1, now=10.3)
        orch.tick(10.3 + dl + 1e-6)
        # EW0's replacement is ready at 11.03 s: still provisioning
        if e.failed_ews != {0, 1} or orch.outstanding != 2:
            raise AssertionError(f"(a): failed EWs {e.failed_ews}, "
                                 f"{orch.outstanding} outstanding")
        return []

    def ew0_back(e, steps):
        if steps < 12:
            return None
        orch.tick(11.2)
        lost = selfheal.experts_without_healthy_replica(
            e.route_state, e.api.placement)
        if e.failed_ews != {1} or lost.size:
            raise AssertionError(f"(a): after EW0's provisioning failed "
                                 f"EWs {e.failed_ews}, experts without a "
                                 f"healthy replica {lost.tolist()}")
        return []

    def ew1_back(e, steps):
        if steps < 16:
            return None
        orch.tick(11.8)
        if e.failed_ews or orch.outstanding:
            raise AssertionError(f"(a): failed EWs {e.failed_ews}, "
                                 f"{orch.outstanding} outstanding")
        return []
    script = Script(eng, ew0, ew1, ew0_back, ew1_back)
    got, wall = script.run(torch, eng, prompts, "(a)")
    same_streams("(a) streams under EW0 then EW1", got, want)
    print(f"  (a) {len(got.streams)} streams bitwise equal to the "
          f"failure-free run; EW0 and EW1 down together from step "
          f"{script.at[1]} to {script.at[2]} on the replicas of experts "
          f"{guarded} on EW2; after provisioning no expert without a "
          f"healthy replica, 0 outstanding; placement generation "
          f"{eng.placement_generation}; events {events(orch)}")
    got.report("(a) EW0 then EW1")
    sub_run_line("(a)", got.launches, wall)
    keep(want)
    keep(got)
    del eng

    # (b) AW0 and EW0 in one detection window, then (d) the same with a
    # cancel inside the recovery window, on one engine: 6 requests, so
    # AW1 has one free slot when AW0 dies
    eng = overlap_engine(cfg, params)
    six = prompts[:6]
    keep(Run(torch, eng, six, 2, warm_up=True))
    want = Run(torch, eng, six, OVERLAP_NEW)
    want.report("(b), (d) failure-free")
    keep(want)

    def aw_ew(engine, orch, t, cancel=False):
        """The (b) and (d) script on ``engine``: AW0 and EW0 fail at
        virtual time ``t`` after 4 steps (with ``cancel``, the victim
        restored at once is cancelled), both come back after 10."""
        state = {}

        def fail(e, steps):
            if steps < 4:
                return None
            victims = sorted(r.rid for r in e.requests.values()
                             if r.aw == 0 and not r.done)
            b0 = e.store.stats.bytes_restored
            orch.inject_failure("aw", 0, now=t)
            orch.inject_failure("ew", 0, now=t)
            fired = orch.tick(t + dl + 1e-6)
            if sorted(ev.kind for ev in fired if ev.kind == "detected") \
                    != ["detected", "detected"] or e.failed_aws != {0} or \
                    e.failed_ews != {0}:
                raise AssertionError(f"detection: {fired}")
            now = [rid for rid in victims if not e.requests[rid].paused]
            state.update(victims=victims, now=now, queued=e.gateway.depth(),
                         bytes=e.store.stats.bytes_restored - b0)
            if cancel:
                rid = now[0]
                if not e.cancel_request(rid, now=t + 0.1) or \
                        e.gateway.find(rid) is not None or \
                        rid in e.requests:
                    raise AssertionError(f"(d): cancel of {rid}")
                state["cancelled"] = rid
                victims = [v for v in victims if v != rid]
            return victims

        def provision(e, steps):
            if steps < 10:
                return None
            orch.tick(t + dl + 1.0 + 1e-3)
            if e.failed_aws or e.failed_ews or orch.outstanding or \
                    e.gateway.depth():
                raise AssertionError(f"provisioning: {e.failed_aws} "
                                     f"{e.failed_ews} {orch.outstanding}")
            return []
        return state, Script(engine, fail, provision)

    for label, cancel in (("(b)", False), ("(d)", True)):
        if cancel:
            # (b)'s provisioning re-pointed the shadows to EW1: protect
            # EW0 again, or its experts would have no replica in (d)
            eng.repoint_shadows(0)
        orch = Orchestrator(eng, worker_init_time=1.0)
        restores0 = eng.store.stats.restores
        state, script = aw_ew(eng, orch, 5.0, cancel)
        got, wall = script.run(torch, eng, six, label)
        keep(got)
        cancelled = state.get("cancelled")
        keep_i = [i for i in range(len(six)) if f"r{i}" != cancelled]
        bad = [i for i in keep_i if got.streams[i] != want.streams[i]]
        if bad:
            raise AssertionError(f"{label}: streams of requests {bad} "
                                 f"differ from the failure-free run "
                                 f"({state})")
        restored = eng.store.stats.restores - restores0
        if restored != len(state["victims"]) or not state["now"] or \
                not state["queued"]:
            raise AssertionError(f"{label}: {restored} restores for "
                                 f"victims {state}")
        if sum(w.slots.free_count() for w in eng.aws) != 8 or \
                eng.store._logs or eng.gateway.depth():
            raise AssertionError(f"{label}: a slot, a log or a queue "
                                 f"entry outlived the run")
        ms = script.next_token_ms
        print(f"  {label} {len(keep_i)} streams bitwise equal to the "
              f"failure-free run; AW0 held {state['victims']}: "
              f"{state['now']} restored onto AW1 at detection "
              f"({state['bytes']} bytes), {state['queued']} queued until "
              f"AW0's provisioning; {restored} restores, "
              f"{eng.store.stats.bytes_restored} bytes restored by the "
              f"engine so far"
              + (f"; {cancelled} cancelled inside the recovery window: "
                 f"every slot free, no log or queue entry left"
                 if cancel else "")
              + f"; fail_aw to the next token "
              f"{ {r: round(v, 2) for r, v in ms.items()} } ms (host "
              f"clock; the queued victims' through AW0's provisioning); "
              f"events {events(orch)}")
        if len(ms) != len(state["victims"]) - bool(cancel):
            raise AssertionError(f"{label}: victims without a next token: "
                                 f"{ms}")
        got.report(f"{label} AW0 + EW0")
        sub_run_line(label, got.launches, wall)
    del eng

    # (c) (b) during chunked prefill: both long prompts on AW1 (session
    # affinity: r0 and r1 hash there), which fails after the first chunk
    # tick with EW0
    eng = overlap_engine(cfg, params, max_seq=640,
                         chunk_token_budget=CHUNK_BUDGET,
                         placement="session_affinity")
    longs = [rng.integers(0, cfg.vocab_size, size=(OVERLAP_LONG,))
             .astype(np.int32) for _ in range(2)]
    keep(Run(torch, eng, longs, 2, warm_up=True))
    want = Run(torch, eng, longs, OVERLAP_NEW)
    want.report("(c) failure-free")
    keep(want)
    orch = Orchestrator(eng, worker_init_time=1.0)
    cursors = {}

    def mid_prefill(e, steps):
        # after the first chunk tick: r0 holds a chunk, r1 waits in the
        # stream (FIFO under the budget)
        rs = sorted(e.requests.values(), key=lambda r: r.rid)
        if not all(r.prefilling for r in rs) or \
                not any(r.prefill_cursor for r in rs):
            raise AssertionError(
                f"(c): after step {steps} (rid, cursor) "
                f"{[(r.rid, r.prefill_cursor) for r in rs]}")
        aw = {r.aw for r in rs}
        if aw != {1}:
            raise AssertionError(f"(c): the prompts are on AWs {aw}")
        cursors.update({r.rid: r.prefill_cursor for r in rs})
        orch.inject_failure("aw", 1, now=3.0)
        orch.inject_failure("ew", 0, now=3.0)
        orch.tick(3.0 + dl + 1e-6)
        return [r.rid for r in rs]

    def provision_c(e, steps):
        if steps < 8:
            return None
        orch.tick(3.0 + dl + 1.0 + 1e-3)
        if e.failed_aws or e.failed_ews or orch.outstanding:
            raise AssertionError("(c): provisioning")
        return []
    script = Script(eng, mid_prefill, provision_c)
    resumed0 = eng.chunked.stats.resumed
    got, wall = script.run(torch, eng, longs, "(c)")
    keep(got)
    same_streams("(c) streams under AW1 + EW0 mid chunked prefill", got,
                 want)
    st = eng.chunked.stats
    restored_at = {rid: st.restored_tokens.get(rid) for rid in cursors}
    if st.resumed - resumed0 != len(cursors) or restored_at != cursors:
        raise AssertionError(f"(c): resumed {st.resumed - resumed0}, "
                             f"restored prefixes {restored_at}, cursors at "
                             f"the failure {cursors}")
    ms = {r: round(v, 2) for r, v in script.next_token_ms.items()}
    print(f"  (c) {len(got.streams)} streams bitwise equal to the "
          f"failure-free run; AW1 failed with EW0 after chunk tick "
          f"{script.at[0]}, both prompts mid prefill; each resumed from "
          f"its committed cursor {cursors} on AW0; fail_aw to the first "
          f"token {ms} ms (host clock); events {events(orch)}")
    got.report("(c) AW1 + EW0 mid chunked prefill")
    sub_run_line("(c)", got.launches, wall)
    del eng

    # (e) run_serving, 24 requests at once against 16 slots, AW0 failed
    # while 8 wait
    wl = make_workload("random", rate_rps=12.0, duration=3.0, seed=6)
    if len(wl) < OVERLAP_QUEUE:
        raise AssertionError(f"(e): the workload has {len(wl)} requests")
    wl = [dataclasses.replace(w, arrival=0.0,
                              prompt_len=64 + 16 * (i % 5),
                              max_new_tokens=OVERLAP_NEW)
          for i, w in enumerate(wl[:OVERLAP_QUEUE])]
    depth_at_fail = []

    def note_depth(e):
        fail_aw = e.fail_aw

        def fail(aw):
            depth_at_fail.append(e.gateway.depth())
            fail_aw(aw)
        e.fail_aw = fail
    runs = {}
    for label, failures in (("(e) failure-free", ()),
                            ("(e) AW0 under a queue",
                             ((OVERLAP_AW_FAIL, "aw", 0),))):
        runs[label] = ServeRun(torch, cfg, params, wl, failures,
                               setup=note_depth,
                               max_batch=16, num_ew=OVERLAP_EWS)
        keep(runs[label])
    base, run = runs.values()
    if len(base.m.finished) != len(wl) or len(run.m.finished) != len(wl):
        raise AssertionError("(e): a request was lost")
    if run.m.outputs != base.m.outputs:
        bad = sorted(r for r in base.m.outputs
                     if run.m.outputs.get(r) != base.m.outputs[r])
        raise AssertionError(f"(e): streams differ for {bad}")
    if depth_at_fail != [8] or not run.victims:
        raise AssertionError(f"(e): queue depth at fail_aw(0) "
                             f"{depth_at_fail}, victims {run.victims}")
    for label, r in runs.items():
        pre, dec = r.launches["prefill"], r.launches["decode"]
        # a decode step of 16 rows has C 16: past the decode path's 8
        if pre["moe_ffn/tensor_core"] != pre["moe_ffn"] or \
                dec["moe_ffn/tensor_core"] != dec["moe_ffn"]:
            raise AssertionError(f"{label}: the expert FFN left the "
                                 f"tensor-core path: {r.launches}")
        r.report(label)
        sub_run_line(label, r.launches, r.wall_s)
    print(f"  (e) {len(wl)} streams bitwise equal to the failure-free "
          f"run, none lost; AW0 failed with {depth_at_fail[0]} requests "
          f"queued and held {len(run.victims)} ({run.victims}), restored "
          f"{len(run.restored)}; TTFT and TBT above on the run's own step "
          f"times")
    print(f"  overlapping failures: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; on {card_line()}")
    del runs, base, run, params
    gc.collect()
    torch.cuda.empty_cache()
    # the expert FFN at every (P, C, D, F, path) of these runs that no
    # earlier check held to the plain versions
    todo = sorted({key for cnt in ffn_c.values() for key in cnt}
                  - FFN_CHECKED)
    if todo:
        kernel_moe_gemm(torch, g, records,
                        [(f"overlap-C{k[1]}-{k[4]}", k) for k in todo],
                        timed=set(), small=False)
    return measured


def profile_decode(torch, engine, prompts, out_dir, chrome=True):
    """Trace 4 steady decode steps of the batch and one prefill of the
    first prompt with torch.profiler: wall time per step, device-busy
    time, and the kernels that take it. Writes the table of each to
    ``out_dir``, and with ``chrome`` the Chrome traces (the dense phases
    leave them out: a 4,088-token prefill's trace alone outgrows what a
    chip run may bring back)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import RequestSpec
    out_dir.mkdir(parents=True, exist_ok=True)
    handles = [engine.client.submit(RequestSpec(
        rid=f"p{i}", prompt=p, max_new=16)) for i, p in enumerate(prompts)]
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps = 4
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    for h in reversed(handles):
        while not h.done():
            engine.step()
        engine.release_request(h.rid)
    with profile(activities=acts) as prof_pre:
        t0 = time.perf_counter()
        h = engine.client.submit(RequestSpec(rid="pp", prompt=prompts[0],
                                             max_new=1))
        torch.cuda.synchronize()
        wall_pre = time.perf_counter() - t0
    while not h.done():
        engine.step()
    engine.release_request("pp")
    from torch.autograd import DeviceType
    for name, pr, w, n in (("decode step", prof, wall, steps),
                           (f"prefill (1 x {len(prompts[0])} tokens)",
                            prof_pre, wall_pre,
                            1)):
        ka = pr.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total", 0) or \
                getattr(e, "self_cuda_time_total", 0)
        # device-side events only (kernels, copies): an operator's own row
        # repeats the time of the kernels it launched
        kern = [e for e in ka if e.device_type == DeviceType.CUDA]
        summed = sum(dev_us(e) for e in kern) / 1e3 / n
        n_kern = sum(e.count for e in kern) / n
        # busy: the union of the device events' spans, so kernels that
        # overlap (a programmatic dependent launch starts before the
        # kernel it waits for ends) count once
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in pr.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for s0, s1 in spans:
            busy_us += max(0.0, s1 - max(s0, end))
            end = max(end, s1)
        busy = busy_us / 1e3 / n
        print(f"  profile {name}: wall {w * 1e3:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / (w * 1e3):.1f}%; the device "
              f"events' times summed: {summed:.2f} ms), {n_kern:.0f} device "
              f"ops per call")
        top = sorted(kern, key=dev_us, reverse=True)[:8]
        for e in top:
            print(f"    {dev_us(e) / 1e3 / n:8.3f} ms  x{e.count / n:5.0f}  "
                  f"{e.key[:70]}")
        tag = "decode" if n > 1 else "prefill"
        (out_dir / f"profile_{tag}.txt").write_text(ka.table(
            sort_by="self_cpu_time_total", row_limit=60))
        if chrome:
            pr.export_chrome_trace(str(out_dir / f"trace_{tag}.json"))


def readable(name: str) -> str:
    """A kernel's mangled name, demangled where c++filt exists."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except OSError:
        return name
    return out.replace("(anonymous namespace)::", "") or name


def print_ptxas(build_log, build):
    """Registers, static shared memory and spills per kernel from nvcc's
    -Xptxas=-v output: a summary per source, then every tensor-core
    kernel (the wgmma bodies of flash_attention.cu and moe_gemm.cu, the
    expert FFN's decode kernels among them), every split decode kernel
    (bf16 fused and paged, with the dynamic shared memory it launches
    with), the SSD scan's kernels and every kernel that spills or takes
    200 or more registers."""
    import re
    smem_of = build.library("decode_attention").decode_attention_split_smem
    for src, log in sorted(build_log.items()):
        entries, name, spill, smem = [], None, (0, 0), 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                m2 = re.search(r"(\d+) bytes smem", line)
                smem = int(m2.group(1)) if m2 else 0
                entries.append((name, int(m.group(1)), spill, smem))
                name = None
        if not entries:
            continue
        regs = [e[1] for e in entries]
        print(f"  {src}: {len(entries)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {sum(1 for e in entries if any(e[2]))} spill")
        for n, r, sp, sm in entries:
            name = readable(n)
            split = re.search(r"decode_split_kernel<(\d+), (\d+)", name)
            if ("_tc_kernel" in n or "moe_decode" in n or "ssm_scan" in n
                    or split or any(sp) or r >= 200):
                dyn = (f", dynamic smem {smem_of(*map(int, split.groups()))}"
                       f" bytes" if split else "")
                print(f"    {name[:110]}: {r} registers, static smem {sm} "
                      f"bytes{dyn}, spill stores/loads {sp[0]}/{sp[1]} "
                      f"bytes")


def print_hgmma(build):
    """Count the HGMMA (wgmma) instructions of each kernel in the built
    flash and expert-FFN libraries (cuobjdump -sass, where the toolkit
    has it); fail if either library has none."""
    import os
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        print(f"  HGMMA count: not measured ({tool} not in the toolkit)")
        return
    for src in ("flash_attention", "moe_gemm"):
        sass = subprocess.run([str(tool), "-sass", str(build._target(src))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        per, fn = Counter(), None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HGMMA" in line and fn:
                per[fn] += 1
        print(f"  {src}: {sum(per.values())} HGMMA instructions (cuobjdump "
              f"-sass) in {len(per)} kernels: " + ", ".join(
                  f"{readable(f)[:60]} {n}" for f, n in sorted(per.items())))
        if not per:
            raise AssertionError(f"{src}: no wgmma (HGMMA) instruction in "
                                 f"the built library")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path, default=None,
                    help="also trace decode steps and a prefill with "
                    "torch.profiler and write the traces to DIR")
    ap.add_argument("--phase", choices=("overlap",), default=None,
                    help="run only this phase after the build: overlap = "
                    "phase 21, with its expert-FFN shapes of phase 2 "
                    "and its flash shapes of phase 14")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc wall {build.build_seconds:.1f} s; each source's nvcc, all "
          f"started together: " + ", ".join(
              f"{k} {v:.1f} s" for k, v in
              sorted(build.build_source_seconds.items())) + ")")
    print_ptxas(build.build_log, build)
    print_hgmma(build)

    observe_kernel_shapes()
    records = []
    phase = Phases(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.phase == "overlap":
        return overlap_alone(torch, g, records, phase)
    kernel_decode_attention(torch, g, records)
    print("decode_attention at Zamba2's shared block (Dh 112, G 1)")
    decode_attention_at(torch, g, records, "decode_attention_fused[Dh112]",
                        8, 32, 32, 112, HYBRID_MAX_SEQ)
    kernel_decode_attention_paged(torch, g, records,
                                  "decode_attention_paged", 8, 32, 8, 128,
                                  32)
    kernel_flash_attention(torch, g)
    print("flash_attention at Zamba2's shared block (Dh 112, G 1)")
    flash_attention_at(torch, g, 1, 128, 32, 32, 112)
    kernel_flash_chunk(torch, g, 8, 512, 32, 8, 128, 128)
    kernel_dense_family(torch, g, records)
    kernel_families(torch, g, records)
    kernel_whisper(torch, g, records)
    kernel_moe_gemm(torch, g, records, MOE_SHAPES)
    kernel_ssm_scan(torch, g, records, SCAN_SHAPES)
    phase("kernels")

    import dataclasses
    from repro_torch.configs import get_config
    print("reference: reduced Mixtral, card kernels vs CPU plain path")
    reference_phase(torch, get_config("mixtral_8x7b").reduced())
    print("reference: reduced Zamba2 with a trailing block, card kernels vs "
          "CPU plain path")
    reference_phase(torch, dataclasses.replace(
        get_config("zamba2_7b").reduced(), num_layers=5))
    for arch in ("gemma2_2b", "h2o_danube_1_8b", "qwen2_1_5b"):
        print(f"reference: reduced {arch} (prompts past its 16-token "
              f"window), card kernels vs CPU plain path")
        reference_phase(torch, get_config(arch).reduced())
    for _, arch, *_ in FAMILIES:
        print(f"reference: reduced {arch}, card kernels vs CPU plain path")
        reference_phase(torch, get_config(arch).reduced())
    phase("reference")
    print("serve: Mixtral-8x7B widths, 8 layers, bf16, contiguous KV")
    engine, prompts, serve, serve_part = serve_phase(
        torch, profile_dir=args.profile)
    phase("serve + failover")
    print(f"kv plane: the same weights at capacity factor 4.0, chunked "
          f"prefill ({CHUNK_BUDGET} tokens/step), paged KV "
          f"({PAGE_TOKENS}-token pages)")
    kv = mixtral_kv_plane(torch, engine, prompts)
    whole, paged = kv["whole"], kv["paged"]
    phase("kv plane + AW failover")
    print(f"orchestrated serving: the same weights at capacity factor 4.0, "
          f"run_serving with an Orchestrator over make_workload("
          f"{ORCH_WORKLOAD}), the virtual clock on the card's step times")
    orchestrated = orchestrated_phase(torch, g, records, engine.params)
    # keep what the flash record reads: the run's telemetry plane holds
    # its engine, and so the weights, which phase 17 needs the card for
    orchestrated = SimpleNamespace(flash=orchestrated.flash)
    phase("orchestrated serving + demo twin")
    print("elastic and preemption: the same weights, num_ew 2, max_ew 3; "
          f"{ELASTIC_WORKLOAD}, scale events {ELASTIC_SCALES}, EW0 "
          f"promoted; {SLO_WORKLOAD} with and without preemption")
    elastic_phase(torch, g, records, engine.params)
    phase("elastic + preemption")
    print(f"prefix cache and telemetry: the same weights, "
          f"{PREFIX_SESSIONS} chat sessions of {PREFIX_TURNS} turns, "
          f"max_seq {PREFIX_MAX_SEQ}, chunk budget {CHUNK_BUDGET}; then "
          f"{PREFIX_WORKLOAD} at the launcher's prefix settings")
    prefix_phase(torch, g, records, engine.params)
    phase("prefix cache + telemetry")
    print(f"control plane and flight recorder: the same weights, "
          f"{CTL_WORKLOAD['kind']} with AW0 failed at "
          f"{CTL_FAILURES[0][0]} s, chunk budget {CTL_BUDGET}, paged KV, "
          f"virtual clock {CTL_CLOCK}; recorded, replayed in script and "
          f"exact mode, and run with the recorder off")
    control_phase(torch, g, records, engine.params)
    del engine
    phase("control plane + flight recorder")
    print(f"hybrid: Zamba2-7B widths, {HYBRID_LAYERS} layers, bf16, "
          f"contiguous KV + recurrent state, 2 AWs")
    hybrid = hybrid_phase(torch, profile_dir=args.profile)
    phase("hybrid + AW failover")
    from repro_torch.serving.engine import EngineConfig
    print(f"gemma2: Gemma2-2B, all 26 layers, bf16, 2 AWs, max_batch 8, "
          f"max_seq {RING_MAX_SEQ}, prompts {GEMMA2_LENS}")
    gemma2, part = dense_ring_phase(
        torch, "gemma2", dataclasses.replace(get_config("gemma2_2b"),
                                             dtype="bfloat16"),
        EngineConfig(max_batch=8, max_seq=RING_MAX_SEQ, num_aw=2, num_ew=1),
        GEMMA2_LENS, partials=True, seg8=True, profile_dir=args.profile)
    phase("gemma2 + partials + AW failover")
    print(f"danube: H2O-Danube-1.8B, all 24 layers, bf16, 2 AWs, max_batch "
          f"4, max_seq {RING_MAX_SEQ}, prompts {DANUBE_LENS}")
    danube, _ = dense_ring_phase(
        torch, "danube", dataclasses.replace(get_config("h2o_danube_1_8b"),
                                             dtype="bfloat16"),
        EngineConfig(max_batch=4, max_seq=RING_MAX_SEQ, num_aw=2, num_ew=1),
        DANUBE_LENS, profile_dir=args.profile)
    phase("danube + AW failover")
    print(f"qwen2: Qwen2-1.5B, all 28 layers, bf16, 2 AWs, max_batch 8, "
          f"max_seq {QWEN2_MAX_SEQ}")
    qwen2 = qwen2_phase(torch, profile_dir=args.profile)
    phase("qwen2 + AW failover")
    fam = {}
    for label, arch, layers, num_ew, kv_plane in FAMILIES:
        print(f"{label}: {arch} at {layers} layers, bf16, 2 AWs, {num_ew} "
              f"EWs, {FAMILY_PROMPT}-token prompts"
              + (f", whole-prompt, chunked ({CHUNK_BUDGET} tokens/step) and "
                 f"paged ({PAGE_TOKENS}-token pages)" if kv_plane else ""))
        fam[label] = family_phase(torch, label, arch, layers, num_ew,
                                  kv_plane)
        gc.collect()
        torch.cuda.empty_cache()
    phase("MoE and dense families")
    family_ffn_checks(torch, g, records, fam)
    phase("families' expert FFN shapes")
    rec = {}
    for label, arch, prompt_len, max_new, fail_tokens, max_seq in \
            RECURRENT_FAMILIES:
        print(f"{label}: {arch} whole, bf16, 2 AWs, 1 EW, 8 requests of "
              f"{prompt_len} prompt tokens + {max_new} new, max_seq "
              f"{max_seq}, fail_aw(0) once every request has {fail_tokens} "
              f"tokens")
        rec[label] = recurrent_family_phase(torch, label, arch, prompt_len,
                                            max_new, fail_tokens, max_seq)
        gc.collect()
        torch.cuda.empty_cache()
    phase("recurrent and encoder-decoder families")
    print(f"training: {', '.join(m[1] for m in TRAIN_MODELS)} in bf16, "
          f"AdamW at lr {TRAIN_LR}; the reduced models in float32 against "
          f"the CPU; the launcher")
    train = training_phase(torch, g)
    phase("training")
    train_kernel_shapes(torch, g, records, train)
    phase("training's kernel shapes")
    print("launch plane: Mixtral-8x7B widths, 8 layers, bf16, params placed "
          "by the Sharder on a 1x1 mesh over a 1-rank NCCL group; the op "
          "count against the analytic count; the dry run at 16x16 and "
          "2x16x16")
    launch_phase(torch, g, records)
    phase("launch plane")
    print(OVERLAP_TITLE)
    overlap = overlap_phase(torch, g, records)
    phase("overlapping failures")
    errs = served_flash_phase(torch, g)
    for name, run, ph, window in (
            ("flash_attention", serve, "prefill", None),
            ("flash_attention[Dh112]", hybrid, "prefill", None),
            ("flash_attention[chunk]", paged, "chunks", None),
            ("flash_attention[orchestrated]", orchestrated, "prefill", None),
            ("flash_attention[gemma2 local]", gemma2, "prefill", True),
            ("flash_attention[gemma2 global]", gemma2, "prefill", False),
            ("flash_attention[danube]", danube, "prefill", None),
            ("flash_attention[qwen2 prefill]", qwen2["whole"], "prefill",
             None),
            ("flash_attention[qwen2 chunk]", qwen2["paged"], "chunks",
             None)) + tuple(
            (f"flash_attention[{label}]", fam[label]["whole"], "prefill",
             None) for label, *_ in FAMILIES) + tuple(
            (f"flash_attention[{label} chunk]", fam[label]["paged"],
             "chunks", None) for label, *_, kv_plane in FAMILIES
            if kv_plane):
        flash_record(torch, g, records, name, run, ph, errs, window=window)
    for name, causal in (("flash_attention[whisper encoder]", False),
                         ("flash_attention[whisper prompt]", True)):
        flash_record(torch, g, records, name, rec["whisper"], "prefill",
                     errs, causal=causal)
    for label in ("qwen2", "mixtral", "zamba2", "whisper"):
        flash_record(torch, g, records, f"flash_attention[train {label}]",
                     train[label], "train", errs,
                     causal=False if label == "whisper" else None)
    phase("flash at the served shapes")

    if not set(SEEN["ffn"]) <= FFN_CHECKED:
        raise AssertionError(f"the expert FFN ran at "
                             f"{sorted(set(SEEN['ffn']) - FFN_CHECKED)}, "
                             f"which was not held to its plain version")
    print(f"expert FFN (P, C, D, F, path) on every run: "
          f"{sorted(SEEN['ffn'])}, each held to its plain version (the "
          f"kernel phase's MOE_SHAPES, the later phases' new shapes and "
          f"family_ffn_checks)")
    if not SEEN["scan"] <= SCAN_CHECKED:
        raise AssertionError(f"the SSD scan ran at (B, S) "
                             f"{sorted(SEEN['scan'] - SCAN_CHECKED)}, "
                             f"which no check held to its plain version")
    print(f"ssm_scan (B, S) on every run: {sorted(SEEN['scan'])}, each held "
          f"to its plain version (the kernel phase's SCAN_SHAPES, the "
          f"training shape after phase 19)")
    ran = {k[:3] for k in SEEN["attn"]}
    if not ran <= CHECKED:
        raise AssertionError(f"the attention kernels ran at (kernel, Dh, G) "
                             f"{sorted(ran - CHECKED)}, which the kernel "
                             f"phase did not hold to the plain versions")
    print(f"attention (kernel, Dh, G) on every run: {sorted(ran)}, each "
          f"held to its plain version in the kernel phase")
    if set(SEEN["flash"]) - FLASH_CHECKED:
        raise AssertionError(f"the flash kernel ran at shapes "
                             f"{sorted(set(SEEN['flash']) - FLASH_CHECKED)}"
                             f", which were not held to the plain version")
    print(f"flash_attention: all {len(SEEN['flash'])} shapes of the runs "
          f"held to the plain version on their recorded positions")

    def total(run, k):
        return sum(ph[k] for ph in run.launches.values())

    def ffn_launches(run, key):
        return sum(cnt[key] for cnt in run.ffn_c.values())

    def attn(run, kernel, window):
        return sum(n for k, n in run.attn.items()
                   if k[0] == kernel and k[3] == window)
    runs = {"serve": serve, "whole": whole, "paged": paged,
            "overlap": overlap}
    moe_run = {"decode": "serve", "prefill": "serve", "prefill-kv": "whole",
               "decode-3ew": "overlap", "prefill-3ew": "overlap"}
    launches = {
        "decode_attention_fused": total(serve, "decode_attention_fused"),
        "decode_attention_fused[Dh112]":
            total(hybrid, "decode_attention_fused"),
        "decode_attention_paged": total(paged, "decode_attention_paged"),
        "ssm_scan": total(hybrid, "ssm_scan"),
        "decode_attention_fused[gemma2 local]":
            attn(gemma2, "decode_attention_fused", True),
        "decode_attention_fused[gemma2 global]":
            attn(gemma2, "decode_attention_fused", False),
        "decode_attention_partial[mixtral]": serve_part.get("mixtral", 0),
        "decode_attention_partial[gemma2 local]": part.get("local", 0),
        "decode_attention_partial[gemma2 global]": part.get("global", 0),
        "decode_attention_fused[danube]":
            total(danube, "decode_attention_fused"),
        "decode_attention_fused[qwen2]":
            total(qwen2["whole"], "decode_attention_fused"),
        "decode_attention_paged[qwen2]":
            total(qwen2["paged"], "decode_attention_paged"),
    }
    launches["decode_attention_fused[whisper]"] = total(
        rec["whisper"], "decode_attention_fused")
    for label, *_, kv_plane in FAMILIES:
        launches[f"decode_attention_fused[{label}]"] = total(
            fam[label]["whole"], "decode_attention_fused")
        if kv_plane:
            launches[f"decode_attention_paged[{label}]"] = total(
                fam[label]["paged"], "decode_attention_paged")
    for label, key in MOE_SHAPES:
        launches[f"moe_gemm[{label}]"] = ffn_launches(
            runs[moe_run.get(label, "paged")], key)
    for r in records:
        r.setdefault("launches", launches.get(r["name"], 0))
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its "
                                 f"path")
    if not any(r["name"].startswith("decode_attention_partial")
               for r in records):
        raise AssertionError("decode_attention_partial has no record")
    phase.report()
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def overlap_alone(torch, g, records, phase):
    """``--phase overlap``: phase 21 alone, with the checks of its kernel
    shapes (its MOE_SHAPES entries first, its flash shapes after); no
    JSON lines."""
    kernel_moe_gemm(torch, g, records,
                    [s for s in MOE_SHAPES if s[0].endswith("-3ew")])
    phase("kernels (phase 21's expert FFN shapes)")
    print(OVERLAP_TITLE)
    overlap_phase(torch, g, records)
    phase("overlapping failures")
    served_flash_phase(torch, g)
    phase("flash at the served shapes")
    if not set(SEEN["ffn"]) <= FFN_CHECKED:
        raise AssertionError(f"the expert FFN ran at "
                             f"{sorted(set(SEEN['ffn']) - FFN_CHECKED)}, "
                             f"which was not held to its plain version")
    phase.report()
    print(card_line())
    return 0


class Phases:
    """Wall time of each phase (host clock through a device sync),
    printed as each ends and together at the end; releases what the
    phase's engines held on the card."""

    def __init__(self, torch):
        self.torch = torch
        self.t = time.perf_counter()
        self.done = []

    def __call__(self, name):
        gc.collect()                 # the engines hold reference cycles
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        print(f"[phase {name}: {now - self.t:.1f} s]")
        self.t = now

    def report(self):
        print("phase wall times: " + ", ".join(
            f"{n} {t:.1f} s" for n, t in self.done))


if __name__ == "__main__":
    sys.exit(main())
