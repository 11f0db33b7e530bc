#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit; no phase is caught):

0. Device: print the card's name and power limit (``nvidia-smi``), turn
   TF32 off for fp32 matmuls and convolutions.
1. Build: compile every kernel under ``paddle_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a into ``build/paddle_tpu_torch`` (git-ignored), one
   ``nvcc`` per source started together; print the build seconds and the
   ``-Xptxas -v`` register/shared-memory lines.
2. Serving kernels against their plain PyTorch versions on the card, at
   the shapes the serving paths give them: ragged paged attention (fp32/
   bf16 and int8 pools; for bf16 q the tensor-core kernel over the host
   work list the mixed step builds: the all-decode step, the mixed step,
   GQA at head dims 128 and 96, and poisoned odd packs at block sizes 5
   and 16 and head dims 64, 80 and 112), paged decode attention (fp32/
   bf16 and int8, head dims 32 to 128 with 80 and 112, GQA 32/8 and
   28/4, block sizes 5 to 128, 8 slots at kv 1024 and 4096, 32 at 2048;
   two calls bitwise equal), #5 at the speculative verify shape (8 spans
   of 3 tokens at kv 1024), each source's generic kernel at the shapes
   the fast kernels do not take (``GENERIC_RAGGED``, ``GENERIC_DECODE``:
   head dims 100 and 256 at GQA and MQA, 64 query heads over one kv
   head, #5's int8 pools at block size 128, #7 at block size 256; bf16
   and int8 pools), the RoPE + QKV epilogue; one JSON line per
   kernel and shape with
   the error, its tolerance, the kernel's and the plain version's times
   (CUDA events), the roofline bound and the library time (null: no
   single PyTorch call computes any of them).  For int8 pools the
   tolerance is per element (:func:`int8_tolerance`) and must reject
   planted faults: the kernel run without each sequence's last key or
   last page, the int8 math with p left unquantized, and the dequantizing
   reference.  Then RMSNorm (kernel #4) against its plain version at the
   layerwise 7B shape (4096 rows x 4096) in bf16 and fp32, one row, 4097
   rows, hidden sizes 5120 and 8192 and sizes that are not a multiple of
   the 16-byte vector (:func:`check_rms_norm`, random weight, row scales
   from 10^-3.5 to 10), with ``torch.nn.functional.rms_norm``'s time; its
   tolerance (:func:`rms_tolerance`) must reject the kernel run without
   the weight and without ``eps``.  The same for #4's layerwise variant
   (rounded before the weight, as the reference's layerwise norm) at the
   7B shape, which the layerwise step runs; in bf16 it is held bitwise to
   its plain version except near a bf16 rounding midpoint, a rule that
   must reject #4's own rounding point.  Then the weight dequant
   (``dequant_int8``, :func:`check_dequant`) bitwise against its plain
   version at a 7B decoder layer's seven projections in one launch, at the
   7B LM head and at ``[37, 100]``, in bf16 and fp32, with a planted wrong
   scale that the check must reject; timed against its bound and the
   three-op torch expression.  Times are device time (:func:`time_ms`).
3. The serving slice at full width: a random-weight Llama-2-7B (bf16),
   built once, serves 8 requests with prompts of 64..1024 tokens, 32 new
   tokens each, admitted 4 + 4 so that prefill chunks ride with running
   decodes, through five engines: the mixed step; the split engine with
   bucketed, chunked prefill (chunks of 256); the split engine with the
   dense prefill; and both engines over int8 pools.  Each run's launch
   counts must be exact for its engine (the mixed step: ragged attention
   and epilogue once per layer per step; the split engine: decode
   attention once per layer per decode step, the epilogue once per layer
   per decode step and prefill chunk; int8 pools: the int8 variants and
   the epilogue with amaxes; nothing else), the pool whole afterwards,
   every token in the vocabulary, and the int8 pools must hold >= 1.9x
   the pages per byte of the bf16 pools, scales counted.  Token matches
   against the eager ``generate`` and between engines are reported, not
   asserted (random bf16 logits can tie).  The mixed engine serves the
   traffic ``SERVE_REPEATS`` times: its wall is the median, with the
   spread of the runs and of their steps' host seconds.  The mixed and
   split runs (and the split run over int8 pools) are profiled once more
   under ``torch.profiler`` (device activity): device time by kernel
   kind and the device's idle share.  Then the sampling and speculative
   engines on the same model and traffic (:func:`serve_sampled_and_spec`:
   the mixed and split engines with ``sampling=True``, the mixed engine
   with an 8-layer truncated draft and ``spec_k`` 2, greedy and sampled;
   sampled requests at temperature 0.8, top-k 50, top-p 0.95, seed 1 + i,
   every fourth greedy): exact launches of the target and the draft,
   pools whole, each sampled engine's replay of the traffic identical;
   the draft tokens proposed and accepted reported, and one sampling
   draw's device operations counted.  Then the prefix cache
   (:func:`serve_prefix`): chat turns under one 768-token system prompt
   (request 0 alone, then fifteen at once) through the mixed prefix
   engine, the same engine without the cache, the split prefix engine and
   the int8-pool prefix engine: launches exact, pools whole (every cached
   page held once, by the table), the system prompt's pages bitwise
   unwritten after they were published, every later turn a 768-token hit,
   768 + the suffixes prefilled (16 x 768 + the suffixes without the
   cache), and the warm TTFT strictly below a cold one of the same length;
   four sampled generations of one prompt sharing its prefill (hits of
   511, served twice, identical); and two tenants' waves through a small
   pool with a 1 GiB host tier against a resident pool (spills, restores
   and their batched copies as predicted, streams byte-identical, steps
   equal).  Before the prefix cache, int8 weights (:func:`serve_w8`): the
   mixed and split engines with ``weight_quant="int8"`` (launches exact,
   ``dequant_int8`` (L + 1) times a target step, pools whole), each
   against its dequantized twin (the same engine without
   ``weight_quant`` on a copy of the model holding the dequantized
   weights) at >= 0.98; then the disaggregated router
   (:func:`serve_disagg`): one ``ServingRouter`` over a ``role="prefill"``
   mixed engine and a ``role="decode"`` split engine sharing the model,
   every request prefilled on the first and decoded on the second after a
   page migration, the decode engine prefilling nothing, one
   device-to-host and one host-to-device copy a migration, the bytes moved
   the pages moved times 8 MiB, launches exact on both engines, every
   span chain valid and both pools whole.  The mixed engine's
   ``efficiency_stats(compute=True)`` gives the serving-step MFU at its
   tokens/s against 989 TFLOP/s, which must lie in (0, 1].  Then the
   elastic drill (:func:`serve_elastic`): three mixed engines of 320
   pages on the model, two behind a ``capacity=`` router and one the
   standby of an ``ElasticController``: an overload wave, idle steps, a
   forced drain; the controller must actuate a scale_up and a scale_down,
   the drain's fates all ``"migrated"``, no prompt token prefilled
   twice, every request at its budget, pools whole, launches exact.
   Then the multi-process fleet (:func:`serve_fleet`): the same prefill
   and decode engines in two ``EngineProcess`` servers (``python -m
   paddle_tpu_torch.inference.engine_server``, each building the 7B
   model from ``SEED``) behind one ``ServingRouter(capacity=True)`` of
   remote clients (``RemoteEngineClient``): streams byte-identical to
   the in-process disaggregated run's, every request prefill -> decode,
   0 tokens prefilled on the decode process, one frame each way a migration
   carrying its pages (bytes = pages x 8 MiB), each server's launches
   exact by its exit record, span chains valid, both pools whole; the
   RPC latency digests, migration seconds over the socket, spawn + warm
   seconds, peak memory per process and the capacity plan reported; the
   traffic once more under ``torch.profiler`` in this process, whose
   chrome trace merged with the request spans must validate.  Last, the
   generic kernels' serving path (:func:`serve_head_dim_256`): a 2-layer
   model at head dim 256 through both engines and both pool types, with
   the generic kernels' launches exact.
4. Serving parity at full width and reduced depth: the same model with 2
   layers in fp32 and the same traffic; the mixed and split engines must
   match the eager ``generate`` (which runs no kernel) and each other at a
   mean per-request rate of at least 0.98, counted up to each request's
   first divergence, and each engine over int8 pools must match itself
   run through the plain int8 versions on the card at 0.98.  Its match
   against its fp32-pool run is reported (see :func:`phase_parity_2l`).
   The greedy speculative engine (a 1-layer draft) must match the greedy
   mixed engine, and it and the sampled mixed engine must each match
   themselves run through the plain versions, at 0.98; a damped pair
   (the target's second layer's ``o_proj`` and ``down_proj`` scaled by
   0.1) must accept a full chain of ``spec_k`` drafts at least once.  The
   mixed and split prefix engines and the host tier must match the same
   engine without the cache, the mixed, split and int8-pool prefix
   engines themselves run through the plain versions, and each of four
   sampled generations a solo request with its seed, at 0.98; the
   int8-pool prefix engine against its cold twin is reported, with how
   the twin's own int8 pages of the system prompt differ from the
   published ones (:func:`prefix_parity`).  The w8 mixed and split engines
   must match their dequantized fp32 twins and themselves run through the
   plain versions of the dequant and the attention, requests moved
   mid-decode to a second engine (:func:`migrated_midway`, fp32 and int8
   pools) the uninterrupted run, and the disaggregated router's streams
   the mixed engine's, each at 0.98.  The fleet drills
   (:func:`fleet_drills_2l`) on two server processes of this model and a
   third whose RPC plane hangs: a router over the processes byte-identical
   to the same router over in-process engines, a cross-socket
   ``extract_request`` -> ``inject_request`` continuation, the hung
   server drained by its deadline with no request dropped, and kill -9 of
   one process mid-decode: no request dropped, every one at its budget,
   ``engine_lost`` counted, the survivor's pool whole, the untouched
   streams at 0.98.
   Then the first step's
   logits against the eager forward by depth and dtype: fp32 at all 32
   layers (held to 1e-3) and bf16 at 2 layers.
5. The three flash kernels (forward, one-pass backward, two-kernel
   backward) against their plain versions over fp32/bf16, head dims 32,
   64, 96 and 128 (36, 80, 100 and 112 padded per half by the wrappers),
   causal
   or not, rope on and off, rectangular shapes,
   rows that see nothing and sequences of 1 and 65 tokens
   (``FLASH_CASES``), each within :func:`flash_tolerance` against the
   plain version of its own form (the backward forms round at the
   reference's points, which differ); the one-pass backward called twice
   must give bitwise-equal dq, dk and dv at the 7B shape in both dtypes,
   with rows that see nothing and on a rectangular causal case
   (``FLASH_DETERMINISM``); timed, with the achieved TFLOP/s, the bound
   and ``scaled_dot_product_attention``'s time, at the 7B training shape
   and at 16k.  In bf16 at head dims 64 and 128 all three are the
   tensor-core kernels of ``csrc/flash_attention_sm90.cu``; the rest run
   on the CUDA cores (``csrc/flash_attention.cu``).
6. Training at full width and depth: Llama-2-7B bf16 through
   ``TrainStep`` (AdamW with bf16 moments, recompute, clip 1.0, batch
   2 x 2048), a warm-up and 4 timed steps: finite losses, the first near
   its random-init value, exact flash launch counts; tokens/s, MFU, peak
   memory, then one step under ``torch.profiler``.
7. Training parity: Llama-2-7B widths at 2 layers in fp32, 3 steps
   through the kernels against the same steps through the plain flash
   versions on the card (loss trajectories within 1e-4).
8. Long context: CodeLlama-7B's config at 2 layers, bf16, batch 1 x
   16384, 2 steps: the router must take the two-kernel backward (once
   per layer per step) and never the fused one.
9. Layerwise training at full width and depth (``bench.py``'s headline
   line): Llama-2-7B bf16 through ``LlamaLayerwiseTrainStep`` with
   ``Adafactor(1e-3)``, batch 2 x 2048, a warm-up and 4 timed steps:
   finite losses, the first near its random-init value, exact launch
   counts (flash forward 2L, fused backward L, two-kernel backward 0 and
   RMSNorm 4L + 1 per step), peak memory below 24 GB; tokens/s, MFU and
   one profiled step.
10. Layerwise parity: Llama-2-7B widths at 2 layers in fp32, 3 steps from
   the same weights through the kernels, through their plain versions on
   the card (losses within 1e-4 relative), and through ``TrainStep`` with
   ``Adafactor`` (within 5e-4, the reference's own bound).
11. Before the last line, one JSON object with every kernel variant's
   numbers; the last line is ``{"ok": true, "device": {...}}``.

Each phase prints its wall seconds.

    python3 chip_smoke.py --timing-of DIR

times the kernels of the checkout at ``DIR`` by both timing methods
(:func:`timing_of`), to hold two commits' kernel times on one
yardstick.

    python3 chip_smoke.py --profile-prefix

profiles the 7B chat traffic with and without the prefix cache
(:func:`profile_prefix`): the device time the cache saves.

The script imports nothing of JAX and nothing of ``paddle_tpu``.  Without
a CUDA card it exits nonzero before printing any result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12,    # fp32 outside the tensor cores
              "int8": 1979e12}     # dense tensor-core int8 rate

RAGGED_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
ROPE_SOURCE = "paddle_tpu_torch/csrc/rope_qkv.cu"
DECODE_SOURCE = "paddle_tpu_torch/csrc/paged_decode_attention.cu"
RAGGED_REPLACES = "paddle_tpu/ops/pallas_kernels.py:1443"
ROPE_REPLACES = "paddle_tpu/ops/pallas_kernels.py:1779"
DECODE_REPLACES = "paddle_tpu/ops/paged_attention.py:936"
RMS_SOURCE = "paddle_tpu_torch/csrc/rms_norm.cu"
RMS_REPLACES = "paddle_tpu/ops/pallas_kernels.py:1078"
# the weight dequant replaces no Pallas kernel: the reference's compiled
# steps trace this expression and XLA fuses it into the matmuls
DEQUANT_SOURCE = "paddle_tpu_torch/csrc/dequant_int8.cu"
DEQUANT_REPLACES = "paddle_tpu/quantization/functional.py:189"
NO_LIBRARY = ("no single PyTorch call computes it: %s")

# served traffic (phases 3 and 4)
PROMPT_LENS = (64, 1024, 200, 768, 128, 512, 900, 320)
NEW_TOKENS = 32
ENGINE_BASE = dict(max_batch_size=8, block_size=16, num_blocks=640,
                   max_seq_len=1088, prefill_chunk_size=256)
ENGINE_KW = dict(ENGINE_BASE, mixed_step=True)           # the mixed engine
SPLIT_KW = dict(ENGINE_BASE, mixed_step=False, prefill_buckets="auto")
DENSE_KW = dict(ENGINE_BASE, mixed_step=False, prefill_buckets=None)
# int8 weights (per-channel PTQ, dequantized on use)
W8_KW = dict(ENGINE_KW, weight_quant="int8")
SPLIT_W8_KW = dict(SPLIT_KW, weight_quant="int8")
# disaggregated serving: a mixed prefill engine and a split decode engine
# behind one router, sharing the model
DISAGG_PREFILL_KW = dict(ENGINE_KW, num_blocks=320, role="prefill")
DISAGG_DECODE_KW = dict(SPLIT_KW, max_batch_size=8, num_blocks=640,
                        role="decode")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# device cycles of the sleep the timed calls queue behind (~11 ms); grown
# when the host takes longer to queue the calls
TIMING_SLEEP_CYCLES = 20_000_000


def time_ms(fn, iters: int, warmup: int = 3, queued: bool = True) -> float:
    """Mean milliseconds of ``fn`` by CUDA events over ``iters`` calls
    after ``warmup`` calls: device time.  The calls are queued behind a
    device-side sleep, so that the host has enqueued them all before the
    device starts the first; the events then time the device's work back
    to back, not the wrappers' host time (which a kernel of tens of
    microseconds would otherwise wait on).  If the host took longer to
    queue them than the device slept, the run is repeated with a longer
    sleep; a function that waits for the device itself (a plain version
    that reads lengths back) returns only after the sleep, and is timed
    as it runs, its host time included.  ``queued=False`` is the earlier
    timing: the calls issued onto an idle device, so each call's time
    is the larger of its device time and its wrapper's host time
    (``python3 chip_smoke.py --timing-of DIR`` gives both for a tree)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = TIMING_SLEEP_CYCLES if queued else 0
    for _ in range(3):
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        if cycles:
            torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        fn()
        first_ms = 1e3 * (time.perf_counter() - t0)
        for _ in range(iters - 1):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        sleep_ms = slept.elapsed_time(start)
        if not queued or host_ms < sleep_ms or first_ms >= sleep_ms:
            break
        cycles = int(cycles * 2 * host_ms / sleep_ms)
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for the dtype."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


# ---------------------------------------------------------------------------
# phase 0-1
# ---------------------------------------------------------------------------
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from paddle_tpu_torch import _build
    t0 = time.perf_counter()
    built = _build.build()
    print("build: %d kernels in %.2f s (wall, parallel nvcc)"
          % (len(built), time.perf_counter() - t0), flush=True)
    for name, b in sorted(built.items()):
        print("build %s: %.2f s -> %s" % (name, b.seconds, b.path))
        for line in b.ptxas.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print("  ptxas %s: %s" % (name, line.strip()))
    sys.stdout.flush()
    return built


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _ragged_case(spans, T, H, Hkv, D, bs, dtype, gen, poison=False,
                 n_pad_spans=0):
    """Build one ragged pack on ``gen``'s device: ``spans`` = [(q_len,
    kv_len)], distinct pages per span, unused table entries -> a poison
    page (NaN when ``poison``), padding spans as the engine writes them
    (q_offset T, q_len 0, kv_len 1, all-sink tables)."""
    import torch
    dev = gen.device
    W = max(-(-kv // bs) for _, kv in spans)
    n_used = sum(-(-kv // bs) for _, kv in spans)
    phys = n_used + 2                        # + poison page + sink page
    poison_page, sink = n_used, n_used + 1
    kc = torch.randn(phys, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    vc = torch.randn(phys, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    if poison:
        kc[poison_page] = float("nan")
        vc[poison_page] = float("nan")
    S = len(spans) + n_pad_spans
    bt = np.full((S, W), poison_page, np.int32)
    q_off = np.full((S,), T, np.int32)
    q_len = np.zeros((S,), np.int32)
    kv_len = np.ones((S,), np.int32)
    page, off = 0, 0
    for s, (ql, kvl) in enumerate(spans):
        n = -(-kvl // bs)
        bt[s, :n] = np.arange(page, page + n)
        page += n
        q_off[s], q_len[s], kv_len[s] = off, ql, kvl
        off += ql
    bt[len(spans):] = sink                   # padding spans: all-sink
    q = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, kc, vc, as_dev(bt), as_dev(q_off), as_dev(q_len),
            as_dev(kv_len))


def _ragged_work(spans, H, Hkv, D, bs, T, table_ints, itemsize,
                 pool_itemsize=None):
    """Bytes (each input read once, the output written once) and
    operations this pack needs: 4 per visible (query head, key, dim).
    ``table_ints`` counts the int32 table entries; int8 pools
    (``pool_itemsize`` 1) also read each used page's two fp32 scales."""
    pool_itemsize = pool_itemsize or itemsize
    rows = sum(ql for ql, _ in spans)
    kv_bytes = sum(kvl for _, kvl in spans) * Hkv * D * pool_itemsize * 2
    if pool_itemsize == 1:
        kv_bytes += sum(-(-kvl // bs) for _, kvl in spans) * Hkv * 4 * 2
    n_bytes = (rows * H * D * itemsize + kv_bytes + T * H * D * itemsize
               + table_ints * 4)
    pairs = sum(sum(kvl - ql + r + 1 for r in range(ql))
                for ql, kvl in spans)
    return n_bytes, 4.0 * pairs * H * D


def ragged_tolerance(want) -> float:
    """The kernel's allowed max abs error against the plain version's
    output ``want`` (same dtype as the pools)."""
    import torch
    if want.dtype == torch.float32:
        # fp32 pools: only the summation order differs (online vs
        # two-pass softmax, blocked dot products)
        return 1e-5
    # bf16: both compute in fp32 and round once to bf16, so they may differ
    # by one bf16 ulp where the fp32 values straddle a rounding boundary.
    # 2^-7 of the largest output magnitude lies between one and two ulps
    # of that output (8 significant bits), so it bounds every row's ulp.
    return 2.0 ** -7 * want.float().abs().max().item()


def _quantize_pools(kc, vc, poison_page=None):
    """int8 codes and per-page, per-head absmax scales [phys, Hkv] of
    random fp pools (the scales of ``poison_page`` set to NaN: the kernels
    must never read them).  Returns ``(kc8, vc8, key_scale, value_scale,
    vmax)``, ``vmax`` the largest dequantized |v| of the other pages."""
    import torch
    from paddle_tpu_torch.ops.paged_attention import dequant_pages
    from paddle_tpu_torch.quantization.functional import quantize_symmetric
    out = []
    for c in (kc, vc):
        sc = torch.nan_to_num(c.float(), nan=0.0).abs().amax(dim=(1, 3))
        codes = quantize_symmetric(torch.nan_to_num(c.float(), nan=0.0),
                                   sc[:, None, :, None]).to(torch.int8)
        out.append((codes, sc))
    (kc8, ks), (vc8, vs) = out
    keep = torch.ones(kc.shape[0], dtype=torch.bool, device=kc.device)
    if poison_page is not None:
        ks[poison_page] = float("nan")
        vs[poison_page] = float("nan")
        keep[poison_page] = False
    vmax = dequant_pages(vc8[keep], vs[keep]).abs().max().item()
    return kc8, vc8, ks, vs, vmax


def int8_tolerance(want, flips, vmax: float):
    """The int8 kernels' allowed abs error against their plain versions,
    per element.  Both compute the same integer products and differ only
    in the fp32 order of the exp, the running max and the merges (the
    kernel's max is per warp or per tile, the plain version's per page):
    fp32 rounding, held to 1e-5 * vmax, except where a probability code
    rounds the other way.  Only a code whose value sits within
    ``P_CODE_REL_WINDOW`` of a .5 boundary can, and ``flips`` (the plain
    version's ``flip_bound``) is the most that all such codes move each
    element.  bf16 outputs add both sides' rounding to bf16: at most 2^-8
    of each value, so 2^-7 of the plain version's plus its share of the
    fp32 part."""
    import torch
    e = flips.float() + 1e-5 * vmax
    if want.dtype == torch.bfloat16:
        return (1 + 2.0 ** -8) * e + BF16_ULP * (1 + BF16_ULP) * \
            want.float().abs()
    return e


def cut_lengths(lens, floor, bs: int, by_page: bool):
    """Planted fault: ``lens`` with each sequence's last key (or its last
    page) left out, never below ``floor``."""
    import torch
    cut = (lens - 1) // bs * bs if by_page else lens - 1
    return torch.maximum(cut, floor).to(lens.dtype)


def dequantized_q(q):
    """q's rows through the int8 kernels' q quantizer and back, fp32."""
    from paddle_tpu_torch.quantization.functional import (
        dequantize_symmetric, quantize_rows_symmetric)
    return dequantize_symmetric(*quantize_rows_symmetric(q))


def fault_excess(faults, want, tol):
    """The largest |out - want| / tol of each planted fault's output: the
    tolerance rejects the fault where it is above 1."""
    return {name: ((out.float() - want.float()).abs() / tol).max().item()
            for name, out in faults.items()}


def check_faults(name, excess):
    kept = [k for k, x in excess.items() if not x > 1.0]
    if kept:
        raise AssertionError("%s: the tolerance does not reject the "
                             "planted faults %s (%s)" % (name, kept, excess))


def _int8_plain_faults(attend_fp, q, kc, vc, ks, vs):
    """The planted faults that are not the kernel's own: the int8 math
    with p left unquantized (q still quantized: fp attention of q's
    dequantized codes over the dequantized pools), and the dequantizing
    reference (fp attention of q itself over them)."""
    from paddle_tpu_torch.ops.paged_attention import dequant_pages
    kd, vd = dequant_pages(kc, ks), dequant_pages(vc, vs)
    return {"p_unquantized": attend_fp(dequantized_q(q), kd, vd),
            "dequant_reference": attend_fp(q.float(), kd, vd)}


def check_ragged(case, spans, T, H, Hkv, D, bs, dtype_name, gen,
                 span_q, poison=False, n_pad_spans=0, quantized=False,
                 generic=False):
    """The ragged kernel against its plain version on one pack (int8
    pools when ``quantized``, with the planted faults the tolerance must
    reject); one JSON line with the error, tolerance, times and bound.
    ``generic``: the shape must route to the generic kernel (and it is
    named so in the line)."""
    import torch
    from paddle_tpu_torch.ops.paged_attention import (
        _ragged_attention_int8_plain, _ragged_attention_plain,
        ragged_paged_attention, ragged_work)
    from paddle_tpu_torch.ops.paged_attention import ragged_generic
    if ragged_generic(D, H // Hkv, quantized, bs) != generic:
        raise AssertionError("ragged %s: the generic route is %s, want %s"
                             % (case, not generic, generic))
    dtype = getattr(torch, dtype_name)
    q, kc, vc, bt, q_off, q_len, kv_len = _ragged_case(
        spans, T, H, Hkv, D, bs, dtype, gen, poison, n_pad_spans)
    scale = 1.0 / math.sqrt(D)
    tables = (bt, q_off, q_len, kv_len)
    # the work list the mixed step builds on the host (used by the bf16
    # tensor-core kernel, ignored by the fp32 one)
    work = torch.from_numpy(ragged_work(q_len.cpu(), kv_len.cpu(), H, Hkv,
                                        bs)).to(q.device)
    scales, extra = {}, {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(
            kc, vc, kc.shape[0] - 2 if poison else None)
        scales = dict(key_scale=ks, value_scale=vs)

        def plain():
            return _ragged_attention_int8_plain(q, kc, vc, ks, vs, *tables,
                                                scale)
    else:
        def plain():
            return _ragged_attention_plain(q, kc, vc, *tables, scale)

    def kernel(kv=kv_len):
        return ragged_paged_attention(q, kc, vc, bt, q_off, q_len, kv, scale,
                                      span_q=span_q, work=work, **scales)
    got = kernel()
    torch.cuda.synchronize()
    if quantized:
        want, flips = _ragged_attention_int8_plain(
            q, kc, vc, ks, vs, *tables, scale, flip_bound=True)
        tol = int8_tolerance(want, flips, vmax)
        faults = {"kernel_drops_last_key": kernel(
                      cut_lengths(kv_len, q_len, bs, False)),
                  "kernel_drops_last_page": kernel(
                      cut_lengths(kv_len, q_len, bs, True))}
        faults.update(_int8_plain_faults(
            lambda qq, kd, vd: _ragged_attention_plain(
                qq, kd, vd, *tables, scale), q, kc, vc, ks, vs))
        extra = dict(fault_excess=fault_excess(faults, want, tol),
                     flips_max=flips.max().item())
    else:
        want = plain()
        tol = ragged_tolerance(want)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    name = ("ragged_paged_attention" + ("_generic" if generic else "")
            + ("_int8" if quantized else ""))
    if not (diff <= tol).all() or not torch.isfinite(got).all():
        raise AssertionError("%s %s %s: max_abs_err %g over tol (or "
                             "non-finite output)" % (name, case, dtype_name,
                                                     err))
    if quantized:
        check_faults("%s %s %s" % (name, case, dtype_name),
                     extra["fault_excess"])
    S, W = bt.shape
    n_bytes, flops = _ragged_work(spans, H, Hkv, D, bs, T, S * (W + 3),
                                  q.element_size(), kc.element_size())
    b_ms, b_by = bound_ms(n_bytes, flops,
                          "int8" if quantized else dtype_name)
    row = dict(kernel=name, case=case, dtype=dtype_name, T=T, H=H,
               Hkv=Hkv, D=D, block_size=bs, spans=len(spans),
               max_abs_err=err, err_over_tol=_err_over_tol(diff, tol),
               kernel_ms=time_ms(kernel, 20),
               plain_ms=time_ms(plain, 3, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library_note=NO_LIBRARY % "attention over a paged block "
               "table with per-span positional masks", **extra)
    emit(row)
    return row


def _err_over_tol(diff, tol) -> float:
    """The largest error in units of its element's tolerance."""
    return (diff / tol).max().item()


def check_paged(case, seq_lens, n_masked, H, Hkv, D, bs, dtype_name, gen,
                quantized=False, generic=False):
    """The decode kernel against its plain version: one query per slot at
    ``seq_lens`` (distinct pages, every unused table entry aimed at a NaN
    page, or at NaN scales for int8), plus ``n_masked`` slots as the
    engine masks them (seq_len 1 over an all-sink row); int8 pools with
    the planted faults the tolerance must reject.  A second call must
    give the same bits (the kernel merges split states in split order).
    The plain version (host loops for int8 pools, up to seconds a call at
    the widest shape) is timed over one call.  ``generic``: the shape must
    route to the generic kernel (named so in the line)."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.paged_attention import (_paged_attention_plain,
                                                      paged_attention)
    if (hasattr(pa, "decode_generic")
            and pa.decode_generic(D, bs) != generic):
        raise AssertionError("paged %s: the generic route is %s, want %s"
                             % (case, not generic, generic))
    dtype = getattr(torch, dtype_name)
    B = len(seq_lens) + n_masked
    q, kc, vc, bt, _, _, sl = _ragged_case(
        [(1, s) for s in seq_lens], B, H, Hkv, D, bs, dtype, gen,
        poison=True, n_pad_spans=n_masked)
    scale = 1.0 / math.sqrt(D)
    scales, extra = {}, {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)

    def kernel(lens=sl):
        return paged_attention(q, kc, vc, bt, lens, scale, **scales)

    def plain():
        return _paged_attention_plain(q, kc, vc, bt, sl, scale, **scales)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("paged_attention %s %s: two calls differ"
                             % (case, dtype_name))
    if quantized:
        want, flips = _paged_attention_plain(q, kc, vc, bt, sl, scale,
                                             flip_bound=True, **scales)
        tol = int8_tolerance(want, flips, vmax)
        one = sl.clamp(max=1)
        faults = {"kernel_drops_last_key": kernel(
                      cut_lengths(sl, one, bs, False)),
                  "kernel_drops_last_page": kernel(
                      cut_lengths(sl, one, bs, True))}
        faults.update(_int8_plain_faults(
            lambda qq, kd, vd: _paged_attention_plain(
                qq, kd, vd, bt, sl, scale), q, kc, vc, ks, vs))
        extra = dict(fault_excess=fault_excess(faults, want, tol),
                     flips_max=flips.max().item())
    else:
        want = plain()
        tol = ragged_tolerance(want)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    name = ("paged_attention" + ("_generic" if generic else "")
            + ("_int8" if quantized else ""))
    if not (diff <= tol).all() or not torch.isfinite(got).all():
        raise AssertionError("%s %s %s: max_abs_err %g over tol (or "
                             "non-finite output)" % (name, case, dtype_name,
                                                     err))
    if quantized:
        check_faults("%s %s %s" % (name, case, dtype_name),
                     extra["fault_excess"])
    spans = [(1, s) for s in seq_lens] + [(1, 1)] * n_masked
    W = bt.shape[1]
    n_bytes, flops = _ragged_work(spans, H, Hkv, D, bs, B, B * (W + 1),
                                  q.element_size(), kc.element_size())
    b_ms, b_by = bound_ms(n_bytes, flops,
                          "int8" if quantized else dtype_name)
    row = dict(kernel=name, case=case, dtype=dtype_name, B=B, H=H, Hkv=Hkv,
               D=D, block_size=bs, max_abs_err=err,
               err_over_tol=_err_over_tol(diff, tol), bitwise_repeat=True,
               # (a tree from before the split design, timed by
               # timing_of, runs one block a slot)
               splits=(1 if generic else
                       pa.decode_splits(B, Hkv, H // Hkv, W)[0]
                       if hasattr(pa, "decode_splits") else 1),
               kernel_ms=time_ms(kernel, 20),
               plain_ms=time_ms(plain, 1, warmup=1), bound_ms=b_ms,
               bound_by=b_by, library_ms=None,
               library_note=NO_LIBRARY % "attention of one query per slot "
               "over a paged block table with per-slot lengths", **extra)
    emit(row)
    return row


RMS_EPS = 1e-6
# (case, rows, hidden): the layerwise 7B shape (batch 2 x 2048 tokens,
# hidden 4096), one row, a row count that is not a power of two, the
# wider Llama hidden sizes, and hidden sizes that are not a multiple of
# the kernel's 16-byte vector (scalar loads)
RMS_CASES = (("7b_layerwise_4096x4096", 4096, 4096), ("one_row", 1, 4096),
             ("rows_4097", 4097, 4096), ("d5120", 1024, 5120),
             ("d8192", 1024, 8192), ("d4099_scalar", 1000, 4099),
             ("d100_scalar", 333, 100))
RMS_MAIN = "7b_layerwise_4096x4096"


def rms_tolerance(want, dtype_name: str, weight=None):
    """Per element: in bf16 one bf16 ulp of |want| (kernel and plain
    version round the same fp32 value, a few fp32 ulps apart, once); in
    fp32 eight fp32 ulps (another summation order, rsqrtf within 2 ulp,
    two products).  ``weight``: #4's layerwise variant, which rounds
    twice, the normalised value n and then n * w; where the fp32 values
    of n straddle a rounding boundary, the first rounding moves the output
    by one ulp of n times |w| before the second, so the limit is one ulp
    at each rounding point: that term is added (n = want / w)."""
    import torch
    tiny = torch.finfo(torch.float32).tiny
    bits = 7 if dtype_name == "bfloat16" else 23
    ulps = 1.0 if dtype_name == "bfloat16" else 8.0

    def ulp(x):
        x = x.abs().clamp(min=tiny)
        return ulps * torch.exp2(torch.floor(torch.log2(x)) - bits)
    tol = ulp(want.float())
    if weight is not None:
        w = weight.float()
        tol = tol + ulp(want.float() / w) * w.abs()
    return tol


# the layerwise variant in bf16: bitwise to its plain version except where
# the fp32 normalised value lies within this many fp32 ulps of a bf16
# rounding midpoint (kernel and plain version sum and rsqrt in another
# order, a few fp32 ulps apart; a bf16 ulp is 65,536 of them)
RMS_MIDPOINT_ULPS = 16


def near_bf16_midpoint(n, ulps: int):
    """Elements of the fp32 tensor ``n`` within ``ulps`` fp32 ulps of a
    bf16 rounding midpoint (low 16 bits of the fp32 pattern 0x8000)."""
    import torch
    return ((n.contiguous().view(torch.int32) & 0xFFFF) - 0x8000).abs() \
        <= ulps


def _rms_inputs(rows, d, dtype, gen):
    """Rows of N(0, 1) scaled by 10^-3.5 .. 10 (evenly in the exponent,
    the first row smallest), so that every case has rows whose mean
    square is near or below ``eps``; a weight of 1 + 0.1 N(0, 1)."""
    import torch
    dev = gen.device
    scale = 10.0 ** torch.linspace(-3.5, 1.0, rows, device=dev)[:, None]
    x = (torch.randn(rows, d, generator=gen, device=dev) * scale).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
    return x, w


def check_rms_norm(case, rows, d, dtype_name, gen, round_first=False):
    """Kernel #4 (with ``round_first``, its layerwise variant, which rounds
    before the weight) against its plain version: every element within
    :func:`rms_tolerance`, and the same tolerance rejecting the kernel's
    output without the weight (w = 1) and without ``eps`` (eps = 0).  In
    bf16 the variant is held bitwise to its plain version except at
    elements whose fp32 normalised value lies within
    ``RMS_MIDPOINT_ULPS`` of a bf16 midpoint, and the same rule must
    reject #4's own rounding point (the kernel run with ``round_first``
    off: ``round_last_off_midpoint`` elements differ away from a
    midpoint)."""
    import torch
    from paddle_tpu_torch.ops.rms_norm import _rms_norm_plain, rms_norm_tpu
    dtype = getattr(torch, dtype_name)
    x, w = _rms_inputs(rows, d, dtype, gen)
    kw = dict(round_first=round_first)
    got = rms_norm_tpu(x, w, RMS_EPS, **kw)
    torch.cuda.synchronize()
    want = _rms_norm_plain(x, w, RMS_EPS, **kw)
    tol = rms_tolerance(want, dtype_name, w if round_first else None)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    name = "rms_norm" + ("_round_first" if round_first else "")
    if not (diff <= tol).all() or not torch.isfinite(got).all():
        raise AssertionError("%s %s %s: max_abs_err %g over tol (or "
                             "non-finite output)" % (name, case, dtype_name,
                                                     err))
    faults = {"weight_dropped": rms_norm_tpu(x, torch.ones_like(w),
                                             RMS_EPS, **kw),
              "eps_dropped": rms_norm_tpu(x, w, 0.0, **kw)}
    excess = fault_excess(faults, want, tol)
    check_faults("%s %s %s" % (name, case, dtype_name), excess)
    extra = {}
    if round_first and dtype_name == "bfloat16":
        x32 = x.float()
        edge = near_bf16_midpoint(
            x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + RMS_EPS),
            RMS_MIDPOINT_ULPS)

        def off_midpoint(out):
            return int(((out != want) & ~edge).sum().item())
        extra = dict(differ=int((got != want).sum().item()),
                     differ_off_midpoint=off_midpoint(got),
                     near_midpoint=int(edge.sum().item()),
                     round_last_off_midpoint=off_midpoint(
                         rms_norm_tpu(x, w, RMS_EPS)))
        if extra["differ_off_midpoint"]:
            raise AssertionError(
                "%s %s: %d elements differ from the plain version away "
                "from a bf16 midpoint" % (name, case,
                                          extra["differ_off_midpoint"]))
        if not extra["round_last_off_midpoint"]:
            raise AssertionError(
                "%s %s: the bitwise rule does not reject the round-last "
                "kernel" % (name, case))
    es = x.element_size()
    b_ms, b_by = bound_ms(2 * rows * d * es + d * es, 4.0 * rows * d,
                          "float32")
    row = dict(kernel=name, case=case, dtype=dtype_name, rows=rows,
               hidden=d, max_abs_err=err,
               err_over_tol=_err_over_tol(diff, tol), fault_excess=excess,
               kernel_ms=time_ms(lambda: rms_norm_tpu(x, w, RMS_EPS, **kw),
                                 50),
               plain_ms=time_ms(lambda: _rms_norm_plain(x, w, RMS_EPS, **kw),
                                20),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: torch.nn.functional.rms_norm(
                   x, (d,), w, RMS_EPS), 50), **extra)
    emit(row)
    return row


def check_rope(case, N, H, Hkv, D, with_amax, gen):
    import torch
    from paddle_tpu_torch.ops.kernels import (_rope_qkv_epilogue_plain,
                                              rope_qkv_epilogue,
                                              rope_tables_for_positions)
    dev = "cuda"
    dt = torch.bfloat16
    q = torch.randn(N, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(N, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(N, Hkv, D, generator=gen, device=dev).to(dt)
    pos = torch.randint(0, 4096, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    cos, sin = rope_tables_for_positions(pos, D, 10000.0)
    args = (q, k, v, cos, sin, with_amax)
    got = rope_qkv_epilogue(*args)
    torch.cuda.synchronize()
    want = _rope_qkv_epilogue_plain(*args)
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        # bitwise: the kernel forbids FMA contraction, so equality is exact
        if not torch.equal(g, w):
            raise AssertionError("rope_qkv_epilogue %s is not bitwise "
                                 "equal to its plain version" % case)
        err = max(err, (g.float() - w.float()).abs().max().item())
    es = q.element_size()
    n_bytes = (2 * (N * H * D + N * Hkv * D) * es + 2 * N * D * 4
               + (N * Hkv * D * es + 2 * N * Hkv * 4 if with_amax else 0))
    flops = 3.0 * N * (H + Hkv) * D + (2.0 * 2 * N * Hkv * D
                                       if with_amax else 0.0)
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    row = dict(kernel="rope_qkv_epilogue", case=case, dtype="bfloat16",
               N=N, H=H, Hkv=Hkv, D=D, with_amax=with_amax,
               max_abs_err=err, tol=0.0,
               kernel_ms=time_ms(lambda: rope_qkv_epilogue(*args), 50),
               plain_ms=time_ms(lambda: _rope_qkv_epilogue_plain(*args), 20),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library_note=NO_LIBRARY % "neox rotary embedding of q and "
               "k at per-token positions")
    emit(row)
    return row


# #7 at scale: 32/32 heads, D 128, block size 16, bf16 q
DECODE_SCALE_CASES = (("long_8x4096", [4096] * 8),
                      ("wide_32x2048", [2048] * 32))


def decode_at_scale(gen, quantized):
    """#7 at ``DECODE_SCALE_CASES`` (:func:`check_paged`)."""
    return [check_paged(case, lens, 0, 32, 32, 128, 16, "bfloat16", gen,
                        quantized) for case, lens in DECODE_SCALE_CASES]


# the shapes the fast paged kernels do not take, computed by each source's
# generic kernel: (case, H, Hkv, D, bs, pools) at the served traffic (#5:
# 8 decode spans at kv 1024 + a 256-token chunk; #7: 8 slots at kv 1024).
# "both" runs bf16 and int8 pools, "int8" only int8 (bf16 pools of block
# size 128 take the tensor-core kernel).
GENERIC_RAGGED = (("d100_gqa8x2", 8, 2, 100, 16, "both"),
                  ("d256_gqa8x8", 8, 8, 256, 16, "both"),
                  ("d256_mqa8x1", 8, 1, 256, 16, "both"),
                  ("g64_64x1", 64, 1, 128, 16, "both"),
                  ("int8_bs128", 32, 32, 128, 128, "int8"))
GENERIC_DECODE = (("d100_gqa8x2", 8, 2, 100, 16),
                  ("d256_gqa8x8", 8, 8, 256, 16),
                  ("d256_mqa8x1", 8, 1, 256, 16),
                  ("bs256", 32, 32, 128, 256))
GENERIC_MAIN = "d100_gqa8x2"
# the speculative verify step's ragged shape: 8 spans of spec_k + 1 = 3
# tokens at kv 1024, padded to the budget 32 (8 slots x 3 -> 32)
VERIFY_CASE = "7b_verify_8x3@1024"

# the weight dequant's cases: a Llama-2-7B decoder layer's seven
# projections (one launch), the LM head, and a width off the 16-element
# vector
DEQUANT_CASES = (("7b_layer", [(4096, 4096)] * 4 + [(11008, 4096)] * 2
                  + [(4096, 11008)]),
                 ("7b_lm_head", [(32000, 4096)]),
                 ("odd_37x100", [(37, 100)]))
DEQUANT_MAIN = "7b_layer"


def check_dequant(case, segments, dtype_name, gen):
    """``dequant_int8`` against its plain version at ``segments``: bitwise,
    and the same check must reject the kernel run with one row's scale
    planted 1% off.  Timed (device time) beside the plain version, the
    three-op torch expression (``library_ms``: cast, multiply, cast; no
    single call computes it) and the bound: each code read once, each
    output written once, the scales read once, at 3.35 TB/s."""
    import torch
    from paddle_tpu_torch.ops import dequant as dq
    dt = getattr(torch, dtype_name)
    n = sum(r * c for r, c in segments)
    rows = sum(r for r, _ in segments)
    codes = torch.randint(-127, 128, (n,), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand(rows, generator=gen, device="cuda") * 0.05
    got = torch.empty(n, dtype=dt, device="cuda")
    want = torch.empty_like(got)
    dq._dequant_int8_plain(codes, scales, segments, want)
    before = dq.dequant_int8.launches
    dq.dequant_int8(codes, scales, segments, got)
    torch.cuda.synchronize()
    if dq.dequant_int8.launches != before + 1:
        raise AssertionError("dequant_int8 %s: the wrapper did not count "
                             "its launch" % case)
    bad = scales.clone()
    bad[rows // 2] *= 1.01
    planted = dq.dequant_int8(codes, bad, segments, torch.empty_like(got))
    torch.cuda.synchronize()
    bitwise = torch.equal(got, want)
    rejected = not torch.equal(planted, want)
    sdiv = scales / torch.full_like(scales, 127.0)

    def library():
        e = r = 0
        for rr, cc in segments:
            (codes[e:e + rr * cc].view(rr, cc).float()
             * sdiv[r:r + rr, None]).to(dt)
            e += rr * cc
            r += rr
    iters = 5 if n > 1 << 20 else 50
    # the multiplies run in fp32 on the CUDA cores, whatever the output
    bound, by = bound_ms(n * (1 + got.element_size()) + 4 * rows, n,
                         "float32")
    row = dict(kernel="dequant_int8", case=case, dtype=dtype_name,
               segments=segments, elements=n,
               max_abs_err=(got.float() - want.float()).abs().max().item(),
               bitwise=bitwise, planted_fault_rejected=rejected,
               kernel_ms=time_ms(lambda: dq.dequant_int8(
                   codes, scales, segments, got), iters),
               plain_ms=time_ms(lambda: dq._dequant_int8_plain(
                   codes, scales, segments, want), iters),
               library_ms=time_ms(library, iters),
               library="the three-op torch expression (cast, multiply, "
                       "cast); no single call computes it",
               bound_ms=bound, bound_by=by)
    emit(row)
    if not bitwise or not rejected:
        raise AssertionError("dequant_int8 %s %s: bitwise %s, planted fault "
                             "rejected %s" % (case, dtype_name, bitwise,
                                              rejected))
    return row


def phase_kernels():
    import torch
    gen = torch.Generator("cuda").manual_seed(SEED)
    H, D, bs, chunk = 32, 128, 16, 256
    decode = [(1, 1024)] * 8
    mixed = decode + [(chunk, 1024)]
    # the engine pads the token axis to its budget: 8 for an all-decode
    # step, 512 for 8 decodes + a 256-token chunk; span_q = min(chunk, T)
    rows = {"ragged": [], "rope": [], "ragged_int8": [], "decode": [],
            "decode_int8": [], "ragged_generic": [],
            "ragged_generic_int8": [], "decode_generic": [],
            "decode_generic_int8": []}
    # odd small shapes: groups of 3, chunks starting mid-page, a
    # prefix-offset span, padding spans, and every unused table entry aimed
    # at a NaN page (the clamp must never read it); at block size 5 (the
    # int8 pools then take the CUDA-core kernel) and 16 (a chunk of two
    # 128-vector tiles; the tensor-core kernel's decode and chunk items)
    odd = [(1, 7), (13, 29), (3, 3), (1, 1), (9, 41), (2, 11)]
    odd16 = [(1, 7), (90, 130), (3, 3), (1, 1), (9, 41), (2, 11), (1, 64)]
    for quantized in (False, True):
        key = "ragged_int8" if quantized else "ragged"
        # the all-decode step (8 decode spans: the tensor-core kernel's
        # decode items; with GQA 32/8 too few blocks for the card, so each
        # span is split over 4 blocks)
        rows[key].append(check_ragged(
            "7b_decode_8x1024", decode, 8, H, H, D, bs, "bfloat16", gen,
            span_q=8, quantized=quantized))
        rows[key].append(check_ragged(
            "gqa32x8_decode_8x1024", decode, 8, H, 8, D, bs, "bfloat16",
            gen, span_q=8, quantized=quantized))
        for dt in ("bfloat16", "float32"):
            rows[key].append(check_ragged(
                "7b_mixed_8x1024+256", mixed, 512, H, H, D, bs, dt, gen,
                span_q=chunk, quantized=quantized))
            rows[key].append(check_ragged(
                "gqa32x8_mixed_8x1024+256", mixed, 512, H, 8, D, bs, dt,
                gen, span_q=chunk, quantized=quantized))
            rows[key].append(check_ragged(
                "gqa32x8_d96_mixed_8x1024+256", mixed, 512, H, 8, 96, bs,
                dt, gen, span_q=chunk, quantized=quantized))
            rows[key].append(check_ragged(
                "odd_poisoned", odd, 40, 6, 2, 64, 5, dt, gen, span_q=13,
                poison=True, n_pad_spans=3, quantized=quantized))
            rows[key].append(check_ragged(
                "odd_poisoned_bs16", odd16, 200, 6, 2, 64, 16, dt, gen,
                span_q=90, poison=True, n_pad_spans=2, quantized=quantized))
            # head dims without a kernel of their own: q and the output
            # padded, the pools read at their width (int8 at 80 and 112,
            # multiples of 16, on the tensor cores in bf16)
            for Dx in (80, 112):
                rows[key].append(check_ragged(
                    "odd_poisoned_bs16_d%d" % Dx, odd16, 200, 6, 2, Dx, 16,
                    dt, gen, span_q=90, poison=True, n_pad_spans=2,
                    quantized=quantized))
    # the split engine's decode step: 8 slots at kv 1024 (the 7B decode
    # shape), GQA 32/8 at head dims 128 and 96 (each slot split over
    # blocks), Qwen2-7B's 28/4 (7 query heads a kv head), an odd poisoned
    # shape with masked slots at head dims 32, 64, 80 and 112 and block
    # sizes 5, 16, 64 and 128; in bf16 a long context and a wide batch
    odd_lens = [7, 29, 3, 1, 41, 11, 16]
    for quantized in (False, True):
        key = "decode_int8" if quantized else "decode"
        rows[key] += decode_at_scale(gen, quantized)
        for dt in ("bfloat16", "float32"):
            rows[key].append(check_paged(
                "g7_28x4_decode_8x1024", [1024] * 8, 0, 28, 4, D, bs, dt,
                gen, quantized))
            for Dx, bsx in ((80, 16), (112, 16), (64, 64), (64, 128)):
                rows[key].append(check_paged(
                    "odd_poisoned_masked_D%d_bs%d" % (Dx, bsx),
                    odd_lens + [300], 3, 8, 2, Dx, bsx, dt, gen, quantized))
            rows[key].append(check_paged(
                "7b_decode_8x1024", [1024] * 8, 0, H, H, D, bs, dt, gen,
                quantized))
            rows[key].append(check_paged(
                "gqa32x8_decode_8x1024", [1024] * 8, 0, H, 8, D, bs, dt, gen,
                quantized))
            rows[key].append(check_paged(
                "gqa32x8_d96_decode_8x1024", [1024] * 8, 0, H, 8, 96, bs, dt,
                gen, quantized))
            for Dx, heads in ((64, (8, 2)), (32, (16, 2))):
                rows[key].append(check_paged(
                    "odd_poisoned_masked_D%d" % Dx, odd_lens, 3, heads[0],
                    heads[1], Dx, 5, dt, gen, quantized))
    # the speculative verify step: 8 spans of 3 tokens (spec_k + 1) at kv
    # 1024, the span window 3 (chunk tiles of the tensor-core kernel)
    for quantized in (False, True):
        key = "ragged_int8" if quantized else "ragged"
        rows[key].append(check_ragged(
            VERIFY_CASE, [(3, 1024)] * 8, 32, H, H, D, bs, "bfloat16", gen,
            span_q=3, quantized=quantized))
    # the generic kernels (shapes the fast ones do not take), bf16 q
    for case, Hx, Hkvx, Dx, bsx, pools in GENERIC_RAGGED:
        for quantized in ((True,) if pools == "int8" else (False, True)):
            key = "ragged_generic" + ("_int8" if quantized else "")
            rows[key].append(check_ragged(
                case + "_mixed_8x1024+256", mixed, 512, Hx, Hkvx, Dx, bsx,
                "bfloat16", gen, span_q=chunk, quantized=quantized,
                generic=True))
    for case, Hx, Hkvx, Dx, bsx in GENERIC_DECODE:
        for quantized in (False, True):
            key = "decode_generic" + ("_int8" if quantized else "")
            rows[key].append(check_paged(
                case + "_decode_8x1024", [1024] * 8, 0, Hx, Hkvx, Dx, bsx,
                "bfloat16", gen, quantized, generic=True))
    for N in (8, 512):
        for amax in (False, True):
            rows["rope"].append(check_rope(
                "7b_T%d%s" % (N, "_amax" if amax else ""), N, H, H, D,
                amax, gen))
    rows["dequant"] = [check_dequant(case, segs, dt, gen)
                       for case, segs in DEQUANT_CASES
                       for dt in ("bfloat16", "float32")]
    rows["rms_norm"] = [check_rms_norm(case, n, d, dt, gen)
                        for case, n, d in RMS_CASES
                        for dt in ("bfloat16", "float32")]
    # the layerwise step's variant (round before the weight), at its shape
    rows["rms_norm"] += [check_rms_norm(RMS_MAIN, 4096, 4096, dt, gen,
                                        round_first=True)
                         for dt in ("bfloat16", "float32")]
    return rows


# ---------------------------------------------------------------------------
# phase 5: the flash kernels against their plain versions
# ---------------------------------------------------------------------------
# (name, B, Sq, Sk, H, D, dtype, rope, causal, kernels); "main" is the
# training path's shape (Llama-2-7B, batch 2 x 2048) and "long_16k" the
# long-context phase's, where the router takes the two-kernel backward.
# The small cases cover head dim 64, fp32, no rope, no mask, key axes
# longer and shorter than the query axis (rows that see nothing) and
# lengths that are not a multiple of the kernels' 64-row tiles, each in
# both dtypes (the bf16 forward and two-kernel backward are the tensor-core
# kernels), and sequences of 1 and 65 tokens.
ALL_FLASH = ("flash_fwd", "flash_bwd_fused", "flash_bwd_two_kernel")
FLASH_CASES = (
    ("main", 2, 2048, 2048, 32, 128, "bfloat16", True, True, ALL_FLASH),
    ("main_fp32", 2, 2048, 2048, 32, 128, "float32", True, True, ALL_FLASH),
    ("d64_full_rope", 1, 512, 512, 8, 64, "bfloat16", True, False,
     ALL_FLASH),
    ("d64_causal_ragged", 1, 200, 200, 4, 64, "float32", False, True,
     ALL_FLASH),
    ("d64_causal_ragged_bf16", 1, 200, 200, 4, 64, "bfloat16", False, True,
     ALL_FLASH),
    ("rect_causal", 2, 192, 448, 4, 128, "bfloat16", False, True, ALL_FLASH),
    ("dead_rows", 1, 448, 192, 4, 128, "float32", False, True, ALL_FLASH),
    ("dead_rows_bf16", 1, 448, 192, 4, 128, "bfloat16", False, True,
     ALL_FLASH),
    ("dead_rows_bf16_d64", 1, 300, 100, 4, 64, "bfloat16", False, True,
     ALL_FLASH),
    ("rect_full_ragged", 1, 100, 300, 4, 64, "float32", False, False,
     ALL_FLASH),
    ("rect_full_ragged_bf16", 1, 100, 300, 4, 64, "bfloat16", False, False,
     ALL_FLASH),
    ("one_token_rope", 2, 1, 1, 4, 128, "bfloat16", True, True, ALL_FLASH),
    ("s65_rope_d64", 2, 65, 65, 4, 64, "bfloat16", True, True, ALL_FLASH),
    ("d32_rope", 2, 300, 300, 4, 32, "bfloat16", True, True, ALL_FLASH),
    ("d32_rope_fp32", 2, 300, 300, 4, 32, "float32", True, True, ALL_FLASH),
    ("d96_dead_rows", 1, 200, 100, 4, 96, "bfloat16", False, True,
     ALL_FLASH),
    ("d96_full_rope_fp32", 1, 130, 130, 4, 96, "float32", True, False,
     ALL_FLASH),
    ("d80_rope", 2, 300, 300, 4, 80, "bfloat16", True, True, ALL_FLASH),
    ("d80_rope_fp32", 2, 300, 300, 4, 80, "float32", True, True, ALL_FLASH),
    ("d112_dead_rows", 1, 200, 100, 4, 112, "bfloat16", False, True,
     ALL_FLASH),
    ("d36_rope", 2, 300, 300, 4, 36, "bfloat16", True, True, ALL_FLASH),
    ("d36_rope_fp32", 2, 300, 300, 4, 36, "float32", True, True, ALL_FLASH),
    ("d100_dead_rows", 1, 200, 100, 4, 100, "bfloat16", False, True,
     ALL_FLASH),
    ("d100_full_rope_fp32", 1, 130, 130, 4, 100, "float32", True, False,
     ALL_FLASH),
    ("long_16k", 1, 16384, 16384, 32, 128, "bfloat16", True, True,
     ("flash_fwd", "flash_bwd_two_kernel")),
)
# the timed cases: the training shapes, and the fp32 variants (the CUDA
# cores) at the 7B one
FLASH_TIMED = ("main", "main_fp32", "long_16k")
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_TC_SOURCE = "paddle_tpu_torch/csrc/flash_attention_sm90.cu"
# the cases where two calls of the one-pass backward must give bitwise
# equal dq, dk and dv (its dq shares are summed in k-tile order)
FLASH_DETERMINISM = ("main", "main_fp32", "dead_rows_bf16", "rect_causal")
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas_kernels.py:176",
    "flash_bwd_fused": "paddle_tpu/ops/pallas_kernels.py:480",
    "flash_bwd_two_kernel": "paddle_tpu/ops/pallas_kernels.py:406",
}
# where each kernel's numbers in the final line come from: its shape and
# the training path that launches it
FLASH_MAIN = {"flash_fwd": ("main", "train_7b"),
              "flash_bwd_fused": ("main", "train_7b"),
              "flash_bwd_two_kernel": ("long_16k", "train_long_16k")}


def flash_source(dtype_name):
    """The source whose kernels a flash call in ``dtype_name`` launches:
    bf16 runs on the tensor cores at every head dim (padded to 64 or
    128), fp32 on the CUDA cores."""
    return FLASH_TC_SOURCE if dtype_name == "bfloat16" else FLASH_SOURCE


BF16_ULP = 2.0 ** -7     # one bf16 ulp of a value is at most this share
NOISE_MARGIN = 4.0       # kernel vs plain rounding, in units of the plain's


def flash_tolerance(want, dtype_name: str, noise=None):
    """The allowed abs error of a flash kernel's output against the plain
    version's ``want``, element by element (a float or a tensor shaped
    like ``want``).

    fp32: the two differ only in summation order (online vs two-pass
    softmax, blocked dot products, and for the fused backward the order
    of the atomic dq additions), so 2e-5 of the output's magnitude.

    bf16: ``BF16_ULP * |want|`` (one ulp of each element: kernel and plain
    round slightly different fp32 values and may land on neighbouring
    bf16 values), plus ``NOISE_MARGIN`` times the largest ``noise`` in the
    element's row (its D values), plus the fp32 allowance above (sums in
    another order; it matters only where the bf16 terms vanish, e.g. a
    causal row that sees one key).  ``noise`` (:func:`flash_noise`) is the
    rounding the plain version does inside the function on these
    inputs.  The kernel rounds the same operands at the same points; its
    values differ from the plain version's only where its fp32 values
    differ in the last bits (p rounded against the running row max, ds
    where p differs), so its own rounding in a row is of the plain
    version's size there.  Nothing here scales with the largest output
    beyond the fp32 allowance."""
    f32 = 2e-5 * max(1.0, want.float().abs().max().item())
    if dtype_name == "float32":
        return f32
    row = noise.amax(dim=-1, keepdim=True)
    return BF16_ULP * want.float().abs() + NOISE_MARGIN * row + f32


# the plain backward form each backward kernel stands for
FLASH_FORM = {"flash_bwd_fused": "fused",
              "flash_bwd_two_kernel": "two_kernel"}


def flash_noise(kernel, q, k, v, out, lse, g, causal, tables):
    """The rounding the plain version of ``kernel`` does inside the
    function, element by element: its output before the last rounding
    less the plain version run in fp32 on the same inputs."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    f32 = torch.float32
    qf, kf, vf, of, gf = (None if t is None else t.float()
                          for t in (q, k, v, out, g))
    if kernel == "flash_fwd":
        raw = fa._flash_fwd_plain(q, k, v, causal, tables, out_dtype=f32)[:1]
        ref = fa._flash_fwd_plain(qf, kf, vf, causal, tables)[:1]
    else:
        form = FLASH_FORM[kernel]
        raw = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                                  form=form, out_dtype=f32)
        ref = fa._flash_bwd_plain(qf, kf, vf, of, lse, gf, causal, tables,
                                  form=form)
    return tuple((a - b).abs() for a, b in zip(raw, ref))


def flash_excess(got, want, tol) -> float:
    """The largest ``|got - want| / tol`` over the elements (<= 1
    passes)."""
    import torch
    diff = (got.float() - want.float()).abs()
    tol = torch.as_tensor(tol, dtype=torch.float32, device=diff.device)
    return (diff / tol).max().item()


def _flash_case(B, Sq, Sk, H, D, dtype_name, rope, gen):
    import torch
    from paddle_tpu_torch.ops.flash_attention import rope_tables
    dt = getattr(torch, dtype_name)

    def rnd(S):
        return torch.randn(B, S, H, D, generator=gen,
                           device="cuda").to(dt)
    q, k, v, g = rnd(Sq), rnd(Sk), rnd(Sk), rnd(Sq)
    tables = rope_tables(Sq, D, 10000.0, device="cuda") if rope else None
    return q, k, v, g, tables


def _flash_work(kernel, B, Sq, Sk, H, D, itemsize, rope, causal):
    """Bytes (each input read once, each output written once) and
    operations the function needs: per visible (query, key) pair 4 D in
    the forward (q.k and p.v) and 10 D in the backward (q.k, dO.v, p^T.dO,
    ds^T.q, ds.k), the same for both backward forms."""
    off = Sk - Sq
    if causal:
        pairs = sum(max(0, min(Sk, i + off + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    pairs *= B * H
    q_bytes, k_bytes = B * Sq * H * D * itemsize, B * Sk * H * D * itemsize
    lse_bytes = B * H * Sq * 4
    tab_bytes = 2 * Sq * D * 4 if rope else 0
    if kernel == "flash_fwd":
        return (2 * q_bytes + 2 * k_bytes + lse_bytes + tab_bytes,
                4.0 * D * pairs)
    # reads q, k, v, out, dO, lse; writes dq, dk, dv
    return (4 * q_bytes + 4 * k_bytes + lse_bytes + tab_bytes,
            10.0 * D * pairs)


def _library_ms(q, k, v, g, causal, backward, iters):
    """The one PyTorch call that computes the same function without rope:
    ``scaled_dot_product_attention`` (its own flash kernels on the card)
    forward, or the backward of one such call alone (the autograd graph
    kept, ``torch.autograd.grad`` timed).  Used here as a yardstick only;
    the port never calls it."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(backward)
                  for t in (q, k, v))
    if not backward:
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                               retain_graph=True), iters)


def check_flash(name, B, Sq, Sk, H, D, dtype_name, rope, causal, kernels,
                gen, timed: bool):
    """Each kernel of ``kernels`` against its plain version on one case;
    one JSON line per kernel.  With ``timed``, also the kernel's, the
    plain version's and the library's times (CUDA events)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, g, tables = _flash_case(B, Sq, Sk, H, D, dtype_name, rope, gen)
    rows = []
    out, lse = fa.flash_fwd(q, k, v, causal, tables)
    torch.cuda.synchronize()
    want_out, want_lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    dead = torch.isneginf(want_lse)
    if not torch.equal(torch.isneginf(lse), dead) or not bool(
            (out.transpose(1, 2)[dead] == 0).all()):
        raise AssertionError("flash_fwd %s: rows that see nothing must "
                             "give lse -inf and out 0" % name)
    results = {"flash_fwd": ((out,), (want_out,), (lse, want_lse))}
    for kern in kernels[1:]:
        fn = getattr(fa, kern)
        got = fn(q, k, v, out, lse, g, causal, tables)
        torch.cuda.synchronize()
        want = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                                   form=FLASH_FORM[kern])
        results[kern] = (got, want, None)
    iters = 3 if Sq > 4096 else 10
    for kern in kernels:
        got, want, lses = results[kern]
        noise = (flash_noise(kern, q, k, v, out, lse, g, causal, tables)
                 if dtype_name == "bfloat16" else (None,) * len(want))
        errs, excess, atols, typical = [], [], [], []
        for a, b, f in zip(got, want, noise):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError("%s %s: non-finite output" % (kern,
                                                                   name))
            tol = flash_tolerance(b, dtype_name, f)
            errs.append((a.float() - b.float()).abs().max().item())
            excess.append(flash_excess(a, b, tol))
            atol = (torch.tensor([tol]) if dtype_name == "float32"
                    else tol - BF16_ULP * b.float().abs())
            atols.append([atol.median().item(), atol.max().item()])
            typical.append(b.float().abs().median().item())
        del noise
        if lses is not None:
            fin = ~dead
            errs.append((lses[0][fin] - lses[1][fin]).abs().max().item())
            excess.append(errs[-1] / 1e-4)
            atols.append([1e-4, 1e-4])
        if any(not (x <= 1.0) for x in excess):
            raise AssertionError("%s %s: errors %s exceed the tolerance "
                                 "(err/tol %s, atol %s)"
                                 % (kern, name, errs, excess, atols))
        n_bytes, flops = _flash_work(kern, B, Sq, Sk, H, D,
                                     q.element_size(), rope, causal)
        b_ms, b_by = bound_ms(n_bytes, flops, dtype_name)
        row = dict(kernel=kern, case=name, dtype=dtype_name, B=B, Sq=Sq,
                   Sk=Sk, H=H, D=D, rope=rope, causal=causal,
                   max_abs_err=max(errs), errs=errs, err_over_tol=excess,
                   atol_median_max=atols, median_abs=typical,
                   rel_tol=BF16_ULP if dtype_name == "bfloat16" else 0.0,
                   bound_ms=b_ms, bound_by=b_by,
                   source=flash_source(dtype_name))
        if kern == "flash_bwd_fused" and name in FLASH_DETERMINISM:
            again = fa.flash_bwd_fused(q, k, v, out, lse, g, causal, tables)
            torch.cuda.synchronize()
            row["bitwise_repeat"] = all(
                torch.equal(a, b) for a, b in zip(got, again))
            if not row["bitwise_repeat"]:
                raise AssertionError("flash_bwd_fused %s: two calls differ "
                                     "(dq, dk, dv must be deterministic)"
                                     % name)
        if timed:
            bwd = kern != "flash_fwd"
            fn = getattr(fa, kern)
            args = (q, k, v, out, lse, g) if bwd else (q, k, v)
            kernel_ms = time_ms(lambda: fn(*args, causal, tables), iters)
            plain = (functools.partial(fa._flash_bwd_plain,
                                       form=FLASH_FORM[kern])
                     if bwd else fa._flash_fwd_plain)
            row.update(
                kernel_ms=kernel_ms, flops=flops,
                tflop_per_s=flops / (kernel_ms * 1e-3) / 1e12,
                plain_ms=time_ms(lambda: plain(*args, causal, tables), 2,
                                 warmup=1),
                library_ms=(_library_ms(q, k, v, g, causal, bwd, iters)
                            if Sq == Sk and causal else None),
                library_note="scaled_dot_product_attention%s on the same "
                "inputs without rope (the rope variant adds two elementwise "
                "passes to it)" % (" backward" if bwd else ""))
        emit(row)
        rows.append(row)
    return rows


def phase_flash_kernels():
    import torch
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = []
    for case in FLASH_CASES:
        rows += check_flash(*case, gen=gen,
                            timed=case[0] in FLASH_TIMED)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: the served slice
# ---------------------------------------------------------------------------
def _prompts(vocab: int):
    rng = np.random.RandomState(SEED)
    return [rng.randint(1, vocab, (n,)).astype(np.int64)
            for n in PROMPT_LENS]


# every launch counter of the serving kernels, by the name the final line
# gives the kernel variant: the engine server's table, whose exit record
# reports the same names
def _no_launches():
    """Every serving kernel variant's name, each with a count of 0."""
    from paddle_tpu_torch.inference.engine_server import LAUNCH_COUNTERS
    return dict.fromkeys(LAUNCH_COUNTERS, 0)


def _reset_launches():
    from paddle_tpu_torch.inference.engine_server import reset_launch_counts
    reset_launch_counts()


def _launches():
    from paddle_tpu_torch.inference.engine_server import launch_counts
    return launch_counts()


class _Calls:
    """Counts the calls the engine makes to one of its steps (``__call__``
    or ``call_packed``).  For a speculative verifier it also counts the
    spans that drafted the full ``spec_k`` tokens and those that accepted
    them all (the bonus-token path)."""

    def __init__(self, step):
        self.step, self.n = step, 0
        self.full_drafts = self.full_accepts = 0

    def __call__(self, *args):
        self.n += 1
        return self.step(*args)

    def call_packed(self, pack, T, **kw):
        self.n += 1
        out = self.step.call_packed(pack, T, **kw)
        K = getattr(self.step, "spec_k", 0)
        if K:
            S, W = self.step.max_spans, self.step.bt_width
            n_draft = pack[4 * T:].reshape(S, -1)[:, W + 4]
            full = n_draft == K
            self.full_drafts += int(full.sum())
            self.full_accepts += int((full & (out[1] == K)).sum())
        return out

    def __getattr__(self, name):
        return getattr(self.step, name)


def _match_rate(got, want):
    """Fraction of ``want`` matched up to the first divergence."""
    n = 0
    for a, b in zip(got, want):
        if a != b:
            break
        n += 1
    return n / max(1, len(want))


def _spread(xs):
    """Median, min, max, 90th percentile and sum of ``xs``."""
    a = np.asarray(xs, np.float64)
    return dict(median=float(np.median(a)), min=float(a.min()),
                max=float(a.max()), p90=float(np.percentile(a, 90)),
                sum=float(a.sum()), n=int(a.size))


# the sampled requests' knobs; every fourth request stays greedy, so both
# branches of the sampling epilogue share a step
SAMPLED_KNOBS = dict(temperature=0.8, top_k=50, top_p=0.95)
DRAFT_LAYERS = 8          # of Llama-2-7B's 32 (the reference's 5 of 20)
SPEC_K = 2                # the reference engine's default


def request_knobs(i: int, sampled: bool):
    """Request ``i``'s sampling knobs: seed 1 + i, greedy when ``i % 4 ==
    3`` or the run is not sampled."""
    if not sampled or i % 4 == 3:
        return {}
    return dict(SAMPLED_KNOBS, seed=1 + i)


def admit_4_4(prompts, sampled=False):
    """The phase-3 traffic: admit 4, step, admit 4, run to completion;
    ``sampled``: the requests carry :func:`request_knobs`.  Returns the
    traffic function :func:`serve` runs (``traffic(eng, step) ->
    req_ids``)."""
    def traffic(eng, step):
        rids = [eng.add_request(p, NEW_TOKENS, **request_knobs(i, sampled))
                for i, p in enumerate(prompts[:4])]
        step()
        rids += [eng.add_request(p, NEW_TOKENS, **request_knobs(i, sampled))
                 for i, p in enumerate(prompts[4:], 4)]
        while eng.has_work():
            step()
        return rids
    return traffic


def pool_whole(eng) -> bool:
    """Every page free, or (with the prefix cache) held exactly once, by
    the cache's table."""
    cache = eng.caches[0]
    cached = (eng.prefix_cache.cached_blocks()
              if eng.prefix_cache is not None else set())
    return (all(cache.refcount(b) == 1 for b in cached)
            and sorted(cache._free + list(cached) + [cache.sink])
            == list(range(cache.num_blocks + 1)))


def serve(model, prompts, engine_kw=None, draft=None, sampled=False,
          traffic=None):
    """Run ``traffic`` (default: :func:`admit_4_4` over ``prompts``) on an
    engine built with ``engine_kw`` (default: the mixed engine) and
    ``draft`` as its draft model.  Returns the engine, the tokens per
    request and the run's statistics: the launch counts (reset just
    before), engine steps (and the spread of their host seconds:
    ``eng.step()`` returns once the step is queued, or once it has read its
    tokens back), the split engine's decode steps and prefill chunks, the
    prompt tokens the engine prefilled, the mixed engine's target launches
    and the draft's launches, for a speculative engine the draft tokens
    proposed and accepted, and with the prefix cache its counters and
    each request's hit tokens."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, draft_model=draft,
                                   **(engine_kw or ENGINE_KW))
    eng.decode_step = _Calls(eng.decode_step)
    if eng.prefill_step is not None:
        eng.prefill_step = _Calls(eng.prefill_step)
    if eng.mixed is not None:
        eng.mixed = _Calls(eng.mixed)
    if eng.draft_step is not None:
        eng.draft_step = _Calls(eng.draft_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    step_s = []

    def step():
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    traffic = traffic or admit_4_4(prompts, sampled)
    t0 = time.perf_counter()
    rids = traffic(eng, step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(step_s)
    launches = _launches()
    outs = [eng.result(r) for r in rids]
    cache = eng.caches[0]
    if not pool_whole(eng):
        raise AssertionError("pool not whole after the run: %d free, %d "
                             "cached, of %d" % (
                                 len(cache._free),
                                 len(eng.prefix_cache or ()),
                                 cache.num_blocks))
    # the draft's pools share the target's page ids: their own free lists
    # are never drawn from
    if not all(len(c._free) == c.num_blocks for c in eng.draft_caches):
        raise AssertionError("a draft pool's free list moved")
    V = model.config.vocab_size
    if not all(0 <= t < V for o in outs for t in o):
        raise AssertionError("a served token lies outside the vocabulary")
    if not all(len(o) == NEW_TOKENS for o in outs):
        raise AssertionError("a request ended early: %s"
                             % [len(o) for o in outs])
    gen_tok = sum(len(o) for o in outs)
    prompt_tok = int(sum(len(eng.finished[r].prompt_ids) for r in rids))
    stats = dict(steps=steps, decode_steps=eng.decode_step.n,
                 prefill_chunks=(eng.prefill_step.n
                                 if eng.prefill_step is not None else 0),
                 prompt_tokens=prompt_tok,
                 prefilled_tokens=eng.prefill_tokens,
                 generated_tokens=gen_tok, wall_s=wall,
                 tokens_per_s=gen_tok / wall,
                 prompt_and_generated_tokens_per_s=(
                     gen_tok + prompt_tok) / wall,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 kv_pool_bytes=sum(c.pool_bytes() for c in eng.caches),
                 step_host_s=_spread(step_s),
                 launches=launches)
    if eng.mixed is not None:
        stats.update(token_budgets=list(eng.token_budgets),
                     budgets_seen=sorted(eng.mixed.compile_counts),
                     mixed_launches=eng.mixed.n)
    from paddle_tpu_torch.ops.paged_attention import (decode_generic,
                                                      ragged_generic)
    cfg = model.config
    stats.update(generic_ragged=eng.mixed is not None and ragged_generic(
        eng.head_dim, cfg.num_attention_heads // cfg.num_key_value_heads,
        cache.quantized, eng.block_size),
        generic_decode=decode_generic(eng.head_dim, eng.block_size))
    if eng.draft_step is not None:
        stats.update(
            draft_launches=eng.draft_step.n, spec_k=eng.spec_k,
            draft_layers=eng.draft_model.config.num_hidden_layers,
            draft_budgets_seen=sorted(eng.draft_step.compile_counts),
            spec_proposed=eng.spec_proposed,
            spec_accepted=eng.spec_accepted,
            acceptance_rate=eng.spec_accepted / max(1, eng.spec_proposed),
            full_chain_spans=eng.mixed.full_drafts,
            full_chain_accepts=eng.mixed.full_accepts)
    pc = eng.prefix_cache
    if pc is not None:
        stats.update(prefix_cache={a: getattr(pc, a) for a in (
            "hits", "misses", "hit_tokens", "evictions", "skipped_pinned",
            "spills", "host_hits", "restores")},
            cached_pages=len(pc),
            prefix_hit_tokens=[eng.finished[r].prefix_hit_tokens
                               for r in rids])
    if eng.prefill_step is not None:
        seen = sorted(eng.prefill_step.compile_counts)
        if len(seen) > len(eng.prefill_buckets):
            raise AssertionError("bucket widths seen %s exceed the bucket "
                                 "set %s" % (seen, eng.prefill_buckets))
        stats.update(prefill_buckets=list(eng.prefill_buckets),
                     buckets_seen=seen)
    return eng, outs, stats


def expected_launches(engine_kw, stats, layers):
    """The launches each serving kernel variant must show after one
    ``serve`` run: every layer of every step goes through its engine's
    kernels once, and through no other serving kernel (the generic
    kernels never: the served shapes have fast ones).  The mixed engine
    launches its target once a step, and a speculative one its draft
    ``draft_launches`` times a run, each through the draft's layers (the
    draft's pools are bf16: no int8 variant)."""
    int8 = engine_kw.get("kv_dtype") == "int8"
    want = _no_launches()
    rope = "rope_qkv_epilogue_amax" if int8 else "rope_qkv_epilogue"
    if engine_kw.get("weight_quant") == "int8":
        # one dequant a layer and one for the LM head, each target step
        target = (stats["mixed_launches"] if engine_kw.get("mixed_step")
                  else stats["decode_steps"] + stats["prefill_chunks"])
        want["dequant_int8"] = (layers + 1) * target
    if engine_kw.get("mixed_step"):
        if stats["mixed_launches"] != stats["steps"]:
            raise AssertionError("the mixed engine launched its target %d "
                                 "times in %d steps"
                                 % (stats["mixed_launches"], stats["steps"]))
        attn = "ragged_paged_attention" + ("_int8" if int8 else "")
        want[attn] = want[rope] = layers * stats["steps"]
        drafted = stats.get("draft_layers", 0) * stats.get(
            "draft_launches", 0)
        want["ragged_paged_attention"] += drafted
        want["rope_qkv_epilogue"] += drafted
        if stats["generic_ragged"]:
            if drafted:
                raise AssertionError("no speculative path runs the "
                                     "generic kernel")
            want[attn.replace("attention", "attention_generic")] = \
                want[attn]
    else:
        want["paged_attention" + ("_int8" if int8 else "")] = \
            layers * stats["decode_steps"]
        if stats["generic_decode"]:
            want["paged_attention_generic" + ("_int8" if int8 else "")] = \
                layers * stats["decode_steps"]
        # the dense prefill ropes inside the model's cache path
        want[rope] = layers * (stats["decode_steps"]
                               + stats["prefill_chunks"])
    return want


def check_launches(name, engine_kw, stats, layers):
    want = expected_launches(engine_kw, stats, layers)
    if stats["launches"] != want:
        raise AssertionError("%s launches %s, want %s"
                             % (name, stats["launches"], want))


def _kernel_kind(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "paged_decode_attention"
    if "ragged_paged_attention" in name or "ragged_tc_kernel" in name:
        return "ragged_paged_attention"
    if "rope_qkv" in name:
        return "rope_qkv_epilogue"
    if "fwd_tc_kernel" in name:
        return "flash_fwd (tensor cores)"
    if "bwd_dq_tc_kernel" in name:
        return "flash_bwd_dq (tensor cores)"
    if "bwd_kv_tc_kernel" in name:
        return "flash_bwd_kv (tensor cores)"
    if "rope_round_kernel" in name or "delta_kernel" in name:
        return "flash pre-passes (rope, delta)"
    if "flash_fwd" in name:
        return "flash_fwd"
    if "flash_bwd_kv_kernel" in name or "dq_finalize" in name:
        return "flash_bwd_kv (+dq finalize)"
    if "flash_bwd_dq" in name:
        return "flash_bwd_dq"
    if "rms_norm_kernel" in name:
        return "rms_norm"
    if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "sm90",
                               "nvjet")):
        return "matmul"
    return "other"


def profile_device(fn, unprofiled_wall_s):
    """``fn()`` once under ``torch.profiler``, device activity only:
    device time by kernel kind, the top kernels, and the device's idle
    share of the profiled wall and of ``unprofiled_wall_s`` (the same work
    without the profiler; kernel durations do not change under it, its
    host overhead does).  Host operators are not recorded: for a run of
    many small operators the profiler takes minutes to sort their events,
    and the host's share is read as the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # timed inside the context: starting the profiler is not the run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    averages = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in averages
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    by_kind = {}
    for name, t, _ in kernels:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return dict(profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
                profile_s=time.perf_counter() - t_start,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                unprofiled_wall_s=unprofiled_wall_s,
                unprofiled_device_idle_share=(
                    1.0 - busy_us / 1e6 / unprofiled_wall_s),
                device_s_by_kind={k: v / 1e6 for k, v in by_kind.items()},
                top_kernels=[dict(name=n[:80], device_s=t / 1e6, calls=c)
                             for n, t, c in top])


def profile_serve(name, model, prompts, unprofiled_wall_s,
                  engine_kw=None, traffic=None):
    """The same traffic once more under ``torch.profiler`` (see
    :func:`profile_device`)."""
    row = dict(phase="profile_" + name, **profile_device(
        lambda: serve(model, prompts, engine_kw, traffic=traffic),
        unprofiled_wall_s))
    emit(row)
    return row


# runs of the mixed engine over the same traffic: its wall follows the
# host, so it is given as the median of these with their spread
SERVE_REPEATS = 5


def _repeat_serve(name, model, prompts, kw, layers, first):
    """``SERVE_REPEATS - 1`` more runs of the traffic that gave ``first``
    (each with exact launches): every run's wall and the spread of its
    steps' host seconds, and the median wall with its throughput (the
    row's ``wall_s`` and ``tokens_per_s``; the first run's are kept as
    ``first_wall_s``)."""
    walls, steps = [first["wall_s"]], [first["step_host_s"]]
    for _ in range(SERVE_REPEATS - 1):
        _, _, st = serve(model, prompts, kw)
        check_launches(name, kw, st, layers)
        walls.append(st["wall_s"])
        steps.append(st["step_host_s"])
    wall = float(np.median(walls))
    return dict(first_wall_s=first["wall_s"], walls_s=walls,
                wall_s=wall, wall_spread_s=_spread(walls),
                tokens_per_s=first["generated_tokens"] / wall,
                prompt_and_generated_tokens_per_s=(
                    first["generated_tokens"] + first["prompt_tokens"])
                / wall,
                step_host_s_by_run=steps)


def first_step_logits(eng, model, prompt):
    """One prompt that fits a chunk through the engine's packed step (both
    kernels) against the eager forward (no kernel): the max difference of
    the last position's logits, beside the logits' spread."""
    import torch
    from paddle_tpu_torch.inference.serving import GenerationRequest
    cache = eng.caches[0]
    req = GenerationRequest(req_id=-1, prompt_ids=prompt)
    req.block_ids = [cache.allocate_block()
                     for _ in range(cache.blocks_needed(len(prompt)))]
    pack, B = eng._fill_mixed_pack(eng.mixed, eng.token_budgets,
                                   [(req, prompt.astype(np.int32), 0, 0,
                                     0, False)])
    got = eng.mixed.logits_packed(pack, B)[0]
    cache.free_sequence(req.block_ids)
    ids = torch.from_numpy(prompt)[None].to(model.device)
    # the eager cache path (explicit empty caches): no kernel
    want = model(ids, [(None, None)] * model.config.num_hidden_layers)[0]
    want = want[0, -1].float()
    return dict(first_step_max_logit_diff=(got - want).abs().max().item(),
                first_step_logit_std=want.std().item())


def serving_efficiency(eng, stats):
    """The engine's ``efficiency_stats(compute=True)`` (one analytic count
    of its steady-state launch) and the serving-step MFU it gives at the
    run's generated tokens/s against the bf16 dense peak: tokens/s x
    flops/token / 989 TFLOP/s, which must lie in (0, 1]."""
    eff = eng.efficiency_stats(compute=True)
    if eff is None:
        raise AssertionError("efficiency_stats gave no block: is "
                             "PADDLE_TPU_MFU_COST_ANALYSIS set to 0?")
    eff = dict(eff, tokens_per_s=stats["tokens_per_s"])
    eff["peak_flops"] = PEAK_FLOPS["bfloat16"]
    eff["serving_step_mfu"] = (stats["tokens_per_s"] * eff["flops_per_token"]
                               / PEAK_FLOPS["bfloat16"])
    if not 0 < eff["serving_step_mfu"] <= 1:
        raise AssertionError("serving-step MFU %r outside (0, 1]: %s"
                             % (eff["serving_step_mfu"], eff))
    return eff


def eager_tokens(model, prompts):
    import torch
    outs = []
    for p in prompts:
        ids = torch.from_numpy(p)[None].to(model.device)
        outs.append(model.generate(ids, NEW_TOKENS)[0, len(p):].tolist())
    return outs


def _rates(outs, ref):
    rates = [_match_rate(o, r) for o, r in zip(outs, ref)]
    return float(np.mean(rates)), rates


def phase_serving_7b():
    """Llama-2-7B bf16 at full width and depth, built once, serves the
    same traffic through the mixed engine (then profiled), the split
    engine with bucketed prefill (profiled), the split engine with the
    dense prefill, and both engines over int8 pools (the split one
    profiled: decode attention's int8 variant).  Each run's launches
    must be exact for its engine; the token matches against eager
    ``generate`` and against the bf16-pool engines are reported, not
    asserted (random bf16 logits tie)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config, param_count)
    cfg = llama_7b_config(dtype="bfloat16")
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    print("7b: %d parameters (%.2f GB bf16) initialized in %.1f s"
          % (param_count(cfg), param_count(cfg) * 2 / 1e9,
             time.perf_counter() - t0), flush=True)
    prompts = _prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    ref = eager_tokens(model, prompts)
    print("7b: eager generate (the token reference) in %.1f s"
          % (time.perf_counter() - t0), flush=True)
    runs, outs = {}, {}
    for name, kw in (("serve_7b", ENGINE_KW), ("serve_7b_split", SPLIT_KW),
                     ("serve_7b_dense", DENSE_KW),
                     ("serve_7b_kv8_split", dict(SPLIT_KW, kv_dtype="int8")),
                     ("serve_7b_kv8_mixed", dict(ENGINE_KW,
                                                 kv_dtype="int8"))):
        t1 = time.perf_counter()
        eng, outs[name], stats = serve(model, prompts, kw)
        check_launches(name, kw, stats, L)
        if name == "serve_7b":
            stats.update(first_step_logits(eng, model, prompts[0]))
            stats.update(_repeat_serve(name, model, prompts, kw, L, stats))
            stats["efficiency"] = serving_efficiency(eng, stats)
        del eng
        stats.update(phase=name + "_bf16", layers=L,
                     engine={k: v for k, v in kw.items()
                             if k not in ENGINE_BASE},
                     phase_wall_s=time.perf_counter() - t1)
        stats["eager_match_rate"], stats["eager_match_rate_per_request"] = \
            _rates(outs[name], ref)
        if "kv8" in name:
            fp = "serve_7b" if kw.get("mixed_step") else "serve_7b_split"
            stats["match_rate_vs_bf16_pool_engine"] = _rates(
                outs[name], outs[fp])[0]
            stats["pages_per_byte_vs_bf16_pool"] = (
                runs[fp]["kv_pool_bytes"] / stats["kv_pool_bytes"])
            if not stats["pages_per_byte_vs_bf16_pool"] >= 1.9:
                raise AssertionError(
                    "%s: int8 pools hold %.3fx the pages per byte of the "
                    "bf16 pools, want >= 1.9" % (
                        name, stats["pages_per_byte_vs_bf16_pool"]))
        if name == "serve_7b_split":
            stats["match_rate_vs_mixed_engine"] = _rates(
                outs[name], outs["serve_7b"])[0]
        emit(stats)
        runs[name] = stats
        if name in ("serve_7b", "serve_7b_split", "serve_7b_kv8_split"):
            runs[name]["profile"] = profile_serve(
                name + "_bf16", model, prompts, stats["wall_s"], kw)
    runs.update(serve_sampled_and_spec(model, prompts, ref, outs))
    t1 = time.perf_counter()
    runs.update(serve_w8(model, prompts, ref, outs,
                         dict(prefix="serve_7b", mixed="serve_7b",
                              split="serve_7b_split"), L))
    runs["serve_7b_disagg"], outs["serve_7b_disagg"] = serve_disagg(
        model, prompts, {"mixed_engine": outs["serve_7b"], "eager": ref})
    print("7b: the int8-weight and disaggregated runs in %.1f s"
          % (time.perf_counter() - t1), flush=True)
    t1 = time.perf_counter()
    runs.update(serve_prefix(model))
    print("7b: the prefix-cache runs in %.1f s" % (time.perf_counter() - t1),
          flush=True)
    t1 = time.perf_counter()
    runs["serve_7b_elastic"] = serve_elastic(model, prompts, outs["serve_7b"])
    print("7b: the elastic drill in %.1f s" % (time.perf_counter() - t1),
          flush=True)
    # the fleet's servers build their own 7B models: free this process's
    # engines' pools first (the model stays)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    runs["serve_7b_fleet"], outs["serve_7b_fleet"] = serve_fleet(
        cfg, prompts, outs["serve_7b_disagg"], runs["serve_7b_disagg"])
    print("7b: the multi-process fleet in %.1f s"
          % (time.perf_counter() - t1), flush=True)
    del model
    torch.cuda.empty_cache()
    runs.update(serve_head_dim_256())
    return runs


# a model whose head dim the fast paged kernels do not take: Gemma-2B's
# attention widths (hidden 2048, 8 query heads over 1 kv head, head dim
# 256) in a Llama block at 2 layers, bf16
D256_CFG = dict(hidden_size=2048, num_attention_heads=8,
                num_key_value_heads=1, intermediate_size=5632,
                num_hidden_layers=2, dtype="bfloat16")


def serve_head_dim_256():
    """The generic kernels' serving path: the phase-3 traffic through the
    mixed and split engines, bf16 and int8 pools, of a 2-layer model at
    head dim 256 (``D256_CFG``), where #5 and #7 route to their sources'
    generic kernels.  Launches exact (the generic counts too), pools
    whole; each engine against its run through the plain versions
    (reported: bf16 logits tie)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    cfg = llama_7b_config(**D256_CFG)
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for name, kw in (("serve_d256_mixed", ENGINE_KW),
                     ("serve_d256_split", SPLIT_KW),
                     ("serve_d256_kv8_mixed", dict(ENGINE_KW,
                                                   kv_dtype="int8")),
                     ("serve_d256_kv8_split", dict(SPLIT_KW,
                                                   kv_dtype="int8"))):
        _, got, stats = serve(model, prompts, kw)
        check_launches(name, kw, stats, cfg.num_hidden_layers)
        if not (stats["generic_ragged"] if kw.get("mixed_step")
                else stats["generic_decode"]):
            raise AssertionError("%s: head dim 256 must take the generic "
                                 "kernel" % name)
        with swapped_attention():
            _, plain, _ = serve(model, prompts, kw)
        stats.update(phase=name + "_bf16", layers=cfg.num_hidden_layers,
                     head_dim=256, engine={k: v for k, v in kw.items()
                                           if k not in ENGINE_BASE},
                     match_rate_vs_plain=_rates(got, plain)[0])
        emit(stats)
        runs[name] = stats
    del model
    torch.cuda.empty_cache()
    return runs


def sampling_draw_launches(S: int = 8, V: int = 32000):
    """What one sampling draw costs the host: the device operations one
    ``sample_logits`` call over [S, V] fp32 logits at ``SAMPLED_KNOBS``
    issues (kernels, and copies or sets), counted from
    ``torch.profiler``'s device events after a warm-up draw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.sampling import sample_logits
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    args = (torch.randn(S, V, generator=gen, device=dev),
            torch.full((S,), SAMPLED_KNOBS["temperature"], device=dev),
            torch.full((S,), SAMPLED_KNOBS["top_k"], dtype=torch.int32,
                       device=dev),
            torch.full((S,), SAMPLED_KNOBS["top_p"], device=dev),
            torch.arange(1, S + 1, dtype=torch.int32, device=dev),
            torch.full((S,), 1024, dtype=torch.int32, device=dev))
    sample_logits(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample_logits(*args)
        torch.cuda.synchronize()
    counts = {"kernels": 0, "copies": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key.lower()
            kind = ("copies" if "memcpy" in key or "memset" in key
                    else "kernels")
            counts[kind] += e.count
    return dict(draw_kernel_launches=counts["kernels"],
                draw_copies=counts["copies"], draw_shape=[S, V])


def serve_sampled_and_spec(model, prompts, ref, outs):
    """The sampling and speculative engines on phase 3's model and
    traffic: the mixed and split engines with ``sampling=True`` (sampled
    requests at ``SAMPLED_KNOBS`` with seed 1 + i, every fourth greedy),
    and the mixed engine with an 8-layer truncated draft (``spec_k`` 2),
    greedy and sampled.  Each run's launches must be exact (the target
    once per layer per step, the draft once per draft layer per draft
    launch, the split engine's decode kernel once per layer per decode
    step), both engines' pools whole, and each sampled engine serves the
    traffic twice with identical token streams.  Reported: walls,
    tokens/s, host seconds, the draft tokens proposed and accepted, the
    split engine's match against the mixed one (sampled), and the greedy
    spec engine's against the greedy mixed one (random bf16 logits tie,
    so neither is asserted)."""
    from paddle_tpu_torch.models.llama import llama_truncated_draft
    L = model.config.num_hidden_layers
    draft = llama_truncated_draft(model, DRAFT_LAYERS)
    runs = {}
    for name, kw, spec, sampled in (
            ("serve_7b_sampled", ENGINE_KW, False, True),
            ("serve_7b_split_sampled", SPLIT_KW, False, True),
            ("serve_7b_spec", dict(ENGINE_KW, spec_k=SPEC_K), True, False),
            ("serve_7b_spec_sampled", dict(ENGINE_KW, spec_k=SPEC_K), True,
             True)):
        t1 = time.perf_counter()
        kw = dict(kw, sampling=sampled)
        dr = draft if spec else None
        _, outs[name], stats = serve(model, prompts, kw, dr, sampled)
        check_launches(name, kw, stats, L)
        if sampled:
            _, again, replay = serve(model, prompts, kw, dr, sampled)
            check_launches(name + " replay", kw, replay, L)
            if again != outs[name]:
                raise AssertionError("%s: the replayed traffic sampled "
                                     "other tokens" % name)
            stats.update(replay_identical=True,
                         replay_wall_s=replay["wall_s"],
                         replay_tokens_per_s=replay["tokens_per_s"])
        stats.update(phase=name + "_bf16", layers=L,
                     engine={k: v for k, v in kw.items()
                             if k not in ENGINE_BASE},
                     phase_wall_s=time.perf_counter() - t1)
        if not sampled:
            stats["eager_match_rate"] = _rates(outs[name], ref)[0]
            stats["match_rate_vs_mixed_engine"] = _rates(
                outs[name], outs["serve_7b"])[0]
        if name == "serve_7b_split_sampled":
            stats["match_rate_vs_mixed_sampled"] = _rates(
                outs[name], outs["serve_7b_sampled"])[0]
        if name == "serve_7b_sampled":
            stats.update(sampling_draw_launches())
        emit(stats)
        runs[name] = stats
    del draft
    return runs


# ---- int8 weights and the disaggregated router ------------------------------
def dequantized_twin(model, eng):
    """A copy of ``model`` whose projection weights and LM head are
    ``eng``'s int8 tree dequantized (by the engine's own kernel): the fp
    engine that must give the w8 engine's tokens."""
    import copy
    import torch
    from paddle_tpu_torch.ops.dequant import LAYER_PROJECTIONS
    twin = copy.deepcopy(model)
    w8 = eng.weight_qtree
    with torch.no_grad():
        for i, layer in enumerate(twin.llama.layers):
            ws = w8.layer(i)
            for mod, name in LAYER_PROJECTIONS:
                getattr(getattr(layer, mod), name).weight.copy_(ws[name])
        head = w8.lm_head()
        if head is not None:
            twin.lm_head.weight.copy_(head)
    return twin


def serve_w8(model, prompts, ref, outs, runs_bf16, layers):
    """The int8-weight engines on ``model`` and the phase-3 traffic:
    ``serve_<...>_w8`` (the mixed engine) and ``serve_<...>_split_w8``
    (bucketed split), each with exact launches (the bf16 twins' kernels,
    plus ``dequant_int8`` (L + 1) times a target step) and a whole pool,
    then its dequantized twin (:func:`dequantized_twin`, the same engine
    without ``weight_quant``) over the same traffic, which must give its
    tokens at >= 0.98.  Reported: the match against the bf16 engine
    (``runs_bf16`` names the run per engine; random weights, so low),
    against eager ``generate`` (``ref``), tokens/s, host seconds a step,
    ``weight_quant_bytes`` and peak memory (the model keeps its own
    weights, so the int8 tree comes on top).  Returns the rows; the
    streams land in ``outs``."""
    import torch
    prefix = runs_bf16["prefix"]
    runs = {}
    for suffix, kw, bf16 in (("w8", W8_KW, runs_bf16["mixed"]),
                             ("split_w8", SPLIT_W8_KW, runs_bf16["split"])):
        name = "%s_%s" % (prefix, suffix)
        t1 = time.perf_counter()
        eng, outs[name], stats = serve(model, prompts, kw)
        check_launches(name, kw, stats, layers)
        twin = dequantized_twin(model, eng)
        stats.update(weight_quant_bytes=eng.weight_quant_bytes,
                     model_bytes=sum(p.numel() * p.element_size()
                                     for p in model.parameters()))
        del eng
        twin_kw = {k: v for k, v in kw.items() if k != "weight_quant"}
        twin_eng, twin_out, twin_stats = serve(twin, prompts, twin_kw)
        check_launches(name + " twin", twin_kw, twin_stats, layers)
        del twin_eng, twin
        torch.cuda.empty_cache()
        stats.update(phase=name, layers=layers,
                     engine={k: v for k, v in kw.items()
                             if k not in ENGINE_BASE},
                     match_rate_vs_dequantized_twin=_rates(outs[name],
                                                           twin_out)[0],
                     twin_wall_s=twin_stats["wall_s"],
                     phase_wall_s=time.perf_counter() - t1)
        if ref is not None:
            stats["eager_match_rate"] = _rates(outs[name], ref)[0]
        if bf16 in outs:
            stats["match_rate_vs_fp_engine"] = _rates(outs[name],
                                                      outs[bf16])[0]
        emit(stats)
        if not stats["match_rate_vs_dequantized_twin"] >= 0.98:
            raise AssertionError(
                "%s: token match %.4f against its dequantized twin < 0.98"
                % (name, stats["match_rate_vs_dequantized_twin"]))
        runs[name] = stats
    return runs


@contextlib.contextmanager
def timed_migrations(log: list):
    """While open, every engine's ``extract_request`` that produced a
    buffer and every ``inject_request`` appends ``(kind, pages, bytes,
    host seconds)`` to ``log``, the device synchronized around each
    call: the engine's own page moves, timed in the run that makes
    them."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    cls = ContinuousBatchingEngine
    extract, inject = cls.extract_request, cls.inject_request

    def timed_extract(self, req_id):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = extract(self, req_id)
        torch.cuda.synchronize()
        if out[2] is not None:
            log.append(("extract", out[2].n_pages, out[2].nbytes,
                        time.perf_counter() - t))
        return out

    def timed_inject(self, prompt_ids, buffer, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rid = inject(self, prompt_ids, buffer, *args, **kw)
        torch.cuda.synchronize()
        log.append(("inject", buffer.n_pages, buffer.nbytes,
                    time.perf_counter() - t))
        return rid
    cls.extract_request, cls.inject_request = timed_extract, timed_inject
    try:
        yield log
    finally:
        cls.extract_request, cls.inject_request = extract, inject


def serve_disagg(model, prompts, against, name="serve_7b_disagg"):
    """One ``ServingRouter`` over a ``role="prefill"`` mixed engine
    (``DISAGG_PREFILL_KW``) and a ``role="decode"`` split engine
    (``DISAGG_DECODE_KW``) that share ``model``, serving the phase-3
    traffic (admit 4, a router step, admit 4, run to completion).  Gates:
    every request starts on the prefill engine and finishes on the decode
    engine after one migration at least; the decode engine prefills 0
    prompt tokens; each migration is one device-to-host and one
    host-to-device copy (``MIGRATION_TRANSFERS``: bf16 or fp32 pools, one
    dtype); the bytes moved each way are the pages moved times the bytes
    of one page over all layers; #5's launches are L x the prefill
    engine's steps, #7's L x the decode engine's decode steps, #6's the
    sum; every request's span chain validates; both pools whole.
    Reported: wall, tokens/s, the router's TTFT/TPOT digests, the page
    moves' seconds, and the token match against each stream list of
    ``against`` (name -> streams).  Returns the row and the streams."""
    import torch
    from paddle_tpu_torch.inference.router import ServingRouter
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.jit.serving_step import migration_transfers
    from paddle_tpu_torch.observability.request_trace import (
        validate_span_chain)
    L = model.config.num_hidden_layers
    pe = ContinuousBatchingEngine(model, **DISAGG_PREFILL_KW)
    de = ContinuousBatchingEngine(model, **DISAGG_DECODE_KW)
    pe.mixed = _Calls(pe.mixed)
    de.decode_step = _Calls(de.decode_step)
    de.prefill_step = _Calls(de.prefill_step)
    router = ServingRouter([pe, de])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = migration_transfers()
    moves = []
    steps = 0
    start = time.perf_counter()
    with timed_migrations(moves):
        rids = [router.submit(p, NEW_TOKENS) for p in prompts[:4]]
        router.step()
        steps += 1
        rids += [router.submit(p, NEW_TOKENS) for p in prompts[4:]]
        while router.has_work():
            router.step()
            steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    t1 = migration_transfers()
    launches = _launches()
    recs = [router.finished[r] for r in rids]
    outs = [rr.output_ids for rr in recs]
    migrations = sum(rr.migrations for rr in recs)
    extracts = [m for m in moves if m[0] == "extract"]
    injects = [m for m in moves if m[0] == "inject"]
    geo = pe.caches[0]
    page_bytes = (2 * L * geo.block_size * geo.num_kv_heads * geo.head_dim
                  * geo.key_cache.element_size())
    pages = sum(m[1] for m in extracts)
    want = _no_launches()
    want["ragged_paged_attention"] = L * pe.mixed.n
    want["paged_attention"] = L * de.decode_step.n
    want["rope_qkv_epilogue"] = L * (pe.mixed.n + de.decode_step.n
                                     + de.prefill_step.n)
    chains = [validate_span_chain(router.tracer.events(r)) for r in rids]
    row = dict(
        phase=name, layers=L, requests=len(rids), router_steps=steps,
        prefill_engine={k: v for k, v in DISAGG_PREFILL_KW.items()
                        if k not in ENGINE_BASE or k == "num_blocks"},
        decode_engine={k: v for k, v in DISAGG_DECODE_KW.items()
                       if k not in ENGINE_BASE or k == "num_blocks"},
        engines_visited=[rr.engines_visited() for rr in recs],
        migrations=migrations, d2h=t1["d2h"] - t0["d2h"],
        h2d=t1["h2d"] - t0["h2d"], pages_moved=pages,
        page_bytes=page_bytes,
        bytes_out=sum(m[2] for m in extracts),
        bytes_in=sum(m[2] for m in injects),
        extract_s=_spread([m[3] for m in extracts]) if extracts else None,
        inject_s=_spread([m[3] for m in injects]) if injects else None,
        prefill_engine_steps=pe.mixed.n,
        decode_engine_decode_steps=de.decode_step.n,
        decode_engine_prefill_chunks=de.prefill_step.n,
        decode_engine_prefilled_tokens=de.prefill_tokens,
        prefill_engine_prefilled_tokens=pe.prefill_tokens,
        generated_tokens=sum(len(o) for o in outs), wall_s=wall,
        tokens_per_s=sum(len(o) for o in outs) / wall,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        slo=router.slo_snapshot(), launches=launches,
        span_chains_valid=all(ok for ok, _ in chains),
        **{"match_rate_vs_" + k: _rates(outs, v)[0]
           for k, v in against.items()})
    bad = []
    ids = (pe.engine_id, de.engine_id)
    if not all(rr.engines_visited()[0] == ids[0]
               and rr.engines_visited()[-1] == ids[1]
               and rr.migrations >= 1 for rr in recs):
        bad.append("a request did not go prefill -> decode: %s"
                   % row["engines_visited"])
    if de.prefill_tokens:
        bad.append("the decode engine prefilled %d tokens"
                   % de.prefill_tokens)
    if (row["d2h"], row["h2d"]) != (migrations, migrations) \
            or len(extracts) != migrations or len(injects) != migrations:
        bad.append("%d migrations made %d d2h / %d h2d copies, %d extracts "
                   "and %d injects" % (migrations, row["d2h"], row["h2d"],
                                       len(extracts), len(injects)))
    if not row["bytes_out"] == row["bytes_in"] == pages * page_bytes:
        bad.append("bytes out %d, in %d, want %d pages x %d"
                   % (row["bytes_out"], row["bytes_in"], pages, page_bytes))
    if launches != want:
        bad.append("launches %s, want %s" % (launches, want))
    if not row["span_chains_valid"]:
        bad.append("span chains: %s" % [why for ok, why in chains if not ok])
    for eng in (pe, de):
        if not pool_whole(eng):
            bad.append("engine %d's pool is not whole" % eng.engine_id)
    if not all(len(o) == NEW_TOKENS for o in outs):
        bad.append("a request ended early: %s" % [len(o) for o in outs])
    emit(row)
    if bad:
        raise AssertionError("%s: %s" % (name, "; ".join(bad)))
    return row, outs


# ---- the multi-process fleet: engines in server processes -----------------
# RPC deadlines of a 7B fleet: a step is tens of milliseconds, a
# migration's frame 8 MiB a page; these only bound a lost server
FLEET_TIMEOUTS = dict(hello=120.0, add_request=120.0, step=300.0,
                      preempt_request=120.0, extract_request=300.0,
                      inject_request=300.0, health_payload=60.0, ping=10.0,
                      shutdown=30.0)
FLEET_WARM = {"prompt_len": 64, "budget": 4}
FLEET_STARTUP_S = 600.0


def server_config(engine_kw, engine_id, dtype="bfloat16", layers=None,
                  **extra):
    """The engine-server config (``inference/engine_server.py``) of an
    engine built with ``engine_kw`` over the phase's model: Llama-2-7B
    widths from ``SEED`` in ``dtype``, cut to ``layers``, warmed before
    it publishes its port."""
    kw = dict(engine_kw)
    cfg = {"model": "7b", "dtype": dtype, "seed": SEED,
           "engine_id": engine_id, "warm": FLEET_WARM,
           "slots": kw.pop("max_batch_size"),
           "num_blocks": kw.pop("num_blocks"),
           "block_size": kw.pop("block_size"),
           "chunk": kw.pop("prefill_chunk_size", None),
           "mixed_step": kw.pop("mixed_step", False),
           "enable_prefix_cache": kw.pop("enable_prefix_cache", False)}
    for key in ("max_seq_len", "prefill_buckets", "role", "kv_dtype"):
        if key in kw:
            cfg[key] = kw.pop(key)
    if kw:
        raise ValueError("no engine-server key for %s" % sorted(kw))
    if layers is not None:
        cfg["layers"] = layers
    cfg.update(extra)
    return cfg


def spawn_fleet(configs):
    """Start one ``EngineProcess`` a config, all at once (each child is a
    fresh ``python -m paddle_tpu_torch.inference.engine_server``, started
    with ``subprocess``: this process has touched CUDA, so nothing here
    forks it), and wait until every one has warmed and published its
    port.  Returns the processes and each one's spawn + warm seconds;
    if one fails, every one is killed."""
    import threading
    from paddle_tpu_torch.inference.fleet import EngineProcess
    procs = [EngineProcess(c, startup_timeout=FLEET_STARTUP_S)
             for c in configs]
    secs, errors = [0.0] * len(procs), []

    def start(i):
        t = time.perf_counter()
        try:
            procs[i].spawn()
        except BaseException as e:                    # noqa: BLE001
            errors.append(e)
        secs[i] = time.perf_counter() - t
    threads = [threading.Thread(target=start, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for p in procs:
            p.kill()
        raise errors[0]
    return procs, secs


def fleet_client(proc, **timeouts):
    """A ``RemoteEngineClient`` of ``proc`` reading a fresh health payload
    on every probe, as the router reads an in-process engine."""
    from paddle_tpu_torch.inference.fleet import (RemoteEngineClient,
                                                  RetryPolicy)
    return RemoteEngineClient(
        proc.address, timeouts=dict(FLEET_TIMEOUTS, **timeouts),
        retry=RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.5),
        health_cache_s=0.0)


def stop_fleet(procs, clients):
    """Shut every server down through its ``shutdown`` RPC and return
    its exit record (``{"engine_server": {...}}``, the last line of its
    log: launch counts, step launches, prefilled tokens, peak memory)."""
    from paddle_tpu_torch.inference.fleet import EngineRPCError
    records = []
    for p, c in zip(procs, clients):
        try:
            c.shutdown_server()
            rc = p.wait(timeout=120.0)
        except EngineRPCError as e:
            rc = e
        with open(p.log_path) as f:
            lines = f.read().strip().splitlines()
        if rc != 0 or not lines:
            raise AssertionError("engine server %s: %r; its log ends %s"
                                 % (p.address, rc, lines[-20:]))
        records.append(json.loads(lines[-1])["engine_server"])
    return records


@contextlib.contextmanager
def wire_log(log: list):
    """While open, every PTF1 frame this process sends or receives with
    KV blobs appends ``(direction, blob count, blob bytes)`` to ``log``."""
    from paddle_tpu_torch.inference import fleet
    send, recv = fleet.send_frame, fleet.recv_frame

    def logged_send(sock, obj, blobs=(), deadline=None):
        if blobs:
            log.append(("out", len(blobs), sum(len(b) for b in blobs)))
        return send(sock, obj, blobs, deadline)

    def logged_recv(sock, deadline=None):
        obj, blobs = recv(sock, deadline)
        if blobs:
            log.append(("in", len(blobs), sum(len(b) for b in blobs)))
        return obj, blobs
    fleet.send_frame, fleet.recv_frame = logged_send, logged_recv
    try:
        yield log
    finally:
        fleet.send_frame, fleet.recv_frame = send, recv


def timed_remote_migrations(clients, log: list):
    """Every ``extract_request`` that returned pages and every
    ``inject_request`` of ``clients`` appends ``(kind, pages, bytes, host
    seconds)`` to ``log``: the RPC, the server's page move and the
    frame's bytes on the socket."""
    for c in clients:
        def extract(req_id, _f=c.extract_request):
            t = time.perf_counter()
            out = _f(req_id)
            if out[2] is not None:
                log.append(("extract", out[2].n_pages, out[2].nbytes,
                            time.perf_counter() - t))
            return out

        def inject(prompt_ids, buffer, *args, _f=c.inject_request, **kw):
            t = time.perf_counter()
            rid = _f(prompt_ids, buffer, *args, **kw)
            log.append(("inject", buffer.n_pages, buffer.nbytes,
                        time.perf_counter() - t))
            return rid
        c.extract_request, c.inject_request = extract, inject


def serve_router(router, prompts, step=None):
    """The phase-3 traffic through ``router``: admit 4, a router step,
    admit the rest, run to completion (``NEW_TOKENS`` each).  Returns the
    rids and the router steps taken."""
    budget = NEW_TOKENS
    step = step or router.step
    rids = [router.submit(p, budget) for p in prompts[:4]]
    step()
    n = 1
    rids += [router.submit(p, budget) for p in prompts[4:]]
    while router.has_work():
        step()
        n += 1
    return rids, n


def rpc_digests(before=None):
    """The ``router_rpc_latency_seconds`` histogram of this process by
    method: calls, mean seconds and the p50/p95/p99 bucket estimates
    (``before``: an earlier result, whose calls are subtracted)."""
    from paddle_tpu_torch.observability import default_registry
    h = default_registry().get("router_rpc_latency_seconds")
    out = {}
    for ch in (h.children() if h is not None else []):
        n, s = ch.count, ch.sum
        b = (before or {}).get(ch.labels["method"])
        if b is not None:
            n, s = n - b["calls"], s - b["sum_s"]
        out[ch.labels["method"]] = dict(
            calls=n, sum_s=s, mean_s=s / n if n else None,
            **{"p%d_s" % q: ch.quantile(q / 100) for q in (50, 95, 99)})
    return out


def fleet_want_launches(rec, layers):
    """The launches one server's exit record must show: its mixed step
    ``layers`` x launches of ragged attention and of the epilogue; its
    split engine ``layers`` x decode steps of decode attention and
    ``layers`` x (decode steps + prefill chunks) of the epilogue;
    nothing else."""
    steps = rec["steps"]
    want = _no_launches()
    want["ragged_paged_attention"] = layers * steps.get("mixed", 0)
    want["paged_attention"] = layers * steps.get("decode", 0)
    want["rope_qkv_epilogue"] = layers * (steps.get("mixed", 0)
                                          + steps.get("decode", 0)
                                          + steps.get("prefill", 0))
    return want


# where the fleet phase writes the router process's profiler trace and the
# merged trace (git-ignored)
FLEET_TRACE_DIR = "build/fleet_trace"


def validate_merged_trace(path):
    """The merged chrome trace parses, every complete span has a
    numeric start >= 0 and a duration >= 0, and it holds the profiler's
    events and the router's request lanes.  Returns the counts."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    bad = [e for e in spans
           if not (isinstance(e.get("ts"), (int, float)) and e["ts"] >= 0
                   and isinstance(e.get("dur"), (int, float))
                   and e["dur"] >= 0)]
    profiler = [e for e in events if e.get("ph") != "M"
                and e.get("pid", 0) >= 1_000_000]
    lanes = [e for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name"
             and str(e.get("args", {}).get("name", "")).startswith("req ")]
    if bad or not profiler or not lanes or not spans:
        raise AssertionError(
            "merged trace %s: %d spans (%d malformed), %d profiler events,"
            " %d request lanes" % (path, len(spans), len(bad),
                                   len(profiler), len(lanes)))
    return dict(events=len(events), spans=len(spans),
                profiler_events=len(profiler), request_lanes=len(lanes))


def serve_fleet(cfg, prompts, against, disagg, name="serve_7b_fleet"):
    """The cross-process counterpart of :func:`serve_disagg`: two
    ``EngineProcess`` servers of Llama-2-7B bf16 (``SEED``), a
    ``role="prefill"`` mixed engine (``DISAGG_PREFILL_KW``) and a
    ``role="decode"`` split engine (``DISAGG_DECODE_KW``), each warmed
    before it publishes its port, behind one ``ServingRouter(capacity=
    True)`` of remote clients (``RemoteEngineClient``) in this process,
    serving the phase-3 traffic.

    Gates: the streams equal ``against`` (the in-process disaggregated
    run's, same model, keyword arguments and router order); every request
    goes prefill -> decode; the decode process prefilled 0 tokens; each
    migration is one frame each way carrying the request's pages, the
    bytes each way the pages moved times 8 MiB; each server's launches
    exact for its engine (its exit record: #5 and #6 on the prefill
    process, #7 and #6 on the decode process, nothing else); every span
    chain valid; both pools whole.  Reported: wall and tokens/s beside
    ``disagg`` (the in-process row), the ``router_rpc_*`` latency
    digests, each migration's seconds over the socket beside the
    in-process page moves, each process's spawn + warm seconds and peak
    memory, and the capacity plan.  Then the same traffic once more
    under ``torch.profiler`` (this router process's host activity, a
    ``record_function`` range per router step), its chrome trace merged
    with the request spans (``observability.fleet_trace``); the merged
    file must validate (:func:`validate_merged_trace`).  ``cfg`` is the
    model's config (the servers build it from ``SEED``).  Returns the row
    and the streams."""
    from paddle_tpu_torch.inference.router import ServingRouter
    from paddle_tpu_torch.observability.request_trace import (
        fleet_trace, validate_span_chain)
    L = cfg.num_hidden_layers
    ids = (1910, 1911)
    procs, spawn_s = spawn_fleet([
        server_config(DISAGG_PREFILL_KW, ids[0]),
        server_config(DISAGG_DECODE_KW, ids[1])])
    try:
        clients = [fleet_client(p) for p in procs]
        router = ServingRouter(clients, capacity=True)
        moves, frames = [], []
        timed_remote_migrations(clients, moves)
        rpc0 = rpc_digests()
        start = time.perf_counter()
        with wire_log(frames):
            rids, steps = serve_router(router, prompts)
        wall = time.perf_counter() - start
        rpc = rpc_digests(rpc0)
        recs = [router.finished[r] for r in rids]
        outs = [rr.output_ids for rr in recs]
        chains = [validate_span_chain(router.tracer.events(r))
                  for r in rids]
        health = [c.health_payload() for c in clients]
        plan = router.capacity_plan()
        # the profiled run: the same traffic, this process's host
        # activity with one range per router step
        from torch.profiler import ProfilerActivity, profile, record_function

        def traced_step():
            with record_function("router.step"):
                router.step()
        import os
        os.makedirs(FLEET_TRACE_DIR, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rids2, _ = serve_router(router, prompts, step=traced_step)
        prof.export_chrome_trace(os.path.join(FLEET_TRACE_DIR,
                                              "router.pt.trace.json"))
        trace = fleet_trace(FLEET_TRACE_DIR + ".json", router,
                            device_trace_dir=FLEET_TRACE_DIR)
        trace.update(validate_merged_trace(trace["path"]))
        outs2 = [router.finished[r].output_ids for r in rids2]
        migrations2 = sum(router.finished[r].migrations for r in rids2)
        exits = stop_fleet(procs, clients)
    finally:
        for p in procs:
            p.kill()
    extracts = [m for m in moves if m[0] == "extract"]
    injects = [m for m in moves if m[0] == "inject"]
    migrations = sum(rr.migrations for rr in recs)
    import torch
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    page_bytes = (2 * L * DISAGG_PREFILL_KW["block_size"]
                  * cfg.num_key_value_heads * head_dim
                  * torch.empty((), dtype=cfg.torch_dtype).element_size())
    pages = sum(m[1] for m in extracts[:migrations])
    frames_in = [f for f in frames if f[0] == "in"]
    frames_out = [f for f in frames if f[0] == "out"]
    launches = {k: sum(e["launches"][k] for e in exits)
                for k in _no_launches()}
    row = dict(
        phase=name, layers=L, requests=len(rids), router_steps=steps,
        engines_visited=[rr.engines_visited() for rr in recs],
        migrations=migrations, pages_moved=pages, page_bytes=page_bytes,
        wire_frames_in=len(frames_in), wire_frames_out=len(frames_out),
        wire_bytes_in=sum(f[2] for f in frames_in),
        wire_bytes_out=sum(f[2] for f in frames_out),
        migration_s_socket=_spread([e[3] + i[3] for e, i in zip(
            extracts[:migrations], injects[:migrations])]),
        extract_s_socket=_spread([m[3] for m in extracts[:migrations]]),
        inject_s_socket=_spread([m[3] for m in injects[:migrations]]),
        extract_s_in_process=disagg.get("extract_s"),
        inject_s_in_process=disagg.get("inject_s"),
        generated_tokens=sum(len(o) for o in outs), wall_s=wall,
        tokens_per_s=sum(len(o) for o in outs) / wall,
        in_process_wall_s=disagg["wall_s"],
        in_process_tokens_per_s=disagg["tokens_per_s"],
        rpc_latency=rpc, slo=router.slo_snapshot(),
        spawn_and_warm_s=spawn_s, servers=exits, launches=launches,
        capacity_plan=plan, pools=[{k: h[k] for k in (
            "engine_id", "free_pages", "total_pages")} for h in health],
        span_chains_valid=all(ok for ok, _ in chains),
        match_rate_vs_in_process=_rates(outs, against)[0],
        profiled_run_match_rate=_rates(outs2, against)[0],
        merged_trace=trace)
    bad = []
    if outs != against or outs2 != against:
        bad.append("streams differ from the in-process disaggregated "
                   "run's: %s, profiled run %s" % (
                       [_match_rate(o, a) for o, a in zip(outs, against)],
                       [_match_rate(o, a) for o, a in zip(outs2, against)]))
    if not all(rr.engines_visited()[0] == ids[0]
               and rr.engines_visited()[-1] == ids[1]
               and rr.migrations >= 1 for rr in recs):
        bad.append("a request did not go prefill -> decode: %s"
                   % row["engines_visited"])
    pre, dec = exits
    if dec["prefill_tokens"] or dec["steps"].get("prefill"):
        bad.append("the decode process prefilled %d tokens in %d chunks"
                   % (dec["prefill_tokens"], dec["steps"].get("prefill")))
    # the wire log covers the first run: one frame each way a migration
    if not (len(frames_in) == len(frames_out) == migrations
            and len(extracts) == len(injects) == migrations + migrations2
            and all(f[1] == 1 for f in frames)):
        bad.append("%d migrations made %d frames in, %d out (%d extracts, "
                   "%d injects over both runs)" % (
                       migrations, len(frames_in), len(frames_out),
                       len(extracts), len(injects)))
    if not (row["wire_bytes_in"] == row["wire_bytes_out"]
            == pages * page_bytes):
        bad.append("wire bytes in %d, out %d, want %d pages x %d"
                   % (row["wire_bytes_in"], row["wire_bytes_out"], pages,
                      page_bytes))
    for rec in exits:
        want = fleet_want_launches(rec, L)
        if rec["launches"] != want:
            bad.append("engine %d launches %s, want %s"
                       % (rec["engine_id"], rec["launches"], want))
    if not pre["steps"].get("mixed") or not dec["steps"].get("decode"):
        bad.append("a server did not step: %s" % [e["steps"]
                                                   for e in exits])
    if not row["span_chains_valid"]:
        bad.append("span chains: %s" % [why for ok, why in chains if not ok])
    for h in health:
        if h["free_pages"] != h["total_pages"]:
            bad.append("engine %d's pool is not whole: %d of %d free"
                       % (h["engine_id"], h["free_pages"],
                          h["total_pages"]))
    emit(row)
    if bad:
        raise AssertionError("%s: %s" % (name, "; ".join(bad)))
    return row, outs


ELASTIC_KW = dict(ENGINE_KW, num_blocks=320)


def serve_elastic(model, prompts, against, name="serve_7b_elastic"):
    """The elastic drill (``tools/bench_elastic.py``'s
    ``bench_elastic_drill`` shape) in process on ``model``: three mixed
    engines (``ELASTIC_KW``: 320 pages each) warmed, two behind a
    ``ServingRouter`` with ``CapacityConfig(min_dwell=2, halflife_s=0.05,
    sample_every=1)``, the third the standby of an ``ElasticController(
    min_engines=1, max_engines=3, cooldown_steps=4)`` stepped after every
    router step.  An overload wave (the phase-3 prompts twice: 16
    requests on 16 slots) runs to completion; idle steps follow until the
    controller acts on the planner's scale_down; then 4 more requests are
    brought mid-decode and a scale_down is forced.  Gates: the controller
    actuated at least one scale_up and one planner scale_down; the forced
    drain's fates all ``"migrated"`` (none re-prefilled) and no prompt
    token prefilled twice (the engines' prefilled tokens are the prompts'
    once); every request finished its budget; every pool whole; launches
    exact (each engine's mixed step: L x launches of #5 and #6).
    Reported: the actions, pool sizes, saturation peak, walls, tokens/s
    and the overload wave's match with ``against`` (the mixed engine's
    streams of the same prompts).  Returns the row."""
    import torch
    from paddle_tpu_torch.inference.elastic import ElasticController
    from paddle_tpu_torch.inference.router import ServingRouter
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.observability.capacity import CapacityConfig
    L, V = model.config.num_hidden_layers, model.config.vocab_size
    engines = [ContinuousBatchingEngine(model, engine_id=1970 + i,
                                        **ELASTIC_KW) for i in range(3)]
    rng = np.random.RandomState(SEED + 3)
    for eng in engines:
        eng.add_request(rng.randint(V - 50, V, (64,)).astype(np.int64), 4)
        eng.run_to_completion()
        eng.finished.clear()
        eng.mixed = _Calls(eng.mixed)
        eng.prefill_tokens = 0
    torch.cuda.synchronize()
    _reset_launches()
    router = ServingRouter(engines[:2], capacity=CapacityConfig(
        min_dwell=2, halflife_s=0.05, sample_every=1))
    ctl = ElasticController(router, standby=[engines[2]], min_engines=1,
                            max_engines=3, cooldown_steps=4)
    plens = {}

    def submit(ps):
        out = []
        for p in ps:
            rid = router.submit(p, NEW_TOKENS)
            plens[rid] = len(p)
            out.append(rid)
        return out
    pool_sizes, sat_peak = [len(router.handles)], 0.0
    t0 = time.perf_counter()
    wave = submit(list(prompts) * 2)
    while router.has_work():
        router.step()
        ctl.step()
        pool_sizes.append(len(router.handles))
        sat_peak = max(sat_peak,
                       router.capacity.fleet_signals()["saturation"])
    torch.cuda.synchronize()
    overload_s = time.perf_counter() - t0
    for _ in range(300):                     # bounded: fail, don't spin
        router.step()
        ctl.step()
        pool_sizes.append(len(router.handles))
        if any(a[1] == "scale_down" for a in ctl.actions):
            break
        time.sleep(0.01)
    planned = [a[1] for a in ctl.actions]
    drained = submit(prompts[:4])
    for _ in range(400):                     # until all 4 are extractable
        router.step()
        live = [router._inflight[k] for k in list(router._inflight)]
        if len(live) == len(drained) and all(
                rr.engine_req is not None
                and getattr(rr.engine_req, "state", "") == "running"
                and rr.engine_req.output_ids for rr in live):
            break
    before_drain = len(router.handles)
    fates = (ctl.actions[-1][2]["fates"]
             if ctl._scale_down() == "scale_down" else {})
    while router.has_work():
        router.step()
        pool_sizes.append(len(router.handles))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    mixed_launches = sum(e.mixed.n for e in engines)
    want = _no_launches()
    want["ragged_paged_attention"] = want["rope_qkv_epilogue"] = \
        L * mixed_launches
    outs = {r: router.finished[r].output_ids for r in plens}
    gen = sum(len(o) for o in outs.values())
    row = dict(
        phase=name, layers=L, requests=len(plens),
        engine={k: v for k, v in ELASTIC_KW.items()
                if k not in ENGINE_BASE or k == "num_blocks"},
        controller_actions=[(a[1], a[2]) for a in ctl.actions],
        planner_actions=list(router.capacity.planner.actions),
        pool_sizes=dict(min=min(pool_sizes), max=max(pool_sizes),
                        final=len(router.handles),
                        before_forced_drain=before_drain),
        saturation_peak=sat_peak, forced_drain_fates=fates,
        prefilled_tokens=sum(e.prefill_tokens for e in engines),
        prompt_tokens=sum(plens.values()), overload_wall_s=overload_s,
        wall_s=wall, generated_tokens=gen, tokens_per_s=gen / wall,
        mixed_launches=mixed_launches, launches=launches,
        overload_match_rate_vs_mixed_engine=_rates(
            [outs[r] for r in wave], list(against) * 2)[0])
    bad = []
    if "scale_up" not in planned or "scale_down" not in planned:
        bad.append("the controller actuated %s before the forced drain"
                   % planned)
    if not fates or fates.get("re_prefilled") or not fates.get("migrated"):
        bad.append("forced drain fates %s" % fates)
    if row["prefilled_tokens"] != row["prompt_tokens"]:
        bad.append("prefilled %d tokens for %d prompt tokens"
                   % (row["prefilled_tokens"], row["prompt_tokens"]))
    if sorted(outs) != sorted(plens) or not all(
            len(o) == NEW_TOKENS for o in outs.values()):
        bad.append("dropped or short requests: %s"
                   % sorted(len(o) for o in outs.values()))
    for eng in engines:
        if not pool_whole(eng):
            bad.append("engine %d's pool is not whole" % eng.engine_id)
    if launches != want:
        bad.append("launches %s, want %s" % (launches, want))
    emit(row)
    if bad:
        raise AssertionError("%s: %s" % (name, "; ".join(bad)))
    return row


def fleet_drills_2l(model, prompts):
    """The reference's four slow fleet drills on two mixed port processes
    (``ENGINE_KW``) of Llama-2-7B widths at 2 layers in fp32 (the phase's
    model, ``SEED``), and a third whose RPC plane hangs
    (``hang:rpc.recv:ms=60000:after=4``):

    - the pool: a router over the two processes serves the phase-3
      traffic byte-identical to the same router over two in-process
      engines (the twin: same model, keyword arguments and engine ids),
      both processes serving;
    - cross-socket migration: a request extracted mid-decode from one
      process resumes on the other by ``inject_request``; its stream
      against the twin's >= 0.98;
    - the hang: a router over one process and the hung one (2 s RPC
      deadlines) drains the hung engine by its deadline and finishes
      every request at full budget (zero drops);
    - kill -9 of one process mid-decode: zero drops, every request at
      full budget, ``engine_lost`` counted, the survivor's pool whole;
      the streams the kill did not touch >= 0.98 of the twin's, the
      re-prefilled ones' match reported.

    Returns the row and the gates (name -> rate, each >= 0.98 in the
    caller)."""
    from paddle_tpu_torch.inference.router import ServingRouter
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import default_registry
    ids = (1980, 1981, 1986)
    short = dict(step=2.0, add_request=2.0, extract_request=2.0,
                 preempt_request=2.0, health_payload=1.0)
    t0 = time.perf_counter()
    procs, spawn_s = spawn_fleet(
        [server_config(ENGINE_KW, i, dtype="float32", layers=2)
         for i in ids[:2]]
        + [server_config(ENGINE_KW, ids[2], dtype="float32", layers=2,
                         fault_spec="hang:rpc.recv:ms=60000:after=4")])
    row, gates, bad = dict(phase="parity_2l_fleet",
                           spawn_and_warm_s=spawn_s), {}, []
    try:
        twin = ServingRouter([ContinuousBatchingEngine(
            model, engine_id=i, **ENGINE_KW) for i in ids[:2]])
        rids, _ = serve_router(twin, prompts)
        want = [twin.finished[r].output_ids for r in rids]
        del twin
        a, b = (fleet_client(p) for p in procs[:2])
        router = ServingRouter([a, b])
        rids, _ = serve_router(router, prompts)
        got = [router.finished[r].output_ids for r in rids]
        used = {e for r in rids for e in router.finished[r].engines_visited()}
        row["pool_match_rate_vs_twin"] = _rates(got, want)[0]
        if got != want or len(used) != 2:
            bad.append("pool: streams %s of the twin's, engines used %s"
                       % (row["pool_match_rate_vs_twin"], sorted(used)))
        # cross-socket migration of prompts[0]
        erid = a.add_request(prompts[0], max_new_tokens=NEW_TOKENS)
        gen = []
        while len(gen) < 4:
            a.step()
            gen = list(next(v for v in a.slots + a.waiting
                            if v.req_id == erid).output_ids)
        _p, gen, buf = a.extract_request(erid)
        resume = np.concatenate([prompts[0], np.asarray(gen, np.int64)])
        erid_b = b.inject_request(resume, buf,
                                  max_new_tokens=NEW_TOKENS - len(gen))
        while b.has_work():
            b.step()
        cont = gen + b.finished.pop(erid_b).output_ids
        gates["fleet_migration_vs_twin"] = _match_rate(cont, want[0])
        row.update(migration_pages=buf.n_pages, migration_bytes=buf.nbytes)
        # the hung server, drained by its deadline
        hung = fleet_client(procs[2], **short)
        router = ServingRouter([a, hung], probe_failure_threshold=2)
        t1 = time.perf_counter()
        rids, _ = serve_router(router, prompts)
        got = [router.finished[r].output_ids for r in rids]
        row.update(hang_drain_s=time.perf_counter() - t1,
                   hang_engine_healthy=router.handles[ids[2]].healthy,
                   hang_match_rate_vs_twin=_rates(got, want)[0])
        if router.handles[ids[2]].healthy or not all(
                len(o) == NEW_TOKENS for o in got):
            bad.append("hang: engine healthy %s, lengths %s"
                       % (row["hang_engine_healthy"], [len(o) for o in got]))
        hung.close()
        procs[2].kill()
        # kill -9 mid-decode
        met = default_registry().get("router_requeues_total")
        lost0 = sum(ch.value for ch in met.children()
                    if ch.labels["reason"] == "engine_lost") if met else 0
        router = ServingRouter([a, b], probe_failure_threshold=2)
        rids = [router.submit(p, NEW_TOKENS) for p in prompts]
        for _ in range(3):
            router.step()
        victim = next(h.engine_id for h in router.handles.values()
                      if any(k[0] == h.engine_id for k in router._inflight))
        procs[ids.index(victim)].kill()
        router.run_to_completion()
        met = default_registry().get("router_requeues_total")
        lost = sum(ch.value for ch in met.children()
                   if ch.labels["reason"] == "engine_lost") - lost0
        got = [router.finished[r].output_ids for r in rids]
        touched = [victim in router.finished[r].engines_visited()
                   for r in rids]
        survivor = b if victim == ids[0] else a
        hp = survivor.health_payload()
        row.update(kill_victim=victim, kill_engine_lost=lost,
                   kill_touched=sum(touched),
                   kill_reprefilled_match_rate=_rates(
                       [g for g, t in zip(got, touched) if t],
                       [w for w, t in zip(want, touched) if t])[0]
                   if any(touched) else None,
                   kill_survivor_pool=[hp["free_pages"],
                                       hp["total_pages"]])
        if any(not t for t in touched):
            gates["fleet_kill9_untouched_vs_twin"] = _rates(
                [g for g, t in zip(got, touched) if not t],
                [w for w, t in zip(want, touched) if not t])[0]
        if sorted(router.finished) != sorted(rids) or not all(
                len(o) == NEW_TOKENS for o in got) or lost < 1 \
                or hp["free_pages"] != hp["total_pages"]:
            bad.append("kill -9: finished %d of %d, lengths %s, engine_lost "
                       "%s, survivor pool %s" % (
                           len(router.finished), len(rids),
                           [len(o) for o in got], lost,
                           row["kill_survivor_pool"]))
        survivor.shutdown_server()
    finally:
        for p in procs:
            p.kill()
    row["wall_s"] = time.perf_counter() - t0
    row.update(gates)
    emit(row)
    if bad:
        raise AssertionError("parity_2l fleet drills: %s" % "; ".join(bad))
    return row, gates

# ---- the prefix cache: chat turns under one system prompt -----------------
SYSTEM_LEN = 768            # a deployment's system prompt: 48 pages of 16
# sixteen user turns, spread evenly over 32..256 tokens (mean 144)
SUFFIX_LENS = tuple(int(n) for n in np.round(np.linspace(32, 256, 16)))
N_PROMPT_LEN = 512          # the n = 4 run's prompt: 32 full pages
N_SAMPLES = 4
TTFT_SUFFIX = 256
PREFIX_KW = dict(ENGINE_KW, enable_prefix_cache=True)
SPLIT_PREFIX_KW = dict(SPLIT_KW, enable_prefix_cache=True)
KV8_PREFIX_KW = dict(PREFIX_KW, kv_dtype="int8")
N4_KW = dict(PREFIX_KW, sampling=True)
PARITY_TURNS = 8            # phase 4: turn 0 alone, then seven at once
# serve_7b_host_tier: tenants A and B, whole waves A, B, A, B of 8 turns
# (A's turns take the even-indexed suffix lengths, B's the odd).  Wave 1
# misses (its turns prefill together) and leaves A's 48 pages + 65 full
# suffix pages in the table; wave 2 (B, all misses) needs 8 x 48 + 95 =
# 479 pages against 512 - 113 = 399 free: its first six turns fit, the
# seventh evicts 14 pages and the eighth 66, least recently used first
# (A's 48, then 32 of wave 1's suffix pages): 80 pages spilled in 2
# batched copies, 640 MiB of the 1 GiB tier at 7B bf16.  Wave 3 restores
# A's 48 pages in one copy (359 pages are free then) and every turn hits
# 768 tokens; wave 4 finds B on the card.  Whole waves free 359 pages at
# their end whatever the pool size, so no pool that admits wave 1 whole
# can make waves 3 or 4 evict.
HOST_TIER_BYTES = 1 << 30
HOST_TIER_BLOCKS = 512
HOST_TIER_KW = dict(PREFIX_KW, num_blocks=HOST_TIER_BLOCKS,
                    host_tier_bytes=HOST_TIER_BYTES)
HOST_TIER_WANT = dict(spills=80, spill_copies=2, restores=48,
                      restore_copies=1, host_hits=48, evictions=80)


def chat_prompts(vocab: int, seed: int = SEED + 1):
    """The system prompt and its sixteen chat turns (seeded token ids)."""
    rng = np.random.RandomState(seed)
    system = rng.randint(1, vocab, (SYSTEM_LEN,)).astype(np.int64)
    return system, [np.concatenate([system, rng.randint(1, vocab, (n,))])
                    for n in SUFFIX_LENS]


class SharedPages:
    """A clone of request ``watch``'s system-prompt pages in every pool
    (K, V and an int8 pool's scale rows), taken as soon as its prefill
    has written them (request 0's: when it publishes them), and the check
    that they were never written since."""

    def __init__(self, watch: int = 0):
        self.watch = watch
        self.blocks = self.pages = None

    def take(self, eng, block_ids):
        import torch
        self.blocks = torch.tensor(block_ids, dtype=torch.long,
                                   device=eng.device)
        self.pages = [t.index_select(0, self.blocks)
                      for t in self._pools(eng)]

    @staticmethod
    def _pools(eng):
        out = []
        for c in eng.caches:
            out += [c.key_cache, c.value_cache]
            if c.quantized:
                out += [c.key_scale, c.value_scale]
        return out

    def unwritten(self, eng) -> bool:
        import torch
        return all(torch.equal(t.index_select(0, self.blocks), p)
                   for t, p in zip(self._pools(eng), self.pages))

    def differ(self, other) -> dict:
        """Where two clones of the same prompt's int8 pages differ: the
        codes that differ (of all), the largest code difference, the scale
        entries that differ (of all) and those of ``other`` above this
        clone's (a recycled page keeps its running-max scale, as in the
        reference, so a prompt written on recycled pages can quantize
        coarser than on fresh ones)."""
        codes = [(a, b) for a, b in zip(self.pages, other.pages)
                 if not a.dtype.is_floating_point]
        scales = [(a, b) for a, b in zip(self.pages, other.pages)
                  if a.dtype.is_floating_point]
        return dict(
            codes_differing=sum(int((a != b).sum()) for a, b in codes),
            codes=sum(a.numel() for a, _ in codes),
            max_code_diff=max(int((a.int() - b.int()).abs().max())
                              for a, b in codes),
            scales_differing=sum(int((a != b).sum()) for a, b in scales),
            scales_above=sum(int((b > a).sum()) for a, b in scales),
            scales=sum(a.numel() for a, _ in scales))


def chat_turns(prompts, shared=None, alone: int = 1):
    """The first ``alone`` requests to completion (request 0: the earlier
    traffic that warmed the cache), then the others at once; ``shared``
    (a :class:`SharedPages`) clones its request's system-prompt pages as
    soon as that request's prefill has written them."""
    pages = SYSTEM_LEN // ENGINE_BASE["block_size"]

    def traffic(eng, step):
        reqs = []

        def run():
            while eng.has_work():
                step()
                r = reqs[shared.watch] if shared is not None and len(
                    reqs) > shared.watch else None
                if r is not None and shared.blocks is None \
                        and r.state not in ("waiting", "prefilling"):
                    shared.take(eng, r.block_ids[:pages])
        rids = []
        for batch in (prompts[:alone], prompts[alone:]):
            for p in batch:
                rids.append(eng.add_request(p, NEW_TOKENS))
                reqs.append(eng.waiting[-1])
            run()
        return rids
    return traffic


def n_samples(prompt):
    """One prompt, ``N_SAMPLES`` sampled generations sharing its
    prefill."""
    def traffic(eng, step):
        rids = eng.add_request(prompt, NEW_TOKENS, n=N_SAMPLES, seed=1,
                               **SAMPLED_KNOBS)
        while eng.has_work():
            step()
        return rids
    return traffic


def tenant_waves(vocab: int, seed: int = SEED + 2):
    """``serve_7b_host_tier``'s traffic: tenants A and B (768-token system
    prompts), waves A, B, A, B of eight turns, each wave added at once and
    run to completion before the next; fresh turns every wave."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(1, vocab, (SYSTEM_LEN,)).astype(np.int64)
               for _ in range(2)]
    waves = [[np.concatenate([systems[w % 2], rng.randint(1, vocab, (n,))])
              for n in SUFFIX_LENS[w % 2::2]] for w in range(4)]

    def traffic(eng, step):
        rids = []
        for wave in waves:
            rids += [eng.add_request(p, NEW_TOKENS) for p in wave]
            step()
            if eng.waiting:
                raise AssertionError("a wave of %d turns was not admitted "
                                     "whole" % len(wave))
            while eng.has_work():
                step()
        return rids
    return traffic


def first_token_s(eng, prompt) -> float:
    """Seconds from ``add_request`` to the request's first token on the
    host, the device synchronized before and after, the engine idle; then
    the request runs to completion."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.add_request(prompt, NEW_TOKENS)
    req = eng.waiting[-1]
    while not req.output_ids:
        eng.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.run_to_completion()
    return dt


def time_to_first_token(model, system, vocab, pairs=3):
    """The reference's TTFT gate (``tools/bench_serving.py``): in an idle
    prefix engine warmed with the system prompt, a request of the system
    prompt + 256 tokens against a cold request of the same length under a
    fresh system prompt, ``pairs`` times, each warm one strictly below its
    cold twin."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    rng = np.random.RandomState(SEED + 3)
    eng = ContinuousBatchingEngine(model, **PREFIX_KW)
    eng.add_request(np.concatenate([system, rng.randint(1, vocab, (32,))]),
                    NEW_TOKENS)
    eng.run_to_completion()
    warm, cold = [], []
    for _ in range(pairs):
        turn = rng.randint(1, vocab, (TTFT_SUFFIX,))
        warm.append(first_token_s(eng, np.concatenate([system, turn])))
        fresh = rng.randint(1, vocab, (SYSTEM_LEN + TTFT_SUFFIX,))
        cold.append(first_token_s(eng, fresh))
    if not all(w < c for w, c in zip(warm, cold)):
        raise AssertionError("warm TTFT %s not strictly below cold %s"
                             % (warm, cold))
    return dict(ttft_warm_s=warm, ttft_cold_s=cold,
                ttft_prompt_tokens=SYSTEM_LEN + TTFT_SUFFIX)


def check_prefix_run(name, stats, cold, n=len(SUFFIX_LENS)):
    """The counts of the chat traffic's first ``n`` turns: each turn after
    the first hit the 768-token system prompt, and the engine prefilled
    768 + the suffixes with the cache (n x 768 + the suffixes without)."""
    want_prefill = (n if cold else 1) * SYSTEM_LEN + sum(SUFFIX_LENS[:n])
    if stats["prefilled_tokens"] != want_prefill:
        raise AssertionError("%s prefilled %d prompt tokens, want %d"
                             % (name, stats["prefilled_tokens"],
                                want_prefill))
    if cold:
        return
    hits = stats["prefix_hit_tokens"]
    if hits != [0] + [SYSTEM_LEN] * (n - 1):
        raise AssertionError("%s prefix hit tokens %s" % (name, hits))


def serve_prefix(model):
    """The prefix cache on phase 3's model: the chat traffic (a 768-token
    system prompt, request 0 alone, then fifteen turns at once) through
    the mixed prefix engine (with the TTFT gate), the same engine without
    the cache (the yardstick), the split prefix engine and the int8-pool
    prefix engine; four sampled generations of one 512-token prompt,
    served twice; and the host tier against a resident pool on two
    tenants' waves.  Launches exact, pools whole (every cached page held
    once, by the table), the system prompt's pages bitwise unwritten, hit
    and prefilled tokens as :func:`check_prefix_run` states, the host
    tier's spills, restores and copies as ``HOST_TIER_WANT`` predicts and
    its streams and steps equal the resident pool's."""
    import torch
    cfg = model.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    system, prompts = chat_prompts(V)
    outs, rows = {}, {}
    for name, kw in (("serve_7b_prefix_cold", ENGINE_KW),
                     ("serve_7b_prefix", PREFIX_KW),
                     ("serve_7b_split_prefix", SPLIT_PREFIX_KW),
                     ("serve_7b_kv8_prefix", KV8_PREFIX_KW)):
        t1 = time.perf_counter()
        cold = not kw.get("enable_prefix_cache")
        shared = None if cold else SharedPages()
        eng, outs[name], stats = serve(model, None, kw,
                                       traffic=chat_turns(prompts, shared))
        check_launches(name, kw, stats, L)
        check_prefix_run(name, stats, cold)
        if shared is not None:
            # the 48 pages x 32 layers x K and V: 384 MiB at 7B bf16
            stats["shared_pages_unwritten"] = shared.unwritten(eng)
            if not stats["shared_pages_unwritten"]:
                raise AssertionError("%s wrote a shared page" % name)
            stats["shared_bytes_checked"] = sum(
                p.numel() * p.element_size() for p in shared.pages)
        del eng, shared
        if name == "serve_7b_prefix":
            stats.update(time_to_first_token(model, system, V))
        stats.update(phase=name + "_bf16", layers=L,
                     engine={k: v for k, v in kw.items()
                             if k not in ENGINE_BASE},
                     phase_wall_s=time.perf_counter() - t1)
        if not cold:
            stats["match_rate_vs_cold"] = _rates(
                outs[name], outs["serve_7b_prefix_cold"])[0]
        rows[name] = stats
    rows["serve_7b_prefix"]["wall_vs_cold"] = (
        rows["serve_7b_prefix"]["wall_s"]
        / rows["serve_7b_prefix_cold"]["wall_s"])
    for stats in rows.values():
        emit(stats)
    prompt = np.random.RandomState(SEED + 4).randint(1, V, (N_PROMPT_LEN,))
    t1 = time.perf_counter()
    streams = []
    for _ in range(2):
        _, got, stats = serve(model, None, N4_KW, traffic=n_samples(prompt))
        check_launches("serve_7b_n4", N4_KW, stats, L)
        streams.append(got)
    if streams[0] != streams[1]:
        raise AssertionError("serve_7b_n4: the second run sampled other "
                             "tokens")
    if len({tuple(o) for o in streams[0]}) < 2:
        raise AssertionError("serve_7b_n4: the %d generations are all equal"
                             % N_SAMPLES)
    if stats["prefix_hit_tokens"] != [0] + [N_PROMPT_LEN - 1] * (
            N_SAMPLES - 1):
        raise AssertionError("serve_7b_n4 hit tokens %s"
                             % stats["prefix_hit_tokens"])
    stats.update(phase="serve_7b_n4_bf16", layers=L, replay_identical=True,
                 distinct_streams=len({tuple(o) for o in streams[0]}),
                 engine={k: v for k, v in N4_KW.items()
                         if k not in ENGINE_BASE},
                 phase_wall_s=time.perf_counter() - t1)
    emit(stats)
    rows["serve_7b_n4"] = stats
    rows.update(serve_host_tier(model)[0])
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def timed_page_moves(log: list):
    """While open, every ``PrefixPageCache._spill`` (the batched extract
    and its split into one-page entries) and every ``_restore_chain``
    that restored pages (their concatenation and the batched inject)
    appends ``(kind, pages, host seconds)`` to ``log``, the device
    synchronized around each call.  The engine's own calls are timed, in
    the run that makes them."""
    import torch
    from paddle_tpu_torch.inference.prefix_cache import PrefixPageCache
    spill, restore = PrefixPageCache._spill, PrefixPageCache._restore_chain

    def timed_spill(self, victims):
        torch.cuda.synchronize()
        t = time.perf_counter()
        spill(self, victims)
        torch.cuda.synchronize()
        log.append(("spill", len(victims), time.perf_counter() - t))

    def timed_restore(self, prompt_ids, start, n_full):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = restore(self, prompt_ids, start, n_full)
        torch.cuda.synchronize()
        if out:
            log.append(("restore", len(out), time.perf_counter() - t))
        return out
    PrefixPageCache._spill = timed_spill
    PrefixPageCache._restore_chain = timed_restore
    try:
        yield log
    finally:
        PrefixPageCache._spill, PrefixPageCache._restore_chain = (
            spill, restore)


def serve_host_tier(model, label="bf16"):
    """``serve_7b_host_tier`` and ``serve_7b_host_tier_resident``: two
    tenants' waves (:func:`tenant_waves`) through a ``HOST_TIER_BLOCKS``
    pool with a 1 GiB host tier, and through a 640-page pool with nothing
    evicted.  Spills, restores, host hits and the host copies read from
    ``MIGRATION_TRANSFERS`` (one per batched spill or restore: one dtype)
    as ``HOST_TIER_WANT`` predicts, every turn of the
    waves after the first two on a 768-token hit, the token streams
    byte-identical and the step counts equal.  Returns the rows (phase
    names end in ``label``) and the streams."""
    from paddle_tpu_torch.jit.serving_step import migration_transfers
    L = model.config.num_hidden_layers
    traffic = tenant_waves(model.config.vocab_size)
    rows, outs = {}, {}
    for name, k in (("serve_7b_host_tier", HOST_TIER_KW),
                    ("serve_7b_host_tier_resident", PREFIX_KW)):
        t1 = time.perf_counter()
        t0 = migration_transfers()
        moves = []
        with timed_page_moves(moves):
            eng, outs[name], stats = serve(model, None, k, traffic=traffic)
        t = migration_transfers()
        check_launches(name, k, stats, L)
        if moves:
            stats["page_moves"] = {
                kind: dict(pages=[n for kd, n, _ in moves if kd == kind],
                           s=[dt for kd, _, dt in moves if kd == kind])
                for kind in ("spill", "restore")}
        stats.update(d2h=t["d2h"] - t0["d2h"], h2d=t["h2d"] - t0["h2d"],
                     phase=name + "_" + label, layers=L,
                     host_tier_entries=len(eng.host_tier or ()),
                     engine={a: v for a, v in k.items()
                             if a not in ENGINE_BASE or a == "num_blocks"},
                     phase_wall_s=time.perf_counter() - t1)
        del eng
        rows[name] = stats
    tier, res = rows["serve_7b_host_tier"], rows["serve_7b_host_tier_resident"]
    # one host copy per dtype (bf16 or fp32 pools: one) per batched spill
    # or restore
    got = dict(tier["prefix_cache"], spill_copies=tier["d2h"],
               restore_copies=tier["h2d"])
    want = HOST_TIER_WANT
    if {a: got[a] for a in want} != want:
        raise AssertionError("serve_7b_host_tier moved %s, predicted %s"
                             % ({a: got[a] for a in want}, want))
    if res["prefix_cache"]["evictions"] or res["d2h"] or res["h2d"]:
        raise AssertionError("the resident pool evicted: %s"
                             % res["prefix_cache"])
    hits = tier["prefix_hit_tokens"]
    if hits[16:] != [SYSTEM_LEN] * 16 or hits != res["prefix_hit_tokens"]:
        raise AssertionError("host tier hit tokens %s, resident %s"
                             % (hits, res["prefix_hit_tokens"]))
    if outs["serve_7b_host_tier"] != outs["serve_7b_host_tier_resident"]:
        raise AssertionError("the host tier's streams differ from the "
                             "resident pool's")
    if tier["steps"] != res["steps"]:
        raise AssertionError("host tier %d steps, resident %d"
                             % (tier["steps"], res["steps"]))
    tier.update(streams_identical_to_resident=True,
                steps_equal_to_resident=True)
    for stats in rows.values():
        emit(stats)
    return rows, outs


def swapped_attention():
    """A context in which the serving steps' attention runs the kernels'
    plain versions on the card (for int8 pools the Pallas int8 math: q
    and p rows quantized, integer products).  The wrappers and their
    counts are not touched; the epilogue kernel still runs."""
    import contextlib
    from paddle_tpu_torch.jit import serving_step as ss
    from paddle_tpu_torch.ops import paged_attention as pa

    def ragged(q, kc, vc, bt, qo, ql, kl, scale, span_q=0, key_scale=None,
               value_scale=None, work=None):
        if key_scale is not None:
            return pa._ragged_attention_int8_plain(
                q, kc, vc, key_scale, value_scale, bt, qo, ql, kl, scale)
        return pa._ragged_attention_plain(q, kc, vc, bt, qo, ql, kl, scale)

    def decode(q, kc, vc, bt, seq_lens, scale, key_scale=None,
               value_scale=None):
        return pa._paged_attention_plain(q, kc, vc, bt, seq_lens, scale,
                                         key_scale, value_scale)

    @contextlib.contextmanager
    def swapped():
        orig = ss.ragged_paged_attention, ss.paged_attention
        ss.ragged_paged_attention, ss.paged_attention = ragged, decode
        try:
            yield
        finally:
            ss.ragged_paged_attention, ss.paged_attention = orig
    return swapped()


@contextlib.contextmanager
def swapped_dequant():
    """A context in which the int8 weight tree dequantizes through the
    kernel's plain version on the card (the wrapper's count untouched)."""
    from paddle_tpu_torch.ops import dequant as dq
    orig = dq.dequant_int8
    dq.dequant_int8 = (lambda codes, scales, segments, out:
                       dq._dequant_int8_plain(codes, scales, segments, out))
    try:
        yield
    finally:
        dq.dequant_int8 = orig


def migrated_midway(model, prompts, kw, at_step=8):
    """The phase-3 traffic on one engine (built with ``kw``) for
    ``at_step`` steps after the second admission, then every running
    request extracted (``extract_request``) and injected into a second
    engine (``inject_request``), both run to completion.  Returns each
    request's whole stream (the tokens made before the move, then those
    made after it) and the number of requests moved; both pools must be
    whole."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    a = ContinuousBatchingEngine(model, **kw)
    b = ContinuousBatchingEngine(model, **kw)
    rids = [a.add_request(p, NEW_TOKENS) for p in prompts[:4]]
    a.step()
    rids += [a.add_request(p, NEW_TOKENS) for p in prompts[4:]]
    for _ in range(at_step):
        a.step()
    moved = {}
    for r in [r for r in a.slots if r is not None and r.state == "running"]:
        p, gen, buf = a.extract_request(r.req_id)
        resume = np.concatenate([p, np.asarray(gen, np.int64)])
        moved[r.req_id] = (gen, b.inject_request(
            resume, buf, max_new_tokens=NEW_TOKENS - len(gen)))
    a.run_to_completion()
    b.run_to_completion()
    if not (pool_whole(a) and pool_whole(b)) or b.prefill_tokens:
        raise AssertionError("migrated_midway: pools whole %s %s, target "
                             "prefilled %d tokens" % (pool_whole(a),
                                                     pool_whole(b),
                                                     b.prefill_tokens))
    outs = [moved[r][0] + b.result(moved[r][1]) if r in moved
            else a.result(r) for r in rids]
    return outs, len(moved)


def phase_parity_2l():
    """Llama-2-7B widths at 2 layers in fp32 (mean per-request token
    matches up to the first divergence):

    - the mixed and split engines against eager ``generate`` and against
      each other, >= 0.98 each;
    - each engine over int8 pools through the kernels against the same
      engine through the plain int8 versions on the card (the same int8
      math), >= 0.98: what the int8 kernels are answerable for;
    - reported, not asserted: each int8-pool engine against its fp32-pool
      run.  At these widths and random weights int8 KV storage itself
      moves greedy tokens (32000 logits of std 1.3 leave top-1 margins
      near 0.3): the reference's own engines show it on the CPU
      (``tests/test_torch_split_serving.py::
      test_kv8_vs_fp32_token_match_at_7b_widths``), so r13's 0.90
      threshold, set on a 1M-parameter model, does not hold here.
    """
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    cfg = llama_7b_config(dtype="float32", num_hidden_layers=2)
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    prompts = _prompts(cfg.vocab_size)
    ref = eager_tokens(model, prompts)
    outs, row = {}, dict(phase="parity_2layer_fp32")
    kv8 = dict(kv_dtype="int8")
    for name, kw, swap in (
            ("mixed", ENGINE_KW, False), ("split", SPLIT_KW, False),
            ("kv8_mixed", dict(ENGINE_KW, **kv8), False),
            ("kv8_split", dict(SPLIT_KW, **kv8), False),
            ("kv8_mixed_plain", dict(ENGINE_KW, **kv8), True),
            ("kv8_split_plain", dict(SPLIT_KW, **kv8), True)):
        t0 = time.perf_counter()
        if not swap:
            eng, outs[name], stats = serve(model, prompts, kw)
            check_launches("parity " + name, kw, stats,
                           cfg.num_hidden_layers)
            row[name + "_launches"] = stats["launches"]
            if name == "mixed":
                row.update(first_step_logits(eng, model, prompts[0]))
        else:
            with swapped_attention():
                eng, outs[name], stats = serve(model, prompts, kw)
        del eng
        row[name + "_vs_eager"] = _rates(outs[name], ref)[0]
        row[name + "_wall_s"] = time.perf_counter() - t0
    gates = {"mixed_vs_eager": row["mixed_vs_eager"],
             "split_vs_eager": row["split_vs_eager"]}
    for a, b in (("split", "mixed"), ("kv8_mixed", "kv8_mixed_plain"),
                 ("kv8_split", "kv8_split_plain")):
        gates["%s_vs_%s" % (a, b)] = _rates(outs[a], outs[b])[0]
    # the sampled mixed engine and the speculative engines (a 1-layer
    # draft), each against itself through the plain versions; greedy
    # speculation against the greedy mixed engine
    from paddle_tpu_torch.models.llama import llama_truncated_draft
    draft = llama_truncated_draft(model, 1)
    spec_kw = dict(ENGINE_KW, spec_k=SPEC_K)
    for name, kw, dr, sampled in (
            ("mixed_sampled", dict(ENGINE_KW, sampling=True), None, True),
            ("spec", spec_kw, draft, False),
            ("spec_sampled", dict(spec_kw, sampling=True), draft, True)):
        for swap in (False, True):
            key = name + ("_plain" if swap else "")
            t0 = time.perf_counter()
            if swap:
                with swapped_attention():
                    _, outs[key], stats = serve(model, prompts, kw, dr,
                                                sampled)
            else:
                _, outs[key], stats = serve(model, prompts, kw, dr, sampled)
                check_launches("parity " + key, kw, stats,
                               cfg.num_hidden_layers)
                row[key + "_launches"] = stats["launches"]
            if dr is not None:
                row[key + "_acceptance_rate"] = stats["acceptance_rate"]
            row[key + "_wall_s"] = time.perf_counter() - t0
    for a, b in (("spec", "mixed"), ("spec", "spec_plain"),
                 ("mixed_sampled", "mixed_sampled_plain")):
        gates["%s_vs_%s" % (a, b)] = _rates(outs[a], outs[b])[0]
    row["spec_sampled_vs_spec_sampled_plain"] = _rates(
        outs["spec_sampled"], outs["spec_sampled_plain"])[0]
    # int8 weights: each w8 engine against its dequantized fp32 twin
    # (serve_w8 gates it) and against itself through the plain versions
    # of the dequant and the attention
    L2 = cfg.num_hidden_layers
    w8 = serve_w8(model, prompts, ref, outs,
                  dict(prefix="parity_2l", mixed="mixed", split="split"), L2)
    for name, kw in (("parity_2l_w8", W8_KW),
                     ("parity_2l_split_w8", SPLIT_W8_KW)):
        with swapped_attention(), swapped_dequant():
            _, plain, _ = serve(model, prompts, kw)
        gates[name + "_vs_dequantized_twin"] = \
            w8[name]["match_rate_vs_dequantized_twin"]
        gates[name + "_vs_plain"] = _rates(outs[name], plain)[0]
        row[name + "_vs_fp32_engine"] = w8[name]["match_rate_vs_fp_engine"]
    # a request moved mid-decode to a second engine against the
    # uninterrupted run, fp32 and int8 pools
    for name, kw, base in (("migrated", ENGINE_KW, "mixed"),
                           ("kv8_migrated", dict(ENGINE_KW, **kv8),
                            "kv8_mixed")):
        got, moved = migrated_midway(model, prompts, kw)
        row[name + "_requests_moved"] = moved
        if not moved:
            raise AssertionError("%s: no request was running to move"
                                 % name)
        gates["%s_vs_%s" % (name, base)] = _rates(got, outs[base])[0]
    # the disaggregated router against one mixed engine
    drow, _ = serve_disagg(model, prompts, {"mixed": outs["mixed"]},
                           name="parity_2l_disagg")
    gates["disagg_vs_mixed"] = drow["match_rate_vs_mixed"]
    # the fleet drills on server processes of this model
    frow, fgates = fleet_drills_2l(model, prompts)
    gates.update(fgates)
    row["fleet_drills"] = {k: v for k, v in frow.items() if k != "phase"}
    row.update(gates)
    for mode in ("mixed", "split"):
        row["kv8_%s_vs_fp32_%s" % (mode, mode)] = _rates(
            outs["kv8_" + mode], outs[mode])[0]
    prefix_gates, prefix_reported = prefix_parity(model)
    gates.update(prefix_gates)
    row.update(prefix_gates, **prefix_reported)
    row["damped_pair"] = damped_pair_run(cfg, prompts)
    emit(row)
    if not row["damped_pair"]["full_chain_accepts"] >= 1:
        raise AssertionError("damped pair: no span accepted all %d drafts "
                             "(the bonus-token path never ran): %s"
                             % (SPEC_K, row["damped_pair"]))
    for gate, rate in gates.items():
        if not rate >= 0.98:
            raise AssertionError("fp32 2-layer %s token match %.4f < 0.98"
                                 % (gate, rate))
    del model
    torch.cuda.empty_cache()
    return row


def prefix_parity(model):
    """The prefix engines at 2 layers fp32 (token matches, each >= 0.98
    in the caller): the mixed and split prefix engines against the same
    engine without the cache on the chat traffic's first
    ``PARITY_TURNS`` turns, the mixed, split and
    int8-pool prefix engines each against itself through the plain
    attention versions; the host tier
    against the mixed engine without the cache on the tenants' waves (its
    spills, restores and copies, and its equality with the resident
    pool, asserted by :func:`serve_host_tier`); generation ``i`` of the
    ``n = 4`` run against a solo request with seed ``1 + i``; the
    int8-pool prefix engine against its cold twin where their pages'
    write histories are equal: each turn in an engine of its own, cold
    and behind its publisher (:func:`kv8_history_twins`).  Returns those
    gates, and what is reported: the int8-pool prefix engine on the chat
    traffic against its cold twin (whose turn 1 writes the system prompt
    on request 0's recycled pages) and against the cold twins on fresh
    pages (per turn too), with how the system prompt's int8 pages each
    twin writes for itself differ from the published ones."""
    V = model.config.vocab_size
    # the system prompt and its first PARITY_TURNS turns (the plain
    # attention versions loop over pages on the host)
    prompts = chat_prompts(V)[1][:PARITY_TURNS]
    outs, gates, reported = {}, {}, {}
    for name, kw, cold_kw in (
            ("prefix", PREFIX_KW, ENGINE_KW),
            ("split_prefix", SPLIT_PREFIX_KW, SPLIT_KW),
            ("kv8_prefix", KV8_PREFIX_KW, dict(ENGINE_KW, kv_dtype="int8"))):
        # the int8 pages of the system prompt: as published (request 0 of
        # the prefix engine) and as request 1 of the cold engine writes its
        # own copy, in a step packed with other requests' spans
        shared = {name: SharedPages(0), name + "_cold": SharedPages(1)}
        for key, k, swap in ((name, kw, False), (name + "_cold", cold_kw,
                                                 False),
                             (name + "_plain", kw, True)):
            traffic = chat_turns(prompts, shared.get(key))
            if swap:
                with swapped_attention():
                    _, outs[key], st = serve(model, None, k,
                                             traffic=traffic)
            else:
                _, outs[key], st = serve(model, None, k, traffic=traffic)
                check_launches("parity " + key, k, st,
                               model.config.num_hidden_layers)
            check_prefix_run("parity " + key, st, key.endswith("_cold"),
                             PARITY_TURNS)
        gates[name + "_vs_" + name + "_plain"] = _rates(
            outs[name], outs[name + "_plain"])[0]
        vs_cold = _rates(outs[name], outs[name + "_cold"])[0]
        if kw.get("kv_dtype") == "int8":
            # reported: the cold twin writes the system prompt on recycled
            # pages, whose running-max scales outlive their last sequence
            # (the reference's rule), so its codes are coarser and random
            # 7B-width greedy tokens move
            reported[name + "_vs_" + name + "_cold"] = vs_cold
            reported["kv8_system_pages_published_vs_cold"] = shared[
                name].differ(shared[name + "_cold"])
            tw = kv8_history_twins(model, prompts, kw, cold_kw,
                                   shared[name])
            solo = tw["solo"]["tokens"]
            gates[name + "_behind_publisher_vs_cold_solo"] = _rates(
                tw["behind"], solo[1:])[0]
            for how in ("solo", "at_once"):
                reported[name + "_vs_cold_" + how] = _rates(
                    outs[name], tw[how]["tokens"])
                reported["kv8_system_pages_published_vs_" + how] = tw[
                    how]["pages"]
        else:
            gates[name + "_vs_" + name + "_cold"] = vs_cold
    _, tier = serve_host_tier(model, "parity_2layer_fp32")
    _, cold, _ = serve(model, None, ENGINE_KW, traffic=tenant_waves(V))
    gates["host_tier_vs_cold"] = _rates(tier["serve_7b_host_tier"], cold)[0]
    prompt = np.random.RandomState(SEED + 4).randint(1, V, (N_PROMPT_LEN,))
    _, children, _ = serve(model, None, N4_KW, traffic=n_samples(prompt))
    solo = []
    for i in range(N_SAMPLES):
        def one(eng, step, seed=1 + i):
            rid = eng.add_request(prompt, NEW_TOKENS, seed=seed,
                                  **SAMPLED_KNOBS)
            while eng.has_work():
                step()
            return [rid]
        solo += serve(model, None, N4_KW, traffic=one)[1]
    gates["n4_children_vs_solo"] = _rates(children, solo)[0]
    return gates, reported


def behind_publisher(prompts, k: int):
    """Request 0 (generating ``2 * NEW_TOKENS``, so that it outlives turn
    ``k``) and turn ``k`` added as soon as request 0 has published the
    system prompt: every page turn ``k`` writes is fresh, and its suffix
    is one chunk beside request 0's decode token.  Returns turn ``k``'s
    id only."""
    def traffic(eng, step):
        eng.add_request(prompts[0], 2 * NEW_TOKENS)
        publisher = eng.waiting[-1]
        while publisher.state in ("waiting", "prefilling"):
            step()
        rid = eng.add_request(prompts[k], NEW_TOKENS)
        while eng.has_work():
            step()
        return [rid]
    return traffic


def kv8_history_twins(model, prompts, kw, cold_kw, published):
    """Int8 codes follow each page's write history (the reference's
    rules: a recycled page keeps its running-max scale; a write that
    raises a page's scale rescales the codes already there), so the
    int8-pool prefix engine and its cold twins write their turns' pages
    differently.  Cold twins with no page recycled: ``solo``, every turn
    in an engine of its own (its system prompt prefilled alone, in the
    chunks request 0 published it in); ``at_once``, request 0 in an engine
    of its own and the other turns at once in a second (their chunks
    packed, and cut mid-page, under the step's token budget).
    ``behind``: turn ``k`` in a prefix engine of its own
    (:func:`behind_publisher`), whose pages then have the histories of
    ``solo``'s turn ``k``.  Launches, prefilled and hit tokens checked;
    ``solo``'s system-prompt pages must equal ``published`` (a
    :class:`SharedPages`) bitwise.  Returns the tokens of each (``behind``:
    turns 1..) and how the system-prompt pages each cold twin's turns
    wrote differ from the published ones: each turn's in ``solo``, turn
    1's in ``at_once``, summed."""
    L = model.config.num_hidden_layers

    def run(batch, alone):
        shared = SharedPages(0)
        _, toks, st = serve(model, None, cold_kw,
                            traffic=chat_turns(batch, shared, alone))
        check_launches("parity kv8 cold twin", cold_kw, st, L)
        return toks, st["prefilled_tokens"], published.differ(shared)
    out = {}
    for how, groups in (("solo", [[p] for p in prompts]),
                        ("at_once", [prompts[:1], prompts[1:]])):
        runs = [run(g, 1 if len(g) == 1 else 0) for g in groups]
        check_prefix_run("parity kv8 %s cold twin" % how,
                         dict(prefilled_tokens=sum(r[1] for r in runs)),
                         True, len(prompts))
        pages = [r[2] for r in runs[1:]]
        out[how] = dict(tokens=[t for r in runs for t in r[0]], pages={
            k: (max if k == "max_code_diff" else sum)(d[k] for d in pages)
            for k in pages[0]})
    p = out["solo"]["pages"]
    if p["codes_differing"] or p["scales_differing"]:
        raise AssertionError("kv8 turns prefilled alone on fresh pages "
                             "wrote other system-prompt pages than the "
                             "published ones: %s" % p)
    out["behind"] = []
    for k in range(1, len(prompts)):
        _, toks, st = serve(model, None, kw,
                            traffic=behind_publisher(prompts, k))
        check_launches("parity kv8 behind publisher", kw, st, L)
        want = len(prompts[0]) + len(prompts[k]) - SYSTEM_LEN
        if st["prefix_hit_tokens"] != [SYSTEM_LEN] or \
                st["prefilled_tokens"] != want:
            raise AssertionError("kv8 turn %d behind its publisher: hit %s, "
                                 "prefilled %d (want %d)"
                                 % (k, st["prefix_hit_tokens"],
                                    st["prefilled_tokens"], want))
        out["behind"] += toks
    return out


def damped_pair_run(cfg, prompts):
    """``tools/bench_serving.py::build_spec_pair``'s damped pair at these
    widths: the target's layer 2 ``o_proj`` and ``down_proj`` scaled by
    0.1, drafted by its 1-layer truncation, so that the draft tracks the
    target as a trained pair's does; greedy speculation with exact
    launches.  Returns the acceptance and the spans that drafted and
    accepted the full ``spec_k`` tokens (the bonus-token path)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_truncated_draft)
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.no_grad():
        for layer in list(model.llama.layers)[1:]:
            for lin in (layer.self_attn.o_proj, layer.mlp.down_proj):
                lin.weight.mul_(0.1)
    kw = dict(ENGINE_KW, spec_k=SPEC_K)
    _, _, stats = serve(model, prompts, kw, llama_truncated_draft(model, 1))
    check_launches("damped pair", kw, stats, cfg.num_hidden_layers)
    return {k: stats[k] for k in ("spec_proposed", "spec_accepted",
                                  "acceptance_rate", "full_chain_spans",
                                  "full_chain_accepts", "steps",
                                  "draft_launches", "wall_s")}


def phase_logits_by_depth():
    """The engine's first-step logits against the eager forward where the
    two differ only in rounding: fp32 at the full 32-layer depth (held to
    1e-3 — the paths differ only in summation order), and bf16 at 2
    layers, beside phase 3's 32 (reported: bf16 rounds the logits
    themselves at ~0.01-0.03 and the eager path keeps the reference's
    bf16 attention scores, so random-init bf16 argmaxes tie)."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    rows = []
    for dtype, layers in (("float32", 32), ("bfloat16", 2)):
        cfg = llama_7b_config(dtype=dtype, num_hidden_layers=layers)
        model = LlamaForCausalLM(
            cfg, generator=torch.Generator("cuda").manual_seed(SEED))
        eng = ContinuousBatchingEngine(model, **ENGINE_KW)
        row = dict(phase="first_step_logits", dtype=dtype, layers=layers,
                   **first_step_logits(eng, model,
                                       _prompts(cfg.vocab_size)[0]))
        emit(row)
        rows.append(row)
        del eng, model
        torch.cuda.empty_cache()
    if not rows[0]["first_step_max_logit_diff"] <= 1e-3:
        raise AssertionError("fp32 32-layer engine logits differ from the "
                             "eager forward by %g > 1e-3"
                             % rows[0]["first_step_max_logit_diff"])
    return rows


# ---------------------------------------------------------------------------
# phases 6-8: the training slice
# ---------------------------------------------------------------------------
TRAIN_LR = 3e-4
TRAIN_BATCH = (2, 2048)        # Llama-2-7B: batch x sequence
LONG_BATCH = (1, 16384)        # CodeLlama-7B's 16k context
TRAIN_STEPS, TRAIN_WARMUP = 4, 1


def _train_launches():
    """The training kernels' launch counts: the three flash kernels and
    RMSNorm (#4, the layerwise step's norms; ``TrainStep``'s model runs
    the plain norm of ``nn.functional``)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.rms_norm import rms_norm_tpu
    out = {k: getattr(fa, k).launches for k in ALL_FLASH}
    out["rms_norm"] = rms_norm_tpu.launches
    return out


def _reset_train_launches():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.rms_norm import rms_norm_tpu
    for k in ALL_FLASH:
        getattr(fa, k).launches = 0
    rms_norm_tpu.launches = 0


def _tokens(vocab: int, shape, seed: int):
    import torch
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(1, vocab, shape)).to("cuda")


def _trainer(cfg, seed=SEED):
    """A random-weight model on the card with ``TrainStep`` over AdamW
    (bf16 moments for a bf16 model: no master weights), clip-norm 1.0."""
    import torch
    from paddle_tpu_torch.jit.train_step import TrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(seed))
    opt = AdamW(TRAIN_LR, parameters=model.named_parameters(),
                moment_dtype=cfg.dtype)
    return model, TrainStep(model, LlamaPretrainingCriterion(), opt,
                            clip_norm=1.0)


def run_steps(step, ids, n):
    """``n`` steps on ``ids`` (labels = inputs); the fp32 losses and the
    wall seconds, host clock around work that ends in a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, ids) for _ in range(n)]
    torch.cuda.synchronize()
    return [x.item() for x in losses], time.perf_counter() - t0


def init_loss(cfg) -> float:
    """The expected first loss of a random-init model: the LM head's
    N(0, initializer_range^2) weights over unit-RMS normed hidden states
    give logits of variance ``s2 = hidden * initializer_range^2`` (1.64
    for Llama-2-7B), independent of the labels, so the loss is
    ``E[lse] = ln V + s2 / 2`` (11.19 for V = 32000), not ln V: the
    softmax is near uniform only when s2 is small."""
    s2 = cfg.hidden_size * cfg.initializer_range ** 2
    return math.log(cfg.vocab_size) + s2 / 2


def phase_train_7b():
    """Llama-2-7B at full width and depth, bf16, AdamW with bf16 moments,
    recompute, clip 1.0, batch 2 x 2048: one warm-up step, then
    ``TRAIN_STEPS`` timed steps whose flash launches must be exact
    (forward twice per layer: once, and once more in the recompute; the
    fused backward once per layer; the two-kernel backward never), then
    one profiled step."""
    import torch
    from paddle_tpu_torch.models.llama import (llama_7b_config,
                                               llama_flops_per_token,
                                               param_count)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama_7b_config(dtype="bfloat16", recompute=True)
    t0 = time.perf_counter()
    model, step = _trainer(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = TRAIN_BATCH
    ids = _tokens(cfg.vocab_size, (B, S), SEED)
    warm, warm_s = run_steps(step, ids, TRAIN_WARMUP)
    _reset_train_launches()
    losses, wall = run_steps(step, ids, TRAIN_STEPS)
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = warm + losses
    L = cfg.num_hidden_layers
    tok_s = B * S * TRAIN_STEPS / wall
    fpt = llama_flops_per_token(cfg, S)
    row = dict(phase="train_7b_bf16", layers=L, params=param_count(cfg),
               batch=B, seq=S, init_s=init_s, warmup_step_s=warm_s,
               steps=TRAIN_STEPS, wall_s=wall, step_s=wall / TRAIN_STEPS,
               losses=losses, expected_first_loss=init_loss(cfg),
               tokens_per_s=tok_s, flops_per_token=fpt,
               mfu=tok_s * fpt / PEAK_FLOPS["bfloat16"],
               peak_memory_bytes=peak, launches=launches)
    row["profile"] = profile_device(lambda: step(ids, ids),
                                    wall / TRAIN_STEPS)
    emit(row)
    want = {"flash_fwd": 2 * L * TRAIN_STEPS,
            "flash_bwd_fused": L * TRAIN_STEPS, "flash_bwd_two_kernel": 0,
            "rms_norm": 0}
    if launches != want:
        raise AssertionError("7B training launches %s, want %s"
                             % (launches, want))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss: %s" % losses)
    if not abs(losses[0] - row["expected_first_loss"]) <= 0.5:
        raise AssertionError("first loss %g is not within 0.5 of the "
                             "random-init value %g"
                             % (losses[0], row["expected_first_loss"]))
    del model, step
    torch.cuda.empty_cache()
    return row


def _plain_kernels():
    """A context in which the model's and the layerwise step's attention
    run the flash plain versions on the card (``_flash_fwd_plain`` /
    ``_flash_bwd_plain`` under an autograd Function) and the layerwise
    step's norms the plain version of kernel #4's layerwise variant
    (differentiated by autograd):
    the reference side of the training parity phases.  The kernel
    wrappers are not touched."""
    import contextlib
    import torch
    from paddle_tpu_torch.jit import layerwise as lw
    from paddle_tpu_torch.models import llama as lm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.rms_norm import _rms_norm_plain

    class PlainFlashRope(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, cos, sin):
            out, lse = fa._flash_fwd_plain(q, k, v, True, (cos, sin))
            ctx.save_for_backward(q, k, v, cos, sin, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, cos, sin, out, lse = ctx.saved_tensors
            form = ("fused" if fa.fused_bwd_taken(k.shape[1])
                    else "two_kernel")
            return (*fa._flash_bwd_plain(q, k, v, out, lse, g.contiguous(),
                                         True, (cos, sin), form=form),
                    None, None)

    def plain(q, k, v, rotary_base, is_causal=True):
        cos, sin = fa.rope_tables(q.shape[1], q.shape[3], rotary_base,
                                  device=q.device)
        return PlainFlashRope.apply(q, k, v, cos, sin)

    def plain_sdpa(q, k, v, cos, sin, causal=True):
        return PlainFlashRope.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), cos, sin)

    swaps = ((lm, "flash_attention_rope", plain),
             (lw, "flash_rope_sdpa", plain_sdpa),
             (lw, "rms_norm", functools.partial(_rms_norm_plain,
                                                round_first=True)))

    @contextlib.contextmanager
    def swapped():
        orig = [getattr(mod, name) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for (mod, name, _), fn in zip(swaps, orig):
                setattr(mod, name, fn)
    return swapped()


def check_plain_run(name):
    """The reference side of a parity phase, run with the counts reset
    just before it, launched no training kernel."""
    launched = {k: n for k, n in _train_launches().items() if n}
    if launched:
        raise AssertionError("%s: the plain run launched kernels %s"
                             % (name, launched))


PARITY_STEPS = 3
# fp32 (TF32 off): kernel and plain paths differ in summation order only;
# Adam may turn a rounding difference in a ~0 gradient into a +-lr move of
# that parameter, which moves a loss near 10.4 by far less than 1e-4 of it
PARITY_RTOL = 1e-4


def phase_train_parity():
    """Llama-2-7B widths at 2 layers in fp32: ``PARITY_STEPS`` steps
    through the kernels against the same steps through the plain flash
    versions on the card, same weights and batch; the loss trajectories
    must agree to ``PARITY_RTOL``."""
    import torch
    from paddle_tpu_torch.models.llama import llama_7b_config
    cfg = llama_7b_config(dtype="float32", num_hidden_layers=2,
                          recompute=True)
    ids = _tokens(cfg.vocab_size, TRAIN_BATCH, SEED + 1)
    model, step = _trainer(cfg)
    _reset_train_launches()
    got, wall = run_steps(step, ids, PARITY_STEPS)
    launches = _train_launches()
    del model, step
    torch.cuda.empty_cache()
    model, step = _trainer(cfg)
    _reset_train_launches()
    with _plain_kernels():
        want, plain_wall = run_steps(step, ids, PARITY_STEPS)
    check_plain_run("fp32 training parity")
    del model, step
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    row = dict(phase="train_parity_2layer_fp32", steps=PARITY_STEPS,
               kernel_losses=got, plain_losses=want, max_rel_diff=rel,
               rtol=PARITY_RTOL, kernel_wall_s=wall, plain_wall_s=plain_wall,
               launches=launches)
    emit(row)
    if not rel <= PARITY_RTOL:
        raise AssertionError("fp32 training losses, kernels vs plain: %s vs "
                             "%s (max rel diff %g > %g)"
                             % (got, want, rel, PARITY_RTOL))
    if launches["flash_fwd"] == 0 or launches["flash_bwd_fused"] == 0:
        raise AssertionError("the fp32 parity run launched no flash "
                             "kernel: %s" % launches)
    return row


def codellama_7b_config(**kw):
    """CodeLlama-7B's public config (Llama-2-7B widths, vocabulary 32016,
    rope_theta 1e6, 16384 positions)."""
    from paddle_tpu_torch.models.llama import llama_7b_config
    cfg = dict(vocab_size=32016, rope_theta=1e6,
               max_position_embeddings=16384)
    cfg.update(kw)
    return llama_7b_config(**cfg)


def phase_train_long():
    """CodeLlama-7B at 2 layers, bf16, batch 1 x 16384, 2 steps: the
    router must take the two-kernel backward (both halves once per layer
    per step) and never the fused one."""
    import torch
    from paddle_tpu_torch.models.llama import llama_flops_per_token
    cfg = codellama_7b_config(dtype="bfloat16", num_hidden_layers=2,
                              recompute=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step = _trainer(cfg)
    ids = _tokens(cfg.vocab_size, LONG_BATCH, SEED + 2)
    steps = 2
    _reset_train_launches()
    losses, wall = run_steps(step, ids, steps)
    launches = _train_launches()
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_fused": 0,
            "flash_bwd_two_kernel": L * steps, "rms_norm": 0}
    row = dict(phase="train_long_16k_bf16", layers=L, batch=LONG_BATCH[0],
               seq=LONG_BATCH[1], steps=steps, wall_s=wall, losses=losses,
               tokens_per_s=LONG_BATCH[0] * LONG_BATCH[1] * steps / wall,
               flops_per_token_full_depth=llama_flops_per_token(
                   codellama_7b_config(), LONG_BATCH[1]),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    if launches != want:
        raise AssertionError("16k training launches %s, want %s"
                             % (launches, want))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite 16k training loss: %s" % losses)
    del model, step
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phases 9-10: layerwise training
# ---------------------------------------------------------------------------
LAYERWISE_LR = 1e-3               # bench.py::_bench_layerwise's Adafactor
LAYERWISE_PEAK_BYTES = 24e9
LAYERWISE_TRAINSTEP_RTOL = 5e-4   # the reference's bound (test_layerwise)


def _layerwise(cfg, seed=SEED):
    """A random-init ``LlamaLayerwiseTrainStep`` on the card with
    ``Adafactor(LAYERWISE_LR)``."""
    from paddle_tpu_torch.jit.layerwise import LlamaLayerwiseTrainStep
    from paddle_tpu_torch.optimizer import Adafactor
    return LlamaLayerwiseTrainStep(
        cfg, Adafactor(LAYERWISE_LR, parameters=[])).init(seed)


def phase_train_7b_layerwise():
    """``bench.py``'s headline line on the card: Llama-2-7B bf16 through
    the layerwise step with Adafactor, batch 2 x 2048, one warm-up step
    and ``TRAIN_STEPS`` timed steps whose launches must be exact (per
    step: flash forward 2L, once in the forward sweep and once in the
    reverse sweep's recompute; the fused backward L; RMSNorm 4L + 1, two
    norms per block in each sweep and the final norm once, outside the
    head's per-chunk recompute), peak memory below
    ``LAYERWISE_PEAK_BYTES``; then one profiled step."""
    import torch
    from paddle_tpu_torch.models.llama import (llama_7b_config,
                                               llama_flops_per_token)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cfg = llama_7b_config(dtype="bfloat16")
    t0 = time.perf_counter()
    step = _layerwise(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_bytes = torch.cuda.memory_allocated()
    B, S = TRAIN_BATCH
    ids = _tokens(cfg.vocab_size, (B, S), SEED)
    warm, warm_s = run_steps(step, ids, TRAIN_WARMUP)
    _reset_train_launches()
    losses, wall = run_steps(step, ids, TRAIN_STEPS)
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = warm + losses
    L = cfg.num_hidden_layers
    tok_s = B * S * TRAIN_STEPS / wall
    fpt = llama_flops_per_token(cfg, S)
    row = dict(phase="train_7b_layerwise_bf16", layers=L,
               params=step.param_count(), optimizer="Adafactor(%g)"
               % LAYERWISE_LR, batch=B, seq=S, init_s=init_s,
               warmup_step_s=warm_s, steps=TRAIN_STEPS, wall_s=wall,
               step_s=wall / TRAIN_STEPS, losses=losses,
               expected_first_loss=init_loss(cfg), tokens_per_s=tok_s,
               flops_per_token=fpt,
               mfu=tok_s * fpt / PEAK_FLOPS["bfloat16"],
               resident_before_bytes=resident,
               params_and_state_bytes=params_bytes - resident,
               peak_memory_bytes=peak, launches=launches)
    row["profile"] = profile_device(lambda: step(ids, ids),
                                    wall / TRAIN_STEPS)
    emit(row)
    want = {"flash_fwd": 2 * L * TRAIN_STEPS,
            "flash_bwd_fused": L * TRAIN_STEPS, "flash_bwd_two_kernel": 0,
            "rms_norm": (4 * L + 1) * TRAIN_STEPS}
    if launches != want:
        raise AssertionError("7B layerwise launches %s, want %s"
                             % (launches, want))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite layerwise loss: %s" % losses)
    if not abs(losses[0] - row["expected_first_loss"]) <= 0.5:
        raise AssertionError("first layerwise loss %g is not within 0.5 of "
                             "the random-init value %g"
                             % (losses[0], row["expected_first_loss"]))
    if not peak < LAYERWISE_PEAK_BYTES:
        raise AssertionError("7B layerwise peak memory %.3f GB is not "
                             "below %.0f GB" % (peak / 1e9,
                                                LAYERWISE_PEAK_BYTES / 1e9))
    del step
    torch.cuda.empty_cache()
    return row


def phase_layerwise_parity():
    """Llama-2-7B widths at 2 layers in fp32, ``PARITY_STEPS`` steps from
    the same weights and batch: the layerwise step through the kernels
    (flash and #4) against the same steps through their plain versions on
    the card (``PARITY_RTOL``), and against ``TrainStep`` with
    ``Adafactor`` over the eager model (``LAYERWISE_TRAINSTEP_RTOL``;
    there Adafactor factors ``[out, in]`` matrices, equal in exact
    arithmetic)."""
    import torch
    from paddle_tpu_torch.jit.layerwise import LlamaLayerwiseTrainStep
    from paddle_tpu_torch.jit.train_step import TrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaPretrainingCriterion,
                                               llama_7b_config)
    from paddle_tpu_torch.optimizer import Adafactor
    cfg = llama_7b_config(dtype="float32", num_hidden_layers=2)
    ids = _tokens(cfg.vocab_size, TRAIN_BATCH, SEED + 3)
    state = _layerwise(cfg).state_dict()

    def layerwise():
        return LlamaLayerwiseTrainStep(
            cfg, Adafactor(LAYERWISE_LR, parameters=[])).set_state_dict(state)
    _reset_train_launches()
    got, wall = run_steps(layerwise(), ids, PARITY_STEPS)
    launches = _train_launches()
    torch.cuda.empty_cache()
    _reset_train_launches()
    with _plain_kernels():
        plain, plain_wall = run_steps(layerwise(), ids, PARITY_STEPS)
    check_plain_run("fp32 layerwise parity")
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(cfg)
    model.load_state_dict(state)
    del state
    fused = TrainStep(model, LlamaPretrainingCriterion(),
                      Adafactor(LAYERWISE_LR,
                                parameters=model.named_parameters()))
    train_step, ts_wall = run_steps(fused, ids, PARITY_STEPS)
    del model, fused
    torch.cuda.empty_cache()
    rel_plain = max(abs(a - b) / abs(b) for a, b in zip(got, plain))
    diff_ts = max(abs(a - b) / max(1.0, abs(b))
                  for a, b in zip(got, train_step))
    row = dict(phase="layerwise_parity_2layer_fp32", steps=PARITY_STEPS,
               kernel_losses=got, plain_losses=plain,
               train_step_losses=train_step, max_rel_diff_plain=rel_plain,
               rtol_plain=PARITY_RTOL, max_diff_train_step=diff_ts,
               tol_train_step=LAYERWISE_TRAINSTEP_RTOL, kernel_wall_s=wall,
               plain_wall_s=plain_wall, train_step_wall_s=ts_wall,
               launches=launches)
    emit(row)
    if not rel_plain <= PARITY_RTOL:
        raise AssertionError("fp32 layerwise losses, kernels vs plain: %s "
                             "vs %s (max rel diff %g > %g)"
                             % (got, plain, rel_plain, PARITY_RTOL))
    if not diff_ts < LAYERWISE_TRAINSTEP_RTOL:
        raise AssertionError("fp32 layerwise vs TrainStep + Adafactor: %s "
                             "vs %s (%g >= %g)" % (got, train_step, diff_ts,
                                                   LAYERWISE_TRAINSTEP_RTOL))
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * L * PARITY_STEPS,
            "flash_bwd_fused": L * PARITY_STEPS, "flash_bwd_two_kernel": 0,
            "rms_norm": (4 * L + 1) * PARITY_STEPS}
    if launches != want:
        raise AssertionError("fp32 layerwise launches %s, want %s"
                             % (launches, want))
    return row


def kernel_summary(rows, serving, flash_rows, train_launches):
    """One entry per kernel variant for the final JSON line: the times at
    the variant's main-path shape, the worst error of any shape, and the
    launches of the run of the path that drives it (``path``)."""
    def pick(rs, case):
        return next(r for r in rs if r["case"] == case
                    and r["dtype"] == "bfloat16")
    out = []
    for name, rs, case, src, rep, path in (
            ("ragged_paged_attention", rows["ragged"],
             "7b_mixed_8x1024+256", RAGGED_SOURCE, RAGGED_REPLACES,
             "serve_7b"),
            ("rope_qkv_epilogue", rows["rope"], "7b_T512", ROPE_SOURCE,
             ROPE_REPLACES, "serve_7b"),
            ("paged_attention", rows["decode"], "7b_decode_8x1024",
             DECODE_SOURCE, DECODE_REPLACES, "serve_7b_split"),
            ("paged_attention_int8", rows["decode_int8"], "7b_decode_8x1024",
             DECODE_SOURCE, DECODE_REPLACES, "serve_7b_kv8_split"),
            ("ragged_paged_attention_int8", rows["ragged_int8"],
             "7b_mixed_8x1024+256", RAGGED_SOURCE, RAGGED_REPLACES,
             "serve_7b_kv8_mixed")):
        r = pick(rs, case)
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=serving[path]["launches"][name], path=path,
                     max_abs_err=max(x["max_abs_err"] for x in rs),
                     ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=None)
        if name.startswith("ragged"):
            # the all-decode step and the speculative verify step, beside
            # it, with the verify step's launches in the spec engines
            d, v = pick(rs, "7b_decode_8x1024"), pick(rs, VERIFY_CASE)
            entry.update(decode_only_ms=d["kernel_ms"],
                         decode_only_bound_ms=d["bound_ms"],
                         verify_ms=v["kernel_ms"],
                         verify_plain_ms=v["plain_ms"],
                         verify_bound_ms=v["bound_ms"])
        entry["launches_by_path"] = {
            p: r["launches"][name] for p, r in serving.items()
            if r["launches"].get(name)}
        out.append(entry)
    # the generic kernels: the head-dim-256 serving path launches them
    # (the 7B paths assert 0); timed at GENERIC_MAIN
    for name, rs, case, src, path in (
            ("ragged_paged_attention_generic", rows["ragged_generic"],
             GENERIC_MAIN + "_mixed_8x1024+256", RAGGED_SOURCE,
             "serve_d256_mixed"),
            ("ragged_paged_attention_generic_int8",
             rows["ragged_generic_int8"], GENERIC_MAIN + "_mixed_8x1024+256",
             RAGGED_SOURCE, "serve_d256_kv8_mixed"),
            ("paged_attention_generic", rows["decode_generic"],
             GENERIC_MAIN + "_decode_8x1024", DECODE_SOURCE,
             "serve_d256_split"),
            ("paged_attention_generic_int8", rows["decode_generic_int8"],
             GENERIC_MAIN + "_decode_8x1024", DECODE_SOURCE,
             "serve_d256_kv8_split")):
        r = pick(rs, case)
        out.append(dict(
            name=name, route="cuda", source=src,
            replaces=RAGGED_REPLACES if src == RAGGED_SOURCE
            else DECODE_REPLACES,
            launches=serving[path]["launches"][name], path=path,
            shape=case, max_abs_err=max(x["max_abs_err"] for x in rs),
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None,
            cases={x["case"]: x["kernel_ms"] for x in rs}))
    # the weight dequant: the w8 serving path launches it (L + 1 a step)
    rs = rows["dequant"]
    r = pick(rs, DEQUANT_MAIN)
    path = "serve_7b_w8"
    out.append(dict(
        name="dequant_int8", route="cuda", source=DEQUANT_SOURCE,
        replaces=DEQUANT_REPLACES,
        launches=serving[path]["launches"]["dequant_int8"], path=path,
        max_abs_err=max(x["max_abs_err"] for x in rs),
        ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        library=r["library"],
        lm_head_ms=pick(rs, "7b_lm_head")["kernel_ms"],
        launches_by_path={p: x["launches"]["dequant_int8"]
                          for p, x in serving.items()
                          if x.get("launches", {}).get("dequant_int8")}))
    # the layerwise step launches #4's round-first variant; #4's own
    # rounding point (no path launches it) is timed beside it
    rs = rows["rms_norm"]
    r, last = (next(x for x in rs if x["case"] == RMS_MAIN and x["kernel"]
                    == k and x["dtype"] == "bfloat16")
               for k in ("rms_norm_round_first", "rms_norm"))
    out.append(dict(name="rms_norm", variant="round_first", route="cuda",
                    source=RMS_SOURCE, replaces=RMS_REPLACES,
                    launches=train_launches["train_7b_layerwise"]["rms_norm"],
                    path="train_7b_layerwise",
                    max_abs_err=max(x["max_abs_err"] for x in rs
                                    if x["kernel"] == r["kernel"]),
                    ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    round_last_ms=last["kernel_ms"]))
    for name in ALL_FLASH:
        case, path = FLASH_MAIN[name]
        rs = [r for r in flash_rows if r["kernel"] == name]
        r = next(x for x in rs if x["case"] == case)
        out.append(dict(name=name, route="cuda", source=r["source"],
                        replaces=FLASH_REPLACES[name],
                        launches=train_launches[path][name], path=path,
                        max_abs_err=max(x["max_abs_err"] for x in rs),
                        ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"]))
    return out


def _scale_rows_into(got, timer):
    """Append :func:`decode_at_scale`'s rows to ``got``, timed by
    ``timer`` (this module's ``time_ms`` and ``emit`` are swapped for the
    run)."""
    import torch
    global time_ms, emit
    saved = time_ms, emit
    time_ms, emit = timer, got.append
    try:
        gen = torch.Generator("cuda").manual_seed(SEED)
        for quantized in (False, True):
            decode_at_scale(gen, quantized)
    finally:
        time_ms, emit = saved


def profile_prefix() -> int:
    """``--profile-prefix``: the device time the prefix cache saves on
    the chat traffic (:func:`chat_turns`), which the host-bound wall
    need not show.  The 7B bf16 model serves it with and without the
    cache, each once for its wall (launches exact) and once under
    ``torch.profiler`` (device busy seconds by kind, idle share)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    phase_device()
    phase_build()
    cfg = llama_7b_config(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    _, prompts = chat_prompts(cfg.vocab_size)
    for name, kw in (("serve_7b_prefix_cold", ENGINE_KW),
                     ("serve_7b_prefix", PREFIX_KW)):
        _, _, stats = serve(model, None, kw, traffic=chat_turns(prompts))
        check_launches(name, kw, stats, cfg.num_hidden_layers)
        profile_serve(name + "_bf16", model, None, stats["wall_s"], kw,
                      chat_turns(prompts))
    return 0


def timing_of(tree: str) -> int:
    """``--timing-of DIR``: the kernels of the checkout at ``DIR`` (its
    ``paddle_tpu_torch`` and its ``chip_smoke.py``, e.g. an earlier commit
    unpacked with ``git archive``) timed by both methods, the device time
    of :func:`time_ms` ("queued") and the earlier timing ("paced",
    ``queued=False``): its phases 2 and 5 run once with each, and one JSON line per case gives every time of
    the case under both.  A tree whose phase 2 lacks #7 at
    ``DECODE_SCALE_CASES`` (an earlier commit) is timed there too, by
    this script's :func:`decode_at_scale` through the tree's package.
    Run it for two trees in one call to compare them on one yardstick."""
    import importlib.util
    import os
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import paddle_tpu_torch
    if not paddle_tpu_torch.__file__.startswith(tree + os.sep):
        raise AssertionError("imported %s, not the tree's package"
                             % paddle_tpu_torch.__file__)
    mod.phase_device()
    mod.phase_build()
    runs = {}
    for method, fn in (("paced", functools.partial(time_ms, queued=False)),
                       ("queued", time_ms)):
        got = []
        mod.time_ms, mod.emit = fn, got.append
        mod.phase_kernels()
        mod.phase_flash_kernels()
        if not any(r.get("case") == DECODE_SCALE_CASES[0][0] for r in got):
            _scale_rows_into(got, fn)
        runs[method] = [r for r in got if "kernel" in r]
    for a, b in zip(runs["paced"], runs["queued"]):
        if (a["kernel"], a.get("case"), a.get("dtype")) != (
                b["kernel"], b.get("case"), b.get("dtype")):
            raise AssertionError("the two passes ran other cases")
        emit(dict(tree=tree, kernel=a["kernel"], case=a.get("case"),
                  dtype=a.get("dtype"), bound_ms=a.get("bound_ms"),
                  **{m: {k: v for k, v in r.items()
                         if k.endswith("_ms") and k != "bound_ms"}
                     for m, r in (("paced", a), ("queued", b))}))
    return 0


def main() -> int:
    """Every phase in order, then the kernels line and the ok line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--timing-of"]:
        return timing_of(sys.argv[2])
    if sys.argv[1:2] == ["--profile-prefix"]:
        return profile_prefix()
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print("phase %s: %.1f s (%.1f s since start)"
              % (name, time.perf_counter() - t0,
                 time.perf_counter() - t_start), flush=True)
        return out

    phase_device()
    run("build", phase_build)
    rows = run("kernels", phase_kernels)
    serving = run("serving_7b", phase_serving_7b)
    run("parity_2l", phase_parity_2l)
    run("logits", phase_logits_by_depth)
    flash_rows = run("flash", phase_flash_kernels)
    train = run("train_7b", phase_train_7b)
    run("train_parity", phase_train_parity)
    long = run("train_long", phase_train_long)
    layerwise = run("train_7b_layerwise", phase_train_7b_layerwise)
    run("layerwise_parity", phase_layerwise_parity)
    emit({"kernels": kernel_summary(
        rows, serving, flash_rows,
        {"train_7b": train["launches"],
         "train_long_16k": long["launches"],
         "train_7b_layerwise": layerwise["launches"]})})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
