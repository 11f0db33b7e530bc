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
   must reject #4's own rounding point.  Times are device time
   (:func:`time_ms`).
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
   the draft tokens proposed and accepted reported.  Last, the generic
   kernels' serving path (:func:`serve_head_dim_256`): a 2-layer model at
   head dim 256 through both engines and both pool types, with the
   generic kernels' launches exact.
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
   0.1) must accept a full chain of ``spec_k`` drafts at least once.
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

The script imports nothing of JAX and nothing of ``paddle_tpu``.  Without
a CUDA card it exits nonzero before printing any result.
"""
from __future__ import annotations

import functools
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
NO_LIBRARY = ("no single PyTorch call computes it: %s")

# served traffic (phases 3 and 4)
PROMPT_LENS = (64, 1024, 200, 768, 128, 512, 900, 320)
NEW_TOKENS = 32
ENGINE_BASE = dict(max_batch_size=8, block_size=16, num_blocks=640,
                   max_seq_len=1088, prefill_chunk_size=256)
ENGINE_KW = dict(ENGINE_BASE, mixed_step=True)           # the mixed engine
SPLIT_KW = dict(ENGINE_BASE, mixed_step=False, prefill_buckets="auto")
DENSE_KW = dict(ENGINE_BASE, mixed_step=False, prefill_buckets=None)


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
# gives the kernel variant: (module, wrapper, attribute)
SERVING_COUNTERS = {
    "ragged_paged_attention": ("paged_attention", "ragged_paged_attention",
                               "launches"),
    "ragged_paged_attention_int8": ("paged_attention",
                                    "ragged_paged_attention",
                                    "int8_launches"),
    "paged_attention": ("paged_attention", "paged_attention", "launches"),
    "paged_attention_int8": ("paged_attention", "paged_attention",
                             "int8_launches"),
    "ragged_paged_attention_generic": ("paged_attention",
                                       "ragged_paged_attention",
                                       "generic_launches"),
    "ragged_paged_attention_generic_int8": ("paged_attention",
                                            "ragged_paged_attention",
                                            "generic_int8_launches"),
    "paged_attention_generic": ("paged_attention", "paged_attention",
                                "generic_launches"),
    "paged_attention_generic_int8": ("paged_attention", "paged_attention",
                                     "generic_int8_launches"),
    "rope_qkv_epilogue": ("kernels", "rope_qkv_epilogue", "launches"),
    "rope_qkv_epilogue_amax": ("kernels", "rope_qkv_epilogue",
                               "amax_launches"),
}


def _counter(name):
    import importlib
    mod, fn, attr = SERVING_COUNTERS[name]
    return getattr(importlib.import_module("paddle_tpu_torch.ops." + mod),
                   fn), attr


def _reset_launches():
    for name in SERVING_COUNTERS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)


def _launches():
    out = {}
    for name in SERVING_COUNTERS:
        fn, attr = _counter(name)
        out[name] = getattr(fn, attr)
    return out


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


def serve(model, prompts, engine_kw=None, draft=None, sampled=False):
    """Admit 4, step, admit 4, run to completion on an engine built with
    ``engine_kw`` (default: the mixed engine) and ``draft`` as its draft
    model; ``sampled``: the requests carry :func:`request_knobs`.
    Returns the engine, the tokens per request and the run's statistics:
    the launch counts (reset just before), engine steps (and the spread of
    their host seconds: ``eng.step()`` returns once the step is queued, or
    once it has read its tokens back), the split engine's decode steps and
    prefill chunks, the mixed engine's target launches and the draft's
    launches, and for a speculative engine the draft tokens proposed and
    accepted."""
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
    t0 = time.perf_counter()
    rids = [eng.add_request(p, NEW_TOKENS, **request_knobs(i, sampled))
            for i, p in enumerate(prompts[:4])]
    step()
    rids += [eng.add_request(p, NEW_TOKENS, **request_knobs(i, sampled))
             for i, p in enumerate(prompts[4:], 4)]
    while eng.has_work():
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(step_s)
    launches = _launches()
    outs = [eng.result(r) for r in rids]
    cache = eng.caches[0]
    whole = sorted(cache._free + [cache.sink]) == list(
        range(cache.num_blocks + 1))
    if not whole:
        raise AssertionError("pool not whole after run_to_completion: %d "
                             "free of %d" % (len(cache._free),
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
    stats = dict(steps=steps, decode_steps=eng.decode_step.n,
                 prefill_chunks=(eng.prefill_step.n
                                 if eng.prefill_step is not None else 0),
                 prompt_tokens=int(sum(map(len, prompts))),
                 generated_tokens=gen_tok, wall_s=wall,
                 tokens_per_s=gen_tok / wall,
                 prompt_and_generated_tokens_per_s=(
                     gen_tok + sum(map(len, prompts))) / wall,
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
    want = dict.fromkeys(SERVING_COUNTERS, 0)
    rope = "rope_qkv_epilogue_amax" if int8 else "rope_qkv_epilogue"
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
                  engine_kw=None):
    """The same traffic once more under ``torch.profiler`` (see
    :func:`profile_device`)."""
    row = dict(phase="profile_" + name, **profile_device(
        lambda: serve(model, prompts, engine_kw), unprofiled_wall_s))
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
        emit(stats)
        runs[name] = stats
    del draft
    return runs


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
    row.update(gates)
    for mode in ("mixed", "split"):
        row["kv8_%s_vs_fp32_%s" % (mode, mode)] = _rates(
            outs["kv8_" + mode], outs[mode])[0]
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
