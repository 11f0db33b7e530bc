"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, the tiny engines against the eager model and the
CPU engines, and tiny training steps (``TrainStep`` and the layerwise
step) through the kernels, on the device.  Every test
skips itself when no CUDA device is present.

This file imports neither JAX nor ``paddle_tpu``, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which sets up the JAX CPU mesh):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import (FLASH_FORM, _flash_case, _quantize_pools,
                        _ragged_case, _rms_inputs, flash_excess, flash_noise,
                        flash_tolerance, cut_lengths, int8_tolerance,
                        near_bf16_midpoint, ragged_tolerance, rms_tolerance,
                        RMS_MIDPOINT_ULPS)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.layerwise import LlamaLayerwiseTrainStep
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny_config,
                                           llama_truncated_draft)
from paddle_tpu_torch.ops import dequant as dq
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import kernels as pk
from paddle_tpu_torch.ops import rms_norm as rn
from paddle_tpu_torch.optimizer import Adafactor, AdamW
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_amax", [False, True])
def test_rope_epilogue_kernel_bitwise(cuda, dtype, with_amax):
    g = torch.Generator(cuda).manual_seed(0)
    N, H, Hkv, D = 37, 8, 4, 64
    q, k, v = (torch.randn(N, h, D, generator=g, device=cuda).to(dtype)
               for h in (H, Hkv, Hkv))
    pos = torch.randint(0, 4096, (N,), generator=g, device=cuda)
    cos, sin = pk.rope_tables_for_positions(pos, D)
    counter = "amax_launches" if with_amax else "launches"
    before = getattr(pk.rope_qkv_epilogue, counter)
    got = pk.rope_qkv_epilogue(q, k, v, cos, sin, with_amax)
    want = pk._rope_qkv_epilogue_plain(q, k, v, cos, sin, with_amax)
    assert getattr(pk.rope_qkv_epilogue, counter) == before + 1
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def _pack(spans, n_pad, T, H, Hkv, D, bs, dtype, dev, seed=0):
    """chip_smoke's ragged pack: a NaN page behind every unused table
    entry and ``n_pad`` padding spans (q_len 0, kv_len 1, all-sink)."""
    gen = torch.Generator(dev).manual_seed(seed)
    return _ragged_case(spans, T, H, Hkv, D, bs, dtype, gen, poison=True,
                        n_pad_spans=n_pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (8, 1)],
                         ids=["mha", "gqa3", "mqa8"])
@pytest.mark.parametrize("D,bs", [(32, 4), (64, 5), (128, 16)])
def test_ragged_attention_kernel_matches_plain(cuda, dtype, heads, D, bs):
    """Decode spans, a long chunk (several row tiles), a prefix-offset
    span and padding spans; rows outside spans stay 0; NaN pages behind
    unused table entries never reach the output."""
    H, Hkv = heads
    spans = [(1, 7), (70, 90), (3, 3), (1, 1), (9, 41), (2, 11)]
    T = sum(q for q, _ in spans) + 5
    args = _pack(spans, 2, T, H, Hkv, D, bs, dtype, cuda)
    before = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args, span_q=70,
                                    work=_work(args, H, Hkv, bs))
    want = pa._ragged_attention_plain(*args, 1.0 / np.sqrt(D))
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ragged_tolerance(want)
    assert (got[sum(q for q, _ in spans):] == 0).all()


def _work(args, H, Hkv, bs):
    """The step's work list for a pack (used by the tensor-core kernel)."""
    q_lens, kv_lens = args[5], args[6]
    return torch.from_numpy(pa.ragged_work(q_lens.cpu(), kv_lens.cpu(), H,
                                           Hkv, bs)).to(q_lens.device)


def _hold_paged(cuda, kind, quantized, dtype, H, Hkv, D, bs, lens, seed=1,
                shared=0):
    """One paged kernel call against its plain version: ``kind`` "ragged"
    (spans ``lens`` of (q_len, kv_len), padding spans, rows outside them
    0) or "decode" (one query per slot at kv ``lens``, masked slots), NaN
    pages (or scales) behind every unused table entry, int8 pools with
    the per-element tolerance that must reject a kernel that skips each
    last page; one launch counted.  ``shared``: every span's first
    ``shared`` table entries name span 0's pages (the prefix cache's
    shared pages: one physical page in several block tables)."""
    gen = torch.Generator(cuda).manual_seed(seed)
    if kind == "ragged":
        T = sum(ql for ql, _ in lens) + 5
        q, kc, vc, bt, qo, ql, kl = _ragged_case(
            lens, T, H, Hkv, D, bs, dtype, gen, poison=True, n_pad_spans=2)
    else:
        q, kc, vc, bt, qo, ql, kl = _ragged_case(
            [(1, s) for s in lens], len(lens) + 2, H, Hkv, D, bs, dtype, gen,
            poison=True, n_pad_spans=2)
    if shared:
        n = len(lens)
        assert all(k >= shared * bs for k in kl[:n].tolist())
        bt[1:n, :shared] = bt[0, :shared]
    scales = {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)
    scale = 1.0 / np.sqrt(D)

    def kernel(kv=kl):
        if kind == "ragged":
            return pa.ragged_paged_attention(
                q, kc, vc, bt, qo, ql, kv, span_q=int(ql.max()),
                work=_work((q, kc, vc, bt, qo, ql, kv), H, Hkv, bs),
                **scales)
        return pa.paged_attention(q, kc, vc, bt, kv, **scales)

    def plain(kv=kl):
        if kind == "ragged" and quantized:
            return pa._ragged_attention_int8_plain(
                q, kc, vc, ks, vs, bt, qo, ql, kv, scale, flip_bound=True)
        if kind == "ragged":
            return pa._ragged_attention_plain(q, kc, vc, bt, qo, ql, kv,
                                              scale)
        return pa._paged_attention_plain(q, kc, vc, bt, kv, scale,
                                         flip_bound=quantized, **scales)
    wrapper = (pa.ragged_paged_attention if kind == "ragged"
               else pa.paged_attention)
    counter = "int8_launches" if quantized else "launches"
    before = getattr(wrapper, counter)
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    if quantized:
        want, flips = want
        tol = int8_tolerance(want, flips, vmax)
    else:
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()
    if kind == "ragged":
        assert (got[sum(ql for ql, _ in lens):] == 0).all()
    if quantized:   # the limit rejects a kernel that skips each last page
        floor = ql if kind == "ragged" else kl.clamp(max=1)
        cut = kernel(cut_lengths(kl, floor, bs, True))
        assert not (cut.float() - want.float()).abs().le(tol).all()


# the prefix cache's traffic at the kernels (block size 16, two shared
# pages): ragged spans of a decode, a suffix chunk at a page-aligned
# offset, a whole-prompt hit's one-token span and another decode; decode
# slots at several lengths over the same two pages
SHARED_RAGGED = [(1, 97), (48, 80), (1, 64), (1, 40)]
SHARED_DECODE = [97, 80, 64, 40, 33]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ragged", "decode"])
def test_paged_kernels_over_shared_pages_match_plain(cuda, kind, dtype,
                                                     quantized):
    """#5 and #7 over block tables that repeat the same physical pages in
    every slot, as the prefix cache builds them, against their plain
    versions within the usual tolerances (GQA 8/2, head dim 128)."""
    lens = SHARED_RAGGED if kind == "ragged" else SHARED_DECODE
    _hold_paged(cuda, kind, quantized, dtype, 8, 2, 128, 16, lens,
                shared=2)


def _seeded_pools(dev, kv_dtype, layers=3, nb=8, bs=4, hkv=2, d=8):
    """Seeded pools on ``dev``, the same values on every device."""
    rng = np.random.RandomState(7)
    caches = [pa.PagedKVCache(nb, bs, hkv, d, sink_block=True, device=dev,
                              kv_dtype=kv_dtype) for _ in range(layers)]
    for c in caches:
        names = ["key_cache", "value_cache"] + (
            ["key_scale", "value_scale"] if c.quantized else [])
        for name in names:
            t = getattr(c, name)
            a = (rng.rand(*t.shape) + 0.1 if name.endswith("scale")
                 else rng.randint(-127, 128, t.shape) if c.quantized
                 else rng.randn(*t.shape))
            t.copy_(torch.from_numpy(np.asarray(a, np.float32)).to(t.dtype))
    return caches


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_page_moves_on_card_match_cpu_bitwise(cuda, kv_dtype):
    """``copy_block``, ``extract_blocks`` and ``inject_blocks`` on card
    pools give the CPU's pools and buffers bit for bit, with one host copy
    per dtype each way."""
    from paddle_tpu_torch.jit import serving_step as ss
    pools = {dev: _seeded_pools(dev, kv_dtype) for dev in ("cpu", cuda)}
    bufs = {}
    for dev, caches in pools.items():
        ss.copy_block(caches, 2, 5)
        t0 = ss.migration_transfers()
        bufs[dev] = ss.extract_blocks(caches, [6, 1, 5], n_tokens=10)
        ss.inject_blocks(caches, bufs[dev], [0, 4, 7])
        t1 = ss.migration_transfers()
        per_dtype = 2 if kv_dtype == "int8" else 1
        assert t1["d2h"] - t0["d2h"] == t1["h2d"] - t0["h2d"] == per_dtype
    a, b = bufs["cpu"], bufs[cuda]
    assert np.array_equal(a.codes, b.codes) and a.geometry() == b.geometry()
    assert (a.scales is None and b.scales is None) or np.array_equal(
        a.scales, b.scales)
    for c, g in zip(pools["cpu"], pools[cuda]):
        for name in ("key_cache", "value_cache", "key_scale", "value_scale"):
            if getattr(c, name) is not None:
                assert torch.equal(getattr(c, name), getattr(g, name).cpu())


@pytest.mark.parametrize("mode", [
    dict(mixed_step=True, prefill_chunk_size=16),
    dict(prefill_buckets="auto", prefill_chunk_size=16),
    dict(mixed_step=True, prefill_chunk_size=16, kv_dtype="int8"),
    dict(mixed_step=True, prefill_chunk_size=16, sampling=True, n=3),
    dict(mixed_step=True, prefill_chunk_size=16, host_tier_bytes=1 << 20)],
    ids=["mixed", "split", "mixed_kv8", "mixed_n3", "host_tier"])
def test_tiny_prefix_engines_on_card_match_cpu(cuda, mode):
    """The prefix engines on the card against the same engines on the CPU,
    same weights, fp32: a 24-token system prompt shared by three turns
    admitted together, then a whole-prompt hit (copy-on-write), or ``n =
    3`` sampled generations of it; with a host tier, a 10-page pool
    serves two system prompts' turns in turn and spills and restores.
    Tokens, hit tokens and page counts equal (int8: tokens at least
    0.9)."""
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=256, intermediate_size=256)
    mode = dict(mode, enable_prefix_cache=True)
    n = mode.pop("n", 1)
    tier = bool(mode.get("host_tier_bytes"))
    rng = np.random.RandomState(0)
    system, other = rng.randint(1, 256, (2, 24))
    firsts = [system, other, system, other] if tier else [system] * 4
    prompts = [np.concatenate([f, rng.randint(1, 256, (k,))])
               for f, k in zip(firsts, (5, 17, 9, 30))] + [system]
    knobs = dict(temperature=0.8, top_k=50, top_p=0.95, seed=1) \
        if mode.get("sampling") else {}
    outs, state = [], []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
        if dev != "cpu":
            model.load_state_dict(cpu_state)
        cpu_state = model.state_dict()
        kw = dict(max_batch_size=3, num_blocks=64, block_size=8)
        kw.update(dict(num_blocks=10, max_seq_len=64) if tier else {})
        eng = ContinuousBatchingEngine(model, device=dev, **kw, **mode)
        r = [eng.add_request(prompts[0], 6, **knobs)]
        eng.run_to_completion()
        for p in prompts[1:]:
            got = eng.add_request(p, 6, n=n if p is system else 1, **knobs)
            r += got if isinstance(got, list) else [got]
            if tier:
                eng.run_to_completion()
        eng.run_to_completion()
        pc = eng.prefix_cache
        c0 = eng.caches[0]
        assert len(c0._free) + len(pc) == c0.num_blocks
        outs.append([eng.result(x) for x in r])
        state.append(([eng.finished[x].prefix_hit_tokens for x in r],
                      pc.hits, pc.spills, pc.restores, sorted(c0._free)))
    assert state[1] == state[0]
    if tier:
        assert state[0][0] == [0, 0, 24, 24, 16]
        assert state[0][2] > 0 and state[0][3] > 0
    else:
        assert state[0][0][:4] == [0, 24, 24, 24]
        assert state[0][0][4:] == [23] * n
    if "kv_dtype" not in mode:
        assert outs[1] == outs[0]
    else:
        same = sum(a == b for g, w in zip(*outs) for a, b in zip(g, w))
        assert same / sum(len(w) for w in outs[0]) >= 0.9


# the shapes the fast paged kernels do not take, which the generic kernel
# of each source computes: (H, Hkv, D, bs)
GENERIC_PAGED = {"d100": (8, 2, 100, 16), "d256_gqa": (8, 8, 256, 16),
                 "d256_mqa": (8, 1, 256, 16), "d44": (4, 2, 44, 4),
                 "d136": (4, 2, 136, 4), "groups64": (64, 1, 64, 16),
                 "bs128": (8, 2, 64, 128), "bs256": (8, 2, 128, 256)}


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(GENERIC_PAGED))
@pytest.mark.parametrize("kind", ["ragged", "decode"])
def test_generic_paged_kernels_match_plain(cuda, kind, shape, dtype,
                                           quantized):
    """#5 and #7 at head dims 100, 256, 44 and 136, 64 query heads over one
    kv head, and block sizes 128 and 256: each wrapper routes the shape to
    its source's generic kernel, which matches the plain version within
    the fast kernels' tolerances (int8 pools per element)."""
    H, Hkv, D, bs = GENERIC_PAGED[shape]
    if kind == "ragged":
        lens = [(1, 7), (40, 60), (3, 3), (1, 1), (9, 41), (2, 300)]
        assert pa.ragged_generic(D, H // Hkv, quantized, bs) == (
            shape not in ("bs128", "bs256") or quantized)
    else:
        lens = [7, 33, 1, 16, 70, 300]
        assert pa.decode_generic(D, bs) == (shape not in ("groups64",
                                                          "bs128"))
    _hold_paged(cuda, kind, quantized, dtype, H, Hkv, D, bs, lens)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """Head dims 44 and 136 and #7 at block size 136, which raised before
    the generic kernels, now compute and match the plain versions; what
    no kernel takes still raises: a head dim of 0, q and pools of other
    dtypes or head dims, int64 tables, non-contiguous operands."""
    for D in (44, 136):     # not a multiple of 8; past 128
        _hold_paged(cuda, "ragged", False, torch.float32, 4, 2, D, 4,
                    [(2, 9)])
        _hold_paged(cuda, "decode", False, torch.float32, 4, 2, D, 4, [9])
    _hold_paged(cuda, "decode", False, torch.float32, 4, 2, 32, 136, [300])
    q, kc, vc, bt, qo, ql, kl = _pack([(2, 9)], 0, 4, 4, 2, 32, 4,
                                      torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim 0"):
        pa.ragged_paged_attention(q[..., :0], kc[..., :0], vc[..., :0], bt,
                                  qo, ql, kl, span_q=2)
    with pytest.raises(ValueError, match="head_dim 0"):
        pa.paged_attention(q[:1, :, :0], kc[..., :0], vc[..., :0], bt[:1],
                           kl[:1])
    with pytest.raises(ValueError, match="pools"):
        pa.paged_attention(q[:1], kc[..., :16], vc[..., :16], bt[:1],
                           kl[:1])
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_paged_attention(q.to(torch.bfloat16), kc, vc, bt, qo, ql,
                                  kl, span_q=2)
    with pytest.raises(ValueError, match="int32"):
        pa.ragged_paged_attention(q, kc, vc, bt.long(), qo, ql, kl,
                                  span_q=2)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q[:1].transpose(1, 2).contiguous().transpose(
            1, 2), kc, vc, bt[:1], kl[:1])
    x = torch.zeros(3, 2, 8, device=cuda)
    cs = torch.zeros(3, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.rope_qkv_epilogue(x.transpose(0, 1).contiguous().transpose(0, 1),
                             x, x, cs, cs)


def test_tiny_engine_on_card_matches_eager(cuda):
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=256, intermediate_size=256)
    model = LlamaForCausalLM(cfg, device=cuda,
                             generator=torch.Generator(cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, (n,)) for n in (3, 17, 40, 9)]
    want = [model.generate(torch.from_numpy(p)[None].to(cuda), 6)[
        0, len(p):].tolist() for p in prompts]
    eng = ContinuousBatchingEngine(model, max_batch_size=3, num_blocks=64,
                                   block_size=8, prefill_chunk_size=16,
                                   mixed_step=True)
    r = [eng.add_request(p, 6) for p in prompts[:2]]
    eng.step()
    r += [eng.add_request(p, 6) for p in prompts[2:]]
    eng.run_to_completion()
    assert [eng.result(x) for x in r] == want
    assert len(eng.caches[0]._free) == 64


FAMILY_MODES = {"mixed": dict(mixed_step=True),
                "split": dict(prefill_buckets="auto"),
                "kv8_split": dict(prefill_buckets="auto", kv_dtype="int8"),
                "w8_mixed": dict(mixed_step=True, weight_quant="int8")}


def _family_model(family, dev):
    from paddle_tpu_torch.models import (MixtralForCausalLM,
                                         Qwen2ForCausalLM,
                                         mixtral_tiny_config,
                                         qwen2_tiny_config)
    widths = dict(num_hidden_layers=2, hidden_size=128, vocab_size=256,
                  num_attention_heads=4, num_key_value_heads=2)
    gen = torch.Generator(dev).manual_seed(0)
    if family == "mixtral":
        return MixtralForCausalLM(mixtral_tiny_config(**widths), device=dev,
                                  generator=gen)
    return Qwen2ForCausalLM(qwen2_tiny_config(intermediate_size=256,
                                              **widths),
                            device=dev, generator=gen)


@pytest.mark.parametrize("mode", sorted(FAMILY_MODES))
@pytest.mark.parametrize("family", ["mixtral", "qwen2"])
def test_tiny_family_engines_on_card_match_cpu(cuda, family, mode):
    """A tiny Mixtral (4 experts, top-2; the MoE FFN through
    ``moe_ffn``) or Qwen2 (q/k/v biases) at GQA 4/2, fp32, served on the
    card through the kernels and on the CPU through their plain versions
    with the same weights: tokens equal (int8 pools: at least 0.9), the
    card run's attention, epilogue and dequant launches counted, the
    pool whole."""
    kw = dict(FAMILY_MODES[mode], max_batch_size=3, num_blocks=64,
              block_size=8, prefill_chunk_size=16)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, (n,)) for n in (3, 17, 40, 9)]
    outs = []
    for dev in ("cpu", cuda):
        model = _family_model(family, dev)
        if dev != "cpu":
            model.load_state_dict(cpu_state)
        cpu_state = model.state_dict()
        before = (pk.rope_qkv_epilogue.launches
                  + pk.rope_qkv_epilogue.amax_launches,
                  pa.ragged_paged_attention.launches
                  + pa.paged_attention.launches
                  + pa.ragged_paged_attention.int8_launches
                  + pa.paged_attention.int8_launches,
                  dq.dequant_int8.launches)
        eng = ContinuousBatchingEngine(model, device=dev, **kw)
        r = [eng.add_request(p, 6) for p in prompts[:2]]
        eng.step()
        r += [eng.add_request(p, 6) for p in prompts[2:]]
        eng.run_to_completion()
        outs.append([eng.result(x) for x in r])
        after = (pk.rope_qkv_epilogue.launches
                 + pk.rope_qkv_epilogue.amax_launches,
                 pa.ragged_paged_attention.launches
                 + pa.paged_attention.launches
                 + pa.ragged_paged_attention.int8_launches
                 + pa.paged_attention.int8_launches,
                 dq.dequant_int8.launches)
        grew = [a > b for a, b in zip(after, before)]
        want = [dev != "cpu"] * 2 + [dev != "cpu" and "w8" in mode]
        assert grew == want
        assert len(eng.caches[0]._free) == 64
    if "kv_dtype" in kw:
        same = sum(a == b for g, w in zip(*outs) for a, b in zip(g, w))
        assert same / sum(len(w) for w in outs[0]) >= 0.9
    else:
        assert outs[1] == outs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_matches_cpu(cuda, dtype):
    """``ops.moe_gate.moe_ffn`` on the card (its per-expert products on
    cuBLAS, the stable sort and bincount on the device) against the same
    call on the CPU: the routing exact, the outputs within rounding, also
    over the int8 path's transposed bank views."""
    from paddle_tpu_torch.ops.moe_gate import moe_ffn, topk_gate
    g = torch.Generator().manual_seed(0)
    N, D, M, E = 37, 64, 96, 8
    x = torch.randn(N, D, generator=g).to(dtype)
    gate_w = torch.randn(E, D, generator=g).to(dtype)
    banks = [(torch.randn(*s, generator=g) * 0.1).to(dtype)
             for s in ((E, D, M), (E, D, M), (E, M, D))]
    want = moe_ffn(x, gate_w, *banks, top_k=2)
    got = moe_ffn(x.to(cuda), gate_w.to(cuda),
                  *[b.to(cuda) for b in banks], top_k=2)
    logits = x.float() @ gate_w.float().t()
    assert torch.equal(topk_gate(logits.to(cuda), 2)[1].cpu(),
                       topk_gate(logits, 2)[1])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    tv = [b.to(cuda).transpose(1, 2).contiguous().transpose(1, 2)
          for b in banks]
    torch.testing.assert_close(
        moe_ffn(x.to(cuda), gate_w.to(cuda), *tv, top_k=2).cpu().float(),
        want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 2), (8, 2), (28, 4),
                                   (16, 2)],
                         ids=["mha", "g2", "g3", "g4", "g7", "g8"])
@pytest.mark.parametrize("D,bs", [(32, 4), (64, 5), (128, 16), (64, 32),
                                  (64, 64), (64, 128), (80, 16),
                                  (112, 16)])
def test_paged_decode_kernel_matches_plain(cuda, quantized, dtype, heads, D,
                                           bs):
    """Slots of many lengths (one past a page edge, one of a single key,
    and at block sizes from 16 one at kv 4096), NaN pages (or NaN scales)
    behind every unused table entry, and two masked slots (seq_len 1 over
    an all-sink row); any group count, block sizes up to 128 and head
    dims 80 and 112 (pools read at their width)."""
    H, Hkv = heads
    lens = [7, 33, 1, 16, 70, 5] + ([4096] if bs >= 16 else [])
    gen = torch.Generator(cuda).manual_seed(1)
    q, kc, vc, bt, _, _, sl = _ragged_case(
        [(1, s) for s in lens], len(lens) + 2, H, Hkv, D, bs, dtype, gen,
        poison=True, n_pad_spans=2)
    scales = {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)
    counter = "int8_launches" if quantized else "launches"
    before = getattr(pa.paged_attention, counter)
    got = pa.paged_attention(q, kc, vc, bt, sl, **scales)
    want = pa._paged_attention_plain(q, kc, vc, bt, sl, 1.0 / np.sqrt(D),
                                     flip_bound=quantized, **scales)
    torch.cuda.synchronize()
    assert getattr(pa.paged_attention, counter) == before + 1
    assert torch.isfinite(got).all()
    if quantized:
        want, flips = want
        tol = int8_tolerance(want, flips, vmax)
    else:
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()
    if quantized:   # the limit rejects a kernel that skips each last page
        cut = pa.paged_attention(q, kc, vc, bt, cut_lengths(
            sl, sl.clamp(max=1), bs, True), **scales)
        assert not (cut.float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (8, 1)],
                         ids=["mha", "gqa3", "mqa8"])
@pytest.mark.parametrize("D,bs", [(32, 4), (64, 5), (128, 16), (64, 64)])
def test_ragged_int8_kernel_matches_plain(cuda, dtype, heads, D, bs):
    """The int8 variant of the ragged kernel over the same packs as the
    fp one (tiles of whole pages, 64 / bs of them)."""
    H, Hkv = heads
    spans = [(1, 7), (70, 90), (3, 3), (1, 1), (9, 41), (2, 11)]
    T = sum(q for q, _ in spans) + 5
    q, kc, vc, bt, qo, ql, kl = _pack(spans, 2, T, H, Hkv, D, bs, dtype,
                                      cuda)
    kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
    before = pa.ragged_paged_attention.int8_launches
    got = pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, kl, span_q=70,
                                    key_scale=ks, value_scale=vs,
                                    work=_work((q, kc, vc, bt, qo, ql, kl),
                                               H, Hkv, bs))
    want, flips = pa._ragged_attention_int8_plain(
        q, kc, vc, ks, vs, bt, qo, ql, kl, 1.0 / np.sqrt(D), flip_bound=True)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.int8_launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().le(
        int8_tolerance(want, flips, vmax)).all()
    assert (got[sum(q for q, _ in spans):] == 0).all()


# spans (q_len, kv_len) for the tensor-core ragged kernel: decode spans
# (decode items), a chunk of several 128-vector tiles, a prefix-offset
# span, a one-key span and a short chunk
TC_SPANS = [(1, 300), (130, 170), (1, 1), (3, 3), (1, 64), (40, 200)]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2), (12, 1)],
                         ids=["mha", "gqa4", "gqa12"])
@pytest.mark.parametrize("D,bs", [(32, 8), (64, 16), (96, 16), (128, 32),
                                  (128, 64)])
def test_ragged_tensor_core_kernel_matches_plain(cuda, quantized, heads, D,
                                                 bs):
    """#5's tensor-core kernel (bf16 q) over its host work list: decode
    items (groups <= 8, pages <= 32 keys: the block's warps split the
    span) and chunk items on mma.sync (bf16, or s8 with one MMA per page
    for int8 pools), with NaN pages (or NaN scales) behind every unused
    table entry and two padding spans; rows outside spans stay 0; one
    launch; the int8 limit rejects the kernel run without each span's
    last page."""
    H, Hkv = heads
    T = sum(q for q, _ in TC_SPANS) + 5
    q, kc, vc, bt, qo, ql, kl = _pack(TC_SPANS, 2, T, H, Hkv, D, bs,
                                      torch.bfloat16, cuda)
    scales, counter = {}, "launches"
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales, counter = dict(key_scale=ks, value_scale=vs), "int8_launches"
    work_np = pa.ragged_work(ql.cpu(), kl.cpu(), H, Hkv, bs)
    decode_spans = len({s for s in (work_np >> 16)[
        (work_np & pa.RAGGED_DECODE) != 0]})
    assert decode_spans == (3 if H // Hkv <= 8 and bs <= 32 else 0)
    work = torch.from_numpy(work_np).to(cuda)
    before = getattr(pa.ragged_paged_attention, counter)
    got = pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, kl, span_q=130,
                                    work=work, **scales)
    scale = 1.0 / np.sqrt(D)
    torch.cuda.synchronize()
    assert getattr(pa.ragged_paged_attention, counter) == before + 1
    assert torch.isfinite(got).all()
    if quantized:
        want, flips = pa._ragged_attention_int8_plain(
            q, kc, vc, ks, vs, bt, qo, ql, kl, scale, flip_bound=True)
        tol = int8_tolerance(want, flips, vmax)
    else:
        want = pa._ragged_attention_plain(q, kc, vc, bt, qo, ql, kl, scale)
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()
    assert (got[sum(q for q, _ in TC_SPANS):] == 0).all()
    if quantized:
        cut = pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, cut_lengths(
            kl, ql, bs, True), span_q=130, work=work, **scales)
        assert not (cut.float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_ragged_tensor_core_kernel_requires_its_work_list(cuda, quantized):
    """The tensor-core kernel takes the step's host-built work list and
    never builds one itself (that would wait for the device): without it
    the wrapper raises, naming ``ragged_work``, and launches nothing."""
    q, kc, vc, bt, qo, ql, kl = _pack(TC_SPANS, 1, 400, 8, 2, 64, 16,
                                      torch.bfloat16, cuda)
    scales, counter = {}, "launches"
    if quantized:
        kc, vc, ks, vs, _ = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales, counter = dict(key_scale=ks, value_scale=vs), "int8_launches"
    before = getattr(pa.ragged_paged_attention, counter)
    with pytest.raises(ValueError, match="ragged_work"):
        pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, kl, **scales)
    assert getattr(pa.ragged_paged_attention, counter) == before


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads,bs", [((8, 1), 16), ((32, 8), 8),
                                      ((4, 2), 32)])
def test_ragged_split_decode_items_match_plain(cuda, quantized, heads, bs):
    """Long decode spans on a few kv heads: the work list splits each over
    several blocks (a run of pages each), and the last block of a span to
    arrive merges the splits in split order.  Against the plain version
    (NaN pages behind unused entries), bitwise equal over repeated calls
    (the order of arrival does not matter), and the arrival counters are
    left zero for the next call."""
    H, Hkv = heads
    spans = [(1, 3000), (1, 129), (1, 700), (5, 40)]
    T = sum(q for q, _ in spans) + 3
    q, kc, vc, bt, qo, ql, kl = _pack(spans, 1, T, H, Hkv, 64, bs,
                                      torch.bfloat16, cuda)
    scales = {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)
    work_np = pa.ragged_work(ql.cpu(), kl.cpu(), H, Hkv, bs)
    dec = work_np[(work_np & pa.RAGGED_DECODE) != 0]
    n_split = ((dec & 0x7FFF) >> pa.RAGGED_SPLIT_SHIFT) + 1
    assert n_split.max() > 1                 # some span is split
    work = torch.from_numpy(work_np).to(cuda)
    outs = [pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, kl, work=work,
                                      **scales) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not pa._split_scratch(cuda, stream, 1, 1)[1].any()
    scale = 1.0 / np.sqrt(64)
    if quantized:
        want, flips = pa._ragged_attention_int8_plain(
            q, kc, vc, ks, vs, bt, qo, ql, kl, scale, flip_bound=True)
        tol = int8_tolerance(want, flips, vmax)
    else:
        want = pa._ragged_attention_plain(q, kc, vc, bt, qo, ql, kl, scale)
        tol = ragged_tolerance(want)
    assert torch.isfinite(outs[0]).all()
    assert (outs[0].float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain_at_head_dim_96(cuda, quantized,
                                                          dtype):
    """#7 at head dim 96 (3 columns a lane: loads of 6 or 12 bytes),
    GQA 32/8 and 8/2, NaN pages behind unused entries."""
    for H, Hkv, bs in ((32, 8, 16), (8, 2, 5)):
        lens = [7, 33, 1, 16, 70, 5]
        gen = torch.Generator(cuda).manual_seed(2)
        q, kc, vc, bt, _, _, sl = _ragged_case(
            [(1, s) for s in lens], len(lens), H, Hkv, 96, bs, dtype, gen,
            poison=True)
        scales = {}
        if quantized:
            kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
            scales = dict(key_scale=ks, value_scale=vs)
        got = pa.paged_attention(q, kc, vc, bt, sl, **scales)
        want = pa._paged_attention_plain(q, kc, vc, bt, sl,
                                         1.0 / np.sqrt(96),
                                         flip_bound=quantized, **scales)
        torch.cuda.synchronize()
        if quantized:
            want, flips = want
            tol = int8_tolerance(want, flips, vmax)
        else:
            tol = ragged_tolerance(want)
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [(32, 8), (8, 1), (28, 4)],
                         ids=["gqa32x8", "mqa8", "g7"])
def test_paged_decode_split_path_is_bitwise_deterministic(cuda, quantized,
                                                          heads):
    """Shapes too small to fill the card split each slot's pages over
    several blocks (``decode_splits``); the last block to arrive merges
    the splits in split order, so two calls give the same bits, and the
    result holds against the plain version."""
    H, Hkv = heads
    lens = [1024, 700, 1, 513]
    assert pa.decode_splits(len(lens), Hkv, H // Hkv, 64)[0] > 1
    gen = torch.Generator(cuda).manual_seed(3)
    q, kc, vc, bt, _, _, sl = _ragged_case(
        [(1, s) for s in lens], len(lens), H, Hkv, 128, 16, torch.bfloat16,
        gen, poison=True)
    scales = {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)
    outs = [pa.paged_attention(q, kc, vc, bt, sl, **scales)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = pa._paged_attention_plain(q, kc, vc, bt, sl, 1.0 / np.sqrt(128),
                                     flip_bound=quantized, **scales)
    if quantized:
        want, flips = want
        tol = int8_tolerance(want, flips, vmax)
    else:
        tol = ragged_tolerance(want)
    assert (outs[0].float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 112, 88])
def test_ragged_kernels_match_plain_at_padded_head_dims(cuda, quantized,
                                                        dtype, D):
    """#5 at head dims without a kernel of their own: q and the output
    padded to the next width, the pools read at their own (the tensor-core
    kernel for bf16 q; int8 pools at D 88 take the CUDA-core kernel)."""
    spans = [(1, 7), (70, 90), (3, 3), (1, 1), (9, 41), (2, 11)]
    T = sum(ql for ql, _ in spans) + 5
    q, kc, vc, bt, qo, ql, kl = _pack(spans, 2, T, 6, 2, D, 16, dtype,
                                      cuda)
    scales = {}
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales = dict(key_scale=ks, value_scale=vs)
    args = (q, kc, vc, bt, qo, ql, kl)
    got = pa.ragged_paged_attention(*args, span_q=70,
                                    work=_work(args, 6, 2, 16), **scales)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    if quantized:
        want, flips = pa._ragged_attention_int8_plain(
            q, kc, vc, ks, vs, bt, qo, ql, kl, 1.0 / np.sqrt(D),
            flip_bound=True)
        tol = int8_tolerance(want, flips, vmax)
    else:
        want = pa._ragged_attention_plain(*args, 1.0 / np.sqrt(D))
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()


def _tiny_engine_tokens(model, dev, **kw):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, (n,)) for n in (3, 17, 40, 9)]
    eng = ContinuousBatchingEngine(model, max_batch_size=3, num_blocks=64,
                                   block_size=8, device=dev, **kw)
    r = [eng.add_request(p, 6) for p in prompts[:2]]
    eng.step()
    r += [eng.add_request(p, 6) for p in prompts[2:]]
    eng.run_to_completion()
    assert len(eng.caches[0]._free) == 64
    return [eng.result(x) for x in r]


@pytest.mark.parametrize("mode", [
    dict(), dict(prefill_buckets="auto", prefill_chunk_size=16),
    dict(prefill_buckets="auto", prefill_chunk_size=16, kv_dtype="int8"),
    dict(mixed_step=True, prefill_chunk_size=16, kv_dtype="int8")],
    ids=["split_dense", "split_buckets", "split_kv8", "mixed_kv8"])
def test_tiny_engines_on_card_match_cpu(cuda, mode):
    """The split and int8 engines on the card (decode, ragged and epilogue
    kernels) against the same engines on the CPU (plain versions), same
    weights: fp32 tokens equal; int8 tokens at least 0.9 (a probability
    code may round the other way on the card)."""
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=256, intermediate_size=256)
    models = {}
    for dev in ("cpu", cuda):
        models[str(dev)] = LlamaForCausalLM(
            cfg, device=dev, generator=torch.Generator("cpu").manual_seed(0)
            if dev == "cpu" else None)
    models[str(cuda)].load_state_dict(models["cpu"].state_dict())
    before = pa.paged_attention.launches + pa.paged_attention.int8_launches
    got = _tiny_engine_tokens(models[str(cuda)], cuda, **mode)
    want = _tiny_engine_tokens(models["cpu"], "cpu", **mode)
    decodes = (pa.paged_attention.launches
               + pa.paged_attention.int8_launches - before)
    assert (decodes > 0) == (not mode.get("mixed_step"))
    if "kv_dtype" not in mode:
        assert got == want
    else:
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        assert same / sum(len(w) for w in want) >= 0.9


@pytest.mark.parametrize("mode", [
    dict(mixed_step=True, prefill_chunk_size=16, sampling=True),
    dict(prefill_buckets="auto", prefill_chunk_size=16, sampling=True),
    dict(mixed_step=True, prefill_chunk_size=16, draft=True),
    dict(mixed_step=True, prefill_chunk_size=16, sampling=True, draft=True)],
    ids=["mixed_sampled", "split_sampled", "spec", "spec_sampled"])
def test_tiny_sampling_engines_on_card_match_cpu(cuda, mode):
    """The sampling and speculative engines on the card (the kernels, the
    sampler's integer ops and draws on the device) against the same
    engines on the CPU (plain versions), same weights, fp32: the same
    tokens, so the card draws the reference's random streams too; every
    fourth request greedy."""
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=256, intermediate_size=256)
    mode = dict(mode)
    draft = mode.pop("draft", False)
    knobs = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1 + i)
             if mode.get("sampling") and i % 4 != 3 else {}
             for i in range(4)]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, (n,)) for n in (3, 17, 40, 9)]
    outs = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
        if dev != "cpu":
            model.load_state_dict(cpu_state)
        cpu_state = model.state_dict()
        kw = dict(mode, draft_model=llama_truncated_draft(model, 1)
                  if draft else None)
        eng = ContinuousBatchingEngine(model, max_batch_size=3,
                                       num_blocks=64, block_size=8,
                                       device=dev, **kw)
        r = [eng.add_request(p, 6, **k)
             for p, k in zip(prompts[:2], knobs[:2])]
        eng.step()
        r += [eng.add_request(p, 6, **k)
              for p, k in zip(prompts[2:], knobs[2:])]
        eng.run_to_completion()
        assert len(eng.caches[0]._free) == 64
        outs.append([eng.result(x) for x in r])
    assert outs[1] == outs[0]


# (causal, rope, Sq, Sk): square, longer key axis, rows that see nothing
# (Sq > Sk), and lengths off the kernels' 64-row tiles
FLASH_SHAPES = {"causal_rope": (True, True, 130, 130),
                "full_rope": (False, True, 96, 96),
                "causal": (True, False, 200, 200),
                "rect_causal": (True, False, 70, 190),
                "dead_rows": (True, False, 190, 70),
                "rect_full": (False, False, 50, 130)}


def _check_flash_kernels(cuda, dtype, D, shape):
    """The forward and both backward forms against their plain versions
    (chip_smoke's tolerances); each wrapper counts one launch; rows that
    see nothing give lse -inf and out 0."""
    causal, rope, Sq, Sk = FLASH_SHAPES[shape]
    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v, g, tables = _flash_case(2, Sq, Sk, 3, D, dtype, rope, gen)
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_fused,
                                   fa.flash_bwd_two_kernel)]
    out, lse = fa.flash_fwd(q, k, v, causal, tables)
    want_out, want_lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert dead.any() == (shape == "dead_rows")
    assert (out.transpose(1, 2)[dead] == 0).all()
    kernels = ("flash_fwd", "flash_bwd_fused", "flash_bwd_two_kernel")
    noise = dict.fromkeys(kernels, (None,) * 3)
    if dtype == "bfloat16":
        noise = {kern: flash_noise(kern, q, k, v, out, lse, g, causal,
                                   tables)
                 for kern in kernels}
    assert flash_excess(out, want_out, flash_tolerance(
        want_out, dtype, noise["flash_fwd"][0])) <= 1.0
    assert (lse[~dead] - want_lse[~dead]).abs().max().item() <= 1e-4
    for kern in kernels[1:]:
        got = getattr(fa, kern)(q, k, v, out, lse, g, causal, tables)
        torch.cuda.synchronize()
        want = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                                   form=FLASH_FORM[kern])
        for a, b, f in zip(got, want, noise[kern]):
            assert torch.isfinite(a).all()
            assert flash_excess(a, b, flash_tolerance(b, dtype, f)) <= 1.0
    assert [f.launches for f in (fa.flash_fwd, fa.flash_bwd_fused,
                                 fa.flash_bwd_two_kernel)] \
        == [n + 1 for n in before]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain(cuda, dtype, D, shape):
    """At head dims 64 and 128 (:func:`_check_flash_kernels`)."""
    _check_flash_kernels(cuda, dtype, D, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain_at_head_dims_32_and_96(cuda, dtype, D,
                                                          shape):
    """Head dims 32 (``llama_tiny_config``'s) and 96 compute on the card,
    as the reference computes every D <= 128: fp32 on the CUDA-core
    kernels of ``csrc/flash_attention.cu``, bf16 padded per half to 64 or
    128 on the tensor cores (:func:`_check_flash_kernels`)."""
    _check_flash_kernels(cuda, dtype, D, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [80, 112])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain_at_padded_head_dims(cuda, dtype, D,
                                                       shape):
    """Head dims 80 (Phi-2's) and 112 compute on the card: the wrappers
    pad each half to the next width a kernel takes (bf16: 128, the tensor
    cores; fp32: 96 or 128) and pass the true scale
    (:func:`_check_flash_kernels`, against the plain versions at D)."""
    _check_flash_kernels(cuda, dtype, D, shape)


# (rope, causal) pairs for the tensor-core kernels' sweep
TC_MODES = {"rope_causal": (True, True), "rope_full": (True, False),
            "causal": (False, True), "full": (False, False)}


@pytest.mark.parametrize("S", [1, 63, 65, 200, 2048])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode", sorted(TC_MODES))
def test_bf16_tensor_core_kernels_match_plain(cuda, mode, D, S):
    """The bf16 forward and two-kernel backward (the tensor-core kernels
    of ``csrc/flash_attention_sm90.cu``) against their plain versions
    under ``chip_smoke.flash_tolerance``, over sequence lengths off and on
    the 64-row tiles; one launch each."""
    rope, causal = TC_MODES[mode]
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v, g, tables = _flash_case(1, S, S, 2, D, "bfloat16", rope, gen)
    before = (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches)
    out, lse = fa.flash_fwd(q, k, v, causal, tables)
    dq, dk, dv = fa.flash_bwd_two_kernel(q, k, v, out, lse, g, causal,
                                         tables)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    want_out, want_lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    noise = flash_noise("flash_fwd", q, k, v, None, None, None, causal,
                        tables)[0]
    assert flash_excess(out, want_out, flash_tolerance(
        want_out, "bfloat16", noise)) <= 1.0
    assert (lse - want_lse).abs().max().item() <= 1e-4
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                               form="two_kernel")
    noise = flash_noise("flash_bwd_two_kernel", q, k, v, out, lse, g,
                        causal, tables)
    for a, b, f in zip((dq, dk, dv), want, noise):
        assert flash_excess(a, b, flash_tolerance(b, "bfloat16", f)) <= 1.0


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_tensor_core_kernels_dead_rows(cuda, D):
    """Sq > Sk, causal: the first Sq - Sk rows see nothing; the forward
    gives them lse -inf and out 0, the backward dq 0, and the rest
    matches the plain versions."""
    gen = torch.Generator(cuda).manual_seed(D)
    q, k, v, g, _ = _flash_case(2, 333, 120, 3, D, "bfloat16", False, gen)
    out, lse = fa.flash_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_bwd_two_kernel(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    dead = torch.isneginf(fa._flash_fwd_plain(q, k, v, True)[1])
    assert dead.sum().item() == 2 * 3 * (333 - 120)
    assert torch.equal(torch.isneginf(lse), dead)
    assert (out.transpose(1, 2)[dead] == 0).all()
    assert (dq.transpose(1, 2)[dead] == 0).all()
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, True,
                               form="two_kernel")
    noise = flash_noise("flash_bwd_two_kernel", q, k, v, out, lse, g, True,
                        None)
    for a, b, f in zip((dq, dk, dv), want, noise):
        assert flash_excess(a, b, flash_tolerance(b, "bfloat16", f)) <= 1.0


@pytest.mark.parametrize("S", [1, 65, 200, 1024])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode", sorted(TC_MODES))
def test_bf16_fused_tensor_core_backward_matches_plain(cuda, mode, D, S):
    """#2 on the tensor cores (``bwd_kv_tc_kernel<EMIT_DQ>`` of
    ``csrc/flash_attention_sm90.cu``) against the plain version of its
    form, rope on and off, causal or not, over lengths on and off the
    64-row tiles (ragged tails); one launch each."""
    rope, causal = TC_MODES[mode]
    gen = torch.Generator(cuda).manual_seed(S + D)
    q, k, v, g, tables = _flash_case(2, S, S, 3, D, "bfloat16", rope, gen)
    out, lse = fa.flash_fwd(q, k, v, causal, tables)
    before = fa.flash_bwd_fused.launches
    got = fa.flash_bwd_fused(q, k, v, out, lse, g, causal, tables)
    torch.cuda.synchronize()
    assert fa.flash_bwd_fused.launches == before + 1
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                               form="fused")
    noise = flash_noise("flash_bwd_fused", q, k, v, out, lse, g, causal,
                        tables)
    for a, b, f in zip(got, want, noise):
        assert torch.isfinite(a).all()
        assert flash_excess(a, b, flash_tolerance(b, "bfloat16", f)) <= 1.0


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_fused_tensor_core_backward_dead_rows(cuda, D):
    """Sq > Sk, causal: the rows that see nothing get dq 0 (no k tile
    adds a share for them), and the rest matches the plain version."""
    gen = torch.Generator(cuda).manual_seed(D + 1)
    q, k, v, g, _ = _flash_case(2, 333, 120, 3, D, "bfloat16", False, gen)
    out, lse = fa.flash_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_bwd_fused(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    dead = torch.isneginf(lse)
    assert (dq.transpose(1, 2)[dead] == 0).all()
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, True, form="fused")
    noise = flash_noise("flash_bwd_fused", q, k, v, out, lse, g, True, None)
    for a, b, f in zip((dq, dk, dv), want, noise):
        assert flash_excess(a, b, flash_tolerance(b, "bfloat16", f)) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["causal_rope", "dead_rows", "long"])
def test_flash_bwd_fused_is_bitwise_deterministic(cuda, dtype, shape):
    """Two calls of the one-pass backward give bitwise-equal dq, dk and
    dv: the dq shares are summed in k-tile order (no atomics), in both
    dtypes (fp32: the CUDA-core kernel; bf16: the tensor-core one)."""
    B, Sq, Sk, H, rope = {"causal_rope": (2, 300, 300, 4, True),
                          "dead_rows": (1, 448, 192, 4, False),
                          "long": (1, 2048, 2048, 8, True)}[shape]
    gen = torch.Generator(cuda).manual_seed(3)
    q, k, v, g, tables = _flash_case(B, Sq, Sk, H, 128, dtype, rope, gen)
    out, lse = fa.flash_fwd(q, k, v, True, tables)
    first = fa.flash_bwd_fused(q, k, v, out, lse, g, True, tables)
    for _ in range(3):
        again = fa.flash_bwd_fused(q, k, v, out, lse, g, True, tables)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rope", [False, True])
def test_repaired_fused_backward_matches_its_form(cuda, rope):
    """#2 (the one-pass backward; bf16 at D 128 runs the tensor-core
    kernel) against the plain version of its own form: scores
    ``round(rope(q)) . round(rope(k) c)`` for dk, dv and dq, and dq as
    ``ds . ks / log2(e)``."""
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v, g, tables = _flash_case(1, 256, 256, 2, 128, "bfloat16", rope,
                                     gen)
    out, lse = fa.flash_fwd(q, k, v, False, tables)
    got = fa.flash_bwd_fused(q, k, v, out, lse, g, False, tables)
    torch.cuda.synchronize()
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, False, tables,
                               form="fused")
    noise = flash_noise("flash_bwd_fused", q, k, v, out, lse, g, False,
                        tables)
    for a, b, f in zip(got, want, noise):
        assert flash_excess(a, b, flash_tolerance(b, "bfloat16", f)) <= 1.0


def test_bf16_calls_cannot_reach_the_cuda_core_variants(cuda):
    """The CUDA-core library holds no bf16 forward and no bf16 backward
    of either form at any head dim: its entries refuse them
    (cudaErrorInvalidValue = 1), so a bf16 call reaches only the
    tensor-core kernels."""
    fwd, bwd = fa._entries()
    st = torch.cuda.current_stream().cuda_stream
    for D in (32, 64, 96, 128):
        x = torch.zeros(1, 64, 2, D, device=cuda, dtype=torch.bfloat16)
        lse = torch.zeros(1, 2, 64, device=cuda)
        assert fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), None, None,
                   x.data_ptr(), lse.data_ptr(), 1, 2, 64, 64, D, 1, 0,
                   0.18, 1, st) == 1
        for fused in (0, 1):
            assert bwd(*([x.data_ptr()] * 5), lse.data_ptr(), None, None,
                       *([x.data_ptr()] * 3), None, None, 1, 2, 64, 64, D,
                       1, 0, 0.18, 0.125, 1, fused, st) == 1


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """D 84, which raised before, now computes padded per half and
    matches the plain versions; an odd D computes without rope, padded at
    its end.  What no kernel takes still raises: D over 128 in the kernel
    wrappers (the public entries take ``_chunked_sdpa`` there), an odd D
    with rope, fp16, Sq != Sk with rope, non-contiguous operands."""
    _check_flash_kernels(cuda, "float32", 84, "causal_rope")
    _check_flash_kernels(cuda, "bfloat16", 35, "causal")
    x = torch.zeros(1, 64, 2, 136, device=cuda)
    with pytest.raises(ValueError, match="head_dim 136"):
        fa.flash_fwd(x, x, x, True)
    x = torch.zeros(1, 64, 2, 35, device=cuda)
    with pytest.raises(ValueError, match="head_dim 35 is odd"):
        fa.flash_attention_rope(x, x, x)
    y = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(y.half(), y.half(), y.half(), True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_fwd(y, torch.zeros(1, 32, 2, 64, device=cuda),
                     torch.zeros(1, 32, 2, 64, device=cuda), True,
                     fa.rope_tables(64, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(y.transpose(1, 2).contiguous().transpose(1, 2), y, y,
                     True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [36, 100])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain_at_any_head_dim(cuda, dtype, D, shape):
    """Head dims that are not a multiple of 8 compute on the card: the
    wrappers pad each half (bf16 to 64 or 128, fp32 to the next of 32,
    64, 96 and 128) and pass the true scale (:func:`_check_flash_kernels`,
    against the plain versions at D)."""
    _check_flash_kernels(cuda, dtype, D, shape)


def test_flash_attention_rope_launches_at_any_length(cuda):
    """S=200 has no Pallas block (the reference falls back there); the
    port still launches the forward kernel and the backward form the
    reference's router picks for it (two-kernel: no key block).  Head dim
    32 (``llama_tiny_config``'s) computes on the card too, as the
    reference computes it, and matches the plain versions."""
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 200, 4, 64, generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    assert not fa.fused_bwd_taken(200)
    before = (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches)
    fa.flash_attention_rope(q, k, v).sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    x = [torch.randn(1, 200, 4, 32, generator=gen, device=cuda)
         .requires_grad_() for _ in range(3)]
    before = (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches)
    out = fa.flash_attention_rope(*x)
    out.sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    cos, sin = fa.rope_tables(200, 32, device=cuda)
    xs = [t.detach() for t in x]
    want_out, want_lse = fa._flash_fwd_plain(*xs, True, (cos, sin))
    assert (out - want_out).abs().max().item() <= 2e-5
    want = fa._flash_bwd_plain(*xs, want_out, want_lse,
                               torch.ones_like(want_out), True, (cos, sin),
                               form="two_kernel")
    for t, w in zip(x, want):
        assert (t.grad - w).abs().max().item() <= 2e-5 * max(
            1.0, w.abs().max().item())


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """Three fp32 TrainStep steps of a tiny model (head dim 64) on the
    card, through the flash kernels, against the same steps on the CPU
    (plain versions): losses to 1e-4 relative."""
    cfg = llama_tiny_config(hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=256,
                            intermediate_size=256)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256,
                                                            (2, 128)))
    losses = {}
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
        if dev != "cpu":
            model.load_state_dict(cpu_state)
        cpu_state = {k: t.clone() for k, t in model.state_dict().items()}
        step = TrainStep(model, LlamaPretrainingCriterion(),
                         AdamW(1e-3, parameters=model.named_parameters()),
                         clip_norm=1.0)
        before = fa.flash_fwd.launches
        losses[str(dev)] = [step(ids.to(dev), ids.to(dev)).item()
                            for _ in range(3)]
        launched = fa.flash_fwd.launches - before
    assert launched == 3 * cfg.num_hidden_layers
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 4096), (1, 64), (129, 5120),
                                    (64, 8192), (50, 100), (33, 4099)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, rows, d):
    """#4 against its plain version within ``chip_smoke.rms_tolerance``
    (vector and scalar paths, leading dims), and the autograd Function's
    gradients on the card against the same Function on the CPU."""
    gen = torch.Generator(cuda).manual_seed(rows)
    x, w = _rms_inputs(rows, d, getattr(torch, dtype), gen)
    x = x.reshape(1, rows, d)
    before = rn.rms_norm_tpu.launches
    got = rn.rms_norm_tpu(x, w, 1e-6)
    assert rn.rms_norm_tpu.launches == before + 1
    want = rn._rms_norm_plain(x, w, 1e-6)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert ((got.float() - want.float()).abs()
            <= rms_tolerance(want, dtype)).all()
    g = torch.randn(x.shape, generator=gen, device=cuda).to(x.dtype)
    grads = {}
    for dev in ("cpu", cuda):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        rn.RMSNormKernel.apply(xd, wd, 1e-6).backward(g.to(dev))
        grads[str(dev)] = (xd.grad.cpu().float(), wd.grad.cpu().float())
    assert rn.rms_norm_tpu.launches == before + 2
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        if dtype == "float32":
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * b.abs().max().item())
        else:
            assert ((a - b).abs() <= rms_tolerance(b, dtype)
                    + 2.0 ** -7 * b.abs().max()).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_layerwise_variant_matches_plain(cuda, dtype):
    """#4's layerwise variant (``round_first``: rounds before the weight,
    as the reference's layerwise ``_rms_norm``) against its plain version
    per element at one bf16 ulp at each of its two rounding points (fp32:
    8 ulps; ``chip_smoke.rms_tolerance`` with the weight), counted as a
    launch of #4.  In bf16 it is bitwise equal to its plain version except
    where the fp32 normalised value lies within ``RMS_MIDPOINT_ULPS`` fp32
    ulps of a bf16 midpoint, and that rule rejects the kernel run at #4's
    own rounding point (``round_first`` off)."""
    gen = torch.Generator(cuda).manual_seed(9)
    x, w = _rms_inputs(333, 4096, getattr(torch, dtype), gen)
    before = rn.rms_norm_tpu.launches
    got = rn.rms_norm_tpu(x, w, 1e-6, round_first=True)
    assert rn.rms_norm_tpu.launches == before + 1
    want = rn._rms_norm_plain(x, w, 1e-6, round_first=True)
    assert ((got.float() - want.float()).abs()
            <= rms_tolerance(want, dtype, w)).all()
    if dtype == "bfloat16":
        x32 = x.float()
        edge = near_bf16_midpoint(
            x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6),
            RMS_MIDPOINT_ULPS)
        assert not ((got != want) & ~edge).any()
        round_last = rn.rms_norm_tpu(x, w, 1e-6)
        assert ((round_last != want) & ~edge).any()


def test_rms_norm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        rn.rms_norm_tpu(x, torch.ones(64, device=cuda,
                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weight"):
        rn.rms_norm_tpu(x, torch.ones(32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm_tpu(torch.zeros(64, 4, device=cuda).t(),
                        torch.ones(64, device=cuda))


def test_tiny_layerwise_step_on_card_matches_cpu(cuda):
    """Three fp32 layerwise steps of a tiny model (head dim 64) on the
    card, through the flash kernels and #4, against the same steps on
    the CPU (plain versions) from the same weights: losses to 1e-4
    relative; launches exact."""
    cfg = llama_tiny_config(hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=256,
                            intermediate_size=256)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256,
                                                            (2, 128)))
    cpu = LlamaLayerwiseTrainStep(cfg, Adafactor(1e-3, parameters=[]),
                                  device="cpu").init(0)
    card = LlamaLayerwiseTrainStep(cfg, Adafactor(1e-3, parameters=[]),
                                   device=cuda).set_state_dict(
                                       cpu.state_dict())
    before = (fa.flash_fwd.launches, rn.rms_norm_tpu.launches)
    want = [cpu(ids, ids).item() for _ in range(3)]
    got = [card(ids.to(cuda), ids.to(cuda)).item() for _ in range(3)]
    L = cfg.num_hidden_layers
    assert (fa.flash_fwd.launches, rn.rms_norm_tpu.launches) == (
        before[0] + 3 * 2 * L, before[1] + 3 * (4 * L + 1))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("segments", [[(37, 100)], [(64, 128), (16, 128),
                                                    (48, 352), (5, 16)]],
                         ids=["odd", "layer"])
def test_dequant_int8_kernel_bitwise(cuda, dtype, segments):
    """The weight dequant kernel equals its plain version bit for bit, at
    a width off the 16-element vector and over a layer-like segment list,
    one launch counted; a planted wrong scale must not."""
    from paddle_tpu_torch.ops import dequant as dq
    g = torch.Generator(cuda).manual_seed(0)
    n = sum(r * c for r, c in segments)
    rows = sum(r for r, _ in segments)
    codes = torch.randint(-127, 128, (n,), generator=g,
                          device=cuda).to(torch.int8)
    scales = torch.rand(rows, generator=g, device=cuda) * 2
    before = dq.dequant_int8.launches
    got = dq.dequant_int8(codes, scales, segments,
                          torch.empty(n, dtype=dtype, device=cuda))
    assert dq.dequant_int8.launches == before + 1
    want = dq._dequant_int8_plain(codes, scales, segments,
                                  torch.empty(n, dtype=dtype, device=cuda))
    assert torch.equal(got, want)
    bad = scales.clone()
    bad[rows // 2] *= 1.01
    wrong = dq._dequant_int8_plain(codes, bad, segments,
                                   torch.empty(n, dtype=dtype, device=cuda))
    assert not torch.equal(got, wrong)


def test_w8_engine_on_card_launches_and_matches_cpu(cuda):
    """A tiny fp32 w8 mixed engine on the card: (layers + 1) dequant
    launches a step, tokens equal the same engine on the CPU."""
    from paddle_tpu_torch.ops import dequant as dq
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=256, intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model = LlamaForCausalLM(cfg, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    prompts = [np.arange(1, 12), np.arange(40, 45)]
    outs = []
    for dev, m in (("cpu", cpu_model), (cuda, model)):
        eng = ContinuousBatchingEngine(m, max_batch_size=2, num_blocks=32,
                                       block_size=16, mixed_step=True,
                                       weight_quant="int8", device=dev)
        steps = 0
        before = dq.dequant_int8.launches
        rids = [eng.add_request(p, 6) for p in prompts]
        while eng.has_work():
            eng.step()
            steps += 1
        outs.append([eng.result(r) for r in rids])
        if dev == cuda:
            assert dq.dequant_int8.launches - before == \
                (cfg.num_hidden_layers + 1) * steps
    assert outs[0] == outs[1]


# the per-rank head counts of the sharded engines (chip_smoke's
# RANK_HEADS): the 7B at tp 2 and 4, Qwen2-7B at tp 2 (a group of 7),
# Mixtral at tp 2
RANK_HEADS = [(16, 16), (8, 8), (14, 2), (16, 4)]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", RANK_HEADS,
                         ids=["7b_tp2", "7b_tp4", "qwen2_tp2", "mixtral_tp2"])
def test_paged_kernels_match_plain_at_per_rank_heads(cuda, quantized, dtype,
                                                     heads):
    """#5 (with the mixed step's work list for bf16 q) and #7 at a rank's
    heads, D 128, block size 16: decode spans and a chunk, NaN pages
    behind unused entries; one launch each, within the kernels' limits."""
    H, Hkv = heads
    spans = [(1, 300), (1, 17), (40, 90), (1, 1)]
    T = sum(q for q, _ in spans) + 3
    q, kc, vc, bt, qo, ql, kl = _pack(spans, 2, T, H, Hkv, 128, 16, dtype,
                                      cuda)
    scales, counter = {}, "launches"
    if quantized:
        kc, vc, ks, vs, vmax = _quantize_pools(kc, vc, kc.shape[0] - 2)
        scales, counter = dict(key_scale=ks, value_scale=vs), "int8_launches"
    work = torch.from_numpy(pa.ragged_work(ql.cpu(), kl.cpu(), H, Hkv,
                                           16)).to(cuda)
    scale = 1.0 / np.sqrt(128)
    before = getattr(pa.ragged_paged_attention, counter)
    got = pa.ragged_paged_attention(q, kc, vc, bt, qo, ql, kl, span_q=40,
                                    work=work, **scales)
    torch.cuda.synchronize()
    assert getattr(pa.ragged_paged_attention, counter) == before + 1
    if quantized:
        want, flips = pa._ragged_attention_int8_plain(
            q, kc, vc, ks, vs, bt, qo, ql, kl, scale, flip_bound=True)
        tol = int8_tolerance(want, flips, vmax)
    else:
        want = pa._ragged_attention_plain(q, kc, vc, bt, qo, ql, kl, scale)
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()
    # #7 over the decode spans' queries
    dq_rows = qo[torch.tensor([0, 1, 3], device=cuda)].long()
    qd = q[dq_rows]
    sl = kl[[0, 1, 3]]
    btd = bt[[0, 1, 3]]
    before = getattr(pa.paged_attention, counter)
    got = pa.paged_attention(qd, kc, vc, btd, sl, **scales)
    want = pa._paged_attention_plain(qd, kc, vc, btd, sl, scale,
                                     flip_bound=quantized, **scales)
    torch.cuda.synchronize()
    assert getattr(pa.paged_attention, counter) == before + 1
    if quantized:
        want, flips = want
        tol = int8_tolerance(want, flips, vmax)
    else:
        tol = ragged_tolerance(want)
    assert (got.float() - want.float()).abs().le(tol).all()


@pytest.mark.parametrize("with_amax", [False, True])
@pytest.mark.parametrize("heads", RANK_HEADS,
                         ids=["7b_tp2", "7b_tp4", "qwen2_tp2", "mixtral_tp2"])
def test_rope_epilogue_bitwise_at_per_rank_heads(cuda, heads, with_amax):
    H, Hkv = heads
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(64, h, 128, generator=g, device=cuda).bfloat16()
               for h in (H, Hkv, Hkv))
    cos, sin = pk.rope_tables_for_positions(
        torch.randint(0, 4096, (64,), generator=g, device=cuda), 128)
    got = pk.rope_qkv_epilogue(q, k, v, cos, sin, with_amax)
    want = pk._rope_qkv_epilogue_plain(q, k, v, cos, sin, with_amax)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"ep": 2}],
                         ids=["tp2", "ep2"])
def test_tiny_sharded_engine_on_card_matches_one_card(cuda, mesh):
    """Two ranks sharing the card (gloo): a tiny fp32 Llama (tp 2) or
    Mixtral (ep 2) mixed engine gives the one-card engine's tokens, with
    the rank's kernels launched on every rank."""
    from paddle_tpu_torch.distributed.launch import run_world
    if "tp" in mesh:
        family = "llama"
        config = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    else:
        family = "mixtral"
        config = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=256,
                      num_local_experts=4, num_experts_per_tok=2)
    ops = [["add", list(range(1, 12)), 6], ["step"],
           ["add", list(range(40, 45)), 6], ["run"]]
    kw = dict(max_batch_size=2, num_blocks=32, block_size=16,
              mixed_step=True, prefill_chunk_size=8)
    out = run_world("paddle_tpu_torch.testing.sharded:serve_cases", 2, dict(
        device=None, backend="gloo",
        models={"m": dict(family=family, config=config)},
        cases=[dict(name="one", model="m", mesh=None, engine=kw, ops=ops),
               dict(name="sharded", model="m", mesh=mesh, engine=kw,
                    ops=ops)]), timeout=300)
    one, sharded = out
    assert sharded["tokens"] == one["tokens"]
    for r in sharded["ranks"]:
        assert r["launches"]["ragged"] == \
            one["ranks"][0]["launches"]["ragged"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_hop_kernels_match_plain(cuda, dtype):
    """A ring hop's kernels on the card (``ops.sequence_parallel``): the
    flash forward with lse and no rope on the diagonal block (causal) and
    on a full block, and both backward forms on each block against the
    out and lse of the whole causal row (the second rank of a two-rank
    ring), each against its plain version; then the ring's merge of the
    two hops' forwards equals the whole row's."""
    gen = torch.Generator(cuda).manual_seed(7)
    B, S, H, D = 1, 256, 4, 128
    q, k, v, g, _ = _flash_case(B, S, 2 * S, H, D, dtype, False, gen)
    out, lse = fa.flash_fwd(q, k, v, True)
    bf16 = dtype == "bfloat16"
    parts = []
    for lo, causal in ((0, False), (S, True)):
        kb, vb = k[:, lo:lo + S].contiguous(), v[:, lo:lo + S].contiguous()
        o, l = fa.flash_fwd(q, kb, vb, causal)
        want_o, want_l = fa._flash_fwd_plain(q, kb, vb, causal)
        noise = (flash_noise("flash_fwd", q, kb, vb, None, None, None,
                             causal, None)[0] if bf16 else None)
        assert flash_excess(o, want_o, flash_tolerance(
            want_o, dtype, noise)) <= 1.0
        assert (l - want_l).abs().max().item() <= 1e-4
        parts.append((o, l))
        for kern in ("flash_bwd_fused", "flash_bwd_two_kernel"):
            got = getattr(fa, kern)(q, kb, vb, out, lse, g, causal)
            want = fa._flash_bwd_plain(q, kb, vb, out, lse, g, causal,
                                       form=FLASH_FORM[kern])
            noise = (flash_noise(kern, q, kb, vb, out, lse, g, causal, None)
                     if bf16 else (None,) * 3)
            for a, b, f in zip(got, want, noise):
                assert flash_excess(a, b, flash_tolerance(b, dtype,
                                                          f)) <= 1.0
    # the ring's logaddexp merge of the two hops is the whole row
    (o0, l0), (o1, l1) = parts
    tot = torch.logaddexp(l0, l1)
    w0 = torch.exp(l0 - tot).transpose(1, 2)[..., None]
    w1 = torch.exp(l1 - tot).transpose(1, 2)[..., None]
    merged = o0.float() * w0 + o1.float() * w1
    assert (tot - lse).abs().max().item() <= 1e-4
    tol = 2e-5 if not bf16 else 2 ** -7 * 4
    assert (merged - out.float()).abs().max().item() <= tol * max(
        1.0, out.float().abs().max().item())
