"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, the tiny engines against the eager model and the
CPU engines, and a tiny training step through the flash kernels, on the
device.  Every test
skips itself when no CUDA device is present.

This file imports neither JAX nor ``paddle_tpu``, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which sets up the JAX CPU mesh):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import (_flash_case, _quantize_pools, _ragged_case,
                        flash_excess, flash_noise, flash_tolerance,
                        cut_lengths, int8_tolerance, ragged_tolerance)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny_config)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import kernels as pk
from paddle_tpu_torch.optimizer import AdamW
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
    got = pa.ragged_paged_attention(*args, span_q=70)
    want = pa._ragged_attention_plain(*args, 1.0 / np.sqrt(D))
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ragged_tolerance(want)
    assert (got[sum(q for q, _ in spans):] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _pack([(2, 9)], 0, 4, 4, 2, 48, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.ragged_paged_attention(*args, span_q=2)
    q, kc, vc, bt, qo, ql, kl = _pack([(2, 9)], 0, 4, 4, 2, 32, 4,
                                      torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_paged_attention(q.to(torch.bfloat16), kc, vc, bt, qo, ql,
                                  kl, span_q=2)
    with pytest.raises(ValueError, match="int32"):
        pa.ragged_paged_attention(q, kc, vc, bt.long(), qo, ql, kl,
                                  span_q=2)
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


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 2), (16, 2)],
                         ids=["mha", "g2", "g4", "g8"])
@pytest.mark.parametrize("D,bs", [(32, 4), (64, 5), (128, 16), (64, 32)])
def test_paged_decode_kernel_matches_plain(cuda, quantized, dtype, heads, D,
                                           bs):
    """Slots of many lengths (one past a page edge, one of a single key),
    NaN pages (or NaN scales) behind every unused table entry, and two
    masked slots (seq_len 1 over an all-sink row)."""
    H, Hkv = heads
    lens = [7, 33, 1, 16, 70, 5]
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
                                    key_scale=ks, value_scale=vs)
    want, flips = pa._ragged_attention_int8_plain(
        q, kc, vc, ks, vs, bt, qo, ql, kl, 1.0 / np.sqrt(D), flip_bound=True)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.int8_launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().le(
        int8_tolerance(want, flips, vmax)).all()
    assert (got[sum(q for q, _ in spans):] == 0).all()


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


# (causal, rope, Sq, Sk): square, longer key axis, rows that see nothing
# (Sq > Sk), and lengths off the kernels' 64-row tiles
FLASH_SHAPES = {"causal_rope": (True, True, 130, 130),
                "full_rope": (False, True, 96, 96),
                "causal": (True, False, 200, 200),
                "rect_causal": (True, False, 70, 190),
                "dead_rows": (True, False, 190, 70),
                "rect_full": (False, False, 50, 130)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain(cuda, dtype, D, shape):
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
    noise = dict.fromkeys(("flash_fwd", "flash_bwd"), (None,) * 3)
    if dtype == "bfloat16":
        noise = {kern: flash_noise(kern, q, k, v, out, lse, g, causal,
                                   tables)
                 for kern in ("flash_fwd", "flash_bwd")}
    assert flash_excess(out, want_out, flash_tolerance(
        want_out, dtype, noise["flash_fwd"][0])) <= 1.0
    assert (lse[~dead] - want_lse[~dead]).abs().max().item() <= 1e-4
    want = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables)
    for fn in (fa.flash_bwd_fused, fa.flash_bwd_two_kernel):
        got = fn(q, k, v, out, lse, g, causal, tables)
        torch.cuda.synchronize()
        for a, b, f in zip(got, want, noise["flash_bwd"]):
            assert torch.isfinite(a).all()
            assert flash_excess(a, b, flash_tolerance(b, dtype, f)) <= 1.0
    assert [f.launches for f in (fa.flash_fwd, fa.flash_bwd_fused,
                                 fa.flash_bwd_two_kernel)] \
        == [n + 1 for n in before]


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(x, x, x, True)
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


def test_flash_attention_rope_launches_at_any_length(cuda):
    """S=200 has no Pallas block (the reference falls back there); the
    port still launches the forward kernel and the backward form the
    reference's router picks for it (two-kernel: no key block), and a
    head dim the kernels lack raises instead of falling back."""
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 200, 4, 64, generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    assert not fa.fused_bwd_taken(200)
    before = (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches)
    fa.flash_attention_rope(q, k, v).sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_two_kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    x = torch.zeros(1, 200, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_rope(x, x, x)


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
