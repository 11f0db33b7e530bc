"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, and the tiny engine against the eager model, on
the device.  Every test skips itself when no CUDA device is present.

This file imports neither JAX nor ``paddle_tpu``, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which sets up the JAX CPU mesh):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import _ragged_case, ragged_tolerance
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.ops import kernels as pk
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
    before = pk.rope_qkv_epilogue.launches
    got = pk.rope_qkv_epilogue(q, k, v, cos, sin, with_amax)
    want = pk._rope_qkv_epilogue_plain(q, k, v, cos, sin, with_amax)
    assert pk.rope_qkv_epilogue.launches == before + 1
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
                                   block_size=8, prefill_chunk_size=16)
    r = [eng.add_request(p, 6) for p in prompts[:2]]
    eng.step()
    r += [eng.add_request(p, 6) for p in prompts[2:]]
    eng.run_to_completion()
    assert [eng.result(x) for x in r] == want
    assert len(eng.caches[0]._free) == 64
