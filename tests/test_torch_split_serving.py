"""The port's split engine and int8 KV pools against the JAX reference, on
the CPU.

The kernel wrappers take their plain PyTorch versions for CPU tensors;
these tests hold those plain versions against the reference's XLA
functions and, for the paged kernels, against the reference's Pallas
kernels run in interpret mode.  On jax 0.9.0 those kernels need two
names that moved (``jax.experimental.disable_x64`` and
``pltpu.TPUMemorySpace``); the ``interpret`` fixture sets both for one
test with ``monkeypatch`` and changes nothing in ``paddle_tpu``.

The engines carry the reference's weights, so the split engine (dense and
bucketed prefill), the mixed engine, lazy allocation and the int8 engines
are compared with ``paddle_tpu`` token for token.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import serving_step as ref_ss
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.ops import online_softmax as ref_os
from paddle_tpu.ops import paged_attention as ref_pa
from paddle_tpu.quantization import functional as ref_qf

from chip_smoke import (cut_lengths, fault_excess, int8_tolerance,
                        _int8_plain_faults)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.serving_step import prefill_scatter
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import online_softmax as pos
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.quantization import functional as qf
from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights

t = torch.from_numpy


def _np(x):
    return np.asarray(x)


@pytest.fixture
def interpret(monkeypatch):
    """Let the reference's paged Pallas kernels run in interpret mode on
    jax 0.9.0 for this test only."""
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                        raising=False)


# ---------------------------------------------------------------------------
# quantization functions and the online-softmax update: bitwise
# ---------------------------------------------------------------------------
def test_quantization_functions_bitwise_equal_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(7, 5, 16) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero row
    x[1, 1, :4] = np.float32(0.5) / 127 * np.arange(4)   # .5 ties
    sc = np.abs(x).max(-1, keepdims=True)
    assert qf.symmetric_bound(8) == ref_qf.symmetric_bound(8) == 127
    np.testing.assert_array_equal(
        qf.absmax_scale(t(x), dim=-1).numpy(),
        _np(ref_qf.absmax_scale(jnp.asarray(x), axis=-1)))
    codes = qf.quantize_symmetric(t(x), t(sc))
    np.testing.assert_array_equal(
        codes.numpy(), _np(ref_qf.quantize_symmetric(jnp.asarray(x),
                                                     jnp.asarray(sc))))
    np.testing.assert_array_equal(
        qf.dequantize_symmetric(codes.to(torch.int8), t(sc)).numpy(),
        _np(ref_qf.dequantize_symmetric(jnp.asarray(codes.numpy()).astype(
            jnp.int8), jnp.asarray(sc))))
    c1, s1 = qf.quantize_rows_symmetric(t(x))
    c2, s2 = ref_qf.quantize_rows_symmetric(jnp.asarray(x))
    assert c1.dtype == torch.int8
    np.testing.assert_array_equal(c1.numpy(), _np(c2))
    np.testing.assert_array_equal(s1.numpy(), _np(s2))
    acc = rng.randint(-2 ** 20, 2 ** 20, (5, 9)).astype(np.int32)
    qs = np.abs(rng.randn(5, 1)).astype(np.float32)
    for softmax_scale in (1.0, 0.125, 1 / np.sqrt(96)):
        np.testing.assert_array_equal(
            qf.fold_int8_scores(t(acc), t(qs), np.float32(0.7),
                                softmax_scale).numpy(),
            _np(ref_qf.fold_int8_scores(jnp.asarray(acc), jnp.asarray(qs),
                                        np.float32(0.7), softmax_scale)))


def test_online_softmax_update_matches_reference():
    """The same expressions in the same order; torch's and XLA's exp and
    matmul may round differently in the last bit (1e-6 relative), and the
    all-masked row stays exactly at its carry."""
    rng = np.random.RandomState(1)
    g, tk, d = 6, 8, 4
    s = rng.randn(g, tk).astype(np.float32)
    ok = rng.rand(g, tk) > 0.3
    ok[0] = False                                   # an all-masked row
    s = np.where(ok, s, -np.inf).astype(np.float32)
    v = rng.randn(tk, d).astype(np.float32)
    carry = (np.where(rng.rand(g, 1) > 0.5, rng.randn(g, 1), -np.inf)
             .astype(np.float32), np.abs(rng.randn(g, 1)).astype(np.float32),
             rng.randn(g, d).astype(np.float32))
    carry[1][np.isneginf(carry[0])] = 0.0
    carry[2][np.isneginf(carry[0])[:, 0]] = 0.0
    want = ref_os.online_softmax_update(
        tuple(jnp.asarray(c) for c in carry), jnp.asarray(s),
        jnp.asarray(ok), lambda p: p @ jnp.asarray(v))
    got = pos.online_softmax_update(tuple(t(c) for c in carry), t(s), t(ok),
                                    lambda p: p @ t(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2][0].numpy(), carry[2][0])


# ---------------------------------------------------------------------------
# writes: fp and int8, bitwise
# ---------------------------------------------------------------------------
def _pools(rng, phys=9, bs=4, hkv=2, d=8):
    return (rng.randn(phys, bs, hkv, d).astype(np.float32),
            rng.randn(phys, bs, hkv, d).astype(np.float32))


def _assert_pools_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_fp_writes_bitwise_equal_reference():
    rng = np.random.RandomState(2)
    kc, vc = _pools(rng)
    bt = np.asarray([[3, 1, 8, 8], [0, 4, 5, 8], [8, 8, 8, 8]], np.int32)
    sl = np.asarray([5, 2, 0], np.int32)             # slot 2: masked
    k1, v1 = (rng.randn(3, 2, 8).astype(np.float32) for _ in range(2))
    want = ref_pa.write_decode_kv(jnp.asarray(k1), jnp.asarray(v1),
                                  jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(bt), jnp.asarray(sl))
    got = (t(kc.copy()), t(vc.copy()))
    pa.write_decode_kv(t(k1), t(v1), *got, t(bt), t(sl))
    _assert_pools_equal(got, want)

    kp, vp = (rng.randn(2, 6, 2, 8).astype(np.float32) for _ in range(2))
    sl2 = np.asarray([1, 3], np.int32)
    want = ref_pa.write_prefill_kv(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(bt[:2]), jnp.asarray(sl2))
    got = (t(kc.copy()), t(vc.copy()))
    pa.write_prefill_kv(t(kp), t(vp), *got, t(bt[:2]), t(sl2))
    _assert_pools_equal(got, want)

    # a bucket-padded chunk starting mid-page; 3 padding positions go to
    # the sink page (8), one of them past the row's last table column
    kch, vch = (rng.randn(1, 8, 2, 8).astype(np.float32) for _ in range(2))
    row = np.asarray([[0, 4, 5]], np.int32)
    want = ref_pa.write_chunk_kv(jnp.asarray(kch), jnp.asarray(vch),
                                 jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(row), jnp.asarray(3),
                                 jnp.asarray(5), 8)
    got = (t(kc.copy()), t(vc.copy()))
    pa.write_chunk_kv(t(kch), t(vch), *got, t(row), 3, 5, 8)
    # the padding rows all land on (sink, 0): compare the live pages, and
    # the sink apart from that slot
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy()[:8], _np(b)[:8])
        np.testing.assert_array_equal(a.numpy()[8, 1:], _np(b)[8, 1:])


def _q8_state(rng, phys=9, bs=4, hkv=2, d=8):
    """An int8 pool with some pages written (nonzero scales)."""
    kc = rng.randint(-127, 128, (phys, bs, hkv, d)).astype(np.int8)
    vc = rng.randint(-127, 128, (phys, bs, hkv, d)).astype(np.int8)
    ks = np.abs(rng.randn(phys, hkv)).astype(np.float32)
    vs = np.abs(rng.randn(phys, hkv)).astype(np.float32)
    ks[2] = vs[2] = 0.0                                 # a fresh page
    return kc, vc, ks, vs


def _q8_both(fn_ref, fn_port, state, *args, port_args=None):
    kc, vc, ks, vs = state
    want = fn_ref(*[jnp.asarray(a) for a in args[:2]], jnp.asarray(kc),
                  jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
                  *args[2:])
    got = [t(a.copy()) for a in (kc, vc, ks, vs)]
    fn_port(*[t(a) for a in args[:2]], *got, *(port_args or args[2:]))
    return got, want


@pytest.mark.parametrize("with_amax", [False, True])
def test_int8_writes_bitwise_equal_reference(with_amax):
    """Codes and scales equal the reference's bit for bit: a page whose
    scale rises (its old codes rescaled), a fresh page, several tokens per
    page, duplicate sink writes (masked decode slots share the sink page;
    only its codes at the shared slot are left out, where both sides keep
    whichever duplicate lands last)."""
    rng = np.random.RandomState(3)
    state = _q8_state(rng)

    def amax(x):
        if not with_amax:
            return None
        return np.abs(x).max(-1).astype(np.float32)

    # ragged: tokens for pages 1 (twice, one much larger: scale rises),
    # 2 (fresh), 4 and the sink (8) twice
    k = (rng.randn(7, 2, 8) * np.array([1, 9, 1, 1, 1, 1, 1])[:, None, None]
         ).astype(np.float32)
    v = rng.randn(7, 2, 8).astype(np.float32)
    blk = np.asarray([1, 1, 2, 4, 8, 8, 2], np.int32)
    off = np.asarray([0, 3, 1, 2, 0, 0, 0], np.int32)
    am = (amax(k), amax(v))
    got, want = _q8_both(
        lambda *a: ref_pa.write_ragged_kv_q8(
            *a, jnp.asarray(blk), jnp.asarray(off),
            *(None if x is None else jnp.asarray(x) for x in am)),
        pa.write_ragged_kv_q8, state, k, v,
        port_args=(t(blk).long(), t(off).long(),
                   *(None if x is None else t(x) for x in am)))
    for a, b in zip(got[2:], want[2:]):                 # scales
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(got[:2], want[:2]):                 # codes
        np.testing.assert_array_equal(a.numpy()[:8], _np(b)[:8])
        np.testing.assert_array_equal(a.numpy()[8, 1:], _np(b)[8, 1:])
    assert (got[2].numpy()[1] > state[2][1]).any()      # the scale rose

    # decode: one token per live page, two masked slots on the sink
    bt = np.asarray([[3, 1, 8], [5, 8, 8], [8, 8, 8], [8, 8, 8]], np.int32)
    sl = np.asarray([6, 2, 0, 0], np.int32)
    k = (rng.randn(4, 2, 8) * 5).astype(np.float32)
    v = rng.randn(4, 2, 8).astype(np.float32)
    am = (amax(k), amax(v))
    got, want = _q8_both(
        lambda *a: ref_pa.write_decode_kv_q8(
            *a, jnp.asarray(bt), jnp.asarray(sl),
            *(None if x is None else jnp.asarray(x) for x in am)),
        pa.write_decode_kv_q8, state, k, v,
        port_args=(t(bt), t(sl), *(None if x is None else t(x)
                                   for x in am)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy()[:8], _np(b)[:8])

    # chunk: 6 positions from 2 (pages 0 and 7), 2 padding -> sink
    row = np.asarray([[0, 7, 6]], np.int32)
    k = rng.randn(1, 8, 2, 8).astype(np.float32)
    v = rng.randn(1, 8, 2, 8).astype(np.float32)
    am = (amax(k[0]), amax(v[0]))
    got, want = _q8_both(
        lambda *a: ref_pa.write_chunk_kv_q8(
            *a, jnp.asarray(row), jnp.asarray(2), jnp.asarray(6), 8,
            *(None if x is None else jnp.asarray(x) for x in am)),
        pa.write_chunk_kv_q8, state, k, v,
        port_args=(t(row), 2, 6, 8, *(None if x is None else t(x)
                                      for x in am)))
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy()[:8], _np(b)[:8])
    np.testing.assert_array_equal(
        pa.dequant_pages(got[0], got[2]).numpy(),
        _np(ref_pa.dequant_pages(want[0], want[2])))


def test_int8_writes_bitwise_equal_reference_at_7b_widths():
    """Llama-2-7B's KV geometry (32 kv heads, D 128, pages of 16) through
    each int8 write with the epilogue's amaxes, from a fresh pool: a
    48-wide chunk of 30 tokens starting mid-page (padding to the sink),
    decode tokens 4x larger (a written page's scale rises and its codes
    are rescaled; a fresh page; masked slots), and a ragged pack with
    several tokens per page.  Codes and scales equal the
    reference's bit for bit after every write, the sink page aside."""
    rng = np.random.RandomState(7)
    phys, bs, hkv, d = 13, 16, 32, 128                 # page 12: the sink
    ref_state = [jnp.zeros((phys, bs, hkv, d), jnp.int8)] * 2 + \
        [jnp.zeros((phys, hkv), jnp.float32)] * 2
    port_state = [torch.zeros(phys, bs, hkv, d, dtype=torch.int8)
                  for _ in range(2)] + [torch.zeros(phys, hkv)
                                        for _ in range(2)]

    def write(fn_ref, fn_port, shape, gain, ref_args, port_args):
        nonlocal ref_state
        k, v = ((rng.randn(*shape) * gain).astype(np.float32)
                for _ in range(2))
        am = [np.abs(x.reshape(-1, hkv, d)).max(-1) for x in (k, v)]
        ref_state = fn_ref(jnp.asarray(k), jnp.asarray(v), *ref_state,
                           *ref_args, *(jnp.asarray(a) for a in am))
        fn_port(t(k), t(v), *port_state, *port_args, *(t(a) for a in am))
        for a, b in zip(port_state, ref_state):
            np.testing.assert_array_equal(a.numpy()[:12], _np(b)[:12])

    row = np.asarray([[0, 1, 2, 3]], np.int32)
    write(ref_pa.write_chunk_kv_q8, pa.write_chunk_kv_q8, (1, 48, hkv, d),
          1.0, (jnp.asarray(row), jnp.asarray(8), jnp.asarray(30), 12),
          (t(row), 8, 30, 12))                  # positions 8..37
    page2 = port_state[2][2].clone()
    bt = np.asarray([[0, 1, 2, 3], [4, 5, 12, 12], [12] * 4, [12] * 4],
                    np.int32)
    sl = np.asarray([38, 17, 0, 0], np.int32)
    write(ref_pa.write_decode_kv_q8, pa.write_decode_kv_q8, (4, hkv, d),
          4.0, (jnp.asarray(bt), jnp.asarray(sl)), (t(bt), t(sl)))
    assert (port_state[2][2] > page2).all()       # page 2's scale rose
    blk = np.asarray([3] * 5 + [6] * 9 + [2, 2, 12, 12], np.int32)
    off = np.asarray(list(range(1, 6)) + list(range(9)) + [7, 8, 0, 0],
                     np.int32)
    write(ref_pa.write_ragged_kv_q8, pa.write_ragged_kv_q8, (18, hkv, d),
          2.0, (jnp.asarray(blk), jnp.asarray(off)),
          (t(blk).long(), t(off).long()))
    written = [0, 1, 2, 3, 5, 6]
    assert (port_state[2][written] > 0).all()
    assert not port_state[2][[4, 7]].any()


def test_int8_cache_layout_and_capacity():
    ref = ref_pa.PagedKVCache(8, 4, 2, 16, sink_block=True, kv_dtype="int8")
    got = pa.PagedKVCache(8, 4, 2, 16, sink_block=True, device="cpu",
                          kv_dtype="int8")
    assert got.quantized and got.key_cache.dtype == torch.int8
    assert tuple(got.key_scale.shape) == tuple(ref.key_scale.shape) == (9, 2)
    assert not got.key_scale.any()
    assert got.pool_bytes() == ref.per_chip_pool_bytes()
    fp = pa.PagedKVCache(8, 4, 2, 16, torch.float32, sink_block=True,
                         device="cpu")
    assert fp.pool_bytes() / got.pool_bytes() >= 1.9   # scales counted
    with pytest.raises(ValueError, match="kv_dtype"):
        pa.PagedKVCache(8, 4, 2, 16, device="cpu", kv_dtype="int4")


# ---------------------------------------------------------------------------
# chunked prefill attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("start", [0, 6])
def test_chunk_prefill_attention_matches_reference(quantized, start):
    rng = np.random.RandomState(4)
    bs, hkv, d, C, H = 4, 2, 16, 8, 4
    kc, vc = _pools(rng, phys=13, bs=bs, hkv=hkv, d=d)
    q = rng.randn(1, C, H, d).astype(np.float32)
    row = np.asarray([[5, 2, 9, 0, 12, 12]], np.int32)
    scales = ({}, {})
    if quantized:
        cache = ref_pa.PagedKVCache(12, bs, hkv, d, sink_block=True,
                                    kv_dtype="int8")
        blk = np.repeat(np.arange(13, dtype=np.int32), bs)
        off = np.tile(np.arange(bs, dtype=np.int32), 13)
        kq, vq, ks, vs = ref_pa.write_ragged_kv_q8(
            jnp.asarray(kc.reshape(-1, hkv, d)),
            jnp.asarray(vc.reshape(-1, hkv, d)), cache.key_cache,
            cache.value_cache, cache.key_scale, cache.value_scale,
            jnp.asarray(blk), jnp.asarray(off))
        kc, vc = _np(kq).copy(), _np(vq).copy()
        scales = ((jnp.asarray(ks), jnp.asarray(vs)),
                  (t(_np(ks).copy()), t(_np(vs).copy())))
    want = ref_pa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(row),
        jnp.asarray(start), 1 / np.sqrt(d), *(scales[0] or ()))
    got = pa.chunk_prefill_attention(t(q), t(kc), t(vc), t(row), start,
                                     1 / np.sqrt(d), *(scales[1] or ()))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# decode attention (#7) and the int8 ragged attention (#5)
# ---------------------------------------------------------------------------
def _decode_pack(seq_lens, H, Hkv, D, bs=4, W=5, seed=5):
    """Random fp pools, a table per slot aimed at a poison page past its
    used pages, and a masked slot (seq_len 1, all-sink row) at the end.
    Returns the clean pools, the poisoned ones (every page no slot uses
    is NaN) and the operands."""
    rng = np.random.RandomState(seed)
    nb = 24
    kc, vc = _pools(rng, phys=nb + 1, bs=bs, hkv=Hkv, d=D)
    sink = nb
    poison, page, rows, used = nb - 1, 0, [], set()
    for s in seq_lens:
        n = -(-s // bs)
        tab = np.full((W,), poison, np.int32)
        tab[:n] = np.arange(page, page + n)
        used.update(range(page, page + n))
        page += n
        rows.append(tab)
    rows.append(np.full((W,), sink, np.int32))
    bt = np.stack(rows)
    sl = np.asarray(list(seq_lens) + [1], np.int32)
    q = rng.randn(len(sl), H, D).astype(np.float32)
    kc_p, vc_p = kc.copy(), vc.copy()
    unused = sorted(set(range(nb)) - used)
    kc_p[unused] = np.nan
    vc_p[unused] = np.nan
    return q, kc, vc, kc_p, vc_p, bt, sl


@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 1)],
                         ids=["gqa", "mha", "mqa"])
def test_paged_attention_plain_matches_xla(heads):
    """Within 1e-5 of ``_paged_attention_xla``; the reference gets the
    clean pool (its gather reads every table entry), the port the
    poisoned one, so a read past a slot's used pages would show."""
    H, Hkv = heads
    q, kc, vc, kc_p, vc_p, bt, sl = _decode_pack([5, 9, 1, 16, 20], H, Hkv,
                                                 16)
    want = ref_pa._paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(sl), 1 / np.sqrt(16))
    before = (pa.paged_attention.launches, pa.paged_attention.int8_launches)
    got = pa.paged_attention(t(q), t(kc_p), t(vc_p), t(bt), t(sl))
    assert (pa.paged_attention.launches,
            pa.paged_attention.int8_launches) == before
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def test_paged_attention_plain_matches_pallas_interpret(interpret):
    q, kc, vc, kc_p, vc_p, bt, sl = _decode_pack([7, 3, 12, 20], 4, 2, 8)
    want = ref_pa._paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(sl), 1 / np.sqrt(8), interpret=True)
    got = pa.paged_attention(t(q), t(kc_p), t(vc_p), t(bt), t(sl))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def _q8_pools(rounds, growth, seed, nb=16, bs=4, hkv=2, d=16):
    """The same int8 pool on both sides, filled through the real
    quantize-on-write path with magnitudes growing per round (existing
    codes rescaled); every page written."""
    rng = np.random.RandomState(seed)
    cq = ref_pa.PagedKVCache(nb, bs, hkv, d, sink_block=True,
                             kv_dtype="int8")
    for r in range(rounds):
        n = bs * nb
        k = (rng.randn(n, hkv, d) * growth ** r).astype(np.float32)
        v = (rng.randn(n, hkv, d) * growth ** r).astype(np.float32)
        blk = np.repeat(np.arange(nb, dtype=np.int32), bs)
        off = np.tile(np.arange(bs, dtype=np.int32), nb)
        (cq.key_cache, cq.value_cache, cq.key_scale,
         cq.value_scale) = ref_pa.write_ragged_kv_q8(
            jnp.asarray(k), jnp.asarray(v), cq.key_cache, cq.value_cache,
            cq.key_scale, cq.value_scale, jnp.asarray(blk),
            jnp.asarray(off))
    port = [t(_np(a).copy()) for a in (cq.key_cache, cq.value_cache,
                                       cq.key_scale, cq.value_scale)]
    vmax = float(np.abs(_np(ref_pa.dequant_pages(cq.value_cache,
                                                 cq.value_scale))).max())
    return cq, port, vmax


def _spans_pack(spans, W, H, d, rng, sink, bs=4, nb=16):
    rows = []
    for _q, kv in spans:
        used = -(-kv // bs)
        tab = np.full((W,), sink, np.int32)
        tab[:used] = (np.arange(used) * 3 + len(rows)) % nb
        rows.append(tab)
    bt = np.stack(rows)
    T = sum(q for q, _ in spans)
    q = rng.randn(T, H, d).astype(np.float32)
    q_off = np.cumsum([0] + [a for a, _ in spans[:-1]]).astype(np.int32)
    q_len = np.asarray([a for a, _ in spans], np.int32)
    kv_len = np.asarray([b for _, b in spans], np.int32)
    return q, bt, q_off, q_len, kv_len


def _ragged_int8_case(spans, rounds, growth, seed, W=6, H=4, d=16):
    cq, port, vmax = _q8_pools(rounds, growth, seed, d=d)
    rng = np.random.RandomState(seed + 1)
    q, bt, q_off, q_len, kv_len = _spans_pack(spans, W, H, d, rng, cq.sink)
    common = (bt, q_off, q_len, kv_len)
    pallas = ref_pa.ragged_paged_attention(
        q, cq.key_cache, cq.value_cache, *common, interpret=True,
        span_q=int(q_len.max()), key_scale=cq.key_scale,
        value_scale=cq.value_scale)
    xla = ref_pa.ragged_paged_attention(
        q, cq.key_cache, cq.value_cache, *common, use_pallas=False,
        key_scale=cq.key_scale, value_scale=cq.value_scale)
    tq, tbt, toff, tql, tkv = (t(a) for a in (q, *common))

    def plain(kv=tkv, flip_bound=False):
        return pa._ragged_attention_int8_plain(
            tq, *port, tbt, toff, tql, kv, 1 / np.sqrt(d),
            flip_bound=flip_bound)
    before = pa.ragged_paged_attention.int8_launches
    got = pa.ragged_paged_attention(
        tq, port[0], port[1], tbt, toff, tql, tkv, span_q=int(q_len.max()),
        key_scale=port[2], value_scale=port[3])
    assert pa.ragged_paged_attention.int8_launches == before
    want, flips = plain(flip_bound=True)
    assert torch.equal(got, want)
    bs = port[0].shape[1]
    faults = {"plain_drops_last_key": plain(cut_lengths(tkv, tql, bs, False)),
              "plain_drops_last_page": plain(cut_lengths(tkv, tql, bs,
                                                         True))}
    faults.update(_int8_plain_faults(
        lambda qq, kd, vd: pa._ragged_attention_plain(
            qq, kd, vd, tbt, toff, tql, tkv, 1 / np.sqrt(d)),
        tq, *port))
    return got, flips, _np(pallas), _np(xla), vmax, faults


def _decode_int8_case(seq_lens, rounds, growth, seed, W=6, H=4, d=16):
    cq, port, vmax = _q8_pools(rounds, growth, seed, d=d)
    rng = np.random.RandomState(seed + 2)
    q, bt, _, _, sl = _spans_pack([(1, s) for s in seq_lens], W, H, d, rng,
                                  cq.sink)
    args = (jnp.asarray(q), cq.key_cache, cq.value_cache, jnp.asarray(bt),
            jnp.asarray(sl), 1 / np.sqrt(d))
    pallas = ref_pa._paged_attention_pallas(
        *args, interpret=True, key_scale=cq.key_scale,
        value_scale=cq.value_scale)
    xla = ref_pa._paged_attention_xla(*args, cq.key_scale, cq.value_scale)
    tq, tbt, tsl = t(q), t(bt), t(sl)

    def plain(lens=tsl, flip_bound=False):
        return pa._paged_attention_plain(
            tq, port[0], port[1], tbt, lens, 1 / np.sqrt(d), *port[2:],
            flip_bound=flip_bound)
    before = pa.paged_attention.int8_launches
    got = pa.paged_attention(tq, port[0], port[1], tbt, tsl,
                             key_scale=port[2], value_scale=port[3])
    assert pa.paged_attention.int8_launches == before
    want, flips = plain(flip_bound=True)
    assert torch.equal(got, want)
    one, bs = tsl.clamp(max=1), port[0].shape[1]
    faults = {"plain_drops_last_key": plain(cut_lengths(tsl, one, bs, False)),
              "plain_drops_last_page": plain(cut_lengths(tsl, one, bs,
                                                         True))}
    faults.update(_int8_plain_faults(
        lambda qq, kd, vd: pa._paged_attention_plain(
            qq, kd, vd, tbt, tsl, 1 / np.sqrt(d)), tq, *port))
    return got, flips, _np(pallas), _np(xla), vmax, faults


def _hold_int8(got, flips, pallas, xla, vmax, faults):
    """The plain version within ``chip_smoke.int8_tolerance`` of the
    Pallas int8 kernel (per element: the fp32 allowance plus the
    probability codes near a .5 boundary), which rejects every planted
    fault (a plain version that drops each sequence's last key or last
    page, leaves p unquantized, or dequantizes like the XLA path); and
    within ``KERNEL_INT8_REL_TOL * vmax`` of the XLA dequant path."""
    assert torch.isfinite(got).all()
    tol = int8_tolerance(got, flips, vmax)
    pallas = torch.from_numpy(np.array(pallas))
    assert (pallas - got).abs().le(tol).all()
    excess = fault_excess(faults, pallas, tol)
    assert min(excess.values()) > 1.0, excess
    assert np.abs(got.numpy() - xla).max() <= pa.KERNEL_INT8_REL_TOL * vmax


def test_ragged_int8_plain_matches_pallas_interpret(interpret):
    """Decode spans, a chunk starting mid-page and a prefix-offset span
    over a pool whose scales rose once (codes rescaled)."""
    _hold_int8(*_ragged_int8_case([(1, 5), (6, 6), (4, 12), (3, 23)],
                                  rounds=2, growth=2.0, seed=10))


def test_paged_attention_int8_plain_matches_pallas_interpret(interpret):
    _hold_int8(*_decode_int8_case([5, 9, 1, 16, 23], rounds=2, growth=2.0,
                                  seed=11))


@pytest.mark.slow
@pytest.mark.parametrize("rounds,growth", [(1, 1.0), (3, 2.0), (2, 3.0)])
def test_int8_plain_versions_match_pallas_interpret_sweep(interpret, rounds,
                                                          growth):
    for spans, W in (([(1, 5), (1, 9), (1, 1), (1, 16)], 4),
                     ([(8, 16)], 4), ([(3, 11), (0, 1), (2, 10)], 6),
                     ([(16, 24), (1, 24)], 6)):
        _hold_int8(*_ragged_int8_case(spans, rounds, growth, 20 + rounds,
                                      W=W))
    for lens in ([1, 2, 3, 4], [24, 17, 8], [13]):
        _hold_int8(*_decode_int8_case(lens, rounds, growth, 30 + rounds))


# ---------------------------------------------------------------------------
# engines against the reference
# ---------------------------------------------------------------------------
# the reference serving tests' _tiny_model (tests/test_serving.py)
TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=128, intermediate_size=128)
CHURN_PROMPTS = [np.array([7, 9, 2], np.int64),
                 np.array([3, 14, 15, 92, 65], np.int64),
                 np.arange(1, 11, dtype=np.int64)]
CHURN_BUDGETS = [4, 4, 4]


def _pair(seed=0, **kw):
    """(reference model, port model with the reference's weights)."""
    paddle.seed(seed)
    ref_cfg = ref_tiny_config(**kw)
    ref = RefLlama(ref_cfg)
    ref.eval()
    cfg = LlamaConfig(**{f: getattr(ref_cfg, f)
                         for f in LlamaConfig.__dataclass_fields__})
    port = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_weights(port, {k: np.asarray(v._value)
                                   for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(**TINY)


@pytest.fixture(scope="module")
def default_tiny_pair():
    """The reference quantization tests' model: llama_tiny_config()."""
    return _pair()


def _run_churn(eng):
    r0 = eng.add_request(CHURN_PROMPTS[0], CHURN_BUDGETS[0])
    eng.step()                          # r0 decoding alone
    r1 = eng.add_request(CHURN_PROMPTS[1], CHURN_BUDGETS[1])
    r2 = eng.add_request(CHURN_PROMPTS[2], CHURN_BUDGETS[2])
    eng.run_to_completion()             # the long prompt chunks mid-decode
    return [eng.result(r) for r in (r0, r1, r2)]


def _leak_free(eng):
    cache = eng.caches[0]
    return sorted(cache._free + [cache.sink]) == list(
        range(cache.num_blocks + 1))


@pytest.mark.parametrize("prefill", [
    dict(),
    dict(prefill_buckets="auto", prefill_chunk_size=4),
    dict(prefill_buckets=(4, 8)),
], ids=["dense", "auto_buckets_chunk4", "buckets_4_8"])
def test_split_engine_byte_identical_to_reference_and_eager(tiny_pair,
                                                            prefill):
    """The split engine (the default) on the churn workload: tokens equal
    to the reference's split engine and to eager ``generate``; bucket
    widths seen bounded by the bucket count; the decode step built once;
    no page leaked; a second wave reuses everything."""
    ref, port = tiny_pair
    want = [port.generate(torch.from_numpy(p)[None], n)[0, len(p):].tolist()
            for p, n in zip(CHURN_PROMPTS, CHURN_BUDGETS)]
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4, **prefill)
    eng = ContinuousBatchingEngine(port, device="cpu", **kw)
    assert eng.mixed is None and eng.token_budgets is None
    got = _run_churn(eng)
    assert got == want
    assert got == _run_churn(RefEngine(ref, **kw))
    assert eng.decode_step.compile_count == 1
    if eng.prefill_step is not None:
        assert 0 < eng.prefill_step.total_compiles <= len(
            eng.prefill_buckets)
    assert _leak_free(eng)
    r3 = eng.add_request(CHURN_PROMPTS[2], CHURN_BUDGETS[2])
    eng.run_to_completion()
    assert eng.result(r3) == want[2]


def test_split_matches_mixed_engine_tokens(tiny_pair):
    """The reference's test_mixed_matches_split_engine_tokens on the port
    (and its tokens equal the reference engine's)."""
    ref, port = tiny_pair
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 128, (n,)).astype(np.int64)
               for n in (3, 6, 10, 14)]
    budgets = [5, 4, 6, 4]

    def run(make, **kw):
        eng = make(max_batch_size=3, num_blocks=64, block_size=4, **kw)
        rids = [eng.add_request(prompts[0], budgets[0])]
        eng.step()
        for p, n in zip(prompts[1:], budgets[1:]):
            rids.append(eng.add_request(p, n))
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    def port_eng(**kw):
        return ContinuousBatchingEngine(port, device="cpu", **kw)

    split = run(port_eng, prefill_buckets=(4, 8), prefill_chunk_size=8)
    mixed = run(port_eng, mixed_step=True, prefill_chunk_size=8)
    assert split == mixed
    assert split == run(lambda **kw: RefEngine(ref, **kw),
                        prefill_buckets=(4, 8), prefill_chunk_size=8)


@pytest.mark.parametrize("mode", [dict(), dict(mixed_step=True,
                                               prefill_chunk_size=4)],
                         ids=["split", "mixed"])
def test_lazy_alloc_victim_truncation_equals_reference(tiny_pair, mode):
    """The reference's lazy-alloc victim contract (tests/test_serving.py):
    a pool of 4 pages cannot hold two prompt-3 requests of 12 new tokens,
    so one finishes early with ``truncated=True``; the same victim and the
    same tokens as the reference, the pool whole, the engine reusable."""
    ref, port = tiny_pair
    kw = dict(max_batch_size=2, num_blocks=4, block_size=4, max_seq_len=32,
              lazy_alloc=True, **mode)

    def run(eng):
        rids = [eng.add_request(np.array([1, 2, 3], np.int64), 12),
                eng.add_request(np.array([4, 5, 6], np.int64), 12)]
        eng.run_to_completion()
        return [(eng.finished[r].truncated, eng.result(r)) for r in rids]

    eng = ContinuousBatchingEngine(port, device="cpu", **kw)
    got = run(eng)
    assert got == run(RefEngine(ref, **kw))
    assert any(tr for tr, _ in got)
    for tr, toks in got:
        assert 0 < len(toks) <= 12 and (tr or len(toks) == 12)
    assert len(eng.caches[0]._free) == 4
    r2 = eng.add_request(np.array([9], np.int64), 3)
    eng.run_to_completion()
    assert len(eng.result(r2)) == 3 and not eng.finished[r2].truncated


def _staggered(eng, prompts, budgets):
    rids = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        rids.append(eng.add_request(p, b))
        if i % 2 == 0:
            eng.step()
    eng.run_to_completion()
    return [eng.result(r) for r in rids]


def _match_rate(got, want):
    """Mean per-request share of ``want`` matched up to the first
    divergence."""
    rates = []
    for g, w in zip(got, want):
        n = 0
        for a, b in zip(g, w):
            if a != b:
                break
            n += 1
        rates.append(n / max(1, len(w)))
    return float(np.mean(rates))


KV8_THRESHOLD = 0.90    # r13's kv8 token-match gate (BENCH_QUANT_r13.json)


@pytest.mark.parametrize("mode", [
    dict(mixed_step=True, prefill_chunk_size=8),
    dict(prefill_buckets="auto", prefill_chunk_size=8),
], ids=["mixed", "split"])
def test_kv8_engine_matches_reference_kv8_and_fp32(default_tiny_pair, mode):
    """The int8-pool engine on the reference quantization tests'
    staggered mix: its tokens against the reference's kv8 engine (which
    dequantizes where the port runs the int8 kernels' math) and against
    the port's fp32-pool engine, each at least 0.90; the int8 pools hold
    at least 1.9x the pages per byte of the fp32 ones, scales counted; the
    int8 launches stay 0 on the CPU."""
    ref, port = default_tiny_pair
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 1024, (n,)).astype(np.int64)
               for n in (5, 3, 8)]
    budgets = [6, 8, 5]
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4, **mode)
    before = (pa.ragged_paged_attention.int8_launches,
              pa.paged_attention.int8_launches)
    eq = ContinuousBatchingEngine(port, device="cpu", kv_dtype="int8", **kw)
    got = _staggered(eq, prompts, budgets)
    fp = _staggered(ContinuousBatchingEngine(port, device="cpu", **kw),
                    prompts, budgets)
    ref_q = _staggered(RefEngine(ref, kv_dtype="int8", **kw), prompts,
                       budgets)
    assert _match_rate(got, ref_q) >= KV8_THRESHOLD
    assert _match_rate(got, fp) >= KV8_THRESHOLD
    assert (pa.ragged_paged_attention.int8_launches,
            pa.paged_attention.int8_launches) == before
    assert _leak_free(eq) and eq.caches[0].quantized
    assert eq.caches[0].key_scale.any()
    fp_eng = ContinuousBatchingEngine(port, device="cpu", **kw)
    assert (fp_eng.caches[0].pool_bytes() / eq.caches[0].pool_bytes()
            >= 1.9)


@pytest.mark.slow
def test_kv8_vs_fp32_token_match_at_7b_widths():
    """At Llama-2-7B widths (2 layers, fp32, random weights) int8 KV
    storage itself moves greedy tokens, in the reference as in the port:
    32000 logits of std ~1.3 leave top-1 margins near 0.3, which the int8
    error crosses within a few tokens.  The reference's own engines show
    it with their own writes and their dequantizing attention, so r13's
    0.90 kv8 gate (set on a 1M-parameter model) cannot hold here for
    either.  The port's fp32 engine equals the reference's; its kv8
    engine's match against its fp32 engine stays within 0.1 of the
    reference's kv8-against-fp32 match.  (Measured on the CPU: 0.055 for
    both, request by request; ~6 GB and ~100 s.)"""
    from paddle_tpu.models.llama import llama_7b_config as ref_7b
    paddle.seed(0)
    cfg = ref_7b(num_hidden_layers=2)
    ref = RefLlama(cfg)
    ref.eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64)
               for n in (64, 200, 128, 320)]
    kw = dict(max_batch_size=4, block_size=16, num_blocks=96,
              max_seq_len=384, prefill_buckets="auto",
              prefill_chunk_size=256)

    def run(make, **extra):
        eng = make(**kw, **extra)
        rids = [eng.add_request(p, 32) for p in prompts[:2]]
        eng.step()
        rids += [eng.add_request(p, 32) for p in prompts[2:]]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref_fp = run(lambda **k: RefEngine(ref, **k))
    ref_q8 = run(lambda **k: RefEngine(ref, **k), kv_dtype="int8")
    port = LlamaForCausalLM(LlamaConfig(**{
        f: getattr(cfg, f) for f in LlamaConfig.__dataclass_fields__}),
        device="cpu")
    load_paddle_tpu_weights(port, {k: np.asarray(v._value)
                                   for k, v in ref.state_dict().items()})
    del ref

    def port_eng(**k):
        return ContinuousBatchingEngine(port, device="cpu", **k)
    fp = run(port_eng)
    q8 = run(port_eng, kv_dtype="int8")
    assert _match_rate(fp, ref_fp) >= 0.98
    ref_rate = _match_rate(ref_q8, ref_fp)
    assert ref_rate < KV8_THRESHOLD
    assert abs(_match_rate(q8, fp) - ref_rate) <= 0.1


def test_engine_construction_follows_reference(tiny_pair):
    _, port = tiny_pair
    eng = ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                   block_size=4, device="cpu")
    assert eng.mixed is None and eng.prefill_step is None
    assert eng.decode_step is not None
    with pytest.raises(ValueError, match="compiled prefill"):
        ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                 block_size=4, device="cpu",
                                 kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                 block_size=4, device="cpu",
                                 kv_dtype="int4")
    with pytest.raises(ValueError, match="top bucket"):
        ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                 block_size=4, device="cpu",
                                 prefill_buckets=(4, 8),
                                 prefill_chunk_size=16)
    eng = ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                   block_size=4, device="cpu",
                                   prefill_buckets="auto")
    assert eng.prefill_buckets == RefEngine._auto_buckets(eng.max_seq_len)


def test_dense_prefill_kv_and_prefill_scatter_match_reference(tiny_pair):
    """The dense prefill's cache-path K/V are [1, L, Hkv, D] before the GQA
    repeat with rope applied, and ``prefill_scatter`` writes them where the
    reference's does; it raises on int8 pools, as the reference does."""
    ref, port = tiny_pair
    ids = np.arange(1, 8, dtype=np.int64)[None]
    _, kv = port(torch.from_numpy(ids), [(None, None)] * 2)
    _, ref_kv = ref(paddle.to_tensor(ids), caches=[(None, None)] * 2)
    assert tuple(kv[0][0].shape) == (1, 7, 2, 16)
    caches = [pa.PagedKVCache(6, 4, 2, 16, sink_block=True, device="cpu")
              for _ in range(2)]
    ref_caches = [ref_pa.PagedKVCache(6, 4, 2, 16, sink_block=True)
                  for _ in range(2)]
    row = np.asarray([[3, 1, 6, 6]], np.int32)
    prefill_scatter(caches, kv, row)
    ref_ss.prefill_scatter(ref_caches, ref_kv, row)
    for c, rc in zip(caches, ref_caches):
        for a, b in ((c.key_cache, rc.key_cache),
                     (c.value_cache, rc.value_cache)):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-5)
    q8 = [pa.PagedKVCache(6, 4, 2, 16, sink_block=True, device="cpu",
                          kv_dtype="int8")]
    with pytest.raises(NotImplementedError, match="quantize"):
        prefill_scatter(q8, kv[:1], row)


def test_step_returns_requests_finished_during_admission(tiny_pair):
    """A one-token budget ends a request inside its dense prefill; the
    step that admitted it still returns its id."""
    _, port = tiny_pair
    eng = ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                   block_size=4, device="cpu")
    rid = eng.add_request(np.array([5, 6, 7], np.int64), 1)
    assert eng.step() == [rid]
    assert len(eng.result(rid)) == 1 and _leak_free(eng)
