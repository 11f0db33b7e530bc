"""The port's kernel modules against the JAX reference, on the CPU.

Each wrapper takes its plain PyTorch version for CPU tensors; these tests
hold those plain versions against the reference's XLA functions (the
Pallas kernels' own references) on the same numpy inputs.  The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``
(marked ``cuda``) compares them with the plain versions there, and
``chip_smoke.py`` does so at the serving shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (reference; turns x64 on)
from paddle_tpu.ops import paged_attention as ref_pa
from paddle_tpu.ops import pallas_kernels as ref_pk

from paddle_tpu_torch.ops import kernels as pk
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


def _rope_inputs(seed=0, N=37, H=4, Hkv=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, H, D).astype(np.float32)
    k = rng.randn(N, Hkv, D).astype(np.float32)
    v = rng.randn(N, Hkv, D).astype(np.float32)
    pos = rng.randint(0, 4096, N).astype(np.int32)
    cos, sin = ref_pk.rope_tables_for_positions(jnp.asarray(pos), D,
                                                10000.0)
    return q, k, v, pos, np.array(cos), np.array(sin)


@pytest.mark.parametrize("with_amax", [False, True])
def test_rope_epilogue_plain_bitwise_equals_reference(with_amax):
    """Same numpy cos/sin fed to both: every output equal bit for bit."""
    q, k, v, _, cos, sin = _rope_inputs()
    want = ref_pk._rope_qkv_epilogue_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos),
        jnp.asarray(sin), with_amax)
    got = pk._rope_qkv_epilogue_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cos), torch.from_numpy(sin), with_amax)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("with_amax", [False, True])
def test_rope_epilogue_wrapper_takes_plain_on_cpu(with_amax):
    q, k, v, _, cos, sin = _rope_inputs(seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v, cos, sin)]
    before = pk.rope_qkv_epilogue.launches
    got = pk.rope_qkv_epilogue(*args, with_amax=with_amax)
    want = pk._rope_qkv_epilogue_plain(*args, with_amax)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    assert pk.rope_qkv_epilogue.launches == before


@pytest.mark.parametrize("D", [16, 64, 128])
def test_rope_tables_within_one_ulp_of_reference(D):
    pos = np.random.RandomState(2).randint(0, 8192, 257).astype(np.int32)
    want = ref_pk.rope_tables_for_positions(jnp.asarray(pos), D, 10000.0)
    got = pk.rope_tables_for_positions(torch.from_numpy(pos), D, 10000.0)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == (257, D)
        ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)))
        assert (np.abs(g - w) <= ulp).all()


# each case: [(q_len, kv_len)] spans (kv_len includes the span) + the
# number of trailing padding spans (q_len 0, kv_len 1, all-sink table)
RAGGED_CASES = {
    "decode_only": ([(1, 5), (1, 9), (1, 1), (1, 16)], 0),
    "fresh_chunk_and_decode": ([(6, 6), (1, 7)], 0),
    "mid_prompt_chunk": ([(4, 12), (8, 8), (1, 3)], 0),
    "ragged_mix": ([(3, 11), (1, 13), (5, 5), (2, 10)], 0),
    "prefix_offset_span": ([(8, 16), (3, 14)], 0),
    "padding_spans": ([(1, 6), (7, 15)], 2),
}


def _ragged_pack(spans, n_pad, H, Hkv, D, bs=4, nb=64, seed=42):
    """Random pools, a table per span with its unused entries aimed at a
    poison page, padding spans as the engine writes them.  Returns the
    numpy pack plus the poisoned pools (every page no span uses is NaN)."""
    rng = np.random.RandomState(seed)
    kc = rng.randn(nb + 1, bs, Hkv, D).astype(np.float32)
    vc = rng.randn(nb + 1, bs, Hkv, D).astype(np.float32)
    sink = nb
    W = max(2, max(-(-kv // bs) for _, kv in spans))
    cache = ref_pa.PagedKVCache(nb, bs, Hkv, D)
    poison = cache.allocate_block()
    used = set()
    rows = []
    for _, kv_len in spans:
        tab = cache.build_block_table([kv_len], max_blocks=W)[0]
        n = -(-kv_len // bs)
        used.update(int(b) for b in tab[:n])
        tab[n:] = poison
        rows.append(tab)
    rows += [np.full((W,), sink, np.int32)] * n_pad
    bt = np.stack(rows).astype(np.int32)
    T = sum(q for q, _ in spans) + 3          # 3 budget-padding tokens
    q = rng.randn(T, H, D).astype(np.float32)
    q_off, off = [], 0
    for q_len, _ in spans:
        q_off.append(off)
        off += q_len
    q_off = np.asarray(q_off + [T] * n_pad, np.int32)
    q_len = np.asarray([a for a, _ in spans] + [0] * n_pad, np.int32)
    kv_len = np.asarray([b for _, b in spans] + [1] * n_pad, np.int32)
    unused = sorted(set(range(nb + 1)) - used - {sink}) + [poison]
    kc_p, vc_p = kc.copy(), vc.copy()
    kc_p[unused] = np.nan
    vc_p[unused] = np.nan
    return q, kc, vc, kc_p, vc_p, bt, q_off, q_len, kv_len


def _check_ragged_plain(case, heads, D):
    """Valid rows within 1e-5 of the reference's XLA path; the port runs
    on pools whose unused pages are NaN, so any read past a span's used
    pages would show."""
    spans, n_pad = RAGGED_CASES[case]
    H, Hkv = heads
    q, kc, vc, kc_p, vc_p, bt, q_off, q_len, kv_len = _ragged_pack(
        spans, n_pad, H, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(ref_pa._ragged_attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(q_off), jnp.asarray(q_len), jnp.asarray(kv_len), scale))
    t = torch.from_numpy
    before = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(
        t(q), t(kc_p), t(vc_p), t(bt), t(q_off), t(q_len), t(kv_len),
        scale, span_q=int(q_len.max())).numpy()
    assert pa.ragged_paged_attention.launches == before
    valid = np.zeros(len(q), bool)
    for off, n in zip(q_off, q_len):
        valid[off:off + n] = True
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)
    assert (got[~valid] == 0).all()          # padding rows are defined


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_attention_plain_matches_reference(case, heads):
    """At head dim 16 (see :func:`_check_ragged_plain`)."""
    _check_ragged_plain(case, heads, 16)


@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("case", ["padding_spans", "ragged_mix"])
def test_ragged_attention_plain_matches_reference_at_head_dims(case, heads,
                                                               D):
    """The head dims the card's kernels take beyond 64 and 128: 32 (the
    tiny config's) and 96 (see :func:`_check_ragged_plain`)."""
    _check_ragged_plain(case, heads, D)


# spans as (q_len, kv_len): chunk spans, decode spans and padding spans
_WORK_SPANS = [(256, 1024), (1, 700), (0, 1), (130, 130), (1, 5), (0, 1)]


def _decode_items(work):
    """(span, split, n_split) of the decode items of a work list."""
    dec = work[(work & pa.RAGGED_DECODE) != 0]
    code = dec & 0xFFFF
    return [(int(s), int(c & 0x7F), int(((c & 0x7FFF) >> 7) + 1))
            for s, c in zip(dec >> 16, code)]


@pytest.mark.parametrize("heads", [(32, 32), (32, 8), (48, 4)],
                         ids=["mha", "gqa4", "gqa12"])
def test_ragged_work_list(heads):
    """The tensor-core kernel's work list: chunk spans cut into tiles of
    ``RAGGED_TILE_Q`` query vectors (rows x groups), listed first, then
    the decode spans; padding spans get none.  Decode items need at most
    8 groups and pages of at most 32 keys (otherwise a one-row span is a
    chunk item); while the blocks would not give each of the card's 132
    SMs one, a long decode span is split into consecutive items of at
    least 8 pages, in split order."""
    H, Hkv = heads
    G = H // Hkv
    q_lens = np.array([a for a, _ in _WORK_SPANS], np.int32)
    kv_lens = np.array([b for _, b in _WORK_SPANS], np.int32)
    work = pa.ragged_work(q_lens, kv_lens, H, Hkv, 16)
    assert work.dtype == np.int32
    decode = (work & pa.RAGGED_DECODE) != 0
    n_dec = int(decode.sum())
    assert decode[len(work) - n_dec:].all()      # chunk items first
    want_chunk = [(s, t) for s, ql in enumerate(q_lens) if ql > 1 or
                  (ql == 1 and G > 8)
                  for t in range(-(-ql * G // pa.RAGGED_TILE_Q))]
    got_chunk = list(zip((work >> 16)[~decode], (work & 0xFFFF)[~decode]))
    assert got_chunk == want_chunk
    items = _decode_items(work)
    if G > 8:
        assert items == []
        return
    assert sorted({s for s, _, _ in items}) == [1, 4]
    blocks = (len(want_chunk) + 2) * Hkv
    for s in (1, 4):
        splits = [(i, n) for t, i, n in items if t == s]
        n = splits[0][1]
        assert splits == [(i, n) for i in range(n)]    # consecutive, in order
        pages = -(-kv_lens[s] // 16)
        if blocks >= 132 or pages < 16:
            assert n == 1
        else:
            assert 1 < n <= pages // 8
    # pages of more than 32 keys: one-row spans run as chunk items
    wide = pa.ragged_work(q_lens, kv_lens, H, Hkv, 64)
    assert not ((wide & pa.RAGGED_DECODE) != 0).any()


@pytest.mark.parametrize("bs", [4, 5, 8, 16, 32, 64])
def test_ragged_tensor_core_routing(bs):
    """Which ragged kernel a call takes on the card: bf16 q runs the
    tensor-core kernel over bf16 pools at any block size and head dim,
    over int8 pools at block sizes that are multiples of 8 dividing 64 and
    head dims that are multiples of 16; fp32 q the CUDA-core kernel."""
    for D in (128, 80, 40):
        assert pa.ragged_tensor_cores(torch.bfloat16, False, bs, D)
        assert pa.ragged_tensor_cores(torch.bfloat16, True, bs, D) == (
            bs in (8, 16, 32, 64) and D % 16 == 0)
        assert not pa.ragged_tensor_cores(torch.float32, False, bs, D)
        assert not pa.ragged_tensor_cores(torch.float32, True, bs, D)


def test_write_ragged_kv_matches_reference_scatter():
    rng = np.random.RandomState(7)
    phys, bs, Hkv, D, T = 6, 4, 2, 8, 9
    kc = rng.randn(phys, bs, Hkv, D).astype(np.float32)
    vc = rng.randn(phys, bs, Hkv, D).astype(np.float32)
    k_new = rng.randn(T, Hkv, D).astype(np.float32)
    v_new = rng.randn(T, Hkv, D).astype(np.float32)
    blocks = np.asarray([0, 0, 1, 3, 3, 3, 5, 2, 4], np.int32)
    offs = np.asarray([0, 1, 3, 0, 1, 2, 3, 2, 0], np.int32)
    wk, wv = ref_pa.write_ragged_kv(
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(blocks), jnp.asarray(offs))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pa.write_ragged_kv(torch.from_numpy(k_new), torch.from_numpy(v_new),
                       tk, tv, torch.from_numpy(blocks).long(),
                       torch.from_numpy(offs).long())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_paged_cache_free_list_and_refcounts_match_reference():
    ref = ref_pa.PagedKVCache(8, 4, 2, 8, sink_block=True)
    got = pa.PagedKVCache(8, 4, 2, 8, sink_block=True, device="cpu")
    assert tuple(got.key_cache.shape) == tuple(ref.key_cache.shape)
    assert got.sink == ref.sink == 8
    a = [got.allocate_block() for _ in range(3)]
    b = [ref.allocate_block() for _ in range(3)]
    assert a == b
    got.free_sequence(a[:2] + [got.sink])
    ref.free_sequence(b[:2] + [ref.sink])
    assert got._free == ref._free
    assert got.refcount(a[2]) == ref.refcount(b[2]) == 1
    assert got.refcount(a[0]) == ref.refcount(b[0]) == 0
    assert got.blocks_needed(9) == ref.blocks_needed(9) == 3
