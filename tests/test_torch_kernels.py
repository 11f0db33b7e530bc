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


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_attention_plain_matches_reference(case, heads):
    """Valid rows within 1e-5 of the reference's XLA path; the port runs
    on pools whose unused pages are NaN, so any read past a span's used
    pages would show."""
    spans, n_pad = RAGGED_CASES[case]
    H, Hkv = heads
    D = 16
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
