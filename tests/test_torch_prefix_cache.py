"""The port's prefix cache against the JAX reference, on the CPU.

Mirrors the reference's tier-1 prefix-cache tests (``test_serving.py``,
``test_serving_quant.py``, ``test_serving_sampling.py``,
``test_serving_migration.py``), each as a comparison with the reference
engine on the same weights (``testing/parity.py``): the tokens, the
counters of the cache (hits, misses, hit tokens, evictions, spills, host
hits, restores), each request's ``prefix_hit_tokens``, the cached page
set, every page's refcount and the free list must equal the reference's.
The free lists pop from the same end and eviction is LRU in both
packages, so the two engines hand out the same page ids.

The page moves (``copy_block``, ``extract_blocks``, ``inject_blocks``)
are compared bit for bit on seeded pools, bf16 pages as their 16-bit
patterns.  The int8-pool engines write bitwise the reference's codes and
scales, but read them through the int8 kernels' math where the
reference's CPU engine dequantizes, so their tokens are held to the port's
own cold int8 engine exactly and to the reference's at the kv8 gate.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.prefix_cache import HostPageTier as RefTier
from paddle_tpu.inference.prefix_cache import PrefixPageCache as RefCache
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import serving_step as ref_ss
from paddle_tpu.models.llama import llama_truncated_draft as ref_draft
from paddle_tpu.ops import paged_attention as ref_pa

from test_torch_split_serving import (CHURN_PROMPTS, KV8_THRESHOLD, TINY,
                                      _match_rate, _pair)
from paddle_tpu_torch.inference.prefix_cache import (HostPageTier,
                                                     PrefixPageCache,
                                                     _prefix_key)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import serving_step as ss
from paddle_tpu_torch.models.llama import llama_truncated_draft
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

P = np.array([5, 17, 42, 7, 99, 3, 11, 23], np.int64)     # 2 full pages
ENGINES = {"split": dict(prefill_buckets=(4, 8)),
           "mixed": dict(mixed_step=True, prefill_chunk_size=4)}


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(**TINY)


def _engines(pair, draft=False, **kw):
    """The reference's and the port's engine, built alike."""
    ref, port = pair
    rk, pk = dict(kw), dict(kw)
    if draft:
        rk["draft_model"] = ref_draft(ref, 1)
        pk["draft_model"] = llama_truncated_draft(port, 1)
    return RefEngine(ref, **rk), ContinuousBatchingEngine(port, device="cpu",
                                                          **pk)


def _state(eng):
    """Everything the two engines must agree on after a run."""
    c0 = eng.caches[0]
    pc = eng.prefix_cache
    return dict(
        tokens={r: q.output_ids for r, q in eng.finished.items()},
        hit_tokens={r: q.prefix_hit_tokens for r, q in eng.finished.items()},
        counters={a: getattr(pc, a) for a in (
            "hits", "misses", "hit_tokens", "evictions", "skipped_pinned",
            "spills", "host_hits", "restores")},
        cached=sorted(pc.cached_blocks()), refs=dict(c0._ref),
        free=list(c0._free))


def _leak_free(eng):
    """Every page free or held exactly once, by the prefix table."""
    c0 = eng.caches[0]
    cached = eng.prefix_cache.cached_blocks()
    return (all(c0.refcount(b) == 1 for b in cached)
            and len(c0._free) + len(cached) == c0.num_blocks)


def _generate(port, prompt, n):
    ids = torch.from_numpy(np.asarray(prompt, np.int64))[None]
    return port.generate(ids, n)[0, len(prompt):].tolist()


def _both(pair, script, draft=False, **kw):
    """Run ``script(eng)`` on both engines; their states must be equal.
    Returns the port's engine and what its script returned."""
    ref_eng, eng = _engines(pair, draft=draft, **kw)
    script(ref_eng)
    out = script(eng)
    assert _state(eng) == _state(ref_eng)
    assert _leak_free(eng)
    return eng, out


# ---------------------------------------------------------------------------
# engines against the reference's, token for token and page for page
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefix_cache_cow_refcounts_and_leak_free(tiny_pair, engine):
    """``test_serving.py::test_prefix_cache_cow_refcounts_and_leak_free``
    (split) and ``::test_mixed_prefix_cow_refcounts_and_leak_free``
    (mixed): B reuses A's two prompt pages and prefills its suffix, C (the
    same prompt as A) takes the whole-prompt hit and its copy-on-write;
    tokens equal eager ``generate``."""
    B = np.concatenate([P, [77, 8]])

    def script(eng):
        ra = eng.add_request(P, 4)
        eng.run_to_completion()
        rb = eng.add_request(B, 4)
        rc = eng.add_request(P, 4)
        eng.run_to_completion()
        return ra, rb, rc
    eng, (ra, rb, rc) = _both(tiny_pair, script, max_batch_size=2,
                              num_blocks=32, block_size=4,
                              enable_prefix_cache=True, **ENGINES[engine])
    port = tiny_pair[1]
    assert eng.result(ra) == eng.result(rc) == _generate(port, P, 4)
    assert eng.result(rb) == _generate(port, B, 4)
    pc = eng.prefix_cache
    assert (pc.misses, pc.hits, pc.hit_tokens) == (1, 2, 8 + 7)
    assert eng.finished[rb].prefix_hit_tokens == 8
    assert eng.finished[rc].prefix_hit_tokens == 7
    assert len(eng.caches[0]._free) < eng.caches[0].num_blocks
    assert eng.prefill_tokens == len(P) + 2 + 1


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefix_eviction_honors_refcounts(tiny_pair, engine):
    """``test_serving.py::test_prefix_eviction_honors_refcounts``: pool
    pressure evicts only the table pages no live request holds (Q's), P's
    pages stay while B shares them."""
    Q = np.array([9, 9, 8, 1, 66, 4, 12, 30], np.int64)
    B = np.concatenate([P, [77, 8]])
    R = np.arange(2, 34, 2, dtype=np.int64)

    def script(eng):
        eng.add_request(P, 2)
        eng.run_to_completion()
        eng.add_request(Q, 2)
        eng.run_to_completion()
        assert len(eng.prefix_cache) == 4
        rb = eng.add_request(B, 6)
        eng.step()
        assert eng.finished.get(rb) is None
        rr = eng.add_request(R, 8)
        eng.run_to_completion()
        return rb, rr
    eng, (rb, rr) = _both(tiny_pair, script, max_batch_size=2,
                          num_blocks=10, block_size=4, max_seq_len=24,
                          enable_prefix_cache=True, **ENGINES[engine])
    port = tiny_pair[1]
    assert eng.prefix_cache.evictions == 2
    assert eng.result(rb) == _generate(port, B, 6)
    assert eng.result(rr) == _generate(port, R, 8)
    assert eng.prefix_cache.match(P) != []


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_concurrent_divergent_suffixes_share_prefix(tiny_pair, engine):
    """``test_serving.py::test_concurrent_divergent_suffixes_share_prefix``:
    two hits admitted together decode divergent suffixes concurrently, one
    of them a chunked suffix at a page-aligned offset."""
    prompts = [np.concatenate([P, [77, 8]]),
               np.concatenate([P, [14, 50, 2]]),
               np.concatenate([P, [61, 5, 44, 9, 28, 33, 2, 71, 19, 90]])]

    def script(eng):
        r1 = eng.add_request(prompts[0], 5)
        eng.run_to_completion()
        rids = [r1] + [eng.add_request(p, 5) for p in prompts[1:]]
        eng.run_to_completion()
        return rids
    eng, rids = _both(tiny_pair, script, max_batch_size=3, num_blocks=64,
                      block_size=4, enable_prefix_cache=True,
                      **ENGINES[engine])
    port = tiny_pair[1]
    for rid, p in zip(rids, prompts):
        assert eng.result(rid) == _generate(port, p, 5)
    assert eng.prefix_cache.hits == 2


@pytest.mark.parametrize("sampled,lazy", [(False, False), (True, False),
                                          (True, True)],
                         ids=["greedy", "sampled", "sampled_lazy"])
def test_spec_prefix_cow_replay(tiny_pair, sampled, lazy):
    """The COW part of ``test_serving_sampling.py::
    test_spec_sampled_e2e_cow_truncation_quant``: the speculative engine
    with the cache; a whole-prompt hit (copy-on-write in the target's and
    the draft's pools) replays a cold run's tokens with the same seed; the
    streams and the pages equal the reference's.  With ``lazy_alloc`` the
    pages grown for rejected drafts go back through ``trim_blocks``
    without taking a reference from the table."""
    knobs = dict(temperature=1.1, seed=21) if sampled else {}

    def script(eng):
        ra = eng.add_request(P, 6, **knobs)
        eng.run_to_completion()
        rc = eng.add_request(P, 6, **knobs)
        eng.run_to_completion()
        eng.add_request(np.concatenate([P, [77, 8, 3]]), 6, **knobs)
        eng.run_to_completion()
        return ra, rc
    eng, (ra, rc) = _both(tiny_pair, script, draft=True, max_batch_size=2,
                          num_blocks=32, block_size=4, mixed_step=True,
                          prefill_chunk_size=4, sampling=sampled, spec_k=2,
                          enable_prefix_cache=True, lazy_alloc=lazy)
    assert eng.result(rc) == eng.result(ra)
    assert eng.finished[rc].prefix_hit_tokens == 7
    assert 0 < eng.spec_proposed
    assert all(len(c._free) == c.num_blocks for c in eng.draft_caches)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_add_request_n_shares_one_prefill(tiny_pair, engine):
    """``test_serving_sampling.py::test_add_request_n_shares_one_prefill``:
    ``n=3`` sampled generations share one prefill (the children admit as
    whole-prompt hits, 7 tokens), their streams equal the reference's,
    child ``i`` equals a solo request with seed ``3 + i`` on a fresh
    engine, greedy ``n=2`` gives identical streams, and nothing leaks."""
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4, sampling=True,
              enable_prefix_cache=True, **ENGINES[engine])

    def script(eng):
        rids = eng.add_request(P, 6, temperature=1.4, seed=3, n=3)
        eng.run_to_completion()
        g = eng.add_request(P, 4, n=2)
        eng.run_to_completion()
        return rids, g
    eng, (rids, g) = _both(tiny_pair, script, **kw)
    assert isinstance(rids, list) and len(rids) == 3
    outs = [eng.result(r) for r in rids]
    assert len({tuple(o) for o in outs}) > 1
    for rid in rids[1:]:
        assert eng.finished[rid].prefix_hit_tokens == 7
        assert eng.finished[rid].parent_req is eng.finished[rids[0]]
    assert eng.prefill_tokens == len(P) + 2 + 1 + 1
    assert eng.result(g[0]) == eng.result(g[1]) == _generate(
        tiny_pair[1], P, 4)
    for i in (1, 2):
        solo = ContinuousBatchingEngine(tiny_pair[1], device="cpu", **kw)
        r = solo.add_request(P, 6, temperature=1.4, seed=3 + i)
        solo.run_to_completion()
        assert solo.result(r) == outs[i]


# ---------------------------------------------------------------------------
# int8 pools
# ---------------------------------------------------------------------------
def test_kv8_cow_carries_scales_and_refcounts():
    """``test_serving_quant.py::test_kv8_cow_carries_scales_and_refcounts``:
    the same full int8 page written in both packages, then ``copy_block``;
    codes and scales bitwise equal to the reference's, and the copy
    dequantizes exactly as its source; the refcount audit."""
    rng = np.random.RandomState(0)
    bs, hkv, d = 4, 2, 8
    caches = [pa.PagedKVCache(8, bs, hkv, d, sink_block=True, device="cpu",
                              kv_dtype="int8") for _ in range(2)]
    refs = [ref_pa.PagedKVCache(8, bs, hkv, d, sink_block=True,
                                kv_dtype="int8") for _ in range(2)]
    src = caches[0].allocate_block()
    assert refs[0].allocate_block() == src
    blks = np.full((bs,), src, np.int32)
    offs = np.arange(bs, dtype=np.int32)
    for c, rc in zip(caches, refs):
        k, v = (rng.randn(bs, hkv, d).astype(np.float32) for _ in range(2))
        pa.write_ragged_kv_q8(torch.from_numpy(k), torch.from_numpy(v),
                              c.key_cache, c.value_cache, c.key_scale,
                              c.value_scale, torch.from_numpy(blks),
                              torch.from_numpy(offs))
        rc.key_cache, rc.value_cache, rc.key_scale, rc.value_scale = \
            ref_pa.write_ragged_kv_q8(jnp.asarray(k), jnp.asarray(v),
                                      rc.key_cache, rc.value_cache,
                                      rc.key_scale, rc.value_scale, blks,
                                      offs)
    dst = caches[0].allocate_block()
    assert refs[0].allocate_block() == dst
    ss.copy_block(caches, src, dst)
    ref_ss.copy_block(refs, src, dst)
    names = ("key_cache", "value_cache", "key_scale", "value_scale")
    for c, rc in zip(caches, refs):
        for name in names:
            np.testing.assert_array_equal(getattr(c, name).numpy(),
                                          np.asarray(getattr(rc, name)))
        torch.testing.assert_close(
            pa.dequant_pages(c.key_cache[dst], c.key_scale[dst]),
            pa.dequant_pages(c.key_cache[src], c.key_scale[src]),
            rtol=0, atol=0)
    # the whole-prompt hit re-runs the page's last position on the copy:
    # quantize-on-write with the copy's scale (one row below it, one that
    # raises it), bitwise the reference's, the source page untouched
    src_pages = [getattr(c, n)[src].clone() for c in caches for n in names]
    last = np.full((1,), bs - 1, np.int32)
    for growth in (0.5, 3.0):
        for c, rc in zip(caches, refs):
            k, v = ((rng.randn(1, hkv, d) * growth).astype(np.float32)
                    for _ in range(2))
            pa.write_ragged_kv_q8(
                torch.from_numpy(k), torch.from_numpy(v), c.key_cache,
                c.value_cache, c.key_scale, c.value_scale,
                torch.tensor([dst], dtype=torch.int32),
                torch.from_numpy(last))
            rc.key_cache, rc.value_cache, rc.key_scale, rc.value_scale = \
                ref_pa.write_ragged_kv_q8(
                    jnp.asarray(k), jnp.asarray(v), rc.key_cache,
                    rc.value_cache, rc.key_scale, rc.value_scale,
                    np.asarray([dst], np.int32), last)
            for name in names:
                np.testing.assert_array_equal(
                    getattr(c, name).numpy(), np.asarray(getattr(rc, name)))
    assert all(torch.equal(getattr(c, n)[src], p) for (c, n), p in zip(
        [(c, n) for c in caches for n in names], src_pages))
    c0 = caches[0]
    c0.share_blocks([src])
    c0.free_sequence([src])
    assert c0.refcount(src) == 1
    c0.free_sequence([src, dst])
    assert c0.refcount(src) == 0 and c0.refcount(dst) == 0
    assert sorted(c0._free) == list(range(c0.num_blocks))
    with pytest.raises(RuntimeError, match="not allocated"):
        c0.share_blocks([src])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_kv8_prefix_engine_pages_and_tokens(tiny_pair, engine):
    """The int8-pool engine with the cache on the COW traffic: the page
    bookkeeping equals the reference's; the published pages' codes and
    scales are bitwise what the publisher's prefill wrote (no later write
    lands in a shared page: the suffixes and the copy-on-write page go to
    private pages); the tokens equal the port's int8 engine without the
    cache and reach the kv8 gate against the reference's int8 engine."""
    B = np.concatenate([P, [77, 8]])
    kw = dict(max_batch_size=2, num_blocks=32, block_size=4,
              kv_dtype="int8", **ENGINES[engine])
    names = ("key_cache", "value_cache", "key_scale", "value_scale")

    def script(eng, snap=None):
        rids = [eng.add_request(P, 4)]
        eng.run_to_completion()
        if snap is not None:
            snap["blocks"] = sorted(eng.prefix_cache.cached_blocks())
            snap["pages"] = [getattr(c, n)[snap["blocks"]].clone()
                             for c in eng.caches for n in names]
        rids += [eng.add_request(B, 4), eng.add_request(P, 4)]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]
    ref_eng, eng = _engines(tiny_pair, enable_prefix_cache=True, **kw)
    want = script(ref_eng)
    snap = {}
    got = script(eng, snap)
    ref_state, state = _state(ref_eng), _state(eng)
    ref_state.pop("tokens"), state.pop("tokens")
    assert state == ref_state and _leak_free(eng)
    assert eng.finished[2].prefix_hit_tokens == 7
    assert len(snap["blocks"]) == 2
    now = [getattr(c, n)[snap["blocks"]] for c in eng.caches for n in names]
    assert all(torch.equal(a, b) for a, b in zip(now, snap["pages"]))
    cold = ContinuousBatchingEngine(tiny_pair[1], device="cpu", **kw)
    assert got == script(cold)
    assert _match_rate(got, want) >= KV8_THRESHOLD


# ---------------------------------------------------------------------------
# page moves and the host tier
# ---------------------------------------------------------------------------
def _seeded_pools(kv_dtype, layers=3, nb=8, bs=4, hkv=2, d=8, seed=7):
    """The same seeded pools in both packages (fp32, bf16 or int8 codes
    with positive scales)."""
    rng = np.random.RandomState(seed)
    port = [pa.PagedKVCache(nb, bs, hkv, d, sink_block=True, device="cpu",
                            kv_dtype=kv_dtype) for _ in range(layers)]
    ref = [ref_pa.PagedKVCache(nb, bs, hkv, d, sink_block=True,
                               kv_dtype=kv_dtype) for _ in range(layers)]
    for c, rc in zip(port, ref):
        names = ["key_cache", "value_cache"]
        if c.quantized:
            names += ["key_scale", "value_scale"]
        for name in names:
            shape = tuple(getattr(c, name).shape)
            if name.endswith("scale"):
                a = (rng.rand(*shape) + 0.1).astype(np.float32)
            elif c.quantized:
                a = rng.randint(-127, 128, shape).astype(np.int8)
            else:
                a = rng.randn(*shape).astype(np.float32)
            t = torch.from_numpy(a).to(getattr(c, name).dtype)
            getattr(c, name).copy_(t)
            setattr(rc, name, jnp.asarray(a).astype(
                getattr(rc, name).dtype))
    return port, ref


def _bits(a):
    """A host array as comparable bits (bf16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _pool_bits(caches, name):
    """One pool of each layer as comparable bits (bf16 as uint16)."""
    return [_bits(getattr(c, name).view(torch.int16).numpy()
                  if getattr(c, name).dtype == torch.bfloat16
                  else getattr(c, name).numpy()).copy() for c in caches]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_page_moves_bitwise_equal_reference(kv_dtype):
    """``copy_block``, ``extract_blocks`` and ``inject_blocks`` on seeded
    pools: the pools after a copy, and the buffer's codes and scales,
    bitwise the reference's; one host copy per dtype each way; a round
    trip into fresh pages restores them bitwise; a buffer of another
    ``kv_dtype`` or page count raises the reference's ``ValueError``."""
    port, ref = _seeded_pools(kv_dtype)
    ss.copy_block(port, 2, 5)
    ref_ss.copy_block(ref, 2, 5)
    names = ["key_cache", "value_cache"] + (
        ["key_scale", "value_scale"] if kv_dtype == "int8" else [])
    for name in names:
        for a, rc in zip(_pool_bits(port, name), ref):
            np.testing.assert_array_equal(a, _bits(getattr(rc, name)))
    ids = [6, 1, 3]
    t0 = ss.migration_transfers()
    buf = ss.extract_blocks(port, ids, n_tokens=10)
    per_dtype = 2 if kv_dtype == "int8" else 1
    assert ss.migration_transfers()["d2h"] == t0["d2h"] + per_dtype
    want = ref_ss.extract_blocks(ref, ids, n_tokens=10)
    np.testing.assert_array_equal(_bits(buf.codes), _bits(want.codes))
    assert (buf.scales is None) == (want.scales is None)
    if buf.scales is not None:
        np.testing.assert_array_equal(buf.scales, want.scales)
    assert buf.geometry() == want.geometry() and buf.nbytes == want.nbytes
    assert (buf.n_pages, buf.n_tokens) == (want.n_pages, want.n_tokens)
    before = {n: _pool_bits(port, n) for n in names}
    ss.inject_blocks(port, buf, [0, 4, 7])
    assert ss.migration_transfers()["h2d"] == t0["h2d"] + per_dtype
    for name in names:
        for a, b in zip(_pool_bits(port, name), before[name]):
            np.testing.assert_array_equal(a[[0, 4, 7]], b[ids])
            rest = [i for i in range(a.shape[0]) if i not in (0, 4, 7)]
            np.testing.assert_array_equal(a[rest], b[rest])
    other = "int8" if kv_dtype != "int8" else "float32"
    wrong, ref_wrong = _seeded_pools(other)
    with pytest.raises(ValueError, match="kv_dtype"):
        ss.inject_blocks(wrong, buf, [0, 1, 2])
    with pytest.raises(ValueError, match="kv_dtype"):
        ref_ss.inject_blocks(ref_wrong, want, [0, 1, 2])
    with pytest.raises(ValueError, match="destination"):
        ss.inject_blocks(port, buf, [0])


def test_prefix_key_is_the_reference_digest():
    from paddle_tpu.inference.prefix_cache import _prefix_key as ref_key
    prompt = np.random.RandomState(1).randint(0, 32000, 40)
    for end in (4, 16, 40):
        assert _prefix_key(prompt, end) == ref_key(prompt, end)


def test_host_tier_spill_restore_stub_pools():
    """``test_serving_migration.py::test_host_tier_spill_restore_stub_pools``
    on both packages' pools: eviction spills in one batched extract, a
    later ``match`` restores the chain bitwise in one batched inject,
    pinned entries are skipped and counted, the byte cap bounds the tier;
    every count equal to the reference's."""
    port, ref = _seeded_pools(None, layers=2, nb=4, seed=13)
    bs = 4
    prompt = np.random.RandomState(3).randint(1, 100, 2 * bs).astype(
        np.int64)
    runs = []
    for caches, Tier, Cache in ((ref, RefTier, RefCache),
                                (port, HostPageTier, PrefixPageCache)):
        tier = Tier(1 << 20)
        pc = Cache(caches[0], bs, all_caches=caches, host_tier=tier)
        ids = [caches[0].allocate_block() for _ in range(2)]
        snap = [_bits(np.asarray(c.key_cache)[ids]) if Cache is RefCache
                else _pool_bits([c], "key_cache")[0][ids] for c in caches]
        pc.register(prompt, ids)
        caches[0].free_sequence(ids)
        n_evicted = pc.evict(2)
        after_spill = (pc.spills, len(tier), len(caches[0]._free))
        blocks = pc.match(prompt)
        restored = [_bits(np.asarray(c.key_cache)[blocks])
                    if Cache is RefCache
                    else _pool_bits([c], "key_cache")[0][blocks]
                    for c in caches]
        for a, b in zip(restored, snap):
            np.testing.assert_array_equal(a, b)
        counts = (n_evicted, after_spill, blocks, pc.host_hits, pc.restores,
                  len(tier), [caches[0].refcount(b) for b in blocks])
        caches[0].share_blocks([blocks[0]])
        counts += (pc.evict(2), pc.skipped_pinned)
        caches[0].free_sequence([blocks[0]])
        small = Tier(2 * bs * 2 * 8 * 4 * len(caches) + 64)
        pc2 = Cache(caches[0], bs, all_caches=caches, host_tier=small)
        ids2 = [caches[0].allocate_block() for _ in range(2)]
        pc2.register(prompt + 1, ids2)
        caches[0].free_sequence(ids2)
        pc2.evict(2)
        counts += (len(small), small.tier_evictions,
                   small.bytes <= small.capacity_bytes)
        runs.append(counts)
    assert runs[0] == runs[1]
    assert runs[1][:2] == (2, (2, 2, 4))
    assert runs[1][-3:] == (1, 1, True)


def test_host_tier_hit_rate_under_pressure(tiny_pair):
    """``test_serving_migration.py::test_host_tier_hit_rate_under_pressure``:
    four prompt families in two waves through a 6-page pool, with and
    without a host tier; the second wave's hit rate with the tier beats
    the one without; tokens, spills, restores and host hits equal the
    reference's, and the restored prefixes give eager ``generate``'s
    tokens."""
    ref, port = tiny_pair
    rng = np.random.RandomState(7)
    V = port.config.vocab_size
    families = [rng.randint(1, V, (8,)).astype(np.int64) for _ in range(4)]
    suffixes = [rng.randint(1, V, (4, 3)).astype(np.int64)
                for _ in range(2)]

    def waves(eng):
        rates, outs = [], []
        for wave in range(2):
            h0, m0 = eng.prefix_cache.hits, eng.prefix_cache.misses
            for i, fam in enumerate(families):
                prompt = np.concatenate([fam, suffixes[wave][i]])
                rid = eng.add_request(prompt, max_new_tokens=4)
                eng.run_to_completion()
                outs.append((prompt, eng.result(rid)))
            h, m = eng.prefix_cache.hits - h0, eng.prefix_cache.misses - m0
            rates.append(h / max(1, h + m))
        return rates[1], outs

    rate = {}
    for tier in (1 << 22, 0):
        eng, (rate[tier], outs) = _both(
            (ref, port), waves, max_batch_size=2, num_blocks=6,
            block_size=4, max_seq_len=16, mixed_step=True,
            prefill_chunk_size=8, enable_prefix_cache=True,
            host_tier_bytes=tier)
        if tier:
            pc = eng.prefix_cache
            assert pc.spills > 0 and pc.restores > 0
            assert pc.host_hits >= pc.restores
            for prompt, out in outs[4:6]:
                assert out == _generate(port, prompt, 4)
    assert rate[1 << 22] > rate[0]


# ---------------------------------------------------------------------------
# construction, requests and explicit token budgets
# ---------------------------------------------------------------------------
PREFIX_ERRORS = {
    "host tier without the cache": (
        dict(mixed_step=True, host_tier_bytes=1 << 20), "spill tier"),
    "host tier with a draft model": (
        dict(mixed_step=True, enable_prefix_cache=True,
             host_tier_bytes=1 << 20, draft=True), "speculative"),
    "cache without a compiled prefill": (
        dict(enable_prefix_cache=True), "bucketed prefill"),
    "top budget below an all-decode pack": (
        dict(mixed_step=True, token_budgets=(2, 3)), "all-decode"),
}


@pytest.mark.parametrize("case", sorted(PREFIX_ERRORS))
def test_construction_errors_follow_reference(tiny_pair, case):
    kw, match = PREFIX_ERRORS[case]
    kw = dict(kw, max_batch_size=4, num_blocks=16, block_size=4)
    draft = kw.pop("draft", False)
    ref, port = tiny_pair
    with pytest.raises(ValueError, match=match):
        RefEngine(ref, draft_model=ref_draft(ref, 1) if draft else None,
                  **kw)
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(
            port, device="cpu",
            draft_model=llama_truncated_draft(port, 1) if draft else None,
            **kw)


def test_add_request_n_errors_follow_reference(tiny_pair):
    """``n > 1`` without the cache raises the reference's ValueError and
    ``n = 0`` its other one; nothing is queued."""
    for eng in _engines(tiny_pair, max_batch_size=2, num_blocks=16,
                        block_size=4, mixed_step=True, sampling=True):
        with pytest.raises(ValueError, match="enable_prefix_cache"):
            eng.add_request(P, 2, n=2)
        with pytest.raises(ValueError, match="n must be"):
            eng.add_request(P, 2, n=0)
        assert not eng.waiting


def test_explicit_token_budgets_match_reference(tiny_pair):
    """An explicit ``token_budgets`` tuple: the sorted set of its values,
    as the reference keeps it; the churn's tokens and the budgets seen
    equal the reference engine's."""
    budgets = (16, 4, 8, 8)

    def churn(eng):
        r0 = eng.add_request(CHURN_PROMPTS[0], 4)
        eng.step()
        rids = [r0] + [eng.add_request(p, 4) for p in CHURN_PROMPTS[1:]]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]
    ref_eng, eng = _engines(tiny_pair, max_batch_size=4, num_blocks=64,
                            block_size=4, mixed_step=True,
                            prefill_chunk_size=4, token_budgets=budgets)
    assert eng.token_budgets == ref_eng.token_budgets == (4, 8, 16)
    assert churn(eng) == churn(ref_eng)
    assert sorted(eng.mixed.compile_counts) == sorted(
        ref_eng.mixed.compile_counts)
    assert set(eng.mixed.compile_counts) <= set(budgets)
