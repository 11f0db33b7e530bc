"""The port's sampling epilogue (``paddle_tpu_torch/ops/sampling.py``)
against the reference's ``paddle_tpu.ops.sampling`` on the CPU, on the
same numpy inputs.

The port writes jax's threefry-2x32 in torch integer ops, so its keys,
bits and uniforms are the reference's bit for bit.  ``gumbel`` takes two
logs, which torch and XLA may round differently by an ulp: it is held to
2 fp32 ulps of ``max(|g|, 1)`` (an ulp of the inner log moves a draw near
0 by about 1e-7 absolute, many ulps of the draw itself).  The filters'
softmax and cumsum sum in another order: their probabilities are held to
1e-6 and the kept sets must be equal.  Tokens are equal on these seeds.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (x64 on, as the reference serves)
from paddle_tpu.ops import sampling as ref

from paddle_tpu_torch.ops import sampling as ps
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

t = torch.from_numpy
SEEDS = (0, 1, 12345, 2 ** 31 - 1)
TAGS = (0, 1, 2)


def _key_words(key):
    return np.array([int(key[0]) & 0xFFFFFFFF, int(key[1])], np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_bitwise_equal_jax(seed):
    """``prng_key``, ``fold_in`` (the reference's ``_row_key``) and the
    32-bit partitionable ``random_bits`` over counters 0..4096 and tags
    0-2, as uint32, equal jax's."""
    ctrs = np.arange(0, 4097, dtype=np.int32)
    for tag in TAGS:
        want = np.asarray(jax.vmap(lambda c: ref._row_key(
            jnp.int32(seed), c, tag))(jnp.asarray(ctrs)))
        k1, k2 = ps._row_key(torch.full((ctrs.size,), seed,
                                        dtype=torch.int32), t(ctrs), tag)
        got = np.stack([k1.numpy(), k2.numpy()], 1).astype(np.uint32)
        np.testing.assert_array_equal(got, want)
        for c in (0, 1, 777, 4096):
            key = ref._row_key(jnp.int32(seed), jnp.int32(c), tag)
            bits = np.asarray(jax.random.bits(key, (97,), jnp.uint32))
            kp = ps._row_key(torch.tensor([seed], dtype=torch.int32),
                             torch.tensor([c], dtype=torch.int32), tag)
            np.testing.assert_array_equal(
                ps.random_bits(kp, 97)[0].numpy().astype(np.uint32), bits)
    base = ps.prng_key(torch.tensor(seed, dtype=torch.int32))
    np.testing.assert_array_equal(
        _key_words(base), np.asarray(jax.random.PRNGKey(jnp.int32(seed))))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise_equal_jax(seed):
    """float32 uniforms (and with gumbel's ``minval``) and the verifier's
    float64 accept draw (x64 on: ``uniform`` without a dtype) equal
    jax's bit for bit."""
    tiny = float(np.finfo(np.float32).tiny)
    for c in (0, 5, 4096):
        for tag in TAGS:
            key = ref._row_key(jnp.int32(seed), jnp.int32(c), tag)
            kp = ps._row_key(torch.tensor([seed], dtype=torch.int32),
                             torch.tensor([c], dtype=torch.int32), tag)
            for lo in (0.0, tiny):
                want = np.asarray(jax.random.uniform(key, (257,),
                                                     jnp.float32, lo, 1.0))
                got = ps.uniform(kp, 257, minval=lo)[0].numpy()
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
            want64 = np.asarray(jax.random.uniform(key))
            assert want64.dtype == np.float64
            assert ps.uniform(kp, dtype=torch.float64)[0].item() \
                == float(want64)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps_of_jax(seed):
    """``gumbel`` over a 32000-token vocabulary within 2 fp32 ulps of
    ``max(|g|, 1)`` of jax's ("low" mode): the uniforms are bitwise and
    only the logs may round differently."""
    assert not jax.config.jax_high_dynamic_range_gumbel
    for c in (0, 4096):
        key = ref._row_key(jnp.int32(seed), jnp.int32(c), 0)
        want = np.asarray(jax.random.gumbel(key, (32000,), jnp.float32))
        kp = ps._row_key(torch.tensor([seed], dtype=torch.int32),
                         torch.tensor([c], dtype=torch.int32), 0)
        got = ps.gumbel(kp, 32000)[0].numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert (np.abs(got - want) <= 2 * ulp).all()


V = 64
KS = (0, 1, 5, V - 1, V)
PS = (0.0, 0.5, 0.95, 1.0)


def _tied_logits(rows, seed):
    """Logits rounded to 0.25 so that many tie (the filters' boundaries
    see ties)."""
    rng = np.random.RandomState(seed)
    return np.round(rng.randn(rows, V).astype(np.float32) * 8) / 4


def _knob_grid():
    ks, ps_ = np.meshgrid(np.asarray(KS, np.int32),
                          np.asarray(PS, np.float32), indexing="ij")
    return ks.reshape(-1), ps_.reshape(-1)


def test_filtered_probs_match_reference():
    """Every (k, p) of k in {0, 1, 5, V-1, V} and p in {0, 0.5, 0.95, 1}
    at three temperatures, on tied logits: the kept sets equal and the
    probabilities within 1e-6."""
    ks, p = _knob_grid()
    n = ks.size
    for temp in (0.5, 1.0, 2.0):
        lg = _tied_logits(n, 3)
        tt = np.full(n, temp, np.float32)
        want = np.asarray(ref.filtered_probs(jnp.asarray(lg),
                                             jnp.asarray(tt),
                                             jnp.asarray(ks),
                                             jnp.asarray(p)))
        got = ps.filtered_probs(t(lg), t(tt), t(ks), t(p)).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_logits_tokens_equal_reference(seed):
    """Sampled tokens equal the reference's over the (k, p) grid, greedy
    rows among them, at counters across the context, with and without
    any row filtering (both of the reference's branches)."""
    ks, p = _knob_grid()
    n = ks.size
    rng = np.random.RandomState(seed % 1000)
    lg = _tied_logits(n, seed % 1000 + 1)
    temps = rng.choice([0.0, 0.3, 0.8, 1.0, 2.5], n).astype(np.float32)
    seeds = (seed + np.arange(n)).astype(np.int64).astype(np.int32)
    ctrs = rng.randint(0, 4097, n).astype(np.int32)
    for kk, pp in ((ks, p), (np.zeros_like(ks), np.zeros_like(p))):
        want = np.asarray(ref.sample_logits(
            jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(kk),
            jnp.asarray(pp), jnp.asarray(seeds), jnp.asarray(ctrs)))
        got = ps.sample_logits(t(lg), t(temps), t(kk), t(pp), t(seeds),
                               t(ctrs)).numpy()
        np.testing.assert_array_equal(got, want)
        greedy = temps <= 0
        np.testing.assert_array_equal(got[greedy],
                                      lg[greedy].argmax(-1))


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_spec_verify_equals_reference(sampled):
    """``(n_acc, token)`` equal the reference's over spans with 0..K
    drafts, drafts copied from the target's argmax (long accepted chains,
    bonus tokens) or random, greedy and sampled rows mixed."""
    rng = np.random.RandomState(5)
    S, K = 24, 3
    lr = rng.randn(S, K + 1, V).astype(np.float32) * 2
    dt = rng.randint(0, V, (S, K)).astype(np.int32)
    dt[::2] = lr[::2, :K].argmax(-1)                # accepted greedily
    nd = rng.randint(0, K + 1, S).astype(np.int32)
    temps = rng.choice([0.0, 0.7, 1.0], S).astype(np.float32)
    ks = rng.choice([0, 5, V], S).astype(np.int32)
    pp = rng.choice([0.0, 0.9, 1.0], S).astype(np.float32)
    seeds = rng.randint(0, 2 ** 31 - 1, S).astype(np.int32)
    bp = rng.randint(0, 4000, S).astype(np.int32)
    q = None
    if sampled:
        q = np.asarray(ref.filtered_probs(
            jnp.asarray(lr[:, :K].reshape(-1, V) + rng.randn(S * K, V)
                        .astype(np.float32)),
            jnp.asarray(np.repeat(temps, K)), jnp.asarray(np.repeat(ks, K)),
            jnp.asarray(np.repeat(pp, K)))).reshape(S, K, V)
        q = q.astype(np.float32)
    args = (lr, dt, nd, temps, ks, pp, seeds, bp)
    want = ref.spec_verify(*map(jnp.asarray, args),
                           None if q is None else jnp.asarray(q))
    got = ps.spec_verify(*map(t, args), None if q is None else t(q))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[0].numpy() == nd).any()     # some chain accepted in full


def test_spec_verify_output_follows_p_chi_square():
    """At V = 8 the verifier's emitted token follows the target's filtered
    distribution ``p`` whatever the draft proposes: over 20000 rows with
    one draft token drawn from ``q``, accepted draft or correction
    together are chi-square consistent with ``p`` (the exactness of
    rejection resampling).  Takes well under 5 s."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    n, Vs = 20000, 8
    lp = rng.randn(Vs).astype(np.float32)
    lq = rng.randn(Vs).astype(np.float32)
    ones = torch.ones(n)
    zk = torch.zeros(n, dtype=torch.int32)
    p = ps.filtered_probs(t(lp)[None], ones[:1], zk[:1], ones[:1] * 0)[0]
    q = ps.filtered_probs(t(lq)[None], ones[:1], zk[:1], ones[:1] * 0)[0]
    seeds = torch.arange(n, dtype=torch.int32)
    base = torch.full((n,), 7, dtype=torch.int32)
    # the draft token: q's inverse CDF at a uniform of its own
    u = torch.from_numpy(rng.rand(n).astype(np.float32))
    draft = torch.searchsorted(torch.cumsum(q, 0), u).clamp(max=Vs - 1)
    rows = t(np.stack([lp, lp])).expand(n, 2, Vs)
    n_acc, tok = ps.spec_verify(rows, draft.to(torch.int32)[:, None],
                                torch.ones(n, dtype=torch.int32), ones, zk,
                                ones * 0, seeds, base,
                                q.expand(n, 1, Vs).contiguous())
    first = torch.where(n_acc > 0, draft.to(torch.int32), tok)
    counts = np.bincount(first.numpy(), minlength=Vs)
    expect = p.numpy().astype(np.float64) * n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # 7 degrees of freedom: P(chi2 > 24.32) = 0.001
    assert chi2 < 24.32, (chi2, counts, expect)
    assert time.perf_counter() - t0 < 5.0
