"""Token sampling of the serving steps (counterpart of
``paddle_tpu/ops/sampling.py``): greedy argmax, per-request temperature
/ top-k / top-p with a seeded counter-based generator, and the
speculative verifier.

Determinism contract, as in the reference: every random draw is keyed
``fold_in(fold_in(prng_key(seed), position), stream_tag)``, where
``position`` is the global sequence index of the token being sampled and
``seed`` the request's.  The key depends on nothing but the request's
own progress, so a sampled request gives the same tokens alone or
batched, through the split or the mixed engine.  The generator is jax's
threefry-2x32 (``jax/_src/prng.py``) written in torch integer ops, so the
draws are the reference's bit for bit: ``prng_key`` is
``jax.random.PRNGKey`` of an int32 seed, ``fold_in`` is
``jax.random.fold_in``, ``random_bits`` is the partitionable 32-bit draw
(``jax_threefry_partitionable``, on in the reference's jax), ``uniform``
and ``gumbel`` are ``jax.random``'s ``_uniform`` and ``_gumbel`` (its
"low" mode).  uint32 values live in int64 tensors masked to 32 bits
(torch's uint32 has few CUDA operators).  ``gumbel``'s logs are torch's,
which may round a last bit differently from XLA's.

The reference runs with x64 on, so its ``uniform`` without a dtype (the
verifier's accept draw) is float64; :func:`spec_verify` draws float64
there too.  Everything else is fp32; ``temperature <= 0`` rows take the
exact argmax.  The reference computes this epilogue in XLA, not in a
Pallas kernel, so it runs here as plain PyTorch on the logits' device.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["greedy_sample", "sample_logits", "filtered_probs",
           "spec_verify", "DRAFT_SEED_XOR", "prng_key", "fold_in",
           "threefry2x32", "random_bits", "uniform", "gumbel"]

# RNG stream tags: one counter (the token position) feeds three
# independent streams, so the draft's proposal draw, the verifier's accept
# draw and the rejection-resample draw never correlate
_TAG_PROPOSE = 0
_TAG_ACCEPT = 1
_TAG_RESIDUAL = 2

# the engine XORs draft-span seeds with this (on the host, int32-safe), so
# a self-speculative draft (same weights) still proposes from a stream
# independent of the target's
DRAFT_SEED_XOR = 0x5EED

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = 1.1754943508222875e-38      # float32's smallest normal


def _u32(x):
    """``x`` as uint32 values: an int64 tensor for a tensor, a Python int
    for an int (two's complement for negative int32 values, as jax's
    conversion to uint32 does).  An int stays on the host: a device
    tensor made from it would be a copy from pageable memory, which waits
    for the device's queue."""
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x).to(torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry-2x32 hash of jax (20 rounds, ``_threefry2x32_lowering``)
    on uint32 values held in int64 tensors, elementwise with broadcasting:
    key ``(k1, k2)``, counts ``(x1, x2)``; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed):
    """``jax.random.PRNGKey`` of int32 seeds (a tensor of any shape): the
    key words ``(0, seed as uint32)`` — an int32 seed shifted right by 32
    gives 0, as the reference's int32 pack lanes give it."""
    k2 = _u32(seed)
    return torch.zeros_like(k2), k2


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for int32 or uint32 ``data``
    (broadcast against the key): the hash of the counts ``(0, data)``."""
    k1, k2 = key
    return threefry2x32(k1, k2, 0, _u32(data))


def _row_key(seeds, counters, tag: int):
    """The reference's ``_row_key`` for rows of seeds and counters:
    ``fold_in(fold_in(prng_key(seed), counter), tag)``."""
    key = fold_in(prng_key(seeds), counters)
    return fold_in(key, tag)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (32-bit, partitionable): the hash of
    the counts ``(0, i)`` for i < n, its words XORed.  ``key`` words of
    shape ``[...]`` give ``[..., n]``."""
    k1, k2 = (k[..., None] for k in key)
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    return b1 ^ b2


def uniform(key, n: Optional[int] = None,
            dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: ``n`` values per key (``None``: one, the
    key's shape) in ``[minval, maxval)``.  float32 keeps the top 23 bits
    of a 32-bit draw as the mantissa of a value in [1, 2); float64 the top
    52 of the 64-bit draw ``(hi << 32) | lo`` of one count."""
    k1, k2 = key
    if dtype == torch.float64:
        if n is not None:
            raise ValueError("uniform: float64 draws one value per key")
        hi, lo = threefry2x32(k1, k2, 0, 0)
        # ((hi << 32) | lo) >> 12, kept below 2^63
        bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
        floats = bits.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        bits = (random_bits(key, 1)[..., 0] if n is None
                else random_bits(key, n))
        floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
                  .view(torch.float32) - 1.0)
    else:
        raise ValueError("uniform: float32 or float64, got %s" % dtype)
    # maxval - minval rounds to the same value in Python's float64 as in
    # the dtype for the ranges used here ([0, 1) and [tiny, 1)): 1.0
    return torch.clamp_min(floats * (maxval - minval) + minval, minval)


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` ("low" mode):
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    u = uniform(key, n, torch.float32, minval=_F32_TINY)
    return -torch.log(-torch.log(u))


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary of each row ``[rows, V]`` in fp32 (the
    first maximum on ties, as ``jnp.argmax``), as int32."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``
    (``-inf`` entries give 0)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _filter_rows(l, t, k, p):
    """Rows ``[..., V]`` fp32 logits -> tempered, top-k / top-p masked
    rows (``-inf`` outside the kept set), each row with its own knobs
    ``t``/``k``/``p`` of shape ``[...]`` (the reference's ``_filter_row``
    vmapped).  ``k <= 0`` disables top-k; ``p`` outside (0, 1) disables
    top-p.  The best token is always kept.  One sort serves both filters:
    the top-k mask removes a suffix of the descending order, so the masked
    row is still sorted and the nucleus cumsum reads it directly."""
    V = l.shape[-1]
    lt = l / torch.clamp_min(t, 1e-6)[..., None]
    desc = torch.sort(lt, dim=-1, descending=True).values
    kk = torch.clamp(k, 1, V).to(torch.int64)
    use_k = (k > 0) & (k < V)
    ninf = torch.full((), float("-inf"), device=l.device)
    k_thr = torch.where(use_k, torch.gather(desc, -1, (kk - 1)[..., None]
                                            )[..., 0], ninf)
    rank = torch.arange(V, device=l.device)
    desc_m = torch.where(use_k[..., None] & (rank >= kk[..., None]), ninf,
                         desc)
    # nucleus over the tempered, top-k-masked distribution: keep the
    # smallest prefix (in descending order) whose mass reaches p
    probs = _softmax(desc_m)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p[..., None]
    use_p = (p > 0.0) & (p < 1.0)
    inf = torch.full((), float("inf"), device=l.device)
    p_thr = torch.where(use_p, torch.where(keep, desc_m, inf).amin(dim=-1),
                        ninf)
    thr = torch.maximum(k_thr, p_thr)[..., None]
    return torch.where(lt < thr, ninf, lt)


def sample_logits(logits, temps, top_ks, top_ps, seeds, counters
                  ) -> torch.Tensor:
    """Sample one token per row (the steps' epilogue): ``logits`` [S, V];
    ``temps``/``top_ps`` [S] fp32; ``top_ks``/``seeds``/``counters`` [S]
    int32 (``counters`` = the global position of the token being
    sampled).  Returns the [S] int32 tokens; rows with ``temperature <=
    0`` take the exact greedy argmax.

    Every row goes through the filters: a row that filters nothing keeps
    its tempered logits bit for bit (the reference skips the sort pass
    when no row filters, with the same division expression in both of
    its branches, so the tokens are the same either way), and the step
    never waits on the device to decide."""
    lf = logits.to(torch.float32)
    V = lf.shape[-1]
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    lt = _filter_rows(lf, temps, top_ks, top_ps)
    g = gumbel(_row_key(seeds, counters, _TAG_PROPOSE), V)
    samp = torch.argmax(lt + g, dim=-1).to(torch.int32)
    return torch.where(temps > 0, samp, greedy)


def filtered_probs(logits, temps, top_ks, top_ps) -> torch.Tensor:
    """[S, V] logits -> [S, V] fp32 probabilities of each row's filtered
    (tempered / top-k / top-p) distribution: the draft's proposal
    distribution ``q``, kept on the device for the verifier."""
    return _softmax(_filter_rows(logits.to(torch.float32), temps, top_ks,
                                 top_ps))


def spec_verify(logits_rows, draft_tokens, n_draft, temps, top_ks, top_ps,
                seeds, base_pos, q_rows=None):
    """Speculative accept/reject and resample (the verify epilogue).

    ``logits_rows`` [S, K+1, V]: the target's logits at each span's K+1
    verify rows (row j predicts the token at position ``base_pos[s] +
    j``).  ``draft_tokens`` [S, K] int (garbage past ``n_draft``);
    ``n_draft`` [S] in [0, K] (0: a plain decode span that samples row
    0).  ``q_rows`` [S, K, V]: the draft's filtered probabilities (None:
    greedy verification only).  Returns ``(n_acc, token)``, [S] int32
    each: the accepted draft count and the emitted correction or bonus
    token.  Sampled rows accept draft j iff ``u_j * q_j(d_j) < p_j(d_j)``
    (u float64, as the reference draws it) and resample the first
    rejection from ``normalize(max(p - q, 0))``, a full chain from
    ``p_K``; greedy rows accept on an argmax match, so greedy speculative
    output is the non-speculative greedy output."""
    lf = logits_rows.to(torch.float32)
    S, K1, V = lf.shape
    K = K1 - 1
    dev = lf.device
    tgt_arg = torch.argmax(lf, dim=-1).to(torch.int32)          # [S, K+1]
    jidx = torch.arange(K, dtype=torch.int32, device=dev)
    n_draft = n_draft.to(torch.int32)
    draft_tokens = draft_tokens.to(torch.int32)
    in_range = jidx[None, :] < n_draft[:, None]
    ok_greedy = tgt_arg[:, :K] == draft_tokens
    if q_rows is not None:
        pf = _softmax(_filter_rows(
            lf, temps[:, None].expand(S, K1), top_ks[:, None].expand(S, K1),
            top_ps[:, None].expand(S, K1)))                      # [S,K+1,V]
        d_idx = torch.clamp(draft_tokens, 0, V - 1).to(torch.int64)[..., None]
        p_d = torch.gather(pf[:, :K], -1, d_idx)[..., 0]
        q_d = torch.gather(q_rows.to(torch.float32), -1, d_idx)[..., 0]
        u = uniform(_row_key(seeds[:, None],
                             base_pos.to(torch.int64)[:, None] + jidx[None],
                             _TAG_ACCEPT), dtype=torch.float64)  # [S, K]
        ok_samp = (u * torch.clamp_min(q_d, 1e-30).to(torch.float64)
                   < p_d.to(torch.float64))
        ok = torch.where((temps > 0)[:, None], ok_samp, ok_greedy)
    else:
        ok = ok_greedy
    ok = ok & in_range
    chain = torch.cumprod(ok.to(torch.int32), dim=1)
    n_acc = chain.sum(dim=1).to(torch.int32)                     # [S]
    n_idx = n_acc.to(torch.int64)[:, None]
    e_greedy = torch.gather(tgt_arg, 1, n_idx)[:, 0]
    if q_rows is None:
        return n_acc, e_greedy
    p_row = torch.gather(pf, 1, n_idx[:, :, None].expand(S, 1, V))[:, 0]
    # a bonus row (n_acc == n_draft) resamples from p itself: pad q with a
    # zero row so the residual covers both, and zero a row whose index
    # would read past the span's drafts
    q_pad = torch.cat([q_rows.to(torch.float32),
                       torch.zeros(S, 1, V, device=dev)], dim=1)
    q_row = torch.gather(q_pad, 1, n_idx[:, :, None].expand(S, 1, V))[:, 0]
    q_row = torch.where((n_acc >= n_draft)[:, None],
                        torch.zeros((), device=dev), q_row)
    w = torch.clamp_min(p_row - q_row, 0.0)
    w_sum = w.sum(dim=-1, keepdim=True)
    w = torch.where(w_sum > 0, w, p_row)   # numeric guard: p == q exactly
    g = gumbel(_row_key(seeds, base_pos.to(torch.int64) + n_acc,
                        _TAG_RESIDUAL), V)
    logw = torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-38)),
                       torch.full((), float("-inf"), device=dev))
    e_samp = torch.argmax(logw + g, dim=-1).to(torch.int32)
    return n_acc, torch.where(temps > 0, e_samp, e_greedy)
