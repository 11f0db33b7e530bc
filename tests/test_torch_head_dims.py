"""Head dims the port's kernels take by padding, and the decode kernel's
split over blocks, on the CPU against the JAX reference.

On the card the flash kernels run a head dim without a kernel of its own
(D 80, 112: multiples of 8 up to 128) padded per half to the next width
they take, with the true ``1/sqrt(D)``; the paged kernels read the pools'
rows at their real width and take the columns past it as zeros.  These
tests run the same padding through the plain versions (the wrappers' own
helpers) and hold the result against ``paddle_tpu``'s functions at the
true D.  The decode kernel (#7) splits each slot's pages over several
blocks and merges their softmax states in split order; a plain model of
that split and merge is held against the unsplit plain version.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as ref_pa
from paddle_tpu.ops import pallas_kernels as ref_pk

from chip_smoke import int8_tolerance
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import online_softmax as pos
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.quantization import functional as qf

t = torch.from_numpy
# fp32, same algorithm, other summation order: rounding only
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
HEAD_DIMS = (80, 112)
# flash head dims padded per half on the card: multiples of 8 and not
FLASH_HEAD_DIMS = HEAD_DIMS + (36, 100)


def _to_ref(x):
    """[B, S, H, D] numpy -> the reference's [B, H, S, D] jax array."""
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


def _from_ref(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


def _interpreted(fn, *args, **kw):
    old = ref_pk._INTERPRET[0]
    ref_pk._INTERPRET[0] = True
    try:
        return fn(*args, **kw)
    finally:
        ref_pk._INTERPRET[0] = old


# ---------------------------------------------------------------------------
# flash (#1-#3): the padded form against the reference's Pallas kernels
# ---------------------------------------------------------------------------
def test_kernel_head_dims_pad_to_the_kernel_widths():
    """bf16 pads every D up to 128 to the tensor cores' 64 or 128, fp32 to
    the next of 32, 64, 96, 128 (a width with a kernel stays); past 128
    the flash width is 0 (the entries take ``_chunked_sdpa``).  The paged
    kernels' fast width for the multiples of 8 up to 128, 0 (the generic
    kernel) for every other D; a head dim of 0 raises naming it."""
    assert [fa.kernel_head_dim(D, torch.bfloat16)
            for D in (8, 32, 40, 64, 80, 96, 112, 128)] \
        == [64, 64, 64, 64, 128, 128, 128, 128]
    assert [fa.kernel_head_dim(D, torch.float32)
            for D in (8, 32, 40, 80, 96, 112, 128)] \
        == [32, 32, 64, 96, 96, 128, 128]
    assert [pa.kernel_head_dim(D) for D in (8, 40, 72, 80, 88, 112, 128)] \
        == [32, 64, 96, 128, 128, 128, 128]
    assert [fa.kernel_head_dim(D, torch.float32) for D in (84, 136, 4)] \
        == [96, 0, 32]
    assert [fa.kernel_head_dim(D, torch.bfloat16) for D in (84, 136, 4)] \
        == [128, 0, 64]
    assert [pa.kernel_head_dim(D) for D in (84, 136, 4)] == [0, 0, 0]
    assert [pa.decode_generic(D, 16) for D in (84, 136, 4, 80)] \
        == [True, True, True, False]
    assert [pa.ragged_generic(D, 1, False, 16) for D in (84, 136, 4, 80)] \
        == [True, True, True, False]
    for D in (0,):
        with pytest.raises(ValueError, match="head_dim %d" % D):
            fa.kernel_head_dim(D, torch.float32)
        with pytest.raises(ValueError, match="head_dim %d" % D):
            pa.kernel_head_dim(D)


def test_generic_routes_by_shape():
    """The generic paged kernels take what the fast ones do not: #5 with
    more than 32 query heads a kv head or int8 pools of block size over
    64, #7 with block sizes over 128; the tensor-core routing never
    claims such a shape."""
    assert pa.ragged_generic(64, 64, False, 16)
    assert not pa.ragged_generic(64, 32, False, 16)
    assert pa.ragged_generic(64, 1, True, 128)
    assert not pa.ragged_generic(64, 1, False, 128)
    assert not pa.ragged_generic(64, 1, True, 64)
    assert pa.decode_generic(64, 256) and not pa.decode_generic(64, 128)
    assert not pa.ragged_tensor_cores(torch.bfloat16, False, 16, 64, 64)
    assert not pa.ragged_tensor_cores(torch.bfloat16, False, 16, 100)
    assert pa.ragged_tensor_cores(torch.bfloat16, False, 16, 64, 32)


def test_odd_head_dims_pad_at_the_end_and_take_no_rope():
    """An odd D has no neox pairs: it pads at its end (the zero columns
    change no score) and the rope entries raise on it, as the reference's
    rope does."""
    x = t(np.arange(2 * 35, dtype=np.float32).reshape(2, 35))
    padded = fa._pad_to(x, 64)
    assert padded.shape == (2, 64)
    assert torch.equal(padded[:, :35], x) and not padded[:, 35:].any()
    assert torch.equal(fa._unpad(padded, 35), x)
    y = t(np.ones((1, 8, 2, 35), np.float32))
    with pytest.raises(ValueError, match="head_dim 35 is odd"):
        fa.flash_attention_rope(y, y, y)


def test_pad_halves_keeps_the_rope_pairs():
    """Padding each half keeps column i's neox partner at i + width/2:
    the roped padded tensor cut back equals the roped tensor, bitwise."""
    rng = np.random.RandomState(0)
    x = t(rng.randn(1, 9, 2, 80).astype(np.float32))
    cos, sin = fa.rope_tables(9, 80)
    padded = fa._rope(fa._pad_halves(x, 128), fa._pad_halves(cos, 128),
                      fa._pad_halves(sin, 128))
    assert torch.equal(fa._unpad_halves(padded, 80), fa._rope(x, cos, sin))
    assert torch.equal(fa._unpad_halves(fa._pad_halves(x, 96), 80), x)


def _flash_inputs(D, rope, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(1, 48, 2, D).astype(np.float32)
                  for _ in range(4))
    tables = None
    if rope:
        cos, sin = ref_pk.rope_tables(48, D)
        tables = (np.asarray(cos), np.asarray(sin))
    return q, k, v, g, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_width", "bf16_width"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("D", FLASH_HEAD_DIMS)
def test_padded_flash_matches_pallas_interpret(D, rope, dtype):
    """The forward and both backward forms run as the card runs them at
    D 80 and 112 (operands padded per half to the width the wrapper takes
    for ``dtype``, the true scale, outputs cut back; here in fp32 through
    the plain versions) against the reference's Pallas flash kernels at
    the true D (interpret mode, causal): within fp32 rounding.  D 36 and
    100, not multiples of 8, pad the same way."""
    q, k, v, g, tables = _flash_inputs(D, rope, seed=D)
    rope_j = None if tables is None else tuple(map(jnp.asarray, tables))
    out_r, lse_r = _interpreted(
        ref_pk._flash_attention_value, _to_ref(q), _to_ref(k), _to_ref(v),
        True, block_q=16, block_k=16, with_lse=True, rope=rope_j)
    lse_r = np.array(lse_r).reshape(1, 2, 48)
    width = fa.kernel_head_dim(D, dtype)
    assert width != D
    scale = 1.0 / math.sqrt(D)

    def pad(x):
        return fa._pad_halves(t(np.array(x)), width)
    rope_p = None if tables is None else tuple(pad(x) for x in tables)
    qp, kp, vp, gp = (pad(x) for x in (q, k, v, g))
    out_p, lse = fa._flash_fwd_plain(qp, kp, vp, True, rope_p, scale=scale)
    np.testing.assert_allclose(fa._unpad_halves(out_p, D).numpy(),
                               _from_ref(out_r), **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_r, **FP32_TOL)
    for form, ref_fn in (("fused", ref_pk._flash_attention_bwd_fused),
                         ("two_kernel", ref_pk._flash_attention_bwd)):
        want = _interpreted(
            ref_fn, _to_ref(q), _to_ref(k), _to_ref(v), out_r,
            jnp.asarray(lse_r.reshape(-1, 48)), _to_ref(g), True,
            block_q=16, block_k=16, rope=rope_j)
        got = fa._flash_bwd_plain(qp, kp, vp, pad(_from_ref(out_r)),
                                  t(lse_r), gp, True, rope_p, form=form,
                                  scale=scale)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert torch.equal(fa._pad_halves(fa._unpad_halves(a, D),
                                              width), a), name
            np.testing.assert_allclose(fa._unpad_halves(a, D).numpy(),
                                       _from_ref(b), err_msg=form + name,
                                       **FP32_TOL)


# ---------------------------------------------------------------------------
# paged kernels (#5, #7): pools read at their width, zero columns past it
# ---------------------------------------------------------------------------
def _pack(seq_lens, H, Hkv, D, bs, seed, q_lens=None):
    """Random fp pools with a page per used block, tables aimed at a
    page no slot uses past each slot's pages, one q row per query (or
    ``q_lens`` rows per span)."""
    rng = np.random.RandomState(seed)
    q_lens = q_lens or [1] * len(seq_lens)
    n = sum(-(-s // bs) for s in seq_lens)
    kc, vc = (rng.randn(n + 1, bs, Hkv, D).astype(np.float32)
              for _ in range(2))
    W = max(-(-s // bs) for s in seq_lens)
    bt = np.full((len(seq_lens), W), n, np.int32)
    page = 0
    for i, s in enumerate(seq_lens):
        m = -(-s // bs)
        bt[i, :m] = np.arange(page, page + m)
        page += m
    q = rng.randn(sum(q_lens), H, D).astype(np.float32)
    q_off = np.cumsum([0] + q_lens[:-1]).astype(np.int32)
    return (q, kc, vc, bt, q_off, np.asarray(q_lens, np.int32),
            np.asarray(seq_lens, np.int32))


def _zero_padded(x, width):
    """The operand as the kernels see it: columns past D read as 0."""
    return torch.nn.functional.pad(t(np.array(x)), (0, width - x.shape[-1]))


def _quantized(kc, vc):
    codes, scales = [], []
    for c in (kc, vc):
        s = np.abs(c).max(axis=(1, 3)).astype(np.float32)      # [phys, Hkv]
        codes.append(qf.quantize_symmetric(
            t(c), t(s)[:, None, :, None]).to(torch.int8))
        scales.append(t(s))
    vmax = pa.dequant_pages(codes[1], scales[1]).abs().max().item()
    return codes, scales, vmax


@pytest.mark.parametrize("heads", [(4, 2), (7, 1)], ids=["gqa2", "gqa7"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_paged_decode_plain_matches_reference(D, heads):
    """#7's plain version over q and pools zero-padded to the width the
    kernel is built at (the true scale, the output cut back) against the
    reference's ``paged_attention`` (XLA) at the true D: 1e-5."""
    H, Hkv = heads
    q, kc, vc, bt, _, _, sl = _pack([5, 19, 1, 33], H, Hkv, D, bs=8,
                                    seed=D + H)
    want = ref_pa.paged_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(bt),
                                  jnp.asarray(sl), use_pallas=False)
    width = pa.kernel_head_dim(D)
    got = pa.paged_attention(*(_zero_padded(x, width) for x in (q, kc, vc)),
                             t(bt), t(sl), scale=1.0 / math.sqrt(D))
    assert torch.equal(got[..., D:], torch.zeros_like(got[..., D:]))
    np.testing.assert_allclose(got[..., :D].numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_int8_paged_decode_plain_matches_reference(D):
    """The int8 variant over zero-padded q and pools: q's absmax, the
    codes and every integer sum see only added zeros, so the result is
    the unpadded plain version's bit for bit, and within
    ``KERNEL_INT8_REL_TOL`` of the reference's XLA dequant path."""
    q, kc, vc, bt, _, _, sl = _pack([5, 19, 1, 33], 4, 2, D, bs=8, seed=D)
    (kc8, vc8), (ks, vs), vmax = _quantized(kc, vc)
    scale = 1.0 / math.sqrt(D)
    plain = pa._paged_attention_plain(t(q), kc8, vc8, t(bt), t(sl), scale,
                                      ks, vs)
    width = pa.kernel_head_dim(D)
    pad = lambda x: torch.nn.functional.pad(x, (0, width - D))  # noqa: E731
    got = pa.paged_attention(pad(t(q)), pad(kc8), pad(vc8), t(bt), t(sl),
                             scale=scale, key_scale=ks, value_scale=vs)
    assert torch.equal(got[..., :D], plain)
    want = ref_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kc8.numpy()), jnp.asarray(vc8.numpy()),
        jnp.asarray(bt), jnp.asarray(sl), use_pallas=False,
        key_scale=jnp.asarray(ks.numpy()), value_scale=jnp.asarray(vs.numpy()))
    assert np.abs(got[..., :D].numpy() - np.asarray(want)).max() \
        <= pa.KERNEL_INT8_REL_TOL * vmax


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_ragged_plain_matches_reference(D):
    """#5's plain version over zero-padded q and pools (decode spans, a
    chunk, a prefix-offset span; GQA 6/2) against the reference's ragged
    XLA path at the true D: 1e-5; its int8 variant equal bit for bit to
    the unpadded one."""
    q, kc, vc, bt, q_off, q_len, kv = _pack([7, 29, 3, 41], 6, 2, D, bs=8,
                                            seed=D + 1,
                                            q_lens=[1, 13, 3, 9])
    want = ref_pa.ragged_paged_attention(
        q, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt), q_off, q_len,
        kv, use_pallas=False)
    width = pa.kernel_head_dim(D)
    tabs = tuple(t(x) for x in (bt, q_off, q_len, kv))
    got = pa.ragged_paged_attention(
        *(_zero_padded(x, width) for x in (q, kc, vc)), *tabs,
        scale=1.0 / math.sqrt(D), span_q=13)
    np.testing.assert_allclose(got[..., :D].numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (kc8, vc8), (ks, vs), _ = _quantized(kc, vc)
    pad = lambda x: torch.nn.functional.pad(x, (0, width - D))  # noqa: E731
    got8 = pa.ragged_paged_attention(pad(t(q)), pad(kc8), pad(vc8), *tabs,
                                     scale=1.0 / math.sqrt(D), span_q=13,
                                     key_scale=ks, value_scale=vs)
    plain8 = pa._ragged_attention_int8_plain(t(q), kc8, vc8, ks, vs, *tabs,
                                             1.0 / math.sqrt(D))
    assert torch.equal(got8[..., :D], plain8)


# ---------------------------------------------------------------------------
# #7's split over blocks and its in-order merge
# ---------------------------------------------------------------------------
def test_decode_splits_cover_the_table_from_shapes_alone():
    """One run while the blocks cover the card's SMs (7B: 8 slots x 32 kv
    heads); GQA 32/8 splits into runs of at least 8 pages; the runs
    always cover the table's width; more than 8 query heads per kv head
    take several head tiles (counted as blocks)."""
    assert pa.decode_splits(8, 32, 1, 64) == (1, 64)
    n, run = pa.decode_splits(8, 8, 4, 64)
    assert n > 1 and run >= 8 and n * run >= 64 > (n - 1) * run
    assert pa.decode_splits(1, 1, 1, 3) == (1, 3)
    for B, Hkv, G, W in ((1, 1, 1, 500), (2, 4, 7, 37), (8, 1, 32, 256),
                         (1, 2, 16, 1)):
        n, run = pa.decode_splits(B, Hkv, G, W)
        assert 1 <= n <= 64 and n * run >= W > (n - 1) * run
    assert pa.decode_splits(8, 2, 32, 512)[0] \
        < pa.decode_splits(8, 2, 16, 512)[0]


def _split_decode_plain(q, kc, vc, bt, sl, scale, runs, ks=None, vs=None):
    """The decode kernel's split and merge in plain torch: slot b's pages
    cut into runs (``runs``: the first page of each), each run's (m, l,
    acc) carried page by page as the plain versions do (int8: q and each
    page's probabilities quantized per row), then merged in run order:
    M = max m, L = sum l e^(m - M), A = sum acc e^(m - M), out A / L."""
    B, H, D = q.shape
    bs, Hkv = kc.shape[1], kc.shape[2]
    g = H // Hkv
    out = torch.zeros_like(q)
    for b in range(B):
        n_pages = -(-int(sl[b]) // bs)
        rows = q[b].reshape(Hkv, g, D)
        if ks is not None:
            codes, q_s = qf.quantize_rows_symmetric(rows)
            rows = codes.to(torch.float32)
        else:
            rows = rows * scale
        states = []
        bounds = [r for r in runs if r < n_pages] + [n_pages]
        for p0, p1 in zip(bounds[:-1], bounds[1:]):
            m = torch.full((Hkv, g, 1), float("-inf"))
            l, acc = torch.zeros(Hkv, g, 1), torch.zeros(Hkv, g, D)
            for p in range(p0, p1):
                page = int(bt[b, p])
                kp = kc[page].permute(1, 0, 2).to(torch.float32)
                vp = vc[page].permute(1, 0, 2).to(torch.float32)
                s = rows @ kp.transpose(1, 2)                 # [Hkv, g, bs]
                if ks is not None:
                    s = qf.fold_int8_scores(s, q_s, ks[page][:, None, None],
                                            scale)
                ok = (p * bs + torch.arange(bs) < int(sl[b]))[None, None]
                s = torch.where(ok, s, torch.tensor(float("-inf")))

                def pv(p_, vp=vp, page=page):
                    if ks is None:
                        return p_ @ vp
                    p_codes, p_s = qf.quantize_rows_symmetric(p_)
                    return qf.fold_int8_scores(
                        p_codes.to(torch.float32) @ vp, p_s,
                        vs[page][:, None, None])
                m, l, acc = pos.online_softmax_update((m, l, acc), s, ok, pv)
            states.append((m, l, acc))
        M = torch.stack([m for m, _, _ in states]).amax(0)
        L = sum(l * torch.exp(m - M) for m, l, _ in states)
        A = sum(acc * torch.exp(m - M) for m, _, acc in states)
        out[b] = (A / L.clamp_min(1e-30)).reshape(H, D)
    return out


@pytest.mark.parametrize("runs", [(0,), (0, 1), (0, 2, 3), (0, 1, 2, 3, 4)],
                         ids=["unsplit", "split_1", "split_2_3", "per_page"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_split_merge_matches_unsplit_plain(quantized, runs):
    """Pages split at arbitrary points (one run, runs of one page, runs
    past a slot's pages) and merged in split order give the unsplit
    plain version: fp within fp32 rounding (1e-5); int8 within
    ``chip_smoke.int8_tolerance`` (a run's running max differs, so a
    probability code at a .5 boundary may round the other way)."""
    q, kc, vc, bt, _, _, sl = _pack([5, 19, 1, 33, 40], 6, 2, 16, bs=8,
                                    seed=3)
    q, kc, vc, bt, sl = t(q), t(kc), t(vc), t(bt), t(sl)
    scale = 1.0 / math.sqrt(16)
    if not quantized:
        got = _split_decode_plain(q, kc, vc, bt, sl, scale, runs)
        want = pa._paged_attention_plain(q, kc, vc, bt, sl, scale)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        return
    (kc8, vc8), (ks, vs), vmax = _quantized(kc.numpy(), vc.numpy())
    got = _split_decode_plain(q, kc8, vc8, bt, sl, scale, runs, ks, vs)
    want, flips = pa._paged_attention_plain(q, kc8, vc8, bt, sl, scale, ks,
                                            vs, flip_bound=True)
    assert (got - want).abs().le(int8_tolerance(want, flips, vmax)).all()
    if runs == (0,):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the generic paged kernels' shapes: the plain versions against the
# reference at the true D (no padding: the generic kernel reads q, the
# pools and the output at their own width)
# ---------------------------------------------------------------------------
GENERIC_SHAPES = {"d100": (8, 2, 100, 8), "d256_gqa": (8, 8, 256, 8),
                  "d256_mqa": (8, 1, 256, 8), "groups64": (64, 1, 32, 8),
                  "bs128": (4, 2, 64, 128)}


@pytest.mark.parametrize("shape", sorted(GENERIC_SHAPES))
def test_generic_shapes_plain_match_reference(shape):
    """#5's and #7's plain versions at head dims 100 and 256, 64 query
    heads over one kv head and block size 128 against the reference's
    XLA paths (fp32: 1e-5), and their int8 variants against the
    reference's dequantizing path within ``KERNEL_INT8_REL_TOL`` of the
    largest value: the shapes the generic kernels compute on the card."""
    H, Hkv, D, bs = GENERIC_SHAPES[shape]
    scale = 1.0 / math.sqrt(D)
    q, kc, vc, bt, q_off, q_len, kv = _pack([7, 29, 3, 41, 150], H, Hkv, D,
                                            bs=bs, seed=D + H,
                                            q_lens=[1, 13, 3, 9, 1])
    tabs = tuple(t(x) for x in (bt, q_off, q_len, kv))
    want = ref_pa.ragged_paged_attention(
        q, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt), q_off, q_len,
        kv, use_pallas=False)
    got = pa.ragged_paged_attention(t(q), t(kc), t(vc), *tabs, scale=scale,
                                    span_q=13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    (kc8, vc8), (ks, vs), vmax = _quantized(kc, vc)
    got8 = pa.ragged_paged_attention(t(q), kc8, vc8, *tabs, scale=scale,
                                     span_q=13, key_scale=ks,
                                     value_scale=vs)
    want8 = ref_pa.ragged_paged_attention(
        q, jnp.asarray(kc8.numpy()), jnp.asarray(vc8.numpy()),
        jnp.asarray(bt), q_off, q_len, kv, use_pallas=False,
        key_scale=jnp.asarray(ks.numpy()),
        value_scale=jnp.asarray(vs.numpy()))
    assert np.abs(got8.numpy() - np.asarray(want8)).max() \
        <= pa.KERNEL_INT8_REL_TOL * vmax
    # #7: one query per slot
    qd, kc, vc, bt, _, _, sl = _pack([5, 19, 1, 33, 140], H, Hkv, D, bs=bs,
                                     seed=D + H + 1)
    want = ref_pa.paged_attention(jnp.asarray(qd), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(bt),
                                  jnp.asarray(sl), use_pallas=False)
    got = pa.paged_attention(t(qd), t(kc), t(vc), t(bt), t(sl), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    (kc8, vc8), (ks, vs), vmax = _quantized(kc, vc)
    got8 = pa.paged_attention(t(qd), kc8, vc8, t(bt), t(sl), scale=scale,
                              key_scale=ks, value_scale=vs)
    want8 = ref_pa.paged_attention(
        jnp.asarray(qd), jnp.asarray(kc8.numpy()), jnp.asarray(vc8.numpy()),
        jnp.asarray(bt), jnp.asarray(sl), use_pallas=False,
        key_scale=jnp.asarray(ks.numpy()),
        value_scale=jnp.asarray(vs.numpy()))
    assert np.abs(got8.numpy() - np.asarray(want8)).max() \
        <= pa.KERNEL_INT8_REL_TOL * vmax
