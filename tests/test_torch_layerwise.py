"""The port's layerwise training slice against the JAX reference, on the
CPU: Adafactor's update rule, kernel #4's plain version (RMSNorm) against
the reference's ``_rms_kernel`` run in interpret mode, its backward, the
chunked head loss, and ``LlamaLayerwiseTrainStep`` step for step against
the reference's, from the same weights and batches.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.jit import layerwise as ref_lw
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.ops import pallas_kernels as ref_pk
from paddle_tpu.optimizer import optimizer as ref_opt

from paddle_tpu_torch.jit import layerwise as lw
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import rms_norm as rn
from paddle_tpu_torch.optimizer import Adafactor
from paddle_tpu_torch.testing.parity import (layerwise_params_from_paddle_tpu,
                                             state_from_paddle_tpu)

def _bf16_ulp(a):
    """One bf16 ulp at each element of ``a`` (float32 numpy)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _f32(t):
    """A torch tensor or jax array as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------
ADAFACTOR_OPTIONS = {
    "default": dict(),
    "beta1": dict(beta1=0.9),
    "beta1_bf16_moment": dict(beta1=0.9, moment_dtype="bfloat16"),
    "unscaled": dict(scale_parameter=False),
    "weight_decay": dict(weight_decay=0.1),
    "clip_decay_eps": dict(clip_threshold=0.5, decay_rate=0.6,
                           epsilon1=1e-20, epsilon2=1e-2),
}
SHAPES = {"1d": (7,), "2d": (6, 5), "3d": (3, 4, 5)}


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("option", sorted(ADAFACTOR_OPTIONS))
def test_adafactor_update_matches_reference(option, shape, pdtype):
    """Four updates of one parameter through ``Optimizer.step`` against
    the reference's ``_update_rule`` fed the same gradients: the
    parameter and every state entry within 2e-6 relative to the tensor's
    largest value in fp32 (the reductions sum in another order); bf16
    parameters and moments within one bf16 ulp."""
    kw = ADAFACTOR_OPTIONS[option]
    shp = SHAPES[shape]
    rng = np.random.RandomState(11)
    p0 = rng.randn(*shp).astype(np.float32)
    grads = [rng.randn(*shp).astype(np.float32) * 10.0 ** -k
             for k in range(4)]
    lr = 1e-2
    jd = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    ref_p = paddle.create_parameter(list(shp), "float32")
    ref_p._value = jnp.asarray(p0).astype(jd)
    ref = ref_opt.Adafactor(lr, parameters=[ref_p], **kw)
    # copies: on the CPU jnp.asarray may share a 64-byte-aligned numpy
    # buffer, which the port's in-place update would then change
    port_p = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(td))
    port = Adafactor(lr, parameters=[("w", port_p)], **kw)
    st = ref._init_state(ref_p)
    pv = ref_p._value
    for gnp in grads:
        pv, st = ref._update_rule(pv, jnp.asarray(gnp).astype(jd), st,
                                  {"lr": jnp.asarray(lr, jnp.float32)})
        port_p.grad = torch.from_numpy(gnp.copy()).to(td)
        port.step()
    pst = port.state("w")
    assert sorted(pst) == sorted(st)
    assert port_p.dtype == td
    for name, a, b in [("param", port_p, pv)] + [(k, pst[k], st[k])
                                                 for k in pst]:
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, name
        if name == "param" and pdtype == "bfloat16" or (
                name == "m" and kw.get("moment_dtype") == "bfloat16"):
            assert (np.abs(a - b) <= _bf16_ulp(b)).all(), name
        else:
            np.testing.assert_allclose(a, b, rtol=2e-6,
                                       atol=2e-6 * np.abs(b).max(),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# kernel #4: RMSNorm
# ---------------------------------------------------------------------------
def _ref_rms_interpret(x, w, eps, block_rows):
    """The reference's ``_rms_kernel`` in a ``pl.pallas_call`` built as
    ``rms_norm_tpu`` builds it, run in interpret mode."""
    shape = x.shape
    d = shape[-1]
    rows = int(np.prod(shape[:-1]))
    br = min(block_rows, rows)
    if rows % br:
        br = rows
    with ref_pk._x64_off():
        out = pl.pallas_call(
            functools.partial(ref_pk._rms_kernel, eps=eps),
            grid=(rows // br,),
            in_specs=[pl.BlockSpec((br, d), lambda i: (i, 0)),
                      pl.BlockSpec((d,), lambda i: (0,))],
            out_specs=pl.BlockSpec((br, d), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((rows, d), x.dtype),
            interpret=True,
        )(x.reshape(rows, d), w)
    return out.reshape(shape)


def _rms_inputs(shape, dtype, seed=0, unit_weight=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2.0
    w = np.ones(shape[-1], np.float32) if unit_weight else \
        (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, wj = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    # the same (rounded) values on both sides
    xt = torch.from_numpy(_f32(xj)).to(td)
    wt = torch.from_numpy(_f32(wj)).to(td)
    return xj, wj, xt, wt


# (shape, block_rows): whole blocks, rows not divisible by block_rows
# (one block over all rows), leading dims, one row
RMS_CASES = {
    "rows1024_blocks256": ((1024, 128), 256),
    "rows700_not_divisible": ((700, 96), 512),
    "leading_2x3x40": ((2, 3, 40, 64), 16),
    "one_row": ((1, 256), 512),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RMS_CASES))
def test_rms_plain_matches_pallas_interpret(case, dtype):
    """#4's plain version (what ``rms_norm_tpu`` runs on CPU tensors)
    against the reference's Pallas kernel in interpret mode: fp32 within
    1e-6 relative, bf16 within one bf16 ulp; no launch is counted."""
    shape, block_rows = RMS_CASES[case]
    xj, wj, xt, wt = _rms_inputs(shape, dtype)
    want = _f32(_ref_rms_interpret(xj, wj, 1e-6, block_rows))
    before = rn.rms_norm_tpu.launches
    got = rn.rms_norm_tpu(xt, wt, 1e-6, block_rows=block_rows)
    assert rn.rms_norm_tpu.launches == before
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = _f32(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_backward_matches_jax_vjp(dtype):
    """``RMSNormKernel``'s backward against ``jax.vjp`` of the kernel's
    function, ``(x32 * rsqrt(mean(x32^2) + eps) * w32).astype(dtype)``,
    for the same output gradient: within 1e-5 (relative to the largest
    gradient; bf16 within one bf16 ulp)."""
    xj, wj, xt, wt = _rms_inputs((3, 10, 48), dtype, seed=1)
    gj = jnp.asarray(np.random.RandomState(2).randn(3, 10, 48)
                     .astype(np.float32)).astype(xj.dtype)

    def fn(x, w):
        x32 = x.astype(jnp.float32)
        ms = jnp.mean(x32 * x32, axis=-1, keepdims=True)
        return (x32 * jax.lax.rsqrt(ms + 1e-6)
                * w.astype(jnp.float32)).astype(x.dtype)
    want_out, vjp = jax.vjp(fn, xj, wj)
    want_dx, want_dw = vjp(gj)
    xt.requires_grad_()
    wt.requires_grad_()
    out = rn.RMSNormKernel.apply(xt, wt, 1e-6)
    out.backward(torch.from_numpy(_f32(gj)).to(xt.dtype))
    for name, a, b in (("out", out, want_out), ("dx", xt.grad, want_dx),
                       ("dw", wt.grad, want_dw)):
        a, b = _f32(a), _f32(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)
        else:
            assert (np.abs(a - b) <= _bf16_ulp(b)).all(), name


@pytest.mark.parametrize("weight", ["unit", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_norm_rounding_point_vs_layerwise_rms_norm(dtype, weight):
    """The rounding point (ROADMAP queue 3 item 7): #4 casts once after
    the weight multiply, the reference's layerwise ``_rms_norm`` casts
    before it.  fp32: equal within 1e-6; bf16 at w = 1: bitwise; bf16 at
    a random w: at most one bf16 ulp apart (and not all equal)."""
    xj, wj, xt, wt = _rms_inputs((64, 256), dtype, seed=3,
                                 unit_weight=weight == "unit")
    want = _f32(ref_lw._rms_norm(xj, wj, 1e-6))
    got = _f32(rn.rms_norm_tpu(xt, wt, 1e-6))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    elif weight == "unit":
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got - want)
        assert (diff <= _bf16_ulp(want)).all()
        assert (diff > 0).any()


def _near_bf16_midpoint(n, ulps=4):
    """Elements of the fp32 array ``n`` within ``ulps`` fp32 ulps of a
    bf16 rounding midpoint: where another fp32 order of the same
    arithmetic can round to the other bf16 neighbour."""
    mag = np.abs(n).astype(np.float64)
    e = np.frexp(mag)[1]
    ulp32, ulpb = np.ldexp(1.0, e - 24), np.ldexp(1.0, e - 8)
    frac = mag / ulpb
    return np.abs(frac - np.floor(frac) - 0.5) * ulpb <= ulps * ulp32


@pytest.mark.parametrize("ulps", [1, 4, 16])
def test_card_midpoint_rule_matches_this_one(ulps):
    """``chip_smoke.near_bf16_midpoint`` (the card check's bit rule for
    the layerwise norm) marks the same fp32 elements as
    :func:`_near_bf16_midpoint`, over random values, values planted at
    and beside bf16 midpoints, powers of two and zero."""
    from chip_smoke import near_bf16_midpoint
    rs = np.random.RandomState(ulps)
    base = (rs.randn(4096) * 10.0 ** rs.uniform(-4, 2, 4096)).astype(
        np.float32)
    mid = (base.view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    off = rs.randint(-2 * ulps, 2 * ulps + 1, 4096).astype(np.int64)
    planted = (mid.astype(np.int64) + off).astype(np.uint32).view(np.float32)
    n = np.concatenate([base, planted, np.float32([0.0, 1.0, -2.0, 0.5])])
    want = _near_bf16_midpoint(n, ulps)
    got = near_bf16_midpoint(torch.from_numpy(n), ulps).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n.size


@pytest.mark.parametrize("weight", ["unit", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RMS_CASES))
def test_layerwise_norm_matches_reference_rms_norm(case, dtype, weight):
    """Kernel #4's layerwise variant (``round_first``: the wrapper's CPU
    branch, which is its plain version) against the reference's layerwise
    ``_rms_norm``, which rounds the normalised input before the weight.

    bf16: bitwise, except where the fp32 normalised value lies within 4
    fp32 ulps of a bf16 rounding midpoint: XLA's mean and rsqrt are an
    fp32 ulp or two from torch's (never bitwise in fp32), which can only
    move such an element, by one bf16 ulp (0-1 elements per case here,
    of 256-67,200).  The kernel's own rounding point differs at a quarter
    of the elements under a random weight.  fp32: within 1e-6 relative
    (those same fp32 ulps)."""
    shape, _ = RMS_CASES[case]
    xj, wj, xt, wt = _rms_inputs(shape, dtype, seed=5,
                                 unit_weight=weight == "unit")
    want = _f32(ref_lw._rms_norm(xj, wj, 1e-6))
    before = rn.rms_norm_tpu.launches
    got_t = rn.rms_norm_tpu(xt, wt, 1e-6, round_first=True)
    assert rn.rms_norm_tpu.launches == before
    assert torch.equal(got_t, rn._rms_norm_plain(xt, wt, 1e-6,
                                                 round_first=True))
    got = _f32(got_t)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        return
    x32 = xt.float()
    n = _f32(x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6))
    edge = _near_bf16_midpoint(n)
    differ = got != want
    assert not (differ & ~edge).any()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert differ.sum() <= 2
    if weight == "random":
        old = _f32(rn.rms_norm_tpu(xt, wt, 1e-6))
        assert (old != want).mean() > 0.1


@pytest.mark.parametrize("weight", ["unit", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layerwise_norm_backward_matches_jax_vjp(dtype, weight):
    """``RMSNormKernel``'s backward with ``round_first`` against
    ``jax.vjp`` of the reference's ``_rms_norm`` for the same output
    gradient.  dx: fp32 within 1e-5 relative to the largest, bf16 within
    one bf16 ulp (bitwise here).  dw: the reference sums its 30 rows in
    bf16, one rounding per addition (XLA's bf16 reduction), the port in
    fp32: held to that recursive sum's error bound, rows x 2^-8 x
    sum|g n| (fp32: 1e-5 relative)."""
    xj, wj, xt, wt = _rms_inputs((3, 10, 48), dtype, seed=1,
                                 unit_weight=weight == "unit")
    gj = jnp.asarray(np.random.RandomState(2).randn(3, 10, 48)
                     .astype(np.float32)).astype(xj.dtype)
    want_out, vjp = jax.vjp(lambda a, b: ref_lw._rms_norm(a, b, 1e-6),
                            xj, wj)
    want_dx, want_dw = (_f32(t) for t in vjp(gj))
    xt.requires_grad_()
    wt.requires_grad_()
    out = rn.RMSNormKernel.apply(xt, wt, 1e-6, True)
    g = torch.from_numpy(_f32(gj)).to(xt.dtype)
    out.backward(g)
    dx, dw = _f32(xt.grad), _f32(wt.grad)
    if dtype == "float32":
        np.testing.assert_allclose(dx, want_dx, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_dx).max())
        np.testing.assert_allclose(dw, want_dw, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_dw).max())
        return
    assert (np.abs(dx - want_dx) <= _bf16_ulp(want_dx)).all()
    n = _f32(want_out).reshape(-1, 48) / _f32(wj)       # round(x r), exact
    terms = np.abs(_f32(g).reshape(-1, 48) * n).sum(0)
    bound = 30 * 2.0 ** -8 * terms + _bf16_ulp(want_dw)
    assert (np.abs(dw - want_dw) <= bound).all()


def test_layerwise_bf16_step_is_closer_to_reference_with_its_norm():
    """The layerwise step's function in bf16 (2 tiny layers, random norm
    weights, batch 2 x 32: embedding, two ``_block_fn``, ``_head_loss``)
    and its gradients against the reference's ``jax.value_and_grad`` of
    the same function from the same weights, with the norms at the
    reference's rounding point (the step's ``rms_norm``) and at the
    kernel's (``round_first=False``, the step before this variant).
    Attention runs the reference's CPU path on both sides (the port's
    copy of ``_chunked_sdpa`` after the graph-level rope), so the norms'
    rounding point is the one systematic difference in the function; the
    bf16 matmuls and reductions still sum in another order.  Measured
    over seeds 0-5: the mean gradient error (per leaf, mean |diff| over
    mean |reference|, averaged over the 12 leaves) 0.0098-0.0108 ->
    0.0074-0.0078, and the share of gradient elements bitwise equal to
    the reference's 0.345-0.377 -> 0.438-0.460 (seed 0: 0.0102 -> 0.0076,
    0.368 -> 0.460).  The fp32 loss moves by 3e-6-5e-4 either way: at this
    size the summation order outweighs the norms' one ulp, so it is
    reported in the assertion messages, not held."""
    ref_cfg = ref_tiny_config(dtype="bfloat16")
    cfg = _port_cfg(ref_cfg)
    rng = np.random.RandomState(0)
    h, i, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, nh, kv = (cfg.num_hidden_layers, cfg.num_attention_heads,
                 cfg.num_key_value_heads)
    dh = h // nh
    shapes = {"wq": (L, h, nh * dh), "wk": (L, h, kv * dh),
              "wv": (L, h, kv * dh), "wo": (L, nh * dh, h),
              "gate": (L, h, i), "up": (L, h, i), "down": (L, i, h),
              "ln1": (L, h), "ln2": (L, h)}
    names = sorted(shapes)
    leaves = [rng.randn(V, h) * 0.02, 1 + 0.1 * rng.randn(h),
              rng.randn(h, V) * 0.02]
    leaves += [1 + 0.1 * rng.randn(*shapes[k]) if k.startswith("ln")
               else rng.randn(*shapes[k]) * 0.02 for k in names]
    leaves_j = [jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
                for a in leaves]
    B, S = 2, 32
    ids, labels = rng.randint(0, V, (B, S)), rng.randint(0, V, (B, S))
    cos_j, sin_j = ref_pk.rope_tables(S, dh, cfg.rope_theta)

    def ref_loss(leaves):
        emb, norm, head, *blocks = leaves
        x = emb[jnp.asarray(ids)]
        for l in range(L):
            x = ref_lw._block_fn({k: b[l] for k, b in zip(names, blocks)},
                                 x, cos_j, sin_j, ref_cfg)
        return ref_lw._head_loss(x, norm, head, jnp.asarray(labels),
                                 ref_cfg)
    want, want_grads = jax.value_and_grad(ref_loss)(leaves_j)

    def port(norm):
        ts = [torch.from_numpy(_f32(a)).to(torch.bfloat16).requires_grad_()
              for a in leaves_j]
        emb, norm_w, head, *blocks = ts
        cos, sin = fa.rope_tables(S, dh, cfg.rope_theta)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lw, "flash_rope_sdpa",
                       lambda q, k, v, c, s, causal: fa._chunked_sdpa(
                           fa._rope_cast(q, c, s), fa._rope_cast(k, c, s),
                           v, causal))
            mp.setattr(lw, "rms_norm", norm)
            x = torch.nn.functional.embedding(torch.from_numpy(ids), emb)
            for l in range(L):
                x = lw._block_fn({k: b[l] for k, b in zip(names, blocks)},
                                 x, cos, sin, cfg)
            loss = lw._head_loss(x, norm_w, head, torch.from_numpy(labels),
                                 cfg)
            grads = torch.autograd.grad(loss, ts)
        err = np.mean([np.abs(_f32(a) - _f32(b)).mean()
                       / np.abs(_f32(b)).mean()
                       for a, b in zip(grads, want_grads)])
        same = np.mean(np.concatenate([(_f32(a) == _f32(b)).ravel()
                                       for a, b in zip(grads, want_grads)]))
        return abs(loss.item() - float(want)), err, same

    new = port(lw.rms_norm)
    old = port(lambda x, w, eps: rn.RMSNormKernel.apply(x, w, eps, False))
    msg = "loss |diff|, mean grad error, bitwise share: now %s, before %s" \
        % (new, old)
    assert new[1] < 0.85 * old[1] and new[1] < 0.009, msg
    assert new[2] > old[2] + 0.05, msg


def test_rms_norm_tpu_rejects_a_device_it_has_no_kernel_for():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        rn.rms_norm_tpu(x, torch.ones(8, device="meta"))


# ---------------------------------------------------------------------------
# the head loss and the layerwise step
# ---------------------------------------------------------------------------
def _port_cfg(ref_cfg):
    return LlamaConfig(**{f: getattr(ref_cfg, f)
                          for f in LlamaConfig.__dataclass_fields__})


def test_head_loss_matches_reference_with_padding():
    """The chunked head loss and its gradients (final norm input, norm
    weight, head) against the reference's ``_head_loss`` and
    ``jax.grad``, at B*S = 96 tokens in chunks of 64 (one padded chunk)."""
    ref_cfg = ref_tiny_config()
    cfg = _port_cfg(ref_cfg)
    rng = np.random.RandomState(1)
    B, S, H = 2, 48, cfg.hidden_size
    hL = rng.randn(B, S, H).astype(np.float32) * 0.1
    norm_w = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    head_w = rng.randn(H, cfg.vocab_size).astype(np.float32) * 0.05
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels[0, 5] = -100

    def ref_fn(a, b, c):
        return ref_lw._head_loss(a, b, c, jnp.asarray(labels), ref_cfg,
                                 chunk=64)
    want, want_grads = jax.value_and_grad(ref_fn, argnums=(0, 1, 2))(
        jnp.asarray(hL), jnp.asarray(norm_w), jnp.asarray(head_w))
    args = [torch.from_numpy(a).requires_grad_()
            for a in (hL, norm_w, head_w)]
    loss = lw._head_loss(*args, torch.from_numpy(labels), cfg, chunk=64)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)
    for name, a, b in zip(("dh", "dnorm", "dhead"), args, want_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def _batches(vocab, n=3, batch=2, seq=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (batch, seq)),
             rng.randint(0, vocab, (batch, seq))) for _ in range(n)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_layerwise_steps_match_reference(kv_heads):
    """Three steps of the port's layerwise step against the reference's
    ``LlamaLayerwiseTrainStep`` (Adafactor 1e-3, fp32) from the same
    weights, loaded through ``layerwise_params_from_paddle_tpu``: losses
    within 1e-5 relative at every step, and every parameter and optimizer
    state entry within 1e-5 after the last.  Loading the same weights
    through the reference's ``state_dict`` and the port's
    ``set_state_dict`` gives the same buffers."""
    ref_cfg = ref_tiny_config(num_key_value_heads=kv_heads)
    cfg = _port_cfg(ref_cfg)
    ref = ref_lw.LlamaLayerwiseTrainStep(
        ref_cfg, ref_opt.Adafactor(1e-3, parameters=[])).init(0)
    np_params = _np_tree(ref.params)
    port = lw.LlamaLayerwiseTrainStep(cfg, device="cpu").set_params(
        layerwise_params_from_paddle_tpu(np_params))

    via_sd = lw.LlamaLayerwiseTrainStep(cfg, device="cpu").set_state_dict(
        state_from_paddle_tpu({k: np.asarray(v._value)
                               for k, v in ref.state_dict().items()}))
    for name in ("emb", "norm", "head"):
        assert torch.equal(via_sd.params[name], port.params[name]), name
    for name, t in port.params["blocks"].items():
        assert torch.equal(via_sd.params["blocks"][name], t), name

    for ids, lab in _batches(cfg.vocab_size):
        want = float(np.asarray(ref(ids.astype(np.int32), lab)._value))
        got = port(torch.from_numpy(ids), torch.from_numpy(lab))
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    ref_params, ref_state = _np_tree(ref.params), _np_tree(ref.opt_state)
    pairs = [(n, port.params[n], ref_params[n]) for n in
             ("emb", "norm", "head")]
    pairs += [(n, port.params["blocks"][n], ref_params["blocks"][n])
              for n in ref_params["blocks"]]
    for n in ("emb", "norm", "head"):
        pairs += [(n + "." + s, v, ref_state[n][s])
                  for s, v in port.opt_state[n].items()]
    for n, st in ref_state["blocks"].items():
        pairs += [(n + "." + s, port.opt_state["blocks"][n][s], v)
                  for s, v in st.items()]
    for name, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _port_model_and_step(cfg, seed=0):
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    step = lw.LlamaLayerwiseTrainStep(cfg, Adafactor(1e-3, parameters=[]),
                                      device="cpu").from_model(model)
    return model, step


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_layerwise_matches_port_train_step_with_adafactor(kv_heads):
    """The port's own parity (the reference's
    ``test_layerwise_matches_fused_train_step``): three steps of the
    layerwise step against ``TrainStep`` + ``Adafactor`` over the eager
    model from the same weights, losses within 5e-4.  (The eager model
    stores matrices ``[out, in]``, so Adafactor's factors swap roles:
    equal in exact arithmetic, not in fp32 rounding.)"""
    cfg = _port_cfg(ref_tiny_config(num_key_value_heads=kv_heads))
    model, layer = _port_model_and_step(cfg)
    fused = TrainStep(model, LlamaPretrainingCriterion(),
                      Adafactor(1e-3, parameters=model.named_parameters()))
    for ids, lab in _batches(cfg.vocab_size):
        ids, lab = torch.from_numpy(ids), torch.from_numpy(lab)
        l_fused = fused(ids, lab).item()
        l_layer = layer(ids, lab).item()
        assert abs(l_fused - l_layer) < 5e-4 * max(1.0, abs(l_fused)), \
            (l_fused, l_layer)


def test_layerwise_init_trains():
    """``init`` + repeated steps on one batch: the loss falls."""
    cfg = _port_cfg(ref_tiny_config())
    step = lw.LlamaLayerwiseTrainStep(cfg, Adafactor(1e-2, parameters=[]),
                                      device="cpu").init(0)
    assert step.param_count() == sum(
        t.numel() for t in [step.params[n] for n in ("emb", "norm", "head")]
        + list(step.params["blocks"].values()))
    (ids, lab), = _batches(cfg.vocab_size, n=1)
    losses = [step(torch.from_numpy(ids), torch.from_numpy(lab)).item()
              for _ in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_layerwise_checkpoint_interop_with_eager_model():
    """Train layerwise, then ``state_dict`` (the eager model's names and
    layout): the eager model computes the same loss, and the dict loads
    back into a fresh layerwise step."""
    cfg = _port_cfg(ref_tiny_config())
    step = lw.LlamaLayerwiseTrainStep(cfg, Adafactor(1e-2, parameters=[]),
                                      device="cpu").init(0)
    (ids, lab), = _batches(cfg.vocab_size, n=1)
    ids, lab = torch.from_numpy(ids), torch.from_numpy(lab)
    for _ in range(3):
        step(ids, lab)
    sd = step.state_dict()
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        l_eager = LlamaPretrainingCriterion()(model(ids), lab).item()
    l_lw = step(ids, lab).item()
    assert abs(l_eager - l_lw) < 5e-4 * max(1.0, abs(l_eager))
    step2 = lw.LlamaLayerwiseTrainStep(cfg, Adafactor(1e-2, parameters=[]),
                                       device="cpu").set_state_dict(sd)
    assert abs(step2(ids, lab).item() - l_lw) < 5e-4


def test_layerwise_state_dict_matches_reference_layout():
    """The port's ``state_dict`` after ``set_params`` from the reference's
    buffers equals the reference's ``state_dict`` mapped by
    ``state_from_paddle_tpu`` (names, shapes and values)."""
    ref_cfg = ref_tiny_config()
    ref = ref_lw.LlamaLayerwiseTrainStep(
        ref_cfg, ref_opt.Adafactor(1e-3, parameters=[])).init(1)
    port = lw.LlamaLayerwiseTrainStep(_port_cfg(ref_cfg),
                                      device="cpu").set_params(
        layerwise_params_from_paddle_tpu(_np_tree(ref.params)))
    want = state_from_paddle_tpu({k: np.asarray(v._value)
                                  for k, v in ref.state_dict().items()})
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.is_contiguous() and torch.equal(t, want[k]), k


def test_layerwise_step_defaults_to_the_card():
    """Without a device the step is for the card; here there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        lw.LlamaLayerwiseTrainStep(_port_cfg(ref_tiny_config()))


def test_reference_train_step_with_adafactor_matches_port_train_step():
    """``TrainStep`` + ``Adafactor`` (the path the layerwise step is held
    against on the card) against the reference's, fp32, three steps from
    the same weights: losses within 1e-5."""
    from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights
    paddle.seed(0)
    ref_cfg = ref_tiny_config()
    ref = RefLlama(ref_cfg)
    port = LlamaForCausalLM(_port_cfg(ref_cfg), device="cpu")
    load_paddle_tpu_weights(port, {k: np.asarray(v._value)
                                   for k, v in ref.state_dict().items()})
    crit = paddle.models.llama.LlamaPretrainingCriterion()
    ref_step = RefTrainStep(ref, crit, ref_opt.Adafactor(
        1e-3, parameters=ref.parameters()))
    step = TrainStep(port, LlamaPretrainingCriterion(),
                     Adafactor(1e-3, parameters=port.named_parameters()))
    for ids, lab in _batches(ref_cfg.vocab_size, seq=32):
        want = float(np.asarray(ref_step(paddle.to_tensor(ids),
                                         paddle.to_tensor(lab))._value))
        got = step(torch.from_numpy(ids), torch.from_numpy(lab)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)
