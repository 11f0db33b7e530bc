"""The port's training slice against the JAX reference, on the CPU.

The flash wrappers take their plain PyTorch versions for CPU tensors;
these tests hold those plain versions against the reference's Pallas
flash kernels run in interpret mode (as ``tests/test_attention.py`` runs
them) and against the reference's CPU path (``_chunked_sdpa`` after
``_rope_xla``, differentiated with ``jax.vjp``).  Then the optimizer
update, the criterion, the cache-less model and a few ``TrainStep`` steps
against the reference's, on the same numpy inputs and weights.  The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.ops import pallas_kernels as ref_pk
from paddle_tpu.optimizer import optimizer as ref_opt

from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_flops_per_token)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights

# fp32, same algorithm, other summation order: rounding only
FP32_TOL = dict(rtol=1e-5, atol=1e-5)

# (causal, rope, Sq, Sk): square, rectangular with Sk > Sq (causal_off > 0)
# and Sq > Sk (causal_off < 0: the first Sq - Sk rows see nothing)
FLASH_CASES = {
    "causal_rope": (True, True, 64, 64),
    "full_rope": (False, True, 64, 64),
    "causal": (True, False, 64, 64),
    "full": (False, False, 64, 64),
    "rect_causal": (True, False, 32, 64),
    "dead_rows_causal": (True, False, 64, 32),
    "rect_full": (False, False, 64, 32),
}


def _bshd(rng, B, S, H, D):
    return rng.randn(B, S, H, D).astype(np.float32)


def _to_ref(x):
    """[B, S, H, D] numpy -> the reference's [B, H, S, D] jax array."""
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


def _from_ref(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


def _flash_inputs(case, B=1, H=2, D=32, seed=0):
    causal, rope, Sq, Sk = FLASH_CASES[case]
    rng = np.random.RandomState(seed)
    q, g = _bshd(rng, B, Sq, H, D), _bshd(rng, B, Sq, H, D)
    k, v = _bshd(rng, B, Sk, H, D), _bshd(rng, B, Sk, H, D)
    tables = None
    if rope:
        cos, sin = ref_pk.rope_tables(Sq, D)
        tables = (np.asarray(cos), np.asarray(sin))
    return causal, q, k, v, g, tables


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _interpret():
    old = ref_pk._INTERPRET[0]
    ref_pk._INTERPRET[0] = True
    return old


def _ref_flash_fwd(causal, q, k, v, tables):
    old = _interpret()
    try:
        out, lse = ref_pk._flash_attention_value(
            _to_ref(q), _to_ref(k), _to_ref(v), causal, block_q=32,
            block_k=32, with_lse=True,
            rope=None if tables is None else tuple(map(jnp.asarray,
                                                       tables)))
    finally:
        ref_pk._INTERPRET[0] = old
    B, Sq, H, _ = q.shape
    return _from_ref(out), np.asarray(lse).reshape(B, H, Sq)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_forward_matches_pallas_interpret(case):
    """out and lse of the plain forward against the Pallas forward kernel
    (interpret mode, 32-row blocks) within rounding (fp32); rows that see
    nothing give out = 0 and lse = -inf in both."""
    causal, q, k, v, _, tables = _flash_inputs(case)
    want_out, want_lse = _ref_flash_fwd(causal, q, k, v, tables)
    rope = None if tables is None else tuple(_t(*tables))
    out, lse = fa._flash_fwd_plain(*_t(q, k, v), causal, rope)
    np.testing.assert_allclose(out.numpy(), want_out, **FP32_TOL)
    dead = np.isneginf(want_lse)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), dead)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead],
                               **FP32_TOL)
    assert dead.any() == (case == "dead_rows_causal")
    assert (out.numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


@pytest.mark.parametrize("form", ["fused", "two_kernel"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_backward_matches_pallas_interpret(case, form):
    """dq, dk, dv of the CPU backward wrappers against the reference's
    fused (``_flash_attention_bwd_fused``) and two-kernel
    (``_flash_attention_bwd``) Pallas backward in interpret mode, fed the
    same out/lse (fp32, within rounding)."""
    causal, q, k, v, g, tables = _flash_inputs(case, seed=1)
    out, lse = _ref_flash_fwd(causal, q, k, v, tables)
    rope_j = None if tables is None else tuple(map(jnp.asarray, tables))
    ref_fn = (ref_pk._flash_attention_bwd_fused if form == "fused"
              else ref_pk._flash_attention_bwd)
    old = _interpret()
    try:
        want = ref_fn(_to_ref(q), _to_ref(k), _to_ref(v), _to_ref(out),
                      jnp.asarray(lse.reshape(-1, lse.shape[-1])),
                      _to_ref(g), causal, block_q=32, block_k=32,
                      rope=rope_j)
    finally:
        ref_pk._INTERPRET[0] = old
    port_fn = (fa.flash_bwd_fused if form == "fused"
               else fa.flash_bwd_two_kernel)
    before = (fa.flash_bwd_fused.launches, fa.flash_bwd_two_kernel.launches)
    rope = None if tables is None else tuple(_t(*tables))
    got = port_fn(*_t(q, k, v, out, lse, g), causal, rope)
    assert (fa.flash_bwd_fused.launches,
            fa.flash_bwd_two_kernel.launches) == before
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), _from_ref(b), err_msg=name,
                                   **FP32_TOL)


@pytest.mark.parametrize("case", ["causal_rope", "full_rope", "causal",
                                  "full", "rect_causal", "rect_full"])
def test_flash_attention_autograd_matches_reference_cpu_path(case):
    """The public functions (forward through the autograd Functions, the
    backward through ``flash_bwd_auto``) against the reference's CPU path:
    ``_chunked_sdpa`` (after ``_rope_xla`` with rope) and its ``jax.vjp``.
    (Dead rows are left to the Pallas comparison: the chunked VJP gives
    NaN for a row that sees nothing, the kernels give 0.)"""
    causal, q, k, v, g, tables = _flash_inputs(case, B=2, seed=2)
    if tables is not None:
        cos, sin = map(jnp.asarray, tables)

        def ref_fn(a, b, c):
            return ref_pk._chunked_sdpa(ref_pk._rope_xla(a, cos, sin),
                                        ref_pk._rope_xla(b, cos, sin), c,
                                        causal)
    else:
        def ref_fn(a, b, c):
            return ref_pk._chunked_sdpa(a, b, c, causal)
    want, vjp = jax.vjp(ref_fn, _to_ref(q), _to_ref(k), _to_ref(v))
    want_grads = vjp(_to_ref(g))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    if tables is not None:
        out = fa.flash_attention_rope(tq, tk, tv, 10000.0, is_causal=causal)
    else:
        out = fa.flash_attention(tq, tk, tv, is_causal=causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), _from_ref(want),
                               **FP32_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want_grads):
        np.testing.assert_allclose(a.numpy(), _from_ref(b), err_msg=name,
                                   **FP32_TOL)


@pytest.mark.parametrize("output", ["out", "dv"])
def test_bf16_flash_tolerance_rejects_a_dropped_tile(output):
    """``chip_smoke.flash_tolerance`` in bf16 (causal, 512 tokens): it
    admits the plain fp32 result rounded once to bf16 (other rounding
    points than the plain bf16 version), and rejects the plain bf16
    result with one 64-wide tile left out: the last key tile for the last
    query rows (out), or the last query tile's share of dv."""
    from chip_smoke import flash_excess, flash_noise, flash_tolerance
    gen = torch.Generator().manual_seed(5)
    q, k, v, g = (torch.randn(1, 512, 2, 64, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa._flash_fwd_plain(q, k, v, True)
    if output == "out":
        want = out
        f32 = fa._flash_fwd_plain(q.float(), k.float(), v.float(), True)[0]
        noise = flash_noise("flash_fwd", q, k, v, None, None, None, True,
                            None)[0]
        wrong = out.clone()
        wrong[:, -64:] = fa._flash_fwd_plain(q[:, -64:], k[:, :-64],
                                             v[:, :-64], False)[0]
    else:
        want = fa._flash_bwd_plain(q, k, v, out, lse, g, True)[2]
        f32 = fa._flash_bwd_plain(q.float(), k.float(), v.float(),
                                  out.float(), lse, g.float(), True)[2]
        noise = flash_noise("flash_bwd", q, k, v, out, lse, g, True,
                            None)[2]
        last = fa._flash_bwd_plain(q[:, -64:], k, v, out[:, -64:],
                                   lse[..., -64:], g[:, -64:], True)[2]
        wrong = (want.float() - last.float()).to(torch.bfloat16)
    tol = flash_tolerance(want, "bfloat16", noise)
    assert flash_excess(f32.to(torch.bfloat16), want, tol) <= 1.0
    assert flash_excess(wrong, want, tol) > 1.0


@pytest.mark.parametrize("S,D", [(130, 32), (32, 160)],
                         ids=["no_block", "head_dim_160"])
def test_shapes_outside_the_kernel_rule_take_chunked(S, D):
    """Where the reference's ``_pallas_ok`` fails it takes
    ``_chunked_sdpa`` after a graph-level rope.  The port does so only
    for head dim > 128; a sequence length with no usable Pallas block
    still goes through ``FlashRopeAttention`` (the kernels mask any
    length).  Forward and grads agree with the reference either way."""
    rng = np.random.RandomState(3)
    q, k, v, g = (_bshd(rng, 1, S, 2, D) for _ in range(4))
    cos, sin = ref_pk.rope_tables(S, D)
    assert not (D <= 128 and ref_pk._fit_block(256, S) > 0)
    assert fa._kernel_ok(*_t(q)) == (D <= 128)

    def ref_fn(a, b, c):
        return ref_pk._flash_rope_sdpa(a, b, c, cos, sin, True)
    want, vjp = jax.vjp(ref_fn, _to_ref(q), _to_ref(k), _to_ref(v))
    want_grads = vjp(_to_ref(g))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention_rope(tq, tk, tv)
    assert (type(out.grad_fn).__name__ == "FlashRopeAttentionBackward") \
        == (D <= 128)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), _from_ref(want),
                               rtol=1e-5, atol=2e-5)
    for a, b in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(a.numpy(), _from_ref(b), rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [True, False])
def test_flash_functions_pass_gradcheck_fp64(causal, rope):
    """The autograd Functions' backward (the plain backward, in fp64)
    against finite differences of their forward, at a toy shape with a
    rectangular key axis where rope allows it."""
    g = torch.Generator().manual_seed(4)
    Sq, Sk = (8, 8) if rope else (6, 10)
    q = torch.randn(1, Sq, 2, 8, dtype=torch.float64, generator=g)
    k = torch.randn(1, Sk, 2, 8, dtype=torch.float64, generator=g)
    v = torch.randn(1, Sk, 2, 8, dtype=torch.float64, generator=g)
    args = [t.requires_grad_() for t in (q, k, v)]
    if rope:
        cos, sin = fa.rope_tables(Sq, 8)

        def fn(a, b, c):
            return fa.FlashRopeAttention.apply(a, b, c, cos, sin, causal)
    else:
        def fn(a, b, c):
            return fa.FlashAttention.apply(a, b, c, causal)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("Sk", [64, 1024, 2048, 2176, 4096, 8192, 8320,
                                16384])
def test_backward_router_takes_the_reference_form(Sk):
    bk = ref_pk._fit_block(max(1024, Sk // 4), Sk)
    want = Sk <= ref_pk._FUSED_BWD_MAX_SK and bool(bk) and Sk // bk <= 4
    assert fa.fused_bwd_taken(Sk) == want
    assert fa._fit_block(max(1024, Sk // 4), Sk) == bk


@pytest.mark.parametrize("D", [16, 64, 128])
def test_rope_tables_within_one_ulp_of_reference(D):
    got = fa.rope_tables(300, D, 10000.0, position_offset=5)
    want = ref_pk.rope_tables(300, D, 10000.0, position_offset=5)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == (300, D)
        assert (np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                       np.abs(b)))).all()


# ---------------------------------------------------------------------------
# optimizer, criterion, model, train step
# ---------------------------------------------------------------------------
OPT_CASES = {
    "adamw_fp32": ("adamw", "float32", "float32", False),
    "adamw_bf16_moments": ("adamw", "bfloat16", "float32", False),
    "adamw_bf16_params_master": ("adamw", "float32", "bfloat16", True),
    "adamw_bf16_params_bf16_moments": ("adamw", "bfloat16", "bfloat16",
                                       False),
    "adam_l2_fp32": ("adam", "float32", "float32", False),
    "adam_l2_bf16_master": ("adam", "bfloat16", "bfloat16", True),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adam_update_matches_reference_update_rule(case):
    """Three updates of one parameter against the reference's
    ``_update_rule`` (fed the same gradients): parameter, moments, beta
    powers and master weights equal to fp32 rounding, bf16 values to one
    bf16 ulp."""
    kind, moments, pdtype, multi = OPT_CASES[case]
    rng = np.random.RandomState(5)
    p0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    lr, wd = 1e-2, 0.1
    jd = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    ref_p = paddle.create_parameter([6, 5], "float32")
    ref_p._value = jnp.asarray(p0).astype(jd)
    port_p = torch.nn.Parameter(torch.from_numpy(p0).to(td))
    if kind == "adamw":
        ref = ref_opt.AdamW(lr, parameters=[ref_p], weight_decay=wd,
                            multi_precision=multi, moment_dtype=moments)
        port = AdamW(lr, parameters=[("w", port_p)], weight_decay=wd,
                     multi_precision=multi, moment_dtype=moments)
    else:
        ref = ref_opt.Adam(lr, parameters=[ref_p], weight_decay=wd,
                           multi_precision=multi, moment_dtype=moments)
        port = Adam(lr, parameters=[("w", port_p)], weight_decay=wd,
                    multi_precision=multi, moment_dtype=moments)
    st = ref._ensure_state(ref_p)
    pv = ref_p._value
    for gnp in grads:
        pv, st = ref._update_rule(pv, jnp.asarray(gnp).astype(jd), st,
                                  {"lr": jnp.asarray(lr, jnp.float32)})
        port_p.grad = torch.from_numpy(gnp).to(td)
        port.step()
    pst = port.state("w")
    assert sorted(pst) == sorted(k for k in st if k != "wd") + (
        ["wd"] if kind == "adamw" else [])
    assert port._global_step == 3
    for name, a, b in [("param", port_p.detach(), pv)] + [
            (k, pst[k], st[k]) for k in pst]:
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        tol = 2.0 ** -8 * np.abs(b).max() if a.size > 1 and (
            name == "param" and pdtype == "bfloat16"
            or name.startswith("moment") and moments == "bfloat16") \
            else 1e-6 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_criterion_matches_reference():
    """Loss (shifted labels, ignore_index, mean over valid) and the
    logits' gradient against the reference criterion's eager backward."""
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 7)).astype(np.int64)
    labels[0, 3] = labels[1, 5] = -100
    ref_x = paddle.to_tensor(logits, stop_gradient=False)
    ref_loss = RefCriterion()(ref_x, paddle.to_tensor(labels))
    ref_loss.backward()
    x = torch.from_numpy(logits).requires_grad_()
    loss = LlamaPretrainingCriterion()(x, torch.from_numpy(labels))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(np.asarray(
        ref_loss._value)), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_x.grad._value),
                               rtol=1e-5, atol=1e-7)


def _train_pair(recompute, seed=0):
    paddle.seed(seed)
    ref_cfg = ref_tiny_config(recompute=recompute)
    ref = RefLlama(ref_cfg)
    cfg = LlamaConfig(**{f: getattr(ref_cfg, f)
                         for f in LlamaConfig.__dataclass_fields__})
    port = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_weights(port, {k: np.asarray(v._value) for k, v in
                                   ref.state_dict().items()})
    return ref, port


def test_cacheless_logits_match_reference_gqa():
    """llama_tiny_config (4 query heads over 2 kv heads): the training
    forward's logits against the reference's, fp32."""
    ref, port = _train_pair(recompute=False)
    ids = np.random.RandomState(7).randint(0, 1024, (2, 24))
    want = np.asarray(ref(paddle.to_tensor(ids))._value)
    got = port(torch.from_numpy(ids))
    assert port.config.num_key_value_heads * 2 \
        == port.config.num_attention_heads
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)


STEPS, LR = 5, 1e-3


@pytest.mark.parametrize("recompute", [False, True])
def test_train_step_trajectory_matches_reference(recompute):
    """Five AdamW steps with clip-norm through ``TrainStep`` (fp32,
    llama_tiny_config): the step-1 gradients of every parameter and the
    loss of every step agree with the reference's ``TrainStep``; the
    parameters after the last step agree to 2 lr per step (Adam moves a
    parameter whose gradient is ~0 by up to lr either way, so a rounding
    difference there may flip its direction)."""
    ref, port = _train_pair(recompute)
    rng = np.random.RandomState(8)
    # one batch four times, then a fresh one: the loss must fall on the
    # repeated batch
    batches = [rng.randint(0, 1024, (2, 32))] * (STEPS - 1) \
        + [rng.randint(0, 1024, (2, 32))]

    ids = batches[0]
    ref_loss = RefCriterion()(ref(paddle.to_tensor(ids)),
                              paddle.to_tensor(ids))
    ref_loss.backward()
    ref_grads = {k: np.asarray(v.grad._value)
                 for k, v in ref.named_parameters()}
    for p in ref.parameters():
        p.clear_gradient()
    crit = LlamaPretrainingCriterion()
    port.train()
    crit(port(torch.from_numpy(ids)), torch.from_numpy(ids)).backward()
    grads = {k: p.grad.numpy().copy() for k, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    assert set(grads) == set(ref_grads)
    for k, gr in grads.items():
        want = ref_grads[k].T if k.endswith("_proj.weight") \
            or k == "lm_head.weight" else ref_grads[k]
        np.testing.assert_allclose(gr, want, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)

    ref_step = RefTrainStep(ref, RefCriterion(),
                            paddle.optimizer.AdamW(
                                LR, parameters=ref.parameters(),
                                weight_decay=0.01),
                            clip_norm=1.0)
    step = TrainStep(port, crit,
                     AdamW(LR, parameters=port.named_parameters(),
                           weight_decay=0.01), clip_norm=1.0)
    want = [float(np.asarray(ref_step(paddle.to_tensor(b),
                                      paddle.to_tensor(b))._value))
            for b in batches]
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches]
    assert step.global_step == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[STEPS - 2] < got[0]
    ref_state = {k: np.asarray(v._value) for k, v in
                 ref.state_dict().items()}
    for k, p in port.state_dict().items():
        want_p = ref_state[k].T if k.endswith("_proj.weight") \
            or k == "lm_head.weight" else ref_state[k]
        np.testing.assert_allclose(p.numpy(), want_p, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=k)


def test_flops_per_token_matches_reference():
    from paddle_tpu.models.llama import llama_flops_per_token as ref_fpt
    from paddle_tpu.models.llama import llama_7b_config as ref_7b
    from paddle_tpu_torch.models.llama import llama_7b_config
    assert llama_flops_per_token(llama_7b_config(), 2048) \
        == ref_fpt(ref_7b(), 2048)
    assert math.isclose(llama_flops_per_token(llama_7b_config(), 2048),
                        6 * 6738415616 + 12 * 32 * 4096 * 2048)
