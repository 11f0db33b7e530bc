"""GPT-2 through the paddle API, port against reference on the CPU: a tiny
GPT (2 layers, 64 wide, 4 heads, vocab 97, 16 positions, dropout 0) from
the same carried weights takes 3 AdamW steps with a global-norm clip in
both packages.  Every loss and every parameter's gradient norm (before
the clip) must agree to 1e-5.  The reference's side runs through
``Layer.functional_call`` under ``jax.jit`` + ``jax.value_and_grad`` (its
eager tape is slow at this size); the port's runs eagerly through the API
(``loss.backward()``, ``opt.step()``), which is what it is for.  The
flash kernels' launch counters stay where they were: the CPU path runs
their plain versions."""
import jax
import numpy as np
import pytest

import paddle_tpu as R
from paddle_tpu.models.gpt import GPTConfig as RConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RGPT
import paddle_tpu_torch as P
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.testing.parity import api_state_from_paddle_tpu
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

TINY = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
B, S, STEPS, TOL = 2, 16, 3, 1e-5
FLASH = (fa.flash_fwd, fa.flash_bwd_fused, fa.flash_bwd_two_kernel)


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab_size"], (B, S + 1)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


def _reference_run(model, ids, labels):
    opt = R.optimizer.AdamW(1e-3, parameters=model.parameters(),
                            grad_clip=R.nn.ClipGradByGlobalNorm(1.0))
    params = dict(model.named_parameters())

    def loss_fn(state, x, y):
        logits = model.functional_call(state, R.Tensor(x))
        return R.nn.functional.cross_entropy(
            logits.reshape([-1, TINY["vocab_size"]]),
            R.Tensor(y).reshape([-1]))._value

    step = jax.jit(jax.value_and_grad(loss_fn))
    losses, norms = [], []
    for _ in range(STEPS):
        loss, grads = step(model.functional_state(), ids, labels)
        losses.append(float(loss))
        norms.append({k: float(np.linalg.norm(np.asarray(g, np.float64)))
                      for k, g in grads.items()})
        for k, g in grads.items():
            params[k]._grad = g
        opt.step()
        opt.clear_grad()
    return losses, norms


def _port_run(model, ids, labels):
    opt = P.optimizer.AdamW(1e-3, parameters=model.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    params = dict(model.named_parameters())
    losses, norms = [], []
    x, y = P.to_tensor(ids), P.to_tensor(labels)
    for _ in range(STEPS):
        logits = model(x)
        loss = P.nn.functional.cross_entropy(
            logits.reshape([-1, TINY["vocab_size"]]), y.reshape([-1]))
        loss.backward()
        losses.append(float(loss))
        norms.append({k: float(np.linalg.norm(p.grad.numpy().astype(
            np.float64))) for k, p in params.items()})
        opt.step()
        opt.clear_grad()
    return losses, norms


def test_tiny_gpt_three_adamw_steps_match_the_reference():
    before = [f.launches for f in FLASH]
    R.seed(3)
    ref = RGPT(RConfig(**TINY))
    model = GPTForCausalLM(GPTConfig(**TINY))
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    missing, unexpected = model.set_state_dict(
        api_state_from_paddle_tpu(state))
    assert not missing and not unexpected
    assert list(model.state_dict()) == list(ref.state_dict())
    ids, labels = _batch()
    want_losses, want_norms = _reference_run(ref, ids, labels)
    got_losses, got_norms = _port_run(model, ids, labels)
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL, atol=TOL)
    assert want_losses[-1] < want_losses[0]
    for got, want in zip(got_norms, want_norms):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= TOL * max(1.0, want[k]), (
                k, got[k], want[k])
    # the clip bit: the global norm is above 1 at the first step
    assert sum(v ** 2 for v in want_norms[0].values()) ** 0.5 > 1.0
    assert [f.launches for f in FLASH] == before
    # the traced reference step drew nothing from the reference's global
    # generator (a draw inside a trace would leave a tracer there)
    assert not isinstance(R.ops.random.default_generator()._key,
                          jax.core.Tracer)
