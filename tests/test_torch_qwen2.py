"""The port's Qwen2 (Llama with q/k/v biases and grouped-query
attention) against the JAX reference, on the CPU.

The config's defaults (Qwen2-7B's widths) and its refusal of
``attention_bias=False``; the tiny model (4 query heads over 2 kv heads,
random q/k/v biases carried across) for logits (1e-5) and eager tokens
(byte-identical); the mixed, bucketed split and w8 mixed engines
byte-identical to the reference's engines and to eager ``generate``; and
five ``TrainStep`` steps (AdamW, clip 1.0) against the reference's
``TrainStep`` (losses within 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU)

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.qwen import Qwen2Config as RefQwen2Config
from paddle_tpu.models.qwen import Qwen2ForCausalLM as RefQwen2
from paddle_tpu.models.qwen import \
    Qwen2PretrainingCriterion as RefQwen2Criterion
from paddle_tpu.models.qwen import qwen2_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models import (Qwen2Config, Qwen2ForCausalLM,
                                     Qwen2PretrainingCriterion,
                                     qwen2_tiny_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

PROMPTS = [np.array([7, 9, 2], np.int64),
           np.array([3, 14, 15, 92, 65], np.int64),
           np.arange(1, 11, dtype=np.int64)]
BUDGET = 4
ENGINES = {"mixed": dict(mixed_step=True, prefill_chunk_size=4),
           "split": dict(prefill_buckets="auto", prefill_chunk_size=4),
           "mixed_w8": dict(mixed_step=True, prefill_chunk_size=4,
                            weight_quant="int8")}


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _pair(seed=0):
    """(reference Qwen2, the port's with the reference's weights), with
    the reference's q/k/v biases set to random values first (they start
    at zero)."""
    paddle.seed(seed)
    ref_cfg = ref_tiny_config()
    ref = RefQwen2(ref_cfg)
    ref.eval()
    rng = np.random.RandomState(seed + 11)
    for name, p in ref.named_parameters():
        if name.endswith(".bias"):
            p.set_value(rng.randn(*p.shape).astype(np.float32) * 0.1)
    cfg = Qwen2Config(**{f: getattr(ref_cfg, f)
                         for f in Qwen2Config.__dataclass_fields__})
    port = Qwen2ForCausalLM(cfg, device="cpu")
    load_paddle_tpu_weights(port, {k: _np(v)
                                   for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def eager_tokens(pair):
    ref, _port = pair
    return [_np(ref.generate(paddle.to_tensor(p[None, :]),
                             max_new_tokens=BUDGET))[0, len(p):].tolist()
            for p in PROMPTS]


def test_config_defaults_and_bias_requirement():
    """Every field default equals the reference's (Qwen2-7B: hidden 3584,
    28 layers, 28 query heads over 4 kv heads, vocabulary 151936); both
    models refuse ``attention_bias=False``."""
    ref = dataclasses.asdict(RefQwen2Config())
    mine = dataclasses.asdict(Qwen2Config())
    assert {k: ref[k] for k in mine} == mine
    assert (mine["hidden_size"], mine["num_hidden_layers"],
            mine["num_attention_heads"], mine["num_key_value_heads"]) \
        == (3584, 28, 28, 4)
    with pytest.raises(ValueError, match="attention_bias"):
        Qwen2ForCausalLM(qwen2_tiny_config(attention_bias=False),
                         device="cpu")
    with pytest.raises(ValueError, match="attention_bias"):
        RefQwen2(ref_tiny_config(attention_bias=False))


def test_biases_carry_and_logits_and_tokens_match(pair, eager_tokens):
    """The q/k/v biases arrive as they are (nonzero); the training
    forward's logits within 1e-5; eager tokens byte-identical."""
    ref, port = pair
    b = port.llama.layers[0].self_attn.k_proj.bias
    want_b = _np(ref.state_dict()["llama.layers.0.self_attn.k_proj.bias"])
    assert torch.equal(b.detach(), torch.from_numpy(np.array(want_b)))
    assert b.abs().max() > 0
    ids = np.random.RandomState(7).randint(0, 1024, (2, 24))
    want = _np(ref(paddle.to_tensor(ids)))
    got = port(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert [port.generate(torch.from_numpy(p[None, :]),
                          max_new_tokens=BUDGET)[0, len(p):].tolist()
            for p in PROMPTS] == eager_tokens


def _serve(cls, model, **kw):
    eng = cls(model, max_batch_size=4, num_blocks=64, block_size=4, **kw)
    rids = []
    for i, p in enumerate(PROMPTS):
        rids.append(eng.add_request(p, BUDGET))
        if i == 0:
            eng.step()
    eng.run_to_completion()
    return [list(eng.result(r)) for r in rids]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_tokens_match_reference(pair, eager_tokens, engine):
    """Tokens byte-identical to the reference's engine (w8: the
    reference's w8 engine) and, in fp, to eager ``generate``."""
    ref, port = pair
    kw = ENGINES[engine]
    want = _serve(RefEngine, ref, **kw)
    got = _serve(ContinuousBatchingEngine, port, device="cpu", **kw)
    assert got == want
    if "weight_quant" not in kw:
        assert got == eager_tokens


STEPS, LR = 5, 1e-3


def test_train_step_trajectory_matches_reference():
    """Five AdamW steps (weight decay 0.01, clip 1.0) through
    ``TrainStep``, one batch four times then a fresh one: losses within
    1e-5 of the reference's ``TrainStep``; the loss falls on the repeated
    batch."""
    ref, port = _pair(seed=1)
    ref.train()
    port.train()
    rng = np.random.RandomState(8)
    batches = [rng.randint(0, 1024, (2, 32))] * (STEPS - 1) \
        + [rng.randint(0, 1024, (2, 32))]
    ref_step = RefTrainStep(ref, RefQwen2Criterion(),
                            paddle.optimizer.AdamW(
                                LR, parameters=ref.parameters(),
                                weight_decay=0.01), clip_norm=1.0)
    step = TrainStep(port, Qwen2PretrainingCriterion(),
                     AdamW(LR, parameters=port.named_parameters(),
                           weight_decay=0.01), clip_norm=1.0)
    want = [float(_np(ref_step(paddle.to_tensor(b), paddle.to_tensor(b))))
            for b in batches]
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[STEPS - 2] < got[0]
