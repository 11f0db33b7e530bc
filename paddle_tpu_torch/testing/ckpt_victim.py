"""A training run to kill: ``python -m paddle_tpu_torch.testing.ckpt_victim
CKPT_DIR LOSS_OUT [STEPS]`` trains a tiny fp32 Llama on the CPU through
the port's ``TrainStep`` (AdamW, clip 1.0, one seeded batch a step) for
``STEPS`` steps (default 8), saving an async checkpoint after every step
under ``CKPT_DIR`` (``-``: no checkpoints).  It first resumes from the
newest valid checkpoint there, if any, and writes the losses of the steps
it ran, as JSON, to ``LOSS_OUT`` when it ends.  Arm a fault with
``PADDLE_TPU_FAULT_SPEC`` (``kill:ckpt.write:after=3`` dies mid-save)."""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

STEPS = 8
KEY = "model.llama.layers.0.mlp.up_proj.weight"    # a key the tests read


def build():
    from ..jit.train_step import TrainStep
    from ..models.llama import (LlamaForCausalLM, LlamaPretrainingCriterion,
                                llama_tiny_config)
    from ..optimizer import AdamW
    cfg = llama_tiny_config(hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, num_key_value_heads=2,
                            intermediate_size=64, vocab_size=64)
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    opt = AdamW(1e-2, parameters=model.named_parameters())
    return TrainStep(model, LlamaPretrainingCriterion(), opt, clip_norm=1.0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ckpt_dir, out = argv[0], argv[1]
    steps = int(argv[2]) if len(argv) > 2 else STEPS
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(1, 64, (4, 8)))
               for _ in range(steps)]
    step = build()
    mgr, start = None, 0
    if ckpt_dir != "-":
        from ..distributed.checkpoint import CheckpointManager
        mgr = CheckpointManager(ckpt_dir, keep_last_k=3)
        state = mgr.load()
        if state is not None:
            step.load_train_state(state)
            start = int(state.meta["global_step"])
    losses = []
    for i in range(start, steps):
        losses.append(step(batches[i], batches[i]).item())
        if mgr is not None:
            mgr.save(i + 1, step.ckpt_values(), {"global_step": i + 1})
    if mgr is not None:
        mgr.wait()
    with open(out, "w") as f:
        json.dump(losses, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
