"""Layer-wise backward with the optimizer update inside the reverse sweep
(counterpart of ``paddle_tpu/jit/layerwise.py``): the max-resident
single-device training form.

    step = LlamaLayerwiseTrainStep(cfg)          # Adafactor(1e-3)
    step.init(seed=0)                            # or .from_model(model)
    loss = step(input_ids, labels)

A ``TrainStep`` holds every parameter's gradient before the update.  Here
each layer's gradients exist only while that layer is swept: peak memory
is the parameters, the per-layer activation checkpoints ([L, B, S, H]),
one layer's working set and one chunk of the head.  One call:

1. runs the forward layer by layer under ``no_grad``, saving each layer's
   *input* into the checkpoint buffer;
2. computes the head loss under autograd (:func:`_head_loss`: the final
   norm, then fp32 logits per token chunk, each chunk recomputed in the
   backward, so ``[B*S, V]`` fp32 never exists);
3. sweeps the layers in reverse: recompute layer ``l`` from its
   checkpoint with autograd, take the gradients of its parameters and of
   its input, then apply the optimizer's rule in place to the layer's
   slice of each stacked buffer and of its state;
4. updates the embedding (its gradient summed in fp32, then cast to the
   embedding's dtype), the final norm and the head.

Parameters are stacked buffers in the reference's layout: block matrices
``[L, in, out]`` (the block computes ``x @ w``; Adafactor's row factor runs
over ``in``), norms ``[L, h]``, ``emb`` [V, h], ``norm`` [h], ``head``
[h, V].  The port's ``LlamaForCausalLM`` layout (``[out, in]``) appears only
in :meth:`~LlamaLayerwiseTrainStep.from_model`,
:meth:`~LlamaLayerwiseTrainStep.state_dict` and
:meth:`~LlamaLayerwiseTrainStep.set_state_dict`.

Kernels: the norms run kernel #4's layerwise variant (``ops.rms_norm``
with ``round_first``: the reference's ``_rms_norm`` rounds the normalised
input before the weight multiply), attention the flash kernels
(``ops.flash_attention``), on [B, S, H, D] in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig, param_count
from ..ops.flash_attention import flash_rope_sdpa, rope_tables
from ..ops.rms_norm import RMSNormKernel
from ..optimizer import Adafactor, Optimizer

__all__ = ["LlamaLayerwiseTrainStep"]


def rms_norm(x, w, eps):
    """Kernel #4's layerwise variant with its gradient (reference:
    ``_rms_norm``), by a module-level name (as is ``flash_rope_sdpa``) so
    that a parity run can put the plain versions in."""
    return RMSNormKernel.apply(x, w, eps, True)


# stacked-buffer leaf -> LlamaForCausalLM parameter name
_KEY_MAP = {
    "wq": "llama.layers.{}.self_attn.q_proj.weight",
    "wk": "llama.layers.{}.self_attn.k_proj.weight",
    "wv": "llama.layers.{}.self_attn.v_proj.weight",
    "wo": "llama.layers.{}.self_attn.o_proj.weight",
    "gate": "llama.layers.{}.mlp.gate_proj.weight",
    "up": "llama.layers.{}.mlp.up_proj.weight",
    "down": "llama.layers.{}.mlp.down_proj.weight",
    "ln1": "llama.layers.{}.input_layernorm.weight",
    "ln2": "llama.layers.{}.post_attention_layernorm.weight",
}
_HEAD_CHUNK = 2048
_IGNORE = -100


def _is_matrix(name: str) -> bool:
    return not name.startswith("ln")


def _block_fn(p: Dict[str, torch.Tensor], h: torch.Tensor, cos, sin,
              cfg: LlamaConfig) -> torch.Tensor:
    """One decoder block over the per-layer parameters ``p`` (reference:
    ``_block_fn``)."""
    B, S, H = h.shape
    nh, kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dh = H // nh
    eps = cfg.rms_norm_eps
    x = rms_norm(h, p["ln1"], eps)
    q = (x @ p["wq"]).reshape(B, S, nh, dh)
    k = (x @ p["wk"]).reshape(B, S, kv, dh)
    v = (x @ p["wv"]).reshape(B, S, kv, dh)
    if kv != nh:
        k = k.repeat_interleave(nh // kv, dim=2)
        v = v.repeat_interleave(nh // kv, dim=2)
    out = flash_rope_sdpa(q, k, v, cos, sin, True).reshape(B, S, nh * dh)
    h = h + out @ p["wo"]
    x = rms_norm(h, p["ln2"], eps)
    return h + (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def _chunk_nll(xk, lk, head_w):
    """Summed fp32 negative log-likelihood of one token chunk."""
    logits = (xk @ head_w).to(torch.float32)            # (chunk, V)
    valid = lk != _IGNORE
    tgt = torch.where(valid, lk, 0)
    lse = torch.logsumexp(logits, dim=-1)
    tok = logits.gather(1, tgt[:, None])[:, 0]
    return ((lse - tok) * valid).sum()


def _head_loss(hL, norm_w, head_w, labels, cfg: LlamaConfig,
               chunk: int = _HEAD_CHUNK) -> torch.Tensor:
    """Shift-by-one LM loss with fp32 log-softmax (reference:
    ``_head_loss``): labels roll left with the last position ignored, the
    tokens are padded to whole chunks, each chunk's logits are recomputed
    in the backward, and the loss is the mean over valid tokens."""
    B, S, H = hL.shape
    x = rms_norm(hL, norm_w, cfg.rms_norm_eps).reshape(B * S, H)
    tail = torch.full((B, 1), _IGNORE, dtype=labels.dtype,
                      device=labels.device)
    shift = torch.cat([labels[:, 1:], tail], dim=1).reshape(B * S)
    pad = (-(B * S)) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros(pad, H)])
        shift = torch.cat([shift, shift.new_full((pad,), _IGNORE)])
    total = torch.zeros((), dtype=torch.float32, device=hL.device)
    for x_c, l_c in zip(x.split(chunk), shift.split(chunk)):
        total = total + checkpoint(_chunk_nll, x_c, l_c, head_w,
                                   use_reentrant=False)
    count = (shift != _IGNORE).sum().to(torch.float32)
    return total / torch.clamp(count, min=1.0)


class LlamaLayerwiseTrainStep:
    """Single-device max-resident Llama pretraining step (see the module
    docstring).  ``optimizer`` defaults to ``Adafactor(1e-3)``; any
    :class:`~paddle_tpu_torch.optimizer.Optimizer` whose ``_update_rule``
    updates a tensor in place works.  ``device=None`` is the CUDA card."""

    def __init__(self, cfg: LlamaConfig, optimizer: Optional[Optimizer] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = cfg.torch_dtype
        self.opt = optimizer if optimizer is not None else \
            Adafactor(1e-3, parameters=[])
        self.params: Optional[Dict] = None
        self.opt_state: Optional[Dict] = None

    # -- parameters -----------------------------------------------------------
    def _shapes(self):
        c = self.cfg
        h, i, v = c.hidden_size, c.intermediate_size, c.vocab_size
        dh = h // c.num_attention_heads
        qd, kvd = c.num_attention_heads * dh, c.num_key_value_heads * dh
        L = c.num_hidden_layers
        blocks = {"wq": (L, h, qd), "wk": (L, h, kvd), "wv": (L, h, kvd),
                  "wo": (L, qd, h), "gate": (L, h, i), "up": (L, h, i),
                  "down": (L, i, h), "ln1": (L, h), "ln2": (L, h)}
        return {"emb": (v, h), "norm": (h,), "head": (h, v),
                "blocks": blocks}

    @torch.no_grad()
    def init(self, seed: int = 0) -> "LlamaLayerwiseTrainStep":
        """Random init on the step's device from a ``torch.Generator``
        seeded ``seed``: normal(0, initializer_range) for matrices, ones
        for norms, in ``cfg.dtype``."""
        gen = torch.Generator(self.device).manual_seed(seed)
        kw = dict(dtype=self.dtype, device=self.device)
        std = self.cfg.initializer_range
        shapes = self._shapes()

        def normal(shape):
            return torch.empty(shape, **kw).normal_(0.0, std, generator=gen)

        self.params = {"emb": normal(shapes["emb"]),
                       "norm": torch.ones(shapes["norm"], **kw),
                       "head": normal(shapes["head"]),
                       "blocks": {name: normal(shp) if _is_matrix(name)
                                  else torch.ones(shp, **kw)
                                  for name, shp in
                                  sorted(shapes["blocks"].items())}}
        self.opt_state = self._init_opt_state()
        return self

    @torch.no_grad()
    def set_params(self, params: Dict) -> "LlamaLayerwiseTrainStep":
        """Take ``params`` (the stacked layout: ``emb``, ``norm``, ``head``
        and ``blocks``) as copies on the step's device and dtype, checking
        every shape, and reset the optimizer state."""
        shapes = self._shapes()

        def take(name, t, shape):
            t = torch.as_tensor(t)
            if tuple(t.shape) != tuple(shape):
                raise ValueError("%s: shape %s, want %s"
                                 % (name, tuple(t.shape), shape))
            return t.to(self.device, self.dtype, copy=True,
                        memory_format=torch.contiguous_format)

        if set(params["blocks"]) != set(shapes["blocks"]):
            raise KeyError("blocks: %s, want %s" % (
                sorted(params["blocks"]), sorted(shapes["blocks"])))
        self.params = {name: take(name, params[name], shapes[name])
                       for name in ("emb", "norm", "head")}
        self.params["blocks"] = {
            name: take(name, params["blocks"][name], shp)
            for name, shp in shapes["blocks"].items()}
        self.opt_state = self._init_opt_state()
        return self

    def from_model(self, model) -> "LlamaLayerwiseTrainStep":
        """Adopt (copies of) the weights of a ``LlamaForCausalLM``."""
        return self.set_state_dict(model.state_dict())

    def set_state_dict(self, state) -> "LlamaLayerwiseTrainStep":
        """Load a ``LlamaForCausalLM``-layout state dict (``[out, in]``
        matrices) into the stacked buffers.  The optimizer state is reset,
        as the reference does: moments gathered for other weights do not
        apply to the loaded ones."""
        def val(key, transpose):
            t = torch.as_tensor(state[key])
            return t.t() if transpose else t

        L = self.cfg.num_hidden_layers
        return self.set_params({
            "emb": val("llama.embed_tokens.weight", False),
            "norm": val("llama.norm.weight", False),
            "head": val("lm_head.weight", True),
            "blocks": {name: torch.stack([val(fmt.format(l), _is_matrix(name))
                                          for l in range(L)])
                       for name, fmt in _KEY_MAP.items()}})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights in ``LlamaForCausalLM``'s names and layout (copies),
        so that a layerwise-trained model loads into the eager model, and
        back."""
        if self.params is None:
            raise RuntimeError("no parameters: call init() or from_model()")

        def copy(t):
            return t.clone(memory_format=torch.contiguous_format)

        out = {"llama.embed_tokens.weight": copy(self.params["emb"]),
               "llama.norm.weight": copy(self.params["norm"]),
               "lm_head.weight": copy(self.params["head"].t())}
        for name, stacked in self.params["blocks"].items():
            for l in range(self.cfg.num_hidden_layers):
                t = stacked[l]
                out[_KEY_MAP[name].format(l)] = copy(
                    t.t() if _is_matrix(name) else t)
        return out

    def _init_opt_state(self):
        """The optimizer's state per leaf; the block parameters' states
        stacked over L (the sweep takes one layer's slice)."""
        p = self.params
        L = self.cfg.num_hidden_layers

        def stacked(name, buf):
            st = self.opt._init_state(name, buf[0])
            return {k: v.unsqueeze(0).repeat(L, *([1] * v.dim())).contiguous()
                    for k, v in st.items()}

        state = {name: self.opt._init_state(name, p[name])
                 for name in ("emb", "norm", "head")}
        state["blocks"] = {name: stacked(name, buf)
                           for name, buf in p["blocks"].items()}
        return state

    def param_count(self) -> int:
        return param_count(self.cfg)

    # -- the step -------------------------------------------------------------
    def __call__(self, ids, labels) -> torch.Tensor:
        """One step on ``ids`` [B, S] with ``labels`` [B, S]; returns the
        fp32 loss (detached)."""
        if self.params is None:
            raise RuntimeError("call init() or from_model() first")
        cfg, opt, p = self.cfg, self.opt, self.params
        blocks, bstate = p["blocks"], self.opt_state["blocks"]
        L = cfg.num_hidden_layers
        lr = opt.get_lr()
        ids = torch.as_tensor(ids).to(self.device, torch.long)
        labels = torch.as_tensor(labels).to(self.device, torch.long)
        B, S = ids.shape
        H = cfg.hidden_size
        cos, sin = rope_tables(S, H // cfg.num_attention_heads,
                               cfg.rope_theta, device=self.device)

        # 1. forward, saving each layer's input
        with torch.no_grad():
            h = F.embedding(ids, p["emb"])
            xs = torch.empty((L, B, S, H), dtype=self.dtype,
                             device=self.device)
            for l in range(L):
                xs[l].copy_(h)
                h = _block_fn({k: b[l] for k, b in blocks.items()}, h, cos,
                              sin, cfg)

        # 2. head loss and its gradients
        with torch.enable_grad():
            hL = h.requires_grad_()
            norm_w = p["norm"].detach().requires_grad_()
            head_w = p["head"].detach().requires_grad_()
            loss = _head_loss(hL, norm_w, head_w, labels, cfg)
            dh, dnorm, dhead = torch.autograd.grad(loss, (hL, norm_w, head_w))
        del hL, h

        # 3. reverse sweep: one layer's gradients, then its update
        names = list(blocks)
        for l in reversed(range(L)):
            with torch.enable_grad():
                p_l = [blocks[k][l].detach().requires_grad_() for k in names]
                x_l = xs[l].detach().requires_grad_()
                out = _block_fn(dict(zip(names, p_l)), x_l, cos, sin, cfg)
                *grads, dh = torch.autograd.grad(out, p_l + [x_l], dh)
            del out, p_l, x_l
            with torch.no_grad():
                for k, g in zip(names, grads):
                    opt._update_rule(blocks[k][l], g,
                                     {s: v[l] for s, v in bstate[k].items()},
                                     lr)
            del grads
        del xs

        # 4. embedding (fp32 sum, cast before the update), norm, head
        with torch.no_grad():
            demb = torch.zeros(p["emb"].shape, dtype=torch.float32,
                               device=self.device)
            demb.index_add_(0, ids.reshape(-1),
                            dh.reshape(-1, H).to(torch.float32))
            demb = demb.to(p["emb"].dtype)
            for name, g in (("emb", demb), ("norm", dnorm), ("head", dhead)):
                opt._update_rule(p[name], g, self.opt_state[name], lr)
        return loss.detach()
