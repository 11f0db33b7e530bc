"""Sequence decoding (counterpart of ``paddle_tpu/nn/decode.py``):
``BeamSearchDecoder`` over a cell and ``dynamic_decode``, the reference's
loop.  Each step runs the cell (``cell(inputs, states) -> (outputs,
new_states)``) on the ``batch * beam`` rows, extends every beam by the
top ``beam`` of ``beam * vocab`` summed log-probabilities (a finished
beam only by ``end_token``, at no cost) and gathers the cell states to
their new beams; the parent pointers are followed back on the host."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """The decoder protocol: ``initialize``, ``step``, ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def _v(x):
    return x._value if isinstance(x, Tensor) else torch.as_tensor(x)


class BeamSearchDecoder(Decoder):
    """``cell`` an RNN cell; ``embedding_fn`` maps ids to embeddings,
    ``output_fn`` cell outputs to vocabulary logits."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...] (each row repeated beam times)."""
        return Tensor._from_value(torch.repeat_interleave(_v(x), beam_size,
                                                          dim=0))

    def _merge(self, v):
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _split(self, v):
        return v.reshape((-1, self.beam_size) + tuple(v.shape[1:]))

    def _map_states(self, states, fn):
        if isinstance(states, (list, tuple)):
            return type(states)(self._map_states(s, fn) for s in states)
        return Tensor._from_value(fn(_v(states)))

    def initialize(self, initial_cell_states):
        K = self.beam_size
        states = self._map_states(
            initial_cell_states,
            lambda v: torch.repeat_interleave(v, K, dim=0))
        some = states[0] if isinstance(states, (list, tuple)) else states
        dev = _v(some).device
        B = _v(some).shape[0] // K
        ids = torch.full((B, K), self.start_token, dtype=torch.int64,
                         device=dev)
        # only beam 0 is live at first: top-k then picks distinct
        # continuations of the one start hypothesis
        log_probs = torch.tensor([[0.0] + [-1e9] * (K - 1)],
                                 dtype=torch.float32, device=dev).repeat(B, 1)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        return (Tensor._from_value(ids), states,
                {"log_probs": log_probs, "finished": finished})

    def step(self, time, inputs, states, beam_state=None):
        K = self.beam_size
        ids = _v(inputs)                                 # [B, K]
        B = ids.shape[0]
        emb = Tensor._from_value(ids.reshape(-1))
        if self.embedding_fn is not None:
            emb = self.embedding_fn(emb)
        cell_out, next_states = self.cell(emb, states)
        logits = self.output_fn(cell_out) if self.output_fn is not None \
            else cell_out
        logit_v = _v(logits).detach().to(torch.float32)   # [BK, V]
        V = logit_v.shape[-1]
        step_lp = torch.log_softmax(logit_v, dim=-1).reshape(B, K, V)
        prev_lp = beam_state["log_probs"]
        prev_fin = beam_state["finished"]
        end_only = torch.full((V,), -1e9, device=logit_v.device)
        end_only[self.end_token] = 0.0
        step_lp = torch.where(prev_fin[..., None], end_only[None, None],
                              step_lp)
        total = prev_lp[..., None] + step_lp              # [B, K, V]
        top_lp, top_idx = torch.topk(total.reshape(B, K * V), K, dim=-1)
        beam_idx = torch.div(top_idx, V, rounding_mode="floor")
        token_idx = top_idx % V

        def gather(v):
            s = self._split(v)                            # [B, K, ...]
            idx = beam_idx.reshape((B, K) + (1,) * (s.dim() - 2))
            return self._merge(torch.gather(s, 1, idx.expand(s.shape)))

        next_states = self._map_states(next_states, gather)
        finished = torch.gather(prev_fin, 1, beam_idx) \
            | (token_idx == self.end_token)
        return (Tensor._from_value(token_idx), Tensor._from_value(beam_idx),
                next_states, {"log_probs": top_lp, "finished": finished})

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 100, output_time_major=False,
                   impute_finished=False, is_test=False,
                   return_length=False, **kwargs):
    """Run ``decoder`` until every beam finished or ``max_step_num``:
    ``(ids [B, K, T], beam log-probs)`` (and the lengths with
    ``return_length``)."""
    inputs, states, beam = decoder.initialize(inits)
    B, K = _v(inputs).shape
    step_tokens, step_parents = [], []
    lengths = torch.zeros((B, K), dtype=torch.int64,
                          device=_v(inputs).device)
    for t in range(int(max_step_num)):
        tokens, parents, states, beam = decoder.step(
            t, inputs, states, beam_state=beam)
        step_tokens.append(_v(tokens).cpu().numpy())
        step_parents.append(_v(parents).cpu().numpy())
        # lengths follow their hypotheses through the beam reorder
        lengths = torch.gather(lengths, 1, _v(parents))
        lengths = torch.where(beam["finished"] & (lengths == 0),
                              torch.full_like(lengths, t + 1), lengths)
        inputs = tokens
        if bool(beam["finished"].all()):
            break
    T = len(step_tokens)
    lengths = torch.where(lengths == 0, torch.full_like(lengths, T),
                          lengths)
    # the parent pointers followed back (gather_tree)
    seq = np.zeros((B, K, T), np.int64)
    for b in range(B):
        for k in range(K):
            kk = k
            for t in range(T - 1, -1, -1):
                seq[b, k, t] = step_tokens[t][b, kk]
                kk = int(step_parents[t][b, kk])
    out_ids = Tensor._from_value(torch.from_numpy(seq).to(lengths.device))
    scores = Tensor._from_value(beam["log_probs"])
    if return_length:
        return out_ids, scores, Tensor._from_value(lengths)
    return out_ids, scores
