"""The functional tail (counterpart of
``paddle_tpu/nn/functional/extended.py``): ``pairwise_distance``,
``triplet_margin_with_distance_loss``, ``hsigmoid_loss``, ``rnnt_loss``,
``class_center_sample`` and ``fractional_max_pool3d``, each in the
reference's math.  ``rnnt_loss`` is the reference's alpha recursion as a
plain PyTorch loop over the lattice (torch has no RNN-T loss of its own);
torch's autograd through it gives the occupancy gradients."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...core.tensor import Tensor
from ...ops._helpers import targ
from ...ops.random import generator_for


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False,
                      name=None):
    def fn(a, b):
        d = a - b + epsilon
        if p == float("inf"):
            return torch.amax(torch.abs(d), dim=-1, keepdim=keepdim)
        if p == 0:
            return torch.sum((d != 0).to(a.dtype), dim=-1, keepdim=keepdim)
        return torch.sum(torch.abs(d) ** p, dim=-1,
                         keepdim=keepdim) ** (1.0 / p)
    return apply_op("pairwise_distance", fn, (x, targ(y)))


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (lambda a, b: pairwise_distance(a, b))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dsn = dist(positive, negative)
        dn = apply_op("minimum", torch.minimum, (dn, targ(dsn)))

    def fn(a, b):
        return _reduce(torch.clamp(a - b + margin, min=0.0), reduction)
    return apply_op("triplet_margin_loss", fn, (dp, targ(dn)))


@functools.lru_cache(maxsize=32)
def _hsigmoid_tree(C: int):
    """The default complete binary tree's path table, codes and mask (a
    function of ``num_classes`` alone)."""
    depth = max(1, int(math.ceil(math.log2(C))))
    table = np.zeros((C, depth), np.int64)
    code = np.zeros((C, depth), np.float32)
    valid = np.zeros((C, depth), np.float32)
    for c in range(C):
        # root-to-leaf walk: node ids are the heap positions of c + C
        bits = bin(c + C)[3:]
        node = 1
        for d, b in enumerate(bits):
            table[c, d] = node - 1
            code[c, d] = 1.0 if b == "1" else 0.0
            valid[c, d] = 1.0
            node = node * 2 + (1 if b == "1" else 0)
    return table, code, valid


def _host(x):
    return x._value if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (the
    path of class c: the bits of ``c + num_classes`` from the root) or a
    custom ``path_table``/``path_code`` pair; ``weight`` [C - 1, D]."""
    C = int(num_classes)
    if path_table is None:
        table, code, valid = (torch.from_numpy(a)
                              for a in _hsigmoid_tree(C))
    else:
        table = _host(path_table).to(torch.int64)
        code = _host(path_code).to(torch.float32)
        valid = (table >= 0).to(torch.float32)
        table = torch.clamp(table, min=0)

    args = [input, label, targ(weight)] + ([bias] if bias is not None
                                           else [])

    def fn(x, lab, w, *b):
        dev = x.device
        lab = lab.reshape(-1).to(torch.int64)
        nodes = table.to(dev)[lab]
        codes = code.to(dev)[lab]
        mask = valid.to(dev)[lab]
        logits = torch.einsum("bd,bnd->bn", x.to(torch.float32),
                              w[nodes].to(torch.float32))
        if b:
            logits = logits + b[0].reshape(-1)[nodes]
        # BCE with logits a node, the code its target
        per = torch.clamp(logits, min=0) - logits * codes \
            + torch.log1p(torch.exp(-torch.abs(logits)))
        return (per * mask).sum(-1, keepdim=True)

    return apply_op("hsigmoid_loss", fn, tuple(args))


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """The RNN-Transducer loss: ``input`` [B, T, U + 1, V] logits (log
    softmax taken here), ``label`` [B, U].  FastEmit is not implemented,
    as in the reference: a nonzero ``fastemit_lambda`` raises."""
    if fastemit_lambda:
        raise NotImplementedError(
            "rnnt_loss: fastemit_lambda != 0 is not supported yet")

    def fn(logits, lab, in_len, lab_len):
        B, T, U1, V = logits.shape
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        lab = lab.to(torch.int64)
        p_blank = logp[..., blank]                            # [B, T, U+1]
        lab_pad = TF.pad(lab, (0, 1))                         # [B, U+1]
        p_emit = torch.gather(
            logp, -1, lab_pad[:, None, :, None].expand(B, T, U1, 1))[..., 0]
        # t = 0: emissions only; the lattice in float64, as the
        # reference's (its zeros take the x64 default)
        col = torch.zeros(B, dtype=torch.float64, device=logits.device)
        row = [col]
        for u in range(1, U1):
            col = col + p_emit[:, 0, u - 1]
            row.append(col)
        rows = [torch.stack(row, 1)]
        for t in range(1, T):
            from_blank = rows[-1] + p_blank[:, t - 1, :]
            prev = from_blank[:, 0]
            row = [prev]
            for u in range(1, U1):
                prev = torch.logaddexp(from_blank[:, u],
                                       prev + p_emit[:, t, u - 1])
                row.append(prev)
            rows.append(torch.stack(row, 1))
        alpha = torch.stack(rows, 1)                          # [B, T, U+1]
        bi = torch.arange(B, device=logits.device)
        t_last = (in_len - 1).to(torch.int64)
        u_last = lab_len.to(torch.int64)
        ll = alpha[bi, t_last, u_last] + p_blank[bi, t_last, u_last]
        return _reduce(-ll, reduction)

    return apply_op("rnnt_loss", fn,
                    (input, targ(label), targ(input_lengths),
                     targ(label_lengths)))


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """``num_samples`` class centres, the labels' classes always among
    them: ``(remapped_label, sampled_class_index)``.  The negatives are
    drawn afresh each call by a numpy generator seeded from the framework
    generator (the seed's contract)."""
    lab_np = np.asarray(_host(label).cpu()).astype(np.int64)
    pos = np.unique(lab_np)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        seed = torch.randint(0, 2 ** 31 - 1, (4,),
                             generator=generator_for("cpu")).numpy()
        rng = np.random.default_rng(seed.astype(np.uint32))
        extra = rng.choice(rest, num_samples - len(pos), replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (Tensor(remap[lab_np]), Tensor(sampled.astype(np.int64)))


def fractional_max_pool3d(x, output_size, kernel_size=None,
                          random_u=None, return_mask=False, name=None):
    """Fractional max pooling over the last three dims: region edges
    ``ceil(alpha (i + u)) - ceil(alpha u)`` (``u`` 0.5 when not given, as
    the reference)."""
    xs = x.shape
    D, H, W = xs[-3], xs[-2], xs[-1]
    if isinstance(output_size, int):
        od = oh = ow = output_size
    else:
        od, oh, ow = output_size
    u = float(random_u) if random_u is not None else 0.5

    def edges(in_sz, out_sz):
        alpha = in_sz / out_sz
        idx = np.arange(out_sz + 1)
        e = np.ceil(alpha * (idx + u)).astype(np.int64) \
            - int(np.ceil(alpha * u))
        e = np.clip(e, 0, in_sz)
        e[-1] = in_sz
        return e

    ed, eh, ew = edges(D, od), edges(H, oh), edges(W, ow)

    def fn(v):
        outs, masks = [], []
        for i in range(od):
            for j in range(oh):
                for k in range(ow):
                    win = v[..., ed[i]:ed[i + 1], eh[j]:eh[j + 1],
                            ew[k]:ew[k + 1]]
                    outs.append(win.amax((-3, -2, -1)))
                    if return_mask:
                        wh = int(eh[j + 1] - eh[j])
                        ww = int(ew[k + 1] - ew[k])
                        am = win.reshape(win.shape[:-3] + (-1,)).argmax(-1)
                        dz = torch.div(am, wh * ww, rounding_mode="floor")
                        rem = am % (wh * ww)
                        dy = torch.div(rem, ww, rounding_mode="floor")
                        dx = rem % ww
                        masks.append(((int(ed[i]) + dz) * H + int(eh[j])
                                      + dy) * W + int(ew[k]) + dx)
        out = torch.stack(outs, -1).reshape(v.shape[:-3] + (od, oh, ow))
        if return_mask:
            m = torch.stack(masks, -1).reshape(
                v.shape[:-3] + (od, oh, ow)).to(torch.int64)
            return out, m
        return out

    return apply_op("fractional_max_pool3d", fn, (x,))
