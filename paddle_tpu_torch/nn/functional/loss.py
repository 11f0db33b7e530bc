"""Loss functions (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` with hard labels over the last axis takes the
reference's fused path (:class:`_SoftmaxXent`): the forward keeps only
the rows' fp32 logsumexp, the backward writes ``(softmax - onehot) * g``
in the logits' dtype, so no fp32 log-probabilities of the whole vocab
are held for the backward.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...ops._helpers import inexact, promote, targ


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


class _SoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross entropy for hard labels (reference:
    ``_fused_softmax_xent``)."""

    @staticmethod
    def forward(ctx, logits, safe_idx, valid):
        xm = logits.amax(dim=-1).to(torch.float32)
        s = torch.exp(logits.to(torch.float32) - xm[..., None]).sum(dim=-1)
        lse = torch.log(s) + xm
        picked = torch.gather(logits, -1, safe_idx[..., None])[..., 0].to(
            torch.float32)
        ctx.save_for_backward(logits, safe_idx, valid, lse)
        return torch.where(valid, lse - picked, 0.0)

    @staticmethod
    def backward(ctx, g):
        logits, safe_idx, valid, lse = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        p.scatter_add_(-1, safe_idx[..., None],
                       torch.full_like(lse[..., None], -1.0))
        scale = (g * valid.to(torch.float32))[..., None]
        return (p * scale).to(logits.dtype), None, None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy (hard or soft labels, class weights, label
    smoothing, ``ignore_index``), the reference's."""
    has_w = weight is not None

    def fn(logits, lab, *w):
        def logp():
            if use_softmax:
                return torch.log_softmax(logits.to(torch.float32), dim=axis)
            return torch.log(torch.clamp(logits.to(torch.float32), 1e-10,
                                         1.0))
        C = logits.shape[axis]
        if soft_label or (lab.dim() == logits.dim() and lab.shape[axis] == C
                          and lab.is_floating_point()):
            soft = lab.to(torch.float32)
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / C
            return _reduce(-torch.sum(soft * logp(), dim=axis), reduction)
        li = lab.squeeze(axis) if lab.dim() == logits.dim() else lab
        li = li.to(torch.int64)
        valid = li != ignore_index
        safe = torch.where(valid, li, torch.zeros_like(li))
        if use_softmax and axis in (-1, logits.dim() - 1) \
                and label_smoothing == 0 and not w:
            loss = _SoftmaxXent.apply(logits, safe, valid)
            if reduction == "mean":
                return loss.sum() / torch.clamp(
                    valid.to(torch.float32).sum(), min=1.0)
            return _reduce(loss, reduction)
        lp = logp()
        ax = axis % logits.dim()
        picked = torch.gather(lp, ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0:
            picked = (1 - label_smoothing) * picked \
                + label_smoothing * lp.mean(dim=ax)
        loss = torch.where(valid, -picked, 0.0)
        if w:
            wt = w[0].to(torch.float32)[safe]
            loss = loss * torch.where(valid, wt, 0.0)
            if reduction == "mean":
                return loss.sum() / torch.clamp(
                    torch.where(valid, wt, 0.0).sum(), min=1e-12)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.to(torch.float32).sum(),
                                            min=1.0)
        return _reduce(loss, reduction)

    args = (input, targ(label)) + ((targ(weight),) if has_w else ())
    return apply_op("cross_entropy", fn, args)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1, name=None):
    from ...ops.manipulation import unsqueeze
    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        from .activation import softmax as _softmax
        return loss, _softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, lab, *w):
        p = torch.clamp(p.to(torch.float32), 1e-7, 1 - 1e-7)
        loss = -(lab * torch.log(p) + (1 - lab) * torch.log1p(-p))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = (input, targ(label)) + ((targ(weight),) if weight is not None
                                   else ())
    return apply_op("binary_cross_entropy", fn, args)


def _log1p_exp_neg_abs(z):
    return torch.logaddexp(torch.zeros_like(z), -torch.abs(z))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    has_w, has_pw = weight is not None, pos_weight is not None

    def fn(z, lab, *extra):
        z, lab = z.to(torch.float32), lab.to(torch.float32)
        w = extra[0] if has_w else None
        pw = extra[1 if has_w else 0] if has_pw else None
        if pw is not None:
            log_w = (pw - 1) * lab + 1
            loss = (1 - lab) * z + log_w * (_log1p_exp_neg_abs(z)
                                            + torch.clamp(-z, min=0.0))
        else:
            loss = torch.clamp(z, min=0) - z * lab + _log1p_exp_neg_abs(z)
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [logit, targ(label)] + [targ(t) for t in (weight, pos_weight)
                                   if t is not None]
    return apply_op("bce_with_logits", fn, tuple(args))


def mse_loss(input, label, reduction="mean", name=None):
    return apply_op("mse_loss", lambda a, b: _reduce(
        torch.square(a - b), reduction), (input, targ(label)))


def l1_loss(input, label, reduction="mean", name=None):
    return apply_op("l1_loss", lambda a, b: _reduce(
        torch.abs(a - b), reduction), (input, targ(label)))


def square_error_cost(input, label, name=None):
    return apply_op("square_error_cost", lambda a, b: torch.square(a - b),
                    (input, targ(label)))


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_op("log_loss", lambda p, lab: -lab * torch.log(
        p + epsilon) - (1 - lab) * torch.log(1 - p + epsilon),
        (input, targ(label)))


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def fn(logp, lab, *w):
        lab = lab.to(torch.int64)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        picked = torch.gather(logp, 1, safe[:, None]).squeeze(1)
        loss = torch.where(valid, -picked, 0.0)
        if w:
            wt = w[0][safe]
            loss = loss * torch.where(valid, wt, 0.0)
            if reduction == "mean":
                return loss.sum() / torch.clamp(
                    torch.where(valid, wt, 0.0).sum(), min=1e-12)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.to(torch.float32).sum(),
                                            min=1.0)
        return _reduce(loss, reduction)
    args = (input, targ(label)) + ((targ(weight),) if weight is not None
                                   else ())
    return apply_op("nll_loss", fn, args)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def fn(logp, t):
        if log_target:
            loss = torch.exp(t) * (t - logp)
        else:
            loss = t * (torch.log(torch.clamp(t, min=1e-10)) - logp)
            loss = torch.where(t > 0, loss, 0.0)
        if reduction == "batchmean":
            return loss.sum() / logp.shape[0]
        return _reduce(loss, reduction)
    return apply_op("kl_div", fn, (input, targ(label)))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def fn(a, b):
        d = torch.abs(a - b)
        return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                                   d - 0.5 * delta), reduction)
    return apply_op("smooth_l1_loss", fn, (input, targ(label)))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply_op("margin_ranking_loss", lambda a, b, lab: _reduce(
        torch.clamp(-lab * (a - b) + margin, min=0.0), reduction),
        (input, targ(other), targ(label)))


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def fn(a, b, lab):
        cos = torch.sum(a * b, -1) / torch.clamp(
            torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1),
            min=1e-12)
        loss = torch.where(lab == 1, 1 - cos,
                           torch.clamp(cos - margin, min=0.0))
        return _reduce(loss, reduction)
    return apply_op("cosine_embedding_loss", fn,
                    (input1, targ(input2), targ(label)))


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply_op("hinge_embedding_loss", lambda a, lab: _reduce(
        torch.where(lab == 1, a, torch.clamp(margin - a, min=0.0)),
        reduction), (input, targ(label)))


def _pdist(a, b, p, epsilon):
    return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                               -1), 1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def fn(a, pos, neg):
        dp, dn = _pdist(a, pos, p, epsilon), _pdist(a, neg, p, epsilon)
        if swap:
            dn = torch.minimum(dn, _pdist(pos, neg, p, epsilon))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
    return apply_op("triplet_margin_loss", fn,
                    (input, targ(positive), targ(negative)))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, lab, *n):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * lab + _log1p_exp_neg_abs(z)
        p_t = p * lab + (1 - p) * (1 - lab)
        a_t = alpha * lab + (1 - alpha) * (1 - lab)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if n:
            loss = loss / n[0]
        return _reduce(loss, reduction)
    args = (logit, targ(label)) + ((targ(normalizer),)
                                   if normalizer is not None else ())
    return apply_op("sigmoid_focal_loss", fn, args)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC by the alpha recursion in log space over ``log_probs`` [T, B,
    C] (the reference's recursion, a step per frame)."""
    def fn(lp, lab, in_len, lab_len):
        T, Bn, C = lp.shape
        L = lab.shape[1]
        S = 2 * L + 1
        neg_inf = -1e30
        ext = torch.full((Bn, S), blank, dtype=torch.int64, device=lp.device)
        ext[:, 1::2] = lab.to(torch.int64)
        full = lambda n: torch.full((Bn, n), neg_inf, dtype=lp.dtype,
                                    device=lp.device)
        init = torch.cat([lp[0, :, blank][:, None],
                          torch.gather(lp[0], 1, ext[:, 1:2]), full(S - 2)],
                         1)
        same = torch.cat([torch.zeros(Bn, 2, dtype=torch.bool,
                                      device=lp.device),
                          ext[:, 2:] == ext[:, :-2]], 1)
        skip_bad = same | (ext == blank)
        alphas = [init]
        alpha = init
        for t in range(1, T):
            a1 = torch.cat([full(1), alpha[:, :-1]], 1)
            a2 = torch.where(skip_bad, neg_inf,
                             torch.cat([full(2), alpha[:, :-2]], 1))
            merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
            alpha = merged + torch.gather(lp[t], 1, ext)
            alphas.append(alpha)
        alphas = torch.stack(alphas, 0)
        t_idx = in_len.to(torch.int64) - 1
        final = alphas[t_idx, torch.arange(Bn, device=lp.device)]
        s_last = 2 * lab_len.to(torch.int64)
        ll = torch.logaddexp(
            torch.gather(final, 1, s_last[:, None])[:, 0],
            torch.gather(final, 1, torch.clamp(s_last - 1, min=0)[:, None]
                         )[:, 0])
        loss = -ll
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(
                lab_len.to(torch.float32), min=1.0))
        return _reduce(loss, reduction)
    return apply_op("ctc_loss", fn, (log_probs, targ(labels),
                                     targ(input_lengths),
                                     targ(label_lengths)))


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_op("soft_margin_loss", lambda x, y: _reduce(
        TF.softplus(-y.to(x.dtype) * x), reduction), (input, targ(label)))


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def fn(x, y, *w):
        C = x.shape[1]
        y = y.to(torch.int64)
        xy = torch.gather(x, 1, y[:, None])
        h = torch.clamp(margin - xy + x, min=0.0)
        if p != 1:
            h = torch.pow(h, p)
        if w:
            h = h * w[0][y][:, None]
        h = h * (1.0 - TF.one_hot(y, C).to(x.dtype))
        return _reduce(torch.sum(h, dim=1) / C, reduction)
    args = (input, targ(label)) + ((targ(weight),)
                                   if weight is not None else ())
    return apply_op("multi_margin_loss", fn, args)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def fn(x, y, *w):
        y = y.to(x.dtype)
        per = y * TF.softplus(-x) + (1 - y) * TF.softplus(x)
        if w:
            per = per * w[0]
        return _reduce(torch.mean(per, dim=-1), reduction)
    args = (input, targ(label)) + ((targ(weight),)
                                   if weight is not None else ())
    return apply_op("multi_label_soft_margin_loss", fn, args)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    def fn(x, y):
        y = y.to(x.dtype)
        loss = torch.exp(x) - y * x if log_input \
            else x - y * torch.log(x + epsilon)
        if full:
            stirling = y * torch.log(y) - y + 0.5 * torch.log(2.0 * np.pi * y)
            loss = loss + torch.where(y > 1.0, stirling, 0.0)
        return _reduce(loss, reduction)
    return apply_op("poisson_nll_loss", fn, (input, targ(label)))


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, y, var):
        var = torch.clamp(var.to(mu.dtype), min=epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(y.to(mu.dtype) - mu)
                      / var)
        if full:
            loss = loss + 0.5 * math.log(2.0 * math.pi)
        return _reduce(loss, reduction)
    return apply_op("gaussian_nll_loss", fn,
                    (input, targ(label), targ(variance)))


def dice_loss(input, label, epsilon=1e-5, name=None):
    def fn(x, y):
        oh = TF.one_hot(y[..., 0].to(torch.int64), x.shape[-1]).to(x.dtype)
        red = tuple(range(1, x.dim()))
        inse = torch.sum(x * oh, dim=red)
        denom = torch.sum(x, dim=red) + torch.sum(oh, dim=red)
        return torch.mean(1.0 - 2.0 * inse / (denom + epsilon))
    return apply_op("dice_loss", fn, (input, targ(label)))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def fn(a, p, lab):
        n = a.shape[0]
        lab = lab.reshape(n, 1).to(a.dtype)
        eq = (lab == lab.T).to(a.dtype)
        tgt = eq / eq.sum(dim=1, keepdim=True)
        l2 = (torch.mean(torch.sum(a * a, 1))
              + torch.mean(torch.sum(p * p, 1))) * 0.25 * l2_reg
        xent = -torch.sum(tgt * torch.log_softmax(a @ p.T, dim=-1), dim=-1)
        return torch.mean(xent) + l2
    return apply_op("npair_loss", fn, (anchor, targ(positive),
                                       targ(labels)))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-style margin softmax cross entropy over cosine logits (the
    whole class axis local; ``group`` raises, as the reference's)."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy(group=...): class-sharded logits are "
            "not ported")

    def fn(x, y):
        y = y.to(torch.int64)
        xf = x.to(torch.float32)
        tgt = torch.gather(xf, 1, y[:, None])[:, 0]
        if margin1 != 1.0 or margin2 != 0.0:
            theta = torch.acos(torch.clamp(tgt, -1.0, 1.0))
            tgt = torch.cos(margin1 * theta + margin2)
        tgt = tgt - margin3
        oh = TF.one_hot(y, x.shape[1]).to(torch.bool)
        mod = torch.where(oh, tgt[:, None], xf) * scale
        logp = torch.log_softmax(mod, dim=-1)
        red = _reduce(-torch.gather(logp, 1, y[:, None]), reduction)
        if return_softmax:
            return red, torch.exp(logp).to(x.dtype)
        return red
    return apply_op("margin_cross_entropy", fn, (logits, targ(label)))


del inexact, promote
