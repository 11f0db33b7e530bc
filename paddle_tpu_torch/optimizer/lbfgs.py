"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

The parameters are flattened into one fp32 vector, so the two-loop
recursion is a handful of dot products and axpys on the device; the line
search's control flow (a few scalars an iteration) runs on the host.
``step(closure)`` drives re-evaluation: the closure recomputes the loss
and calls ``backward()`` at each trial point, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .optimizer import Optimizer, Params

__all__ = ["LBFGS"]


def _flat(params: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.detach().to(torch.float32).reshape(-1)
                      for p in params])


@torch.no_grad()
def _unflat_assign(params: List[torch.Tensor], vec: torch.Tensor) -> None:
    off = 0
    for p in params:
        n = p.numel()
        p.copy_(vec[off:off + n].view(p.shape))
        off += n


def _flat_grad(params: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([
        torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
        if p.grad is None else p.grad.to(torch.float32).reshape(-1)
        for p in params])


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through ``(x1, f1, g1)`` and ``(x2, f2,
    g2)``, clamped to ``bounds`` (the line search's interpolation step)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square ** 0.5
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) /
                                        (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) /
                                        (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


class LBFGS(Optimizer):
    """Limited-memory BFGS with an optional strong-Wolfe line search
    (``line_search_fn="strong_wolfe"``)."""

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = None,
                 parameters: Optional[Params] = None, weight_decay=None):
        super().__init__(learning_rate, parameters, weight_decay)
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self._max_iter = max_iter
        self._max_eval = max_eval
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        self._line_search_fn = line_search_fn
        self._trainable = [p for _, p in self._params if p.requires_grad]
        self._hist: Dict[str, list] = {"s": [], "y": [], "rho": []}
        self._n_evals = 0

    def _evaluate(self, closure, x: torch.Tensor):
        _unflat_assign(self._trainable, x)
        loss = closure()
        self._n_evals += 1
        return float(loss), _flat_grad(self._trainable)

    def _strong_wolfe(self, closure, x, t, d, f, g, gtd,
                      c1=1e-4, c2=0.9, max_ls=25):
        d_norm = float(d.abs().max())
        g_prev, f_prev, t_prev = g, f, 0.0
        done = False
        ls_iter = 0
        f_new, g_new = self._evaluate(closure, x + t * d)
        gtd_new = _dot(g_new, d)

        # bracket phase
        bracket = bracket_f = bracket_g = bracket_gtd = None
        while ls_iter < max_ls:
            if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and
                                              f_new >= f_prev):
                bracket, bracket_f = [t_prev, t], [f_prev, f_new]
                bracket_g = [g_prev, g_new]
                bracket_gtd = [_dot(g_prev, d), gtd_new]
                break
            if abs(gtd_new) <= -c2 * gtd:
                done = True
                bracket, bracket_f, bracket_g = [t, t], [f_new, f_new], \
                    [g_new, g_new]
                break
            if gtd_new >= 0:
                bracket, bracket_f = [t_prev, t], [f_prev, f_new]
                bracket_g = [g_prev, g_new]
                bracket_gtd = [_dot(g_prev, d), gtd_new]
                break
            min_step = t + 0.01 * (t - t_prev)
            max_step = t * 10
            tmp = t
            t = _cubic_interpolate(t_prev, f_prev, _dot(g_prev, d),
                                   t, f_new, gtd_new,
                                   bounds=(min_step, max_step))
            t_prev, f_prev, g_prev = tmp, f_new, g_new
            f_new, g_new = self._evaluate(closure, x + t * d)
            gtd_new = _dot(g_new, d)
            ls_iter += 1
        if bracket is None:
            bracket, bracket_f, bracket_g = [0, t], [f, f_new], [g, g_new]
            bracket_gtd = [gtd, gtd_new]

        # zoom phase
        insuf_progress = False
        low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] \
            else (1, 0)
        while not done and ls_iter < max_ls:
            if abs(bracket[1] - bracket[0]) * d_norm < self._tol_change:
                break
            t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                                   bracket[1], bracket_f[1], bracket_gtd[1])
            eps = 0.1 * (max(bracket) - min(bracket))
            if min(max(bracket) - t, t - min(bracket)) < eps:
                if insuf_progress or t >= max(bracket) or t <= min(bracket):
                    t = max(bracket) - eps if abs(t - max(bracket)) < \
                        abs(t - min(bracket)) else min(bracket) + eps
                    insuf_progress = False
                else:
                    insuf_progress = True
            else:
                insuf_progress = False
            f_new, g_new = self._evaluate(closure, x + t * d)
            gtd_new = _dot(g_new, d)
            ls_iter += 1
            if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
                bracket[high_pos] = t
                bracket_f[high_pos] = f_new
                bracket_g[high_pos] = g_new
                bracket_gtd[high_pos] = gtd_new
                low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] \
                    else (1, 0)
            else:
                if abs(gtd_new) <= -c2 * gtd:
                    done = True
                elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                    bracket[high_pos] = bracket[low_pos]
                    bracket_f[high_pos] = bracket_f[low_pos]
                    bracket_g[high_pos] = bracket_g[low_pos]
                    bracket_gtd[high_pos] = bracket_gtd[low_pos]
                bracket[low_pos] = t
                bracket_f[low_pos] = f_new
                bracket_g[low_pos] = g_new
                bracket_gtd[low_pos] = gtd_new
        t = bracket[low_pos]
        return bracket_f[low_pos], bracket_g[low_pos], t

    def step(self, closure: Optional[Callable] = None) -> torch.Tensor:
        """Up to ``max_iter`` L-BFGS iterations from the current
        parameters, each evaluating ``closure`` (which returns the loss
        after its ``backward()``); returns the first evaluation's loss."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "re-evaluates the model")

        def eval_closure():
            # the closure computes the loss and its backward: fresh grads
            for p in self._trainable:
                p.grad = None
            with torch.enable_grad():
                return closure()

        with torch.no_grad():
            return self._step_impl(eval_closure)

    def _step_impl(self, eval_closure) -> torch.Tensor:
        self._n_evals = 0
        x = _flat(self._trainable)
        loss, g = self._evaluate(eval_closure, x)
        orig_loss = loss
        if float(g.abs().max()) <= self._tol_grad:
            return torch.tensor(orig_loss, dtype=torch.float32)

        hist = self._hist
        lr = self.get_lr()
        for it in range(self._max_iter):
            # two-loop recursion
            q = g
            alphas = []
            for s, y, rho in zip(reversed(hist["s"]), reversed(hist["y"]),
                                 reversed(hist["rho"])):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if hist["s"]:
                s, y = hist["s"][-1], hist["y"][-1]
                r = q * (torch.dot(s, y) / torch.dot(y, y))
            else:
                r = q
            for (s, y, rho), a in zip(
                    zip(hist["s"], hist["y"], hist["rho"]),
                    reversed(alphas)):
                b = rho * torch.dot(y, r)
                r = r + s * (a - b)
            d = -r

            gtd = _dot(g, d)
            if gtd > -self._tol_change:
                break
            t = min(1.0, 1.0 / float(g.abs().sum())) * lr \
                if it == 0 else lr

            if self._line_search_fn == "strong_wolfe":
                new_loss, new_g, t = self._strong_wolfe(
                    eval_closure, x, t, d, loss, g, gtd)
                x_new = x + t * d
            else:
                x_new = x + t * d
                new_loss, new_g = self._evaluate(eval_closure, x_new)

            s = x_new - x
            y = new_g - g
            ys = _dot(y, s)
            if ys > 1e-10:
                if len(hist["s"]) >= self._history_size:
                    for k in ("s", "y", "rho"):
                        hist[k].pop(0)
                hist["s"].append(s)
                hist["y"].append(y)
                hist["rho"].append(1.0 / ys)

            x, loss, g = x_new, new_loss, new_g
            if self._n_evals >= self._max_eval:
                break
            if float(g.abs().max()) <= self._tol_grad:
                break
            if float((t * d).abs().max()) <= self._tol_change:
                break

        _unflat_assign(self._trainable, x)
        self._global_step += 1
        return torch.tensor(orig_loss, dtype=torch.float32)
