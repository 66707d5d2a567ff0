"""L-BFGS, the closure-driven quasi-Newton method of
``paddle_tpu/optimizer/lbfgs.py``: the two-loop recursion over a bounded
history of (s, y) pairs and an optional strong-Wolfe line search with
cubic interpolation (``_cubic_min``), in the JAX package's order and
with its constants.

The parameters are viewed as one flat f32 vector on their device. The
history is a ring of ``history_size`` slots, each an (s, y) pair of
flat vectors on that device; once full, the oldest slot is overwritten
in place. The two-loop recursion runs on the device (its scalars stay
there); only the line search's control flow, which depends on the
values by nature, reads numbers back, as the JAX package does.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _normalize_weight_decay

__all__ = ["LBFGS"]


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2), clamped
    to [lo, hi]; the midpoint where the discriminant is negative."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    sq = d1 * d1 - g1 * g2
    if sq < 0:
        return (lo + hi) / 2.0
    d2 = sq ** 0.5
    if x1 <= x2:
        t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
    else:
        t = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
    return min(max(t, lo), hi)


class LBFGS(Optimizer):
    """``opt.step(closure)``: ``closure()`` clears the gradients,
    evaluates the loss, calls its ``backward()`` and returns it; the step
    returns the first evaluation's loss as a 0-d tensor.

        opt = LBFGS(parameters=model.parameters(),
                    line_search_fn="strong_wolfe")

        def closure():
            opt.clear_grad()
            loss = loss_fn(model(x), y)
            loss.backward()
            return loss

        loss = opt.step(closure)

    ``grad_clip`` and ``weight_decay`` (L1 or L2, a parameter's own
    ``regularizer`` first) shape the gradient the direction and the
    search see, and the decay's term is added to every evaluated loss,
    as in the JAX package."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
        )
        self.max_iter = int(max_iter)
        self.max_eval = int(max_eval if max_eval is not None
                            else max_iter * 5 // 4)
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', got "
                f"{line_search_fn!r}"
            )
        self.line_search_fn = line_search_fn
        # the ring: slots of (s, y), ``_head`` the next slot to write,
        # ``_len`` the pairs held (oldest at (_head - _len) % size)
        self._ring = []
        self._head = 0
        self._len = 0
        self._func_evals = 0

    # -- the flat view ------------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _decay_cfg(self):
        """Per parameter (kind, coeff): its own ``regularizer`` (even a
        zero one) before the optimizer's ``weight_decay``."""
        out = []
        for p in self._params():
            preg = getattr(p, "regularizer", None)
            out.append(_normalize_weight_decay(
                preg if preg is not None else self._default_weight_decay))
        return out

    def _gather_flat_grad(self):
        """The flat f32 gradient: clipped first, then the coupled decay
        added (never clipped), the base class's order."""
        params = self._params()
        gs = [p.grad.detach().clone() if p.grad is not None
              else torch.zeros_like(p) for p in params]
        if self._grad_clip is not None:
            self._grad_clip.clip_(gs, [getattr(p, "need_clip", True)
                                       for p in params])
        out = []
        for p, g, (kind, coeff) in zip(params, gs, self._decay_cfg()):
            if kind == "l2" and coeff:
                g = g + coeff * p.detach().to(g.dtype)
            elif kind == "l1" and coeff:
                g = g + coeff * torch.sign(p.detach()).to(g.dtype)
            out.append(g.reshape(-1).float())
        return torch.cat(out)

    def _decay_loss(self):
        """The objective term whose gradient ``_gather_flat_grad`` adds
        (l2: coeff / 2 ||w||^2, l1: coeff |w|_1), one read for all."""
        total = None
        for p, (kind, coeff) in zip(self._params(), self._decay_cfg()):
            w = p.detach().float()
            if kind == "l2" and coeff:
                term = 0.5 * coeff * w.square().sum()
            elif kind == "l1" and coeff:
                term = coeff * w.abs().sum()
            else:
                continue
            total = term if total is None else total + term
        return float(total) if total is not None else 0.0

    @torch.no_grad()
    def _set_flat_params(self, flat):
        offset = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[offset:offset + n].view_as(p))
            offset += n

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._params()])

    # -- the history ring ---------------------------------------------------
    def _push(self, s, y):
        """Keep (s, y) in the next slot, overwriting the oldest pair when
        the ring is full."""
        if len(self._ring) < self.history_size:
            self._ring.append((s.clone(), y.clone()))
        else:
            self._ring[self._head][0].copy_(s)
            self._ring[self._head][1].copy_(y)
        self._head = (self._head + 1) % self.history_size
        self._len = min(self._len + 1, self.history_size)

    def _history(self):
        """The held pairs, oldest first."""
        start = (self._head - self._len) % self.history_size
        return [self._ring[(start + i) % self.history_size]
                for i in range(self._len)]

    def _direction(self, grad):
        """-H g by the two-loop recursion (JAX's ``_two_loop``)."""
        pairs = self._history()
        if not pairs:
            return -grad
        rho = [1.0 / torch.dot(s, y).clamp_min(1e-10) for s, y in pairs]
        s_last, y_last = pairs[-1]
        h_diag = (torch.dot(s_last, y_last)
                  / torch.dot(y_last, y_last).clamp_min(1e-10))
        q = grad.clone()
        alphas = [None] * len(pairs)
        for i in range(len(pairs) - 1, -1, -1):
            s, y = pairs[i]
            alphas[i] = rho[i] * torch.dot(s, q)
            q -= alphas[i] * y
        r = q * h_diag
        for i, (s, y) in enumerate(pairs):
            beta = rho[i] * torch.dot(y, r)
            r += s * (alphas[i] - beta)
        return -r

    # -- strong Wolfe line search (host-driven, like the JAX one) -----------
    def _strong_wolfe(self, eval_fn, x0, loss0, grad0, d, alpha0,
                      c1=1e-4, c2=0.9, max_ls=25):
        dg0 = float(torch.dot(grad0, d))
        if dg0 >= 0:
            return alpha0, loss0, grad0   # not a descent direction
        a_prev, f_prev, g_prev = 0.0, loss0, dg0
        a, f_lo, g_lo = alpha0, loss0, dg0
        grad_a = grad0
        bracketed = False
        for _ in range(max_ls):
            f_a, grad_a = eval_fn(x0 + a * d)
            dg_a = float(torch.dot(grad_a, d))
            if f_a > loss0 + c1 * a * dg0 or (bracketed and f_a >= f_prev):
                hi, f_hi, g_hi = a, f_a, dg_a
                lo, f_lo, g_lo = a_prev, f_prev, g_prev
                break
            if abs(dg_a) <= -c2 * dg0:
                return a, f_a, grad_a
            if dg_a >= 0:
                hi, f_hi, g_hi = a_prev, f_prev, g_prev
                lo, f_lo, g_lo = a, f_a, dg_a
                break
            a_prev, f_prev, g_prev = a, f_a, dg_a
            a = a * 2.0
            bracketed = True
        else:
            return a, f_a, grad_a
        # zoom between lo and hi
        for _ in range(max_ls):
            a = _cubic_min(lo, f_lo, g_lo, hi, f_hi, g_hi,
                           min(lo, hi) + 0.1 * abs(hi - lo),
                           max(lo, hi) - 0.1 * abs(hi - lo))
            f_a, grad_a = eval_fn(x0 + a * d)
            dg_a = float(torch.dot(grad_a, d))
            if f_a > loss0 + c1 * a * dg0 or f_a >= f_lo:
                hi, f_hi, g_hi = a, f_a, dg_a
            else:
                if abs(dg_a) <= -c2 * dg0:
                    return a, f_a, grad_a
                if dg_a * (hi - lo) >= 0:
                    hi, f_hi, g_hi = lo, f_lo, g_lo
                lo, f_lo, g_lo = a, f_a, dg_a
            if abs(hi - lo) < self.tolerance_change:
                break
        return a, f_a, grad_a

    # -- the closure-driven step --------------------------------------------
    def step(self, closure=None):
        if closure is None:
            raise TypeError(
                "LBFGS.step requires a closure that re-evaluates the "
                "model and returns the loss"
            )

        def evaluate():
            with torch.enable_grad():
                loss = closure()
            self._func_evals += 1
            return (float(loss.detach()) + self._decay_loss(),
                    self._gather_flat_grad())

        def eval_at(flat_x):
            self._set_flat_params(flat_x)
            return evaluate()

        loss, grad = evaluate()
        orig_loss = loss
        x = self._flat_params()
        lr = float(self.get_lr())

        for it in range(self.max_iter):
            if float(grad.abs().max()) <= self.tolerance_grad:
                break
            d = self._direction(grad)
            # the first iteration ever: min(1, 1 / |g|_1) * lr
            if not self._len and it == 0:
                alpha = min(1.0, 1.0 / max(float(grad.abs().sum()),
                                           1e-10)) * lr
            else:
                alpha = lr
            prev_x, prev_grad, prev_loss = x, grad, loss
            if self.line_search_fn == "strong_wolfe":
                alpha, loss, grad = self._strong_wolfe(
                    eval_at, x, loss, grad, d, alpha
                )
                x = prev_x + alpha * d
                self._set_flat_params(x)
            else:
                x = x + alpha * d
                self._set_flat_params(x)
                loss, grad = evaluate()
            s = x - prev_x
            y = grad - prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._push(s, y)
            if self._func_evals >= self.max_eval:
                break
            if float((alpha * d).abs().max()) <= self.tolerance_change:
                break
            if abs(loss - prev_loss) < self.tolerance_change:
                break

        self._global_step += 1
        return torch.tensor(orig_loss, dtype=torch.float32)

    def _update(self, weights, grads, states, lrs, t):
        raise RuntimeError(
            "LBFGS is closure-driven; call step(closure), not step()"
        )

    # -- checkpointing --------------------------------------------------------
    def state_dict(self):
        """The history, oldest pair first (``hist_s``, ``hist_y``), the
        closure evaluations and the step count, the JAX keys."""
        pairs = self._history()
        return {
            "hist_s": [s.clone() for s, _ in pairs],
            "hist_y": [y.clone() for _, y in pairs],
            "func_evals": self._func_evals,
            "global_step": self._global_step,
        }

    def set_state_dict(self, state_dict):
        self._ring, self._head, self._len = [], 0, 0
        device = self._params()[0].device if self._params() else None
        for s, y in zip(state_dict.get("hist_s", []),
                        state_dict.get("hist_y", [])):
            self._push(torch.as_tensor(s, dtype=torch.float32,
                                       device=device),
                       torch.as_tensor(y, dtype=torch.float32,
                                       device=device))
        self._func_evals = int(state_dict.get("func_evals", 0))
        self._global_step = int(state_dict.get("global_step", 0))
        return self

    set_dict = set_state_dict
