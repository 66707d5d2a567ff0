"""AdamW, the decoupled weight decay of ``paddle_tpu/optimizer/adamw.py``.

``weight_decay`` is applied to the weight (the fp32 master where there is
one) before the Adam update, scaled by the effective learning rate:
``w *= 1 - lr * lr_ratio(p) * coeff``. ``apply_decay_param_fun(name)``
chooses the parameters that decay; ``lr_ratio(param)`` scales each
parameter's learning rate; a group's own ``weight_decay`` is its
decoupled coefficient.
"""
from __future__ import annotations

from .adam import Adam

__all__ = ["AdamW"]


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, amsgrad=False):
        # decoupled, so not handed to the base class as an L2 term
        super().__init__(
            learning_rate=learning_rate, beta1=beta1, beta2=beta2,
            epsilon=epsilon, parameters=parameters, weight_decay=None,
            grad_clip=grad_clip, multi_precision=multi_precision,
            amsgrad=amsgrad,
        )
        self._coeff = float(weight_decay)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _group_l2(self, group):
        return 0.0

    def _param_extras(self, p, group):
        decay = self._coeff
        gwd = group.get("weight_decay")
        if gwd is not None:
            decay = float(gwd)
        if self._apply_decay_param_fun is not None and not (
                self._apply_decay_param_fun(self.param_name(p))):
            decay = 0.0
        ratio = float(self._lr_ratio(p)) if self._lr_ratio is not None else 1.0
        return decay, ratio
