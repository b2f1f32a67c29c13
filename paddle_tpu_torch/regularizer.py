"""paddle.regularizer — weight decay regularizers (port of
paddle_tpu/regularizer.py).

Reference parity: python/paddle/fluid/regularizer.py (L1DecayRegularizer /
L2DecayRegularizer) and the paddle.regularizer 2.x aliases.  A regularizer
passed as an optimizer's ``weight_decay`` transforms the gradient in
``Optimizer._apply_decay`` (optimizer/__init__.py): L2 adds coeff * p
(coupled decay, fluid semantics; AdamW's decoupled decay overrides), L1
adds coeff * sign(p).  On the card the multi-tensor kernel applies both
inside its update (ops/kernels/optimizer.py).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff=0.0, coeff=None):
        self._regularization_coeff = float(
            coeff if coeff is not None else regularization_coeff)

    @property
    def coeff(self):
        return self._regularization_coeff

    def __call__(self, param, grad):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._regularization_coeff})"


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (fluid L2DecayRegularizer)."""

    def __call__(self, param, grad):
        return grad + self._regularization_coeff * param


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param) (fluid L1DecayRegularizer)."""

    def __call__(self, param, grad):
        return grad + self._regularization_coeff * torch.sign(param)


# fluid-era names
L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
