"""Gradient clipping (port of paddle_tpu/nn/clip.py).

The clip objects act on (param, grad) lists, as the optimizer's
``grad_clip`` does before an eager step.  Every scale stays a device
tensor: clipping never reads a norm back to the host.  Reference parity:
python/paddle/fluid/clip.py (ClipGradByValue:118, ClipGradByNorm:220,
ClipGradByGlobalNorm:336).
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        n = g.square().sum().sqrt()
        scale = torch.where(n > self.clip_norm,
                            self.clip_norm / n.clamp_min(1e-12),
                            torch.ones_like(n))
        return g * scale

    def _dygraph_clip(self, params_grads):
        return [(p, self._clip_one(g) if _clipped(p, g) else g)
                for p, g in params_grads]


def _global_scale(grads, clip_norm):
    """(scale, norm): the float32 global L2 norm of ``grads`` and
    min(clip_norm / max(norm, 1e-6), 1)."""
    total = grads[0].float().square().sum()
    for g in grads[1:]:
        total = total + g.float().square().sum()
    gnorm = total.sqrt()
    scale = torch.minimum(clip_norm / gnorm.clamp_min(1e-6),
                          torch.ones_like(gnorm))
    return scale, gnorm


class ClipGradByGlobalNorm(ClipGradBase):
    """``group_name`` is accepted and kept, as in the reference, which
    clips every gradient in one group whatever its name."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        gs = [g for p, g in params_grads if _clipped(p, g)]
        if not gs:
            return params_grads
        scale, _ = _global_scale(gs, self.clip_norm)
        return [(p, g * scale.to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every parameter's ``.grad`` in place so that their global L2
    norm is at most ``max_norm``; returns the norm before clipping (a
    float32 device scalar).  ``norm_type`` and ``error_if_nonfinite`` are
    accepted and not read, as the reference's (paddle_tpu/nn/clip.py
    ``clip_grad_norm_``): the norm is always L2."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros([])
    scale, gnorm = _global_scale([p.grad for p in params], float(max_norm))
    for p in params:
        p.grad = p.grad * scale.to(p.grad.dtype)
    return gnorm
