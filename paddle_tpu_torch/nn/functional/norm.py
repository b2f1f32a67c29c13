"""Normalisation (port of paddle_tpu/nn/functional/__init__.py:635-760:
``batch_norm``, ``instance_norm``, ``group_norm``, ``normalize``,
``local_response_norm``; ``layer_norm`` lives in the package's
``__init__``, where it reaches the LayerNorm kernel).

None of these is a Pallas kernel in the reference (jnp math that XLA
fuses), so the port calls PyTorch's ops: cuDNN's or ATen's batch norm on
the card.  The semantics are the reference's:

- ``batch_norm`` in training normalises with the batch's biased variance
  and moves the running statistics, in place, as
  ``running * momentum + batch * (1 - momentum)`` with Paddle's momentum
  (0.9 by default: PyTorch's ``momentum`` is the other weight, so it gets
  ``1 - momentum``), the running variance taking the unbiased variance
  (n / (n - 1)).  The reference computes the variance as E[x^2] - E[x]^2
  clamped at 0; PyTorch's kernels use Welford's update: the same function,
  another rounding.  ``use_global_stats`` (or eval mode) normalises with
  the running statistics and moves nothing.  The statistics are written
  where they lie, so a captured CUDA graph reads and updates the same
  tensors its eager step does.
- ``local_response_norm`` is the reference's: x / (k + alpha * s)^beta
  with s the sum of squares over ``size`` channels, not PyTorch's mean
  (alpha / size).
"""
from __future__ import annotations

import torch

_F = torch.nn.functional


def _channel_last(x, data_format):
    return data_format[-1] == "C" and len(data_format) > 2 and x.dim() > 2


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    last = _channel_last(x, data_format)
    if last:
        x = x.movedim(-1, 1)
    use_batch = bool(training) and not use_global_stats
    out = _F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=use_batch, momentum=1.0 - momentum,
                        eps=epsilon)
    return out.movedim(1, -1) if last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial positions with
    the biased variance; the running statistics are not used, as in the
    reference."""
    return _F.instance_norm(x, weight=weight, bias=bias, eps=eps)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    last = _channel_last(x, data_format)
    if last:
        x = x.movedim(-1, 1)
    out = _F.group_norm(x, num_groups, weight, bias, epsilon)
    return out.movedim(1, -1) if last else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / norm.clamp_min(epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Channel axis 1 (as the reference's, for any ``data_format``)."""
    sq = x.square()
    half = size // 2
    pad = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    padded = _F.pad(sq, pad)
    C = x.shape[1]
    s = sum(padded[:, i:i + C] for i in range(size))
    return x / (k + alpha * s).pow(beta)
