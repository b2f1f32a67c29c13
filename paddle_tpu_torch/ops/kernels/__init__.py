"""Hand-written CUDA kernels of the port, one module per TPU kernel.

Each module holds the kernel's wrapper (which launches it on a CUDA
tensor, counts the launch in ``<wrapper>.launches`` and raises on what the
kernel does not take), the plain PyTorch version of the same function
(taken for a CPU tensor, and the reference the kernel is held against on
the card), a note naming the Pallas kernel it replaces, and, where the
reference has a custom_vjp, the ``torch.autograd.Function`` that joins a
forward kernel to its backward.  ``optimizer`` is the one kernel beyond the
``pallas_call`` set: the whole-tree optimizer update the reference gets
from XLA inside its jitted step (``multi_tensor_step``, and
``multi_tensor_norm_step`` for the rules that need per-tensor norms);
``amp`` is the other, the loss scaler's check_finite_and_unscale over
every gradient.
"""
from . import (amp, bias_gelu, flash_attention, layer_norm, optimizer,
               paged_attention, softmax_xent)

# one entry per CUDA kernel: the wrapper that launches it and counts
WRAPPERS = {
    "layer_norm": layer_norm.layer_norm,
    "bias_gelu": bias_gelu.bias_gelu,
    "flash_attention": flash_attention.flash_attention,
    "paged_decode_attention": paged_attention.paged_decode_attention,
    "bias_gelu_bwd": bias_gelu.bias_gelu_bwd,
    "flash_attention_dq": flash_attention.flash_attention_dq,
    "flash_attention_dkv": flash_attention.flash_attention_dkv,
    "softmax_xent": softmax_xent.softmax_xent_fwd,
    "softmax_xent_bwd": softmax_xent.softmax_xent_bwd,
    "multi_tensor_step": optimizer.multi_tensor_step,
    "multi_tensor_norm_step": optimizer.multi_tensor_norm_step,
    "check_finite_and_unscale": amp.check_finite_and_unscale_,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_launches() -> dict:
    """{kernel: {variant: launches}} of every kernel whose C entry chooses
    between hand-written kernels (the attention kernels' ``simt`` /
    ``mma`` / ``tf32x3``, LayerNorm's ``block`` /
    ``warp``, paged decode's ``lane`` / ``split``, the bias-GeLU forward's
    and backward's ``scalar`` / ``vec``), since the libraries were
    loaded."""
    return {**flash_attention.variant_launches(),
            **layer_norm.variant_launches(),
            **paged_attention.variant_launches(),
            **bias_gelu.variant_launches()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
        for sub in ("dropout_launches", "cross_launches"):
            if hasattr(fn, sub):
                setattr(fn, sub, 0)
