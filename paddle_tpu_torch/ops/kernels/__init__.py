"""Hand-written CUDA kernels of the port, one module per TPU kernel.

Each module holds the kernel's wrapper (which launches it on a CUDA
tensor, counts the launch in ``<wrapper>.launches`` and raises on what the
kernel does not take), the plain PyTorch version of the same function
(taken for a CPU tensor, and the reference the kernel is held against on
the card), a note naming the Pallas kernel it replaces, and, where the
reference has a custom_vjp, the ``torch.autograd.Function`` that joins a
forward kernel to its backward.
"""
from . import (bias_gelu, flash_attention, layer_norm, paged_attention,
               softmax_xent)

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
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_launches() -> dict:
    """{kernel: {variant: launches}} of every kernel whose C entry chooses
    between two hand-written kernels (the attention kernels' ``simt`` /
    ``mma``, LayerNorm's ``block`` / ``warp``, paged decode's ``lane`` /
    ``split``, the bias-GeLU backward's ``scalar`` / ``vec``), since the
    libraries were loaded."""
    return {**flash_attention.variant_launches(),
            **layer_norm.variant_launches(),
            **paged_attention.variant_launches(),
            **bias_gelu.variant_launches()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
