"""LayerList (port of paddle_tpu/nn/layer/container.py ``LayerList``).

Sublayers are registered through :meth:`Layer.add_sublayer` as ``"0"``,
``"1"``, ..., so state-dict names equal the reference's
(``encoder.layers.0.self_attn.q_proj.weight``).
"""
from __future__ import annotations

from ..layer_base import Layer


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())
