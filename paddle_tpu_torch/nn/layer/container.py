"""Layer containers (port of paddle_tpu/nn/layer/container.py):
Sequential, LayerList, LayerDict and ParameterList.

Sublayers are registered through :meth:`Layer.add_sublayer` under the
reference's names (a Sequential's and a LayerList's as ``"0"``, ``"1"``,
...), so state-dict names equal the reference's
(``encoder.layers.0.self_attn.q_proj.weight``, ``layer1.0.conv1.weight``).
"""
from __future__ import annotations

from collections import OrderedDict

from ..layer_base import Layer


class Sequential(Layer):
    """Sublayers called in order: given as layers (named "0", "1", ...),
    as (name, layer) pairs, or as one OrderedDict."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        return layers[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        """Insert before ``index``; the sublayers are renamed "0", "1", ...
        in their new order, as the reference renames them."""
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.register_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else len(self) + idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.register_parameter(str(len(self)), parameter)
        return self
