"""VGG16 feature extractor, truncatable, and its skip variant (port of
``tpuseg/nn/vgg16.py``).

No pretrained weights are fetched: ``load_npz`` reads a local ``.npz``
export of torchvision's ``vgg16().features`` and ``params_from_torch_features``
renames its ``features.N.*`` keys to this module's ``conv{i}.*`` (the
layouts are torch's on both sides).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.nn.coord_conv import add_coordinates

# torchvision cfg 'D': numbers are conv output channels, 'M' is maxpool.
_CFG_D = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


def _layer_types() -> List[str]:
    """The per-index layer list of torchvision vgg16.features (conv+relu
    pairs and pools), used to interpret truncation indices."""
    types = []
    for v in _CFG_D:
        if v == "M":
            types.append("pool")
        else:
            types.append(f"conv{v}")
            types.append("relu")
    return types


class VGG16(nn.Module):
    """torchvision's VGG16 ``features``, truncated after ``n_layers`` torch
    layers; ``use_coordinates`` prepends the three coordinate planes
    (with r) to every convolution's input."""

    def __init__(self, in_channels: int = 3, n_layers: Optional[int] = None,
                 use_coordinates: bool = False):
        super().__init__()
        types = _layer_types()
        self.types = types[:n_layers if n_layers is not None else len(types)]
        self.use_coordinates = use_coordinates
        extra = 3 if use_coordinates else 0
        cin, conv_i = in_channels, 0
        for t in self.types:
            if t.startswith("conv"):
                feats = int(t[4:])
                self.add_module(f"conv{conv_i}",
                                nn.Conv2d(cin + extra, feats, 3, padding=1))
                cin, conv_i = feats, conv_i + 1

    def forward(self, x, return_intermediate: Optional[List[int]] = None):
        outs, conv_i = [], 0
        for i, t in enumerate(self.types):
            if t == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif t == "relu":
                x = F.relu(x)
            else:
                if self.use_coordinates:
                    x = add_coordinates(x, with_r=True)
                x = getattr(self, f"conv{conv_i}")(x)
                conv_i += 1
            if return_intermediate and i in return_intermediate:
                outs.append(x)
        if return_intermediate:
            outs.append(x)
            return outs
        return x


def params_from_torch_features(
    arrays: Mapping[str, np.ndarray], skip_prefix: bool = False
) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg16().features`` state dict (numpy arrays; keys
    ``features.{i}.weight`` / ``.bias`` or ``{i}.weight`` / ``.bias``, ``i``
    the torch Sequential index) as the ``state_dict`` of ``VGG16``, or of
    ``SkipVGG16`` (keys under ``features.``) with ``skip_prefix``."""
    prefix = "features." if skip_prefix else ""
    sd: Dict[str, torch.Tensor] = {}
    conv_i = 0
    for i, t in enumerate(_layer_types()):
        if not t.startswith("conv"):
            continue
        for full_key in (f"features.{i}.weight", f"{i}.weight"):
            if full_key in arrays:
                break
        else:
            raise KeyError(f"missing weights for torch layer {i} ({t})")
        for leaf, key in (("weight", full_key),
                          ("bias", full_key[:-6] + "bias")):
            sd[f"{prefix}conv{conv_i}.{leaf}"] = torch.from_numpy(
                np.array(arrays[key], np.float32))
        conv_i += 1
    return sd


def load_npz(path: str, skip_prefix: bool = False) -> Dict[str, torch.Tensor]:
    """Load a ``.npz`` export of torchvision VGG16 weights as a
    ``state_dict`` (see ``params_from_torch_features``).

    Export recipe (on a machine with the weights)::

        sd = torchvision.models.vgg16(weights="IMAGENET1K_V1").state_dict()
        np.savez(path, **{k: v.numpy() for k, v in sd.items()
                          if k.startswith("features.")})
    """
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return params_from_torch_features(arrays, skip_prefix)


class SkipVGG16(nn.Module):
    """Outputs of torch layers 3 and 8 plus the output after 16 layers."""

    def __init__(self, in_channels: int = 3, use_coordinates: bool = False):
        super().__init__()
        self.features = VGG16(in_channels, n_layers=16,
                              use_coordinates=use_coordinates)

    def forward(self, x):
        return self.features(x, return_intermediate=[3, 8])
