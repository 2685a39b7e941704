"""flax variable trees -> the port's ``state_dict``.

The port's modules carry the flax module names (``Conv_0``, ``_BN_1``,
``up_atten3``...), so a leaf's torch key is its flax path joined with dots
(the collection name dropped).  Only the leaf itself changes layout — the
inverse of ``tools/convert_reference_weights.py:46-61``:

* conv kernel HWIO ``(kh, kw, in, out)`` -> OIHW ``(out, in, kh, kw)``; a
  depthwise ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)`` by the same transpose;
* Dense ``(in, out)`` -> Linear ``(out, in)``;
* ConvTranspose ``(kh, kw, in, out)`` -> torch ``(in, out, kh, kw)`` with
  the spatial flip: flax's transposed conv correlates the dilated input
  with the kernel as stored, torch's scatters it, so the taps run in
  opposite order;
* ``BatchNorm_*`` scale/bias/mean/var -> weight/bias/running_mean/
  running_var (eps 1e-5 lives in the module), plus a zero
  ``num_batches_tracked``;
* ``MaskedBatchNorm_*`` keeps scale/bias/mean/var; ``decoder_state``'s
  ``baseline`` becomes a buffer of the same name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats", "decoder_state")
_BN_NAMES = {
    "scale": "weight", "bias": "bias", "mean": "running_mean",
    "var": "running_var",
}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _is_conv_transpose(module_name: str) -> bool:
    # flax names: ``ConvTranspose_0`` in the UNet ``_Up``; ``up`` in the
    # pyramid levels (``_UpAttenLevel.up``)
    return module_name.startswith("ConvTranspose") or module_name == "up"


def _convert(mod: str, leaf: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if mod.startswith("BatchNorm"):
        return _BN_NAMES[leaf], a
    if leaf != "kernel":
        return leaf, a
    if a.ndim == 2:
        return "weight", a.T
    if a.ndim != 4:
        raise ValueError(f"unexpected kernel rank {a.shape}")
    if _is_conv_transpose(mod):
        return "weight", np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return "weight", np.transpose(a, (3, 2, 0, 1))


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax variables tree (numpy or jax leaves) -> torch ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for col in variables:
        if col not in _COLLECTIONS:
            raise ValueError(f"unknown variable collection {col!r}")
        for path, value in _leaves(variables[col]):
            a = np.asarray(value)
            if col == "decoder_state":
                key = ".".join(path)
            else:
                name, a = _convert(path[-2], path[-1], a)
                key = ".".join(path[:-1] + (name,))
                if path[-2].startswith("BatchNorm") and name == "weight":
                    sd[".".join(path[:-1] + ("num_batches_tracked",))] = (
                        torch.zeros((), dtype=torch.long)
                    )
            if key in sd:
                raise ValueError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.array(a))
    return sd


def load_flax(model: torch.nn.Module, variables: Dict[str, Any]):
    """Load a flax tree into ``model`` strictly: every leaf used, no
    parameter or buffer left at its initial value."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def load_checkpoint(model: torch.nn.Module, path: str):
    """Load a flax msgpack checkpoint file into ``model`` (strict)."""
    from tpuseg_torch.utils.checkpoint_io import read_msgpack

    return load_flax(model, read_msgpack(path))
