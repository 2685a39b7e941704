"""flax variable trees <-> the port's ``state_dict``.

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
  ``baseline`` becomes a buffer of the same name;
* an SRU cell's ``weight`` (rows, bidir*d*k) is used as ``x @ weight`` on
  both sides and passes untransposed (it is no Dense ``kernel``);
* flax ``LayerNorm`` / ``GroupNorm`` leaves (the SRU stack's ``ln{i}``,
  ``GroupNorm_*``, the transformer's ``layer_norm``) rename ``scale`` to
  ``weight``.

A ``Dense`` that feeds a reshape passes as any Dense: the module that
reshapes keeps flax's NHWC order (``nn/dcgan_decoder.py``).

``to_flax`` is the exact inverse (so a state trained by the port can be
compared with, or read by, the JAX package) and ``grads_to_flax`` applies
the same map to the ``.grad`` fields.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from tpuseg_torch.nn.sru import SRUCell

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


def _is_norm(module_name: str) -> bool:
    """flax LayerNorm / GroupNorm modules, whose ``scale`` is torch's
    ``weight``."""
    return re.fullmatch(r"ln\d+|GroupNorm_\d+|layer_norm",
                        module_name) is not None


def _convert(mod: str, leaf: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if mod.startswith("BatchNorm"):
        return _BN_NAMES[leaf], a
    if _is_norm(mod):
        return {"scale": "weight"}.get(leaf, leaf), a
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
                mod = path[-2] if len(path) > 1 else ""
                name, a = _convert(mod, path[-1], a)
                key = ".".join(path[:-1] + (name,))
                if mod.startswith("BatchNorm") and name == "weight":
                    sd[".".join(path[:-1] + ("num_batches_tracked",))] = (
                        torch.zeros((), dtype=torch.long)
                    )
            if key in sd:
                raise ValueError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.array(a))
    return sd


def _is_bn(module) -> bool:
    return isinstance(module, torch.nn.modules.batchnorm._BatchNorm)


def _unconvert(owner, mod: str, name: str, a: np.ndarray):
    """Inverse of ``_convert``: (collection, flax leaf name, flax array)
    for the tensor ``name`` of the module ``owner`` (named ``mod``)."""
    if _is_bn(owner):
        if name == "num_batches_tracked":
            return None
        leaf = {v: k for k, v in _BN_NAMES.items()}[name]
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        return col, leaf, a
    if isinstance(owner, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
        return "params", {"weight": "scale"}.get(name, name), a
    if isinstance(owner, SRUCell):
        return "params", name, a
    if name == "baseline":
        return "decoder_state", name, a
    if name in dict(owner.named_buffers(recurse=False)):
        return "batch_stats", name, a  # MaskedBatchNorm mean / var
    if name != "weight":
        return "params", name, a
    if a.ndim == 2:
        return "params", "kernel", a.T
    if _is_conv_transpose(mod):
        return "params", "kernel", np.transpose(a[:, :, ::-1, ::-1],
                                                (2, 3, 0, 1))
    return "params", "kernel", np.transpose(a, (2, 3, 1, 0))


def _to_tree(model: torch.nn.Module, pick) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for prefix, owner in model.named_modules():
        tensors = list(owner.named_parameters(recurse=False))
        tensors += list(owner.named_buffers(recurse=False))
        for name, t in tensors:
            value = pick(t)
            if value is None:
                continue
            got = _unconvert(owner, prefix.split(".")[-1], name,
                             value.detach().cpu().numpy())
            if got is None:
                continue
            col, leaf, a = got
            node = tree.setdefault(col, {})
            for part in (prefix.split(".") if prefix else []):
                node = node.setdefault(part, {})
            node[leaf] = np.array(a, order="C")
    return tree


def to_flax(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters and buffers as the nested flax tree
    ``{"params", "batch_stats", "decoder_state"}`` of numpy arrays:
    ``to_flax(load_flax(m, v))`` equals ``v`` leaf for leaf."""
    return _to_tree(model, lambda t: t)


def grads_to_flax(model: torch.nn.Module) -> Dict[str, Any]:
    """The ``.grad`` of every parameter as a flax ``params`` tree (a
    parameter without a gradient gives zeros)."""
    def pick(t):
        if not isinstance(t, torch.nn.Parameter):
            return None
        return torch.zeros_like(t) if t.grad is None else t.grad

    return _to_tree(model, pick)["params"]


def load_flax(model: torch.nn.Module, variables: Dict[str, Any]):
    """Load a flax tree into ``model`` strictly: every leaf used, no
    parameter or buffer left at its initial value."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model

