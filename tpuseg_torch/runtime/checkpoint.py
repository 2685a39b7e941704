"""Train-state checkpoints (counterpart of ``tpuseg/runtime/checkpoint.py``,
which writes orbax directories): one ``torch.save`` file holding the model
(parameters, BatchNorm statistics, the decoder's baseline), the optimizer
slots, the plateau schedule and the step, written atomically, so a resume
continues the schedule instead of restarting it.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional

import torch

from tpuseg_torch.runtime.state import TrainState


def save_checkpoint(path: str, state: TrainState,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Save the full train state under ``path`` (a file)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = dict(state.state_dict(), metadata=metadata or {})
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore into an existing state (its model and optimizer give the
    structure and the device); returns the same object."""
    payload = torch.load(os.path.abspath(path), map_location=state.device,
                         weights_only=True)
    payload.pop("metadata", None)
    state.load_state_dict(payload)
    return state


def read_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (on the CPU) of a file ``save_checkpoint``
    wrote; raises ``ValueError`` for any other file."""
    keys = {"step", "model", "optimizer", "plateau"}
    payload = None
    if zipfile.is_zipfile(path):
        payload = torch.load(os.path.abspath(path), map_location="cpu",
                             weights_only=True)
    if not (isinstance(payload, dict) and keys <= payload.keys()):
        raise ValueError(f"{path} is not a checkpoint written by "
                         "tpuseg_torch.runtime.checkpoint.save_checkpoint")
    return payload["model"]
