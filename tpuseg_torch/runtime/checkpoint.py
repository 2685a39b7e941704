"""Train-state checkpoints (counterpart of ``tpuseg/runtime/checkpoint.py``,
which writes orbax directories): one ``torch.save`` file holding the model
(parameters, BatchNorm statistics, the decoder's baseline), the optimizer
slots, the plateau schedule and the step, written atomically, so a resume
continues the schedule instead of restarting it.
"""

from __future__ import annotations

import os
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
