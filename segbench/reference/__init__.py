"""A frozen, plain-PyTorch copy of the segmentation model that the
benchmark holds the program's outputs against.

It imports nothing of the program: the modules are copies of the port's
model, decoder, losses and optimizer chain at the time the benchmark was
written, with the hand kernels replaced by their plain versions
(``kernels/``) and the multi-process helpers by their one-process
meaning (``parallel/``).  It reads the checkpoint itself
(``utils/checkpoint_io.py``, ``weights.py``).  Inference runs in float32
with TF32 off; the training steps run in the configuration's precision
(bfloat16 autocast, parameters and optimizer in float32), as the program
does.
"""

import torch


def resolve_device(device) -> torch.device:
    return torch.device(device)
