"""tpuseg_torch — the PyTorch/CUDA port of ``tpuseg`` for NVIDIA Hopper.

The package mirrors ``tpuseg``'s module layout so each counterpart is easy
to find, but imports nothing from it (nor JAX, flax or msgpack): the JAX
package is the reference the port is tested against, not a dependency.

Public layouts follow the JAX package: images ``(B, H, W, 3)`` uint8, id
maps ``(B, H, W)``, the ``ir_chain`` kernel on NHWC ``(N, H, W, C)``.
Inside, modules hold NCHW tensors (``torch.channels_last`` where a kernel
wants an NHWC view).

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent, unless the caller asks for ``device="cpu"``.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    but absent (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpuseg_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
