from tpuseg_torch.losses.dice import (  # noqa: F401
    dice_coefficient,
    dice_loss,
    instance_dice_loss,
)
from tpuseg_torch.losses.focal import (  # noqa: F401
    bce_loss,
    focal_loss,
    softmax_cross_entropy,
)
from tpuseg_torch.losses.lovasz import (  # noqa: F401
    binary_xloss,
    iou_binary,
    lovasz_grad,
    lovasz_hinge,
    lovasz_softmax,
    stable_bce_loss,
)
from tpuseg_torch.losses.discriminative import (  # noqa: F401
    discriminative_loss,
)
from tpuseg_torch.losses.mmd import (  # noqa: F401
    decoder_mmd_loss,
    gl_loss,
    mmd_penalty,
    mmd_penalty_with_p,
)

__all__ = [
    "dice_coefficient",
    "dice_loss",
    "instance_dice_loss",
    "focal_loss",
    "bce_loss",
    "softmax_cross_entropy",
    "lovasz_grad",
    "lovasz_hinge",
    "lovasz_softmax",
    "stable_bce_loss",
    "binary_xloss",
    "iou_binary",
    "discriminative_loss",
    "mmd_penalty",
    "mmd_penalty_with_p",
    "decoder_mmd_loss",
    "gl_loss",
]
