from tpuseg_torch.losses.dice import dice_coefficient, dice_loss  # noqa: F401
from tpuseg_torch.losses.focal import (  # noqa: F401
    focal_loss,
    softmax_cross_entropy,
)
