from tpuseg_torch.nn.aspp import (
    DenseASPP,
    DenseAsppBlock,
    DilatedMobileNetV2,
    MaskedAsppEncoder,
)
from tpuseg_torch.nn.attention import (
    ChannelAttention,
    HardAttention,
    MaskedBatchNorm,
    SpatialAttention,
    SqueezeExcite,
)
from tpuseg_torch.nn.blocks import (
    Conv1x1BN,
    ConvBN,
    DoubleConv,
    InvertedResidual,
    InvertedV1Residual,
    MobileV1ASPP,
)
from tpuseg_torch.nn.conv_gru import ConvGRUCell
from tpuseg_torch.nn.coord_conv import (
    CoordConv,
    CoordConvNet,
    CoordConvTranspose,
    add_coordinates,
    retrofit_coordconv_params,
)
from tpuseg_torch.nn.dcgan_decoder import DcganDecoder
from tpuseg_torch.nn.heads import L0Head
from tpuseg_torch.nn.hourglass import RecurrentHourglass
from tpuseg_torch.nn.sru import SRU, SRUCell, sru_recurrence
from tpuseg_torch.nn.transformer import (
    MultiHeadAttention,
    NonLocalLayer,
    PositionwiseFeedForward,
    ScaledDotProductAttention,
    ScalePDAttention,
    TransformerDecoderLayer,
    make_position_encoding,
)
from tpuseg_torch.nn.unet import UNet
from tpuseg_torch.nn.vgg16 import VGG16, SkipVGG16

__all__ = [
    "DenseASPP",
    "DenseAsppBlock",
    "DilatedMobileNetV2",
    "MaskedAsppEncoder",
    "CoordConv",
    "CoordConvTranspose",
    "add_coordinates",
    "CoordConvNet",
    "retrofit_coordconv_params",
    "ConvGRUCell",
    "RecurrentHourglass",
    "DcganDecoder",
    "SRU",
    "SRUCell",
    "sru_recurrence",
    "VGG16",
    "SkipVGG16",
    "MultiHeadAttention",
    "NonLocalLayer",
    "PositionwiseFeedForward",
    "ScalePDAttention",
    "ScaledDotProductAttention",
    "TransformerDecoderLayer",
    "make_position_encoding",
    "ConvBN",
    "Conv1x1BN",
    "InvertedV1Residual",
    "InvertedResidual",
    "MobileV1ASPP",
    "DoubleConv",
    "UNet",
    "SqueezeExcite",
    "ChannelAttention",
    "SpatialAttention",
    "HardAttention",
    "MaskedBatchNorm",
    "L0Head",
]
