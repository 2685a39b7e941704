"""Single typed configuration tree (own copy of ``tpuseg/configs/config.py``).

The port keeps its own copy rather than importing the JAX package's: the
values must stay identical, and ``tests/test_torch_modules.py`` checks
that they do.  Field comments are abridged; the JAX file documents the
measurements behind each default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "CVPPP"
    base_path: str = "data"
    n_classes: int = 2
    max_n_objects: int = 32
    image_height: int = 256
    image_width: int = 256
    mean: Tuple[float, float, float] = (
        0.521697844321, 0.389775426267, 0.206216114391
    )
    std: Tuple[float, float, float] = (
        0.212398291819, 0.151755427041, 0.113022107204
    )
    class_weights: Optional[Tuple[float, ...]] = None
    hflip: bool = True
    vflip: bool = True
    transpose: bool = True
    rot90: bool = True
    rotation: bool = True
    color_jitter: bool = False
    grayscale: bool = False
    channel_swap: bool = False
    gamma: bool = False
    resolution: bool = False
    center_cut: bool = True
    n_channels: int = 21  # RGB+LAB+HSV+YUV+YCbCr+HED+YIQ


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    d_model: int = 24
    d_k: int = 12
    d_v: int = 12
    d_inner: int = 40
    d_h: int = 20
    n_head: int = 2
    sp_reduction: int = 2
    num_layers: int = 1
    focal_gamma: float = 2.0
    ce_weight: float = 10.0
    lov_weight: float = 10.0
    lambda_l: float = 0.5
    lambda_r: float = 2.0
    lambda_e: float = 5.0
    lambda_pn: float = 0.01
    lambda_ins: float = 1.0
    pyramid_weights: Tuple[float, ...] = (16.0, 8.0, 4.0, 2.0, 1.0)
    max_iter: int = 2
    use_mask: bool = True
    use_encode: bool = True
    use_pyramid: bool = True
    drop_rate: float = 0.5
    position_type: int = 1
    baseline_momentum: float = 0.9
    entropy_clamp_lo: float = 1e-7
    entropy_clamp_hi: float = 1.0 - 1e-7
    entropy_normal: float = 1.0
    # extraction stopping rule (overridable at run time by stop_params)
    min_remaining_frac: float = 0.003
    stop_remaining_frac: float = -1.0
    peak_suppress_factor: float = 0.0
    max_extract_misses: int = 3
    extract_loop: str = "scan"
    # glimpses decoded per extraction round, folded into the decode batch
    extract_group: int = 4
    # windowed decode of the two finest pyramid levels (0 disables)
    extract_window: int = 192
    extract_window_stride: int = 64
    use_pallas_softmax: bool = False
    deterministic_glimpse: bool = False
    debug_loss_terms: bool = False
    remat: bool = True
    hoist_skips_train: bool = True
    smooth: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "ReSeg"
    n_filters: int = 32
    use_instance_segmentation: bool = True
    use_coordinates: bool = False
    use_wae: bool = False
    use_count_head: bool = True
    count_classes: int = 33
    use_density_head: bool = True
    delta_var: float = 0.5
    delta_dist: float = 1.5
    norm: int = 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    n_epochs: int = 600
    optimizer: str = "Adadelta"
    learning_rate: float = 1.0
    lr_drop_factor: float = 0.5
    lr_drop_patience: int = 25
    weight_decay: float = 0.001
    clip_grad_norm: float = 10.0
    criterion: str = "Multi"
    optimize_bg: bool = False
    lambda_count: float = 1.0
    lambda_density: float = 0.02
    train_cnn: bool = True
    seed: int = 23
    n_workers: int = 2


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    dice_smooth_eps: float = 0.0


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def cvppp_config(**overrides) -> Config:
    """The CVPPP configuration matching the reference's effective settings."""
    cfg = Config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
