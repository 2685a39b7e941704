"""Dataset settings (own copy of ``tpuseg/settings/__init__.py``):
``get_config(dataset)`` over the typed Config tree, the default dataset
paths, and the reference's settings classes as aliases over the config.
"""

from __future__ import annotations

import os

from tpuseg_torch.configs import Config, cvppp_config

_DATASETS = ("CVPPP",)


def get_config(dataset: str) -> Config:
    if dataset not in _DATASETS:
        raise ValueError(f"unknown dataset {dataset}")
    return cvppp_config()


def default_data_paths(cfg: Config, dataset: str):
    """(training, validation) record prefixes:
    ``<base>/processed/<dataset>/records/{training,validation}``, where
    ``data/scripts/prepare.py`` writes them."""
    root = os.path.join(cfg.data.base_path, "processed", dataset, "records")
    return os.path.join(root, "training"), os.path.join(root, "validation")


class CVPPPDataSettings:
    """The reference's ``DataSettings`` names over ``cvppp_config()``."""

    def __init__(self):
        cfg = cvppp_config()
        self.cfg = cfg
        self.BASE_PATH = cfg.data.base_path
        self.CLASS_WEIGHTS = cfg.data.class_weights
        self.MAX_N_OBJECTS = cfg.data.max_n_objects
        self.N_CLASSES = cfg.data.n_classes


class CVPPPModelSettings:
    """The reference's ``ModelSettings`` names over ``cvppp_config()``."""

    def __init__(self):
        cfg = cvppp_config()
        self.cfg = cfg
        self.MODEL_NAME = cfg.model.name
        self.N_CLASSES = cfg.data.n_classes
        self.MAX_N_OBJECTS = cfg.data.max_n_objects
        self.USE_INSTANCE_SEGMENTATION = cfg.model.use_instance_segmentation
        self.USE_COORDINATES = cfg.model.use_coordinates
        self.IMAGE_HEIGHT = cfg.data.image_height
        self.IMAGE_WIDTH = cfg.data.image_width
        self.MEAN = list(cfg.data.mean)
        self.STD = list(cfg.data.std)


class CVPPPTrainingSettings(CVPPPModelSettings):
    """The reference's ``TrainingSettings`` names over ``cvppp_config()``."""

    def __init__(self):
        super().__init__()
        cfg = self.cfg
        self.OPTIMIZER = cfg.train.optimizer
        self.LEARNING_RATE = cfg.train.learning_rate
        self.LR_DROP_FACTOR = cfg.train.lr_drop_factor
        self.LR_DROP_PATIENCE = cfg.train.lr_drop_patience
        self.WEIGHT_DECAY = cfg.train.weight_decay
        self.CLIP_GRAD_NORM = cfg.train.clip_grad_norm
        self.CRITERION = cfg.train.criterion
        self.SEED = cfg.train.seed
