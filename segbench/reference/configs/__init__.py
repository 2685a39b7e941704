from segbench.reference.configs.config import (  # noqa: F401
    Config,
    DataConfig,
    DecoderConfig,
    EvalConfig,
    ModelConfig,
    TrainConfig,
    cvppp_config,
)
