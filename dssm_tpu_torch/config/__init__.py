from dssm_tpu_torch.config.configs import (  # noqa: F401
    PRESETS,
    DataConfig,
    IOConfig,
    LossConfig,
    MeshConfig,
    RunConfig,
    TowerConfig,
    TrainConfig,
    apply_overrides,
    get_preset,
    validate,
)
