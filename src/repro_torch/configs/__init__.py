from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                                all_configs, cells, get_config)
