from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, PORTED,
                                      ModelConfig, get_config, list_archs)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "PORTED", "ModelConfig", "get_config",
           "list_archs"]
