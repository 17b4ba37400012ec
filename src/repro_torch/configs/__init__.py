from repro_torch.configs.base import (ARCH_IDS, SHAPES, SHAPE_SPECS,
                                      ArchConfig, MoEConfig, SSMConfig,
                                      get_config, get_reduced_config)
