from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MoEConfig,
                                      SSMConfig, get_config,
                                      get_reduced_config)
