"""Model configurations the port runs (``get_config``), the input-shape
cells and the training and serving knobs."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ServeConfig,
                                      ShapeCell, TrainConfig)
from repro_torch.configs.registry import (ARCH_IDS, LONG_CONTEXT_ARCHS,
                                          all_cells, cell_is_applicable,
                                          get_config)

__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "TrainConfig",
           "ServeConfig", "ARCH_IDS", "LONG_CONTEXT_ARCHS", "all_cells",
           "cell_is_applicable", "get_config"]
