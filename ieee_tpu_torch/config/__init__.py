from .node import ConfigNode
from .defaults import (
    get_default_config,
    imagedata_kwargs,
    engine_run_kwargs,
    lr_scheduler_kwargs,
    optimizer_kwargs,
)

__all__ = [
    "ConfigNode",
    "get_default_config",
    "imagedata_kwargs",
    "engine_run_kwargs",
    "lr_scheduler_kwargs",
    "optimizer_kwargs",
]
