from .avgmeter import AverageMeter, MetricMeter
from .loggers import Logger
from .tools import mkdir_if_missing, read_image, set_random_seed

__all__ = ["AverageMeter", "MetricMeter", "Logger", "mkdir_if_missing",
           "read_image", "set_random_seed"]
