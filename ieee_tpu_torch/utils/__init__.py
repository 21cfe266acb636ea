from .avgmeter import AverageMeter, MetricMeter
from .loggers import Logger, RankLogger
from .tools import (check_isfile, mkdir_if_missing, read_image, read_json,
                    set_random_seed, write_json)

__all__ = ["AverageMeter", "MetricMeter", "Logger", "RankLogger",
           "check_isfile", "mkdir_if_missing", "read_image", "read_json",
           "set_random_seed", "write_json"]
