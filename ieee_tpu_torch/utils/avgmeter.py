"""Running-average meters (reference ``torchreid/utils/avgmeter.py:5-73``;
the port's copy of ``ieee_tpu/utils/avgmeter.py``)."""

from __future__ import annotations

from collections import defaultdict

__all__ = ["AverageMeter", "MetricMeter"]


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricMeter:
    """A dict of AverageMeters keyed by metric name."""

    def __init__(self, delimiter: str = " "):
        self.meters = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, input_dict):
        if input_dict is None:
            return
        if not isinstance(input_dict, dict):
            raise TypeError("MetricMeter.update() expects a dict")
        for k, v in input_dict.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name} {meter.val:.4f} ({meter.avg:.4f})"
            for name, meter in self.meters.items()
        )
