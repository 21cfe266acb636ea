"""Engine dispatch (counterpart of ``ieee_tpu/engine/__init__.py``).

This slice builds the eval-only engine for ``loss.name margin`` (the IEEE
run config); the training engines come with the training slice.
"""

from __future__ import annotations

from .engine import Engine

__all__ = ["Engine", "build_engine"]


def build_engine(cfg, datamanager, model, device="cuda") -> Engine:
    """Engine for ``cfg.loss.name`` (reference
    ``scripts/mainMultiModal.py:45-130``)."""
    name = cfg.loss.name
    if name != "margin":
        raise NotImplementedError(
            f"the {name!r} engine is not ported yet (only margin, eval)")
    return Engine(datamanager, model, device=device,
                  fused_eval=bool(cfg.cuda.fused_eval))
