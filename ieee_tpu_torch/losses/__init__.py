"""Loss functions (counterpart of ``ieee_tpu/losses``; reference
``torchreid/losses``).

This slice ports what the IEEE training path uses: label-smoothed cross
entropy and the 3M multi-modal margin loss. The triplet, hetero and time
losses come later (ROADMAP A.8).
"""

from .cross_entropy import cross_entropy_loss
from .margin import multi_modal_margin_loss

__all__ = ["cross_entropy_loss", "multi_modal_margin_loss"]
