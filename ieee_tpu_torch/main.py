"""Single-modal entry point of the port (counterpart of ``scripts/main.py``;
reference ``scripts/main.py``).

The same run as ``main_multimodal``: the engine dispatch builds the
single-modal engine when the data carries one stream, and the model build
passes the ``cuda.*`` kernel flags to ``ieee3modalPart`` only.

Usage:
    python -m ieee_tpu_torch.main \
        --config-file configs/market1501_softmax_r50.yaml --root DATA \
        [--device cuda] [--seed N] [key value ...]
"""

from .main_multimodal import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
