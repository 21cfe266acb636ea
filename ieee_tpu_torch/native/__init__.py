"""Host-side native code of the port (counterpart of ``ieee_tpu/native``):
the C++ CMC/mAP ranker, built with ``g++`` at first use."""
