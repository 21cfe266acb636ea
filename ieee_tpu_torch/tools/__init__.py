"""The port's measurement and training tools, counterparts of the JAX
package's ``tools/``: each runs as ``python -m
ieee_tpu_torch.tools.<name>`` with the JAX tool's arguments and defaults
plus ``--device`` (default ``cuda``; it raises without a card unless given
``--device cpu``, which runs the plain PyTorch versions and times on the
host clock).

- ``bw_probe``, ``bw_probe2``, ``roofline_probe``: the bandwidth and matmul
  rates the card reaches (with the ``scale_bf16`` kernel).
- ``fusion_probe``: the fused matmul epilogue and the BN+ReLU-on-load
  consumer at the CIM shape (``mm_stats``, ``bn_mm``).
- ``profile_train``: train steps/s at bench.py's protocol and the device
  time by kernel (``torch.profiler``).
- ``eval_bench``, ``eval_fwd_bench``: the distmat with CMC/mAP at
  Market-1501 scale, and the plain, fused and int8 eval forward.
- ``int8_probe``, ``int8_e2e_eval``: the ``conv_s8`` kernel at each
  ResNet-50 site against cuDNN bf16 and ``torch._int_mm``, and the
  engine's whole eval plain against int8 (wall, forward ms, mAP delta).
- ``loader_bench``: the train loader's batches/s against a step rate.
- ``train_e2e``, ``summarize_e2e``, ``ablation_sweep``, ``diag_train``:
  the paper's Table-3 drivers (a convergence run of one ablation variant
  and the table of such runs; a few timed steps of each variant; gradient,
  parameter and logit norms on real steps). They write under ``log/``.

Three have no JAX counterpart; they time the port's kernels at the main
paths' shapes: ``block_bench`` (the block backward's product kernels),
``mm_bench`` (the four fused 1x1 kernels) and ``kernel_bench`` (the
distmat and ``scale_bf16``, per call, queued and on the device).

Each tool's work is in functions that take shapes and iteration counts;
``main()`` calls them at the JAX tool's sizes.
"""
