"""The pure-Python planning around the Hopper kernels (``csrc/mm_bn_bwd.cu``,
``csrc/bn_gemm_sm90.cu``, ``csrc/block_bwd_sm90.cu``, and
``csrc/mm_bn_train.cu`` and ``csrc/mm_affine.cu`` on ``csrc/mm_sm90.cuh``):
the dW kernels' splits of N into row ranges, the forward kernels' column
tile, and the parsing of ``nvcc -Xptxas -v`` output that ``chip_smoke.py``
prints. All run on the CPU in milliseconds; the kernels themselves are
held to their plain versions on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import pytest

from ieee_tpu_torch.ops import _build
from ieee_tpu_torch.ops.kernels.block_bwd import (
    BN3_MAX_UNFLUSHED_ROWS,
    BN3_MIN_ROWS,
    BN3_ROW_STEP,
    CONV2_MAX_ROWS,
    _bn1_plan,
    _bn3_plan,
    _bn3_width,
    _conv2_plan,
    _dw_width,
)
from ieee_tpu_torch.ops.kernels.matmul_bn import (
    DW_MIN_ROWS,
    DW_ROW_STEP,
    DW_TILE,
    EVAL_SITES,
    MM_ROWS,
    MM_WIDTHS,
    TRAIN_SITES,
    _dw_plan,
    _mm_plan,
)

SMS = 132


# (N, K, C): every site class of a batch-128 train step (layer4 cb1,
# cb3, downsample, cb1 of layer4.1-2, CIM, the two reduce sites), the
# config's batch 8, ragged and tiny N, and K or C off the 64/256 tiles
@pytest.mark.parametrize("n,k,c", [
    (16384, 1024, 512), (16384, 512, 2048), (16384, 1024, 2048),
    (16384, 2048, 512), (16384, 2048, 2048), (128, 2048, 768),
    (768, 2048, 768), (1024, 2048, 2048), (8, 2048, 768), (48, 2048, 768),
    (1037, 1024, 2048), (1, 8, 8), (13, 24, 40), (4960, 264, 40),
    (100000, 8, 24)])
def test_dw_plan_covers_n_in_whole_steps_and_fits_the_grid(n, k, c):
    splits, rows = _dw_plan(n, k, c, sms=SMS)
    assert splits >= 1 and rows % DW_ROW_STEP == 0
    # the ranges cover N exactly: none empty, the last may be short
    assert (splits - 1) * rows < n <= splits * rows
    tiles = -(-c // DW_TILE[0]) * -(-k // DW_TILE[1])
    # one wave of blocks, unless the output tiles alone exceed it
    assert tiles * splits <= max(SMS, tiles)
    if splits > 1:
        assert rows >= DW_MIN_ROWS


def test_dw_plan_splits_the_small_outputs_of_the_step():
    # layer4 cb1 (1024 -> 512) has 16 output tiles: 8 ranges of 2048 rows
    assert _dw_plan(16384, 1024, 512, sms=SMS) == (8, 2048)
    # CIM (2048 -> 2048) fills the card with its 128 tiles alone
    assert _dw_plan(16384, 2048, 2048, sms=SMS) == (1, 16384)


# (N, K, C): every 1x1 site of a batch-128 train step and of an eval batch
# of 100, the config's batch 8 (CIM, both reduce sites), the card tests'
# ragged and tiny shapes, and the largest N the grid's 65535 row tiles take
@pytest.mark.parametrize("n,k,c", [
    (16384, 1024, 512), (16384, 512, 2048), (16384, 1024, 2048),
    (16384, 2048, 512), (16384, 2048, 2048), (128, 2048, 768),
    (768, 2048, 768), (12800, 1024, 512), (12800, 512, 2048),
    (12800, 1024, 2048), (12800, 2048, 512), (1024, 2048, 2048),
    (8, 2048, 768), (48, 2048, 768), (1037, 2048, 2048), (2048, 264, 768),
    (129, 40, 264), (1, 8, 8), (16384, 40, 264), (65535 * 128, 8, 8)])
def test_mm_plan_covers_the_output_and_fits_the_grid(n, k, c):
    width = _mm_plan(n, c, sms=SMS)
    assert width in MM_WIDTHS and width % 64 == 0  # NB 64-column boxes
    rows, cols = -(-n // MM_ROWS), -(-c // width)
    # the grid covers N and C, and the 64-deep steps K
    assert rows * MM_ROWS >= n and cols * width >= c
    assert -(-k // 64) * 64 >= k
    assert rows <= 65535 and cols <= 65535  # grid y and x
    # the widest tile whose grid fills half the SMs, else the narrowest
    blocks = {wd: rows * -(-c // wd) for wd in MM_WIDTHS}
    fill = [wd for wd in MM_WIDTHS if 2 * blocks[wd] >= SMS]
    assert width == (max(fill) if fill else min(MM_WIDTHS))


def test_mm_plan_at_the_sites():
    # layer4 and CIM at train batch 128 and eval batch 100: 128 x 256
    # tiles, 2-8 waves
    for n in (16384, 12800):
        assert _mm_plan(n, 512, sms=SMS) == _mm_plan(n, 2048, sms=SMS) == 256
    # the config's batch-8 CIM: 8 x 8 tiles of 256 fill 64 SMs, 8 x 16 of
    # 128 fill 128
    assert _mm_plan(1024, 2048, sms=SMS) == 128
    # the reduce sites (global and part rows at batch 128 and 8): 64
    for n in (128, 768, 8, 48):
        assert _mm_plan(n, 768, sms=SMS) == 64


def test_mm_site_tables_count_the_launches_of_a_step_and_a_batch():
    # a train step launches each train kernel at 33 sites, an eval batch
    # mm_affine at 21 (7 per trunk); the layer4 and CIM sites take the
    # 256-wide tile, the reduce sites the 64-wide one
    assert sum(site[-1] for site in TRAIN_SITES) == 33
    assert sum(site[-1] for site in EVAL_SITES) == 21
    for n, k, c, _, _ in TRAIN_SITES + EVAL_SITES:
        assert k % 8 == 0 and c % 8 == 0  # the kernels' 16-byte strides
    assert {_mm_plan(n, c, sms=SMS) for n, _, c, _, _ in TRAIN_SITES} == {
        256, 64}
    assert {_mm_plan(n, c, sms=SMS) for n, _, c, _, _ in EVAL_SITES} == {256}


# (N, C, cm): bn3_apply at layer1-3 of a batch-128 step, width 512, the
# card tests' smaller batches, ragged batches and cm of 8, 16 and 24
@pytest.mark.parametrize("n,c,cm", [
    (262144, 256, 64), (65536, 512, 128), (16384, 1024, 256),
    (16384, 2048, 512), (4096, 512, 128), (2048, 1024, 256),
    (384, 256, 64), (105, 64, 16), (384, 32, 8), (105, 96, 24),
    (1, 32, 8), (200000, 1024, 192)])
def test_bn3_plan_covers_n_in_whole_steps_and_bounds_the_chains(n, c, cm):
    splits, rows = _bn3_plan(n, c, cm, sms=SMS)
    assert splits >= 1 and rows % BN3_ROW_STEP == 0
    assert (splits - 1) * rows < n <= splits * rows
    width = _bn3_width(cm)
    tiles = -(-c // 128) * -(-cm // width)
    if width == 256:  # no f32 totals: the chains stay short
        assert rows <= BN3_MAX_UNFLUSHED_ROWS
    else:  # one wave of blocks, unless the output tiles alone exceed it
        assert tiles * splits <= max(SMS, tiles)
    if splits > 1:
        assert rows >= min(BN3_MIN_ROWS, BN3_MAX_UNFLUSHED_ROWS)


def test_bn3_plan_at_the_block_path_stages():
    # layer1: 2 output tiles of 128 x 64, 66 ranges of 4032 rows: 132
    # blocks, one per SM
    assert _bn3_width(64) == 64
    assert _bn3_plan(262144, 256, 64, sms=SMS) == (66, 4032)
    # layer2: 4 tiles of 128 x 128, 32 ranges of 2048 rows
    assert _bn3_width(128) == 128
    assert _bn3_plan(65536, 512, 128, sms=SMS) == (32, 2048)
    # layer3: 8 tiles of 128 x 256, 16 ranges of 1024 rows
    assert _bn3_width(256) == _bn3_width(512) == 256
    assert _bn3_plan(16384, 1024, 256, sms=SMS) == (16, 1024)


# (N, cm): conv2_bwd at layer1-3 of a batch-128 step, width 512, the card
# tests' smaller and odd maps, cm of 8 and 24, and a large ragged N
CONV2_CASES = [(262144, 64), (65536, 128), (16384, 256), (16384, 512),
               (4096, 128), (2048, 256), (384, 64), (105, 16), (384, 8),
               (105, 24), (63, 8), (350, 24), (280, 16), (180, 8), (1, 8),
               (200000, 192)]


def _check_ranges(n, splits, rows, tiles, width, max_rows=None):
    assert splits >= 1 and rows % BN3_ROW_STEP == 0
    # the ranges cover N exactly: none empty, the last may be short
    assert (splits - 1) * rows < n <= splits * rows
    # one wave of blocks, unless the output tiles alone exceed it or the
    # cap on a range's rows forces more ranges
    if max_rows is None or rows < max_rows:
        assert tiles * splits <= max(SMS, tiles)
    if splits > 1:
        assert rows >= BN3_MIN_ROWS
    # at most 128 columns a block: f32 totals flushed every 128 rows, so
    # the ranges need no cap for the drift
    assert width <= 128
    if max_rows is not None:
        assert rows <= max_rows


@pytest.mark.parametrize("n,cm", CONV2_CASES)
def test_conv2_plan_covers_n_in_whole_steps_and_fits_one_wave(n, cm):
    splits, rows = _conv2_plan(n, cm, sms=SMS)
    width = _dw_width(cm)
    tiles = -(-cm // 128) * 9 * -(-cm // width)  # c tiles x taps x columns
    # the kernel keeps a bit a row of a range in shared memory
    _check_ranges(n, splits, rows, tiles, width, CONV2_MAX_ROWS)


# (N, cin, cm): bn1_apply at the same maps, cin = 4 cm as in the trunks,
# and cin of 32 and 96 with cm of 8 and 24
@pytest.mark.parametrize("n,cin,cm", [
    (262144, 256, 64), (65536, 512, 128), (16384, 1024, 256),
    (16384, 2048, 512), (4096, 512, 128), (2048, 1024, 256), (384, 256, 64),
    (105, 64, 16), (384, 32, 8), (105, 96, 24), (350, 32, 24), (1, 32, 8),
    (200000, 768, 192)])
def test_bn1_plan_covers_n_in_whole_steps_and_fits_one_wave(n, cin, cm):
    splits, rows = _bn1_plan(n, cin, cm, sms=SMS)
    width = _dw_width(cin)
    tiles = -(-cm // 128) * -(-cin // width)
    _check_ranges(n, splits, rows, tiles, width)


def test_conv2_and_bn1_plans_at_the_block_path_stages():
    # conv2_bwd, layer1: 9 taps x one 128 x 64 tile: 14 ranges of 18752
    # rows (126 blocks); layer2: 9 taps x one 128 x 128 tile, the same;
    # layer3: 2 c tiles x 9 taps x 2 column tiles of 128: 3 ranges
    assert _dw_width(64) == 64 and _dw_width(256) == 128
    assert _conv2_plan(262144, 64, sms=SMS) == (14, 18752)
    assert _conv2_plan(65536, 128, sms=SMS) == (14, 4736)
    assert _conv2_plan(16384, 256, sms=SMS) == (3, 5504)
    # bn1_apply, layer1: one c tile x 2 cin tiles of 128: 66 ranges;
    # layer2: 4 cin tiles, 32 ranges of 2048 rows (the 64-row step rounds
    # 33 up); layer3: 2 x 8 tiles, 8 ranges of 2048
    assert _bn1_plan(262144, 256, 64, sms=SMS) == (66, 4032)
    assert _bn1_plan(65536, 512, 128, sms=SMS) == (32, 2048)
    assert _bn1_plan(16384, 1024, 256, sms=SMS) == (8, 2048)


LOG = """== mm_bn_bwd.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113mm_bn_dw_sm90ILb1EEEvPK13__nv_bfloat16S3_S3_PKfPfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113mm_bn_dw_sm90ILb1EEEvPK13__nv_bfloat16S3_S3_PKfPfiiii
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _ZN4sm9014mbar_timed_outEjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z19split_reduce_kernelPKfPfim' for 'sm_90a'
ptxas info    : Function properties for _Z19split_reduce_kernelPKfPfim
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers, 384 bytes cmem[0]
"""


def test_kernel_resources_reads_registers_and_spills():
    # a called function's properties (here an out-of-line report) do
    # not overwrite the kernel's own spills
    res = _build.kernel_resources(LOG)
    assert len(res) == 2
    dw = next(v for name, v in res.items() if "mm_bn_dw_sm90" in name)
    assert dw == {"registers": 232, "spill_stores": 4, "spill_loads": 12}
    red = res["_Z19split_reduce_kernelPKfPfim"]
    assert red == {"registers": 10, "spill_stores": 0, "spill_loads": 0}
