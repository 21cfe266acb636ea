"""The port's measurement tools (``ieee_tpu_torch/tools/``) at small sizes on
the CPU (``device="cpu"``: the kernels' plain versions, host clock), and
each tool's entry point refusing ``--device cuda`` without a card.

What is checked is what each tool prints and returns: every line of its
JAX counterpart (or the line that says a path is not ported), finite
times, and the checks a tool makes itself (the device ranking against the
numpy oracle, the fused eval against the plain one, the probe kernels'
plain versions against the unfused torch ops).
"""

import importlib
import math

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

TOOLS = ("bw_probe", "bw_probe2", "fusion_probe", "roofline_probe",
         "profile_train", "eval_bench", "eval_fwd_bench", "loader_bench",
         "block_bench", "mm_bench", "kernel_bench")


def _tool(name):
    return importlib.import_module(f"ieee_tpu_torch.tools.{name}")


def _finite_ms(results):
    return all(math.isfinite(v[0] if isinstance(v, tuple) else v) and
               (v[0] if isinstance(v, tuple) else v) >= 0
               for v in results.values())


@pytest.mark.parametrize("name", TOOLS)
def test_tool_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _tool(name).main(["--device", "cuda"])


def test_bw_probe(capsys):
    res = _tool("bw_probe").probe("cpu", m=64, iters=1)
    out = capsys.readouterr().out
    for line in ("reduce-1pass bf16 (0 MB)", "add2 bf16", "reduce-1pass f32",
                 "add2 f32", "kernel scale bf16 (512-row tiles)",
                 "kernel scale bf16 (2048-row tiles)",
                 "torch.mul bf16 (library)", "clone bf16 (copy ceiling)"):
        assert line in out, line
    assert len(res) == 8 and _finite_ms(res)
    assert "GB/s (R+W carry)" in out and "GB/s (2R+1W)" in out


def test_bw_probe2(capsys):
    res = _tool("bw_probe2").probe("cpu", n=64, bn_shape=(4, 2, 2, 16),
                                   iters=1)
    out = capsys.readouterr().out
    assert "add2 f32 0 MB" in out and "add2 bf16 0 MB" in out
    assert "bn stats+normalize bf16 0 MB map" in out
    assert len(res) == 3 and _finite_ms(res)
    # the BN body normalises each channel to mean 0, variance 1
    z = torch.randn(4, 2, 2, 16, dtype=torch.bfloat16)
    zn = _tool("bw_probe2").bn_normalize(z).float()
    assert zn.dtype == torch.float32 and zn.shape == z.shape
    assert zn.mean((0, 1, 2)).abs().max() < 2e-2
    assert (zn.pow(2).mean((0, 1, 2)) - 1).abs().max() < 2e-2


def test_fusion_probe(capsys):
    res = _tool("fusion_probe").probe("cpu", n=256, k=128, c=128, iters=1)
    out = capsys.readouterr().out
    for line in ("pure mm:", "torch mm+stats+bnrelu:",
                 "kernel mm+stats epilogue:", "mean err:",
                 "torch bnrelu+mm consumer:",
                 "kernel fused-affine mm consumer:", "consumer max err:",
                 "dW x^T@dy:"):
        assert line in out, line
    # the probe's statistics are taken before y's bf16 rounding, the
    # baseline's after it: they differ by rounding only
    assert res["mean_err"] < 1e-3 and res["var_err"] < 1e-3
    # the consumer: the same h, f32 sums in another order, bf16 out
    assert res["consumer_err"] < 5e-2
    assert _finite_ms({k: v for k, v in res.items() if "err" not in k})


def test_roofline_probe(capsys):
    res = _tool("roofline_probe").probe(
        "cpu", mm=64, ew=(64, 64), bn_shapes=((4, 2, 2, 16),),
        conv3=(2, 4, 4, 8), conv1=(2, 2, 2, 16, 8), iters=1)
    out = capsys.readouterr().out
    for line in ("matmul bf16 64^3:", "elementwise 0MB bf16:",
                 "bn stats+write [4, 2, 2, 16]:", "conv3x3 [2, 4, 4, 8]:",
                 "conv1x1 16->8 [2,2,2]:"):
        assert line in out, line
    assert len(res) == 5 and _finite_ms(res)
    # the one-pass elementwise step is c * 1.0001 + 0.5
    x = torch.randn(8, 8, dtype=torch.bfloat16)
    got = _tool("roofline_probe").elementwise(
        x, torch.tensor(0.5, dtype=torch.bfloat16),
        torch.tensor(1.0, dtype=torch.bfloat16))
    torch.testing.assert_close(got.float(), x.float() * 1.0001 + 0.5,
                               rtol=2 ** -7, atol=2 ** -7)


def test_profile_train(capsys, tmp_path):
    res = _tool("profile_train").run(
        batch=8, steps=1, top=5, trace_dir=str(tmp_path), device="cpu",
        height=64, width=32, num_pids=4, backbone_layers=(1, 1, 1, 1),
        profile_n=1)
    out = capsys.readouterr().out
    assert "steady state:" in out and "triplets/s" in out
    assert "cpu operator total over the profile" in out
    assert math.isfinite(res["loss"]) and res["steps_per_s"] > 0
    assert 1 <= len(res["table"]) <= 5 and res["ms_per_step"] > 0
    assert (tmp_path / "trace.json").stat().st_size > 0


def _fused_sites(model) -> int:
    """The model's 1x1 conv+BN sites on the fused kernels: each Bottleneck's
    fused cb1 and cb3 (with its downsample), each CIM and reduce layer
    built as a FusedConvBN1x1."""
    from ieee_tpu_torch.models.common import FusedConvBN1x1
    from ieee_tpu_torch.models.resnet import Bottleneck

    return sum(isinstance(m, FusedConvBN1x1)
               + (int(m.fuse_cb1) + int(m.fuse_cb3)
                  if isinstance(m, Bottleneck) else 0)
               for m in model.modules())


@pytest.mark.parametrize("name", ["profile_train", "eval_fwd_bench"])
def test_tools_measure_the_reference_path_unless_fused(name, monkeypatch):
    # as the JAX tools, which build the model without fused_1x1: the
    # default run asks for the plain model, --fused for the fused one
    tool = _tool(name)
    asked = []
    monkeypatch.setattr(tool, "run",
                        lambda *args, **kw: asked.append(kw["fused"]))
    tool.main(["--device", "cpu"])
    tool.main(["--fused", "--device", "cpu"])
    assert asked == [False, True]


def test_tools_model_has_fused_sites_only_when_asked():
    # the tools' model (profile_train.build_ieee, which eval_fwd_bench
    # shares) at full width, one block per stage: no step is run
    build = _tool("profile_train").build_ieee
    assert _tool("eval_fwd_bench").build_ieee is build
    plain = build("cpu", False, 4, (1, 1, 1, 1))
    assert _fused_sites(plain) == 0
    # per trunk layer4.0's cb1 and cb3 (with the downsample), then CIM's
    # two convs and the reduce layer per modality
    fused = build("cpu", True, 4, (1, 1, 1, 1))
    assert _fused_sites(fused) == 3 * 2 + 3 * 3


def test_kernel_bench(capsys):
    res = _tool("kernel_bench").bench(
        "cpu", iters=1, distmat_shapes=((16, 24, 19),), scale_rows=64)
    assert set(res) == {("distmat", (16, 24, 19)), ("scale_bf16", 512),
                        ("scale_bf16", 2048), ("torch.mul", 64),
                        ("clone", 64)}
    # per call and queued on the host clock; no device number on the CPU
    assert all(math.isfinite(t[0]) and math.isfinite(t[1]) and t[2] is None
               for t in res.values())
    out = capsys.readouterr().out
    assert "distmat 16x24x19: kernel" in out and "(3xTF32" in out
    assert out.count("not measured device") == 6


def test_eval_bench(capsys):
    res = _tool("eval_bench").run(num_q=60, num_g=300, dim=16, device="cpu",
                                  n=1, oracle_q=40)
    out = capsys.readouterr().out
    assert "device distmat+CMC/mAP (60x300, 16-d):" in out
    assert "device vs numpy oracle (40 queries)" in out
    assert "estimated full-scale" in out and "speedup" in out
    assert res["cmc_err"] <= 1e-6 and res["map_err"] <= 1e-6
    assert 0.0 <= res["mAP"] <= 1.0


def test_eval_fwd_bench(capsys):
    res = _tool("eval_fwd_bench").run(batch=2, device="cpu", height=64,
                                      width=32, backbone_layers=(1, 1, 1, 1),
                                      iters=1)
    out = capsys.readouterr().out
    assert "plain:" in out and "fused:" in out
    assert "int8 PTQ: not ported yet (ROADMAP A.7)" in out
    # the folded head against the plain forward on the same weights
    # (bf16 trunks; 5.7e-3 measured at this size)
    assert res["rel_dev"] < 2e-2


def test_loader_bench_main(capsys):
    small = ["--device", "cpu", "--batch", "8", "--height", "64", "--width",
             "32", "--batches", "3"]
    res = _tool("loader_bench").main(small + ["--step-rate", "0.01"])
    out = capsys.readouterr().out
    assert set(res) == {"workers=0", "workers=1", "workers=2", "workers=4"}
    assert "workers=0 +cache: not ported yet" in out
    assert "workers=2 +cache: not ported yet" in out
    assert "-> OK" in out
    with pytest.raises(SystemExit) as exc:
        _tool("loader_bench").main(small + ["--step-rate", "1e9"])
    assert exc.value.code == 1
    assert "-> STARVED" in capsys.readouterr().out


def test_block_bench(capsys):
    # the three block kernels' plain versions at every stage, one image
    totals = _tool("block_bench").bench("cpu", batch=1, iters=1)
    assert set(totals) == {"conv2_bwd", "bn1_apply", "bn3_apply"}
    assert _finite_ms(totals)
    out = capsys.readouterr().out
    assert out.count("ms per call queued") == 9
    assert "per step (30 blocks), queued:" in out


def test_mm_bench(capsys):
    # the four 1x1 kernels' plain versions at one small site each
    totals = _tool("mm_bench").bench(
        "cpu", iters=1, train_sites=((64, 32, 16, True, 33),),
        eval_sites=((40, 24, 8, False, 21),))
    assert set(totals) == {"mm_stats", "mm_affine", "mm_bn_da", "mm_bn_dw"}
    assert _finite_ms(totals)
    out = capsys.readouterr().out
    assert out.count("ms per call queued") == 4
    assert "mm_stats per train step (33 sites), queued:" in out
    assert "per trunk (7 sites):" in out
