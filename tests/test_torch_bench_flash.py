"""The port's twin of ``bench.py`` (``mllm_npu_tpu_torch/bench_flash.py``)
on the CPU, where it times the plain version at a tiny shape: one JSON
line with ``bench.py``'s keys and the twin's own, the card's floor at the
reference's bench shape, and no CPU fallback when a card is asked for."""

import json

import pytest
import torch

from mllm_npu_tpu_torch import bench_flash

KEYS = {"metric", "value", "unit", "vs_baseline", "best", "reps", "sdpa_s",
        "sdpa_best", "vs_sdpa", "plain_s", "bound_s", "bound_by",
        "bound_share", "vs_a100_flash_attn", "vs_a100_xformers",
        "max_abs_err", "within_tolerance", "launches", "device", "kind",
        "card", "shape"}


def test_one_json_line_on_the_cpu(capsys):
    got = bench_flash.main(["--device", "cpu", "--batch", "1", "--heads",
                            "2", "--seq", "16", "--head-dim", "32",
                            "--short", "1", "--long", "3", "--reps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(got))
    assert KEYS <= set(line)
    assert line["metric"] == "flash_attention_fwd_avg_time_B1H2S16D32"
    assert line["unit"] == "s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(0.0022245049 / line["value"])
    assert line["vs_a100_flash_attn"] == pytest.approx(
        778.5e-6 / line["value"])
    assert line["vs_a100_xformers"] == pytest.approx(
        460.7e-6 / line["value"])
    assert line["within_tolerance"] and line["max_abs_err"] == 0.0
    # the CPU runs the plain version: no kernel launch, no card
    assert line["launches"] == 0
    assert line["device"] == "cpu" and line["card"] is None
    assert line["kind"] is None


def test_the_bound_at_the_bench_shape():
    """Q, K, V read and O written: 134.2 MB, 40.1 µs at 3.35 TB/s, over
    the 17.18 GFLOP's (two products of 2·S²·D a head) 17.4 µs at 989
    TFLOP/s."""
    secs, by, nbytes, flops = bench_flash.bound(32, 8, 256, 256)
    assert nbytes == 4 * 33554432 and flops == 4 * 4294967296
    assert by == "bytes"
    assert secs == pytest.approx(40.06e-6, rel=1e-3)
    assert flops / 989e12 == pytest.approx(17.37e-6, rel=1e-3)


def test_no_cpu_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_flash.main([])
