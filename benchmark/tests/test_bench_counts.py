"""The yardstick's counts against hand counts at small shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import kernels, peaks
from benchmark.drivers import recon
from benchmark.reference.sd import layers, ops

from .cells import HERE


def _flops(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_linear_and_conv_flops_match_hand_counts():
    lin = layers.Linear(48, 40, device="meta")
    x = torch.zeros((3, 7, 48), device="meta")
    assert _flops(lambda: lin(x)) == 2 * 3 * 7 * 48 * 40
    conv = layers.Conv2d(8, 16, 3, padding=1, device="meta")
    img = torch.zeros((2, 8, 10, 12), device="meta")
    assert _flops(lambda: conv(img)) == 2 * 2 * 16 * 10 * 12 * 8 * 9


def test_attention_and_geglu_flops_match_hand_counts():
    b, sq, sk, c, h = 3, 16, 24, 32, 4
    q = torch.zeros((b, sq, c), device="meta")
    kv = torch.zeros((b, sk, c), device="meta")
    assert _flops(lambda: ops.multi_head_attention(q, kv, kv, h)) == 4 * b * sq * sk * c
    m, inner = 10, 64
    x = torch.zeros((m, c), device="meta")
    w1, b1 = torch.zeros((2 * inner, c), device="meta"), torch.zeros(2 * inner, device="meta")
    w2, b2 = torch.zeros((c, inner), device="meta"), torch.zeros(c, device="meta")
    assert _flops(lambda: ops.geglu_ff(x, w1, b1, w2, b2)) == 6 * m * c * inner


def test_kernel_bounds_match_hand_counts():
    # kernel A, L0 site of sampling: ex2-bound, 1.101 ms in PERF.md's table
    key = (32, 4096, 4096, 320, 1)
    ex2 = 32 * 8 * 4096 * 4096
    assert kernels.flash_fwd(key, 8) == pytest.approx(ex2 / peaks.PEAK_EX2)
    assert kernels.flash_fwd(key, 8) * 1e3 == pytest.approx(1.101, rel=1e-3)
    # kernel C at L0: tensor-bound, 0.326 ms
    assert kernels.geglu((131072, 320, 1280)) * 1e3 == pytest.approx(0.326, rel=1e-2)
    assert kernels.geglu((2, 64, 128)) == pytest.approx(
        2.0 * (2 * 2 * 64 + 3 * 128 * 64 + 2 * 128 + 64) / peaks.PEAK_BYTES)
    # kernel H, the recon step's shape: bytes-bound
    n, kc, cs = 1024, 512, 4
    fwd = 4.0 * (n * 12 * kc + 2 * n) + 4.0 * n * cs * cs * 8 * 256
    assert kernels.composite_coarse_fwd((n, kc, cs)) == pytest.approx(fwd / peaks.PEAK_BYTES)
    bwd = 4.0 * (n * 12 * kc + 2 * n) + 4.0 * (n * cs * cs * 6 * 256 + n * 12 * kc)
    assert kernels.composite_coarse_bwd((n, kc, cs)) == pytest.approx(bwd / peaks.PEAK_BYTES)


def test_recon_step_flops_by_hand():
    cfg = json.loads((HERE / "gs4d-tiny.json").read_text())
    n, c, w = cfg["n_gaussians"], cfg["n_grid_dims"], cfg["mlp_width"]
    # step 25: one unlocked frame, bucket 2, 4 views x 2 frames rendered
    frames, items = 2, 8
    per_point = 2 * 6 * (8 * c + c) + 2 * (2 * c * w + 3 * w) + 2 * (2 * c * w + 4 * w)
    want = 3.0 * (frames * n * per_point + items * n * 250)
    assert recon.n_items(cfg, 25) == items
    assert recon.step_flops(cfg, 25) == want
    # past half the video every frame renders
    assert recon.n_items(cfg, 775) == cfg["n_view"] * cfg["n_frame"]
