"""The image-to-video cell (``drivers/svd_i2v.py``) on a tiny SVD on the
CPU: a clean run reads ``correct``; each fault the cell is built to catch,
planted in the program, reads incorrect; the cell's files are found by
name; its per-layer readers read what a trace holds and nothing where it
holds nothing."""

import json
import time

import pytest
import torch

from benchmark import harness

from .cells import BENCH, HERE


def _spec() -> harness.CellSpec:
    config = json.loads((HERE / "svd-tiny.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "svd_i2v.json").read_text())
    traffic.update(steps=3, check_steps=2, image_coarse=4)
    e2e = [{"name": "sample_step_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]
    return harness.CellSpec(name="svd-tiny", chips=1, config_name="svd-tiny", config=config,
                            traffic_name="svd_i2v", traffic=traffic, end_to_end=e2e,
                            per_layer=[])


def _run(seed: int = 2 ** 31 + 4321) -> dict:
    from benchmark.drivers import svd_i2v

    torch.set_num_threads(4)
    return harness.run_cell(_spec(), svd_i2v, seed, 0.5, False, time.perf_counter(),
                            torch.device("cpu"))


def _unmasked(mp):
    from animate3d_tpu_torch.ops import attention as TA

    def unmasked(q, k, v, num_heads, scale):
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 32 - t.shape[1]))
        qh, kh, vh = (TA._split_heads(x, num_heads) for x in (q, pad(k), pad(v)))
        return TA._merge_heads(TA.attention_xla(qh, kh, vh, scale))

    mp.setattr(TA, "packed_padded_attention", unmasked)


def _no_conv3d(mp):
    import torch.nn.functional as F

    from animate3d_tpu_torch.models import unet_svd

    def forward(self, x, temb):
        h = F.silu(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb)).transpose(1, 2)[:, :, :, None, None]
        return F.silu(self.norm2(h)) + x

    mp.setattr(unet_svd.TemporalResnetBlock, "forward", forward)


def _cfg_mean(mp):
    from animate3d_tpu_torch.pipelines import svd_sampler

    orig = svd_sampler.SVDSampler.guidance_scale
    mp.setattr(svd_sampler.SVDSampler, "guidance_scale",
               lambda self: torch.full_like(orig(self), float(orig(self).mean())))


def _mix_one(mp):
    from animate3d_tpu_torch.models import attention_layers

    orig = attention_layers.AlphaBlender.forward

    def forward(self, a, b, image_only=None):
        saved = self.mix_factor.data.clone()
        self.mix_factor.data.fill_(1.0)
        try:
            return orig(self, a, b, image_only)
        finally:
            self.mix_factor.data.copy_(saved)

    mp.setattr(attention_layers.AlphaBlender, "forward", forward)


FAULTS = {"unmasked": _unmasked, "no_conv3d": _no_conv3d, "cfg_mean": _cfg_mean,
          "mix_one": _mix_one}


def test_clean_run_reads_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and set(res["checks"]) == {
        "image_rel", "latent_rel", "starts_rel", "denoised_rel", "step_rel", "decode_rel"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_cell_files_found_by_name():
    cell = harness.load_cell(BENCH.parent, "svdxt-i2v-576x1024")
    assert cell.chips == 1 and cell.traffic["driver"] == "svd_i2v"
    assert cell.config["sampling"]["num_frames"] == 25
    assert [m["name"] for m in cell.end_to_end] == ["sample_step_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "svd.device_idle_share", "svd.mfu", "svd.flash_fwd_d64_roofline",
        "svd.temporal_attn_roofline", "svd.temporal_share", "svd.host_syncs_per_step",
        "sample.geglu_roofline"}


def test_svd_readers():
    """The roofline readers take only their kernel's instance and shape;
    with nothing of theirs in the trace they read None."""
    from benchmark.counts import svd

    key_a, key_b = (50, 9216, 9216, 320, 1), (18432, 25, 320)
    t = harness.TraceSummary(
        window_s=10.0, busy_s=8.0, units=10, config={},
        kernels={"void (anonymous namespace)::flash_fwd_kernel<64>(CUtensorMap_st)": [0.2, 5],
                 "void (anonymous namespace)::flash_fwd_kernel<48>(CUtensorMap_st)": [9.0, 5],
                 "void (anonymous namespace)::packed_attn_kernel<32, 64, 2, 3, true>(x)":
                     [0.01, 5]},
        launches={("flash_fwd", key_a): 5, ("packed_attn", key_b): 5,
                  ("packed_attn", (8192, 16, 320)): 3,
                  ("packed_seq_padded", "25->32"): 5},
        counts={"temporal_device_s": 2.0})
    a = harness.read_layer_metric("svd.flash_fwd_d64_roofline", t)
    assert a == pytest.approx(100.0 * 5 * svd.flash_fwd_d64(key_a) / 0.2)
    b = harness.read_layer_metric("svd.temporal_attn_roofline", t)
    assert b == pytest.approx(100.0 * 5 * svd.packed_padded(key_b) / 0.01)
    assert harness.read_layer_metric("svd.temporal_share", t) == pytest.approx(25.0)
    empty = harness.TraceSummary(window_s=10.0, busy_s=8.0, kernels={}, launches={}, units=1,
                                 config={})
    for name in ("svd.flash_fwd_d64_roofline", "svd.temporal_attn_roofline",
                 "svd.temporal_share", "svd.host_syncs_per_step", "svd.mfu"):
        assert harness.read_layer_metric(name, empty) is None, name


def test_svd_reference_imports_no_jax_or_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.svd.svd_xt, benchmark.counts.svd;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'animate3d_tpu', 'animate3d_tpu_torch'));"
            "print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
