"""The CogVideoX image-to-video cell (``drivers/cogvideox_i2v.py``) on a
tiny CogVideoX on the CPU: a clean run reads ``correct``; each fault the
cell is built to catch, planted in the program, reads incorrect; the
cell's files are found by name; its per-layer readers read what a trace
holds and nothing where it holds nothing; the reference and the counts
import nothing of JAX or of the program."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness

from .cells import BENCH, HERE


def _spec() -> harness.CellSpec:
    config = json.loads((HERE / "cogvideox-tiny.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "cogvideox_i2v.json").read_text())
    traffic.update(steps=4, check_steps=2, check_below=3, prompt_len=[2, 4])
    e2e = [{"name": "sample_step_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]
    return harness.CellSpec(name="cogvideox-tiny", chips=1, config_name="cogvideox-tiny",
                            config=config, traffic_name="cogvideox_i2v", traffic=traffic,
                            end_to_end=e2e, per_layer=[])


def _run(seed: int = 2 ** 31 + 4321) -> dict:
    from benchmark.drivers import cogvideox_i2v

    torch.set_num_threads(4)
    return harness.run_cell(_spec(), cogvideox_i2v, seed, 0.3, False, time.perf_counter(),
                            torch.device("cpu"))


def _no_rope(mp):
    from animate3d_tpu_torch.models import transformer_cogvideox as T

    mp.setattr(T, "apply_rotary", lambda x, cos, sin: x)


def _rope_text(mp):
    from animate3d_tpu_torch.models import transformer_cogvideox as T

    def qk(self, x, norm, n_text, rope):
        b, s, d = x.shape
        cos, sin = (torch.cat([r[:n_text], r]) for r in rope)
        return T.apply_rotary(norm(x.view(b, s, self.heads, -1)), cos, sin).reshape(b, s, d)

    mp.setattr(T.JointAttention, "_qk", qk)


def _no_qk_norm(mp):
    from animate3d_tpu_torch.models import transformer_cogvideox as T

    orig = T.JointAttention._qk
    mp.setattr(T.JointAttention, "_qk",
               lambda self, x, norm, n, rope: orig(self, x, lambda y: y, n, rope))


def _gates_one(mp):
    from animate3d_tpu_torch.models import transformer_cogvideox as T

    orig = T.LayerNormZero.forward

    def forward(self, x, n_text, temb):
        y, g, eg = orig(self, x, n_text, temb)
        return y, torch.ones_like(g), torch.ones_like(eg)

    mp.setattr(T.LayerNormZero, "forward", forward)


def _no_pos_emb(mp):
    from animate3d_tpu_torch.models import transformer_cogvideox as T

    orig = T.PatchEmbed.forward
    mp.setattr(T.PatchEmbed, "forward", lambda self, text, video: orig(self, text, video)
               - self.pos_embedding.to(text.dtype))


def _image_zero(mp):
    from animate3d_tpu_torch.pipelines import cogvideox_sampler as S

    orig = S.CogVideoXSampler.encode_image
    mp.setattr(S.CogVideoXSampler, "encode_image",
               lambda self, image, gen: torch.zeros_like(orig(self, image, gen)))


def _v_as_eps(mp):
    from animate3d_tpu_torch.models import diffusion

    def coefficients(self, t, n):
        prev = t - self.config.num_train_timesteps // n
        a_t = max(float(self.alphas64[t]), 1e-12)
        a_prev = float(self.alphas64[prev]) if prev >= 0 else self.final64
        r = (a_prev / a_t) ** 0.5
        return r, (1 - a_prev) ** 0.5 - r * (1 - a_t) ** 0.5

    mp.setattr(diffusion.DDIMScheduler, "step_coefficients", coefficients)


def _leading(mp):
    from animate3d_tpu_torch.models import diffusion

    def timesteps(self, n):
        ratio = self.config.num_train_timesteps // n
        return torch.as_tensor((np.arange(n) * ratio).round()[::-1].copy(), dtype=torch.int64)

    mp.setattr(diffusion.DDIMScheduler, "timesteps", timesteps)


FAULTS = {"no_rope": _no_rope, "rope_text": _rope_text, "no_qk_norm": _no_qk_norm,
          "gates_one": _gates_one, "no_pos_emb": _no_pos_emb, "image_zero": _image_zero,
          "v_as_eps": _v_as_eps, "leading": _leading}


def test_clean_run_reads_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and set(res["checks"]) == {
        "text_rel", "image_rel", "starts_rel", "attn_rel", "v_rel", "step_rel", "decode_rel"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_cell_files_found_by_name():
    cell = harness.load_cell(BENCH.parent, "cogvideox5b-i2v-480x720")
    assert cell.chips == 1 and cell.traffic["driver"] == "cogvideox_i2v"
    assert cell.config["transformer"]["num_layers"] == 42 and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["sample_step_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "cogvideox.device_idle_share", "cogvideox.mfu", "cogvideox.attn_share",
        "cogvideox.flash_fwd_roofline", "cogvideox.host_syncs_per_step"}


def test_cogvideox_readers():
    """The roofline reads kernel A's 64-wide instance at the joint shape;
    the attention share the span's device time; with nothing of theirs in
    the trace they read None."""
    from benchmark.counts import svd

    key = (2, 17776, 17776, 3072, 1)
    t = harness.TraceSummary(
        window_s=10.0, busy_s=8.0, units=6, config={},
        kernels={"void (anonymous namespace)::flash_fwd_kernel<64>(CUtensorMap_st)": [4.0, 252]},
        launches={("flash_fwd", key): 252, ("span_calls", "cogvideox.forward"): 6,
                  ("host_sync", "cogvideox_sampler.step"): 6},
        counts={"attn_device_s": 4.4, "flops": 6.6e14 * 6})
    a = harness.read_layer_metric("cogvideox.flash_fwd_roofline", t)
    assert a == pytest.approx(100.0 * 252 * svd.flash_fwd_d64(key) / 4.0)
    assert harness.read_layer_metric("cogvideox.attn_share", t) == pytest.approx(55.0)
    assert harness.read_layer_metric("cogvideox.host_syncs_per_step", t) == pytest.approx(1.0)
    assert harness.read_layer_metric("cogvideox.mfu", t) == pytest.approx(
        100.0 * 6.6e14 * 6 / (10.0 * 989e12))
    empty = harness.TraceSummary(window_s=10.0, busy_s=8.0, kernels={}, launches={}, units=1,
                                 config={})
    for name in ("cogvideox.flash_fwd_roofline", "cogvideox.attn_share",
                 "cogvideox.host_syncs_per_step", "cogvideox.mfu"):
        assert harness.read_layer_metric(name, empty) is None, name


def test_cogvideox_reference_imports_no_jax_or_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.cogvideox.cogvideox, benchmark.counts.cogvideox;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'animate3d_tpu', 'animate3d_tpu_torch'));"
            "print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
