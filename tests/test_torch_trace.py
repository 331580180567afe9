"""The port's spans and counters (``utils/trace.py``): off outside a
profiler session, on inside one, the host-sync and weight-cast counters,
the spans a recon step, a train step and a sampling run open, and the
``--profile_dir`` exporters. No JAX here: the one test for the card runs
there as it is."""

import json
import warnings

import numpy as np
import pytest
import torch

from animate3d_tpu_torch.ops import _build
from animate3d_tpu_torch.utils import trace

N_VIEWS = 4


@pytest.fixture(autouse=True)
def _disarmed():
    """Each test starts and ends with the sync hook off and no profiler."""
    yield
    trace.span("_")  # outside a session: restores the sync mode and hook
    assert warnings.showwarning is not trace._show


def _profiled(fn):
    """Run ``fn()`` under a CPU profiler session → (its result, the
    counters' change, the profiler)."""
    before = trace.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.changes(before), prof


def _by(name, changes):
    return {k: n for (c, k), n in changes.items() if c == name}


def test_span_off_is_one_shared_noop(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    before = trace.snapshot()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"), trace.span("b"):
        torch.ones(4).sum()
    lin = torch.nn.Linear(4, 4)
    assert trace.cast(lin.weight, torch.bfloat16).dtype == torch.bfloat16
    assert calls == [] and trace.snapshot() == before
    _, changes, prof = _profiled(lambda: torch.ones(4).sum())
    assert not changes
    assert not {"a", "b"} & {e.name for e in prof.events()}


def test_span_on_lands_in_the_profile_and_counts():
    def nested():
        import time

        with trace.span("t.outer"):
            time.sleep(0.002)
            with trace.span("t.inner"):
                time.sleep(0.003)
            with trace.span("t.inner"):
                time.sleep(0.001)

    _, changes, prof = _profiled(nested)
    assert {"t.outer", "t.inner"} <= {e.name for e in prof.events()}
    calls, ns, self_ns = (_by(c, changes) for c in ("span_calls", "span_ns", "span_self_ns"))
    assert calls == {"t.outer": 1, "t.inner": 2}
    assert ns["t.inner"] >= 4e6 and ns["t.outer"] >= ns["t.inner"] + 2e6
    assert self_ns["t.inner"] == ns["t.inner"]
    assert self_ns["t.outer"] == ns["t.outer"] - ns["t.inner"]


def test_host_sync_hook_counts_every_warning_by_innermost_span():
    def syncs():
        for _ in range(3):  # one call site: the registry must not keep it once
            with trace.span("t.outer"), trace.span("t.inner"):
                warnings.warn(trace.SYNC_WARNING)
        with trace.span("t.outer"):
            warnings.warn(trace.SYNC_WARNING + " (Triggered internally)")
        warnings.warn(trace.SYNC_WARNING)

        class Syncing(torch.autograd.Function):  # a sync in a backward
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                warnings.warn(trace.SYNC_WARNING)
                return g * 2

        x = torch.ones(3, requires_grad=True)
        y = Syncing.apply(x).sum()
        with trace.span("t.backward"):
            y.backward()

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        _, changes, _ = _profiled(syncs)
        warnings.warn("another warning")
    assert _by("host_sync", changes) == {"t.inner": 3, "t.outer": 1, "outside": 1,
                                         "t.backward": 1}
    assert [str(w.message) for w in shown] == ["another warning"]


def test_weight_cast_counts_launched_casts():
    from animate3d_tpu_torch.models.layers import Conv2d, GroupNorm, Linear

    torch.manual_seed(0)
    lin, lin_b, conv = Linear(4, 4, bias=False), Linear(4, 4), Conv2d(4, 4, 1)
    norm = GroupNorm(2, 4).to(torch.bfloat16)
    x = torch.randn(2, 4)

    def run():
        lin(x.bfloat16())
        lin_b(x.bfloat16())
        conv(x.bfloat16()[..., None, None])
        lin(x)
        conv(x[..., None, None])
        norm(x[..., None, None])
        GroupNorm(2, 4)(x.bfloat16()[..., None, None])  # f32 weights read as f32: no cast

    _, changes, _ = _profiled(run)
    assert _by("weight_cast", changes) == {"float32->bfloat16": 5, "bfloat16->float32": 2}


def test_program_spans_never_take_a_traffic_span_name():
    """The benchmark's traffic files name the spans its drivers open (the
    idle-gap labels of its breakdown); the port's spans, as its sources
    open them, use other names."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    traffic = {name for f in (root / "benchmark" / "traffic").glob("*.json")
               for name in json.load(open(f)).get("spans", [])}
    program = {m for f in (root / "animate3d_tpu_torch").rglob("*.py")
               for m in re.findall(r'trace\.span(?:ned)?\("([^"]+)"\)', f.read_text())}
    assert {"animate3d.step", "unet.forward", "prefetcher.wait"} <= program
    assert "system.step" in traffic and not program & traffic


def test_launch_totals_ignore_other_counters():
    base = _build.launch_totals()
    trace.COUNTERS["span_ns", "t.other"] += 5
    trace.COUNTERS["host_sync", "outside"] += 1
    try:
        assert _build.LAUNCHES is trace.COUNTERS
        assert _build.launch_totals() == base
    finally:
        del trace.COUNTERS["span_ns", "t.other"]
        trace.COUNTERS["host_sync", "outside"] -= 1


RECON_SPANS = {"animate3d.step", "animate3d.step_batch", "animate3d.loss", "deform.frames",
               "kplanes.sample", "renderer4d.render_batch", "rasterize.project",
               "rasterize.select", "rasterize.composite", "rasterize.composite_bwd",
               "arap.loss", "animate3d.backward", "deform_adam.step"}


def test_recon_step_opens_its_spans():
    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.gaussians.deform import DeformConfig
    from animate3d_tpu_torch.gaussians.state import random_state
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig
    from animate3d_tpu_torch.systems.animate3d import (Animate3DConfig, Animate3DSystem,
                                                       LossConfig)

    res, nf = 16, 2
    cfg = Animate3DConfig(n_view=N_VIEWS, n_frame=nf,
                          deform=DeformConfig(grid_sizes=((4, 4, 4, 2),), grid_feature_dim=4,
                                              use_global_trans=True),
                          renderer=Renderer4DConfig(height=res, width=res),
                          loss=LossConfig(arap_sample_num=8, arap_radius=0.5))
    state = random_state(20, radius=0.4, generator=torch.Generator().manual_seed(0))
    system = Animate3DSystem(cfg, state=state, device="cpu")
    cams = fixed_view_cameras(height=res, width=res, total_frame=nf)
    rng = np.random.default_rng(0)
    batch = {"gs_cameras": gs_cameras_from_batch(cams), "timestamps": cams["timestamps"],
             "rgb": torch.from_numpy(rng.uniform(size=(N_VIEWS * nf, res, res, 3))).float(),
             "mask": torch.ones(N_VIEWS * nf, res, res, 1)}
    _, changes, _ = _profiled(lambda: system.step(batch))
    calls = _by("span_calls", changes)
    assert RECON_SPANS <= set(calls) and calls["animate3d.step"] == 1
    assert _by("span_self_ns", changes)["animate3d.step"] >= 0


def test_train_step_opens_its_spans_and_counts_casts():
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.pipelines import train_mvvdm as TT

    unet, *_ = build_models("tiny", N_VIEWS, "cpu", seed=0, train=True, clip=False)
    masters = TT.cast_frozen_bf16(unet, torch.bfloat16)
    cfg = TT.MVVDMTrainConfig(num_views=N_VIEWS)
    ucfg = unet.config
    rng = np.random.default_rng(2)
    batch = TT.TrainBatch(*(torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
                            ((N_VIEWS, 2, 8, 8, 4), (N_VIEWS, 77, ucfg.cross_attention_dim),
                             (N_VIEWS, 77, ucfg.cross_attention_dim), (N_VIEWS, 16),
                             (N_VIEWS, ucfg.image_embed_dim))))
    opt = TT.make_optimizer(masters, cfg)
    _, changes, _ = _profiled(lambda: TT.train_step(
        unet, opt, batch, cfg, DDIMScheduler(), torch.Generator().manual_seed(0)))
    calls = _by("span_calls", changes)
    assert {"train_mvvdm.step", "train_mvvdm.forward", "train_mvvdm.backward",
            "master_adamw.step", "master_adamw.clip", "unet.forward"} <= set(calls)
    assert calls["unet.forward"] == 1
    assert _by("weight_cast", changes)["float32->bfloat16"] > 0


def test_two_step_sample_opens_its_spans():
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.pipelines.mv_sampler import (MVSampler, MVSamplerConfig,
                                                          decode_video)

    unet, vae, text, vision = build_models("tiny", N_VIEWS, "cpu", seed=0)
    sampler = MVSampler(unet, MVSamplerConfig(num_inference_steps=2, num_views=N_VIEWS,
                                              num_frames=2, height=16, width=16,
                                              vae_scale_factor=2, freeinit_num_iters=1))
    gen = torch.Generator().manual_seed(0)

    def run():
        embeds = encode_ip_adapter_images(vision, torch.rand(N_VIEWS, 16, 16, 3))
        ctx = text(torch.zeros(N_VIEWS, 77, dtype=torch.long))
        first = vae.encode(torch.rand(N_VIEWS, 16, 16, 3))[0][:, None]
        latents = sampler.sample(first, ctx, ctx, embeds, generator=gen)
        return decode_video(vae, latents)

    _, changes, _ = _profiled(run)
    calls = _by("span_calls", changes)
    assert calls["mv_sampler.round"] == 1 and calls["mv_sampler.step"] == 2
    assert calls["unet.forward"] == 2
    assert {"clip.text_tower", "clip.vision_tower", "vae.encoder", "vae.decoder"} <= set(calls)


def test_inference_cli_profile_dir_writes_trace_and_summary(tmp_path):
    from PIL import Image

    from animate3d_tpu_torch.cli.inference import main

    rng = np.random.default_rng(0)
    for i in range(N_VIEWS):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    res = main(["--device", "cpu", "--model_size", "tiny", "-W", "16", "-H", "16", "-L", "2",
                "--steps", "2", "--freeinit_iters", "2", "--ip_image_root", str(tmp_path),
                "--output_dir", str(tmp_path / "out"), "--profile_dir", str(tmp_path / "p")])
    prof = res["profile"]
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert {"mv_sampler.step", "unet.forward"} <= {e.get("name") for e in events}
    summary = json.load(open(tmp_path / "p" / "summary.json"))
    assert prof.summary_path == str(tmp_path / "p" / "summary.json")
    assert summary["span_calls"]["unet.forward"] == len(res["step_seconds"]) == 4
    assert summary["span_calls"]["mv_sampler.round"] == 2


def test_step_profile_traces_steps_10_to_19(tmp_path):
    from animate3d_tpu_torch.utils.logging import PROFILE_STEPS, StepProfile

    with StepProfile(str(tmp_path)) as profile:
        for i in range(PROFILE_STEPS.stop + 2):
            profile.before(i)
            with trace.span("t.step"):
                pass
            profile.after(i)
    summary = json.load(open(tmp_path / "summary.json"))
    assert summary["span_calls"] == {"t.step": len(PROFILE_STEPS)}
    assert len(list(tmp_path.glob("trace.*.json"))) == 1
    with StepProfile(str(tmp_path / "short")) as profile:  # a run that ends inside the range
        for i in range(PROFILE_STEPS.start + 2):
            profile.before(i)
            with trace.span("t.step"):
                pass
    assert json.load(open(tmp_path / "short" / "summary.json"))["span_calls"] == {"t.step": 2}


@pytest.mark.cuda
def test_host_syncs_counted_on_cuda():
    """``x.item()``, a blocking ``as_tensor`` of a numpy array to the card,
    ``trace.synchronize`` and a sync in a backward on autograd's device
    thread each count one ``host_sync`` under their span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(4, device="cuda")
    a = np.arange(1 << 20, dtype=np.float32)

    class Syncing(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return v * 2

        @staticmethod
        def backward(ctx, g):
            g.sum().item()
            return g * 2

    w = torch.ones(4, device="cuda", requires_grad=True)
    y = Syncing.apply(w).sum()
    torch.cuda.synchronize()

    def run():
        with trace.span("t.item"):
            x.sum().item()
        with trace.span("t.copy"):
            torch.as_tensor(a, device="cuda")
        with trace.span("t.sync"):
            trace.synchronize()
        with trace.span("t.backward"):
            y.backward()

    before = trace.snapshot()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        run()
    assert _by("host_sync", trace.changes(before)) == {
        "t.item": 1, "t.copy": 1, "t.sync": 1, "t.backward": 1}
    assert torch.cuda.get_sync_debug_mode() == 0 or trace._armed
