"""The port's trainer CLI (animate3d_tpu_torch/cli/train_mvvdm.py) end to end
on the CPU at tiny size, mirroring tests/test_train_cli.py: sanity GIF,
metrics, checkpoints, the motion-module export, resume and validation;
plus its dataset and checkpoint helpers."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from animate3d_tpu_torch.core import checkpoint as ckpt
from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset, Prefetcher
from animate3d_tpu_torch.pipelines.train_mvvdm import extract_motion_modules


def _workspace(tmp_path, frames_per_view=0):
    """4 views as still PNGs, or as directories of ``frames_per_view``
    PNG frames, and a one-item manifest."""
    rng = np.random.default_rng(0)
    vids = tmp_path / "vids"
    vids.mkdir()
    views = []
    for v in range(4):
        if frames_per_view:
            d = vids / f"view{v}"
            d.mkdir()
            for f in range(frames_per_view):
                Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                    d / f"{f}.png")
            views.append(f"view{v}")
        else:
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                vids / f"view{v}.png")
            views.append(f"view{v}.png")
    (tmp_path / "manifest.json").write_text(json.dumps([{"videos": views, "caption": "t"}]))
    return vids


def _config(tmp_path, vids, extra=""):
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"""
output_dir: "{tmp_path}/out"
model_size: tiny
num_views: 4
video_length: 2
sample_size: 16
train_data:
  manifest_path: "{tmp_path}/manifest.json"
  video_root: "{vids}"
  total_frames: 4
max_train_steps: 2
checkpointing_steps: 2
learning_rate: 1.0e-4
global_seed: 0
{extra}""")
    return str(cfg)


def _metrics(tmp_path):
    return [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]


def test_train_cli_tiny_on_cpu_checkpoints_and_resumes(tmp_path):
    """Two steps with gradient checkpointing and validation sampling, then a
    second run with more steps that resumes from step 2."""
    from animate3d_tpu_torch.cli.train_mvvdm import main

    vids = _workspace(tmp_path, frames_per_view=4)
    cfg = _config(tmp_path, vids, "gradient_checkpointing: true\nvalidation_steps: 2\n"
                                  "validation_num_steps: 2\n")
    res = main(["--config", cfg, "--device", "cpu"])
    out = tmp_path / "out"
    with Image.open(out / "sanity_check.gif") as gif:
        assert gif.n_frames == 2
    assert (out / "samples" / "sample-2.gif").exists()
    for d in ("checkpoints", "motion_modules"):
        assert (out / d / "step_2" / "checkpoint.pt").exists()
    metrics = _metrics(tmp_path)
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm", "sec_per_step"))
    export = ckpt.restore_checkpoint(str(out / "motion_modules" / "step_2"))["params"]
    masters = res["optimizer"].masters
    assert set(export) == set(masters)
    for k, v in masters.items():
        assert torch.equal(export[k], v)

    res2 = main(["--config", cfg, "--device", "cpu", "max_train_steps=3"])
    assert res2["start_step"] == 2
    assert [m["step"] for m in _metrics(tmp_path)] == [0, 1, 2]
    assert (out / "checkpoints" / "step_3" / "checkpoint.pt").exists()
    state = ckpt.restore_checkpoint(str(out / "checkpoints" / "step_3"))
    assert state["step"] == 3 and state["optimizer"]["count"] == 3


def test_train_cli_without_device_cpu_raises_on_a_host_without_cuda(tmp_path):
    from animate3d_tpu_torch.cli.train_mvvdm import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    vids = _workspace(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", _config(tmp_path, vids)])


def test_dataset_reads_stills_and_frame_directories(tmp_path):
    vids = _workspace(tmp_path, frames_per_view=6)
    ds = MVideoDataset(MVideoConfig(manifest_path=str(tmp_path / "manifest.json"),
                                    video_root=str(vids), sample_size=8, sample_n_frames=3,
                                    total_frames=6), seed=0)
    with Prefetcher(ds.iterate(batch_size=2), depth=1) as prefetch:
        batch = next(prefetch)
    assert not prefetch._t.is_alive()  # close() ended the reader blocked on a full queue
    assert batch["pixel_values"].shape == (2, 4, 3, 8, 8, 3)
    assert -1.0 <= batch["pixel_values"].min() < batch["pixel_values"].max() <= 1.0
    assert batch["cameras"].shape == (2, 4, 16) and batch["text"] == ["t", "t"]


def test_dataset_mp4_raises_naming_the_native_decoder(tmp_path):
    (tmp_path / "a.mp4").write_bytes(b"\0" * 16)
    (tmp_path / "manifest.json").write_text(json.dumps([{"videos": ["a.mp4"] * 4}]))
    ds = MVideoDataset(MVideoConfig(manifest_path=str(tmp_path / "manifest.json"),
                                    video_root=str(tmp_path), sample_size=8,
                                    sample_n_frames=2, total_frames=2))
    with pytest.raises(RuntimeError, match="native"):
        ds[0]
    with Prefetcher(ds.iterate(), depth=1) as prefetch, pytest.raises(RuntimeError):
        next(prefetch)


def test_checkpoint_keep_and_latest(tmp_path):
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), step, {"step": step, "w": torch.ones(2) * step},
                             keep=2)
    assert ckpt.list_checkpoint_steps(str(tmp_path)) == [2, 3]
    latest = ckpt.find_latest_checkpoint(str(tmp_path))
    assert latest.endswith("step_3")
    assert torch.equal(ckpt.restore_checkpoint(latest)["w"], torch.full((2,), 3.0))
    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None
    state = {"down_blocks.0.motion_modules.0.proj_in.weight": torch.ones(1),
             "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q_i2v.weight":
                 torch.ones(1),
             "down_blocks.0.resnets.0.conv1.weight": torch.ones(1)}
    assert set(extract_motion_modules(state)) == set(list(state)[:2])


@pytest.mark.parametrize("override", ["use_wandb=true"])
def test_train_cli_refuses_what_is_not_ported(tmp_path, override):
    from animate3d_tpu_torch.cli.train_mvvdm import main

    vids = _workspace(tmp_path)
    with pytest.raises(NotImplementedError):
        main(["--config", _config(tmp_path, vids), "--device", "cpu", override])
