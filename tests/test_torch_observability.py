"""The port's observability and launch leftovers against the JAX package's:
TensorBoard event files (``utils/tb_writer.py``) read back across the two
packages, the metrics logger, the progress file, the ``torch.profiler``
trace, the trial's provenance files, and the ``--typecheck`` contracts
(``core/typecheck.py``) rejecting what the JAX package's jaxtyping contracts
reject, on the same inputs."""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.core import typecheck as JTC
from animate3d_tpu.utils import tb_writer as JTB
from animate3d_tpu_torch.core import typecheck as TTC
from animate3d_tpu_torch.utils import logging as TL
from animate3d_tpu_torch.utils import tb_writer as TTB


def test_tb_events_read_back_across_packages(tmp_path):
    scalars = {"loss": 0.25, "psnr": 31.5, "note": "text"}
    for writer, reader, name in ((TTB.TBWriter, JTB.read_events, "port"),
                                 (JTB.TBWriter, TTB.read_events, "jax")):
        w = writer(str(tmp_path / name))
        w.scalars(scalars, 3)
        w.scalar("loss", 0.125, 4)
        w.close()
        events = reader(w.path)
        assert events == [(3, "loss", 0.25), (3, "psnr", 31.5), (4, "loss", 0.125)]


def test_metrics_logger_writes_jsonl_and_tb(tmp_path):
    log = TL.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log(0, {"loss": torch.tensor(0.5), "tag": "a"})
    log.log(1, {"loss": 0.25})
    log.close()
    lines = [json.loads(x) for x in open(tmp_path / "m" / "metrics.jsonl")]
    assert lines == [{"step": 0, "loss": 0.5, "tag": "a"}, {"step": 1, "loss": 0.25}]
    assert log.tb_path.startswith(str(tmp_path / "m" / "tb"))
    assert JTB.read_events(log.tb_path) == [(0, "loss", 0.5), (1, "loss", 0.25)]
    off = TL.MetricsLogger(str(tmp_path / "n" / "metrics.jsonl"), tb_dir="")
    assert off.tb_path is None


def test_progress_writer_rewrites_one_line(tmp_path):
    from animate3d_tpu.utils.logging import ProgressWriter as JPW

    lines = []
    for cls, name in ((TL.ProgressWriter, "port"), (JPW, "jax")):
        pw = cls(str(tmp_path / name / "progress"))
        pw.train_step(10, 200)
        pw.train_step(100, 200)
        pw.close()
        lines.append(open(tmp_path / name / "progress").read())
    assert lines[0] == lines[1] == "Generation progress: 50.00%"


def test_step_timer_and_profile_trace(tmp_path):
    timer = TL.StepTimer("cpu")
    for _ in range(2):
        with timer:
            torch.ones(8).sum()
    assert timer.count == 2 and timer.mean > 0
    with TL.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(prof.trace_path))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with TL.profile_trace(None) as off:
        assert off is None


def _agree(jax_fn, port_fn, *arrays, **kw):
    """Both contracts on the same numpy inputs: both pass or both raise."""
    try:
        jax_fn(*(jnp.asarray(a) for a in arrays))
        jax_ok = True
    except Exception:
        jax_ok = False
    try:
        port_fn(*(torch.as_tensor(a) for a in arrays), **kw)
        port_ok = True
    except TTC.TypeCheckError:
        port_ok = False
    assert jax_ok == port_ok, (jax_ok, [a.shape for a in arrays])
    return port_ok


F32 = np.float32


def _z(*shape, dtype=F32):
    return np.zeros(shape, dtype)


@pytest.mark.parametrize("case,ok", [
    ((_z(8, 4, 4, 3), _z(8, 4, 4, 1), _z(8)), True),
    ((_z(8, 4, 4, 3), _z(8, 4, 4, 3), _z(8)), False),  # a 3-channel mask
    ((_z(7, 4, 4, 3), _z(8, 4, 4, 1), _z(8)), False),  # rgb's batch
    ((_z(8, 4, 4, 3), _z(8, 4, 5, 1), _z(8)), False),  # mask's width
    ((_z(8, 4, 4, 3), _z(8, 4, 4, 1), _z(8, 1)), False),  # timestamps' rank
    ((_z(8, 4, 4, 3, dtype=np.uint8), _z(8, 4, 4, 1), _z(8, dtype=np.int32)), True),
])
def test_recon_batch_contract(case, ok):
    assert _agree(JTC._check_recon_batch, TTC.check_recon_batch, *case) == ok


@pytest.mark.parametrize("case,ok", [
    ((_z(4), _z(4, 4, 4), _z(4, 4, 4), _z(4, 3)), True),
    ((_z(4), _z(4, 3, 4), _z(4, 4, 4), _z(4, 3)), False),
    ((_z(4), _z(4, 4, 4), _z(4, 4, 4), _z(3, 3)), False),
    ((_z(5), _z(4, 4, 4), _z(4, 4, 4), _z(4, 3)), False),
    ((_z(4), _z(4, 4, 4, dtype=np.int32), _z(4, 4, 4), _z(4, 3)), False),  # not float
])
def test_render_batch_contract(case, ok):
    assert _agree(JTC._check_render_batch, TTC.check_render_batch, *case) == ok


@pytest.mark.parametrize("case,ok", [
    ((_z(5, 3), _z(5, 3), _z(5, 4), _z(5)), True),
    ((_z(5, 3), _z(5, 3), _z(5, 3), _z(5)), False),
    ((_z(5, 3), _z(5, 3), _z(5, 4), _z(4)), False),
    ((_z(5, 3), _z(6, 3), _z(5, 4), _z(5)), False),
    ((_z(5, 3, dtype=np.int32), _z(5, 3), _z(5, 4), _z(5)), False),
])
def test_rasterize_contract(case, ok):
    assert _agree(JTC._check_rasterize, TTC.check_rasterize, *case) == ok


def test_rasterize_contract_takes_the_ports_view_axis():
    """The port's rasterize renders B views at once: a leading axis, bound
    alike over means, scales and rotations."""
    TTC.check_rasterize(_z(2, 5, 3), _z(2, 5, 3), _z(2, 5, 4), _z(5))
    with pytest.raises(TTC.TypeCheckError):
        TTC.check_rasterize(_z(2, 5, 3), _z(3, 5, 3), _z(2, 5, 4), _z(5))


@pytest.mark.parametrize("case,ok", [
    ((_z(2, 8, 16), _z(2, 8, 16), _z(2, 8, 16)), True),
    ((_z(2, 8, 16), _z(2, 4, 16), _z(2, 4, 16)), True),  # cross attention
    ((_z(2, 8, 16), _z(2, 8, 16), _z(2, 4, 16)), False),  # k / v lengths
    ((_z(2, 8, 16), _z(2, 8, 8), _z(2, 8, 8)), False),  # channels
    ((_z(2, 8, 16), _z(2, 8, 16), _z(2, 8)), False),  # v's rank
    ((_z(2, 8, 16, dtype=bool), _z(2, 8, 16), _z(2, 8, 16)), False),  # bool is no number
])
def test_attention_contract(case, ok):
    assert _agree(JTC._check_attention, TTC.check_attention, *case, num_heads=2) == ok


def test_attention_contract_heads_and_kv_group():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError):
        TTC.check_attention(q, q, q, num_heads=3)
    TTC.check_attention(q, q[:2], q[:2], num_heads=2, kv_group=2)
    with pytest.raises(TTC.TypeCheckError):
        TTC.check_attention(q, q[:2], q[:2], num_heads=2)


def test_enable_typecheck_wraps_the_boundaries_and_restores():
    from animate3d_tpu_torch.models import attention_layers
    from animate3d_tpu_torch.ops import attention
    from animate3d_tpu_torch.systems import animate3d

    originals = (attention.multi_head_attention, attention_layers.multi_head_attention,
                 animate3d.Animate3DSystem.step, animate3d.render_batch)
    TTC.enable_typecheck()
    try:
        assert attention.multi_head_attention is not originals[0]
        q = torch.randn(2, 8, 16)
        out = attention_layers.multi_head_attention(q, q, q, 2, self_attention=True)
        assert out.shape == (2, 8, 16)
        with pytest.raises(TTC.TypeCheckError):
            attention.multi_head_attention(q, q, q[:, :4], 2)
    finally:
        TTC.disable_typecheck()
    assert (attention.multi_head_attention, attention_layers.multi_head_attention,
            animate3d.Animate3DSystem.step, animate3d.render_batch) == originals


def test_snapshot_provenance(tmp_path):
    from animate3d_tpu_torch.cli.launch import snapshot_provenance

    snapshot_provenance(str(tmp_path), ["--config", "x.yaml", "--train"])
    assert open(tmp_path / "cmd.txt").read() == (
        "python -m animate3d_tpu_torch.cli.launch --config x.yaml --train\n")
    with zipfile.ZipFile(tmp_path / "code_snapshot.zip") as z:
        names = z.namelist()
    assert "animate3d_tpu_torch/cli/launch.py" in names
    assert "animate3d_tpu_torch/csrc/flash_fwd.cu" in names
    assert "animate3d_tpu_torch/csrc/hopper_common.cuh" in names
    assert not any(n.startswith("animate3d_tpu/") or "__pycache__" in n or "/_build/" in n
                   for n in names)


def test_launch_typecheck_gradio_and_provenance(tmp_path):
    """One recon step through the launch CLI with ``--typecheck --gradio``:
    the contracts pass on the real batch, the trial holds ``progress``,
    ``cmd.txt``, ``code_snapshot.zip`` and a TB event file; a planted
    3-channel mask then fails at the step's boundary."""
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import main
    from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
    from animate3d_tpu_torch.gaussians.state import random_state

    rng = np.random.default_rng(0)
    (tmp_path / "frames").mkdir()
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (16, 16, 4), dtype=np.uint8), "RGBA").save(
            tmp_path / "frames" / f"{i}.png")
    write_gaussian_ply(str(tmp_path / "asset.ply"),
                       random_state(20, radius=0.4, generator=torch.Generator().manual_seed(0)))
    (tmp_path / "c.yaml").write_text(f"""
name: "tc"
tag: "t"
use_timestamp: false
exp_root_dir: "{tmp_path}/outputs"
data: {{image_root: "{tmp_path}/frames", height: 16, width: 16, n_view: 4, total_frame: 2}}
system:
  n_view: 4
  n_frame: 2
  test_option: "four_view"
  geometry: {{grid_size: [[4, 4, 4, 2]], n_grid_dims: 4,
              geometry_convert_from: "{tmp_path}/asset.ply"}}
  loss: {{arap_K: 3, arap_sample_num: 8, arap_radius: 0.5}}
trainer: {{max_steps: 1, log_every_n_steps: 1}}
""")
    try:
        res = main(["--config", str(tmp_path / "c.yaml"), "--train", "--device", "cpu",
                    "--typecheck", "--gradio"])
        trial = tmp_path / "outputs" / "tc" / "t"
        assert open(trial / "progress").read() == "Rendering video ..."
        assert "--typecheck --gradio" in open(trial / "cmd.txt").read()
        with zipfile.ZipFile(trial / "code_snapshot.zip") as z:
            assert "animate3d_tpu_torch/core/typecheck.py" in z.namelist()
        (events,) = (trial / "tb").glob("events.out.tfevents.*")
        assert {tag for _, tag, _ in JTB.read_events(str(events))} >= {"loss", "psnr"}
        system = res["system"]
        from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch

        cams = fixed_view_cameras(height=16, width=16, total_frame=2)
        bad = {"gs_cameras": gs_cameras_from_batch(cams), "timestamps": cams["timestamps"],
               "rgb": torch.zeros(8, 16, 16, 3), "mask": torch.zeros(8, 16, 16, 3)}
        with pytest.raises(TTC.TypeCheckError, match="mask"):
            system.step(bad)
    finally:
        TTC.disable_typecheck()
