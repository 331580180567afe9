"""Stage-1 motion reconstruction: the port's system step, optimizer, config
and CLI against the JAX package's, on the CPU.

One JAX ``Animate3DSystem`` is shared by the file. Its renderer is
monkeypatched here to ``rasterize(backend="pallas")`` (the coarse-direct
route, kernel H in interpret mode) for the duration of the module; the JAX
package itself is not edited. The port gets the JAX step's straight-through
masks and ARAP node sample, recomputed with the same ``jax.random`` splits.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import animate3d_tpu.rendering.renderer4d as jr4
from animate3d_tpu.core import config as jconfig
from animate3d_tpu.core import schedule as jschedule
from animate3d_tpu.data.cameras import fixed_view_cameras as jfixed_view_cameras
from animate3d_tpu.data.cameras import gs_cameras_from_batch as jgs_cameras_from_batch
from animate3d_tpu.gaussians.deform import DeformConfig as JDeformConfig
from animate3d_tpu.gaussians.state import GaussianState as JGaussianState
from animate3d_tpu.ops.rasterize import rasterize as jrasterize
from animate3d_tpu.systems import animate3d as jsys
from animate3d_tpu_torch.convert.from_flax import deform_params_from_flax
from animate3d_tpu_torch.core import config, schedule
from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
from animate3d_tpu_torch.gaussians.deform import DeformConfig
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.rendering.renderer4d import RenderDraws, Renderer4DConfig
from animate3d_tpu_torch.systems.animate3d import (
    Animate3DConfig,
    Animate3DSystem,
    DeformAdam,
    LossConfig,
    StepDraws,
)

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

N, NV, NF, RES = 80, 2, 4, 96  # 96² = 36 tiles: the coarse-direct route (kernel H)
GRID = ((8, 8, 8, 4), (12, 12, 12, 4))
METRICS = ("loss", "loss_rgb", "loss_mask", "psnr", "loss_arap", "raster_overflow")


def _scene():
    rng = np.random.default_rng(0)
    return dict(xyz=rng.uniform(-0.4, 0.4, (N, 3)), features_dc=rng.uniform(-1, 1, (N, 1, 3)),
                features_rest=np.zeros((N, 0, 3)), opacity=rng.uniform(-1, 3, (N, 1)),
                scaling=rng.uniform(-3.2, -2.2, (N, 3)), rotation=rng.normal(size=(N, 4)))


def _configs():
    common = dict(n_view=NV, n_frame=NF, progressive_iter_per_frame=50)
    jcfg = jsys.Animate3DConfig(
        **common, deform=JDeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                       use_global_trans=True),
        renderer=jr4.Renderer4DConfig(height=RES, width=RES, back_ground_color=(0.5, 0.5, 0.5)),
        loss=jsys.LossConfig(arap_sample_num=32))
    cfg = Animate3DConfig(
        **common, deform=DeformConfig(grid_sizes=GRID, grid_feature_dim=4, use_global_trans=True),
        renderer=Renderer4DConfig(height=RES, width=RES, back_ground_color=(0.5, 0.5, 0.5)),
        loss=LossConfig(arap_sample_num=32))
    return jcfg, cfg


@pytest.fixture(scope="module")
def recon():
    """The shared JAX system (renderer on the Pallas route), its initial
    params as numpy, the whole-video batch for both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr4, "rasterize", functools.partial(jrasterize, backend="pallas"))
        d = {k: v.astype(np.float32) for k, v in _scene().items()}
        jcfg, cfg = _configs()
        jsystem = jsys.Animate3DSystem(
            jcfg, state=JGaussianState(**{k: jnp.asarray(v) for k, v in d.items()}),
            key=jax.random.PRNGKey(1))
        params0 = jax.tree_util.tree_map(np.asarray, jsystem.params)
        rng = np.random.default_rng(1)
        rgb = rng.uniform(size=(NV * NF, RES, RES, 3)).astype(np.float32)
        mask = rng.uniform(size=(NV * NF, RES, RES, 1)) > 0.3
        jcams = jfixed_view_cameras(azimuths_deg=(0.0, 120.0), height=RES, width=RES,
                                    total_frame=NF)
        jbatch = {"gs_cameras": jgs_cameras_from_batch(jcams), "timestamps": jcams["timestamps"],
                  "rgb": rgb, "mask": mask}
        cams = fixed_view_cameras(azimuths_deg=(0.0, 120.0), height=RES, width=RES,
                                  total_frame=NF)
        batch = {"gs_cameras": gs_cameras_from_batch(cams), "timestamps": cams["timestamps"],
                 "rgb": torch.from_numpy(rgb), "mask": torch.from_numpy(mask.astype(np.float32))}
        yield jsystem, params0, jbatch, cfg, GaussianState.from_numpy(**d), batch


def _jax_draws(key, n_items, sample_num=32):
    """The JAX step's draws: ``k_render, k_arap, _ = split(key, 3)``, one
    straight-through mask per item from ``split(k_render, B)``, the ARAP
    node sample ``choice(k_arap, N, (sample_num,))``."""
    k_render, k_arap, _ = jax.random.split(key, 3)
    masks = np.stack([np.asarray(jax.random.uniform(k, (N, 1)) < 0.1, np.float32)
                      for k in jax.random.split(k_render, n_items)])
    idx = np.array(jax.random.choice(k_arap, N, (sample_num,), replace=True))
    return StepDraws(render=RenderDraws(torch.from_numpy(masks)),
                     arap_idx=torch.as_tensor(idx, dtype=torch.long))


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.05).astype(v.dtype)
        if "out" in jax.tree_util.keystr(p) else v, params)


def _port_system(cfg, state, params, global_step):
    s = Animate3DSystem(cfg, state=state, seed=0, device="cpu")
    s.field.load_state_dict(deform_params_from_flax(params), strict=True)
    s.global_step = global_step
    return s


@pytest.mark.parametrize("strategy", ["normal", "light"])
def test_system_step_matches_jax(recon, strategy):
    """Step 0 at the initial weights: 'normal' unlocks 1 frame, which frame
    bucketing pads to 2 (weights 1, 0); 'light' gathers that frame twice
    (weights 1, 1): 2 x 2 items either way. Loss and metrics at 1e-5
    relative, and every parameter after one Adam step (eps 1e-15: a nonzero
    gradient moves its weight by about ±lr) at 1e-5 relative."""
    jsystem, params0, jbatch, cfg, state, batch = recon
    key = jax.random.PRNGKey(5)
    jsystem.params = jax.tree_util.tree_map(jnp.asarray, params0)
    jsystem.opt_state = jsystem.tx.init(jsystem.params)
    jsystem.global_step = 0
    jsystem.cfg.sample_strategy = strategy
    try:
        jm = {k: float(v) for k, v in jsystem.step(jbatch, key).items()}
    finally:
        jsystem.cfg.sample_strategy = "normal"
    jparams = deform_params_from_flax(jax.tree_util.tree_map(np.asarray, jsystem.params))

    port = _port_system(dataclasses.replace(cfg, sample_strategy=strategy), state, params0, 0)
    assert len(port.step_batch(batch)[1]) == NV * 2
    m = port.step(batch, draws=_jax_draws(key, NV * 2))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, atol=1e-12, err_msg=k)
    moved = 0
    for name, p in port.field.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), rtol=1e-5, atol=1e-10,
                                   err_msg=name)
        moved += int((jparams[name] != deform_params_from_flax(params0)[name]).sum())
    assert moved > 0


def test_system_gradients_match_jax(recon):
    """All frames unlocked (full batch, the static frame at t = -1 included)
    from weights whose ``out`` layers are nonzero, so every group has a
    gradient. The JAX gradient is read off one SGD(1) step; each tensor
    at 1e-4 of its largest gradient (f32 sums in another order through the
    compositing, the K-planes gathers and the 3x3 SVDs of ARAP)."""
    jsystem, params0, jbatch, cfg, state, batch = recon
    key = jax.random.PRNGKey(9)
    params = _perturb(params0, 3)
    jsystem.tx = optax.sgd(1.0)
    jsystem._train_step = jax.jit(jsystem._train_step_impl, static_argnames=("do_guidance",))
    jsystem.params = jax.tree_util.tree_map(jnp.asarray, params)
    jsystem.opt_state = jsystem.tx.init(jsystem.params)
    jsystem.global_step = 200
    jm = {k: float(v) for k, v in jsystem.step(jbatch, key).items()}
    jafter = deform_params_from_flax(jax.tree_util.tree_map(np.asarray, jsystem.params))
    before = deform_params_from_flax(params)

    port = _port_system(cfg, state, params, 200)
    cams, ts, rgb, mask, fw = port.step_batch(batch)
    assert len(ts) == NV * NF and (ts == -1).sum() == NV
    loss, m = port.loss(cams, torch.as_tensor(ts), rgb, mask, torch.as_tensor(fw),
                        port.lambdas(200), _jax_draws(key, NV * NF))
    loss.backward()
    for k in METRICS:
        np.testing.assert_allclose(float(m[k].detach()), jm[k], rtol=1e-5, err_msg=k)
    assert jm["loss_arap"] > 0
    for name, p in port.field.named_parameters():
        jg = (before[name] - jafter[name]).numpy()
        scale = np.abs(jg).max()
        if name.startswith("delta_scaling"):  # scales are not deformed in recon
            assert scale == 0 and p.grad is None
            continue
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy() / scale, jg / scale, atol=1e-4, err_msg=name)


def test_deform_adam_matches_optax():
    """Three steps of the per-group optimizer (one group on an exp schedule)
    against optax's adam(c_schedule(lr, "exp"), eps=1e-15)."""
    rng = np.random.default_rng(2)
    p0 = {"grid_0_0": rng.normal(size=(3, 4)), "delta_xyz_network.out.weight": rng.normal(
        size=(3, 5))}
    p0 = {k: v.astype(np.float32) for k, v in p0.items()}
    lrs = {"grid": [1e-2, 1e-3, 2], "delta_xyz_network": 1e-4}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = DeformAdam(params, {k: schedule.c_schedule(v, "exp") for k, v in lrs.items()})
    groups = {"grid_0_0": "grid", "delta_xyz_network.out.weight": "delta_xyz_network"}
    tx = optax.multi_transform(
        {g: optax.adam(jschedule.c_schedule(v, "exp"), eps=1e-15) for g, v in lrs.items()},
        groups)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec", [0.5, [1.0, 3.0, 10], [2, 1e-2, 1e-4, 8],
                                  [0, 0.1, 0.5, 5, 1.0, 9]])
def test_schedules_match_jax(spec):
    for step in (0, 3, 6, 12):
        assert schedule.C(spec, 0, step) == pytest.approx(jschedule.C(spec, 0, step))
        assert config.C_max(spec) == jconfig.C_max(spec)
        if not isinstance(spec, list) or len(spec) <= 4:
            for interp in ("linear", "exp"):
                assert schedule.c_schedule(spec, interp)(step) == pytest.approx(
                    float(jschedule.c_schedule(spec, interp)(step)), rel=1e-6)


def test_recon_config_loads_as_jax(tmp_path):
    """The recon yaml with the CLI's dotted overrides: the same tree, the
    trial name interpolated from the prompt."""
    args = ["system.prompt_processor.prompt=a red butterfly", f"exp_root_dir={tmp_path}",
            "trainer.max_steps=3"]
    path = "configs/animate3d/motion_recon_frame_16.yaml"
    mine = config.load_config(path, cli_args=args, makedirs=False)
    ref = jconfig.load_config(path, cli_args=args, makedirs=False)
    assert mine.trial_dir == ref.trial_dir and mine.trial_dir.endswith("a_red_butterfly")
    for k in ("data", "system", "trainer", "checkpoint", "seed", "data_type", "system_type"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.system["guidance"]["n_view"] == 4


TEST_OBJ = """
v 0 0 0
v 0.5 0 0
v 0.5 0.5 0
v 0 0.5 0
v 0.25 0.25 0.4
f 1 2 3
f 1 3 4
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
"""
E2E_VIEW, E2E_FRAME = 4, 2


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """An asset (the JAX package's mesh2gaussian output, with mesh-edge
    ARAP connectivity), fake tracked RGBA frames and a tiny config, as
    tests/test_cli_e2e.py builds them, at 96² so the route is kernel H."""
    from PIL import Image

    from animate3d_tpu.tools import mesh2gaussian

    root = tmp_path_factory.mktemp("recon_e2e")
    (root / "asset.obj").write_text(TEST_OBJ)
    mesh2gaussian.run(str(root / "asset.obj"), str(root), "asset")
    (root / "frames").mkdir()
    rng = np.random.default_rng(0)
    for i in range(E2E_VIEW * E2E_FRAME):
        rgba = rng.uniform(0, 255, size=(RES, RES, 4)).astype(np.uint8)
        rgba[..., 3] = 255
        Image.fromarray(rgba, "RGBA").save(root / "frames" / f"{i}.png")
    cfg = f"""
name: "e2e"
tag: "t"
use_timestamp: false
exp_root_dir: "{root}/outputs"
seed: 0
data:
  image_root: "{root}/frames"
  height: {RES}
  width: {RES}
  n_view: {E2E_VIEW}
  total_frame: {E2E_FRAME}
system:
  load_guidance: false
  n_view: {E2E_VIEW}
  n_frame: {E2E_FRAME}
  progressive_iter_per_frame: 1
  test_option: "four_view"
  save_gaussian_trajectory: true
  connected_vertices_info_path: "{root}/asset.json"
  geometry:
    grid_size: [[8, 8, 8, 3]]
    n_grid_dims: 4
    use_global_trans: true
    geometry_convert_from: "{root}/asset.ply"
    load_ply_cfg:
      rot_x_degree: 90.0
  renderer:
    back_ground_color: [0.5, 0.5, 0.5]
  loss:
    lambda_rgb: 100.0
    lambda_mask: 10.0
    lambda_arap: 1.0
    arap_K: 2
    arap_sample_num: 16
trainer:
  max_steps: 3
  log_every_n_steps: 1
  val_check_interval: 2
checkpoint:
  every_n_train_steps: 3
"""
    (root / "config.yaml").write_text(cfg)
    return root


def test_launch_train_and_test_on_cpu(workspace):
    from animate3d_tpu_torch.cli.launch import main

    res = main(["--config", str(workspace / "config.yaml"), "--train", "--device", "cpu"])
    trial = workspace / "outputs" / "e2e" / "t"
    assert (trial / "ckpts" / "step_3" / "checkpoint.pt").exists()
    metrics = [json.loads(line) for line in open(trial / "metrics.jsonl")]
    assert [m["step"] for m in metrics] == [0, 1, 2]
    for m in metrics:
        assert set(METRICS + ("sec_per_step",)) <= set(m) and np.isfinite(m["loss"])
    assert len(os.listdir(trial / "save" / "images")) == E2E_VIEW * E2E_FRAME
    assert (trial / "save" / "val" / "it2.gif").exists()  # val_check_interval
    traj = sorted(os.listdir(trial / "save" / "gaussian_trajectory"))
    assert len(traj) == E2E_FRAME
    assert res["rgb"].shape == (E2E_VIEW, E2E_FRAME, RES, RES, 3)
    assert res["system"].mesh_nn_idx is not None  # mesh-edge ARAP
    # --test alone restores the checkpoint and renders the same images
    again = main(["--config", str(workspace / "config.yaml"), "--test", "--device", "cpu"])
    np.testing.assert_allclose(again["rgb"], res["rgb"], atol=1e-6)


REFUSED = {("--train", "trainer.mesh_dp=2"): NotImplementedError,
           ("--train", "system.load_guidance=true"): ValueError,
           ("--train", "system.weights=ckpts/step_9"): FileNotFoundError,
           ("--train", "system.weights=ckpts"): FileNotFoundError}


@pytest.mark.parametrize("extra", [list(k) for k in REFUSED])
def test_launch_refuses_what_is_not_ported(workspace, extra):
    """dp meshes are not ported; refine's guidance without the random-camera
    SDS batch (``data.use_random_camera``) and stage chaining from a
    checkpoint that does not exist are refused before any work (refine and
    chaining themselves: tests/test_torch_refine.py)."""
    from animate3d_tpu_torch.cli.launch import main

    with pytest.raises(REFUSED[tuple(extra)]):
        main(["--config", str(workspace / "config.yaml"), "--device", "cpu", *extra])


def test_saver_writes_the_test_artifacts(tmp_path):
    from animate3d_tpu_torch.utils.saving import Saver

    saver = Saver(str(tmp_path / "save"))
    rgb = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    png = saver.rgba("images/0.png", rgb, np.full((5, 7), 0.5, np.float32))
    from PIL import Image

    with Image.open(png) as im:
        assert im.mode == "RGBA" and im.size == (7, 5)
    np.testing.assert_array_equal(np.load(saver.trajectory("t/m.npy", rgb)), rgb)
    assert json.load(open(saver.json("m.json", {"psnr": 1.5}))) == {"psnr": 1.5}


def test_launch_needs_cuda_unless_told_cpu(workspace):
    from animate3d_tpu_torch.cli.launch import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the CLI runs there without --device cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", str(workspace / "config.yaml"), "--train"])


def test_system_needs_cuda_unless_told_cpu(tmp_path):
    """The system, like the CLI, runs on ``cuda`` unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the system runs there without device='cpu'")
    cfg = config.load_config("configs/animate3d/motion_recon_frame_16.yaml", cli_args=[
        "system.prompt_processor.prompt=a red butterfly", f"exp_root_dir={tmp_path}"],
        makedirs=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Animate3DSystem.from_config(cfg)


def test_recon_path_imports_no_jax_and_no_trainer():
    """The recon CLI's import closure holds nothing of JAX, flax or the JAX
    package, and not the MV-VDM trainer (core/checkpoint imports none)."""
    code = ("import sys, animate3d_tpu_torch.cli.launch as l, animate3d_tpu_torch.systems."
            "animate3d, animate3d_tpu_torch.data.multi_image, animate3d_tpu_torch.core."
            "checkpoint; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'animate3d_tpu') or m == 'animate3d_tpu_torch.pipelines."
            "train_mvvdm']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stdout + out.stderr
