"""The port's data and sequence parallelism (``animate3d_tpu_torch/parallel``)
on the CPU: gloo process groups of 2 and 4 ranks (``tests/torch_dist_worker.py``,
a ``file://`` rendezvous under the test's tmp dir), each held against the
one-process run on the same global batch, and the ring against the JAX
package's ``ring_attention_sharded`` and its dense attention (the cases of
tests/test_parallel.py)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_refine_workspace as refine_workspace
from torch_cpu_host import warm_vml
from torch_dist_worker import Group, spawn

warm_vml()

RES, NV, NF = 32, 4, 2


def _trainer_config(root: Path, out: str, batch: int) -> str:
    cfg = root / f"{out}.yaml"
    cfg.write_text(f"""
output_dir: "{root}/{out}"
model_size: tiny
num_views: 4
video_length: 2
sample_size: 16
train_batch_size: {batch}
train_data:
  manifest_path: "{root}/manifest.json"
  video_root: "{root}/vids"
  total_frames: 4
max_train_steps: 2
checkpointing_steps: 1
learning_rate: 1.0e-4
global_seed: 0
""")
    return str(cfg)


def _recon_config(root: Path) -> str:
    cfg = root / "recon.yaml"
    cfg.write_text(f"""
name: "dp"
tag: "t"
use_timestamp: false
exp_root_dir: "{root}/outputs"
seed: 0
data:
  image_root: "{root}/frames"
  height: {RES}
  width: {RES}
  n_view: {NV}
  total_frame: {NF}
system:
  load_guidance: false
  n_view: {NV}
  n_frame: {NF}
  progressive_iter_per_frame: 1
  test_option: "four_view"
  geometry:
    grid_size: [[8, 8, 8, 3]]
    n_grid_dims: 4
    grid_lr: 0.2
    delta_xyz_network_lr: 0.01
    geometry_convert_from: "{root}/asset.ply"
  loss:
    lambda_rgb: 100.0
    lambda_mask: 10.0
    lambda_arap: 1.0
    arap_radius: 0.5
    arap_K: 3
    arap_sample_num: 16
    lambda_position: 0.1
    lambda_sparsity: 0.1
    lambda_scales: 0.1
    lambda_tv_loss: 0.1
trainer:
  max_steps: 3
  log_every_n_steps: 1
""")
    return str(cfg)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """2-rank groups run the trainer at dp 2 (one video a rank), the same
    with ZeRO-1, and the recon and refine CLIs at ``trainer.mesh_dp=2`` with
    the ring at sp 2 and a tiny UNet under ``sp_ring``; a 4-rank group the
    ring at sp 4. The one-process runs of the trainer (the global batch of
    2), of recon and of refine run here."""
    from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
    from animate3d_tpu_torch.gaussians.state import random_state

    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    (root / "vids").mkdir()
    items = []
    for item in range(2):
        views = []
        for v in range(4):
            d = root / "vids" / f"item{item}_view{v}"
            d.mkdir()
            for f in range(4):
                Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                    d / f"{f}.png")
            views.append(d.name)
        items.append({"videos": views, "caption": f"item {item}"})
    (root / "manifest.json").write_text(json.dumps(items))
    (root / "frames").mkdir()
    for i in range(NV * NF):
        rgba = rng.uniform(0, 255, size=(RES, RES, 4)).astype(np.uint8)
        rgba[..., 3] = 255
        Image.fromarray(rgba, "RGBA").save(root / "frames" / f"{i}.png")
    write_gaussian_ply(str(root / "asset.ply"),
                       random_state(40, radius=0.4, generator=torch.Generator().manual_seed(0)))
    qkv = {n: rng.normal(size=(2, 64, 64)).astype(np.float32) for n in "qkv"}
    np.savez(root / "qkv.npz", **qkv)
    recon_cfg = _recon_config(root)
    (root / "refine").mkdir()
    refine_ws = refine_workspace.build(root / "refine")
    refine_args = ["--config", refine_workspace.REFINE_YAML, "--train",
                   *refine_workspace.refine_args(
                       refine_ws, f"system.weights={refine_ws['recon_trial']}/ckpts",
                       f"system.guidance.flax_params_dir={refine_ws['weights']}",
                       "trainer.max_steps=2", "trainer.log_every_n_steps=1",
                       f"exp_root_dir={root}/refine_out")]

    # three groups, each joined within 60 s of its start; the one-process
    # runs go while the first group runs
    from animate3d_tpu_torch.cli import launch, train_mvvdm

    ring_task = {"kind": "ring", "inputs": str(root / "qkv.npz"), "heads": 4}
    trainers = Group(root / "dp2", 2, [
        {"kind": "trainer", "config": _trainer_config(root, "dp", 1)},
        {"kind": "trainer", "config": _trainer_config(root, "zero", 1),
         "extras": ["zero_sharded_optimizer=true"], "every_rank": True}])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many small ops, and the test workers share the cores
    try:
        one = train_mvvdm.main(["--config", _trainer_config(root, "one", 2), "--device", "cpu"])
        recon_one = launch.main(["--config", recon_cfg, "--train", "--device", "cpu",
                                 "name=one"])
        refine_one = launch.main([*refine_args, "name=one", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    trainer_dp, trainer_zero = trainers.results()
    recon_dp, refine_dp, ring2, unet = spawn(root / "mixed2", 2, [
        {"kind": "launch", "args": ["--config", recon_cfg, "--train", "trainer.mesh_dp=2"]},
        {"kind": "launch", "args": [*refine_args, "trainer.mesh_dp=2", "name=dp"]},
        ring_task, {"kind": "unet_sp_ring"}])
    (ring4,) = spawn(root / "sp4", 4, [ring_task])
    return {"root": root, "qkv": qkv, "trainer_dp": trainer_dp, "trainer_zero": trainer_zero,
            "recon_dp": recon_dp, "refine_dp": refine_dp, "ring2": ring2, "unet": unet,
            "ring4": ring4, "trainer_one": one, "recon_one": recon_one,
            "refine_one": refine_one}


def test_dp2_train_step_equals_the_one_process_step(dp2):
    """Two steps at dp 2 (one video a rank, the global batch's draws) against
    two steps of one process on the global batch of 2: loss and gradient
    norm, and the masters after the updates within 1e-6 relative (all of
    them as one vector). Adam's first steps divide each gradient element by
    its own size, so an element whose terms cancel to rounding (a zero-init
    bias) may move by up to the learning rate either way: each element is
    held to that bound."""
    one, dp = dp2["trainer_one"], dp2["trainer_dp"]
    for m1, m2 in zip(one["metrics"], dp["metrics"]):
        np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-6)
        np.testing.assert_allclose(m2["grad_norm"], m1["grad_norm"], rtol=1e-5)
    masters = {k: v.detach() for k, v in one["optimizer"].masters.items()}
    assert set(dp["masters"]) == set(masters)
    diff = torch.cat([(dp["masters"][k] - v).reshape(-1) for k, v in masters.items()])
    ref = torch.cat([v.reshape(-1) for v in masters.values()])
    assert float(diff.norm() / ref.norm()) < 1e-6
    assert float(diff.abs().max()) < 1e-4  # the learning rate
    # only rank 0 writes: one metrics line a step, and the checkpoints
    lines = open(dp2["root"] / "dp" / "metrics.jsonl").read().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
    assert (dp2["root"] / "dp" / "checkpoints" / "step_2" / "checkpoint.pt").exists()
    assert list((dp2["root"] / "dp" / "tb").glob("events.out.tfevents.*"))


def test_zero1_equals_replicated_state(dp2):
    """ZeRO-1 at dp 2: the moments of the masters whose leading axis divides
    by 2 are sharded (each rank holds half), and after two steps the masters
    and the (gathered) optimizer state equal the replicated run's, bit for
    bit, on every rank."""
    rep, zero = dp2["trainer_dp"], dp2["trainer_zero"]
    assert not rep["sharded"] and all(z["sharded"] for z in zero)
    for z in zero:
        for k, v in rep["masters"].items():
            assert torch.equal(z["masters"][k], v), k
        st_rep, st_zero = rep["optimizer"]["adamw"]["state"], z["optimizer"]["adamw"]["state"]
        assert z["optimizer"]["count"] == rep["optimizer"]["count"] == 2
        for i, s in st_rep.items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st_zero[i][key], s[key]), (i, key)


def test_dp2_recon_step_equals_the_one_process_step(dp2):
    """``trainer.mesh_dp=2``: each rank renders half of the 8 view·frame
    items, the means over items are normalised by the global batch, ARAP
    counts once; three steps against one process's."""
    one, dp = dp2["recon_one"], dp2["recon_dp"]
    assert dp["rendered"] == [NV * NF // 2] * 3  # each step: this rank's half
    assert dp["metrics"][-1]["loss_arap"] > 1e-6
    for m1, m2 in zip(one["metrics"], dp["metrics"]):
        for k in ("loss", "loss_rgb", "loss_mask", "psnr", "loss_arap", "raster_overflow"):
            np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, atol=1e-7, err_msg=k)
    field = one["system"].field.state_dict()
    for k, v in field.items():
        np.testing.assert_allclose(dp["field"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_refine_step_at_mesh_dp_2_equals_one_process(dp2):
    """Refine at ``trainer.mesh_dp=2``: each rank renders half of the
    step's 8 recon items and half of the 8 SDS renders, and VAE-encodes its
    half (the latents are gathered for the guidance's UNet); two steps
    against one process's: losses (loss_sds included) and the field."""
    nv, nf = refine_workspace.NV, refine_workspace.NF
    one, dp = dp2["refine_one"], dp2["refine_dp"]
    # per step: this rank's half of the recon items, then of the SDS renders
    assert dp["rendered"] == [nv * nf // 2, nv * nf // 2] * 2
    assert dp["encoded"] == [nv * nf // 2] * 2
    for m1, m2 in zip(one["metrics"], dp["metrics"]):
        for k in ("loss", "loss_sds", "loss_rgb", "loss_mask", "psnr"):
            np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in one["system"].field.state_dict().items():
        np.testing.assert_allclose(dp["field"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring_and_dense(dp2, sp):
    """The ring at sp 2 and 4 against the JAX package's ring over a (1, sp)
    mesh of its CPU devices and its dense attention (atol 2e-5)."""
    from animate3d_tpu.ops.attention import multi_head_attention
    from animate3d_tpu.parallel.mesh import make_mesh
    from animate3d_tpu.parallel.sp_attention import ring_attention_sharded

    q, k, v = (jnp.asarray(dp2["qkv"][n]) for n in "qkv")
    mesh = make_mesh(dp=1, sp=sp, devices=jax.devices()[:sp])
    jax_ring = np.asarray(ring_attention_sharded(mesh, q, k, v, 4))
    dense = np.asarray(multi_head_attention(q, k, v, 4, backend="xla"))
    port = dp2["ring2" if sp == 2 else "ring4"]["out"].numpy()
    np.testing.assert_allclose(port, jax_ring, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(port, dense, atol=2e-5, rtol=1e-5)


def test_sp_ring_min_seq_gate(dp2):
    """Under ``sp_ring`` at the default ``SP_MIN_SEQ`` a 16-token sequence
    stays local and one of SP_MIN_SEQ tokens rides the ring; both equal the
    local attention."""
    u = dp2["unet"]
    assert u["short_calls"] == 0 and u["long_calls"] == 1
    for out, ref in (u["short"], u["long"]):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)


def test_unet_forward_under_sp_ring_matches_local(dp2):
    """A tiny UNet under ``sp_ring`` (min_seq 16): its cross-view
    self-attention rides the ring, the temporal and text sites stay local,
    and the output equals the local forward."""
    u = dp2["unet"]
    # the cross-view sequences (4 views x h x w) ride the ring; 2-frame
    # temporal and 7-token text sites stay local
    assert u["unet_calls"] and all(s[1] >= 4 * 16 for s in u["unet_calls"])
    np.testing.assert_allclose(u["ringed"].numpy(), u["local"].numpy(), atol=3e-5, rtol=1e-4)


def test_mesh_helpers_at_world_one():
    """Without a process group the mesh is (1, 1) and every collective is a
    no-op; a dp the world cannot hold raises."""
    from animate3d_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh()
    assert (m.dp, m.sp, m.rank, m.is_main) == (1, 1, 0, True)
    x = torch.arange(6.0).reshape(6, 1)
    assert torch.equal(pmesh.shard_batch(m, {"x": x})["x"], x)
    pmesh.all_reduce_(m, [x])
    assert torch.equal(x, torch.arange(6.0).reshape(6, 1))
    assert pmesh.shard_leading_where_divisible(m, [x]) == [None]
    with pytest.raises(ValueError):
        pmesh.make_mesh(dp=2)
