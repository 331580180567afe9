"""Experiment runner for the 4D stage: the port of ``animate3d_tpu/cli/launch.py``
for stage-1 motion reconstruction, stage-2 4D-SDS refine and their evaluation.

    python -m animate3d_tpu_torch.cli.launch --config configs/animate3d/motion_recon_frame_16.yaml \\
        --train system.prompt_processor.prompt="a butterfly" data.image_root=<frames> \\
        system.geometry.geometry_convert_from=<asset.ply> [--device cpu]
    python -m animate3d_tpu_torch.cli.launch --config configs/animate3d/refine_frame_16.yaml \\
        --train system.prompt_processor.prompt="a butterfly" data.image_root=<frames> \\
        system.geometry.geometry_convert_from=<asset.ply> system.weights=<recon trial>/ckpts \\
        [system.guidance.flax_params_dir=<artifact root>]

``--train`` first restores ``system.weights`` (stage chaining: a ``ckpts``
directory, whose newest ``step_N`` is taken, or a ``step_N``; the field's
parameters only, not the optimizer state), then optimises the deformation
field on the whole-video batch (uploaded once), with the SDS batch of the
random-camera sampler every step in refine (``system.load_guidance``),
logs ``metrics.jsonl``, writes ``ckpts/step_N`` and, every
``trainer.guidance_eval_interval`` steps, the guidance's teacher preview as
``save/guidance_eval/it{N}.gif``, then runs the ``--test`` pass.
``--test`` restores ``resume`` (or the trial's latest checkpoint) and
renders ``system.test_option``'s cameras: ``four_view``, the four training
views at ``data.eval_height/width`` (default ``data.height/width``), with a
PSNR / SSIM (/ LPIPS, given weights) report ``save/metrics_test.json``
against the frames of ``data.image_root``; or
``testset``, the 3-elevation x 4-azimuth grid at the eval size of
``data.<key>`` or ``data.random_camera.<key>`` (default 512²). Each view
becomes RGBA pngs and a video (``save/videos/view_{v}.mp4``, a GIF where no
mp4 writer exists); ``system.save_gaussian_trajectory`` adds per-frame
``.npy`` trajectories. ``--export`` is ``--test`` with the trajectories on.
``--validate`` renders the 360° orbit (``data.n_val_views`` frames, default
120, at ``data.eval_height/width``, default 512²) as a video and
``save/val/orbit.gif``.

``trainer.mesh_dp=N`` trains data parallel over N processes started by
``torchrun`` (NCCL on CUDA, gloo with ``--device cpu``): each rank renders
its slice of the step's view·frame items and of the SDS batch, the field's
gradients are summed over the ranks (``systems/animate3d.py``); rank 0
writes the logs, checkpoints, previews and the ``--test`` pass.
``--typecheck`` installs the boundary shape contracts
(``core/typecheck.py``); ``--gradio`` keeps a one-line progress file,
``<trial_dir>/progress``. Each run writes ``parsed.yaml``, ``cmd.txt`` and
``code_snapshot.zip`` (the port's sources) into the trial directory.

Runs on ``cuda`` unless ``--device cpu``; raises when CUDA is absent. The
4D stage is float32 (on CUDA, ``resolve_device`` turns TF32 off for
matmuls and convolutions: the K-planes and MLP products are f32 in the
reference); refine's frozen guidance UNet runs in bf16, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import zipfile

import numpy as np
import torch


PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT_EXT = (".py", ".cu", ".cuh", ".yaml")


def snapshot_provenance(trial_dir: str, argv) -> None:
    """The command line (``cmd.txt``) and a zip of the port's sources
    (``code_snapshot.zip``: its ``.py``, ``.cu``, ``.cuh`` and ``.yaml``
    files, by their path in the repository)."""
    with open(os.path.join(trial_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(["python", "-m", "animate3d_tpu_torch.cli.launch", *argv]) + "\n")
    with zipfile.ZipFile(os.path.join(trial_dir, "code_snapshot.zip"), "w",
                         zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(PORT_ROOT):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
            for name in sorted(files):
                if name.endswith(SNAPSHOT_EXT):
                    path = os.path.join(root, name)
                    z.write(path, os.path.relpath(path, os.path.dirname(PORT_ROOT)))


def build_system(cfg, seed: int = 0, device=None):
    """``system_type`` through the registry."""
    import animate3d_tpu_torch.systems.animate3d  # noqa: F401 — registers the system
    from animate3d_tpu_torch.core.registry import find

    cls = find(cfg.system_type or "gaussian-splatting-animate3d-system")
    return cls.from_config(cfg, seed=seed, device=device)


def load_system_weights(cfg, system) -> None:
    """Stage chaining: ``system.weights`` restores the deformation field from
    an earlier stage's checkpoint (refine loads the recon trial's)."""
    from animate3d_tpu_torch.core.checkpoint import find_latest_checkpoint, restore_checkpoint

    weights = cfg.system.get("weights")
    if not weights:
        return
    path = weights
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        path = find_latest_checkpoint(path)
    if path is None or not os.path.exists(os.path.join(path, "checkpoint.pt")):
        raise FileNotFoundError(f"system.weights={weights!r}: no checkpoint found — run the "
                                "stage-1 reconstruction first")
    system.field.load_state_dict(restore_checkpoint(path)["params"])
    print(f"[weights] restored system weights from {path}")


def _guidance_batch(system, raw_rc: dict) -> dict:
    """The step's SDS batch on the system's device, with the guidance's
    text and fallback image conditioning."""
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch

    dev = system.device
    gi = system.guidance_inputs
    return {"cameras": gs_cameras_from_batch(raw_rc, device=dev),
            "timestamps": torch.as_tensor(raw_rc["timestamps"], device=dev),
            "c2w": torch.as_tensor(raw_rc["c2w"], device=dev),
            "text_cond": gi["text_cond"], "text_uncond": gi["text_uncond"],
            "image_embeds": gi["image_embeds"]}


def _validation_render(cfg, system, step: int) -> None:
    """The fixed views at the training size as a multi-view GIF."""
    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.utils.saving import export_to_gif_mv

    n_frame = system.cfg.n_frame
    cams = fixed_view_cameras(height=cfg.data.get("height", 256),
                              width=cfg.data.get("width", 256), total_frame=n_frame)
    out = system.render(gs_cameras_from_batch(cams, device=system.device), cams["timestamps"])
    rgb = out.rgb.cpu().numpy()
    export_to_gif_mv(rgb.reshape(-1, n_frame, *rgb.shape[1:]),
                     os.path.join(cfg.trial_dir, "save", "val", f"it{step}.gif"))


def run_train(cfg, system, mesh=None, progress=None, profile_dir=None) -> dict:
    """Optimise the field; on a dp ``mesh`` (dp > 1) every rank steps and
    rank 0 writes. With ``profile_dir``, steps ``PROFILE_STEPS`` are traced
    there (``utils/logging.py::profile_trace``)."""
    from animate3d_tpu_torch.core.checkpoint import save_checkpoint
    from animate3d_tpu_torch.core.registry import find
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    import animate3d_tpu_torch.data.multi_image  # noqa: F401 — registers the datamodule
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.utils.logging import MetricsLogger, StepProfile

    main_rank = mesh is None or mesh.is_main
    if mesh is not None:
        pmesh.replicate(mesh, list(system.field.parameters()))
        system.mesh = mesh
        if main_rank:
            print(f"[mesh] dp={mesh.dp} over {mesh.dp} processes")
    dataset = find(cfg.data_type or "simple-multi-image-datamodule").from_config(
        cfg.data, seed=cfg.seed)
    dev = system.device
    raw = dataset.batch(0)
    batch = {  # the whole video, uploaded once
        "gs_cameras": gs_cameras_from_batch(raw, device=dev),
        "timestamps": np.asarray(raw["timestamps"]),
        "rgb": torch.as_tensor(raw["rgb"], device=dev),
        "mask": torch.as_tensor(raw["mask"].astype(np.float32), device=dev),
    }
    max_steps = cfg.trainer.get("max_steps", 800)
    ckpt_every = cfg.checkpoint.get("every_n_train_steps", max_steps)
    val_every = cfg.trainer.get("val_check_interval", 0)
    log_every = cfg.trainer.get("log_every_n_steps", 50)
    geval_every = int(cfg.trainer.get("guidance_eval_interval", 0) or 0)
    ckpt_dir = os.path.join(cfg.trial_dir, "ckpts")
    logger = MetricsLogger(os.path.join(cfg.trial_dir, "metrics.jsonl")) if main_rank else None
    pending, logged = [], []
    t0 = time.perf_counter()

    def flush() -> None:
        nonlocal t0
        if not pending:
            return
        values = [(s, {k: float(v) for k, v in m.items()}) for s, m in pending]  # syncs
        window = (time.perf_counter() - t0) / len(pending)
        for s, m in values:
            if logger is not None:
                logger.log(s, {**m, "sec_per_step": window})
            logged.append({"step": s, **m, "sec_per_step": window})
        if main_rank:
            msg = " ".join(f"{k}={v:.5f}" for k, v in values[-1][1].items())
            print(f"[{values[-1][0]}/{max_steps}] {msg} ({window:.3f}s/it avg)")
        pending.clear()
        t0 = time.perf_counter()

    with StepProfile(profile_dir) as profile:
        for step in range(max_steps):
            profile.before(step)
            if progress is not None and step % log_every == 0:
                progress.train_step(step, max_steps)
            guidance_batch = None
            if system.do_guidance and dataset.random_sampler is not None:
                guidance_batch = _guidance_batch(system, dataset.batch(step)["random_camera"])
            pending.append((step, system.step(batch, guidance_batch=guidance_batch)))
            profile.after(step)
            if step % log_every == 0 or step + 1 == max_steps:
                flush()
            if geval_every and guidance_batch is not None and (step + 1) % geval_every == 0:
                from animate3d_tpu_torch.utils.saving import Saver

                # every rank previews, so that the generators stay in step
                imgs = system.guidance_preview(
                    guidance_batch, num_steps=int(cfg.trainer.get("guidance_eval_steps", 25)))
                if main_rank:
                    Saver(os.path.join(cfg.trial_dir, "save")).gif_mv(
                        f"guidance_eval/it{step + 1}.gif", imgs.cpu().numpy())
                    print(f"[guidance_eval] wrote teacher preview at step {step + 1}")
            if not main_rank:
                continue
            if val_every and (step + 1) % val_every == 0 and step + 1 < max_steps:
                _validation_render(cfg, system, step + 1)
            if (step + 1) % ckpt_every == 0 or step + 1 == max_steps:
                save_checkpoint(ckpt_dir, step + 1, {"params": system.field.state_dict(),
                                                     "opt_state": system.opt.state_dict(),
                                                     "step": step + 1})
    flush()
    if progress is not None:
        progress.train_step(max_steps, max_steps)
    if main_rank:
        print(f"[train] done; checkpoints in {ckpt_dir}")
    return {"metrics": logged}


def _restore_for_eval(cfg, system, tag: str) -> None:
    from animate3d_tpu_torch.core.checkpoint import find_latest_checkpoint, restore_checkpoint

    latest = cfg.resume or find_latest_checkpoint(os.path.join(cfg.trial_dir, "ckpts"))
    if latest:
        system.field.load_state_dict(restore_checkpoint(latest)["params"])
        print(f"[{tag}] restored {latest}")


def _eval_renderer_cfg(system, height: int, width: int):
    """The evaluation size: the rasterizer sizes from the renderer config, not
    from the cameras. (The port's binning is exact, so the JAX package's
    ``exact_test_binning`` switch has nothing to turn off.)"""
    return dataclasses.replace(system.cfg.renderer, height=int(height), width=int(width))


def _quality_report(cfg, system, rgb: np.ndarray, saver) -> dict:
    """PSNR / SSIM per view (and LPIPS, given weights) of the four-view
    renders (V, F, H, W, 3) against the frames of ``data.image_root`` over
    the background, written to ``metrics_test.json``."""
    from animate3d_tpu_torch.data.multi_image import load_rgba_frames
    from animate3d_tpu_torch.utils import metrics as qm

    n_views, n_frame, h, w = rgb.shape[:4]
    gt_rgb, gt_mask = load_rgba_frames(cfg.data["image_root"], h, w)
    bgc = np.asarray(system.cfg.renderer.back_ground_color, np.float32)
    gt = (gt_rgb * gt_mask + bgc * (1.0 - gt_mask)).reshape(n_views, n_frame, h, w, 3)
    dev = system.device
    on_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    per_view = []
    with torch.no_grad():
        for v in range(n_views):
            pred, ref = on_dev(rgb[v]), on_dev(gt[v])
            per_view.append({"view": v, "psnr": round(float(qm.psnr(pred, ref)), 3),
                             "ssim": round(float(qm.ssim(pred, ref).mean()), 4)})
        report = {"per_view": per_view,
                  "psnr": round(float(np.mean([r["psnr"] for r in per_view])), 3),
                  "ssim": round(float(np.mean([r["ssim"] for r in per_view])), 4)}
        lp = qm.load_lpips(device=dev)
        if lp is not None:
            d = lp(on_dev(rgb.reshape(-1, h, w, 3)), on_dev(gt.reshape(-1, h, w, 3)))
            report["lpips"] = round(float(d.mean()), 4)
    saver.json("metrics_test.json", report)
    print(f"[test] PSNR {report['psnr']:.2f} dB  SSIM {report['ssim']:.4f}"
          + (f"  LPIPS {report['lpips']:.4f}" if "lpips" in report else ""))
    return report


def run_test(cfg, system, progress=None) -> dict:
    from animate3d_tpu_torch.data.cameras import (
        fixed_view_cameras,
        gs_cameras_from_batch,
        testset_grid_cameras,
    )
    from animate3d_tpu_torch.utils.saving import Saver

    _restore_for_eval(cfg, system, "test")
    if progress is not None:
        progress.write("Rendering video ...")
    test_option = cfg.system.get("test_option", "testset")
    n_frame = system.cfg.n_frame
    rc = cfg.data.get("random_camera", {}) or {}

    def eval_opt(key, default):  # a top-level data.<key> wins over data.random_camera.<key>
        return cfg.data.get(key, rc.get(key, default))

    if test_option == "four_view":
        eval_h = cfg.data.get("eval_height", cfg.data.get("height", 256))
        eval_w = cfg.data.get("eval_width", cfg.data.get("width", 256))
        cams = fixed_view_cameras(height=eval_h, width=eval_w, total_frame=n_frame)
    else:
        grid = {}
        if eval_opt("eval_elevation_deg", None) is not None:
            grid["elevations_deg"] = tuple(eval_opt("eval_elevation_deg", ()))
        if eval_opt("eval_azimuth_deg", None) is not None:
            grid["azimuth_sets_deg"] = tuple(tuple(a) for a in eval_opt("eval_azimuth_deg", ()))
        eval_h, eval_w = eval_opt("eval_height", 512), eval_opt("eval_width", 512)
        cams = testset_grid_cameras(height=eval_h, width=eval_w, total_frame=n_frame, **grid)
    out = system.render(gs_cameras_from_batch(cams, device=system.device), cams["timestamps"],
                        renderer_cfg=_eval_renderer_cfg(system, eval_h, eval_w))
    saver = Saver(os.path.join(cfg.trial_dir, "save"))
    rgb = out.rgb.cpu().numpy()
    n_views = rgb.shape[0] // n_frame
    rgb = rgb.reshape(n_views, n_frame, *rgb.shape[1:])
    alpha = out.alpha.cpu().numpy().reshape(n_views, n_frame, eval_h, eval_w)
    videos = []
    for v in range(n_views):
        for f in range(n_frame):
            saver.rgba(f"images/{v * n_frame + f}.png", rgb[v, f], alpha[v, f])
        videos.append(saver.mp4(f"videos/view_{v}.mp4", rgb[v]))
    if cfg.system.get("save_gaussian_trajectory", False):
        means = out.means3d.cpu().numpy().reshape(n_views, n_frame, -1, 3)[0]
        for f in range(n_frame):
            saver.trajectory(f"gaussian_trajectory/means3D_frame_{f}.npy", means[f])
    report = None
    image_root = cfg.data.get("image_root")
    if test_option == "four_view" and image_root and os.path.isdir(image_root):
        report = _quality_report(cfg, system, rgb, saver)
    print(f"[test] wrote {n_views * n_frame} RGBA images of {eval_h}x{eval_w} and "
          f"{len(videos)} videos to {saver.save_dir}")
    return {"rgb": rgb, "alpha": alpha, "overflow": int(out.overflow), "videos": videos,
            "report": report}


def run_validate(cfg, system) -> dict:
    """The validation orbit: the camera sweeps 360° while the animation
    plays, as a video and ``val/orbit.gif``."""
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch, val_orbit_cameras
    from animate3d_tpu_torch.utils.saving import Saver

    _restore_for_eval(cfg, system, "validate")
    eval_h, eval_w = cfg.data.get("eval_height", 512), cfg.data.get("eval_width", 512)
    cams = val_orbit_cameras(n_views=int(cfg.data.get("n_val_views", 120)), height=eval_h,
                             width=eval_w, total_frame=system.cfg.n_frame)
    out = system.render(gs_cameras_from_batch(cams, device=system.device), cams["timestamps"],
                        renderer_cfg=_eval_renderer_cfg(system, eval_h, eval_w))
    saver = Saver(os.path.join(cfg.trial_dir, "save"))
    rgb = out.rgb.cpu().numpy()
    video = saver.mp4("videos/val_orbit.mp4", rgb)
    gif = saver.gif_mv("val/orbit.gif", rgb[None])
    print(f"[validate] wrote the {rgb.shape[0]}-frame orbit to {saver.save_dir}")
    return {"rgb": rgb, "video": video, "gif": gif}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="animate3d_tpu_torch 4D-stage runner")
    parser.add_argument("--config", required=True)
    group = parser.add_mutually_exclusive_group(required=True)
    for flag in ("--train", "--test", "--validate", "--export"):
        group.add_argument(flag, action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; CUDA asked for and absent raises")
    parser.add_argument("--typecheck", action="store_true",
                        help="check tensor shapes and dtypes at the 4D stage's boundaries")
    parser.add_argument("--gradio", action="store_true",
                        help="UI mode: one-line progress in <trial_dir>/progress")
    parser.add_argument("--profile_dir", default=None,
                        help="--train: trace steps 10-19 with torch.profiler, a chrome "
                             "trace and summary.json here")
    parser.add_argument("extras", nargs="*", help="dotted config overrides")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    from animate3d_tpu_torch.core.config import dump_config, load_config
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.utils.logging import ProgressWriter

    if args.typecheck:
        from animate3d_tpu_torch.core.typecheck import enable_typecheck

        enable_typecheck()
    device = resolve_device(args.device)
    cfg = load_config(args.config, cli_args=args.extras)
    mesh_dp = int(cfg.trainer.get("mesh_dp", 0) or 0) if args.train else 0
    joined, mesh = False, None
    if mesh_dp > 1:
        device, joined = pmesh.init_distributed(device)
        mesh = pmesh.make_mesh(dp=mesh_dp)
    main_rank = mesh is None or mesh.is_main
    try:
        if main_rank:
            os.makedirs(cfg.trial_dir, exist_ok=True)
            dump_config(os.path.join(cfg.trial_dir, "parsed.yaml"),
                        {"data": cfg.data, "system": cfg.system, "trainer": cfg.trainer})
            snapshot_provenance(cfg.trial_dir, argv)
        progress = (ProgressWriter(os.path.join(cfg.trial_dir, "progress"))
                    if args.gradio and main_rank else None)
        system = build_system(cfg, seed=cfg.seed, device=device)
        res = {"system": system, "trial_dir": cfg.trial_dir}
        if args.validate:
            res.update(run_validate(cfg, system))
            return res
        if args.train:
            load_system_weights(cfg, system)
            res.update(run_train(cfg, system, mesh, progress, args.profile_dir))
        if args.export:
            cfg.system["save_gaussian_trajectory"] = True
        if main_rank:
            system.mesh = None
            res.update(run_test(cfg, system, progress))
        if progress is not None:
            progress.close()
        return res
    finally:
        pmesh.leave(joined)


if __name__ == "__main__":
    main()
