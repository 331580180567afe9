"""MV-VDM trainer CLI of the PyTorch port, on one device or data parallel.

    python -m animate3d_tpu_torch.cli.train_mvvdm --config <yaml> [key.path=value ...]
    torchrun --nproc_per_node <n> -m animate3d_tpu_torch.cli.train_mvvdm --config <yaml>

Reads the keys of ``configs/training/train.yaml`` (and of the JAX CLI,
``animate3d_tpu/cli/train_mvvdm.py``): builds the MV motion UNet + VAE from
``global_seed``, loads ``flax_params_dir`` (an artifact root in the layout
of ``convert/weights.py::discover_artifacts``: UNet, VAE, the CLIP towers
and tokenizer where it holds them) through ``factory.init_and_load``, then
``pretrained_model_path``'s diffusers ``unet/`` and ``vae/`` model files
over it, and runs the loop: VAE posterior sample x 0.18215, the train step,
metrics at the log cadence, checkpoints and the motion-module export every
``checkpointing_steps`` and at the end, resume from the latest checkpoint,
and validation sampling every ``validation_steps``. The first batch is
dumped as ``sanity_check.gif``.

Conditioning as in the JAX trainer: each caption through the text tower
(cached per caption, repeated across its views), the CFG null context the
encoded ``""``, and frame 0 of each view through the IP-Adapter's vision
tower for the image embeds; without a tower (or a tokenizer) the
conditioning is zeros, with a warning (smoke mode). The UNet computes in
bf16 on CUDA with f32 trainable parameters; the frozen ones are stored in
bf16 (``cast_frozen_bf16: true``, the default) or kept in f32 (``false``).

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; NCCL on
CUDA, gloo with ``--device cpu``) the ranks are data parallel, as the JAX
trainer's dp mesh: the global batch is ``train_batch_size`` x world size
(also ``scale_lr``'s factor), each rank reads and encodes its slice, draws
the global batch's noise and keeps its rows, gradients and the logged loss
are averaged over the ranks; ``zero_sharded_optimizer: true`` shards the
AdamW moments (ZeRO-1; a no-op at one rank, as in JAX). Only rank 0 writes
the sanity GIF, metrics, checkpoints and validation GIFs (every rank
samples, so the generators stay in step); every rank resumes. ``use_wandb``
raises: wandb publishes to an outside service. Runs on CUDA;
``--device cpu`` exists for the tests.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def _check_supported(cfg: dict) -> None:
    """Raise on config keys whose feature the port does not have, rather
    than train without it."""
    if cfg.get("use_wandb"):
        raise NotImplementedError("use_wandb: not ported (wandb publishes to an outside "
                                  "service); metrics.jsonl and tb/ hold the metrics")


def load_pretrained_model_path(base: str, unet, vae) -> dict:
    """``base``'s diffusers ``unet/`` and ``vae/`` model files (the
    ``.safetensors``, else the ``.bin``) over the modules, by the released
    key names, as the JAX trainer loads them over its bundle. Returns
    {"unet" / "vae": (missing, unexpected) key lists} for the files found."""
    from animate3d_tpu_torch.convert import weights as W

    audit = {}
    for sub, module, key in (("unet", unet, W.unet_key), ("vae", vae, W.vae_key)):
        path = W.find_model_file(os.path.join(base, sub), W.MODEL_FILES[:2])
        if path:
            sd = {key(k): v for k, v in W.load_torch_state_dict(path).items()}
            audit[sub] = W._assign(module, sd)
            print(f"[load] {path}: missing={len(audit[sub][0])} "
                  f"unexpected={len(audit[sub][1])}")
    return audit


def main(argv=None) -> dict:
    """Run the CLI; returns {"unet", "optimizer", "metrics" (one dict per
    step run), "step_seconds" (wall per step, ended by a device
    synchronise on CUDA), "start_step", "loaded" (the families read from
    files), "conditioning" (the first batch's text_ctx, null_text_ctx and
    image_embeds), "dp" and "backend" (the process group's, None without
    one)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    parser.add_argument("--profile_dir", default=None,
                        help="trace the loop's steps 10-19 with torch.profiler: a chrome "
                             "trace and summary.json here")
    parser.add_argument("extras", nargs="*", help="dotted overrides key.path=value")
    args = parser.parse_args(argv)

    import yaml

    from animate3d_tpu_torch.core.checkpoint import (
        find_latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from animate3d_tpu_torch.core.config import deep_merge, parse_cli_overrides
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset, Prefetcher
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.models.factory import build_models, has_tokenizer, init_and_load
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.pipelines.train_mvvdm import (
        MVVDMTrainConfig,
        TrainBatch,
        cast_frozen_bf16,
        extract_motion_modules,
        make_optimizer,
        train_step,
    )
    from animate3d_tpu_torch.utils import trace
    from animate3d_tpu_torch.utils.logging import MetricsLogger, StepProfile
    from animate3d_tpu_torch.utils.saving import save_videos_grid

    with open(args.config) as fh:
        cfg = yaml.safe_load(fh) or {}
    cfg = deep_merge(cfg, parse_cli_overrides(args.extras))
    _check_supported(cfg)
    dev = resolve_device(args.device)
    dev, joined = pmesh.init_distributed(dev)
    mesh = pmesh.make_mesh()
    main_rank = mesh.is_main

    out_dir = cfg.get("output_dir", "outputs/mvvdm")
    os.makedirs(out_dir, exist_ok=True)
    n_views = cfg.get("num_views", 4)
    n_frames = cfg.get("video_length", 16)
    sample_size = cfg.get("sample_size", 256)
    seed = cfg.get("global_seed", 42)

    ckpt_flag = bool(cfg.get("gradient_checkpointing", False))
    root = cfg.get("flax_params_dir")
    towers = bool(root) and os.path.isdir(root)
    unet, vae, text_model, vision_model = build_models(
        cfg.get("model_size", "full"), n_views, dev, seed=seed, train=True,
        gradient_checkpointing=ckpt_flag, clip=towers)
    unet, vae, text_model, vision_model, loaded = init_and_load(
        unet, vae, text_model, vision_model, root, None)
    base = cfg.get("pretrained_model_path")
    if base and os.path.isdir(base):
        loaded |= set(load_pretrained_model_path(base, unet, vae))
    if ckpt_flag and main_rank:
        print("[train] gradient checkpointing (block recompute) enabled")
    # released files are f32: the frozen weights are rounded to the compute
    # dtype once, here, unless cast_frozen_bf16 is false
    masters = cast_frozen_bf16(unet, torch.bfloat16 if dev.type == "cuda" else torch.float32,
                               cast_frozen=bool(cfg.get("cast_frozen_bf16", True)))
    ucfg = unet.config
    lat = sample_size // (2 ** (len(vae.config.block_out_channels) - 1))

    dataset = MVideoDataset(MVideoConfig(
        manifest_path=cfg["train_data"]["manifest_path"],
        video_root=cfg["train_data"].get("video_root", ""),
        sample_size=sample_size, sample_n_frames=n_frames, num_views=n_views,
        total_frames=cfg["train_data"].get("total_frames", 48),
        elevation=cfg["train_data"].get("elevation", 15.0)), seed=seed)
    batch_size = cfg.get("train_batch_size", 1) * mesh.dp  # the global batch
    max_steps = cfg.get("max_train_steps",
                        cfg.get("max_train_epoch", 20) * max(len(dataset), 1))
    tcfg = MVVDMTrainConfig(
        learning_rate=cfg.get("learning_rate", 1e-4),
        cfg_dropout_prob=cfg.get("cfg_random_null_text_ratio", 0.1),
        num_views=n_views,
        i2v_cond_time_zero=cfg.get("i2v_cond_time_zero", False),
        max_grad_norm=cfg.get("max_grad_norm", 1.0),
        lr_scheduler=cfg.get("lr_scheduler", "constant"),
        lr_warmup_steps=cfg.get("lr_warmup_steps", 0),
        max_train_steps=max_steps,
        gradient_accumulation_steps=cfg.get("gradient_accumulation_steps", 1),
        scale_lr=cfg.get("scale_lr", False),
        lr_scale_factor=float(batch_size),
    )
    pmesh.replicate(mesh, list(masters.values()))
    zero = bool(cfg.get("zero_sharded_optimizer", False))
    opt = make_optimizer(masters, tcfg, mesh, zero)
    if mesh.dp > 1 and main_rank:
        print(f"[mesh] dp={mesh.dp}: global batch {batch_size}"
              + (", ZeRO-1 optimizer sharding" if opt.sharded else ""))
    scheduler = DDIMScheduler(SchedulerConfig(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_step = 0
    latest = find_latest_checkpoint(ckpt_dir)
    if latest and cfg.get("auto_resume", True):
        state = restore_checkpoint(latest)
        res = unet.load_state_dict(state["frozen"], strict=False)
        if res.unexpected_keys or set(res.missing_keys) != set(masters):
            raise RuntimeError(f"{latest} does not match this model: missing "
                               f"{sorted(set(res.missing_keys) - set(masters))[:5]}, "
                               f"unexpected {res.unexpected_keys[:5]}")
        with torch.no_grad():
            for name, m in masters.items():
                m.copy_(state["masters"][name])
        opt.load_state_dict(state["optimizer"])
        gen.set_state(state["generator"])
        start_step = int(state["step"])
        if main_rank:
            print(f"[resume] {latest} @ step {start_step}")

    depth = int(cfg.get("prefetch_depth", 2))
    batches = dataset.iterate(batch_size=batch_size, keep=pmesh.shard_rows(mesh, batch_size))
    prefetch = Prefetcher(batches, depth=depth) if depth > 0 else None
    it = prefetch or batches

    ctx_dim, img_dim = ucfg.cross_attention_dim, ucfg.image_embed_dim
    # caption -> CLIP text embeddings, cached per caption; the null context
    # is the encoded empty caption
    encode_captions = null_ctx_row = None
    if text_model is not None and has_tokenizer(root):
        from animate3d_tpu_torch.convert.weights import tokenizer_root
        from animate3d_tpu_torch.utils.tokenizer import ClipTokenizer, find_tokenizer_files

        tokenizer = ClipTokenizer(*find_tokenizer_files(tokenizer_root(root)), max_length=77)
        cap_cache = {}

        @torch.no_grad()
        def encode_captions(texts) -> torch.Tensor:
            missing = sorted({t for t in texts if t not in cap_cache})
            if missing:
                ids = torch.as_tensor(tokenizer(missing), dtype=torch.long, device=dev)
                cap_cache.update(zip(missing, text_model(ids).float()))
            return torch.stack([cap_cache[t] for t in texts])

        null_ctx_row = encode_captions([""])[0]
    else:
        print("[text] WARNING: no text encoder/tokenizer — zero text conditioning (smoke mode)")

    @torch.no_grad()
    def encode_frame0(frame0: torch.Tensor) -> torch.Tensor:
        """(M, H, W, 3) frames in [-1, 1] -> (M, D_img) IP-Adapter embeds."""
        if vision_model is None:
            return torch.zeros((frame0.shape[0], img_dim), device=dev)
        return encode_ip_adapter_images(vision_model, (frame0 + 1.0) / 2.0).float()

    if vision_model is None:
        print("[ip] WARNING: no image encoder — zero image embeds (smoke mode)")

    def text_pair(captions, n: int):
        """(text_ctx, null_ctx) for one caption per video, each repeated
        over its ``n`` views (view-major)."""
        if encode_captions is None:
            zeros = torch.zeros((len(captions) * n, 77, ctx_dim), device=dev)
            return zeros, zeros
        ctx = encode_captions(list(captions)).repeat_interleave(n, dim=0)
        return ctx, null_ctx_row.expand(ctx.shape).clone()

    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl")) if main_rank else None
    ckpt_every = cfg.get("checkpointing_steps", 1000)
    validation_steps = cfg.get("validation_steps", 0)
    validation_tuple = tuple(cfg.get("validation_steps_tuple", ()))
    log_every = int(cfg.get("log_every_n_steps", 10))

    @torch.no_grad()
    def vae_sample(imgs: torch.Tensor, chunk: int = 16) -> torch.Tensor:
        """Posterior *sample* of this rank's (M, H, W, 3) images, encoded
        ``chunk`` at a time; the noise is drawn for every rank's images, a
        chunk at a time as at one rank, and this rank's rows are kept."""
        m = imgs.shape[0]
        total, lo = m * mesh.dp, m * mesh.dp_rank
        eps = torch.cat([torch.randn((min(chunk, total - i), lat, lat,
                                      vae.config.latent_channels), generator=gen, device=dev)
                         for i in range(0, total, chunk)])[lo:lo + m]
        mean, logvar = (torch.cat(p) for p in zip(*(vae.encode(imgs[i:i + chunk])
                                                     for i in range(0, m, chunk))))
        return mean + torch.exp(0.5 * logvar) * eps

    def run_validation(step: int, raw) -> None:
        """Sample on the first video's conditioning (its frame-0 renders,
        caption and image embeds) with the sampling pipeline and write a
        4-view GIF."""
        from animate3d_tpu_torch.pipelines.mv_sampler import (
            MVSampler,
            MVSamplerConfig,
            decode_video,
            encode_conditioning_images,
        )
        from animate3d_tpu_torch.utils.saving import export_to_gif_mv

        n, f = raw["pixel_values"].shape[1:3]
        frame0 = torch.as_tensor(raw["pixel_values"][0, :, 0], device=dev)
        ffl = encode_conditioning_images(vae, frame0)
        text_cond, text_uncond = text_pair(raw["text"][:1], n)
        scfg = MVSamplerConfig(
            num_inference_steps=cfg.get("validation_num_steps", 25), num_views=n,
            num_frames=f, height=sample_size, width=sample_size,
            vae_scale_factor=2 ** (len(vae.config.block_out_channels) - 1),
            freeinit_enabled=False, i2v_cond_time_zero=tcfg.i2v_cond_time_zero)
        latents = MVSampler(unet, scfg, scheduler).sample(
            ffl, text_cond, text_uncond, encode_frame0(frame0), generator=gen)
        video = decode_video(vae, latents)
        if main_rank:
            out = os.path.join(out_dir, "samples", f"sample-{step}.gif")
            export_to_gif_mv(video.cpu().numpy(), out)
            print(f"[val] wrote {out}")

    def save(step: int) -> None:
        opt_state = opt.state_dict()  # collective under ZeRO-1
        if not main_rank:
            return
        frozen = {k: v for k, v in unet.state_dict().items() if k not in masters}
        trained = {k: v.detach() for k, v in masters.items()}
        save_checkpoint(ckpt_dir, step, {
            "step": step, "masters": trained, "frozen": frozen,
            "optimizer": opt_state, "generator": gen.get_state()})
        save_checkpoint(os.path.join(out_dir, "motion_modules"), step,
                        {"params": extract_motion_modules(trained)}, keep=2)

    metrics_all, step_seconds, conditioning = [], [], None
    profile = StepProfile(args.profile_dir)
    try:
        for step in range(start_step, max_steps):
            profile.before(step - start_step)
            t0 = time.perf_counter()
            raw = next(it)
            b, n, f = raw["pixel_values"].shape[:3]
            if step == start_step and main_rank:
                vids = (raw["pixel_values"].reshape(b * n, f, sample_size, sample_size, 3) + 1) / 2
                save_videos_grid(vids, os.path.join(out_dir, "sanity_check.gif"), n_rows=n)
            pixels = torch.as_tensor(raw["pixel_values"], device=dev)
            imgs = pixels.reshape(b * n * f, sample_size, sample_size, 3)
            latents = (vae_sample(imgs) * 0.18215).reshape(b * n, f, lat, lat, 4)
            text_ctx, null_ctx = text_pair(raw["text"], n)
            image_embeds = encode_frame0(pixels[:, :, 0].reshape(b * n, sample_size,
                                                                 sample_size, 3))
            batch = TrainBatch(
                latents=latents, text_ctx=text_ctx, null_text_ctx=null_ctx,
                camera=torch.as_tensor(raw["cameras"].reshape(b * n, 16), device=dev),
                image_embeds=image_embeds)
            if conditioning is None:
                conditioning = {"text_ctx": text_ctx, "null_text_ctx": null_ctx,
                                "image_embeds": image_embeds}
            metrics = train_step(unet, opt, batch, tcfg, scheduler, gen, mesh)
            if dev.type == "cuda":
                trace.synchronize(dev)
            step_seconds.append(time.perf_counter() - t0)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics_all.append(metrics)
            if main_rank:
                logger.log(step, {**metrics, "sec_per_step": step_seconds[-1]})
            if main_rank and (step % log_every == 0 or step + 1 == max_steps):
                print(f"[{step}/{max_steps}] loss={metrics['loss']:.5f} "
                      f"grad_norm={metrics['grad_norm']:.4f} ({step_seconds[-1]:.3f} s/it)")
            if ((validation_steps and (step + 1) % validation_steps == 0)
                    or (step + 1) in validation_tuple):
                run_validation(step + 1, raw)
            if (step + 1) % ckpt_every == 0 or step + 1 == max_steps:
                save(step + 1)
            profile.after(step - start_step)
    finally:
        profile.close()
        if prefetch is not None:
            prefetch.close()
        pmesh.leave(joined)
    return {"unet": unet, "optimizer": opt, "metrics": metrics_all,
            "step_seconds": step_seconds, "start_step": start_step, "loaded": loaded,
            "conditioning": conditioning, "dp": mesh.dp, "backend": mesh.backend}


if __name__ == "__main__":
    main()
