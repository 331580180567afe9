"""Driver of the ``train_dp4`` traffic: MV-VDM fine-tuning at data
parallelism over ``dp`` cards, one process a card (NCCL; gloo on the CPU),
each rank the per-step body of ``animate3d_tpu_torch/cli/train_mvvdm.py`` at
dp: its slice of the global batch (one video a rank) from ``MVideoDataset``
through a ``Prefetcher``, the posterior noise drawn for every rank's frames
and its rows kept, ``pipelines/train_mvvdm.py::train_step`` with the mesh
(the gradient all-reduce, ZeRO-1's sharded AdamW and its all-gather).

The harness's process is rank 0; its set-up starts ranks 1.. as processes
of this file (``python -m benchmark.drivers.train_dp4 <spec.json> <rank>``)
and joins them in one process group (``tcp://localhost``, a free port, the
traffic's ``pg_timeout_s`` on every collective); every rank computes on
one intra-op thread, as ``torchrun`` starts its processes
(``OMP_NUM_THREADS=1``), since the ranks share the host's cores. Only rank 0 keeps the
window's clock; after each step it broadcasts whether the window has
closed, so every rank stops after the same step. Then every rank meets at
a barrier and leaves the group; rank 0 joins the others' processes within
``join_s`` and kills any that are left, which fails the run.

The window's unit is one global step, timed on rank 0. The check is the
train cell's over the first three steps, for the global batch: the loss
(the mean over the ranks), rank 0's all-reduced first gradient (clipped,
read back from AdamW's first moments, gathered over the ZeRO-1 shards) and
the change of the masters over the three steps, against the reference's
mean over the same videos run one at a time on rank 0's card
(``reference/sd/train_dp.py``)."""

from __future__ import annotations

import atexit
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from benchmark import harness
from benchmark.drivers import recon, sample, train
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.sd import pipeline as ref
from benchmark.reference.sd import train as ref_train
from benchmark.reference.sd import train_dp as ref_dp

CHECKED = recon.CHECKED
ROOT = harness.BENCH_DIR.parent


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclass
class State(train.State):
    rank: int = 0
    dp: int = 1
    mesh: object = None
    procs: List[subprocess.Popen] = field(default_factory=list)
    logs: List[str] = field(default_factory=list)
    joined: bool = False
    rank_steps: List[int] = field(default_factory=list)


def _start_ranks(ctx: harness.Ctx, dp: int, port: int, root: str) -> tuple:
    """Ranks 1..dp-1 as processes of this module; their output goes to
    files under the run's scratch directory."""
    spec = {"config": ctx.spec.config, "traffic": ctx.spec.traffic, "seed": ctx.seed,
            "name": ctx.spec.name, "device": ctx.device.type, "port": port, "root": root,
            "tmp": ctx.tmp}
    path = os.path.join(ctx.tmp, "dp_spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(1, dp):
        log = os.path.join(ctx.tmp, f"rank{r}.log")
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.train_dp4", path, str(r)],
                cwd=str(ROOT), env=env, stdout=fh, stderr=subprocess.STDOUT))
        logs.append(log)

    def kill():
        for p in procs:
            if p.poll() is None:
                p.kill()
    atexit.register(kill)
    return procs, logs


def _join_group(traffic: dict, rank: int, dp: int, port: int, device) -> object:
    from animate3d_tpu_torch.parallel import mesh as pmesh

    if device.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=dp,
                            timeout=datetime.timedelta(seconds=traffic["pg_timeout_s"]))
    return pmesh.make_mesh(dp=dp)


def build(ctx: harness.Ctx, rank: int, port: int, root: str, procs=(), logs=()) -> State:
    """Rank ``rank``'s program, joined to the group, through its first
    steps (the checked three and the warm-up)."""
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset, Prefetcher
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.pipelines.train_mvvdm import MVVDMTrainConfig, make_optimizer
    from animate3d_tpu_torch.utils.tokenizer import (ClipTokenizer, find_tokenizer_files,
                                                     write_char_level_tokenizer)

    config, traffic = ctx.spec.config, ctx.spec.traffic
    dp = traffic["dp"]
    torch.set_num_threads(1)  # one intra-op thread a rank, as torchrun starts them
    dev = resolve_device(ctx.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    mesh = _join_group(traffic, rank, dp, port, dev)
    s, tr = config["sampling"], traffic["train"]
    manifest = os.path.join(root, "manifest.json")
    mods, masters = train._program(config, traffic, ctx.seed, dev)
    tcfg = MVVDMTrainConfig(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                            adam_b1=tr["adam_b1"], adam_b2=tr["adam_b2"],
                            adam_eps=tr["adam_eps"], max_grad_norm=tr["max_grad_norm"],
                            cfg_dropout_prob=tr["cfg_dropout_prob"], num_views=s["num_views"],
                            i2v_cond_time_zero=s["i2v_cond_time_zero"])
    opt = make_optimizer(masters, tcfg, mesh, zero=traffic["zero"])
    batch = traffic["batch_size"] * dp  # the global batch
    dataset = MVideoDataset(MVideoConfig(
        manifest_path=manifest, video_root=root, sample_size=s["size"],
        sample_n_frames=s["num_frames"], num_views=s["num_views"],
        total_frames=traffic["clip_frames"], elevation=s["camera_elevation"]),
        seed=harness.seed_for(ctx.seed, "dataset") % (1 << 63))
    prefetch = Prefetcher(dataset.iterate(batch_size=batch, keep=pmesh.shard_rows(mesh, batch)),
                          depth=traffic["prefetch_depth"])
    tok_dir = os.path.join(ctx.tmp, f"tokenizer{rank}")
    write_char_level_tokenizer(tok_dir)
    tokenizer = ClipTokenizer(*find_tokenizer_files(tok_dir), max_length=77)
    cache = {}

    @torch.no_grad()
    def encode_captions(texts):
        missing = sorted({t for t in texts if t not in cache})
        if missing:
            ids = torch.as_tensor(tokenizer(missing), dtype=torch.long, device=dev)
            cache.update(zip(missing, mods["text"](ids).float()))
        return torch.stack([cache[t] for t in texts])

    null_row = encode_captions([""])[0]

    def text_pair(captions, n: int):
        c = encode_captions(list(captions)).repeat_interleave(n, dim=0)
        return c, null_row.expand(c.shape).clone()

    state = State(ctx=ctx, cfg=config, traffic=traffic, system=None, batch=None, video=(),
                  mods=mods, opt=opt, tcfg=tcfg,
                  sched=DDIMScheduler(SchedulerConfig(), device=dev),
                  gen=torch.Generator(device=dev).manual_seed(harness.seed_for(ctx.seed, "gen")),
                  it=prefetch, prefetch=prefetch, text_pair=text_pair, masters=masters,
                  manifest=manifest, rank=rank, dp=dp, mesh=mesh, procs=list(procs),
                  logs=list(logs), joined=True)

    def moments():
        # collective under ZeRO-1: the moments gathered over the shards
        st = opt.state_dict()["adamw"]["state"]
        return {k: st[i]["exp_avg"] if i in st else torch.zeros_like(p)
                for i, (k, p) in enumerate(masters.items())}
    recon.first_steps(state, run_step, max(CHECKED, traffic["warm_steps"]), moments,
                      lambda: masters)
    return state


def setup(ctx: harness.Ctx) -> State:
    traffic = ctx.spec.traffic
    root = os.path.join(ctx.tmp, "clips")
    train.write_clips(traffic, ctx.spec.config, ctx.seed, root)
    port = _free_port()
    procs, logs = _start_ranks(ctx, traffic["dp"], port, root)
    try:
        return build(ctx, 0, port, root, procs, logs)
    except BaseException:
        for p in procs:
            p.kill()
        raise


def run_step(state: State) -> dict:
    """One global step: this rank's video through ``cli/train_mvvdm.py``'s
    per-step body at dp."""
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.pipelines.train_mvvdm import TrainBatch, train_step

    mods, dev, mesh = state.mods, state.ctx.device, state.mesh
    s = state.cfg["sampling"]
    size = s["size"]
    lat = size // 2 ** (len(state.cfg["vae"]["block_out_channels"]) - 1)
    c = state.cfg["vae"]["latent_channels"]
    with span("loader.next"):
        raw = next(state.it)
    b, n, f = raw["pixel_values"].shape[:3]
    pixels = torch.as_tensor(raw["pixel_values"], device=dev)
    imgs = pixels.reshape(b * n * f, size, size, 3)
    with span("vae.encode"), torch.no_grad():
        m, chunk = imgs.shape[0], 16
        total, lo = m * mesh.dp, m * mesh.dp_rank
        eps = torch.cat([torch.randn((min(chunk, total - i), lat, lat, c), generator=state.gen,
                                     device=dev) for i in range(0, total, chunk)])[lo:lo + m]
        mean, logvar = (torch.cat(p) for p in zip(*(mods["vae"].encode(imgs[i:i + chunk])
                                                     for i in range(0, m, chunk))))
        latents = ((mean + torch.exp(0.5 * logvar) * eps)
                   * state.cfg["vae"]["scaling_factor"]).reshape(b * n, f, lat, lat, c)
    with span("clip.encode"), torch.no_grad():
        text_ctx, null_ctx = state.text_pair(raw["text"], n)
        image_embeds = encode_ip_adapter_images(
            mods["vision"], (pixels[:, :, 0].reshape(b * n, size, size, 3) + 1.0) / 2.0).float()
    batch = TrainBatch(latents=latents, text_ctx=text_ctx, null_text_ctx=null_ctx,
                       camera=torch.as_tensor(raw["cameras"].reshape(b * n, 16), device=dev),
                       image_embeds=image_embeds)
    with span("train_step"):
        metrics = train_step(mods["unet"], state.opt, batch, state.tcfg, state.sched, state.gen,
                             mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    state.k += 1
    return {k: torch.tensor(float(v)) for k, v in metrics.items()}


def _closed(state: State, closed: bool) -> bool:
    """Rank 0's ``closed`` on every rank (a one-element broadcast)."""
    flag = torch.tensor([int(closed)], dtype=torch.int32, device=state.ctx.device)
    dist.broadcast(flag, 0)
    return bool(flag.item()) if state.rank else closed


def window(state: State, win) -> None:
    """Steps until rank 0's window closes; every rank runs the same steps."""
    while True:
        run_step(state)
        try:
            win.tick()
            closed = False
        except harness.WindowClosed:
            closed = True
        if _closed(state, closed):
            raise harness.WindowClosed


class _RankClock:
    """The window of ranks 1..: no clock of its own (rank 0 decides)."""

    def tick(self):
        pass


def leave(state: State) -> None:
    """Every rank: a barrier, then out of the group. Rank 0 then joins the
    other ranks' processes within the traffic's ``join_s``, kills those
    left, and raises where any failed."""
    if state.prefetch is not None:
        state.prefetch.close()
        state.prefetch = None
    if state.joined:
        dist.barrier()
        dist.destroy_process_group()
        state.joined = False
    if state.rank or not state.procs:
        return
    deadline = time.monotonic() + state.traffic["join_s"]
    bad = []
    for p, log in zip(state.procs, state.logs):
        try:
            rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "killed after the join deadline"
        if rc != 0:
            with open(log) as fh:
                bad.append(f"{log}: {rc}\n" + fh.read()[-4000:])
    state.procs = []
    if bad:
        raise RuntimeError("ranks failed:\n" + "\n".join(bad))
    state.rank_steps = [state.k]
    for log in state.logs:
        with open(log.replace(".log", ".steps")) as fh:
            state.rank_steps.append(int(fh.read()))
    if len(set(state.rank_steps)) != 1:
        raise RuntimeError(f"the ranks ran different numbers of steps: {state.rank_steps}")


def trace_counts(state: State, win) -> Dict[str, float]:
    """Rank 0's work: one video's step a unit (the train cell's count at
    batch 1)."""
    return train.trace_counts(state, win)


# -- the check ------------------------------------------------------------------------

def follow(state: State, mode: str = "f32", fault: Optional[str] = None):
    """The reference through the three checked global steps from the same
    start: (mean losses, first gradients, parameters after the three)."""
    cfg, traffic, dev, seed = state.cfg, state.traffic, state.ctx.device, state.ctx.seed
    s = cfg["sampling"]
    recon.release(dev)
    mods = ref.build(dict(cfg, unet=dict(cfg["unet"], gradient_checkpointing=True)), dev)
    sample.load_weights(mods, dict(cfg, unet_dtype="float32"), seed, dev, upcast=True)
    markers = traffic["train"]["trainable_markers"]
    if traffic["cast_frozen_bf16"]:
        with torch.no_grad():
            for name, p in mods["unet"].named_parameters():
                if not ref_train.is_trainable(name, markers):
                    p.copy_(p.to(torch.bfloat16).float())
    trainer = ref_train.Trainer(mods, cfg, markers, traffic["train"])
    with open(state.manifest) as fh:
        items = json.load(fh)
    data = ref_dp.global_batches(items, harness.seed_for(seed, "dataset") % (1 << 63),
                                 traffic["clip_frames"], s["num_frames"],
                                 traffic["batch_size"] * traffic["dp"])
    gen = torch.Generator(device=dev).manual_seed(harness.seed_for(seed, "gen"))
    root = os.path.dirname(state.manifest)
    cams = ref.cameras(s["num_views"], s["camera_elevation"], dev)
    losses, first = [], None
    with precision.mode(mode):
        for k in range(CHECKED):
            videos = next(data)
            pixels = [torch.as_tensor(ref_train.read_clip(root, item, idx, s["num_views"]),
                                      device=dev)[None] for item, idx in videos]
            loss, grads = ref_dp.dp_step(trainer, pixels, [item["caption"] for item, _ in videos],
                                         cams, gen, fault=fault)
            losses.append(loss)
            if k == 0:
                first = grads
    return losses, first, {k: p.detach().clone() for k, p in trainer.params.items()}


def free_program(state: State) -> None:
    leave(state)
    train.free_program(state)


def check(state: State) -> Dict[str, dict]:
    free_program(state)
    return recon.with_limits(recon.gaps(state, recon.program_readings(state), follow(state)),
                             state.traffic["limits"])


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    state = setup(ctx)
    free_program(state)
    want = follow(state)
    out = {"program": recon.gaps(state, recon.program_readings(state), want)}
    if control:
        out["control"] = recon.gaps(state, follow(state, "fp8"), want)
        out["own_rank"] = recon.gaps(state, follow(state, fault="own_rank"), want)
    return out


# -- ranks 1.. ------------------------------------------------------------------------

def worker(spec_path: str, rank: int) -> int:
    """Rank ``rank``: its program through the first steps, then steps until
    rank 0's window closes, then the barrier and out."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    cell = harness.CellSpec(name=spec["name"], chips=spec["traffic"]["dp"], config_name="",
                            config=spec["config"], traffic_name="train_dp4",
                            traffic=spec["traffic"], end_to_end=[], per_layer=[])
    device = (torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu"))
    ctx = harness.Ctx(spec=cell, seed=spec["seed"], device=device, tmp=spec["tmp"])
    state = build(ctx, rank, spec["port"], spec["root"])
    try:
        window(state, _RankClock())
    except harness.WindowClosed:
        pass
    leave(state)
    with open(os.path.join(spec["tmp"], f"rank{rank}.steps"), "w") as fh:
        fh.write(str(state.k))
    return 0


if __name__ == "__main__":
    harness.fix_cache_dirs(ROOT)
    sys.exit(worker(sys.argv[1], int(sys.argv[2])))
