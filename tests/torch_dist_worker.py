"""Gloo process groups on the CPU for the port's multi-rank tests (``Group``,
``spawn``); each rank runs this file,

    python tests/torch_dist_worker.py <spec.json> <rank>

The spec names the world size, the ``file://`` rendezvous (a FileStore under
the test's tmp dir, so parallel test workers never share a port) and the
tasks; each task's results are ``torch.save``d by rank 0 (and, where a task
says so, by every rank) under the spec's ``out`` directory.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
JOIN_SECONDS = 60


class Group:
    """``tasks`` running on a gloo group of ``world`` worker processes, which
    must end within JOIN_SECONDS of the start (a hang fails the test)."""

    def __init__(self, tmp: Path, world: int, tasks):
        tmp.mkdir(parents=True, exist_ok=True)
        spec = {"world": world, "store": f"file://{tmp}/store", "out": str(tmp),
                "tasks": tasks}
        (tmp / "spec.json").write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.tmp, self.world, self.tasks = tmp, world, tasks
        self.deadline = time.monotonic() + JOIN_SECONDS
        self.logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, __file__, str(tmp / "spec.json"), str(r)],
                                       env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
                      for r in range(world)]

    def results(self) -> list:
        """Rank 0's result of each task (every rank's where the task asks)."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.wait()
            import pytest

            pytest.fail(f"the {self.world}-rank group did not end within {JOIN_SECONDS} s "
                        "(a hang)")
        finally:
            for f in self.logs:
                f.close()
        for r, p in enumerate(self.procs):
            log = (self.tmp / f"rank{r}.log").read_text()
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        load = lambda i, r: torch.load(self.tmp / f"{i}.{r}.pt", weights_only=False)
        return [[load(i, r) for r in range(self.world)] if t.get("every_rank") else load(i, 0)
                for i, t in enumerate(self.tasks)]


def spawn(tmp: Path, world: int, tasks) -> list:
    return Group(tmp, world, tasks).results()


def trainer(spec, task, rank):
    from animate3d_tpu_torch.cli.train_mvvdm import main

    res = main(["--config", task["config"], "--device", "cpu", *task.get("extras", [])])
    masters = {k: v.detach().clone() for k, v in res["optimizer"].masters.items()}
    return {"masters": masters, "metrics": res["metrics"],
            "optimizer": res["optimizer"].state_dict(), "sharded": res["optimizer"].sharded}


def launch(spec, task, rank):
    """The 4D-stage CLI with ``task["args"]`` on the CPU; ``rendered`` counts
    the items each render of the training steps covered on this rank, and
    ``encoded`` the images each SDS VAE encode took."""
    from animate3d_tpu_torch.cli.launch import main
    from animate3d_tpu_torch.pipelines.guidance import AnimateMVGuidance
    from animate3d_tpu_torch.systems import animate3d

    rendered, real = [], animate3d.render_batch
    encoded, real_encode = [], AnimateMVGuidance._chunked_vae_encode

    def spy(state, deform_fn, cameras, timestamps, *a, **kw):
        if kw.get("do_reconstruction", True):
            rendered.append(int(timestamps.shape[0]))
        return real(state, deform_fn, cameras, timestamps, *a, **kw)

    def spy_encode(self, x):
        encoded.append(int(x.shape[0]))
        return real_encode(self, x)

    animate3d.render_batch = spy
    AnimateMVGuidance._chunked_vae_encode = spy_encode
    try:
        res = main([*task["args"], "--device", "cpu"])
    finally:
        animate3d.render_batch = real
        AnimateMVGuidance._chunked_vae_encode = real_encode
    return {"field": {k: v.detach().clone() for k, v in res["system"].field.state_dict().items()},
            "metrics": res["metrics"], "rendered": rendered, "encoded": encoded}


def ring(spec, task, rank):
    from animate3d_tpu_torch.parallel.mesh import make_mesh
    from animate3d_tpu_torch.parallel.sp_attention import ring_attention_sharded

    q, k, v = (torch.as_tensor(np.load(task["inputs"])[n]) for n in "qkv")
    mesh = make_mesh(dp=1, sp=spec["world"])
    with torch.no_grad():
        return {"out": ring_attention_sharded(mesh, q, k, v, task["heads"])}


def unet_sp_ring(spec, task, rank):
    """A tiny UNet forward under ``sp_ring`` (``min_seq`` lowered, so the
    tiny spatial sequences ride the ring) and the local forward; then the
    gate at the default ``SP_MIN_SEQ``: a 16-token sequence stays local, one
    of ``SP_MIN_SEQ`` tokens rides the ring."""
    from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
    from animate3d_tpu_torch.ops import attention
    from animate3d_tpu_torch.parallel import sp_attention
    from animate3d_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    ucfg = MVUNetConfig.tiny(num_views=4)
    unet = MVMotionUNet(ucfg).eval()
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    args = (f32(4, 2, 8, 8, 4), torch.tensor([300.0] * 4), f32(4, 7, ucfg.cross_attention_dim),
            f32(4, 16), f32(4, ucfg.image_embed_dim))
    mesh = make_mesh(dp=1, sp=spec["world"])
    calls = []
    real = sp_attention.ring_attention_sharded

    def spy(*a, **kw):
        calls.append(tuple(a[1].shape))
        return real(*a, **kw)

    sp_attention.ring_attention_sharded = spy
    mha = attention.multi_head_attention
    short, long = f32(4, 16, 32), f32(2, attention.SP_MIN_SEQ, 32)
    with torch.no_grad():
        local = unet(*args)
        with attention.sp_ring(mesh, min_seq=16):
            ringed = unet(*args)
        unet_calls = list(calls)
        with attention.sp_ring(mesh):
            out_short = mha(short, short, short, 2, self_attention=True)
            short_calls = len(calls) - len(unet_calls)
            out_long = mha(long, long, long, 2, self_attention=True)
            long_calls = len(calls) - len(unet_calls) - short_calls
        ref_short, ref_long = (mha(x, x, x, 2, self_attention=True) for x in (short, long))
    sp_attention.ring_attention_sharded = real
    return {"local": local, "ringed": ringed, "unet_calls": unet_calls,
            "short_calls": short_calls, "long_calls": long_calls,
            "short": (out_short, ref_short), "long": (out_long, ref_long)}


TASKS = {"trainer": trainer, "launch": launch, "ring": ring, "unet_sp_ring": unet_sp_ring}


def main():
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["store"], rank=rank,
                            world_size=spec["world"])
    try:
        for i, task in enumerate(spec["tasks"]):
            out = TASKS[task["kind"]](spec, task, rank)
            dist.barrier()
            if rank == 0 or task.get("every_rank"):
                torch.save(out, os.path.join(spec["out"], f"{i}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
