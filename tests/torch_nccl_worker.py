"""One rank of the two-card data-parallel gradient check
(``tests/test_torch_dp_nccl.py``), NCCL over two cards of one host:

    python tests/torch_nccl_worker.py <out_dir> <rank> <port>

Both ranks build the full-width MV-VDM UNet as the trainer builds it
(``benchmark/drivers/train.py``'s program: seeded float32 weights, the
trainable leaves float32 masters, the frozen ones bf16) and one synthetic
global batch of two videos (4 views x 4 frames of 32 x 32 latents, text,
cameras, image embeddings) with its draws, from fixed seeds. Rank ``r``
takes the gradient of video ``r`` and all-reduces the mean over NCCL
(``parallel/mesh.py::all_reduce_``). Rank 0 then, on its own card, takes
video 0's gradient again (the kernels' run-to-run spread), video 1's (so
the mean of the two halves without NCCL) and the batch of both videos in
one pass (the one-process run), and writes the relative gaps to
``<out_dir>/gaps.json``."""

import json
import os
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rel(a, b) -> float:
    fa = torch.cat([x.double().reshape(-1) for x in a])
    fb = torch.cat([x.double().reshape(-1) for x in b])
    return float((fa - fb).norm() / fb.norm())


def norm(g) -> float:
    return float(torch.cat([x.double().reshape(-1) for x in g]).norm())


def main(out: str, rank: int, port: int) -> None:
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.pipelines.train_mvvdm import MVVDMTrainConfig, TrainBatch, loss_fn
    from benchmark.drivers import train

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=120))
    mesh = pmesh.make_mesh(dp=2)
    config = json.load(open(os.path.join(ROOT, "benchmark/configs/mvvdm-sd15.json")))
    traffic = json.load(open(os.path.join(ROOT, "benchmark/traffic/train.json")))
    mods, masters = train._program(config, traffic, 2200000301, dev)
    unet = mods["unet"]
    n, f, lat = 4, 4, 32  # 4 frames: the one-pass batch of both videos fits one card
    g = torch.Generator().manual_seed(7)
    full = TrainBatch(latents=torch.randn((2 * n, f, lat, lat, 4), generator=g),
                      text_ctx=torch.randn((2 * n, 77, 768), generator=g),
                      null_text_ctx=torch.randn((2 * n, 77, 768), generator=g),
                      camera=torch.randn((2 * n, 16), generator=g),
                      image_embeds=torch.randn((2 * n, 1024), generator=g))
    t = torch.tensor([321, 812])
    noise = torch.randn((2 * n, f - 1, lat, lat, 4), generator=g)
    drop = torch.tensor([False, False])
    full = TrainBatch(*(x.to(dev) for x in full))
    t, noise, drop = t.to(dev), noise.to(dev), drop.to(dev)
    tcfg = MVVDMTrainConfig(num_views=n)
    sched = DDIMScheduler(SchedulerConfig(), device=dev)

    def grads_of(videos):
        rows = torch.cat([torch.arange(v * n, (v + 1) * n) for v in videos]).to(dev)
        vids = torch.tensor(videos, device=dev)
        batch = TrainBatch(*(x[rows] for x in full))
        loss_fn(unet, batch, t[vids], noise[rows], drop[vids], tcfg, sched).backward()
        out = [m.grad.detach().clone() for m in masters.values()]
        for m in masters.values():
            m.grad = None
        return out

    own = grads_of([rank])
    reduced = [x.clone() for x in own]
    pmesh.all_reduce_(mesh, reduced, "mean")
    if rank == 0:
        again = grads_of([0])
        other = grads_of([1])
        split = [(a + b) / 2 for a, b in zip(own, other)]
        one = grads_of([0, 1])
        gaps = {"nccl_vs_split": rel(reduced, split), "repeat": rel(again, own),
                "one_vs_split": rel(one, split),
                "norm_one_vs_nccl": abs(norm(one) - norm(reduced)) / norm(one),
                "norm_nccl_vs_split": abs(norm(reduced) - norm(split)) / norm(split),
                "bitwise_nccl_split": all(torch.equal(a, b) for a, b in zip(reduced, split)),
                "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(again, own))}
        with open(os.path.join(out, "gaps.json"), "w") as fh:
            json.dump(gaps, fh)
    pmesh.leave(True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
