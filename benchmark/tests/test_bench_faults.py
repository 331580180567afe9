"""A run with the timed path broken underneath reads ``correct`` false:
for each cell, each fault it can have on one card (a step that returns its
state unchanged; half the batch left out; an answer altered where it is
produced). The tiny cells run on the CPU (``cells.py``)."""

import importlib

import pytest
import torch

from . import cells


def _half_unet(monkeypatch):
    """The UNet computes the first half of its batch and returns it for
    both halves."""
    from animate3d_tpu_torch.models import unet_mv

    forward = unet_mv.MVMotionUNet.forward

    def half(self, x, t, text, cam=None, img=None, **kw):
        h = x.shape[0] // 2
        tt = t[:h] if torch.as_tensor(t).dim() else t
        out = forward(self, x[:h], tt, text[:h], None if cam is None else cam[:h],
                      None if img is None else img[:h], **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(unet_mv.MVMotionUNet, "forward", half)


def _scaled(monkeypatch, module: str, name: str, fix):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: fix(orig(*a, **k)))


def _adam_still(monkeypatch):
    from animate3d_tpu_torch.systems import animate3d

    monkeypatch.setattr(animate3d.DeformAdam, "step",
                        lambda self: setattr(self, "count", self.count + 1))


def _rows_half(monkeypatch):
    """The recon loss over the first half of the step's items."""
    from animate3d_tpu_torch.systems import animate3d

    loss = animate3d.Animate3DSystem.loss

    def half(self, *a, **k):
        self._rows = lambda n: slice(0, n // 2)
        try:
            return loss(self, *a, **k)
        finally:
            del self._rows

    monkeypatch.setattr(animate3d.Animate3DSystem, "loss", half)


def _loss_half(monkeypatch):
    """The port's epsilon-MSE taken over the first half of the views."""
    from animate3d_tpu_torch.pipelines import train_mvvdm

    def half(unet, batch, t, noise, drop, cfg, scheduler):
        n = cfg.num_views
        t_views = t.repeat_interleave(n)
        first, rest = batch.latents[:, :1], batch.latents[:, 1:]
        noisy = torch.cat([first, scheduler.add_noise(rest, noise, t_views)], dim=1)
        dropped = drop.repeat_interleave(n)[:, None, None]
        text_ctx = torch.where(dropped, batch.null_text_ctx, batch.text_ctx)
        eps = unet(noisy, t_views, text_ctx, batch.camera, batch.image_embeds,
                   i2v_cond_time_zero=cfg.i2v_cond_time_zero)
        h = eps.shape[0] // 2
        return torch.mean((eps[:h, 1:].float() - noise[:h].float()) ** 2)

    monkeypatch.setattr(train_mvvdm, "loss_fn", half)


def _renders_dimmed(monkeypatch):
    _scaled(monkeypatch, "animate3d_tpu_torch.systems.animate3d", "render_batch",
            lambda out: out._replace(rgb=out.rgb * 0.98))


def _master_adamw_still(monkeypatch):
    from animate3d_tpu_torch.pipelines import train_mvvdm

    def still(self, grads):
        self.count += 1
        for p in self.masters.values():
            p.grad = None
        return torch.linalg.vector_norm(torch.stack([g.float().norm() for g in grads]))

    monkeypatch.setattr(train_mvvdm.MasterAdamW, "step", still)


FAULTS = {
    "sample": {
        "unchanged": lambda mp: mp.setattr(
            importlib.import_module("animate3d_tpu_torch.models.diffusion").DDIMScheduler,
            "step", lambda self, eps, t, sample, *a, **k: (sample, sample)),
        "half_batch": _half_unet,
        "altered": lambda mp: _scaled(mp, "animate3d_tpu_torch.pipelines.mv_sampler",
                                      "decode_video", lambda v: v * 0.98),
    },
    "recon": {"unchanged": _adam_still, "half_batch": _rows_half, "altered": _renders_dimmed},
    "refine": {"unchanged": _adam_still, "half_batch": _rows_half, "altered": _renders_dimmed},
    "train": {
        "unchanged": _master_adamw_still,
        "half_batch": _loss_half,
        "altered": lambda mp: _scaled(mp, "animate3d_tpu_torch.pipelines.train_mvvdm",
                                      "loss_fn", lambda loss: loss * 1.1),
    },
}


@pytest.mark.parametrize("driver,fault", [(d, f) for d, fs in FAULTS.items() for f in fs])
def test_fault_reads_incorrect(monkeypatch, driver, fault):
    FAULTS[driver][fault](monkeypatch)
    res = cells.run(driver)
    assert not res["correct"], res["checks"]
