"""MV-VDM trainer: fine-tuning of the motion modules and adapters.

Port of ``animate3d_tpu/pipelines/train_mvvdm.py`` on one device:
  * only parameters whose names carry a ``TRAINABLE_KEY_MARKERS`` entry
    train (motion modules, I2V / spatial adapters, alpha blenders);
  * the first frame stays noise-free as the I2V condition, one random
    timestep per video repeated over its views, ``add_noise`` on frames
    1..F-1, epsilon-MSE in f32 on frames 1..F-1;
  * per-video CFG dropout of the text context to the null context;
  * AdamW after global-norm clipping, with the optax schedules.

Precision mirrors the JAX trainer: the UNet computes in the model dtype
(bf16 on the card, ``unet.compute_dtype``) and stores the trainable
parameters in f32, which are the optimizer's masters (:class:`MasterAdamW`);
the frozen ones are stored in the compute dtype (``cast_frozen_bf16: true``,
the default) or kept in f32 (``false``). Each layer casts its weights to the
compute dtype at use and the norms apply theirs in f32, flax's rule
(``models/layers.py``), so the kernels see bf16 activations either way.
Frozen parameters get no gradient, no state and no update.

The random draws come from an explicit ``torch.Generator``; :func:`loss_fn`
also takes the draws as tensors so that tests can hand it the ones JAX made.

Data parallel (a ``parallel.mesh.Mesh`` with dp > 1): each rank holds its
slice of the global batch, draws the *global* batch's timesteps, noise and
CFG drop from the shared seeded generator and keeps its rows, so a step
equals the one-process step on the global batch; gradients and the logged
loss are means over the ranks. ``zero_sharded_optimizer`` (ZeRO-1) keeps on
each rank the AdamW moments of its slice of every master whose leading axis
divides by dp, updates that slice and all-gathers the masters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from animate3d_tpu_torch.models.diffusion import DDIMScheduler
from animate3d_tpu_torch.parallel import mesh as pmesh

TRAINABLE_KEY_MARKERS = (
    "motion_modules",  # all temporal transformers
    "to_q_i2v", "to_k_i2v", "to_v_i2v", "to_out_i2v",  # I2V adapters
    "to_q_sp", "to_k_sp", "to_v_sp", "to_out_sp",  # spatial adapters
    "alpha_blender",
)


@dataclass(frozen=True)
class MVVDMTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    cfg_dropout_prob: float = 0.1
    num_views: int = 4
    i2v_cond_time_zero: bool = False
    lr_scheduler: str = "constant"  # constant | linear | cosine
    lr_warmup_steps: int = 0
    max_train_steps: int = 100000  # decay horizon for linear / cosine
    # the reference's gradient_accumulation_steps only scales the LR (its
    # loop steps every batch), kept for config parity as in the JAX package
    gradient_accumulation_steps: int = 1
    scale_lr: bool = False
    lr_scale_factor: float = 1.0  # the batch size when scale_lr


def make_lr_schedule(cfg: MVVDMTrainConfig) -> Callable[[int], float]:
    """count -> learning rate, the values of the JAX package's optax
    schedules: constant / linear to 0 / cosine to 0, after a linear warmup
    from 0 when ``lr_warmup_steps`` is set."""
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.lr_scale_factor
    warmup = cfg.lr_warmup_steps * cfg.gradient_accumulation_steps
    decay = max(cfg.max_train_steps * cfg.gradient_accumulation_steps, warmup + 1) - warmup

    def linear(init: float, end: float, steps: int, count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    if cfg.lr_scheduler == "constant":
        def main(count):
            return lr
    elif cfg.lr_scheduler == "linear":
        def main(count):
            return linear(lr, 0.0, decay, count)
    elif cfg.lr_scheduler == "cosine":
        def main(count):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
    else:
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")
    if not warmup:
        return main
    return lambda count: (linear(0.0, lr, warmup, count) if count < warmup
                          else main(count - warmup))


def is_trainable(name: str) -> bool:
    """True for the parameters the reference unfreezes, by diffusers name."""
    return any(m in name for m in TRAINABLE_KEY_MARKERS)


def extract_motion_modules(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trained entries only (motion modules + adapters): the release
    export (the reference's ``save_motion_modules``)."""
    return {name: t for name, t in state.items() if is_trainable(name)}


def trainable_mask(module: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable} over ``module``'s parameters (the JAX
    package's ``trainable_mask`` over the port's diffusers names)."""
    return {name: is_trainable(name) for name, _ in module.named_parameters()}


def cast_frozen_bf16(unet: torch.nn.Module, dtype: torch.dtype = torch.bfloat16,
                     cast_frozen: bool = True) -> Dict[str, torch.Tensor]:
    """Set the UNet to compute in ``dtype`` with its trainable parameters
    stored in f32 and the frozen ones in ``dtype`` (``cast_frozen``, the
    JAX trainer's ``cast_frozen_bf16: true``) or in f32 (``false``). Returns
    the masters: {name: trainable parameter}, the module's own f32 tensors."""
    masters = {}
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if is_trainable(name):
                p.data = p.data.float()
                masters[name] = p
            else:
                p.data = p.data.to(dtype if cast_frozen else torch.float32)
    unet.compute_dtype = dtype
    return masters


class MasterAdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over f32 masters.

    Clipping is optax's rule, ``g if norm < max else g / norm * max`` with
    no epsilon (``clip_grad_norm_`` adds 1e-6). ``torch.optim.AdamW``'s math
    is optax ``adamw``'s (decoupled decay, eps outside the square root); the
    learning rate of each step is the schedule at the count before it, as
    optax's ``scale_by_schedule`` reads it.

    With ``zero`` on a mesh of dp > 1 (ZeRO-1) AdamW steps this rank's
    slices of the masters that ``shard_leading_where_divisible`` shards
    (views, so the update lands in the masters) and the whole of the others,
    then the masters are all-gathered; :meth:`state_dict` gathers the
    moments, so a checkpoint reads as a replicated one, and
    :meth:`load_state_dict` takes this rank's slices of them."""

    def __init__(self, masters: Dict[str, torch.Tensor], cfg: MVVDMTrainConfig,
                 mesh: Optional[pmesh.Mesh] = None, zero: bool = False):
        self.masters = masters
        self.max_grad_norm = cfg.max_grad_norm
        self.schedule = make_lr_schedule(cfg)
        self.count = 0
        self.mesh = mesh
        tensors = list(masters.values())
        self.shards = (pmesh.shard_leading_where_divisible(mesh, tensors)
                       if zero and mesh is not None else [None] * len(tensors))
        params = [m.detach()[sl] if sl is not None else m
                  for m, sl in zip(tensors, self.shards)]
        self.adamw = torch.optim.AdamW(params, lr=self.schedule(0),
                                       betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                                       weight_decay=cfg.weight_decay)
        self._params = params

    @property
    def sharded(self) -> bool:
        return any(sl is not None for sl in self.shards)

    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from the gradients of the masters, in their order
        (any dtype; upcast to f32). Returns the global norm before clipping."""
        grads = [g.float() for g in grads]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if not bool(norm < self.max_grad_norm):
            grads = [g / norm * self.max_grad_norm for g in grads]
        for p, g, sl in zip(self._params, grads, self.shards):
            p.grad = g if sl is None else g[sl]
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        for p in (*self._params, *self.masters.values()):
            p.grad = None
        if self.sharded:
            pmesh.gather_shards_(self.mesh, list(self.masters.values()), self.shards)
        return norm

    def state_dict(self) -> dict:
        """The replicated layout's state (collective under ZeRO-1: every
        rank calls it)."""
        sd = self.adamw.state_dict()
        if self.sharded:
            state = {i: dict(st) for i, st in sd["state"].items()}
            for i, sl in enumerate(self.shards):
                if sl is not None and i in state:
                    for key in ("exp_avg", "exp_avg_sq"):
                        state[i][key] = pmesh.all_gather_rows(self.mesh, state[i][key])
            sd = {**sd, "state": state}
        return {"count": self.count, "adamw": sd}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        sd = state["adamw"]
        if self.sharded:
            st = {i: dict(v) for i, v in sd["state"].items()}
            for i, sl in enumerate(self.shards):
                if sl is not None and i in st:
                    for key in ("exp_avg", "exp_avg_sq"):
                        st[i][key] = st[i][key][sl].clone()
            sd = {**sd, "state": st}
        self.adamw.load_state_dict(sd)


def make_optimizer(masters: Dict[str, torch.Tensor], cfg: MVVDMTrainConfig,
                   mesh: Optional[pmesh.Mesh] = None, zero: bool = False) -> MasterAdamW:
    """The JAX package's ``make_optimizer`` over the trainable masters
    (ZeRO-1 on ``mesh`` when ``zero``; a no-op at dp 1, as in JAX)."""
    return MasterAdamW(masters, cfg, mesh, zero)


class TrainBatch(NamedTuple):
    """Pre-encoded training batch, leading axis B*N (view-major)."""

    latents: torch.Tensor  # (B*N, F, h, w, 4) clean VAE latents x 0.18215
    text_ctx: torch.Tensor  # (B*N, 77, D)
    null_text_ctx: torch.Tensor  # (B*N, 77, D) empty-prompt embeds (CFG dropout)
    camera: torch.Tensor  # (B*N, 16)
    image_embeds: Optional[torch.Tensor]  # (B*N, D_img) or None


def draw(batch: TrainBatch, cfg: MVVDMTrainConfig, num_train_timesteps: int,
         generator: torch.Generator, mesh: Optional[pmesh.Mesh] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t per video (B,), noise for frames 1..F-1, CFG drop per video (B,)).
    On a mesh of dp > 1 the draws are the global batch's (dp x B videos)
    and this rank's rows are kept."""
    lat = batch.latents
    n = cfg.num_views
    dp = mesh.dp if mesh is not None else 1
    b = lat.shape[0] // n * dp
    dev = lat.device
    t = torch.randint(0, num_train_timesteps, (b,), generator=generator, device=dev)
    noise = torch.randn((b * n, lat.shape[1] - 1) + tuple(lat.shape[2:]), generator=generator,
                        device=dev, dtype=lat.dtype)
    drop = torch.rand((b,), generator=generator, device=dev) < cfg.cfg_dropout_prob
    if dp > 1:
        videos, items = pmesh.shard_rows(mesh, b), pmesh.shard_rows(mesh, b * n)
        t, noise, drop = t[videos], noise[items], drop[videos]
    return t, noise, drop


def loss_fn(unet: torch.nn.Module, batch: TrainBatch, t: torch.Tensor, noise: torch.Tensor,
            drop: torch.Tensor, cfg: MVVDMTrainConfig, scheduler: DDIMScheduler
            ) -> torch.Tensor:
    """Epsilon-MSE (f32) on frames 1..F-1 for the given draws."""
    n = cfg.num_views
    t_views = t.repeat_interleave(n)
    first, rest = batch.latents[:, :1], batch.latents[:, 1:]
    noisy = torch.cat([first, scheduler.add_noise(rest, noise, t_views)], dim=1)
    dropped = drop.repeat_interleave(n)[:, None, None]
    text_ctx = torch.where(dropped, batch.null_text_ctx, batch.text_ctx)
    eps = unet(noisy, t_views, text_ctx, batch.camera, batch.image_embeds,
               i2v_cond_time_zero=cfg.i2v_cond_time_zero)
    return torch.mean((eps[:, 1:].float() - noise.float()) ** 2)


def apply_gradients(unet: torch.nn.Module, opt: MasterAdamW,
                    mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """Step the masters (the module's trainable parameters) on their
    gradients, averaged over the mesh's dp ranks, and clear them. Returns
    the global gradient norm before clipping."""
    grads = [torch.zeros_like(m) if m.grad is None else m.grad for m in opt.masters.values()]
    if mesh is not None:
        pmesh.all_reduce_(mesh, grads, "mean")
    return opt.step(grads)


def train_step(unet: torch.nn.Module, opt: MasterAdamW, batch: TrainBatch,
               cfg: MVVDMTrainConfig, scheduler: DDIMScheduler,
               generator: torch.Generator, mesh: Optional[pmesh.Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step on this rank's batch; returns {"loss" (the mean
    over the mesh's dp ranks), "grad_norm"} as device scalars."""
    t, noise, drop = draw(batch, cfg, scheduler.config.num_train_timesteps, generator, mesh)
    loss = loss_fn(unet, batch, t, noise, drop, cfg, scheduler)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        loss = loss.clone()
        pmesh.all_reduce_(mesh, [loss], "mean")
    return {"loss": loss, "grad_norm": apply_gradients(unet, opt, mesh)}
