"""The port's trainer pipeline (animate3d_tpu_torch/pipelines/train_mvvdm.py)
against the JAX package's.

One tiny UNet (MVUNetConfig.tiny, one layer per block, every attention
behaviour of the trainer's config) with seeded, perturbed weights is built
by the port; its state dict goes to JAX through convert/torch_to_flax.py
and comes back through the port's convert/from_flax.py unchanged. Inputs
and draws are made with numpy / jax.random and handed to both sides.
"""

import collections

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from animate3d_tpu.convert.torch_to_flax import torch_to_flax_params
from animate3d_tpu.models.unet_mv import MVMotionUNet as JaxUNet, MVUNetConfig as JaxUNetConfig
from animate3d_tpu.pipelines import train_mvvdm as JT
from animate3d_tpu_torch.convert.from_flax import from_flax
from animate3d_tpu_torch.models.diffusion import DDIMScheduler
from animate3d_tpu_torch.models.factory import init_params
from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
from animate3d_tpu_torch.pipelines import train_mvvdm as TT

N_VIEWS, N_VIDEOS, FRAMES, LAT = 4, 2, 3, 8


def _drop_none(tree):
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None and not (isinstance(v, dict)
                                                                      and not v)}
    return tree


@pytest.fixture(scope="module")
def tiny():
    """(port state dict, flax params) of one tiny UNet: the port's seeded
    init, every parameter perturbed by 0.01 N(0, 1) so that zero-initialised
    adapters carry gradient too."""
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1))
    init_params(unet, seed=0)
    rng = np.random.default_rng(99)
    state = {k: v.numpy() + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in unet.state_dict().items()}
    return state, {"params": torch_to_flax_params(state)}


@pytest.fixture(scope="module")
def batch_and_draws():
    """A numpy batch of 2 videos and the draws JAX's loss_fn makes from key 0."""
    rng = np.random.default_rng(1)
    bn = N_VIDEOS * N_VIEWS
    batch = dict(latents=rng.normal(size=(bn, FRAMES, LAT, LAT, 4)).astype(np.float32),
                 text_ctx=rng.normal(size=(bn, 77, 32)).astype(np.float32),
                 null_text_ctx=np.zeros((bn, 77, 32), np.float32),
                 camera=rng.normal(size=(bn, 16)).astype(np.float32),
                 image_embeds=rng.normal(size=(bn, 16)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    draws = dict(t=np.array(jax.random.randint(k_t, (N_VIDEOS,), 0, 1000)),
                 noise=np.array(jax.random.normal(k_noise, (bn, FRAMES - 1, LAT, LAT, 4),
                                                  jnp.float32)),
                 drop=np.array(jax.random.bernoulli(k_drop, 0.5, (N_VIDEOS,))))
    return batch, draws, key


def test_params_carry_across_unchanged(tiny):
    state, params = tiny
    back = from_flax(params)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_trainable_names_match_jax_mask(tiny):
    state, params = tiny
    mask = from_flax(JT.trainable_mask(params))
    jax_names = {k for k, v in mask.items() if bool(v.reshape(-1)[0])}
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1))
    port_mask = TT.trainable_mask(unet)
    assert set(port_mask) == set(state)
    assert jax_names == {k for k, trainable in port_mask.items() if trainable}
    assert 0 < len(jax_names) < len(state)


def test_loss_and_grads_match_jax_train_step(tiny, batch_and_draws):
    """The tiny UNet's loss and every trainable gradient against the JAX
    trainer's loss_fn under value_and_grad (through make_train_step, with a
    transformation that hands back the gradients as its state), on the same
    params, batch and draws. The port runs with gradient checkpointing. f32;
    loss within 1e-5 relative, gradients within 1e-5 of the largest
    gradient magnitude (f32 sums in another order through the UNet and its
    backward)."""
    state, params = tiny
    batch, draws, key = batch_and_draws
    cfg = JT.MVVDMTrainConfig(num_views=N_VIEWS, cfg_dropout_prob=0.5)
    unet = JaxUNet(JaxUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1), dtype=jnp.float32)

    def unet_apply(p, *a, i2v_cond_time_zero=False):
        return unet.apply(p, *a, i2v_cond_time_zero=i2v_cond_time_zero)

    grab = optax.GradientTransformation(
        lambda p: None, lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jax.jit(JT.make_train_step(unet_apply, grab, cfg))
    with jax.default_matmul_precision("highest"):
        _, grads, metrics = step(params, None, JT.TrainBatch(
            **{k: jnp.asarray(v) for k, v in batch.items()}), key)
    ref = from_flax(_drop_none(jax.tree_util.tree_map(np.asarray, grads)))

    port = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1,
                                          gradient_checkpointing=True)).train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    for name, p in port.named_parameters():
        p.requires_grad_(TT.is_trainable(name))
    tcfg = TT.MVVDMTrainConfig(num_views=N_VIEWS, cfg_dropout_prob=0.5)
    loss = TT.loss_fn(port, TT.TrainBatch(**{k: torch.from_numpy(v) for k, v in batch.items()}),
                      torch.from_numpy(draws["t"]).long(), torch.from_numpy(draws["noise"]),
                      torch.from_numpy(draws["drop"]), tcfg, DDIMScheduler())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(metrics["loss"]), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in port.named_parameters() if p.requires_grad}
    assert set(got) == set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    for name, g in got.items():
        np.testing.assert_allclose(g, ref[name].numpy(), atol=1e-5 * top, rtol=0, err_msg=name)


def test_frozen_params_stay_bit_identical(tiny, batch_and_draws):
    """A full train step changes every trainable master and module copy and
    leaves every frozen parameter bit-identical (the port's twin of
    tests/test_train_cli.py::test_frozen_params_do_not_move)."""
    state, _ = tiny
    batch, _, _ = batch_and_draws
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1)).train()
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    for name, p in unet.named_parameters():
        p.requires_grad_(TT.is_trainable(name))
    masters = TT.cast_frozen_bf16(unet, torch.float32)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    cfg = TT.MVVDMTrainConfig(num_views=N_VIEWS)
    opt = TT.make_optimizer(masters, cfg)
    metrics = TT.train_step(unet, opt, TT.TrainBatch(
        **{k: torch.from_numpy(v) for k, v in batch.items()}), cfg, DDIMScheduler(),
        torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    for name, p in unet.named_parameters():
        if name in masters:
            assert not torch.equal(p, before[name]), name
            torch.testing.assert_close(p.detach(), masters[name], atol=0, rtol=0)
        else:
            assert torch.equal(p, before[name]), name
            assert p.grad is None


@pytest.mark.parametrize("scheduler,warmup", [("constant", 0), ("linear", 3), ("cosine", 2)])
def test_optimizer_matches_optax(scheduler, warmup):
    """MasterAdamW against the JAX make_optimizer (clip_by_global_norm +
    adamw) fed the same numpy gradients for 3 steps, one of them above the
    clipping norm and one below; params within 1e-6 after every step."""
    rng = np.random.default_rng(7)
    shapes = {"motion_modules_0": (6, 5), "to_q_i2v": (5,), "alpha_blender": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = JT.MVVDMTrainConfig(learning_rate=1e-2, weight_decay=0.05, lr_scheduler=scheduler,
                              lr_warmup_steps=warmup, max_train_steps=6)
    tcfg = TT.MVVDMTrainConfig(learning_rate=1e-2, weight_decay=0.05, lr_scheduler=scheduler,
                               lr_warmup_steps=warmup, max_train_steps=6)
    params = {"params": {k: {"kernel": jnp.asarray(v)} for k, v in init.items()}}
    tx = JT.make_optimizer(params, cfg)
    opt_state = tx.init(params)
    masters = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = TT.make_optimizer(masters, tcfg)
    for i, scale in enumerate((3.0, 0.05, 1.0)):
        grads = {k: (scale * rng.normal(size=s) / np.sqrt(37)).astype(np.float32)
                 for k, s in shapes.items()}
        jgrads = {"params": {k: {"kernel": jnp.asarray(v)} for k, v in grads.items()}}
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        norm = opt.step([torch.from_numpy(grads[k]) for k in masters])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-6)
        for k in masters:
            np.testing.assert_allclose(masters[k].numpy(),
                                       np.asarray(params["params"][k]["kernel"]),
                                       atol=1e-6, rtol=0, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("kw", [
    dict(lr_scheduler="constant"),
    dict(lr_scheduler="constant", lr_warmup_steps=10),
    dict(lr_scheduler="linear", lr_warmup_steps=10),
    dict(lr_scheduler="cosine", lr_warmup_steps=5),
    dict(lr_scheduler="cosine", scale_lr=True, gradient_accumulation_steps=2,
         lr_scale_factor=4.0),
], ids=["constant", "constant-warmup", "linear-warmup", "cosine-warmup", "cosine-scaled"])
def test_lr_schedule_matches_optax(kw):
    """The port's schedules (float64) against optax's (float32): rtol 1e-6,
    and atol 1e-7 of the peak rate for the cancellation in optax's f32
    cosine near the end of the decay."""
    jax_sched = JT.make_lr_schedule(JT.MVVDMTrainConfig(learning_rate=1e-3,
                                                        max_train_steps=110, **kw))
    port_sched = TT.make_lr_schedule(TT.MVVDMTrainConfig(learning_rate=1e-3,
                                                         max_train_steps=110, **kw))
    for count in (0, 1, 4, 5, 9, 10, 11, 60, 109, 110, 150, 300):
        np.testing.assert_allclose(port_sched(count), float(jax_sched(count)),
                                   rtol=1e-6, atol=1e-10, err_msg=f"count {count}")


def test_checkpointed_step_launch_structure(monkeypatch):
    """Which kernels a checkpointed train step launches, with kernel
    wrappers replaced by counting plain versions at tiny size (full
    resolution = the flash / packed level): every kernel site's forward runs
    twice (forward + recompute), the backward runs D only where an input
    needs it (the first cross-view attn1 sits before any trainable
    parameter; its I2V branch needs dq only) and E at every temporal site.
    chip_smoke.py asserts the full-width counts derived the same way."""
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import attention as A
    from animate3d_tpu_torch.ops import geglu as G
    from animate3d_tpu_torch.ops import routing

    counts = collections.Counter()

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    bwd = A.flash_attention_bwd

    def flash_bwd(q, k, v, out, lse, do, heads, scale, kv_group, need_dq, need_dkv):
        counts["flash_bwd_dq"] += need_dq
        counts["flash_bwd_dkv"] += need_dkv
        return bwd(q, k, v, out, lse, do, heads, scale, kv_group)

    hw = LAT * LAT

    def plan(batch, sq, sk, c, heads, self_attention, on_cuda):
        if self_attention and sq == 2 and batch >= N_VIEWS * hw:
            return "packed"  # temporal attention at full resolution
        return "flash" if sq == N_VIEWS * hw else "plain"

    monkeypatch.setattr(routing, "kernels_enabled", lambda device: True)
    monkeypatch.setattr(A, "attention_plan", plan)
    monkeypatch.setattr(A, "flash_attention_bwd", flash_bwd)
    for mod, name, counter in ((A, "flash_attention", "flash_fwd"),
                               (A, "packed_attention", "packed_attn"),
                               (A, "packed_attention_bwd", "packed_attn_bwd"),
                               (G, "geglu", "geglu")):
        monkeypatch.setattr(mod, name, counted(counter, getattr(mod, name)))
    monkeypatch.setattr(G, "geglu_plan", lambda *a: True)

    unet, *_ = build_models("tiny", N_VIEWS, "cpu", seed=0, train=True,
                            gradient_checkpointing=True)
    masters = TT.cast_frozen_bf16(unet, torch.float32)
    cfg = TT.MVVDMTrainConfig(num_views=N_VIEWS)
    rng = np.random.default_rng(2)
    batch = TT.TrainBatch(*(torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
                            ((N_VIEWS, 2, LAT, LAT, 4), (N_VIEWS, 77, 32), (N_VIEWS, 77, 32),
                             (N_VIEWS, 16), (N_VIEWS, 16))))
    TT.train_step(unet, TT.make_optimizer(masters, cfg), batch, cfg, DDIMScheduler(),
                  torch.Generator().manual_seed(0))
    # tiny: 5 spatial transformers and 5 motion modules at full resolution
    # (as at L0 of the full UNet), 17 feed-forwards in all
    assert dict(counts) == {"flash_fwd": 40, "flash_bwd_dq": 19, "flash_bwd_dkv": 18,
                            "packed_attn": 20, "packed_attn_bwd": 10, "geglu": 34}
