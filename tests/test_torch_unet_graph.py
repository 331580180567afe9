"""The MV-VDM UNet's CUDA-graph replay (``models/unet_graph.py``): when it
engages, what its key holds, how the cache warms, captures, replays and
drops graphs, and how a replay counts its kernel launches; on the card, a
replayed forward equals the eager one bit for bit and counts the same
launches, and the guidance's UNet call replays. Imports nothing of JAX, so
it runs on a card's host too:
``python3 -m pytest tests/test_torch_unet_graph.py -q --noconftest -m cuda``."""

import collections
import types

import pytest
import torch

from animate3d_tpu_torch.models import unet_graph as G
from animate3d_tpu_torch.models.factory import init_params
from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
from animate3d_tpu_torch.ops import _build, routing
from animate3d_tpu_torch.ops.attention import attention_backend, sp_ring
from animate3d_tpu_torch.utils import trace

ON_CUDA = types.SimpleNamespace(is_cuda=True)


def _inputs(device="cpu", bn=4, f=2, size=8, cfg=None, t_shape=()):
    cfg = cfg or MVUNetConfig.tiny(num_views=4)
    g = torch.Generator(device=device).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=device)
    t = torch.full(t_shape, 517, dtype=torch.int64, device=device)
    return (rnd(bn, f, size, size, 4), t, rnd(bn, 77, cfg.cross_attention_dim),
            rnd(bn, 16), rnd(bn, cfg.image_embed_dim))


def _graph_counts(fn):
    """``fn()`` inside a profiler session; the ``unet_graph`` counters'
    change over it."""
    before = trace.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, {k[1]: n for k, n in trace.changes(before).items() if k[0] == "unet_graph"}


# -- when a forward replays -------------------------------------------------------------

def test_engages_only_without_grad_in_eval_on_cuda():
    """Replay needs a CUDA input, no gradient, eval mode and no ring
    attention in scope; the CPU never engages."""
    with torch.no_grad():
        assert G.engages(ON_CUDA, training=False)
        assert not G.engages(ON_CUDA, training=True)
        assert not G.engages(torch.zeros(1), training=False)
        with sp_ring(object()):
            assert not G.engages(ON_CUDA, training=False)
    assert not G.engages(ON_CUDA, training=False)  # gradients on
    with torch.inference_mode():
        assert G.engages(ON_CUDA, training=False)


def test_cpu_forward_runs_eagerly_and_counts_it():
    """On the CPU the forward without gradients is the eager one: no graph
    kept, one ``("unet_graph", "eager")`` a forward while tracing, the same
    output as with gradients on."""
    torch.manual_seed(0)
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=4)).eval().requires_grad_(False)
    init_params(unet, 0)
    args = _inputs()
    with torch.no_grad():
        out, counts = _graph_counts(lambda: unet(*args))
    assert counts == {"eager": 1} and not unet._graphs._entries
    torch.testing.assert_close(out, unet(*args), rtol=0, atol=0)


# -- the key ------------------------------------------------------------------------------

def _key(tensors, i2v=False, compute_dtype=None):
    return G.call_key(tensors, i2v, compute_dtype)


def _half(t):
    return t.to(torch.bfloat16)


CHANGES = {
    "latents shape": lambda a: ((a[0][:, :1],) + a[1:], {}),
    "latents dtype": lambda a: ((_half(a[0]),) + a[1:], {}),
    "timesteps shape": lambda a: ((a[0], a[1].expand(4)) + a[2:], {}),
    "timesteps dtype": lambda a: ((a[0], a[1].int()) + a[2:], {}),
    "context shape": lambda a: (a[:2] + (a[2][:, :5],) + a[3:], {}),
    "camera absent": lambda a: (a[:3] + (None, a[4]), {}),
    "image embeds absent": lambda a: (a[:4] + (None,), {}),
    "image embeds dtype": lambda a: (a[:4] + (_half(a[4]),), {}),
    "i2v_cond_time_zero": lambda a: (a, {"i2v": True}),
    "compute dtype": lambda a: (a, {"compute_dtype": torch.bfloat16}),
}


@pytest.mark.parametrize("field", sorted(CHANGES))
def test_each_call_field_changes_the_key(field):
    args = _inputs()
    tensors, kw = CHANGES[field](args)
    assert _key(tensors, **kw) != _key(args)
    assert _key(args) == _key(tuple(t.clone() for t in args))  # values do not enter


@pytest.mark.parametrize("scope", ["attention backend", "plain ops", "inference mode"])
def test_each_scope_changes_the_key(scope):
    args = _inputs()
    ctx = {"attention backend": lambda: attention_backend("flash"),
           "plain ops": routing.plain_ops, "inference mode": torch.inference_mode}[scope]
    with ctx():
        inside = _key(args)
    assert inside != _key(args)


def test_replaced_weights_change_the_weights_key_and_in_place_updates_do_not():
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=4)).eval()
    slots = G.tensor_slots(unet)
    assert len(slots) == len(list(unet.parameters())) + len(list(unet.buffers()))
    base = G.weights_key(slots)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(0.5)
        unet.load_state_dict({k: v.clone() for k, v in unet.state_dict().items()})
    assert G.weights_key(slots) == base
    unet.conv_in.weight.data = unet.conv_in.weight.data.clone()
    after_data = G.weights_key(slots)
    assert after_data != base
    unet.conv_out.bias = torch.nn.Parameter(unet.conv_out.bias.detach().clone())
    assert G.weights_key(slots) != after_data
    before_cast = G.weights_key(slots)
    unet.to(torch.float64)
    assert G.weights_key(slots) != before_cast


# -- launch bookkeeping -------------------------------------------------------------------

def test_a_replay_adds_exactly_the_captures_launches():
    """Only the kernel-launch counters enter a capture's change (spans,
    syncs, casts and the graph counter do not, nor counters that did not
    move); N replays, each adding that change, count what N eager forwards
    count."""
    before = {("flash_fwd", (8, 1024, 1024, 320, 1)): 3, ("span_calls", "unet.forward"): 2,
              ("geglu", (8192, 320, 1280)): 1}
    forward = {("flash_fwd", (8, 1024, 1024, 320, 1)): 4, ("geglu", (8192, 320, 1280)): 2,
               ("packed_attn", (512, 16, 320)): 2}
    after = dict(before)
    for k, n in forward.items():
        after[k] = after.get(k, 0) + n
    after.update({("span_calls", "unet.forward"): 3, ("host_sync", "mv_sampler.step"): 1,
                  ("weight_cast", "float32->bfloat16"): 5, ("unet_graph", "capture"): 1,
                  ("kplanes_fwd", (16, 20000, 2)): 0})
    changes = G.launch_changes(before, after)
    assert changes == forward
    eager, replayed = collections.Counter(), collections.Counter()
    for _ in range(5):
        eager.update(forward)  # each eager forward's wrappers count their launches
        replayed.update(changes)
    assert replayed == eager


# -- the cache's bookkeeping, with a stand-in for the CUDA graph -----------------------

class _Replay:
    """Stands in for a captured graph: recomputes the stand-in forward's
    arithmetic into the static output, without its Python (so without
    counting launches)."""

    def __init__(self, inputs, out):
        self.inputs, self.out = inputs, out

    def replay(self):
        x, t = self.inputs
        self.out.copy_(2 * x + t)


class _CpuCache(G.GraphCache):
    def _warm_up(self, fn, tensors):
        return fn(*tensors)

    def _record(self, fn, inputs):
        out = fn(*inputs)
        return _Replay(inputs, out), out


LAUNCH = ("geglu", (1, 64, 64))


def _forward(x, t):
    """A stand-in forward whose wrapper counts one launch of C."""
    _build.LAUNCHES[LAUNCH] += 1
    return 2 * x + t


def test_cache_warms_captures_then_replays_each_key():
    cache, x, t = _CpuCache(), torch.arange(4.0), torch.tensor(1.0)
    before = _build.LAUNCHES[LAUNCH]
    steps, outs = [], []
    for i in range(5):
        xi = x + i
        out, counts = _graph_counts(lambda: cache.run(("k",), (1,), _forward, (xi, t)))
        steps.append(counts)
        outs.append(out)
        torch.testing.assert_close(out, 2 * xi + t, rtol=0, atol=0)
    assert steps == [{"eager": 1}, {"capture": 1}, {"replay": 1}, {"replay": 1}, {"replay": 1}]
    assert _build.LAUNCHES[LAUNCH] - before == 5  # one a forward, replays included
    entry = cache._entries[("k",)]
    assert all(o.data_ptr() != entry.output.data_ptr() for o in outs)  # callers get clones
    torch.testing.assert_close(outs[2], 2 * (x + 2) + t, rtol=0, atol=0)  # kept as returned


def test_cache_keeps_the_most_recent_keys_and_drops_all_on_new_weights():
    cache, t = _CpuCache(), torch.tensor(0.0)
    for n in range(1, G.MAX_GRAPHS + 2):
        cache.run((n,), (1,), _forward, (torch.ones(n), t))
    assert len(cache._entries) == G.MAX_GRAPHS and (1,) not in cache._entries
    cache.run((2,), (1,), _forward, (torch.ones(2), t))  # used: now the most recent
    cache.run((G.MAX_GRAPHS + 2,), (1,), _forward, (torch.ones(1), t))
    assert (2,) in cache._entries and (3,) not in cache._entries
    _, counts = _graph_counts(lambda: cache.run((2,), (2,), _forward, (torch.ones(2), t)))
    assert counts == {"eager": 1} and list(cache._entries) == [(2,)]


# -- on the card ----------------------------------------------------------------------------

def _cuda_unet():
    """A two-level UNet at the widths kernels A, B and C take (320 and 640
    channels, 8 heads of 40 and 80), bf16, seeded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = MVUNetConfig.tiny(num_views=4, block_out_channels=(320, 640), num_heads=8,
                            motion_num_heads=8, layers_per_block=1)
    with torch.device("cuda"):
        unet = MVMotionUNet(cfg)
    init_params(unet, 0)
    return unet.to(torch.bfloat16).eval().requires_grad_(False), cfg


# two keys: one timestep for the batch (sampling), one a row (the SDS guidance)
KEYS = [((), "auto"), ((8,), "flash")]


@pytest.mark.cuda
def test_replay_equals_eager_bitwise_on_cuda():
    """Over several timesteps at two keys, each call (warm-up, capture,
    replays) equals the eager forward bit for bit; the keys' graphs live
    side by side."""
    unet, cfg = _cuda_unet()
    for t_shape, backend in KEYS:
        lat, t, ctx, cam, img = _inputs("cuda", bn=8, f=4, size=32, cfg=cfg, t_shape=t_shape)
        with attention_backend(backend):
            for i, step in enumerate((981, 741, 501, 261, 21)):
                ts = torch.full_like(t, step)
                x = lat * (1.0 + 0.1 * i)
                with torch.no_grad():
                    got = unet(x, ts, ctx, cam, img)
                with torch.enable_grad():
                    want = unet(x, ts, ctx, cam, img)
                assert torch.equal(got, want), (t_shape, backend, step)
    assert len(unet._graphs._entries) == 2
    assert all(e.graph is not None for e in unet._graphs._entries.values())


@pytest.mark.cuda
def test_replays_count_the_launches_of_eager_forwards_on_cuda():
    unet, cfg = _cuda_unet()
    args = _inputs("cuda", bn=8, f=4, size=32, cfg=cfg)
    n = 3
    with attention_backend("flash"):
        with torch.no_grad():
            for _ in range(2):  # warm-up and capture
                unet(*args)
            before = dict(_build.LAUNCHES)
            for _ in range(n):
                unet(*args)
            replayed = G.launch_changes(before, dict(_build.LAUNCHES))
        before = dict(_build.LAUNCHES)
        with torch.enable_grad():
            for _ in range(n):
                unet(*args)
        eager = G.launch_changes(before, dict(_build.LAUNCHES))
    assert replayed == eager
    totals = {name: sum(c for (k, _), c in eager.items() if k == name) for name in _build.COUNTERS}
    assert totals["flash_fwd"] > 0 and totals["geglu"] > 0 and totals["packed_attn"] > 0


@pytest.mark.cuda
def test_guidance_unet_apply_replays_on_cuda():
    """The SDS guidance's UNet call, made without gradients inside the
    loss's grad-enabled scope as ``AnimateMVGuidance.loss`` makes it,
    replays from its third call on and returns the eager output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from animate3d_tpu_torch.pipelines.guidance import build_guidance_from_config
    from animate3d_tpu_torch.systems.animate3d import Animate3DConfig

    guidance, _ = build_guidance_from_config({"guidance": {"model_size": "tiny"}},
                                             Animate3DConfig(n_view=4, n_frame=4), "cuda")
    unet = guidance.modules[0]
    lat, t, ctx, cam, img = _inputs("cuda", bn=8, f=4, size=8, cfg=unet.config, t_shape=(8,))
    seen = []
    with torch.enable_grad():
        for _ in range(3):
            out, counts = _graph_counts(lambda: guidance.unet_apply(lat, t, ctx, cam, img))
            seen.append(counts)
        with attention_backend("flash"):
            want = unet(lat, t, ctx, cam, img)
    assert seen == [{"eager": 1}, {"capture": 1}, {"replay": 1}]
    assert torch.equal(out, want)
