"""Port ops (animate3d_tpu_torch/ops) against the JAX Pallas kernels.

On the CPU each port wrapper takes its plain version; the JAX side runs
its Pallas kernel in interpret mode with lane-padded inputs, as
tests/test_attention.py does. Inputs come from numpy with a seed; both
sides run in float32 (JAX at "highest" matmul precision).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animate3d_tpu.ops import attention as JA
from animate3d_tpu.ops import geglu as JG
from animate3d_tpu_torch.ops import attention as TA
from animate3d_tpu_torch.ops import geglu as TG


def _merged_and_padded(rng, b, s, h, d):
    x = rng.normal(size=(b, s, h * d)).astype(np.float32)
    xp = np.pad(x.reshape(b, s, h, d), ((0, 0), (0, 0), (0, 0), (0, JA.DP - d)))
    return x, jnp.asarray(xp.reshape(b, s, h * JA.DP))


@pytest.mark.parametrize("b,s,h,d", [(2, 512, 2, 40), (1, 2048, 1, 40), (2, 512, 2, 160)])
def test_flash_plain_matches_pallas_kernel(b, s, h, d):
    # S=2048 is the TPU kernel's skip-max regime (Sk >= 2048, logits
    # clamped at 110 in base 2); on in-distribution inputs the clamp never
    # binds, so the port's exact online softmax agrees with it. Heads 160
    # wide take the TPU's unpadded kernel (multi_head_attention's route
    # at d >= 128), the others its lane-padded merged-head one.
    rng = np.random.default_rng(0)
    if d >= JA.DP:
        q, k, v = (rng.normal(size=(b, s, h * d)).astype(np.float32) for _ in range(3))
        with jax.default_matmul_precision("highest"):
            ref_o, ref_lse = JA._flash_attention_fwd_impl(
                _to_bhsd(q, h), _to_bhsd(k, h), _to_bhsd(v, h), d ** -0.5)
        ref, ref_lse = _to_merged(ref_o), np.asarray(ref_lse).reshape(b * h, s, -1)
    else:
        (q, qp), (k, kp), (v, vp) = (_merged_and_padded(rng, b, s, h, d) for _ in range(3))
        with jax.default_matmul_precision("highest"):
            ref_p, ref_lse = JA._flash_fwd_impl_merged(qp, kp, vp, h, d ** -0.5)
        ref = np.asarray(ref_p).reshape(b, s, h, JA.DP)[..., :d].reshape(b, s, h * d)
    scale = d ** -0.5
    out, lse = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), h, scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, s), np.asarray(ref_lse)[..., 0],
                               atol=3e-5, rtol=1e-4)


def test_flash_plain_kv_group_matches_broadcast():
    # the I2V branches' frame-0 K/V: query batch b reads K/V batch b // g
    rng = np.random.default_rng(1)
    g, h, d = 3, 2, 8
    q = torch.from_numpy(rng.normal(size=(2 * g, 64, h * d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 32, h * d)).astype(np.float32))
            for _ in range(2))
    out, lse = TA.flash_attention(q, k, v, h, 0.3, kv_group=g)
    ref, ref_lse = TA.flash_attention(q, k.repeat_interleave(g, 0),
                                      v.repeat_interleave(g, 0), h, 0.3)
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(lse, ref_lse)


def test_packed_plain_matches_pallas_kernel():
    # 16 frames, and one (S 1, which the TPU's packed kernel takes too: out is v)
    rng = np.random.default_rng(2)
    b, h, d = 16, 2, 40
    for s in (16, 1):
        (q, qp), (k, kp), (v, vp) = (_merged_and_padded(rng, b, s, h, d) for _ in range(3))
        scale = d ** -0.5
        with jax.default_matmul_precision("highest"):
            ref_p = JA.packed_temporal_flash_padded(qp, kp, vp, h, scale)
        ref = np.asarray(ref_p).reshape(b, s, h, JA.DP)[..., :d].reshape(b, s, h * d)
        out = TA.packed_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), h, scale)
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=1e-4, err_msg=f"S {s}")


def test_geglu_plain_matches_pallas_kernel():
    # the Pallas kernel's A&S 7.1.26 erf is within 1.5e-7 of the exact erf
    # the port uses; atol 1e-5 covers that gap after both products
    rng = np.random.default_rng(3)
    m, c, inner = 300, 64, 640
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, 2 * inner)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(2 * inner,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(inner, c)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JG._geglu_pallas(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                               jnp.float32, interpret=True)
    out = TG.geglu(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (x, w1.T, b1, w2.T, b2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# full-width attention sites of the main path (CFG batch: 2 x 4 views x 16
# frames) at 256^2, 512^2 and one at 1024^2, and of a 4-frame and a
# one-frame clip: (query batch, Sq, Sk, C, heads, self-attention, which
# padded JAX predicate the layer asks first). A site whose padded predicate declines falls through to
# JAX's multi_head_attention and its auto rule.
_SITES = [
    ("L0 cross-view attn1 / spatial branch", 32, 4096, 4096, 320, 8, True, "flash"),
    ("L1 cross-view attn1 / spatial branch", 32, 1024, 1024, 640, 8, True, "flash"),
    ("L1 i2v frame-0 K/V", 32, 1024, 1024, 640, 8, False, "flash"),
    ("L2 cross-view attn1", 32, 256, 256, 1280, 8, True, "flash"),
    ("L3 cross-view attn1 (mid)", 32, 64, 64, 1280, 8, True, "flash"),
    ("L0 text cross-attn", 128, 1024, 77, 320, 8, False, "flash"),
    ("L0 ip cross-attn", 128, 1024, 4, 320, 8, False, "flash"),
    ("L0 temporal", 8192, 16, 16, 320, 8, True, "packed"),
    ("L1 temporal", 2048, 16, 16, 640, 8, True, "packed"),
    ("L2 temporal", 512, 16, 16, 1280, 8, True, "packed"),
    ("L3 temporal", 128, 16, 16, 1280, 8, True, "packed"),
    ("L0 temporal, a 4-frame clip", 2048, 4, 4, 320, 8, True, "packed"),
    ("L0 temporal, a one-frame clip", 8192, 1, 1, 320, 8, True, "packed"),
    ("L2 temporal, a one-frame clip", 512, 1, 1, 1280, 8, True, "packed"),
    ("512 L0 cross-view attn1 / spatial branch", 32, 16384, 16384, 320, 8, True, "flash"),
    ("512 L0 i2v frame-0 K/V", 32, 16384, 16384, 320, 8, False, "flash"),
    ("512 L1 cross-view attn1 / spatial branch", 32, 4096, 4096, 640, 8, True, "flash"),
    ("512 L1 i2v frame-0 K/V", 32, 4096, 4096, 640, 8, False, "flash"),
    ("512 L2 cross-view attn1", 32, 1024, 1024, 1280, 8, True, "flash"),
    ("512 L2 spatial branch", 32, 1024, 1024, 1280, 8, True, "flash"),
    ("512 L2 i2v frame-0 K/V", 32, 1024, 1024, 1280, 8, False, "flash"),
    ("512 L3 cross-view attn1", 32, 256, 256, 1280, 8, True, "flash"),
    ("512 L0 text cross-attn", 128, 4096, 77, 320, 8, False, "flash"),
    ("512 L0 temporal", 32768, 16, 16, 320, 8, True, "packed"),
    ("512 L2 temporal", 2048, 16, 16, 1280, 8, True, "packed"),
    ("1024 L2 cross-view attn1 / spatial branch", 32, 4096, 4096, 1280, 8, True, "flash"),
]


def _jax_route(b, sq, sk, c, heads, self_attn, jax_pred, monkeypatch):
    """The JAX layer's route on the TPU, in the layer's own order: its
    padded predicate first, else ``multi_head_attention``'s auto rule, traced
    under ``jax.eval_shape`` (nothing is allocated at full shapes) with
    ``_flash_attention`` patched to record that the rule took it."""
    padded = (JA.padded_flash_plan(b, sq, sk, c, heads) if jax_pred == "flash"
              else self_attn and JA.padded_packed_plan(b, sq, c, heads))
    if padded:
        return jax_pred
    took = []

    def flash(q, k, v, scale):
        took.append(q.shape)
        return JA.attention_xla(q, k, v, scale)

    monkeypatch.setattr(JA, "_flash_attention", flash)
    spec = lambda s: jax.ShapeDtypeStruct((b, s, c), jnp.bfloat16)
    jax.eval_shape(lambda q, k, v: JA.multi_head_attention(q, k, v, heads),
                   spec(sq), spec(sk), spec(sk))
    return "flash" if took else "plain"


@pytest.mark.parametrize("site", _SITES, ids=[s[0] for s in _SITES])
def test_routing_matches_jax_predicates(site, monkeypatch):
    """The port's attention_plan on CUDA takes a kernel exactly where the
    JAX routing on the TPU takes its Pallas kernel, at every head width and
    resolution: the lane-padded plans below 128-wide heads, the unpadded
    flash kernel of multi_head_attention's auto rule at 160. Every site
    routed to "flash" has a head width kernels A and D take."""
    _, b, sq, sk, c, heads, self_attn, jax_pred = site
    monkeypatch.setattr(JA.jax, "default_backend", lambda: "tpu")
    jax_route = _jax_route(b, sq, sk, c, heads, self_attn, jax_pred, monkeypatch)
    plan = TA.attention_plan(b, sq, sk, c, heads, self_attn, on_cuda=True)
    assert plan == jax_route
    if plan == "flash":
        assert TA.flash_kernel_takes(c // heads), (c, heads)
    assert TA.attention_plan(b, sq, sk, c, heads, self_attn, on_cuda=False) == "plain"


def test_flash_plan_takes_160_wide_heads_at_512():
    # the L2 cross-view / spatial sites at 512^2: 1.07 GB of f32 logits
    assert TA.attention_plan(32, 1024, 1024, 1280, 8, True, on_cuda=True) == "flash"
    assert TA.attention_plan(32, 1024, 1024, 1280, 8, False, on_cuda=True) == "flash"


def test_flash_kernel_takes_the_sd15_head_widths():
    """Kernels A and D take 40-, 80- and 160-wide heads and nothing else, so
    a forced flash at another width raises on CUDA rather than going plain."""
    assert TA.FLASH_HEAD_DIMS == (40, 80, 160)
    for d in (40, 80, 160):
        assert TA.flash_kernel_takes(d)
    for d in (8, 32, 64, 96, 128, 144, 168, 256, 320):
        assert not TA.flash_kernel_takes(d), d


@pytest.mark.parametrize("kv_batches,sk,heads,kv_group,split", [
    (16, 4096, 8, 1, 1),   # train L0: 4096 CTAs, no split
    (1, 4096, 8, 16, 4),   # train L0 i2v: 256 key-tile CTAs -> 1024
    (1, 1024, 8, 16, 16),  # L2 i2v: 64 -> 1024, one query batch a CTA
    (2, 16384, 8, 16, 1),  # 512^2 L0 i2v: 2048 CTAs already
    (2, 197, 1, 2, 2),     # a ragged key tile, kv_group 2
])
def test_flash_bwd_split_fills_the_card(kv_batches, sk, heads, kv_group, split):
    """Kernel D splits a K/V batch's kv_group query batches over CTAs (a
    divisor of kv_group) until the grid has four CTAs an SM of 132."""
    got = TA.flash_bwd_split(kv_batches, sk, heads, kv_group)
    assert got == split and kv_group % got == 0


@pytest.mark.parametrize("m,c,inner", [(131072, 320, 1280), (32768, 640, 2560),
                                       (8192, 1280, 5120), (2048, 1280, 5120),
                                       (100, 320, 1280),
                                       # 512^2 sampling and the trainer's shapes
                                       (524288, 320, 1280), (131072, 640, 2560),
                                       (32768, 1280, 5120), (65536, 320, 1280),
                                       (16384, 640, 2560), (4096, 1280, 5120),
                                       (1024, 1280, 5120)])
def test_geglu_routing_matches_jax(m, c, inner):
    # JAX geglu_ff on the TPU: inner % 640 == 0 and at least 256 rows; where
    # the port routes to kernel C, the kernel takes the shape
    plan = TG.geglu_plan(m, c, inner)
    assert plan == (inner % JG._BI == 0 and m >= JG._BM)
    if plan:
        TG.check_kernel_shape(c, inner)


@pytest.mark.parametrize("c,inner", [(96, 1280), (320, 1000), (32, 64), (320, 0)])
def test_geglu_kernel_shape_rule_raises(c, inner):
    # kernel C takes C and I that are multiples of 64 and nothing else
    with pytest.raises(ValueError, match="multiples of 64"):
        TG.check_kernel_shape(c, inner)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8192 + 72, 100, 1])
def test_geglu_kernel_matches_plain_on_cuda(m):
    """Kernel C against its plain version at each SD1.5 width, at an I that
    is no multiple of 128 and at a C that is no multiple of 160 (the output
    launch's 128-column tiles), at a ragged M and at M under one tile
    (2^-6 of the largest output and 1e-2 relative L2), and the shape rule
    raising on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(m)

    def rnd(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for c, inner in ((320, 1280), (640, 2560), (1280, 5120), (64, 192), (384, 1536)):
        x = rnd((m, c), 1.0)
        w1, b1 = rnd((2 * inner, c), c ** -0.5), rnd((2 * inner,), 0.1)
        w2, b2 = rnd((c, inner), inner ** -0.5), rnd((c,), 0.1)
        out = TG.geglu(x, w1, b1, w2, b2).float()
        ref = TG._geglu_plain(x, w1, b1, w2, b2).float()
        assert (out - ref).abs().max() <= 2 ** -6 * ref.abs().max(), (c, inner)
        assert (out - ref).norm() <= 1e-2 * ref.norm(), (c, inner)
    with pytest.raises(ValueError, match="multiples of 64"):
        TG.geglu(rnd((m, 96), 1.0), rnd((384, 96), 0.1), rnd((384,), 0.1),
                 rnd((96, 192), 0.1), rnd((96,), 0.1))


def test_cpu_tensors_take_plain_path_without_building():
    # no kernel library is built or launched for CPU tensors
    from animate3d_tpu_torch.ops import _build

    _build.reset_launches()
    x = torch.randn(2, 16, 80)
    TA.multi_head_attention(x, x, x, 2, self_attention=True)
    TG.geglu_ff(torch.randn(300, 64), torch.randn(1280, 64), torch.randn(1280),
                torch.randn(64, 640), torch.randn(64))
    assert sum(_build.launch_totals().values()) == 0


def test_plain_ops_turns_kernels_off_in_its_scope():
    from animate3d_tpu_torch.ops import routing

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert routing.kernels_enabled(cuda) and not routing.kernels_enabled(cpu)
    with routing.plain_ops():
        assert not routing.kernels_enabled(cuda)
        with routing.plain_ops():
            pass
        assert not routing.kernels_enabled(cuda)
    assert routing.kernels_enabled(cuda)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """Each kernel against its plain version on the card (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def assert_agree(out, ref):
        # 2^-6 of the largest output (2-4 bf16 ulps there) and 1e-2 relative L2
        out, ref = out.float(), ref.float()
        assert (out - ref).abs().max() <= 2 ** -6 * ref.abs().max()
        assert (out - ref).norm() <= 1e-2 * ref.norm()

    # kernel A at each head width it takes, and at the I2V kv_group 16
    for b, c, kv_group in ((4, 320, 1), (4, 640, 1), (4, 1280, 1), (16, 320, 16)):
        d = c // 8
        q = rnd(b, 1024, c)
        k, v = rnd(b // kv_group, 1024, c), rnd(b // kv_group, 1024, c)
        out, lse = TA.flash_attention(q, k, v, 8, d ** -0.5, kv_group)
        ref, ref_lse = TA._flash_plain(q, k, v, 8, d ** -0.5, kv_group)
        assert_agree(out, ref)
        assert (lse - ref_lse).abs().max() < 1e-3
    q, k, v = rnd(512, 16, 640), rnd(512, 16, 640), rnd(512, 16, 640)
    out = TA.packed_attention(q, k, v, 8, 80 ** -0.5)
    ref = TA.packed_small_attention(q, k, v, 8, 80 ** -0.5)
    assert_agree(out, ref)
    x, w1, b1, w2, b2 = rnd(300, 320), rnd(2560, 320), rnd(2560), rnd(320, 1280), rnd(320)
    out, ref = TG.geglu(x, w1, b1, w2, b2), TG._geglu_plain(x, w1, b1, w2, b2)
    assert_agree(out, ref)


@pytest.mark.cuda
def test_packed_kernel_matches_plain_at_every_shape_it_takes_on_cuda():
    """Kernel B against its plain version at every (S, D) of
    ``packed_kernel_takes`` (S 32 at D 160 included), 8 heads, on a batch
    whose token count leaves a partial last tile at S < 16 (the zero-filled
    rows), and on strided token rows (a view of a wider tensor): within 2^-6
    of the largest output and 1e-2 relative L2 (bf16 P and output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for s in TA.PACKED_SEQ:
        for d in (40, 80, 160):
            assert TA.packed_kernel_takes(s, d)
            c = 8 * d
            wide = torch.randn((3, 37, s, c + 8), generator=gen, device="cuda").to(
                torch.bfloat16)
            q, k, v = (wide[i, :, :, :c] for i in range(3))
            out = TA.packed_attention(q, k, v, 8, d ** -0.5)
            ref = TA.packed_small_attention(q, k, v, 8, d ** -0.5)
            out, ref = out.float(), ref.float()
            assert (out - ref).abs().max() <= 2 ** -6 * ref.abs().max(), (s, d)
            assert (out - ref).norm() <= 1e-2 * ref.norm(), (s, d)


def _to_bhsd(x, h):
    b, s, c = x.shape
    return jnp.asarray(x.reshape(b, s, h, c // h).transpose(0, 2, 1, 3))


def _to_merged(x):
    b, h, s, d = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(b, s, h * d)


@pytest.mark.parametrize("d,kv_group", [(40, 1), (80, 1), (40, 2), (160, 1), (160, 2)])
def test_flash_bwd_plain_matches_pallas_vjp(d, kv_group):
    """The plain backward of kernel D against jax.vjp of _flash_attention,
    whose VJP runs the Pallas dq / dkv kernels (interpret mode), on JAX's
    own out and lse. With kv_group > 1 the JAX side attends to K/V repeated
    over the group, so its VJP sums dk / dv over the group. Sk = 512 (the
    kernels' K block), f32 at "highest" matmul precision; atol 1e-5 / rtol
    1e-4 covers f32 sums in another order and exp vs exp2."""
    rng = np.random.default_rng(10 + d + kv_group)
    b, s, h = 2, 512, 2
    q = rng.normal(size=(b, s, h * d)).astype(np.float32)
    k, v = (rng.normal(size=(b // kv_group, s, h * d)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, s, h * d)).astype(np.float32)
    scale = d ** -0.5

    def fwd(qj, kj, vj):
        rep = (lambda x: jnp.repeat(x, kv_group, axis=0)) if kv_group > 1 else (lambda x: x)
        return JA._flash_attention(qj, rep(kj), rep(vj), scale)

    with jax.default_matmul_precision("highest"):
        qj, kj, vj = _to_bhsd(q, h), _to_bhsd(k, h), _to_bhsd(v, h)
        kr, vr = (jnp.repeat(x, kv_group, axis=0) for x in (kj, vj))
        out, lse = JA._flash_attention_fwd_impl(qj, kr, vr, scale)
        _, vjp = jax.vjp(fwd, qj, kj, vj)
        ref = [_to_merged(x) for x in vjp(_to_bhsd(g, h))]
    got = TA._flash_bwd_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(_to_merged(out)),
                              torch.from_numpy(np.array(lse)), torch.from_numpy(g),
                              h, scale, kv_group)
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5, rtol=1e-4)


def test_packed_bwd_plain_matches_pallas_vjp():
    """The plain backward of kernel E against jax.vjp of
    packed_temporal_flash_padded (Pallas forward and backward kernels in
    interpret mode), heads lane-padded to 128 on the JAX side; f32 at
    "highest" precision, atol 1e-5 / rtol 1e-4; at S 16 and at S 1, where
    the plain dq and dk are exactly 0 (a one-token softmax is the constant
    1; JAX's hold the rounding of g v^T - Delta) and dv is g."""
    rng = np.random.default_rng(4)
    b, h, d = 16, 2, 40
    for s in (16, 1):
        (q, qp), (k, kp), (v, vp), (g, gp) = (_merged_and_padded(rng, b, s, h, d)
                                              for _ in range(4))
        scale = d ** -0.5
        with jax.default_matmul_precision("highest"):
            _, vjp = jax.vjp(lambda *a: JA.packed_temporal_flash_padded(*a, h, scale),
                             qp, kp, vp)
            ref = [np.asarray(x).reshape(b, s, h, JA.DP)[..., :d].reshape(b, s, h * d)
                   for x in vjp(gp)]
        got = TA._packed_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, g)), h, scale)
        for x, r in zip(got, ref):
            np.testing.assert_allclose(x.numpy(), r, atol=1e-5, rtol=1e-4, err_msg=f"S {s}")
    assert not got[0].any() and not got[1].any()
    assert torch.equal(got[2], torch.from_numpy(g))


def test_geglu_fn_grads_match_pallas_vjp():
    """GegluFn (kernel C's plain version forward, autograd of
    _geglu_reference backward) against jax.vjp of _geglu_fused (Pallas
    forward in interpret mode, XLA VJP of the reference); f32, atol 1e-5
    relative to each gradient's largest magnitude."""
    rng = np.random.default_rng(5)
    m, c, inner = 256, 64, 640
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, 2 * inner)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(2 * inner,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(inner, c)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    gy = rng.normal(size=(m, c)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: JG._geglu_fused(jnp.float32, *a),
                         *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
        ref = [np.asarray(r) for r in vjp(jnp.asarray(gy))]
    ref[1], ref[3] = ref[1].T, ref[3].T  # torch Linear layout
    args = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in (x, w1.T, b1, w2.T, b2)]
    y = TG.GegluFn.apply(*args)
    got = torch.autograd.grad(y, args, torch.from_numpy(gy))
    for x_, r in zip(got, ref):
        np.testing.assert_allclose(x_.numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("kv_group,need", [(1, "qkv"), (2, "qkv"), (2, "q")])
def test_flash_fn_plain_grads_match_autograd(kv_group, need):
    """FlashAttentionFn on its plain route (CPU) gives autograd's gradients
    of the plain attention, and only those its inputs need."""
    torch.manual_seed(0)
    b, h, d = 4, 2, 8
    q = torch.randn(b, 64, h * d, requires_grad=True)
    k = torch.randn(b // kv_group, 48, h * d, requires_grad="k" in need)
    v = torch.randn(b // kv_group, 48, h * d, requires_grad="v" in need)
    do = torch.randn(b, 64, h * d)
    out = TA.FlashAttentionFn.apply(q, k, v, h, 0.3, kv_group, False)
    kr, vr = (x.repeat_interleave(kv_group, 0) for x in (k, v))
    ref = TA._merge_heads(TA.attention_xla(*(TA._split_heads(x, h) for x in (q, kr, vr)), 0.3))
    wrt = [x for x in (q, k, v) if x.requires_grad]
    for x, r in zip(torch.autograd.grad(out, wrt, do), torch.autograd.grad(ref, wrt, do)):
        torch.testing.assert_close(x, r, atol=1e-5, rtol=1e-5)


def test_packed_fn_plain_grads_match_autograd():
    torch.manual_seed(1)
    q, k, v = (torch.randn(8, 16, 80, requires_grad=True) for _ in range(3))
    g = torch.randn(8, 16, 80)
    out = TA.PackedAttentionFn.apply(q, k, v, 2, 0.2, False)
    ref = TA._merge_heads(TA.attention_xla(*(TA._split_heads(x, 2) for x in (q, k, v)), 0.2))
    for x, r in zip(torch.autograd.grad(out, (q, k, v), g),
                    torch.autograd.grad(ref, (q, k, v), g)):
        torch.testing.assert_close(x, r, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_cuda():
    """Kernels D and E against their plain backward versions on the card
    (bf16; 2^-6 of the largest gradient and 1e-2 relative L2); E at every
    (S, D) of ``PACKED_SEQ`` x (40, 80, 160), a ragged batch included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def assert_agree(outs, refs):
        for out, ref in zip(outs, refs):
            out, ref = out.float(), ref.float()
            assert (out - ref).abs().max() <= 2 ** -6 * ref.abs().max()
            assert (out - ref).norm() <= 1e-2 * ref.norm()

    # kernel D at each head width it takes, and at kv_group 4 and 16 (the
    # I2V shape, whose query batches it splits over CTAs)
    for b, c, kv_group in ((4, 320, 1), (4, 320, 4), (4, 640, 1), (4, 1280, 1),
                           (16, 320, 16), (16, 1280, 16)):
        d = c // 8
        q = rnd(b, 1024, c)
        k, v = rnd(b // kv_group, 1024, c), rnd(b // kv_group, 1024, c)
        out, lse = TA.flash_attention(q, k, v, 8, d ** -0.5, kv_group)
        args = (q, k, v, out, lse, rnd(b, 1024, c), 8, d ** -0.5, kv_group)
        assert_agree(TA.flash_attention_bwd(*args), TA._flash_bwd_plain(*args))
    args = (rnd(512, 16, 640), rnd(512, 16, 640), rnd(512, 16, 640), rnd(512, 16, 640),
            8, 80 ** -0.5)
    assert_agree(TA.packed_attention_bwd(*args), TA._packed_bwd_plain(*args))
    # kernel E at every (S, D) it takes, S 32 x D 160 included, on a batch
    # that fills whole tiles and on a ragged one (the last 16-token tile
    # partial where S < 16); two launches bitwise equal (no atomics)
    for s in TA.PACKED_SEQ:
        for d in (40, 80, 160):
            for b in (512 // s, 37):
                args = tuple(rnd(b, s, 8 * d) for _ in range(4)) + (8, d ** -0.5)
                grads = TA.packed_attention_bwd(*args)
                assert_agree(grads, TA._packed_bwd_plain(*args))
                again = TA.packed_attention_bwd(*args)
                assert all(torch.equal(x, y) for x, y in zip(grads, again)), (s, d, b)
