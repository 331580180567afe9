"""``recon.kplanes_kernel_share`` on synthetic traces: None where no kernel
of the K-planes sampler ran (the gathers of a program without it count
for nothing), its kernels' share of the busy time in % otherwise."""

import pytest

from benchmark import harness

NAME = "recon.kplanes_kernel_share"
OTHERS = {"void_at::native::index_elementwise_kernel_128__4__at::native": (0.4, 100),
          "void__anonymous_namespace_::indexing_backward_kernel_small_strid": (1.2, 100),
          "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_war": (0.6, 300)}
KERNEL_I = {"void__anonymous_namespace_::kplanes_fwd_kernel_Geom__float_const": (0.02, 100),
            "void__anonymous_namespace_::kplanes_bwd_kernel_Geom__float_const_": (0.05, 100),
            "void__anonymous_namespace_::kplanes_pack_kernel_Geom__Sources__fl": (0.002, 100),
            "void__anonymous_namespace_::kplanes_unpack_kernel_Geom__float_con": (0.003, 100)}


def _trace(kernels):
    return harness.TraceSummary(window_s=4.0, busy_s=2.5, kernels=dict(kernels), launches={},
                                units=100, config={})


def test_none_without_the_kernel():
    assert harness.read_layer_metric(NAME, _trace({})) is None
    assert harness.read_layer_metric(NAME, _trace(OTHERS)) is None


def test_share_of_busy_time_in_its_kernels():
    got = harness.read_layer_metric(NAME, _trace({**OTHERS, **KERNEL_I}))
    assert got == pytest.approx(100.0 * 0.075 / 2.5)
