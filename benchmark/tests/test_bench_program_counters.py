"""The readers of the port's own counters (``benchmark/program_counters.py``
and the five ``layer_metrics`` files on it) on synthetic traces: None where
the window recorded no program span, counts per unit otherwise, kernel
launch keys ignored; and the kernel readers reading the same with the new
keys present."""

import pytest

from benchmark import harness

KERNELS = {("flash_fwd", (32, 4096, 4096, 320, 1)): 30, ("geglu", (131072, 320, 1280)): 20,
           ("flash_bwd_dq", (16, 4096, 4096, 320, 1)): 14,
           ("flash_bwd_dkv", (16, 4096, 4096, 320, 1)): 14,
           ("composite_coarse_fwd", (1024, 512, 4)): 4,
           ("composite_coarse_bwd", (1024, 512, 4)): 4}
PROGRAM = {("span_calls", "train_mvvdm.step"): 4, ("span_calls", "prefetcher.wait"): 4,
           ("span_ns", "train_mvvdm.step"): 4_000_000_000,
           ("span_ns", "prefetcher.wait"): 6_000_000,
           ("span_self_ns", "prefetcher.wait"): 6_000_000,
           ("host_sync", "master_adamw.clip"): 4, ("host_sync", "animate3d.step_batch"): 8,
           ("host_sync", "outside"): 40,
           ("weight_cast", "float32->bfloat16"): 8000, ("weight_cast", "bfloat16->float32"): 4}
READERS = ("recon.host_syncs_per_step", "sample.host_syncs_per_step",
           "train.host_syncs_per_step", "train.weight_casts_per_step", "train.loader_wait_ms")
WANT = {"recon.host_syncs_per_step": 3.0, "sample.host_syncs_per_step": 3.0,
        "train.host_syncs_per_step": 3.0, "train.weight_casts_per_step": 2001.0,
        "train.loader_wait_ms": 1.5}


def _trace(launches, units=4):
    kernels = {"flash_fwd_kernel": [0.2, 30], "geglu_gemm_kernel": [0.05, 40],
               "flash_bwd_kernel": [0.1, 14], "composite_coarse_fwd_kernel": [0.01, 4],
               "composite_coarse_bwd_kernel": [0.02, 4], "index_put_kernel": [0.3, 9]}
    return harness.TraceSummary(window_s=2.0, busy_s=1.5, kernels=kernels,
                                launches=dict(launches), units=units, config={},
                                counts={"heads": 8.0, "flops": 1e14})


@pytest.mark.parametrize("name", READERS)
def test_none_without_program_spans(name):
    assert harness.read_layer_metric(name, _trace(KERNELS)) is None
    # counters without a closed span (a tracer that never turned on) read None too
    no_spans = {k: n for k, n in PROGRAM.items() if k[0] != "span_calls"}
    assert harness.read_layer_metric(name, _trace({**KERNELS, **no_spans})) is None
    assert harness.read_layer_metric(name, _trace({**KERNELS, **PROGRAM}, units=0)) is None


@pytest.mark.parametrize("name", READERS)
def test_counts_per_unit_ignoring_kernel_keys(name):
    got = harness.read_layer_metric(name, _trace({**KERNELS, **PROGRAM}))
    assert got == pytest.approx(WANT[name])
    alone = harness.read_layer_metric(name, _trace(PROGRAM))
    assert alone == got
    # a window with spans and none of the metric's counter reads 0, not None
    spans = {k: n for k, n in PROGRAM.items() if k[0] == "span_calls"}
    assert harness.read_layer_metric(name, _trace(spans)) == 0.0


@pytest.mark.parametrize("name", ["sample.flash_fwd_roofline", "sample.geglu_roofline",
                                  "train.flash_bwd_roofline",
                                  "recon.composite_coarse_roofline", "recon.kplanes_share",
                                  "train.mfu", "train.device_idle_share"])
def test_kernel_readers_read_the_same_beside_the_program_counters(name):
    plain = harness.read_layer_metric(name, _trace(KERNELS))
    assert plain is not None and plain > 0
    assert harness.read_layer_metric(name, _trace({**KERNELS, **PROGRAM})) == plain
