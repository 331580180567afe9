"""``sample.unet_graph_share`` and ``refine.unet_graph_share`` on synthetic
traces: None without a program span or without the UNet's graph counters,
replays / all UNet forwards in % otherwise."""

import pytest

from benchmark import harness

SPANS = {("span_calls", "mv_sampler.step"): 8}
METRICS = ["sample.unet_graph_share", "refine.unet_graph_share"]


def _trace(launches):
    return harness.TraceSummary(window_s=2.0, busy_s=1.5, kernels={}, launches=dict(launches),
                                units=8, config={})


@pytest.mark.parametrize("name", METRICS)
def test_none_without_spans(name):
    assert harness.read_layer_metric(name, _trace({("unet_graph", "replay"): 16})) is None


@pytest.mark.parametrize("name", METRICS)
def test_none_without_the_counters(name):
    counts = {**SPANS, ("flash_fwd", (32, 1024, 1024, 320, 1)): 30,
              ("vae_encode_chunk", "kept"): 8}
    assert harness.read_layer_metric(name, _trace(counts)) is None


@pytest.mark.parametrize("name", METRICS)
def test_replays_over_all_forwards(name):
    assert harness.read_layer_metric(
        name, _trace({**SPANS, ("unet_graph", "replay"): 16})) == 100.0
    counts = {**SPANS, ("unet_graph", "replay"): 6, ("unet_graph", "capture"): 1,
              ("unet_graph", "eager"): 1}
    assert harness.read_layer_metric(name, _trace(counts)) == 75.0
    assert harness.read_layer_metric(name, _trace({**SPANS, ("unet_graph", "eager"): 4})) == 0.0
