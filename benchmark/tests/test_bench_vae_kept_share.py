"""``refine.vae_kept_share`` on synthetic traces: None without the
encode's counters or without a program span, kept / (kept + recomputed)
in % otherwise."""

from benchmark import harness

SPANS = {("span_calls", "animate3d.step"): 8}


def _trace(launches):
    return harness.TraceSummary(window_s=2.0, busy_s=1.5, kernels={}, launches=dict(launches),
                                units=8, config={})


def test_none_without_the_counters_or_spans():
    assert harness.read_layer_metric("refine.vae_kept_share", _trace(SPANS)) is None
    counts = {("vae_encode_chunk", "kept"): 6, ("vae_encode_chunk", "recomputed"): 2}
    assert harness.read_layer_metric("refine.vae_kept_share", _trace(counts)) is None


def test_kept_over_all_chunks():
    counts = {("vae_encode_chunk", "kept"): 6, ("vae_encode_chunk", "recomputed"): 2,
              ("flash_fwd", (32, 4096, 4096, 320, 1)): 30}
    assert harness.read_layer_metric("refine.vae_kept_share", _trace({**SPANS, **counts})) == 75.0
    assert harness.read_layer_metric(
        "refine.vae_kept_share", _trace({**SPANS, ("vae_encode_chunk", "recomputed"): 8})) == 0.0
