"""Share of the SDS encode's chunks that kept their encoder activations for
the backward rather than recomputing them there, in %
(``pipelines/guidance.py``'s ``("vae_encode_chunk", "kept" | "recomputed")``
counters); None where the window recorded no program span or neither
counter moved."""

from benchmark.program_counters import spans_recorded


def read(t):
    if not spans_recorded(t):
        return None
    counts = {key: n for (name, key), n in t.launches.items() if name == "vae_encode_chunk"}
    kept, recomputed = counts.get("kept", 0), counts.get("recomputed", 0)
    if kept + recomputed <= 0:
        return None
    return 100.0 * kept / (kept + recomputed)
