"""Share of the window's UNet forwards that replayed from a CUDA graph, in %
(``models/unet_graph.py``'s ``("unet_graph", "replay" | "capture" |
"eager")`` counters, one a forward); None where the window recorded no
program span or no forward counted."""

from benchmark.program_counters import spans_recorded


def read(t):
    if not spans_recorded(t):
        return None
    counts = {key: n for (name, key), n in t.launches.items() if name == "unet_graph"}
    forwards = sum(counts.values())
    if forwards <= 0:
        return None
    return 100.0 * counts.get("replay", 0) / forwards
