"""Host syncs a training step inside the port's spans (``utils/trace.py``'s
``host_sync`` counter; the loop's own read-back of the metrics, outside
them, left out)."""

from benchmark.program_counters import host_syncs_per_unit as read  # noqa: F401
