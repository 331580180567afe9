"""Host syncs a recon step inside the port's spans (``.item()``, blocking
copies, ``nonzero``, explicit synchronises: ``utils/trace.py``'s
``host_sync`` counter, by innermost span)."""

from benchmark.program_counters import host_syncs_per_unit as read  # noqa: F401
