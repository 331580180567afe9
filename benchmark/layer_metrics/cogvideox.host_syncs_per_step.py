"""Host syncs a DDIM step of CogVideoX image-to-video sampling (the
window's units) inside the port's spans: ``utils/trace.py``'s
``host_sync`` counter, a request's conditioning spread over its steps."""

from benchmark.program_counters import host_syncs_per_unit as read  # noqa: F401
