"""Host syncs an Euler step of image-to-video sampling (the window's units)
inside the port's spans: ``utils/trace.py``'s ``host_sync`` counter, the
request's conditioning and decode spread over its steps."""

from benchmark.program_counters import host_syncs_per_unit as read  # noqa: F401
