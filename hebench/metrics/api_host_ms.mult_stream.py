"""api_host_ms.mult_stream: mean host time for an operation's public calls to
return (their enqueue), on the host clock, no synchronise."""

from hebench.readers import api_host_ms as read  # noqa: F401
