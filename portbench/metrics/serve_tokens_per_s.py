"""Generated tokens handed to the clients' requests, per second between two
of the engine's deliveries (host clock)."""

from portbench.readers import serve_tokens_per_s as read  # noqa: F401
