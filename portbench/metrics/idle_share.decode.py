"""Device idle percent of a traced stretch of decode-long's window (device trace)."""

from portbench.readers import idle_share as read  # noqa: F401
