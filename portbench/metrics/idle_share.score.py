"""Device idle percent of a traced stretch of the scoring actor's calls (device trace)."""

from portbench.readers import idle_share as read  # noqa: F401
