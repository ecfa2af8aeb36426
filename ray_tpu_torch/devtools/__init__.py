"""Developer tooling that ships with the package but never runs on a
cluster hot path: the chaos harness (``devtools/chaos``)."""
