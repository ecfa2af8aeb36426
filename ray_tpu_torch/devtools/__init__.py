"""Developer tooling that ships with the package but never runs on a
cluster hot path: the chaos harness (``devtools/chaos``) and raylint, the
static rules with their lock-order witness (``devtools/raylint``)."""
