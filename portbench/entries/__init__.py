"""One module per way of driving the port: ``run(spec, seed=, seconds=,
trace=, t_start=) -> record``, the record holding ``attempted``,
``failed``, ``device``, ``checks`` and the ``ctx`` the metric readers
read."""
