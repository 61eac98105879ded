"""Per-layer metrics: one reader a file, named as the metric, each with a
``read(ctx)`` that returns the metric's value or None where the run has
nothing for it to read; ``_roofline`` and ``_trace`` hold the arithmetic
they share."""
