"""One reader a per-layer metric: ``metrics/<name>.py`` with ``read(run)``
returning the metric's value, or None where the run holds nothing for it."""
