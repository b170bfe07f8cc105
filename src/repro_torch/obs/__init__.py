"""Observability: the metrics registry the serving engine fills."""
