"""One driver a configuration ``kind``: ``drivers/<kind>.py`` with
``run(ctx) -> Outcome``."""
