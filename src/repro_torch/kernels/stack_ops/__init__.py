"""K1 ``masked_push`` and K2 ``masked_peek``: per-lane stack traffic."""
