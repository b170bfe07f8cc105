"""LM serving: the prefill and decode steps, and the autobatched
closed-loop generation engine."""
