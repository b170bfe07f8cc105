"""Training-side helpers the serving loop shares: the straggler policy."""
