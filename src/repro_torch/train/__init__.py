"""Training: AdamW, the train step, the deterministic data stream,
checkpoints and the restart loop (the straggler policy is shared with
serving)."""
