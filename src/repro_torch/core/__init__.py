"""Autobatching core on PyTorch: the Fig-2 IR and its builder, analyses,
lowering with the paper's five optimizations, fusion and DCE passes, the
unbatched oracle, and the program-counter VM (Algorithm 2) behind
:func:`batching.autobatch`."""
