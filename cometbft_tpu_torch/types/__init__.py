"""Core consensus types the commit-verification path needs (reference:
cometbft_tpu/types)."""
