"""Host libraries (reference: cometbft_tpu/libs)."""
