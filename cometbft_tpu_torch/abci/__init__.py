"""ABCI types that the port's evidence needs (reference: cometbft_tpu/abci)."""
