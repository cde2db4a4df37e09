"""ABCI: message types, the Application interface, clients and the kvstore app (reference: cometbft_tpu/abci)."""
