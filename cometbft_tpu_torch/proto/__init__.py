"""Hand-rolled protobuf encoders for the tendermint proto surface the port
needs (reference: cometbft_tpu/proto)."""
