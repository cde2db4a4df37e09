"""Light-client header verification (reference: cometbft_tpu/light): the
pure verifier and its errors. The bisection client, providers and
detector are not ported yet."""
