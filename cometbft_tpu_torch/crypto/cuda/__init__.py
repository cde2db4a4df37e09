"""Device code of the port: hand-written CUDA kernels under ``csrc/``,
built by ``build.py`` and wrapped, each beside its plain torch version,
in ``ed25519_batch``, ``sha256`` and ``merkle`` (reference:
cometbft_tpu/crypto/tpu)."""
