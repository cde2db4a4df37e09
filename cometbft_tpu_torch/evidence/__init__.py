"""Verification of validator misbehaviour (reference:
cometbft_tpu/evidence/verify.py). The pool and reactor are not ported
yet."""
