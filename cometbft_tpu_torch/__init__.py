"""PyTorch/CUDA port of the commit-verification plane of ``cometbft_tpu``.

The JAX package ``cometbft_tpu`` stays the reference; this package keeps
its own copies of the host modules it needs and hand-written CUDA kernels
for the device programs (``crypto/cuda/``). It imports ``torch`` and never
``jax``. Entry points run on ``torch.device("cuda")`` unless the caller
passes ``device="cpu"``, where each kernel wrapper runs its plain torch
version instead.
"""
