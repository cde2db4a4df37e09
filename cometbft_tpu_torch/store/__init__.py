"""store — the block store.

Ported from cometbft_tpu/store/__init__.py.
"""

from cometbft_tpu_torch.store.block_store import BlockStore  # noqa: F401
