"""State/execution metrics.

Ported from cometbft_tpu/state/metrics.py.

Reference: state/metrics.go — block processing time histogram
(fed from execBlockOnProxyApp, state/execution.go:144).
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.libs.metrics import Registry

SUBSYSTEM = "state"


class Metrics:
    def __init__(self, registry: Optional[Registry] = None):
        r = registry if registry is not None else Registry()
        self.block_processing_time = r.histogram(
            SUBSYSTEM, "block_processing_time",
            "Time spent processing a block through ABCI, in seconds.",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5),
        )

    @classmethod
    def nop(cls) -> "Metrics":
        return cls(None)
