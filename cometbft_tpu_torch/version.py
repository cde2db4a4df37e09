"""Version constants.

Ported from cometbft_tpu/version.py.

Reference: version/version.go:6 (TMCoreSemVer = "0.34.28"). We track the
capability surface of that line; our own semver is independent.
"""

__version__ = "0.1.0"

# Capability-parity target line of the reference.
CMT_SEM_VER = "0.34.28"

# Protocol versions (reference: version/version.go + proto/tendermint/version).
BLOCK_PROTOCOL = 11
P2P_PROTOCOL = 8
ABCI_SEM_VER = "0.17.0"
