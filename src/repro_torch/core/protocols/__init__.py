"""Ported protocols; each module self-registers with repro_torch.core.registry.

twopl registers nowait and waitdie; occ, mvcc and sundial register
themselves.  calvin is ROADMAP A.7.
"""
from repro_torch.core.protocols import twopl  # noqa: F401  (registers nowait + waitdie)
from repro_torch.core.protocols import occ  # noqa: F401
from repro_torch.core.protocols import mvcc  # noqa: F401
from repro_torch.core.protocols import sundial  # noqa: F401
