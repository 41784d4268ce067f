"""Ported protocols; each module self-registers with repro_torch.core.registry,
in the reference's order.

twopl registers nowait and waitdie; occ, mvcc, sundial and calvin register
themselves.
"""
from repro_torch.core.protocols import twopl  # noqa: F401  (registers nowait + waitdie)
from repro_torch.core.protocols import occ  # noqa: F401
from repro_torch.core.protocols import mvcc  # noqa: F401
from repro_torch.core.protocols import sundial  # noqa: F401
from repro_torch.core.protocols import calvin  # noqa: F401
