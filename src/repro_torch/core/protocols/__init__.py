"""Ported protocols; each module self-registers with repro_torch.core.registry,
in the reference's order.

twopl registers nowait and waitdie; occ, mvcc, sundial and calvin register
themselves.  ``PROTOCOLS`` is the reference's read-only live view of the
registry for legacy callers (``PROTOCOLS[name].tick``); new code calls
:func:`repro_torch.core.registry.get_protocol`.
"""
from repro_torch.core import registry as _registry
from repro_torch.core.protocols import twopl  # noqa: F401  (registers nowait + waitdie)
from repro_torch.core.protocols import occ  # noqa: F401
from repro_torch.core.protocols import mvcc  # noqa: F401
from repro_torch.core.protocols import sundial  # noqa: F401
from repro_torch.core.protocols import calvin  # noqa: F401

PROTOCOLS = _registry.ProtocolsView()
