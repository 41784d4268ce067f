"""Ported protocols; each module self-registers with repro_torch.core.registry.

Only the 2PL family is ported (twopl registers nowait and waitdie); occ,
mvcc, sundial and calvin are ROADMAP A.6/A.7.
"""
from repro_torch.core.protocols import twopl  # noqa: F401  (registers nowait + waitdie)
