"""WAITDIE (paper §4.3): registry variant of twopl (older waits, younger
dies).  Import shim only; ``repro_torch.core.protocols.twopl`` registers it."""
from repro_torch.core.protocols.twopl import WAITDIE as _entry
from repro_torch.core.protocols.twopl import STAGES_USED  # noqa: F401

tick = _entry.tick
