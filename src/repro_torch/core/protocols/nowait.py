"""NOWAIT (paper §4.2): registry variant of twopl (abort on any conflict).
Import shim only; ``repro_torch.core.protocols.twopl`` registers it."""
from repro_torch.core.protocols.twopl import NOWAIT as _entry
from repro_torch.core.protocols.twopl import STAGES_USED  # noqa: F401

tick = _entry.tick
