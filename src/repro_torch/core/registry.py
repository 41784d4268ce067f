"""Protocol plugin registry (port of ``repro.core.registry``).

A protocol is one module plus one :func:`register_protocol` call; every
front-door surface picks it up by name.  The port registers nowait,
waitdie, occ, mvcc, sundial and calvin when ``repro_torch.core.protocols``
is imported; :func:`get_protocol` triggers that import lazily.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple


class Caps(NamedTuple):
    """Capability flags consumed by the planner (see ``repro.core.registry``)."""

    node_shardable: bool = True
    batch_node_shardable: bool = True
    deterministic: bool = False
    ro_commit: bool = False
    tick_driven: bool = True


class RunHooks(NamedTuple):
    """How the planner obtains metrics for one engine configuration:
    ``grid_run(entry, ec, cm, wl, *, ticks, warmup, ticks_active)`` and
    ``node_run(entry, ec, cm, wl, *, ticks, warmup, devices)``, each
    returning the ``engine.summarize`` metrics dict, every metric with a
    leading config axis (``ec.n_configs``)."""

    grid_run: Callable[..., Dict]
    node_run: Callable[..., Dict]


def _default_grid_run(entry: "ProtocolEntry", ec, cm, wl, *, ticks, warmup, ticks_active):
    from repro_torch.core.engine import run

    _, _, m = run(entry.tick, ec, cm, wl, ticks, warmup=warmup, ticks_active=ticks_active)
    return m


def _default_node_run(entry: "ProtocolEntry", ec, cm, wl, *, ticks, warmup, devices):
    from repro_torch.core.engine import run_sharded

    _, _, m = run_sharded(entry.tick, ec, cm, wl, ticks, warmup=warmup, devices=devices)
    return m


DEFAULT_HOOKS = RunHooks(grid_run=_default_grid_run, node_run=_default_node_run)


class ProtocolEntry(NamedTuple):
    """One registered protocol: everything the planner/engine needs by name."""

    name: str
    tick: Optional[Callable]
    stages: Tuple[str, ...]
    caps: Caps
    hooks: RunHooks
    variant: Mapping[str, Any]
    # key of the store layout, wire-cost and merge tables
    family: str = ""


_REGISTRY: Dict[str, ProtocolEntry] = {}


def register_protocol(
    name: str,
    *,
    tick: Optional[Callable] = None,
    stages: Tuple[str, ...] = (),
    hooks: Optional[RunHooks] = None,
    capabilities: Caps = Caps(),
    variant: Optional[Mapping[str, Any]] = None,
    family: Optional[str] = None,
    override: bool = False,
) -> ProtocolEntry:
    """Register a protocol under ``name``; returns the stored entry."""
    if not name or not isinstance(name, str):
        raise ValueError(f"register_protocol: protocol name must be a non-empty str, got {name!r}")
    if name in _REGISTRY and not override:
        raise ValueError(
            f"protocol {name!r} is already registered; pass "
            f"register_protocol({name!r}, ..., override=True) to replace it or "
            f"unregister_protocol({name!r}) first"
        )
    if capabilities.tick_driven and tick is None:
        raise ValueError(
            f"register_protocol({name!r}): tick-driven protocols need a compiled tick "
            "(rounds.make_tick over a StageSpec table)"
        )
    if not capabilities.tick_driven and hooks is None:
        raise ValueError(
            f"register_protocol({name!r}): Caps(tick_driven=False) protocols own their "
            "run loop — provide RunHooks(grid_run=..., node_run=...)"
        )
    entry = ProtocolEntry(
        name=name,
        tick=tick,
        stages=tuple(stages),
        caps=capabilities,
        hooks=hooks if hooks is not None else DEFAULT_HOOKS,
        variant=dict(variant or {}),
        family=family if family is not None else name,
    )
    _REGISTRY[name] = entry
    return entry


def unregister_protocol(name: str) -> None:
    """Remove a registered protocol (test/plugin hygiene)."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unregister_protocol: unknown protocol {name!r}; registered: {protocol_names()}")
    del _REGISTRY[name]


def _ensure_builtins() -> None:
    import repro_torch.core.protocols  # noqa: F401


def get_protocol(name: str) -> ProtocolEntry:
    """Look up a registered protocol by name (actionable KeyError if absent)."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown protocol {name!r}; registered protocols: {protocol_names()}. "
            "Add new ones via repro_torch.core.registry.register_protocol(name, tick=..., "
            "stages=..., capabilities=Caps(...))"
        ) from None


def protocol_names() -> Tuple[str, ...]:
    """Registered protocol names, in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY)


def protocol_family(name: str) -> str:
    """Runtime-profile key for ``name``; unregistered names resolve to themselves."""
    _ensure_builtins()
    entry = _REGISTRY.get(name)
    return entry.family if entry is not None else name


class ProtocolsView(Mapping):
    """Read-only live view of the registry, in registration order: the
    reference's legacy ``PROTOCOLS[name].tick`` (entries expose ``.tick``)."""

    def __getitem__(self, name: str) -> ProtocolEntry:
        return get_protocol(name)

    def __iter__(self):
        return iter(protocol_names())

    def __len__(self) -> int:
        _ensure_builtins()
        return len(_REGISTRY)

    def __contains__(self, name) -> bool:
        _ensure_builtins()
        return name in _REGISTRY

    def __repr__(self) -> str:
        return f"ProtocolsView({protocol_names()})"
