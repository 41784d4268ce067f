"""Declarative stage-graph runtime (port of ``repro.core.rounds``).

A protocol is a table of :class:`StageSpec` rows and :func:`make_tick`
compiles the table into the engine's per-tick function.  The full round
lifecycle

    want-mask -> service_ops -> effect hook -> account_round
              -> served bookkeeping -> stage transition

lives in :func:`run_stage_round`, once.  Cross-stage doorbell merging
(paper §4.2) is a pass over the same tables: when a stage declares
``fuse_next`` and the merge predicate holds (both stages coded one-sided,
doorbell batching on, ``EngineConfig.merge_stages`` set), completed
transactions skip the intermediate stage and its wire bytes ride the
absorbing stage's doorbell.

A stage's primitive is one Python int when every config of the run codes
it alike, and then the predicates on it are Python bools, as in a run of
one config; where the run's configs differ they are (G·N,) tensors
(``engine.stage_is_rpc``).  Predicates on state are tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine as eng
from repro_torch.core.costmodel import (
    ST_COMMIT,
    ST_LOG,
    ST_VALIDATE,
    CostModel,
    wire_cost,
)

FRESH = -1  # st["stage"] sentinel: slot regenerates a new txn next tick

# StageSpec.kind values
ROUND = "round"  # serviced network round (lock/fetch/validate/commit/release)
LOG = "log"  # fire-and-forget replicated log round (no service arbitration)
EXEC = "exec"  # local execution phase (no network)


class StageOut(NamedTuple):
    """What an effect hook hands back to :func:`run_stage_round`: ``fail`` (N,) txns
    aborting out of this stage, ``served_acc`` overriding what accumulates
    into ``st["served"]``, ``outstanding`` overriding the completion check."""

    st: Dict
    store: Dict
    fail: Optional[torch.Tensor] = None
    served_acc: Optional[torch.Tensor] = None
    outstanding: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class StageSpec:
    """One row of a protocol's stage table (see ``repro.core.rounds``)."""

    stage: int
    canon: int
    kind: str = ROUND
    ops: Optional[Callable] = None
    effect: Optional[Callable] = None
    next_stage: int = FRESH
    done: str = "advance"
    retry_stage: Optional[int] = None  # fail: restart stage (no locks held)
    abrel_stage: Optional[int] = None  # fail: abort-release stage (locks held)
    new_ts: bool = False  # retry with a fresh (larger) timestamp
    start_exec: bool = False  # completion enters the execution phase
    salt_off: int = 0  # service_ops salt offset (pins arbitration RNG draws)
    ro_commit: bool = False  # read-only txns commit on completing this stage
    fuse_next: Optional[int] = None  # next_stage when doorbell merging fires
    fuse_absorbs: Optional[int] = None  # canon id whose bytes ride this doorbell


# ---------------------------------------------------------------------------
# Cross-stage doorbell merging (§4.2): the fusable-pair merge table
# ---------------------------------------------------------------------------

# Protocol family -> ordered (absorber, absorbed) canonical stage pairs; the
# FIRST firing pair for an absorbed stage claims it.
MERGE_TABLE: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "default": ((ST_COMMIT, ST_LOG),),
    "occ": ((ST_VALIDATE, ST_LOG), (ST_COMMIT, ST_LOG)),
}


def merge_pairs(protocol: str) -> Tuple[Tuple[int, int], ...]:
    from repro_torch.core.registry import protocol_family

    return MERGE_TABLE.get(protocol_family(protocol), MERGE_TABLE["default"])


def _and(a, b):
    """``a & b`` of Python bools or bool tensors (no tensor for two bools)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a & b
    return a and b


def _or(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a | b
    return a or b


def _not(a):
    return ~a if isinstance(a, torch.Tensor) else not a


def _pair_on(ec: eng.EngineConfig, absorber: int, absorbed: int):
    """Raw pair predicate (ignoring precedence); off unless ``merge_stages``.
    A Python bool, or (G·N,) bool where the run's configs differ."""
    if not (ec.merge_stages and ec.doorbell):
        return False
    return _and(_not(eng.stage_is_rpc(ec, absorber)), _not(eng.stage_is_rpc(ec, absorbed)))


def log_rides(ec: eng.EngineConfig, st: Dict):
    """Which doorbell carries each txn's LOG bytes: ``(absorbed, by_v, by_c)``.

    Each is a Python bool (same for every txn) or an (G·N,) bool tensor:
    the VALIDATE→LOG pair only carries txns that post a validate round (a
    non-empty read set); the others fall through to COMMIT.
    """
    by_v = False
    by_c = False
    for a, b in merge_pairs(ec.protocol):
        if b != ST_LOG:
            continue
        on = _pair_on(ec, a, b)
        if on is False:
            continue
        if a == ST_VALIDATE:
            by_v = _or(by_v, _and(on, (st["valid"] & ~st["is_w"]).any(dim=1)))
        elif a == ST_COMMIT:
            by_c = _or(by_c, on)
    by_c = _and(by_c, _not(by_v))  # the first registered pair claims the stage
    return _or(by_v, by_c), by_v, by_c


def _resolve_next(ec: eng.EngineConfig, spec: StageSpec, st: Dict):
    # fuse_next routes past the LOG stage for txns whose log bytes ride a doorbell
    if spec.fuse_next is None:
        return spec.next_stage
    absorbed, _, _ = log_rides(ec, st)
    if isinstance(absorbed, torch.Tensor):
        return torch.where(absorbed, spec.fuse_next, spec.next_stage).to(torch.int32)
    return spec.fuse_next if absorbed else spec.next_stage


def _stage_wire(ec: eng.EngineConfig, cm: CostModel, wl, spec: StageSpec, st: Dict):
    """(bytes, n_verbs) for one round, with absorbed-stage bytes when fused.

    Absorbed LOG bytes ride the WRITE ops of a COMMIT doorbell, or the
    read-set ops of txns that also write on a VALIDATE doorbell; bytes are
    then an (N,K) float32 tensor.
    """
    wc = wire_cost(ec.protocol, spec.canon)
    nb = wc.bytes_for(wl.rw, cm.n_backups)
    if spec.fuse_absorbs is not None and ec.merge_stages and ec.doorbell:
        extra = wire_cost(ec.protocol, spec.fuse_absorbs).bytes_for(wl.rw, cm.n_backups)
        _, by_v, by_c = log_rides(ec, st)
        if spec.canon == ST_VALIDATE:
            has_ws = (st["valid"] & st["is_w"]).any(dim=1)
            on = (has_ws & by_v)[:, None] & st["valid"] & ~st["is_w"]
        else:
            on = st["is_w"] & (by_c[:, None] if isinstance(by_c, torch.Tensor) else bool(by_c))
        nb = torch.where(on, extra, 0.0) + nb
    return nb, wc.n_verbs


# ---------------------------------------------------------------------------
# Shared effect building blocks
# ---------------------------------------------------------------------------


def apply_commit(ec: eng.EngineConfig, store: Dict, st: Dict, eff, *, bump_seq: bool = False) -> Dict:
    """Write back wvals + release this txn's locks for served commit ops
    (``bump_seq`` also advances OCC's validation sequence word)."""
    keys_f = st["keys"].reshape(-1)
    w_eff = (eff & st["is_w"]).reshape(-1)
    idx_w = torch.where(w_eff, keys_f, ec.store_rows)
    store = dict(store)
    store["data"] = eng.write_rows(
        ec, store["data"], idx_w, st["wvals"].reshape(-1, st["wvals"].shape[-1])
    )
    store["ver"] = eng.write_rows(ec, store["ver"], idx_w, 1, op="add")
    if bump_seq:
        store["seq"] = eng.write_rows(ec, store["seq"], idx_w, 1, op="add")
    rel = (eff & st["locked"]).reshape(-1)
    idx_r = torch.where(rel, keys_f, ec.store_rows)
    store["lock_hi"] = eng.write_rows(ec, store["lock_hi"], idx_r, 0)
    store["lock_lo"] = eng.write_rows(ec, store["lock_lo"], idx_r, 0)
    return store


def writeback_commit_effect(*, bump_seq: bool = False) -> Callable:
    """COMMIT effect hook for protocols using the plain write-back."""

    def effect(ec, cm, wl, st, store, in_s, served, salt):
        store = apply_commit(ec, store, st, served, bump_seq=bump_seq)
        st = dict(st)
        st["locked"] = st["locked"] & ~served
        return StageOut(st, store)

    return effect


def release_effect(ec, cm, wl, st, store, in_s, served, salt) -> StageOut:
    """ABORT-RELEASE effect: zero the lock words this txn still holds."""
    store = eng.release_locks(ec, store, st, served)
    st = dict(st)
    st["locked"] = st["locked"] & ~served
    return StageOut(st, store)


def ops_valid(ec, wl, st):
    """All valid ops not yet served (fetch/commit-style stages)."""
    return st["valid"] & ~st["served"]


def ops_write_set(ec, wl, st):
    """Write-set ops not yet served (occ/sundial/mvcc commit)."""
    return st["valid"] & st["is_w"] & ~st["served"]


def ops_read_set(ec, wl, st):
    """Read-set ops not yet served (validate stages)."""
    return st["valid"] & ~st["is_w"] & ~st["served"]


def ops_locked(ec, wl, st):
    """Held locks not yet released (abort-release stages)."""
    return st["locked"] & ~st["served"]


def ops_lock_pending(write_only: bool) -> Callable:
    """Lock-stage want basis: unlocked (write-set) ops.  One-sided lock
    requests re-post every tick, so ``served`` does NOT mask the basis."""

    def ops(ec, wl, st):
        base = st["valid"] & st["is_w"] if write_only else st["valid"]
        return base & ~st["locked"] & ~st["served"]

    return ops


def abort_to_retry(st: Dict, fail, spec: StageSpec) -> Dict:
    """Route failing txns: ABREL when holding locks, else immediate retry
    (counts the abort, zeroes the latency/round counters; ``spec.new_ts``
    also takes a fresh, larger timestamp)."""
    has_locks = st["locked"].any(dim=1)
    st = dict(st)
    st["stage"] = torch.where(
        fail & has_locks, spec.abrel_stage, torch.where(fail, spec.retry_stage, st["stage"])
    )
    insta = fail & ~has_locks
    st = eng.finish_abort(st, insta)
    st = dict(st)
    if spec.new_ts:
        st["clock"] = torch.where(insta, st["clock"] + 1, st["clock"])
        st["ts_hi"] = torch.where(insta, st["clock"], st["ts_hi"])
    st["lat_us"] = torch.where(insta, 0.0, st["lat_us"])
    st["rounds"] = torch.where(insta, 0, st["rounds"])
    return st


# ---------------------------------------------------------------------------
# The round lifecycle
# ---------------------------------------------------------------------------


def run_stage_round(
    ec: eng.EngineConfig, cm: CostModel, wl, st: Dict, store: Dict, spec: StageSpec, salt: int
) -> Tuple[Dict, Dict]:
    """One serviced network round for ``spec``: the full lifecycle."""
    prim = eng.stage_primitive(ec, spec.canon)
    in_s = st["stage"] == spec.stage
    want = in_s[:, None] & spec.ops(ec, wl, st)
    served, load = eng.service_ops(ec, cm, st, want, eng.stage_is_rpc(ec, spec.canon), salt)
    out = spec.effect(ec, cm, wl, st, store, in_s, served, salt)
    st, store = dict(out.st), out.store
    nbytes, n_verbs = _stage_wire(ec, cm, wl, spec, st)
    st = eng.account_round(ec, cm, st, spec.canon, served, load, prim, nbytes, n_verbs=n_verbs)
    st = dict(st)
    acc = served if out.served_acc is None else out.served_acc
    st["served"] = st["served"] | acc

    if spec.done == "abort":
        done = in_s & ~st["locked"].any(dim=1)
        st = eng.finish_abort(st, done)
        st = dict(st)
        if spec.new_ts:
            st["clock"] = torch.where(done, st["clock"] + 1, st["clock"])
            st["ts_hi"] = torch.where(done, st["clock"], st["ts_hi"])
        st["stage"] = torch.where(done, spec.next_stage, st["stage"])
        st["served"] = st["served"] & ~done[:, None]
        st["lat_us"] = torch.where(done, 0.0, st["lat_us"])
        st["rounds"] = torch.where(done, 0, st["rounds"])
        return st, store

    outstanding = out.outstanding
    if outstanding is None:
        outstanding = in_s[:, None] & spec.ops(ec, wl, st)
    done = in_s & ~outstanding.any(dim=1)

    if spec.done == "commit":
        st = eng.finish_commit(ec, cm, st, done)
        st = dict(st)
        st["stage"] = torch.where(done, FRESH, st["stage"])
        st["served"] = st["served"] & ~done[:, None]
        return st, store

    # "advance"
    fail = out.fail
    exit_mask = done
    if fail is not None:
        done = done & ~fail
        exit_mask = done | fail
        st = abort_to_retry(st, fail, spec)
    if spec.ro_commit:
        # read-only fast path: txns with an empty write set commit here
        has_ws = (st["valid"] & st["is_w"]).any(dim=1)
        ro_done = done & ~has_ws
        st = eng.finish_commit(ec, cm, st, ro_done)
        st = dict(st)
        st["stage"] = torch.where(ro_done, FRESH, st["stage"])
        done = done & has_ws
    st["stage"] = torch.where(done, _resolve_next(ec, spec, st), st["stage"])
    if spec.start_exec:
        st["exec_left"] = torch.where(done, eng.per_row(ec, wl.exec_ticks), st["exec_left"])
    st["served"] = st["served"] & ~exit_mask[:, None]
    st["substep"] = torch.where(exit_mask, 0, st["substep"])
    return st, store


def _log_round(ec: eng.EngineConfig, cm: CostModel, wl, st: Dict, spec: StageSpec) -> Dict:
    """Coordinator log to the replication group: one fire-and-forget round
    (no service arbitration; read-only txns advance for free).  Txns whose
    LOG bytes ride a doorbell were routed past this stage."""
    prim = eng.stage_primitive(ec, spec.canon)
    in_g = st["stage"] == spec.stage
    ops = in_g[:, None] & st["is_w"] & st["valid"]
    load = torch.full(ops.shape, float(cm.n_backups), dtype=torch.float32, device=ops.device)
    nbytes, n_verbs = _stage_wire(ec, cm, wl, spec, st)
    st = eng.account_round(ec, cm, st, spec.canon, ops, load, prim, nbytes, n_verbs=n_verbs)
    st = dict(st)
    st["stage"] = torch.where(in_g, spec.next_stage, st["stage"])
    st["served"] = st["served"] & ~in_g[:, None]
    return st


def _exec_stage(ec: eng.EngineConfig, wl, st: Dict, spec: StageSpec) -> Dict:
    """Local execution phase: burn exec_left ticks, then run the workload's
    execute fn and advance (possibly straight past a fused LOG stage)."""
    in_e = st["stage"] == spec.stage
    st = dict(st)
    st["exec_left"] = torch.where(in_e, torch.clamp(st["exec_left"] - 1, min=0), st["exec_left"])
    done_e = in_e & (st["exec_left"] == 0)
    wv = wl.execute(st["keys"], st["is_w"], st["valid"], st["rvals"])
    st["wvals"] = torch.where(done_e[:, None, None], wv, st["wvals"])
    st["stage"] = torch.where(done_e, _resolve_next(ec, spec, st), st["stage"])
    return st


def canon_table(specs: Tuple[StageSpec, ...]) -> Tuple[int, ...]:
    """Protocol-stage -> canonical-stage map derived from a stage table."""
    by_stage = {s.stage: s.canon for s in specs}
    return tuple(by_stage[i] for i in range(len(by_stage)))


def canon_of(stage, canon_map: Tuple[int, ...]):
    """Map st["stage"] values to canonical cost stages (-1 = inactive)."""
    canon = torch.full_like(stage, -1)
    for ps, c in enumerate(canon_map):
        canon = torch.where(stage == ps, c, canon)
    return canon


def begin_tick(
    ec: eng.EngineConfig,
    cm: CostModel,
    wl,
    st: Dict,
    canon_map: Tuple[int, ...],
    start_stage: int,
    fresh_hook: Optional[Callable] = None,
) -> Dict:
    """Regenerate fresh slots and charge every active txn its tick base.
    Bucket-padded (dead) slots stay at stage -1 forever."""
    fresh = st["stage"] < 0
    alive = eng.alive_mask(ec)
    if alive is not None:
        fresh = fresh & alive
    st = eng.regen_txns(ec, wl, st, fresh, new_ts=True)
    st = dict(st)
    st["stage"] = torch.where(fresh, start_stage, st["stage"])
    if fresh_hook is not None:
        st = fresh_hook(st, fresh)
    return eng.base_time(ec, cm, st, canon_of(st["stage"], canon_map))


def make_tick(
    *,
    specs: Tuple[StageSpec, ...],
    start_stage: int,
    salt_mult: int,
    fresh_hook: Optional[Callable] = None,
) -> Callable:
    """Compile a stage table into the engine's per-tick function.

    ``specs`` run in the given order (reverse pipeline order, so a
    transaction advances at most one network stage per tick); ``salt_mult``
    namespaces each protocol's arbitration RNG stream.
    """
    canon_map = canon_table(specs)

    def tick(ec: eng.EngineConfig, cm: CostModel, wl, st: Dict, store: Dict, t: int):
        salt = t * salt_mult
        st = begin_tick(ec, cm, wl, st, canon_map, start_stage, fresh_hook)
        for spec in specs:
            if spec.kind == ROUND:
                st, store = run_stage_round(ec, cm, wl, st, store, spec, salt + spec.salt_off)
            elif spec.kind == LOG:
                st = _log_round(ec, cm, wl, st, spec)
            else:
                st = _exec_stage(ec, wl, st, spec)
        return st, store

    return tick
