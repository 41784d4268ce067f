"""OCC (paper §4.1, DrTM+H layout lock | seq | record; port of
``repro.core.protocols.occ``).

FETCH (speculative, no locks) -> EXEC -> LOCK(WS) -> VALIDATE(RS seq
unchanged, unlocked) -> LOG -> COMMIT(write back, seq+1, unlock).
Any lock or validation failure aborts (release WS locks, retry).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as eng
from repro_torch.core import registry
from repro_torch.core import rounds
from repro_torch.core.arbiter import hash_prio
from repro_torch.core.costmodel import (
    ST_COMMIT,
    ST_EXEC,
    ST_FETCH,
    ST_LOCK,
    ST_LOG,
    ST_RELEASE,
    ST_VALIDATE,
)
from repro_torch.core.rounds import StageOut, StageSpec
from repro_torch.core.timestamps import TS, ts_eq, ts_is_zero

S_FETCH, S_EXEC, S_LOCKW, S_VALID, S_LOG, S_COMMIT, S_ABREL = range(7)


def _validate_effect(ec, cm, wl, st, store, in_v, served, salt):
    """Re-read RS seq words: unchanged + unlocked (or locked by me)."""
    seq_now, lh, ll = eng.read_rows_many(
        ec, (store["seq"], store["lock_hi"], store["lock_lo"]), st["keys"]
    )
    lock = TS(lh, ll)
    mine = ts_eq(lock, TS(st["ts_hi"][:, None], st["ts_lo"][:, None]))
    bad = served & ((seq_now != st["seq_seen"]) | (~ts_is_zero(lock) & ~mine))
    return StageOut(dict(st), store, fail=in_v & bad.any(dim=1))


def _lock_effect(ec, cm, wl, st, store, in_l, served, salt):
    """CAS the write-set locks; DrTM+H folds a seq re-check into the
    lock+read doorbell."""
    st = dict(st)
    base = eng.op_index(ec, served.shape[1])
    # unique logical-op lo word => exactly one winner per key (twopl.py note)
    won, store = eng.try_lock(ec, store, st, served, hash_prio(base + st["ts_lo"][:, None], salt + 1), base)
    st["locked"] = st["locked"] | won
    lost = served & ~won
    seq_now = eng.read_rows(ec, store["seq"], st["keys"])
    ws_changed = (won & (seq_now != st["seq_seen"])).any(dim=1)
    ws = st["valid"] & st["is_w"]
    return StageOut(
        st,
        store,
        fail=in_l & (lost.any(dim=1) | ws_changed),
        served_acc=torch.zeros_like(served),  # one-sided waiters re-post
        outstanding=ws & ~st["locked"],
    )


def _fetch_effect(ec, cm, wl, st, store, in_f, served, salt):
    """Speculative tuple+seq read (no locks taken): one batched plane round."""
    st = dict(st)
    got, seq, ver = eng.read_rows_many(ec, (store["data"], store["seq"], store["ver"]), st["keys"])
    st["rvals"] = torch.where(served[:, :, None], got, st["rvals"])
    st["seq_seen"] = torch.where(served, seq, st["seq_seen"])
    st["ver_seen"] = torch.where(served, ver, st["ver_seen"])
    return StageOut(st, store)


SPECS = (
    StageSpec(
        stage=S_COMMIT,
        canon=ST_COMMIT,
        ops=rounds.ops_write_set,
        effect=rounds.writeback_commit_effect(bump_seq=True),
        done="commit",
        salt_off=1,
        fuse_absorbs=ST_LOG,
    ),
    StageSpec(
        stage=S_ABREL,
        canon=ST_RELEASE,
        ops=rounds.ops_locked,
        effect=rounds.release_effect,
        done="abort",
        next_stage=S_FETCH,
        salt_off=2,
    ),
    StageSpec(stage=S_LOG, canon=ST_LOG, kind=rounds.LOG, next_stage=S_COMMIT),
    StageSpec(
        stage=S_VALID,
        canon=ST_VALIDATE,
        ops=rounds.ops_read_set,
        effect=_validate_effect,
        next_stage=S_LOG,
        fuse_next=S_COMMIT,
        # the VALIDATE→LOG merge-table pair: with both stages one-sided, the
        # log WRITEs ride the validation doorbell
        fuse_absorbs=ST_LOG,
        retry_stage=S_FETCH,
        abrel_stage=S_ABREL,
        salt_off=3,
    ),
    StageSpec(
        stage=S_LOCKW,
        canon=ST_LOCK,
        ops=rounds.ops_lock_pending(write_only=True),
        effect=_lock_effect,
        next_stage=S_VALID,  # no writes at all -> straight to validate
        retry_stage=S_FETCH,
        abrel_stage=S_ABREL,
        salt_off=4,
    ),
    StageSpec(stage=S_EXEC, canon=ST_EXEC, kind=rounds.EXEC, next_stage=S_LOCKW),
    StageSpec(
        stage=S_FETCH,
        canon=ST_FETCH,
        ops=rounds.ops_valid,
        effect=_fetch_effect,
        next_stage=S_EXEC,
        start_exec=True,
        salt_off=6,
    ),
)

tick = rounds.make_tick(specs=SPECS, start_stage=S_FETCH, salt_mult=29)

STAGES_USED = ("fetch", "lock", "validate", "log", "commit", "release")

registry.register_protocol("occ", tick=tick, stages=STAGES_USED, capabilities=registry.Caps())
