"""Shared 2PL machinery: NOWAIT and WAITDIE (paper §4.2, §4.3; port of
``repro.core.protocols.twopl``).

Stage machine (a rounds.StageSpec table):
  LOCK -> EXEC -> LOG -> COMMIT -> (done, regen)
    \\-> ABREL (release partial locks) -> retry same txn

NOWAIT: any lock conflict aborts immediately.
WAITDIE: on conflict, strictly older requesters WAIT (RPC: parked on the
owner's wait-list; one-sided: re-post CAS+READ every round), younger
requesters DIE (abort, retry with the ORIGINAL timestamp).
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
    ST_LOCK,
    ST_LOG,
    ST_RELEASE,
)
from repro_torch.core.rounds import StageOut, StageSpec
from repro_torch.core.timestamps import TS, ts_is_zero, ts_lt

S_LOCK, S_EXEC, S_LOG, S_COMMIT, S_ABREL = range(5)


def _lock_effect(wait_die: bool):
    """Arbitrated CAS + fetch-under-lock with the NOWAIT/WAITDIE conflict
    rule.  RPC waiters are parked server-side (``served`` accumulates);
    one-sided waiters re-post CAS+READ every tick."""

    def effect(ec, cm, wl, st, store, in_l, served, salt):
        is_rpc_l = eng.stage_is_rpc(ec, ST_LOCK)
        st = dict(st)
        pend = in_l[:, None] & st["valid"] & ~st["locked"]
        # under a parked RPC waiter st["served"] stays set, while the
        # one-sided plane never accumulates it: pend re-posts every tick
        if isinstance(is_rpc_l, torch.Tensor):  # the run's configs differ
            rpc = is_rpc_l[:, None]
            acc = served & rpc
            contenders = torch.where(rpc, pend & (st["served"] | acc), served)
        else:
            acc = served if is_rpc_l else torch.zeros_like(served)
            contenders = pend & (st["served"] | acc) if is_rpc_l else served

        if wait_die:
            prio_hi = st["ts_hi"][:, None].expand(contenders.shape)
            prio_lo = st["ts_lo"][:, None].expand(contenders.shape)
        else:
            # hashed priority models arrival order; the UNIQUE logical op
            # index as the lo word keeps exactly one winner per key
            base = eng.op_index(ec, contenders.shape[1])
            prio_hi = hash_prio(base + st["ts_lo"][:, None], salt + 1)
            prio_lo = base
        won, store = eng.try_lock(ec, store, st, contenders, prio_hi, prio_lo)
        st["locked"] = st["locked"] | won
        # fetch records under freshly-won locks: one doorbell-batched read
        # of tuple + version from the store try_lock returned
        got, ver = eng.read_rows_many(ec, (store["data"], store["ver"]), st["keys"])
        st["rvals"] = torch.where(won[:, :, None], got, st["rvals"])
        st["ver_seen"] = torch.where(won, ver, st["ver_seen"])

        lost = contenders & ~won
        if wait_die:
            lh, ll = eng.read_rows_many(ec, (store["lock_hi"], store["lock_lo"]), st["keys"])
            lock = TS(lh, ll)
            me = TS(st["ts_hi"][:, None], st["ts_lo"][:, None])
            older = ts_lt(me, lock) | ts_is_zero(lock)  # free again next tick -> wait
            abort_now = in_l & (lost & ~older).any(dim=1)
        else:
            abort_now = in_l & lost.any(dim=1)
        return StageOut(
            st,
            store,
            fail=abort_now,
            served_acc=acc,
            outstanding=st["valid"] & ~st["locked"],
        )

    return effect


def _specs(wait_die: bool):
    # reverse pipeline order: a txn advances at most one stage per tick
    return (
        StageSpec(
            stage=S_COMMIT,
            canon=ST_COMMIT,
            ops=rounds.ops_valid,  # RO ops still round-trip to release locks
            effect=rounds.writeback_commit_effect(),
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
            # retry same txn; WAITDIE keeps its original timestamp (die rule)
            next_stage=S_LOCK,
            salt_off=2,
        ),
        StageSpec(stage=S_LOG, canon=ST_LOG, kind=rounds.LOG, next_stage=S_COMMIT),
        StageSpec(
            stage=S_EXEC,
            canon=ST_EXEC,
            kind=rounds.EXEC,
            next_stage=S_LOG,
            fuse_next=S_COMMIT,
        ),
        StageSpec(
            stage=S_LOCK,
            canon=ST_LOCK,
            ops=rounds.ops_lock_pending(write_only=False),
            effect=_lock_effect(wait_die),
            next_stage=S_EXEC,
            start_exec=True,
            retry_stage=S_LOCK,
            abrel_stage=S_ABREL,
            salt_off=3,
        ),
    )


def make_tick(wait_die: bool):
    return rounds.make_tick(specs=_specs(wait_die), start_stage=S_LOCK, salt_mult=17)


STAGES_USED = ("lock", "log", "commit", "release")

NOWAIT = registry.register_protocol(
    "nowait",
    tick=make_tick(wait_die=False),
    stages=STAGES_USED,
    capabilities=registry.Caps(),
    variant={"wait_die": False},
    family="twopl",
)
WAITDIE = registry.register_protocol(
    "waitdie",
    tick=make_tick(wait_die=True),
    stages=STAGES_USED,
    capabilities=registry.Caps(),
    variant={"wait_die": True},
    family="twopl",
)
