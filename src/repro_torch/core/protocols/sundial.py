"""SUNDIAL (paper §4.5; port of ``repro.core.protocols.sundial``):
lock | rts | wts | record, logical leases.

FETCH: atomic read of each tuple; for reads commit_tts = max(commit_tts,
wts).  LOCK(WS): CAS lock + READ; require wts unchanged since fetch, then
commit_tts = max(commit_tts, rts+1).  VALIDATE: every RS record whose
rts < commit_tts gets a lease RENEWAL (atomic read, fail if wts changed or
locked by another txn, then CAS rts -> commit_tts); one-sided renewal
takes 2 dependent rounds, RPC one.  COMMIT: write back WS with
wts = rts = commit_tts, unlock.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as eng
from repro_torch.core import registry
from repro_torch.core import rounds
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

_I32_MIN = -(2**31)


def _lex_lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _wts(ec, store, keys) -> TS:
    hi, lo = eng.read_rows_many(ec, (store["wts_hi"], store["wts_lo"]), keys)
    return TS(hi, lo)


def _rts(ec, store, keys) -> TS:
    hi, lo = eng.read_rows_many(ec, (store["rts_hi"], store["rts_lo"]), keys)
    return TS(hi, lo)


def _bump_commit(st, ops, cand: TS):
    """commit_tts = max(commit_tts, max over ops of cand)."""
    ch = torch.where(ops, cand.hi, _I32_MIN).amax(dim=1)
    cl = torch.where(ops & (cand.hi == ch[:, None]), cand.lo, _I32_MIN).amax(dim=1)
    upd = _lex_lt(st["commit_hi"], st["commit_lo"], ch, cl) & ops.any(dim=1)
    st = dict(st)
    st["commit_hi"] = torch.where(upd, ch, st["commit_hi"])
    st["commit_lo"] = torch.where(upd, cl, st["commit_lo"])
    return st


def _commit_effect(ec, cm, wl, st, store, in_c, served, salt):
    """Write back WS with wts = rts = commit_tts, then unlock."""
    st = dict(st)
    keys_f = st["keys"].reshape(-1)
    idx = torch.where(served.reshape(-1), keys_f, ec.store_rows)
    K = st["keys"].shape[1]
    ch = eng.per_op(st["commit_hi"], K)
    cl = eng.per_op(st["ts_lo"], K)  # writer id in lo for wts uniqueness
    store = dict(store)
    store["data"] = eng.write_rows(ec, store["data"], idx, st["wvals"].reshape(-1, wl.rw))
    store["wts_hi"] = eng.write_rows(ec, store["wts_hi"], idx, ch)
    store["wts_lo"] = eng.write_rows(ec, store["wts_lo"], idx, cl)
    store["rts_hi"] = eng.write_rows(ec, store["rts_hi"], idx, ch)
    store["rts_lo"] = eng.write_rows(ec, store["rts_lo"], idx, cl)
    store["ver"] = eng.write_rows(ec, store["ver"], idx, 1, op="add")
    rel = (served & st["locked"]).reshape(-1)
    idx_r = torch.where(rel, keys_f, ec.store_rows)
    store["lock_hi"] = eng.write_rows(ec, store["lock_hi"], idx_r, 0)
    store["lock_lo"] = eng.write_rows(ec, store["lock_lo"], idx_r, 0)
    st["locked"] = st["locked"] & ~served
    return StageOut(st, store)


def _validate_effect(ec, cm, wl, st, store, in_v, served, salt):
    """Lease renewal: EVERY RS record is validated at commit (the version
    read must be unchanged, wts == wts_seen); leases short of commit_tts are
    then RENEWED (CAS rts -> commit_tts), failing if locked by a writer."""
    st = dict(st)
    rs = st["valid"] & ~st["is_w"]
    rts_now = _rts(ec, store, st["keys"])
    cm_h, cm_l = st["commit_hi"][:, None], st["commit_lo"][:, None]
    needs = rs & _lex_lt(rts_now.hi, rts_now.lo, cm_h, cm_l)
    # one-sided renewal: round 1 = atomic read, round 2 = CAS (substep);
    # RPC renewal: a single handler call
    is_rpc = eng.stage_is_rpc(ec, ST_VALIDATE)
    if isinstance(is_rpc, torch.Tensor):  # the run's configs differ
        final = st["substep"] >= torch.where(is_rpc, 0, 1)
    else:
        final = st["substep"] >= (0 if is_rpc else 1)  # rounds needed - 1
    eff = served & final[:, None]
    wts_now = _wts(ec, store, st["keys"])
    lh, ll = eng.read_rows_many(ec, (store["lock_hi"], store["lock_lo"]), st["keys"])
    lock = TS(lh, ll)
    mine = ts_eq(lock, TS(st["ts_hi"][:, None], st["ts_lo"][:, None]))
    unchanged = ts_eq(wts_now, TS(st["wts_seen_hi"], st["wts_seen_lo"]))
    renew_ok = unchanged & (ts_is_zero(lock) | mine)
    bad = eff & ((needs & ~renew_ok) | ~unchanged)
    # CAS rts -> commit_tts (lexicographic scatter-max, as MVCC)
    ok_eff = (eff & renew_ok).reshape(-1)
    idx = torch.where(ok_eff, st["keys"].reshape(-1), ec.store_rows)
    K = st["keys"].shape[1]
    store = dict(store)
    store["rts_hi"], store["rts_lo"] = eng.scatter_ts_max(
        ec, store["rts_hi"], store["rts_lo"], idx,
        eng.per_op(st["commit_hi"], K), eng.per_op(st["commit_lo"], K), ok_eff,
    )
    partial = in_v & served.any(dim=1) & ~final
    st["substep"] = torch.where(partial, st["substep"] + 1, st["substep"])
    return StageOut(st, store, fail=in_v & bad.any(dim=1), served_acc=served & final[:, None])


def _lock_effect(ec, cm, wl, st, store, in_l, served, salt):
    """CAS lock + READ; require wts unchanged since fetch, then
    commit_tts = max(commit_tts, rts + 1)."""
    st = dict(st)
    won, store = eng.try_lock(
        ec, store, st, served,
        st["ts_hi"][:, None].expand(served.shape), st["ts_lo"][:, None].expand(served.shape),
    )
    st["locked"] = st["locked"] | won
    wts_now = _wts(ec, store, st["keys"])
    unchanged = ts_eq(wts_now, TS(st["wts_seen_hi"], st["wts_seen_lo"]))
    lost = served & ~won
    fail = in_l & (lost.any(dim=1) | (won & ~unchanged).any(dim=1))
    rts_now = _rts(ec, store, st["keys"])
    st = _bump_commit(st, won, TS(rts_now.hi + 1, torch.zeros_like(rts_now.lo)))
    ws = st["valid"] & st["is_w"]
    return StageOut(
        st,
        store,
        fail=fail,
        served_acc=torch.zeros_like(served),
        outstanding=ws & ~st["locked"],
    )


def _fetch_effect(ec, cm, wl, st, store, in_f, served, salt):
    """Atomic tuple read; reads order after writers (commit_tts >= wts):
    tuple + version + wts ride one doorbell-batched plane round."""
    st = dict(st)
    got, ver = eng.read_rows_many(ec, (store["data"], store["ver"]), st["keys"])
    st["rvals"] = torch.where(served[:, :, None], got, st["rvals"])
    st["ver_seen"] = torch.where(served, ver, st["ver_seen"])
    wts_now = _wts(ec, store, st["keys"])
    st["wts_seen_hi"] = torch.where(served, wts_now.hi, st["wts_seen_hi"])
    st["wts_seen_lo"] = torch.where(served, wts_now.lo, st["wts_seen_lo"])
    rs = st["valid"] & ~st["is_w"]
    return StageOut(_bump_commit(st, served & rs, wts_now), store)


def _fresh_hook(st, fresh):
    st = dict(st)
    st["commit_hi"] = torch.where(fresh, 0, st["commit_hi"])
    st["commit_lo"] = torch.where(fresh, 0, st["commit_lo"])
    return st


SPECS = (
    StageSpec(
        stage=S_COMMIT,
        canon=ST_COMMIT,
        ops=rounds.ops_write_set,
        effect=_commit_effect,
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
        new_ts=True,
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
        retry_stage=S_FETCH,
        abrel_stage=S_ABREL,
        new_ts=True,
        salt_off=3,
    ),
    StageSpec(
        stage=S_LOCKW,
        canon=ST_LOCK,
        ops=rounds.ops_lock_pending(write_only=True),
        effect=_lock_effect,
        next_stage=S_VALID,
        retry_stage=S_FETCH,
        abrel_stage=S_ABREL,
        new_ts=True,
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
        salt_off=5,
    ),
)

tick = rounds.make_tick(specs=SPECS, start_stage=S_FETCH, salt_mult=43, fresh_hook=_fresh_hook)

STAGES_USED = ("fetch", "lock", "validate", "log", "commit", "release")

registry.register_protocol("sundial", tick=tick, stages=STAGES_USED, capabilities=registry.Caps())
