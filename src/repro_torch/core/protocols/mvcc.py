"""MVCC (paper §4.4; port of ``repro.core.protocols.mvcc``):
tts | rts | wts[4] | record[4].

Read (RS): atomic double-read of the tuple; Cond R1, a committed version
with the largest wts < ctts exists among the static slots; Cond R2, tts is
0 or > ctts.  Abort if either fails (slot overflow shows up as an R1
failure).  Then bump rts to max(rts, ctts) via CAS-max.

Write (WS): read metadata, check Cond W1 (ctts > max wts and > rts), CAS the
lock (tts), then RE-CHECK W1 with the returned metadata (the paper's
double-read/double-check).  Commit overwrites the OLDEST wts slot and its
record, then unlocks.

Local clocks advance to any larger observed wts/rts (drift limiter, §4.4).
Read-only transactions commit at the RTS stage (``StageSpec.ro_commit``).
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
from repro_torch.core.timestamps import TS, ts_eq, ts_is_zero, ts_lt
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import first_true

S_READ, S_RTS, S_LOCKW, S_EXEC, S_LOG, S_COMMIT, S_ABREL = range(7)

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _vts(ec, store, keys) -> TS:
    """Version timestamps at keys: (N,K,slots) TS (one batched plane round)."""
    hi, lo = eng.read_rows_many(ec, (store["wts_hi"], store["wts_lo"]), keys)
    return TS(hi, lo)


def _lex_lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _best_version(wts: TS, ctts: TS):
    """Largest wts strictly < ctts among slots. Returns (found, slot_idx)."""
    ch, cl = ctts.hi[..., None], ctts.lo[..., None]
    cand = _lex_lt(wts.hi, wts.lo, ch, cl) & ~((wts.hi == 0) & (wts.lo == 0))
    best_h = torch.where(cand, wts.hi, _I32_MIN).amax(dim=-1, keepdim=True)
    is_h = cand & (wts.hi == best_h)
    best_l = torch.where(is_h, wts.lo, _I32_MIN).amax(dim=-1, keepdim=True)
    winner = is_h & (wts.lo == best_l)
    return cand.any(dim=-1), first_true(winner)


def _version_pick(ec, wts: TS, ctts: TS, lock: TS = None):
    """Cond R1 version pick (+ Cond R2 when ``lock`` is given) over version
    rows already read, routed through the kernel plane.

    wts is (..., S); ctts/lock broadcast against the (...) op batch.
    Returns (found, slot, r2_ok) with r2_ok None when ``lock`` is None,
    bitwise-equal across planes (the torch plane is the inline
    ``_best_version`` + R2 check).  The kernel reads wts rows in place
    (views with a row stride included) and takes a ctts of one pair per
    transaction without expanding it.
    """
    if ec.kernel_plane == kops.KERNEL:
        shp = wts.hi.shape[:-1]
        S = wts.hi.shape[-1]
        if ctts.hi.shape[-1:] == (1,) and ctts.hi.shape[:-1] == shp[:-1]:  # one pair per transaction
            ch, cl = ctts.hi.reshape(-1), ctts.lo.reshape(-1)
        else:
            ch, cl = ctts.hi.expand(shp).reshape(-1), ctts.lo.expand(shp).reshape(-1)
        lh = ll = None
        if lock is not None:
            lh, ll = (t.expand(shp).reshape(-1).contiguous() for t in lock)
        found, slot, ok = kops.version_select(
            wts.hi.reshape(-1, S), wts.lo.reshape(-1, S), ch.contiguous(), cl.contiguous(), lh, ll
        )
        return found.reshape(shp), slot.reshape(shp), None if ok is None else ok.reshape(shp)
    found, slot = _best_version(wts, ctts)
    r2 = None if lock is None else ts_is_zero(lock) | ts_lt(ctts, lock)
    return found, slot, r2


def _version_read(ec, store, keys, ctts: TS, with_lock: bool):
    """The version rows at keys (N, K) and their Cond R1 pick against ctts
    (N, 1), with Cond R2 against the lock at keys when ``with_lock``.
    Returns (wts TS (N, K, S), found, slot, r2_ok or None).

    The kernel plane does it in ONE launch that reads the store in place
    (``kops.version_read``); the torch plane gathers, then picks inline.
    Node-sharded, the fused read's outputs are no owner-only addends, so
    it takes the reference's route on both planes: the rows come back in
    one exchange each (wts pair, lock pair), then the pick runs on the
    combined rows (``kops.version_select`` on the kernel plane).
    """
    if ec.kernel_plane == kops.KERNEL and ec.shard is None:
        lock = (store["lock_hi"], store["lock_lo"]) if with_lock else (None, None)
        found, slot, r2, wh, wl = kops.version_read(
            store["wts_hi"], store["wts_lo"], keys, ctts.hi.reshape(-1), ctts.lo.reshape(-1), *lock
        )
        return TS(wh, wl), found, slot, r2
    wts = _vts(ec, store, keys)
    lock = TS(*eng.read_rows_many(ec, (store["lock_hi"], store["lock_lo"]), keys)) if with_lock else None
    return (wts,) + _version_pick(ec, wts, ctts, lock)


def _max_wts(wts: TS) -> TS:
    bh = wts.hi.amax(dim=-1, keepdim=True)
    bl = torch.where(wts.hi == bh, wts.lo, _I32_MIN).amax(dim=-1)
    return TS(bh[..., 0], bl)


def _oldest_slot(wts: TS):
    bh = wts.hi.amin(dim=-1, keepdim=True)
    is_h = wts.hi == bh
    bl = torch.where(is_h, wts.lo, _I32_MAX).amin(dim=-1, keepdim=True)
    return first_true(is_h & (wts.lo == bl))


def _at_slot(a, slot):
    """a (..., S) at slot (...): ``take_along_axis`` on the last axis."""
    return torch.gather(a, -1, slot.long()[..., None])[..., 0]


def _check_w1(ec, store, st, ops, wts: TS):
    """Cond W1 per op: ctts > max(wts) and ctts > rts; ``wts`` are the
    version rows at st["keys"] that the stage has already read from this
    store."""
    mx = _max_wts(wts)
    rh, rl = eng.read_rows_many(ec, (store["rts_hi"], store["rts_lo"]), st["keys"])
    me_h, me_l = st["ts_hi"][:, None], st["ts_lo"][:, None]
    ok = _lex_lt(mx.hi, mx.lo, me_h, me_l) & _lex_lt(rh, rl, me_h, me_l)
    return ok | ~ops


def _commit_effect(ec, cm, wl, st, store, in_c, served, salt):
    """Overwrite the OLDEST version slot + its record, then unlock.
    wts pair + version counter ride one doorbell-batched plane round."""
    st = dict(st)
    K = st["keys"].shape[1]
    wh, wl_, ver = eng.read_rows_many(
        ec, (store["wts_hi"], store["wts_lo"], store["ver"]), st["keys"]
    )
    oldest = _oldest_slot(TS(wh, wl_))  # (N,K)
    keys_f = st["keys"].reshape(-1)
    idx_k = torch.where(served.reshape(-1), keys_f, ec.store_rows)
    idx_s = oldest.reshape(-1)
    store = dict(store)
    store["wts_hi"] = eng.write_rows2(ec, store["wts_hi"], idx_k, idx_s, eng.per_op(st["ts_hi"], K))
    store["wts_lo"] = eng.write_rows2(ec, store["wts_lo"], idx_k, idx_s, eng.per_op(st["ts_lo"], K))
    store["vdata"] = eng.write_rows2(ec, store["vdata"], idx_k, idx_s, st["wvals"].reshape(-1, wl.rw))
    store["vver"] = eng.write_rows2(ec, store["vver"], idx_k, idx_s, (ver + 1).reshape(-1))
    store["ver"] = eng.write_rows(ec, store["ver"], idx_k, 1, op="add")
    rel = (served & st["locked"]).reshape(-1)
    idx_r = torch.where(rel, keys_f, ec.store_rows)
    store["lock_hi"] = eng.write_rows(ec, store["lock_hi"], idx_r, 0)
    store["lock_lo"] = eng.write_rows(ec, store["lock_lo"], idx_r, 0)
    st["locked"] = st["locked"] & ~served
    return StageOut(st, store)


def _lock_effect(ec, cm, wl, st, store, in_l, served, salt):
    """CAS tts + READ, then double-check W1 under the lock (the paper's
    atomicity fix); fetch the newest committed version for read-modify-write."""
    st = dict(st)
    won, store = eng.try_lock(
        ec, store, st, served,
        st["ts_hi"][:, None].expand(served.shape), st["ts_lo"][:, None].expand(served.shape),
    )
    st["locked"] = st["locked"] | won
    wts, found, slot, _ = _version_read(
        ec, store, st["keys"], TS(st["ts_hi"][:, None], st["ts_lo"][:, None]), with_lock=False
    )
    got = eng.read_rows2(ec, store["vdata"], st["keys"], slot)
    st["rvals"] = torch.where(won[:, :, None], got, st["rvals"])
    vver = eng.read_rows2(ec, store["vver"], st["keys"], slot)
    st["ver_seen"] = torch.where(won, vver, st["ver_seen"])
    w1_ok = _check_w1(ec, store, st, won, wts)
    lost = served & ~won
    fail = in_l & (lost.any(dim=1) | (won & ~w1_ok).any(dim=1) | (won & ~found).any(dim=1))
    ws = st["valid"] & st["is_w"]
    return StageOut(
        st,
        store,
        fail=fail,
        served_acc=torch.zeros_like(served),
        outstanding=ws & ~st["locked"],
    )


def _rts_effect(ec, cm, wl, st, store, in_t, served, salt):
    """Validated rts CAS-max: conditional on the read still being valid
    (Cond R2 still holds and the version read is still the newest < ctts);
    otherwise a writer serialized between our read and our rts update and
    we abort."""
    st = dict(st)
    ctts_now = TS(st["ts_hi"][:, None], st["ts_lo"][:, None])
    wts_now, found_now, slot_now, r2_now = _version_read(ec, store, st["keys"], ctts_now, with_lock=True)
    best_now = TS(_at_slot(wts_now.hi, slot_now), _at_slot(wts_now.lo, slot_now))
    still_ok = found_now & ts_eq(best_now, TS(st["wts_seen_hi"], st["wts_seen_lo"])) & r2_now
    fail = in_t & (served & ~still_ok).any(dim=1)
    served = served & still_ok
    # lexicographic scatter-max of ctts into rts
    K = st["keys"].shape[1]
    sf = served.reshape(-1)
    idx = torch.where(sf, st["keys"].reshape(-1), ec.store_rows)
    store = dict(store)
    store["rts_hi"], store["rts_lo"] = eng.scatter_ts_max(
        ec, store["rts_hi"], store["rts_lo"], idx, eng.per_op(st["ts_hi"], K), eng.per_op(st["ts_lo"], K), sf
    )
    return StageOut(st, store, fail=fail, served_acc=served)


def _read_effect(ec, cm, wl, st, store, in_f, served, salt):
    """Atomic double-read + version selection + W1 precheck."""
    st = dict(st)
    ctts = TS(st["ts_hi"][:, None], st["ts_lo"][:, None])
    wts, found, slot, r2 = _version_read(ec, store, st["keys"], ctts, with_lock=True)
    (rts_obs,) = eng.read_rows_many(ec, (store["rts_hi"],), st["keys"])
    rs = st["valid"] & ~st["is_w"]
    got = eng.read_rows2(ec, store["vdata"], st["keys"], slot)
    rs_served = served & rs
    st["rvals"] = torch.where(rs_served[:, :, None], got, st["rvals"])
    vver = eng.read_rows2(ec, store["vver"], st["keys"], slot)
    st["ver_seen"] = torch.where(rs_served, vver, st["ver_seen"])
    # remember the READ version's wts so the rts stage can re-validate
    st["wts_seen_hi"] = torch.where(rs_served, _at_slot(wts.hi, slot), st["wts_seen_hi"])
    st["wts_seen_lo"] = torch.where(rs_served, _at_slot(wts.lo, slot), st["wts_seen_lo"])
    # clock drift adjustment from observed remote timestamps
    obs = torch.maximum(
        torch.where(served, wts.hi.amax(dim=-1), 0).amax(dim=1),
        torch.where(served, rts_obs, 0).amax(dim=1),
    )
    st["clock"] = torch.maximum(st["clock"], obs)
    # failures: RS needs (R1 & R2); WS precheck W1
    w1 = _check_w1(ec, store, st, served & st["is_w"], wts)
    bad_rs = rs_served & ~(found & r2)
    bad_ws = served & st["is_w"] & ~w1
    return StageOut(st, store, fail=in_f & (bad_rs.any(dim=1) | bad_ws.any(dim=1)))


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
        next_stage=S_READ,
        new_ts=True,  # MVCC retries take a fresh (larger) timestamp
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
        stage=S_LOCKW,
        canon=ST_LOCK,
        ops=rounds.ops_lock_pending(write_only=True),
        effect=_lock_effect,
        next_stage=S_EXEC,
        start_exec=True,
        retry_stage=S_READ,
        abrel_stage=S_ABREL,
        new_ts=True,
        salt_off=3,
    ),
    StageSpec(
        stage=S_RTS,
        canon=ST_VALIDATE,
        ops=rounds.ops_read_set,
        effect=_rts_effect,
        # read-only txns commit at this stage; read-write txns go on to lock
        ro_commit=True,
        next_stage=S_LOCKW,
        retry_stage=S_READ,
        abrel_stage=S_ABREL,
        new_ts=True,
        salt_off=4,
    ),
    StageSpec(
        stage=S_READ,
        canon=ST_FETCH,
        ops=rounds.ops_valid,
        effect=_read_effect,
        next_stage=S_RTS,
        retry_stage=S_READ,
        abrel_stage=S_ABREL,
        new_ts=True,
        salt_off=5,
    ),
)

tick = rounds.make_tick(specs=SPECS, start_stage=S_READ, salt_mult=37)

STAGES_USED = ("fetch", "validate", "lock", "log", "commit", "release")

registry.register_protocol(
    "mvcc",
    tick=tick,
    stages=STAGES_USED,
    # ro_commit: read-only txns commit at the validate stage (S_RTS above)
    capabilities=registry.Caps(ro_commit=True),
)
