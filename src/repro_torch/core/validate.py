"""Serializability validation of committed histories (port of
``repro.core.validate``).

Builds the version-order precedence graph (WW / WR / RW edges per record)
from the engine's commit history and checks it for a cycle, the standard
conflict-serializability test.  Also provides the store-consistency
invariants (no lost updates) and the cross-protocol serializability
oracle: :func:`replay_committed` re-executes the committed history in
commit order against a plain sequential store, and :func:`final_data`
projects a protocol store down to its latest committed record values, so
``replay == final_data`` asserts final-state equivalence.

Every function takes the port's state/store dicts of one config (tensors
on any device) or dicts of numpy arrays; a batched run keeps one history
per config, and ``engine.config_slice`` hands each config's part over.  The graph is the port's own: a dict of
successor sets, checked with Kahn's algorithm.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

_I32_MIN = -(2**31)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_history(st: Dict) -> List[dict]:
    h = {k: _np(st[k]) for k in ("h_idx", "h_keys", "h_ver_r", "h_ver_w", "h_isw", "h_valid", "h_ts_hi", "h_ts_lo")}
    n = min(int(h["h_idx"][0]), h["h_keys"].shape[0])
    out = []
    for i in range(n):
        ops = [
            dict(
                key=int(h["h_keys"][i, j]),
                ver_r=int(h["h_ver_r"][i, j]),
                ver_w=int(h["h_ver_w"][i, j]),
                is_w=bool(h["h_isw"][i, j]),
            )
            for j in range(h["h_keys"].shape[1])
            if h["h_valid"][i, j]
        ]
        out.append(dict(txn=i, ts=(int(h["h_ts_hi"][i]), int(h["h_ts_lo"][i])), ops=ops))
    return out


class DiGraph:
    """The few parts of a directed graph the validator needs: nodes in
    insertion order and successor sets."""

    def __init__(self):
        self.succ: Dict[int, Set[int]] = {}

    def add_node(self, n: int) -> None:
        self.succ.setdefault(n, set())

    def add_edge(self, u: int, v: int) -> None:
        self.add_node(u)
        self.add_node(v)
        self.succ[u].add(v)

    @property
    def edges(self) -> List[Tuple[int, int]]:
        return [(u, v) for u, vs in self.succ.items() for v in sorted(vs)]


def precedence_graph(history: List[dict]) -> DiGraph:
    g = DiGraph()
    for t in history:
        g.add_node(t["txn"])
    # per key: writers by produced version; readers by version read
    writers: Dict[Tuple[int, int], int] = {}
    readers: Dict[int, List[Tuple[int, int]]] = {}
    key_writes: Dict[int, List[int]] = {}
    for t in history:
        for op in t["ops"]:
            if op["is_w"]:
                writers[(op["key"], op["ver_w"])] = t["txn"]
                key_writes.setdefault(op["key"], []).append(op["ver_w"])
            readers.setdefault(op["key"], []).append((op["ver_r"], t["txn"]))
    for key, vers in key_writes.items():
        vs = sorted(set(vers))
        # WW edges along the version chain
        for a, b in zip(vs, vs[1:]):
            g.add_edge(writers[(key, a)], writers[(key, b)])
        nxt = {a: b for a, b in zip(vs, vs[1:])}
        for ver_r, txn in readers.get(key, []):
            w = writers.get((key, ver_r))
            if w is not None and w != txn:
                g.add_edge(w, txn)  # WR: read version's writer precedes reader
            nv = nxt.get(ver_r)
            if nv is None:
                # first write after ver_r (reader of a non-boundary version)
                later = [v for v in vs if v > ver_r]
                nv = later[0] if later else None
            if nv is not None and writers[(key, nv)] != txn:
                g.add_edge(txn, writers[(key, nv)])  # RW: reader precedes next writer
    return g


def find_cycle(g: DiGraph) -> List[Tuple[int, int]]:
    """The edges of one directed cycle of ``g``, or [] when it is acyclic.

    Kahn's algorithm peels off every node of in-degree 0; what remains has
    a cycle through every node, found by walking predecessors from any
    remaining node until one repeats.
    """
    indeg = {n: 0 for n in g.succ}
    for vs in g.succ.values():
        for v in vs:
            indeg[v] += 1
    queue = [n for n, d in indeg.items() if d == 0]
    while queue:
        n = queue.pop()
        for v in g.succ[n]:
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    left = {n for n, d in indeg.items() if d > 0}
    if not left:
        return []
    pred = {v: u for u in left for v in g.succ[u] if v in left}
    node, seen = next(iter(left)), []
    while node not in seen:
        seen.append(node)
        node = pred[node]
    cyc = seen[seen.index(node):][::-1]  # predecessor walk, reversed into edge order
    return list(zip(cyc, cyc[1:] + cyc[:1]))


def is_serializable(history: List[dict]) -> Tuple[bool, List]:
    cycle = find_cycle(precedence_graph(history))
    return not cycle, cycle


def final_data(store: Dict) -> np.ndarray:
    """Latest committed record values (R, rw), protocol-layout-agnostic.

    Single-version stores expose ``data`` directly; MVCC's latest version
    is the slot with the lexicographically largest wts (slot 0 is seeded as
    the initial committed version, so fresh records resolve to it).
    """
    if "vdata" not in store:
        return _np(store["data"])
    wts_hi, wts_lo = _np(store["wts_hi"]), _np(store["wts_lo"])
    best_hi = wts_hi.max(axis=1, keepdims=True)
    best = np.where(wts_hi == best_hi, wts_lo, np.int32(_I32_MIN)).argmax(axis=1)
    return _np(store["vdata"])[np.arange(wts_hi.shape[0]), best]


def replay_committed(st: Dict, wl, n_records: int) -> np.ndarray:
    """Replay the committed history in commit order on a sequential store.

    Each committed transaction reads its operands from the sequential
    store, re-runs the workload's ``execute`` and writes back its write
    set: the textbook serial execution.  If the protocol's interleaved run
    was serializable in its commit order, the result matches
    :func:`final_data` of the engine's store exactly.  Runs on the CPU.
    """
    n = int(_np(st["h_idx"])[0])
    cap = st["h_keys"].shape[0]
    if n > cap:
        raise ValueError(f"history overflowed: {n} commits > history_cap {cap}")
    keys, is_w, valid = (torch.as_tensor(_np(st[k])[:n]) for k in ("h_keys", "h_isw", "h_valid"))
    data = torch.full((n_records + 1, wl.rw), wl.init_value, dtype=torch.int32)  # + a drop row
    for i in range(n):
        k = keys[i]
        wv = wl.execute(k[None], is_w[i][None], valid[i][None], data[k.long()][None])[0]
        data[torch.where(is_w[i] & valid[i], k, n_records).long()] = wv
    return data[:n_records].numpy()


def inflight_commit_writes(st: Dict, commit_stage: int) -> np.ndarray:
    """Keys partially written by transactions caught mid-COMMIT at run end.

    A commit round can straddle ticks under capacity limits: its served
    write ops have already hit the store while the transaction is not yet
    counted committed (no history row).  The oracle excludes these keys
    from the final-state comparison.
    """
    in_c = _np(st["stage"]) == commit_stage
    written = _np(st["served"]) & _np(st["is_w"]) & _np(st["valid"])
    return np.unique(_np(st["keys"])[in_c[:, None] & written])


def check_no_lost_updates(history: List[dict], store: Dict) -> Tuple[bool, str]:
    """Final per-key version counter must equal committed write count
    (every committed write produced a distinct, persisted version)."""
    writes: Dict[int, int] = {}
    vers: Dict[int, set] = {}
    for t in history:
        for op in t["ops"]:
            if op["is_w"]:
                writes[op["key"]] = writes.get(op["key"], 0) + 1
                vers.setdefault(op["key"], set()).add(op["ver_w"])
    ver = _np(store["ver"])
    for key, cnt in writes.items():
        if len(vers[key]) != cnt:
            return False, f"key {key}: {cnt} commits produced {len(vers[key])} versions (lost update)"
        if ver[key] < max(vers[key]):
            return False, f"key {key}: store version {ver[key]} < max committed {max(vers[key])}"
    return True, ""
