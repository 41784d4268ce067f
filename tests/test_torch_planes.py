"""The port's communication planes (``repro_torch.core.planes``).

The engine transport at 1, 2 and 4 node shards, all on the CPU (the
port's counterpart of the reference's forced host devices), against the
dense engine helpers on the same store and requests, on both kernel
planes and with one or three configs on the flat batched store: gathers,
scatters, CAS arbitration, the timestamp scatter-max and the capacity
ranking give BITWISE the dense results.  Then the request-routed planes
(``make_planes``: ``os_read``, ``os_cas``, ``rpc_call``, lossless and with
a finite cap) against the reference's, run in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` as
``tests/test_planes.py`` runs it.  Every comparison is exact: the planes
move int32 words and bool flags only.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import planes
from repro_torch.core.costmodel import CostModel
from repro_torch.core.planes import NodeShard, Shards, make_planes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NODES, COROUTINES, RPN, K = 4, 3, 16, 2
SHAPES = {"lock_hi": (), "data": (2,), "vdata": (4, 2), "wts_hi": (4,)}


def _configs(n_shards, plane, G):
    dense = teng.EngineConfig(protocol="nowait", n_nodes=N_NODES, coroutines=COROUTINES, records_per_node=RPN,
                              kernel_plane=plane, device="cpu", n_configs=G)
    return dense, teng.node_mesh_config(dense, ("cpu",) * n_shards)


def _shard(ec, arr):
    """A dense (G·R, ...) array split into the node shards' (G·R_l, ...) arrays."""
    G, r_l, tail = ec.n_configs, ec.records_local, tuple(arr.shape[1:])
    v = arr.view((G, ec.shard.n_shards, r_l) + tail)
    return Shards(v[:, s].reshape((G * r_l,) + tail).clone() for s in range(ec.shard.n_shards))


def _store(ec, gen):
    return {k: torch.randint(-50, 50, (ec.store_rows,) + s, generator=gen, dtype=torch.int32)
            for k, s in SHAPES.items()}


def _keys(ec, gen, n=COROUTINES * N_NODES):
    """(G·n, K) store rows: each config's keys in its own rows, its first
    and last row included."""
    R, G = ec.n_records, ec.n_configs
    k = torch.randint(0, R, (G, n, K), generator=gen, dtype=torch.int32)
    k[:, 0, 0], k[:, -1, -1] = 0, R - 1
    return (k + torch.arange(G, dtype=torch.int32)[:, None, None] * R).view(G * n, K)


CASES = [(n, plane, G) for n in (1, 2, 4) for plane in ("torch", "kernel") for G in (1, 3)]
IDS = [f"{n}shards-{plane}-G{G}" for n, plane, G in CASES]


@pytest.mark.parametrize("n_shards,plane,G", CASES, ids=IDS)
def test_node_reads_equal_dense_gathers(n_shards, plane, G):
    dense, ec = _configs(n_shards, plane, G)
    gen = torch.Generator().manual_seed(n_shards * 10 + G)
    store = _store(dense, gen)
    sharded = {k: _shard(ec, v) for k, v in store.items()}
    keys = _keys(dense, gen)
    for k, v in store.items():
        assert torch.equal(teng.read_rows(ec, sharded[k], keys), teng.read_rows(dense, v, keys)), k
    names = ("lock_hi", "data", "wts_hi")
    got = teng.read_rows_many(ec, [sharded[k] for k in names], keys)
    want = teng.read_rows_many(dense, [store[k] for k in names], keys)
    for k, g, w in zip(names, got, want):
        assert g.shape == w.shape and torch.equal(g, w), k
    sel = torch.randint(0, 4, keys.shape, generator=gen, dtype=torch.int32)
    for k in ("vdata", "wts_hi"):
        assert torch.equal(teng.read_rows2(ec, sharded[k], keys, sel), teng.read_rows2(dense, store[k], keys, sel)), k
    assert all(torch.equal(a, b) for a, b in zip(teng.global_store(ec, sharded).values(), store.values()))


@pytest.mark.parametrize("n_shards,plane,G", CASES, ids=IDS)
def test_node_writes_equal_dense_scatters(n_shards, plane, G):
    """Set and add, with masked-off requests at the global drop sentinel
    and repeated rows (adds accumulate), rows and (row, slot) pairs."""
    dense, ec = _configs(n_shards, plane, G)
    gen = torch.Generator().manual_seed(100 + n_shards * 10 + G)
    store = _store(dense, gen)
    sharded = {k: _shard(ec, v) for k, v in store.items()}
    keys = _keys(dense, gen).reshape(-1)
    keys[1] = keys[0]  # a repeated row
    mask = torch.rand(keys.shape, generator=gen) < 0.7
    mask[0] = mask[1] = True
    idx = torch.where(mask, keys, dense.store_rows)
    vals = torch.randint(-9, 9, (keys.shape[0], 2), generator=gen, dtype=torch.int32)
    sel = torch.randint(0, 4, keys.shape, generator=gen, dtype=torch.int32)
    for op in ("set", "add"):
        out = {
            "lock_hi": (teng.write_rows(ec, sharded["lock_hi"], idx, 1, op=op),
                        teng.write_rows(dense, store["lock_hi"], idx, 1, op=op)),
            "data": (teng.write_rows(ec, sharded["data"], idx, vals, op=op),
                     teng.write_rows(dense, store["data"], idx, vals, op=op)),
            "wts_hi": (teng.write_rows2(ec, sharded["wts_hi"], idx, sel, vals[:, 0], op=op),
                       teng.write_rows2(dense, store["wts_hi"], idx, sel, vals[:, 0], op=op)),
            "vdata": (teng.write_rows2(ec, sharded["vdata"], idx, sel, vals, op=op),
                      teng.write_rows2(dense, store["vdata"], idx, sel, vals, op=op)),
        }
        for k, (got, want) in out.items():
            assert isinstance(got, Shards) and len(got) == n_shards
            if op == "set" and k == "lock_hi":
                assert not torch.equal(want, store[k])
            assert torch.equal(teng.global_store(ec, {k: got})[k], want), (op, k)


@pytest.mark.parametrize("n_shards,plane,G", CASES, ids=IDS)
def test_node_cas_and_ts_max_equal_dense(n_shards, plane, G):
    """CAS arbitration on a few hot keys (narrow priorities, so ties and
    lo words decide), which the node mesh runs on the coordinator, and the
    owner-local lexicographic timestamp scatter-max."""
    dense, ec = _configs(n_shards, plane, G)
    gen = torch.Generator().manual_seed(200 + n_shards * 10 + G)
    M = dense.store_rows
    keys = _keys(dense, gen, n=40).reshape(-1)
    hot = torch.randint(0, 6, keys.shape, generator=gen, dtype=torch.int32) * 11  # six hot rows over the nodes
    keys = torch.where(torch.rand(keys.shape, generator=gen) < 0.5, keys - keys % dense.n_records + hot, keys)
    hi = torch.randint(-2, 3, keys.shape, generator=gen, dtype=torch.int32)
    lo = torch.randint(0, 30, keys.shape, generator=gen, dtype=torch.int32)
    act = torch.rand(keys.shape, generator=gen) < 0.8
    want = teng.arb_winner(dense, keys, hi, lo, act)
    got = teng.arb_winner(ec, keys, hi, lo, act)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert int(want.sum()) > 0 and int((act & ~want).sum()) > 0

    r_hi = torch.randint(-3, 3, (M,), generator=gen, dtype=torch.int32)
    r_lo = torch.randint(-3, 3, (M,), generator=gen, dtype=torch.int32)
    idx = torch.where(act, keys, M)
    got = teng.scatter_ts_max(ec, _shard(ec, r_hi), _shard(ec, r_lo), idx, hi, lo, act)
    want = teng.scatter_ts_max(dense, r_hi, r_lo, idx, hi, lo, act)
    g = teng.global_store(ec, {"hi": got[0], "lo": got[1]})
    assert torch.equal(g["hi"], want[0]) and torch.equal(g["lo"], want[1])
    assert not torch.equal(want[0], r_hi)


@pytest.mark.parametrize("n_shards,plane,G", CASES, ids=IDS)
def test_node_service_ranking_equals_dense(n_shards, plane, G):
    """``service_ops`` with a hot destination (ranks past the capacity),
    execution-phase slots, and, with three configs, a primitive that
    differs by config: the node mesh's served flags and loads equal the
    dense ranking's."""
    dense, ec = _configs(n_shards, plane, G)
    gen = torch.Generator().manual_seed(300 + n_shards * 10 + G)
    N = G * dense.n_slots
    keys = _keys(dense, gen)
    hot = torch.rand(keys.shape, generator=gen) < 0.6
    keys = torch.where(hot, keys - keys % dense.n_records + 3, keys)  # node 0 of each config
    st = {"keys": keys, "ts_lo": torch.randint(1, 50, (N,), generator=gen, dtype=torch.int32),
          "exec_left": torch.randint(0, 2, (N,), generator=gen, dtype=torch.int32)}
    op_mask = torch.rand(keys.shape, generator=gen) < 0.9
    cm = CostModel(handler_cap=3, nic_cap=4)  # both capacities below the hot node's load
    rpcs = [True, False] + ([torch.tensor([True, False, True]).repeat_interleave(dense.n_slots)] if G == 3 else [])
    for is_rpc in rpcs:
        want = teng.service_ops(dense, cm, st, op_mask, is_rpc, 7)
        got = teng.service_ops(ec, cm, st, op_mask, is_rpc, 7)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int((op_mask & ~want[0]).sum()) > 0 and int(want[0].sum()) > 0


def test_node_mesh_config_checks():
    dense = teng.EngineConfig(protocol="nowait", n_nodes=4, device="cpu")
    with pytest.raises(ValueError, match="3 device\\(s\\) must divide n_nodes=4"):
        teng.node_mesh_config(dense, ("cpu",) * 3)
    ec = teng.node_mesh_config(dense, ["cpu", "cpu"])
    assert ec.shard == NodeShard(2, ("cpu", "cpu")) and ec.device == "cpu" and ec.records_local == 2 * 16384
    assert teng.node_mesh_config(dense, None).shard == NodeShard(1, ("cpu",))
    with pytest.raises(ValueError, match="already node-sharded"):
        teng.node_mesh_config(ec, ("cpu",))


# ---------------------------------------------------------------------------
# Request-routed planes against the reference's, on 4 forced host devices
# ---------------------------------------------------------------------------

# the inputs, the handler and the calls of tests/test_planes.py, each
# result printed as one JSON line
_REF = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.planes import make_planes

n_nodes, rpn, rw = 4, 8, 2
R = n_nodes * rpn
mesh = Mesh(np.asarray(jax.devices()).reshape(n_nodes), ("node",))
rng = np.random.default_rng(0)
data = jnp.asarray(rng.integers(0, 1000, (R, rw)), jnp.int32)
keys = jnp.asarray(rng.integers(0, R, (n_nodes * 8,)), jnp.int32)
locks = jnp.zeros((R,), jnp.int32).at[5].set(99)
cas_keys = jnp.asarray([5, 5, 9, 9, 9, 12, 3, 3] * n_nodes, jnp.int32)
new = jnp.arange(1, cas_keys.shape[0] + 1, dtype=jnp.int32)
hot = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7] * n_nodes, jnp.int32)

def handler(data_l, addrs, valid):
    replies = jnp.where(valid[:, None], data_l[jnp.clip(addrs, 0, data_l.shape[0] - 1)], 0)
    data_l = data_l.at[jnp.where(valid, addrs, data_l.shape[0])].add(1, mode="drop")
    return data_l, replies

out = {}
for cap in (0, 2):
    os_read, os_cas, rpc_call = make_planes(mesh, "node", rpn, rw, cap=cap)
    for name, k in (("keys", keys), ("hot", hot)):
        out[f"read/{cap}/{name}"] = np.asarray(jax.jit(os_read)(data, k)).tolist()
        d2, rep = jax.jit(lambda d, kk: rpc_call(d, kk, handler))(data, k)
        out[f"rpc/{cap}/{name}"] = [np.asarray(d2).tolist(), np.asarray(rep).tolist()]
    for name, k, l in (("cas", cas_keys, locks), ("hot", hot, jnp.zeros((R,), jnp.int32))):
        l2, won = jax.jit(os_cas)(l, k, new)
        out[f"cas/{cap}/{name}"] = [np.asarray(l2).tolist(), np.asarray(won).astype(int).tolist()]
print(json.dumps(out))
"""


def _ref_planes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_planes():
    n_nodes, rpn, rw = 4, 8, 2
    R = n_nodes * rpn
    rng = np.random.default_rng(0)
    data = torch.tensor(rng.integers(0, 1000, (R, rw)), dtype=torch.int32)
    keys = torch.tensor(rng.integers(0, R, (n_nodes * 8,)), dtype=torch.int32)
    locks = torch.zeros((R,), dtype=torch.int32)
    locks[5] = 99
    cas_keys = torch.tensor([5, 5, 9, 9, 9, 12, 3, 3] * n_nodes, dtype=torch.int32)
    new = torch.arange(1, cas_keys.shape[0] + 1, dtype=torch.int32)
    hot = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7] * n_nodes, dtype=torch.int32)

    def handler(data_l, addrs, valid):
        idx = torch.clamp(addrs, 0, data_l.shape[0] - 1).long()
        replies = torch.where(valid[:, None], data_l[idx], 0)
        data_l = planes.scatter_drop(data_l, torch.where(valid, addrs, data_l.shape[0]), 1, accumulate=True)
        return data_l, replies

    out = {}
    shard = NodeShard(n_nodes, ("cpu",) * n_nodes)
    for cap in (0, 2):
        os_read, os_cas, rpc_call = make_planes(shard, rpn, rw, cap=cap)
        for name, k in (("keys", keys), ("hot", hot)):
            out[f"read/{cap}/{name}"] = os_read(data, k).tolist()
            d2, rep = rpc_call(data, k, handler)
            out[f"rpc/{cap}/{name}"] = [d2.tolist(), rep.tolist()]
        for name, k, lk in (("cas", cas_keys, locks), ("hot", hot, torch.zeros((R,), dtype=torch.int32))):
            l2, won = os_cas(lk, k, new)
            assert won.dtype == torch.bool
            out[f"cas/{cap}/{name}"] = [l2.tolist(), won.to(torch.int64).tolist()]
    return out, data, keys


def test_make_planes_match_reference_on_4_forced_host_devices():
    """os_read, os_cas and rpc_call, lossless and at cap 2 (requests past
    the cap dropped: zero replies, never won), equal the reference's."""
    want = _ref_planes()
    got, data, keys = _port_planes()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    # and the dense semantics the reference's own test pins
    assert got["read/0/keys"] == data[keys.long()].tolist()
    assert sum(got["cas/0/cas"][1]) == 3 and got["cas/0/cas"][0][5] == 99
    assert any(v == [0, 0] for v in got["read/2/hot"])
