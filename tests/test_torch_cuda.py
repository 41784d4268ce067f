"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips without a card.  The file imports
no JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lock_arbiter import lock_arbiter
from repro_torch.kernels.multi_read import multi_read, multi_read_many
from repro_torch.kernels.mvcc_version_select import mvcc_version_read, mvcc_version_select

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and launch the CUDA kernels")
    return torch.device("cuda")


I32_WORDS = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)


def _arbiter_case(G, M, n_keys, seed, *, ties=False, pad=False, extremes=False):
    """Random batch: inactive rows, narrow priorities; ``ties`` makes pairs
    share a priority, ``pad`` adds a tail of inactive -1 keys, ``extremes``
    draws keys and priorities from the int32 extremes."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, (G, M)).astype(np.int32)
    hi = rng.integers(-3, 4, (G, M)).astype(np.int32)
    lo = np.stack([rng.permutation(M) for _ in range(G)]).astype(np.int32).reshape(G, M)
    if ties:
        lo //= 2
    if extremes:
        keys, hi, lo = (I32_WORDS[rng.integers(0, len(I32_WORDS), (G, M))] for _ in range(3))
    act = rng.random((G, M)) < 0.7
    if pad and M:
        keys[:, -max(1, M // 4):] = -1
        act[:, -max(1, M // 4):] = False
    return keys, hi, lo, act


@pytest.mark.parametrize(
    "G,M,n_keys,ties,pad",
    [(1, 480, 262144, False, False), (1, 480, 64, True, False), (3, 37, 9, False, True), (3, 1, 1, False, False),
     (1, 0, 1, False, False), (1, 2048, 300, True, False), (2, 2048, 40, False, True),
     # one hot key (with and without exact ties), and the global-memory table (M > 4096)
     (1, 2400, 1, False, False), (1, 2400, 1, True, False), (2, 12000, 262144, False, False),
     (2, 12000, 50, True, True)],
)
def test_lock_arbiter_cuda_matches_plain(card, G, M, n_keys, ties, pad):
    args = [torch.tensor(a) for a in _arbiter_case(G, M, n_keys, M + n_keys, ties=ties, pad=pad)]
    n = lock_arbiter.launches
    got = lock_arbiter(*[a.to(card) for a in args])
    assert lock_arbiter.launches == n + (0 if G * M == 0 else 1 if M <= 4096 else 2)
    # the plain version's (G, M, M) pair tensor, a group at a time
    want = torch.cat([ref.lock_arbiter_ref(*(a[g:g + 1] for a in args)) for g in range(G)]) if G else got.cpu()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("G,M", [(1, 2400), (2, 480), (1, 5000)])
def test_lock_arbiter_cuda_int32_extremes(card, G, M):
    args = [torch.tensor(a) for a in _arbiter_case(G, M, 1, G * M, extremes=True)]
    got = lock_arbiter(*[a.to(card) for a in args])
    want = torch.cat([ref.lock_arbiter_ref(*(a[g:g + 1] for a in args)) for g in range(G)])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("R,M,A", [(262144, 480, 2), (262144, 480, 3), (1000, 37, 1), (1000, 0, 2)])
def test_multi_read_cuda_matches_plain(card, R, M, A):
    rng = np.random.default_rng(R + M + A)
    table = torch.tensor(rng.integers(-(2**31), 2**31 - 1, (R, A)), dtype=torch.int32)
    keys = torch.tensor(rng.integers(-3, R + 3, M), dtype=torch.int32)  # padding and keys >= R
    n = multi_read.launches
    got = multi_read(table.to(card), keys.to(card))
    assert multi_read.launches == n + (1 if M else 0)
    assert torch.equal(got.cpu(), ref.multi_read_ref(table, keys))


def _unaligned(t):
    """The same values in storage that starts 4 bytes past a 16-byte
    boundary: a contiguous view the kernels' 16-byte paths must refuse."""
    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize(
    "M,shapes,R,unaligned",
    [(480, ((2,), ()), 262144, False), (480, ((), ()), 262144, False), (2400, ((4,), (4,)), 262144, False),
     (2400, ((16,), ()), 262144, False), (2400, ((4,), (4,), ()), 262144, False), (2400, ((), (), ()), 1000, False),
     (12000, ((3,), (9,), (8,), (1,)), 1000, False), (37, ((4,), (16,)), 1000, True), (0, ((4,), ()), 1000, False),
     (480, ((2, 2), (3, 3)), 50, True), (1, ((4,),), 1, False)],
)
def test_multi_read_many_cuda_matches_plain(card, M, shapes, R, unaligned):
    """1 to 4 arrays of widths 1 to 16 read in place in one launch, keys in
    [-3, R+3); ``unaligned`` makes every array a view 4 bytes past a 16-byte
    boundary, so the scalar path runs."""
    gen = torch.Generator().manual_seed(M + R + len(shapes))
    arrs = [torch.randint(-(2**31), 2**31 - 1, (R,) + s, generator=gen, dtype=torch.int32) for s in shapes]
    keys = torch.randint(-3, R + 3, (M,), generator=gen, dtype=torch.int32)
    on_card = [a.to(card) for a in arrs]
    if unaligned:
        on_card = [_unaligned(a) for a in on_card]
        assert all(a.data_ptr() % 16 for a in on_card)
    n = multi_read.launches
    got = multi_read_many(on_card, keys.to(card))
    assert multi_read.launches == n + (1 if M else 0)
    for g, w in zip(got, ref.gather_many_ref(arrs, keys)):
        assert g.is_contiguous() and torch.equal(g.cpu(), w)


def _store_case(R, N, K, S, gen, *, extremes=False):
    """An MVCC store's wts and lock words, keys (N, K) in [-3, R+3) and one
    ctts pair per row of keys: narrow words (empty slots, ties, ctts == wts,
    lock == ctts) or the int32 extremes."""
    def words(*shape):
        if extremes:
            return I32_WORDS_T[torch.randint(0, len(I32_WORDS), shape, generator=gen)]
        return torch.randint(-1, 3, shape, generator=gen, dtype=torch.int32)

    wh, wl, lh, ll, ch, cl = words(R, S), words(R, S), words(R), words(R), words(N), words(N)
    keys = torch.randint(-3, R + 3, (N, K), generator=gen, dtype=torch.int32)
    return wh, wl, lh, ll, keys, ch, cl


I32_WORDS_T = torch.tensor(I32_WORDS)


@pytest.mark.parametrize(
    "R,N,K,S,with_lock,kind",
    [(262144, 240, 10, 4, True, "narrow"), (262144, 240, 10, 4, False, "narrow"), (1000, 240, 10, 1, True, "narrow"),
     (1000, 240, 10, 2, False, "narrow"), (1000, 37, 3, 16, True, "narrow"), (1000, 1200, 10, 4, True, "narrow"),
     (50, 40, 10, 4, True, "extremes"), (50, 40, 10, 16, False, "extremes"), (1000, 0, 10, 4, True, "narrow"),
     (1000, 37, 10, 4, True, "unaligned"), (1000, 37, 10, 8, False, "unaligned")],
)
def test_mvcc_version_read_cuda_matches_plain(card, R, N, K, S, with_lock, kind):
    """The fused read in one launch: gathered rows, found, slot and r2_ok
    exactly as the plain version's masked gather + pick."""
    gen = torch.Generator().manual_seed(R + N * K + S + with_lock)
    wh, wl, lh, ll, keys, ch, cl = _store_case(R, N, K, S, gen, extremes=kind == "extremes")
    lock = (lh, ll) if with_lock else (None, None)
    on_card = [None if t is None else t.to(card) for t in (wh, wl, keys, ch, cl) + lock]
    if kind == "unaligned":
        on_card[0], on_card[1] = _unaligned(on_card[0]), _unaligned(on_card[1])
    n = mvcc_version_select.launches
    got = mvcc_version_read(*on_card)
    assert mvcc_version_select.launches == n + (1 if N * K else 0)
    want = ref.version_read_ref(wh, wl, keys, ch, cl, *lock)
    for name, g, w in zip(("found", "slot", "r2_ok", "rows_hi", "rows_lo"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("S", [1, 4, 16])
def test_mvcc_version_select_cuda_reads_row_views(card, S):
    """Op rows seen through a row stride (column slices of one (M, 2S)
    table) and one ctts pair per transaction of K = 10 ops, with and
    without the lock: read in place, one launch."""
    gen = torch.Generator().manual_seed(S)
    M, N = 2400, 240
    table = torch.randint(-1, 3, (M, 2 * S), generator=gen, dtype=torch.int32)
    ch, cl, lh, ll = (torch.randint(-1, 3, (n,), generator=gen, dtype=torch.int32) for n in (N, N, M, M))
    t = table.to(card)
    for lock in ((lh, ll), (None, None)):
        n = mvcc_version_select.launches
        got = mvcc_version_select(t[:, :S], t[:, S:], ch.to(card), cl.to(card),
                                  *(None if x is None else x.to(card) for x in lock))
        assert mvcc_version_select.launches == n + 1
        z = torch.zeros(M, dtype=torch.int32)
        want = ref.mvcc_version_select_ref(table[:, :S], table[:, S:], ch.repeat_interleave(10),
                                           cl.repeat_interleave(10), *(z if x is None else x for x in lock))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert (got[2] is None) if lock[0] is None else torch.equal(got[2].cpu(), want[2])


def _version_case(M, S, seed, kind):
    """Narrow words (ties, empty slots, ctts == wts all occur) or one edge
    case: all slots empty, ctts equal to a wts, tied winners, lock == ctts,
    int32 extremes."""
    rng = np.random.default_rng(seed)
    wh, wl = (rng.integers(-2, 3, (M, S)).astype(np.int32) for _ in range(2))
    ch, cl = (rng.integers(-2, 3, M).astype(np.int32) for _ in range(2))
    lh, ll = (rng.integers(-1, 2, M).astype(np.int32) for _ in range(2))
    if kind == "empty":
        wh[:], wl[:] = 0, 0
    elif kind == "ctts_eq" and M:
        pick = rng.integers(0, S, M)
        ch, cl = wh[np.arange(M), pick].copy(), wl[np.arange(M), pick].copy()
    elif kind == "ties":
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        wh[:, 0] = 0
        ch[:], cl[:] = 1, 2
    elif kind == "lock_eq":
        lh, ll = ch.copy(), cl.copy()
    elif kind == "extremes":
        words = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)
        wh, wl = (words[rng.integers(0, 7, (M, S))] for _ in range(2))
        ch, cl, lh, ll = (words[rng.integers(0, 7, M)] for _ in range(4))
    return [torch.tensor(a) for a in (wh, wl, ch, cl, lh, ll)]


@pytest.mark.parametrize(
    "M,S,kind",
    [(2400, 4, "random"), (2400, 1, "random"), (2400, 16, "random"), (0, 4, "random"), (1, 3, "random"),
     (37, 8, "empty"), (37, 4, "ctts_eq"), (37, 4, "ties"), (37, 2, "lock_eq"), (37, 4, "extremes")],
)
def test_mvcc_version_select_cuda_matches_plain(card, M, S, kind):
    args = _version_case(M, S, M * 7 + S, kind)
    n = mvcc_version_select.launches
    got = mvcc_version_select(*[a.to(card) for a in args])
    assert mvcc_version_select.launches == n + (1 if M else 0)
    for g, w in zip(got, ref.mvcc_version_select_ref(*args)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if kind == "ties":
        assert bool((got[1] == 1).all())


def _node_config(G, n_shards=4):
    """A paper-width EngineConfig of G configs on a node mesh of one card."""
    from repro_torch.core.engine import EngineConfig, node_mesh_config

    ec = EngineConfig(protocol="nowait", n_nodes=4, records_per_node=65536, n_configs=G, kernel_plane="kernel",
                      device="cuda")
    return node_mesh_config(ec, ("cuda",) * n_shards)


@pytest.mark.parametrize("G,M,n_keys,ties", [(1, 480, 262144, False), (1, 2400, 262144, True), (4, 480, 64, True),
                                             (4, 2400, 262144, False), (2, 12000, 262144, True)])
def test_lock_arbiter_cuda_on_the_node_mesh(card, G, M, n_keys, ties):
    """The node mesh's arbitration: one launch on the coordinator over the
    G*R global rows, a third of the requests on the rows either side of a
    shard boundary; its winners equal the plain version's."""
    from repro_torch.core import engine

    ec = _node_config(G)
    keys, hi, lo, act = (torch.tensor(a) for a in _arbiter_case(G, M, n_keys, G + M, ties=ties))
    r_l = ec.records_local
    edge = torch.tensor([s * r_l + d for s in range(1, 4) for d in (-1, 0)], dtype=torch.int32)
    keys[:, ::3] = edge[torch.arange(keys[:, ::3].numel()) % len(edge)].view(G, -1)
    keys = keys + torch.arange(G, dtype=torch.int32)[:, None] * ec.n_records
    n = lock_arbiter.launches
    got = engine.arb_winner(ec, *(a.reshape(-1).to(card) for a in (keys, hi, lo, act))).cpu()
    assert lock_arbiter.launches == n + (1 if M <= 4096 else 2)  # past 4096 requests: insert and decide
    want = torch.cat([ref.lock_arbiter_ref(*(a[g:g + 1] for a in (keys, hi, lo, act))) for g in range(G)])
    assert torch.equal(got, want.reshape(-1))


@pytest.mark.parametrize("G,M,shapes", [(1, 480, ((), ())), (1, 480, ((2,), ())), (4, 2400, ((4,), (4,), ())),
                                        (64, 480, ((), ()))])
def test_multi_read_cuda_per_shard_keys(card, G, M, shapes):
    """Each shard's gather on its own (G*R_l, ...) arrays with local keys
    outside [0, R_l) (the drop form; at G = 1 also the unclipped
    ``key - s*R_l``): zero rows there, as the plain version; the shards'
    summed replies are the dense gather."""
    from repro_torch.core import planes
    from repro_torch.core.planes import Shards
    from repro_torch.kernels import ops

    ec = _node_config(G)
    gen = torch.Generator().manual_seed(G + M)
    glob = [torch.randint(-(2**31), 2**31 - 1, (G * ec.n_records,) + sh, generator=gen, dtype=torch.int32)
            for sh in shapes]
    split = [Shards(a.view((G, 4, ec.records_local) + sh)[:, s].reshape((-1,) + sh).contiguous().to(card)
                    for s in range(4)) for a, sh in zip(glob, shapes)]
    keys = torch.randint(0, G * ec.n_records, (M,), generator=gen, dtype=torch.int32)
    owner, local = planes.owner_local(ec, keys)
    for s in range(4):
        forms = [planes.local_ix_drop(ec, s, owner, local)] + ([keys - s * ec.records_local] if G == 1 else [])
        for li in forms:
            n = multi_read.launches
            got = ops.gather_many([a[s] for a in split], li.to(card), plane=ops.KERNEL)
            assert multi_read.launches == n + 1
            for g, w in zip(got, ref.gather_many_ref([a[s].cpu() for a in split], li)):
                assert torch.equal(g.cpu(), w)
    got = planes.node_read_batch(ec, split, keys.to(card))
    for g, w in zip(got, ref.gather_many_ref(glob, keys)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("protocol,workload", [("nowait", "smallbank"), ("mvcc", "ycsb"), ("calvin", "ycsb")])
def test_node_layout_on_the_card_matches_dense(card, protocol, workload):
    """Four node shards on the one card: the node row equals the dense
    row (kernel plane, and the torch plane on the CPU), with the node
    path's launches per tick."""
    from repro_torch.api import ExperimentSpec, run

    kw = dict(protocol=protocol, workload=workload, configs=[{"hybrid": 63}], n_nodes=4, coroutines=6,
              records_per_node=64, ticks=32, warmup=4)
    counts = (lock_arbiter.launches, multi_read.launches, mvcc_version_select.launches)
    node = run(ExperimentSpec(kernel_plane="kernel", layout="node", devices=("cuda",) * 4, **kw)).row
    got = tuple(c.launches - n for c, n in zip((lock_arbiter, multi_read, mvcc_version_select), counts))
    per_tick = {"nowait": (1, 8, 0), "mvcc": (1, 40, 3), "calvin": (0, 0, 0)}[protocol]
    assert got == tuple(p * 36 for p in per_tick)
    dense = run(ExperimentSpec(kernel_plane="kernel", **kw)).row
    cpu = run(ExperimentSpec(kernel_plane="torch", layout="node", devices=("cpu",) * 4, device="cpu", **kw)).row
    for key in ("commits", "aborts", "abort_rate", "avg_round_trips"):
        assert node[key] == dense[key] == cpu[key], key
    assert node["n_node_shards"] == 4


@pytest.mark.parametrize("protocol,workload", [("nowait", "smallbank"), ("mvcc", "ycsb")])
@pytest.mark.parametrize("layout,node_shards", [("config", None), ("config_node", 2)])
def test_config_layouts_on_the_card_match_dense(card, protocol, workload, layout, node_shards):
    """The config axis split over two parts on the one card (three codes,
    so the last part is padded), and on a 2 x 2 config x node mesh: the
    rows equal the dense run's."""
    from repro_torch.api import ExperimentSpec, run

    kw = dict(protocol=protocol, workload=workload, configs=[{"hybrid": c} for c in (0, 63, 21)], n_nodes=4,
              coroutines=6, records_per_node=64, ticks=32, warmup=4, kernel_plane="kernel")
    n_dev = 2 * (node_shards or 1)
    res = run(ExperimentSpec(layout=layout, devices=("cuda",) * n_dev, node_shards=node_shards, **kw))
    assert res.plan.layout == layout and res.plan.n_devices == n_dev
    dense = run(ExperimentSpec(**kw)).rows
    for a, b in zip(res.rows, dense):
        for key in ("hybrid", "commits", "aborts", "abort_rate", "avg_round_trips", "throughput_mtps"):
            assert a[key] == b[key], key
        assert a["n_node_shards"] == (node_shards or 1)


@pytest.mark.parametrize("protocol,workload", [("nowait", "smallbank"), ("mvcc", "ycsb")])
def test_kernel_plane_matches_torch_plane_on_the_card(card, protocol, workload):
    from repro_torch.api import ExperimentSpec, run

    kw = dict(protocol=protocol, workload=workload, configs=[{"hybrid": c} for c in (0, 63, 21, 42)],
              n_nodes=2, coroutines=6, records_per_node=64, ticks=32, warmup=4)
    before = (multi_read.launches, mvcc_version_select.launches)
    k_rows = run(ExperimentSpec(kernel_plane="kernel", **kw)).rows
    # per batched tick of the four configs' one bucket: one multi_read launch per gather_many, one
    # mvcc_version_select launch per fused version read
    per_tick = {"nowait": (2, 0), "mvcc": (5, 3)}[protocol]
    n_ticks = 32 + 4
    assert (multi_read.launches - before[0], mvcc_version_select.launches - before[1]) == \
        (per_tick[0] * n_ticks, per_tick[1] * n_ticks)
    t_rows = run(ExperimentSpec(kernel_plane="torch", **kw)).rows
    c_rows = run(ExperimentSpec(kernel_plane="torch", device="cpu", **kw)).rows
    for k, t, c in zip(k_rows, t_rows, c_rows):
        for key in ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips"):
            assert k[key] == t[key] == c[key], key


@pytest.mark.parametrize(
    "B,H,Sq,Sk,Dh,causal",
    [(2, 3, 128, 128, 64, True), (1, 2, 65, 65, 32, False), (1, 1, 1, 1, 128, True), (2, 2, 50, 130, 64, False),
     (1, 4, 320, 320, 128, True), (1, 2, 70, 40, 32, True), (1, 2, 70, 0, 64, True), (2, 3, 190, 190, 112, True),
     (1, 2, 65, 130, 112, False)],
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_flash_attention_cuda_matches_plain(card, B, H, Sq, Sk, Dh, causal, dtype, tol):
    gen = torch.Generator().manual_seed(Sq * 131 + Sk + Dh)
    q = torch.randn((B, Sq, H, Dh), generator=gen).to(dtype).to(card).transpose(1, 2)  # attention_op's views
    k, v = (torch.randn((B, H, Sk, Dh), generator=gen).to(dtype).to(card) for _ in range(2))
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "kind,B,H,Sq,Sk,Dh,causal,dtype,tol",
    [("serving shape, (B, S, H, Dh) views", 4, 32, 2048, 2048, 64, True, torch.float32, 1e-5),
     ("Dh 128, Sq < Sk", 2, 3, 200, 333, 128, True, torch.float32, 1e-5),
     ("Dh 128, Sq > Sk", 2, 3, 333, 200, 128, True, torch.bfloat16, 3e-2),
     ("llama4-scout's prefill head, (B, S, H, Dh) views", 1, 40, 2048, 2048, 128, True, torch.float32, 1e-5),
     ("kimi-k2's head dim, (B, S, H, Dh) views", 1, 64, 2048, 2048, 112, True, torch.float32, 1e-5),
     ("kimi-k2's head dim, Sq < Sk", 2, 3, 200, 333, 112, True, torch.bfloat16, 3e-2),
     ("rows not 16-byte aligned", 2, 3, 130, 130, 112, True, torch.float32, 1e-5),
     ("rows not 16-byte aligned", 2, 3, 130, 130, 64, True, torch.float32, 1e-5),
     ("rows not 16-byte aligned", 2, 3, 77, 90, 32, False, torch.bfloat16, 3e-2)],
)
def test_flash_attention_cuda_layouts(card, kind, B, H, Sq, Sk, Dh, causal, dtype, tol):
    """(B, S, H, Dh) storage seen through a transpose, as attention_op hands
    it over; "not aligned" takes the last Dh of (B, S, H, Dh + 1) rows, so
    the kernel's plain-load path runs."""
    gen = torch.Generator().manual_seed(B * Sq + Sk + Dh)
    extra = 1 if "aligned" in kind else 0

    def view(S):
        t = torch.randn((B, S, H, Dh + extra), generator=gen).to(dtype).to(card)
        return t[..., extra:].transpose(1, 2)

    q, k, v = view(Sq), view(Sk), view(Sk)
    assert (q.data_ptr() % 16 != 0) == bool(extra)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_reduced_serve_on_the_card_matches_the_cpu(card):
    """The serving path at the reduced config: the kernel plane on the card
    against the torch plane on the CPU, same seed (1e-4 on logits, the
    card's serving tolerance in chip_smoke.py; tokens equal)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("stablelm-1.6b")
    kw = dict(batch=3, prompt_len=40, gen_len=8, page_size=16, seed=0)
    n = flash_attention.launches
    on_card = serve(cfg, device="cuda", plane="kernel", **kw)
    assert flash_attention.launches == n + cfg.n_layers
    on_cpu = serve(cfg, device="cpu", plane="torch", **kw)
    assert torch.equal(on_card.prompts.cpu(), on_cpu.prompts)
    torch.testing.assert_close(on_card.logits.cpu(), on_cpu.logits, atol=1e-4, rtol=0)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_reduced_moe_serve_on_the_card_matches_the_cpu(card, arch):
    """The MoE serving path at the reduced config: the kernel plane on the
    card against the torch plane on the CPU, same seed (5e-4 on logits, the
    CPU tests' 5e-5 against the reference with 10x for the card's summation
    order; tokens equal), one flash_attention launch per prefill layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    kw = dict(batch=3, prompt_len=40, gen_len=8, page_size=16, seed=0)
    n = flash_attention.launches
    on_card = serve(cfg, device="cuda", plane="kernel", **kw)
    assert flash_attention.launches == n + cfg.n_layers
    on_cpu = serve(cfg, device="cpu", plane="torch", **kw)
    assert torch.equal(on_card.prompts.cpu(), on_cpu.prompts)
    torch.testing.assert_close(on_card.logits.cpu(), on_cpu.logits, atol=5e-4, rtol=0)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)


def test_pipeline_tokens_on_the_card_equal_the_cpus(card):
    """The synthetic pipeline draws on the card bitwise what it draws on the
    CPU (threefry, XLA's exp and log written out), at full vocabulary."""
    from repro_torch.data.pipeline import make_pipeline

    on_card, on_cpu = (make_pipeline(100352, 4, 2048, seed=0, device=d) for d in ("cuda", "cpu"))
    sc, sp = on_card[0](), on_cpu[0]()
    for _ in range(10):
        sc, bc = on_card[1](sc)
        sp, bp = on_cpu[1](sp)
        assert sc == sp and torch.equal(bc["tokens"].cpu(), bp["tokens"])


def test_reduced_train_step_on_the_card_matches_the_cpu(card):
    """Three AdamW steps at the reduced config, S = 600 (scan-flash attention
    in every block) and S = 64 (naive attention), from the same seed on the
    card and on the CPU: losses within 1e-5, grad_norm within 1e-5 relative,
    parameters within 1e-6 (the CPU tests' tolerances against the
    reference), and no kernel launched."""
    from repro_torch.configs import reduced_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models.lm import init_lm
    from repro_torch.train.steps import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("stablelm-1.6b")
    for seq in (600, 64):
        runs = {}
        for dev in ("cuda", "cpu"):
            step, opt = build_train_step(cfg, "adamw")
            params = init_lm(prng.prng_key(0), cfg, torch.float32, device=dev)
            state = opt.init(dict(params.named_parameters()))
            init, nxt = make_pipeline(cfg.vocab_size, 2, seq, seed=0, device=dev)
            ds, metrics = init(), []
            n = flash_attention.launches
            for i in range(3):
                ds, b = nxt(ds)
                params, state, m = step(params, state, i, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            assert flash_attention.launches == n
            runs[dev] = (metrics, {k: v.cpu() for k, v in params.state_dict().items()})
        for (lc, gc), (lp, gp) in zip(runs["cuda"][0], runs["cpu"][0]):
            assert abs(lc - lp) <= 1e-5 and abs(gc - gp) <= 1e-5 * gp, (seq, lc, lp, gc, gp)
        for k, v in runs["cpu"][1].items():
            torch.testing.assert_close(runs["cuda"][1][k], v, atol=1e-6, rtol=0)


def test_ssm_layer_on_the_card_matches_the_cpu(card):
    """The SSM layer at falcon-mamba's reduced config: the seed's weights
    drawn on the card bitwise those drawn on the CPU, then ``apply_ssm``
    with its state and five chained ``apply_ssm_step`` calls, card against
    CPU within 1e-5 of each output's largest |value| (the CPU tests'
    tolerance against the reference)."""
    from repro_torch.configs import reduced_config
    from repro_torch.core import prng
    from repro_torch.layers import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("falcon-mamba-7b")
    layers = {d: ssm.init_ssm(prng.fold_in(prng.prng_key(0, d), 3), cfg) for d in ("cpu", "cuda")}
    for name in ssm.SSM.NAMES:
        assert torch.equal(getattr(layers["cuda"], name).cpu(), getattr(layers["cpu"], name)), name
    x = torch.tensor(np.random.default_rng(0).standard_normal((3, 300, cfg.d_model)).astype(np.float32))

    def close(got, want, name):
        gap = float((got.cpu() - want).abs().max())
        assert gap <= 1e-5 * float(want.abs().max()), (name, gap)

    with torch.inference_mode():
        out = {d: ssm.apply_ssm(layers[d], cfg, x[:, :295].to(d), return_state=True) for d in ("cpu", "cuda")}
        close(out["cuda"][0], out["cpu"][0], "y")
        for t in range(295, 300):
            ys = {d: ssm.apply_ssm_step(layers[d], cfg, x[:, t : t + 1].to(d), out[d][1])[0] for d in ("cpu", "cuda")}
            close(ys["cuda"], ys["cpu"], f"step {t}")
            close(out["cuda"][1]["h"], out["cpu"][1]["h"], f"h {t}")


def test_reduced_ssm_serve_on_the_card_matches_the_cpu(card):
    """The SSM serving path at falcon-mamba's reduced config: the card
    against the CPU, same seed (1e-4 on logits, 10x the CPU tests' 1e-5
    against the reference; tokens equal); no hand-written kernel launches."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("falcon-mamba-7b")
    kw = dict(batch=3, prompt_len=40, gen_len=8, page_size=16, seed=0)
    n = flash_attention.launches
    on_card = serve(cfg, device="cuda", plane="kernel", **kw)
    assert flash_attention.launches == n
    on_cpu = serve(cfg, device="cpu", plane="torch", **kw)
    assert torch.equal(on_card.prompts.cpu(), on_cpu.prompts)
    torch.testing.assert_close(on_card.logits.cpu(), on_cpu.logits, atol=1e-4, rtol=0)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
