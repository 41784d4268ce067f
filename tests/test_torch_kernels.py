"""The port's kernels against the JAX kernels and their plain references.

On the CPU each kernel wrapper runs its plain version; those are held
bitwise against the Pallas kernels in interpret mode and against
``repro.kernels.ref``.  The CUDA kernels against their plain versions are
in ``tests/test_torch_cuda.py``, which imports no JAX so that it runs on
the card's machine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.arbiter import scatter_min_winner as j_scatter_min_winner
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.lock_arbiter import lock_arbiter as j_lock_arbiter
from repro.kernels.multi_read import multi_read as j_multi_read
from repro.kernels.mvcc_version_select import mvcc_version_select as j_mvcc_version_select
from repro.kernels.ops import attention_op as j_attention_op
from repro.kernels.ops import gather_many as j_gather_many
from repro.kernels.ops import version_select as j_version_select
from repro_torch.core.arbiter import scatter_min_winner
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lock_arbiter import lock_arbiter, pack_prio
from repro_torch.kernels.ref import lock_arbiter_ref
from repro_torch.kernels.multi_read import multi_read, multi_read_many
from repro_torch.kernels.mvcc_version_select import mvcc_version_read, mvcc_version_select
from repro_torch.kernels.ref import mvcc_version_select_ref

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arbiter_case(G, M, n_keys, seed, *, ties=False, pad=False):
    """Random arbitration batch: unique (hi, lo) per group unless ``ties``
    (then pairs share a priority and several requests win), inactive rows,
    and, with ``pad``, a tail of inactive -1 padding keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, (G, M)).astype(np.int32)
    hi = rng.integers(-3, 4, (G, M)).astype(np.int32)  # narrow: lo decides often
    lo = np.stack([rng.permutation(M) for _ in range(G)]).astype(np.int32).reshape(G, M)
    if ties:
        lo //= 2
        hi[:] = 1
    act = rng.random((G, M)) < 0.7
    if pad and M:
        tail = max(1, M // 4)
        keys[:, -tail:] = -1
        act[:, -tail:] = False
    return keys, hi, lo, act


ARBITER_CASES = [
    (G, M, n_keys, ties, pad)
    for G in (1, 3)
    for M in (1, 37, 480)
    for n_keys, ties, pad in ((7, False, False), (500, False, True), (5, True, False), (11, True, True))
]


@pytest.mark.parametrize("G,M,n_keys,ties,pad", ARBITER_CASES)
def test_lock_arbiter_plain_matches_pallas_and_ref(G, M, n_keys, ties, pad):
    keys, hi, lo, act = _arbiter_case(G, M, n_keys, G * 1000 + M + n_keys, ties=ties, pad=pad)
    got = lock_arbiter(*map(torch.tensor, (keys, hi, lo, act))).numpy()
    pallas = np.asarray(j_lock_arbiter(*map(jnp.asarray, (keys, hi, lo, act)), interpret=True))
    jax_ref = np.asarray(jref.lock_arbiter_ref(*map(jnp.asarray, (keys, hi, lo, act))))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jax_ref)


def test_lock_arbiter_exact_tie_leaves_several_winners():
    keys = np.array([[5, 5, 5, 2, -1]], np.int32)
    hi = np.array([[1, 1, 2, 0, -9]], np.int32)
    lo = np.array([[3, 3, 0, 0, -9]], np.int32)
    act = np.array([[True, True, True, True, False]])
    got = lock_arbiter(*map(torch.tensor, (keys, hi, lo, act))).numpy()
    np.testing.assert_array_equal(got, [[True, True, False, True, False]])
    np.testing.assert_array_equal(got, np.asarray(j_lock_arbiter(*map(jnp.asarray, (keys, hi, lo, act)), interpret=True)))


EXTREMES = [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX]
int32s = st.one_of(st.sampled_from(EXTREMES), st.integers(I32_MIN, I32_MAX))


@settings(max_examples=300, deadline=None)
@given(a=st.tuples(int32s, int32s), b=st.tuples(int32s, int32s))
def test_pack_prio_orders_as_signed_lexicographic(a, b):
    """The kernel's 64-bit packing: unsigned order == signed (hi, lo) order."""
    pa, pb = (int(pack_prio(np.array([h], np.int32), np.array([l], np.int32))[0]) for h, l in (a, b))
    assert (pa < pb) == (a < b) and (pa == pb) == (a == b)


def _hash_table_arbiter(keys, hi, lo, act):
    """The CUDA kernel's algorithm in numpy: per group and key, the minimum
    packed priority over the active requests; a request wins iff it is
    active and its packed priority equals its key's minimum."""
    won = np.zeros(keys.shape, bool)
    packed = pack_prio(hi, lo)
    for g in range(keys.shape[0]):
        best = {}
        for key, p, a in zip(keys[g].tolist(), packed[g].tolist(), act[g].tolist()):
            if a:
                best[key] = min(best.get(key, p), p)
        won[g] = [bool(a) and best[key] == p for key, p, a in zip(keys[g].tolist(), packed[g].tolist(), act[g].tolist())]
    return won


def _extreme_case(G, M, seed, n_words=len(EXTREMES)):
    rng = np.random.default_rng(seed)
    words = np.array(EXTREMES[:n_words], np.int32)
    keys, hi, lo = (words[rng.integers(0, n_words, (G, M))] for _ in range(3))
    return keys, hi, lo, rng.random((G, M)) < 0.7


@pytest.mark.parametrize(
    "case",
    [("random", 1, 480, 7, False, False), ("ties+pad", 3, 37, 11, True, True), ("one key", 1, 64, 1, False, False),
     ("one key, ties", 2, 64, 1, True, False), ("extremes", 2, 96, None, None, None), ("M=1", 3, 1, 1, False, False)],
    ids=lambda c: c[0],
)
def test_lock_arbiter_hash_table_algorithm_matches_ref_and_pallas(case):
    """Per-key min of the packed word, then equality, is the arbiter: equal
    to the plain version, the JAX reference and the Pallas kernel (interpret
    mode), ties (several winners) and inactive padding included."""
    name, G, M, n_keys, ties, pad = case
    if name == "extremes":
        keys, hi, lo, act = _extreme_case(G, M, 7)
    else:
        keys, hi, lo, act = _arbiter_case(G, M, n_keys, G * 31 + M, ties=ties, pad=pad)
    mirror = _hash_table_arbiter(keys, hi, lo, act)
    np.testing.assert_array_equal(mirror, lock_arbiter_ref(*map(torch.tensor, (keys, hi, lo, act))).numpy())
    np.testing.assert_array_equal(mirror, np.asarray(jref.lock_arbiter_ref(*map(jnp.asarray, (keys, hi, lo, act)))))
    np.testing.assert_array_equal(
        mirror, np.asarray(j_lock_arbiter(*map(jnp.asarray, (keys, hi, lo, act)), interpret=True)))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n_words=st.integers(1, len(EXTREMES)))
def test_lock_arbiter_hash_table_algorithm_on_extreme_words(seed, n_words):
    """Keys, hi and lo drawn from few int32 extremes (many same-key requests
    and exact ties): the mirror equals the plain version and the JAX one."""
    keys, hi, lo, act = _extreme_case(2, 24, seed, n_words)
    mirror = _hash_table_arbiter(keys, hi, lo, act)
    np.testing.assert_array_equal(mirror, lock_arbiter_ref(*map(torch.tensor, (keys, hi, lo, act))).numpy())
    np.testing.assert_array_equal(mirror, np.asarray(jref.lock_arbiter_ref(*map(jnp.asarray, (keys, hi, lo, act)))))


def test_lock_arbiter_empty_batch():
    z = torch.zeros((3, 0), dtype=torch.int32)
    won = lock_arbiter(z, z, z, torch.zeros((3, 0), dtype=torch.bool))
    assert won.shape == (3, 0) and won.dtype == torch.bool


@pytest.mark.parametrize("R", [37, 1000, 4096])
@pytest.mark.parametrize("M", [1, 37, 480])
@pytest.mark.parametrize("A", [1, 2, 3])
def test_multi_read_plain_matches_pallas_and_ref(R, M, A):
    rng = np.random.default_rng(R * 7 + M * 3 + A)
    table = rng.integers(I32_MIN, I32_MAX, (R, A), dtype=np.int64).astype(np.int32)
    keys = rng.integers(-2, R + 3, M).astype(np.int32)  # -1/-2 padding and keys >= R
    got = multi_read(torch.tensor(table), torch.tensor(keys)).numpy()
    pallas = np.asarray(j_multi_read(jnp.asarray(table), jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    # the JAX ref clamps keys >= R, so it is compared on keys < R only
    inside = keys < R
    jax_ref = np.asarray(jref.multi_read_ref(jnp.asarray(table), jnp.asarray(keys)))
    np.testing.assert_array_equal(got[inside], jax_ref[inside])
    assert (got[(keys < 0) | (keys >= R)] == 0).all()


def test_multi_read_empty_batch():
    out = multi_read(torch.ones((10, 3), dtype=torch.int32), torch.zeros((0,), dtype=torch.int32))
    assert out.shape == (0, 3)


@pytest.mark.parametrize("M,n_records", [(1, 4), (37, 9), (480, 262144), (480, 64)])
@pytest.mark.parametrize("ties", [False, True])
def test_scatter_min_winner_matches_jax(M, n_records, ties):
    keys, hi, lo, act = _arbiter_case(1, M, n_records, M + n_records, ties=ties)
    args = (keys[0], hi[0], lo[0], act[0])
    got = scatter_min_winner(*map(torch.tensor, args), n_records).numpy()
    want = np.asarray(j_scatter_min_winner(*map(jnp.asarray, args), n_records))
    np.testing.assert_array_equal(got, want)
    # and the kernel plane's dispatch gives the same winners
    kern = ops.cas_arbitrate(*map(torch.tensor, args), n_records, plane=ops.KERNEL).numpy()
    np.testing.assert_array_equal(kern, want)


# the main paths' gather_many array sets: name -> the arrays' shapes after R
GATHER_SETS = {
    "wts_hi|wts_lo, S=4": ((4,), (4,)),
    "lock_hi|lock_lo": ((), ()),
    "data|ver, rw=2": ((2,), ()),
    "data|ver, rw=16": ((16,), ()),
    "wts_hi|wts_lo|ver": ((4,), (4,), ()),
    "lock_hi|lock_lo|rts_hi": ((), (), ()),
}


def _gather_case(shapes, R, N, K, seed, *, outside):
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(I32_MIN, I32_MAX, (R,) + s, dtype=np.int64).astype(np.int32) for s in shapes]
    lo, hi = (-3, R + 3) if outside else (0, R)
    return arrs, rng.integers(lo, hi, (N, K)).astype(np.int32)


@pytest.mark.parametrize("outside", [False, True], ids=["keys in [0, R)", "keys in [-3, R+3)"])
@pytest.mark.parametrize("name", list(GATHER_SETS))
def test_gather_many_matches_pallas_and_jnp(name, outside):
    """The kernel plane's multi-array gather (its plain version on CPU
    tensors) bitwise against the reference's ``ops.gather_many`` on its
    pallas_interpret plane (the packed-table Pallas kernel, zero rows for
    keys outside [0, R)) and, for keys in range, its jnp plane; the port's
    torch plane too where it is defined (keys in range)."""
    arrs, keys = _gather_case(GATHER_SETS[name], 97, 12, 10, len(name) * 7 + outside, outside=outside)
    got = ops.gather_many([torch.tensor(a) for a in arrs], torch.tensor(keys), plane=ops.KERNEL)
    jarrs, jkeys = [jnp.asarray(a) for a in arrs], jnp.asarray(keys)
    planes = ("pallas_interpret", "jnp") if not outside else ("pallas_interpret",)
    wants = [j_gather_many(jarrs, jkeys, plane=p) for p in planes]
    if not outside:
        wants.append(ops.gather_many([torch.tensor(a) for a in arrs], torch.tensor(keys), plane=ops.TORCH))
    assert len(got) == len(arrs)
    for i, (g, a) in enumerate(zip(got, arrs)):
        assert tuple(g.shape) == keys.shape + a.shape[1:] and g.is_contiguous()
        for want in wants:
            np.testing.assert_array_equal(g.numpy(), np.asarray(want[i]), err_msg=f"{name} array {i}")
    if outside:
        bad = (keys < 0) | (keys >= 97)
        assert all((g.numpy()[bad] == 0).all() for g in got)


def _read_case(R, N, K, S, seed, *, outside):
    """A store's wts and lock words (narrow: empty slots, ties, ctts == wts
    and lock == ctts all occur), keys (N, K) and one ctts pair per row."""
    rng = np.random.default_rng(seed)
    wh, wl = (rng.integers(-1, 3, (R, S)).astype(np.int32) for _ in range(2))
    lh, ll = (rng.integers(-1, 2, R).astype(np.int32) for _ in range(2))
    lo, hi = (-3, R + 3) if outside else (0, R)
    keys = rng.integers(lo, hi, (N, K)).astype(np.int32)
    ch, cl = (rng.integers(-1, 3, N).astype(np.int32) for _ in range(2))
    return wh, wl, lh, ll, keys, ch, cl


@pytest.mark.parametrize("outside", [False, True], ids=["keys in [0, R)", "keys in [-3, R+3)"])
@pytest.mark.parametrize("with_lock", [True, False])
@pytest.mark.parametrize("S", [1, 2, 4, 16])
def test_version_read_matches_pallas_gather_and_select(S, with_lock, outside):
    """The fused version read (its plain version on CPU tensors) bitwise
    against the reference's ``ops.gather_many`` + ``ops.version_select`` on
    the pallas_interpret plane: the wts rows (and lock pair) gathered at
    keys, ctts expanded to one pair per op, then the Pallas pick."""
    wh, wl, lh, ll, keys, ch, cl = _read_case(61, 8, 10, S, S * 13 + with_lock * 2 + outside, outside=outside)
    lock = (torch.tensor(lh), torch.tensor(ll)) if with_lock else (None, None)
    got = ops.version_read(torch.tensor(wh), torch.tensor(wl), torch.tensor(keys), torch.tensor(ch),
                           torch.tensor(cl), *lock)
    jkeys = jnp.asarray(keys)
    jwh, jwl, jlh, jll = j_gather_many([jnp.asarray(a) for a in (wh, wl, lh, ll)], jkeys, plane="pallas_interpret")
    M = keys.size
    jch, jcl = (jnp.repeat(jnp.asarray(c), keys.shape[1]) for c in (ch, cl))
    found, slot, ok = j_version_select(jwh.reshape(M, S), jwl.reshape(M, S), jch, jcl, jlh.reshape(M), jll.reshape(M),
                                       plane="pallas_interpret")
    want = [found, slot, ok if with_lock else None, jwh, jwl]
    for name, g, w in zip(("found", "slot", "r2_ok", "rows_hi", "rows_lo"), got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w).reshape(g.shape)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_gather_many_planes_agree_and_unpack():
    rng = np.random.default_rng(3)
    data = torch.tensor(rng.integers(0, 99, (50, 2)), dtype=torch.int32)
    ver = torch.tensor(rng.integers(0, 99, 50), dtype=torch.int32)
    keys = torch.tensor(rng.integers(0, 50, (6, 2)), dtype=torch.int32)
    a = ops.gather_many((data, ver), keys, plane=ops.TORCH)
    b = ops.gather_many((data, ver), keys, plane=ops.KERNEL)
    assert a[0].shape == (6, 2, 2) and a[1].shape == (6, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[0], data[keys.long()]) and torch.equal(a[1], ver[keys.long()])


def test_wrappers_check_inputs_and_count_only_cuda_launches():
    before = (lock_arbiter.launches, multi_read.launches, mvcc_version_select.launches)
    k = torch.zeros((1, 4), dtype=torch.int32)
    b = torch.zeros((1, 4), dtype=torch.bool)
    lock_arbiter(k, k, k, b)
    multi_read(torch.zeros((4, 2), dtype=torch.int32), k[0])
    mvcc_version_select(k, k, k[0, :1], k[0, :1], k[0, :1], k[0, :1])
    assert (lock_arbiter.launches, multi_read.launches, mvcc_version_select.launches) == before  # plain versions ran
    with pytest.raises(ValueError, match="contiguous"):
        mvcc_version_select(torch.zeros((4, 2), dtype=torch.int32).t(), k, k[0, :1], k[0, :1], k[0, :1], k[0, :1])
    with pytest.raises(ValueError, match="shape"):
        mvcc_version_select(k, k, k[0], k[0, :1], k[0, :1], k[0, :1])
    with pytest.raises(TypeError, match="int32"):
        mvcc_version_select(k, k.long(), k[0, :1], k[0, :1], k[0, :1], k[0, :1])
    with pytest.raises(TypeError, match="int32"):
        lock_arbiter(k.long(), k, k, b)
    with pytest.raises(ValueError, match="shape"):
        lock_arbiter(k, k[:, :2], k, b)
    with pytest.raises(ValueError, match="contiguous"):
        multi_read(torch.zeros((2, 4), dtype=torch.int32).t(), k[0])
    with pytest.raises(TypeError, match="int32"):
        multi_read(torch.zeros((4, 2)), k[0])
    # the multi-array gather and the fused version read
    t4 = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 8 arrays"):
        multi_read_many([t4] * 9, k[0])
    with pytest.raises(ValueError, match="R = 4"):
        multi_read_many([t4, torch.zeros((5,), dtype=torch.int32)], k[0])
    with pytest.raises(ValueError, match="contiguous"):
        multi_read_many([t4, torch.zeros((2, 4), dtype=torch.int32).t()], k[0])
    with pytest.raises(ValueError, match=r"keys \(M,\)"):
        multi_read(t4, k)
    assert tuple(multi_read_many([t4], k)[0].shape) == (1, 4, 2)  # keys of any shape
    with pytest.raises(ValueError, match="both lock words"):
        mvcc_version_read(t4, t4, k, k[0, :1], k[0, :1], k[0])
    with pytest.raises(ValueError, match="shape"):
        mvcc_version_read(t4, t4, k, k[0], k[0], k[0], k[0])
    with pytest.raises(ValueError, match="contiguous"):
        mvcc_version_read(t4, t4, t4.t(), k[0, :2], k[0, :2])
    with pytest.raises(ValueError, match="row stride"):
        mvcc_version_select(t4, torch.zeros((4, 4), dtype=torch.int32)[:, :2], k[0], k[0])
    got = mvcc_version_read(t4, t4, k, k[0, :1], k[0, :1])
    assert got[2] is None and tuple(got[3].shape) == (1, 4, 2)
    assert (lock_arbiter.launches, multi_read.launches, mvcc_version_select.launches) == before


def _attn_inputs(B, H, Sq, Sk, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Sk, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Sk, Dh)).astype(np.float32))


FLASH_CASES = [  # (B, H, Sq, Sk, Dh, causal): the reference test's grid, ragged S, Sq != Sk, S = 1
    (B, H, S, S, Dh, causal) for B, H, S, Dh in ((1, 2, 128, 64), (2, 1, 192, 32), (1, 1, 320, 128))
    for causal in (True, False)
] + [
    (1, 2, 65, 65, 64, True), (2, 1, 100, 100, 32, False), (1, 1, 1, 1, 64, True), (1, 2, 1, 1, 128, False),
    (1, 2, 50, 130, 64, False), (2, 1, 130, 50, 32, False), (1, 1, 40, 70, 64, True), (1, 1, 70, 40, 32, True),
    # kimi-k2's head dim
    (1, 2, 130, 130, 112, True), (1, 1, 70, 90, 112, False),
]


@pytest.mark.parametrize("B,H,Sq,Sk,Dh,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(B, H, Sq, Sk, Dh, causal, dtype):
    """The plain version (the wrapper on CPU tensors) against the Pallas
    kernel in interpret mode (64-blocks) and the reference's ``ref``, at the
    reference test's tolerances: 1e-5 in float32, 3e-2 in bfloat16."""
    args = _attn_inputs(B, H, Sq, Sk, Dh, B * 1000 + Sq * 7 + Sk + Dh + causal)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    tol = 1e-5 if dtype == "float32" else 3e-2
    n = flash_attention.launches
    got = flash_attention(*(torch.tensor(a).to(tdt) for a in args), causal=causal)
    assert flash_attention.launches == n  # a CPU tensor runs the plain version
    assert got.dtype == tdt and tuple(got.shape) == (B, H, Sq, Dh)
    jargs = [jnp.asarray(a, jdt) for a in args]
    pallas = j_flash_attention(*jargs, causal=causal, block_q=64, block_k=64, interpret=True)
    want = jref.flash_attention_ref(*jargs, causal=causal)
    for other in (pallas, want):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("plane", [ops.TORCH, ops.KERNEL, ops.AUTO])
def test_attention_op_planes_match_reference(causal, plane):
    """ops.attention_op in the (B, S, H, Dh) layout, both planes, against the
    reference's ``ops.attention_op`` (Pallas in interpret mode on the CPU)."""
    rng = np.random.default_rng(5 + causal)
    q, k, v = (rng.standard_normal((2, 96, 3, 32)).astype(np.float32) for _ in range(3))
    got = ops.attention_op(*map(torch.tensor, (q, k, v)), causal=causal, plane=plane)
    want = j_attention_op(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64, block_k=64)
    assert tuple(got.shape) == (2, 96, 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_flash_attention_takes_strided_views_and_checks_inputs():
    q, k, v = (torch.tensor(a) for a in _attn_inputs(2, 3, 20, 20, 32, 9))
    # (B, S, H, Dh) storage seen as (B, H, S, Dh): no copy needed
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qs.is_contiguous()
    torch.testing.assert_close(flash_attention(qs, ks, vs), flash_attention(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous along Dh"):
        flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="share"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :16], k[..., :16], v[..., :16])
    with pytest.raises(ValueError, match="disagree"):
        flash_attention(q, k[:, :2], v[:, :2])
    with pytest.raises(ValueError, match=r"\(B, H, S, Dh\)"):
        flash_attention(q[0], k[0], v[0])


def _version_case(M, S, seed, kind):
    """A version-select batch of one ``kind``: "random" (narrow words, so
    ties, empty slots and ctts equal to a wts all occur), "empty" (every
    slot (0, 0)), "ctts_eq" (every ctts equals one of its row's wts),
    "ties" (the winning pair repeated in several slots), "lock_eq" (lock ==
    ctts) or "extremes" (int32 MIN/MAX words)."""
    rng = np.random.default_rng(seed)
    wh = rng.integers(-2, 3, (M, S)).astype(np.int32)
    wl = rng.integers(-2, 3, (M, S)).astype(np.int32)
    ch = rng.integers(-2, 3, M).astype(np.int32)
    cl = rng.integers(-2, 3, M).astype(np.int32)
    lh = rng.integers(-1, 2, M).astype(np.int32)
    ll = rng.integers(-1, 2, M).astype(np.int32)
    rows = np.arange(M)
    if kind == "empty":
        wh[:], wl[:] = 0, 0
    elif kind == "ctts_eq" and M:
        pick = rng.integers(0, S, M)
        ch, cl = wh[rows, pick].copy(), wl[rows, pick].copy()
    elif kind == "ties" and M:
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        ch[:], cl[:] = 1, 2
        wh[:, 0] = 0  # slot 0 is below the tie, so the first winner is slot 1
    elif kind == "lock_eq":
        lh, ll = ch.copy(), cl.copy()
    elif kind == "extremes":
        words = np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX], np.int32)
        wh, wl = (words[rng.integers(0, 7, (M, S))] for _ in range(2))
        ch, cl, lh, ll = (words[rng.integers(0, 7, M)] for _ in range(4))
    return wh, wl, ch, cl, lh, ll


VERSION_CASES = [(M, S, kind) for S in (1, 2, 4, 16) for M, kind in (
    (1, "random"), (37, "random"), (2400, "random"), (0, "random"), (37, "empty"), (37, "ctts_eq"),
    (37, "ties"), (37, "lock_eq"), (37, "extremes"),
)]


@pytest.mark.parametrize("M,S,kind", VERSION_CASES)
def test_mvcc_version_select_plain_matches_pallas_and_ref(M, S, kind):
    args = _version_case(M, S, M * 31 + S, kind)
    got = [t.numpy() for t in mvcc_version_select(*map(torch.tensor, args))]
    kern = [t.numpy() for t in ops.version_select(*map(torch.tensor, args))]
    plain = [t.numpy() for t in mvcc_version_select_ref(*map(torch.tensor, args))]
    if M:
        pallas = [np.asarray(t) for t in j_mvcc_version_select(*map(jnp.asarray, args), interpret=True)]
    else:  # the Pallas kernel's grid cannot be empty: its plain reference stands in
        pallas = [np.asarray(t) for t in jref.mvcc_version_select_ref(*map(jnp.asarray, args))]
    jax_ref = [np.asarray(t) for t in jref.mvcc_version_select_ref(*map(jnp.asarray, args))]
    for name, g, k, p, pa, r in zip(("found", "slot", "r2_ok"), got, kern, plain, pallas, jax_ref):
        assert g.dtype == pa.dtype and g.shape == (M,), name
        for other in (k, p, pa, r):
            np.testing.assert_array_equal(g, other, err_msg=f"{name} {kind}")
    if kind == "ties" and S > 1:
        np.testing.assert_array_equal(got[1], 1)
    if kind == "empty":
        assert not got[0].any() and not got[1].any()
    if kind == "ctts_eq":  # strictly below: the equal slot never wins
        wh, wl, ch, cl = args[:4]
        picked = np.stack([wh[np.arange(M), got[1]], wl[np.arange(M), got[1]]])
        assert not (got[0] & (picked[0] == ch) & (picked[1] == cl)).any()


def test_auto_plane_follows_the_device():
    assert ops.resolve_plane("auto", "cpu") == ops.TORCH
    assert ops.resolve_plane("auto", "cuda") == ops.KERNEL
    assert ops.resolve_plane("kernel", "cpu") == ops.KERNEL
    with pytest.raises(ValueError):
        ops.resolve_plane("pallas", "cpu")
