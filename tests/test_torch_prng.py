"""repro_torch.core.prng against jax.random, bitwise (default
jax_threefry_partitionable=True mode), over many seeds and the exact
shapes SmallBank draws, plus SmallBank's vectorised ``gen`` against the
JAX one under vmap."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.workloads import make_workload as jmake_workload
from repro_torch.core import prng
from repro_torch.workloads import make_workload as tmake_workload

I32 = np.iinfo(np.int32)
SEEDS = np.concatenate(
    [[0, 1, 42, -1, I32.min, I32.max], np.random.default_rng(0).integers(I32.min, I32.max, 58)]
).astype(np.int32)


def _jkeys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))


def _tkeys(seeds):
    return torch.stack([prng.prng_key(int(s)) for s in seeds])


def _eq(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)  # bitwise, not approximately
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def test_prng_key_matches():
    _eq(_jkeys(SEEDS), _tkeys(SEEDS))
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2**31)


@pytest.mark.parametrize("data", [0, 1, 239, 65535, I32.max, -1])
def test_fold_in_matches(data):
    jk, tk = _jkeys(SEEDS), _tkeys(SEEDS)
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, jnp.int32(data)))(jk), prng.fold_in(tk, torch.tensor(data)))


def test_fold_in_vectorised_data_matches():
    data = np.random.default_rng(1).integers(0, 10**6, len(SEEDS)).astype(np.int32)
    jk, tk = _jkeys(SEEDS), _tkeys(SEEDS)
    _eq(jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data)), prng.fold_in(tk, torch.tensor(data)))


@pytest.mark.parametrize("num", [1, 2, 5, 7])
def test_split_matches(num):
    jk, tk = _jkeys(SEEDS), _tkeys(SEEDS)
    _eq(jax.vmap(lambda k: jax.random.split(k, num))(jk), prng.split(tk, num))


@pytest.mark.parametrize("shape", [(), (2,), (3, 5)])
def test_uniform_matches(shape):
    jk, tk = _jkeys(SEEDS), _tkeys(SEEDS)
    _eq(jax.vmap(lambda k: jax.random.uniform(k, shape))(jk), prng.uniform(tk, shape))
    _eq(
        jax.vmap(lambda k: jax.random.uniform(k, shape, minval=-2.5, maxval=7.0))(jk),
        prng.uniform(tk, shape, -2.5, 7.0),
    )


@pytest.mark.parametrize(
    "minval,maxval",
    [
        (0, 6), (0, 100), (0, 262144), (0, 100 * 4), (-7, 1000),
        # spans above 2**31 hit the mod-2**32 wrap of the squared multiplier
        # and of rem(higher) * multiplier + rem(lower)
        (I32.min, I32.max), (I32.min, 6), (-(2**30), 2**30 + 12345),
        (5, 5), (9, 3),  # empty range: always minval
    ],
)
@pytest.mark.parametrize("shape", [(), (2,), (4, 3)])
def test_randint_matches(minval, maxval, shape):
    jk, tk = _jkeys(SEEDS), _tkeys(SEEDS)
    _eq(
        jax.vmap(lambda k: jax.random.randint(k, shape, minval, maxval))(jk),
        prng.randint(tk, shape, minval, maxval),
    )


@pytest.mark.parametrize("n_records", [128, 262144, 50])
@pytest.mark.parametrize("seed", [0, 7])
def test_smallbank_gen_matches_vmapped_jax(n_records, seed):
    """The engine's draw: fold_in(fold_in(PRNGKey(seed), lsid), txn_no)."""
    jw, tw = jmake_workload("smallbank", n_records), tmake_workload("smallbank", n_records)
    rng = np.random.default_rng(seed)
    lsid = np.arange(240, dtype=np.int32)
    txn_no = rng.integers(0, 5000, 240).astype(np.int32)
    key0 = jax.random.PRNGKey(seed)

    def gen_one(s, t):
        return jw.gen(jax.random.fold_in(jax.random.fold_in(key0, s), t), 0, s)

    want = jax.vmap(gen_one)(jnp.asarray(lsid), jnp.asarray(txn_no))
    keys = prng.fold_in(prng.fold_in(prng.prng_key(seed), torch.tensor(lsid)), torch.tensor(txn_no))
    got = tw.gen(keys, torch.tensor(lsid) // 60, torch.tensor(lsid))
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_records", [128, 262144, 50])
@pytest.mark.parametrize("workload,kw", [("ycsb", {}), ("ycsb", {"hot_prob": 0.6}), ("tpcc", {})])
def test_ycsb_tpcc_gen_and_execute_match_vmapped_jax(workload, kw, n_records):
    """The engine's draw of every slot key by key (randint with a nonzero
    minval, float32 hot/write/remote thresholds, tpcc's shape-() n_items,
    the sequential de-duplication), and the vectorised execute."""
    jw, tw = jmake_workload(workload, n_records, **kw), tmake_workload(workload, n_records, **kw)
    rng = np.random.default_rng(n_records)
    lsid = np.arange(240, dtype=np.int32)
    node = lsid // 60
    txn_no = rng.integers(0, 5000, 240).astype(np.int32)
    key0 = jax.random.PRNGKey(3)

    def gen_one(s, n, t):
        return jw.gen(jax.random.fold_in(jax.random.fold_in(key0, s), t), n, s)

    want = jax.vmap(gen_one)(jnp.asarray(lsid), jnp.asarray(node), jnp.asarray(txn_no))
    keys = prng.fold_in(prng.fold_in(prng.prng_key(3), torch.tensor(lsid)), torch.tensor(txn_no))
    got = tw.gen(keys, torch.tensor(node), torch.tensor(lsid))
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rvals = rng.integers(-100, 100, (240, tw.max_ops, tw.rw)).astype(np.int32)
    np.testing.assert_array_equal(
        tw.execute(*got, torch.tensor(rvals)).numpy(), np.asarray(jax.vmap(jw.execute)(*want, jnp.asarray(rvals)))
    )
