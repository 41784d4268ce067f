"""The weight draws' card path, run here on the CPU: ``_chunked_draw`` with
``table=True`` hashes its counts in int32 (``_threefry2x32_i32``) and looks
each element up in its map's table of the top 23 random bits
(``_top23_table``).  It must give the plain path's values bitwise (int64
threefry, the map applied to every element), and so the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

MAPS = {"truncated_normal": lambda: prng._truncated_normal_fn(-2.0, 2.0), "normal": prng._normal_fn}


def test_int32_threefry_is_the_int64_form():
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.integers(0, 2**32, 2, dtype=np.int64))
    x0, x1 = (torch.from_numpy(rng.integers(0, 2**32, 100_003, dtype=np.int64)) for _ in range(2))
    for hi in (x0, 0):
        want = prng.threefry2x32(k[0:1], k[1:2], hi, x1)
        got = prng._threefry2x32_i32(prng._i32(k[0:1]), prng._i32(k[1:2]), prng._i32(hi), prng._i32(x1))
        for w, g in zip(want, got):
            assert g.dtype == torch.int32 and torch.equal(prng._i32(w), g)


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("shape,start,stop,chunk", [
    ((1000, 37), 0, None, 4099),
    ((2**33,), 2**31 - 5000, 2**31 + 5000, 4096),  # the low count word past int32
    ((2**33 + 3,), 2**32 - 3000, 2**32 + 3000, 4096),  # the high count word from 0 to 1
])
def test_table_draw_is_the_plain_draw(name, shape, start, stop, chunk):
    key = prng.fold_in(prng.prng_key(7), 3)
    fn = MAPS[name]()
    plain = prng._chunked_draw(key, shape, fn, start, stop, chunk=chunk, table=False)
    table = prng._chunked_draw(key, shape, fn, start, stop, chunk=chunk, table=True)
    assert torch.equal(plain.view(torch.int32), table.view(torch.int32))


@pytest.mark.parametrize("seed,shape", [(0, (128, 384)), (2**31 - 1, (3, 4, 5))])
def test_table_draw_matches_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tkey = prng.fold_in(prng.prng_key(seed), 11)
    want = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32))
    got = prng._chunked_draw(tkey, shape, MAPS["truncated_normal"](), chunk=997, table=True).reshape(shape)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng._chunked_draw(tkey, shape, MAPS["normal"](), chunk=997, table=True).reshape(shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_refuses_a_map_of_all_32_bits():
    with pytest.raises(ValueError, match="top 23"):
        prng._chunked_draw(prng.prng_key(0), (8,), lambda b: b, table=True, dtype=torch.int64)
    # on the CPU by default, and for such a map on any device, the plain path
    bits = prng._chunked_draw(prng.prng_key(0), (8,), lambda b: b, dtype=torch.int64)
    assert torch.equal(bits, prng.random_bits(prng.prng_key(0), (8,)))
