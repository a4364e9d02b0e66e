"""Hamming matrix + masked match-selection ops."""

import jax.numpy as jnp
import numpy as np
import pytest

from gfplslam_tpu.ops import matching
from gfplslam_tpu.ops.hamming import BIG, hamming_matrix


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def test_hamming_matches_numpy(rng):
    a, b = rand_desc(rng, 32), rand_desc(rng, 48)
    d = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref = np.zeros((32, 48), np.uint32)
    for i in range(32):
        for j in range(48):
            ref[i, j] = bin(int.from_bytes(a[i].tobytes(), "little")
                            ^ int.from_bytes(b[j].tobytes(), "little")).count("1")
    np.testing.assert_array_equal(d, ref)


def popcount_reference(a, b, rows=64):
    """Hamming distances by unpacking every XOR word into bits."""
    out = np.empty((len(a), len(b)), np.uint32)
    for s in range(0, len(a), rows):
        x = a[s:s + rows, None, :] ^ b[None, :, :]
        out[s:s + rows] = np.unpackbits(
            x.view(np.uint8), axis=-1).sum(-1, dtype=np.uint32)
    return out


@pytest.mark.parametrize("n,m", [(256, 128), (1024, 512), (100, 60)])
def test_hamming_matrix_matches_popcount_reference(rng, n, m):
    """The capacity shapes (stereo/tracker points, lines) and one that no
    tile size divides."""
    a, b = rand_desc(rng, n), rand_desc(rng, m)
    d = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d, popcount_reference(a, b))


def test_hamming_matrix_masking_consistency(rng):
    a, b = rand_desc(rng, 256), rand_desc(rng, 128)
    va = np.arange(256) % 3 != 0
    vb = np.arange(128) % 2 == 0
    d = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(va), jnp.asarray(vb)))
    assert (d[~va] == int(BIG)).all()
    assert (d[:, ~vb] == int(BIG)).all()
    live = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d[np.ix_(va, vb)], live[np.ix_(va, vb)])


def test_hamming_mask(rng):
    a, b = rand_desc(rng, 8), rand_desc(rng, 8)
    va = np.array([True] * 4 + [False] * 4)
    d = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                  valid_a=jnp.asarray(va)))
    assert np.all(d[4:] == int(BIG))


def test_mutual_best_identity(rng):
    a = rand_desc(rng, 16)
    d = hamming_matrix(jnp.asarray(a), jnp.asarray(a))
    m = matching.mutual_best(d)
    np.testing.assert_array_equal(np.asarray(m.idx), np.arange(16))
    assert np.all(np.asarray(m.valid))
    assert np.all(np.asarray(m.dist) == 0)


def test_mutual_best_rejects_one_sided():
    # row 0 prefers col 0, but col 0 prefers row 1 -> row 0 invalid
    d = jnp.asarray([[5.0, 9.0], [1.0, 8.0]])
    m = matching.mutual_best(d)
    assert not bool(m.valid[0])
    assert bool(m.valid[1])


def test_budget_gate():
    m = matching.Matches(idx=jnp.arange(6),
                         dist=jnp.asarray([3.0, 1.0, 5.0, 2.0, 4.0, 0.5]),
                         valid=jnp.ones(6, bool))
    g = matching.budget_gate(m, 3)
    np.testing.assert_array_equal(np.asarray(g.valid),
                                  [False, True, False, True, False, True])


def test_dedup_per_target():
    # rows 0,1 both match target 2; row 1 closer -> row 0 dropped
    m = matching.Matches(idx=jnp.asarray([2, 2, 0]),
                         dist=jnp.asarray([4.0, 2.0, 1.0]),
                         valid=jnp.ones(3, bool))
    g = matching.dedup_per_target(m, 4)
    np.testing.assert_array_equal(np.asarray(g.valid), [False, True, True])


def test_ratio_gate():
    d = jnp.asarray([[1.0, 10.0], [9.0, 10.0]])
    i1, d1, d2 = matching.best2(d)
    m = matching.Matches(idx=i1, dist=d1, valid=jnp.ones(2, bool))
    g = matching.ratio_gate(m, d2, 0.9)
    assert bool(g.valid[0]) and not bool(g.valid[1])


def test_mad_gate(rng):
    base = rng.normal(10, 1, size=62).astype(np.float32)
    dist = np.concatenate([base, [200.0, 250.0]]).astype(np.float32)
    m = matching.Matches(idx=jnp.zeros(64, jnp.int32), dist=jnp.asarray(dist),
                         valid=jnp.ones(64, bool))
    g = matching.mad_gate(m, 5.0)
    v = np.asarray(g.valid)
    assert not v[62] and not v[63]
    assert v[:62].sum() > 55
