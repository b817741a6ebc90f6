"""The port's counter-based RNG against the JAX package's, bit for bit.

Tolerance: exact equality. Both packages must draw the same bits for every
lane, so the path tracers can be compared per lane."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuturenderer_tpu.utils import rng as jrng
from tuturenderer_tpu_torch.utils import rng as trng

N_KEYS = 100_000


def _keys(seed=0):
    r = np.random.RandomState(seed)
    lane = r.randint(0, 2**31 - 1, N_KEYS).astype(np.int32)
    lane[:3] = [0, 1, 2**31 - 1]          # extremes of the lane id range
    sample = r.randint(0, 1 << 20, N_KEYS).astype(np.int32)
    bounce = r.randint(0, 16, N_KEYS).astype(np.int32)
    seeds = r.randint(0, 2**31 - 1, N_KEYS).astype(np.int32)
    return seeds, lane, sample, bounce


PURPOSES = [jrng.LIGHT_PICK, jrng.LIGHT_U, jrng.LIGHT_V, jrng.BSDF_U0,
            jrng.BSDF_U1, jrng.BSDF_LOTTERY, jrng.RR, jrng.PIXEL_JX,
            jrng.PIXEL_JY, jrng.LIGHT_DIR_U0, jrng.LIGHT_DIR_U1, jrng.COMPACT]


def test_purpose_ids_match():
    assert [getattr(trng, n) for n in (
        "LIGHT_PICK", "LIGHT_U", "LIGHT_V", "BSDF_U0", "BSDF_U1",
        "BSDF_LOTTERY", "RR", "PIXEL_JX", "PIXEL_JY", "LIGHT_DIR_U0",
        "LIGHT_DIR_U1", "COMPACT")] == PURPOSES == list(range(12))


@pytest.mark.parametrize("purpose", PURPOSES)
def test_uniform_bits_equal(purpose):
    seeds, lane, sample, bounce = _keys(purpose)
    want = np.asarray(jrng.uniform(jnp.asarray(seeds), jnp.asarray(lane),
                                   jnp.asarray(sample), jnp.asarray(bounce),
                                   purpose))
    got = trng.uniform(torch.from_numpy(seeds), torch.from_numpy(lane),
                       torch.from_numpy(sample), torch.from_numpy(bounce),
                       purpose).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("words", [
    (7,), (0, -1), (3, 2**31 - 1, -5, 123456789), (0xFFFF, 0x10000, 0)])
def test_hash_u32_bits_equal(words):
    """Scalars, negative words (wrapped to uint32) and the widest lanes."""
    lane = np.arange(-50, 50, dtype=np.int32)
    want = np.asarray(jrng.hash_u32(*words, jnp.asarray(lane)))
    got = trng.hash_u32(*words, torch.from_numpy(lane)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  want.astype(np.uint64))


def test_uniform_simple_bits_equal():
    seeds, lane, _, bounce = _keys(99)
    want = np.asarray(jrng.uniform_simple(jnp.asarray(seeds),
                                          jnp.asarray(lane),
                                          jnp.asarray(bounce)))
    got = trng.uniform_simple(torch.from_numpy(seeds), torch.from_numpy(lane),
                              torch.from_numpy(bounce)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
