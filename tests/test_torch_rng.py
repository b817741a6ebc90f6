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


# ------------------------------------------------ the CUDA kernel's host part
#
# On the card ``uniform`` hands every word to ``csrc/rng.cu``: an int or a
# 0-d CPU tensor as a constant masked to 32 bits on the host, a tensor with
# elements as a column. The kernel's arithmetic is held to the plain hash on
# the card (tests/test_torch_cuda.py); here the host's masking is held to
# ``hash_u32``: its constants, put in place of the words, hash alike.

def _hashed_as_the_kernel_takes(words):
    """``hash_u32`` of the words the kernel receives: each constant of
    ``kernel_words`` in place of its word, the columns as they are."""
    cols, _ = trng.kernel_words(words)
    return trng.hash_u32(*(c.value if c.kind == 0 else w
                           for c, w in zip(cols, words)))


WORD_CASES = [(7,), (0, -1), (3, 2**31 - 1, -5), (0xFFFF, 0x10000, 0)]


@pytest.mark.parametrize("words", WORD_CASES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_int_words_bits_equal(words, dtype):
    """Python-int words, negative ones wrapped to uint32 and 2**31 - 1,
    masked on the host, then a lane column: ``hash_u32`` of what the
    kernel receives equals ``hash_u32`` of the words bit for bit."""
    lane = torch.arange(-50, 50, dtype=dtype)
    cols, shape = trng.kernel_words((*words, lane))
    assert shape == lane.shape and cols[-1].kind == trng._KIND[dtype]
    assert all(c.kind == 0 and 0 <= c.value <= trng.MASK for c in cols[:-1])
    np.testing.assert_array_equal(
        _hashed_as_the_kernel_takes((*words, lane)).numpy(),
        trng.hash_u32(*words, lane).numpy())


@pytest.mark.parametrize("words", WORD_CASES)
def test_kernel_constant_words_after_a_column_bits_equal(words):
    """Int words after a column, a 0-d CPU tensor and a numpy integer
    past 32 bits go to the kernel as constants masked to 32 bits."""
    lane = torch.arange(-50, 50, dtype=torch.int64) * 40_000_019
    mixed = (torch.tensor(words[0]), lane,
             torch.tensor(-3, dtype=torch.int32), np.int64(2**40 + words[-1]))
    cols, _ = trng.kernel_words(mixed)
    assert [c.kind for c in cols] == [0, 2, 0, 0]
    np.testing.assert_array_equal(_hashed_as_the_kernel_takes(mixed).numpy(),
                                  trng.hash_u32(*mixed).numpy())


@pytest.mark.parametrize("purpose", PURPOSES)
def test_uniform_plain_bits_equal(purpose):
    """The plain draw, the kernel's oracle on the card, with seed and
    bounce as ints and lane and sample as int32 columns as the path tracer
    draws: bit-equal to the JAX package's."""
    _, lane, sample, _ = _keys(purpose)
    seed, bounce = 2**31 - 1 - purpose, purpose % 7
    want = np.asarray(jrng.uniform(seed, jnp.asarray(lane),
                                   jnp.asarray(sample), bounce, purpose))
    got = trng.uniform_plain(seed, torch.from_numpy(lane),
                             torch.from_numpy(sample), bounce,
                             purpose).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cpu_draw_takes_the_plain_path():
    """A CPU draw returns the plain version's bits, launches nothing and
    its span counts no kernel draws."""
    from tuturenderer_tpu_torch.utils import profiling
    seeds, lane, sample, bounce = _keys(5)
    args = [torch.from_numpy(a) for a in (seeds, lane, sample, bounce)]
    before = trng.LAUNCHES
    with profiling.recording():
        n0 = len(profiling.recorded())
        got = trng.uniform(*args, trng.RR)
        simple = trng.uniform_simple(7, args[1], 3)
        spans = [s for s in profiling.recorded()[n0:] if s.name == "rng"]
    assert trng.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        trng.uniform_plain(*args, trng.RR).numpy().view(np.uint32))
    np.testing.assert_array_equal(
        simple.numpy().view(np.uint32),
        trng.uniform_simple_plain(7, args[1], 3).numpy().view(np.uint32))
    assert [s.counts for s in spans] == [{"draws": N_KEYS}] * 2


@pytest.mark.parametrize("word, match", [
    (1.5, "ints and integer tensors"),
    ("7", "ints and integer tensors"),
    (torch.tensor(2.0), "integer words"),
])
def test_kernel_words_refuses(word, match):
    with pytest.raises(ValueError, match=match):
        trng.kernel_words((word, torch.arange(4)))


def test_kernel_words_refuses_five_words():
    with pytest.raises(ValueError, match="at most 4 words"):
        trng.kernel_words((1, 2, torch.arange(4), 3, 4))


@pytest.mark.parametrize("word, shape, match", [
    (torch.arange(4, dtype=torch.int16), (4,), "int32 and int64"),
    (torch.arange(3), (4,), "does not broadcast"),
    (torch.arange(8).reshape(2, 4).t(), (4,), "does not broadcast"),
    (torch.arange(8).reshape(4, 2).t().contiguous().t(), (4, 2),
     "only contiguous"),
])
def test_kernel_word_refused(word, shape, match):
    """The words the kernel does not take, refused before any launch."""
    with pytest.raises(ValueError, match=match):
        trng._column(word, torch.Size(shape))


def test_kernel_word_strides():
    """A 1-D column passes its stride (0 for a broadcast scalar), a 0-d one
    stride 0, a contiguous N-d one stride 1."""
    base = torch.arange(8, dtype=torch.int32)
    cases = [(base, 1, 1), (base[::2], 2, 1),
             (torch.tensor(5).broadcast_to((4,)), 0, 2),
             (torch.tensor(5), 0, 2),
             (torch.arange(8).reshape(2, 4), 1, 2)]
    for w, stride, kind in cases:
        shape = w.shape if w.dim() else torch.Size([4])
        col = trng._column(w, shape)
        assert (col.ptr, col.stride, col.kind) == (w.data_ptr(), stride, kind)


def test_kernel_draw_refuses_cpu_columns():
    """A CPU tensor with elements beside a CUDA word is refused before the
    kernel is built or launched (here every column is on the CPU)."""
    before = trng.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        trng._kernel_draw((1, torch.arange(4), 2))
    assert trng.LAUNCHES == before
