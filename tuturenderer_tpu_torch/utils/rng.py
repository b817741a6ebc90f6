"""Counter-based RNG, bit-exact with ``tuturenderer_tpu/utils/rng.py``.

Every random decision is a pure function of ``(seed, lane, sample, bounce,
purpose)``, so this package draws the same numbers as the JAX package for
every lane, which lets the two be compared per lane.

Two forms of one draw. On a CUDA word, ``uniform`` and ``uniform_simple``
launch ``csrc/rng.cu``'s kernel, which hashes every lane in native uint32
arithmetic and writes its float, one launch a draw, with no host-to-device
copy and no sync; ``LAUNCHES`` counts its launches. Otherwise they run the
plain version, ``uniform_plain`` and ``uniform_simple_plain`` over
``hash_u32``, which is also the kernel's oracle on the card.

The JAX generator works in uint32. PyTorch has no full uint32 arithmetic,
so the plain version's words live in int64 and every add, left shift and
multiply is reduced modulo 2**32 with ``& 0xFFFFFFFF``. A multiply by a
32-bit constant could pass 2**63, so it is split into the constant's 16-bit
halves (``_mul32``): no intermediate exceeds 2**49.

The kernel takes as a word a Python int (masked to 32 bits on the host), a
0-d CPU tensor (read on the host as an int), a 0-d CUDA tensor (one value
for every lane) or an int32 or int64 CUDA tensor of the draw's shape (its
low 32 bits), and hashes them in order from ``GOLDEN``, as ``hash_u32``
does. A draw with a CUDA word and a word of any other kind (a float, a CPU
tensor with elements, a shape the kernel would have to broadcast) raises.

Each draw is an ``rng`` span of ``utils/profiling.py`` that counts the
numbers drawn (``draws``) and, of them, those the kernel drew (``kernel``).
"""
from __future__ import annotations

import ctypes
import operator

import torch

from .profiling import span

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9

# distinct draw purposes within one path vertex
LIGHT_PICK = 0
LIGHT_U = 1
LIGHT_V = 2
BSDF_U0 = 3
BSDF_U1 = 4
BSDF_LOTTERY = 5
RR = 6
PIXEL_JX = 7
PIXEL_JY = 8
LIGHT_DIR_U0 = 9
LIGHT_DIR_U1 = 10
COMPACT = 11        # compaction-overflow lane roulette

LAUNCHES = 0        # launches of the kernel, one a draw on the card
MAX_WORDS = 4       # the kernel's words, constants and columns
_KIND = {torch.int32: 1, torch.int64: 2}    # a constant word is kind 0


def _mul32(h, c: int):
    """(h * c) mod 2**32 for h in [0, 2**32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def _mix(h):
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def hash_u32(*words):
    """Combine integer words (tensors or ints, broadcastable) into uint32
    values held in an int64 tensor."""
    device = next((w.device for w in words if isinstance(w, torch.Tensor)),
                  None)
    h = torch.tensor(GOLDEN, dtype=torch.int64, device=device)
    for w in words:
        w = torch.as_tensor(w, device=device).to(torch.int64) & MASK
        h = _mix(h ^ ((w + GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK))
    return h


def _to_unit(bits):
    # 24-bit mantissa -> [0, 1), exact in float32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_plain(seed, lane, sample, bounce, purpose):
    """``uniform`` in plain PyTorch, on any device."""
    return _to_unit(hash_u32(seed, lane, sample, bounce * 32 + purpose))


def uniform_simple_plain(seed, lane, tag):
    """``uniform_simple`` in plain PyTorch, on any device."""
    return _to_unit(hash_u32(seed, lane, tag))


def uniform(seed, lane, sample, bounce, purpose):
    """U[0, 1) float32 for each lane. On the CPU the words are any
    broadcastable ints. On a CUDA draw each word is an int (masked to 32
    bits on the host), a 0-d integer tensor (a CPU one read on the host, a
    CUDA one read by the kernel for every lane) or an int32 or int64 CUDA
    tensor of the draw's shape (its low 32 bits); any other word raises."""
    with span("rng") as sp:
        return _draw(sp, seed, lane, sample, bounce * 32 + purpose)


def uniform_simple(seed, lane, tag):
    """U[0, 1) float32 for each lane, from three words, which follow
    ``uniform``'s rules."""
    with span("rng") as sp:
        return _draw(sp, seed, lane, tag)


def _draw(sp, *words):
    if any(isinstance(w, torch.Tensor) and w.is_cuda for w in words):
        out = _kernel_draw(words)
        if sp.on:
            sp.count("kernel", out.numel())
    else:
        out = _to_unit(hash_u32(*words))
    if sp.on:
        sp.count("draws", out.numel())
    return out


# ---------------------------------------------------------------- the kernel

def _host_int(w) -> int:
    """A word that is not a tensor with elements, as an int in [0, 2**32):
    a Python int (or any integer ``operator.index`` takes) or a 0-d CPU
    tensor of an integer type."""
    if isinstance(w, torch.Tensor):
        if w.is_floating_point() or w.is_complex():
            raise ValueError(f"the RNG kernel takes integer words, not "
                             f"{w.dtype}")
        return int(w.item()) & MASK
    try:
        return operator.index(w) & MASK
    except TypeError:
        raise ValueError(f"the RNG kernel takes ints and integer tensors as "
                         f"words, not {type(w).__name__}") from None


class _Word(ctypes.Structure):
    """``csrc/rng.cu``'s ``RngWord``."""
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("value", ctypes.c_uint32), ("kind", ctypes.c_int)]


def _lib():
    from ..ops.cuda import build
    # a render draws (the pixel jitter) before it queries a dense scene or
    # shades, so the first draw builds the render's kernels in one round
    lib = build.load_all(build.RENDER_KERNELS)["rng"]
    if lib.rng_uniform.argtypes is None:
        lib.rng_uniform.argtypes = [ctypes.POINTER(_Word), ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.rng_uniform.restype = ctypes.c_int
    return lib


def _column(w: torch.Tensor, shape) -> _Word:
    """The kernel's word for a tensor with elements or a CUDA tensor: 0-d,
    or of the draw's shape and 1-D (any stride) or contiguous."""
    if w.dtype not in _KIND:
        raise ValueError(f"the RNG kernel takes int32 and int64 tensors, "
                         f"not {w.dtype}")
    if w.dim() == 0:
        stride = 0
    elif w.shape != shape:
        raise ValueError(f"the RNG kernel does not broadcast a word of shape "
                         f"{tuple(w.shape)} to {tuple(shape)}")
    elif w.dim() == 1:
        stride = w.stride(0)
    elif w.is_contiguous():
        stride = 1
    else:
        raise ValueError("the RNG kernel takes a word of more than one "
                         "dimension only contiguous")
    return _Word(w.data_ptr(), stride, 0, _KIND[w.dtype])


def _is_column(w) -> bool:
    return isinstance(w, torch.Tensor) and (w.is_cuda or w.dim() > 0)


def kernel_words(words):
    """-> (the kernel's words, the draw's shape): a constant for each word
    that is not a CUDA tensor or a tensor with elements, else a column.
    Raises on a word the kernel does not take; places no device check."""
    if len(words) > MAX_WORDS:
        raise ValueError(f"the RNG kernel takes at most {MAX_WORDS} words, "
                         f"got {len(words)}")
    shape = next((w.shape for w in words if _is_column(w) and w.dim()),
                 torch.Size())
    return [_column(w, shape) if _is_column(w)
            else _Word(None, 0, _host_int(w), 0) for w in words], shape


def _kernel_draw(words) -> torch.Tensor:
    """The draw of ``words`` by the kernel -> float32 of the shape of the
    words with elements (0-d if none has), on their device. Raises on a
    word the kernel does not take."""
    global LAUNCHES
    devs = {w.device for w in words if _is_column(w)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the RNG kernel takes words on one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}")
    cols, shape = kernel_words(words)
    dev = devs.pop()
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().rng_uniform((_Word * MAX_WORDS)(*cols), len(cols),
                                 out.numel(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rng_uniform kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
