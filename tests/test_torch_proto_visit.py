"""The visit-walk probe (K8) of the PyTorch port against the JAX kernel body
``tools/proto_visit.py::kernel``, run here in interpret mode through a
``pl.pallas_call`` built as ``tools/proto_visit.py::run`` builds it.

At NC = 128 clusters and 2 tiles (2,048 rays), one interpret-mode call per
scenario (about half a minute each on the CPU):

- "early" with tile 1 half dead (every other lane): every ray, dead or
  live, hits t = 1 at cluster 0 plane 0 and each tile stops after its
  first group;
- "full" with tile 1 wholly dead: tile 0 walks all 32 groups to t = 6,
  while tile 1's limit falls to 0 after its first group, so it ends with
  no hit (t = 3.4e38, idx = -1).

Tolerance: exact. The plain version computes the kernel's float32
expressions in its order (one true division per plane), and XLA's CPU
backend rounds each step as PyTorch does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools import proto_visit as JP
from tuturenderer_tpu_torch.tools import proto_visit as P

NC, N_TILES = 128, 2


@functools.partial(jax.jit, static_argnames=("nc",))
def _jax_run_interpret(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop,
                       nc):
    """``tools/proto_visit.py::run`` with ``interpret=True``."""
    nt = ox.shape[0] // (JP.ROWS * JP.LANES)
    r = nc // 128
    rs = lambda a: a.reshape(nt * JP.ROWS, JP.LANES)
    tile = lambda: pl.BlockSpec((JP.ROWS, JP.LANES), lambda i: (i, 0),
                                memory_space=pltpu.VMEM)
    smem = lambda: pl.BlockSpec((r, 128), lambda i: (i, 0),
                                memory_space=pltpu.SMEM)
    t, idx = pl.pallas_call(
        JP.kernel,
        grid=(nt,),
        in_specs=[smem(), smem()] + [tile() for _ in range(7)] +
        [pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=[tile(), tile()],
        out_shape=[jax.ShapeDtypeStruct((nt * JP.ROWS, JP.LANES), jnp.float32),
                   jax.ShapeDtypeStruct((nt * JP.ROWS, JP.LANES), jnp.int32)],
        scratch_shapes=[pltpu.SMEM((2, JP.G, 8, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, JP.G)),
                        pltpu.SMEM((1,), jnp.float32),
                        pltpu.SMEM((1,), jnp.int32)],
        interpret=True,
    )(vlist, ventry, rs(ox), rs(oy), rs(oz), rs(dx), rs(dy), rs(dz),
      rs(live), woop)
    return t.reshape(-1), idx.reshape(-1)


def _inputs(name):
    a = P.scenario(name, NC, N_TILES)
    if name == "early":
        a["live"][P.TILE::2] = 0.0         # tile 1 half dead
    else:
        a["live"][P.TILE:] = 0.0           # tile 1 wholly dead
    return a


@pytest.fixture(scope="module", params=["early", "full"])
def walked(request):
    """(scenario, inputs, JAX t, JAX idx)."""
    name = request.param
    a = _inputs(name)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t, idx = _jax_run_interpret(
        j["vlist"].reshape(-1, 128), j["ventry"].reshape(-1, 128),
        *(j[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz", "live")),
        j["woop"].reshape(NC, 8, 128), nc=NC)
    return name, a, np.asarray(t), np.asarray(idx)


def test_plain_walk_matches_the_jax_kernel(walked):
    name, a, jt, jidx = walked
    t, idx = P.run(*P.tensors(a, "cpu"), nc=NC)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_array_equal(idx.numpy(), jidx)


def test_walk_answers_and_exits(walked):
    """Each scenario's asserted answer on its live tile, the dead tile's
    early exit, and the groups walked per tile."""
    name, a, _, _ = walked
    t, idx, groups = P.walk_plain(*P.tensors(a, "cpu"), nc=NC)
    live = torch.from_numpy(a["live"]) > 0
    if name == "early":
        P.check(name, t, idx)                 # dead lanes included
        assert groups.tolist() == [1, 1]
    else:
        P.check(name, t[:P.TILE], idx[:P.TILE])
        assert not bool(live[P.TILE:].any())
        assert (t[P.TILE:] == np.float32(3.4e38)).all()
        assert (idx[P.TILE:] == -1).all()
        assert groups.tolist() == [NC // P.G, 1]


@pytest.mark.parametrize("bad", ["rays", "nc", "cluster-id", "dtype"])
def test_run_rejects_bad_inputs(bad):
    a = P.scenario("early", 8, 1)
    args = P.tensors(a, "cpu")
    nc = 8
    if bad == "rays":
        args[2] = args[2][:1000].contiguous()
    elif bad == "nc":
        nc = 6
    elif bad == "cluster-id":
        args[0] = args[0].clone()
        args[0][3] = 8
    else:
        args[0] = args[0].long()
    with pytest.raises(ValueError):
        P.run(*args, nc=nc)


def test_main_needs_the_card():
    with pytest.raises((RuntimeError, ValueError)):
        P.main(device="cpu")
