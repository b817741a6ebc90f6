"""The visit-walk probe (K8) of the PyTorch port against the JAX kernel body
``tools/proto_visit.py::kernel``, run here in interpret mode through a
``pl.pallas_call`` built as ``tools/proto_visit.py::run`` builds it, and
the CUDA kernel's loop (``csrc/proto_visit.cu``) mirrored in torch.

At NC = 128 visit-list entries and 2 tiles (2,048 rays), one
interpret-mode call per scenario (about half a minute each on the CPU):

- "early" with tile 1 half dead (every other lane): every ray, dead or
  live, hits t = 1 at cluster 0 plane 0 and each tile stops after its
  first group;
- "full" with tile 1 wholly dead: tile 0 walks all 32 groups to t = 6,
  while tile 1's limit falls to 0 after its first group, so it ends with
  no hit (t = 3.4e38, idx = -1);
- "special" (``special_planes``: 16 clusters, tile 1 wholly dead): planes
  with w_d = +0, -0, subnormal, just below, at and just above 1e-6, inf
  and NaN rows, sentinel entries between valid ones; tile 0 ends on its
  limit after its third group.

``kernel_loop`` mirrors the CUDA kernel's loop: a tile as a cluster of 2
CTAs of 512 rays, the division of -w_o by w_d where |w_d| >= 1e-6 and of
1 by 1 elsewhere, the clusters of sentinel entries skipped, t_lim the
least over the groups of the larger of the two CTAs' maxima. It is held
to the plain version on every scenario.

The JAX kernel's tile-wide exit on t_lim does not run in interpret mode:
there a while loop's condition reads a scratch ref as it was when the loop
began (JAX 0.9.0, ROADMAP queue 3; ``test_interpret_while_condition``
holds it), so the kernel walks on until an entry of 3.4e38, on buffers
its prefetch (which reads the ref as updated) no longer filled. "early"
and "full" give the same answers either way; for "special" the JAX run
takes each visit list cut where the plain walk ended. The exit itself is
held by the plain walk's own checks and by the mirror of the CUDA loop.

Tolerance: exact. The plain version computes the kernel's float32
expressions in its order (one true division per plane), and XLA's CPU
backend rounds each step as PyTorch does (the special planes and rays lie
on grids of 1/64, so every product and sum is exact and only the division
rounds), except that it flushes subnormals to zero (ROADMAP queue 3):
where a subnormal decides a ray's answer (a plane at a subnormal c3 met
from z = 0), that ray is left out of the comparison with JAX.
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


def _subnormal(t: torch.Tensor) -> torch.Tensor:
    return (t != 0.0) & (t.abs() < torch.finfo(torch.float32).tiny)


@pytest.fixture(scope="module", params=["early", "full", "special"])
def walked(request):
    """(scenario, inputs, JAX t, JAX idx)."""
    name = request.param
    a = _inputs(name)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if name == "special":
        # each visit list cut where the plain walk ends (entries 3.4e38
        # from there on, which ends it there too): in interpret mode the
        # while loop's condition reads tlim as it was when the loop began
        # (JAX 0.9.0), so the JAX kernel would walk on past the limit on
        # buffers its prefetch no longer filled
        _, _, groups = P.walk_plain(*P.tensors(a, "cpu"), nc=NC)
        ventry = a["ventry"].reshape(N_TILES, NC).copy()
        for tile, g in enumerate(groups.tolist()):
            ventry[tile, g * P.G:] = np.float32(3.4e38)
        j["ventry"] = jnp.asarray(ventry.reshape(-1))
    # the table padded to NC clusters (the special planes have 16; the
    # visit lists name no other): every scenario then shares one compile
    woop = np.zeros((NC, P.ROW), np.float32)
    woop[:a["woop"].shape[0]] = a["woop"]
    t, idx = _jax_run_interpret(
        j["vlist"].reshape(-1, 128), j["ventry"].reshape(-1, 128),
        *(j[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz", "live")),
        jnp.asarray(woop).reshape(NC, 8, 128), nc=NC)
    return name, a, np.asarray(t), np.asarray(idx)


def test_interpret_while_condition():
    """Why the JAX run of "special" takes visit lists cut where the plain
    walk ends: in interpret mode a ``lax.while_loop``'s condition reads an
    SMEM scratch ref as it was when the loop began, while its body reads
    it as updated. The body lowers the limit to 2 at once; a condition
    that read it as updated would stop after 2 steps, not 8. Should this
    fail after a JAX upgrade, the cut in ``walked`` is no longer needed."""
    def kernel(o_ref, lim):
        lim[0] = jnp.float32(100.0)

        def cond(s):
            return jnp.logical_and(s < 8, s.astype(jnp.float32) < lim[0])

        def body(s):
            o_ref[s] = lim[0]
            lim[0] = jnp.float32(2.0)
            return s + 1

        o_ref[8] = jax.lax.while_loop(cond, body, 0).astype(jnp.float32)

    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((9,), jnp.float32),
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.SMEM((1,), jnp.float32)], interpret=True)()
    np.testing.assert_array_equal(np.asarray(out), [100.0] + [2.0] * 7 + [8.0])


def test_plain_walk_matches_the_jax_kernel(walked):
    name, a, jt, jidx = walked
    t, idx = P.run(*P.tensors(a, "cpu"), nc=NC)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    # the rays whose nearest t is subnormal: XLA on the CPU flushes it
    keep = ~_subnormal(t).numpy()
    if name == "special":
        assert keep.sum() < t.shape[0] - 100     # the rays from z = 0
        assert (a["oz"][~keep] == 0.0).all()
    else:
        assert keep.all()
    np.testing.assert_array_equal(t.numpy()[keep], jt[keep])
    np.testing.assert_array_equal(idx.numpy()[keep], jidx[keep])


def test_walk_answers_and_exits(walked):
    """Each scenario's asserted answer on its live tile, the dead tile's
    early exit, and the groups walked per tile."""
    name, a, _, _ = walked
    t, idx, groups = P.walk_plain(*P.tensors(a, "cpu"), nc=NC)
    live = torch.from_numpy(a["live"]) > 0
    if name == "early":
        P.check(name, t, idx)                 # dead lanes included
        assert groups.tolist() == [1, 1]
    elif name == "full":
        P.check(name, t[:P.TILE], idx[:P.TILE])
        assert not bool(live[P.TILE:].any())
        assert (t[P.TILE:] == np.float32(3.4e38)).all()
        assert (idx[P.TILE:] == -1).all()
        assert groups.tolist() == [NC // P.G, 1]
    else:
        assert not bool(live[P.TILE:].any())
        assert groups.tolist() == [3, 1]
        assert bool((idx[:P.TILE] >= 0).all())
        # the skipped entries' cluster is the nearest, and never wins; of
        # an exact tie the first plane wins; no inf or NaN row wins
        assert not bool((idx // P.CS == P.NEAR).any())
        plane = idx[idx >= 0] % P.CS
        assert bool((plane == 0).any()) and not bool((plane == 1).any())
        assert not bool(((plane >= 8) & (plane <= 13)).any())


def _tests(a, tile: int, groups: int):
    """(w_d, t, accepted) of every test of ``tile``'s first ``groups``
    groups, valid clusters only, [rays, planes]."""
    v = slice(tile * NC, (tile + 1) * NC)
    r = slice(tile * P.TILE, (tile + 1) * P.TILE)
    pos = [p for p in range(groups * P.G) if a["ventry"][v][p] < P.SENTINEL]
    rows = a["woop"][:, :P.CS * P.WF].reshape(-1, P.CS, P.WF)[:, :, 8:12]
    pl = torch.from_numpy(rows[a["vlist"][v][pos]].reshape(-1, 4))
    o = [torch.from_numpy(a[k][r])[:, None] for k in ("ox", "oy", "oz")]
    d = [torch.from_numpy(a[k][r])[:, None] for k in ("dx", "dy", "dz")]
    w_o = o[0] * pl[:, 0] + o[1] * pl[:, 1] + o[2] * pl[:, 2] - pl[:, 3]
    w_d = d[0] * pl[:, 0] + d[1] * pl[:, 1] + d[2] * pl[:, 2]
    t = -w_o / w_d
    return w_d, t, (w_d.abs() >= P.MIN_WD) & (t > 0.0)


def test_special_planes_reach_the_edge_cases():
    """The special planes give the tests the kernel's guarded division
    must get right: w_d of +0, -0, subnormal size, just below, at and
    just above 1e-6, inf and NaN; t of inf, NaN and subnormal size, the
    subnormal accepted; the threshold itself accepted."""
    a = _inputs("special")
    w_d, t, ok = _tests(a, 0, 3)
    bits = w_d.contiguous().view(torch.int32)
    tiny = np.float32(1e-6)
    assert bool(((w_d == 0.0) & (bits == 0)).any())
    assert bool(((w_d == 0.0) & (bits < 0)).any())
    assert bool(_subnormal(w_d).any())
    for at in (np.nextafter(tiny, np.float32(0)), tiny,
               np.nextafter(tiny, np.float32(1))):
        assert bool((w_d == float(at)).any())
    assert bool((ok & (w_d == float(tiny))).any())
    assert bool(w_d.isinf().any()) and bool(w_d.isnan().any())
    assert bool(t.isinf().any()) and bool(t.isnan().any())
    assert bool((ok & _subnormal(t)).any())
    # sentinel entries: at 3e37 and 3.4e38 (skipped) between valid ones,
    # one just below 3e37 (walked)
    e = a["ventry"][:16]
    assert (e == np.float32(3e37)).sum() == 1 and (e >= 3.4e38).sum() == 1
    assert ((e < np.float32(3e37)) & (e > 1e37)).sum() == 1


def kernel_loop(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc: int):
    """The CUDA kernel's loop in torch -> (t, idx, groups walked per tile):
    a tile of 1024 rays as 2 CTAs of 512, one ray a thread; per group, the
    clusters of sentinel entries skipped, each plane tested in order, a
    test that |w_d| >= 1e-6 rejects dividing 1 by 1, and the best updated
    by selects; then each CTA's maximum over its warps' maxima of
    (live ? t_best : 0), and t_lim = min(t_lim, the larger of the two)."""
    n_tiles = ox.shape[0] // P.TILE
    rows = woop[:, :P.CS * P.WF].reshape(-1, P.CS, P.WF)[:, :, 8:12]
    t_out, idx_out, walked = [], [], []
    for tile in range(n_tiles):
        r = slice(tile * P.TILE, (tile + 1) * P.TILE)
        vl, ve = vlist[tile * nc:(tile + 1) * nc], ventry[tile * nc:
                                                          (tile + 1) * nc]
        o = [c[r] for c in (ox, oy, oz)]
        d = [c[r] for c in (dx, dy, dz)]
        lv = live[r] > 0.0
        t_best = torch.full((P.TILE,), P.F32_MAX)
        idx = torch.full((P.TILE,), -1, dtype=torch.int32)
        t_lim = torch.tensor(P.F32_MAX, dtype=torch.float32)
        s = 0
        while s < nc // P.G and bool(ve[min(s * P.G, nc - 1)] < t_lim):
            for g in range(P.G):
                p = min(s * P.G + g, nc - 1)
                if not bool(ve[p] < P.SENTINEL):
                    continue
                cid = int(vl[p])
                for k in range(P.CS):
                    q = rows[cid, k]
                    w_o = o[0] * q[0] + o[1] * q[1] + o[2] * q[2] - q[3]
                    w_d = d[0] * q[0] + d[1] * q[1] + d[2] * q[2]
                    crosses = w_d.abs() >= P.MIN_WD
                    t = torch.where(crosses, -w_o, 1.0) / \
                        torch.where(crosses, w_d, 1.0)
                    ok = crosses & (t > 0.0) & (t < t_best)
                    t_best = torch.where(ok, t, t_best)
                    idx = torch.where(ok, cid * P.CS + k, idx)
            m = torch.where(lv, t_best, 0.0)
            # [CTA, warp, lane] -> each CTA's maximum
            part = m.reshape(2, -1, 32).amax(dim=2).amax(dim=1)
            t_lim = torch.minimum(t_lim, part.max())
            s += 1
        t_out.append(t_best)
        idx_out.append(idx)
        walked.append(s)
    return torch.cat(t_out), torch.cat(idx_out), walked


@pytest.mark.parametrize("name", ["early", "full", "special"])
def test_kernel_loop_matches_the_plain_walk(name):
    """The kernel's loop against the plain walk, dead lanes included."""
    a = _inputs(name)
    if name == "special":
        a["live"][:P.TILE:3] = 0.0         # and a third of tile 0 dead
    args = P.tensors(a, "cpu")
    t, idx, groups = P.walk_plain(*args, nc=NC)
    kt, kidx, walked = kernel_loop(*args, nc=NC)
    assert walked == groups.tolist()
    np.testing.assert_array_equal(kt.numpy(), t.numpy())
    np.testing.assert_array_equal(kidx.numpy(), idx.numpy())


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
