"""The dense kernels' contract on edge cases, and the loops of the tiled
kernels K1 (Woop nearest hit), K2 (Woop any hit), K3 (MT nearest hit) and
K4 (MT any hit) in ``tuturenderer_tpu_torch/csrc/dense_intersect.cu``, on
the CPU.

The tiled kernels test one triangle at a time in index order (two rays
per thread, tiles of 256 triangles). A nearest hit updates its best on a
strict t < best; the plain versions take the first minimum of tiles of
512 triangles and a strict < across them: ``by_steps`` mirrors the
kernels' loop and is held to the plain versions, exact t ties included.
The any hits K2 (Woop) and K4 (MT) stop a warp once its 64 rays are
settled and a block once its 512 are: ``anyhit_walk`` mirrors those
exits and counts the triangles each warp tests, on a set where whole
blocks settle in the first tile.

The special rays (``torch_port_util.special_rays``: in a triangle's
plane, det and w_d = +0 and -0, inf and NaN components, subnormal
products, det overflowing to inf or underflowing to a subnormal, dist
within 1e-4 of t on both sides) go through the plain versions, the
kernels' oracle, and the JAX package's Pallas kernels in interpret mode.
The wrappers' alignment rules (the MT kernels read ``float4``s; the Woop
kernels any float offset) hold on the CPU too.

Tolerance: exact. The mirrors compute the plain versions' float32
expressions. The JAX kernels compute them too, and agree exactly on every
ray whose answer neither rounding nor a subnormal decides: a grazing ray
may split between XLA's and PyTorch's roundings, and XLA on the CPU
flushes subnormals to zero (ROADMAP queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten, special_rays, special_verts
from tuturenderer_tpu.ops.pallas import intersect as JP
from tuturenderer_tpu.scene.data import SceneBuilder as JBuilder
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.tools.time_kernels import soup

EPS = K.PARALLEL_EPS
INF, NAN = float("inf"), float("nan")
FORMS = {"woop": (K.pack_triangles_woop, K._woop_tile, K.TRI_FLOATS,
                  K.tri_intersect, K.tri_occluded),
         "mt": (K.pack_triangles, K._mt_tile, K.MT_FLOATS,
                K.tri_intersect_mt, K.tri_occluded_mt)}


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def special():
    verts = special_verts()
    b = JBuilder()
    m = b.add_material()
    b.add_triangles(verts, None, None, m)
    jscene = b.build()
    o, d, n_values = special_rays(verts)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
            for a in (o, d) for i in range(3)]
    return (jscene, scene_from_numpy(flatten(jscene), device="cpu"), o, d,
            rays, n_values)


def _pairs(rays):
    return [c[:, None] for c in rays]


def _dists(t_hit):
    """[N] shadow distances around each ray's nearest hit: at it, within
    1e-4 on both sides, at 1e-4 exactly, beyond, at +inf and NaN."""
    t = torch.where(t_hit < 1e30, t_hit, torch.full_like(t_hit, 2.0))
    out = [t * s for s in (0.5, 1.0, 2.0)]
    out += [t + off for off in (5e-5, -5e-5, 1e-4, -1e-4, 2e-4, -2e-4)]
    out += [torch.nextafter(t + 1e-4, torch.full_like(t, INF)),
            torch.full_like(t, INF), torch.full_like(t, NAN)]
    return out


def test_special_rays_reach_the_edge_cases(special):
    """The set holds what the kernels' arithmetic must get right: MT dets
    of +0, -0, NaN, inf and subnormal size, Woop w_d of 0 and NaN, exact
    t ties, and shadow rays blocked, free, and flipping with dist."""
    _, scene, _, _, rays, _ = special
    ox, oy, oz, dx, dy, dz = _pairs(rays)
    mt = K.pack_triangles(scene)
    tri = mt.reshape(-1, K.MT_FLOATS)
    e1x, e1y, e1z, e2x, e2y, e2z = [tri[:, j][None, :] for j in range(3, 9)]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = s1x * e1x + s1y * e1y + s1z * e1z
    zero = det == 0.0
    assert bool((zero & (_bits(det) == 0)).any())
    assert bool((zero & (_bits(det) < 0)).any())
    assert bool(det.isnan().any()) and bool(det.isinf().any())
    tiny = torch.finfo(torch.float32).tiny
    assert bool(((det != 0.0) & (det.abs() < tiny)).any())
    woop = K.pack_triangles_woop(scene).reshape(-1, K.TRI_FLOATS)
    r3x, r3y, r3z = [woop[:, j][None, :] for j in (8, 9, 10)]
    w_d = dx * r3x + dy * r3y + dz * r3z
    assert bool((w_d == 0.0).any()) and bool(w_d.isnan().any())
    t, _, _, ok = K._mt_tile(tri, *_pairs(rays))
    t = torch.where(ok, t, K.F32_MAX)
    ties = (t == t.min(dim=1, keepdim=True).values) & ok
    assert bool((ties.sum(dim=1) > 1).any())
    t_hit = K.tri_intersect_mt_plain(mt, *rays)[0]
    blocked = torch.stack([K.tri_occluded_mt_plain(mt, *rays, dist)
                           for dist in _dists(t_hit)])
    assert bool(blocked.any()) and not bool(blocked.all())
    assert bool((blocked.any(dim=0) & ~blocked.all(dim=0)).any())


def by_steps(tile, floats, table, rays):
    """The tiled nearest-hit kernels' loop: one triangle at a time in index
    order, the best updated on a strict t < best."""
    tri = table.reshape(-1, floats)
    n = rays[0].shape[0]
    best = torch.full((n,), K.F32_MAX)
    idx = torch.full((n,), -1, dtype=torch.int32)
    bu, bv = torch.zeros(n), torch.zeros(n)
    for k in range(tri.shape[0]):
        t, u, v, ok = (a[:, 0] for a in tile(tri[k:k + 1], *_pairs(rays)))
        better = ok & (t < best)
        best = torch.where(better, t, best)
        idx = torch.where(better, torch.tensor(k, dtype=torch.int32), idx)
        bu = torch.where(better, u, bu)
        bv = torch.where(better, v, bv)
    return best, idx, bu, bv


@pytest.mark.parametrize("form", sorted(FORMS))
def test_steps_in_index_order_give_the_plain_nearest_hit(special, form):
    _, scene, _, _, rays, _ = special
    pack, tile, floats, near, _ = FORMS[form]
    table = pack(scene)
    got, want = by_steps(tile, floats, table, rays), near(table, *rays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # triangle 3 repeats triangle 0: their exact t tie keeps index 0
    assert bool((want[1] == 0).any()) and not bool((want[1] == 3).any())


def anyhit_walk(first: np.ndarray, n_tris: int, vote_every: int = 1):
    """The any hits' exits over the first blocker of each ray (``n_tris``
    where none blocks): rays in blocks of 512, ray i and i + 256 on one
    thread, so warp w of a block holds rays 32w..32w+31 and
    256+32w..256+32w+31; tiles of 256 triangles in index order. A warp
    votes once per ``vote_every`` triangles (a step past a tile's last
    triangle tests the last one again) and stops once all its rays are
    settled (blocked, or past n); a block stops staging tiles once all
    its rays are. Returns (blocked [N], tests each warp made [blocks,
    8])."""
    n = first.shape[0]
    n_blocks = -(-n // 512)
    f = np.full(n_blocks * 512, -1, np.int64)     # past n: settled
    f[:n] = first
    f = f.reshape(n_blocks, 2, 8, 32)             # block, ray of thread, warp
    warp_last = f.max(axis=(1, 3))                # [blocks, 8]
    block_last = warp_last.max(axis=1)
    tested = np.zeros((n_blocks, 8), np.int64)
    for base in range(0, n_tris, 256):
        count = min(256, n_tris - base)
        staging = block_last >= base               # not yet all settled
        steps = -(-np.clip(warp_last + 1 - base, 0, count) // vote_every)
        tested += np.where(staging[:, None], steps * vote_every, 0)
    return first < n_tris, tested


def _first_blocker(form, table, rays, dist, chunk=512):
    """Each ray's first blocking triangle in index order, T if none."""
    _, tile, floats, _, _ = FORMS[form]
    tri = table.reshape(-1, floats)
    n_tris = tri.shape[0]
    first = torch.full((rays[0].shape[0],), n_tris)
    for lo in reversed(range(0, n_tris, chunk)):
        t, _, _, ok = tile(tri[lo:lo + chunk], *_pairs(rays))
        d = dist[:, None]
        ok = ok & (t < d) & ((t - d).abs() >= EPS)
        first = torch.where(ok.any(dim=1), lo + ok.int().argmax(dim=1),
                            first)
    return first.numpy()


@pytest.mark.parametrize("form,vote_every", [("mt", 1), ("woop", 4)],
                         ids=["K4", "K2"])
def test_anyhit_exits_settle_whole_blocks(form, vote_every):
    """The any hits' exits at 4,095 triangles (16 tiles), K4 voting per
    triangle, K2 per 4 triangles: a block whose 512 rays are aimed at
    triangles 0-255 with no distance limit tests one tile, a block at
    dist 0 tests all 16 (4,095 tests, K2's 4,096 with the last triangle
    tested twice), a mixed block walks on for its free rays; the rays
    blocked are the plain version's."""
    scene = soup(4095, "cpu", seed=1)
    verts = torch.stack([torch.stack(list(v), 1)
                         for v in (scene.tv0, scene.tv1, scene.tv2)], 1)
    r = np.random.RandomState(9)
    n = 4 * 512 + 100
    aim = torch.from_numpy(r.randint(0, 256, n))
    o = torch.from_numpy((r.randn(n, 3) * 8.0).astype(np.float32))
    d = verts[aim].mean(dim=1) - o
    d = d / d.norm(dim=1, keepdim=True)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    dist = torch.full((n,), INF)
    dist[512:1024] = 0.0
    dist[1024 + 1:1536:2] = 0.0
    dist[2048 + 1::3] = 0.0
    pack, _, _, _, occ = FORMS[form]
    table = pack(scene)
    blocked, tested = anyhit_walk(
        _first_blocker(form, table, rays, dist), 4095, vote_every)
    np.testing.assert_array_equal(blocked,
                                  occ(table, *rays, dist).numpy())
    every = 4095 if vote_every == 1 else 4096
    assert (tested[0] <= 256).all() and (tested[1] == every).all()
    assert (tested[2] == every).all() and (tested[3] <= 256).all()


def _jvec(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


@pytest.fixture(params=sorted(FORMS))
def form(request):
    """The JAX package's Pallas kernels in one form, restored after."""
    saved = JP.PALLAS_IMPL
    JP.PALLAS_IMPL = request.param
    try:
        yield request.param
    finally:
        JP.PALLAS_IMPL = saved


def test_special_rays_match_pallas_interpret(special, form):
    """The plain versions (the kernels' oracle) against the JAX package's
    Pallas kernels in interpret mode, in the same form, on the special
    rays that neither rounding nor subnormals decide: the same hits, t
    and shadow masks."""
    jscene, scene, o, d, rays, n = special
    o, d, rays = o[:n], d[:n], [c[:n] for c in rays]
    pack, _, _, near, occ = FORMS[form]
    table = pack(scene)
    jt, jidx, _, _ = map(np.asarray, JP.pallas_tri_intersect(
        jscene, _jvec(o), _jvec(d), interpret=True))
    t, idx, _, _ = (a.numpy() for a in near(table, *rays))
    np.testing.assert_array_equal(idx >= 0, jidx >= 0)
    np.testing.assert_array_equal(t, jt)
    for dist in _dists(torch.from_numpy(t)):
        want = np.asarray(JP.pallas_tri_occluded(
            jscene, _jvec(o), _jvec(d), jnp.asarray(dist.numpy()),
            interpret=True))
        np.testing.assert_array_equal(occ(table, *rays, dist).numpy(), want)


def _unaligned(table):
    """The table at a 4-byte offset into a larger tensor."""
    out = torch.cat([table.new_zeros(1), table])[1:]
    assert out.data_ptr() % 16 == 4
    return out


def test_mt_wrappers_refuse_an_unaligned_table(special):
    """K3 and K4 read each triangle as 3 float4: both wrappers refuse a
    table off a 16-byte boundary, on the CPU as on the card, and count no
    launch."""
    _, scene, _, _, rays, _ = special
    table = _unaligned(K.pack_triangles(scene))
    dist = torch.ones_like(rays[0])
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        K.tri_intersect_mt(table, *rays)
    with pytest.raises(ValueError, match="16-byte"):
        K.tri_occluded_mt(table, *rays, dist)
    assert K.LAUNCHES == before


def test_woop_wrappers_take_an_unaligned_table(special):
    """K1 stages its rows 4 bytes at a time and K2 reads scalars: a Woop
    table at any float offset is taken, with the same answers."""
    _, scene, _, _, rays, _ = special
    table = K.pack_triangles_woop(scene)
    dist = torch.full_like(rays[0], 3.0)
    for g, w in zip(K.tri_intersect(_unaligned(table), *rays),
                    K.tri_intersect(table, *rays)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(K.tri_occluded(_unaligned(table), *rays, dist),
                               K.tri_occluded(table, *rays, dist))
