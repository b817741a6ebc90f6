"""The port forms of tests/test_textures.py's atlas and config cases, and
``intersect_scene`` on its textured triangle, each held to the JAX package
on the same inputs:

- ``TextureAtlas.sample``: repeat wrap, nearest texel, index -1 gives
  zeros; test_textures.py's queries and a seeded set, bit-equal to the
  JAX atlas's samples;
- a config whose ``texture`` line names its file relative to the config:
  the port's parser finds it, and its scene holds the JAX parser's texture
  and material tables;
- ``intersect_scene`` on the textured triangle: test_textures.py's rays
  and a seeded grid over the triangle, every HitRecord field
  (``torch_port_util.check_hit_records``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_textures import checker, textured_scene as jax_textured_scene
from torch_port_util import check_hit_records, flatten
from tuturenderer_tpu.ops.intersect import intersect_scene as j_intersect
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.ops.intersect import intersect_scene
from tuturenderer_tpu_torch.scene.data import LAMBERTIAN, SceneBuilder
from tuturenderer_tpu_torch.utils.vec import Vec3


def textured_scene():
    """test_textures.py's textured_scene, built with the port's builder."""
    b = SceneBuilder()
    tex = b.add_texture("diffuse", "checker", checker())
    rough = b.add_texture("roughness", "r",
                          np.full((4, 4, 3), 0.25, np.float32))
    m = b.add_material(LAMBERTIAN, diffuse=(0.5, 0.5, 0.5),
                       diffuse_map=tex, roughness_map=rough)
    verts = np.asarray([[[0, 0, 0], [4, 0, 0], [0, 4, 0]]], np.float32)
    uvs = np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32)
    b.add_triangles(verts, None, uvs, m)
    return b.build(device="cpu")


def test_textured_scene_matches_jax():
    got, want = flatten(textured_scene()), flatten(jax_textured_scene())
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_atlas_repeat_wrap():
    s = textured_scene()
    atlas = s.diffuse_maps
    t = torch.tensor
    # u=0.05,v=0.05 -> texel (0,0) = red ; u=0.18 -> texel (1,0) = blue
    c0 = atlas.sample(t([0]), t([0.05]), t([0.05]))
    c1 = atlas.sample(t([0]), t([0.18]), t([0.05]))
    assert float(c0.x[0]) == 1.0 and float(c0.z[0]) == 0.0
    assert float(c1.x[0]) == 0.0 and float(c1.z[0]) == 1.0
    # wrap: u=1.05 equals u=0.05
    cw = atlas.sample(t([0]), t([1.05]), t([0.05]))
    assert float(cw.x[0]) == 1.0
    # idx -1 -> zeros
    cz = atlas.sample(t([-1]), t([0.1]), t([0.1]))
    assert float(cz.x[0]) == 0.0


@pytest.mark.parametrize("category", ["diffuse_maps", "roughness_maps"])
def test_atlas_sample_matches_jax(category):
    """Seeded indices (-1 among them) and coordinates inside, past and
    below [0, 1], on texels' edges and integers: the same texels as the
    JAX atlas, bit for bit."""
    atlas = getattr(textured_scene(), category)
    jatlas = getattr(jax_textured_scene(), category)
    r = np.random.RandomState(3)
    n = 512
    idx = r.randint(-1, 2, n).astype(np.int32) if category == \
        "diffuse_maps" else r.randint(-1, 3, n).astype(np.int32)
    idx = np.minimum(idx, atlas.k - 1)
    u = (r.rand(n) * 6.0 - 3.0).astype(np.float32)
    v = (r.rand(n) * 6.0 - 3.0).astype(np.float32)
    edges = np.asarray([0.0, 0.125, 0.25, 1.0, -1.0, 2.0, -0.125, 0.999999,
                        1e-8, -1e-8], np.float32)
    u[:len(edges)] = edges
    v[len(edges):2 * len(edges)] = edges
    got = atlas.sample(torch.from_numpy(idx), torch.from_numpy(u),
                       torch.from_numpy(v))
    want = jatlas.sample(jnp.asarray(idx), jnp.asarray(u), jnp.asarray(v))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.stack([c.numpy() for c in got], 1)[idx < 0] == 0).all()


def test_config_texture_roundtrip(tmp_path):
    """Config-driven texture binding through the full parser, the texture
    named relative to the config."""
    from tuturenderer_tpu.scene.config import parse_config as j_parse
    from tuturenderer_tpu_torch.io.ppm import write_ppm
    from tuturenderer_tpu_torch.scene.config import parse_config
    tex_path = tmp_path / "check.ppm"
    write_ppm(str(tex_path), checker(), gamma=1.0)
    cfg = tmp_path / "scene.txt"
    cfg.write_text(f"""
imsize 16 16
eye 0 0 -3
viewdir 0 0 1
hfov 60
updir 0 1 0
bkgcolor 0 0 0 1.0
integrator path
texture {tex_path.name}
v -1 -1 0
v 1 -1 0
v 0 1 0
vt 0 0
vt 1 0
vt 0.5 1
f 1/1 2/2 3/3
""")
    pc = parse_config(str(cfg))
    scene = pc.builder.build(device="cpu")
    assert scene.has_textures
    assert scene.diffuse_maps.k == 1
    assert int(scene.materials.diffuse_map[int(scene.tmat[0])]) == 0
    # the texel values the JAX parser reads from the same file
    np.testing.assert_array_equal(scene.diffuse_maps.rgb[0, :8, :8].numpy(),
                                  checker())
    got, want = flatten(scene), flatten(j_parse(str(cfg)).builder.build())
    for key in ("diffuse_maps.rgb", "diffuse_maps.w", "diffuse_maps.h",
                "materials.diffuse_map", "tmat", "tuv1u", "tuv2v"):
        assert np.array_equal(got[key], want[key]), key


def test_intersect_scene_on_textured_triangle_matches_jax():
    """test_textures.py's rays (down onto the triangle near its uv corner)
    and a seeded grid over and past the triangle, from above and below."""
    scene = textured_scene()
    r = np.random.RandomState(4)
    xy = r.rand(256, 2) * 5.0 - 0.5
    z = np.where(r.rand(256) < 0.5, 1.0, -1.0)
    o = np.concatenate([[[0.3, 0.3, 1.0], [0.5, 0.5, 1.0]],
                        np.c_[xy, z]]).astype(np.float32)
    d = np.concatenate([[[0, 0, -1], [0, 0, -1]],
                        np.c_[0.1 * r.randn(256, 2), -z]])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rec = intersect_scene(scene, Vec3(*[torch.from_numpy(o[:, i].copy())
                                        for i in range(3)]),
                          Vec3(*[torch.from_numpy(d[:, i].copy())
                                 for i in range(3)]))
    jrec = j_intersect(jax_textured_scene(),
                       JVec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
                       JVec3(*[jnp.asarray(d[:, i]) for i in range(3)]))
    n = check_hit_records(scene, o, d, rec, jrec)
    assert bool(rec.hit[0]) and bool(rec.hit[1])
    assert n["held"] >= 0.97 * n["hits"] and n["hits"] > 64, n
    assert 0 < rec.hit.float().mean() < 1
