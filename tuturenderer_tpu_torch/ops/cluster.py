"""Cluster tables for mesh-scale scenes (host side, numpy).

The layout of ``tuturenderer_tpu/ops/pallas/cluster.py`` (``Clusters``,
``woop_rows``, ``pack_woop``, ``build_clusters``), kept exactly so a table
built here is bit-equal to the JAX package's:

- triangles are grouped by a median split on the longest axis into
  clusters of at most 64;
- ``aabb [C, 8]``: min(3), max(3), 2 pad; ``woop [C, 8, 128]``: 64 rows of
  ``WOOP_F`` = 14 floats, r1(3) c1 r2(3) c2 r3'(3) c3' nlen alpha, where
  the r3/c3 row is prescaled by |n| so ``w_d = d . r3'`` is the parallel
  test's ``dir . n_hat`` directly; ``tri_idx [C, 64]`` original triangle
  ids, -1 in the padding;
- C is padded to a multiple of ``C_ALIGN`` = 1024 with inverted boxes.

On top, the port keeps a binary tree over the real clusters' boxes for the
per-ray traversal of ``csrc/cluster_walk.cu``, built from ``aabb`` alone
(so tables imported from the JAX package get it too): ``node_box [K, 8]``
(lo(3), hi(3), 2 pad) and ``node_link [K, 2]`` int32, the two child node
ids of an inner node, or ``(-1 - cluster, -1)`` for a leaf. Node 0 is the
root. Each node box is padded outward by ``1e-5 * max(|lo|, |hi|) + 1e-4``
per axis, the margin of the JAX visit lists (cluster.py:237-252): a ray's
slab test then never culls a triangle hit inside the box by rounding, and
flat clusters (a ground plane, flat terrain patches) keep a thickness.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve

CLUSTER_SIZE = 64
WOOP_F = 14             # floats per triangle row: 12 + |n| + alpha
C_ALIGN = 1024          # cluster count padding of the JAX layout
TREE_STACK = 64         # traversal stack of the kernels (csrc kStack)


@dataclasses.dataclass(frozen=True)
class Clusters:
    aabb: torch.Tensor       # [C, 8] f32: min(3), max(3), 2 pad
    woop: torch.Tensor       # [C, 8, 128] f32: CLUSTER_SIZE * WOOP_F + pad
    tri_idx: torch.Tensor    # [C, CLUSTER_SIZE] i32 original ids, -1 pad
    scene_lo: torch.Tensor   # [3] f32
    scene_hi: torch.Tensor   # [3] f32
    node_box: torch.Tensor   # [K, 8] f32 padded lo(3), hi(3), 2 pad
    node_link: torch.Tensor  # [K, 2] i32 children, or (-1 - cluster, -1)


def woop_rows(verts: np.ndarray):
    """Per-triangle inverse-basis rows, factorised in float64. Returns
    (rows [T,3,3], c [T,3], nlen [T]), rows zeroed for degenerate
    triangles (their tests then always reject)."""
    v0 = verts[:, 0].astype(np.float64)
    e1 = verts[:, 1].astype(np.float64) - v0
    e2 = verts[:, 2].astype(np.float64) - v0
    n = np.cross(e1, e2)
    basis = np.stack([e1, e2, n], axis=2)
    det = np.linalg.det(basis)
    ok = np.abs(det) > 1e-30
    safe = basis.copy()
    safe[~ok] = np.eye(3)
    rows = np.linalg.inv(safe)
    rows[~ok] = 0.0
    c = np.einsum('tij,tj->ti', rows, v0)
    c[~ok] = 0.0
    return rows, c, np.linalg.norm(n, axis=1)


def pack_woop(rows: np.ndarray, c: np.ndarray, nlen: np.ndarray,
              alpha: np.ndarray) -> np.ndarray:
    """[T, WOOP_F] rows r1(3) c1 r2(3) c2 r3'(3) c3' nlen alpha, with
    r3' = r3 |n| and c3' = c3 |n|."""
    t = rows.shape[0]
    p = np.concatenate([rows, c[:, :, None]], axis=2)        # [t, 3, 4]
    p[:, 2, :] = p[:, 2, :] * nlen[:, None]
    p = p.reshape(t, 12)
    return np.concatenate([p, nlen[:, None], alpha[:, None]],
                          axis=1).astype(np.float32)


def build_clusters(verts: np.ndarray, alphas: np.ndarray = None) -> dict:
    """The JAX layout as numpy arrays (``clusters_from_numpy`` makes the
    tensors): median-split grouping of triangles into padded clusters of
    CLUSTER_SIZE. ``alphas``: per-triangle opacity for the transmittance
    kernel (fully opaque by default)."""
    t = verts.shape[0]
    if alphas is None:
        alphas = np.ones((t,), np.float32)
    lo = verts.min(axis=1)
    hi = verts.max(axis=1)
    centroid = 0.5 * (lo + hi)

    groups = []
    stack = [np.arange(t)]
    while stack:
        idx = stack.pop()
        if len(idx) <= CLUSTER_SIZE:
            groups.append(idx)
            continue
        bmin = lo[idx].min(axis=0)
        bmax = hi[idx].max(axis=0)
        axis = int(np.argmax(bmax - bmin))
        srt = idx[np.argsort(centroid[idx, axis], kind="stable")]
        mid = len(srt) // 2
        stack.append(srt[mid:])
        stack.append(srt[:mid])

    cnum = -(-len(groups) // C_ALIGN) * C_ALIGN
    rows, cvec, nlen = woop_rows(verts)
    w = pack_woop(rows, cvec, nlen, np.asarray(alphas, np.float32))

    aabb = np.zeros((cnum, 8), np.float32)
    aabb[:, :3] = np.float32(3.4e38)       # padded clusters: empty boxes
    aabb[:, 3:6] = np.float32(-3.4e38)
    woop = np.zeros((cnum, 8 * 128), np.float32)
    tri_idx = np.full((cnum, CLUSTER_SIZE), -1, np.int32)
    for ci, idx in enumerate(groups):
        aabb[ci, :3] = lo[idx].min(axis=0)
        aabb[ci, 3:6] = hi[idx].max(axis=0)
        woop[ci, :len(idx) * WOOP_F] = w[idx].reshape(-1)
        tri_idx[ci, :len(idx)] = idx
    return dict(aabb=aabb, woop=woop.reshape(cnum, 8, 128), tri_idx=tri_idx,
                scene_lo=lo.min(axis=0).astype(np.float32),
                scene_hi=hi.max(axis=0).astype(np.float32))


def _padded(lo: np.ndarray, hi: np.ndarray):
    """Box pushed outward by a relative and an absolute margin, rounded
    outward to float32."""
    lo = lo.astype(np.float64)
    hi = hi.astype(np.float64)
    margin = 1e-5 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-4
    lo32 = (lo - margin).astype(np.float32)
    hi32 = (hi + margin).astype(np.float32)
    lo32 = np.where(lo32 > lo - margin,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi + margin,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def build_tree(aabb: np.ndarray):
    """Binary tree over the real clusters of ``aabb [C, 8]`` (rows with
    min <= max; the padding's inverted boxes are skipped): a median split on
    the longest axis of the node's box, by cluster centroid. Returns
    (node_box [K, 8] f32, node_link [K, 2] i32) in depth-first order."""
    lo = aabb[:, :3]
    hi = aabb[:, 3:6]
    real = np.nonzero((lo <= hi).all(axis=1))[0]
    if len(real) == 0:
        raise ValueError("cluster table has no real cluster")
    centroid = 0.5 * (lo.astype(np.float64) + hi.astype(np.float64))
    boxes, links = [], []
    stack = [(real, -1, 0, 0)]          # (cluster ids, parent, slot, depth)
    max_depth = 0
    while stack:
        ids, parent, slot, depth = stack.pop()
        k = len(boxes)
        if parent >= 0:
            links[parent][slot] = k
        max_depth = max(max_depth, depth)
        blo = lo[ids].min(axis=0)
        bhi = hi[ids].max(axis=0)
        plo, phi = _padded(blo, bhi)
        boxes.append(np.concatenate([plo, phi, np.zeros(2, np.float32)]))
        if len(ids) == 1:
            links.append([-1 - int(ids[0]), -1])
            continue
        links.append([0, 0])
        axis = int(np.argmax(bhi.astype(np.float64) - blo))
        srt = ids[np.argsort(centroid[ids, axis], kind="stable")]
        mid = len(srt) // 2
        stack.append((srt[mid:], k, 1, depth + 1))
        stack.append((srt[:mid], k, 0, depth + 1))
    # a depth-first walk that pushes both children holds at most depth + 1
    if max_depth + 1 >= TREE_STACK:
        raise ValueError(f"cluster tree depth {max_depth} exceeds the "
                         f"traversal stack of {TREE_STACK}")
    return (np.stack(boxes).astype(np.float32),
            np.asarray(links, np.int32).reshape(-1, 2))


def clusters_from_numpy(arrays: dict, device=DEFAULT_DEVICE) -> Clusters:
    """``Clusters`` on ``device`` from the five JAX-layout arrays (keys
    ``aabb``, ``woop``, ``tri_idx``, ``scene_lo``, ``scene_hi``), with the
    port's tree built from ``aabb``."""
    device = resolve(device)
    aabb = np.asarray(arrays["aabb"], np.float32)
    node_box, node_link = build_tree(aabb)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return Clusters(aabb=t(aabb), woop=t(arrays["woop"]),
                    tri_idx=t(arrays["tri_idx"]),
                    scene_lo=t(arrays["scene_lo"]),
                    scene_hi=t(arrays["scene_hi"]),
                    node_box=t(node_box), node_link=t(node_link))
