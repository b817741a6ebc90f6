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

On top, the port keeps a BVH with small leaves, built from the five JAX
arrays (so tables imported from the JAX package get it too), which
``csrc/bvh_walk.cu`` walks for the nearest hit, the any hit and the
transmittance: a binary tree over the real clusters' boxes on top
(``build_tree``), and below each cluster a median split of its real rows
down to leaves of at most ``BVH_LEAF`` rows. ``bvh_nodes [K, 16]`` float32,
64 bytes per inner node: both children's boxes as ``a.lo.x a.hi.x a.lo.y
a.hi.y | b.lo.x b.hi.x b.lo.y b.hi.y | a.lo.z a.hi.z b.lo.z b.hi.z`` and,
as int32 bits, ``link a, link b, 0, 0``; a link >= 0 is an inner node, a
link < 0 a leaf of rows ``first .. first + count`` with ``-1 - link = first
<< 4 | count``; node 0 is the root. ``bvh_rows [R, 12]`` float32 holds the
real rows' first 12 Woop floats (r1 c1 | r2 c2 | r3' c3', 48 bytes) in leaf
order, bit for bit, and ``bvh_virt [R]`` int32 their virtual ids (cluster
* 64 + slot); the transmittance reads a row's alpha through its virtual id
from ``woop``.

Every box is padded outward by ``1e-5 * max(|lo|, |hi|) + 1e-4`` per axis,
the margin of the JAX visit lists (cluster.py:237-252): a ray's slab test
then never culls a triangle hit inside the box by rounding, and flat
clusters (a ground plane, flat terrain patches) keep a thickness. The BVH
bounds each row by the triangle its float32 Woop rows describe (the rows
inverted in float64), which is the triangle the kernels test.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve

CLUSTER_SIZE = 64
WOOP_F = 14             # floats per triangle row: 12 + |n| + alpha
C_ALIGN = 1024          # cluster count padding of the JAX layout
BVH_LEAF = 4            # rows per BVH leaf at most
BVH_STACK = 32          # traversal stack of csrc/bvh_walk.cu (kStack)
NODE_F = 16             # floats per BVH node: 4 float4
ROW_F = 12              # floats per BVH row: 3 float4
LEAF_BITS = 4           # -1 - leaf link = first row << LEAF_BITS | count


@dataclasses.dataclass(frozen=True)
class Clusters:
    """The cluster tables on one device. The BVH rows are copied from
    ``woop`` when the tables are built: ``dataclasses.replace(clusters,
    woop=...)`` leaves ``bvh_rows`` as it was, so it may change the alphas
    (slot 13, which the transmittance kernel reads from ``woop``) and
    nothing the BVH holds. Construction checks that: a ``woop`` whose
    first 12 floats of a row differ, bit for bit, from that row's copy in
    ``bvh_rows`` raises. ``n_real``, the number of real rows in
    ``tri_idx``, is counted on construction (not a field), so the kernels'
    wrappers can hold ``bvh_virt`` to it without reading the device."""
    aabb: torch.Tensor       # [C, 8] f32: min(3), max(3), 2 pad
    woop: torch.Tensor       # [C, 8, 128] f32: CLUSTER_SIZE * WOOP_F + pad
    tri_idx: torch.Tensor    # [C, CLUSTER_SIZE] i32 original ids, -1 pad
    scene_lo: torch.Tensor   # [3] f32
    scene_hi: torch.Tensor   # [3] f32
    bvh_nodes: torch.Tensor  # [K, NODE_F] f32: child boxes, links (i32)
    bvh_rows: torch.Tensor   # [R, ROW_F] f32 Woop rows in leaf order
    bvh_virt: torch.Tensor   # [R] i32 virtual id of each row

    def __post_init__(self):
        n_real, moved = torch.stack([(self.tri_idx >= 0).sum(),
                                     self._moved_rows()]).tolist()
        if moved:
            raise ValueError(
                f"{moved} rows of woop differ from their copies in bvh_rows "
                "in the geometry the BVH was built from: rebuild the tables "
                "from the new woop (clusters_from_numpy), do not replace "
                "woop alone")
        object.__setattr__(self, "n_real", n_real)

    @property
    def n_clusters(self) -> int:
        return self.aabb.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_idx.shape[1]

    def _moved_rows(self) -> torch.Tensor:
        """The number of BVH rows whose 12 floats differ, bit for bit, from
        the Woop row that ``bvh_virt`` names, as an int64 tensor; 0 where
        the shapes, types or devices do not fit together (the kernels'
        wrappers refuse those)."""
        rows, virt, woop = self.bvh_rows, self.bvh_virt, self.woop
        zero = torch.zeros((), dtype=torch.int64, device=self.tri_idx.device)
        if (rows.dtype != torch.float32 or woop.dtype != torch.float32 or
                rows.dim() != 2 or rows.shape[1] != ROW_F or
                virt.dim() != 1 or virt.shape[0] != rows.shape[0] or
                woop.dim() != 3 or woop.shape[1] * woop.shape[2] <
                CLUSTER_SIZE * WOOP_F or not rows.device == virt.device ==
                woop.device == zero.device or rows.shape[0] == 0 or
                woop.shape[0] == 0):
            return zero
        woop_rows = woop.reshape(woop.shape[0], -1)[
            :, :CLUSTER_SIZE * WOOP_F].reshape(-1, WOOP_F)
        virt = virt.long()
        fits = (virt >= 0) & (virt < woop_rows.shape[0])
        src = woop_rows[virt.clamp(0, woop_rows.shape[0] - 1), :ROW_F]
        differ = (src.view(torch.int32) != rows.view(torch.int32)).any(dim=1)
        return (differ & fits).sum()


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


def build_tree(aabb: np.ndarray) -> np.ndarray:
    """Binary tree over the real clusters of ``aabb [C, 8]`` (rows with
    min <= max; the padding's inverted boxes are skipped): a median split on
    the longest axis of the node's box, by cluster centroid. Returns
    ``node_link [K, 2]`` int32 in depth-first order, the two child node ids
    of an inner node, or ``(-1 - cluster, -1)`` for a leaf; node 0 is the
    root. ``build_bvh`` puts its inner nodes on top of the BVH."""
    lo = aabb[:, :3]
    hi = aabb[:, 3:6]
    real = np.nonzero((lo <= hi).all(axis=1))[0]
    if len(real) == 0:
        raise ValueError("cluster table has no real cluster")
    centroid = 0.5 * (lo.astype(np.float64) + hi.astype(np.float64))
    links = []
    stack = [(real, -1, 0)]             # (cluster ids, parent, slot)
    while stack:
        ids, parent, slot = stack.pop()
        k = len(links)
        if parent >= 0:
            links[parent][slot] = k
        if len(ids) == 1:
            links.append([-1 - int(ids[0]), -1])
            continue
        links.append([0, 0])
        blo = lo[ids].min(axis=0)
        bhi = hi[ids].max(axis=0)
        axis = int(np.argmax(bhi.astype(np.float64) - blo))
        srt = ids[np.argsort(centroid[ids, axis], kind="stable")]
        mid = len(srt) // 2
        stack.append((srt[mid:], k, 1))
        stack.append((srt[:mid], k, 0))
    return np.asarray(links, np.int32).reshape(-1, 2)


def real_woop_rows(woop: np.ndarray, tri_idx: np.ndarray):
    """(rows [R, WOOP_F], virtual ids [R]) of the table's real rows in row
    order (numpy)."""
    c = tri_idx.shape[0]
    rows = woop.reshape(c, -1)[:, :CLUSTER_SIZE * WOOP_F] \
        .reshape(c * CLUSTER_SIZE, WOOP_F)
    virt = np.nonzero(tri_idx.reshape(-1) >= 0)[0]
    return rows[virt], virt


def row_bounds(rows: np.ndarray):
    """(lo, hi, ok) of the triangles that float32 Woop rows ``rows [R, >=
    12]`` describe: lo, hi [R, 3] float64 and ok [R] bool. With M the rows
    r1, r2, r3' and c the offsets c1, c2, c3', the corners solve
    M p = c + (0, 0, 0), (1, 0, 0) and (0, 1, 0). Degenerate rows (all
    zero: their tests always reject) have ok False and lo = hi = 0."""
    m = rows[:, :12].astype(np.float64).reshape(-1, 3, 4)
    mat, off = m[:, :, :3], m[:, :, 3]
    ok = np.linalg.det(mat) != 0.0
    inv = np.linalg.inv(np.where(ok[:, None, None], mat, np.eye(3)))
    p0 = np.einsum('rij,rj->ri', inv, off)
    corners = np.stack([p0, p0 + inv[:, :, 0], p0 + inv[:, :, 1]], axis=1)
    corners[~ok] = 0.0
    return corners.min(axis=1), corners.max(axis=1), ok


def _seg_reduce(ufunc, vals: np.ndarray, starts: np.ndarray,
                sizes: np.ndarray) -> np.ndarray:
    """``ufunc`` over the rows of each segment [start, start + size) of
    ``vals`` (every size >= 1)."""
    idx = np.stack([starts, starts + sizes], axis=1).ravel()
    return ufunc.reduceat(np.concatenate([vals, vals[:1]]), idx, axis=0)[::2]


def _child_boxes(lo_a, hi_a, lo_b, hi_b) -> np.ndarray:
    """[n, 12] float32 box floats of inner nodes from their two children's
    bounds (float64 [n, 3] each), padded outward."""
    (la, ha), (lb, hb) = _padded(lo_a, hi_a), _padded(lo_b, hi_b)
    return np.stack([la[:, 0], ha[:, 0], la[:, 1], ha[:, 1],
                     lb[:, 0], hb[:, 0], lb[:, 1], hb[:, 1],
                     la[:, 2], ha[:, 2], lb[:, 2], hb[:, 2]], axis=1)


def _split_clusters(lo, hi, c_start, c_size, first_id: int):
    """Median splits of every cluster's rows down to leaves of at most
    ``BVH_LEAF``, all clusters at once, level by level. ``lo``/``hi`` [R, 3] row bounds, rows grouped by cluster at
    ``c_start``/``c_size``. Returns (order: leaf-order position -> row,
    root link per cluster, the inner nodes' boxes [n, 12] and links [n, 2]
    as one array per level, numbered from ``first_id`` level by level, the
    number of levels)."""
    cen = 0.5 * (lo + hi)
    order = np.arange(len(lo))
    root = np.empty(len(c_start), np.int64)
    boxes, links = [], []
    # segments: first position, size, parent node (-1: a cluster), slot
    start, size = c_start, c_size
    parent, slot = np.full(len(start), -1), np.zeros(len(start), np.int64)
    n_nodes = first_id
    while True:
        split = size > BVH_LEAF
        link = np.where(split, np.cumsum(split) - 1 + n_nodes,
                        -1 - ((start << LEAF_BITS) | size))
        if parent[0] < 0:
            root[:] = link
        else:
            links[-1][parent - (n_nodes - len(links[-1])), slot] = link
        start, size = start[split], size[split]
        if not len(start):
            return order, root, boxes, links, len(boxes)
        # sort each splitting segment's rows by centroid on its longest axis
        ext = _seg_reduce(np.maximum, hi[order], start, size) - \
            _seg_reduce(np.minimum, lo[order], start, size)
        axis = np.argmax(ext, axis=1)
        which = np.repeat(np.arange(len(start)), size)
        pos = np.arange(len(which)) + np.repeat(start - np.cumsum(size) + size,
                                                size)
        rows = order[pos]
        order[pos] = rows[np.lexsort((cen[rows, axis[which]], which))]
        mid = size // 2
        kid_start = np.stack([start, start + mid], axis=1).ravel()
        kid_size = np.stack([mid, size - mid], axis=1).ravel()
        k_lo = _seg_reduce(np.minimum, lo[order], kid_start, kid_size)
        k_hi = _seg_reduce(np.maximum, hi[order], kid_start, kid_size)
        boxes.append(_child_boxes(k_lo[0::2], k_hi[0::2], k_lo[1::2],
                                  k_hi[1::2]))
        links.append(np.zeros((len(start), 2), np.int64))
        ids = np.arange(n_nodes, n_nodes + len(start))
        n_nodes += len(start)
        start, size = kid_start, kid_size
        parent, slot = np.repeat(ids, 2), np.tile(np.arange(2), len(ids))


def _levels(node_link: np.ndarray) -> list:
    """The node ids of a tree ``node_link [K, 2]`` (a link < 0 in column 0:
    a leaf; node 0 the root), one array per level from the root down."""
    levels, level = [], np.zeros(1, np.int64)
    while len(level):
        levels.append(level)
        level = node_link[level[node_link[level, 0] >= 0]].ravel()
    return levels


def build_bvh(aabb: np.ndarray, woop: np.ndarray, tri_idx: np.ndarray,
              node_link: np.ndarray):
    """The BVH of the module docstring -> (bvh_nodes [K, 16] f32,
    bvh_rows [R, 12] f32, bvh_virt [R] i32, depth in inner nodes, the most
    a walk's stack holds).

    Top levels: the inner nodes of the cluster tree ``node_link`` (from
    ``build_tree``), in its depth-first order. Below each real cluster: its
    real rows split at the median (``len // 2``) by centroid on the longest
    axis of their bounds while more than ``BVH_LEAF`` remain. A cluster's box
    is the union of its ``aabb`` row and its rows' bounds, an inner node's
    the union of its children's. A degenerate row is bounded by a point at
    its cluster's ``aabb`` minimum."""
    rows, virt = real_woop_rows(woop, tri_idx)
    if len(virt) >= 1 << (30 - LEAF_BITS):
        raise ValueError(f"{len(virt)} rows exceed the leaf link's range")
    cluster = virt // CLUSTER_SIZE
    lo, hi, ok = row_bounds(rows)
    lo[~ok] = hi[~ok] = aabb[cluster[~ok], :3]
    c_ids, c_start, c_size = np.unique(cluster, return_index=True,
                                       return_counts=True)
    top_leaf = node_link[:, 0] < 0
    if not np.array_equal(np.sort(-1 - node_link[top_leaf, 0]), c_ids):
        raise ValueError("the cluster tree's leaves are not the clusters "
                         "with real rows")
    c_lo = np.minimum(_seg_reduce(np.minimum, lo, c_start, c_size),
                      aabb[c_ids, :3])
    c_hi = np.maximum(_seg_reduce(np.maximum, hi, c_start, c_size),
                      aabb[c_ids, 3:6])

    top = np.nonzero(~top_leaf)[0]
    order, root, boxes, links, levels = _split_clusters(
        lo, hi, c_start, c_size, len(top))

    # the cluster tree level by level: a leaf takes its cluster's box and
    # root link, an inner node (bottom-up) the union of its children's boxes
    k_top = len(node_link)
    t_lo, t_hi = np.zeros((k_top, 3)), np.zeros((k_top, 3))
    t_link = np.zeros(k_top, np.int64)
    t_link[top] = np.arange(len(top))
    c_row = np.zeros(len(aabb), np.int64)
    c_row[c_ids] = np.arange(len(c_ids))
    leaf_k = np.nonzero(top_leaf)[0]
    r = c_row[-1 - node_link[leaf_k, 0]]
    t_lo[leaf_k], t_hi[leaf_k], t_link[leaf_k] = c_lo[r], c_hi[r], root[r]
    depth = np.zeros(k_top, np.int64)
    tree_levels = _levels(node_link)
    for d, level in enumerate(tree_levels):
        depth[level] = d
    for level in tree_levels[::-1]:
        k = level[node_link[level, 0] >= 0]
        a, b = node_link[k, 0], node_link[k, 1]
        t_lo[k] = np.minimum(t_lo[a], t_lo[b])
        t_hi[k] = np.maximum(t_hi[a], t_hi[b])
    if not len(top) and root[0] < 0:
        # one cluster of at most ``BVH_LEAF`` rows: a root over it and an
        # empty leaf (count 0)
        top_boxes = _child_boxes(c_lo, c_hi, c_lo, c_hi)
        top_links = np.array([[root[0], -1]])
    else:
        a, b = node_link[top, 0], node_link[top, 1]
        top_boxes = _child_boxes(t_lo[a], t_hi[a], t_lo[b], t_hi[b])
        top_links = np.stack([t_link[a], t_link[b]], axis=1)
    nodes = np.zeros((len(top_boxes) + sum(len(x) for x in boxes), NODE_F),
                     np.float32)
    nodes[:, :12] = np.concatenate([top_boxes, *boxes])
    nodes.view(np.int32)[:, 12:14] = np.concatenate([top_links, *links])
    stack = max(int(depth[top_leaf].max()) + levels, 1)
    if stack > BVH_STACK:
        raise ValueError(f"BVH depth {stack} exceeds the traversal stack of "
                         f"{BVH_STACK}")
    return (nodes, np.ascontiguousarray(rows[order, :ROW_F]),
            virt[order].astype(np.int32), stack)


def clusters_from_numpy(arrays: dict, device=DEFAULT_DEVICE) -> Clusters:
    """``Clusters`` on ``device`` from the five JAX-layout arrays (keys
    ``aabb``, ``woop``, ``tri_idx``, ``scene_lo``, ``scene_hi``), with the
    port's BVH built from them."""
    device = resolve(device)
    aabb = np.asarray(arrays["aabb"], np.float32)
    woop = np.asarray(arrays["woop"], np.float32)
    tri_idx = np.asarray(arrays["tri_idx"], np.int32)
    nodes, rows, virt, _ = build_bvh(aabb, woop, tri_idx, build_tree(aabb))
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return Clusters(aabb=t(aabb), woop=t(woop), tri_idx=t(tri_idx),
                    scene_lo=t(arrays["scene_lo"]),
                    scene_hi=t(arrays["scene_hi"]), bvh_nodes=t(nodes),
                    bvh_rows=t(rows), bvh_virt=t(virt))
