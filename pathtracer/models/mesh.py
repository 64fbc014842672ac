"""Triangle meshes + threaded BVH, as flat SoA arrays.

Fills the reference's two acknowledged gaps: "will be changed to triangle
later" (reference primitive.h:26) and "TODO kd-tree acceleration
structure" (reference scene.h:33). BASELINE config 4 (~100k-tri textured
scene) builds on this.

Design decisions:
  - The BVH is *threaded* (stackless): nodes are laid out in DFS order
    with a precomputed `skip` link. Traversal is one data-dependent loop
    per lane — `node = hit ? node+1 : skip[node]` — with no per-lane
    stack, so it maps onto `lax.while_loop` over SoA lanes without
    scatter/stack machinery.
  - Leaves hold up to LEAF_SIZE contiguous triangles (triangles are
    REORDERED at build time), so leaf tests are a static unrolled loop
    over a dynamic-sliceable range.
  - Triangles are stored as (v0, e1, e2) with precomputed edges for
    Möller-Trumbore, plus per-triangle shading data (normal, uv, material).

The builder is host-side NumPy (median split on the longest centroid
axis). Build time for 100k tris is a few seconds; an SAH C++ builder can
swap in behind the same array contract.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array
from pathtracer.utils.pytree import pytree_dataclass, static_field

LEAF_SIZE = 4


@pytree_dataclass
class MeshData:
    """Flattened mesh + BVH, ready for device traversal."""

    # triangles, reordered into BVH leaf order
    v0: Array  # (T, 3)
    e1: Array  # (T, 3) v1 - v0
    e2: Array  # (T, 3) v2 - v0
    n_geom: Array  # (T, 3) geometric normal (normalized)
    uv0: Array  # (T, 2)
    uv_e1: Array  # (T, 2) uv1 - uv0
    uv_e2: Array  # (T, 2) uv2 - uv0
    material_id: Array  # (T,) int32

    # threaded BVH, DFS order
    node_min: Array  # (M, 3)
    node_max: Array  # (M, 3)
    node_skip: Array  # (M,) int32 — next node on miss / after a leaf
    node_start: Array  # (M,) int32 — first triangle (leaves)
    node_count: Array  # (M,) int32 — triangle count (0 for inner nodes)

    # gather-friendly packed copies: ONE row fetch per traversal step
    # instead of five separate gathers (ints stored as exact f32 < 2^24)
    nodes_packed: Array  # (M, 12): min3 max3 skip start count pad3
    tris_packed: Array  # (T, 12): v0 e1 e2 pad3

    num_tris: int = static_field(0)
    num_nodes: int = static_field(0)
    leaf_size: int = static_field(LEAF_SIZE)


def build_bvh(
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (T, 3) int
    uvs: np.ndarray | None = None,  # (V, 2)
    material_id: np.ndarray | int = 0,
    leaf_size: int = LEAF_SIZE,
    use_native: bool = True,
) -> MeshData:
    """Build the threaded BVH over a triangle mesh (host-side).

    Uses the native C++ binned-SAH builder (native/bvh_builder.cpp via
    pathtracer.native.bvh) when available — better trees, ~100x faster
    builds on large meshes — with this NumPy median-split builder as the
    always-available fallback. Both emit the same threaded-DFS layout.
    """
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    T = faces.shape[0]
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), np.float64)
    else:
        uvs = np.asarray(uvs, np.float64)
    if np.isscalar(material_id):
        material_id = np.full((T,), material_id, np.int64)
    else:
        material_id = np.asarray(material_id, np.int64)

    if use_native:
        from pathtracer.native import bvh as native_bvh

        built = native_bvh.build_arrays(
            tri_min.astype(np.float32), tri_max.astype(np.float32),
            centroid.astype(np.float32), leaf_size,
        )
        if built is not None:
            (perm, nmin, nmax, nskip, nstart, ncount) = built
            return _finalize(
                v0, v1, v2, uvs, faces, material_id,
                perm.astype(np.int64), nmin, nmax, nskip, nstart, ncount,
                leaf_size=leaf_size,
            )

    order: list[int] = []  # triangle permutation (leaf order)
    # node records: [min, max, start, count, parent-ish]; children patched in
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_start: list[int] = []
    nodes_count: list[int] = []
    nodes_end: list[int] = []  # index of the node AFTER this subtree (skip)

    def rec(idx: np.ndarray) -> None:
        """Emit the subtree over triangle indices `idx`; DFS order."""
        me = len(nodes_min)
        bb_min = tri_min[idx].min(axis=0)
        bb_max = tri_max[idx].max(axis=0)
        nodes_min.append(bb_min)
        nodes_max.append(bb_max)
        if len(idx) <= leaf_size:
            nodes_start.append(len(order))
            nodes_count.append(len(idx))
            nodes_end.append(0)  # patched below
            order.extend(idx.tolist())
            nodes_end[me] = len(nodes_min)
            return
        nodes_start.append(0)
        nodes_count.append(0)
        nodes_end.append(0)
        # median split on longest centroid axis
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = len(idx) // 2
        part = np.argpartition(c[:, axis], mid)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])
        nodes_end[me] = len(nodes_min)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    perm = np.asarray(order, np.int64)
    return _finalize(
        v0, v1, v2, uvs, faces, material_id, perm,
        np.stack(nodes_min), np.stack(nodes_max),
        np.asarray(nodes_end), np.asarray(nodes_start),
        np.asarray(nodes_count), leaf_size=leaf_size,
    )


def _finalize(v0, v1, v2, uvs, faces, material_id, perm,
              node_min, node_max, node_skip, node_start, node_count,
              leaf_size=LEAF_SIZE) -> MeshData:
    """Reorder triangles into leaf order and pack the MeshData pytree."""
    T = perm.shape[0]
    v0o, v1o, v2o = v0[perm], v1[perm], v2[perm]
    e1o = v1o - v0o
    e2o = v2o - v0o
    n = np.cross(e1o, e2o)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(n_len, 1e-20)
    uv0o = uvs[faces[perm, 0]]
    uv1o = uvs[faces[perm, 1]]
    uv2o = uvs[faces[perm, 2]]

    M = int(node_min.shape[0])
    nodes_packed = np.zeros((M, 12), np.float32)
    nodes_packed[:, 0:3] = node_min
    nodes_packed[:, 3:6] = node_max
    nodes_packed[:, 6] = node_skip
    nodes_packed[:, 7] = node_start
    nodes_packed[:, 8] = node_count
    tris_packed = np.zeros((T, 12), np.float32)
    tris_packed[:, 0:3] = v0o
    tris_packed[:, 3:6] = e1o
    tris_packed[:, 6:9] = e2o

    return MeshData(
        v0=jnp.asarray(v0o, jnp.float32),
        e1=jnp.asarray(e1o, jnp.float32),
        e2=jnp.asarray(e2o, jnp.float32),
        n_geom=jnp.asarray(n, jnp.float32),
        uv0=jnp.asarray(uv0o, jnp.float32),
        uv_e1=jnp.asarray(uv1o - uv0o, jnp.float32),
        uv_e2=jnp.asarray(uv2o - uv0o, jnp.float32),
        material_id=jnp.asarray(material_id[perm], jnp.int32),
        node_min=jnp.asarray(node_min, jnp.float32),
        node_max=jnp.asarray(node_max, jnp.float32),
        node_skip=jnp.asarray(node_skip, jnp.int32),
        node_start=jnp.asarray(node_start, jnp.int32),
        node_count=jnp.asarray(node_count, jnp.int32),
        nodes_packed=jnp.asarray(nodes_packed),
        tris_packed=jnp.asarray(tris_packed),
        num_tris=T,
        num_nodes=M,
        leaf_size=leaf_size,
    )
