"""Ray-triangle intersection + threaded-BVH traversal (SoA lanes).

The triangle/accelerator stage the reference never reached
(primitive.h:26, scene.h:33). Traversal is the stackless array form:
each lane carries one node pointer through a `lax.while_loop`;
`node = hit ? node+1 : skip[node]` (DFS threading, models/mesh.py). Leaf
tests are a static LEAF_SIZE-unrolled Möller-Trumbore loop, so the whole
traversal is fixed-shape lane math + per-lane gathers — no stacks, no
scatters, no dynamic shapes.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array, lax

from pathtracer.utils.pytree import pytree_dataclass
from pathtracer.models.mesh import MeshData
from pathtracer.ops import vecmath as vm

BIG = 1e30


@pytree_dataclass
class TriHit:
    t: Array  # (N,) BIG on miss
    tri: Array  # (N,) int32 triangle index (post-reorder), 0 on miss
    u: Array  # (N,) barycentric u
    v: Array  # (N,) barycentric v


def moller_trumbore(
    o: Array, d: Array, v0: Array, e1: Array, e2: Array,
    tmin: float, t_best: Array,
) -> tuple[Array, Array, Array, Array]:
    """Batched Möller-Trumbore; all inputs (N,3) (or broadcastable).

    Returns (valid, t, u, v). Two-sided (no backface culling), matching the
    reference's two-sided sphere shading convention.
    """
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    ok_det = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = (
        ok_det
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < t_best)
    )
    return valid, t, u, v


def intersect_mesh(
    mesh: MeshData,
    o: Array,
    d: Array,
    tmin: float,
    tmax: Array | float = BIG,
    any_hit: bool = False,
) -> TriHit:
    """Traversal of the threaded BVH for N rays.

    any_hit=True is the shadow-ray mode (scene.h:101-108 IntersectP): a
    lane retires at its FIRST accepted hit instead of the closest, which
    converges the lockstep while_loop far faster.
    """
    n = o.shape[0]
    M = mesh.num_nodes

    # Axis-parallel rays: clamp |d| away from 0, keeping the sign, so the
    # slab test degenerates gracefully instead of producing inf-inf NaNs.
    safe_d = jnp.where(
        jnp.abs(d) > 1e-12, d, jnp.where(d >= 0, 1e-12, -1e-12)
    )
    inv_d = 1.0 / safe_d

    t_init = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))

    def cond(state):
        node, *_ = state
        return jnp.any(node < M)

    def body(state):
        node, t_best, idx, uu, vv = state
        nc = jnp.minimum(node, M - 1)
        nd = jnp.take(mesh.nodes_packed, nc, axis=0)  # (N,12) one gather
        nd_min = nd[:, 0:3]
        nd_max = nd[:, 3:6]
        skip = nd[:, 6].astype(jnp.int32)
        start = nd[:, 7].astype(jnp.int32)
        count = nd[:, 8].astype(jnp.int32)

        # slab test against [tmin, t_best] (reference BBox::IntersectP
        # semantics, geometry.h:421-444 — dormant there, load-bearing here)
        t0s = (nd_min - o) * inv_d
        t1s = (nd_max - o) * inv_d
        tn = jnp.max(jnp.minimum(t0s, t1s), axis=-1)
        tf = jnp.min(jnp.maximum(t0s, t1s), axis=-1)
        box_hit = (tn <= tf) & (tf > tmin) & (tn < t_best)

        is_leaf = count > 0
        test_leaf = box_hit & is_leaf
        for j in range(mesh.leaf_size):
            tri = jnp.minimum(start + j, mesh.v0.shape[0] - 1)
            m = test_leaf & (j < count)
            td = jnp.take(mesh.tris_packed, tri, axis=0)  # (N,12) one gather
            valid, t, u_, v_ = moller_trumbore(
                o, d, td[:, 0:3], td[:, 3:6], td[:, 6:9], tmin, t_best
            )
            better = m & valid
            t_best = jnp.where(better, t, t_best)
            idx = jnp.where(better, tri, idx)
            uu = jnp.where(better, u_, uu)
            vv = jnp.where(better, v_, vv)

        active = node < M
        next_node = jnp.where(
            is_leaf | ~box_hit, skip, node + 1
        )
        if any_hit:
            # first accepted hit retires the lane immediately
            next_node = jnp.where(t_best < t_init, M, next_node)
        node = jnp.where(active, next_node, node)
        return node, t_best, idx, uu, vv

    # Derive the zero carries from the ray arrays (not fresh constants):
    # under shard_map the body outputs carry the mesh axes' varying tag,
    # and lax.while_loop requires the initial carry to match (same trick
    # as models/integrator.py's carry0).
    zf = o[:, 0] * 0.0
    zi = zf.astype(jnp.int32)
    state0 = (zi, t_init + zf, zi, zf, zf)
    node, t_best, idx, uu, vv = lax.while_loop(cond, body, state0)
    hit_t = jnp.where(t_best < t_init, t_best, BIG)
    return TriHit(t=hit_t, tri=idx, u=uu, v=vv)


def mesh_brute_force_t(
    mesh: MeshData, o: Array, d: Array, tmin: float
) -> TriHit:
    """O(N*T) oracle: test every triangle (for BVH validation tests)."""
    n = o.shape[0]

    def per_tri(carry, i):
        t_best, idx, uu, vv = carry
        valid, t, u_, v_ = moller_trumbore(
            o, d, mesh.v0[i], mesh.e1[i], mesh.e2[i], tmin, t_best
        )
        t_best = jnp.where(valid, t, t_best)
        idx = jnp.where(valid, i, idx)
        uu = jnp.where(valid, u_, uu)
        vv = jnp.where(valid, v_, vv)
        return (t_best, idx, uu, vv), None

    init = (
        jnp.full((n,), BIG),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
    )
    (t, idx, uu, vv), _ = lax.scan(
        per_tri, init, jnp.arange(mesh.num_tris, dtype=jnp.int32)
    )
    return TriHit(t=t, tri=idx, u=uu, v=vv)
