"""Shrake-Rupley solvent-accessible surface area — device kernel.

The reference reaches SASA through mdtraj's C implementation
(enspara/info_theory/exposons.py:76 ``md.shrake_rupley``). Here the
algorithm runs on the device: per atom, a golden-spiral point shell of radius
(r_vdw + probe); a point is accessible when no other atom's inflated
sphere covers it. The occlusion test for all (atom, point, other-atom)
triples is a batched distance computation — large, regular, and
vectorizable; we block over atoms to bound memory.
"""

import functools

import numpy as np

from ..citation import cite

__all__ = ['shrake_rupley', 'sphere_points']


def sphere_points(n):
    """n points ~uniform on the unit sphere (golden-spiral), matching
    the classic Shrake-Rupley construction."""
    inc = np.pi * (3 - np.sqrt(5))
    offset = 2.0 / n
    k = np.arange(n)
    y = k * offset - 1 + offset / 2
    r = np.sqrt(np.maximum(1 - y * y, 0))
    phi = k * inc
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r],
                    axis=1).astype(np.float32)


def _radii_from_top(top):
    return np.array([a.radius for a in top.atoms], dtype=np.float32)


@cite('shrake-rupley')
def shrake_rupley(traj, probe_radius=0.14, n_sphere_points=960,
                  mode='atom', atom_block=64, mesh=None,
                  n_neighbors='auto'):
    """Per-atom (or per-residue) SASA in nm^2 for every frame.

    Parameters
    ----------
    traj : Trajectory (with topology for radii) or tuple
        ``(xyz (F, A, 3), radii (A,))``.
    probe_radius : float, nm (0.14 = water; exposons use 0.28).
    n_sphere_points : test points per atom (quality/cost knob).
    mode : 'atom' or 'residue'.
    mesh : optional multi-device mesh; frames shard across it
        (embarrassingly parallel, no collectives).
    n_neighbors : 'auto', int, or None. Only atoms with
        ``|x_i - x_j| < (r_i + p) + (r_j + p)`` can occlude atom i's
        shell, so the occlusion test runs over each atom's K nearest
        candidates instead of all A atoms. 'auto' measures the exact
        max neighbor count on device (cheap: one (A, A) distance pass)
        and sizes K to cover it — the result is EXACT, not
        approximate. None forces the dense all-pairs path.

    Returns
    -------
    (n_frames, n_atoms) or (n_frames, n_residues) float32 array.
    """
    if isinstance(traj, tuple):
        xyz, radii = traj
        top = None
    else:
        xyz = traj.xyz
        top = traj.top
        radii = _radii_from_top(top)

    xyz = np.asarray(xyz, dtype=np.float32)
    radii = np.asarray(radii, dtype=np.float32)
    out = _sasa_device(xyz, radii, float(probe_radius),
                       int(n_sphere_points), int(atom_block),
                       mesh=mesh, n_neighbors=n_neighbors)
    out = np.asarray(out)

    if mode == 'residue':
        if top is None:
            raise ValueError("mode='residue' requires a topology")
        res_out = np.zeros((out.shape[0], top.n_residues),
                           dtype=np.float32)
        for r in top.residues:
            idx = [a.index for a in r.atoms]
            res_out[:, r.index] = out[:, idx].sum(axis=1)
        return res_out
    return out


@functools.lru_cache(maxsize=8)
def _compiled_sasa(n_atoms, n_points, atom_block):
    import jax
    import jax.numpy as jnp

    pts = sphere_points(n_points)

    def per_frame(coords, rad_inflated, const_per_atom):
        # coords (A, 3), rad_inflated (A,) = r_vdw + probe
        n_blocks = (n_atoms + atom_block - 1) // atom_block
        pad = n_blocks * atom_block - n_atoms
        coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
        rad_p = jnp.pad(rad_inflated, (0, pad))

        def block(b):
            sl = jax.lax.dynamic_slice_in_dim(coords_p, b * atom_block,
                                              atom_block)
            rads = jax.lax.dynamic_slice_in_dim(rad_p, b * atom_block,
                                                atom_block)
            # shell points for each atom in block: (blk, P, 3)
            shell = sl[:, None, :] + rads[:, None, None] * pts[None]
            # occluded if any OTHER atom's inflated sphere covers the pt
            d2 = jnp.sum(
                (shell[:, :, None, :] - coords[None, None, :, :]) ** 2,
                axis=-1)                      # (blk, P, A)
            cover = d2 < (rad_inflated[None, None, :] ** 2)
            # an atom always covers its own shell boundary: discount by
            # masking the atom itself
            own = (jnp.arange(n_atoms)[None, None, :]
                   == (b * atom_block
                       + jnp.arange(atom_block))[:, None, None])
            occluded = jnp.any(cover & ~own, axis=-1)  # (blk, P)
            frac = 1.0 - jnp.mean(occluded, axis=-1)
            return frac * const_per_atom_block(rads)

        def const_per_atom_block(rads):
            return 4.0 * jnp.pi * rads * rads

        fracs = jax.lax.map(block, jnp.arange(n_blocks))  # (nb, blk)
        return fracs.reshape(-1)[:n_atoms]

    @jax.jit
    def sasa_all(xyz, rad_inflated):
        return jax.lax.map(
            lambda c: per_frame(c, rad_inflated, None), xyz)

    return sasa_all


@functools.lru_cache(maxsize=8)
def _compiled_neighbor_count(n_atoms, atom_block):
    """Exact max-over-(frame, atom) count of potential occluders:
    j != i with |x_i - x_j| < r_i + r_j (inflated radii)."""
    import jax
    import jax.numpy as jnp

    n_blocks = (n_atoms + atom_block - 1) // atom_block
    pad = n_blocks * atom_block - n_atoms

    def per_frame(coords, rad_inflated):
        coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
        rad_p = jnp.pad(rad_inflated, (0, pad))

        def block(b):
            sl = jax.lax.dynamic_slice_in_dim(coords_p, b * atom_block,
                                              atom_block)
            rads = jax.lax.dynamic_slice_in_dim(rad_p, b * atom_block,
                                                atom_block)
            d2 = jnp.sum((sl[:, None, :] - coords[None, :, :]) ** 2,
                         axis=-1)                       # (blk, A)
            thresh = (rads[:, None] + rad_inflated[None, :]) ** 2
            own = (jnp.arange(n_atoms)[None, :]
                   == (b * atom_block
                       + jnp.arange(atom_block))[:, None])
            rel = (d2 < thresh) & ~own
            return jnp.max(jnp.sum(rel, axis=-1))

        return jnp.max(jax.lax.map(block, jnp.arange(n_blocks)))

    @jax.jit
    def max_count(xyz, rad_inflated):
        return jnp.max(jax.lax.map(
            lambda c: per_frame(c, rad_inflated), xyz))

    return max_count


@functools.lru_cache(maxsize=16)
def _compiled_sasa_nl(n_atoms, n_points, atom_block, n_neighbors):
    """Neighbor-list Shrake-Rupley: occlusion tested against each
    atom's K nearest cutoff-satisfying candidates only. Exact whenever
    K >= the true max neighbor count (callers guarantee this via
    _compiled_neighbor_count)."""
    import jax
    import jax.numpy as jnp

    pts = sphere_points(n_points)
    n_blocks = (n_atoms + atom_block - 1) // atom_block
    pad = n_blocks * atom_block - n_atoms

    def per_frame(coords, rad_inflated):
        coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
        rad_p = jnp.pad(rad_inflated, (0, pad))

        def block(b):
            sl = jax.lax.dynamic_slice_in_dim(coords_p, b * atom_block,
                                              atom_block)
            rads = jax.lax.dynamic_slice_in_dim(rad_p, b * atom_block,
                                                atom_block)
            d2 = jnp.sum((sl[:, None, :] - coords[None, :, :]) ** 2,
                         axis=-1)                       # (blk, A)
            thresh = (rads[:, None] + rad_inflated[None, :]) ** 2
            own = (jnp.arange(n_atoms)[None, :]
                   == (b * atom_block
                       + jnp.arange(atom_block))[:, None])
            rel = (d2 < thresh) & ~own
            score = jnp.where(rel, -d2, -jnp.inf)
            vals, idx = jax.lax.top_k(score, n_neighbors)  # (blk, K)
            ncoords = coords[idx]                       # (blk, K, 3)
            # invalid slots (beyond the true neighbor count) get
            # radius 0: d2 >= 0 can never be < 0, so they never cover
            nrad = jnp.where(jnp.isfinite(vals),
                             rad_inflated[idx], 0.0)    # (blk, K)
            shell = sl[:, None, :] + rads[:, None, None] * pts[None]
            d2p = jnp.sum(
                (shell[:, :, None, :] - ncoords[:, None, :, :]) ** 2,
                axis=-1)                                # (blk, P, K)
            occluded = jnp.any(d2p < (nrad[:, None, :] ** 2), axis=-1)
            frac = 1.0 - jnp.mean(occluded, axis=-1)
            return frac * 4.0 * jnp.pi * rads * rads

        fracs = jax.lax.map(block, jnp.arange(n_blocks))
        return fracs.reshape(-1)[:n_atoms]

    @jax.jit
    def sasa_all(xyz, rad_inflated):
        return jax.lax.map(
            lambda c: per_frame(c, rad_inflated), xyz)

    return sasa_all


def _pick_n_neighbors(xyz, rad, n_atoms, atom_block, n_neighbors):
    """Resolve the n_neighbors knob to a compiled kernel choice.
    Returns K (int) for the neighbor-list path or None for dense."""
    if n_neighbors is None:
        return None
    if n_neighbors == 'auto':
        count_fn = _compiled_neighbor_count(n_atoms,
                                            min(atom_block, n_atoms))
        need = int(count_fn(xyz, rad))
    else:
        need = int(n_neighbors)
    k = max(8, -(-need // 8) * 8)   # round up to a multiple of 8
    if k >= n_atoms or k > 0.75 * n_atoms:
        return None                 # dense path is cheaper
    return k


def _sasa_device(xyz, radii, probe_radius, n_points, atom_block,
                 mesh=None, n_neighbors='auto'):
    rad = radii + probe_radius
    k = _pick_n_neighbors(xyz, rad, xyz.shape[1], atom_block,
                          n_neighbors)
    if k is not None:
        fn = _compiled_sasa_nl(xyz.shape[1], n_points,
                               min(atom_block, xyz.shape[1]), k)
    else:
        fn = _compiled_sasa(xyz.shape[1], n_points,
                            min(atom_block, xyz.shape[1]))
    if mesh is not None and mesh.size > 1:
        # frames are embarrassingly parallel: shard them over the mesh
        import jax
        import numpy as np_
        from ..parallel.mesh import FRAME_AXIS, P

        n = xyz.shape[0]
        pad = (-n) % mesh.size
        if pad:
            xyz = np_.concatenate(
                [xyz, np_.zeros((pad,) + xyz.shape[1:], xyz.dtype)])
        out = jax.jit(jax.shard_map(
            lambda x: fn(x, rad), mesh=mesh,
            in_specs=P(FRAME_AXIS), out_specs=P(FRAME_AXIS),
            check_vma=False))(xyz)
        return out[:n]
    return fn(xyz, rad)


def shrake_rupley_np(xyz, radii, probe_radius=0.14, n_sphere_points=960):
    """Host oracle for tests."""
    xyz = np.asarray(xyz, np.float64)
    radii = np.asarray(radii, np.float64) + probe_radius
    pts = sphere_points(n_sphere_points).astype(np.float64)
    F, A = xyz.shape[:2]
    out = np.zeros((F, A), dtype=np.float64)
    for f in range(F):
        for a in range(A):
            shell = xyz[f, a] + radii[a] * pts
            d2 = ((shell[:, None, :] - xyz[f][None, :, :]) ** 2).sum(-1)
            cover = d2 < radii[None, :] ** 2
            cover[:, a] = False
            acc = ~cover.any(axis=1)
            out[f, a] = acc.mean() * 4 * np.pi * radii[a] ** 2
    return out
