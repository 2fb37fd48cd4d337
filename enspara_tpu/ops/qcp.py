"""Theobald QCP RMSD — the flagship device kernel of the framework.

The reference reaches minimum-RMSD through mdtraj's C/SSE Theobald code
(enspara/cluster/util.py:291 ``md.rmsd``); here it is rebuilt for the
device:

* the 3x3 inner-product matrices for all (frame, center) pairs come from
  one big matmul over the atom axis, at full fp32 precision,
* the quartic characteristic polynomial of the QCP 4x4 key matrix is
  solved for its largest root with a scaled Newton iteration,
* the k-centers iteration fuses both into one Triton kernel
  (:mod:`enspara_tpu.ops.kcenters_triton`) that reads each frame once.

Math follows Theobald (2005), Acta Cryst. A61 478-480 and Liu, Agrafiotis
& Theobald (2010), J. Comput. Chem. 31 1561-1563. RMSD is computed from
the largest eigenvalue lambda_max of the key matrix:
``rmsd = sqrt(max(0, ga + gb - 2*lambda_max) / n_atoms)``.

All computation is fp32; the Newton iteration runs on the
scaled variable ``u = lambda / lambda0`` with ``lambda0 = (ga+gb)/2`` so
every quantity stays O(1) regardless of structure size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..citation import cite

__all__ = [
    'center_coordinates', 'qcp_rmsd_matrix', 'qcp_rmsd_vector',
    'rmsd', 'prepare_structures', 'NEWTON_ITERS',
]

NEWTON_ITERS = 12


def center_coordinates(xyz):
    """Remove the centroid from each structure.

    Parameters
    ----------
    xyz : (..., n_atoms, 3)

    Returns
    -------
    centered : same shape
    g : (...,) sum of squared centered coordinates (the QCP 'G' inner
        product).
    """
    xyz = jnp.asarray(xyz, jnp.float32)
    mean = jnp.mean(xyz, axis=-2, keepdims=True)
    centered = xyz - mean
    g = jnp.sum(centered * centered, axis=(-2, -1))
    return centered, g


def _poly_coeffs_scaled(S, lam0):
    """Quartic coefficients of the QCP characteristic polynomial,
    scaled by lambda0 so the Newton variable is O(1).

    Parameters
    ----------
    S : (..., 3, 3) inner-product matrices sum_n A[n,i] * B[n,j]
    lam0 : (...,) initial eigenvalue guess (ga+gb)/2

    Returns
    -------
    (c2, c1, c0) : coefficients of u^4 + c2 u^2 + c1 u + c0
    """
    return _poly_coeffs_scaled_components(
        (S[..., 0, 0], S[..., 0, 1], S[..., 0, 2],
         S[..., 1, 0], S[..., 1, 1], S[..., 1, 2],
         S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]), lam0)


def _poly_coeffs_scaled_components(Sc, lam0):
    """Like :func:`_poly_coeffs_scaled` but takes the nine inner-product
    components as separate arrays, so callers keep S as nine dense
    arrays in whatever layout suits them (the frame-minor kernel holds
    nine per-frame register sums)."""
    (Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz) = Sc

    Sxx2, Sxy2, Sxz2 = Sxx * Sxx, Sxy * Sxy, Sxz * Sxz
    Syx2, Syy2, Syz2 = Syx * Syx, Syy * Syy, Syz * Syz
    Szx2, Szy2, Szz2 = Szx * Szx, Szy * Szy, Szz * Szz

    fnorm2 = (Sxx2 + Sxy2 + Sxz2 + Syx2 + Syy2 + Syz2
              + Szx2 + Szy2 + Szz2)
    det = (Sxx * (Syy * Szz - Syz * Szy)
           - Sxy * (Syx * Szz - Syz * Szx)
           + Sxz * (Syx * Szy - Syy * Szx))

    C2 = -2.0 * fnorm2
    C1 = -8.0 * det

    SxzpSzx = Sxz + Szx
    SxzmSzx = Sxz - Szx
    SyzpSzy = Syz + Szy
    SyzmSzy = Syz - Szy
    SxypSyx = Sxy + Syx
    SxymSyx = Sxy - Syx
    SxxpSyy = Sxx + Syy
    SxxmSyy = Sxx - Syy

    D = (Sxy2 + Sxz2 - Syx2 - Szx2)
    D = D * D
    E = ((-Sxx2 + Syy2 + Szz2 + Syz2 + Szy2)
         - 2.0 * (Syy * Szz - Syz * Szy)) \
        * ((-Sxx2 + Syy2 + Szz2 + Syz2 + Szy2)
           + 2.0 * (Syy * Szz - Syz * Szy))
    F = (-(SxzpSzx) * (SyzmSzy) + (SxymSyx) * (SxxmSyy - Szz)) \
        * (-(SxzmSzx) * (SyzpSzy) + (SxymSyx) * (SxxmSyy + Szz))
    G = (-(SxzpSzx) * (SyzpSzy) - (SxypSyx) * (SxxpSyy - Szz)) \
        * (-(SxzmSzx) * (SyzmSzy) - (SxypSyx) * (SxxpSyy + Szz))
    H = ((SxypSyx) * (SyzpSzy) + (SxzpSzx) * (SxxmSyy + Szz)) \
        * (-(SxymSyx) * (SyzmSzy) + (SxzpSzx) * (SxxpSyy + Szz))
    I = ((SxypSyx) * (SyzmSzy) + (SxzmSzx) * (SxxmSyy - Szz)) \
        * (-(SxymSyx) * (SyzpSzy) + (SxzmSzx) * (SxxpSyy - Szz))
    C0 = D + E + F + G + H + I

    # the clamp must keep inv**4 finite in fp32: 1e-30 overflowed
    # inv2*inv2 to inf and made 0 * inf = NaN distances on degenerate
    # (all-identical / single-atom) structures, where G = 0 exactly
    inv = 1.0 / jnp.maximum(lam0, 1e-9)
    inv2 = inv * inv
    return C2 * inv2, C1 * inv2 * inv, C0 * inv2 * inv2


def _newton_max_root(c2, c1, c0):
    """Largest real root of ``u^4 + c2 u^2 + c1 u + c0`` by Newton from
    u=1 (the value for identical structures). Monotone decreasing toward
    the root from above, so convergence is safe and quadratic."""
    u = jnp.ones_like(c2)

    def body(_, u):
        u2 = u * u
        p = u2 * u2 + c2 * u2 + c1 * u + c0
        dp = u * (4.0 * u2 + 2.0 * c2) + c1
        # where dp ~ 0 (perfect match at u=1), keep u unchanged
        step = p / jnp.where(jnp.abs(dp) < 1e-12, 1e-12, dp)
        step = jnp.clip(step, -0.5, 0.5)
        return u - step

    u = jax.lax.fori_loop(0, NEWTON_ITERS, body, u)
    return jnp.clip(u, 0.0, 1.0)


def _rmsd_from_S(S, ga, gb, n_atoms):
    """(..., 3, 3) inner products + G values -> (...,) RMSD."""
    lam0 = (ga + gb) * 0.5
    c2, c1, c0 = _poly_coeffs_scaled(S, lam0)
    u = _newton_max_root(c2, c1, c0)
    lam = u * lam0
    msd = jnp.maximum(ga + gb - 2.0 * lam, 0.0) / n_atoms
    return jnp.sqrt(msd)


def _newton_max_root_unrolled(c2, c1, c0):
    """Largest quartic root, Newton UNROLLED as straight-line code —
    the form Pallas kernel bodies use (same math as
    :func:`_newton_max_root`)."""
    u = jnp.ones_like(c2)
    for _ in range(NEWTON_ITERS):
        u2 = u * u
        p = u2 * u2 + c2 * u2 + c1 * u + c0
        dp = u * (4.0 * u2 + 2.0 * c2) + c1
        step = p / jnp.where(jnp.abs(dp) < 1e-12, 1e-12, dp)
        u = u - jnp.clip(step, -0.5, 0.5)
    return jnp.clip(u, 0.0, 1.0)


def rmsd_from_S_components_unrolled(Sc, gsum, n_atoms_real):
    """Shared epilogue of the fused k-centers iteration: nine
    inner-product components + G sums -> RMSD, with the Newton
    iteration unrolled. Pure jnp on arrays of any (matching) shape, so
    kernel bodies can trace through it."""
    lam0 = gsum * 0.5
    c2, c1, c0 = _poly_coeffs_scaled_components(Sc, lam0)
    u = _newton_max_root_unrolled(c2, c1, c0)
    return jnp.sqrt(jnp.maximum(gsum - 2.0 * u * lam0, 0.0)
                    / n_atoms_real)


def _rmsd_from_S_components(Sc, ga, gb, n_atoms):
    """Nine (...,) inner-product components + G values -> (...,) RMSD."""
    lam0 = (ga + gb) * 0.5
    c2, c1, c0 = _poly_coeffs_scaled_components(Sc, lam0)
    u = _newton_max_root(c2, c1, c0)
    lam = u * lam0
    msd = jnp.maximum(ga + gb - 2.0 * lam, 0.0) / n_atoms
    return jnp.sqrt(msd)


@functools.partial(jax.jit, static_argnames=('n_atoms',))
def qcp_rmsd_matrix(frames, centers, g_frames, g_centers, n_atoms=None):
    """All-pairs minimum RMSD between two sets of *pre-centered*
    structures.

    Parameters
    ----------
    frames : (F, N, 3) centered coordinates
    centers : (C, N, 3) centered coordinates
    g_frames : (F,) per-structure G (from :func:`center_coordinates`)
    g_centers : (C,)
    n_atoms : real atom count if N includes zero-padding rows (padding
        atoms at the origin contribute nothing to S or G, so only the
        divisor needs the true count).

    Returns
    -------
    (F, C) float32 RMSD matrix.
    """
    frames = jnp.asarray(frames, jnp.float32)
    centers = jnp.asarray(centers, jnp.float32)
    if n_atoms is None:
        n_atoms = frames.shape[-2]
    # S[i, j, f, c] = sum_n frames[f, n, i] * centers[c, n, j], with
    # the (i, j) axes leading so the nine components slice out as dense
    # (F, C) planes. HIGHEST keeps the product out of TF32.
    S = jnp.einsum('fni,cnj->ijfc', frames, centers,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    Sc = tuple(S[i, j] for i in range(3) for j in range(3))
    return _rmsd_from_S_components(Sc, g_frames[:, None],
                                   g_centers[None, :], float(n_atoms))


@functools.partial(jax.jit, static_argnames=('n_atoms',))
def qcp_rmsd_vector(frames, center, g_frames, g_center, n_atoms=None):
    """RMSD of every frame to one center — the k-centers inner loop.
    Bandwidth-bound: reads each frame once, one (F*3, N)x(N, 3) matvec."""
    frames = jnp.asarray(frames, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    if n_atoms is None:
        n_atoms = frames.shape[-2]
    # S laid out (3, 3, F), frame axis minormost, so the nine
    # components slice out as plain (F,) vectors.
    S = jnp.einsum('fni,nj->ijf', frames, center,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    Sc = tuple(S[i, j] for i in range(3) for j in range(3))
    return _rmsd_from_S_components(Sc, g_frames, g_center,
                                   float(n_atoms))


def prepare_structures(xyz, n_atoms_pad=None):
    """Center structures and optionally zero-pad the atom axis.

    Returns ``(centered_padded, g, n_real_atoms)``. Padding atoms sit at
    the origin, which is exact for QCP (zero contribution to S and G).
    """
    xyz = jnp.asarray(xyz, jnp.float32)
    n_real = xyz.shape[-2]
    centered, g = center_coordinates(xyz)
    if n_atoms_pad is not None and n_atoms_pad > n_real:
        pad = [(0, 0)] * (centered.ndim - 2) + \
            [(0, n_atoms_pad - n_real), (0, 0)]
        centered = jnp.pad(centered, pad)
    return centered, g, n_real


@cite('qcp')
def rmsd(target_xyz, reference_xyz, precentered=False):
    """mdtraj-style convenience: minimum RMSD of each frame in
    ``target_xyz`` (F, N, 3) to a single reference structure (N, 3)
    or each of (C, N, 3) references (returns (F,) or (F, C)).
    """
    target_xyz = jnp.asarray(target_xyz, jnp.float32)
    reference_xyz = jnp.asarray(reference_xyz, jnp.float32)
    if not precentered:
        target_xyz, g_t = center_coordinates(target_xyz)
        reference_xyz, g_r = center_coordinates(reference_xyz)
    else:
        g_t = jnp.sum(target_xyz ** 2, axis=(-2, -1))
        g_r = jnp.sum(reference_xyz ** 2, axis=(-2, -1))
    if reference_xyz.ndim == 2:
        return qcp_rmsd_vector(target_xyz, reference_xyz, g_t, g_r)
    return qcp_rmsd_matrix(target_xyz, reference_xyz, g_t, g_r)


def kabsch_rmsd_np(A, B):
    """Host oracle: minimum RMSD via Kabsch/SVD in float64. Used only in
    tests to validate the QCP kernel."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    A = A - A.mean(0)
    B = B - B.mean(0)
    H = A.T @ B
    U, s, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    s_corr = s.copy()
    s_corr[-1] *= d
    msd = (np.sum(A * A) + np.sum(B * B) - 2.0 * np.sum(s_corr)) / len(A)
    return np.sqrt(max(msd, 0.0))
