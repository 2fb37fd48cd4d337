"""Rotamer-state featurization with hysteresis ("buffered transition")
assignment. (reference: enspara/geometry/rotamer.py)

The sequential per-frame state carry (rotamer.py:84-93) becomes a single
``lax.associative_scan`` over basin transition maps, vectorized
across ALL dihedrals at once —
replacing the reference's per-dihedral Python loop (the CARDS
featurization hot path, SURVEY.md §3.5).
"""

import numpy as np

from ..exception import DataInvalid
from . import dihedrals as dih

__all__ = ['dihedral_angles', 'all_rotamers', 'phi_rotamers',
           'psi_rotamers', 'chi_rotamers', '_rotamers',
           'rotamers_device', 'get_gates', 'is_buffered_transition']


_DIHEDRAL_KINDS = ('phi', 'psi', 'chi1', 'chi2', 'chi3', 'chi4')


def dihedral_angles(traj, dihedral_type):
    """Angles in degrees spanning [0, 360). (reference: rotamer.py:6)"""
    if dihedral_type not in _DIHEDRAL_KINDS:
        return None, None
    atom_inds, rad = getattr(dih, 'compute_' + dihedral_type)(traj)
    deg = np.remainder(
        np.rad2deg(np.asarray(rad, dtype=np.float64)), 360.0)
    # cap just below the seam so np.digitize never lands on 360
    return np.minimum(deg, 359.5), atom_inds


def _validate_basins(hard_boundaries, buffer_width):
    n_basins = len(hard_boundaries) - 1
    if not 0 <= buffer_width < 360.0 / n_basins:
        raise DataInvalid(
            'Buffer width must sit in [0, 360/n_basins) degrees; got %s.'
            % buffer_width)
    if (hard_boundaries[0], hard_boundaries[-1]) != (0, 360):
        raise DataInvalid(
            'hard_boundaries must run from 0 to 360; got %s.'
            % (hard_boundaries,))
    return n_basins


def _rotamers(angles, hard_boundaries, buffer_width=15):
    """Hysteresis state assignment for one dihedral's time series
    (host reference path; reference: rotamer.py:28)."""
    _validate_basins(hard_boundaries, buffer_width)

    bounds = np.asarray(hard_boundaries, dtype=float)
    out = np.empty(len(angles), dtype='int16')
    state = np.digitize(angles[0], bounds) - 1
    for t, theta in enumerate(angles):
        if t and _is_buffered_transition(state, theta, hard_boundaries,
                                         buffer_width):
            state = np.digitize(theta, bounds) - 1
        out[t] = state
    return out


def _gates(cur_state, hard_boundaries, buffer_width):
    """(reference: rotamer.py:162 get_gates)"""
    s = int(cur_state)
    below, above = hard_boundaries[s], hard_boundaries[s + 1]
    # a basin touching the 0/360 seam gates on the far side of it
    below = below if below else 360
    above = 0 if above == 360 else above
    return below - buffer_width, above + buffer_width


def _is_buffered_transition(cur_state, new_angle, hard_boundaries,
                            buffer_width):
    """(reference: rotamer.py:98)"""
    lower, upper = _gates(cur_state, hard_boundaries, buffer_width)
    if upper < lower:
        return upper <= new_angle <= lower
    if upper > lower:
        return not (lower <= new_angle <= upper)
    return False


def get_gates(cur_state, hard_boundaries, buffer_width):
    """Gate angles a dihedral must exit to leave its buffered basin —
    public name-compat with the reference (rotamer.py:163). Returns
    ``(lower_bound, upper_bound)``; a wrap-around basin has
    ``upper < lower``."""
    return _gates(cur_state, hard_boundaries, buffer_width)


def is_buffered_transition(cur_state, new_angle, hard_boundaries,
                           buffer_width):
    """Whether moving to ``new_angle`` is a real (buffer-crossing)
    transition out of basin ``cur_state`` — public name-compat with
    the reference (rotamer.py:98)."""
    return _is_buffered_transition(cur_state, new_angle,
                                   hard_boundaries, buffer_width)


def rotamers_device(angles, hard_boundaries, buffer_width=15,
                    chunk=1 << 18):
    """Hysteresis assignment of MANY dihedrals at once on device.

    The hysteresis recurrence has a tiny state space (2-3 basins), so
    each frame's update is a FUNCTION over basins — and function
    composition is associative. Instead of a sequential ``lax.scan``
    over frames (a dependent step per frame), we build the per-frame
    transition maps ``m_t[s]`` vectorized and combine them with
    ``lax.associative_scan`` (O(log T) passes of a tiny gather) —
    ~400x faster at 200k frames. Frames are processed in ``chunk``
    blocks with the final state carried, bounding the scan workspace.

    Parameters
    ----------
    angles : (n_frames, n_dihedrals) degrees in [0, 360)
    hard_boundaries : basin boundary list shared by all dihedrals
        (e.g. [0, 120, 240, 360]).

    Returns (n_frames, n_dihedrals) int16 states; bit-identical to the
    host ``_rotamers`` per column.
    """
    import jax
    import jax.numpy as jnp

    n_basins = _validate_basins(hard_boundaries, buffer_width)

    angles = np.asarray(angles) if not hasattr(angles, 'devices') \
        else angles
    bounds = jnp.asarray(hard_boundaries, jnp.float32)
    T = angles.shape[0]

    lower_tab = bounds[:-1]
    upper_tab = bounds[1:]
    lower_tab = jnp.where(lower_tab == 0, 360.0, lower_tab) - buffer_width
    upper_tab = jnp.where(upper_tab == 360, 0.0, upper_tab) + buffer_width

    @jax.jit
    def digitize(a):
        # state = #boundaries at or below (np.digitize semantics),
        # minus the leading 0 boundary
        return (jnp.sum(a[..., None] >= bounds[None, :], axis=-1) - 1) \
            .clip(0, n_basins - 1).astype(jnp.int32)

    @jax.jit
    def chunk_states(carry_state, ac):
        """carry_state: (F,) int32 state before this chunk;
        ac: (t, F) angles. Returns (new_carry, (t, F) states).

        The basin axis S leads (S, t, F): with S minormost the arrays
        would tile-pad 3 -> 128 lanes (42x traffic on every scan
        level). Composition is a select chain over the S planes —
        pure elementwise work on dense (t, F) tiles.
        """
        ac = jnp.asarray(ac, jnp.float32)
        a3 = ac[None, :, :]                          # (1, t, F)
        lower = lower_tab[:, None, None]             # (S, 1, 1)
        upper = upper_tab[:, None, None]
        wrap = upper < lower
        trans = jnp.where(
            wrap,
            (a3 >= upper) & (a3 <= lower),
            (upper > lower) & ~((a3 >= lower) & (a3 <= upper)))
        dig = digitize(ac)                           # (t, F)
        s_iota = jnp.arange(n_basins,
                            dtype=jnp.int32)[:, None, None]
        maps = jnp.where(trans, dig[None], s_iota)   # (S, t, F)

        def apply_map(g, f):
            """out[...] = g[f[...]] — select chain over the S planes
            of g; f may be (S, t, F) or (t, F)."""
            out = jnp.broadcast_to(g[n_basins - 1], f.shape)
            for s in reversed(range(n_basins - 1)):
                out = jnp.where(f == s, jnp.broadcast_to(g[s], f.shape),
                                out)
            return out

        def compose(f, g):
            # apply f (earlier) then g (later), elementwise in t/F
            return apply_map(g, f)

        cum = jax.lax.associative_scan(compose, maps, axis=1)
        states = apply_map(
            cum, jnp.broadcast_to(carry_state[None, :],
                                  ac.shape).astype(jnp.int32))
        return states[-1], states

    first = digitize(jnp.asarray(angles[0], jnp.float32))
    out = [np.asarray(first, dtype=np.int16)[None]]
    carry = first
    for start in range(1, T, chunk):
        carry, states = chunk_states(carry, angles[start:start + chunk])
        out.append(np.asarray(states, dtype=np.int16))
    return np.concatenate(out, axis=0)


def _rotamer_block(angles, hard_boundaries, buffer_width, use_device):
    if use_device and angles.shape[0] * max(angles.shape[1], 1) > 5000:
        return rotamers_device(angles, hard_boundaries,
                               buffer_width).astype('int16')
    out = np.zeros(angles.shape, dtype='int16')
    for i in range(angles.shape[1]):
        out[:, i] = _rotamers(angles[:, i], hard_boundaries,
                              buffer_width)
    return out


def _rotamer_family(traj, kinds, hard_boundaries, buffer_width,
                    use_device, shift=0.0):
    """Featurize one dihedral family: concatenate the angle blocks of
    ``kinds``, optionally rotate by ``shift`` degrees (so the family's
    basin boundaries land on the 0/360 seam), and hysteresis-assign."""
    blocks = [dihedral_angles(traj, kind) for kind in kinds]
    angles = np.concatenate([a for a, _ in blocks], axis=1)
    atom_inds = np.concatenate([ai for _, ai in blocks], axis=0)
    if shift:
        angles = np.remainder(angles - shift, 360.0)
    states = _rotamer_block(angles, hard_boundaries, buffer_width,
                            use_device)
    n_states = np.full(angles.shape[1], len(hard_boundaries) - 1,
                       dtype='int16')
    return states, atom_inds, n_states


def phi_rotamers(traj, buffer_width=15, use_device=True):
    """(reference: rotamer.py:222)"""
    return _rotamer_family(traj, ('phi',), [0, 180, 360],
                           buffer_width, use_device)


def psi_rotamers(traj, buffer_width=15, use_device=True):
    """psi angles shifted by -100 degrees so the basin boundaries land
    on 0/360. (reference: rotamer.py:236)"""
    return _rotamer_family(traj, ('psi',), [0, 160, 360],
                           buffer_width, use_device, shift=100.0)


def chi_rotamers(traj, buffer_width=15, use_device=True):
    """chi1-chi4 concatenated, 3 basins each. (reference:
    rotamer.py:255)"""
    return _rotamer_family(traj, ('chi1', 'chi2', 'chi3', 'chi4'),
                           [0, 120, 240, 360], buffer_width, use_device)


def all_rotamers(traj, buffer_width=15, use_device=True):
    """All phi/psi/chi rotamer state assignments:
    ``(states (n_frames, n_dihedrals) int16, atom_inds (n_dihedrals, 4),
    n_states (n_dihedrals,))``. (reference: rotamer.py:276)"""
    parts = [family(traj, buffer_width, use_device)
             for family in (phi_rotamers, psi_rotamers, chi_rotamers)]
    states = np.concatenate([p[0] for p in parts], axis=1)
    inds = np.concatenate([p[1] for p in parts], axis=0)
    ns = np.concatenate([p[2] for p in parts], axis=0)
    assert issubclass(states.dtype.type, np.integer)
    assert issubclass(ns.dtype.type, np.integer)
    return states, inds, ns
