"""Transition counting, eigenspectra, ergodic trimming.
(reference: enspara/msm/transition_matrices.py)

Counting semantics match the reference exactly: unassigned (-1) frames
are stripped per trajectory *before* pairing, so transitions skip over
gaps; sliding-window or strided pairing at the lag time; accumulation
into a scipy COO counts matrix (container-polymorphic downstream).

The device-side masked-pair counting for sharded data lives in
:func:`assigns_to_counts_device` — padding and trajectory boundaries are
handled by masks so counts never cross rows (SURVEY.md §5 long-context
note).
"""

import csv
import functools
import numbers

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
from scipy.sparse.csgraph import (breadth_first_order,
                                  connected_components)

from .. import exception
from ..ra import RaggedArray

__all__ = ['TrimMapping', 'assigns_to_counts', 'eigenspectrum',
           'trim_disconnected', 'eq_probs', 'assigns_to_counts_device',
           'assigns_to_counts_sharded']


class TrimMapping:
    """Bijection between pre- and post-ergodic-trimming state ids, with
    CSV round-trip. (reference: transition_matrices.py:26)"""

    __slots__ = ['to_original']

    def __init__(self, transformations=None):
        self.to_original = {}
        if transformations:
            self.to_original = {t: o for o, t in transformations}

    @classmethod
    def load(cls, filename):
        with open(filename, 'r') as f:
            return cls.read(f)

    @classmethod
    def read(cls, file):
        rows = list(csv.reader(file))
        assert rows and rows[0] == ['original', 'mapped']
        pairs = []
        for lineno, row in enumerate(rows[1:], start=2):
            if not row or all(not cell.strip() for cell in row):
                continue    # blank line
            if len(row) != 2:
                raise exception.DataInvalid(
                    'TrimMapping CSV line %d has %d columns (expected '
                    '2): %r' % (lineno, len(row), row))
            try:
                pairs.append((int(row[0]), int(row[1])))
            except ValueError:
                raise exception.DataInvalid(
                    'TrimMapping CSV line %d has non-integer state '
                    'ids: %r' % (lineno, row))
        return TrimMapping(pairs)

    @property
    def to_mapped(self):
        return {v: k for k, v in self.to_original.items()}

    @to_mapped.setter
    def to_mapped(self, value):
        self.to_original = {v: k for k, v in value.items()}

    def save(self, filename):
        with open(filename, 'w') as f:
            self.write(f)

    def write(self, file):
        writer = csv.writer(file)
        writer.writerow(['original', 'mapped'])
        writer.writerows(sorted(self.to_mapped.items(),
                                key=lambda x: x[0]))

    def __eq__(self, other):
        if self is other:
            return True
        if hasattr(other, 'to_original'):
            return self.to_original == other.to_original
        try:
            return TrimMapping(other) == self
        except Exception:
            return False

    def __repr__(self):
        return 'to_original:' + str(self.to_original)

    __str__ = __repr__


def _transitions_helper(assigns_1d, lag_time=1, sliding_window=True):
    """(start, end) state pairs of one gap-compacted trajectory.
    (reference: transition_matrices.py:310)"""
    seq = np.asarray(assigns_1d)
    stride = 1 if sliding_window else lag_time
    origins = seq[:max(len(seq) - lag_time, 0):stride]
    landings = seq[lag_time::stride]
    return np.stack((origins, landings))


def assigns_to_counts(assigns, lag_time, max_n_states=None,
                      sliding_window=True):
    """Count transitions between states. (reference:
    transition_matrices.py:113)

    Parameters
    ----------
    assigns : 2-D array or RaggedArray, rows = trajectories; -1 marks
        unassigned frames (dropped before pairing).
    lag_time : int, observation interval.
    max_n_states : int, optional matrix dimension override.
    sliding_window : bool, every frame (True) or every lag_time'th.

    Returns
    -------
    C : scipy.sparse.coo_matrix, shape=(n_states, n_states)
    """
    if not isinstance(lag_time, numbers.Integral):
        raise exception.DataInvalid(
            'The lag time must be an integer. Got %s type %s.'
            % (lag_time, type(lag_time)))
    if lag_time < 1:
        raise exception.DataInvalid(
            "Lag times must be be strictly greater than 0. Got '%s'."
            % lag_time)

    if isinstance(assigns, RaggedArray):
        rows = [assigns[i] for i in range(len(assigns))]
    else:
        assigns = np.asarray(assigns)
        if assigns.ndim == 1:
            raise exception.DataInvalid(
                'The given assignments array has 1-dimensional shape %s. '
                'Two dimensional shapes = (n_trj, n_frames) are expected. '
                'If this is really what you want, try using '
                'assignments.reshape(1, -1) to create a single-row 2d '
                'array.' % (assigns.shape,))
        rows = list(assigns)

    rows = [np.asarray(a)[np.asarray(a) != -1] for a in rows]

    if max_n_states is None:
        max_n_states = int(max(
            (a.max() for a in rows if len(a)), default=-1)) + 1

    transitions = [
        _transitions_helper(a, lag_time=lag_time,
                            sliding_window=sliding_window)
        for a in rows if len(a) > lag_time]
    if transitions:
        mat_coords = np.hstack(transitions)
    else:
        mat_coords = np.zeros((2, 0), dtype=int)
    mat_data = np.ones(mat_coords.shape[1], dtype=int)
    return scipy.sparse.coo_matrix(
        (mat_data, mat_coords), shape=(max_n_states, max_n_states))


_COUNTS_MATMUL_BLOCK = 2048


def _counts_matmul(start, end, valid, n_states):
    """Transition counts as blocked one-hot matmuls:
    ``C = sum_blocks onehot(start_blk)^T @ onehot(end_blk)``.

    One-hot entries are 0/1 (exact in bf16) and the product accumulates
    in fp32, so counts are exact up to 2^24 per cell. Invalid pairs are
    encoded as state ``n_states`` whose one-hot row is all zero — no
    separate mask multiply needed.

    The default is ``jnp.bincount``: this formulation pays an
    (n_states, n_states) fp32 accumulator read+write per 2048-pair
    block (65 GB of carry traffic at 4096 states and 1M pairs). Kept
    as an explicitly requested path (``use_matmul=True``); not measured
    on a GPU.
    """
    import jax
    import jax.numpy as jnp

    B = _COUNTS_MATMUL_BLOCK
    s = jnp.where(valid, start, n_states).reshape(-1)
    e = end.reshape(-1)
    pad = (-s.shape[0]) % B
    if pad:
        s = jnp.concatenate([s, jnp.full((pad,), n_states, s.dtype)])
        e = jnp.concatenate([e, jnp.zeros((pad,), e.dtype)])
    states = jnp.arange(n_states, dtype=jnp.int32)

    def body(acc, blk):
        sb, eb = blk
        os_ = (sb[:, None] == states[None, :]).astype(jnp.bfloat16)
        oe = (eb[:, None] == states[None, :]).astype(jnp.bfloat16)
        return acc + jnp.dot(os_.T, oe,
                             preferred_element_type=jnp.float32), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((n_states, n_states), jnp.float32),
        (s.reshape(-1, B), e.reshape(-1, B)))
    return acc.astype(jnp.int32)


def assigns_to_counts_device(assigns_padded, mask, lag_time, n_states,
                             sliding_window=True, use_matmul=None):
    """Masked transition counting on device for padded (n_traj, max_len)
    assignment blocks: counts pairs (a[t], a[t+lag]) where both ends are
    valid and assigned, never crossing row boundaries or padding.

    Note: on gapped (-1-containing) data this differs from the host
    :func:`assigns_to_counts`, which compacts gaps before pairing; on
    gap-free data they agree exactly.

    ``use_matmul=True`` forces the one-hot matmul formulation (see
    :func:`_counts_matmul`); it exists as an ablation/testing knob.

    Returns a dense (n_states, n_states) int32 device array.
    """
    import jax.numpy as jnp

    if not isinstance(lag_time, numbers.Integral) or lag_time < 1:
        raise exception.DataInvalid(
            'lag_time must be a positive integer; got %r' % (lag_time,))
    if isinstance(assigns_padded, np.ndarray) \
            and isinstance(mask, np.ndarray) and assigns_padded.size:
        # the host coo path raises on out-of-range states; the device
        # bincount would silently DROP them — validate host inputs up
        # front (device-resident inputs are the caller's contract).
        # Only MASKED-IN cells count: sentinel values under mask=False
        # are legal padding (r5 review)
        masked_max = int(np.max(assigns_padded, initial=-1,
                                where=mask.astype(bool)))
        if masked_max >= n_states:
            raise exception.DataInvalid(
                'assignment id %d >= n_states=%d'
                % (masked_max, n_states))
    a = jnp.asarray(assigns_padded, jnp.int32)
    m = jnp.asarray(mask, bool)
    start = a[:, :-lag_time]
    end = a[:, lag_time:]
    valid = (m[:, :-lag_time] & m[:, lag_time:]
             & (start >= 0) & (end >= 0))
    if not sliding_window:
        stride_mask = jnp.zeros_like(valid)
        stride_mask = stride_mask.at[:, ::lag_time].set(True)
        valid = valid & stride_mask
    if use_matmul:
        return _counts_matmul(start, end, valid, n_states)
    flat_idx = jnp.where(valid, start * n_states + end, n_states ** 2)
    counts = jnp.bincount(flat_idx.reshape(-1),
                          length=n_states ** 2 + 1)[:-1]
    return counts.reshape(n_states, n_states)


def assigns_to_counts_sharded(assigns_padded, mask, lag_time, n_states,
                              sliding_window=True, mesh=None):
    """Transition counting with trajectories sharded over the device
    mesh: each shard counts its local rows, a psum over the mesh
    produces the replicated global count matrix. Lag pairs never cross
    trajectory rows, so trajectory-axis sharding needs no halo
    (SURVEY.md §5: masked lag-counting on sharded sequence data).
    """
    import jax.numpy as jnp
    from ..parallel import mesh as pmesh

    if mesh is None:
        mesh = pmesh.frame_mesh()
    a = np.asarray(assigns_padded)
    m = np.asarray(mask, dtype=bool)
    if a.size:
        # inside shard_map the operands are traced, so the device
        # variant's host validation never fires — run it here on the
        # numpy inputs (r5 review: out-of-range ids were silently
        # dropped from the sharded counts)
        if not isinstance(lag_time, (int, np.integer)) or lag_time < 1:
            raise exception.DataInvalid(
                'lag_time must be a positive integer; got %r'
                % (lag_time,))
        masked_max = int(np.max(a, initial=-1, where=m))
        if masked_max >= n_states:
            raise exception.DataInvalid(
                'assignment id %d >= n_states=%d'
                % (masked_max, n_states))
    n_traj = a.shape[0]
    pad = (-n_traj) % mesh.size
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                        a.dtype)])
        m = np.concatenate([m, np.zeros((pad,) + m.shape[1:], bool)])

    # PRESHARD the inputs onto the mesh before entering jit: arrays
    # committed to one device force the compiled program to open with
    # an implicit reshard, which XLA:CPU compiles pathologically
    # (measured at 262k frames x 8 virtual devices: 206 s compile /
    # 0.46 s per call with committed inputs vs 1.97 s / 0.031 s
    # presharded — the round-2 northstar-mesh "961.9 s counting"
    # artifact was exactly this)
    import jax
    from jax.sharding import NamedSharding

    from ..parallel.mesh import FRAME_AXIS, P

    sharding = NamedSharding(mesh, P(FRAME_AXIS))
    a_d = jax.device_put(np.ascontiguousarray(a, np.int32), sharding)
    m_d = jax.device_put(np.ascontiguousarray(m), sharding)
    fn = _counts_sharded_fn(mesh, int(lag_time), int(n_states),
                            bool(sliding_window))
    return fn(a_d, m_d)


@functools.lru_cache(maxsize=32)
def _counts_sharded_fn(mesh, lag_time, n_states, sliding_window):
    """Cached jitted shard_map for sharded counting: a fresh closure
    per call would re-trace and re-enter the compile cache on EVERY
    lag of a timescale scan (same executable-reuse rationale as
    ops/sparse.py:_scatter_fn). jax.sharding.Mesh is hashable, so it
    keys the cache directly; bounded so long-lived processes scanning
    many (lag, k) combinations don't pin executables forever."""
    import jax
    from ..parallel.mesh import FRAME_AXIS, P

    def body(a_l, m_l):
        c = assigns_to_counts_device(
            a_l, m_l, lag_time, n_states,
            sliding_window=sliding_window)
        return jax.lax.psum(c, FRAME_AXIS)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
        out_specs=P(), check_vma=False))


def eigenspectrum(T, n_eigs=None, left=True, maxiter=100000, tol=1E-30):
    """Top eigenvalues/vectors of a transition matrix, sorted by
    descending real part; the first eigenvector is normalized to sum 1
    (equilibrium populations when left=True).
    (reference: transition_matrices.py:173)
    """
    dim = T.shape[0]
    if n_eigs is None:
        k = dim
    else:
        if n_eigs < 2:
            raise ValueError('n_eig must be greater than or equal to 2')
        k = n_eigs

    # left spectra of T are right spectra of T^T
    A = T.transpose() if left else T

    if scipy.sparse.issparse(A):
        if dim < 1000 or k >= dim - 1:
            # ARPACK can't return near-full spectra (it requires
            # k < dim-1, so the n_eigs=None default would always
            # crash the sparse branch); densify instead
            w, phi = scipy.linalg.eig(A.toarray().astype(float))
        else:
            w, phi = scipy.sparse.linalg.eigs(
                A.tocsr().asfptype(), k, which='LR',
                maxiter=maxiter, tol=tol)
    else:
        w, phi = scipy.linalg.eig(np.asarray(A, dtype=float))

    rank = np.argsort(-w.real)
    w, phi = w[rank], phi[:, rank]

    # leading eigenvector scaled to unit mass (= equilibrium populations
    # when left=True)
    phi[:, 0] = phi[:, 0] / phi[:, 0].sum()

    return w.real[:k], phi.real[:, :k]


def trim_disconnected(counts, threshold=1, renumber_states=True):
    """Keep only the maximum-population strongly-connected component of
    the thresholded counts graph. (reference:
    transition_matrices.py:236)

    Returns (TrimMapping, trimmed_counts) with trimmed_counts recast to
    the input container type.
    """
    out_type = type(counts)
    if scipy.sparse.issparse(counts):
        counts = counts.toarray()
    counts = np.asarray(counts)

    thresholded = np.array(counts, copy=True)
    thresholded[counts < threshold] = 0

    n_subgraphs, labels = connected_components(
        thresholded, connection='strong', directed=True)

    pops = counts.sum(axis=1)
    subgraph_pops = [np.sum(pops[labels == i]) for i in range(n_subgraphs)]
    maxpop_subgraph = np.argmax(subgraph_pops)
    keep_states = np.where(labels == maxpop_subgraph)[0]

    if renumber_states:
        trimmed_counts = counts[np.ix_(keep_states, keep_states)].copy()
        mapping = TrimMapping(zip(keep_states, range(len(trimmed_counts))))
    else:
        trim_states = np.where(labels != maxpop_subgraph)
        trimmed_counts = np.array(counts, copy=True)
        trimmed_counts[trim_states, :] = 0
        trimmed_counts[:, trim_states] = 0
        mapping = TrimMapping(zip(keep_states, keep_states))

    if out_type is not np.ndarray and out_type is not type(trimmed_counts):
        try:
            trimmed_counts = out_type(trimmed_counts)
        except TypeError:
            pass

    return mapping, trimmed_counts


def _eq_probs_detailed_balance(T, rel_tol=1e-10):
    """O(nnz) stationary distribution for a reversible chain, or None.

    If T is row-stochastic and satisfies detailed balance w.r.t. some
    pi, then along any edge with T_ij > 0 and T_ji > 0,
    ``log pi_j - log pi_i = log T_ij - log T_ji``. Propagating those
    increments over a BFS spanning tree of the symmetric-support graph
    determines log-pi up to the normalization constant — no eigensolve.
    The candidate is then *certified* on every stored entry
    (max |pi_i T_ij - pi_j T_ji| <= rel_tol * max |pi_i T_ij|) and on
    row-stochasticity; any violation returns None so the caller falls
    back to the eigensolver. Builders that symmetrize counts
    (transpose, Prinz MLE) produce exact detailed balance, so their
    chains always take this path.
    """
    S = scipy.sparse.csr_matrix(T, dtype=np.float64)
    n = S.shape[0]
    if n == 0 or S.shape[0] != S.shape[1]:
        return None
    rows = np.asarray(S.sum(axis=1)).ravel()
    if not np.all(np.isfinite(rows)) or np.abs(rows - 1.0).max() > 1e-8:
        return None
    if S.nnz == 0 or (S.data < 0).any():
        return None

    # spanning tree over edges present in BOTH directions
    support = (S != 0)
    sym = support.multiply(support.T).tocsr()
    n_comp, _ = connected_components(sym, directed=False)
    if n_comp != 1:
        return None
    order, pred = breadth_first_order(
        sym, 0, directed=False, return_predecessors=True)
    if order.shape[0] != n:
        return None

    # log-space walk: children appear after their predecessor in BFS
    # order, so one pass assigns every node
    children = order[1:]
    parents = pred[children]
    with np.errstate(divide='ignore'):
        fwd = np.log(np.asarray(
            S[parents, children]).ravel())          # T[parent, child]
        bwd = np.log(np.asarray(
            S[children, parents]).ravel())          # T[child, parent]
    delta = fwd - bwd
    log_pi = np.zeros(n)
    for c, p, d in zip(children, parents, delta):
        log_pi[c] = log_pi[p] + d
    log_pi -= log_pi.max()
    pi = np.exp(log_pi)
    pi /= pi.sum()

    # certify detailed balance on EVERY stored entry, not just the tree
    F = S.multiply(pi[:, None]).tocoo()             # flux pi_i T_ij
    asym = np.abs((F - F.T).tocoo().data)
    bound = rel_tol * F.data.max()
    if asym.size and asym.max() > bound:
        return None
    return pi


def eq_probs(T, maxiter=100000, tol=1E-30):
    """Equilibrium populations: the top left eigenvector, normalized.
    (reference: transition_matrices.py:304)

    Reversible chains (builders.transpose / builders.mle output) skip
    the eigensolver entirely: detailed balance determines pi along a
    spanning tree in O(nnz), certified on every entry — the ARPACK
    left-eigenvector solve only runs for non-reversible input.
    """
    pi = _eq_probs_detailed_balance(T)
    if pi is not None:
        return pi
    val, vec = eigenspectrum(T, n_eigs=3, left=True, maxiter=maxiter,
                             tol=tol)
    return vec[:, 0]
