"""K-centers (Gonzalez farthest-point) clustering.

(reference: enspara/cluster/kcenters.py). The hot path runs entirely on
the device mesh as one jitted while_loop (see
:mod:`enspara_tpu.cluster.engine`); user-supplied callable metrics fall
back to a host loop with the reference's exact semantics.
"""

import logging

import numpy as np

from ..citation import cite
from ..exception import ImproperlyConfigured
from . import util
from .util import run_timed
from . import engine

logger = logging.getLogger(__name__)

__all__ = ['KCenters', 'kcenters', 'kcenters_mpi']


class KCenters(util.MolecularClusterMixin):
    """Sklearn-style estimator for k-centers clustering.

    Parameters
    ----------
    metric : str or callable
        'rmsd', 'euclidean', 'manhattan', 'hamming', or a callable
        ``f(X, center) -> distances``.
    n_clusters : int, optional
    cluster_radius : float, optional
        Stop adding centers when the max frame-center distance falls to
        this value. At least one of n_clusters/cluster_radius required.
    random_first_center : bool
        Seed the search from a uniformly random frame instead of
        frame 0 (an extension — the reference declares but does not
        implement this flag, kcenters.py:193). ``random_state`` pins
        the draw.
    mesh : jax Mesh, optional
        Device mesh to shard frames over (default: all devices).
    precision : 'fp32' (default) or 'bf16'
        'bf16' stores frames as bfloat16 in the device loop
        (metric='rmsd' only): half the frame footprint, with distances
        rounded by up to 2^-8 of the structures' RMS extents — a knob
        with no reference equivalent (see
        engine.kcenters_device_fused).
    """

    def __init__(self, metric, n_clusters=None, cluster_radius=None,
                 random_first_center=False, random_state=None, mesh=None,
                 precision='fp32'):
        if n_clusters is None and cluster_radius is None:
            raise ImproperlyConfigured(
                'Either n_clusters or cluster_radius is required for '
                'KCenters clustering')
        self.metric = metric
        self.n_clusters = n_clusters
        self.cluster_radius = cluster_radius
        self.random_first_center = random_first_center
        self.random_state = random_state
        self.mesh = mesh
        self.precision = precision

    def fit(self, X, init_centers=None):
        conf = self.get_params()
        conf['distance_method'] = conf.pop('metric')
        conf['dist_cutoff'] = conf.pop('cluster_radius')
        self.result_, self.runtime_ = run_timed(
            kcenters, X, init_centers=init_centers, **conf)
        return self

    # sklearn-compatible params plumbing
    def get_params(self, deep=True):
        return {'metric': self.metric, 'n_clusters': self.n_clusters,
                'cluster_radius': self.cluster_radius,
                'random_first_center': self.random_first_center,
                'random_state': self.random_state, 'mesh': self.mesh,
                'precision': self.precision}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self


@cite('kcenters')
def kcenters(traj, distance_method, n_clusters=None, dist_cutoff=None,
             init_centers=None, random_first_center=False,
             random_state=None, mesh=None, precision='fp32'):
    """Functional k-centers (reference: cluster/kcenters.py:108).

    Returns a :class:`~enspara_tpu.cluster.util.ClusterResult` whose
    assignments/distances cover all frames and whose center_indices are
    concatenated frame positions.

    ``random_first_center=True`` seeds the search from a uniformly
    random frame instead of frame 0 (an extension — the reference
    declares but does not implement this flag, kcenters.py:193;
    ``random_state`` pins the draw). Gonzalez's 2-approximation bound
    holds for any seed frame, so results differ only in which
    equivalent covering is found.
    """
    if n_clusters is None and dist_cutoff is None:
        raise ImproperlyConfigured(
            "KCenters must specify 'n_clusters' or 'dist_cutoff'")

    metric_name = util._metric_name(distance_method)
    xyz = traj.xyz if hasattr(traj, 'xyz') else np.asarray(traj)

    if random_first_center:
        if init_centers is not None and len(init_centers):
            raise ImproperlyConfigured(
                "'random_first_center' and 'init_centers' both pick "
                'the starting center; pass one or the other')
        # accept the full sklearn-style random_state contract
        # (None/int/RandomState/Generator) like hybrid/kmedoids do —
        # default_rng alone rejects RandomState instances (ADVICE r4)
        if isinstance(random_state, np.random.RandomState):
            from ..util.rng import check_random_state
            first = int(check_random_state(random_state)
                        .randint(len(xyz)))
        else:
            rng = np.random.default_rng(random_state)
            first = int(rng.integers(len(xyz)))
        init_centers = [traj[first] if hasattr(traj, 'xyz')
                        else xyz[first]]

    if metric_name is not None:
        return _kcenters_fast(xyz, metric_name, n_clusters, dist_cutoff,
                              init_centers, mesh, precision=precision)
    if precision != 'fp32':
        raise ImproperlyConfigured(
            "precision='bf16' requires a built-in metric on the device "
            "path (callable metrics run on the host)")
    return _kcenters_host(traj, util._get_distance_method(distance_method),
                          n_clusters, dist_cutoff, init_centers)


def kcenters_mpi(traj, distance_method, **kwargs):
    """Name-compat with the reference's MPI entry point
    (cluster/kcenters.py:103). Here data parallelism comes from the
    device mesh rather than MPI ranks: pass ``mesh=`` to shard frames,
    or rely on the default mesh over all local devices."""
    kwargs.pop('mpi_mode', None)
    return kcenters(traj, distance_method, **kwargs)


def _kcenters_fast(X, metric, n_clusters, dist_cutoff, init_centers,
                   mesh, precision='fp32'):
    n_init = 0
    init_distances = init_assignments = init_ctr_inds = None
    init_center_data = []
    if init_centers is not None and len(init_centers):
        init_center_data = [np.asarray(
            c.xyz[0] if hasattr(c, 'xyz') else c) for c in init_centers]
        init_assignments, init_distances = engine.assign_device(
            X, np.stack(init_center_data), metric, mesh=mesh)
        n_init = len(init_center_data)
        # recover the init centers' frame indices the way the
        # reference does (kcenters.py:195-206): the min-distance frame
        # of each init cluster. An init center that owns NO frames
        # (duplicates, or centers dominated by others) cannot be
        # given a frame index — and letting it through leaves -1
        # sentinels in center_indices that silently corrupt
        # downstream partitioning/kmedoids — so it is rejected
        # loudly instead.
        init_ctr_inds = util.find_cluster_centers(
            init_assignments, init_distances)
        if len(init_ctr_inds) != n_init:
            owned = np.unique(np.asarray(init_assignments))
            missing = sorted(set(range(n_init)) - set(owned.tolist()))
            raise ImproperlyConfigured(
                'init_centers %s own no frames (duplicated centers, '
                'or centers dominated by another init center); '
                'remove them from the warm start' % missing)

    res = engine.kcenters_device(
        X, metric=metric, n_clusters=n_clusters, dist_cutoff=dist_cutoff,
        init_distances=init_distances, init_assignments=init_assignments,
        n_init_centers=n_init, init_center_indices=init_ctr_inds,
        mesh=mesh, precision=precision)

    ctr_inds = list(res.center_indices)
    if n_init:
        centers = list(init_center_data) + \
            util.gather_frames(X, ctr_inds[n_init:])
    else:
        centers = util.gather_frames(X, ctr_inds)
    logger.info('Terminated k-centers with n=%s and d=%0.6f',
                res.n_found, res.distances.max(initial=0.0))
    return util.ClusterResult(
        center_indices=ctr_inds,
        assignments=res.assignments,
        distances=res.distances,
        centers=centers)


def _kcenters_host(traj, distance_method, n_clusters, dist_cutoff,
                   init_centers):
    """Generic host loop for callable metrics — reference semantics
    (kcenters.py:217-231, :243-306)."""
    n_clusters = np.inf if n_clusters is None else n_clusters
    dist_cutoff = 0 if dist_cutoff is None else dist_cutoff

    if init_centers is None:
        ctr_inds = []
        centers = []
        assignments = np.full(len(traj), -1, dtype=int)
        distances = np.full(len(traj), np.inf, dtype=float)
    else:
        centers = [c for c in init_centers]
        assignments, distances = util.assign_to_nearest_center(
            traj, centers, distance_method)
        ctr_inds = list(util.find_cluster_centers(assignments, distances))
        if len(ctr_inds) != len(centers):
            # an init center owning no frames would make the grown
            # centers' labels (len(ctr_inds)-based) collide with
            # existing init labels — fail loudly instead
            owned = set(np.unique(assignments).tolist())
            missing = sorted(set(range(len(centers))) - owned)
            raise ImproperlyConfigured(
                'init_centers %s own no frames (duplicated centers, '
                'or centers dominated by another init center); '
                'remove them from the warm start' % missing)

    while (len(ctr_inds) < n_clusters) and (distances.max() > dist_cutoff):
        new_center_index = int(np.argmax(distances))
        ctr_inds.append(new_center_index)
        new_center = traj[new_center_index]
        dist = np.asarray(
            distance_method(traj, new_center)).reshape(-1)
        inds = dist < distances
        distances[inds] = dist[inds]
        assignments[inds] = len(ctr_inds) - 1
        centers.append(new_center)

    return util.ClusterResult(
        center_indices=ctr_inds,
        assignments=assignments,
        distances=distances,
        centers=centers)
