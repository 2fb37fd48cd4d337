"""K-hybrid clustering: k-centers seeding + k-medoids refinement.
(reference: enspara/cluster/hybrid.py)
"""

import logging

import numpy as np

from ..citation import cite
from ..exception import ImproperlyConfigured
from ..util.rng import check_random_state
from . import util
from .util import run_timed
from .kcenters import kcenters as _kcenters
from .kmedoids import _kmedoids_iterations

logger = logging.getLogger(__name__)

__all__ = ['KHybrid', 'hybrid']


class KHybrid(util.MolecularClusterMixin):
    """Sklearn-style estimator: k-centers to place centers, then
    ``kmedoids_updates`` PAM sweeps to refine them.
    (reference: hybrid.py:28)"""

    def __init__(self, metric, n_clusters=None, cluster_radius=None,
                 kmedoids_updates=5, random_first_center=False,
                 random_state=None, mesh=None):
        if n_clusters is None and cluster_radius is None:
            raise ImproperlyConfigured(
                'Either n_clusters or cluster_radius is required for '
                'KHybrid clustering')
        self.metric = metric
        self.n_clusters = n_clusters
        self.cluster_radius = cluster_radius
        self.kmedoids_updates = kmedoids_updates
        self.random_first_center = random_first_center
        self.random_state = random_state
        self.mesh = mesh

    def fit(self, X, init_centers=None):
        conf = dict(n_iters=self.kmedoids_updates,
                    n_clusters=self.n_clusters,
                    dist_cutoff=self.cluster_radius,
                    random_first_center=self.random_first_center,
                    random_state=self.random_state,
                    mesh=self.mesh)
        self.result_, self.runtime_ = run_timed(
            hybrid, X, self.metric, init_centers=init_centers, **conf)
        return self


@cite('khybrid')
def hybrid(X, distance_method, n_iters=5, n_clusters=None,
           dist_cutoff=None, random_first_center=False,
           init_centers=None, random_state=None, mesh=None):
    """(reference: hybrid.py:112)"""
    random_state = check_random_state(random_state)

    result = _kcenters(
        X, distance_method, n_clusters=n_clusters,
        dist_cutoff=dist_cutoff, init_centers=init_centers,
        random_first_center=random_first_center,
        # the seed must reach the first-center draw, or a pinned
        # random_state still yields a different clustering every run
        random_state=(random_state.randint(2 ** 31)
                      if random_first_center else None),
        mesh=mesh)

    if n_iters <= 0:
        return result

    metric = util._get_distance_method(distance_method)
    # the caller's mesh pin must reach the PAM stage too (r5 review:
    # the device sweeps fell back to a mesh over ALL devices)
    return _kmedoids_iterations(
        X, metric, n_iters,
        list(np.asarray(result.center_indices)),
        np.asarray(result.assignments),
        np.asarray(result.distances),
        random_state=random_state, mesh=mesh)


def hybrid_device(X, metric='rmsd', n_iters=5, n_clusters=None,
                  dist_cutoff=None, seed=0, bucket_factor=8,
                  mesh=None):
    """Fully-on-device k-hybrid: the k-centers while_loop seeds a
    device PAM sweep loop (engine_kmedoids) — zero per-proposal host
    dispatches. The scale path for khybrid on a device mesh.

    Returns a ClusterResult (centers gathered host-side at the end).
    """
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from . import engine
    from ..parallel import mesh as pmesh
    from .engine_kmedoids import kmedoids_sweeps_device

    # Resolve the mesh here and push the frames to the device ONCE:
    # both stages accept device-resident coordinates, so the frame set
    # crosses host->device a single time instead of once per stage
    # (at 1M x 64-atom frames that is 768 MB saved).
    if mesh is None:
        mesh = pmesh.frame_mesh()
    if not isinstance(X, jax.Array):
        Xp = engine._prepare_data(X, metric)
        if mesh.size == 1 or len(Xp) % mesh.size == 0:
            sh = NamedSharding(
                mesh, P(pmesh.FRAME_AXIS, *([None] * (Xp.ndim - 1))))
            X = jax.device_put(Xp, sh)
        else:
            # non-dividing frame counts keep the per-stage padding
            # logic; each stage pads/uploads for itself
            X = Xp

    res = engine.kcenters_device(
        X, metric=metric, n_clusters=n_clusters,
        dist_cutoff=dist_cutoff, mesh=mesh)

    m, d, a = kmedoids_sweeps_device(
        X, metric, res.assignments, res.distances,
        res.center_indices, n_sweeps=n_iters, seed=seed,
        bucket_factor=bucket_factor, mesh=mesh)

    centers = util.gather_frames(X, m)
    return util.ClusterResult(center_indices=list(m),
                              assignments=a, distances=d,
                              centers=centers)
