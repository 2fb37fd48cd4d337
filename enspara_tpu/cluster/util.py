"""Clustering utilities: results container, nearest-center assignment,
metric dispatch. (reference: enspara/cluster/util.py)
"""

import logging
import time
from collections import namedtuple

import numpy as np

from .. import ra
from ..exception import ImproperlyConfigured, DataInvalid
from ..ra.ra import partition_list, partition_indices
from ..geometry import libdist

logger = logging.getLogger(__name__)

__all__ = ['ClusterResult', 'assign_to_nearest_center',
           'find_cluster_centers', 'MolecularClusterMixin']


class ClusterResult(namedtuple('ClusterResult',
                               ['center_indices', 'distances',
                                'assignments', 'centers'])):
    """Clustering output: per-frame assignments/distances, the indices
    of frames chosen as centers, and the center data itself.
    (reference: cluster/util.py:105)"""

    def partition(self, lengths):
        """Split concatenated per-frame arrays back into per-trajectory
        rows; ndarray when lengths are uniform, RaggedArray otherwise.
        (reference: cluster/util.py:111)"""
        if len(set(int(n) for n in lengths)) <= 1:
            def chop(flat):
                return np.array(partition_list(flat, lengths))
        else:
            def chop(flat):
                return ra.RaggedArray(flat, lengths=lengths)
        return self._replace(
            assignments=chop(self.assignments),
            distances=chop(self.distances),
            center_indices=partition_indices(self.center_indices, lengths))


def run_timed(fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)``; return ``(result, wall_seconds)``."""
    tick = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - tick


def gather_frames(X, indices):
    """``[X[i] for i in indices]`` as host arrays with ONE
    device->host transfer when X is device-resident: a python loop of
    single-frame fetches costs one round trip per frame, k of them
    for k centers."""
    indices = np.asarray(indices, dtype=int)
    if hasattr(X, 'xyz'):
        X = X.xyz                      # Trajectory -> coordinate array
    try:
        import jax
        if isinstance(X, jax.Array):
            return list(np.asarray(X[jax.numpy.asarray(indices)]))
    except ImportError:
        pass
    return [np.asarray(X[i]) for i in indices]


def assign_to_nearest_center(trajectory, cluster_centers, distance_method):
    """Assign each frame to the nearest of ``cluster_centers`` under
    ``distance_method``, with the reference's semantics: iterate centers
    in order, strict-< updates (first-minimum tie-breaking).
    (reference: cluster/util.py:159)

    For the batched device form used in hot paths see
    :func:`enspara_tpu.cluster.engine.assign_device`.
    """
    n_frames = len(trajectory)
    best_dist = np.full(n_frames, np.inf, dtype=float)
    best_ctr = np.zeros(n_frames, dtype=int)

    # evaluate centers in blocks: one argmin per block instead of one
    # masked update per center, with first-minimum ties preserved both
    # within a block (np.argmin) and across blocks (strict <)
    block_len = 32
    for lo in range(0, len(cluster_centers), block_len):
        block = cluster_centers[lo:lo + block_len]
        dmat = np.stack(
            [np.asarray(distance_method(trajectory, ctr)).reshape(-1)
             for ctr in block])
        winner = dmat.argmin(axis=0)
        winning_dist = dmat[winner, np.arange(n_frames)]
        improved = winning_dist < best_dist
        best_dist[improved] = winning_dist[improved]
        best_ctr[improved] = winner[improved] + lo
    return best_ctr, best_dist


def find_cluster_centers(assignments, distances):
    """For each label, the index of its minimum-distance frame.
    (reference: cluster/util.py:208)"""
    if len(distances) != len(assignments):
        raise DataInvalid(
            'Length of distances (%s) must match length of assignments '
            '(%s).' % (len(distances), len(assignments)))
    labels = np.ravel(assignments)
    gaps = np.ravel(distances)
    # sort by (label, distance, frame index): the first row of each
    # label group is that cluster's minimum-distance frame, with the
    # frame-index key reproducing numpy argmin's first-hit tie-break
    order = np.lexsort((np.arange(labels.size), gaps, labels))
    ranked = labels[order]
    group_head = np.flatnonzero(
        np.r_[True, ranked[1:] != ranked[:-1]] if ranked.size else [])
    return order[group_head]


def _rmsd_metric(trajectory, center):
    """Callable metric adapter for coordinate data: minimum RMSD of each
    frame to one structure, via the QCP device kernel."""
    from ..ops import qcp
    xyz = trajectory.xyz if hasattr(trajectory, 'xyz') else trajectory
    cxyz = center.xyz if hasattr(center, 'xyz') else center
    cxyz = np.asarray(cxyz)
    if cxyz.ndim == 3:
        cxyz = cxyz[0]
    return np.asarray(qcp.rmsd(np.asarray(xyz), cxyz), dtype=np.float64)


def _get_distance_method(metric):
    """'rmsd' -> QCP kernel; named vector metrics -> libdist; callables
    pass through. (reference: cluster/util.py:289)"""
    if metric == 'rmsd':
        return _rmsd_metric
    if metric == 'euclidean':
        return libdist.euclidean
    if metric in ('cityblock', 'manhattan'):
        return libdist.manhattan
    if metric == 'hamming':
        return libdist.hamming
    if callable(metric):
        return metric
    raise ImproperlyConfigured(
        "Unknown metric %r: expected 'rmsd', 'euclidean', 'manhattan', "
        "'hamming', or a callable." % (metric,))


def _metric_name(metric):
    """The device-engine name for a metric, or None if only the generic
    host path applies (user callables)."""
    if metric in ('rmsd', 'euclidean', 'manhattan', 'cityblock',
                  'hamming'):
        return 'manhattan' if metric == 'cityblock' else metric
    if metric is libdist.euclidean:
        return 'euclidean'
    if metric is libdist.manhattan:
        return 'manhattan'
    if metric is libdist.hamming:
        return 'hamming'
    if metric is _rmsd_metric:
        return 'rmsd'
    return None


class MolecularClusterMixin:
    """predict() + result_ properties shared by the cluster estimators.
    (reference: cluster/util.py:46)"""

    def predict(self, X):
        try:
            centers = self.centers_
        except AttributeError:
            raise ImproperlyConfigured(
                'To predict the clustering result for new data, the '
                'clusterer first must have fit some data.') from None
        labels, gaps = assign_to_nearest_center(
            X, centers, _get_distance_method(self.metric))
        return ClusterResult(
            assignments=labels, distances=gaps,
            center_indices=find_cluster_centers(labels, gaps),
            centers=self.centers_)

    @property
    def labels_(self):
        return self.result_.assignments

    @property
    def distances_(self):
        return self.result_.distances

    @property
    def center_indices_(self):
        return self.result_.center_indices

    @property
    def centers_(self):
        return self.result_.centers


# ---------------------------------------------------------------------
# data loading front-ends and output writers (used by the CLI apps)
# (reference: cluster/util.py:324-740)
# ---------------------------------------------------------------------

import os
import pickle
import time

from ..util.load import load_as_concatenated, sound_trajectory
from ..util.log import timed
from ..util.parallel import auto_nprocs


def expand_files(pgroups):
    """Expand glob patterns in nested file-group lists, sorting each
    expansion (reference: cluster/util.py:315)."""
    from glob import glob

    expanded = []
    for pgroup in pgroups:
        expanded.append([])
        for p in pgroup:
            expanded[-1].extend(sorted(glob(p)))
    return expanded


def load_features(features, stride):
    """Load feature arrays: one .h5 RaggedArray file or many .npy files.
    (reference: cluster/util.py:324)"""
    if len(features) == 1:
        data = ra.load(features[0], stride=stride)
        if isinstance(data, ra.RaggedArray):
            return list(data.lengths), data._data
        return [len(data)], np.asarray(data)
    # mmap: a 20 GB file with --subsample 10 must not page fully
    # through RAM to keep 2 GB (r5 review; parallel/io.py's
    # loader already reads npy stripes this way)
    rows = [np.asarray(np.load(f, mmap_mode='r')[::stride])
            for f in features]
    inner = set(r.shape[1:] for r in rows)
    if len(inner) > 1:
        raise DataInvalid(
            'Feature files had inconsistent widths: %s' % inner)
    lengths = [len(r) for r in rows]
    return lengths, np.concatenate(rows).astype(np.float32)


def load_trajectories(topologies, trajectories, selections, stride,
                      processes=None):
    """Load trajectory sets (one topology + atom selection per set)
    into one concatenated coordinate array.
    (reference: cluster/util.py:350)"""
    from .. import io as io_mod

    flat_trjs = []
    configs = []
    n_inds = None
    top = None
    indices = None

    for topfile, trjset, selection in zip(topologies, trajectories,
                                          selections):
        top = io_mod.load(topfile).top
        try:
            indices = top.select(selection)
        except Exception:
            raise ImproperlyConfigured(
                "The provided selection '{s}' didn't match the topology "
                'file, {t}'.format(s=selection, t=topfile))
        if len(indices) == 0:
            raise ImproperlyConfigured(
                "Selection '%s' selected no atoms in %s"
                % (selection, topfile))
        if n_inds is not None and n_inds != len(indices):
            raise ImproperlyConfigured(
                'Selection on topology %s selected %s atoms, but other '
                'selections selected %s atoms.'
                % (topfile, len(indices), n_inds))
        n_inds = len(indices)
        for trj in trjset:
            flat_trjs.append(trj)
            configs.append({'top': top, 'stride': stride,
                            'atom_indices': indices})

    with timed('Loading took %.1f sec', logger.info):
        lengths, xyz = load_as_concatenated(
            flat_trjs, args=configs,
            processes=processes or auto_nprocs())

    return lengths, xyz, top.subset(indices)


def load_trjs_or_features(args):
    """Dispatch CLI args to feature or trajectory loading; returns
    (lengths, data) where data is an ndarray (features) or Trajectory.
    (reference: cluster/util.py:433)"""
    from .. import io as io_mod

    if getattr(args, 'features', None):
        lengths, data = load_features(args.features,
                                      stride=args.subsample)
    else:
        assert args.trajectories
        assert len(args.trajectories) == len(args.topologies)
        lengths, xyz, select_top = load_trajectories(
            args.topologies, args.trajectories, selections=args.atoms,
            stride=args.subsample, processes=auto_nprocs())
        data = io_mod.Trajectory(xyz, select_top)
    return lengths, data


def load_frames(filenames, indices, **kwargs):
    """Load specific (file_index, frame_index) frames.
    (reference: cluster/util.py:245)"""
    from .. import io as io_mod

    stride = kwargs.pop('stride', 1) or 1
    out = []
    for file_id, frame_id in indices:
        name, pos = filenames[file_id], frame_id * stride
        try:
            out.append(io_mod.load_frame(name, index=pos, **kwargs))
        except Exception as err:
            raise ImproperlyConfigured(
                'Failed to load frame %s of %s (%s).' % (pos, name, err))
    return out


def load_asymm_frames(center_indices, trajectories, topology, subsample):
    """(reference: cluster/util.py:409)"""
    import itertools
    from .. import io as io_mod

    frames = []
    begin_index = 0
    for topfile, trjset in zip(topology, trajectories):
        end_index = begin_index + len(trjset)
        target_centers = [c for c in center_indices
                          if begin_index <= c[0] < end_index]
        subframes = load_frames(
            list(itertools.chain(*trajectories)),
            target_centers,
            top=io_mod.load(topfile).top,
            stride=subsample)
        frames.extend(subframes)
        begin_index += len(trjset)
    return frames


def write_centers_indices(path, indices, intermediate_n=None):
    """(reference: cluster/util.py:464)"""
    if not path:
        logger.info('--center-indices not provided, not writing center '
                    'indices to file.')
        return
    if intermediate_n is not None:
        d = os.path.dirname(path)
        os.makedirs(os.path.join(d, 'intermediate-%s' % intermediate_n),
                    exist_ok=True)
        path = os.path.join(d, 'intermediate-%s' % intermediate_n,
                            os.path.basename(path))
    with open(path, 'wb') as f:
        np.save(f, indices)


def write_centers(result, args, intermediate_n=None):
    """(reference: cluster/util.py:481)"""
    if getattr(args, 'features', None):
        if intermediate_n is not None:
            d = os.path.dirname(args.center_features)
            os.makedirs(os.path.join(
                d, 'intermediate-%s' % intermediate_n), exist_ok=True)
            path = os.path.join(d, 'intermediate-%s' % intermediate_n,
                                os.path.basename(args.center_features))
            ra.save(path, np.asarray(result.centers))
        else:
            np.save(args.center_features, np.asarray(result.centers))
    else:
        outdir = os.path.dirname(args.center_features) or '.'
        if intermediate_n is not None:
            outdir = os.path.join(outdir,
                                  'intermediate-%s' % intermediate_n)
        os.makedirs(outdir, exist_ok=True)
        centers = load_asymm_frames(result.center_indices,
                                    args.trajectories, args.topologies,
                                    args.subsample)
        with open(args.center_features, 'wb') as f:
            pickle.dump(centers, f)


def write_assignments_and_distances_with_reassign(result, args,
                                                  intermediate_n=None):
    """(reference: cluster/util.py:511)"""
    def _save(path, arr):
        if intermediate_n is not None:
            d = os.path.dirname(path)
            os.makedirs(os.path.join(
                d, 'intermediate-%s' % intermediate_n), exist_ok=True)
            path = os.path.join(d, 'intermediate-%s' % intermediate_n,
                                os.path.basename(path))
        ra.save(path, arr)

    if args.subsample == 1:
        _save(args.distances, result.distances)
        _save(args.assignments, result.assignments)
    elif not args.no_reassign:
        if getattr(args, 'features', None):
            # feature runs: reload the FULL (unsubsampled) features and
            # batch-assign to the centers. (The reference reaches its
            # trajectory-only reassign() here and crashes on the None
            # topologies — r5 review.)
            lengths, data = load_features(args.features, stride=1)
            name = _metric_name(args.cluster_distance)
            if name is not None:
                from . import engine
                assig_flat, dist_flat = engine.assign_device(
                    data, np.asarray(result.centers), name)
            else:
                assig_flat, dist_flat = assign_to_nearest_center(
                    data, np.asarray(result.centers),
                    _get_distance_method(args.cluster_distance))
            assig = ra.RaggedArray(assig_flat, lengths=lengths)
            dist = ra.RaggedArray(dist_flat, lengths=lengths)
        else:
            assig, dist = reassign(
                args.topologies, args.trajectories, args.atoms,
                centers=result.centers)
        _save(args.distances, dist)
        _save(args.assignments, assig)
    else:
        logger.debug('Got --no-reassign, not doing reassigment')


def compute_batches(lengths, batch_size):
    """Greedily pack trajectory indices into batches whose summed
    frame counts stay under ``batch_size``.
    (reference: cluster/util.py:551)"""
    batches = [[]]
    room = batch_size
    for i, ln in enumerate(lengths):
        # <= (not <): a trajectory exactly filling the remaining room
        # belongs in the CURRENT batch — with strict <, a first
        # trajectory of exactly batch_size frames left an empty
        # leading batch that crashed the loader downstream
        if ln <= room:
            batches[-1].append(i)
            room -= ln
        else:
            batches.append([i])
            room = batch_size - ln
    # an oversized first trajectory (ln > batch_size) opens a new
    # batch immediately, stranding the initial empty list
    return [b for b in batches if b]


def determine_batch_size(n_atoms, dtype_bytes, frac_mem):
    """(reference: cluster/util.py:569). Batches are bounded by host
    RAM; the device round-trips stream through device memory in sub-batches."""
    import psutil

    floats_per_frame = n_atoms * 3
    bytes_per_frame = floats_per_frame * dtype_bytes
    bytes_total = psutil.virtual_memory().total
    batch_size = int(bytes_total * frac_mem / bytes_per_frame)
    return batch_size, batch_size * bytes_per_frame / 1024 ** 3


def batch_reassign(targets, centers, lengths, frac_mem, n_procs=None):
    """Reassign every frame of a big dataset to the nearest center,
    loading trajectories in RAM-bounded batches and assigning on the
    device mesh. (reference: cluster/util.py:582)"""
    from . import engine

    center_xyz = np.stack([
        (c.xyz[0] if hasattr(c, 'xyz') else np.asarray(c))
        for c in centers])
    n_atoms = center_xyz.shape[1]

    DTYPE_BYTES = 4
    batch_size, batch_gb = determine_batch_size(
        n_atoms, DTYPE_BYTES, frac_mem)
    if batch_size < max(lengths):
        raise ImproperlyConfigured(
            'Batch size of %s was smaller than largest file (size %s).'
            % (batch_size, max(lengths)))

    batches = compute_batches(lengths, batch_size)

    assignments = []
    distances = []
    for i, batch_indices in enumerate(batches):
        batch_targets = [targets[j] for j in batch_indices]
        batch_lengths, xyz = load_as_concatenated(
            [tfile for tfile, top, aids in batch_targets],
            lengths=[lengths[j] for j in batch_indices],
            args=[{'top': top, 'atom_indices': aids}
                  for t, top, aids in batch_targets],
            processes=n_procs)

        batch_assignments, batch_distances = engine.assign_device(
            xyz, center_xyz, metric='rmsd')
        del xyz

        assignments.extend(
            partition_list(batch_assignments, batch_lengths))
        distances.extend(
            partition_list(batch_distances, batch_lengths))

    return assignments, distances


def reassign(topologies, trajectories, atoms, centers, frac_mem=0.5):
    """Reassign full (unsubsampled) datasets to centers in batches.
    (reference: cluster/util.py:652)"""
    from .. import io as io_mod
    from concurrent.futures import ThreadPoolExecutor

    n_procs = auto_nprocs()

    if len(topologies) != len(trajectories):
        raise ImproperlyConfigured(
            "Number of topologies (%s) didn't match number of sets of "
            'trajectories (%s).' % (len(topologies), len(trajectories)))
    if len(topologies) != len(atoms):
        raise ImproperlyConfigured(
            "Number of topologies (%s) didn't match number of atom "
            'selection strings (%s).' % (len(topologies), len(atoms)))

    if hasattr(centers, 'xyz'):
        centers = [centers[i] for i in range(len(centers))]

    with timed('Reassignment took %.1f seconds.', logger.info):
        targets = []
        for topfile, trjfiles, atoms_i in zip(topologies, trajectories,
                                              atoms):
            t = io_mod.load(topfile).top
            atom_ids = t.select(atoms_i)
            for trjfile in trjfiles:
                assert os.path.exists(trjfile)
                targets.append((trjfile, t, atom_ids))

        with ThreadPoolExecutor(max_workers=n_procs) as ex:
            lengths = list(ex.map(
                lambda tgt: sound_trajectory(tgt[0]), targets))

        assignments, distances = batch_reassign(
            targets, centers, lengths, frac_mem=frac_mem,
            n_procs=n_procs)

    if all(len(assignments[0]) == len(a) for a in assignments):
        return np.array(assignments), np.array(distances)
    return ra.RaggedArray(assignments), ra.RaggedArray(distances)
