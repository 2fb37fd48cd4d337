"""Exposons: clusters of residues whose solvent exposure changes
cooperatively. (reference: enspara/info_theory/exposons.py)

Pipeline: atomic SASAs (device Shrake-Rupley kernel,
:mod:`enspara_tpu.geometry.sasa`) -> per-sidechain condensation ->
exposed/buried dichotomy -> weighted MI -> AffinityPropagation
(sklearn, fixed random_state=0 for determinism, matching the
publication's behavior).
"""

import logging

import numpy as np

from .. import exception
from ..citation import cite
from .mutual_info import weighted_mi

logger = logging.getLogger(__name__)

__all__ = ['exposons', 'exposons_from_sasas', 'condense_sidechain_sasas',
           'get_sidechain_atom_ids']


@cite('exposons')
def exposons(trj, damping, weights=None, probe_radius=0.28,
             threshold=0.02, mesh=None):
    """Compute exposons for a trajectory (enspara_tpu.io.Trajectory).
    (reference: exposons.py:16)

    Returns ``(sasa_mi, exposon_labels)``.
    """
    from ..geometry.sasa import shrake_rupley

    if weights is None:
        weights = np.full((len(trj),), 1 / len(trj))
    else:
        weights = np.array(weights) / sum(weights)

    sasas = shrake_rupley(trj, probe_radius=probe_radius, mode='atom',
                          mesh=mesh)
    sasas = condense_sidechain_sasas(sasas, trj.top)
    return exposons_from_sasas(sasas, damping, weights, threshold)


@cite('exposons')
def exposons_from_sasas(sasas, damping, weights, threshold):
    """Exposons from precomputed sidechain SASAs: dichotomize exposure
    at ``threshold``, take the frame-weighted MI between sidechains,
    and cluster the MI matrix. (capability match: exposons.py:86)"""
    exposure = np.asarray(sasas) > threshold
    mi_mtx = weighted_mi(exposure, weights)

    # clustering hyperparameters pinned to the publication: MI as a
    # precomputed affinity, preference 0, random_state 0 (sklearn's
    # behavior at publication time; also makes results deterministic)
    ap_params = dict(affinity='precomputed', damping=damping,
                     preference=0, random_state=0, max_iter=10000)
    from sklearn.cluster import AffinityPropagation

    labels = AffinityPropagation(**ap_params).fit_predict(mi_mtx)

    return mi_mtx, labels


_BACKBONE_NAMES = frozenset(
    ['N', 'C', 'CA', 'O', 'HA', 'H', 'H1', 'H2', 'H3', 'OXT',
     # C-terminal carboxylate synonyms: mdtraj's PDB loader renames
     # these to O/OXT before the reference's name-based selection
     # (exposons.py:154) ever sees them; our loader preserves source
     # names, so the exclusion must list them explicitly. Deliberate
     # divergence: for topologies whose loader does NOT rename (e.g.
     # GRO upstream), the reference counts these backbone carboxylate
     # oxygens as "sidechain" — a loader artifact, not chemistry — so
     # we exclude them uniformly across formats instead.
     'OC1', 'OC2', 'OT1', 'OT2'])


def get_sidechain_atom_ids(top):
    """Per-residue lists of sidechain atom ids (everything but the
    backbone names). (reference: exposons.py:135)"""
    sc_ids = []
    for res in top.residues:
        ids = np.array([a.index for a in res.atoms
                        if a.name not in _BACKBONE_NAMES], dtype=int)
        sc_ids.append(ids)
    return sc_ids


@cite('exposons')
def condense_sidechain_sasas(sasas, top):
    """Sum atomic SASAs into per-residue sidechain SASAs.
    (reference: exposons.py:179)"""
    if top.n_residues <= 1:
        raise exception.DataInvalid(
            'Topology must have more than one residue.')
    if top.n_atoms != sasas.shape[1]:
        raise exception.DataInvalid(
            'need one SASA column per topology atom (%d columns, %d '
            "atoms) -- were the SASAs computed with mode='atom' against "
            'this topology?' % (sasas.shape[1], top.n_atoms))

    sc_ids = get_sidechain_atom_ids(top)

    # per-residue column sums, in the reference's exact operation
    # order (fp32 sum over the residue's atom ids) — a dense
    # (atoms x residues) membership matmul is ~99.9% zeros and
    # multi-GB on large complexes (r5 review), and sparse/other
    # summation orders flip near-threshold exposures against the
    # reference oracle. Memory here is just the (frames, residues)
    # output.
    sasas32 = np.asarray(sasas, dtype='float32')
    out = np.zeros((sasas32.shape[0], len(sc_ids)), dtype='float32')
    for r, ids in enumerate(sc_ids):
        if ids.size == 0:
            logger.warning('Found 0 sidechain atoms for residue %s.', r)
            continue
        out[:, r] = sasas32[:, ids].sum(axis=1)
    return out
