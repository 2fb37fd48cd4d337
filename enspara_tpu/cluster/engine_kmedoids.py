"""Fully-on-device k-medoids (PAM) sweeps.

The host path (cluster/kmedoids.py) dispatches ~3k device calls per
sweep; here the ENTIRE sweep — proposal sampling, distance kernel,
cost test, cache maintenance — is one jitted loop.

FastPAM-style second-nearest cache: alongside the nearest-medoid state
``(d1, a1)`` we carry the exact second-nearest ``(d2, a2)``. A
proposal replacing medoid ``cid`` with candidate ``c`` then costs ONE
distance column plus elementwise selects — for members of ``cid`` the
new nearest is ``min(d2, dnew)`` (their second-nearest is by
definition another medoid), for everyone else ``min(d1, dnew)``. The
reference's 'ambiguous subset' reassignment (kmedoids.py:637-670) and
its fixed-size bucket are needed only to REPAIR the cache on ACCEPTED
proposals: the points whose new second-nearest cannot be derived from
the cached pair (``a1==cid`` or ``a2==cid``, with ``dnew > d2``) are
gathered into a ``M = bucket_factor * n/k``-slot bucket and re-ranked
against all k medoids. When the true repair count fits the bucket
(tracked in ``overflow``), the update is exactly PAM; overflow cases
fall back to keeping the proposal rejected for safety.

Batched proposals (FastPAM2-flavored): proposals for ``batch``
consecutive medoids are sampled together from the batch-start
memberships, their distance columns computed as ONE ``(n, batch)``
pairwise block (the frame data is read once per batch instead of once
per proposal — the dominant cost at large n), and their post-swap
costs SCREENED for the whole batch in a few (batch, n) passes.
Proposals the batch-start screen already rules out are skipped with
two scalar reads; survivors are verified EXACTLY against the live
cache before committing, so every accepted swap is a true PAM
improving swap. Cache repairs are decoupled from accepts: an accept
only marks the points whose (d2, a2) became upper bounds as stale
(d1/a1 stay exact through the pure elementwise update), and the
bucketed k-way re-rank runs on demand — when a proposal's cluster
contains stale members (case B would inherit an inexact d2), when the
stale set would outgrow the bucket, and at batch end — amortizing one
repair over ~bucket_factor accepts. The only divergences from
one-at-a-time PAM are the proposal distribution (a candidate is a
uniform member of its cluster as of the batch start rather than the
instant of proposal) and the pruning of proposals the batch-start
screen rejected (skipping candidates never breaks PAM). Distances to
a candidate are static, so the precomputed columns stay exact
regardless of earlier accepts.

Randomness uses jax PRNG (uniform over the proposal cluster's members,
reproducing the reference's `_propose_new_center_amongst` semantics,
kmedoids.py:482) — deterministic for a given key and independent of
mesh shape (SURVEY.md 'hard parts').
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import engine

__all__ = ['kmedoids_sweeps_device']


@functools.partial(
    jax.jit, static_argnames=('metric', 'n_sweeps', 'bucket', 'batch'))
def _pam_sweeps(data, valid, d1, a1, medoid_inds, key, metric,
                n_sweeps, bucket, batch=64):
    n = data.shape[0]
    k = medoid_inds.shape[0]
    B = int(min(batch, k))
    n_batches = (k + B - 1) // B

    n_valid = jnp.sum(valid)

    def cost(d):
        return jnp.sum(jnp.where(valid, d * d, 0.0)) / n_valid

    # ---- build the exact second-nearest cache (d2, a2) from the
    # warm-start (d1, a1): chunked (n, C) pairwise blocks through the
    # fused matrix kernel (k/C launches instead of k), running min
    # over all medoids other than each point's own.
    C_CHUNK = int(min(64, k))
    n_chunks = (k + C_CHUNK - 1) // C_CHUNK
    pad_k = n_chunks * C_CHUNK - k
    minds_pad = jnp.pad(medoid_inds, (0, pad_k))

    def init_chunk(ci, st):
        d2x, a2x = st
        idx = jax.lax.dynamic_slice_in_dim(minds_pad, ci * C_CHUNK,
                                           C_CHUNK)
        D = engine._pairwise_block(data, data[idx], metric)  # (n, C)
        cids = ci * C_CHUNK + jnp.arange(C_CHUNK, dtype=jnp.int32)
        invalid_col = (cids[None, :] == a1[:, None]) \
            | (cids[None, :] >= k)
        D = jnp.where(invalid_col, jnp.inf, D)
        carg = jnp.argmin(D, axis=1)
        cmin = jnp.min(D, axis=1)
        better = (cmin < d2x) & valid
        return (jnp.where(better, cmin, d2x),
                jnp.where(better, cids[carg], a2x))

    d2, a2 = jax.lax.fori_loop(
        0, n_chunks, init_chunk,
        (jnp.full(n, jnp.inf, jnp.float32),
         jnp.full(n, -1, jnp.int32)))

    def _repair(op):
        """ONE k-way re-rank restores (d2, a2) exactness for every
        point whose cache went stale since the last repair. d1/a1 are
        exact throughout and are NOT touched (the re-rank would
        re-introduce matmul-form kernel noise). top_k on the mask is
        ~3x faster than jnp.nonzero(size=...) (no cumsum);
        tie-break is the lowest index, unused slots filtered by
        amb_real."""
        d1, a1, d2, a2, medoid_inds, stale = op
        amb_idx = jax.lax.top_k(stale.astype(jnp.float32),
                                bucket)[1].astype(jnp.int32)
        amb_real = stale[amb_idx]
        sub = data[amb_idx]                              # (bucket, ..)
        medoids = data[medoid_inds]
        d_amb = engine._pairwise_block(sub, medoids, metric)
        # self-distance clamp for bucketed medoid points
        d_amb = jnp.where(
            amb_idx[:, None] == medoid_inds[None, :], 0.0, d_amb)
        # second-nearest = min outside each point's own (exact)
        # nearest medoid
        hide = (jnp.arange(k)[None, :] == a1[amb_idx][:, None])
        d_amb2 = jnp.where(hide, jnp.inf, d_amb)
        b_a2 = jnp.argmin(d_amb2, axis=1).astype(jnp.int32)
        b_d2 = jnp.min(d_amb2, axis=1)

        d2r = d2.at[amb_idx].set(jnp.where(amb_real, b_d2,
                                           d2[amb_idx]))
        a2r = a2.at[amb_idx].set(jnp.where(amb_real, b_a2,
                                           a2[amb_idx]))
        return (d1, a1, d2r, a2r, medoid_inds,
                jnp.zeros_like(stale))

    def one_batch(bi, state):
        d1, a1, d2, a2, medoid_inds, rbits, cost_cur = state
        cids = (bi * B
                + jnp.arange(B, dtype=jnp.int32))    # some may be >= k

        # uniform member per cluster, all B clusters in one (B, n)
        # pass: the argmax of iid random priorities over each member
        # set is uniform on it. The random bits are drawn once per
        # sweep (threefry over 1M elements costs ~5 ms) and remixed
        # per cluster with a Weyl/murmur step; |1 keeps every member's
        # priority above the 0 sentinel. sampled_ok = the cluster
        # actually had members when sampled — a cluster empty at batch
        # start can GAIN members from an earlier in-batch accept, and
        # its sentinel argmax=0 must never be treated as a real
        # candidate (frame 0 may even be another cluster's medoid).
        member0 = (a1[None, :] == cids[:, None]) & valid[None, :]
        mixed = rbits[None, :] ^ (jnp.uint32(0x9E3779B9)
                                  * cids[:, None].astype(jnp.uint32))
        mixed = mixed * jnp.uint32(0x85EBCA6B)
        prio = jnp.where(member0, mixed | jnp.uint32(1), jnp.uint32(0))
        p_idxs = jnp.argmax(prio, axis=1).astype(jnp.int32)
        sampled_ok = jnp.max(prio, axis=1) > 0

        # ONE batched distance pass for the whole proposal block, then
        # ONE transpose to (B, n) so each proposal's distances are a
        # contiguous (1, n) row slice — slicing a column out of (n, B)
        # inside the proposal loop would touch every (8, 128) tile of
        # the block per proposal. Matmul-form metrics (euclidean, QCP)
        # carry ~1e-3 fp32 noise on self-distances; a candidate's
        # distance to itself is 0 by definition, and accepted medoids
        # must report d1 == 0.
        D = engine._pairwise_block(data, data[p_idxs], metric)  # (n, B)
        Dt = D.T
        Dt = Dt.at[jnp.arange(B), p_idxs].set(0.0)

        # batch-start screen: exact post-swap cost for ALL B proposals
        # in a few (B, n) passes. After in-batch accepts it becomes a
        # HEURISTIC pre-filter (clear losers at batch start are
        # skipped; survivors are verified exactly below).
        cand0 = jnp.where(member0,
                          jnp.minimum(d2[None, :], Dt),
                          jnp.minimum(d1[None, :], Dt))
        est0 = jnp.sum(jnp.where(valid[None, :], cand0 * cand0, 0.0),
                       axis=1) / n_valid

        def one_proposal(b, st):
            d1, a1, d2, a2, medoid_inds, cost_cur, stale = st
            cid = cids[b]
            p_idx = p_idxs[b]

            # cheap scalar pre-filter; cost_cur only decreases, so a
            # proposal whose batch-start exact cost already loses can
            # never win later in the batch... it CAN become improving
            # after memberships shift, but skipping proposals never
            # breaks PAM — it only prunes the candidate sequence
            trial = (est0[b] < cost_cur) & sampled_ok[b] & (cid < k)

            def do_try(op):
                d1, a1, d2, a2, medoid_inds, cost_cur, stale = op
                dnew = jax.lax.dynamic_slice_in_dim(Dt, b, 1,
                                                    axis=0)[0]
                members = (a1 == cid) & valid

                # repair ON DEMAND: a stale member's d2 would make the
                # post-swap d1 inexact (case B inherits d2), and an
                # over-budget stale set could not be repaired later —
                # in either case run the k-way re-rank NOW (restoring
                # exact d2/a2 for all stale points) and evaluate the
                # proposal against the repaired cache. Amortized cost:
                # the stale set grows by ~n/k per accept, so repairs
                # fire every ~bucket_factor accepts.
                unc_bound = ((members | (a2 == cid)) & (dnew > d2)
                             & valid)
                needs_repair = (jnp.any(members & stale)
                                | (jnp.sum(stale | unc_bound) > bucket))
                d1, a1, d2, a2, medoid_inds, stale = jax.lax.cond(
                    needs_repair, _repair, lambda o: o,
                    (d1, a1, d2, a2, medoid_inds, stale))

                # exact post-swap nearest distance straight from the
                # cache: members' second-nearest is by definition
                # another medoid; the same array doubles as the new d1
                # on commit
                cand_d1 = jnp.where(members, jnp.minimum(d2, dnew),
                                    jnp.minimum(d1, dnew))
                new_cost = cost(cand_d1)

                # points whose (d2, a2) can no longer be derived from
                # the cached pair: deferred to the next on-demand or
                # batch-end re-rank
                uncertain = ((members | (a2 == cid)) & (dnew > d2)
                             & valid)
                new_stale = stale | uncertain
                n_stale = jnp.sum(new_stale)

                good = (new_cost < cost_cur) & (n_stale <= bucket)

                def commit(op2):
                    d1, a1, d2, a2, medoid_inds, _, _ = op2
                    in1 = dnew < d1
                    in2 = dnew < d2
                    caseB = a1 == cid        # nearest displaced
                    caseC = a2 == cid        # second-nearest displaced
                    # new d1/a1 are exact in every case (case B's
                    # min(d2, dnew) relies on the unsafe gate above);
                    # new d2/a2 are exact unless flagged uncertain, in
                    # which case they are upper bounds until repair
                    na1 = jnp.where(
                        caseB, jnp.where(in2, cid, a2),
                        jnp.where(in1, cid, a1))
                    nd2 = jnp.where(
                        caseB, jnp.maximum(dnew, d2),
                        jnp.where(caseC, jnp.maximum(dnew, d1),
                                  jnp.where(in1, d1,
                                            jnp.where(in2, dnew, d2))))
                    na2 = jnp.where(
                        caseB, jnp.where(in2, a2, cid),
                        jnp.where(caseC, jnp.where(in1, a1, cid),
                                  jnp.where(in1, a1,
                                            jnp.where(in2, cid, a2))))
                    nd1 = jnp.where(valid, cand_d1, jnp.inf)
                    na1 = jnp.where(valid, na1, -1)
                    nd2 = jnp.where(valid, nd2, jnp.inf)
                    na2 = jnp.where(valid, na2, -1)
                    return (nd1, na1, nd2, na2,
                            medoid_inds.at[cid].set(p_idx), new_cost,
                            new_stale)

                # operand must be the POST-repair state: commit's
                # caseB/caseC/in2 and the reject fallback both read it,
                # and evaluating them against the pre-repair cache
                # would mix stale (d2, a2) into an accepted update
                return jax.lax.cond(
                    good, commit, lambda o: o,
                    (d1, a1, d2, a2, medoid_inds, cost_cur, stale))

            return jax.lax.cond(trial, do_try, lambda o: o, st)

        stale0 = jnp.zeros(n, bool)
        d1, a1, d2, a2, medoid_inds, cost_cur, stale = jax.lax.fori_loop(
            0, B, one_proposal,
            (d1, a1, d2, a2, medoid_inds, cost_cur, stale0))

        # ---- batch-end repair: clears leftover staleness so the next
        # batch's screen and samples start from an exact cache
        d1, a1, d2, a2, medoid_inds, _ = jax.lax.cond(
            jnp.any(stale), _repair, lambda op: op,
            (d1, a1, d2, a2, medoid_inds, stale))
        return (d1, a1, d2, a2, medoid_inds, rbits, cost_cur)

    def one_sweep(s, state):
        d1, a1, d2, a2, medoid_inds, cost_cur = state
        rbits = jax.random.bits(jax.random.fold_in(key, s), (n,),
                                jnp.uint32)
        d1, a1, d2, a2, medoid_inds, _, cost_cur = jax.lax.fori_loop(
            0, n_batches, one_batch,
            (d1, a1, d2, a2, medoid_inds, rbits, cost_cur))
        return (d1, a1, d2, a2, medoid_inds, cost_cur)

    d1, a1, d2, a2, medoid_inds, _ = jax.lax.fori_loop(
        0, n_sweeps, one_sweep,
        (d1, a1, d2, a2, medoid_inds, cost(d1)))
    return d1, a1, medoid_inds


def kmedoids_sweeps_device(X, metric, assignments, distances,
                           medoid_inds, n_sweeps=5, bucket_factor=8,
                           seed=0, mesh=None, proposal_batch=64):
    """Run ``n_sweeps`` device PAM sweeps from a warm start.

    Parameters
    ----------
    X : (n, d) features or (n, n_atoms, 3) coordinates.
    metric : 'rmsd' | 'euclidean' | 'manhattan' | 'hamming'.
    assignments, distances : warm-start state (e.g. from k-centers).
    medoid_inds : (k,) current medoid frame indices.
    bucket_factor : ambiguous-bucket size in units of n/k.
    seed : jax PRNG seed (deterministic for a given seed).
    proposal_batch : proposals evaluated per batched distance pass
        (the ``(n, batch)`` block is materialized: at 1M frames the
        default 64 costs 2.3 GB of device memory for rmsd).

    Returns ``(medoid_inds, distances, assignments)`` as numpy arrays.
    """
    from ..parallel import mesh as pmesh

    if mesh is None:
        mesh = pmesh.frame_mesh()
    n = len(X)
    k = len(medoid_inds)
    bucket = int(min(n, max(64, bucket_factor * ((n + k - 1) // k))))

    data_sh, _ = engine.prepare_sharded(X, metric, mesh)
    n_pad = data_sh.shape[0]

    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    d1 = np.full(n_pad, np.inf, np.float32)
    d1[:n] = distances
    a1 = np.full(n_pad, -1, np.int32)
    a1[:n] = assignments

    d1_sh, _ = pmesh.shard_frames(d1, mesh)
    a1_sh, _ = pmesh.shard_frames(a1, mesh)
    valid_sh, _ = pmesh.shard_frames(valid, mesh)

    d1_out, a1_out, m_out = _pam_sweeps(
        data_sh, valid_sh, d1_sh, a1_sh,
        jnp.asarray(np.asarray(medoid_inds, dtype=np.int32)),
        jax.random.PRNGKey(seed), metric, int(n_sweeps), bucket,
        batch=int(proposal_batch))

    return (np.asarray(m_out).astype(np.int64),
            np.asarray(d1_out)[:n].astype(np.float64),
            np.asarray(a1_out)[:n].astype(np.int64))
