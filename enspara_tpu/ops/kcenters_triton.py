"""One k-centers iteration as a Pallas kernel for the GPU (Triton route).

Each iteration of the Gonzalez loop computes the RMSD of every frame to
the newly chosen center, lowers each frame's distance where the new
center is nearer, and finds the frame farthest from all centers so far.
The work per frame is nine multiply-adds per atom and a short Newton
solve: far below the card's arithmetic rate, so the loop is bound by
reading the frames (768 MB per iteration at 1M frames x 64 atoms in
fp32). The kernel reads them exactly once per iteration:

* frames are stored frame-minor, ``(3 * n_atoms, n)`` with row
  ``i * n_atoms + a`` holding coordinate ``i`` of atom ``a``, so each
  program loads contiguous runs of ``block`` frames per row;
* each program owns ``block`` frames, loops over the atoms with the nine
  inner-product sums in registers, then runs the QCP Newton epilogue
  (:func:`enspara_tpu.ops.qcp.rmsd_from_S_components_unrolled`) and the
  strict-< min update in place;
* it writes its block's (max, argmax) of the updated distances, so the
  next center is a tiny reduction over ``n / block`` values instead of
  another pass over the distance row.

Nine outputs per frame are a reduction, not a matrix product, so the
tensor cores have nothing to do here. Frames may be stored as bf16; they
are upcast on load and all arithmetic stays fp32.

Reference inner loop: enspara/cluster/kcenters.py:314-378 (md.rmsd plus
a host min update per center).
"""

import functools

import jax
import jax.numpy as jnp

from . import qcp

__all__ = ['kcenters_iteration_triton', 'BLOCK']

# frames per program: 8 per thread at 4 warps. Frame counts are padded
# to a multiple of it (the padding frames carry distance -inf).
BLOCK = 1024
NUM_WARPS = 4

_IMAX = jnp.iinfo(jnp.int32).max


def _kernel(c_ref, gc_ref, cid_ref, f_ref, g_ref, d_ref, a_ref,
            d_out, a_out, bmax_out, barg_out, *, n_atoms, block):
    """c_ref: (3 * n_atoms,) center coordinates, same row order as the
    frames; gc_ref/cid_ref: (1,) center G and center id; f_ref:
    (3 * n_atoms, n); g/d/a refs: (n,). d/a are aliased to d_out/a_out,
    and each program touches only its own ``block`` columns."""
    from jax.experimental import pallas as pl

    pid = pl.program_id(0)
    cols = pl.ds(pid * block, block)

    def atom(a, S):
        c = [c_ref[i * n_atoms + a] for i in range(3)]
        f = [f_ref[i * n_atoms + a, cols].astype(jnp.float32)
             for i in range(3)]
        # S[3 * i + j] = sum_a f[i, a] * c[j, a]
        return tuple(S[3 * i + j] + f[i] * c[j]
                     for i in range(3) for j in range(3))

    zero = jnp.zeros((block,), jnp.float32)
    Sc = jax.lax.fori_loop(0, n_atoms, atom, (zero,) * 9)

    gsum = g_ref[cols] + gc_ref[0]
    d_new = qcp.rmsd_from_S_components_unrolled(Sc, gsum,
                                                float(n_atoms))
    d_old = d_ref[cols]
    upd = d_new < d_old
    nd = jnp.where(upd, d_new, d_old)
    d_out[cols] = nd
    a_out[cols] = jnp.where(upd, cid_ref[0], a_ref[cols])

    # first index among the block's maxima: the same tie break as
    # np.argmax once the caller takes the smallest index across blocks
    m = jnp.max(nd)
    idx = pid * block + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    bmax_out[pid] = m
    barg_out[pid] = jnp.min(jnp.where(nd == m, idx, _IMAX))


@functools.partial(jax.jit, static_argnames=('n_atoms', 'interpret'))
def kcenters_iteration_triton(frames, g, dist, assig, center, g_center,
                              center_id, n_atoms, interpret=False):
    """One fused k-centers iteration.

    Parameters
    ----------
    frames : (3 * n_atoms, n) centered coordinates, fp32 or bf16, rows
        ``i * n_atoms + a``; ``n`` a multiple of :data:`BLOCK`.
    g : (n,) float32 per-frame G (sum of squared coordinates).
    dist : (n,) float32 current distances (-inf on padding frames).
    assig : (n,) int32 current assignments.
    center : (3 * n_atoms,) float32 the new center, same row order.
    g_center : () float32 the center's G.
    center_id : () int32 the id given to frames the center claims.
    interpret : run the kernel in the Pallas interpreter (CPU tests).

    Returns ``(dist, assig, block_max, block_argmax)``; the last two are
    ``(n // BLOCK,)`` and hold each block's largest updated distance and
    the global index of its first occurrence.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = frames.shape[1]
    if n % BLOCK:
        raise ValueError('frame count %d is not a multiple of %d'
                         % (n, BLOCK))
    n_blocks = n // BLOCK
    kernel = functools.partial(_kernel, n_atoms=n_atoms, block=BLOCK)
    return pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n_blocks,), jnp.float32),
            jax.ShapeDtypeStruct((n_blocks,), jnp.int32),
        ],
        input_output_aliases={5: 0, 6: 1},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name='kcenters_iteration',
    )(center.astype(jnp.float32),
      jnp.reshape(g_center, (1,)).astype(jnp.float32),
      jnp.reshape(center_id, (1,)).astype(jnp.int32),
      frames, g, dist, assig)
