"""Pair-EM kernel for NVIDIA GPUs (Pallas, Triton route).

Fuses the whole two-locus haplotype EM of ops.em.pair_em into one kernel.
The XLA formulation runs a while_loop over the full (P, I, 3) batch: every
iteration re-reads both GL blocks from device memory (~1.6 flop/B, far
below the card's ridge) and the batch iterates until its SLOWEST pair has
converged. Here each program owns a power-of-two block of pairs:

  * the EM iterations run inside the program; the state f (4 x BP), the
    active set and n_iter stay in registers;
  * the program exits as soon as ITS pairs have converged (or ITER_MAX);
  * cohorts of any size loop over individual chunks of BI inside each
    iteration. A cohort that fits one chunk loads its GL rows ONCE, before
    the loop, and iterates on registers; larger cohorts re-read chunks
    that a block's neighbours keep warm in L1/L2.

Semantics are those of ops.em.pair_em, op for op in the update: NaN-
ignoring eps fold, per-pair freeze at max |df| < EPSILON, ITER_MAX cap,
n_used == 0 pairs frozen at n_iter 0 with NaN frequencies, optional `live`
mask (dead pairs keep f0 and n_iter == ITER_MAX). Only the order of the
sum over individuals differs (chunked), so values agree to rounding.

The EM has no matrix product (elementwise work plus reductions over
individuals), so the tensor cores buy nothing and Triton is the cheapest
route that expresses it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import EPSILON, ITER_MAX

# (k -> site-1 allele bit, site-2 allele bit); k = 2*a1 + a2 (ops/em.py)
_KBITS = ((0, 0), (0, 1), (1, 0), (1, 1))


def block_shape(n_ind: int, itemsize: int) -> tuple[int, int, int]:
    """(pairs per program, individuals per chunk, warps).

    Few pairs per program: a program iterates until its SLOWEST pair has
    converged, so small blocks waste the fewest updates on the heavy tail
    of iteration counts. On an H100 at 512k pairs and I = 100 (or 2,000)
    a 512-value tile on 2 warps was fastest in f32 and a 256-value tile on
    4 warps in f64 (PERF.md)."""
    bi = min(128, max(16, pl.next_power_of_2(n_ind)))
    tile, warps = (512, 2) if itemsize <= 4 else (256, 4)
    return max(1, tile // bi), bi, warps


def _miss(g):
    """miss_mask (ops/preprocess.py) on a GL triplet of tiles."""
    return ((jnp.abs(g[0] - g[1]) < EPSILON)
            & (jnp.abs(g[1] - g[2]) < EPSILON))


def _em_kernel(g1_ref, g2_ref, m1_ref, m2_ref, live_ref,
               f0_ref, f1_ref, f2_ref, f3_ref, nit_ref, nu_ref, *,
               n_pairs: int, n_ind: int, bp: int, bi: int,
               ignore_miss: bool):
    dt = f0_ref.dtype
    p0 = pl.program_id(0) * bp
    psl = pl.ds(p0, bp)
    pok = (p0 + jnp.arange(bp)) < n_pairs
    m1 = plgpu.load(m1_ref.at[psl], mask=pok, other=0.5)
    m2 = plgpu.load(m2_ref.at[psl], mask=pok, other=0.5)
    live = plgpu.load(live_ref.at[psl], mask=pok, other=0) != 0
    n_chunks = -(-n_ind // bi)

    def load(c):
        """GL tiles and the include mask of individual chunk c; padding
        lanes read the uniform record (s > 0, include 0 -> r == 0)."""
        i0 = c * bi
        cok = pok[:, None] & ((i0 + jnp.arange(bi)) < n_ind)[None, :]
        isl = pl.ds(i0, bi)
        g1 = [plgpu.load(g1_ref.at[psl, isl, k], mask=cok, other=1.0 / 3)
              for k in range(3)]
        g2 = [plgpu.load(g2_ref.at[psl, isl, k], mask=cok, other=1.0 / 3)
              for k in range(3)]
        inc = cok
        if ignore_miss:
            inc = inc & ~(_miss(g1) | _miss(g2))
        return g1, g2, inc.astype(dt)

    def sums(f, g1, g2, inc):
        """sum_i D_k[i] / s[i] over included individuals (ops.em._em_update
        op order)."""
        D = []
        for (a1k, a2k) in _KBITS:
            d = None
            for (a, b) in _KBITS:
                t = f[2 * a + b][:, None] * g1[a1k + a] * g2[a2k + b]
                d = t if d is None else d + t
            D.append(d)
        s = None
        for k in range(4):
            t = f[k][:, None] * D[k]
            s = t if s is None else s + t
        r = inc / s
        return [jnp.sum(D[k] * r, axis=1) for k in range(4)]

    if n_chunks == 1:
        g1, g2, inc = load(0)
        n_used = jnp.sum(inc, axis=1)

        def em_sums(f):
            return sums(f, g1, g2, inc)
    else:
        if ignore_miss:
            n_used = lax.fori_loop(
                0, n_chunks, lambda c, a: a + jnp.sum(load(c)[2], axis=1),
                jnp.zeros(bp, dt))
        else:
            n_used = jnp.full(bp, n_ind, dt)

        def em_sums(f):
            def body(c, acc):
                part = sums(f, *load(c))
                return tuple(a + p for a, p in zip(acc, part))
            zero = jnp.zeros(bp, dt)
            return list(lax.fori_loop(0, n_chunks, body, (zero,) * 4))

    # x == 0 (all individuals excluded): inv_x = inf, the update goes NaN
    # and the NaN-ignoring eps fold freezes the pair at n_iter 0 — the
    # reference's behaviour (strict.pair_em_batch)
    inv_x = 1.0 / n_used
    f0 = ((1 - m1) * (1 - m2), (1 - m1) * m2, m1 * (1 - m2), m1 * m2)

    def cond(carry):
        it, _, active, _ = carry
        return (it < ITER_MAX) & (jnp.sum(active.astype(jnp.int32)) > 0)

    def body(carry):
        it, f, active, n_iter = carry
        S = em_sums(f)
        f_new = [f[k] * S[k] * inv_x for k in range(4)]
        tot = ((f_new[0] + f_new[1]) + f_new[2]) + f_new[3]
        f_next = tuple(jnp.where(active, f_new[k] / tot, f[k])
                       for k in range(4))
        eps = jnp.zeros(bp, dt)
        for k in range(4):
            d = jnp.abs(f_next[k] - f[k])
            eps = jnp.where(d > eps, d, eps)   # NaN-ignoring fold
        newly = active & (eps < EPSILON)
        n_iter = jnp.where(newly, it, n_iter)
        return it + 1, f_next, active & ~newly, n_iter

    carry = (jnp.int32(0), f0, live & pok,
             jnp.full(bp, ITER_MAX, jnp.int32))
    _, f, _, n_iter = lax.while_loop(cond, body, carry)
    for k, ref in enumerate((f0_ref, f1_ref, f2_ref, f3_ref)):
        plgpu.store(ref.at[psl], f[k], mask=pok)
    plgpu.store(nit_ref.at[psl], n_iter, mask=pok)
    plgpu.store(nu_ref.at[psl], n_used.astype(jnp.int32), mask=pok)


@functools.partial(jax.jit, static_argnames=(
    "ignore_miss_data", "block_pairs", "block_ind", "num_warps",
    "interpret"))
def pair_em_gpu(gl1, gl2, maf1, maf2, ignore_miss_data: bool, live=None, *,
                block_pairs: int | None = None, block_ind: int | None = None,
                num_warps: int | None = None, interpret: bool = False):
    """Drop-in for ops.em.pair_em: gl (P, I, 3) normal-space GLs ->
    (f (P, 4), n_iter (P,) int32, n_used (P,) int32), in gl1's dtype.

    block_pairs / block_ind / num_warps override block_shape()."""
    P, I, _ = gl1.shape
    dt = gl1.dtype
    bp, bi, nw = block_shape(I, jnp.dtype(dt).itemsize)
    bp, bi, nw = block_pairs or bp, block_ind or bi, num_warps or nw
    live = (jnp.ones(P, jnp.int32) if live is None
            else live.astype(jnp.int32))
    kernel = functools.partial(_em_kernel, n_pairs=P, n_ind=I, bp=bp,
                               bi=bi, ignore_miss=ignore_miss_data)
    *f, n_iter, n_used = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(P, bp),),
        out_shape=(*[jax.ShapeDtypeStruct((P,), dt)] * 4,
                   jax.ShapeDtypeStruct((P,), jnp.int32),
                   jax.ShapeDtypeStruct((P,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=nw, num_stages=1),
        interpret=interpret,
        name="pair_em_gpu",
    )(gl1, gl2, maf1.astype(dt), maf2.astype(dt), live)
    return jnp.stack(f, axis=1), n_iter, n_used
