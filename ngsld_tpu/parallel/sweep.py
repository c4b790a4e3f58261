"""Sharded LD sweep step: the multi-chip pair-EM + statistics pipeline.

shard_map over a ('pairs', 'ind') mesh:
  * pair blocks are split across 'pairs' (pure data parallelism — the
    reference's thread pool, ngsLD.cpp:159-186, mapped to devices);
  * the individual axis is split across 'ind'; every per-individual
    reduction in the EM (denominator counts, numerator sums, Pearson
    moments) becomes a psum across devices.

The EM state f is replicated along 'ind' (each shard applies the identical
update after the psum), so convergence decisions agree bitwise across
shards and no further synchronization is needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..constants import EPSILON, ITER_MAX
from ..ops.preprocess import miss_mask
from ..ops.stats import chi2_stat, ld_stats

_KBITS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _pair_em_shard(gl1, gl2, f0, include, n_used, live=None):
    """Per-shard EM body: local individuals, psum('ind') reductions.
    live: optional initial active set (see ops.em.pair_em) — dead lanes
    freeze at f0/ITER_MAX; every 'ind' shard receives the same mask so
    the collective loop stays in lockstep."""
    dt = gl1.dtype
    Ploc = gl1.shape[0]
    incf = include.astype(dt)
    inv_x = 1.0 / n_used.astype(dt)

    def cond(carry):
        it, f, active, n_iter = carry
        return (it < ITER_MAX) & jnp.any(active)

    def body(carry):
        it, f, active, n_iter = carry
        fk = [f[:, k] for k in range(4)]
        Q = [[fk[2 * a][:, None] * gl2[:, :, c] + fk[2 * a + 1][:, None] * gl2[:, :, c + 1]
              for c in range(2)] for a in range(2)]
        D = [gl1[:, :, a1k] * Q[0][a2k] + gl1[:, :, a1k + 1] * Q[1][a2k]
             for (a1k, a2k) in _KBITS]
        s = fk[0][:, None] * D[0]
        for k in range(1, 4):
            s = s + fk[k][:, None] * D[k]
        r = incf / s
        # per-individual contributions are local; the sum over the cohort
        # spans the 'ind' mesh axis
        S = jnp.stack([jnp.sum(D[k] * r, axis=1) for k in range(4)], axis=1)
        S = jax.lax.psum(S, "ind")
        f_new = f * S * inv_x[:, None]
        f_new = f_new / jnp.sum(f_new, axis=1, keepdims=True)
        f_next = jnp.where(active[:, None], f_new, f)
        diffs = jnp.abs(f_next - f)
        eps = jnp.zeros(Ploc, dt)
        for k in range(4):
            eps = jnp.where(diffs[:, k] > eps, diffs[:, k], eps)
        newly = active & (eps < EPSILON)
        n_iter = jnp.where(newly, it, n_iter)
        return it + 1, f_next, active & ~newly, n_iter

    act0 = jnp.ones(Ploc, bool) if live is None else live
    carry = (jnp.int32(0), f0, act0,
             jnp.full(Ploc, ITER_MAX, jnp.int32))
    _, f, _, n_iter = jax.lax.while_loop(cond, body, carry)
    return f, n_iter


def _pearson_shard(x, y, n_tot):
    """Pearson r^2 with the individual axis sharded: two-pass moments via
    psum('ind')."""
    n = n_tot.astype(x.dtype)
    mx = jax.lax.psum(jnp.sum(x, axis=1), "ind") / n
    my = jax.lax.psum(jnp.sum(y, axis=1), "ind") / n
    xc = x - mx[:, None]
    yc = y - my[:, None]
    sxy = jax.lax.psum(jnp.sum(xc * yc, axis=1), "ind")
    sxx = jax.lax.psum(jnp.sum(xc * xc, axis=1), "ind")
    syy = jax.lax.psum(jnp.sum(yc * yc, axis=1), "ind")
    r = sxy / (jnp.sqrt(sxx) * jnp.sqrt(syy))
    return r * r


def sweep_step(mesh, ignore_miss_data: bool = False, extend_out: bool = True):
    """Build the jitted sharded step:
    (gn1, gn2, eg1, eg2, maf1, maf2) -> per-pair LD statistics.

    Inputs are (P, I, 3) / (P, I) / (P,); P must divide the 'pairs' axis,
    I the 'ind' axis.
    """

    def step(gn1, gn2, eg1, eg2, maf1, maf2):
        f0 = jnp.stack([(1 - maf1) * (1 - maf2), (1 - maf1) * maf2,
                        maf1 * (1 - maf2), maf1 * maf2], axis=1).astype(gn1.dtype)
        if ignore_miss_data:
            include = ~(miss_mask(gn1) | miss_mask(gn2))
        else:
            include = jnp.ones(gn1.shape[:2], bool)
        n_used = jax.lax.psum(jnp.sum(include, axis=1), "ind").astype(jnp.int32)
        f, n_iter = _pair_em_shard(gn1, gn2, f0, include, n_used)
        # Pearson uses ALL individuals, missing included (ngsLD.cpp:290)
        n_tot = jax.lax.psum(
            jnp.full(gn1.shape[0], gn1.shape[1], jnp.int32), "ind")
        r2p = _pearson_shard(eg1, eg2, n_tot)
        hmaf0, hmaf1, D, Dp, r2 = ld_stats(f)
        chi2 = chi2_stat(f) if extend_out else jnp.zeros_like(r2p)
        return r2p, f, n_iter, n_used, hmaf0, hmaf1, D, Dp, r2, chi2

    pspec = P("pairs", "ind", None)   # (P, I, 3)
    espec = P("pairs", "ind")         # (P, I)
    vspec = P("pairs")                # (P,)
    mapped = shard_map(
        step, mesh=mesh,
        in_specs=(pspec, pspec, espec, espec, vspec, vspec),
        out_specs=(vspec, P("pairs", None), vspec, vspec, vspec, vspec,
                   vspec, vspec, vspec, vspec),
        check_vma=False)
    return jax.jit(mapped)
