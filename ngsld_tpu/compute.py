"""Cached device compute-fn builders for the block engine, and the
device-facing choices they depend on.

Two sweep kernels, each optionally shard_map'ed over a device mesh:
  * _compute_block_fn      — gathered-pair step, 1-D 'pairs' mesh
  * _compute_block_ind_fn  — gathered-pair step, 2-D ('pairs','ind') mesh

pair_em_for owns the platform -> pair-EM implementation decision;
device_bytes_limit / max_block_pairs size the gathered blocks to the
device's memory.
"""

from __future__ import annotations

import functools

# pair-EM implementation per JAX platform (jax.devices()[0].platform)
EM_IMPLS = {"gpu": "pallas-triton", "cpu": "xla"}


def pair_em_for(platform: str):
    """The pair-EM function for a platform, with ops.em.pair_em's
    signature: the Hopper kernel (kernels.em_gpu) on 'gpu', the XLA
    while_loop on 'cpu'. Any other platform is an error."""
    impl = EM_IMPLS.get(platform)
    if impl is None:
        raise ValueError(f"no pair-EM implementation for platform "
                         f"{platform!r} (supported: {sorted(EM_IMPLS)})")
    if impl == "pallas-triton":
        from .kernels.em_gpu import pair_em_gpu
        return pair_em_gpu
    from .ops.em import pair_em
    return pair_em


def device_bytes_limit() -> int | None:
    """Memory the allocator may hand out on this process's first device,
    or None where the backend does not report it (the CPU)."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) if limit else None


# bytes per (pair, individual) of one gathered block: two (I, 3) GL rows
# and two E[G] rows (8 values), the XLA EM's include mask and (P, I)
# temporaries (~8 more), with headroom
_PAIR_IND_VALUES = 16
_BLOCK_QUANTUM = 16384   # engine_block pads blocks to this many pairs


def max_block_pairs(n_ind: int, itemsize: int, bytes_limit: int,
                    share: float = 0.5) -> int:
    """Largest gathered-block pair count whose buffers take at most `share`
    of bytes_limit (the rest holds the site tables and the next block's
    inputs). A multiple of the engine's padding quantum, at least one
    quantum."""
    per_pair = _PAIR_IND_VALUES * n_ind * itemsize + 64
    cap = int(bytes_limit * share) // per_pair
    return max(_BLOCK_QUANTUM, cap // _BLOCK_QUANTUM * _BLOCK_QUANTUM)


def _imat(n_iter, n_used, ignore_miss_data: bool, n_ind: int):
    """Pack the per-pair int metadata for the host pull.

    With --ignore_miss_data off, EVERY pair uses all n_ind individuals
    (ops/em.py include mask == ones), so n_used is a constant the host
    synthesizes and n_iter (<= ITER_MAX == 100, gen_func.hpp:18) ships as
    one int8 — (P, 1) i8 instead of (P, 2) i16, 3 fewer bytes per pair
    to copy to the host. engine_block.fmt rebuilds the 2-column layout
    from im.shape[1]."""
    import jax.numpy as jnp
    if not ignore_miss_data:
        return n_iter.astype(jnp.int8)[:, None]
    idt = jnp.int16 if n_ind <= 32767 else jnp.int32
    return jnp.stack([n_iter.astype(idt), n_used.astype(idt)], axis=1)


@functools.lru_cache(maxsize=None)
def _compute_block_ind_fn(ignore_miss_data: bool, n_shards: int,
                          n_ind_shards: int):
    """Block step over a 2-D ('pairs', 'ind') mesh for cohorts whose
    per-pair EM should split the INDIVIDUAL axis across devices
    (--shard_ind): each per-individual reduction becomes a psum across
    devices (parallel.sweep.sweep_step). The gathers run under GSPMD (tables
    'ind'-sharded, index vectors 'pairs'-sharded); only (r2p, f) + int16
    metadata return to the host, like the 1-D path."""
    import jax
    import jax.numpy as jnp
    from .parallel.mesh import make_mesh
    from .parallel.sweep import sweep_step
    mesh = make_mesh(n_shards, n_ind_shards,
                     devices=jax.devices()[:n_shards * n_ind_shards])
    step = sweep_step(mesh, ignore_miss_data, extend_out=True)

    def compute(gn, eg, maf, sidx):
        # sidx (2, P): both index vectors ride ONE host->device transfer
        s1, s2 = sidx[0], sidx[1]
        gn1, gn2 = jnp.take(gn, s1, axis=0), jnp.take(gn, s2, axis=0)
        eg1, eg2 = jnp.take(eg, s1, axis=0), jnp.take(eg, s2, axis=0)
        maf1, maf2 = jnp.take(maf, s1), jnp.take(maf, s2)
        r2p, f, n_iter, n_used, *_rest = step(gn1, gn2, eg1, eg2,
                                              maf1, maf2)
        fmat = jnp.concatenate([r2p[:, None].astype(f.dtype), f], axis=1)
        imat = _imat(n_iter, n_used, ignore_miss_data, gn.shape[1])
        return fmat, imat

    return jax.jit(compute), mesh


@functools.lru_cache(maxsize=None)
def _compute_block_fn(ignore_miss_data: bool, platform: str,
                      n_shards: int = 1):
    """Device-resident block step: the GL/E[G]/MAF tables stay on device and
    the per-block pair GATHER happens there too — only the (s1, s2) index
    vectors cross to the device per block.

    The device returns only (r2p, hap_freqs) + (n_iter, n_used): every
    other column (D, D', r2, hap MAFs, chi2) is a pure function of the
    frequencies and derives on the host (_stats_host/_chi2_host mirror the
    device formulas op-for-op in the same dtype), halving the per-pair
    result bytes. The pair EM is pair_em_for(platform).

    With n_shards > 1 the same step runs shard_map'ed over a 1-D 'pairs'
    mesh: tables replicated, index vectors (and therefore the gather and
    the EM) split across devices — the device replacement for the
    reference's pthread pool (ngsLD.cpp:154-186)."""
    import jax
    import jax.numpy as jnp
    from .ops.stats import pearson_r2
    pair_em = pair_em_for(platform)

    def compute(gn, eg, maf, sidx):
        # sidx (2, P): one fused index upload per block (see above)
        s1, s2 = sidx[0], sidx[1]
        gn1, gn2 = jnp.take(gn, s1, axis=0), jnp.take(gn, s2, axis=0)
        eg1, eg2 = jnp.take(eg, s1, axis=0), jnp.take(eg, s2, axis=0)
        maf1, maf2 = jnp.take(maf, s1), jnp.take(maf, s2)
        r2p = pearson_r2(eg1, eg2)
        f, n_iter, n_used = pair_em(gn1, gn2, maf1, maf2, ignore_miss_data)
        fmat = jnp.concatenate([r2p[:, None].astype(f.dtype), f],
                               axis=1)  # (P, 5)
        imat = _imat(n_iter, n_used, ignore_miss_data, gn.shape[1])
        return fmat, imat

    if n_shards > 1:
        from jax import shard_map
        from jax.sharding import PartitionSpec as PS

        from .parallel.mesh import make_mesh
        mesh = make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
        rep, shd = PS(), PS("pairs")
        compute = shard_map(
            compute, mesh=mesh,
            in_specs=(rep, rep, rep, PS(None, "pairs")),
            out_specs=(shd, shd), check_vma=False)
    return jax.jit(compute)
