"""JAX engine driver: the fast device path (GPU, or CPU via XLA).

Pipeline (mirrors main(), ngsLD.cpp:27-223, re-architected for a device;
every stage below overlaps its neighbors via bounded queues/threads):
  host: binary GLs stream to the device in slabs while positions parse
        (text inputs take the native/strict readers — exact reference
        semantics); normalization happens on device (preprocess raw=True)
  dev:  preprocess (call_geno, MAF, normal-space GLs, E[G])   [jit, sharded]
  host: banded pair plan (native C++ slab enumerator, RNG-exact), produced
        on a prefetch thread                                  [plan.band]
  dev:  per block: pair gather + pair EM (compute.pair_em_for: the
        Pallas/Triton kernel on a GPU, the XLA loop on the CPU) + Pearson
        r2; only (r2p, hap freqs) + int16 metadata return to the host
  host: 3-stage emit pipeline — pull (device->host copy) -> derive stats
        + format (native C, stats computed in the formatter's worker
        threads) -> write (disk IO) — rows in deterministic (s1, s2) order

Two sharding modes: the default replicates the tables over a 1-D 'pairs'
mesh (--shard); --ring keeps them site-sharded and ring-passes partner
blocks for tables too large to replicate (multi-host: per-process shards).

Precision: f64 unless --precision f32. Values agree with the strict engine
to ~1e-12 (f64) / ~1e-4 (f32); the strict engine remains the byte-exact
contract.

Aux subsystems the reference lacks (SURVEY.md §5):
  * phase timing + stage wall-time counters + EM-iteration histogram
    (--verbose 2)
  * JAX profiler traces (--profile DIR)
  * checkpoint/resume: per-block output shards + manifest (--checkpoint DIR);
    a killed run re-runs only the missing blocks
  * graceful SIGINT/SIGTERM: in-flight blocks flush, exit 130, resumable
"""

from __future__ import annotations

import os
import sys

from . import strict
from .config import Params
from .utils.logging import RunLog, echo_config

# The drivers and their support classes live in sibling modules; the names
# below stay importable from here (tests and external monkeypatches use
# `engine._RingSpill` etc. — same class objects, just defined elsewhere).
from .checkpoint import (_RING_COLS, _Checkpoint,  # noqa: F401
                         _config_fingerprint, _RingSpill)
from .engine_block import (_chi2_host, _compute_block_fn,  # noqa: F401
                           _compute_block_ind_fn, _prefetch_blocks,
                           _run_jax_body, _stats_host, _unpack)
from .engine_ring import _local_blocks, _run_jax_ring  # noqa: F401
from .loaders import (_ring_sharded_tables,  # noqa: F401
                      _StreamedGLLoader, _StreamedTextLoader)


def _resolve_precision(precision: str) -> str:
    return "f64" if precision == "auto" else precision


# persistent compile cache when JAX_COMPILATION_CACHE_DIR is not set: a
# fixed directory in the checkout (the path is part of the cache key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> None:
    """The CLI is a fresh process per run and a cold compile costs seconds:
    keep compiled programs across runs. Where JAX_COMPILATION_CACHE_DIR is
    set JAX reads it itself and no directory is set here."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


def run_jax(pars: Params, out_fh=None) -> None:
    import jax

    enable_compile_cache()
    prec = _resolve_precision(pars.precision)
    if prec == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dt = jnp.float64 if prec == "f64" else jnp.float32
    log = RunLog(pars.verbose)
    if pars.verbose >= 1:
        echo_config(pars, f"(jax, {jax.default_backend()}, {prec})")

    # resolve --shard 0 ("all devices") to a CONCRETE count exactly once:
    # the block decomposition (and therefore checkpoint shard compatibility)
    # must not silently depend on the device count of whatever machine a
    # checkpoint is resumed on — the resolved value joins the fingerprint
    n_avail = len(jax.devices())
    if not pars.shard:
        # --shard 0 = "all devices" — the devices LEFT OVER after the
        # individual axis takes its share, so --shard 0 --shard_ind M works
        pars.shard = n_avail // max(1, getattr(pars, "shard_ind", 1))
        if not pars.shard:
            raise strict.StrictError(
                "shard", f"--shard_ind {pars.shard_ind} > {n_avail} devices")
    if pars.shard * max(1, getattr(pars, "shard_ind", 1)) > n_avail:
        raise strict.StrictError(
            "shard", f"--shard {pars.shard} x --shard_ind "
            f"{getattr(pars, 'shard_ind', 1)} > {n_avail} devices")
    if getattr(pars, "ring", False) and pars.shard == 1 and n_avail > 1:
        log.log(1, "==> WARNING: --ring with --shard 1 runs a degenerate "
                   f"1-device ring ({n_avail} devices available); "
                   "pass --shard 0 for all devices")

    profile_dir = getattr(pars, "profile", None)
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    close = False
    if out_fh is None:
        if pars.out is not None:
            path = pars.out
            if getattr(pars, "ring", False) and jax.process_count() > 1:
                # multi-host ring: every process runs this program and owns
                # its resident blocks' rows; a shared path would have the
                # hosts truncate/interleave each other. Each host writes its
                # own shard (merge with `ngsld-merge OUT` afterwards).
                path = f"{pars.out}.part{jax.process_index():05d}"
                log.log(1, f"==> multi-host ring: this process writes {path}"
                           f" (merge: ngsld-merge {pars.out})")
            out_fh = open(path, "wb")
            close = True
        else:
            out_fh = getattr(sys.stdout, "buffer", sys.stdout)

    from .engine_ring import RingNarrowBand
    try:
        if getattr(pars, "ring", False):
            # ring mode owns its own step-granular checkpoint (_RingSpill,
            # built inside _run_jax_ring once the block decomposition is
            # known)
            try:
                _run_jax_ring(pars, out_fh, log, prec, dt, profile_dir)
            except RingNarrowBand as e:
                # raised before any IO/output: the band fits inside one
                # ring step's sub-block, so the rectangle sweep would be
                # mostly dead lanes — run the replicated-table block
                # engine instead (same output contract)
                log.log(1, f"==> --ring auto-route: {e}; using the "
                           "block engine (NGSLD_RING_AUTOROUTE=0 or "
                           "--ring_sub N to force the ring)")
                _run_jax_body(pars, out_fh, log, prec, dt, profile_dir)
        else:
            _run_jax_body(pars, out_fh, log, prec, dt, profile_dir)
    finally:
        if close:
            out_fh.close()
