"""Replicated-table block sweep driver (the default JAX engine).

The GL/E[G]/MAF tables are replicated per device over a 1-D 'pairs' mesh
(--shard) or a 2-D ('pairs','ind') mesh (--shard_ind); the banded pair
plan streams through a 3-stage emit pipeline (pull -> derive+format ->
write). See _run_jax_body.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np

from . import strict
from .checkpoint import _Checkpoint
from .compute import (_BLOCK_QUANTUM, _compute_block_fn,
                      _compute_block_ind_fn, device_bytes_limit,
                      max_block_pairs)
from .loaders import _StreamedGLLoader, _StreamedTextLoader


def _prefetch_blocks(gen, depth: int = 4):
    """Run a generator in a daemon thread, yielding through a bounded queue.

    Plan construction (plan.band) is a multi-second NumPy pass at large
    n_sites; the big ops release the GIL, so producing blocks concurrently
    hides the plan behind device compute. Closing the returned generator
    stops the producer promptly (GracefulStop path)."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def produce():
        try:
            for item in gen:
                while True:
                    if stop.is_set():
                        return
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            q.put(_END)
        except BaseException as e:  # surface plan errors on the consumer
            q.put((_ERR, e))

    t = threading.Thread(target=produce, daemon=True,
                         name="ngsld-plan-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


def _stats_host(f):
    """NumPy mirror of ops.stats.ld_stats: same op order, same dtype as the
    EM output, so host-derived stats match device-derived ones bitwise
    (ngsLD.cpp:296-306 semantics, incl. the C min() NaN asymmetry)."""
    maf0 = 1 - (f[:, 0] + f[:, 1])
    maf1 = 1 - (f[:, 0] + f[:, 2])
    D = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]

    def c_min(a, b):
        return np.where(a <= b, a, b)

    with np.errstate(all="ignore"):
        neg = -c_min(maf0 * maf1, (1 - maf0) * (1 - maf1))
        pos = c_min(maf0 * (1 - maf1), (1 - maf0) * maf1)
        Dp = D / np.where(D < 0, neg, pos)
        rr = D / np.sqrt(maf0 * maf1 * (1 - maf0) * (1 - maf1))
        return maf0, maf1, D, Dp, rr * rr


def _chi2_host(f):
    """NumPy mirror of ops.stats.chi2_stat: float32 accumulator, terms in
    the EM dtype (the reference computes chi2 in float, ngsLD.cpp:328-333)."""
    f32 = np.float32
    freq_A = (f[:, 0] + f[:, 1]).astype(f32)
    freq_B = (f[:, 0] + f[:, 2]).astype(f32)
    exp_hap = np.stack([freq_A * freq_B, freq_A * (1 - freq_B),
                        (1 - freq_A) * freq_B, (1 - freq_A) * (1 - freq_B)],
                       axis=1)
    with np.errstate(all="ignore"):
        diff = f - exp_hap.astype(f.dtype)
        terms = (diff * diff) / exp_hap.astype(f.dtype)
        chi2 = np.zeros(f.shape[0], f32)
        for i in range(4):  # sequential float32 rounding, like the reference
            chi2 = (chi2.astype(f.dtype) + terms[:, i]).astype(f32)
    return chi2


def _unpack(fmat, imat, extend_out=True):
    r2p, f = fmat[:, 0], fmat[:, 1:5]
    hmaf0, hmaf1, D, Dp, r2 = _stats_host(f)
    chi2 = _chi2_host(f) if extend_out \
        else np.zeros(len(f), np.float32)  # column not printed
    return (r2p, f, imat[:, 0], imat[:, 1], hmaf0, hmaf1, D, Dp, r2, chi2)


def _run_jax_body(pars, out_fh, log, prec, dt, profile_dir):
    import jax
    import jax.numpy as jnp
    from .ops.preprocess import preprocess

    ingest = None
    try:
        loader = None
        raw_gl = False  # loader delivers UNNORMALIZED records
        np_dt = np.float64 if dt == jnp.float64 else np.float32
        # upload/compute overlap (loaders._OverlapIngest): slab-wise
        # preprocess + coverage-gated dispatch hides the GL transfer under
        # the sweep. Engaged only when the PLAN cannot depend on unloaded
        # data (min_maf <= 0: the maf filter is constant-true,
        # ngsLD.cpp:264,270), on a single-device mesh, and when a
        # mid-sweep read error can keep the reference's no-output surface
        # (seekable out -> truncate; checkpoint mode never wrote to out).
        overlap = (
            _StreamedGLLoader.applicable(pars)
            and os.environ.get("NGSLD_OVERLAP_UPLOAD", "1") != "0"
            and pars.min_maf <= 0
            and pars.shard == 1 and getattr(pars, "shard_ind", 1) == 1
            and pars.verbose < 7
            and (bool(getattr(pars, "checkpoint", None))
                 or bool(getattr(out_fh, "seekable", lambda: False)())))
        ingest = None
        if _StreamedGLLoader.applicable(pars):
            # binary input: stream file slabs straight to the device while
            # the positions parse below runs; normalize on device
            loader = _StreamedGLLoader(pars, np_dt, stream_np=overlap)
            raw_gl = True
        elif _StreamedTextLoader.applicable(pars):
            # gz-text input: native line parsing streams to the device the
            # same way; records arrive already log-normalized
            loader = _StreamedTextLoader(pars, np_dt)
        else:
            with log.phase("Reading data from file"):
                geno_log = strict.read_geno(pars.in_geno, pars.in_bin,
                                            pars.in_probs, pars.in_logscale,
                                            pars.n_ind, pars.n_sites)
        with log.phase("Getting sites coordinates"):
            if pars.in_pos:
                pos_dist, labels = strict.read_pos(
                    pars.in_pos, pars.in_pos_header, pars.n_sites)
            else:
                pos_dist = np.full(pars.n_sites, math.inf)
                labels = ["(null)"] * pars.n_sites
        if pars.verbose >= 6:
            for s in range(min(10, pars.n_sites)):
                log.log(6, f"{s}\t{pos_dist[s]:f}")

        with log.phase("Preprocessing (call_geno, MAF, E[G]) on device"):
            pre_partial = functools.partial(
                preprocess, call=pars.call_geno, N_thresh=pars.N_thresh,
                call_thresh=pars.call_thresh,
                ignore_miss_data=pars.ignore_miss_data,
                raw=raw_gl, in_log=pars.in_logscale)
            pre = jax.jit(pre_partial)
            if overlap:
                from .loaders import _OverlapIngest
                ingest = _OverlapIngest(loader, pars, dt, pre_partial)
                gn_d = eg_d = maf_d = None
                maf = ingest.maf_host   # filled slab-by-slab, read by fmt
                # the PLAN's maf consumer is constant-true at min_maf<=0;
                # give it defined values so nothing reads uninitialized
                # memory (knife_edge_sites is empty at min_maf<=0 too)
                maf_plan = np.zeros(pars.n_sites, np.float64)
                log.log(2, "==> overlap ingest: GL upload + preprocess "
                           "run under the sweep (coverage-gated blocks)")
            elif loader is not None:
                with log.phase("  gl stream+upload", level=2):
                    gl_d = loader.join()
            else:
                # narrow on host first: GLs cross the host->device link
                # once, at target precision
                host_gl = np.asarray(geno_log, np.float64 if dt == jnp.float64
                                     else np.float32)
                del geno_log
                with log.phase("  gl upload", level=2):
                    gl_d = jnp.asarray(host_gl)
                    gl_d.block_until_ready()
                del host_gl
            if not overlap:
                with log.phase("  preprocess jit", level=2):
                    gn_d, maf_d, eg_d = pre(gl_d)
                # only MAF returns to the host (the plan needs it); GL/E[G]
                # tables stay device-resident for the sweep
                with log.phase("  maf to host", level=2):
                    # np.array: writable copy (knife-edge refinement writes)
                    maf = np.array(maf_d, np.float64)
                maf_plan = maf

        from .refine import (StrictRefiner, degenerate_tiers,
                             knife_edge_sites)
        refiner = None

        def get_refiner():
            nonlocal refiner
            if refiner is None:
                refiner = StrictRefiner(pars)
            return refiner

        no_refine = os.environ.get("NGSLD_REFINE") == "0"

        # pair-set stability: sites whose device MAF sits within precision
        # noise of min_maf get the bit-exact strict MAF, so `maf < min_maf`
        # (ngsLD.cpp:264,270) can never flip a band vs the reference
        # (NGSLD_REFINE=0 = round-1 behavior: no repair of any kind)
        ks = (np.empty(0, np.int64)
              if os.environ.get("NGSLD_REFINE") == "0"
              else knife_edge_sites(maf, pars.min_maf, prec))
        if len(ks):
            maf[ks] = get_refiner().exact_maf(ks)
            log.log(2, f"==> strict MAF refinement: {len(ks)} knife-edge "
                       f"site(s) at min_maf={pars.min_maf}")
            log.count("maf_refined_sites", len(ks))
        if pars.verbose >= 7:
            log.log(7, "==> Geno data")
            gn0 = np.asarray(gn_d[:min(10, pars.n_sites), 0, :])
            for s in range(min(10, pars.n_sites)):
                log.log(7, f"{s}\t{labels[s]}\t{maf[s]:f} "
                           f"({gn0[s,0]:f} {gn0[s,1]:f} {gn0[s,2]:f})")

        from .io.writer import RowWriter
        from .plan.band import iter_pair_blocks
        platform = jax.devices()[0].platform
        n_shards = pars.shard   # resolved once in run_jax
        idx_shd = None
        if getattr(pars, "shard_ind", 1) > 1:
            # 2-D ('pairs','ind') mesh: individual axis split across
            # devices (large cohorts), per-individual reductions psum
            # across devices. Tables re-shard once (device-to-device).
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as PS
            compute, mesh2 = _compute_block_ind_fn(
                pars.ignore_miss_data, n_shards, pars.shard_ind)
            gn_d = jax.device_put(
                gn_d, NamedSharding(mesh2, PS(None, "ind", None)))
            eg_d = jax.device_put(
                eg_d, NamedSharding(mesh2, PS(None, "ind")))
            maf_d = jax.device_put(maf_d, NamedSharding(mesh2, PS()))
            idx_shd = NamedSharding(mesh2, PS(None, "pairs"))
            log.log(2, f"==> mesh: {n_shards} pair-shards x "
                       f"{pars.shard_ind} individual-shards")
        else:
            compute = _compute_block_fn(pars.ignore_miss_data, platform,
                                        n_shards)
        # every device must receive the same per-shard shape; the block's
        # gathered buffers must fit the device beside the site tables
        chunk = int(pars.chunk_pairs)
        limit = device_bytes_limit()
        if limit is not None:
            cap = max_block_pairs(pars.n_ind, np.dtype(np_dt).itemsize,
                                  limit) * n_shards
            if chunk > cap:
                log.log(2, f"==> block size {chunk} -> {cap} pairs "
                           f"(device memory {limit / 1e9:.1f} GB)")
                chunk = cap
        chunk = -(-chunk // n_shards) * n_shards

        ckpt = None
        if getattr(pars, "checkpoint", None):
            # the fingerprint pins the sweep decomposition (the EFFECTIVE
            # chunk): a resume under a config that changes it would mix
            # shards from different decompositions
            ckpt = _Checkpoint(pars.checkpoint, pars, log,
                               extra={"chunk": chunk})
            # per-block RowWriters share one label blob (building it is
            # O(n_sites) — once, not once per block)
            try:
                from .native import LabelBlob, get_lib, make_labels_blob
                if get_lib() is not None and not isinstance(labels, LabelBlob):
                    labels = LabelBlob(*make_labels_blob(labels))
            except Exception:
                pass
        writer = None
        if ckpt is None:
            writer = RowWriter(out_fh, labels, pars.extend_out)
            writer.write_header()

        fmt_rw = writer if writer is not None \
            else RowWriter(None, labels, pars.extend_out)

        def pull(bi, blk, dev_out):
            """Stage 1 (device->host copy): outputs are sliced to the live
            row count BEFORE the transfer (gather outputs carry tail
            padding), so copied bytes scale with live pairs."""
            P = len(blk.s1)
            t0 = time.perf_counter()
            fm = np.asarray(dev_out[0][:P])
            im = np.asarray(dev_out[1][:P])
            log.count_time("sweep: result pull", time.perf_counter() - t0)
            return bi, blk, fm, im

        def fmt(bi, blk, fm, im):
            """Stage 2 (CPU): derive stats, format rows to bytes.

            Degenerate pairs (Dp/r2/chi2 denominators ~0 — refine.py) are
            recomputed with the strict pipeline and emit the reference's
            exact values; everything else takes the native derive+format
            fast path."""
            t0 = time.perf_counter()
            n_iter = im[:, 0].astype(np.int32)
            if im.shape[1] > 1:
                n_used = im[:, 1].astype(np.int32)
            else:
                # slim pull layout (compute._imat): --ignore_miss_data is
                # off, so every pair used the whole cohort — synthesize
                # the constant column and rebuild the 2-col im the
                # downstream _unpack/refine slicing expects
                n_used = np.full(im.shape[0], pars.n_ind, np.int32)
                im = np.column_stack([n_iter, n_used])
            log.count("em_iterations", int(n_iter.astype(np.int64).sum()))
            if pars.verbose >= 2:
                log.hist("em_iteration_histogram",
                         np.bincount(np.clip(n_iter, 0, 100)))
            tiers = (np.zeros(len(fm), np.uint8) if no_refine
                     else degenerate_tiers(fm[:, 1:5], prec))
            t1, t2 = tiers == 1, tiers == 2
            log.count_time("sweep: fmt/tiers", time.perf_counter() - t0)
            data = None
            if tiers.any():
                # Tier 1 (exact-zero class) rows take the bit-exact strict
                # recompute; tier 2 (f32-garbage class) re-derives its
                # stat columns in f64 from the engine's raw frequencies
                # (refine.derive_columns_f64 — no EM re-run). The corrected
                # rows ride the native derive+format call as OVERRIDE
                # columns, so one pass emits the whole chunk (a chunk is
                # ~1M rows — refining 5% of them must not drag the other
                # 95% onto a slow path, nor pay a byte-level splice).
                log.count("pairs_refined", int(t1.sum()))
                log.count("pairs_rederived", int(t2.sum()))
                use_native = bool(fmt_rw.native)
                if use_native:
                    # refined rows ride the SAME native call as override
                    # columns (derive-with-overrides) — no separate bulk
                    # format, no Python byte splice
                    idx = np.flatnonzero(tiers)
                    s1s, s2s, dists = (blk.s1[idx], blk.s2[idx],
                                       blk.dist[idx])
                    fms, ims = fm[idx], im[idx]
                    t1s, t2s = t1[idx], t2[idx]
                else:
                    idx = None
                    s1s, s2s, dists = blk.s1, blk.s2, blk.dist
                    fms, ims = fm, im
                    t1s, t2s = t1, t2
                # host derive in the EM dtype (bitwise what the native
                # derive path prints), widened to f64 for the formatter
                tu = time.perf_counter()
                r2p, f, n_iter64, n_used64, hmaf0, hmaf1, D, Dp, r2, chi2 \
                    = _unpack(fms, ims, pars.extend_out)
                cols = dict(      # copies: fm-backed views are read-only
                    r2p=np.array(r2p, np.float64),
                    f=np.array(f, np.float64),
                    hmaf1=np.array(hmaf0, np.float64),
                    hmaf2=np.array(hmaf1, np.float64),
                    D=np.array(D, np.float64),
                    Dp=np.array(Dp, np.float64),
                    r2=np.array(r2, np.float64),
                    chi2=np.array(chi2, np.float32),
                    maf1=maf[s1s].copy(), maf2=maf[s2s].copy(),
                    n_iter=np.array(n_iter64, np.int32),
                    n_used=np.array(n_used64, np.int32))
                log.count_time("sweep: fmt/unpack",
                               time.perf_counter() - tu)
                if t2s.any():
                    tp = time.perf_counter()
                    from .refine import derive_columns_f64
                    pol = derive_columns_f64(cols["f"][t2s])
                    for k in pol:
                        cols[k][t2s] = pol[k]
                    log.count_time("sweep: fmt/rederive",
                                   time.perf_counter() - tp)
                if t1s.any():
                    tr = time.perf_counter()
                    ref = get_refiner().refine_columns(s1s[t1s],
                                                       s2s[t1s])
                    for k in cols:
                        cols[k][t1s] = ref[k]
                    log.count_time("sweep: fmt/refine",
                                   time.perf_counter() - tr)
                tf = time.perf_counter()
                if use_native:
                    from .native import format_rows_derive
                    data = format_rows_derive(
                        fmt_rw.blob, fmt_rw.off, blk.s1, blk.s2,
                        blk.dist, fm[:, 0], fm[:, 1:5], maf[blk.s1],
                        maf[blk.s2], n_used, n_iter, pars.extend_out,
                        overrides=(idx, cols))
                    if data is None:
                        # only reachable on an fm dtype mismatch — a code
                        # bug; falling back would format the subset alone
                        raise RuntimeError(
                            "native derive formatter rejected the chunk")
                    log.count_time("sweep: fmt/bulk",
                                   time.perf_counter() - tf)
                else:
                    data = fmt_rw.format_block(
                        s1s, s2s, dists, cols["r2p"], cols["D"],
                        cols["Dp"], cols["r2"], n_used=cols["n_used"],
                        maf1=cols["maf1"], maf2=cols["maf2"],
                        hap=cols["f"], hmaf1=cols["hmaf1"],
                        hmaf2=cols["hmaf2"], chi2=cols["chi2"],
                        n_iter=cols["n_iter"])
                    log.count_time("sweep: fmt/rows",
                                   time.perf_counter() - tf)
            elif fmt_rw.native:
                # single native pass: D/D'/r2/hap-MAFs/chi2 derive inside
                # the formatter's worker threads from (r2p, f) directly
                from .native import format_rows_derive
                data = format_rows_derive(
                    fmt_rw.blob, fmt_rw.off, blk.s1, blk.s2, blk.dist,
                    fm[:, 0], fm[:, 1:5], maf[blk.s1], maf[blk.s2],
                    n_used, n_iter, pars.extend_out)
            if data is None:
                r2p, f, n_iter64, n_used64, hmaf0, hmaf1, D, Dp, r2, chi2 \
                    = _unpack(fm, im, pars.extend_out)
                data = fmt_rw.format_block(
                    blk.s1, blk.s2, blk.dist, r2p, D, Dp, r2,
                    n_used=n_used64.astype(np.int32), maf1=maf[blk.s1],
                    maf2=maf[blk.s2], hap=f, hmaf1=hmaf0, hmaf2=hmaf1,
                    chi2=chi2, n_iter=n_iter64.astype(np.int32))
            log.count_time("sweep: format", time.perf_counter() - t0)
            return bi, data

        def write(bi, data):
            """Stage 3 (disk IO): write rows (or a checkpoint shard)."""
            t0 = time.perf_counter()
            if ckpt is not None:
                with ckpt.open_block(bi) as bfh:
                    bfh.write(data)
                ckpt.commit_block(bi)
            else:
                try:
                    out_fh.write(data)
                except TypeError:
                    out_fh.write(data.decode())
            log.count_time("sweep: write", time.perf_counter() - t0)

        from .utils.signals import GracefulStop

        n_blocks = 0
        interrupted = False
        # 3-stage emit pipeline on daemon threads: result pull (copy),
        # stat derivation + row formatting (CPU), file write (disk IO). All
        # three release the GIL for their heavy part, so they overlap each
        # other AND the main thread's dispatch even on one core. FIFO
        # queues keep rows in (s1, s2) order.
        import queue as _queue
        import threading
        emit_q = _queue.Queue(maxsize=3)   # main -> pull
        fmt_q = _queue.Queue(maxsize=2)    # pull -> fmt
        write_q = _queue.Queue(maxsize=2)  # fmt -> write
        emit_err = []

        def _stage(in_q, out_q, fn, name):
            def run():
                while True:
                    item = in_q.get()
                    if item is None:
                        if out_q is not None:
                            out_q.put(None)
                        return
                    try:
                        res = fn(*item)
                    except BaseException as e:
                        emit_err.append(e)
                        while in_q.get() is not None:  # unblock the producer
                            pass
                        if out_q is not None:
                            out_q.put(None)
                        return
                    if out_q is not None:
                        out_q.put(res)
            t = threading.Thread(target=run, daemon=True, name=name)
            t.start()
            return t

        stages = [_stage(emit_q, fmt_q, pull, "ngsld-pull"),
                  _stage(fmt_q, write_q, fmt, "ngsld-fmt"),
                  _stage(write_q, None, write, "ngsld-write")]
        with log.phase("compute: banded pair sweep"), GracefulStop(log) as gs:
            blocks_it = enumerate(_prefetch_blocks(
                iter_pair_blocks(pars, maf_plan, pos_dist,
                                 block_pairs=chunk)))
            try:
                while True:
                    t_top = time.perf_counter()
                    try:
                        bi, blk = next(blocks_it)
                    except StopIteration:
                        break
                    log.count_time("sweep: plan wait",
                                   time.perf_counter() - t_top)
                    n_blocks = bi + 1
                    if gs.stopped or emit_err:
                        interrupted = not emit_err
                        break
                    if ckpt is not None and ckpt.done(bi):
                        log.count("blocks_resumed")
                        continue
                    P = len(blk.s1)
                    log.count("pairs_emitted", P)
                    log.count("blocks_computed")
                    if pars.verbose >= 3:
                        log.log(3, f"> Block {bi}: anchors "
                                   f"{blk.s1[0]}..{blk.s1[-1]}, {P} pairs")
                    if ingest is not None:
                        # overlap ingest: dispatch only after every
                        # site this block touches is device-resident
                        tw = time.perf_counter()
                        gn_d, eg_d, maf_d = ingest.wait(
                            int(blk.s2.max()) + 1)
                        log.count_time("sweep: ingest wait",
                                       time.perf_counter() - tw)
                    # pad to a multiple of 16K*n_shards (tail blocks and
                    # sampling variance then hit a few compiled shapes, and
                    # padding stays <= 12% instead of up to 2x with pow2)
                    quantum = _BLOCK_QUANTUM * n_shards
                    pad = -P % quantum
                    s1 = np.concatenate([blk.s1, np.zeros(pad, np.int64)])
                    s2 = np.concatenate([blk.s2, np.ones(pad, np.int64)
                                         * min(1, pars.n_sites - 1)])
                    t0 = time.perf_counter()
                    # one fused (2, P) index upload per block
                    sidx = np.stack([s1, s2]).astype(np.int32)
                    sj = (jnp.asarray(sidx) if idx_shd is None
                          else jax.device_put(sidx, idx_shd))
                    dev_out = compute(gn_d, eg_d, maf_d, sj)  # async
                    log.count_time("sweep: dispatch",
                                   time.perf_counter() - t0)
                    emit_q.put((bi, blk, dev_out))
            finally:
                # always shut the pipeline down, even when the loop raises
                # (device OOM, plan error): daemon stages blocked on get()
                # would otherwise pin queued device buffers forever
                emit_q.put(None)
                for t in stages:
                    t.join()
            if emit_err:
                raise emit_err[0]

        if ingest is not None and not interrupted:
            # surface a tail-of-file read error (NaN/EOF) even when no
            # block needed the last sites — the reference reads the whole
            # table before computing anything (read_data.cpp:13-116)
            ingest.join_all()
        if interrupted:
            hint = (f"resume with the same --checkpoint {ckpt.dir}"
                    if ckpt is not None else
                    "rerun with --checkpoint DIR to make runs resumable")
            log.log(0, f"==> Interrupted before block {n_blocks - 1}; "
                       f"completed blocks are flushed. {hint}")
            raise SystemExit(130)

        if ckpt is not None:
            with log.phase("Merging checkpoint shards"):
                hdr = strict.header_line(pars.extend_out)
                out_fh.write(hdr if hasattr(out_fh, "encoding")
                             else hdr.encode())
                ckpt.concatenate(out_fh, n_blocks)
        if refiner is not None:
            # sub-stage attribution of the strict-repair wall (read/prep/
            # gather/pearson/em/stats) — the dominant host cost on every
            # e2e leg, now visible in the timings artifact
            for k, v in sorted(refiner.t.items()):
                log.count_time(f"sweep: fmt/refine/{k}", v)
        log.summary()
    except BaseException:
        if (ingest is not None and ingest.failed
                and getattr(pars, "checkpoint", None) is None):
            # overlap mode wrote rows before the read error surfaced;
            # the reference prints NOTHING on bad input (it reads the
            # whole table first) — restore that surface (the overlap
            # gate required a seekable out_fh)
            try:
                out_fh.seek(0)
                out_fh.truncate()
            except Exception:
                pass
        raise
    finally:
        if profile_dir:
            jax.profiler.stop_trace()
