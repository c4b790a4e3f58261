"""Site-sharded ring sweep driver (--ring) — see _run_jax_ring."""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from . import strict
from .checkpoint import _RingSpill
from .compute import device_bytes_limit
from .engine_block import _chi2_host, _stats_host
from .loaders import _ring_sharded_tables


class RingNarrowBand(RuntimeError):
    """Raised by _run_jax_ring (before any IO/output) when the banded plan
    is too narrow for the ring's rectangle steps: the band fits inside ONE
    step's partner sub-block, so most rectangle lanes would be dead and
    the replicated-table block engine is strictly better. run_jax catches
    this and reruns on the block engine."""

    def __init__(self, mean_w: float, b_sub: int):
        super().__init__(
            f"banded plan (mean live width {mean_w:.0f} sites) fits inside "
            f"one ring step's {b_sub}-site partner sub-block")
        self.mean_w, self.b_sub = mean_w, b_sub


def _local_blocks(arr, B: int):
    """{block index -> host ndarray} for this process's ADDRESSABLE shards
    of a 'sites'-sharded array (multi-host: each host only ever touches the
    blocks it owns; np.asarray on the global array would raise)."""
    out = {}
    for sh in arr.addressable_shards:
        start = sh.index[0].start or 0
        out[start // B] = np.asarray(sh.data)
    return out


def _run_jax_ring(pars, out_fh, log, prec, dt, profile_dir):
    """Site-sharded ring sweep driver (--ring).

    The replicated-table engine (_run_jax_body) assumes the GL/E[G] tables
    fit on every device; at reference scale they don't (5M sites x 500 ind
    ~ 30 GB fp32, SURVEY.md §7). Here the preprocessed tables are sharded
    over a 1-D 'sites' mesh — one contiguous block per device — and
    partner blocks ride the ring via ppermute (parallel.ring).

    Each ring step compacts ON DEVICE (parallel.ring._device_compact): the
    stepper itself applies the emission mask (band, triangle, MAF, real
    sites, sampling) and gathers the surviving rows, so this host pulls
    only its own blocks' LIVE (r2p, hap-freq, n_iter) rows — 21-24 B per
    emitted pair instead of ~52 B per rectangle cell — plus a per-block
    count that cross-checks the host's replay of the same mask (which
    supplies the (a, pj) labels). Derived columns (D/D'/r2/hap-MAFs/chi2)
    are computed at merge time on the host (_stats_host), never shipped.
    Host memory is O(emitted rows), not O(n_steps * S * B) tiles; device
    memory is O(table/n_dev + B*B_sub stats) per device (size the mesh so
    B = S/n_dev stays ~10^4). Rows are emitted per resident block in
    (s1, s2) order — on a multi-host cluster every host runs the same
    program and writes the shard holding its own blocks' rows.

    With --checkpoint the sweep is resumable at (sub-ring, ring step)
    granularity (_RingSpill): completed steps' tiles feed the merge from
    disk and the visiting state fast-forwards via an offset ppermute
    (the reference has no resume at all, SURVEY.md §5).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as PS

    from .io.writer import RowWriter
    from .parallel.ring import ring_sweep_stepper
    from .plan.band import band_limits, contig_positions

    n_dev = pars.shard   # resolved once in run_jax
    n_is = getattr(pars, "shard_ind", 1)
    if n_is > 1:
        # 2-D ('sites', 'ind') mesh: site blocks ride the ring while the
        # individual axis splits within each block (very large cohorts);
        # per-individual reductions psum over 'ind'
        # (parallel.ring.ring_sweep_stepper_ind)
        if pars.n_ind % n_is:
            raise strict.StrictError(
                "shard", "--shard_ind must divide --n_ind")
        mesh = Mesh(np.array(jax.devices()[:n_dev * n_is])
                    .reshape(n_dev, n_is), ("sites", "ind"))
    else:
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("sites",))

    tmp_spill = None
    try:
        with log.phase("Getting sites coordinates"):
            if pars.in_pos:
                pos_dist, labels = strict.read_pos(
                    pars.in_pos, pars.in_pos_header, pars.n_sites)
            else:
                pos_dist = np.full(pars.n_sites, math.inf)
                labels = ["(null)"] * pars.n_sites

        n = pars.n_sites
        B = -(-n // n_dev)
        # sub-block ring: visiting state rotates B_sub-row sub-blocks so the
        # per-step stat tile is (B, B_sub) — a full (B, B) tile would not
        # fit device memory at scale, and narrow bands waste less
        # out-of-band compute. 0 = auto: ~4k sites per sub-block AND a cap
        # on the per-step tile AREA: the per-step transient peak is roughly
        # 70-80 B per cell (stat planes + rearrange copies + the compaction
        # gather), so the cap keeps it near 30% of device memory (a
        # degenerate few-device ring makes B huge, e.g. 100k sites on 1
        # device = 4e8 cells at B_sub=4096). NGSLD_RING_AREA overrides it;
        # backends that report no memory limit use 6e7 cells.
        mem = device_bytes_limit()
        area_cap = int(os.environ.get(
            "NGSLD_RING_AREA", int(0.3 * mem / 80) if mem else 60_000_000))
        n_sub = getattr(pars, "ring_sub", 0) or max(
            1, -(-B // 4096), -(-(B * B) // area_cap))
        n_sub = min(n_sub, B)
        B = -(-B // n_sub) * n_sub   # sub-blocks must divide the block
        B_sub = B // n_sub

        # narrow-band auto-route: a band that fits inside ONE ring step's
        # partner sub-block leaves most rectangle lanes dead (the step EM
        # computes every lane of a live batch) — the block engine wins
        # outright there. Exempt: multi-host (the block engine is
        # single-host), an explicit --ring_sub (the user is hand-tuning
        # the ring), a resumed ring checkpoint, tables too big to
        # replicate per device, NGSLD_RING_AUTOROUTE=0.
        if (jax.process_count() == 1
                and not getattr(pars, "ring_sub", 0)
                and os.environ.get("NGSLD_RING_AUTOROUTE") != "0"):
            ck = getattr(pars, "checkpoint", None)
            ring_ckpt = False   # resumed RING checkpoint pins the engine
            if ck and os.path.exists(os.path.join(ck, "MANIFEST.json")):
                import json as _json
                try:
                    with open(os.path.join(ck, "MANIFEST.json")) as fh:
                        ring_ckpt = _json.load(fh).get("mode") == "ring"
                except Exception:
                    ring_ckpt = True   # unreadable: don't reroute blindly
            # tables replicable per device: at most a quarter of its
            # memory (4e9 B where the backend reports no limit)
            tbl_bytes = float(pars.n_sites) * pars.n_ind * 16.0
            mem_cap = float(os.environ.get(
                "NGSLD_AUTOROUTE_MEM", 0.25 * mem if mem else 4e9))
            if not ring_ckpt and tbl_bytes <= mem_cap:
                hi_r = band_limits(pos_dist, pars.max_kb_dist,
                                   pars.max_snp_dist)
                live_w = np.maximum(
                    np.minimum(hi_r, n) - np.arange(n) - 1, 0)
                mean_w = float(live_w.mean()) if n else 0.0
                if mean_w <= B_sub:
                    raise RingNarrowBand(mean_w, B_sub)
        Sp = B * n_dev
        from .ops.preprocess import preprocess
        np_dt = np.float64 if prec == "f64" else np.float32
        with log.phase("Reading data from file (site-sharded stream)"):
            gl_d, raw_gl = _ring_sharded_tables(
                pars, mesh, n_dev, B, Sp, np_dt, log)
        with log.phase("Preprocessing (site-sharded) on device"):
            pre = jax.jit(functools.partial(
                preprocess, call=pars.call_geno, N_thresh=pars.N_thresh,
                call_thresh=pars.call_thresh,
                ignore_miss_data=pars.ignore_miss_data,
                raw=raw_gl, in_log=pars.in_logscale),
                # free the log-GL table as the normalized tables build:
                # device memory is the ring's scarce resource (the CPU
                # backend ignores donation, so only donate off the CPU)
                donate_argnums=(0,) if mesh.devices.flat[0].platform != "cpu"
                else ())
            gn_d, maf_d, eg_d = pre(gl_d)
            del gl_d
            if jax.process_count() == 1:
                maf = np.array(maf_d, np.float64)[:n]
            else:
                # masks need GLOBAL MAFs (partner blocks live on other
                # hosts); allgather the (tiny) vector
                from jax.experimental import multihost_utils
                maf = np.array(multihost_utils.process_allgather(
                    maf_d, tiled=True), np.float64)[:n]

        from .refine import (StrictRefiner, degenerate_tiers,
                             knife_edge_sites)
        refiner = None

        def get_refiner():
            nonlocal refiner
            if refiner is None:
                refiner = StrictRefiner(pars)
            return refiner

        no_refine = os.environ.get("NGSLD_REFINE") == "0"

        # pair-set stability: knife-edge sites take the strict f64 MAF so
        # the band masks below can never flip vs the reference. The maf
        # vector is identical on every host (allgathered above) and the
        # strict recompute is deterministic, so all hosts stay in agreement
        # (NGSLD_REFINE=0 = round-1 behavior: no repair of any kind).
        ks = (np.empty(0, np.int64)
              if os.environ.get("NGSLD_REFINE") == "0"
              else knife_edge_sites(maf, pars.min_maf, prec))
        if len(ks):
            maf[ks] = get_refiner().exact_maf(ks)
            log.log(2, f"==> strict MAF refinement: {len(ks)} knife-edge "
                       f"site(s) at min_maf={pars.min_maf}")
            log.count("maf_refined_sites", len(ks))

        hi = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
        contig, pos = contig_positions(pos_dist)
        ok = ~(maf < pars.min_maf)            # NaN passes, ngsLD.cpp:264/270

        # --rnd_sample: replicate the reference's draw discipline (one taus
        # uniform per surviving candidate, in s2 order, from a per-anchor
        # child stream, ngsLD.cpp:164-166,277) without host-planning the
        # global pair set: each host materializes only its RESIDENT anchors'
        # sampled draw-index sets (cost/memory ~ its own emitted rows), and
        # a pair's draw index is recovered in O(1) as the ok-prefix-sum
        # rank of the partner within the anchor's band.
        # blocks this process OWNS (first device of the mesh row is local):
        # it computes their sampling plans and masks, pulls their compacted
        # rows, and emits their output shard
        my_blocks = sorted(
            k for k in range(n_dev)
            if np.atleast_1d(mesh.devices[k]).ravel()[0]
            .process_index == jax.process_index())
        samp_keys = okc = None
        if pars.rnd_sample < 1.0:
            from .gsl_rng import iter_uniform_chunks
            from .plan.band import child_seeds
            seeds = child_seeds(pars.seed, n)
            okc = np.cumsum(ok.astype(np.int64))  # okc[j] = #ok in [0, j]
            # sampled pairs as a SORTED array of keys anchor*n + draw_index
            # (ascending anchors x ascending draw indices => concatenation
            # is already sorted; membership below is one searchsorted)
            parts = []
            with log.phase("Sampling plan (taus draws, resident anchors)"):
                for k in my_blocks:
                    lo_s, hi_s = k * B, min(k * B + B, n)
                    if lo_s >= n:
                        continue
                    anchors = np.arange(lo_s, hi_s)[ok[lo_s:hi_s]]
                    if not len(anchors):
                        continue
                    # kept-candidate count per anchor (ok partners in band)
                    m = (okc[np.maximum(hi[anchors] - 1, anchors)]
                         - okc[anchors])
                    for a0, a1, u in iter_uniform_chunks(seeds[anchors], m):
                        for r in range(a0, a1):
                            c_hit = np.flatnonzero(
                                u[r - a0, :m[r]] <= pars.rnd_sample)
                            if len(c_hit):
                                parts.append(anchors[r] * np.int64(n) + c_hit)
            samp_keys = (np.concatenate(parts) if parts
                         else np.empty(0, np.int64))
        # max forward reach of any device's anchors past its block start:
        # sub-ring (si) needs ring steps t while t*B + si*B_sub < maxspan
        starts = np.arange(n_dev) * B
        maxspan = int(max(
            (hi[s:min(s + B, n)].max(initial=0) - s) for s in starts
            if s < n))
        log.log(2, f"==> ring: {n_dev} blocks of {B} sites, {n_sub} "
                   f"sub-blocks of {B_sub}")

        import tempfile
        persistent = bool(getattr(pars, "checkpoint", None))
        if persistent:
            spill_dir = pars.checkpoint
        else:
            tmp_spill = tempfile.TemporaryDirectory(prefix="ngsld_ring_")
            spill_dir = tmp_spill.name
        spill = _RingSpill(
            spill_dir, pars,
            # cols= versions the spilled record layout: slim-v2 stores only
            # (a, pj, r2p, f, n_iter, n_used) and derives the rest at merge
            # — resumes against older full-stat spills must be rejected
            dict(mode="ring", n_dev=n_dev, n_sub=n_sub, block=B,
                 n_proc=jax.process_count(), n_is=n_is, cols="slim-v2"),
            jax.process_index(), persistent)
        rck = spill if persistent else None

        # Device-side row compaction (parallel.ring._device_compact):
        # every stepper returns (fm, im, cnt) with only the live rows
        # meaningful, so per-step host-link bytes scale with emitted
        # pairs (21-24 B each), not with B x B_sub rectangle area (the
        # old 10-stat full-tile pull cost ~52 B/cell). Derived columns
        # (D/D'/r2/hap-MAFs/chi2) moved to merge time on the host.
        compact_cfg = dict(
            n=n, B=B, B_sub=B_sub, n_dev=n_dev,
            sample=pars.rnd_sample < 1.0,
            slim_im=not pars.ignore_miss_data,
            use_i16=pars.n_ind <= 32767)
        shd1 = NamedSharding(mesh, PS("sites"))
        hip = np.zeros(Sp, np.int32)
        hip[:n] = hi
        okp = np.zeros(Sp, np.float32)
        okp[:n] = ok
        hi_d = jax.device_put(hip, shd1)
        ok_d = jax.device_put(okp, shd1)
        # row_chunk bounds the XLA stepper's peak memory to 256 anchor
        # strips of EM intermediates while still vmapping (scan-per-anchor
        # would be ~256x more dispatches)
        if n_is > 1:
            from .parallel.ring import ring_sweep_stepper_ind
            stepper = ring_sweep_stepper_ind(
                mesh, pars.ignore_miss_data, pars.extend_out,
                row_chunk=256, compact_cfg=compact_cfg)
        else:
            stepper = ring_sweep_stepper(
                mesh, pars.ignore_miss_data, pars.extend_out,
                row_chunk=256, compact_cfg=compact_cfg)
        writer = RowWriter(out_fh, labels, pars.extend_out)
        if jax.process_index() == 0:
            # multi-host shards concatenate in part order; only the first
            # shard carries the header
            writer.write_header()

        def host_mask(i, si, t):
            """The emission mask of one resident block's (B, B_sub) step
            tile (triangle, real sites, MAF, band, sampling) — the SAME
            predicate parallel.ring._device_compact evaluates on device.
            Returns (valid, samp) where samp is the sampling-membership
            plane the device still needs (packed bits input), or None when
            --rnd_sample is off. The host side provides the (a, pj) labels
            and live counts; the device side orders/ships only the
            surviving value rows."""
            A = (i * B + np.arange(B, dtype=np.int64))[:, None]    # (B, 1)
            PJ = (((i + t) % n_dev) * B + si * B_sub
                  + np.arange(B_sub, dtype=np.int64))[None, :]     # (1, Bs)
            valid = (PJ > A) & (PJ < n) & (A < n)
            valid &= ok[np.minimum(A, n - 1)] & ok[np.minimum(PJ, n - 1)]
            valid &= PJ < hi[np.minimum(A, n - 1)]   # band: s2 < hi[s1]
            samp = None
            if samp_keys is not None:
                # draw index of (a, pj) = #ok candidates strictly before
                # pj; one vectorized searchsorted over all valid cells
                samp = np.zeros_like(valid)
                if valid.any():
                    c = (okc[np.maximum(np.minimum(PJ, n) - 1, 0)]
                         - okc[np.minimum(A, n - 1)])
                    q = (np.minimum(A, n - 1) * np.int64(n) + c)[valid]
                    pos_in = np.searchsorted(samp_keys, q)
                    hit = pos_in < len(samp_keys)
                    hit[hit] = samp_keys[pos_in[hit]] == q[hit]
                    samp[valid] = hit
                valid = valid & samp
            return valid, samp

        CAPW = -(-(B * B_sub) // 32)
        bits_shd = NamedSharding(mesh, PS("sites", None))

        def pack_bits(samp):
            """(B, B_sub) bool -> (CAPW,) u32, little-endian bit order
            (the exact layout parallel.ring._unpack_bits reverses)."""
            by = np.packbits(samp.reshape(-1), bitorder="little")
            by = np.pad(by, (0, CAPW * 4 - len(by)))
            return by.view(np.uint32)

        from .parallel.ring import ring_subblock_taker
        from .parallel.ring import ring_subblock_taker_ind as _rsti
        from .utils.signals import GracefulStop
        interrupted = False
        with log.phase("compute: ring sweep"), GracefulStop(log) as gs:
            for si in range(n_sub):
                if interrupted:
                    break
                # steps needed by THIS sub-ring: partners at ring step t
                # start t*B + si*B_sub past the anchor block's start
                t_max = min(n_dev,
                            -(-(maxspan - si * B_sub) // B) if B else 0)
                if t_max <= 0:
                    continue
                t0 = 0
                if rck is not None:
                    # resume: steps commit in order, so the first missing
                    # one is where the interrupted sweep stopped. On a
                    # multi-host cluster the hosts may have died at different
                    # points; every host must run the SAME collective
                    # sequence, so they agree on the minimum resume step
                    # (hosts that committed further simply recompute and
                    # overwrite — loads stay below the agreed point so no
                    # rows double-append).
                    while t0 < t_max and rck.done(si, t0):
                        t0 += 1
                    if jax.process_count() > 1:
                        from jax.experimental import multihost_utils
                        t0 = int(multihost_utils.process_allgather(
                            np.array([t0])).min())
                    # resumed steps' tiles are already in the spill; the
                    # merge phase reads them straight from disk
                    for t in range(t0):
                        log.count("ring_steps_resumed")
                    if t0:
                        log.log(2, f"==> ring ckpt: sub-ring {si} resumes "
                                   f"at step {t0}/{t_max}")
                if t0 >= t_max:
                    continue
                taker = ring_subblock_taker if n_is == 1 else _rsti
                vis = taker(mesh, n_sub, si, offset=t0, with_ok=True)(
                    gn_d, eg_d, maf_d, ok_d)
                for t in range(t0, t_max):
                    stop = gs.stopped
                    if jax.process_count() > 1:
                        # SPMD: every host must break at the SAME step or
                        # the survivors hang in the next collective — make
                        # the stop decision collective (any host stops all)
                        from jax.experimental import multihost_utils
                        stop = bool(multihost_utils.process_allgather(
                            np.array([stop])).any())
                    if stop:
                        # the last completed step is committed; a rerun
                        # with the same --checkpoint resumes right here
                        interrupted = True
                        break
                    # host mask pass: (a, pj) labels + live counts for MY
                    # blocks, and (when sampling) the packed membership
                    # bits every device ANDs into its own mask
                    masks = {i: host_mask(i, si, t) for i in my_blocks}
                    extra = []
                    if compact_cfg["sample"]:
                        rows = {i: pack_bits(samp)
                                for i, (_, samp) in masks.items()}

                        def _bits_cb(index):
                            i0 = index[0].start or 0
                            return rows.get(
                                i0, np.zeros(CAPW, np.uint32))[None]

                        extra = [jax.make_array_from_callback(
                            (n_dev, CAPW), bits_shd, _bits_cb)]
                    res, *vis = stepper(
                        gn_d, eg_d, maf_d, hi_d, ok_d, *vis,
                        jnp.int32(t), jnp.int32(si), *extra)
                    vis = tuple(vis)
                    fm_g, im_g, cnt_g = res
                    fm_sh = {(s.index[0].start or 0): s.data
                             for s in fm_g.addressable_shards}
                    im_sh = {(s.index[0].start or 0): s.data
                             for s in im_g.addressable_shards}
                    cnt_sh = {(s.index[0].start or 0): s.data
                              for s in cnt_g.addressable_shards}
                    step_rows = {}
                    for i in my_blocks:
                        valid, _ = masks[i]
                        a_idx, pj_idx = np.nonzero(valid)
                        live = len(a_idx)
                        if live == 0:
                            step_rows[i] = None
                            continue
                        # device/host mask agreement check is free: the
                        # device count rides the (tiny) cnt pull
                        dev_live = int(np.asarray(cnt_sh[i])[0])
                        if dev_live != live:
                            raise AssertionError(
                                f"ring compact mismatch: device "
                                f"{dev_live} vs host {live} rows "
                                f"(block {i}, si {si}, t {t})")
                        fm = np.asarray(fm_sh[i][0, :live])
                        im = np.asarray(im_sh[i][0, :live])
                        # spill rows stay slim on disk too: int32 labels
                        # (site indices < 2^31 at any supported scale),
                        # n_iter as pulled, and NO n_used column when it
                        # is the constant the merge synthesizes
                        cols_i = dict(
                            a=(i * B + a_idx).astype(np.int32),
                            pj=((((i + t) % n_dev) * B + si * B_sub
                                 + pj_idx).astype(np.int32)),
                            r2p=fm[:, 0], f=fm[:, 1:5],
                            n_iter=im[:, 0])
                        if im.shape[1] > 1:
                            cols_i["n_used"] = im[:, 1]
                        step_rows[i] = cols_i
                    spill.save_step(si, t, step_rows)
                    del step_rows, masks
                    log.count("ring_steps")

        if interrupted:
            hint = (f"resume with the same --checkpoint {rck.dir}"
                    if rck is not None else
                    "rerun with --checkpoint DIR to make ring runs resumable")
            log.log(0, f"==> Interrupted mid ring sweep; completed steps "
                       f"are committed. {hint}")
            raise SystemExit(130)

        # Emit: bounded-memory merge over the spill. Each tile file is
        # already (a, pj)-sorted (row-major compaction), so rows for an
        # anchor RANGE are a contiguous slice of every tile — memmap the
        # tiles, walk per-tile cursors, and lexsort only one anchor-chunk
        # of rows at a time. Host memory is O(chunk rows), not O(emitted
        # rows); byte-identical to a global per-block lexsort because
        # (a, pj) is unique across a block's tiles.
        budget = int(os.environ.get("NGSLD_RING_EMIT_ROWS", 2_000_000))
        with log.phase("emit: merge + format"):
            for i in my_blocks:
                mms = [np.load(p, mmap_mode="r")
                       for p in spill.block_tiles(i)]
                total = sum(len(x) for x in mms)
                if total == 0:
                    continue
                if not pars.in_bin and not no_refine:
                    # gz-text inputs: prime the refiner's row caches for
                    # ALL of this block's fragile sites in ONE streaming
                    # parse — per-chunk priming would re-decompress the
                    # file once per merge chunk (O(chunks x file))
                    t1s = set()
                    for x in mms:
                        tt = degenerate_tiers(np.asarray(x["f"]),
                                              prec)
                        which = tt == 1   # tier 2 reads no files now
                        if which.any():
                            t1s.update(np.asarray(x["a"])[which])
                            t1s.update(np.asarray(x["pj"])[which])
                    if t1s:
                        get_refiner()._ensure(np.fromiter(t1s, np.int64))
                a_lo, a_hi = i * B, min(i * B + B, n)
                step = max(1, int(budget // max(1, total // max(1, B))))
                cursors = [0] * len(mms)
                a0 = a_lo
                while a0 < a_hi:
                    a1 = min(a0 + step, a_hi)
                    parts = []
                    for j, x in enumerate(mms):
                        e = int(np.searchsorted(x["a"], a1, side="left"))
                        if e > cursors[j]:
                            parts.append(np.asarray(x[cursors[j]:e]))
                            cursors[j] = e
                    a0 = a1
                    if not parts:
                        continue
                    cat = np.concatenate(parts)
                    cat = cat[np.lexsort((cat["pj"], cat["a"]))]
                    af, pf = cat["a"], cat["pj"]
                    dist = np.where(contig[af] == contig[pf],
                                    pos[pf] - pos[af], np.inf)
                    # derived columns come from the hap freqs HERE, in the
                    # EM dtype — the device no longer computes (or ships)
                    # them per rectangle cell; _stats_host/_chi2_host
                    # mirror ops.stats op-for-op (engine_block contract)
                    fh = cat["f"]
                    hmaf1, hmaf2, D, Dp, r2 = _stats_host(fh)
                    chi2 = (_chi2_host(fh) if pars.extend_out
                            else np.zeros(len(fh), np.float32))
                    cols = dict(
                        r2p=cat["r2p"], D=D, Dp=Dp,
                        r2=r2, f=fh, hmaf1=hmaf1,
                        hmaf2=hmaf2,
                        chi2=chi2.astype(np.float32),
                        n_iter=cat["n_iter"].astype(np.int32),
                        n_used=(cat["n_used"].astype(np.int32)
                                if "n_used" in (cat.dtype.names or ())
                                else np.full(len(cat), pars.n_ind,
                                             np.int32)),
                        maf1=maf[af], maf2=maf[pf])
                    tiers = (np.zeros(len(cat), np.uint8) if no_refine
                             else degenerate_tiers(
                                 cat["f"], prec,
                                 extra_nonfinite=(Dp, r2)))
                    t1, t2 = tiers == 1, tiers == 2
                    if tiers.any():
                        # tier 1: bit-exact strict recompute; tier 2: f64
                        # re-derive of the stat columns from the raw
                        # frequencies (refine.derive_columns_f64); widen
                        # the chunk to f64 so one formatter call emits
                        # all populations
                        log.count("pairs_refined", int(t1.sum()))
                        log.count("pairs_rederived", int(t2.sum()))
                        for k in ("r2p", "D", "Dp", "r2", "f",
                                  "hmaf1", "hmaf2"):
                            cols[k] = np.array(cols[k], np.float64)
                        cols["maf1"] = cols["maf1"].copy()
                        cols["maf2"] = cols["maf2"].copy()
                        if t2.any():
                            from .refine import derive_columns_f64
                            pol = derive_columns_f64(cols["f"][t2])
                            for k in pol:
                                cols[k][t2] = pol[k]
                        if t1.any():
                            ref = get_refiner().refine_columns(af[t1],
                                                               pf[t1])
                            for k in cols:
                                cols[k][t1] = ref[k]
                    writer.write_block(
                        af, pf, dist, cols["r2p"], cols["D"], cols["Dp"],
                        cols["r2"], n_used=cols["n_used"],
                        maf1=cols["maf1"], maf2=cols["maf2"],
                        hap=cols["f"], hmaf1=cols["hmaf1"],
                        hmaf2=cols["hmaf2"], chi2=cols["chi2"],
                        n_iter=cols["n_iter"])
                    log.count("pairs_emitted", len(af))
        if refiner is not None:
            # sub-stage attribution of the strict-repair wall (same keys
            # as the block engine: read/prep/cache/gather/pearson/em/stats)
            for k, v in sorted(refiner.t.items()):
                log.count_time(f"emit: refine/{k}", v)
        log.summary()
    finally:
        if tmp_spill is not None:
            tmp_spill.cleanup()
        if profile_dir:
            jax.profiler.stop_trace()
