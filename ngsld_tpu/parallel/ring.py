"""Ring banded sweep: LD over a SITE-SHARDED genotype table.

The replicated-table path (engine --shard / parallel.sweep) assumes the GL
table fits on every device. At reference scale that fails: 5M sites x 500
individuals is ~30 GB fp32 (SURVEY.md §7 "Memory at the 5M×500 config"),
so the table must stay sharded by site-block. The banded pair space then
needs pairs (a, b) whose blocks live on DIFFERENT devices — the
"cross-block halo exchange" of SURVEY.md §2.

This module implements the device pattern for that exchange: a ring
pass of partner blocks over the mesh (ring-attention topology without the
softmax state — pair results are independent, ngsLD's band is a banded
attention mask over the SNP sequence). At ring step t each device holds

  * its resident anchor block  i = axis_index('sites')
  * a visiting partner block   j = (i + t) mod n_blocks

received via jax.lax.ppermute from its ring neighbor, and computes the full
(B x B) tile of pair statistics between them. Sites are block-cyclic: with
a banded plan (max_kb_dist / max_snp_dist) only the first few ring steps
carry in-band pairs, so `n_steps` is set from the band width and the ring
terminates early — communication volume is O(band), not O(n_sites).

Semantics per pair match ops.em.pair_em / ops.stats exactly (same jnp
code); band and MAF filtering are per-pair masks the caller applies to the
returned tiles (the reference's break-vs-skip distinction collapses to a
mask over an precomputed band, plan/band.py).

Reference mapping: replaces the shared-memory assumption of the pthread
pool (ngsLD.cpp:159-186) where every thread reads the whole GL matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops.em import pair_em
from ..ops.preprocess import miss_mask
from ..ops.stats import chi2_stat, ld_stats, pearson_r2


def _tile_stats_fn(ignore_miss_data: bool, extend_out: bool, row_chunk: int,
                   slim: bool = False):
    """All B_a x B_b pair statistics between an anchor and a partner block
    (shared by the all-steps ring_sweep and the one-step stepper).

    slim=True returns only (r2p, f, n_iter, n_used) — the compacted
    steppers derive D/D'/r2/hap-MAFs/chi2 on the HOST at merge time
    (engine_block._stats_host mirrors ops.stats.ld_stats op-for-op in the
    same dtype), so computing them per rectangle cell here would be pure
    waste."""

    def tile_stats(gn_a, eg_a, maf_a, gn_b, eg_b, maf_b, live=None):
        Ba = gn_a.shape[0]

        def strip(args):
            if live is None:
                (g1, e1, m1), lv = args, None
            else:
                g1, e1, m1, lv = args   # lv: this anchor's live lanes
            gn1 = jnp.broadcast_to(g1[None], gn_b.shape)
            eg1 = jnp.broadcast_to(e1[None], eg_b.shape)
            maf1 = jnp.broadcast_to(m1[None], maf_b.shape)
            f, n_iter, n_used = pair_em(gn1, gn_b, maf1, maf_b,
                                        ignore_miss_data, live=lv)
            r2p = pearson_r2(eg1, eg_b)
            if slim:
                return dict(r2p=r2p, f=f, n_iter=n_iter, n_used=n_used)
            hmaf0, hmaf1, D, Dp, r2 = ld_stats(f)
            chi2 = (chi2_stat(f) if extend_out
                    else jnp.zeros_like(r2p, jnp.float32))
            return dict(r2p=r2p, f=f, n_iter=n_iter, n_used=n_used,
                        hmaf1=hmaf0, hmaf2=hmaf1, D=D, Dp=Dp, r2=r2,
                        chi2=chi2)

        xs = (gn_a, eg_a, maf_a) if live is None \
            else (gn_a, eg_a, maf_a, live)
        # default (row_chunk=0): ONE flat vmapped batch, as documented;
        # row_chunk > 0 bounds peak memory by vmapping row_chunk anchor
        # strips per scan step (lax.map with no batch_size would scan
        # one anchor at a time — the slowest possible schedule)
        bs = min(row_chunk, Ba) if row_chunk else Ba
        return jax.lax.map(strip, xs, batch_size=bs)

    return tile_stats


_STAT_KEYS = ("r2p", "f", "n_iter", "n_used", "hmaf1", "hmaf2",
              "D", "Dp", "r2", "chi2")


def _unpack_bits(words, area: int):
    """(ceil(area/32),) u32 -> (area,) bool, little-endian bit order —
    the exact inverse of the host packing (np.packbits bitorder='little'
    viewed as LE uint32)."""
    b = ((words[:, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1) != 0
    return b.reshape(-1)[:area]


def _tile_mask(i, t, si, cfg, hi_loc, ok_loc, vok, bits):
    """The emission mask of one (B, B_sub) step tile, on device: strict
    upper triangle, real sites, MAF-ok anchor AND partner, band limit,
    optional --rnd_sample membership via the packed `bits` plane. Built
    entirely from per-device data that already rides the ring; mirrors
    engine_ring.host_mask cell for cell (the host replays it for the
    (a, pj) labels)."""
    B, B_sub, n, n_dev = cfg["B"], cfg["B_sub"], cfg["n"], cfg["n_dev"]
    a_loc = jnp.arange(B, dtype=jnp.int32)
    A = (i.astype(jnp.int32) * B + a_loc)[:, None]              # (B, 1)
    org = ((i + t) % n_dev).astype(jnp.int32) * B + si * B_sub
    PJ = org + jnp.arange(B_sub, dtype=jnp.int32)[None, :]      # (1, Bs)
    valid = (PJ > A) & (PJ < n) & (A < n)
    valid &= (ok_loc[:, None] > 0.0) & (vok[None, :] > 0.0)
    valid &= PJ < hi_loc[:, None]
    if cfg["sample"]:
        valid &= _unpack_bits(bits, B * B_sub).reshape(B, B_sub)
    return valid


def _device_compact(r2p, f, nit, nu, valid, cfg):
    """Device-side row compaction of one (B, B_sub) step tile by its
    emission mask (_tile_mask): gathers the surviving cells in row-major
    (a, pj) order and returns (fm (CAP, 5), im, cnt) with CAP = B*B_sub —
    only [:cnt] rows ever leave the device, so copied bytes scale with
    LIVE pairs like the block engine's (engine_block), not with
    rectangle area. `cnt` cross-checks the host's mask replay.

    Replaces the full-tile pull + host compact_tile of rounds 1-3: at the
    old 10-stat layout that pull cost ~52 B per rectangle CELL; this path
    costs 21-24 B per live pair (plus 0.125 B/cell of sampling bits when
    --rnd_sample is active)."""
    B, B_sub = cfg["B"], cfg["B_sub"]
    vf = valid.reshape(-1)
    cnt = jnp.sum(vf, dtype=jnp.int32)
    idx = jnp.flatnonzero(vf, size=B * B_sub, fill_value=0)
    fm = jnp.concatenate([r2p.reshape(-1)[idx][:, None],
                          f.reshape(-1, 4)[idx]], axis=1)
    nit_c = nit.reshape(-1)[idx]
    if cfg["slim_im"]:
        # --ignore_miss_data off: n_used is the constant n_ind (host
        # synthesizes it) and n_iter <= ITER_MAX == 100 fits int8
        im = nit_c.astype(jnp.int8)[:, None]
    else:
        idt = jnp.int16 if cfg["use_i16"] else jnp.int32
        im = jnp.stack([nit_c.astype(idt),
                        nu.reshape(-1)[idx].astype(idt)], axis=1)
    return fm, im, cnt


def _tile_stats_ind_fn(ignore_miss_data: bool, extend_out: bool,
                       row_chunk: int, slim: bool = False):
    """2-D ('sites', 'ind') variant of _tile_stats_fn: each device holds
    only its individual SLICE of both blocks; every per-individual
    reduction (EM numerators/denominators, Pearson moments, n_used)
    psums over the 'ind' axis (parallel.sweep's shard bodies).
    slim: as in _tile_stats_fn."""
    from .sweep import _pair_em_shard, _pearson_shard

    def tile_stats(gn_a, eg_a, maf_a, gn_b, eg_b, maf_b, live=None):
        Ba = gn_a.shape[0]

        def strip(args):
            if live is None:
                (g1, e1, m1), lv = args, None
            else:
                g1, e1, m1, lv = args   # lv: this anchor's live lanes
            gn1 = jnp.broadcast_to(g1[None], gn_b.shape)
            eg1 = jnp.broadcast_to(e1[None], eg_b.shape)
            maf1 = jnp.broadcast_to(m1[None], maf_b.shape)
            f0 = jnp.stack([(1 - maf1) * (1 - maf_b), (1 - maf1) * maf_b,
                            maf1 * (1 - maf_b), maf1 * maf_b],
                           axis=1).astype(gn1.dtype)
            if ignore_miss_data:
                include = ~(miss_mask(gn1) | miss_mask(gn_b))
            else:
                include = jnp.ones(gn1.shape[:2], bool)
            n_used = jax.lax.psum(jnp.sum(include, axis=1),
                                  "ind").astype(jnp.int32)
            f, n_iter = _pair_em_shard(gn1, gn_b, f0, include, n_used,
                                       live=lv)
            n_tot = jax.lax.psum(
                jnp.full(gn1.shape[0], gn1.shape[1], jnp.int32), "ind")
            r2p = _pearson_shard(eg1, eg_b, n_tot)
            if slim:
                return dict(r2p=r2p, f=f, n_iter=n_iter, n_used=n_used)
            hmaf0, hmaf1, D, Dp, r2 = ld_stats(f)
            chi2 = (chi2_stat(f) if extend_out
                    else jnp.zeros_like(r2p, jnp.float32))
            return dict(r2p=r2p, f=f, n_iter=n_iter, n_used=n_used,
                        hmaf1=hmaf0, hmaf2=hmaf1, D=D, Dp=Dp, r2=r2,
                        chi2=chi2)

        xs = (gn_a, eg_a, maf_a) if live is None \
            else (gn_a, eg_a, maf_a, live)
        bs = min(row_chunk, Ba) if row_chunk else Ba
        return jax.lax.map(strip, xs, batch_size=bs)

    return tile_stats


def ring_sweep_stepper_ind(mesh, ignore_miss_data: bool = False,
                           extend_out: bool = True, row_chunk: int = 0,
                           compact_cfg: dict | None = None):
    """Ring stepper over a 2-D ('sites', 'ind') mesh: the GL/E[G] tables
    shard over BOTH the site-block axis and the individual axis (very
    large cohorts whose blocks exceed one device even site-sharded). The
    visiting blocks ride the 'sites' ring exactly as in
    ring_sweep_stepper — the ppermute acts within each 'ind' column —
    while the per-individual reductions psum over 'ind'. Stats are
    replicated along 'ind' (every shard applies the identical EM update
    after the psum), so emission is unchanged.

    compact_cfg: same contract change as ring_sweep_stepper; the
    compacted (fm, im, cnt) outputs stay replicated along 'ind' and the
    engine pulls from each mesh row's first device."""
    n_dev = mesh.shape["sites"]
    perm = [(k, (k - 1) % n_dev) for k in range(n_dev)]
    tile_stats = _tile_stats_ind_fn(ignore_miss_data, extend_out,
                                    row_chunk,
                                    slim=compact_cfg is not None)
    spec3 = P("sites", "ind", None)
    espec = P("sites", "ind")

    if compact_cfg is not None:
        def local_c(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si,
                    bits=None):
            idx = jax.lax.axis_index("sites")
            valid = _tile_mask(idx, t, si, compact_cfg, hi_g, ok_g, vok,
                               bits[0] if bits is not None else None)
            out = tile_stats(gn, eg, maf, vgn, veg, vmaf, live=valid)
            fm, im, cnt = _device_compact(
                out["r2p"], out["f"], out["n_iter"], out["n_used"],
                valid, compact_cfg)
            nxt = tuple(jax.lax.ppermute(v, "sites", perm)
                        for v in (vgn, veg, vmaf, vok))
            return (fm[None], im[None], cnt[None]), *nxt

        in_specs = [spec3, espec, P("sites"),
                    P("sites"), P("sites"),
                    spec3, espec, P("sites"), P("sites"),
                    P(), P()]
        if compact_cfg["sample"]:
            in_specs.append(P("sites", None))
        mapped = shard_map(
            local_c, mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=((P("sites", None, None), P("sites", None, None),
                        P("sites")),
                       spec3, espec, P("sites"), P("sites")),
            check_vma=False)
        return jax.jit(mapped)

    def local(gn, eg, maf, vgn, veg, vmaf):
        out = tile_stats(gn, eg, maf, vgn, veg, vmaf)
        nxt = tuple(jax.lax.ppermute(v, "sites", perm)
                    for v in (vgn, veg, vmaf))
        return out, *nxt

    out_stats = {k: (P("sites", None, None) if k == "f"
                     else P("sites", None)) for k in _STAT_KEYS}
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(spec3, espec, P("sites"),
                  spec3, espec, P("sites")),
        out_specs=(out_stats, spec3, espec, P("sites")),
        check_vma=False)
    return jax.jit(mapped)


def ring_subblock_taker_ind(mesh, n_sub: int, si: int, offset: int = 0,
                            with_ok: bool = False):
    """2-D-mesh analogue of ring_subblock_taker (tables sharded over
    ('sites', 'ind'))."""
    n_dev = mesh.shape["sites"]
    perm = [(k, (k - offset) % n_dev) for k in range(n_dev)]

    def local(gn, eg, maf, ok=None):
        B_sub = gn.shape[0] // n_sub
        lo = si * B_sub
        out = (gn[lo:lo + B_sub], eg[lo:lo + B_sub], maf[lo:lo + B_sub])
        if ok is not None:
            out = out + (ok[lo:lo + B_sub],)
        if offset % n_dev:
            out = tuple(jax.lax.ppermute(v, "sites", perm) for v in out)
        return out

    spec3 = P("sites", "ind", None)
    espec = P("sites", "ind")
    specs = (spec3, espec, P("sites"))
    if with_ok:
        specs = specs + (P("sites"),)
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=specs, out_specs=specs, check_vma=False)
    return jax.jit(mapped)


def ring_sweep_stepper(mesh, ignore_miss_data: bool = False,
                       extend_out: bool = True, row_chunk: int = 0,
                       compact_cfg: dict | None = None):
    """One-ring-step variant of ring_sweep for streaming drivers: the
    visiting block triple is carried explicitly, so the host can pull and
    emit each step's (S, B) stat tile before computing the next — peak
    memory is O(S*B), not O(n_steps*S*B).

    Returns fn(gn, eg, maf, vgn, veg, vmaf) -> (stats_dict, vgn', veg',
    vmaf') where the primed arrays are the visiting blocks advanced one
    ring position (initialize the triple with the resident arrays).

    compact_cfg (see _device_compact) changes the contract to
    fn(gn, eg, maf, hi, ok, vgn, veg, vmaf, vok, t, si[, bits]) ->
    ((fm, im, cnt), vgn', veg', vmaf', vok'): the band/ok vectors join
    the inputs (the visiting ok RIDES THE RING — it must be the host's
    knife-edge-refined ok, not derivable from vmaf on device), derived
    stats are skipped entirely (merge-time host derive), and each
    device's tile leaves compacted to its live rows."""
    n_dev = mesh.shape["sites"]
    perm = [(k, (k - 1) % n_dev) for k in range(n_dev)]
    tile_stats = _tile_stats_fn(ignore_miss_data, extend_out, row_chunk,
                                slim=compact_cfg is not None)
    spec3 = P("sites", None, None)

    if compact_cfg is not None:
        def local_c(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si,
                    bits=None):
            idx = jax.lax.axis_index("sites")
            valid = _tile_mask(idx, t, si, compact_cfg, hi_g, ok_g, vok,
                               bits[0] if bits is not None else None)
            # the mask also seeds pair_em's active set: dead rectangle
            # lanes freeze at iteration 0 instead of gating their whole
            # vmapped batch with discarded trajectories
            out = tile_stats(gn, eg, maf, vgn, veg, vmaf, live=valid)
            fm, im, cnt = _device_compact(
                out["r2p"], out["f"], out["n_iter"], out["n_used"],
                valid, compact_cfg)
            nxt = tuple(jax.lax.ppermute(v, "sites", perm)
                        for v in (vgn, veg, vmaf, vok))
            return (fm[None], im[None], cnt[None]), *nxt

        in_specs = [spec3, P("sites", None), P("sites"),
                    P("sites"), P("sites"),
                    spec3, P("sites", None), P("sites"), P("sites"),
                    P(), P()]
        if compact_cfg["sample"]:
            in_specs.append(P("sites", None))
        mapped = shard_map(
            local_c, mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=((P("sites", None, None), P("sites", None, None),
                        P("sites")),
                       spec3, P("sites", None), P("sites"), P("sites")),
            check_vma=False)
        return jax.jit(mapped)

    def local(gn, eg, maf, vgn, veg, vmaf):
        out = tile_stats(gn, eg, maf, vgn, veg, vmaf)
        nxt = tuple(jax.lax.ppermute(v, "sites", perm)
                    for v in (vgn, veg, vmaf))
        return out, *nxt

    out_stats = {k: (P("sites", None, None) if k == "f"
                     else P("sites", None)) for k in _STAT_KEYS}
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(spec3, P("sites", None), P("sites"),
                  spec3, P("sites", None), P("sites")),
        out_specs=(out_stats, spec3, P("sites", None), P("sites")),
        check_vma=False)
    return jax.jit(mapped)


def ring_subblock_taker(mesh, n_sub: int, si: int, offset: int = 0,
                        with_ok: bool = False):
    """jitted fn(gn, eg, maf) -> (vgn, veg, vmaf): the si-th of n_sub
    equal sub-blocks of every device's resident rows, as 'sites'-sharded
    arrays of global length S/n_sub. Seeds a sub-block ring: rotating
    B_sub-row sub-blocks instead of whole device blocks bounds the per-step
    tile to (B, B_sub) — at pod scale a full (B, B) tile of stats would
    not fit device memory, and banded sweeps waste less out-of-band work.

    offset > 0 fast-forwards the ring: device i receives the sub-block of
    device (i + offset) mod n_dev in a single ppermute, exactly the state
    the one-step stepper reaches after `offset` rotations — used by
    checkpoint resume to skip already-emitted ring steps without replaying
    their compute.

    with_ok=True adds a fourth (S,) array (the MAF-ok plane) to both the
    inputs and the visiting state — the compacted steppers mask partner
    cells with the HOST's knife-edge-refined ok, which is not derivable
    from vmaf on device."""
    n_dev = mesh.shape["sites"]
    perm = [(k, (k - offset) % n_dev) for k in range(n_dev)]

    def local(gn, eg, maf, ok=None):
        B_sub = gn.shape[0] // n_sub
        lo = si * B_sub
        out = (gn[lo:lo + B_sub], eg[lo:lo + B_sub], maf[lo:lo + B_sub])
        if ok is not None:
            out = out + (ok[lo:lo + B_sub],)
        if offset % n_dev:
            out = tuple(jax.lax.ppermute(v, "sites", perm) for v in out)
        return out

    spec3 = P("sites", None, None)
    specs = (spec3, P("sites", None), P("sites"))
    if with_ok:
        specs = specs + (P("sites"),)
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=specs, out_specs=specs, check_vma=False)
    return jax.jit(mapped)


def ring_sweep(mesh, n_steps: int, ignore_miss_data: bool = False,
               extend_out: bool = True, row_chunk: int = 0):
    """Build the jitted ring sweep over mesh axis 'sites'.

    Returns fn(gn, eg, maf) where gn (S, I, 3), eg (S, I), maf (S,) are
    sharded over 'sites' into n_devices blocks of B = S / n_devices rows.

    Output: a dict of arrays of shape (n_steps, S, B) (hap 'f' adds a
    trailing 4): entry [t, a, o] is the statistic for the pair
    (site a, site partner_index(t, a, o)); see `partner_index`. Pairs where
    partner <= a at t == 0 duplicate the symmetric triangle; callers mask
    them along with out-of-band pairs.

    row_chunk > 0 bounds peak memory: each anchor-row strip of the (B x B)
    tile is computed in sequence via lax.map instead of one flat batch.
    """
    n_dev = mesh.shape["sites"]
    perm = [(k, (k - 1) % n_dev) for k in range(n_dev)]  # j-blocks ride up
    tile_stats = _tile_stats_fn(ignore_miss_data, extend_out, row_chunk)

    def local(gn, eg, maf):
        # resident anchor block stays; partner copies ride the ring
        vis = (gn, eg, maf)
        outs = []
        for t in range(n_steps):
            outs.append(tile_stats(gn, eg, maf, *vis))
            if t + 1 < n_steps:
                vis = tuple(jax.lax.ppermute(v, "sites", perm) for v in vis)
        return {k: jnp.stack([o[k] for o in outs], axis=0) for k in outs[0]}

    spec3 = P("sites", None, None)
    out_specs = {k: (P(None, "sites", None, None) if k == "f"
                     else P(None, "sites", None))
                 for k in _STAT_KEYS}
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(spec3, P("sites", None), P("sites")),
        out_specs=out_specs, check_vma=False)
    return jax.jit(mapped)


def partner_index(t: int, a, block_size: int, n_sites: int):
    """Global site index of out[t, a, o]'s partner for o in [0, B): the
    sites of block (block(a) + t) mod n_blocks."""
    import numpy as np
    blk = (a // block_size + t) % (n_sites // block_size)
    return blk * block_size + np.arange(block_size)


def steps_for_band(hi, block_size: int) -> int:
    """Ring steps needed so every in-band pair (s1, s2 < hi[s1]) is covered:
    1 + max blocks spanned by any anchor's band."""
    import numpy as np
    n = len(hi)
    a = np.arange(n)
    span = np.maximum(hi - 1, a) // block_size - a // block_size
    return int(span.max()) + 1 if n else 1
