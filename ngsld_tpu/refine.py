"""Host-side strict (f64, reference-exact) repair of numerically fragile
results — the f32-hardening layer of the JAX engine.

Two failure modes of the fast device path are repaired here:

1. **Pair-set stability** (`knife_edge_sites` + `StrictRefiner.exact_maf`):
   the banded plan's `maf < min_maf` filter (ngsLD.cpp:264,270) consumes
   device-computed MAFs. In f32 mode a knife-edge site can round to the
   other side of min_maf than the reference's f64 value, silently
   adding/removing whole anchor bands. Sites within a tolerance of the
   threshold get their MAF recomputed with the bit-exact strict estimator
   (strict.est_maf_all), so the pair SET always matches the reference.

2. **Degenerate LD statistics** (`degenerate_mask` +
   `StrictRefiner.refine_columns`): Dp, r2 and chi2 divide by haplotype-
   frequency products that can be ~0 (monomorphic-ish sites, D ~ 0). A
   ~1e-6 EM wobble then moves the printed value arbitrarily (or flips
   inf/nan vs finite). Flagged pairs are recomputed end-to-end with the
   strict pipeline (read rows -> call_geno -> est_maf -> EM -> stats), so
   their emitted values are byte-exact with the reference's.

Only the NEEDED site rows are re-read from the GENO file (binary: direct
seeks; gz-text: one streaming parse keeping the wanted rows), so the cost
is O(flagged), not O(table).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from . import strict


def load_gl_rows(pars, sites: np.ndarray) -> np.ndarray:
    """(len(sites), n_ind, 3) f64 log-normalized GL rows for the given
    GLOBAL site indices — bit-identical to strict.read_geno(...)[sites].

    Binary input seeks straight to each record (read_data.cpp:28-47
    semantics per row); text input streams the native chunk parser (the
    same code path as ngsld_read_geno_text) once, keeping only the wanted
    rows. Falls back to a full strict.read_geno when neither fast path
    applies (native lib unavailable)."""
    sites = np.asarray(sites, np.int64)
    m = pars.n_ind
    if pars.in_bin:
        rec = m * 3
        out = np.empty((len(sites), m, 3), np.float64)
        with open(pars.in_geno, "rb") as fh:
            for j, s in enumerate(sites):
                fh.seek(int(s) * rec * 8)
                raw = np.fromfile(fh, np.float64, rec).reshape(m, 3)
                for i in range(m):
                    g = [float(raw[i, 0]), float(raw[i, 1]),
                         float(raw[i, 2])]
                    if not pars.in_logscale:
                        # conv_space(log) with -inf -> -INF clamp
                        # (read_data.cpp:38, gen_func.cpp:125-132)
                        g = [strict._NEG_INF_SENTINEL
                             if strict._libm_log1(v) == -math.inf
                             else strict._libm_log1(v) for v in g]
                    g = strict.post_prob3(g)
                    if any(math.isnan(v) for v in g):
                        raise strict.StrictError(
                            "read_geno",
                            "NaN found! Is the file format correct?")
                    out[j, i] = g
        return out

    use_native = os.environ.get("NGSLD_NO_NATIVE") != "1"
    if use_native:
        try:
            from .native import get_lib, parse_geno_text_native
            use_native = get_lib() is not None
        except Exception:
            use_native = False
    if not use_native:
        table = strict.read_geno(pars.in_geno, pars.in_bin, pars.in_probs,
                                 pars.in_logscale, m, pars.n_sites)
        return np.asarray(table, np.float64)[sites].copy()

    want = {}          # site -> ALL output slots (duplicates honored,
    for j, s in enumerate(sites):   # like the binary branch above)
        want.setdefault(int(s), []).append(j)
    out = np.empty((len(sites), m, 3), np.float64)
    found = 0
    n = pars.n_sites
    CHUNK = 16 << 20
    with strict.open_maybe_gz(pars.in_geno, "rb") as fh:
        carry = b""
        s = 0
        while found < len(sites):
            data = fh.read(CHUNK)
            eof = not data
            buf = carry + data
            if eof:
                if not buf:
                    break
                chunk, carry = buf + b"\n", b""
            else:
                cut = buf.rfind(b"\n")
                if cut < 0:
                    carry = buf
                    continue
                chunk, carry = buf[:cut + 1], buf[cut + 1:]
            if s >= n:
                break
            recs, _used = parse_geno_text_native(
                chunk, pars.in_probs, pars.in_logscale, m, s,
                min(chunk.count(b"\n"), n - s))
            for j in range(len(recs)):
                for k in want.get(s + j, ()):
                    out[k] = recs[j]
                    found += 1
            s += len(recs)
            if eof:
                break
    if found < len(sites):
        raise strict.StrictError(
            "read_geno", "GENO file at premature EOF. "
            "Check GENO file and number of sites!")
    return out


def read_binary_raw_rows(pars, sites: np.ndarray) -> np.ndarray:
    """RAW (un-normalized) f64 records for the given sites from a binary
    GENO file, as ONE vectorized gather through a memmap (shared by the
    fast loader and the native siteprep feeder). The r5 profile put the
    old per-site seek+fromfile Python loop at ~9 s per 100k flagged
    sites — page-cache reads dominated by interpreter overhead; the
    memmap fancy-index reads the same bytes in one numpy op."""
    sites = np.asarray(sites, np.int64)
    m = pars.n_ind
    mm = np.memmap(pars.in_geno, np.float64, mode="r",
                   shape=(pars.n_sites, m, 3))
    raw = np.array(mm[sites])   # materialize: callers mutate in place
    del mm
    return raw


def knife_edge_sites(maf: np.ndarray, min_maf: float, prec: str) -> np.ndarray:
    """Site indices whose device MAF is too close to min_maf to trust the
    `maf < min_maf` plan decision at the engine's precision.

    Tolerance derivation (pinned by
    tests/test_refine.py::test_knife_edge_tolerance_bounds_measured_f32_error):
    the closed-form MAF is mean(E[G])/2 with each f32 posterior carrying
    ~2^-24 relative error; XLA reduces the individual axis as a tree, so
    the mean accumulates O(log I) ulps, keeping the absolute error ~1e-6
    even at I = 5000 (measured worst case across depth/error regimes:
    < 1e-5). The f32 band of 1e-4 therefore bounds the real error with
    >= 10x margin — a site farther than tol from min_maf can never flip
    the plan decision (ngsLD.cpp:264,270) — while flagging only
    O(tol * n_sites) sites for the strict recompute. f64 analogously:
    ~2^-53 per-element error, 1e-11 band."""
    if min_maf <= 0:
        return np.empty(0, np.int64)
    tol = 1e-4 if prec == "f32" else 1e-11
    with np.errstate(invalid="ignore"):
        return np.flatnonzero(np.abs(maf - min_maf) <= tol)


def degenerate_tiers(f: np.ndarray, prec: str,
                     extra_nonfinite=()) -> np.ndarray:
    """Classify pairs by how numerically fragile their Dp/r2/chi2 are
    (reference formulas: ngsLD.cpp:295-349). Returns (P,) uint8:

    0 — healthy: the fast path's values are within the precision
        contract (~1e-12 f64 / ~1e-4 f32 of strict).

    Threshold derivation: both engines stop the EM at max-abs update
    < EPSILON = 1e-5 (gen_func.hpp:16), which makes ~1e-5 the f
    divergence floor between ANY two implementations (measured f32-vs-
    f64 converged |Δf| < 5e-5; pinned by tests/test_refine.py::
    test_tier2_band_bounds_measured_f32_em_wobble). Dp/r2 divide by
    denominator products of f-sums, so a denominator below ~1e-4 lets
    that wobble move the printed value by O(0.1+) — the tier-2 band.
    Denominators below ~1e-7 (or |D| within wobble of 0, whose sign
    picks the Dp branch) are indistinguishable from exact zero at the
    shared stop tolerance — strict's value there is inf/nan or branch-
    dependent, so only the bit-exact recompute reproduces it (tier 1).
    1 — exact-zero class: a denominator at (or within f64 wobble of)
        exactly 0, a D whose sign could flip branches, or nonfinite
        output. Strict's value is inf/nan or branch-dependent, so these
        get the full bit-exact strict recompute in BOTH precisions.
    2 — f32-garbage class (flagged only when prec == 'f32'): the
        denominator is small enough (< ~1e-3) that the f32 DERIVE's
        rounding (D = f0*f3 - f1*f2 at ~1e-8 absolute) moves Dp/r2
        visibly. Re-deriving the VALUE columns in f64 from the raw f32
        frequencies (derive_columns_f64) repairs it; no EM re-run, no
        file reads, no strict recompute.

    f: (P, 4) haplotype frequencies (any float dtype); extra_nonfinite:
    already-derived stat columns — nonfinite values there force tier 1.
    """
    fa = np.asarray(f)
    if fa.ndim == 2 and fa.dtype in (np.float32, np.float64):
        try:  # native mirror: same f64 ops/order, ~40x on the hot chunks
            from .native import tier_scan_native
            res = tier_scan_native(fa, prec == "f32")
        except ImportError:
            res = None
        if res is not None:
            tier, _ = res
            for col in extra_nonfinite:
                tier[~np.isfinite(np.asarray(col, np.float64))] = 1
            return tier
    f = np.asarray(f, np.float64)
    with np.errstate(all="ignore"):
        maf0 = 1.0 - (f[:, 0] + f[:, 1])
        maf1 = 1.0 - (f[:, 0] + f[:, 2])
        D = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]
        neg = -np.minimum(maf0 * maf1, (1 - maf0) * (1 - maf1))
        pos = np.minimum(maf0 * (1 - maf1), (1 - maf0) * maf1)
        den_dp = np.where(D < 0, neg, pos)
        den_r2 = maf0 * maf1 * (1 - maf0) * (1 - maf1)
        tier = np.zeros(len(f), np.uint8)
        nonfin = ~np.isfinite(f).all(axis=1)
        for col in extra_nonfinite:
            nonfin |= ~np.isfinite(np.asarray(col, np.float64))
        if prec == "f32":
            # f32-garbage band: Dp/r2/chi2 re-derive in f64 from the
            # engine's RAW converged f32 frequencies (derive_columns_f64)
            # — the f32 DERIVE's catastrophic cancellation (D rounds at
            # ~1e-8 absolute; /den amplifies) is the repairable error,
            # while the frequencies themselves park at the same shared
            # 1e-5 stop point as any f64 run. Measured vs strict
            # (tests/test_refine.py::test_derive_only_band_bound):
            # |dDp| ~ 6e-7/den — orders under the old warm-started f64
            # polish re-RUN, which marched past the stop point on slow
            # trajectories (|dDp| up to 0.5; removed round 4). The band
            # extends to 1e-3 where the fuzz comparator's fragile cutoff
            # sits, so every denominator range is either repaired or
            # asserted.
            tier[(np.abs(den_dp) < 1e-3) | (np.abs(den_r2) < 1e-6)
                 | (np.abs(D) < 2e-6)] = 2
        # exact-zero class, BOTH precisions: strict's value is inf/nan or
        # branch-dependent — only the bit-exact recompute matches it.
        # D == 0 with a healthy denominator is a STABLE 0.000000
        # everywhere and stays fast. A hap-MAF factor within f32-EM
        # wobble (~1e-4, test_tier2_band_bounds_measured_f32_em_wobble)
        # of a simplex BOUNDARY is also exact-zero class: the factor's
        # SIGN is stop-point-dependent, so den_r2 can land negative here
        # and positive in strict (or vice versa) — sqrt flips between
        # NaN and finite, which no value repair can reproduce (r4 fuzz
        # seed 103: m1 = -1.2e-7 -> -nan r2 vs strict's 0.000000).
        mn = np.minimum(np.minimum(np.abs(maf0), np.abs(maf1)),
                        np.minimum(np.abs(1 - maf0), np.abs(1 - maf1)))
        tier[(np.abs(den_dp) < 1e-7) | (np.abs(den_r2) < 1e-13)
             | (mn < 1e-4) | nonfin] = 1
    return tier


def degenerate_mask(f: np.ndarray, prec: str = "f64",
                    extra_nonfinite=()) -> np.ndarray:
    """Any-tier flag (see degenerate_tiers)."""
    return degenerate_tiers(f, prec, extra_nonfinite) > 0


def derive_columns_f64(f_raw) -> dict:
    """f64 VALUE repair for tier-2 pairs: re-derive the f-dependent
    columns (D/D'/r2/hap-MAFs/chi2, ngsLD.cpp:295-349) in f64 from the
    engine's RAW converged f32 frequencies. No EM re-run: the f32
    trajectory parks at the same shared 1e-5 stop point as a cold f64
    run, so the frequencies are already within f32 quantization (~6e-8
    relative) of strict's — the repairable error is the f32 DERIVE's
    catastrophic cancellation (D = f0*f3 - f1*f2 rounds at ~1e-8
    absolute, then divides by a ~0 denominator). Measured vs strict:
    |dDp| ~ 6e-7/den across the whole tier-2 band, where the previous
    warm-started f64 EM polish reached 0.5 (it marched past the stop
    point on slowly-decaying trajectories — an EM *re-run*, not a
    repair; removed round 4, tests/test_refine.py::
    test_derive_only_band_bound pins the comparison)."""
    f = np.asarray(f_raw, np.float64)
    hmaf0, hmaf1, D, Dp, r2 = strict.ld_stats_batch(f)
    chi2 = strict.chi2_batch(f)
    return dict(f=f, hmaf1=hmaf0, hmaf2=hmaf1, D=D, Dp=Dp, r2=r2,
                chi2=chi2)


class StrictRefiner:
    """Recompute flagged sites/pairs with the strict pipeline; caches the
    per-site state (rows, called genotypes, MAF, E[G]) so repeated blocks
    touching the same fragile sites pay the file read once."""

    def __init__(self, pars):
        self.pars = pars
        # contiguous caches + site->row map: refine_columns gathers whole
        # pair batches with ONE fancy-index per array instead of 2k+
        # per-site np.stack items (the r5 profile measured the stacked
        # dict layout at ~1.7 s per 50k-pair batch, per array)
        # site -> cache row as a flat int32 lookup (-1 = absent): the
        # membership test, the insert and the pair->row gather are all
        # single vectorized numpy ops. The previous dict[site] layout plus
        # concatenate-per-batch growth cost 12-15 s of the 1M sampled
        # leg's refine wall (r5 probe) — Python-loop inserts and O(N^2)
        # recopies on the fmt thread of a 1-core host.
        self._idx_arr = np.full(pars.n_sites, -1, np.int32)
        # capacity-doubling row buffers: appending a batch is O(batch)
        # amortized
        self._n = 0
        self._cap = 0
        self._gn = np.empty((0, pars.n_ind, 3), np.float64)
        self._eg = np.empty((0, pars.n_ind), np.float64)
        self._maf_arr = np.empty(0, np.float64)
        # wall-seconds by sub-stage (read/prep/gather/pearson/em/stats) —
        # surfaced as `sweep: fmt/refine/<k>` in --verbose timings so e2e
        # artifacts attribute the refine wall (the top CPU stage on every
        # leg) without a profiler run
        self.t = {}

    def _tick(self, key, t0) -> float:
        now = time.perf_counter()
        self.t[key] = self.t.get(key, 0.0) + (now - t0)
        return now

    def _ensure(self, sites) -> None:
        uniq = np.unique(np.asarray(sites, np.int64))
        arr = uniq[self._idx_arr[uniq] < 0]
        if not len(arr):
            return
        # native fast path: raw rows + the whole strict site pipeline
        # (post_prob/call_geno/est_maf/E[G]) in C, bit-identical to the
        # Python strict path (ngsld_strict_siteprep)
        done = False
        t0 = time.perf_counter()
        if os.environ.get("NGSLD_NO_NATIVE") != "1":
            try:
                from .native import strict_siteprep_native
                raw, text_norm = self._read_raw_rows(arr)
                t0 = self._tick("read", t0)
                if raw is not None:
                    out = strict_siteprep_native(
                        raw, self.pars.in_logscale, text_norm,
                        self.pars.call_geno, self.pars.N_thresh,
                        self.pars.call_thresh, self.pars.ignore_miss_data)
                    if out is not None:
                        gn, maf, eg = out
                        done = True
            except ImportError:
                pass
        if not done:
            rows = load_gl_rows(self.pars, arr)
            t0 = self._tick("read", t0)
            if self.pars.call_geno:
                strict.call_geno_inplace(rows, self.pars.N_thresh,
                                         self.pars.call_thresh)
            maf = strict.est_maf_all(rows, self.pars.ignore_miss_data)
            gn = strict.libm_exp(rows)
            eg = gn[:, :, 1] + 2 * gn[:, :, 2]
        t0 = self._tick("prep", t0)
        base = self._n
        need = base + len(arr)
        if need > self._cap:
            cap = max(need, 2 * self._cap, 4096)
            I = self.pars.n_ind
            for name, shape in (("_gn", (cap, I, 3)), ("_eg", (cap, I)),
                                ("_maf_arr", (cap,))):
                buf = np.empty(shape, np.float64)
                buf[:base] = getattr(self, name)[:base]
                setattr(self, name, buf)
            self._cap = cap
        self._gn[base:need] = gn
        self._eg[base:need] = eg
        self._maf_arr[base:need] = np.asarray(maf, np.float64)
        self._n = need
        self._idx_arr[arr] = np.arange(base, need, dtype=np.int32)
        self._tick("cache", t0)

    def _rows(self, sites) -> np.ndarray:
        return self._idx_arr[np.asarray(sites, np.int64)].astype(np.int64)

    def _read_raw_rows(self, sites):
        """(rows, text_norm) for the native siteprep: binary input reads
        RAW records via seeks (C applies log/post_prob); text input uses
        the native chunk parser (rows arrive log-normalized). (None,
        False) when no fast source applies."""
        pars = self.pars
        if pars.in_bin:
            return read_binary_raw_rows(pars, sites), False
        try:
            from .native import get_lib
            if get_lib() is None:
                return None, False
        except Exception:
            return None, False
        return load_gl_rows(pars, sites), True   # native text parse

    def exact_maf(self, sites) -> np.ndarray:
        """Strict (bit-exact) MAF for the given global site indices."""
        self._ensure(sites)
        return self._maf_arr[self._rows(sites)]

    def refine_columns(self, s1, s2) -> dict:
        """Strict end-to-end values for the given pairs. Returns f64 (and
        int64/float32 where the contract says so) columns keyed like the
        ring spill: r2p f n_iter n_used maf1 maf2 hmaf1 hmaf2 D Dp r2
        chi2 — each byte-exact with what `--engine strict` would print."""
        s1 = np.asarray(s1, np.int64)
        s2 = np.asarray(s2, np.int64)
        self._ensure(np.concatenate([s1, s2]))
        t0 = time.perf_counter()
        i1, i2 = self._rows(s1), self._rows(s2)
        gn1, gn2 = self._gn[i1], self._gn[i2]
        eg1, eg2 = self._eg[i1], self._eg[i2]
        maf1, maf2 = self._maf_arr[i1], self._maf_arr[i2]
        t0 = self._tick("gather", t0)
        r2p = strict.pearson_r2_batch(eg1, eg2)
        t0 = self._tick("pearson", t0)
        em = None
        if os.environ.get("NGSLD_NO_NATIVE") != "1":
            try:
                from .native import strict_pair_em_native
                em = strict_pair_em_native(gn1, gn2, maf1, maf2,
                                           self.pars.ignore_miss_data)
            except ImportError:
                em = None
        if em is None:
            em = strict.pair_em_batch(gn1, gn2, maf1, maf2,
                                      self.pars.ignore_miss_data)
        f, n_iter, n_used = em
        t0 = self._tick("em", t0)
        hmaf0, hmaf1, D, Dp, r2 = strict.ld_stats_batch(f)
        chi2 = strict.chi2_batch(f)
        self._tick("stats", t0)
        return dict(r2p=r2p, f=f, n_iter=n_iter, n_used=n_used,
                    maf1=maf1, maf2=maf2, hmaf1=hmaf0, hmaf2=hmaf1,
                    D=D, Dp=Dp, r2=r2, chi2=chi2)

