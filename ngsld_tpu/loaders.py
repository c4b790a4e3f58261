"""Host->device input loaders for the JAX engines.

Three streaming paths (all with exact reference read semantics,
read_data.cpp:13-116):
  * _StreamedGLLoader    — binary doubles, slab reader + uploader threads
  * _StreamedTextLoader  — gz text via the native chunk parser
  * _ring_sharded_tables — site-sharded per-device load for --ring
"""

from __future__ import annotations

import os

import numpy as np

from . import strict


class _StreamedGLLoader:
    """Binary GL fast path: np.fromfile slabs in a reader thread, device_put
    slabs in an uploader thread, one device-side concatenate at join().

    Replaces read -> f64 normalize -> f32 narrow -> monolithic upload (three
    serial full-data passes) with a read/upload pipeline; normalization moves
    into the device preprocess (ops.preprocess raw=True). Only used when the
    file size matches exactly (ngsLD.cpp:55 semantics) — anything else falls
    back to strict.read_geno, which raises the reference's exact errors.

    NaN parity: the reference errors on NaN after post_prob
    (read_data.cpp:44-45). Raw NaN inputs are checked per slab; all-(-inf)
    log-scale records (which post_prob turns into NaN) are too.
    """

    SLAB_BYTES = 256 << 20

    @staticmethod
    def applicable(pars) -> bool:
        if not pars.in_bin or os.environ.get("NGSLD_NO_FASTBIN") == "1":
            return False
        try:
            size = os.path.getsize(pars.in_geno)
        except OSError:
            return False
        return size == pars.n_sites * pars.n_ind * 3 * 8

    def __init__(self, pars, np_dtype, stream_np=False):
        import queue
        import threading
        self._pars = pars
        self._dt = np_dtype
        self._q = queue.Queue(maxsize=2)
        self._slabs = []
        self._err = []
        self._reader = threading.Thread(
            target=self._read, daemon=True, name="ngsld-gl-read")
        self._reader.start()
        self._uploader = None
        if not stream_np:
            self._uploader = threading.Thread(
                target=self._upload, daemon=True, name="ngsld-gl-upload")
            self._uploader.start()

    def _read(self):
        p = self._pars
        n, m = p.n_sites, p.n_ind
        # NGSLD_SLAB_BYTES: test/tuning override (small values force the
        # multi-slab paths — overlap ingest coverage gating — on tiny
        # fixtures)
        slab_bytes = int(os.environ.get("NGSLD_SLAB_BYTES",
                                        self.SLAB_BYTES))
        slab_sites = max(1, slab_bytes // (m * 3 * 8))
        try:
            with open(p.in_geno, "rb") as fh:
                s = 0
                while s < n:
                    k = min(slab_sites, n - s)
                    a = np.fromfile(fh, dtype=np.float64,
                                    count=k * m * 3).reshape(k, m, 3)
                    a = a.astype(self._dt, copy=False)
                    # NaN parity checks on the NARROWED slab (half the
                    # bytes), mirroring the reference's NaN-after-post_prob
                    # error (read_data.cpp:42-45): raw NaN; +inf anywhere
                    # (inf - inf in the normalize); log-scale all-(-inf)
                    # records (-inf - -inf); linear-scale negatives (log ->
                    # NaN). Linear zeros are FINE: conv_space clamps the
                    # -inf to a finite -INF (gen_func.cpp:127-128). The one
                    # deviation: a finite f64 > f32-max narrows to +inf and
                    # errors here where the f64 reference would accept it —
                    # use --precision f64 for such (pathological) inputs.
                    bad = np.isnan(a).any() or np.isposinf(a).any()
                    if not bad:
                        if p.in_logscale:
                            bad = np.isneginf(a).all(axis=-1).any()
                        else:
                            bad = bool((a < 0).any())
                    if bad:
                        raise strict.StrictError(
                            "read_geno",
                            "NaN found! Is the file format correct?")
                    self._q.put(a)
                    s += k
            self._q.put(None)
        except BaseException as e:
            self._err.append(e)
            self._q.put(None)

    def _upload(self):
        import jax
        try:
            while True:
                a = self._q.get()
                if a is None:
                    return
                self._slabs.append(jax.device_put(a))
        except BaseException as e:
            self._err.append(e)
            # drain so the reader never blocks on a full queue
            while self._q.get() is not None:
                pass

    def np_slabs(self):
        """stream_np mode: yield host slabs in file order (the reader
        thread keeps at most 2 queued); raises the reader's error (the
        reference's NaN semantics) after the stream ends."""
        while True:
            a = self._q.get()
            if a is None:
                break
            yield a
        self._reader.join()
        if self._err:
            raise self._err[0]

    def join(self):
        import jax.numpy as jnp
        self._reader.join()
        self._uploader.join()
        if self._err:
            raise self._err[0]
        return (jnp.concatenate(self._slabs, axis=0)
                if len(self._slabs) > 1 else self._slabs[0])


class _StreamedTextLoader:
    """gz-text GL fast path (Beagle probs / called-genotype formats):
    decompressed chunks parse through the native line parser in a reader
    thread while an uploader thread device_puts the slabs — the text-input
    analogue of _StreamedGLLoader. Records arrive already log-normalized
    (parse_geno_line is the same code path as ngsld_read_geno_text), so the
    engine's standard (raw=False) preprocess applies.

    EOF parity with read_geno (read_data.cpp:33,106-109): fewer lines than
    n_sites -> 'premature EOF'; ANY byte after the n_sites-th record ->
    'not at EOF'. NGSLD_NO_FASTTEXT=1 opts out."""

    CHUNK_BYTES = 48 << 20

    @staticmethod
    def applicable(pars) -> bool:
        if pars.in_bin or os.environ.get("NGSLD_NO_FASTTEXT") == "1":
            return False
        try:
            from .native import get_lib
            return get_lib() is not None
        except Exception:
            return False

    def __init__(self, pars, np_dtype):
        import queue
        import threading
        self._pars = pars
        self._dt = np_dtype
        self._q = queue.Queue(maxsize=2)
        self._slabs = []
        self._err = []
        self._reader = threading.Thread(
            target=self._read, daemon=True, name="ngsld-gltext-read")
        self._uploader = threading.Thread(
            target=self._upload, daemon=True, name="ngsld-gltext-upload")
        self._reader.start()
        self._uploader.start()

    def _read(self):
        from .native import parse_geno_text_native
        p = self._pars
        n = p.n_sites
        try:
            with strict.open_maybe_gz(p.in_geno, "rb") as fh:
                carry = b""
                s = 0
                leftover = b""
                while True:
                    data = fh.read(self.CHUNK_BYTES)
                    eof = not data
                    buf = carry + data
                    if eof:
                        if not buf:
                            break
                        chunk, carry = buf + b"\n", b""  # final bare line
                    else:
                        cut = buf.rfind(b"\n")
                        if cut < 0:
                            carry = buf
                            continue
                        chunk, carry = buf[:cut + 1], buf[cut + 1:]
                    if s >= n:
                        leftover = chunk
                        break
                    recs, used = parse_geno_text_native(
                        chunk, p.in_probs, p.in_logscale, p.n_ind, s,
                        min(chunk.count(b"\n"), n - s))
                    if len(recs):
                        self._q.put(recs.astype(self._dt, copy=False))
                    s += len(recs)
                    if used < len(chunk):
                        leftover = chunk[used:]
                        break
                    if eof:
                        break
                if s < n:
                    raise strict.StrictError(
                        "read_geno", "GENO file at premature EOF. "
                        "Check GENO file and number of sites!")
                if leftover or carry or fh.read(1):
                    raise strict.StrictError(
                        "read_geno", "GENO file not at EOF. "
                        "Check GENO file and number of sites!")
            self._q.put(None)
        except BaseException as e:
            self._err.append(e)
            self._q.put(None)

    def _upload(self):
        import jax
        try:
            while True:
                a = self._q.get()
                if a is None:
                    return
                self._slabs.append(jax.device_put(a))
        except BaseException as e:
            self._err.append(e)
            while self._q.get() is not None:  # unblock the reader
                pass

    def join(self):
        import jax.numpy as jnp
        self._reader.join()
        self._uploader.join()
        if self._err:
            raise self._err[0]
        return (jnp.concatenate(self._slabs, axis=0)
                if len(self._slabs) > 1 else self._slabs[0])


def _ring_sharded_tables(pars, mesh, n_dev, B, Sp, np_dt, log):
    """Site-sharded table load for --ring: stream each ADDRESSABLE device's
    B-row block straight from the GENO file and assemble the global
    (Sp, n_ind, 3) 'sites'-sharded array with
    jax.make_array_from_single_device_arrays — the global table is never
    materialized on any host. Host RSS is O(one block + one slab); on a
    multi-host cluster each process reads only its own devices' blocks (binary
    input seeks; text input is parsed once per host, discarding
    non-resident records as it goes).

    Returns (gl_global, raw): `raw=True` means the
    records are UNNORMALIZED file values (binary fast path) and preprocess
    must run with raw=True/in_log=pars.in_logscale; `raw=False` means
    log-normalized (text parse / strict fallback). Falls back to
    strict.read_geno (exact reference error surface) when neither fast
    path applies; that fallback IS O(table) on the host and logs a note.

    Reference parity: the load semantics per record match read_data.cpp
    13-116 via the same code paths the block engine's streamed loaders use.
    """
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    n, m = pars.n_sites, pars.n_ind
    # the mesh may carry an 'ind' axis (--ring --shard_ind): the table
    # then shards over BOTH site blocks and individual slices, and each
    # device receives only its (B, I_loc) window of the block it loads
    n_is = dict(zip(mesh.axis_names, mesh.devices.shape)).get("ind", 1)
    I_loc = m // n_is
    shd = NamedSharding(mesh, PS("sites", "ind", None) if n_is > 1
                        else PS("sites", None, None))
    grid = mesh.devices.reshape(n_dev, n_is)
    mine_devs = {}          # site block k -> [(ind shard q, device)]
    for k in range(n_dev):
        for q in range(n_is):
            d = grid[k, q]
            if d.process_index == jax.process_index():
                mine_devs.setdefault(k, []).append((q, d))
    my = sorted(mine_devs)  # this process's resident site blocks
    pad_val = np_dt(np.log(1.0 / 3.0))

    def put_block(k, buf, shards):
        """Ship one fully-loaded (B, m, 3) site block to every owned
        device of its mesh row (slicing the individual axis per shard)."""
        for q, d in mine_devs[k]:
            sl = buf if n_is == 1 else np.ascontiguousarray(
                buf[:, q * I_loc:(q + 1) * I_loc])
            shards.append(jax.device_put(sl, d))

    def assemble(shards):
        return jax.make_array_from_single_device_arrays(
            (Sp, m, 3), shd, shards)

    slab_bytes = int(os.environ.get("NGSLD_SLAB_BYTES",
                                    _StreamedGLLoader.SLAB_BYTES))

    if _StreamedGLLoader.applicable(pars):
        # binary fast path: RAW f64 records; seek straight to each resident
        # block, narrow + NaN-check slab-wise (read_data.cpp:42-45 parity,
        # same checks as _StreamedGLLoader), normalize on device
        rec = m * 3
        slab_sites = max(1, slab_bytes // (rec * 8))
        shards = []
        with open(pars.in_geno, "rb") as fh:
            for k in my:
                lo = k * B
                rows = max(0, min(B, n - lo))
                # pad rows must normalize to a harmless uniform record in
                # whichever space the RAW file is in
                buf = np.full((B, m, 3),
                              pad_val if pars.in_logscale
                              else np_dt(1.0 / 3.0), np_dt)
                fh.seek(lo * rec * 8)
                s = 0
                while s < rows:
                    cnt = min(slab_sites, rows - s)
                    a = np.fromfile(fh, dtype=np.float64,
                                    count=cnt * rec).reshape(cnt, m, 3)
                    a = a.astype(np_dt, copy=False)
                    bad = np.isnan(a).any() or np.isposinf(a).any()
                    if not bad:
                        bad = (np.isneginf(a).all(axis=-1).any()
                               if pars.in_logscale else bool((a < 0).any()))
                    if bad:
                        raise strict.StrictError(
                            "read_geno",
                            "NaN found! Is the file format correct?")
                    buf[s:s + cnt] = a
                    s += cnt
                put_block(k, buf, shards)
                del buf
        return assemble(shards), True

    if _StreamedTextLoader.applicable(pars):
        # gz-text: native chunked parse of the whole file (records arrive
        # log-normalized); only resident blocks are buffered, everything
        # else is discarded as soon as it parses
        from .native import parse_geno_text_native
        mine = {k: None for k in my}
        shards = []
        chunk_bytes = min(slab_bytes, _StreamedTextLoader.CHUNK_BYTES)
        with strict.open_maybe_gz(pars.in_geno, "rb") as fh:
            carry = b""
            s = 0
            leftover = b""
            while True:
                data = fh.read(chunk_bytes)
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
                    leftover = chunk
                    break
                recs, used = parse_geno_text_native(
                    chunk, pars.in_probs, pars.in_logscale, m, s,
                    min(chunk.count(b"\n"), n - s))
                got = len(recs)
                # scatter this chunk's records into resident block buffers
                r0 = 0
                while r0 < got:
                    g = s + r0
                    k = g // B
                    take = min(got - r0, (k + 1) * B - g)
                    if k in mine:
                        if mine[k] is None:
                            mine[k] = np.full((B, m, 3), pad_val, np_dt)
                        mine[k][g - k * B:g - k * B + take] = \
                            recs[r0:r0 + take].astype(np_dt, copy=False)
                    r0 += take
                s += got
                # a block is complete once the stream passes its end
                for k in sorted(mine):
                    if mine[k] is not None and (k + 1) * B <= s:
                        put_block(k, mine[k], shards)
                        del mine[k]
                if used < len(chunk):
                    leftover = chunk[used:]
                    break
                if eof:
                    break
            if s < n:
                raise strict.StrictError(
                    "read_geno", "GENO file at premature EOF. "
                    "Check GENO file and number of sites!")
            if leftover or carry or fh.read(1):
                raise strict.StrictError(
                    "read_geno", "GENO file not at EOF. "
                    "Check GENO file and number of sites!")
        for k in sorted(mine):   # tail blocks (partial or all-pad)
            b = mine[k]
            if b is None:
                b = np.full((B, m, 3), pad_val, np_dt)
            put_block(k, b, shards)
        return assemble(shards), False

    # fallback: strict reader (exact reference error surface); this DOES
    # materialize the table on the host — fine for small runs, logged so
    # at-scale users notice
    log.log(2, "==> ring: input not stream-shardable; using the strict "
               "reader (host memory O(table))")
    geno_log = strict.read_geno(pars.in_geno, pars.in_bin, pars.in_probs,
                                pars.in_logscale, m, n)
    shards = []
    for k in my:
        lo = k * B
        buf = np.full((B, m, 3), pad_val, np_dt)
        rows = max(0, min(B, n - lo))
        if rows:
            buf[:rows] = np.asarray(geno_log[lo:lo + rows], np_dt)
        put_block(k, buf, shards)
    return assemble(shards), False


class _OverlapIngest:
    """Slab-wise upload + preprocess that OVERLAPS the banded pair sweep.

    The serial chain `join() -> preprocess(full table) -> sweep` puts the
    whole host->device GL transfer on the critical path (the 1M-site
    sampled leg measured 19-51 s of upload before the first block could
    dispatch). Here an ingest thread consumes the reader's host slabs,
    uploads each, runs the SAME jitted per-site preprocess on it, and
    writes the results into full-size device tables via
    dynamic_update_slice; a coverage counter (sites resident) gates block
    dispatch in the engine, so the sweep starts as soon as the first
    slab's sites are live. Per-site preprocessing makes slab-wise
    evaluation value-identical to the monolithic call (reductions are
    within a site's row).

    Only engaged when the plan cannot depend on not-yet-loaded data:
    min_maf <= 0 (the plan's only maf consumer, ngsLD.cpp:264,270, is
    then a constant-true filter — the engine passes the plan a dummy maf
    and the real per-slab values land in `maf_host` before any block
    touching them reaches the fmt stage). `failed` drives the engine's
    output-truncation on a mid-sweep read error, preserving the
    reference's nothing-printed-on-bad-input surface (read_data.cpp:44).
    """

    def __init__(self, loader, pars, dt, pre_partial):
        import threading
        self._loader = loader
        self._pars = pars
        self._dt = dt
        self._pre_partial = pre_partial
        self.maf_host = np.empty(pars.n_sites, np.float64)
        self.failed = False
        self._err = None
        self._cov = 0
        self._bufs = None
        self._cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ngsld-ingest")
        self._thread.start()

    def _run(self):
        import jax
        import jax.numpy as jnp
        from jax import lax
        p = self._pars
        n, m = p.n_sites, p.n_ind
        try:
            pre = jax.jit(self._pre_partial)

            @jax.jit
            def upd(gn, eg, mf, gs, es, ms, off):
                z = jnp.zeros((), off.dtype)  # DUS wants one index dtype
                return (lax.dynamic_update_slice(gn, gs, (off, z, z)),
                        lax.dynamic_update_slice(eg, es, (off, z)),
                        lax.dynamic_update_slice(mf, ms, (off,)))

            gn = jnp.zeros((n, m, 3), self._dt)
            eg = jnp.zeros((n, m), self._dt)
            mf = jnp.zeros((n,), self._dt)
            off = 0
            for slab in self._loader.np_slabs():
                k = len(slab)
                sd = jax.device_put(slab)
                gs, ms, es = pre(sd)
                gn, eg, mf = upd(gn, eg, mf, gs, es, ms, np.int32(off))
                # the host pull synchronizes this slab's whole chain
                mh = np.array(ms, np.float64)
                self.maf_host[off:off + k] = mh
                off += k
                with self._cv:
                    self._bufs = (gn, eg, mf)
                    self._cov = off
                    self._cv.notify_all()
            if off != n:   # reader stopped early without raising
                raise strict.StrictError(
                    "read_geno", "GENO file at premature EOF. "
                    "Check GENO file and number of sites!")
        except BaseException as e:
            with self._cv:
                self._err = e
                self.failed = True
                self._cv.notify_all()

    def wait(self, need: int):
        """Block until `need` sites are resident; returns the current
        (gn, eg, maf) device tables. Raises the ingest error if the read
        failed (reference NaN/EOF semantics)."""
        with self._cv:
            while self._cov < need and self._err is None:
                self._cv.wait()
            if self._err is not None and self._cov < need:
                raise self._err
            return self._bufs

    def join_all(self):
        """Wait for the whole table (end-of-run error
        surfacing); returns the final (gn, eg, maf) device tables."""
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._bufs
