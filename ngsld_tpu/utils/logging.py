"""Leveled stderr narration + phase timing.

Mirrors the reference's --verbose contract (phase banners at >=1,
progress at >=3, data dumps at >=6/7; ngsLD.cpp:46,86,102,118,151,194 and
parse_args.cpp:135-161) and adds what it lacks: per-phase wall timing and
run counters (pairs evaluated, EM iteration histogram, throughput).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


class RunLog:
    def __init__(self, verbose: int = 1):
        self.verbose = verbose
        self.timings: list = []
        self.counters: dict = {}
        self.time_counters: dict = {}
        self.hists: dict = {}

    def log(self, level: int, msg: str) -> None:
        if self.verbose >= level:
            sys.stderr.write(msg + "\n")

    @contextmanager
    def phase(self, name: str, level: int = 1):
        self.log(level, f"==> {name}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings.append((name, time.perf_counter() - t0))

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def count_time(self, key: str, seconds: float) -> None:
        """Accumulate wall-time into a named bucket (printed with the phase
        timings; cheap enough to leave on at any verbosity)."""
        self.time_counters[key] = self.time_counters.get(key, 0.0) + seconds

    def hist(self, key: str, counts) -> None:
        """Accumulate an integer histogram (e.g. EM iterations per pair)."""
        import numpy as np
        prev = self.hists.get(key)
        counts = np.asarray(counts, dtype=np.int64)
        if prev is None:
            self.hists[key] = counts.copy()
        else:
            n = max(len(prev), len(counts))
            out = np.zeros(n, np.int64)
            out[:len(prev)] += prev
            out[:len(counts)] += counts
            self.hists[key] = out

    def dump_json(self) -> None:
        """Write phase timings / stage sub-timers / counters as JSON to
        $NGSLD_TIMINGS_JSON (if set). Machine-readable counterpart of
        summary(): bench.py attaches the pull/dispatch/format split to each
        e2e leg so wall-clock changes are attributable to a stage."""
        import json
        import os
        path = os.environ.get("NGSLD_TIMINGS_JSON")
        if not path:
            return
        try:
            payload = {
                "phases": {n: round(t, 3) for n, t in self.timings},
                "stages": {k: round(v, 3)
                           for k, v in sorted(self.time_counters.items())},
                "counters": dict(self.counters),
            }
            with open(path, "w") as fh:
                json.dump(payload, fh)
        except OSError:
            pass

    def summary(self) -> None:
        self.dump_json()
        if self.verbose < 1:
            return
        total = sum(t for _, t in self.timings)
        sys.stderr.write("==> Phase timings:\n")
        for name, t in self.timings:
            sys.stderr.write(f"\t{name}: {t:.3f}s ({100*t/max(total,1e-9):.0f}%)\n")
        for name, t in sorted(self.time_counters.items()):
            sys.stderr.write(f"\t  [{name}: {t:.3f}s]\n")
        if self.counters:
            sys.stderr.write("==> Counters:\n")
            for k, v in sorted(self.counters.items()):
                sys.stderr.write(f"\t{k}: {v}\n")
        for k, h in sorted(self.hists.items()):
            nz = [i for i, c in enumerate(h) if c]
            if not nz:
                continue
            tot = int(h.sum())
            # quartiles over the iteration distribution
            cum = h.cumsum()
            qs = [int((cum >= q * tot).argmax()) for q in (0.5, 0.9, 0.99)]
            sys.stderr.write(
                f"==> {k}: min {nz[0]}, p50 {qs[0]}, p90 {qs[1]}, "
                f"p99 {qs[2]}, max {nz[-1]}\n")
        pairs = self.counters.get("pairs_emitted", 0)
        compute_t = sum(t for n, t in self.timings if n.startswith("compute"))
        if pairs and compute_t > 0:
            sys.stderr.write(f"==> Throughput: {pairs/compute_t:.3g} pairs/s "
                             "(compute phases)\n")


def echo_config(pars, engine_info: str = "") -> None:
    """Startup config echo — field-for-field the reference's stderr block
    (parse_args.cpp:135-159), incl. glibc's "(null)" for NULL strings and
    the >4 debugging note; the engine line is appended as an extension."""
    from .. import __version__

    def s(v):
        return "(null)" if v is None else str(v)

    def b(v):
        return "true" if v else "false"

    lines = [
        "==> Input Arguments:",
        f"\tgeno: {s(pars.in_geno)}",
        f"\tprobs: {b(pars.in_probs)}",
        f"\tlog_scale: {b(pars.in_logscale)}",
        f"\tn_ind: {pars.n_ind}",
        f"\tn_sites: {pars.n_sites}",
        f"\tpos: {s(pars.in_pos)} ({'WITH' if pars.in_pos_header else 'WITHOUT'} header)",
        f"\tmax_kb_dist (kb): {pars.max_kb_dist}",
        f"\tmax_snp_dist: {pars.max_snp_dist}",
        f"\tmin_maf: {pars.min_maf:f}",
        f"\tignore_miss_data: {b(pars.ignore_miss_data)}",
        f"\tcall_geno: {b(pars.call_geno)}",
        f"\tN_thresh: {pars.N_thresh:f}",
        f"\tcall_thresh: {pars.call_thresh:f}",
        f"\trnd_sample: {pars.rnd_sample:f}",
        f"\tseed: {pars.seed}",
        f"\textend_out: {b(pars.extend_out)}",
        f"\tout: {s(pars.out)}",
        f"\tn_threads: {pars.n_threads}",
        f"\tverbose: {pars.verbose}",
        f"\tversion: {__version__} (ngsld-tpu)",
        "",
        f"\tengine: {pars.engine} {engine_info}",
        "",
    ]
    sys.stderr.write("\n".join(lines))
    if pars.verbose > 4:
        sys.stderr.write("==> Verbose values greater than 4 for debugging "
                         "purpose only. Expect large amounts of info on "
                         "screen\n")
