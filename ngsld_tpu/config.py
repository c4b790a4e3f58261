"""Run configuration shared by all engines.

Mirrors the reference's `params` struct and CLI validation
(/root/reference/ngsLD.hpp:11-44, parse_args.cpp:6-184).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field


class ConfigError(ValueError):
    pass


@dataclass
class Params:
    # inputs (parse_args.cpp:35-59 flag table)
    in_geno: str = None
    in_probs: bool = False        # --probs
    in_logscale: bool = False     # --log_scale (implies --probs)
    n_ind: int = 0
    n_sites: int = 0
    in_pos: str = None            # --pos / --posH
    in_pos_header: bool = False
    max_kb_dist: int = 100        # default 100 kb (parse_args.cpp:15)
    max_snp_dist: int = 0
    min_maf: float = 0.0
    ignore_miss_data: bool = False
    call_geno: bool = False
    N_thresh: float = 0.0         # implies --call_geno
    call_thresh: float = 0.0      # implies --call_geno
    rnd_sample: float = 1.0
    seed: int = None              # default time-based (parse_args.cpp:23)
    extend_out: bool = False
    out: str = None               # default stdout
    n_threads: int = 1
    verbose: int = 1

    # engine extensions (not in the reference)
    engine: str = "auto"          # auto | jax | strict
    precision: str = "auto"       # auto | f32 | f64
    chunk_pairs: int = 1 << 19   # pairs per device block for the pair EM;
    # engine_block caps it so the gathered blocks fit the device memory
    # (compute.max_block_pairs)
    profile: str = None           # JAX profiler trace dir
    checkpoint: str = None        # per-block shard dir (resume support)
    shard: int = 1                # devices for the pair sweep (0 = all local)
    shard_ind: int = 1            # devices for the INDIVIDUAL axis (large
    # cohorts: every per-individual EM reduction becomes a psum)
    ring: bool = False            # site-sharded ring sweep (GL table too
    # large to replicate per device; SURVEY.md §7 "Memory at 5M×500")
    ring_sub: int = 0             # ring sub-blocks per device block
    # (0 = auto: ~4k sites per sub-block)

    # derived
    in_bin: bool = field(default=False, init=False)

    def finalize(self) -> "Params":
        """Apply flag interactions + validation (parse_args.cpp:71-73,
        103-110, 168-183 and ngsLD.cpp:41-57)."""
        if self.in_logscale:
            self.in_probs = True
        if self.N_thresh or self.call_thresh:
            self.call_geno = True
        if self.seed is None:
            # reference default: time(NULL) + rand()%1000; glibc's unseeded
            # first rand() is 1804289383 -> +383 (parse_args.cpp:23)
            self.seed = int(time.time()) + 383

        if self.in_geno is None:
            raise ConfigError("genotype input file (--geno) missing!")
        if self.n_ind == 0:
            raise ConfigError("number of individuals (--n_ind) missing!")
        if self.n_sites == 0:
            raise ConfigError("number of sites (--n_sites) missing!")
        if self.in_pos is None and self.max_kb_dist > 0:
            raise ConfigError("position file necessary in order to filter by maximum distance!")
        if self.min_maf < 0 or self.min_maf > 1:
            raise ConfigError("minimum allele frequency must be in [0,1]!")
        if self.call_geno and not self.in_probs:
            # this check runs BEFORE the binary-input sniff, as in the
            # reference (parse_args.cpp:178-179 precedes ngsLD.cpp:53)
            raise ConfigError("can only call genotypes from likelihoods/probabilities!")
        if self.rnd_sample <= 0 or self.rnd_sample > 1:
            raise ConfigError("proportion of comparisons to sample must be in ]0,1]!")
        if self.n_threads < 1:
            # parse_args.cpp:182-183 (same relative order: after rnd_sample)
            raise ConfigError("number of threads cannot be less than 1!")
        if self.ring:
            if self.engine == "strict":
                raise ConfigError("--ring requires the jax engine")
        if self.shard_ind < 1:
            raise ConfigError("--shard_ind must be >= 1")
        if self.shard_ind > 1 and self.n_ind % self.shard_ind:
            raise ConfigError(
                "--shard_ind must divide --n_ind (padding individuals "
                "would change the EM's denominators)")

        if not os.path.exists(self.in_geno):
            # mirror of the stat() check (ngsLD.cpp:42-43)
            raise ConfigError("cannot check GENO file size!")

        # input format sniff: ".gz" extension => gzip text, else binary
        # doubles with probs forced on (ngsLD.cpp:45-57)
        self.in_bin = os.path.splitext(self.in_geno)[1] != ".gz"
        if self.in_bin:
            self.in_probs = True
            st = os.stat(self.in_geno)
            if self.n_sites != st.st_size // 8 // self.n_ind // 3:
                raise ConfigError("invalid/corrupt genotype input file!")

        if self.N_thresh > self.call_thresh:
            raise ConfigError("missing data threshold must be smaller than calling genotype threshold!")
        return self
