"""Byte-level conformance: strict engine vs the reference binary.

Reproduces the reference's own end-to-end contract (examples/test.sh:16-34:
run, sort rows, compare) over the same option matrix, on synthetic fixtures.
Every row must match byte-for-byte.
"""

import os
import subprocess

import pytest

from ngsld_tpu import strict
from ngsld_tpu.config import Params
from ngsld_tpu.utils.simulate import simulate, write_all

N_IND = 10
N_SITES = 300


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixtures")
    sim = simulate(n_ind=N_IND, n_sites=N_SITES, seed=11,
                   all_missing_site_rate=0.02, mono_rate=0.05)
    return write_all(sim, str(d))


def run_ref(ref_binary, geno, pos, out, extra):
    cmd = [ref_binary, "--geno", geno, "--n_ind", str(N_IND), "--n_sites",
           str(N_SITES), "--pos", pos, "--extend_out", "--out", out] + extra
    subprocess.run(cmd, check=True, capture_output=True)


def run_strict(geno, pos, out, extra):
    argmap = {"--probs": ("in_probs", True), "--log_scale": ("in_logscale", True),
              "--call_geno": ("call_geno", True),
              "--ignore_miss_data": ("ignore_miss_data", True)}
    kw = dict(in_geno=geno, n_ind=N_IND, n_sites=N_SITES, in_pos=pos,
              extend_out=True, out=out)
    it = iter(extra)
    for a in it:
        if a in argmap:
            k, v = argmap[a]
            kw[k] = v
        elif a in ("--max_kb_dist", "--max_snp_dist"):
            kw[a.lstrip("-")] = int(next(it))
        elif a in ("--min_maf", "--N_thresh", "--call_thresh", "--rnd_sample"):
            kw[a.lstrip("-")] = float(next(it))
        elif a == "--seed":
            kw["seed"] = int(next(it))
        else:
            raise ValueError(a)
    strict.run(Params(**kw).finalize())


def sorted_rows(path):
    with open(path) as fh:
        lines = fh.readlines()
    return lines[0], sorted(lines[1:])


# the reference test matrix (examples/test.sh:16-34), adapted to one fixture
MATRIX = [
    ("geno_text", ["--max_kb_dist", "20", "--min_maf", "0.05"]),
    ("geno_text", ["--max_kb_dist", "20", "--min_maf", "0.05",
                   "--rnd_sample", "0.5", "--seed", "12345"]),
    ("glf", ["--log_scale", "--max_kb_dist", "10", "--min_maf", "0.05"]),
    ("glf", ["--log_scale", "--max_kb_dist", "10", "--min_maf", "0.05", "--call_geno"]),
    ("glf", ["--log_scale", "--max_kb_dist", "10", "--min_maf", "0.05",
             "--call_geno", "--N_thresh", "0.3", "--call_thresh", "0.9"]),
    ("beagle", ["--probs", "--max_kb_dist", "10", "--min_maf", "0.05"]),
    ("beagle", ["--probs", "--max_kb_dist", "10", "--min_maf", "0.05", "--call_geno"]),
    ("beagle", ["--probs", "--max_kb_dist", "10", "--min_maf", "0.05",
                "--call_geno", "--N_thresh", "0.3", "--call_thresh", "0.9"]),
    ("beagle", ["--probs", "--max_kb_dist", "10", "--min_maf", "0.05",
                "--ignore_miss_data"]),
    # extras beyond the reference matrix: snp-dist band, no min_maf (NaN paths)
    ("beagle", ["--probs", "--max_snp_dist", "15", "--max_kb_dist", "0"]),
    ("beagle", ["--probs", "--max_kb_dist", "5"]),
]


@pytest.mark.parametrize("fmt,extra", MATRIX)
def test_matrix_byte_identical(ref_binary, fixtures, tmp_path, fmt, extra):
    geno = fixtures[fmt if fmt != "geno_text" else "geno_text"]
    ref_out = str(tmp_path / "ref.ld")
    my_out = str(tmp_path / "mine.ld")
    run_ref(ref_binary, geno, fixtures["pos"], ref_out, extra)
    run_strict(geno, fixtures["pos"], my_out, extra)
    h1, a = sorted_rows(ref_out)
    h2, b = sorted_rows(my_out)
    assert h1 == h2
    assert len(a) == len(b), f"row count {len(a)} vs {len(b)}"
    mismatches = [(x, y) for x, y in zip(a, b) if x != y]
    assert not mismatches, f"{len(mismatches)} mismatching rows; first: {mismatches[0]}"
    assert len(a) > 0  # non-trivial comparison


def test_binary_nonlog_roundtrip(ref_binary, tmp_path):
    """Binary input WITHOUT --log_scale (normal-space doubles) — covers the
    conv_space(log) clamp path (read_data.cpp:37-38)."""
    sim = simulate(n_ind=8, n_sites=120, seed=3)
    from ngsld_tpu.utils.simulate import write_glf_bin, write_pos
    geno = str(tmp_path / "lin.glf")
    pos = str(tmp_path / "lin.pos")
    write_glf_bin(sim, geno, log_scale=False)
    write_pos(sim, pos)
    ref_out = str(tmp_path / "ref.ld")
    my_out = str(tmp_path / "mine.ld")
    cmd = [ref_binary, "--geno", geno, "--n_ind", "8", "--n_sites", "120",
           "--pos", pos, "--extend_out", "--max_kb_dist", "10", "--out", ref_out]
    subprocess.run(cmd, check=True, capture_output=True)
    pars = Params(in_geno=geno, n_ind=8, n_sites=120, in_pos=pos,
                  extend_out=True, max_kb_dist=10, out=my_out).finalize()
    strict.run(pars)
    h1, a = sorted_rows(ref_out)
    h2, b = sorted_rows(my_out)
    assert h1 == h2 and a == b and len(a) > 0


def test_deep_verbose_traces_match_reference(fixtures, ref_binary, tmp_path):
    """--verbose 6/7/9 diagnostics byte-match the reference: the pos/geno
    dumps (ngsLD.cpp:120-122,138-143) and the per-pair filter trace with
    break/skip/PASS verdicts (ngsLD.cpp:242-283)."""
    import re
    import sys

    args = ["--geno", fixtures["beagle"], "--probs", "--n_ind", str(N_IND),
            "--n_sites", str(N_SITES), "--pos", fixtures["pos"],
            "--max_kb_dist", "3", "--min_maf", "0.1", "--rnd_sample", "0.8",
            "--seed", "7", "--verbose", "9"]
    ref = subprocess.run([ref_binary] + args + ["--out", os.devnull],
                         capture_output=True, text=True, check=True)

    from ngsld_tpu.cli import params_from_args
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        strict.run(params_from_args(args + ["--engine", "strict",
                                            "--out", os.devnull]))
    mine = buf.getvalue()

    def diag(text):
        # pos dump, geno dump, pair-trace headers and verdict lines —
        # engine-specific banners (config echo, threads) excluded: the
        # diagnostics start at the first pos-dump line "0\t..."
        lines = text.splitlines()
        start = next(i for i, ln in enumerate(lines)
                     if re.match(r"^0\t", ln))
        keep = []
        for ln in lines[start:]:
            if re.match(r"^[0-9]", ln) or ln.startswith("\t") \
                    or ln == "==> Geno data":
                keep.append(ln)
        return keep

    r, m = diag(ref.stderr), diag(mine)
    assert len(r) > 2000
    assert r == m


def _testsh_scale_config(ref_binary, tmp_path_factory, fmt, extra):
    """One examples/test.sh-scale config (24 individuals x 10,000 sites,
    test.sh:9-34): run reference binary + strict engine, sort + compare
    byte-for-byte."""
    global _BIG
    try:
        fixtures = _BIG
    except NameError:
        d = tmp_path_factory.mktemp("testsh")
        sim = simulate(n_ind=24, n_sites=10000, seed=11,
                       all_missing_site_rate=0.02, mono_rate=0.05)
        fixtures = _BIG = write_all(sim, str(d))
    tmp_path = tmp_path_factory.mktemp("out")
    geno = fixtures[fmt]
    ref_out = str(tmp_path / "ref.ld")
    my_out = str(tmp_path / "mine.ld")
    cmd = [ref_binary, "--geno", geno, "--n_ind", "24", "--n_sites",
           "10000", "--pos", fixtures["pos"], "--extend_out",
           "--out", ref_out] + extra
    subprocess.run(cmd, check=True, capture_output=True)
    argmap = {"--probs": ("in_probs", True),
              "--log_scale": ("in_logscale", True),
              "--call_geno": ("call_geno", True),
              "--ignore_miss_data": ("ignore_miss_data", True)}
    kw = dict(in_geno=geno, n_ind=24, n_sites=10000,
              in_pos=fixtures["pos"], extend_out=True, out=my_out)
    it = iter(extra)
    for a in it:
        if a in argmap:
            k, v = argmap[a]
            kw[k] = v
        elif a in ("--max_kb_dist", "--max_snp_dist"):
            kw[a.lstrip("-")] = int(next(it))
        elif a in ("--min_maf", "--N_thresh", "--call_thresh",
                   "--rnd_sample"):
            kw[a.lstrip("-")] = float(next(it))
        elif a == "--seed":
            kw["seed"] = int(next(it))
    strict.run(Params(**kw).finalize())
    h1, a = sorted_rows(ref_out)
    h2, b = sorted_rows(my_out)
    assert h1 == h2 and len(a) == len(b) and a == b and len(a) > 10000


def test_testsh_scale_default_config(ref_binary, tmp_path_factory):
    """ONE full-scale (24 x 10,000) byte-exact config runs in the DEFAULT
    suite — binary log-GL input, the kb-10 band, the
    min_maf filter. The full 8-config matrix stays under `-m slow`."""
    _testsh_scale_config(ref_binary, tmp_path_factory, *MATRIX[2])


@pytest.mark.slow
@pytest.mark.parametrize("fmt,extra", MATRIX[:8])
def test_matrix_testsh_scale(ref_binary, tmp_path_factory, fmt, extra):
    """The reference's own regression scale (examples/test.sh:9-34: 24
    individuals x 10,000 sites, 8 configs, sort + compare): byte-identical.
    Opt-in (slow): `pytest -m slow tests/test_conformance_strict.py`."""
    _testsh_scale_config(ref_binary, tmp_path_factory, fmt, extra)
