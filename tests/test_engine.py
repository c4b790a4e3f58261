"""JAX engine vs strict engine: same pair set, near-identical values.

The strict engine is the byte-exact contract; the JAX engine (f64, CPU here)
must agree on every emitted pair and match all numeric columns to 1e-9, with
the overwhelming majority of rows byte-identical after %f formatting.
"""

import io
import os

import numpy as np
import pytest

from ngsld_tpu import strict
from ngsld_tpu.config import Params
from ngsld_tpu.engine import run_jax
from ngsld_tpu.utils.simulate import simulate, write_all


@pytest.fixture(scope="module")
def fixdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fix"))
    sim = simulate(n_ind=10, n_sites=250, seed=21, all_missing_site_rate=0.02,
                   mono_rate=0.05)
    return write_all(sim, d)


def run_both(paths, **kw):
    base = dict(in_geno=paths["beagle"], in_probs=True, n_ind=10, n_sites=250,
                in_pos=paths["pos"], extend_out=True, precision="f64")
    base.update(kw)
    s_out, j_out = io.StringIO(), io.StringIO()
    strict.run(Params(**base).finalize(), out_fh=s_out)
    run_jax(Params(**base).finalize(), out_fh=j_out)
    return s_out.getvalue().splitlines(), j_out.getvalue().splitlines()


def compare(s_rows, j_rows):
    """Column contract between the fast engine and the byte-exact oracle:

    * same pair set, same order
    * >=90% of rows byte-identical
    * D, hap freqs, mafs, chi2: within one %f print quantum (1e-6)
    * Dp, r2: within 5e-5 (ratio stats amplify the EM's 1e-5 stop tolerance)
    * degenerate pairs (an estimated hap MAF at the 0/1 boundary within the
      EM tolerance) exempt Dp/r2/chi2 — 0/0 forms, garbage in both engines
    * nIter within 2
    """
    assert s_rows[0] == j_rows[0]
    assert len(s_rows) == len(j_rows)
    n_exact = 0
    for sr, jr in zip(s_rows[1:], j_rows[1:]):
        if sr == jr:
            n_exact += 1
            continue
        sf, jf = sr.split("\t"), jr.split("\t")
        assert sf[:2] == jf[:2], f"pair mismatch: {sf[:2]} vs {jf[:2]}"
        hm1, hm2 = float(sf[14]), float(sf[15])  # hap_maf1, hap_maf2
        degenerate = any(np.isnan(m) or min(m, 1 - m) < 2e-5 for m in (hm1, hm2))
        for c, (a, b) in enumerate(zip(sf[2:], jf[2:])):
            if a == b:
                continue
            av, bv = float(a), float(b)
            if np.isnan(av) and np.isnan(bv):
                continue
            if c == 16:  # nIter may differ on convergence knife-edges
                assert abs(av - bv) <= 2, f"nIter far apart: {sr} vs {jr}"
            elif c in (3, 4, 14):  # Dp, r2, chi2
                if not degenerate:
                    assert abs(av - bv) <= 5e-5, f"col {c}: {a} vs {b}\n{sr}\n{jr}"
            else:
                assert abs(av - bv) <= 1.01e-6, f"col {c}: {a} vs {b}\n{sr}\n{jr}"
    assert n_exact >= 0.9 * (len(s_rows) - 1), \
        f"only {n_exact}/{len(s_rows)-1} rows exact"


@pytest.mark.parametrize("kw", [
    dict(max_kb_dist=10, min_maf=0.05),
    dict(max_kb_dist=10, min_maf=0.05, ignore_miss_data=True),
    dict(max_kb_dist=10, min_maf=0.05, call_geno=True),
    dict(max_kb_dist=10, min_maf=0.05, call_geno=True, N_thresh=0.3, call_thresh=0.9),
    dict(max_kb_dist=5, min_maf=0.0),
    dict(max_kb_dist=10, min_maf=0.05, rnd_sample=0.5, seed=12345),
    dict(max_kb_dist=10, min_maf=0.05, chunk_pairs=64),  # multi-block padding
])
def test_engine_matches_strict(fixdir, kw):
    s_rows, j_rows = run_both(fixdir, **kw)
    assert len(s_rows) > 1
    compare(s_rows, j_rows)


def test_engine_genotype_input(fixdir):
    s_rows, j_rows = run_both(fixdir, in_geno=fixdir["geno_text"],
                              in_probs=False, max_kb_dist=10, min_maf=0.05)
    compare(s_rows, j_rows)


def test_engine_binary_input(fixdir):
    s_rows, j_rows = run_both(fixdir, in_geno=fixdir["glf"], in_logscale=True,
                              max_kb_dist=10, min_maf=0.05)
    compare(s_rows, j_rows)


def test_streamed_loader_nan_parity(tmp_path):
    """The streamed binary fast path must reject NaN records with the
    reference's error (read_data.cpp:44-45), like the strict reader."""
    import io

    from ngsld_tpu import strict
    from ngsld_tpu.engine import _StreamedGLLoader, run_jax
    from ngsld_tpu.utils.simulate import simulate, write_glf_bin, write_pos

    sim = simulate(n_ind=6, n_sites=50, seed=11)
    glf = str(tmp_path / "bad.glf")
    posf = str(tmp_path / "bad.pos")
    write_glf_bin(sim, glf)
    write_pos(sim, posf)
    raw = np.fromfile(glf, dtype=np.float64)
    raw[123] = np.nan
    raw.tofile(glf)

    pars = Params(in_geno=glf, in_probs=True, in_logscale=True, n_ind=6,
                  n_sites=50, in_pos=posf, max_kb_dist=5).finalize()
    assert _StreamedGLLoader.applicable(pars)
    with pytest.raises(strict.StrictError, match="NaN found"):
        run_jax(pars, out_fh=io.BytesIO())


def test_streamed_text_loader_matches_strict_reader(tmp_path, monkeypatch):
    """The streaming gz-text loader must deliver the same records as
    strict.read_geno — engine outputs byte-identical in f64 — for both
    Beagle probs and called-genotype formats, across chunk boundaries."""
    import io

    from ngsld_tpu.engine import _StreamedTextLoader, run_jax
    from ngsld_tpu.utils.simulate import simulate, write_all

    sim = simulate(n_ind=9, n_sites=300, seed=23)
    files = write_all(sim, str(tmp_path / "fix"))
    monkeypatch.setattr(_StreamedTextLoader, "CHUNK_BYTES", 4096)  # force
    # many chunks so line-boundary carry logic is exercised
    for key, extra in (("beagle", dict(in_probs=True)),
                       ("geno_text", {})):
        pars_kw = dict(in_geno=files[key], n_ind=9, n_sites=300,
                       in_pos=files["pos"], max_kb_dist=5, extend_out=True,
                       **extra)
        a = io.BytesIO()
        run_jax(Params(**pars_kw).finalize(), out_fh=a)
        monkeypatch.setenv("NGSLD_NO_FASTTEXT", "1")
        b = io.BytesIO()
        run_jax(Params(**pars_kw).finalize(), out_fh=b)
        monkeypatch.delenv("NGSLD_NO_FASTTEXT")
        assert a.getvalue() == b.getvalue(), key   # f64: byte-identical


def test_streamed_text_loader_eof_parity(tmp_path):
    """Line-count mismatches raise the reference's EOF errors."""
    import gzip
    import io

    from ngsld_tpu import strict
    from ngsld_tpu.engine import run_jax
    from ngsld_tpu.utils.simulate import simulate, write_all

    sim = simulate(n_ind=6, n_sites=50, seed=2)
    files = write_all(sim, str(tmp_path / "fix"))

    def pars(n_sites):
        return Params(in_geno=files["beagle"], in_probs=True, n_ind=6,
                      n_sites=n_sites, in_pos=None, max_kb_dist=0,
                      max_snp_dist=10).finalize()

    with pytest.raises(strict.StrictError, match="not at EOF"):
        run_jax(pars(49), out_fh=io.BytesIO())
    # too many expected sites: the pos file has 50 lines, so use no pos
    with pytest.raises(strict.StrictError, match="premature EOF"):
        run_jax(pars(51), out_fh=io.BytesIO())


@pytest.mark.parametrize("val,logscale", [
    (np.inf, True),          # +inf log-GL: inf - inf in the normalize
    (np.inf, False),         # +inf likelihood: log -> +inf -> NaN
    (-0.25, False),          # negative linear likelihood: log -> NaN
])
def test_streamed_loader_rejects_nonfinite(tmp_path, val, logscale):
    """read_data.cpp:42-45 parity: inputs whose post_prob would be NaN must
    error on the streamed binary fast path, not emit NaN rows."""
    import io

    from ngsld_tpu import strict
    from ngsld_tpu.engine import _StreamedGLLoader, run_jax
    from ngsld_tpu.utils.simulate import simulate, write_glf_bin, write_pos

    sim = simulate(n_ind=6, n_sites=50, seed=13)
    glf = str(tmp_path / "bad.glf")
    posf = str(tmp_path / "bad.pos")
    write_glf_bin(sim, glf)
    write_pos(sim, posf)
    raw = np.fromfile(glf, dtype=np.float64)
    if not logscale:
        raw = np.exp(raw)    # linear-scale file
    raw[77] = val
    raw.tofile(glf)

    pars = Params(in_geno=glf, in_probs=True, in_logscale=logscale, n_ind=6,
                  n_sites=50, in_pos=posf, max_kb_dist=5).finalize()
    assert _StreamedGLLoader.applicable(pars)
    with pytest.raises(strict.StrictError, match="NaN found"):
        run_jax(pars, out_fh=io.BytesIO())


def test_overlap_ingest_parity_multislab(tmp_path, monkeypatch):
    """Upload/compute overlap (loaders._OverlapIngest): coverage-gated
    slab-wise preprocessing must emit byte-identical output to the
    monolithic join path. NGSLD_SLAB_BYTES forces many slabs so the
    dispatch loop really gates on partial coverage."""
    import io

    from ngsld_tpu.engine import run_jax
    from ngsld_tpu.utils.simulate import simulate, write_glf_bin, write_pos

    sim = simulate(n_ind=8, n_sites=300, seed=33, mono_rate=0.05)
    glf = str(tmp_path / "ov.glf")
    posf = str(tmp_path / "ov.pos")
    write_glf_bin(sim, glf)
    write_pos(sim, posf)
    base = dict(in_geno=glf, in_probs=True, in_logscale=True, n_ind=8,
                n_sites=300, in_pos=posf, max_kb_dist=5, extend_out=True,
                precision="f64")

    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")  # ~20 sites/slab
    monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", "1")
    ov = io.BytesIO()
    run_jax(Params(**base).finalize(), out_fh=ov)

    monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", "0")
    mono = io.BytesIO()
    run_jax(Params(**base).finalize(), out_fh=mono)
    assert ov.getvalue() == mono.getvalue()
    assert ov.getvalue().count(b"\n") > 300


def test_overlap_ingest_error_truncates_output(tmp_path, monkeypatch):
    """A NaN near EOF surfaces only after early blocks already emitted
    rows; the reference prints NOTHING on bad input (it reads the whole
    table first, read_data.cpp:44-45) — the overlap path must truncate
    the partial output before re-raising."""
    from ngsld_tpu import strict
    from ngsld_tpu.engine import run_jax
    from ngsld_tpu.utils.simulate import simulate, write_glf_bin, write_pos

    sim = simulate(n_ind=8, n_sites=300, seed=34)
    glf = str(tmp_path / "bad.glf")
    posf = str(tmp_path / "bad.pos")
    write_glf_bin(sim, glf)
    write_pos(sim, posf)
    raw = np.memmap(glf, np.float64, mode="r+")
    raw[len(raw) - 3] = np.nan
    del raw

    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    out = str(tmp_path / "bad.ld")
    pars = Params(in_geno=glf, in_probs=True, in_logscale=True, n_ind=8,
                  n_sites=300, in_pos=posf, max_kb_dist=5).finalize()
    with open(out, "wb") as fh:
        with pytest.raises(strict.StrictError, match="NaN found"):
            run_jax(pars, out_fh=fh)
    assert os.path.getsize(out) == 0
