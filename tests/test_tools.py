"""Tests for the post-processing toolchain (prune, fit_decay, ld_blocks)."""

import subprocess
import sys

import numpy as np
import pytest


# ---------------------------------------------------------------- prune ----

def write_ld(path, rows):
    with open(path, "w") as fh:
        fh.write("site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n")
        for a, b, dist, r2 in rows:
            fh.write(f"{a}\t{b}\t{dist}\t0.0\t0.0\t0.0\t{r2}\n")


def run_prune(ld_path, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "ngsld_tpu.tools.prune", "--input", str(ld_path),
         "--max_dist", "50000", "--min_weight", "0.5", *extra],
        capture_output=True, text=True, check=True)
    return [ln for ln in out.stdout.splitlines() if ln]


def test_prune_drops_heaviest(tmp_path):
    ld = tmp_path / "t.ld"
    # hub chr1:2 connects to 3 others; pruning must drop the hub only
    write_ld(ld, [("chr1:1", "chr1:2", 100, 0.9),
                  ("chr1:2", "chr1:3", 100, 0.9),
                  ("chr1:2", "chr1:4", 100, 0.9),
                  ("chr1:5", "chr1:6", 100, 0.1)])  # below min_weight
    kept = run_prune(ld)
    assert kept == ["chr1:1", "chr1:3", "chr1:4", "chr1:5", "chr1:6"]


def test_prune_keep_heavy(tmp_path):
    ld = tmp_path / "t.ld"
    write_ld(ld, [("chr1:1", "chr1:2", 100, 0.9),
                  ("chr1:2", "chr1:3", 100, 0.9),
                  ("chr1:2", "chr1:4", 100, 0.9)])
    kept = run_prune(ld, "--keep_heavy")
    assert kept == ["chr1:2"]


def test_prune_tie_break_lowercase(tmp_path):
    ld = tmp_path / "t.ld"
    # equal weights: the lexicographically smallest lowercase label drops
    write_ld(ld, [("chr1:20", "chr1:10", 100, 0.9)])
    kept = run_prune(ld)
    assert kept == ["chr1:20"]  # "chr1:10" < "chr1:20" -> dropped


def test_prune_max_dist_filter(tmp_path):
    ld = tmp_path / "t.ld"
    write_ld(ld, [("chr1:1", "chr1:2", 100000, 0.9)])  # beyond max_dist
    kept = run_prune(ld)
    assert kept == ["chr1:1", "chr1:2"]


def test_prune_no_edges_among_kept(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(300):
        a, b = rng.integers(0, 60, 2)
        if a == b:
            continue
        rows.append((f"chr1:{a+1}", f"chr1:{b+1}", int(rng.integers(1, 2000)),
                     float(rng.random())))
    ld = tmp_path / "t.ld"
    write_ld(ld, rows)
    kept = set(run_prune(ld))
    for a, b, dist, r2 in rows:
        if dist <= 50000 and abs(r2) >= 0.5 and a != b:
            assert not (a in kept and b in kept), f"edge {a}-{b} survived"


# ------------------------------------------------------------ fit_decay ----

def test_fit_decay_recovers_rate(tmp_path):
    rng = np.random.default_rng(1)
    rate, r2h, r2l = 2e-3, 0.8, 0.05
    dist = rng.integers(1, 100000, 4000)
    r2 = (r2h - r2l) / (1 + rate * dist) + r2l + rng.normal(0, 0.02, 4000)
    ld = tmp_path / "t.ld"
    with open(ld, "w") as fh:
        fh.write("site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n")
        for d, v in zip(dist, r2):
            fh.write(f"chr1:1\tchr1:{1+d}\t{d}\t0\t0\t0\t{max(v,0):.6f}\n")
    lst = tmp_path / "files.txt"
    lst.write_text(str(ld) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "ngsld_tpu.tools.fit_decay", "--ld_files",
         str(lst), "--ld", "r2", "--fit_level", "3", "--seed", "7",
         "--fit_bin_size", "1"],
        capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    hdr = lines[0].split("\t")
    row = dict(zip(hdr, lines[1].split("\t")))
    assert abs(float(row["DecayRate"]) - rate) / rate < 0.25
    assert abs(float(row["LDmax"]) - r2h) < 0.1
    assert abs(float(row["LDmin"]) - r2l) < 0.05


def test_fit_decay_finite_sample_model(tmp_path):
    rng = np.random.default_rng(2)
    n_ind, rate = 50, 1e-3
    dist = rng.integers(1, 80000, 3000)
    C = rate * dist
    r2 = (((10 + C) / ((2 + C) * (11 + C)))
          * (1 + ((3 + C) * (12 + 12 * C + C ** 2)) / (n_ind * (2 + C) * (11 + C))))
    r2 = np.clip(r2 + rng.normal(0, 0.01, len(C)), 0, 1)
    ld = tmp_path / "t.ld"
    with open(ld, "w") as fh:
        fh.write("site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n")
        for d, v in zip(dist, r2):
            fh.write(f"chr1:1\tchr1:{1+d}\t{d}\t0\t0\t0\t{v:.6f}\n")
    lst = tmp_path / "files.txt"
    lst.write_text(str(ld) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "ngsld_tpu.tools.fit_decay", "--ld_files",
         str(lst), "--ld", "r2", "--n_ind", str(n_ind), "--fit_level", "3",
         "--seed", "3"], capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    row = dict(zip(lines[0].split("\t"), lines[1].split("\t")))
    assert abs(float(row["DecayRate"]) - rate) / rate < 0.25


# ------------------------------------------------------------ ld_blocks ----

def test_ld_blocks_plots(tmp_path):
    from ngsld_tpu import strict
    from ngsld_tpu.config import Params
    from ngsld_tpu.utils.simulate import simulate, write_all
    paths = write_all(simulate(n_ind=8, n_sites=150, seed=4), str(tmp_path))
    ld = tmp_path / "out.ld"
    strict.run(Params(in_geno=paths["beagle"], in_probs=True, n_ind=8,
                      n_sites=150, in_pos=paths["pos"], max_kb_dist=10,
                      out=str(ld)).finalize())
    chrom = open(paths["pos"]).readline().split("\t")[0]
    out = subprocess.run(
        [sys.executable, "-m", "ngsld_tpu.tools.ld_blocks", str(ld),
         f"{chrom}:1-10000", "--out_prefix", str(tmp_path / "blk")],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "blk.r2.pdf").exists()
    assert (tmp_path / "blk.Dp.pdf").exists()


def test_prune_nonfinite_weights(tmp_path):
    """Degenerate pairs print nan/inf r2; prune must skip them instead of
    overflowing the weight quantization."""
    ld = tmp_path / "x.ld"
    ld.write_text(
        "chr1:10\tchr1:20\t10\t0.5\t0.1\t0.9\tinf\n"
        "chr1:20\tchr1:30\t10\t0.5\t0.1\t0.9\tnan\n"
        "chr1:10\tchr1:30\t20\t0.5\t0.1\t0.9\t0.8\n")
    out = tmp_path / "kept.pos"
    from ngsld_tpu.tools.prune import main
    assert main(["--input", str(ld), "--output", str(out),
                 "--max_dist", "100", "--min_weight", "0.1"]) == 0
    kept = out.read_text().splitlines()
    # only the finite edge (10, 30) prunes one of its ends; 20 is edgeless
    assert "chr1:20" in kept and len(kept) == 2


def test_prune_self_loop_no_crash(tmp_path):
    """A row with identical labels (self-loop) must not crash the pruner."""
    ld = tmp_path / "x.ld"
    ld.write_text(
        "chr1:10\tchr1:10\t0\t0.5\t0.1\t0.9\t0.9\n"
        "chr1:10\tchr1:20\t10\t0.5\t0.1\t0.9\t0.8\n")
    out = tmp_path / "kept.pos"
    from ngsld_tpu.tools.prune import main
    assert main(["--input", str(ld), "--output", str(out),
                 "--max_dist", "100", "--min_weight", "0.1"]) == 0
    assert len(out.read_text().splitlines()) >= 1


def test_prune_negative_weights_still_prunes(tmp_path):
    """weight_type 'e' keeps raw (possibly negative) weights: the reference
    removes the max-weight node while ANY edges remain, so connected pairs
    must still be separated even when every weight is negative."""
    ld = tmp_path / "x.ld"
    ld.write_text("chr1:10\tchr1:20\t10\t0.5\t-0.1\t0.9\t0.8\n")
    out = tmp_path / "kept.pos"
    from ngsld_tpu.tools.prune import main
    assert main(["--input", str(ld), "--output", str(out), "--max_dist",
                 "100", "--min_weight", "-1", "--weight_type", "e",
                 "--field_weight", "5"]) == 0
    kept = out.read_text().splitlines()
    assert len(kept) == 1  # one end of the edge must be dropped


def test_fit_decay_bin_edges_right_closed(tmp_path):
    """Binning mirrors R's cut(): intervals (a, b], so an edge-exact
    distance joins the LOWER bin and dist == 0 is dropped."""
    import numpy as np

    from ngsld_tpu.tools.fit_decay import load_ld_file
    ld = tmp_path / "x.ld"
    rows = [("chr1:1", "chr1:2", "0", "0.9"),     # dist 0: dropped by cut
            ("chr1:1", "chr1:3", "250", "0.5"),   # edge: joins bin (0,250]
            ("chr1:1", "chr1:4", "251", "0.1")]   # next bin (250,500]
    ld.write_text("site1\tsite2\tdist\tr2\n" +
                  "".join("\t".join(r) + "\n" for r in rows))
    out = load_ld_file(str(ld), ["r2"], 0.0, float("inf"), False, 1.0,
                       250, 0)
    d, v = out["r2"]
    assert list(d) == [0.0, 250.0]
    np.testing.assert_allclose(v, [0.5, 0.1])


def test_prune_isolated_node_with_nonpositive_weights(tmp_path):
    """The reference takes max(weight) over ALL vertices: with all-negative
    edge weights, an isolated (weight-0) node is selected and DROPPED
    before the edged ones."""
    ld = tmp_path / "x.ld"
    ld.write_text("chr1:10\tchr1:20\t10\t0.5\t-0.1\t0.9\t0.8\n"
                  "chr1:30\tchr1:40\t999999\t0.5\t-0.1\t0.9\t0.8\n")
    out = tmp_path / "kept.pos"
    from ngsld_tpu.tools.prune import main
    # max_dist 100 filters the second row's edge -> chr1:30/40 isolated
    assert main(["--input", str(ld), "--output", str(out), "--max_dist",
                 "100", "--min_weight", "-1", "--weight_type", "e",
                 "--field_weight", "5"]) == 0
    kept = out.read_text().splitlines()
    # isolated weight-0 nodes drop first (reference semantics), then one
    # end of the negative-weight edge
    assert len(kept) == 1


def test_fit_decay_empty_file_ok(tmp_path):
    from ngsld_tpu.tools.fit_decay import load_ld_file
    ld = tmp_path / "x.ld"
    ld.write_text("site1\tsite2\tdist\tr2\n")
    out = load_ld_file(str(ld), ["r2"], 0.0, float("inf"), False, 1.0, 250, 0)
    d, v = out["r2"]
    assert len(d) == 0 and len(v) == 0


def test_prune_graph_pl_compat_aliases(tmp_path):
    """prune_graph.pl interface compat (prune_graph.pl:19-28): --in_file /
    --out / kb-denominated --max_kb_dist behave like --input / --output /
    --max_dist*1000."""
    ld = tmp_path / "x.ld"
    ld.write_text("chr1:10\tchr1:20\t5000\t0.5\t0.1\t0.9\t0.8\n"
                  "chr1:20\tchr1:30\t90000\t0.5\t0.1\t0.9\t0.7\n")
    from ngsld_tpu.tools.prune import main
    a, b = tmp_path / "a.pos", tmp_path / "b.pos"
    assert main(["--input", str(ld), "--output", str(a),
                 "--max_dist", "50000", "--min_weight", "0.5"]) == 0
    assert main(["--in_file", str(ld), "--out", str(b),
                 "--max_kb_dist", "50", "--min_weight", "0.5"]) == 0
    assert a.read_text() == b.read_text()
    import pytest
    with pytest.raises(SystemExit):   # mutually exclusive / required
        main(["--input", str(ld), "--min_weight", "0.5"])
    with pytest.raises(SystemExit):
        main(["--input", str(ld), "--min_weight", "0.5",
              "--max_dist", "1", "--max_kb_dist", "1"])


def _random_ld_rows(seed, n_nodes=40, n_edges=120):
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_edges):
        u, v = rng.integers(0, n_nodes, 2)
        if u == v:
            continue
        # two contigs, tie-prone quantized weights
        nu = f"chr{u % 2 + 1}:{100 + int(u) * 10}"
        nv = f"chr{v % 2 + 1}:{100 + int(v) * 10}"
        dist = int(rng.integers(1, 2000))
        w = round(float(rng.choice([-0.8, -0.2, 0.1, 0.25, 0.25, 0.7,
                                    0.9])), 4)
        rows.append(f"{nu}\t{nv}\t{dist}\t0\t0\t0\t{w}\n")
    return rows


@pytest.mark.parametrize("wt,keep_heavy", [("a", False), ("e", False),
                                           ("n", False), ("a", True)])
def test_prune_matches_reference_algorithm(tmp_path, wt, keep_heavy):
    """Diff ngsld-prune against a direct transcription of
    prune_ngsLD.py:104-186 (tests/oracle_prune.py) on randomized graphs —
    the reference-script oracle the property tests could not provide."""
    from ngsld_tpu.tools.prune import main
    from tests.oracle_prune import prune_reference

    for seed in (1, 2, 3, 4):
        rows = _random_ld_rows(seed)
        ld = tmp_path / f"g{seed}.ld"
        ld.write_text("".join(rows))
        out = tmp_path / f"k{seed}.pos"
        argv = ["--input", str(ld), "--output", str(out),
                "--max_dist", "1000", "--min_weight", "0.3",
                "--weight_type", wt]
        if keep_heavy:
            argv.append("--keep_heavy")
        assert main(argv) == 0
        kept, _ = prune_reference(rows, max_dist=1000, min_weight=0.3,
                                  weight_type=wt, keep_heavy=keep_heavy)
        assert out.read_text().splitlines() == kept, (wt, keep_heavy, seed)


def test_prune_golden_real_ld_output(tmp_path):
    """Golden regression: prune a REAL strict-engine .ld file and pin the
    kept set against the committed golden (generated by the reference-
    algorithm oracle, tests/golden/prune_kept.pos)."""
    import os

    from ngsld_tpu.tools.prune import main
    from tests.oracle_prune import prune_reference

    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "prune_kept.pos")
    from ngsld_tpu import strict
    from ngsld_tpu.config import Params
    from ngsld_tpu.utils.simulate import simulate, write_all
    files = write_all(simulate(n_ind=10, n_sites=150, seed=19),
                      str(tmp_path / "fx"))
    ld = tmp_path / "x.ld"
    strict.run(Params(in_geno=files["beagle"], in_probs=True, n_ind=10,
                      n_sites=150, in_pos=files["pos"], max_kb_dist=5,
                      out=str(ld), verbose=0).finalize())
    out = tmp_path / "kept.pos"
    assert main(["--input", str(ld), "--output", str(out), "--max_dist",
                 "3000", "--min_weight", "0.2"]) == 0
    rows = ld.read_text().splitlines()[1:]
    kept, _ = prune_reference(rows, max_dist=3000, min_weight=0.2)
    assert out.read_text().splitlines() == kept
    with open(golden) as fh:
        assert out.read_text() == fh.read()


def test_fit_decay_recovers_known_decay(tmp_path):
    """Golden-style oracle for ngsld-fit-decay: data generated from the
    exact Hill & Weir expectation with known parameters must fit back to
    those parameters (fit_LDdecay.R:179-247 objective)."""
    import numpy as np

    from ngsld_tpu.tools.fit_decay import _fit_one, ld_exp

    rng = np.random.default_rng(5)
    dist = rng.integers(1, 100000, 4000).astype(float)
    rho_true, n_ind = 8e-5, 50
    r2 = ld_exp([rho_true, 0, 0], dist, "r2", n_ind, 1.0)
    r2 = np.clip(r2 + rng.normal(0, 0.004, len(dist)), 0, 1)
    par = _fit_one(dist, r2, "r2", n_ind, 1.0, fit_level=3,
                   rng=np.random.default_rng(1))
    assert par is not None
    assert abs(par[0] - rho_true) / rho_true < 0.08, par


# ---------------------------------------------------------------- merge ----

def test_merge_discovers_and_concatenates(tmp_path):
    """ngsld-merge STEM finds STEM.part*, keeps one header, preserves part
    order (the pod workflow closer; /root/reference/ngsLD.cpp:72-77 shape)."""
    from ngsld_tpu.tools.merge import main as merge_main

    hdr = "site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n"
    (tmp_path / "o.ld.part00000").write_text(hdr + "a\tb\t1\t0\t0\t0\t0\n")
    (tmp_path / "o.ld.part00001").write_text("c\td\t2\t0\t0\t0\t0\n")
    (tmp_path / "o.ld.part00002").write_text("e\tf\t3\t0\t0\t0\t0\n")
    stem = str(tmp_path / "o.ld")
    assert merge_main([stem]) == 0
    got = (tmp_path / "o.ld").read_text()
    assert got == (hdr + "a\tb\t1\t0\t0\t0\t0\n" + "c\td\t2\t0\t0\t0\t0\n"
                   + "e\tf\t3\t0\t0\t0\t0\n")


def test_merge_drops_duplicate_headers_and_deletes(tmp_path):
    from ngsld_tpu.tools.merge import main as merge_main

    hdr = "site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n"
    p0 = tmp_path / "x.part00000"
    p1 = tmp_path / "x.part00001"
    p0.write_text(hdr + "a\tb\t1\t0\t0\t0\t0\n")
    p1.write_text(hdr + "c\td\t2\t0\t0\t0\t0\n")   # re-merge scenario
    out = tmp_path / "merged.ld"
    assert merge_main(["--out", str(out), "--delete-parts",
                       str(p0), str(p1)]) == 0
    assert out.read_text().count("site1\t") == 1
    assert "c\td" in out.read_text()
    assert not p0.exists() and not p1.exists()


def test_merge_part_order_numeric(tmp_path):
    """Part index 10 must come after 9 (numeric, not lexicographic)."""
    from ngsld_tpu.tools.merge import discover_parts

    for i in (0, 9, 10, 2):
        (tmp_path / f"y.part{i:05d}").write_text("")
    # a 5-digit-padded glob hit plus an unpadded straggler
    (tmp_path / "y.part7").write_text("")
    parts = discover_parts(str(tmp_path / "y"))
    idx = [int(p.rsplit("part", 1)[1]) for p in parts]
    assert idx == sorted(idx) == [0, 2, 7, 9, 10]


def test_merge_missing_inputs_error(tmp_path):
    from ngsld_tpu.tools.merge import main as merge_main

    assert merge_main([str(tmp_path / "nope")]) == 1


def test_n_threads_validation():
    """parse_args.cpp:182-183 parity: n_threads < 1 is fatal."""
    import pytest as _pytest

    from ngsld_tpu.config import ConfigError, Params

    with _pytest.raises(ConfigError, match="number of threads cannot be less than 1!"):
        Params(in_geno="x", n_ind=1, n_sites=1, max_kb_dist=0,
               n_threads=0).finalize()


def test_bench_compact_line_stays_small():
    """bench.py's last stdout line is read from a tail window: pin the
    contract — the compact line stays < 1.2 KB with the headline fields
    FIRST, even with every leg populated."""
    import importlib.util
    import json
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).parent.parent / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    detail = {
        "device": "NVIDIA H100 80GB HBM3",
        "power_limit": "NVIDIA H100 80GB HBM3, 700.00 W",
        "em_kernel": {p: {"kernel_ms": 12.3456789, "xla_ms": 98.7654321,
                          "kernel_evals_per_sec": 4.2123456e11}
                      for p in ("f64", "f32")},
    }
    for leg in ("e2e", "e2e_sampled"):
        detail[leg] = {"wall_s": 162.4123, "rows": 17_900_000,
                       "speedup_vs_reference": 4.20123,
                       "phases": {"x" * 40: 1.0}}
    compact = {"metric": "pair_em_evals_per_sec",
               "value": bench._r4(4.2123456e11), "unit": "pair*ind*iter/s",
               "detail": bench._compact_detail(detail)}
    line = json.dumps(compact, separators=(",", ":"))
    assert len(line) < 1200, len(line)
    assert line.startswith('{"metric":"pair_em_evals_per_sec","value":')
    parsed = json.loads(line)
    assert parsed["value"] == 4.212e11
    assert parsed["detail"]["e2e"]["x"] == 4.201
    assert parsed["detail"]["em_f64"] == {"kernel_ms": 12.35,
                                          "xla_ms": 98.77}
    assert "phases" not in parsed["detail"]["e2e"]
