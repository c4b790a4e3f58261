#!/usr/bin/env python3
"""Bring-up check of the ngsld GPU engine on one NVIDIA card.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # the multi-card CLI paths only

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one would fail): the CLI through
ngsld_tpu.cli.main(argv), and the strict oracle on the host.

Phases (one card), in this order:
  device    — nvidia-smi name and power limit, jax.devices(); fails
              unless JAX's platform is 'gpu'
  scale     — 100k x 100 kb100 (17.9M pairs) and 20k x 2,000
              --max_kb_dist 0 --max_snp_dist 50 (~1M pairs) through the CLI: row count against the
              plan, >= 10,000 sampled rows against the strict per-pair
              pipeline; wall time, phase split, peak device memory
  correct   — 5,000 sites x 100 individuals, --max_kb_dist 100
              --extend_out, in three input variants, f64 and f32,
              against the full --engine strict output
  kernel    — the pair-EM kernel compiled for the card at 512k pairs,
              I = 100 and 2,000, f32 and f64: memory analysis, timing
              against ops.em.pair_em (the XLA loop), values against it
              and 2,000 sampled pairs against strict.pair_em_batch

--four-cards runs the 100k x 100 kb100 fixture under --shard 4,
--shard 2 --shard_ind 2 and --ring --shard 4 --ring_sub 8 and compares
each with the one-card output of the same fixture.

The last stdout line is {"ok": true, "device": {...}} and is printed only
when every phase passed on a GPU. --rehearse runs the same code at tiny
sizes on whatever JAX finds (the kernel in interpret mode) and never
prints that line. Work files and report.json go to .smoke/ in the
checkout.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FULL = dict(kern_p=1 << 19, kern_i=(100, 2000), strict_pairs=2000,
            corr=(5000, 100), dense=(100_000, 100), cohort=(20_000, 2000),
            sample_rows=10_000)
TINY = dict(kern_p=256, kern_i=(12, 300), strict_pairs=64,
            corr=(300, 12), dense=(2000, 12), cohort=(500, 40),
            sample_rows=200)

# f64: the printed 6th decimal (a unit of %f, plus its rounding); f32:
# the documented 1e-4 (README, Conformance). Rows whose nIter differs sit
# on a convergence knife-edge: the EM stops an update or two apart, so
# the frequencies may move by up to the 1e-5 stop tolerance, and the
# ratios D', r2 and chi2 by that over their hap-MAF denominator. f32 sums
# round differently in two implementations, so near a slowly converging
# stop nIter may move by 2 (the engine tests' rule, tests/test_engine.py);
# in f64 by at most 1.
TOL = {"f64": 2e-6, "f32": 1e-4}
KNIFE_TOL = 2e-5
NITER_TOL = {"f64": 1, "f32": 2}


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def card_name_and_limit():
    """nvidia-smi's name and power limit, from a child that stays off
    JAX."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---- row comparison ----------------------------------------------------

def compare_lines(ref, got, prec, where):
    """Rows of two outputs in the same order: identical (site1, site2,
    dist) and numeric columns within TOL[prec]. Hap-MAF denominators
    below 1e-3 make D'/r2 (columns 5, 6) and chi2 (16) ratios of noise:
    there D'/r2 get a denominator-scaled bound and chi2 is not compared
    (the test suite's rule). Returns the largest deviation seen."""
    check(len(ref) == len(got),
          f"{where}: {len(got)} rows vs {len(ref)} expected")
    worst = 0.0
    n_knife = 0
    tol = TOL[prec]
    for a, b in zip(ref, got):
        if a == b:
            continue
        fa, fb = a.split("\t"), b.split("\t")
        check(fa[:3] == fb[:3], f"{where}: pair set differs: {a!r} vs {b!r}")
        knife = len(fa) > 18 and fa[18] != fb[18]
        if knife:
            n_knife += 1
            check(abs(int(fa[18]) - int(fb[18])) <= NITER_TOL[prec],
                  f"{where}: nIter {fa[18]} vs {fb[18]}")
        den = 1.0
        if len(fa) > 13:
            hap = [float(v) for v in fa[10:14]]
            m0, m1 = 1 - (hap[0] + hap[1]), 1 - (hap[0] + hap[2])
            den = min(abs(m0 * m1), abs((1 - m0) * (1 - m1)),
                      abs(m0 * (1 - m1)), abs((1 - m0) * m1))
        fragile = den < 1e-3
        for c in range(3, len(fa)):
            if c == 18 or (fragile and c == 16):
                continue
            x, y = float(fa[c]), float(fb[c])
            if not (np.isfinite(x) and np.isfinite(y)):
                check(x == y or (np.isnan(x) and np.isnan(y)),
                      f"{where}: column {c}: {a!r} vs {b!r}")
                continue
            t = tol
            if knife:
                t = max(tol, KNIFE_TOL)
                if c in (5, 6, 16):
                    t = max(t, KNIFE_TOL / max(den, 1e-12))
            if fragile and c in (5, 6):
                t += 6e-6 / max(den, 1e-12)
            d = abs(x - y)
            check(d <= t, f"{where}: column {c} off by {d:.3g} "
                          f"(> {t:.3g}): {a!r} vs {b!r}")
            worst = max(worst, d)
    return {"rows": len(ref), "max_dev": worst, "knife_rows": n_knife}


def iter_lines(path):
    with open(path, "rb") as fh:
        for ln in fh:
            yield ln.decode().rstrip("\n")


def compare_files(ref_path, got_path, prec, where, chunk=200_000):
    """compare_lines over two large outputs, streamed in chunks."""
    stats = {"rows": 0, "max_dev": 0.0, "knife_rows": 0}
    ra, rb = iter_lines(ref_path), iter_lines(got_path)
    while True:
        a = [ln for _, ln in zip(range(chunk), ra)]
        b = [ln for _, ln in zip(range(chunk), rb)]
        if not a and not b:
            return stats
        s = compare_lines(a, b, prec, where)
        stats["rows"] += s["rows"]
        stats["knife_rows"] += s["knife_rows"]
        stats["max_dev"] = max(stats["max_dev"], s["max_dev"])


def sha(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for blk in iter(lambda: fh.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


# ---- phases --------------------------------------------------------------

def phase_device(rehearse, card):
    import jax
    log(card)   # nvidia-smi's own line(s)
    log("jax.devices():", jax.devices())
    check(rehearse or jax.devices()[0].platform == "gpu",
          f"JAX platform is {jax.devices()[0].platform!r}, not 'gpu'")


def _em_table(I, seed):
    """A simulated (S, I, 3) normal-space GL table and its MAFs (host)."""
    from ngsld_tpu.utils.simulate import simulate
    S = min(20_000, max(1024, (256 << 20) // (I * 24)))
    sim = simulate(n_ind=I, n_sites=S, seed=seed)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    return gl, (gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2


def _em_inputs(gl, maf, P, dt, seed):
    """P random site pairs of the table, gathered on the device; the host
    copies of the first pairs feed the strict oracle."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    i1, i2 = rng.integers(0, len(gl), P), rng.integers(0, len(gl), P)
    take = jax.jit(lambda g, m, i, j: (jnp.take(g, i, axis=0),
                                       jnp.take(g, j, axis=0),
                                       jnp.take(m, i), jnp.take(m, j)))
    out = take(jnp.asarray(gl.astype(dt)), jnp.asarray(maf.astype(dt)),
               jnp.asarray(i1, jnp.int32), jnp.asarray(i2, jnp.int32))
    return out, (i1, i2)


def _best_of(fn, args, reps=3):
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_kernel(sz, rehearse, card):
    import jax
    import jax.numpy as jnp
    from ngsld_tpu import strict
    from ngsld_tpu.compute import device_bytes_limit, max_block_pairs
    from ngsld_tpu.kernels.em_gpu import pair_em_gpu
    from ngsld_tpu.ops.em import pair_em

    jax.config.update("jax_enable_x64", True)
    limit = device_bytes_limit()
    kern = jax.jit(lambda *a: pair_em_gpu(*a, True, interpret=rehearse))
    xla = jax.jit(lambda *a: pair_em(*a, True))
    res = {}
    for I in sz["kern_i"]:
        gl, maf = _em_table(I, seed=I)
        for prec, dt in (("f32", np.float32), ("f64", np.float64)):
            P = sz["kern_p"]
            shapes = ([jax.ShapeDtypeStruct((P, I, 3), dt)] * 2
                      + [jax.ShapeDtypeStruct((P,), dt)] * 2)
            t0 = time.perf_counter()
            compiled = kern.trace(*shapes).lower().compile()
            t_comp = time.perf_counter() - t0
            log(f"[kernel] I={I} {prec} P={P}: compiled in {t_comp:.2f} s;"
                f" memory_analysis: {compiled.memory_analysis()}")
            # run and compare at the engine's own block cap where 512k
            # gathered pairs plus the XLA loop's temporaries would not fit
            if limit is not None:
                P = min(P, max_block_pairs(I, np.dtype(dt).itemsize, limit))
            (g1, g2, m1, m2), (i1, i2) = _em_inputs(gl, maf, P, dt, seed=I)
            tk, got = _best_of(kern, (g1, g2, m1, m2))
            tx, want = _best_of(xla, (g1, g2, m1, m2))
            f_k, it_k, nu_k = (np.asarray(v) for v in got)
            f_x, it_x, nu_x = (np.asarray(v) for v in want)
            nan = np.isnan(f_k) & np.isnan(f_x)
            dev = float(np.abs(np.where(nan, 0, f_k)
                               - np.where(nan, 0, f_x)).max())
            tol = 3e-5 if prec == "f32" else 1e-10
            check(dev <= tol, f"kernel I={I} {prec}: f off by {dev:.3g}")
            check((nu_k == nu_x).all(), f"kernel I={I} {prec}: n_used")
            # knife-edges: n_iter within NITER_TOL on at most 0.5% of the
            # pairs in f64; f32 sums round differently in the two
            # implementations, so there on at most 1%
            dit = np.abs(it_k.astype(np.int64) - it_x)
            knife = float((dit > 0).mean())
            share = 0.01 if prec == "f32" else 0.005
            r = {"pairs": P, "compile_s": t_comp, "kernel_ms": tk * 1e3,
                 "xla_ms": tx * 1e3, "f_max_dev": dev, "n_iter_knife": knife,
                 "n_iter_dev_hist": np.bincount(dit).tolist(),
                 "mean_iters": float(it_k.mean())}
            check(dit.max() <= NITER_TOL[prec]
                  and (dit > 0).sum() <= max(2, share * P),
                  f"kernel I={I} {prec}: n_iter differs on {knife:.4%}: "
                  f"{json.dumps(r)}")
            if prec == "f64":
                n = min(sz["strict_pairs"], P)
                sel = np.random.default_rng(0).choice(P, n, replace=False)
                a, b = i1[sel], i2[sel]
                fs, its, nus = strict.pair_em_batch(gl[a], gl[b], maf[a],
                                                    maf[b], True)
                ds = float(np.nan_to_num(np.abs(fs - f_k[sel])).max())
                check(ds <= 1e-10, f"kernel I={I}: strict f off by {ds:.3g}")
                check((nus == nu_k[sel]).all(), f"kernel I={I}: strict n_used")
                dis = np.abs(its - it_k[sel])
                check(dis.max() <= NITER_TOL[prec]
                      and (dis > 0).sum() <= max(2, share * n),
                      f"kernel I={I}: strict n_iter")
                r["strict_pairs"] = n
                r["strict_f_max_dev"] = ds
            log(f"[kernel] I={I} {prec} P={P}: kernel {tk * 1e3:.3f} ms, "
                f"XLA {tx * 1e3:.3f} ms ({card}); {json.dumps(r)}")
            res[f"I{I}_{prec}"] = r
            del g1, g2, m1, m2, got, want
    return res


def _run_cli(argv, out):
    """One in-process CLI run; (wall seconds, phase timings)."""
    import jax
    from ngsld_tpu.cli import main
    tj = out + ".timings.json"
    os.environ["NGSLD_TIMINGS_JSON"] = tj
    try:
        t0 = time.perf_counter()
        rc = main(argv + ["--out", out])
        dt = time.perf_counter() - t0
    finally:
        del os.environ["NGSLD_TIMINGS_JSON"]
    check(rc == 0, f"ngsld {' '.join(argv)} exited {rc}")
    try:
        with open(tj) as fh:
            timings = json.load(fh)
    except (OSError, ValueError):
        timings = {}
    stats = jax.devices()[0].memory_stats() or {}
    return dt, timings.get("phases", {}), stats.get("peak_bytes_in_use")


def phase_correct(sz, work):
    from ngsld_tpu.cli import main
    from ngsld_tpu.utils.simulate import simulate, write_all
    S, I = sz["corr"]
    files = write_all(simulate(n_ind=I, n_sites=S, seed=11),
                      os.path.join(work, "corr"))
    common = ["--n_ind", str(I), "--n_sites", str(S), "--pos",
              files["pos"], "--max_kb_dist", "100", "--extend_out",
              "--verbose", "0"]
    variants = {
        "binary": ["--geno", files["glf"], "--log_scale"],
        "beagle": ["--geno", files["beagle"], "--probs", "--min_maf",
                   "0.05"],
        "call_geno": ["--geno", files["glf"], "--log_scale", "--call_geno",
                      "--ignore_miss_data", "--rnd_sample", "0.1",
                      "--seed", "12345"],
    }
    res = {}
    for name, argv in variants.items():
        ref = os.path.join(work, f"{name}.strict.ld")
        t0 = time.perf_counter()
        check(main(argv + common + ["--engine", "strict", "--out", ref])
              == 0, f"strict {name} failed")
        t_strict = time.perf_counter() - t0
        ref_lines = list(iter_lines(ref))
        for prec in ("f64", "f32"):
            out = os.path.join(work, f"{name}.{prec}.ld")
            dt, _, _ = _run_cli(argv + common + ["--engine", "jax",
                                                 "--precision", prec], out)
            s = compare_lines(ref_lines, list(iter_lines(out)), prec,
                              f"correct/{name}/{prec}")
            s.update(wall_s=dt, strict_s=t_strict)
            log(f"[correct] {name} {prec}: {json.dumps(s)}")
            res[f"{name}_{prec}"] = s
            check(s["rows"] > 100, f"correct/{name}: too few rows")
            os.unlink(out)
        os.unlink(ref)
    return res


def _sampled_check(argv_in, out, n_sample, prec, where):
    """Recompute n_sample random output rows with the strict per-pair
    pipeline (refine.StrictRefiner: the bit-exact strict functions) and
    compare them as in the correctness phase."""
    from ngsld_tpu.cli import params_from_args
    from ngsld_tpu.io.writer import RowWriter
    from ngsld_tpu.refine import StrictRefiner
    from ngsld_tpu.strict import read_pos
    pars = params_from_args(argv_in + ["--engine", "strict"])
    _, labels = read_pos(pars.in_pos, pars.in_pos_header, pars.n_sites)
    labels = list(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    n_rows = sum(1 for _ in iter_lines(out)) - 1
    rng = np.random.default_rng(7)
    want = set(rng.choice(n_rows, min(n_sample, n_rows), replace=False)
               .tolist())
    got = []
    for k, ln in enumerate(iter_lines(out)):
        if k and (k - 1) in want:
            got.append(ln)
    fields = [ln.split("\t") for ln in got]
    s1 = np.array([index[f[0]] for f in fields], np.int64)
    s2 = np.array([index[f[1]] for f in fields], np.int64)
    dist = np.array([float(f[2]) for f in fields])
    c = StrictRefiner(pars).refine_columns(s1, s2)
    text = RowWriter(None, labels, True).format_block(
        s1, s2, dist, c["r2p"], c["D"], c["Dp"], c["r2"],
        n_used=c["n_used"], maf1=c["maf1"], maf2=c["maf2"], hap=c["f"],
        hmaf1=c["hmaf1"], hmaf2=c["hmaf2"], chi2=c["chi2"],
        n_iter=c["n_iter"]).decode().rstrip("\n").split("\n")
    s = compare_lines(text, got, prec, where)
    s["rows_total"] = n_rows
    return s


def _plan_rows(pos_path, n_sites, kb, snp):
    from ngsld_tpu.plan.band import band_limits
    from ngsld_tpu.strict import read_pos
    pos_dist, _ = read_pos(pos_path, False, n_sites)
    hi = band_limits(pos_dist, kb, snp)
    return int(np.maximum(np.minimum(hi, n_sites) - np.arange(n_sites) - 1,
                          0).sum())


def _bin_fixture(work, tag, S, I, **kw):
    from ngsld_tpu.utils.simulate import simulate, write_glf_bin, write_pos
    d = os.path.join(work, f"{tag}_{S}x{I}")
    os.makedirs(d, exist_ok=True)
    glf, pos = os.path.join(d, "sim.glf"), os.path.join(d, "sim.pos")
    if not (os.path.exists(glf) and os.path.exists(pos)):
        sim = simulate(n_ind=I, n_sites=S, seed=17, **kw)
        write_glf_bin(sim, glf)
        write_pos(sim, pos)
        del sim
    return glf, pos


def _dense_argv(sz, work):
    S, I = sz["dense"]
    glf, pos = _bin_fixture(work, "dense", S, I, contig_kb=500.0)
    return (["--geno", glf, "--log_scale", "--n_ind", str(I), "--n_sites",
             str(S), "--pos", pos, "--max_kb_dist", "100", "--extend_out"],
            pos, S)


def phase_scale(sz, work, card):
    res = {}
    argv, pos, S = _dense_argv(sz, work)
    cohort_S, cohort_I = sz["cohort"]
    glf2, pos2 = _bin_fixture(work, "cohort", cohort_S, cohort_I)
    runs = {
        "dense": (argv, pos, S, 100, 0),
        "cohort": (["--geno", glf2, "--log_scale", "--n_ind",
                    str(cohort_I), "--n_sites", str(cohort_S), "--pos",
                    pos2, "--max_kb_dist", "0", "--max_snp_dist", "50",
                    "--extend_out"],
                   pos2, cohort_S, 0, 50),
    }
    for name, (a, p, n, kb, snp) in runs.items():
        out = os.path.join(work, f"{name}.ld")
        dt, phases, peak = _run_cli(a + ["--engine", "jax", "--verbose",
                                         "2"], out)
        rows = sum(1 for _ in iter_lines(out)) - 1
        plan = _plan_rows(p, n, kb, snp)
        check(rows == plan, f"scale/{name}: {rows} rows, plan has {plan}")
        s = _sampled_check(a, out, sz["sample_rows"], "f64",
                           f"scale/{name}")
        s.update(sampled=s.pop("rows"), wall_s=dt, rows=rows,
                 peak_bytes_in_use=peak, phases=phases)
        log(f"[scale] {name} ({card}): {json.dumps(s)}")
        res[name] = s
        os.unlink(out)
    return res


def phase_four_cards(sz, work, card):
    import jax
    check(len(jax.devices()) >= 4,
          f"--four-cards needs 4 devices, JAX has {len(jax.devices())}")
    argv, _, _ = _dense_argv(sz, work)
    argv = argv + ["--engine", "jax", "--verbose", "2"]
    one = os.path.join(work, "one.ld")
    dt1, _, _ = _run_cli(argv, one)
    res = {"one_card_s": dt1}
    log(f"[four] one card: {dt1:.3f} s")
    for name, extra, exact in (
            ("shard4", ["--shard", "4"], True),
            ("shard2_ind2", ["--shard", "2", "--shard_ind", "2"], False),
            ("ring4", ["--ring", "--shard", "4", "--ring_sub", "8"], False)):
        out = os.path.join(work, f"{name}.ld")
        dt, _, _ = _run_cli(argv + extra, out)
        if exact:
            check(sha(out) == sha(one),
                  f"four/{name}: not byte-identical to one card")
            s = {"identical": True}
        else:
            s = compare_files(one, out, "f64", f"four/{name}")
        s["wall_s"] = dt
        log(f"[four] {name} ({card}): {json.dumps(s)}")
        res[name] = s
        os.unlink(out)
    os.unlink(one)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card paths against one card")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any platform; prints no result")
    args = ap.parse_args()

    import ngsld_tpu  # noqa: F401  (fails outside a checkout)
    from ngsld_tpu.engine import enable_compile_cache
    import jax
    enable_compile_cache()
    sz = TINY if args.rehearse else FULL
    work = os.path.join(HERE, ".smoke")
    os.makedirs(work, exist_ok=True)
    card = card_name_and_limit()

    t0 = time.perf_counter()
    phase_device(args.rehearse, card)
    report = {}
    if args.four_cards:
        report["four_cards"] = phase_four_cards(sz, work, card)
    else:
        # scale runs first: peak_bytes_in_use is the process's peak so
        # far, so each scale run's peak is its own there (the cohort run
        # needs more than the dense one); the kernel phase allocates more
        report["scale"] = phase_scale(sz, work, card)
        report["correct"] = phase_correct(sz, work)
        report["kernel"] = phase_kernel(sz, args.rehearse, card)
    report["total_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    log(f"all phases passed in {report['total_s']:.1f} s on {card}")
    if args.rehearse:
        return 3   # a rehearsal is never a result
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
