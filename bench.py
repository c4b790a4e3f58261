"""Benchmark on one NVIDIA GPU: the pair-EM kernel and end-to-end CLI runs.

Legs:
  * em_kernel — kernels.em_gpu.pair_em_gpu against ops.em.pair_em (the
    XLA while_loop) on one gathered 512k-pair block at I = 100, in f64
    (the engine's default precision) and f32; warm, best of 5, each call
    ending in block_until_ready
  * e2e — 100k sites x 100 individuals, --max_kb_dist 100 --extend_out
    (BASELINE.json), through ngsld_tpu.cli.main in THIS process
  * e2e_sampled — 1M sites, --max_snp_dist 64 --rnd_sample 0.05
  * reference baselines — the same fixtures through the reference binary
    where tests/refshim can build it (a CPU-only child process)

One process holds the card: the CLI legs run in-process, and nothing else
opens the GPU. Without a GPU the bench exits non-zero and prints no result.

The final stdout line is a compact JSON object (headline first, floats at
4 significant digits); the full detail goes to .bench/BENCH_DETAIL.json.
Fixtures and reference times are kept under .bench/ in the checkout.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".bench")
DETAIL_PATH = os.path.join(WORK, "BENCH_DETAIL.json")
REF_CACHE = os.path.join(WORK, "ref_times.json")

RESULT = {"metric": "pair_em_evals_per_sec", "value": 0.0,
          "unit": "pair*ind*iter/s", "detail": {}}

# flops per (pair, individual, iteration) of the EM update: D_k (48),
# s (7), masked reciprocal (1), D*r and the sum (8); the per-pair tail
# adds <1% at I = 100
FLOPS_PER_EVAL = 64


def _r4(x):
    """4 significant digits — keeps the compact line small and stable."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    return x


def _compact_detail(d):
    """Shrink the full detail dict to headline numbers (< ~1.5 KB)."""
    c = {}
    for k in ("device", "power_limit"):
        if k in d:
            c[k] = d[k]
    k = d.get("em_kernel")
    if isinstance(k, dict):
        for prec in ("f64", "f32"):
            v = k.get(prec)
            if isinstance(v, dict):
                c[f"em_{prec}"] = {"kernel_ms": _r4(v.get("kernel_ms")),
                                   "xla_ms": _r4(v.get("xla_ms"))}
    for leg, short in (("e2e", "e2e"), ("e2e_sampled", "samp")):
        v = d.get(leg)
        if not isinstance(v, dict):
            continue
        e = {}
        if "wall_s" in v:
            e["s"] = _r4(v["wall_s"])
        if "speedup_vs_reference" in v:
            e["x"] = _r4(v["speedup_vs_reference"])
        if "error" in v:
            e["err"] = 1
        if e:
            c[short] = e
    if "error" in d:
        c["error"] = str(d["error"])[:200]
    c["full"] = ".bench/BENCH_DETAIL.json"
    return c


def _emit():
    os.makedirs(WORK, exist_ok=True)
    with open(DETAIL_PATH, "w") as fh:
        json.dump(RESULT, fh, indent=1)
        fh.write("\n")
    compact = {"metric": RESULT["metric"], "value": _r4(RESULT["value"]),
               "unit": RESULT["unit"],
               "detail": _compact_detail(RESULT["detail"])}
    print(json.dumps(compact, separators=(",", ":")), flush=True)


def card_name_and_limit():
    """`nvidia-smi` name and power limit (a child that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def _sim_tables(S, I, seed=0):
    from ngsld_tpu.utils.simulate import simulate
    sim = simulate(n_ind=I, n_sites=S, seed=seed)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gl[..., 1] + 2 * gl[..., 2]
    return gl, eg.mean(axis=1) / 2


def timeit(fn, *args, reps=5):
    """Best-of-reps wall time of fn(*args) after one warm-up call."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def em_kernel_bench(P=1 << 19, I=100):
    """Kernel (a) against the XLA loop on the same gathered block."""
    import jax
    import jax.numpy as jnp
    from ngsld_tpu.kernels.em_gpu import pair_em_gpu
    from ngsld_tpu.ops.em import pair_em

    gl, maf = _sim_tables(60000, I)
    rng = np.random.default_rng(1)
    i1, i2 = rng.integers(0, len(gl), P), rng.integers(0, len(gl), P)
    res = {"n_pairs": P, "n_ind": I}
    for prec, dt in (("f64", np.float64), ("f32", np.float32)):
        args = [jnp.asarray(x.astype(dt)) for x in
                (gl[i1], gl[i2], maf[i1], maf[i2])]
        tk, (f, it, _) = timeit(jax.jit(lambda *a: pair_em_gpu(*a, False)),
                                *args)
        tx, _ = timeit(jax.jit(lambda *a: pair_em(*a, False)), *args)
        evals = float((np.asarray(it).astype(np.int64) + 1).sum()) * I
        res[prec] = {"kernel_ms": tk * 1e3, "xla_ms": tx * 1e3,
                     "kernel_evals_per_sec": evals / tk,
                     "xla_evals_per_sec": evals / tx,
                     "kernel_tflops": evals * FLOPS_PER_EVAL / tk / 1e12,
                     "mean_iters": evals / I / P}
        del args, f, it
    RESULT["value"] = res["f64"]["kernel_evals_per_sec"]
    return res


# ---- fixtures ---------------------------------------------------------

def _fixture(n_sites, tag, contig_kb=None):
    fixdir = os.path.join(WORK, f"fix_{tag}")
    glf = os.path.join(fixdir, "sim.glf")
    pos = os.path.join(fixdir, "sim.pos")
    if not (os.path.exists(glf) and os.path.exists(pos)):
        from ngsld_tpu.utils.simulate import simulate, write_glf_bin, \
            write_pos
        os.makedirs(fixdir, exist_ok=True)
        kw = {"contig_kb": contig_kb} if contig_kb else {}
        sim = simulate(n_ind=100, n_sites=n_sites, seed=17, **kw)
        write_glf_bin(sim, glf)
        write_pos(sim, pos)
    return glf, pos


def _cli_argv(glf, pos, n_sites, extra):
    return ["--geno", glf, "--log_scale", "--n_ind", "100", "--n_sites",
            str(n_sites), "--pos", pos] + extra


def run_cli(argv, out):
    """One in-process CLI run: wall time, row count and the engine's
    phase/stage split (via NGSLD_TIMINGS_JSON)."""
    from ngsld_tpu.cli import main
    tj = out + ".timings.json"
    os.environ["NGSLD_TIMINGS_JSON"] = tj
    try:
        t0 = time.perf_counter()
        rc = main(argv + ["--engine", "jax", "--out", out, "--verbose", "2"])
        dt = time.perf_counter() - t0
    finally:
        os.environ.pop("NGSLD_TIMINGS_JSON", None)
    if rc != 0:
        return {"error": f"ngsld exited {rc}"}
    with open(out, "rb") as fh:
        rows = sum(chunk.count(b"\n")
                   for chunk in iter(lambda: fh.read(1 << 20), b"")) - 1
    res = {"wall_s": dt, "rows": rows, "rows_per_sec": rows / dt}
    try:
        with open(tj) as fh:
            res.update(json.load(fh))
    except (OSError, ValueError):
        pass
    return res


E2E = {
    "e2e": (100_000, "100k", 500.0, ["--max_kb_dist", "100",
                                      "--extend_out"]),
    "e2e_sampled": (1_000_000, "1m", None,
                    ["--max_kb_dist", "0", "--max_snp_dist", "64",
                     "--rnd_sample", "0.05", "--seed", "12345",
                     "--extend_out"]),
}


def e2e_bench(key):
    n_sites, tag, contig_kb, extra = E2E[key]
    glf, pos = _fixture(n_sites, tag, contig_kb)
    res = run_cli(_cli_argv(glf, pos, n_sites, extra),
                  os.path.join(WORK, f"{key}.ld"))
    res["config"] = f"{n_sites} sites x 100, " + " ".join(extra)
    return res


def e2e_em_compare(key="e2e"):
    """The e2e leg with the kernel and with the XLA loop as the GPU's pair
    EM: one untimed warm-up run of each, then kernel, XLA, XLA, kernel.
    The end-to-end test that decides whether the kernel stays the GPU's
    EM."""
    from ngsld_tpu import compute
    n_sites, tag, contig_kb, extra = E2E[key]
    glf, pos = _fixture(n_sites, tag, contig_kb)
    argv = _cli_argv(glf, pos, n_sites, extra)
    impl = compute.EM_IMPLS["gpu"]
    res = {k: [] for k in ("pallas-triton", "xla")}
    try:
        for i, em in enumerate(("pallas-triton", "xla", "pallas-triton",
                                "xla", "xla", "pallas-triton")):
            compute.EM_IMPLS["gpu"] = em
            compute._compute_block_fn.cache_clear()
            r = run_cli(argv, os.path.join(WORK, f"{key}_{em}.ld"))
            if i >= 2:   # the first two compile
                res[em].append({k: r.get(k) for k in ("wall_s", "rows",
                                                      "error", "phases")})
    finally:
        compute.EM_IMPLS["gpu"] = impl
        compute._compute_block_fn.cache_clear()
    return res


# ---- reference baseline (CPU child; never opens the card) -------------

def ref_measure(key, argv, timeout):
    """Time the reference binary on the fixture an e2e leg used; cached
    per (config, fixture signature) under .bench/."""
    files = [argv[1], argv[argv.index("--pos") + 1]]
    sig = hashlib.sha1((key + "|" + "|".join(
        f"{os.path.getsize(f)}:{int(os.path.getmtime(f))}" for f in files)
        ).encode()).hexdigest()[:16]
    try:
        with open(REF_CACHE) as fh:
            cache = json.load(fh)
    except (OSError, ValueError):
        cache = {}
    if sig in cache:
        return dict(cache[sig], measured="cached")
    script = os.path.join(HERE, "tests", "refshim", "build_reference.sh")
    p = subprocess.run(["bash", script], capture_output=True, text=True)
    binp = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    if p.returncode != 0 or not os.path.isfile(binp):
        return {"error": "reference binary did not build"}
    out = os.path.join(WORK, f"ref_{key}.ld")
    t0 = time.perf_counter()
    try:
        p = subprocess.run([binp] + argv + ["--out", out, "--n_threads",
                                            str(os.cpu_count())],
                           capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"lb_s": timeout, "measured": "timeout"}
    if p.returncode != 0:
        return {"error": f"reference exited {p.returncode}"}
    entry = {"s": time.perf_counter() - t0, "n_threads": os.cpu_count()}
    cache[sig] = entry
    with open(REF_CACHE, "w") as fh:
        json.dump(cache, fh)
    return dict(entry, measured="session")


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs an NVIDIA GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 2
    from ngsld_tpu.engine import enable_compile_cache
    enable_compile_cache()
    os.makedirs(WORK, exist_ok=True)
    d = RESULT["detail"]
    d["device"] = jax.devices()[0].device_kind
    d["power_limit"] = card_name_and_limit()

    def leg(key, fn, *a):
        t0 = time.perf_counter()
        try:
            res = fn(*a)
        except Exception as e:   # a failed leg must not hide the others
            res = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        res["leg_wall_s"] = time.perf_counter() - t0
        d[key] = res
        return res

    leg("em_kernel", em_kernel_bench)
    for key in E2E:
        res = leg(key, e2e_bench, key)
        if "wall_s" in res and os.environ.get("NGSLD_BENCH_REF", "1") != "0":
            n_sites, tag, contig_kb, extra = E2E[key]
            glf, pos = _fixture(n_sites, tag, contig_kb)
            ref = ref_measure(key, _cli_argv(glf, pos, n_sites, extra),
                              timeout=1800)
            d[f"ref_{key}"] = ref
            if "s" in ref:
                res["speedup_vs_reference"] = ref["s"] / res["wall_s"]
    _emit()
    return 0 if RESULT["value"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
