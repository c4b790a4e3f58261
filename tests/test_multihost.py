"""REAL multi-host ring execution: 2 OS processes, jax.distributed over
localhost, Gloo CPU collectives — the process_count() > 1 branches of the
ring engine (per-process output shards, global-MAF allgather, collective
stop decision, heterogeneous-checkpoint resume lockstep) actually execute
here instead of being trusted dead code.

The reference has no multi-node story at all (SURVEY.md §2); this is the
framework's pod claim, so it gets the pod test.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "multihost_child.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(port, pid, cli_args, extra=(), n_proc=2, env_extra=None):
    env = _clean_env()
    if env_extra:
        env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, CHILD, "--pid", str(pid), "--port", str(port),
         "--nprocs", str(n_proc), *extra, "--", *cli_args],
        cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _run_pod(cli_args, extras=((), ()), timeout=240, n_proc=None,
             env_extra=None):
    if n_proc is None:
        n_proc = len(extras)
    port = _free_port()
    procs = [_launch(port, pid, cli_args,
                     extras[pid] if pid < len(extras) else (),
                     n_proc=n_proc, env_extra=env_extra)
             for pid in range(n_proc)]
    rcs, errs = [], []
    try:
        for p in procs:
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()   # exact child PID we spawned (e.g. a survivor
                _, err = p.communicate()   # hung on a broken collective)
            rcs.append(p.returncode)
            errs.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, errs


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from ngsld_tpu.utils.simulate import simulate, write_all
    d = str(tmp_path_factory.mktemp("mh"))
    files = write_all(simulate(n_ind=8, n_sites=500, seed=34), d)
    return files


def _cli(files, out, ckpt=None, seed=None):
    args = ["--geno", files["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "500", "--pos", files["pos"], "--max_kb_dist", "0",
            "--extend_out", "--engine", "jax", "--ring", "--shard", "8",
            "--ring_sub", "2", "--out", out, "--verbose", "0"]
    if ckpt:
        args += ["--checkpoint", ckpt]
    if seed is not None:
        args += ["--seed", str(seed), "--rnd_sample", "0.5"]
    return args


def _concat_shards(out, n_proc=2):
    data = b""
    for pid in range(n_proc):
        with open(f"{out}.part{pid:05d}", "rb") as fh:
            data += fh.read()
    return data


def _strict_output(files, tmp_path, seed=None):
    from ngsld_tpu import strict
    from ngsld_tpu.cli import params_from_args
    out = str(tmp_path / "strict.ld")
    args = ["--geno", files["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "500", "--pos", files["pos"], "--max_kb_dist", "0",
            "--extend_out", "--engine", "strict", "--out", out,
            "--verbose", "0"]
    if seed is not None:
        args += ["--seed", str(seed), "--rnd_sample", "0.5"]
    strict.run(params_from_args(args))
    return open(out, "rb").read()


def _assert_pod_matches_strict(pod_bytes, strict_bytes):
    """Pair set and order must match exactly; values to f64 EM tolerance
    (the jax engine's documented contract vs the bit-exact oracle)."""
    pr = pod_bytes.decode().splitlines()
    sr = strict_bytes.decode().splitlines()
    assert len(pr) == len(sr) and len(pr) > 1000
    assert pr[0] == sr[0]                      # header (proc 0 only)
    for a, b in zip(pr[1:], sr[1:]):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:3] == fb[:3], (fa[:3], fb[:3])
        for c in range(3, len(fa)):
            x, y = float(fa[c]), float(fb[c])
            if not (np.isfinite(x) and np.isfinite(y)):
                # degenerate rows are strict-refined (refine.py): the
                # engines must agree exactly on inf/nan spellings now
                assert x == y or (np.isnan(x) and np.isnan(y)), (c, a, b)
                continue
            assert abs(x - y) <= 5e-5, (c, a, b)


@pytest.mark.slow_multihost
def test_two_process_ring_matches_strict(fix, tmp_path):
    """Plain 2-process pod run: per-process shards concatenate to the
    oracle's output (covers the MAF allgather + per-process writers)."""
    out = str(tmp_path / "pod.ld")
    rcs, errs = _run_pod(_cli(fix, out))
    assert rcs == [0, 0], errs
    _assert_pod_matches_strict(_concat_shards(out),
                               _strict_output(fix, tmp_path))


@pytest.mark.slow_multihost
def test_two_process_ring_rnd_sample(fix, tmp_path):
    """--rnd_sample on a pod: every host materializes only its resident
    anchors' draw sets; the union must be the reference's exact pair set."""
    out = str(tmp_path / "pods.ld")
    rcs, errs = _run_pod(_cli(fix, out, seed=12345))
    assert rcs == [0, 0], errs
    pod = _concat_shards(out).decode().splitlines()
    st = _strict_output(fix, tmp_path, seed=12345).decode().splitlines()
    assert [r.split("\t")[:2] for r in pod] == \
           [r.split("\t")[:2] for r in st]


@pytest.mark.slow_multihost
def test_collective_sigint_stops_both_then_resume(fix, tmp_path):
    """SIGINT on ONE host: the stop decision is collective, so BOTH exit
    130 with committed steps; a rerun over the same --checkpoint resumes
    in lockstep and completes."""
    out = str(tmp_path / "podi.ld")
    ckpt = str(tmp_path / "ck")
    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt),
                         extras=(("--sigint-after", "2"), ()))
    assert rcs == [130, 130], (rcs, errs)
    done = [p for p in os.listdir(ckpt) if p.endswith(".done")]
    assert done  # some steps committed on each host
    assert any("p00000" in p for p in done)
    assert any("p00001" in p for p in done)

    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt))
    assert rcs == [0, 0], errs
    _assert_pod_matches_strict(_concat_shards(out),
                               _strict_output(fix, tmp_path))


@pytest.mark.slow_multihost
def test_host_crash_heterogeneous_resume(fix, tmp_path):
    """One host DIES (os._exit) mid-sweep, leaving heterogeneous
    checkpoints (the dead host committed fewer steps). The rerun must
    agree on the MINIMUM resume step across hosts — the collective-min
    lockstep (engine.py ring resume) — and still match the oracle."""
    out = str(tmp_path / "podc.ld")
    ckpt = str(tmp_path / "ck")
    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt),
                         extras=((), ("--crash-after", "2")), timeout=120)
    assert 17 in rcs, (rcs, errs)   # the crashed host
    # the surviving host either also died on the broken collective or got
    # killed by the harness timeout — either way, resume must work:
    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt))
    assert rcs == [0, 0], errs
    _assert_pod_matches_strict(_concat_shards(out),
                               _strict_output(fix, tmp_path))


@pytest.mark.slow_multihost
def test_four_process_crash_heterogeneous_resume(fix, tmp_path):
    """One of FOUR hosts dies mid-sweep; the other three hang on the
    broken collective (killed by the harness). The 4-way rerun must agree
    on the collective-min resume step and match the oracle."""
    out = str(tmp_path / "pod4c.ld")
    ckpt = str(tmp_path / "ck4")
    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt),
                         extras=((), (), ("--crash-after", "2"), ()),
                         n_proc=4, timeout=150)
    assert 17 in rcs, (rcs, errs)
    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt), n_proc=4, timeout=360)
    assert rcs == [0, 0, 0, 0], errs
    _assert_pod_matches_strict(_concat_shards(out, n_proc=4),
                               _strict_output(fix, tmp_path))


@pytest.mark.slow_multihost
def test_eight_process_ring_dress_rehearsal(fix, tmp_path):
    """8-process pod dress rehearsal: --ring
    --rnd_sample with an uneven tail (500 sites over 8 single-device
    processes pad to 512), TWO hosts die mid-sweep at different steps
    (heterogeneous checkpoints), the 8-way rerun agrees on the
    collective-min resume step, and `ngsld-merge` assembles the shards
    into the oracle's exact sampled pair set. The closest this
    environment gets to a pod run."""
    from ngsld_tpu.tools.merge import main as merge_main

    out = str(tmp_path / "pod8.ld")
    ckpt = str(tmp_path / "ck8")
    rcs, errs = _run_pod(
        _cli(fix, out, ckpt=ckpt, seed=12345),
        extras=((), (), ("--crash-after", "1"), (), (),
                ("--crash-after", "2"), (), ()),
        n_proc=8, timeout=300)
    assert rcs.count(17) >= 1, (rcs, errs)   # at least one host died
    done = [p for p in os.listdir(ckpt) if p.endswith(".done")]
    assert done                              # some steps committed

    rcs, errs = _run_pod(_cli(fix, out, ckpt=ckpt, seed=12345),
                         n_proc=8, timeout=600)
    assert rcs == [0] * 8, (rcs, errs)

    merged = str(tmp_path / "merged.ld")
    assert merge_main(["--out", merged, out]) == 0
    pod = open(merged).read().splitlines()
    st = _strict_output(fix, tmp_path, seed=12345).decode().splitlines()
    assert len(pod) == len(st) > 500
    assert pod[0] == st[0]
    assert [r.split("\t")[:2] for r in pod] == \
           [r.split("\t")[:2] for r in st]
