"""Graceful SIGINT: finish the in-flight block, flush, resume cleanly."""

import os
import signal

import numpy as np
import pytest

import ngsld_tpu.engine as engine_mod
import ngsld_tpu.engine_block as engine_block_mod
from ngsld_tpu.cli import params_from_args
from ngsld_tpu.engine import run_jax
from ngsld_tpu.utils.simulate import simulate, write_all


def _pars(files, out, ckpt):
    return params_from_args([
        "--geno", files["beagle"], "--probs", "--n_ind", "8",
        "--n_sites", "500", "--pos", files["pos"], "--max_kb_dist", "5",
        "--extend_out", "--engine", "jax", "--chunk_pairs", "700",
        "--checkpoint", ckpt, "--out", out, "--verbose", "0"])


def test_sigint_then_resume(tmp_path, monkeypatch):
    sim = simulate(n_ind=8, n_sites=500, seed=33)
    files = write_all(sim, str(tmp_path / "fix"))
    ckpt = str(tmp_path / "ckpt")

    # straight run for the expected bytes
    straight = tmp_path / "straight.ld"
    run_jax(_pars(files, str(straight), str(tmp_path / "ckpt_straight")))
    expected = straight.read_bytes()

    # interrupt: deliver SIGINT right after the sweep loop consumes the
    # second block (so block 0 is already dispatched); the sweep must
    # finish in-flight work, commit shards, and exit 130. The injection
    # wraps the consumer-side prefetch generator: the plan producer runs
    # in its own thread and races ahead of the sweep.
    real_prefetch = engine_block_mod._prefetch_blocks

    def prefetch_with_sigint(gen, depth=4):
        for i, blk in enumerate(real_prefetch(gen, depth)):
            if i == 1:
                os.kill(os.getpid(), signal.SIGINT)
            yield blk

    monkeypatch.setattr(engine_block_mod, "_prefetch_blocks",
                        prefetch_with_sigint)
    out1 = tmp_path / "interrupted.ld"
    with pytest.raises(SystemExit) as ei:
        run_jax(_pars(files, str(out1), ckpt))
    assert ei.value.code == 130
    parts = [p for p in os.listdir(ckpt) if p.endswith(".tsv")]
    assert len(parts) >= 1          # completed blocks were committed
    monkeypatch.setattr(engine_block_mod, "_prefetch_blocks",
                        real_prefetch)

    # resume with the same checkpoint dir: must complete and match
    out2 = tmp_path / "resumed.ld"
    run_jax(_pars(files, str(out2), ckpt))
    assert out2.read_bytes() == expected


def _ring_pars(files, out, ckpt):
    return params_from_args([
        "--geno", files["beagle"], "--probs", "--n_ind", "8",
        "--n_sites", "500", "--pos", files["pos"], "--max_kb_dist", "0",
        "--extend_out", "--engine", "jax", "--ring", "--shard", "8",
        "--ring_sub", "2", "--checkpoint", ckpt, "--out", out,
        "--verbose", "0"])


def test_ring_sigint_then_resume(tmp_path, monkeypatch):
    """SIGINT mid ring sweep: exit 130 with committed step shards; a rerun
    with the same --checkpoint resumes and matches the straight run."""
    sim = simulate(n_ind=8, n_sites=500, seed=34)
    files = write_all(sim, str(tmp_path / "fix"))
    ckpt = str(tmp_path / "ckpt")

    straight = tmp_path / "straight.ld"
    run_jax(_ring_pars(files, str(straight), str(tmp_path / "cks")))
    expected = straight.read_bytes()

    real_save = engine_mod._RingSpill.save_step
    calls = []

    def save_with_sigint(self, si, t, blocks):
        real_save(self, si, t, blocks)
        calls.append((si, t))
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGINT)

    monkeypatch.setattr(engine_mod._RingSpill, "save_step", save_with_sigint)
    out1 = tmp_path / "interrupted.ld"
    with pytest.raises(SystemExit) as ei:
        run_jax(_ring_pars(files, str(out1), ckpt))
    assert ei.value.code == 130
    done = [p for p in os.listdir(ckpt) if p.endswith(".done")]
    assert len(done) == 2           # exactly the committed steps remain
    monkeypatch.setattr(engine_mod._RingSpill, "save_step", real_save)

    out2 = tmp_path / "resumed.ld"
    run_jax(_ring_pars(files, str(out2), ckpt))
    assert out2.read_bytes() == expected


def test_signal_handlers_restored(tmp_path):
    from ngsld_tpu.utils.signals import GracefulStop
    before = signal.getsignal(signal.SIGINT)
    with GracefulStop() as gs:
        assert signal.getsignal(signal.SIGINT) != before
        assert not gs.stopped
    assert signal.getsignal(signal.SIGINT) == before
