"""Child process for the REAL multi-host ring tests (test_multihost.py).

Each instance is one 'host' of a simulated cluster: it registers with the
jax.distributed coordinator, sees 8//nprocs local CPU devices (8 global), and runs the --ring engine end-to-end — exercising the
process_count() > 1 branches (per-process output shards, global-MAF
allgather, collective stop/resume lockstep) that single-process tests
cannot reach.
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="virtual CPU devices per process "
                         "(default: 8 // nprocs)")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--crash-after", type=int, default=0,
                    help="os._exit(17) after N committed ring steps "
                         "(simulates a host dying mid-sweep)")
    ap.add_argument("--sigint-after", type=int, default=0,
                    help="raise SIGINT in THIS process after N committed "
                         "steps (the stop must propagate collectively)")
    ap.add_argument("argv", nargs=argparse.REMAINDER,
                    help="ngsld CLI args (after a leading --)")
    args = ap.parse_args()

    n_local = args.local_devices or max(1, 8 // args.nprocs)
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={n_local}"

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nprocs, process_id=args.pid)

    if args.crash_after or args.sigint_after:
        from ngsld_tpu import engine as engine_mod
        real = engine_mod._RingSpill.save_step
        state = {"n": 0}

        def hooked(self, si, t, blocks):
            real(self, si, t, blocks)
            state["n"] += 1
            if args.crash_after and state["n"] >= args.crash_after:
                os._exit(17)
            if args.sigint_after and state["n"] == args.sigint_after:
                import signal
                os.kill(os.getpid(), signal.SIGINT)

        engine_mod._RingSpill.save_step = hooked

    from ngsld_tpu.cli import main as cli_main
    argv = args.argv[1:] if args.argv[:1] == ["--"] else args.argv
    try:
        rc = cli_main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    sys.exit(rc)


if __name__ == "__main__":
    main()
