"""Test config: the virtual 8-device CPU mesh by default.

JAX_PLATFORMS defaults to cpu; tests marked `gpu` need it to include the
card (`JAX_PLATFORMS=cuda,cpu`, see README) and skip otherwise."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# ring tests exercise ring internals deliberately — don't let narrow-band
# fixtures silently reroute them to the block engine (the autoroute has
# its own dedicated tests that re-enable it)
os.environ.setdefault("NGSLD_RING_AUTOROUTE", "0")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def ref_binary():
    """Build (once) and return the reference oracle binary path, or skip."""
    import subprocess, pathlib
    script = pathlib.Path(__file__).parent / "refshim" / "build_reference.sh"
    try:
        out = subprocess.run(["bash", str(script)], capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[-1]
    except subprocess.CalledProcessError as e:
        pytest.skip(f"reference oracle build failed: {e.stderr}")
