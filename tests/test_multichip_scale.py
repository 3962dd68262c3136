"""16- and 32-virtual-device dryruns.

The in-suite mesh is fixed at 8 CPU devices (conftest); wider meshes need
a fresh interpreter with their own xla_force_host_platform_device_count,
so these run the full driver dryrun — toy steps + kNN + pod pipeline +
mid-scale soak with bit-identity checks + fully-sharded budget run +
traffic meters — in a subprocess per width.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
@pytest.mark.parametrize("n_devices", [16, 32])
def test_dryrun_wide_mesh(n_devices):
    env = dict(os.environ)
    # the child re-pins platform/devices itself; scrub this process's flags
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__; "
         f"__graft_entry__.dryrun_multichip({n_devices})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=840)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"dryrun_multichip({n_devices}): ok" in out.stdout
    assert "bit-identical" in out.stdout
