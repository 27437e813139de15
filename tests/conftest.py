"""Shared fixtures.

Default sessions run on the single real CPU device; only two entry
points force placeholder topologies, both BEFORE the first jax
initialization (the device count locks there):

  * ``launch/dryrun.py`` forces 512 devices (production-mesh compiles);
  * this conftest forces ``$REPRO_FORCE_HOST_DEVICES`` CPU devices when
    that env var is set — the multi-device test harness.  CI runs the
    sharded-serving tests under ``REPRO_FORCE_HOST_DEVICES=8``; a plain
    local ``pytest`` gets the same coverage through the
    ``eight_devices`` fixture, which re-runs the requesting module in a
    subprocess with the forced topology.
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_FORCE = os.environ.get("REPRO_FORCE_HOST_DEVICES")
if _FORCE:  # must precede the jax import below
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={int(_FORCE)}").strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch sees none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def eight_devices(request):
    """An 8-CPU-device topology for sharding tests.

    When the session already has >= 8 devices (launched under
    ``REPRO_FORCE_HOST_DEVICES=8``, as the CI multi-device job does),
    yields them directly.  Otherwise the device count is already locked
    at 1, so the requesting test module is re-run ONCE in a subprocess
    with the forced topology: this outer module then skips if the
    subprocess passed and fails loudly if it failed — plain ``pytest``
    keeps the multi-device coverage either way.
    """
    if jax.device_count() >= 8:
        return jax.devices()[:8]
    if os.environ.get("REPRO_FORCE_HOST_DEVICES"):
        # The forcing env was set but did not take (e.g. a non-cpu
        # JAX_PLATFORMS backend ignores the host-device flag): spawning
        # a child would recurse forever — fail loudly instead.
        pytest.fail(
            f"REPRO_FORCE_HOST_DEVICES set but only {jax.device_count()} "
            f"device(s) materialized (JAX_PLATFORMS="
            f"{os.environ.get('JAX_PLATFORMS')!r}); refusing to recurse",
            pytrace=False)
    env = dict(os.environ, REPRO_FORCE_HOST_DEVICES="8")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(__file__), os.pardir, "src"),
                    env.get("PYTHONPATH")) if p)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         str(request.fspath)],
        env=env, capture_output=True, text=True, timeout=1800)
    if r.returncode == 0:
        pytest.skip("passed in the forced-8-device subprocess "
                    "(REPRO_FORCE_HOST_DEVICES=8)")
    pytest.fail(
        "forced-8-device subprocess failed:\n" + r.stdout[-4000:]
        + r.stderr[-2000:], pytrace=False)
