"""Shared test helpers.

NOTE: no XLA_FLAGS here on purpose — unit/smoke tests run on the single
real CPU device.  Tests that need multiple devices spawn a subprocess
with --xla_force_host_platform_device_count (see `run_with_devices`).
"""
import os
import subprocess
import sys
import textwrap

import pytest


def run_with_devices(code: str, n_devices: int = 8) -> str:
    """Run a python snippet in a subprocess with N emulated devices.
    Raises on failure; returns stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr[-3000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
