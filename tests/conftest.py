"""Test configuration: run everything on a virtual 8-device CPU mesh.

A fake multi-device backend (SURVEY.md §4): sharding and collective code
paths are exercised via ``--xla_force_host_platform_device_count`` without
real devices.  Tests marked ``gpu`` need a GPU and skip here;
``chip_smoke.py`` runs them on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA's CPU compiler segfaults nondeterministically once a single
    process has accumulated a few hundred compiled programs (observed at
    ~85% of the full suite, always inside backend_compile_and_load, at
    whichever large compile comes next; every module passes in
    isolation).  Dropping the compiled-executable caches between modules
    keeps the live-program count bounded.  Costs recompiles of the
    handful of cross-module shared programs — a few extra minutes on the
    full suite, and nothing when running single files."""
    yield
    jax.clear_caches()
