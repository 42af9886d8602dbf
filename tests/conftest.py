"""Shared fixtures. Tests run on the single CPU device (no forced host
devices here — the dry-run subprocess test sets its own XLA_FLAGS)."""
import importlib.util
import os

import jax
import pytest

# Determinism + float32 default for numeric assertions.
jax.config.update("jax_default_matmul_precision", "float32")

# The property-based suites (test_modulo / test_quantizers / test_ef_codecs)
# importorskip hypothesis so local environments without it still run the
# deterministic tests.  In CI that skip would be SILENT — the suites pin the
# codec contracts, and requirements-ci.txt installs hypothesis precisely so
# they execute in the tier-1 matrix — so a CI environment missing it is a
# broken install and must fail loudly, not shed coverage.
if os.environ.get("CI") and importlib.util.find_spec("hypothesis") is None:
    raise pytest.UsageError(
        "hypothesis is not importable in CI: the property-based codec "
        "suites would be skipped silently. It is pinned in "
        "requirements-ci.txt — fix the install instead of skipping.")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs CUDA cards; skips on a machine without them")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
