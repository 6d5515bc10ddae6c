import os

# Tests run on the default single CPU device — the 512-device dry-run sets
# its own XLA_FLAGS (never set globally here; see launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


# -- hypothesis fallback ----------------------------------------------------
# Property-based tests import `given`/`settings`/`st` from here when the
# optional `hypothesis` dependency (requirements-dev.txt) is missing, so the
# properties skip individually instead of killing collection of their whole
# module.

import pytest  # noqa: E402


def given(*_a, **_k):
    def deco(fn):
        @pytest.mark.skip(reason="hypothesis not installed")
        def skipped():
            pass
        skipped.__name__ = getattr(fn, "__name__", "test_property")
        return skipped
    return deco


settings = given


class _StrategyStub:
    def __getattr__(self, _name):
        return lambda *a, **k: None


st = _StrategyStub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
