"""Test harness configuration.

Runs the whole suite on the CPU backend with a virtual 8-device mesh,
so multi-device sharding code is exercised without accelerators.  The
platform is forced through jax.config as well as the environment: an
interpreter may import jax before pytest loads this file, and then the
environment variables alone are read too late.

Fixtures ``test_fa`` / ``test_mmi`` give the small reference every
golden test maps to: tests/data/test.fa (committed, written by
tests/data/make_test_fa.py) and an .mmi index built from it by the
repo's own writer once per session.
"""
import os

os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_platform_name", "cpu")

assert jax.default_backend() == "cpu", (
    "tests must run on the CPU mesh, got " + jax.default_backend()
)
assert jax.device_count() >= 8, "expected the 8-device virtual CPU mesh"

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TEST_FA = os.path.join(DATA, "test.fa")


@pytest.fixture(scope="session")
def test_fa() -> str:
    return TEST_FA


@pytest.fixture(scope="session")
def test_mmi(tmp_path_factory) -> str:
    from mappy_rs_tpu.index.build import build_index
    from mappy_rs_tpu.index.mmi import save_mmi
    from mappy_rs_tpu.utils.seqcodes import read_fastx

    path = str(tmp_path_factory.mktemp("mmi") / "test.mmi")
    save_mmi(path, build_index(list(read_fastx(TEST_FA))).to_raw())
    return path
