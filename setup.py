"""Wheel build hook: compile the native host runtime into the package.

The reference ships manylinux wheels built by maturin from its Rust
crate (SURVEY.md §2a #15); the analogue here is the C++ host runtime
(mappy_rs_tpu/native/*.cc) compiled into the wheel as a ctypes-loaded
shared library.  Source installs still work without this step — the
package builds the library on first use (native/__init__.py, same
flags) — but `python -m build` / `pip wheel .` produces a binary wheel
with the library prebuilt.

MAPPY_NATIVE_ARCH overrides -march for distributable builds (default
"native" for local ones; use e.g. "x86-64-v3" for portable wheels).
"""
import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "mappy_rs_tpu", "native")
        dst = os.path.join(self.build_lib, "mappy_rs_tpu", "native")
        os.makedirs(dst, exist_ok=True)
        arch = os.environ.get("MAPPY_NATIVE_ARCH", "native")
        cmd = [
            os.environ.get("CXX", "g++"),
            "-O3", f"-march={arch}", "-fPIC", "-shared", "-std=c++17",
            "-Wall",
            os.path.join(src, "mappy_native.cc"),
            os.path.join(src, "front_end.cc"),
            os.path.join(src, "post_chain.cc"),
            "-o", os.path.join(dst, "libmappy_native.so"),
        ]
        self.announce("building native runtime: " + " ".join(cmd), 2)
        subprocess.run(cmd, check=True)


setup(cmdclass={"build_py": BuildPyWithNative})
