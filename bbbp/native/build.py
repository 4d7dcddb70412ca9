"""Build libbbbpchem.so: ``python -m bbbp.native.build``."""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "bbbpchem.cpp")
OUT = os.path.join(HERE, "libbbbpchem.so")


def build(verbose: bool = True) -> str:
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", SRC, "-o", OUT,
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    build()
    print(f"built {OUT}")
