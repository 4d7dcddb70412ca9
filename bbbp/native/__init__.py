"""Native (C++) fast path for host-side featurization.

The reference is pure Python over RDKit's C++ (SURVEY.md preamble); here the
parser + fingerprint engine themselves are C++ (``bbbpchem.cpp``), exposed via
ctypes, with an OpenMP-threaded batch API feeding the screening pipeline.
Build with ``python -m bbbp.native.build``; all call sites fall back to the
pure-Python implementation transparently when the shared library is absent.
"""
