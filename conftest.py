"""Build the native host helpers once, before any test module is imported.

tests/test_native_ff.py and tests/test_native_hash.py build
`.cache/ffec.so` and `.cache/b3native.so` while they are imported. Under
pytest-xdist every worker imports them at about the same time, and all
builds write through one `.tmp` path (hotproofs_tpu/core/native_ff.py:37-43,
core/native.py:28-42): on a fresh checkout overlapping builds broke some
workers' collection, and xdist then stopped the run with no test passed.
This file is loaded by the controlling process before it starts the
workers; it builds both libraries under a file lock, so the workers find
them built.
"""

import fcntl
import os

from hotproofs_tpu.core import native, native_ff

_LOCK = os.path.join(os.path.dirname(native_ff._SO), "native.build.lock")
os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
with open(_LOCK, "w") as _f:
    fcntl.flock(_f, fcntl.LOCK_EX)
    try:
        native_ff.get_lib()
        native.get_lib()
    finally:
        fcntl.flock(_f, fcntl.LOCK_UN)
