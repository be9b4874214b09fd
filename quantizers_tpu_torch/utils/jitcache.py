"""The persistent kernel build cache.

Counterpart of ``quantizers_tpu/utils/jitcache.py``, which keys compiled
XLA programs on disk. The port's compiled artifact is the CUDA kernels'
shared library (:mod:`~quantizers_tpu_torch.ops._build`): built by ``nvcc``
at the first launch (seconds to half a minute) under a directory keyed by a
hash of the sources and flags, so that a later process loads it as it is.
Every CLI calls :func:`enable_persistent_cache` first, as the JAX CLIs do.

Location: ``$QTPU_JIT_CACHE`` if set, else the package's git-ignored
``_kernels_build/``. ``0``, ``off``, ``none`` or the empty string disable
it: each process then builds into a temporary directory of its own.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_OFF = ("0", "off", "none", "")


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel build at its persistent directory and return it
    (None where ``$QTPU_JIT_CACHE`` disables the cache). ``path`` wins over
    the environment. Safe to call more than once; it takes effect for a
    library not loaded yet."""
    from ..ops import _build

    env = os.environ.get("QTPU_JIT_CACHE")
    if path is None and env is not None and env.lower() in _OFF:
        _build.set_build_root(None)
        return None
    cache_dir = Path(path or env or _build.DEFAULT_BUILD_ROOT)
    _build.set_build_root(cache_dir)
    return str(cache_dir)
