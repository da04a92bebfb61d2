"""The persistent build cache (``compile_cache_dir``).

In the JAX package this key points XLA's persistent compilation cache
at a directory, so a restart reloads the jitted programs instead of
compiling them again.  The port has no XLA program: what it compiles is
its hand-written CUDA kernels (``nvcc``, one library per ``csrc/*.cu``)
and its host sources (``g++``/``gcc``: the C ABI, the native page
reader), which ``ops/_build.py`` writes under ``build/kernels/`` and
``build/host/`` at the repository root.  Those two directories are the
port's persistent cache, so ``compile_cache_dir = <dir>`` (global key,
any task) moves them to ``<dir>/kernels`` and ``<dir>/host``; a later
process with the same directory loads the libraries without compiling
them again.  Without the key they stay under ``build/``.

Each library's name carries a hash of its source, its local headers,
its flags, the compiler's identity, the machine and (for host sources)
the Python ABI, so a stale or foreign entry is just a miss.  Libraries
are written under a temporary name and renamed into place, so processes
may share the directory.

The key is acted on in one place, ``NetTrainer.set_param``: every path
that loads a kernel builds its trainer from the same configuration
first (the CLI's tasks, the serving engine's own trainer, the wrapper's
``Net`` and the C ABI), so no other entry point calls :func:`enable`.

The move must happen before the first kernel loads: a library already
loaded stays loaded from where it was and is never reloaded from the
new directory.  Moving after that emits ``compile_cache.mid_process_enable``
and prints a warning, as the JAX package does when its cache is enabled
after a backend came up.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

_enabled_dir: Optional[str] = None


def enabled_dir() -> Optional[str]:
    """The directory the cache was pointed at, or None."""
    return _enabled_dir


def enable(path: str, silent: bool = True) -> bool:
    """Point the kernel and host build directories at ``path/kernels``
    and ``path/host`` (``path`` is created if missing).  Idempotent;
    returns True when newly enabled.  Must run before the first kernel
    loads; ``NetTrainer.set_param`` calls it before its trainer loads
    one."""
    global _enabled_dir
    if not path:
        return False
    path = os.path.abspath(os.path.expanduser(path))
    if _enabled_dir == path:
        return False
    os.makedirs(path, exist_ok=True)
    from ..ops import _build

    if _build.LOADED:
        from ..obs import events as obs_events

        obs_events.emit("compile_cache.mid_process_enable", dir=path)
        print(
            "WARNING: compile_cache_dir set after a kernel library was "
            f"already loaded ({len(_build.LOADED)} loaded); those stay "
            "loaded from where they were and are not reloaded from "
            f"{path} — set compile_cache_dir before the first kernel "
            "loads (the CLI/serve engine order)", flush=True,
        )
    _build.set_cache_root(path)
    _enabled_dir = path
    if not silent:
        print(f"compile cache: kernel and host builds under {path}",
              flush=True)
    return True


def configure(cfg: Sequence[Tuple[str, str]], silent: bool = True) -> bool:
    """Scan an ordered config stream for ``compile_cache_dir`` (last
    one wins) and enable it.  No-op without the key."""
    path = ""
    for name, val in cfg or ():
        if name == "compile_cache_dir":
            path = val
    return enable(path, silent=silent) if path else False
