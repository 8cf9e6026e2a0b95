"""Build shared libraries at first use: keyed, atomic and locked.

The compositors' CUDA sources (ops/composite.py, with nvcc) and the host
image codec (data/codec.py, with the host C++ compiler) are compiled into
the package's `_build/` the first time they are needed. A library is named
by a hash of everything that shapes it (`keyed_path`), so an edit of the
source or the flags builds a new one and a stale one is never loaded.

`build` is safe between processes and between threads: each call compiles
into a temporary directory of its own and renames the result into place
(a rename within one directory is atomic), so a reader sees a whole
library or none; and one lock per library in the process makes a thread
that finds another building it wait for that build instead of repeating it.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Sequence

_LOCKS: Dict[Path, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def keyed_path(build_dir: Path, stem: str, *key: bytes) -> Path:
    """`build_dir / "<stem>_<hash of key>.so"`."""
    digest = hashlib.sha256(b"".join(key)).hexdigest()
    return build_dir / f"{stem}_{digest[:16]}.so"


def _lock(lib: Path) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(lib, threading.Lock())


def build(commands: Mapping[Path, Callable[[Path], Sequence[str]]],
          log: bool = False) -> None:
    """Build each library `lib` of `commands` that does not exist yet:
    `commands[lib](out)` is the command that writes it to `out`. The
    commands run all at once; each result is renamed to its `lib`. With
    `log`, each command's output is kept beside its library as
    `<lib>.log`. Raises RuntimeError naming each command that failed."""
    libs = sorted(commands)                 # one lock order: no deadlock
    with contextlib.ExitStack() as held:
        for lib in libs:
            held.enter_context(_lock(lib))
        procs = {}
        for lib in libs:
            if lib.exists():
                continue
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=lib.parent, prefix=".build-"))
            held.callback(shutil.rmtree, tmp, ignore_errors=True)
            cmd = [str(c) for c in commands[lib](tmp / lib.name)]
            procs[lib] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for lib, (cmd, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{cmd[0]} failed ({proc.returncode}) to build "
                              f"{lib.name}:\n{' '.join(cmd)}\n{out}")
                continue
            if log:
                (tmp / "log").write_text(out)
                os.replace(tmp / "log", lib.with_suffix(".log"))
            os.replace(tmp / lib.name, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
