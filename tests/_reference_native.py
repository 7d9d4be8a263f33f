"""Load the JAX package's native library once per test process, built
once across processes.

`photon_tpu.native.get_lib()` compiles with g++ straight onto its final
path under a thread lock only, and remembers a failure for the rest of
the process. Under ``pytest -n N --dist loadfile`` several workers reach
it at once from a clean checkout; one of them can `CDLL` a file another
worker's linker is still writing, and from then on every native test of
that worker sees "unavailable". This helper takes a file lock, compiles
the same source with the same command to a temporary name, moves it onto
the final path with `os.replace` (so no reader ever sees a torn file),
loads it and hands it to the module as its memoized library, so its
`get_lib()` never compiles again in this process.
"""
import ctypes
import fcntl
import os
import subprocess


def _load(RN, path):
    try:
        lib = ctypes.CDLL(str(path))
        RN._bind(lib)
        return lib
    except OSError:  # a torn file left by a killed build: rebuild it
        return None


def reference_native():
    """The JAX package's native library, loaded (None when g++ fails)."""
    from photon_tpu import native as RN

    with RN._lock:
        if RN._lib is not None:
            return RN._lib
        final = RN._LIB_PATH
        final.parent.mkdir(parents=True, exist_ok=True)
        with open(final.parent / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            lib = None
            if (final.exists()
                    and final.stat().st_mtime >= RN._SRC.stat().st_mtime):
                lib = _load(RN, final)
            if lib is None:
                tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         str(RN._SRC), "-o", str(tmp)],
                        check=True, capture_output=True, timeout=300)
                    os.replace(tmp, final)
                    lib = _load(RN, final)
                except (OSError, subprocess.SubprocessError):
                    lib = None
                finally:
                    if tmp.exists():
                        tmp.unlink()
        RN._lib, RN._tried = lib, True
        return lib
