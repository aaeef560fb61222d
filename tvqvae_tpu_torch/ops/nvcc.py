"""Building and loading the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. ``build`` compiles it with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` beside
the package, named by a hash of the source and the flags, so a changed
source builds anew and an unchanged one is reused. ``Library`` loads one
with ``ctypes`` at its first use, never at import. Every pointer and the
stream cross as ``ctypes.c_void_p``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: Path, flags=NVCC_FLAGS, verbose: bool = False) -> Path:
    """Compile ``source`` into ``build/kernels/lib<stem>_<hash>.so`` (once per
    source and flag set) and return its path. With ``verbose`` print nvcc's
    ptxas report (registers, shared memory, spills per kernel)."""
    tag = hashlib.sha1(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip(), flush=True)
    os.replace(tmp, out)
    return out


class Library:
    """A kernel library built and loaded at its first ``get()``.

    ``functions`` maps each exported C function to ``(argtypes, restype)``.
    Every source exports ``<stem>_error_string(int) -> const char*`` for the
    CUDA error codes its entry points return."""

    def __init__(self, source: Path, functions: dict):
        self.source = source
        self.functions = functions
        self._lib = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self, verbose: bool = False) -> Path:
        return build(self.source, verbose=verbose)

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (argtypes, restype) in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                err = getattr(lib, f"{self.source.stem}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, name: str, err: int) -> None:
        """Raise if a launch returned a CUDA error code."""
        if err != 0:
            msg = getattr(self._lib, f"{self.source.stem}_error_string")(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg}")
