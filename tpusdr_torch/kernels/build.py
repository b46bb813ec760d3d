"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` expose a plain C interface, so they compile in
seconds without PyTorch's headers.  The shared library lands in
``build/tpusdr_torch/`` at the root of the checkout, named by a hash of
the sources and flags, and is built at first use.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusdr_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register / shared-memory / spill report, kept in the log
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home is not None and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not built yet)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libtpusdr_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tpusdr_decim_fir.argtypes = [
            p, i64, p, i64, p, i, i, i, i64, i64, p, i, p,
        ]
        lib.tpusdr_decim_fir.restype = i
        lib.tpusdr_decim_fir_smem.argtypes = [i, i, i]
        lib.tpusdr_decim_fir_smem.restype = i64
        lib.tpusdr_fm_fused.argtypes = [
            p, i64, p, i, i, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float, i64, p, i, p,
        ]
        lib.tpusdr_fm_fused.restype = i
        lib.tpusdr_fm_fused_smem.argtypes = [i, i]
        lib.tpusdr_fm_fused_smem.restype = i64
        lib.tpusdr_max_smem_optin.argtypes = [i]
        lib.tpusdr_max_smem_optin.restype = i64
        lib.tpusdr_error_string.argtypes = [i]
        lib.tpusdr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
