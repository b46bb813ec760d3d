"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` expose a plain C interface, so they compile in
seconds without PyTorch's headers: one nvcc per source, all started
together, then one link.  The shared library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)
    ]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in compiles]
    logs = [(c, p.communicate()[0], p.returncode) for c, p in zip(compiles, procs)]
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    if all(rc == 0 for _, _, rc in logs):
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append((link, proc.stdout, proc.returncode))
    (BUILD_DIR / "build.log").write_text("".join(" ".join(c) + "\n" + text for c, text, _ in logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(c, text, rc) for c, text, rc in logs if rc != 0]
    if failed:
        c, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{text}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tpusdr_decim_fir.argtypes = [
            p, i64, p, i64, p, i, i, i, i64, i64, i, i, i, p, i, p,
        ]
        lib.tpusdr_decim_fir.restype = i
        lib.tpusdr_decim_fir_smem.argtypes = [i, i, i, i, i, i]
        lib.tpusdr_decim_fir_smem.restype = i64
        u32 = ctypes.c_uint32
        fm_head = [p, i64, p, i64, p, i, i, u32, p, p, u32, ctypes.c_float, i64, i, i, i, i, i64]
        lib.tpusdr_fm_fused.argtypes = [*fm_head, p, i, p]
        lib.tpusdr_fm_fused.restype = i
        lib.tpusdr_fm_fused_probe.argtypes = [*fm_head, i, p, i, p]
        lib.tpusdr_fm_fused_probe.restype = i
        lib.tpusdr_fm_fused_smem.argtypes = [i, i, i, i, i]
        lib.tpusdr_fm_fused_smem.restype = i64
        lib.tpusdr_fir_poly.argtypes = [p, i64, p, i64, p, i, i, i64, i, i, i, p, i, p]
        lib.tpusdr_fir_poly.restype = i
        lib.tpusdr_fir_poly_smem.argtypes = [i, i, i, i, i]
        lib.tpusdr_fir_poly_smem.restype = i64
        lib.tpusdr_resample_poly.argtypes = [
            p, i64, p, i64, i64, i64, i, p, i, i, i, i64, i64, i, i, i, p, i64, p, i64, i, p,
        ]
        lib.tpusdr_resample_poly.restype = i
        lib.tpusdr_resample_poly_smem.argtypes = [i, i, i, i, i]
        lib.tpusdr_resample_poly_smem.restype = i64
        lib.tpusdr_copy_floor.argtypes = [p, i64, i, i, i, i, i, i, p, i, p]
        lib.tpusdr_copy_floor.restype = i
        lib.tpusdr_copy_floor_smem.argtypes = [i, i]
        lib.tpusdr_copy_floor_smem.restype = i64
        lib.tpusdr_copy_floor_resident.argtypes = [i64, i]
        lib.tpusdr_copy_floor_resident.restype = i
        lib.tpusdr_staging.argtypes = [i, p, i64, i64, i64, i64, i, i, i, i, i, p, i, p]
        lib.tpusdr_staging.restype = i
        lib.tpusdr_staging_smem.argtypes = [i, i]
        lib.tpusdr_staging_smem.restype = i64
        lib.tpusdr_shift_sum.argtypes = [p, i64, i, i, i, i64, i, i, i, p, i, p]
        lib.tpusdr_shift_sum.restype = i
        lib.tpusdr_shift_sum_smem.argtypes = [i64, i, i64, i, i]
        lib.tpusdr_shift_sum_smem.restype = i64
        lib.tpusdr_max_smem_optin.argtypes = [i]
        lib.tpusdr_max_smem_optin.restype = i64
        lib.tpusdr_stamp.argtypes = [p, p, i64, i, i, i, p]
        lib.tpusdr_stamp.restype = i
        lib.tpusdr_error_string.argtypes = [i]
        lib.tpusdr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
