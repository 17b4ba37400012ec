"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own (one ``nvcc`` per source, all
started together) for ``sm_90a`` into ``<repo>/build/repro_torch_kernels``
— a directory ``.gitignore`` lists — at first use, from the repository's
sources only.  The library name carries a digest of the source, the shared
headers and the flags, so an edited source is rebuilt and a stale library
is never loaded.  Each library exposes a plain C interface: pointers and
the stream as ``void*``, and every entry point returns
``cudaGetLastError()``, which :func:`check` raises on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("s2fp8_quant", "s2fp8_matmul", "flash_attention", "paged_attention",
           "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "s2fp8_quant": {
        "s2fp8_quant_apply": (_P, _I, _P, _LL, _P, _I, _P, _P),
        "s2fp8_truncate_apply": (_P, _I, _P, _LL, _P, _I, _P, _P),
        "s2fp8_dequant": (_P, _P, _LL, _P, _I, _P),
        "s2fp8_stats": (_P, _I, _LL, _P, _LL, _P, _P, _P, _F, _P),
        "s2fp8_quant": (_P, _I, _P, _LL, _P, _LL, _P, _P, _P, _F, _I, _P,
                        _P),
        "s2fp8_truncate_fused": (_P, _I, _P, _LL, _P, _LL, _P, _P, _P, _F,
                                 _I, _P, _P),
        "s2fp8_code_table": (_P, _I, _P),
        "s2fp8_code_sweep": (_P, _I, _P, _P, _P),
        "s2fp8_code_table_layout": (_P,),
        "s2fp8_fused_capacity": (_P, _I),
    },
    "s2fp8_matmul": {
        "s2fp8_qmatmul": (_P, _P, _P, _P) + (_I,) * 10 + (_P, _P, _P, _I, _I,
                                                           _I, _I, _P),
        "s2fp8_qmatmul_batched": (_P, _P, _P) + (_I,) * 11 + (
            _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "flash_attention": {
        "s2fp8_qflash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _I, _I, _I, _F, _I, _P),
        "s2fp8_qflash_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P),
        "flash_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "paged_attention": {
        "s2fp8_paged_decode": (_P, _P, _P, _P, _P, _P, _P, _LL, _P, _LL, _I,
                               _I, _I, _I, _I, _I, _P, _P, _F, _I, _I, _P),
    },
    "selective_scan": {
        "selective_scan": (_P,) * 9 + (_I,) * 5 + (_P,),
        "selective_scan_bwd": (_P,) * 15 + (_I,) * 5 + (_P,),
        "selective_scan_bwd_scratch": (_I,) * 5,
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, ptxas_verbose: bool = False
          ) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once.  Returns name -> compiler output (with
    ``ptxas_verbose`` the per-kernel register / shared-memory report).
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                           else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype declared for every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> Optional[int]:
    """A tensor's device address for a ``void*`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()
