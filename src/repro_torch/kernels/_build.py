"""Build and load the port's CUDA kernel library.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into ``librepro_torch_kernels.so``. The library has a
plain C interface (no PyTorch headers, so a build takes seconds) and is
loaded with ``ctypes``. The output lands in ``build/kernels`` at the root
of the checkout, under a name keyed by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is not.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the library: name -> argtypes (every function returns int,
# the CUDA error code of its launch, except the error-string helper)
SIGNATURES = {
    "repro_fused_add_rmsnorm": (_P,) * 6 + (_I, _I, _F) + (_I,) * 10
    + (_P,),
    "repro_silu_and_mul": (_P, _P, _P, _I, _I, _L) + (_I,) * 8 + (_P,),
    "repro_merge_attn_states": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P),
    "repro_paged_decode_attention": (_P,) * 9 + (_I,) * 13
    + (_F, _I, _I, _I, _I, _P),
    "repro_flash_decode_attention": (_P,) * 8 + (_I,) * 10
    + (_F, _I, _I, _I, _I, _P),
    "repro_prefill_attention": (_P,) * 4 + (_I,) * 5 + (_L,) * 9
    + (_I, _F, _P),
    "repro_empty": (_P,),
}

_lib = None
build_info: dict = {}   # seconds, path, cached, ptxas log of the last load


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def _compile(out: Path) -> str:
    """Compile every source in parallel and link ``out``; returns the
    compilers' combined log (ptxas register and shared-memory report)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed to build " + ", ".join(failed)
                               + ":\n" + "\n".join(logs))
        part = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(part),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("linking the kernel library failed:\n"
                               + link.stdout)
        os.replace(part, out)     # atomic: a reader never sees half a file
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source tree has no
    build yet. Raises RuntimeError when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    t0 = time.perf_counter()
    log, cached = "", out.exists()
    if not cached:
        log = _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=str(out),
                      cached=cached, log=log)
    _lib = lib
    return lib


_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    """The C interface's code for a tensor's dtype (0 fp32, 1 bf16)."""
    try:
        return _DTYPE_CODES[str(t.dtype)]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}") from None


def vector_width(width: int, *tensors) -> int:
    """Elements per 16-byte vector for these tensors, or 1 when ``width``
    is not a multiple of it or a pointer is not 16-byte aligned."""
    vec = 16 // tensors[0].element_size()
    if width % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")
