"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles on its own, with ``nvcc`` for ``sm_90a``,
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  The libraries land in ``build/kernels/`` at the repo
root, named by a hash of their source and flags, and are built at first use:
the first call of any kernel wrapper starts one ``nvcc`` per source, all at
once, and waits for them.  Only the sources in this checkout are used.

Flags are per source.  The codec kernels build with ``-fmad=false``, which
keeps every float multiply and add separately rounded, as the plain PyTorch
versions compute them (the kernels also spell the arithmetic out with
``_rn`` intrinsics), so they equal their plain versions bit for bit.  The
two flash-attention kernels (``flash_attention_tc.cu`` on the tensor cores
in bfloat16 with ``wgmma`` and TMA, ``flash_attention_f32tc.cu`` on the
tensor cores in float32 with 3xTF32 ``mma.sync``) are held to their plain
version within a tolerance (they sum in another order) and may contract
multiply-adds.  The tensor-core kernel fetches
``cuTensorMapEncodeTiled`` at run time through the CUDA runtime
(``cudaGetDriverEntryPoint``), so no source links ``-lcuda``.
``--use_fast_math`` is never used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
CODEC_FLAGS = NVCC_FLAGS + ("-fmad=false",)

_P, _I, _I64, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint32)
# C signature of each source's entry point (restype is int: cudaError_t)
SIGNATURES = {
    "moniqua_encode": (_P, _I, _P, _I64, _I64, _I64, _P, _U32, _U32, _U32,
                       _I64, _U32, _I, _I, _P),
    "moniqua_decode_reduce": (_P, _P, _P, _I, _P, _I64, _I64, _I, _P, _P, _I,
                              _P),
    "moniqua_decode": (_P, _P, _I, _P, _I64, _I64, _P, _I, _I, _P),
    "flash_attention_tc": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                           ctypes.c_float, _I, _I64, _I64, _P, _P),
    "flash_attention_f32tc": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                              ctypes.c_float, _I, _I64, _I64, _P, _P),
}
# nvcc flags of each source
FLAGS = {"moniqua_encode": CODEC_FLAGS, "moniqua_decode_reduce": CODEC_FLAGS,
         "moniqua_decode": CODEC_FLAGS, "flash_attention_tc": NVCC_FLAGS,
         "flash_attention_f32tc": NVCC_FLAGS}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: keyed by a hash of
    the source and its flags, so an edited source is rebuilt."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(FLAGS[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(force: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing (every source with
    ``force``), one ``nvcc`` per source, all started together; raises with
    the compiler's output if any fails.  Returns the library path of each
    source; each compiler log (``-Xptxas -v``: registers, spills) sits
    beside it as ``.log``."""
    paths = {name: library_path(name) for name in SIGNATURES}
    todo = {n: p for n, p in paths.items() if force or not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS[name], "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log = proc.communicate()[0]
            path.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first
    if any library is missing."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
