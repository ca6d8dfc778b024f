"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Every source is compiled once, on first use, by its own nvcc process (all
started together), and the objects are linked into one shared library
with a plain C interface, which ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c -o <build>/<source>.<hash>.o csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <build>/libpheniqs_kernels_<hash>.so <objects>

No fast math: ``--use_fast_math`` would swap expf for the approximate
__expf and flush denormals, and ``-fmad=false`` keeps each multiply-add
rounded twice; the hybrid bound and the kernel-versus-plain comparisons
rest on both. The library lands in ``pheniqs_tpu_torch/_build/`` (listed
in .gitignore), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. ptxas' register and
shared-memory report is kept beside it (``build_log()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: argtypes of every exported entry (csrc/*.cu); each returns cudaError_t
SIGNATURES = {
    "phq_unpack_tokens": (_P, _I, _I, _P, _I) + (_P,) * 11,
    "phq_unpack_columns": (_P, _I, _I) + (_P,) * 5 + (_I,) * 3 + (_P,) * 8,
    "phq_pamld": (_P, _P) + (_P,) * 16,
    "phq_pamld_slices": (_P, _P, _I, _I, _I, _I, _I) + (_P,) * 9,
    "phq_pamld_state": (_P,) * 6,
    "phq_pamld_merge": (_P, _P, _I, _I, _I) + (_P,) * 16,
    "phq_pamld_info": (_I, _P),
    "phq_mdd": (_P,) * 14,
    "phq_tpq_eval": (_P, _I, _P, _P, _P),
    "phq_features": (_P, _P, _I, _I, _I, ctypes.c_float, _P, _P, _P),
    "phq_counters": (_I,) * 11 + (_P,) * 12,
    "phq_pack": (_I,) * 6 + (_P,) * 8,
}

_LIBRARY = None


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libpheniqs_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every csrc/*.cu (one nvcc process each, in parallel) and
    link the shared library, unless a build of the same sources and flags
    exists. Returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{source.stem}.{tag}.o" for source in sources()]
    compiles = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for source, obj in zip(sources(), objects)
    ]
    logs = [process.communicate()[0] for process in compiles]
    failed = [
        f"{source.name}: nvcc exited {process.returncode}"
        for source, process in zip(sources(), compiles)
        if process.returncode != 0
    ]
    # the failed sources' own output: the others' ptxas reports would bury it
    failures = "".join(text for text, process in zip(logs, compiles) if process.returncode != 0)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(partial), *map(str, objects)],
            capture_output=True, text=True,
        )
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link: nvcc exited {link.returncode}")
    log = "".join(logs)
    target.with_suffix(".log").write_text(log)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n{(failures or log)[-6000:]}")
    os.replace(partial, target)
    return target


def build_log() -> str:
    """nvcc's and ptxas' output of the current build (registers, spills,
    shared memory per kernel)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIBRARY
    if _LIBRARY is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBRARY = lib
    return _LIBRARY


def check(status: int, name: str):
    """Raise when a C entry reported a CUDA error (launch refused, bad
    configuration, or an earlier asynchronous fault)."""
    if status != 0:
        import torch

        message = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
        raise RuntimeError(f"{name} failed: cudaError {status} on {message}")
