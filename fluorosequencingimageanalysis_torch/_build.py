"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into ``_build/<name>-<hash>.so`` inside this package (git-ignored),
where the hash covers the source, the shared headers (``csrc/*.cuh``) and
the compiler flags, then loaded with ctypes. ptxas's report of each build
(registers, shared memory, spills) is kept beside it as
``_build/<name>-<hash>.ptxas.txt``; ``ptxas_info`` reads it. The library
is written to a per-process temporary file and moved into place with
``os.replace``, so concurrent first uses never load a torn file. There is
no fallback: a missing ``nvcc`` or a compiler error raises with the
compiler's output.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# No --use_fast_math: parity depends on IEEE expf, division and denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-kernel additions. fit_quality: -fmad=false rounds every product on
# its own, as the plain twin's one-op-per-launch arithmetic does, so the
# LM kernel matches its twin bit for bit (see ops/lm.py::_row_sum).
# candidate_map keeps FMA contraction: its 25-tap sum cancels large terms,
# and the FMA form is the one that agrees with the twin's convolution.
KERNEL_FLAGS = {"fit_quality": ("-fmad=false",)}

_libs: dict = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def flags(name: str) -> tuple:
    """nvcc flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by content."""
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def ptxas_path(name: str) -> str:
    """Where ptxas's report of the build of ``csrc/<name>.cu`` is kept."""
    return library_path(name)[:-len(".so")] + ".ptxas.txt"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists; returns
    the library path."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *flags(name), "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}"
                           f"{proc.stdout}")
    report = ptxas_path(name)
    with open(f"{report}.{os.getpid()}.tmp", "w") as f:
        f.write(proc.stderr + proc.stdout)
    os.replace(f"{report}.{os.getpid()}.tmp", report)
    os.replace(tmp, so)
    return so


def build_all(names) -> list:
    """Build several sources at once, one nvcc process each; returns their
    library paths."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def ptxas_info(name: str) -> dict:
    """Registers (the most any kernel of the file uses) and spill bytes
    (stores plus loads, over its kernels) from the kept ptxas report of
    the current build of ``csrc/<name>.cu``."""
    with open(ptxas_path(name)) as f:
        text = f.read()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    if not regs:
        raise RuntimeError(f"no register count in {ptxas_path(name)}")
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", text)
    return {"registers": max(regs), "spill_bytes": sum(map(int, spills))}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
