"""Build and load the port's native sources (csrc/) at first use.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host C++:
the greedy tracker and the two step-fit cores) exposes a plain C entry
point and is compiled, by ``nvcc`` or by the host compiler ``g++``
respectively, into
``_build/<name>-<hash>.so`` inside this package (git-ignored), where the
hash covers the source, for CUDA sources the shared headers
(``csrc/*.cuh``), and the compiler flags; it is then loaded with ctypes.
ptxas's report of each CUDA build (registers, shared memory, spills) is
kept beside it as ``_build/<name>-<hash>.ptxas.txt``; ``ptxas_info``
reads it. The library is written to a per-process temporary file and
moved into place with ``os.replace``, so concurrent first uses never load
a torn file. There is no fallback: a missing compiler or a compiler error
raises with the compiler's output.
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
# mc_fit: the same, for the Monte-Carlo fit's model and pixel sums
# (ops/mc_fit.py::mc_fit_plain). consolidate: the same, so that its
# squared distances round as the plain twin's (ops/consolidate.py).
# candidate_map keeps FMA contraction: its 25-tap sum cancels large terms,
# and the FMA form is the one that agrees with the twin's convolution.
KERNEL_FLAGS = {"fit_quality": ("-fmad=false",),
                "mc_fit": ("-fmad=false",),
                "consolidate": ("-fmad=false",)}
# Host C++: no -ffast-math, and -ffp-contract=off so that a*b + c rounds
# twice on every host architecture (the tracker's distances are the
# reference's plain sqrt(dh*dh + dw*dw); the step-fit cores promise the
# Python chain's float results bit for bit). No -march=native: a build is
# keyed by source and flags, not by CPU, and the build directory may be
# copied to a machine with another CPU. -pthread: the step-fit cores
# thread their batches.
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off",
              "-pthread")

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


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, then g++ on PATH."""
    for c in (os.environ.get("CXX"), "g++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    raise RuntimeError("g++ not found (looked at $CXX and PATH); the host "
                       "C++ sources cannot be built")


def source(name: str) -> str:
    """``csrc/<name>.cpp`` if it exists, else ``csrc/<name>.cu``."""
    cpp = os.path.join(CSRC, name + ".cpp")
    return cpp if os.path.exists(cpp) else os.path.join(CSRC, name + ".cu")


def _is_cuda(name: str) -> bool:
    return source(name).endswith(".cu")


def flags(name: str) -> tuple:
    """Compiler flags for ``csrc/<name>.cu`` (nvcc) or ``.cpp`` (g++)."""
    if not _is_cuda(name):
        return HOST_FLAGS
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>`` lives, keyed by content."""
    digest = hashlib.sha256()
    headers = (sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
               if _is_cuda(name) else [])
    for path in [source(name), *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def ptxas_path(name: str) -> str:
    """Where ptxas's report of the build of ``csrc/<name>.cu`` is kept."""
    return library_path(name)[:-len(".so")] + ".ptxas.txt"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its keyed build
    exists; returns the library path."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    src = source(name)
    compiler = find_nvcc() if _is_cuda(name) else find_cxx()
    proc = subprocess.run([compiler, *flags(name), "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed to build "
                           f"{os.path.basename(src)} (exit "
                           f"{proc.returncode}):\n{proc.stderr}"
                           f"{proc.stdout}")
    if not _is_cuda(name):
        os.replace(tmp, so)
        return so
    report = ptxas_path(name)
    with open(f"{report}.{os.getpid()}.tmp", "w") as f:
        f.write(proc.stderr + proc.stdout)
    os.replace(f"{report}.{os.getpid()}.tmp", report)
    os.replace(tmp, so)
    return so


def build_all(names) -> list:
    """Build several sources at once, one compiler process each; returns their
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


def ptxas_kernels(name: str) -> dict:
    """Registers and spill bytes of each kernel of the current build of
    ``csrc/<name>.cu``, by its mangled name (one entry per template
    instantiation), from the kept ptxas report."""
    with open(ptxas_path(name)) as f:
        text = f.read()
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        kernel = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
        out[kernel] = {"registers": int(regs.group(1)) if regs else None,
                       "spill_bytes": sum(map(int, spills))}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
