"""Build and load the port's CUDA kernels and its host decoders.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process into ``build/rufus_tpu_torch/<hash>/lib<name>.so`` beside
the package, at first use; all sources compile at once, in parallel. The
directory name hashes the sources and flags, so an edited source rebuilds.
Libraries are loaded with ``ctypes``: no PyTorch headers are compiled,
which keeps a cold build to seconds.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.

The host code (``native/*.cpp``: the BGZF/BAM and FASTQ decoders, the
assembler's Align3 scoring, interpret's depth-model and pull loads) is one
library, ``librufus_torch_io.so``, built the same way by the host compiler
(``build_native``) and typed by ``host_function``; a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "rufus_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no fused multiply-add: the host library's doubles round as Python's do
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]
HOST_LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _build_dir(flags, files) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in files:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet (one nvcc each, all
    started together). Returns {name: {"so": path, "ptxas": text}}; the
    ptxas text (registers, shared memory, spills) is kept in a log file
    beside each library, so it is also there for a cached build."""
    sources = _sources()
    out_dir = _build_dir(NVCC_FLAGS, sources + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))))
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        so = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(so):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    errors = []
    for name, (p, tmp, so) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            os.remove(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        with open(so + ".ptxas.txt", "w") as f:
            f.write(text)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    result = {}
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        so = os.path.join(out_dir, f"lib{name}.so")
        with open(so + ".ptxas.txt") as f:
            result[name] = {"so": so, "ptxas": f.read()}
    return result


def build_native() -> str:
    """Compile ``native/*.cpp`` into ``librufus_torch_io.so`` with the host
    compiler (``$CXX``, else g++), unless it is built; returns its path."""
    sources = sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))
    out_dir = _build_dir(HOST_FLAGS + HOST_LIBS, sources)
    so = os.path.join(out_dir, "librufus_torch_io.so")
    with _lock:
        if os.path.exists(so):
            return so
        os.makedirs(out_dir, exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("no C++ compiler: the native host code needs "
                               "g++ (or $CXX) and zlib")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        p = subprocess.run([cxx, *HOST_FLAGS, *sources, "-o", tmp, *HOST_LIBS],
                           capture_output=True, text=True)
        if p.returncode != 0:
            os.remove(tmp)
            raise RuntimeError(f"building librufus_torch_io.so failed:\n"
                               f"{p.stdout}{p.stderr}")
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def host_function(name: str, restype, argtypes: tuple):
    """The C entry point `name` of ``librufus_torch_io.so`` (built on first
    use), typed."""
    fn = getattr(ctypes.CDLL(build_native()), name)
    fn.restype = restype
    fn.argtypes = list(argtypes)
    return fn


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        built = build_all()
    if name not in built:
        raise KeyError(f"no kernel source csrc/{name}.cu")
    return ctypes.CDLL(built[name]["so"])


# ctypes argument types of the C entry points: pointers and the stream are
# void*, sizes long long, small scalars int (an unset argtype would pass a
# Python int as a 32-bit int and cut a pointer or a size).
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def function(lib_name: str, fn_name: str, argtypes):
    """The C entry point `fn_name` of ``csrc/<lib_name>.cu``, typed."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as the C functions take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def on_card(fn):
    """Decorates a launcher whose first argument is a CUDA tensor. The C
    entry points launch on the current device, and a stream of another
    card would fail, so the tensor's card is made current for the call:
    a shard of a mesh may be on any card."""
    @functools.wraps(fn)
    def run(t, *args, **kwargs):
        import torch

        with torch.cuda.device(t.device):
            return fn(t, *args, **kwargs)

    return run
