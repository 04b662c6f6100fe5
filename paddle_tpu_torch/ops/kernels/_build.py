"""Build the port's CUDA sources into one shared library and load it.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one ``.so`` with a
plain C interface, loaded with ctypes; the same library is also imported
as the extension module ``_pt_kernels`` (csrc/pymodule.cu), whose entries
skip ctypes' argument conversion for the wrappers on a host-bound path (its
compile needs the interpreter's Python.h). The library lands in
``paddle_tpu_torch/build/`` under a name that hashes the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as is. Nothing
is compiled when a module is imported: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-I", sysconfig.get_paths()["include"]]
PY_MODULE = "_pt_kernels"

_lib = None
_py = None
# inputs copied by aligned16 since the last reset
# (ops.kernels.reset_launch_counts)
copies = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("paddle_tpu_torch: nvcc not found on PATH, in "
                       "$CUDA_HOME/bin or /usr/local/cuda/bin; the CUDA "
                       "kernels are built from csrc/ at first use")


def _sources():
    srcs = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    return srcs, headers


def library_path() -> Path:
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("paddle_tpu_torch: nvcc failed for "
                               + "\n".join(failed))
        out_so = tmp / so.name
        link = subprocess.run(
            [nvcc] + ARCH_FLAGS + ["-shared", "-o", str(out_so)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("paddle_tpu_torch: linking the kernel "
                               f"library failed:\n{link.stdout}")
        os.replace(out_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def py_module():
    """The library imported as the extension module ``_pt_kernels`` (built
    on first call): csrc/pymodule.cu's METH_FASTCALL entries."""
    global _py
    if _py is None:
        path = str(build())
        loader = importlib.machinery.ExtensionFileLoader(PY_MODULE, path)
        spec = importlib.util.spec_from_file_location(PY_MODULE, path,
                                                      loader=loader)
        _py = importlib.util.module_from_spec(spec)
        loader.exec_module(_py)
    return _py


def entry(name: str, argtypes):
    """A C entry point of the library with its argument types set. Every
    entry returns the cudaError_t of its launch as an int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        describe = library().pt_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"paddle_tpu_torch: {name} launch failed with "
                           f"cudaError_t {err} "
                           f"({describe(err).decode()})")


def aligned16(t):
    """``t`` where its data starts on a 16-byte boundary (or it is None),
    else a fresh contiguous copy, counted in ``copies``: the kernels copy
    their tiles with 16-byte loads, and a view at an odd offset (8 bytes
    into its storage, say) is copied once here instead of refused. The C
    entries still refuse an unaligned pointer."""
    global copies
    if t is None or t.data_ptr() % 16 == 0:
        return t
    copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def same_inputs(refs, inputs):
    """True when each weak reference in ``refs`` still points at the very
    object of ``inputs`` (None stands for None): how a wrapper tells that a
    call brings the step inputs it last validated."""
    return all((r is None and t is None)
               or (r is not None and t is not None and r() is t)
               for r, t in zip(refs, inputs))
