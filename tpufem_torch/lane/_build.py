"""Build and load the CUDA kernel library of the port (the lane layout's
kernels and the structured lattice's).

The sources under ``tpufem_torch/csrc/`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds. Every ``.cu`` is
compiled to an object file, all compilers started together, and the
objects are linked into one shared library under ``tpufem_torch/build/``
that is loaded with ``ctypes``. The build runs at first use and again
whenever a source is newer than the library. A failed build raises: no
caller gets a substitute for a kernel that did not build.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libtpufem_lane_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # None: loaded an up-to-date library
build_log: str = ""


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
        "the lane kernels cannot be built"
    )


def _stale(srcs) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    newest = max(os.path.getmtime(p) for p in
                 srcs + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return os.path.getmtime(LIB_PATH) < newest


def build(verbose: bool = False) -> float:
    """Compile every source (in parallel) and link; returns seconds."""
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no kernel sources under {CSRC_DIR}")
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    # -fmad=false: products and sums round separately, as they do in the
    # plain PyTorch versions the kernels are held against, so the kernels
    # that multiply and add (K4, K6, K7, K8) are bit-equal to them; K6 /
    # K7 / K8 pay for it in instructions (their notes in csrc/ count them)
    common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC"]
    if verbose:
        common += ["-Xptxas", "-v"]
    procs = []
    for src in srcs:
        obj = os.path.join(
            BUILD_DIR, os.path.splitext(os.path.basename(src))[0] + ".o"
        )
        procs.append((src, obj, subprocess.Popen(
            common + ["-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(src)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + build_log
        )
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp]
        + [obj for _s, obj, _p in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    build_log += link.stdout
    if link.returncode != 0:
        raise RuntimeError("linking the lane kernels failed:\n" + link.stdout)
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built first if missing or out of date."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if _stale(sources()):
            build_seconds = build(verbose=verbose)
        lib = ctypes.CDLL(LIB_PATH)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.lane_gather_cm.restype = ci
        cll = ctypes.c_longlong
        lib.lane_gather_cm.argtypes = [
            ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cll, vp]
        lib.lane_scatter_cm.restype = ci
        lib.lane_scatter_cm.argtypes = [
            ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.lane_pass_update.restype = ci
        lib.lane_pass_update.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ci, ci, cll, ci, ci, ci, ci, ci, ci,
            vp]
        cd = ctypes.c_double
        lib.lane_fused_elem.restype = ci
        lib.lane_fused_elem.argtypes = [
            ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
            ci, ci, cd, ci, ci, cd, cd, cd, ci, ci, ci, ci, cll, vp]
        lib.lane_gather_weighted.restype = ci
        lib.lane_gather_weighted.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cll,
            vp]
        lib.lane_gather.restype = ci
        lib.lane_gather.argtypes = [
            ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, cll,
            vp]
        lib.lane_scatter.restype = ci
        lib.lane_scatter.argtypes = [
            ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.lane_scatter_weighted.restype = ci
        lib.lane_scatter_weighted.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
            ci, cll, vp]
        # structured lattice kernels: the constants are a host float array
        lib.lattice_residual.restype = ci
        lib.lattice_residual.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, vp]
        lib.lattice_tangent.restype = ci
        lib.lattice_tangent.argtypes = [vp, vp, vp, vp, ci, ci, vp, ci, ci,
                                        vp]
        for fn in (lib.lattice_residual_occupancy,
                   lib.lattice_tangent_occupancy):
            fn.restype = ci
            fn.argtypes = [ip]
        lib.lattice_matvec3d.restype = ci
        lib.lattice_matvec3d.argtypes = [vp, vp, ci, ci, ci, vp, ci, ci, ci,
                                         ci, vp]
        _lib = lib
        return _lib
