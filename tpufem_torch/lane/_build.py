"""Build and load the CUDA kernel library of the port (the lane layout's
kernels and the structured lattice's).

The sources under ``tpufem_torch/csrc/`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds. Every ``.cu`` is
compiled to an object file, all compilers started together, and the
objects are linked into one shared library under ``tpufem_torch/build/``
that is loaded with ``ctypes``. The build runs at first use and again
whenever a source is newer than the library. A failed build raises: no
caller gets a substitute for a kernel that did not build.

The fused kernel's generated route (``lane/fused_gen.py``) compiles one
unit per generated source (:func:`load_unit`) into ``build/gen/``, named
by a digest of the source, the headers, the flags and the compiler; such
a unit never makes the main library stale.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libtpufem_lane_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

GEN_DIR = os.path.join(BUILD_DIR, "gen")
# -fmad=false: products and sums round separately, as they do in the plain
# PyTorch versions the kernels are held against, so the kernels that
# multiply and add (K4, K6, K7, K8) are bit-equal to them; K6 / K7 / K8 pay
# for it in instructions (their notes in csrc/ count them)
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # None: loaded an up-to-date library
build_log: str = ""
_units: Dict[str, ctypes.CDLL] = {}
_unit_locks: Dict[str, threading.Lock] = {}
unit_logs: Dict[str, str] = {}  # generated units' compiler output (ptxas)
_nvcc_version: Optional[str] = None


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
    common = [nvcc, *NVCC_FLAGS]
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
            ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
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


# -- generated units (the fused kernel's generated route) ----------------------


def _nvcc_id(nvcc: str) -> str:
    global _nvcc_version
    if _nvcc_version is None:
        _nvcc_version = subprocess.run(
            [nvcc, "--version"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True).stdout
    return _nvcc_version


def unit_key(source: str, nvcc: Optional[str] = None) -> str:
    """sha256 of a generated unit's source, the headers of ``csrc/`` it
    includes, the flags and the compiler's version."""
    h = hashlib.sha256(source.encode())
    for hdr in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(f.read())
    h.update(repr(NVCC_FLAGS).encode())
    h.update(_nvcc_id(nvcc or _find_nvcc()).encode())
    return h.hexdigest()


def load_unit(source: str) -> ctypes.CDLL:
    """A generated CUDA unit (source text that includes headers of
    ``csrc/``) as a loaded library: built at first use with the library's
    flags into ``build/gen/<sha256>.so`` and kept there, so that a later
    process loads it; a failed build raises with the compiler's log. The
    main library is not touched (its staleness test reads ``csrc/`` only).
    Thread-safe: units may be built in parallel from threads."""
    nvcc = _find_nvcc()
    key = unit_key(source, nvcc)
    with _lock:
        if key in _units:
            return _units[key]
        klock = _unit_locks.setdefault(key, threading.Lock())
    with klock:
        if key in _units:
            return _units[key]
        so = os.path.join(GEN_DIR, key + ".so")
        if not os.path.exists(so):
            os.makedirs(GEN_DIR, exist_ok=True)
            src = os.path.join(GEN_DIR, key + ".cu")
            with open(src, "w") as f:
                f.write(source)
            tmp = so + f".tmp{os.getpid()}.{threading.get_ident()}"
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC_DIR,
                 "-shared", src, "-o", tmp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for the generated unit {src}:\n"
                    + proc.stdout)
            os.replace(tmp, so)
            unit_logs[key] = proc.stdout
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        for fn in (lib.lane_fused_gen_launch1, lib.lane_fused_gen_launch2):
            fn.restype = ci
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                           ctypes.c_longlong, vp]
        _units[key] = lib
        return lib
