"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` per ``csrc/*.cu`` (K1 ``bp4_qc.cu`` and K2
``bp2_qc.cu``, which share ``qc_common.cuh``, the probe kernels of
``probes.cu``, the fused feedback-GNN step of ``gnn_feedback.cu``,
OSD-0's elimination of ``osd0.cu``, the GF(2) product of ``gf2mat.cu`` and
GNN_BP4's CN and VN updates of ``gnn_bp4.cu``), all
started together, compiles each source into an object,
and one more links them into a shared library with a plain C interface,
which ``ctypes`` loads.  No PyTorch headers are involved.  The library goes into
``_build/`` beside this file (listed in .gitignore), named by a hash of the
sources and the flags: a library left over from other sources can never be
picked up.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory and
spills of each kernel) is kept beside it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

from . import obs

__all__ = ["load_kernels", "build_info"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "csrc")
_OUT_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
# what the last build of this process did: library path, seconds, ptxas report
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")) + glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_OUT_DIR, f"libfgt_kernels-{h.hexdigest()[:16]}.so")


def _build(lib: str) -> None:
    os.makedirs(_OUT_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, cu], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)
    ]
    reports, failed = [], []
    for cu, proc in zip(cus, procs):
        out, _ = proc.communicate(timeout=600)
        reports.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(cu)} (exit {proc.returncode})")
    report = "".join(reports)
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=600)
        report += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(f"link (exit {link.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{report}")
    with open(lib[:-3] + ".ptxas.txt", "w") as f:
        f.write(report)
    os.replace(tmp, lib)
    build_info.update(seconds=seconds, built=True)


def load_kernels() -> ctypes.CDLL:
    """The kernels' library, built first if this source revision has none."""
    if _lib is None:
        _load()
    return _lib


@obs.setup("kernels")
def _load() -> None:
    """Build the library if need be, dlopen it and declare its functions."""
    global _lib
    lib = _lib_path()
    build_info.update(library=lib, seconds=0.0, built=False)
    if not os.path.exists(lib):
        _build(lib)
    with open(lib[:-3] + ".ptxas.txt") as f:
        build_info["ptxas"] = f.read()
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    dll.fgt_bp4_qc_launch.argtypes = [p, p, p, p, p] + [i] * 11 + [f, i, i, i, p]
    dll.fgt_bp4_qc_launch.restype = i
    dll.fgt_bp4_qc_occupancy.argtypes = [i] * 7 + [p]
    dll.fgt_bp4_qc_occupancy.restype = i
    dll.fgt_bp2_qc_launch.argtypes = [p, p, p, p] + [i] * 8 + [f, i, i, i, p]
    dll.fgt_bp2_qc_launch.restype = i
    dll.fgt_bp2_qc_occupancy.argtypes = [i] * 5 + [p]
    dll.fgt_bp2_qc_occupancy.restype = i
    dll.fgt_probe_gather_launch.argtypes = [p, p, p] + [i] * 5 + [f] + [i] * 7 + [p]
    dll.fgt_probe_gather_launch.restype = i
    dll.fgt_probe_shift_launch.argtypes = [p, p] + [i] * 5 + [f] + [i] * 6 + [p]
    dll.fgt_probe_shift_launch.restype = i
    dll.fgt_probe_loop_clusters.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    dll.fgt_probe_loop_clusters.restype = i
    dll.fgt_probe_phi_launch.argtypes = [p, p] + [i] * 7 + [p]
    dll.fgt_probe_phi_launch.restype = i
    dll.fgt_probe_phi_last_launch.argtypes = [ctypes.POINTER(i)]
    dll.fgt_probe_phi_last_launch.restype = None
    side = [p, i, p, i, p, p, p, i]  # logits, rows, syndromes, rows, cn ids, masks, degrees, dv
    dll.fgt_gnn_feedback_launch.argtypes = [p, i] + side + side + [p, p, p, p] + [i] * 5 + [p]
    dll.fgt_gnn_feedback_launch.restype = i
    dll.fgt_gnn_feedback_packed_floats.argtypes = [i] * 3
    dll.fgt_gnn_feedback_packed_floats.restype = i
    dll.fgt_gnn_feedback_occupancy.argtypes = [i] * 3 + [p]
    dll.fgt_gnn_feedback_occupancy.restype = i
    dll.fgt_osd0_launch.argtypes = [p, p, i, p, p, i, i, i, p]
    dll.fgt_osd0_launch.restype = i
    dll.fgt_osd0_shared_bytes.argtypes = [i, i]
    dll.fgt_osd0_shared_bytes.restype = i
    dll.fgt_osd0_occupancy.argtypes = [i, i, p]
    dll.fgt_osd0_occupancy.restype = i
    dll.fgt_gf2_matmul_launch.argtypes = [p, ctypes.c_longlong, i, p, p, p, i, i, i, p]
    dll.fgt_gf2_matmul_launch.restype = i
    dll.fgt_gf2_occupancy.argtypes = [i, i, p]
    dll.fgt_gf2_occupancy.restype = i
    cn_side = [p, p, p, p, p, p, i, i]  # embeddings, logits, output, VN ids, masks, degrees, c_pad, dc
    dll.fgt_gnn_bp4_cn_launch.argtypes = [p, i] + cn_side + cn_side + [p] + [i] * 7 + [p]
    dll.fgt_gnn_bp4_cn_launch.restype = i
    vn_side = [p, p, p, p, p, i, i]  # CN embeddings, signs, CN ids, masks, degrees, c_pad, dv
    dll.fgt_gnn_bp4_vn_launch.argtypes = [p, i, p] + vn_side + vn_side + [p] + [i] * 7 + [p]
    dll.fgt_gnn_bp4_vn_launch.restype = i
    dll.fgt_gnn_bp4_occupancy.argtypes = [i] * 6 + [p]
    dll.fgt_gnn_bp4_occupancy.restype = i
    dll.fgt_cuda_error_string.argtypes = [i]
    dll.fgt_cuda_error_string.restype = ctypes.c_char_p
    _lib = dll
