"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. At first use every source is
compiled by `nvcc` for `sm_90a` into a shared library under
`tsm_det_pointcloud_tpu_torch/_build/` (one `nvcc` per source, all started
together), keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, and loaded with `ctypes`. Pointers and the
stream are passed as `c_void_p`; every C entry returns the launch's
`cudaError_t`, and `check` raises when it is not 0.

`LAUNCHES` counts kernel launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> source file
SOURCES = {
    "fps": "fps.cu",
    "fps_block": "fps_block.cu",
    "query_group": "group.cu",
    "probe": "probe.cu",
    "spconv_bykey": "spconv_bykey.cu",
    "spconv_bykey_bwd": "spconv_bykey_bwd.cu",
    "spconv_gather": "spconv_gather.cu",
}

# launches per kernel: each source's, and the second kernels of two sources
# (K6's weighted s-fps instantiation, K2's with 33-64 samples a ball),
# counted apart
LAUNCHES = {name: 0 for name in (*SOURCES, "fps_block_weighted", "query_group_wide")}

_MAX_SCALES = 4


class GroupScales(ctypes.Structure):
    """Mirror of `struct GroupScales` in csrc/group.cu."""
    _fields_ = [
        ("n_scales", ctypes.c_int),
        ("use_window", ctypes.c_int),
        ("ns", ctypes.c_int * _MAX_SCALES),
        ("offset", ctypes.c_int * _MAX_SCALES),
        ("has_min", ctypes.c_int * _MAX_SCALES),
        ("min_r2", ctypes.c_float * _MAX_SCALES),
        ("max_r2", ctypes.c_float * _MAX_SCALES),
        ("qr", (ctypes.c_int * 3) * _MAX_SCALES),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fps": ("fps_launch", [_P, _P, _P, _I, _I, _I, _P, _P]),
    "fps_block": ("fps_block_launch",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]),
    "query_group": ("query_group_launch",
                    [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, GroupScales,
                     _I, _P, _P, _P, _P, _P]),
    "probe": ("probe_launch", [_P, _P, _I, _I, _I, _I, _P, _P, _P]),
    "spconv_bykey": ("bykey_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "spconv_bykey_bwd": ("bykey_bwd_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P]),
    "spconv_gather": ("gather_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
}

# entries beside a kernel's launch: name -> (kernel whose library holds it,
# symbol, argtypes)
_ENTRIES = {
    "fps_plan": ("fps", "fps_plan", [_I, _I, _P]),
    "fps_round_probe": ("fps", "fps_round_probe", [_I, _I, _I, _P, _P]),
    "spconv_bykey_bwd_plan": ("spconv_bykey_bwd", "bykey_bwd_plan", [_I, _I, _I, _I, _I, _P]),
    "fps_block_plan": ("fps_block", "fps_block_plan", [_I, _I, _P]),
    # the second kernels of two sources, launched through their source's
    # entry, which picks the kernel from its arguments
    "fps_block_weighted": ("fps_block", *_SIGNATURES["fps_block"]),
    "query_group_wide": ("query_group", *_SIGNATURES["query_group"]),
}

_lock = threading.Lock()
_funcs = {}
BUILD_LOG = {}   # kernel -> nvcc's output (registers, spills)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name):
    LAUNCHES[name] += 1


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name):
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all():
    """Compile every stale kernel library, one nvcc per source in parallel.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    nvcc = None
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def func(name):
    """The ctypes entry of kernel `name` (or of a name in `_ENTRIES`),
    building the libraries at first use."""
    f = _funcs.get(name)
    if f is not None:
        return f
    with _lock:
        if name not in _funcs:
            build_all()
            entries = {**{k: (k, sym, at) for k, (sym, at) in _SIGNATURES.items()},
                       **_ENTRIES}
            for k, (kernel, sym, argtypes) in entries.items():
                fn = getattr(ctypes.CDLL(str(_lib_path(kernel))), sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _funcs[k] = fn
    return _funcs[name]


def check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def stream_ptr(device):
    """The raw cudaStream_t of `device`'s current stream: one C call, no
    Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def as_int32(t):
    """`t` itself when it already is contiguous int32, else a contiguous
    int32 copy."""
    import torch

    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.contiguous().to(torch.int32)


def ptr(t):
    return None if t is None else t.data_ptr()


def check_shape(t, shape, what):
    """Raise unless `t` has `shape` (None entries match any size)."""
    if t is None:
        return
    if t.dim() != len(shape) or any(
            s is not None and t.shape[i] != s for i, s in enumerate(shape)):
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")


def require_cuda(*tensors):
    """Raise unless every given tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError("kernel inputs must all lie on the card")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
