"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain
C interface (no PyTorch headers), loaded with :mod:`ctypes`; the wrappers
in :mod:`repro_torch.kernels.sim_step`,
:mod:`repro_torch.kernels.ckpt_codec`,
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.decode_attention`,
:mod:`repro_torch.kernels.rwkv6` and :mod:`repro_torch.kernels.mamba`
(each of the last two with a forward and a backward library) pass device
pointers and PyTorch's current CUDA stream as integers.  Libraries land in ``build/repro_torch/``
at the repository root, named by a hash of their source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

``python -c "from repro_torch.kernels import build; build.build_all()"``
builds every kernel; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = [
    "NVCC_FLAGS", "BUILD_DIR", "KernelBuildError", "KernelLaunchError",
    "build_all", "load",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs, at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: sm_90a (Hopper), and no FMA contraction: the kernels must round like
#: their plain PyTorch versions (see the notes in csrc/*.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}



class KernelBuildError(RuntimeError):
    """A kernel's library could not be built: ``nvcc`` is missing or
    rejected a source.  A fault of the installation or of the code, never
    of the device, so recovery loops must not retry it or fall back to
    another engine (:func:`repro_torch.ft.retry.classify_failure` gives it
    ``FailureKind.FATAL``)."""


class KernelLaunchError(RuntimeError):
    """A kernel wrapper's launch returned a CUDA error (``code``, a
    ``cudaError_t``).  :func:`repro_torch.ft.retry.classify_failure` reads
    the code: 2 (out of memory) is ``OOM``, the runtime's sticky codes are
    ``DEVICE_LOSS``, and every other code is a fault of the kernel or of its
    build (an image the card cannot run, a bad launch configuration), so
    ``FATAL``."""

    def __init__(self, name: str, code: int):
        super().__init__(f"{name}: kernel launch failed (cudaError {code})")
        self.code = int(code)


_P, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double

#: C signatures of the entry points (every one returns a cudaError_t as int)
_SIGNATURES = {
    "sim_step": {
        "sim_step_primitive_update": [
            _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F64,
            _I32, _I32, _P, _P, _P, _P, _I32, _F64, _F64, _P,
        ],
        "sim_step_stream_advance": [
            _I64, _P, _P, _P, _P, _P, _P, _I32, _F64, _F64, _P,
        ],
        # the law-indexed variants: per-lane law code and s1 / s2 pointers
        "sim_step_primitive_update_indexed": [
            _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F64,
            _I32, _P, _P, _P, _P, _P, _P, _P, _P,
        ],
        "sim_step_stream_advance_indexed": [
            _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ],
        # the walks: masks and clock (4), cursors (7), lane constants (8),
        # trust coins (3), then each stream's law; a null pointer is a None
        # argument
        "sim_step_prediction_walk": [_I64] + [_P] * 22 + [
            _I32, _F64, _F64, _I32, _F64, _F64, _P,
        ],
        "sim_step_prediction_walk_indexed": [_I64] + [_P] * 22 + [
            _I32, _F64, _F64, _P, _P, _P, _I32, _F64, _F64, _P, _P, _P, _P,
        ],
        # res, t, sf_ctr, sf_time, n_faults, DR, key, mean, horizon, three
        # cancel slots; the law
        "sim_step_strike_walk": [_I64] + [_P] * 12 + [_I32, _F64, _F64, _P],
        "sim_step_strike_walk_indexed": [_I64] + [_P] * 12 + [_P, _P, _P, _P],
        # silr, t, sf_ctr, sf_time, corrupt, key, mean, horizon; the law
        "sim_step_silent_walk": [_I64] + [_P] * 8 + [_I32, _F64, _F64, _P],
        "sim_step_silent_walk_indexed": [_I64] + [_P] * 8 + [_P, _P, _P, _P],
        # the host trace mode's slab walks: lanes, slab rows, then pointers
        # mask, t, lead_act, P0, pi
        "sim_step_slab_prediction_skip": [_I64, _I64] + [_P] * 6,
        # res, t, fi, n_faults, rc, F, Fcancel, can, ep_ft
        "sim_step_slab_strike_walk": [_I64, _I64] + [_P] * 10,
        # silr, t, fi, corrupt, F
        "sim_step_slab_silent_walk": [_I64, _I64] + [_P] * 6,
    },
    "ckpt_codec": {
        "ckpt_quantize": [_I64, _P, _P, _P, _P, _I32, _P],
        "ckpt_dequantize": [_I64, _P, _P, _P, _P, _I32, _P],
    },
    "flash_attention": {
        # q, k, v, o; dtype, B, H, KV, S, T, hd, causal, vec; 12 strides
        "flash_attention_fwd": [_P] * 4 + [_I32] * 9 + [_I64] * 12 + [_P],
        # q, k, v, o; B, H, KV, S, T, hd, causal; 12 strides
        "flash_attention_tc_fwd": [_P] * 4 + [_I32] * 7 + [_I64] * 12 + [_P],
    },
    "decode_attention": {
        # q, k, v, pos, scratch, o; q / kv dtype, B, H, KV, S, hd, vec;
        # 10 strides
        "decode_attention_fwd": [_P] * 6 + [_I32] * 8 + [_I64] * 10 + [_P],
    },
    "rwkv6": {
        # r, k, v, w, u, s0, y, sT; B, S, H, hd; 23 strides
        "wkv6_fwd": [_P] * 8 + [_I32] * 4 + [_I64] * 23 + [_P],
        # the same, then the tile's rows a thread (0: hd's default)
        "wkv6_fwd_rows": [_P] * 8 + [_I32] * 4 + [_I64] * 23 + [_I32, _P],
    },
    "rwkv6_bwd": {
        "wkv6_bwd_chunk": [_I32],
        "wkv6_bwd_groups": [_I32],
        # r, k, v, w, u, s0, dy, dsT; dr, dk, dv, dw, du, ds0; three scratch
        # buffers; B, S, H, hd, u_batched
        "wkv6_bwd": [_P] * 17 + [_I32] * 5 + [_P],
    },
    "mamba_scan": {
        "selective_scan_fwd_chunk": [],
        # dt, x, A, Bc, Cc, h0, y, hT; B, S, D, ds; (batch, seq) strides of
        # dt, x, Bc, Cc, y
        "selective_scan_fwd": [_P] * 8 + [_I32] * 4 + [_I64] * 10 + [_P],
    },
    "mamba_scan_bwd": {
        "selective_scan_bwd_chunk": [],
        "selective_scan_bwd_parts": [_I32, _I32],
        # dt, x, A, Bc, Cc, h0, dy, dhT; ddt, dx, dA, dB, dC, dh0; three
        # scratch buffers; B, S, D, ds
        "selective_scan_bwd": [_P] * 17 + [_I32] * 4 + [_P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found: the port's CUDA kernels build on a machine with "
        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str) -> subprocess.Popen:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler
    output}`` for the sources built now (the ``-Xptxas -v`` register and
    spill report); raises if any build fails."""
    with _lock:
        return _build_missing(sorted(p.stem for p in CSRC.glob("*.cu")))


def _build_missing(names: List[str]) -> Dict[str, str]:
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {n: _start(n, nvcc) for n in todo}
    logs, failed = {}, []
    for n, p in procs.items():
        logs[n] = p.communicate()[0]
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise KernelBuildError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_missing([name])
            try:
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            except (OSError, AttributeError) as exc:
                raise KernelBuildError(
                    f"cannot load the library of {name}: {exc}"
                ) from exc
            _libs[name] = lib
    return lib
