"""Build and load the hand-written CUDA kernels of the port.

Each source in ``flashattention_tpu_torch/csrc/`` is compiled by ``nvcc`` on
its own into a shared library with a plain C interface and loaded with
``ctypes``; PyTorch's headers are never included, so a build takes seconds.
The serving kernels' forms for 8-bit K/V payloads (int8 / fp8 with float32
scales) come from the same sources built with ``-DFA_QUANT`` into libraries
of their own (``*_quant``; paged decode's, instantiated for every head_dim
and group size, split further into one library per head_dim,
``paged_decode_quant_d<D>``), so they build beside the others instead of
lengthening the longest build.  Paged decode's draft form (speculative
verification, ``draft_k > 1``) is the same source built with ``-DFA_DRAFT``,
into ``paged_decode_draft`` and, for 8-bit pages, one library per head_dim
(``paged_decode_draft_quant_d<D>``).  The forms of flash_fwd and of the three
backward kernels with attention dropout or a block mask are the same sources
built with ``-DFA_EXTRA`` into ``*_extra`` libraries; the wrappers take them
only when a call has either.  The tensor-core forms of the forward, the
fused backward and chunked prefill (``flash_fwd_tc``, ``flash_bwd_tc``, their
dropout forms ``*_tc_extra``, and ``paged_prefill_tc``) are sources of their
own, and the two forwards' 8-bit forms are the same sources built with
``-DFA_QUANT`` (``flash_fwd_tc_quant``, ``paged_prefill_tc_quant``).  The
two-pass backward pair's tensor-core forms are ``flash_bwd_dq_tc`` (a
source of its own) and ``flash_bwd_dkv_tc`` (the fused backward's source
built with ``-DFA_PAIR``), each with its dropout form ``*_extra``.
``probe_mma`` is the forward's loop bodies alone and its softmax probes, for
``torch_tools/probe_mma.py`` and ``torch_tools/probe_softmax.py``.
The build runs at first use, from the sources in the checkout only, into
``build/torch_kernels/`` beside the package (listed in ``.gitignore``).  A
library's file name carries a hash of its source, the headers it includes
and its flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build_all`
starts one ``nvcc`` per source, all at once.

Nothing here runs when the module is imported: the CPU tests import every
module, and neither ``nvcc`` nor a card is needed until a kernel is launched
on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = [
    "KERNELS", "KernelBuildError", "build_all", "library", "check_aligned", "check_launch",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# name -> (source, C entry point, its argtypes[, extra nvcc flags]); every
# entry returns an int status: 0, a cudaError_t value, or -1 for a
# configuration not instantiated.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ..., window, softcap, then dropout's row stride, seed, threshold, 1 / (1 - rate), stream
_EXTRA = [_I, _I, _I, _F, _P]
_FLASH_FWD = ("flash_fwd.cu", "fa_flash_fwd", [_I, _I, *[_P] * 14, *[_I] * 8, _F, _I, _F, *_EXTRA])
_PAGED_DECODE = ("paged_decode.cu", "fa_paged_decode", [_I, _I, *[_P] * 8, *[_I] * 7, _F, _I, _F, _P])
_PAGED_PREFILL = ("paged_prefill.cu", "fa_paged_prefill", [_I, _I, *[_P] * 8, *[_I] * 9, _F, _I, _F, _P])
_BWD = [*[_I] * 8, _F, _I, _F, *_EXTRA]  # ..., causal, scale, window, softcap, dropout, stream
KERNELS = {
    "flash_fwd": _FLASH_FWD,
    "paged_decode": _PAGED_DECODE,
    "paged_prefill": _PAGED_PREFILL,
    "flash_fwd_quant": (*_FLASH_FWD, ["-DFA_QUANT"]),
    "flash_fwd_extra": (*_FLASH_FWD, ["-DFA_EXTRA"]),
    "flash_fwd_quant_extra": (*_FLASH_FWD, ["-DFA_QUANT", "-DFA_EXTRA"]),
    **{f"paged_decode_quant_d{d}": (*_PAGED_DECODE, ["-DFA_QUANT", f"-DFA_HEAD_DIM={d}"])
       for d in (32, 64, 128, 256)},
    "paged_decode_draft": (*_PAGED_DECODE, ["-DFA_DRAFT"]),
    **{f"paged_decode_draft_quant_d{d}": (
        *_PAGED_DECODE, ["-DFA_QUANT", "-DFA_DRAFT", f"-DFA_HEAD_DIM={d}"]) for d in (32, 64, 128, 256)},
    "paged_prefill_quant": (*_PAGED_PREFILL, ["-DFA_QUANT"]),
    "paged_prefill_tc": ("paged_prefill_tc.cu", "fa_paged_prefill_tc",
                         [*[_P] * 6, *[_I] * 9, _F, _I, _F, _P]),
    # The 8-bit forms of the two tensor-core forwards: the payload's type
    # code and the two scale arrays first, then the bf16 form's arguments.
    "paged_prefill_tc_quant": ("paged_prefill_tc.cu", "fa_paged_prefill_tc_quant",
                               [_I, _P, _P, *[_P] * 6, *[_I] * 9, _F, _I, _F, _P], ["-DFA_QUANT"]),
    "flash_fwd_tc_quant": ("flash_fwd_tc.cu", "fa_flash_fwd_tc_quant",
                           [_I, _P, _P, *[_P] * 8, *[_I] * 8, _F, _I, _F, *_EXTRA], ["-DFA_QUANT"]),
    "flash_naive": (
        "flash_naive.cu",
        "fa_flash_naive",
        [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    **{name + suffix: (source, entry, args, flags)
       for name, source, entry, args in (
           ("flash_bwd", "flash_bwd.cu", "fa_flash_bwd", [_I, *[_P] * 9, *_BWD]),
           ("flash_bwd_dq", "flash_bwd_dq.cu", "fa_flash_bwd_dq", [_I, *[_P] * 13, *_BWD]),
           ("flash_bwd_dkv", "flash_bwd_dkv.cu", "fa_flash_bwd_dkv", [_I, *[_P] * 14, *_BWD]),
           ("flash_fwd_tc", "flash_fwd_tc.cu", "fa_flash_fwd_tc",
            [*[_P] * 8, *[_I] * 8, _F, _I, _F, *_EXTRA]),
           ("flash_bwd_tc", "flash_bwd_tc.cu", "fa_flash_bwd_tc", [*[_P] * 9, *_BWD]),
           ("flash_bwd_dq_tc", "flash_bwd_dq_tc.cu", "fa_flash_bwd_dq_tc", [*[_P] * 11, *_BWD]))
       for suffix, flags in (("", []), ("_extra", ["-DFA_EXTRA"]))},
    # The pair's dK/dV pass: the fused backward's source in its pair form.
    **{"flash_bwd_dkv_tc" + suffix: ("flash_bwd_tc.cu", "fa_flash_bwd_dkv_tc",
                                     [*[_P] * 12, *_BWD], ["-DFA_PAIR", *flags])
       for suffix, flags in (("", []), ("_extra", ["-DFA_EXTRA"]))},
    # The tensor-core forward's loop bodies alone and its softmax probes
    # (torch_tools/probe_mma.py, torch_tools/probe_softmax.py).
    "probe_mma": ("probe_mma.cu", "fa_probe_mma", [_I, *[_P] * 6, *[_I] * 5, _F, _P]),
}
# Status codes from 10000 up: a TMA tensor map could not be encoded
# (tc_common.cuh's tc_encode_map; 10000 + the driver's CUresult).
_MAP_ERROR = 10000
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed; the message carries its standard error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> list[str]:
    return [*_FLAGS, *(KERNELS[name][3] if len(KERNELS[name]) > 3 else [])]


def _sources(src: str) -> list[str]:
    """``src`` and the headers of ``csrc/`` it includes, transitively."""
    out, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in out:
            continue
        out.append(f)
        with open(os.path.join(_CSRC, f)) as fh:
            todo += re.findall(r'^#include "([^"]+)"', fh.read(), re.M)
    return out


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in _sources(KERNELS[name][0]):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict[str, dict]:
    """Build every kernel library that is missing, one ``nvcc`` per source,
    all started together.  Returns ``{name: {"seconds", "cached", "log"}}``
    where ``log`` is nvcc's standard error (``-Xptxas -v`` register and
    shared-memory report).  Raises :class:`KernelBuildError` on failure."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(_CSRC, KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[name][0]}:\n{err}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        out[name] = {
            "seconds": time.perf_counter() - t0, "cached": False, "log": err,
        }
    if errors:
        raise KernelBuildError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _so_path(name)
        if not os.path.exists(so):
            build_all([name])
        lib = ctypes.CDLL(so)
        entry, argtypes = KERNELS[name][1:3]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as the
    kernels' vector loads (``fa::load4``) require."""
    bad = [tuple(t.shape) for t in tensors if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name} takes 16-byte aligned tensors; misaligned: {bad}")


def check_launch(name: str, status: int, what: str) -> None:
    """Raise unless a kernel entry point returned 0."""
    if status == 0:
        return
    if status < 0:
        raise ValueError(f"{name}: no kernel instantiated for {what}")
    if status >= _MAP_ERROR:
        raise RuntimeError(f"{name}: TMA tensor map not encoded for {what} "
                           f"(CUresult {status - _MAP_ERROR}; 0: no driver entry point)")
    msg = library(name).fa_error_string(status).decode()
    raise RuntimeError(f"{name}: launch failed for {what}: {msg} ({status})")
