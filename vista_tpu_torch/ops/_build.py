"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under ``build/`` at the
root of the checkout: one ``nvcc -c`` per source, all started together,
then one link. The file name carries a hash of the sources, so an edited
source is rebuilt and an unchanged one is not. The library is
loaded with ``ctypes``: pointers and the stream travel as ``c_void_p``, and
every C entry returns ``cudaGetLastError()`` of its launch.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc`` or a card.

Launch counts: each kernel wrapper calls :func:`count` exactly where it
launches its kernel, with the kernel's name and the call site (and, for a
kernel with more than one route, the route: ``"name:route"`` then counts
too), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# kernel name (and "kernel:route") -> launches; "kernel/site" -> launches
LAUNCHES: collections.Counter = collections.Counter()
SITES: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vk_attention_short": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "vk_attention_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "vk_attention_bwd_prep": [_P] * 4 + [_I] * 4 + [_P],
    "vk_attention_bwd_short": [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P],
    "vk_attention_bwd_wgmma": [_P] * 8 + [_I] * 6 + [_F, _P],
    "vk_layer_norm": [_P] * 4 + [_I] * 5 + [_F, _P],
    "vk_conv3": [_P] * 7 + [_I] * 7 + [_P],
    "vk_gn_silu": [_P] * 4 + [_I] * 3 + [_P],
    "vk_ff_bwd_dh": [_P] * 7 + [_I] * 4 + [_P],
    "vk_ln_bwd": [_P] * 9 + [_I] * 6 + [_F, _P],
    "vk_ln_occupancy": [_P],
    "vk_wgrad": [_P] * 6 + [_I] * 8 + [_P],
    "vk_seg_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vk_ln_linear": [_P] * 7 + [_I, _I, _I, _I, _I, _F, _P],
    "vk_linear_residual": [_P] * 5 + [_I] * 4 + [_P],
}

_lib = None
build_log = ""

# (name, device, stream) -> int32 device scratch that a kernel leaves as it
# found it (arrival counters, a grid barrier's count and generation): zero
# when made, one set per stream, since launches on one stream are ordered
# and two streams would race on one set
_STREAM_INTS: dict = {}


def count(kernel: str, site: str, route: str | None = None) -> None:
    LAUNCHES[kernel] += 1
    SITES[f"{kernel}/{site}"] += 1
    if route is not None:
        LAUNCHES[f"{kernel}:{route}"] += 1


def reset_counts() -> None:
    LAUNCHES.clear()
    SITES.clear()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    return BUILD / f"libvista_kernels-{source_digest()}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source in parallel, then one link."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD))
    nvcc = _nvcc()
    objs = [work / (src.stem + ".o") for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(_sources(), procs)]
    failed = [src.name for src, proc in zip(_sources(), procs) if proc.returncode != 0]
    if not failed:
        tmp = work / "lib.so"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
    build_log = "\n".join(logs)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(build_log)
    shutil.rmtree(work, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ints(name: str, n: int, device: torch.device) -> torch.Tensor:
    """The current stream's ``n`` int32 scratch values called ``name``."""
    key = (name, device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _STREAM_INTS:
        _STREAM_INTS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return _STREAM_INTS[key]


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """What every kernel asks of a tensor argument: on the card, of the
    kernel's type, contiguous, 16-byte aligned, and of the expected shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def on_cpu(*tensors) -> bool:
    """True when the wrapper should take the plain version: only for tensors
    that lie on the CPU. A tensor on any other device than CPU or CUDA is
    refused."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {sorted(devs)}")
