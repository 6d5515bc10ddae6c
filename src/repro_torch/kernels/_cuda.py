"""Build, load and count the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Each source is
compiled by its own ``nvcc`` process, all started together, then linked.
The library lands in ``build/kernels/`` at the checkout's root, named by a
hash of the sources and flags, so an edited source is never served stale.
Nothing here runs at import time: the CPU tests import every module.

``launches`` counts kernel launches per kernel. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels. ``forms`` splits a kernel's count by the
form it took (flash: the decode form or the fp32 / bf16 sequence form;
wkv6: the decode (T = 1) or the prefill kernel). Both are updated under a
lock: the executor's worker threads launch kernels at the same time.
``build_log`` holds the wall seconds of each build that ran ``nvcc`` in this
process (``obs.torchwatch`` counts them).
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

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"paged_decode_bkgh": 0, "flash_attention_bhsd": 0,
            "wkv6_bhtk": 0, "rglru_btc": 0}
forms = {"flash_attention_bhsd": {"decode": 0, "seq_f32": 0, "seq_bf16": 0},
         "wkv6_bhtk": {"decode": 0, "prefill": 0}}

build_log: list[float] = []

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()
_sm_counts: dict[int, int] = {}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
        for counts in forms.values():
            for form in counts:
                counts[form] = 0


def nvcc() -> str:
    """Path of the CUDA compiler."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    found = [str(Path(home, "bin", "nvcc"))] if home else []
    found += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in found:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path. The compiler's output, register and
    spill counts included, goes to ``build/kernels/build.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"librepro_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    compiler = nvcc()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen([compiler, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [compiler, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout.decode()}")
    os.replace(tmp, lib)
    build_log.append(time.monotonic() - t0)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            handle.repro_paged_decode.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
            handle.repro_paged_decode.restype = i32
            handle.repro_flash_attention.argtypes = (
                [ptr] * 4 + [i32] * 10 + [ctypes.c_float, i32, i32, ptr])
            handle.repro_flash_attention.restype = i32
            handle.repro_flash_decode.argtypes = (
                [ptr] * 5 + [i32] * 5 + [ctypes.c_longlong] * 6
                + [i32, ctypes.c_float, i32, i32, i32, ptr])
            handle.repro_flash_decode.restype = i32
            handle.repro_wkv6.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
            handle.repro_wkv6.restype = i32
            handle.repro_rglru.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
            handle.repro_rglru.restype = i32
            handle.repro_error_string.argtypes = [i32]
            handle.repro_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check_launch(name: str, err: int, form: str | None = None) -> None:
    """Raise if a launch was refused; count it (and its form) otherwise."""
    if err:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
    with _count_lock:
        launches[name] += 1
        if form is not None:
            forms[name][form] += 1


def check_cuda_tensors(name, tensors, dtypes):
    """Wrapper-side validation before handing raw pointers to a kernel:
    every tensor on one CUDA device, contiguous, of an accepted dtype."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dt:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def check_cuda_views(name, tensors, dtypes, device):
    """Validation for strided views a kernel reads in place through their
    strides: on ``device``, of an accepted dtype, the last dim of stride 1,
    the base address and every other stride (of a dim longer than 1) a
    multiple of 16 bytes, so that each row can be fetched in 16-byte
    pieces."""
    for t, dt in zip(tensors, dtypes):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype not in dt:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dt}")
        size = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must have stride 1, not "
                             f"{t.stride(-1)}")
        if t.data_ptr() % 16 or any(
                n > 1 and st * size % 16
                for n, st in zip(t.shape[:-1], t.stride()[:-1])) \
                or t.shape[-1] * size % 16:
            raise ValueError(f"{name}: base address or strides "
                             f"{t.stride()} not 16-byte aligned")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device``, read once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def device_and_stream(device: torch.device):
    """The (device index, current stream) a launch on ``device`` takes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return index, ctypes.c_void_p(torch.cuda.current_stream(index).cuda_stream)
