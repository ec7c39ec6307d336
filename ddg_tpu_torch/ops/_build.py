"""Build the CUDA sources under `ddg_tpu_torch/csrc/` at first use and
load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `build/ddg_tpu_torch/lib<name>-<hash>.so` at the root of the
checkout. The hash covers the source, the shared headers and the flags,
so an edited source is rebuilt and an unchanged one is reused. All
`nvcc` processes start together. A missing `nvcc` or a failed build
raises: there is nothing to fall back to on a CUDA tensor.

Every exported function returns `cudaGetLastError()` after its launch;
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'ddg_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float
i32p = ctypes.POINTER(ctypes.c_int)


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA kernels of ddg_tpu_torch '
                       'are built from source at first use')


def build_all() -> dict[str, tuple[Path, str]]:
    """Compile every `csrc/*.cu` that has no library for its hash yet.
    Returns {name: (library path, compiler output)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = b''.join(p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    out: dict[str, tuple[Path, str]] = {}
    jobs = []
    for src in sorted(CSRC.glob('*.cu')):
        digest = hashlib.sha256(src.read_bytes() + headers
                                + ' '.join(NVCC_FLAGS).encode())
        lib = BUILD_DIR / f'lib{src.stem}-{digest.hexdigest()[:16]}.so'
        out[src.stem] = (lib, '')
        if lib.exists():
            continue
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- {name}.cu ---\n{log}')
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return out


@functools.cache
def _libraries() -> dict[str, ctypes.CDLL]:
    return {name: ctypes.CDLL(str(path))
            for name, (path, _) in build_all().items()}


@functools.cache
def kernel(lib: str, fn: str, argtypes: tuple,
           restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function `fn` of `csrc/<lib>.cu`, built on first use."""
    f = getattr(_libraries()[lib], fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{fn}: CUDA launch failed with error {rc}')


def require_cuda(*tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Raise unless every tensor is a CUDA tensor on one device and, with
    `contiguous`, contiguous (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'expected CUDA tensors on {dev}, '
                             f'got {t.device}')
        if contiguous and not t.is_contiguous():
            raise ValueError('expected contiguous tensors')
