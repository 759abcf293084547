"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``,
with the device code they share in ``csrc/*.cuh``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries land in ``build/repro_torch/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the
source and flags so an edited source rebuilds.  Nothing builds at import:
the first launch builds what it needs, and :func:`build` compiles several
sources in parallel (one ``nvcc`` process each)."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("stamp_matmul", "decode_matmul", "paged_attention",
           "grouped_matmul", "cache_attention", "int8_matmul", "quant_pack",
           "haar_dwt", "wht", "span_link")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-lineinfo"]
# the GEMM epilogues, the multi-level Haar DWT (whose levels sum the
# previous level's products) and the span link (whose WHT scale meets the
# bias) evaluate in the plain versions' order: no FMA contraction (the
# quantizers and K10 need none — they use no multiply-add)
_FLAGS = {"stamp_matmul": ["-fmad=false"], "decode_matmul": ["-fmad=false"],
          "paged_attention": [], "grouped_matmul": ["-fmad=false"],
          "cache_attention": [], "int8_matmul": ["-fmad=false"],
          "quant_pack": [], "haar_dwt": ["-fmad=false"], "wht": [],
          "span_link": ["-fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}

VP = ctypes.c_void_p
INT = ctypes.c_int
LL = ctypes.c_longlong
FLT = ctypes.c_float


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _command(name: str, out: Path) -> list:
    return [nvcc(), *_ARCH, *_COMMON, *_FLAGS[name], "-o", str(out),
            str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    # the headers a source may include count as part of it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(_ARCH + _COMMON + _FLAGS[name])
                         .encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{key}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> dict:
    """Compile every missing library in ``names``, all ``nvcc`` processes
    started together.  Returns ``{name: compiler output}`` for the ones
    built; raises with the compiler's message if any fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        cmd = _command(name, out.with_suffix(".tmp.so"))
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            out.with_suffix(".tmp.so").replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use), with
    ``argtypes``/``restype`` set from ``{function: [ctypes types]}``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def _properties(index: int) -> tuple:
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, p.shared_memory_per_block_optin


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def sm_count(device: torch.device) -> int:
    """The card's multiprocessors (read once per card: the launch plans
    size their grids by it on every call)."""
    return _properties(_index(device))[0]


def smem_optin(device: torch.device) -> int:
    """The most shared memory a block may opt into on the card."""
    return _properties(_index(device))[1]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def require_cuda(*tensors) -> None:
    """Validate what a launch takes: CUDA, contiguous, 4-byte aligned."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError("kernel inputs must all lie on the CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError("kernel inputs must be 4-byte aligned")


#: dtype codes of the kernels that take f32, bf16 or f16 tensors
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def float_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in FLOAT_CODES:
        raise ValueError(f"{what} takes f32, bf16 or f16 tensors, not "
                         f"{dtype}")
    return FLOAT_CODES[dtype]
