"""Build and load the port's hand-written Hopper kernels.

The CUDA sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a``, one
``nvcc -c`` per source, all started together, and link into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``_build/`` (listed in ``.gitignore``), and the library
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the cached library.

``-fmad=false`` keeps every product and sum separately rounded, so each
kernel is bit-identical to its plain PyTorch twin.

Every C entry takes its pointers and the stream as ``c_void_p`` and returns
``cudaGetLastError()`` after its launch; ``launch`` raises when that is not
0 (a refused launch never runs, and a later synchronize would not say so).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int64
D = ctypes.c_double

#: C entry -> argument types (pointers and the stream last as c_void_p,
#: every integer as int64, a float32 scalar as a double holding it)
SIGNATURES = {
    "vp_residue_expand": [P] * 4 + [I] * 6 + [P],
    "vp_floor1_synth": [P] * 9 + [I] * 6 + [P],
    "vp_floor1_posts": [P] * 6 + [I] * 4 + [P],
    "vp_floor0_synth": [P] * 5 + [I] * 3 + [D] * 2 + [P],
    "vp_residue_gather": [P] * 3 + [I] * 4 + [P],
    "vp_couple_spectrum": [P] + [I] * 2 + [P],
    "vp_ola_assemble": [P] * 11 + [I] * 7 + [P],
    "vp_dpack_pack": [P] * 5 + [I] * 7 + [P],
    "vp_dpack_unary": [P] * 4 + [I] * 7 + [P],
}

#: launches per kernel since the last reset (chip_smoke reads these to
#: show the main path went through every kernel); K2's posts mode and
#: K4's output modes (the dpack mode holds the dpack wire's select) count
#: under their own names
COUNTS = {
    "residue_expand": 0,
    "residue_gather": 0,
    "floor1_synth": 0,
    "floor1_posts": 0,
    "floor0_synth": 0,
    "couple_spectrum": 0,
    "ola_assemble": 0,
    "ola_assemble_s16": 0,
    "ola_assemble_s16p": 0,
    "ola_assemble_dpack": 0,
    "dpack_pack": 0,
    "dpack_unary": 0,
}

_lock = threading.Lock()
_lib = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libvp_kernels_{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
               str(src)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in procs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *[str(o) for o, _ in procs]],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    (BUILD / "nvcc.log").write_text("".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)


def load():
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vp_error_string.argtypes = [ctypes.c_int]
        lib.vp_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(kernel: str, *args, count: str | None = None) -> None:
    """Launch ``vp_<kernel>`` on the current CUDA stream; count it (under
    ``count``, default the kernel's name) and raise on a launch error."""
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, "vp_" + kernel)(*args, stream)
    COUNTS[count or kernel] += 1
    if err != 0:
        msg = lib.vp_error_string(err).decode()
        raise RuntimeError(f"vp_{kernel} launch failed: {msg} ({err})")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
