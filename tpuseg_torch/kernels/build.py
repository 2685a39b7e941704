"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``tpuseg_torch/kernels/_build/`` (listed in
``.gitignore``), keyed by a hash of the source so an edited kernel is
rebuilt.  ``build()`` starts one ``nvcc`` per source, all at once.

``KERNELS`` lists them: ``ir_chain`` (the decoder's fused inverted-residual
block), ``masked_softmax`` (the per-instance attention softmax, forward
and backward) and ``sru_scan`` (the SRU recurrence, forward and backward).

``build_host`` compiles the repo's C++ host library (``native/*.cpp``: the
SRU forward on the CPU and the record gather) with the host compiler into
the same directory, keyed by a hash of its sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("ir_chain", "masked_softmax", "sru_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

REPO = Path(__file__).resolve().parents[2]
HOST_SOURCES = (REPO / "native" / "sru_cpu.cpp",
                REPO / "native" / "records_io.cpp")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def host_compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")


def host_library_path() -> Path:
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in HOST_SOURCES)).hexdigest()[:16]
    return BUILD_DIR / f"libtpuseg_native-{digest}.so"


def build_host() -> Path:
    """Compile ``HOST_SOURCES`` into one shared library unless it exists;
    raises with the compiler's output if the build fails."""
    out = host_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp),
           *map(str, HOST_SOURCES), "-lpthread"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_logs["native"] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every listed kernel whose library is missing, one ``nvcc``
    process per source, all started together.  Raises with the compiler's
    output if one fails; keeps each log (ptxas register/spill report) in
    ``build_logs``."""
    names = tuple(names or KERNELS)
    jobs = {name: (source(name), library_path(name)) for name in names
            if not library_path(name).exists()}
    compile_all(jobs)
    return {name: library_path(name) for name in names}


def compile_all(jobs: Dict[str, Tuple[Path, Path]]) -> None:
    """Compile ``{label: (source, library)}``, one ``nvcc`` per source, all
    started together; keeps each log in ``build_logs[label]`` and raises
    with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, out) in jobs.items():
        tmp = Path(out).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[label] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for label, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[label] = log
        if proc.returncode != 0:
            failed.append(f"--- {label} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def stream_handle(device) -> int:
    """The handle of the current CUDA stream on ``device``, for a launch:
    ``torch._C._cuda_getCurrentRawStream`` returns it without building a
    ``torch.cuda.Stream`` object (0.18 against 8.6 us a call on the H100
    machine's host)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    index = device.index
    return raw(torch.cuda.current_device() if index is None else index)


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
