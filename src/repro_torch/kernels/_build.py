"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes`` — a build takes seconds,
where a PyTorch extension that includes torch's headers takes minutes.
All sources that lack a current library compile at once (one ``nvcc``
process each, started together).  Libraries land in
``<repo>/build/repro_torch_kernels/`` under a name carrying a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header never loads a stale build.

Nothing is built at import time: the first CUDA launch (or an explicit
``build_all()``) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: per-source extra flags.  The step kernel keeps the plain version's
#: operation order exactly: no contraction of ``a*b + c`` into an FMA.
EXTRA_FLAGS = {"hetero_fuse.cu": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin, "
        "default /usr/local/cuda): the CUDA kernels cannot be built"
    )


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(src.name, ())


def library_path(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` without a current library, all ``nvcc``
    processes started together.  Returns ``{stem: compiler output}`` for
    the sources compiled (``-Xptxas=-v`` register/spill lines); raises
    ``RuntimeError`` with the compiler output if any build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for src in todo:
            out = library_path(src)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(src), "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for src, out, tmp, cmd, proc in procs:
            log, _ = proc.communicate()
            logs[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = library_path(CSRC / f"{stem}.cu")
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[stem] = lib
    return lib
