"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library for ``sm_90a``, then opened with :mod:`ctypes`; no
PyTorch header is compiled, which keeps a build to seconds.  Libraries land
in ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
from pathlib import Path
import re
import shutil
import subprocess
import time

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "Build", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    source: Path
    library: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output, with the -Xptxas -v register/shared-memory lines

    def ptxas_summary(self) -> dict[str, dict[str, int]]:
        """Per kernel (mangled name), what ``-Xptxas -v`` reports:
        ``registers``, ``stack`` bytes, ``spill_stores`` and ``spill_loads``
        bytes.  Empty when the build was reused (no log)."""
        out: dict[str, dict[str, int]] = {}
        name = None
        for ln in self.log.splitlines():
            if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln):
                name = m.group(1)
                out.setdefault(name, {})
            elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
                out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            elif name and (m := re.search(r"Used (\d+) registers", ln)):
                out[name]["registers"] = int(m.group(1))
        return out


_libraries: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return found


def build(source: Path) -> Build:
    """Compile ``source`` into a shared library unless it is already built."""
    source = Path(source).resolve()
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    library = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if library.exists():
        return Build(source, library, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = library.with_name(f"{library.stem}.{os.getpid()}.partial")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(partial, library)
    return Build(source, library, seconds, proc.stdout + proc.stderr)


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source).resolve()
    if source not in _libraries:
        _libraries[source] = ctypes.CDLL(str(build(source).library))
    return _libraries[source]
