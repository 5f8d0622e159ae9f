"""Build the CUDA sources of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the source, of every header
``csrc/*.cuh`` and of the flags, so an edited source or header builds anew
and an unchanged one is reused. ``defines`` add ``-D`` macros (a source's
tuning traits, as ``experiments/quad_kernels.py`` varies them) and build a
library of their own. ``-Xptxas -v`` (registers, spills) is
kept beside the library as ``<name>-<hash>.ptxas.txt``. No
``--use_fast_math``: the parity tolerances assume IEEE ``sinf``/``cosf``
and division. Nothing is built at import; :func:`load` builds on first use
and :func:`build_all` builds every source at once, one ``nvcc`` each,
holding a lock on the build directory, so that processes started together
(the multi-process fleet's ranks) build a library once and never race.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# The VDE sweep's functors lie in one source per family over the shared
# headers vde.cuh and vde_models.cuh, so that their builds run in parallel.
VDE_SOURCES = ("vde_bicycle", "vde_gp_bicycle", "vde_quad", "vde_gp_quad",
               "vde_gp_quad_routed", "vde_gp_quad_dual")
SOURCES = VDE_SOURCES + ("lq_ipm", "lane_chain")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(defines=()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _target(name: str, defines=()) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, defines=()) -> dict:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, defines) for n in names}
    if all(so.exists() for so in targets.values()):
        return targets
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _compile(targets, defines)
    return targets


def _compile(targets: dict, defines) -> None:
    """Run ``nvcc`` for every target that is missing, all at once."""
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, so)
    failed = []
    for n, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        so.with_suffix(".ptxas.txt").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            continue
        tmp.replace(so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def ptxas_report(name: str, defines=()) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of the last build."""
    path = _target(name, defines).with_suffix(".ptxas.txt")
    if not path.exists():
        return "(built earlier; no ptxas report)"
    keep = ("Compiling entry", "registers", "spill", "stack frame")
    return "\n".join(line for line in path.read_text().splitlines()
                     if any(k in line for k in keep))


def ptxas_resources(name: str, defines=()) -> dict:
    """{kernel entry (mangled name): {"registers", "spill_stores",
    "spill_loads"}} from the ``-Xptxas -v`` report of the last build."""
    out, entry = {}, None
    for line in ptxas_report(name, defines).splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                       r"bytes spill loads", line)):
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry]["registers"] = int(m.group(1))
    return out


def functor_resources(name: str, kernel: str, functor: str, defines=()) -> dict:
    """:func:`ptxas_resources` of the instantiation ``kernel<functor>`` of
    ``csrc/<name>.cu`` (a functor's source is its dynamics' ``cuda_source``),
    matched on the whole template argument of the
    mangled name (``vde_kernelI10BicycleDynE``), so that ``BicycleDyn``
    never matches ``GPBicycleDyn``."""
    tag = f"{kernel}I{len(functor)}{functor}E"
    found = [r for e, r in ptxas_resources(name, defines).items() if tag in e]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} ptxas entries of {kernel}<{functor}> "
                           f"in {name}.cu")
    return found[0]


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built first if needed."""
    key = (name, tuple(defines))
    if key not in _LIBS:
        so = build_all((name,), defines)[name]
        _LIBS[key] = ctypes.CDLL(str(so))
    return _LIBS[key]


def require_card(device) -> None:
    """Raise when ``device`` is a CUDA device and this machine has none:
    the entry points never fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           "available; pass device='cpu' for the plain path")
