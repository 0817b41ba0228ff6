"""Build and load the port's CUDA kernels.

Each library has a plain C interface in ``csrc/<name>.cu``; a library whose
kernels are many may add parts, ``csrc/<name>.<part>.cu`` (flash
attention's one a head dim), so that its instances compile in parallel.
Every source is compiled by ``nvcc`` for Hopper (``sm_90a``) into an object,
all of them started together, and each library's objects are linked into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, at first
use, and loaded with ``ctypes``.  The sources may include the shared headers
``csrc/*.cuh`` (``-I csrc``).  The hash covers the sources, every header and
the flags, so an edited source or header is rebuilt and an unchanged one is
not.  Only sources in this package are built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_libs: Dict[str, ctypes.CDLL] = {}


def refuse_grad(name, *tensors):
    """Raises if autograd is recording and a tensor of ``tensors`` requires
    grad: a kernel fills its output through a raw pointer, which autograd
    does not see, so its output would have no gradient.  Differentiable
    calls go through ``repro_torch.kernels.ops``."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} kernel: an input requires grad, and the kernel's output "
            f"would carry none; call repro_torch.kernels.ops.{name}, whose "
            f"autograd function has the backward")

_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME="
                       f"{home!r}: the CUDA kernels cannot be built")


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and its parts ``csrc/<name>.<part>.cu``."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob(f"{name}.*.cu"))]


def library_names() -> list:
    """Every library of ``csrc``: the sources that are not parts."""
    return sorted(p.stem for p in CSRC.glob("*.cu") if "." not in p.stem)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every library of ``csrc`` (or the named ones) not built yet:
    one ``nvcc`` per source, all started together, then one link a
    library.  ``nvcc``'s output, with the ``-Xptxas=-v`` register and
    shared-memory report, is kept beside each library as ``.log``.  Raises
    if any build fails."""
    names = library_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = [(src, tmp.with_name(f"{tmp.name}.{src.stem}.o"))
                for src in sources(name)]
        jobs.append((name, out, tmp, objs, [_run(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
             str(src)]) for src, o in objs]))
    failed = []
    for name, out, tmp, objs, procs in jobs:
        logs = [proc.communicate()[0] for proc in procs]
        if not any(proc.returncode for proc in procs):
            link = _run([nvcc(), *LINK_FLAGS, "-o", str(tmp),
                         *(str(o) for _, o in objs)])
            logs.append(link.communicate()[0])
            procs.append(link)
        for _, o in objs:
            o.unlink(missing_ok=True)
        log = "\n".join(logs)
        out.with_suffix(".log").write_text(log)
        if any(proc.returncode for proc in procs):
            failed.append(f"nvcc failed on {name}:\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]
