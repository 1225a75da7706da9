"""Builds the port's two native artifacts at first use, into ``_build/``.

(a) The framework-neutral coordination core (``native/src/*.cc``) as
    ``libtpuft.so``, compiled with plain ``g++``: neither cmake nor protobuf
    is needed.  ``tpuft.pb.h`` is generated into the build directory by
    ``native/gen_pb_local.py``'s ``gen_cpp(parse(PROTO))``, loaded by file
    path so nothing is written outside this package's build directory.

(b) The Hopper kernels, one shared library per ``csrc/*.cu`` source with a
    plain C interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
    ``ctypes``.  The sources build in parallel, one ``nvcc`` each.

Every artifact's file name carries a hash of its inputs (sources, headers,
flags), so a stale build can never be loaded.  A cross-process ``fcntl``
lock serializes the builds: concurrent test workers, or the replica-group
processes of one run, build once and the others wait and load.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, Iterator, List, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_PROTO = os.path.join(_REPO_ROOT, "proto", "tpuft.proto")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# The plain-g++ source set of the native core.  A copy of
# torchft_tpu/_native.py NATIVE_SOURCES: the port imports nothing of the JAX
# package, and tests/test_torch_native.py pins that the two lists agree.
NATIVE_SOURCES = (
    "wire.cc",
    "http.cc",
    "flight.cc",
    "lighthouse.cc",
    "manager.cc",
    "store.cc",
    "ring.cc",
    "capi.cc",
)

_GXX_FLAGS = ("-std=c++17", "-O3", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Wall seconds each artifact's last build took in this process (0.0 when it
# was already built), and each kernel build's compiler remarks (ptxas
# registers, shared memory, spills); chip_smoke.py prints both.
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


@contextmanager
def _locked(what: str) -> Iterator[None]:
    """Cross-process lock for building ``what`` (one lock per artifact kind,
    so the native core and the kernels can build at the same time)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".lock-{what}"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _digest(paths: Sequence[str], extra: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update("\0".join(extra).encode())
    return h.hexdigest()[:16]


def _run(cmd: List[str], timeout: float) -> str:
    """Runs a build command; returns its stderr (compiler remarks)."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build command failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}"
        )
    return proc.stderr


# -- (a) the native coordination core ----------------------------------------


def _gen_pb_header(out_dir: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "_tpuft_gen_pb_local", os.path.join(_NATIVE_DIR, "gen_pb_local.py")
    )
    assert spec is not None and spec.loader is not None
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(out_dir, "tpuft.pb.h"), "w") as f:
        f.write(gen.gen_cpp(gen.parse(_PROTO)))


def native_lib_path() -> str:
    """Builds ``libtpuft.so`` if needed and returns its path."""
    src_dir = os.path.join(_NATIVE_DIR, "src")
    inputs = sorted(
        os.path.join(src_dir, f)
        for f in os.listdir(src_dir)
        if f.endswith((".cc", ".h"))
    ) + [_PROTO, os.path.join(_NATIVE_DIR, "gen_pb_local.py")]
    tag = _digest(inputs, _GXX_FLAGS + NATIVE_SOURCES)
    out_dir = os.path.join(BUILD_DIR, "native")
    lib = os.path.join(out_dir, f"libtpuft-{tag}.so")
    if os.path.exists(lib):
        build_seconds.setdefault("native", 0.0)
        return lib
    with _locked("native"):
        if os.path.exists(lib):
            build_seconds.setdefault("native", 0.0)
            return lib
        if shutil.which("g++") is None:
            raise RuntimeError("building the native core needs g++ on PATH")
        t0 = time.monotonic()
        work = os.path.join(out_dir, f"work-{tag}")
        os.makedirs(work, exist_ok=True)
        _gen_pb_header(work)
        inc = ["-I", src_dir, "-I", work]

        def compile_one(src: str) -> str:
            obj = os.path.join(work, src.replace(".cc", ".o"))
            _run(["g++", *_GXX_FLAGS, *inc, "-c", os.path.join(src_dir, src),
                  "-o", obj], timeout=900)
            return obj

        with ThreadPoolExecutor(max_workers=len(NATIVE_SOURCES)) as pool:
            objs = list(pool.map(compile_one, NATIVE_SOURCES))
        tmp = lib + f".tmp{os.getpid()}"
        _run(["g++", "-shared", "-o", tmp, *objs, "-lpthread"], timeout=300)
        os.replace(tmp, lib)
        shutil.rmtree(work, ignore_errors=True)
        build_seconds["native"] = time.monotonic() - t0
    return lib


# -- (b) the CUDA kernels ----------------------------------------------------


def kernel_sources() -> List[str]:
    """Names (without extension) of every kernel source under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA kernels "
        "build only on a machine with the CUDA toolkit"
    )


def _kernel_path(name: str) -> str:
    headers = sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")
    )
    tag = _digest([os.path.join(CSRC_DIR, name + ".cu"), *headers], NVCC_FLAGS)
    return os.path.join(BUILD_DIR, "kernels", f"{name}-{tag}.so")


_PROPERTIES = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def spill_bytes(log: str) -> Dict[str, int]:
    """Function (mangled name) -> bytes of spill stores plus loads, from
    the ``-Xptxas -v`` remarks of one build."""
    return {m[1]: int(m[3]) + int(m[4]) for m in _PROPERTIES.finditer(log)}


def _log_path(lib: str) -> str:
    """Where a kernel library's compiler remarks are kept."""
    return lib[: -len(".so")] + ".ptxas.txt"


def _load_logs(names: Sequence[str], paths: Dict[str, str]) -> None:
    for n in names:
        build_seconds.setdefault("kernel:" + n, 0.0)
        if n not in build_logs and os.path.exists(_log_path(paths[n])):
            with open(_log_path(paths[n])) as f:
                build_logs[n] = f.read()


def build_kernels(names: Sequence[str] = ()) -> Dict[str, str]:
    """Builds the named kernel libraries (default: all), one ``nvcc`` per
    source, all started together.  Returns name -> library path; a library
    built earlier brings its compiler remarks into ``build_logs``."""
    names = list(names) or kernel_sources()
    paths = {n: _kernel_path(n) for n in names}
    missing = [n for n in names if not os.path.exists(paths[n])]
    if not missing:
        _load_logs(names, paths)
        return paths
    with _locked("kernels"):
        missing = [n for n in names if not os.path.exists(paths[n])]
        nvcc = _nvcc()
        os.makedirs(os.path.join(BUILD_DIR, "kernels"), exist_ok=True)

        def compile_one(name: str) -> None:
            t0 = time.monotonic()
            tmp = paths[name] + f".tmp{os.getpid()}"
            log = _run(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC_DIR,
                 "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")], timeout=900,
            )
            with open(_log_path(paths[name]), "w") as f:
                f.write(log)
            build_logs[name] = log
            os.replace(tmp, paths[name])
            build_seconds["kernel:" + name] = time.monotonic() - t0

        with ThreadPoolExecutor(max_workers=max(1, len(missing))) as pool:
            for fut in [pool.submit(compile_one, n) for n in missing]:
                fut.result()
    _load_logs(names, paths)
    return paths


_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_kernels([name])[name])
        _loaded[name] = lib
    return lib
