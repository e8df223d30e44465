"""Build the port's native sources at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, which is loaded with
``ctypes``; a source in ``TORCH_LINKED`` also includes PyTorch's C10
headers and links against its ``c10_cuda`` library, with the include
and library paths of ``torch.utils.cpp_extension`` and PyTorch's C++ ABI
(``csrc/graph_flow.cu`` reaches the caching allocator so).  Each
``csrc/<name>.cpp`` is host C++ (the exact solvers of
``pymht_tpu_torch.native``) and is compiled by the host's C++ compiler.
Libraries land in ``build/pymht_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.  The
compiler's report (for nvcc ``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``.log``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pymht_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
TORCH_LINKED = frozenset({"graph_flow"})

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (PyTorch's guess of
    CUDA_HOME when the variable is unset)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def host_compiler() -> list:
    """The command that compiles host C++: g++ (or another C++ compiler
    on PATH), else nvcc driving its own host compiler."""
    for cxx in ("g++", "c++", "clang++"):
        found = shutil.which(cxx)
        if found:
            return [found, *HOST_FLAGS]
    return [find_nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler",
            "-fPIC"]


def _source(name: str) -> Path:
    for ext in (".cu", ".cpp"):
        if (CSRC / (name + ext)).is_file():
            return CSRC / (name + ext)
    raise FileNotFoundError(f"no source for {name!r} under {CSRC}")


def torch_flags() -> tuple:
    """nvcc flags that compile against PyTorch's C10 headers and link
    against ``libc10_cuda``: the paths of ``torch.utils.cpp_extension``
    and PyTorch's C++ ABI."""
    import torch
    from torch.utils import cpp_extension
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    flags = [f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    for p in cpp_extension.library_paths():
        flags += [f"-L{p}", f"-Xlinker=-rpath,{p}"]
    return tuple(flags) + ("-lc10_cuda", "-lc10")


def _flags(src: Path) -> tuple:
    if src.suffix != ".cu":
        return HOST_FLAGS
    return NVCC_FLAGS + (torch_flags() if src.stem in TORCH_LINKED else ())


def library_path(name: str, src=None) -> Path:
    src = Path(src) if src else _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, src=None) -> Path:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (the host
    compiler), or the source file ``src`` under the library name
    ``name``, unless an up-to-date library exists.  Raises RuntimeError
    with the compiler's stderr when the build fails."""
    so = library_path(name, src)
    if so.is_file():
        return so
    src = Path(src) if src else _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    flags = _flags(src)
    libs = [f for f in flags if f.startswith("-l")]   # after the source
    cmd = ([find_nvcc(), *(f for f in flags if f not in libs)]
           if src.suffix == ".cu" else host_compiler()) + ["-o", tmp,
                                                           str(src), *libs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(cmd[0]).name} failed with code "
                           f"{res.returncode} building {src.name}:\n"
                           f"{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)   # atomic: a concurrent build sees no torn file
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
